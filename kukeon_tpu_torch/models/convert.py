"""Parameters carried across: numpy trees in, the port's tensors out.

:func:`params_from_numpy` takes a parameter tree in the reference's layout
as numpy arrays (what ``jax.tree.map(np.asarray, params)`` gives, or
``kukeon_tpu``'s host-side int8 init) and returns the same tree as torch
tensors on ``device``. bf16 leaves arrive as ``ml_dtypes.bfloat16`` (the
numpy dtype jax uses) and are reinterpreted bit for bit, without importing
``ml_dtypes``; int8 ``q`` leaves and f32 ``s`` scales stay as they are.

:func:`init_quantized_params_device` draws an int8 tree on the device,
layer by layer, with the reference's recipe (normal draws scaled by
``fan_in ** -0.5``, then per-output-channel symmetric int8): an 8B tree in
seconds, where drawing 8 B normals in numpy on the host takes minutes.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from kukeon_tpu_torch.models.llama import LlamaConfig, Params, _int8_sym


def _tensor_from_numpy(a: np.ndarray) -> torch.Tensor:
    a = np.ascontiguousarray(a)
    if not a.flags.writeable:     # jax's host views are read-only
        a = a.copy()
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def params_from_numpy(tree: Any, device: torch.device | str,
                      dtype: torch.dtype | None = None) -> Params:
    """Numpy tree -> torch tree on ``device``, same nesting and keys.

    ``dtype`` (optional) casts the floating leaves other than int8 scales
    (norms, full-precision matrices) to the model's activation dtype — for
    trees whose norms come as float32."""

    def conv(node, key=None):
        if isinstance(node, dict):
            return {k: conv(v, k) for k, v in node.items()}
        t = _tensor_from_numpy(np.asarray(node))
        if dtype is not None and t.is_floating_point() and key != "s":
            t = t.to(dtype)
        return t.to(device)

    return conv(tree)


def init_quantized_params_device(cfg: LlamaConfig, generator: torch.Generator,
                                 device: torch.device | str) -> Params:
    """Random int8 tree drawn on ``device`` one layer slice at a time, so
    peak memory beyond the int8 tree is one f32 layer matrix (the embedding
    is the largest: V x H). ``generator`` must live on ``device``."""
    c = cfg
    L, H, I, V = c.num_layers, c.hidden_size, c.intermediate_size, c.vocab_size

    def q_leaf(shape, fan_in, axis):
        w = torch.randn(shape, generator=generator, dtype=torch.float32, device=device)
        qw, s = _int8_sym(w.mul_(fan_in ** -0.5), axis)
        return qw, s.squeeze(axis)

    def stacked(shape, fan_in):
        """[L, *shape] int8, scale per output column (axis 1 of the layer
        slice [K, N] is the reference's axis 1 of [L, K, N])."""
        qs = torch.empty((L, *shape), dtype=torch.int8, device=device)
        ss = torch.empty((L, shape[1]), dtype=torch.float32, device=device)
        for layer in range(L):
            qs[layer], ss[layer] = q_leaf(shape, fan_in, 0)
        return {"q": qs, "s": ss}

    eq, es = q_leaf((V, H), H, 1)
    ones = lambda *shape: torch.ones(shape, dtype=c.dtype, device=device)  # noqa: E731
    params: Params = {
        "embed": {"q": eq, "s": es},                         # scale per vocab row
        "layers": {
            "attn_norm": ones(L, H),
            "wq": stacked((H, c.q_dim), H),
            "wk": stacked((H, c.kv_dim), H),
            "wv": stacked((H, c.kv_dim), H),
            "wo": stacked((c.q_dim, H), c.q_dim),
            "mlp_norm": ones(L, H),
            "w_gate": stacked((H, I), H),
            "w_up": stacked((H, I), H),
            "w_down": stacked((I, H), I),
        },
        "final_norm": ones(H),
    }
    if not c.tie_embeddings:
        hq, hs = q_leaf((H, V), H, 0)                        # scale per vocab col
        params["lm_head"] = {"q": hq, "s": hs}
    return params
