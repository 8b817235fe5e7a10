"""Parameters carried across: numpy trees in, the port's tensors out.

:func:`params_from_numpy` takes a parameter tree in the reference's layout
as numpy arrays (what ``jax.tree.map(np.asarray, params)`` gives, or
``kukeon_tpu``'s host-side int8 init, or an orbax checkpoint's leaves) and
returns the same tree as torch tensors on ``device``. bf16 leaves arrive as
``ml_dtypes.bfloat16`` (the numpy dtype jax uses) or as
:class:`BFloat16Bits` (the orbax reader's) and are reinterpreted bit for
bit, without importing ``ml_dtypes``; int8 ``q`` leaves and f32 ``s``
scales stay as they are.

:func:`init_quantized_params_device` draws an int8 tree on the device,
layer by layer, with the reference's recipe (normal draws scaled by
``fan_in ** -0.5``, then per-output-channel symmetric int8): an 8B tree in
seconds, where drawing 8 B normals in numpy on the host takes minutes.
:func:`init_quantized_moe_params_device` does the same for the MoE tree,
one expert matrix at a time.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from kukeon_tpu_torch.models.llama import LlamaConfig, Params, _int8_sym, nest
from kukeon_tpu_torch.models.moe import MoEConfig


class BFloat16Bits(np.ndarray):
    """A bfloat16 array held as its uint16 bit patterns (numpy has no
    bfloat16 without ``ml_dtypes``): what the port's checkpoint readers
    return for a bfloat16 leaf. ``np.asarray`` drops the marker, so keep
    the object itself until :func:`tensor_from_numpy` views it as
    ``torch.bfloat16``."""


def tensor_from_numpy(a: np.ndarray) -> torch.Tensor:
    """A host array as a CPU tensor, bit for bit: ``ml_dtypes.bfloat16``
    and :class:`BFloat16Bits` become ``torch.bfloat16``; read-only arrays
    are copied, others shared."""
    if isinstance(a, BFloat16Bits):
        return tensor_from_numpy(a.view(np.ndarray)).view(torch.bfloat16)
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
    and the MoE router (norms, full-precision matrices) to the model's
    activation dtype — for trees whose norms come as float32. The router
    stays float32, as the reference keeps it, so routing does not wobble."""

    def conv(node, key=None):
        if isinstance(node, dict):
            return {k: conv(v, k) for k, v in node.items()}
        t = tensor_from_numpy(node if isinstance(node, np.ndarray) else np.asarray(node))
        if dtype is not None and t.is_floating_point() and key not in ("s", "router"):
            t = t.to(dtype)
        return t.to(device)

    return conv(tree)


def npz_leaves(*, device: torch.device | str, path: str):
    """The ``(path tuple, tensor)`` leaves of an ``.npz`` whose keys are the
    leaves' paths joined by ``/`` (numpy dtypes; int8 ``{"q", "s"}`` leaves
    as ``…/q`` and ``…/s``), on ``device``, read one at a time in the
    file's order: a weight recipe's factory
    (:class:`kukeon_tpu_torch.parallel.sharding.Recipe`)."""
    with np.load(path) as f:
        for key in f.files:
            yield tuple(key.split("/")), tensor_from_numpy(f[key]).to(device)


def init_quantized_params_device(cfg: LlamaConfig, generator: torch.Generator,
                                 device: torch.device | str) -> Params:
    """Random int8 tree drawn on ``device`` one layer slice at a time, so
    peak memory beyond the int8 tree is one f32 layer matrix (the embedding
    is the largest: V x H). ``generator`` must live on ``device``."""
    return nest(iter_quantized_params_device(cfg, generator, device))


def iter_quantized_params_device(cfg: LlamaConfig, generator: torch.Generator,
                                 device: torch.device | str):
    """:func:`init_quantized_params_device`' leaves as ``(path, tensor)``
    pairs, each drawn when it is yielded (the same draws, in the same
    order), so a caller can keep a slice of each and free the rest."""
    return _int8_leaves(cfg, generator, device, experts=None)


def init_quantized_moe_params_device(cfg: MoEConfig, generator: torch.Generator,
                                     device: torch.device | str) -> Params:
    """Random int8 MoE tree drawn on ``device`` one layer and one expert
    matrix at a time, so peak memory beyond the int8 tree is one f32
    matrix (at Mixtral-8x7B an expert matrix is 235 MB, where a whole
    [L, E, H, I] f32 stack would be 60 GB). The router is drawn f32 and
    stays so. ``generator`` must live on ``device``."""
    return nest(iter_quantized_moe_params_device(cfg, generator, device))


def iter_quantized_moe_params_device(cfg: MoEConfig, generator: torch.Generator,
                                     device: torch.device | str):
    """:func:`init_quantized_moe_params_device`' leaves as ``(path,
    tensor)`` pairs, each drawn when it is yielded (the same draws)."""
    return _int8_leaves(cfg, generator, device, experts=cfg.num_experts)


def _int8_leaves(cfg, generator: torch.Generator, device, experts: int | None):
    """The Llama tree's leaves, or with ``experts`` the MoE tree's (router
    [L, H, E] f32 and expert stacks [L, E, K, N]), in the tree's order."""
    c = cfg
    L, H, I, V = c.num_layers, c.hidden_size, c.intermediate_size, c.vocab_size

    def normal(shape, fan_in):
        w = torch.randn(shape, generator=generator, dtype=torch.float32, device=device)
        return w.mul_(fan_in ** -0.5)

    def q_leaf(shape, fan_in, axis):
        qw, s = _int8_sym(normal(shape, fan_in), axis)
        return qw, s.squeeze(axis)

    def stacked(name, shape, fan_in, lead=(L,)):
        """[*lead, K, N] int8, scale per output column: the reference's axis
        1 of [L, K, N] (axis 2 of [L, E, K, N]), one [K, N] slice at a time."""
        qs = torch.empty((*lead, *shape), dtype=torch.int8, device=device)
        ss = torch.empty((*lead, shape[1]), dtype=torch.float32, device=device)
        for idx in np.ndindex(*lead):
            qs[idx], ss[idx] = q_leaf(shape, fan_in, 0)
        yield ("layers", name, "q"), qs
        yield ("layers", name, "s"), ss

    eq, es = q_leaf((V, H), H, 1)                            # scale per vocab row
    yield ("embed", "q"), eq
    yield ("embed", "s"), es
    del eq, es
    ones = lambda *shape: torch.ones(shape, dtype=c.dtype, device=device)  # noqa: E731
    yield ("layers", "attn_norm"), ones(L, H)
    yield from stacked("wq", (H, c.q_dim), H)
    yield from stacked("wk", (H, c.kv_dim), H)
    yield from stacked("wv", (H, c.kv_dim), H)
    yield from stacked("wo", (c.q_dim, H), c.q_dim)
    yield ("layers", "mlp_norm"), ones(L, H)
    mlp = (L,) if experts is None else (L, experts)
    if experts is not None:
        yield ("layers", "router"), normal((L, H, experts), H)
    yield from stacked("w_gate", (H, I), H, mlp)
    yield from stacked("w_up", (H, I), H, mlp)
    yield from stacked("w_down", (I, H), I, mlp)
    yield ("final_norm",), ones(H)
    if not c.tie_embeddings:
        hq, hs = q_leaf((H, V), H, 0)                        # scale per vocab col
        yield ("lm_head", "q"), hq
        yield ("lm_head", "s"), hs
