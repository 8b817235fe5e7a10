"""BERT-family encoder (the bge-base embedding model), the port of
``kukeon_tpu/models/bert.py``.

bge-base is BERT-base with CLS pooling and L2 normalisation. Plain
functions on tensors over the reference's stacked tree (``[L, ...]``
layers), so a reference tree converted by
:func:`kukeon_tpu_torch.models.convert.params_from_numpy` runs unchanged.
Post-LN, bidirectional attention with an additive padding bias; matmuls in
the model dtype, LayerNorm, attention logits and softmax in f32, as the
reference. The reference leaves BERT to XLA (no Pallas kernel), so these
are plain tensor ops too: no SDPA, whose rounding differs from the
reference's explicit softmax. The reference's ``lax.scan`` over layers is
a Python loop.

**Tensor parallelism** (``mesh=``, a ``parallel.mesh.Mesh``; the
reference's ``shard_bert_params``): the forward runs on one rank's local
tree (``parallel/sharding.py bert_param_specs``): its vocabulary rows of
``word``, its heads' columns of ``wq``/``wk``/``wv`` and their biases,
its rows of ``wo``, its columns of ``w_in`` and ``b_in`` and rows of
``w_out``. The word rows come from a masked lookup and an ``all_reduce``,
and ``position`` and ``type`` are added once, after it; the head count
comes from the local shapes; one ``all_reduce`` follows ``attn @ wo`` and
one ``h @ w_out``, and ``bo``/``b_out`` are added after the sum (before
it, t ranks would add them t times).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch
import torch.nn.functional as F

from kukeon_tpu_torch.models.llama import _psum, masked_lookup, nest

Params = dict[str, Any]


@dataclasses.dataclass(frozen=True)
class BertConfig:
    vocab_size: int = 30522
    hidden_size: int = 768
    intermediate_size: int = 3072
    num_layers: int = 12
    num_heads: int = 12
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    layer_norm_eps: float = 1e-12
    dtype: torch.dtype = torch.bfloat16

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads

    def param_count(self) -> int:
        H, I, L = self.hidden_size, self.intermediate_size, self.num_layers
        embed = (self.vocab_size + self.max_position_embeddings
                 + self.type_vocab_size) * H + 2 * H
        attn = 4 * (H * H + H)
        mlp = H * I + I + I * H + H
        norms = 4 * H
        return embed + L * (attn + mlp + norms)


def bge_base() -> BertConfig:
    """BAAI/bge-base-en shapes (= BERT-base)."""
    return BertConfig()


def bge_tiny() -> BertConfig:
    """Test-size config: fast on a CPU."""
    return BertConfig(
        vocab_size=512, hidden_size=64, intermediate_size=128,
        num_layers=2, num_heads=4, max_position_embeddings=128,
        dtype=torch.float32,
    )


def init_params(cfg: BertConfig, generator: torch.Generator,
                device: torch.device | str) -> Params:
    """Random parameters in the reference layout (stacked layers on axis 0):
      embed: word [V, H], position [P, H], type [T, H], norm_scale/bias [H];
      layers: wq/wk/wv/wo [L, H, H] with biases bq/bk/bv/bo [L, H],
      attn_norm_scale/bias [L, H], w_in [L, H, I] + b_in [L, I],
      w_out [L, I, H] + b_out [L, H], mlp_norm_scale/bias [L, H].
    Matrices are normal draws times ``fan_in ** -0.5``, biases 0, norm
    scales 1. The draws differ from the reference's (torch's generator, not
    jax's); parity tests convert the reference's tree instead."""
    return nest(iter_params(cfg, generator, device))


def iter_params(cfg: BertConfig, generator: torch.Generator, device: torch.device | str):
    """:func:`init_params`' leaves as ``(path, tensor)`` pairs, each drawn
    when it is yielded (the same draws, in the same order)."""
    c = cfg
    L, H, I = c.num_layers, c.hidden_size, c.intermediate_size

    def dense(shape, fan_in):
        w = torch.randn(shape, generator=generator, dtype=torch.float32, device=device)
        return (w * fan_in ** -0.5).to(c.dtype)

    def full(value, *shape):
        return torch.full(shape, value, dtype=c.dtype, device=device)

    yield ("embed", "word"), dense((c.vocab_size, H), H)
    yield ("embed", "position"), dense((c.max_position_embeddings, H), H)
    yield ("embed", "type"), dense((c.type_vocab_size, H), H)
    yield ("embed", "norm_scale"), full(1.0, H)
    yield ("embed", "norm_bias"), full(0.0, H)
    for name, shape, fan_in in (("q", (H, H), H), ("k", (H, H), H), ("v", (H, H), H),
                                ("o", (H, H), H)):
        yield ("layers", "w" + name), dense((L, *shape), fan_in)
        yield ("layers", "b" + name), full(0.0, L, H)
    yield ("layers", "attn_norm_scale"), full(1.0, L, H)
    yield ("layers", "attn_norm_bias"), full(0.0, L, H)
    yield ("layers", "w_in"), dense((L, H, I), H)
    yield ("layers", "b_in"), full(0.0, L, I)
    yield ("layers", "w_out"), dense((L, I, H), I)
    yield ("layers", "b_out"), full(0.0, L, H)
    yield ("layers", "mlp_norm_scale"), full(1.0, L, H)
    yield ("layers", "mlp_norm_bias"), full(0.0, L, H)


def _layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                eps: float) -> torch.Tensor:
    """Full LayerNorm (mean and variance) in f32, back in ``x``'s dtype."""
    dtype = x.dtype
    x = x.float()
    mu = x.mean(dim=-1, keepdim=True)
    var = torch.square(x - mu).mean(dim=-1, keepdim=True)
    y = (x - mu) * torch.rsqrt(var + eps)
    return (y * scale.float() + bias.float()).to(dtype)


def forward(
    params: Params,
    cfg: BertConfig,
    tokens: torch.Tensor,
    mask: torch.Tensor,
    token_types: torch.Tensor | None = None,
    mesh=None,
) -> torch.Tensor:
    """Encode. tokens/mask: [B, S] (mask 1 = real token, 0 = pad).
    Returns the final hidden states [B, S, H] in f32. ``mesh``: ``params``
    is the rank's local tree (the module docstring)."""
    c = cfg
    B, S = tokens.shape
    tokens = tokens.long()
    pos = torch.arange(S, device=tokens.device)
    tt = token_types.long() if token_types is not None else torch.zeros_like(tokens)

    e = params["embed"]
    word = (e["word"][tokens] if mesh is None
            else masked_lookup(e["word"], tokens, e["word"].shape[0], mesh))
    x = (word + e["position"][pos][None] + e["type"][tt]).to(c.dtype)
    x = _layer_norm(x, e["norm_scale"], e["norm_bias"], c.layer_norm_eps)

    # Padded keys take f32's most negative finite value (not -inf), so a
    # row whose keys are all padded still softmaxes to finite numbers.
    neg = torch.finfo(torch.float32).min
    attn_bias = torch.where(mask[:, None, None, :].bool(),
                            torch.zeros((), device=tokens.device),
                            torch.full((), neg, device=tokens.device))   # [B, 1, 1, S]
    scale = c.head_dim ** -0.5

    lw = params["layers"]
    nh = lw["wq"].shape[-1] // c.head_dim          # this rank's heads
    for layer in range(c.num_layers):
        w = {name: t[layer] for name, t in lw.items()}

        def proj(name, bname):
            return (x @ w[name] + w[bname]).reshape(B, S, nh, c.head_dim)

        q = proj("wq", "bq")
        k = proj("wk", "bk")
        v = proj("wv", "bv")
        logits = torch.einsum("bqhd,bkhd->bhqk", q, k).float() * scale
        probs = torch.softmax(logits + attn_bias, dim=-1).to(c.dtype)
        attn = torch.einsum("bhqk,bkhd->bqhd", probs, v).reshape(B, S, nh * c.head_dim)
        attn = _psum(attn @ w["wo"], mesh) + w["bo"]
        x = _layer_norm(x + attn, w["attn_norm_scale"], w["attn_norm_bias"],
                        c.layer_norm_eps)

        # The reference's gelu is the exact (erf) one: approximate=False.
        h = F.gelu((x @ w["w_in"] + w["b_in"]).float()).to(c.dtype)
        h = _psum(h @ w["w_out"], mesh) + w["b_out"]
        x = _layer_norm(x + h, w["mlp_norm_scale"], w["mlp_norm_bias"], c.layer_norm_eps)
    return x.float()


def embed(
    params: Params,
    cfg: BertConfig,
    tokens: torch.Tensor,
    mask: torch.Tensor,
    pooling: str = "cls",
    mesh=None,
) -> torch.Tensor:
    """Sentence embeddings, bge-style: encode, pool, L2-normalise.
    Returns [B, H] f32 unit vectors. ``pooling``: "cls" (bge's default) or
    "mean" (mask-weighted)."""
    hidden = forward(params, cfg, tokens, mask, mesh=mesh)
    if pooling == "cls":
        pooled = hidden[:, 0, :]
    elif pooling == "mean":
        m = mask.float()[:, :, None]
        pooled = (hidden * m).sum(dim=1) / torch.clamp(m.sum(dim=1), min=1.0)
    else:
        raise ValueError(f"unknown pooling {pooling!r}")
    norm = torch.linalg.vector_norm(pooled, dim=-1, keepdim=True)
    return pooled / torch.clamp(norm, min=1e-12)
