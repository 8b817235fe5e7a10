"""Grouped-query attention, the port of ``kukeon_tpu/ops/attention.py``.

One position-based mask covers causal self-attention (prefill) and
attention against a fixed-size cache (each query attends to cache slots
with ``key_position <= query_position`` and ``slot < kv_length``). Scores
and softmax are float32: where the reference asks XLA for an f32 result of
a low-precision dot (``preferred_element_type``), the port upcasts the
operands, which gives the same exact products and an f32 sum.

Only the grouped einsum path is ported. The reference's flash dispatch
(a Pallas kernel that engine prefill never reaches) and its ring/ulysses
sequence-parallel paths raise ``NotImplementedError`` here.
"""

from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def repeat_kv(x: torch.Tensor, n_rep: int) -> torch.Tensor:
    """Expand KV heads for GQA: [B, S, KV, D] -> [B, S, KV * n_rep, D]."""
    if n_rep == 1:
        return x
    b, s, kv, d = x.shape
    return x[:, :, :, None, :].expand(b, s, kv, n_rep, d).reshape(b, s, kv * n_rep, d)


def attention_mask(
    q_positions: torch.Tensor,
    kv_positions: torch.Tensor,
    kv_length: torch.Tensor | None = None,
) -> torch.Tensor:
    """Boolean mask [B, 1, Sq, Skv]: True = attend.

    Args:
      q_positions: [B, Sq] absolute positions of the queries.
      kv_positions: [B, Skv] absolute positions of the keys.
      kv_length: optional [B] number of valid cache slots; slots at index
        >= kv_length are masked out.
    """
    causal = kv_positions[:, None, :] <= q_positions[:, :, None]   # [B, Sq, Skv]
    if kv_length is not None:
        skv = kv_positions.shape[-1]
        valid = (torch.arange(skv, device=kv_positions.device)[None, None, :]
                 < kv_length[:, None, None])
        causal = causal & valid
    return causal[:, None, :, :]


def attention_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mask: torch.Tensor,
) -> torch.Tensor:
    """Masked multi-head attention (GQA-expanded inputs).

    q: [B, Sq, H, D]; k, v: [B, Skv, H, D]; mask: [B, 1, Sq, Skv] bool.
    Returns [B, Sq, H, D] in q's dtype; softmax in float32.
    """
    scale = 1.0 / math.sqrt(q.shape[-1])
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    scores = torch.where(mask, scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", probs.to(v.dtype), v)
    return out.to(q.dtype)


def attention_grouped(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mask: torch.Tensor,
) -> torch.Tensor:
    """GQA attention without materializing repeated KV heads: the query
    heads are grouped ([B, Sq, KV, G, D]) so every KV byte is read once.

    q: [B, Sq, H, D]; k, v: [B, Skv, KV, D] (H % KV == 0);
    mask: [B, 1, Sq, Skv] bool.
    """
    B, Sq, H, D = q.shape
    KV = k.shape[2]
    G = H // KV
    scale = 1.0 / math.sqrt(D)
    qg = q.reshape(B, Sq, KV, G, D)
    scores = torch.einsum("bqkgd,btkd->bkgqt", qg.float(), k.float()) * scale
    scores = torch.where(mask[:, :, None, :, :], scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgqt,btkd->bqkgd", probs.to(v.dtype), v)
    return out.reshape(B, Sq, H, D).to(q.dtype)


def decode_gqa_attention(
    q: torch.Tensor,
    k_new: torch.Tensor,
    v_new: torch.Tensor,
    cache_k: torch.Tensor,
    cache_v: torch.Tensor,
    lengths: torch.Tensor,
    k_scale: torch.Tensor | None = None,
    v_scale: torch.Tensor | None = None,
) -> torch.Tensor:
    """Single-token decode attention against a cache, append-free.

    The new token's K/V are not written into the cache first: the cache
    contributes ``lengths`` masked slots and the current token one extra
    score, softmaxed together. The caller writes the new K/V once per step.

    Quantized cache: int8 ``cache_k``/``cache_v`` with per-token per-head
    scales ``k_scale``/``v_scale`` [B, S, KV]; the key scale multiplies the
    f32 scores, the value scale folds into the probabilities before the
    value product — the same math as dequantize-then-attend.

    q: [B, 1, H, D]; k_new, v_new: [B, 1, KV, D] (full precision);
    cache_k, cache_v: [B, S, KV, D]; lengths: [B]. Returns [B, 1, H, D].
    """
    B, _, H, D = q.shape
    S, KV = cache_k.shape[1], cache_k.shape[2]
    G = H // KV
    scale = 1.0 / math.sqrt(D)
    dt = q.dtype

    qg = q.reshape(B, KV, G, D)
    qf = qg.float()
    # The quantized path converts int8 -> activation dtype (exact); the f32
    # upcast below is the port's spelling of an f32-accumulating dot.
    ck = cache_k.to(dt) if k_scale is not None else cache_k
    s_cache = torch.einsum("bkgd,btkd->bkgt", qf, ck.float()) * scale
    if k_scale is not None:
        s_cache = s_cache * k_scale.permute(0, 2, 1)[:, :, None, :]
    valid = (torch.arange(S, device=q.device)[None, None, None, :]
             < lengths[:, None, None, None])
    s_cache = torch.where(valid, s_cache, NEG_INF)
    s_self = torch.einsum("bkgd,bkd->bkg", qf,
                          k_new.reshape(B, KV, D).float())[..., None] * scale

    probs = torch.softmax(torch.cat([s_cache, s_self], dim=-1), dim=-1)
    p_cache = probs[..., :S]
    if v_scale is not None:
        p_cache = p_cache * v_scale.permute(0, 2, 1)[:, :, None, :]
        cv = cache_v.to(dt)
        p_cache = p_cache.to(dt)
    else:
        cv = cache_v
        p_cache = p_cache.to(cache_v.dtype)
    p_self = probs[..., S:].to(v_new.dtype)
    out = (torch.einsum("bkgt,btkd->bkgd", p_cache, cv)
           + p_self * v_new.reshape(B, KV, 1, D))
    return out.reshape(B, 1, H, D).to(dt)


def gqa_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    q_positions: torch.Tensor,
    kv_positions: torch.Tensor,
    kv_length: torch.Tensor | None = None,
    impl: str = "auto",
) -> torch.Tensor:
    """GQA attention entry point used by the model.

    q: [B, Sq, NH, D]; k, v: [B, Skv, NKV, D] with NH % NKV == 0.
    ``impl``: "auto" and "reference" take the grouped einsum ("auto" picks
    it everywhere, as the reference does off TPU).
    """
    if impl == "flash":
        raise NotImplementedError(
            "impl='flash' (the Pallas flash forward, kukeon_tpu/ops/"
            "flash_attention.py) is not ported yet: ROADMAP.md B1, with "
            "the training slice (A7)")
    if impl in ("ring", "ulysses"):
        raise NotImplementedError(
            f"impl={impl!r} (sequence parallelism) is not ported yet: "
            "ROADMAP.md A13, multi-GPU")
    if impl not in ("auto", "reference"):
        raise ValueError(f"unknown attention impl {impl!r}")
    mask = attention_mask(q_positions, kv_positions, kv_length)
    return attention_grouped(q, k, v, mask)
