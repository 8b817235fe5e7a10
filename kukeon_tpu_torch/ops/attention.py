"""Grouped-query attention, the port of ``kukeon_tpu/ops/attention.py``.

One position-based mask covers causal self-attention (prefill) and
attention against a fixed-size cache (each query attends to cache slots
with ``key_position <= query_position`` and ``slot < kv_length``). Scores
and softmax are float32: where the reference asks XLA for an f32 result of
a low-precision dot (``preferred_element_type``), the port upcasts the
operands, which gives the same exact products and an f32 sum.

:func:`gqa_attention` dispatches as the reference does: the flash
forward (:mod:`kukeon_tpu_torch.ops.flash_attention`, a CUDA kernel) for
cacheless self-attention at S >= 1024 on the GPU, where the reference
takes its Pallas kernel on the TPU, and the grouped einsum otherwise.
Engine prefill always has a cache, so it never takes flash. ``ring`` and
``ulysses`` are the sequence-parallel paths over a training mesh's
``seq`` axis (``parallel/ring_attention.py``, ``parallel/ulysses.py``):
where the reference reads its ambient mesh, the port takes ``mesh=``.
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
    mesh=None,
    whole_len: int | None = None,
) -> torch.Tensor:
    """GQA attention entry point used by the model.

    q: [B, Sq, NH, D]; k, v: [B, Skv, NKV, D] with NH % NKV == 0.
    ``impl``: "flash" forces the flash forward (full self-attention only);
    "auto" takes it when ``kv_length`` is None, Sq >= 1024, the shape is
    one :func:`flash_attention.supports` covers and q lies on the GPU (the
    reference's rule, with the GPU in the TPU's place); "reference" and
    every other case take the grouped einsum. "ring" and "ulysses" attend
    this rank's block of the sequence over every ``seq`` peer's on a
    training ``mesh`` (``parallel.mesh.Mesh``), full self-attention only;
    without a mesh they are a ``ValueError``, as the reference's are
    without an ambient one. ``whole_len``: q is one rank's block of a
    sequence of this many positions, attending every key of it (Skv ==
    whole_len, ``llama.seq_attention``); "auto" and "flash" then decide on
    the whole sequence, Sq == Skv == whole_len, as the reference does on
    its global arrays, and the flash kernel takes the block ("auto" where
    the block has the kernel's ``MIN_S`` rows).
    """
    if impl in ("ring", "ulysses"):
        if kv_length is not None or q.shape[1] != k.shape[1]:
            raise ValueError(
                f"impl={impl!r} requires full self-attention (Sq == Skv, no "
                f"kv_length); got Sq={q.shape[1]}, Skv={k.shape[1]}, "
                f"kv_length={'set' if kv_length is not None else 'None'}. "
                "Use 'reference' or 'auto' for cached decode."
            )
        if mesh is None:
            raise ValueError(f"impl={impl!r} attends over a mesh's seq axis: pass mesh=")
        if impl == "ulysses":
            from kukeon_tpu_torch.parallel.ulysses import ulysses_attention

            return ulysses_attention(q, k, v, q_positions=q_positions,
                                     kv_positions=kv_positions, mesh=mesh)
        from kukeon_tpu_torch.parallel.ring_attention import ring_attention

        return ring_attention(q, k, v, q_positions=q_positions, kv_positions=kv_positions,
                              mesh=mesh)
    if impl not in ("auto", "reference", "flash"):
        raise ValueError(f"unknown attention impl {impl!r}")

    from kukeon_tpu_torch.ops import flash_attention as fa   # it imports this module

    q_len = q.shape[1] if whole_len is None else whole_len
    if impl == "flash":
        if kv_length is not None or not fa.supports(q_len, k.shape[1]):
            raise ValueError(
                "impl='flash' requires full self-attention with Sq == Skv, "
                "Sq >= 128, Sq a multiple of the 256 block, and no kv_length; "
                f"got Sq={q_len}, Skv={k.shape[1]}, "
                f"kv_length={'set' if kv_length is not None else 'None'}. "
                "Use 'reference' or 'auto'."
            )
        use_flash = True
    else:
        use_flash = (impl == "auto" and kv_length is None and q_len >= 1024
                     and fa.supports(q_len, k.shape[1]) and q.shape[1] >= fa.MIN_S
                     and q.device.type == "cuda")
    if use_flash:
        return fa.flash_attention(q, k, v, q_positions, kv_positions)
    mask = attention_mask(q_positions, kv_positions, kv_length)
    return attention_grouped(q, k, v, mask)
