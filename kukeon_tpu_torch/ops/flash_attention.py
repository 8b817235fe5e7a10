"""Flash-attention forward (causal by position), the port of
``kukeon_tpu/ops/flash_attention.py``.

``flash_attention(q, k, v, q_positions, kv_positions)`` keeps the JAX
layout: q ``[B, S, H, D]``, k and v ``[B, S, KV, D]``, positions
``[B, S]``; a query attends to the keys with ``kv_position <=
q_position``. Unlike the JAX function, k and v may carry fewer heads than
q (``H % KV == 0``): the kernel maps query head ``h`` to kv head
``h // (H // KV)``, which is what ``repeat_kv`` followed by the JAX
function computes, without the expanded copy.

Routes, by where the tensors lie:

- CPU: :func:`flash_attention_reference`, the plain PyTorch version.
- CUDA: the hand-written kernel in ``kukeon_tpu_torch/csrc/flash_attention.cu``
  (bf16 on the tensor cores, f32 with plain FMAs), built at first use.
  D must be 32, 64 or 128 and S a multiple of 64 (at most 65536);
  anything else raises, and so does a failed build or launch. There is
  no fallback.

The backward is the JAX package's: no kernel, the reference attention
recomputed under autograd (``_flash_bwd``), with the gradients of k and v
summed back to their own head count through ``repeat_kv``.

In bf16 the kernel and the plain version round differently: the kernel
casts the *unnormalised* probabilities to ``v.dtype`` before the value
product and divides by the f32 row sum at the end (as the JAX kernel
does); the plain version normalises first, then casts.

``flash_attention.launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from kukeon_tpu_torch.ops import _build
from kukeon_tpu_torch.ops.attention import attention_mask, attention_reference, repeat_kv

TILE = 64
MAX_S = 1 << 16
HEAD_DIMS = (32, 64, 128)


def supports(q_len: int, kv_len: int, block: int = 256) -> bool:
    """Whether the kernel covers this shape (dispatcher guard); the JAX
    package's rule, so both dispatch alike."""
    if q_len != kv_len:
        return False
    b = min(block, q_len)
    return q_len % b == 0 and q_len >= 128


def flash_attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                              q_positions: torch.Tensor,
                              kv_positions: torch.Tensor) -> torch.Tensor:
    """The plain version: position-masked softmax attention in f32, the
    probabilities cast to ``v.dtype`` before the value product."""
    n_rep = q.shape[2] // k.shape[2]
    return attention_reference(q, repeat_kv(k, n_rep), repeat_kv(v, n_rep),
                               attention_mask(q_positions, kv_positions))


def _check(q, k, v, q_positions, kv_positions) -> None:
    if q.ndim != 4 or k.shape != v.shape or k.ndim != 4:
        raise ValueError(f"flash_attention wants q [B,S,H,D] and k, v [B,S,KV,D]; got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    B, S, H, D = q.shape
    if k.shape[0] != B or k.shape[1] != S or k.shape[3] != D or H % k.shape[2]:
        raise ValueError(f"flash_attention shape mismatch: q {tuple(q.shape)}, "
                         f"k/v {tuple(k.shape)} (equal S, H a multiple of KV)")
    if q_positions.shape != (B, S) or kv_positions.shape != (B, S):
        raise ValueError(f"flash_attention wants [B,S] positions; got "
                         f"{tuple(q_positions.shape)}, {tuple(kv_positions.shape)}")
    if not (q.dtype == k.dtype == v.dtype):
        raise ValueError(f"flash_attention wants one dtype; got {q.dtype}, {k.dtype}, {v.dtype}")
    if not (q.device == k.device == v.device == q_positions.device == kv_positions.device):
        raise ValueError("flash_attention operands on different devices")


def _launch(q, k, v, q_positions, kv_positions) -> torch.Tensor:
    B, S, H, D = q.shape
    KV = k.shape[2]
    if q.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"flash_attention kernel takes bfloat16 or float32; got {q.dtype}")
    if D not in HEAD_DIMS:
        raise ValueError(f"flash_attention kernel takes D in {HEAD_DIMS}; got {D}")
    if S % TILE or S > MAX_S:
        raise ValueError(f"flash_attention kernel takes S a multiple of {TILE} up to "
                         f"{MAX_S}; got {S}")
    out = torch.empty((B, S, H, D), dtype=q.dtype, device=q.device)
    strides = []
    for t in (q, k, v, out):
        if t.stride(3) != 1:
            raise ValueError("flash_attention kernel wants the head dim contiguous")
        if q.dtype == torch.bfloat16 and (t.data_ptr() % 16
                                          or any(s % 8 for s in t.stride()[:3])):
            raise ValueError("flash_attention kernel wants 16-byte aligned bf16 rows")
        strides += t.stride()[:3]
    # Fresh int32 copies: the kernel copies kv positions 16 bytes at a time.
    qp = torch.empty((B, S), dtype=torch.int32, device=q.device).copy_(q_positions)
    kp = torch.empty((B, S), dtype=torch.int32, device=q.device).copy_(kv_positions)
    lib = _build.load_flash_attention()
    err = lib.kukeon_flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), qp.data_ptr(),
        kp.data_ptr(), B, S, H, KV, D, (ctypes.c_longlong * 12)(*strides),
        int(q.dtype == torch.bfloat16), torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA error {err} "
                           f"(B={B}, S={S}, H={H}, KV={KV}, D={D}, {q.dtype})")
    flash_attention.launches += 1
    return out


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, q_positions, kv_positions):
        ctx.save_for_backward(q, k, v, q_positions, kv_positions)
        if q.device.type == "cpu":
            return flash_attention_reference(q, k, v, q_positions, kv_positions)
        if q.device.type != "cuda":
            raise ValueError(f"flash_attention: unsupported device {q.device}")
        return _launch(q, k, v, q_positions, kv_positions)

    @staticmethod
    def backward(ctx, g):
        q, k, v, q_positions, kv_positions = ctx.saved_tensors
        with torch.enable_grad():
            qkv = [t.detach().requires_grad_() for t in (q, k, v)]
            out = flash_attention_reference(*qkv, q_positions, kv_positions)
            dq, dk, dv = torch.autograd.grad(out, qkv, g)
        return dq, dk, dv, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    q_positions: torch.Tensor, kv_positions: torch.Tensor,
                    block_q: int = 256, block_k: int = 256) -> torch.Tensor:
    """Position-masked flash attention. q [B, S, H, D]; k, v [B, S, KV, D]
    with H % KV == 0; positions [B, S]. ``block_q``/``block_k`` are the JAX
    signature's and do not change the result (the kernel tiles by 64)."""
    del block_q, block_k
    _check(q, k, v, q_positions, kv_positions)
    return _FlashAttention.apply(q, k, v, q_positions, kv_positions)


flash_attention.launches = 0
