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
- CUDA: the hand-written kernel in ``kukeon_tpu_torch/csrc/flash_attention.cu``,
  built at first use. It replaces the Pallas ``_flash_kernel``. The work
  is bound by the tensor cores (about 750 operations a byte at S 2048,
  D 64), so bf16 takes a Hopper design: a persistent block on each SM
  whose producer warpgroup lists each 128-row q tile's kv tiles and
  streams Q, K and V tiles by TMA into shared-memory rings, ``wgmma`` for
  both products (P from registers, V as an MN-major operand), and two
  consumer warpgroups that take turns on the tensor cores so that one's
  softmax hides behind the other's products. A first small launch takes
  the min and max position of every 64-row chunk, from which the tile
  lists follow. f32 runs a plain-FMA kernel, for the f32 models and
  tests. D must be 32, 64 or 128 and S at least 128 and at most 2^30; a
  ragged last tile is fine (TMA zero-fills, the kernel masks). Past S
  65536 (512 kv tiles) the kernel's kv-tile lists no longer fit shared
  memory and go to an int32 workspace allocated here, one part per SM.
  bf16 operands need every
  stride and base address a multiple of 16 bytes (:func:`check_tma_operand`):
  the launch builds the tensor maps per call over the caller's strides.
  Anything else raises, and so does a failed build or launch.
  There is no fallback.

The backward is the JAX package's: no kernel, the reference attention
recomputed under autograd (``_flash_bwd``), with the gradients of k and v
summed back to their own head count through ``repeat_kv``.

In bf16 the kernel and the plain version round differently: the kernel
casts the *unnormalised* probabilities to ``v.dtype`` before the value
product and divides by the f32 row sum at the end (as the JAX kernel
does); the plain version normalises first, then casts.

``flash_attention.launches`` counts calls that launched the kernel (the
bf16 route's two launches count once).
"""

from __future__ import annotations

import ctypes

import torch

from kukeon_tpu_torch.ops import _build
from kukeon_tpu_torch.ops.attention import attention_mask, attention_reference, repeat_kv

BOX = 64             # rows of a position chunk (bf16 kernel)
MIN_S = 128
MAX_S = 1 << 30
SMEM_TILES = 512     # kv-tile lists of up to this many 128-row tiles stay in shared memory
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


def check_tma_operand(strides: tuple[int, ...], data_ptr: int) -> None:
    """Raise unless the bf16 kernel can read a ``[B, S, X, D]`` operand with
    these element ``strides`` at this address through a TMA tensor map: D
    contiguous, and the byte strides of X, S and B and the base address
    multiples of 16 (TMA's rule). The launch builds the maps (dims, box,
    swizzle) from the same strides."""
    if strides[3] != 1:
        raise ValueError("flash_attention kernel wants the head dim contiguous")
    byte_strides = (strides[2] * 2, strides[1] * 2, strides[0] * 2)
    if any(s % 16 for s in byte_strides):
        raise ValueError(f"flash_attention kernel wants byte strides that are multiples of "
                         f"16 (TMA); got {byte_strides} for strides {tuple(strides)}")
    if data_ptr % 16:
        raise ValueError("flash_attention kernel wants 16-byte aligned bf16 operands")


def _launch(q, k, v, q_positions, kv_positions) -> torch.Tensor:
    B, S, H, D = q.shape
    KV = k.shape[2]
    if q.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"flash_attention kernel takes bfloat16 or float32; got {q.dtype}")
    if D not in HEAD_DIMS:
        raise ValueError(f"flash_attention kernel takes D in {HEAD_DIMS}; got {D}")
    if S < MIN_S or S > MAX_S:
        raise ValueError(f"flash_attention kernel takes S >= {MIN_S} and <= {MAX_S}; got {S}")
    out = torch.empty((B, S, H, D), dtype=q.dtype, device=q.device)
    strides = []
    for t in (q, k, v, out):
        if t.stride(3) != 1:
            raise ValueError("flash_attention kernel wants the head dim contiguous")
        strides += t.stride()[:3]
    if q.dtype == torch.bfloat16:
        for t in (q, k, v):
            check_tma_operand(t.stride(), t.data_ptr())
    qp, kp = (p if p.dtype == torch.int32 and p.is_contiguous() else
              torch.empty((B, S), dtype=torch.int32, device=q.device).copy_(p)
              for p in (q_positions, kv_positions))
    # Per 64-row chunk: min and max of the kv and q positions (the kernel's
    # first launch writes them, its second lists each q tile's kv tiles).
    minmax = torch.empty((B, -(-S // BOX), 4), dtype=torch.int32, device=q.device)
    n_kt = -(-S // 128)
    tile_list = None
    if q.dtype == torch.bfloat16 and n_kt > SMEM_TILES:
        # One pair of lists for each persistent block (at most one an SM).
        sms = torch.cuda.get_device_properties(q.device).multi_processor_count
        tile_list = torch.empty(sms * 2 * n_kt, dtype=torch.int32, device=q.device)
    lib = _build.load_flash_attention()
    err = lib.kukeon_flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), qp.data_ptr(),
        kp.data_ptr(), minmax.data_ptr(), None if tile_list is None else tile_list.data_ptr(),
        0 if tile_list is None else tile_list.numel(), B, S, H, KV, D,
        (ctypes.c_longlong * 12)(*strides), int(q.dtype == torch.bfloat16),
        torch.cuda.current_stream(q.device).cuda_stream)
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
    signature's and do not change the result (the kernel tiles by 128)."""
    del block_q, block_k
    _check(q, k, v, q_positions, kv_positions)
    return _FlashAttention.apply(q, k, v, q_positions, kv_positions)


flash_attention.launches = 0
