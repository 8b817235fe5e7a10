"""Weight-only int8 matmul for decode, the port of
``kukeon_tpu/ops/int8_matmul.py::int8_matmul``.

``h [B, K] @ q [K, N] * s [N] -> [B, N]`` (or ``q [N, K]`` with
``transpose=True``, the tied-embedding LM head). The product accumulates
in f32, the f32 scale multiplies the sum, and one cast gives ``h.dtype``.

Routes, by where the tensors lie:

- CPU: :func:`int8_matmul_reference`, the plain PyTorch version of the
  kernel's math.
- CUDA, B <= 64 (decode): the hand-written kernel in
  ``kukeon_tpu_torch/csrc/int8_matmul.cu``, built at first use. K and N
  must be multiples of 128; anything else raises. There is no fallback if
  the build or the launch fails.
- CUDA, B > 64 (prefill): dequantize then ``torch.matmul``, scale in
  ``h.dtype`` — the large product the reference leaves to XLA.

``int8_matmul.launches`` counts kernel launches (one per call that reached
the kernel), so a run can show the decode path went through it;
``int8_matmul.launches_t`` counts the transposed ones among them.
"""

from __future__ import annotations

import torch

from kukeon_tpu_torch.ops import _build

MAX_B = 64
# Enough blocks for two per SM on a 132-SM H100.
_TARGET_BLOCKS = 264


def int8_matmul_reference(h: torch.Tensor, q: torch.Tensor, s: torch.Tensor,
                          *, transpose: bool = False) -> torch.Tensor:
    """The kernel's math in plain PyTorch: f32 sum of exact products,
    f32 scale, one cast to ``h.dtype``."""
    w = q.float()
    acc = h.float() @ (w.T if transpose else w)
    return (acc * s.float()).to(h.dtype)


def _check(h: torch.Tensor, q: torch.Tensor, s: torch.Tensor,
           transpose: bool) -> tuple[int, int, int]:
    if h.ndim != 2 or q.ndim != 2 or s.ndim != 1:
        raise ValueError(f"int8_matmul wants h [B,K], q 2-D, s [N]; got "
                         f"{tuple(h.shape)}, {tuple(q.shape)}, {tuple(s.shape)}")
    B, K = h.shape
    N, Kq = (q.shape if transpose else (q.shape[1], q.shape[0]))
    if Kq != K or s.shape[0] != N or B < 1:
        raise ValueError(f"int8_matmul shape mismatch: h {tuple(h.shape)}, "
                         f"q {tuple(q.shape)} (transpose={transpose}), "
                         f"s {tuple(s.shape)}")
    if q.dtype != torch.int8 or s.dtype != torch.float32:
        raise ValueError(f"int8_matmul wants q int8 and s float32; got "
                         f"{q.dtype}, {s.dtype}")
    if h.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"int8_matmul wants h bfloat16 or float32; got {h.dtype}")
    if not (h.device == q.device == s.device):
        raise ValueError(f"int8_matmul operands on different devices: "
                         f"{h.device}, {q.device}, {s.device}")
    if not (h.is_contiguous() and q.is_contiguous() and s.is_contiguous()):
        raise ValueError("int8_matmul wants contiguous h, q and s")
    return B, K, N


def k_slice(B: int, K: int, N: int, transpose: bool) -> int:
    """Length of the K slice one block sums: the largest of 512/256/128/64
    that divides K and still gives the grid ``_TARGET_BLOCKS`` blocks (the
    smallest that divides K when none does)."""
    rb = 1 if B == 1 else 2 if B == 2 else 4 if B <= 4 else 8
    tiles = -(-N // (32 if transpose else 512)) * -(-B // rb)
    cands = (512, 256, 128) if transpose else (512, 256, 128, 64)
    fits = [ks for ks in cands if K % ks == 0]
    for ks in fits:
        if tiles * (K // ks) >= _TARGET_BLOCKS:
            return ks
    return fits[-1]


def int8_matmul(h: torch.Tensor, q: torch.Tensor, s: torch.Tensor,
                *, transpose: bool = False) -> torch.Tensor:
    """h [B, K] @ int8 weights, dequantized on the fly.

    ``transpose=False``: q [K, N], s [N] -> out [B, N]
    ``transpose=True``:  q [N, K], s [N] -> out [B, N]
    """
    B, K, N = _check(h, q, s, transpose)
    if h.device.type == "cpu":
        return int8_matmul_reference(h, q, s, transpose=transpose)
    if h.device.type != "cuda":
        raise ValueError(f"int8_matmul: unsupported device {h.device}")
    if B > MAX_B:
        w = q.to(h.dtype)
        return (h @ (w.T if transpose else w)) * s.to(h.dtype)
    if K % 128 or N % 128:
        raise ValueError(f"int8_matmul kernel takes K and N multiples of 128; "
                         f"got K={K}, N={N}")
    if q.data_ptr() % 16:
        raise ValueError("int8_matmul kernel wants q 16-byte aligned")
    lib = _build.load_int8_matmul()
    ks = k_slice(B, K, N, transpose)
    out = torch.empty((B, N), dtype=h.dtype, device=h.device)
    ws = torch.empty((K // ks, B, N), dtype=torch.float32, device=h.device)
    err = lib.kukeon_int8_matmul(
        h.data_ptr(), q.data_ptr(), s.data_ptr(), out.data_ptr(), ws.data_ptr(),
        B, K, N, ks, int(transpose), int(h.dtype == torch.bfloat16),
        torch.cuda.current_stream(h.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"int8_matmul kernel launch failed: CUDA error {err} "
                           f"(B={B}, K={K}, N={N}, ks={ks}, transpose={transpose})")
    int8_matmul.launches += 1
    int8_matmul.launches_t += int(transpose)
    return out


int8_matmul.launches = 0      # every kernel launch
int8_matmul.launches_t = 0    # the transposed (tied LM head) ones among them
