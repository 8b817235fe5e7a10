"""Weight-only int8 matmul for decode, the port of
``kukeon_tpu/ops/int8_matmul.py::int8_matmul`` and ``::int8_matmul_expert``.

``h [B, K] @ q [K, N] * s [N] -> [B, N]`` (or ``q [N, K]`` with
``transpose=True``, the tied-embedding LM head), and per expert
``x [E, C, K] @ q [E, K, N] * s [E, N] -> [E, C, N]`` (the MoE expert
stacks). The product accumulates in f32, the f32 scale multiplies the sum,
and one cast gives the activation dtype.

Routes (:func:`_route`, the same for both functions, with C in B's place):

- CPU: :func:`int8_matmul_reference` / :func:`int8_matmul_expert_reference`,
  the plain PyTorch version of the kernel's math.
- CUDA, B <= 64 and K and N multiples of 128 (decode): the hand-written
  kernels in ``kukeon_tpu_torch/csrc/int8_matmul.cu``, built at first
  use; all E experts in one launch. There is no fallback if the build or
  the launch fails.
- CUDA, anything else: the reference's own fallback
  (:func:`int8_matmul_dequant`): dequantize, then ``torch.matmul``, scale
  in the activation dtype. It takes prefill-sized batches, where the large
  product is the reference's XLA one, and dims off 128 (the tiny models),
  which the reference's rule sends there too. It launches none of the
  kernels below and counts nothing.

The kernels replace the Pallas ``_kernel``/``_kernel_t`` and the E
launches of ``int8_matmul_expert``. Decode reads every weight byte once
for a few rows, so HBM bandwidth bounds them. K1 with bf16 activations
(the llama3-8b and Mixtral trunk projections) is one launch a call:
128-column tiles by at most 8 K slices (:func:`k_slice_bf16`) stream the
weights and the rows of h through a 4-stage ``cp.async`` ring, convert the
weights to bf16 exactly in 2.5 ALU operations a weight, and multiply on
``mma.sync``; the slices of a column tile form a thread block cluster,
whose blocks sum them in slice order through distributed shared memory,
scale and cast, so the output is bit-reproducible and no f32 partial
reaches global memory. The bf16 expert product (the Mixtral decode path)
has the same body with the slices summed by a second launch, plus a skip:
a block whose activation rows are all exactly 0 (an expert no token
chose, under dense dispatch) reads no weights and writes +0, the full
product's result bit for bit; its K slices (:func:`k_slice_expert`) go up
to 2048. The f32 and transposed routes keep the first design (f32 FMAs,
K slices from :func:`k_slice`, a second launch for the sum).

``int8_matmul.launches`` and ``int8_matmul_expert.launches`` count calls
that launched a kernel (one per call that reached the kernel), so a run
can show the decode path went through them; ``int8_matmul.launches_t``
counts the transposed ones among the first.
"""

from __future__ import annotations

import torch

from kukeon_tpu_torch.ops import _build

MAX_B = 64
# Enough blocks for two per SM on a 132-SM H100.
_TARGET_BLOCKS = 264
# K1's bf16 kernel: about one block an SM, and at most 8 K slices (the
# portable cluster size, over which the kernel sums the slices).
_BF16_BLOCKS = 128
_BF16_MAX_SPLITS = 8
# The bf16 expert kernel: about four waves of its two blocks an SM, so that
# blocks that skip (no token) or finish early leave no long tail.
_EXPERT_BLOCKS = 1024


def int8_matmul_reference(h: torch.Tensor, q: torch.Tensor, s: torch.Tensor,
                          *, transpose: bool = False) -> torch.Tensor:
    """The kernel's math in plain PyTorch: f32 sum of exact products,
    f32 scale, one cast to ``h.dtype``."""
    w = q.float()
    acc = h.float() @ (w.T if transpose else w)
    return (acc * s.float()).to(h.dtype)


def int8_matmul_expert_reference(x: torch.Tensor, q: torch.Tensor,
                                 s: torch.Tensor) -> torch.Tensor:
    """The kernel's math per expert in plain PyTorch: f32 sum of exact
    products, f32 scale, one cast to ``x.dtype``."""
    acc = torch.bmm(x.float(), q.float())
    return (acc * s.float()[:, None, :]).to(x.dtype)


def int8_matmul_dequant(h: torch.Tensor, q: torch.Tensor, s: torch.Tensor,
                        *, transpose: bool = False) -> torch.Tensor:
    """The reference's fallback: q cast to ``h.dtype``, one matmul in that
    dtype, then the scale in that dtype."""
    w = q.to(h.dtype)
    return (h @ (w.T if transpose else w)) * s.to(h.dtype)


def int8_matmul_expert_dequant(x: torch.Tensor, q: torch.Tensor,
                               s: torch.Tensor) -> torch.Tensor:
    """The reference's fallback per expert, in ``x.dtype`` throughout."""
    return torch.bmm(x, q.to(x.dtype)) * s[:, None, :].to(x.dtype)


def _route(device_type: str, B: int, K: int, N: int) -> str:
    """Which route a call takes: "plain" (CPU), "kernel" (CUDA at decode
    shapes the kernels take) or "dequant" (CUDA otherwise: the reference
    falls back for B > 64 or K or N not a multiple of 128)."""
    if device_type == "cpu":
        return "plain"
    if device_type != "cuda":
        raise ValueError(f"int8_matmul: unsupported device type {device_type}")
    return "dequant" if B > MAX_B or K % 128 or N % 128 else "kernel"


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


def k_slice(B: int, K: int, N: int, transpose: bool, E: int = 1) -> int:
    """Length of the K slice one block sums: the largest of 512/256/128/64
    that divides K and still gives the grid ``_TARGET_BLOCKS`` blocks (the
    smallest that divides K when none does); ``E`` experts multiply the
    grid."""
    rb = 1 if B == 1 else 2 if B == 2 else 4 if B <= 4 else 8
    tiles = -(-N // (32 if transpose else 512)) * -(-B // rb) * E
    cands = (512, 256, 128) if transpose else (512, 256, 128, 64)
    fits = [ks for ks in cands if K % ks == 0]
    for ks in fits:
        if tiles * (K // ks) >= _TARGET_BLOCKS:
            return ks
    return fits[-1]


def k_slice_expert(C: int, K: int, N: int, E: int) -> int:
    """K slice of the bf16 expert kernel: the largest of 2048/1024/512/256/128
    that divides K and still gives ``_EXPERT_BLOCKS`` blocks (128-column
    tiles x 8-row groups x E experts x slices); the smallest that divides K
    when none does. Longer slices stream more weights per block and leave
    a smaller f32 workspace to reduce."""
    tiles = (N // 128) * -(-C // 8) * E
    fits = [ks for ks in (2048, 1024, 512, 256, 128) if K % ks == 0]
    for ks in fits:
        if tiles * (K // ks) >= _EXPERT_BLOCKS:
            return ks
    return fits[-1]


def k_slice_bf16(B: int, K: int, N: int) -> int:
    """K slice of K1's bf16 kernel: a multiple of 128 that divides K into
    at most 8 slices; the largest such up to 2048 that still gives
    ``_BF16_BLOCKS`` blocks (128-column tiles x 8-row groups x slices),
    else the smallest (the most blocks)."""
    m = K // 128
    fits = [128 * d for d in range(m, 0, -1) if m % d == 0 and m // d <= _BF16_MAX_SPLITS]
    tiles = (N // 128) * -(-B // 8)
    for ks in fits:
        if ks <= 2048 and tiles * (K // ks) >= _BF16_BLOCKS:
            return ks
    return fits[-1]


def int8_matmul(h: torch.Tensor, q: torch.Tensor, s: torch.Tensor,
                *, transpose: bool = False) -> torch.Tensor:
    """h [B, K] @ int8 weights, dequantized on the fly.

    ``transpose=False``: q [K, N], s [N] -> out [B, N]
    ``transpose=True``:  q [N, K], s [N] -> out [B, N]
    """
    B, K, N = _check(h, q, s, transpose)
    route = _route(h.device.type, B, K, N)
    if route == "plain":
        return int8_matmul_reference(h, q, s, transpose=transpose)
    if route == "dequant":
        return int8_matmul_dequant(h, q, s, transpose=transpose)
    if q.data_ptr() % 16 or h.data_ptr() % 16:
        raise ValueError("int8_matmul kernel wants h and q 16-byte aligned")
    lib = _build.load_int8_matmul()
    out = torch.empty((B, N), dtype=h.dtype, device=h.device)
    stream = torch.cuda.current_stream(h.device).cuda_stream
    if h.dtype == torch.bfloat16 and not transpose:
        ks = k_slice_bf16(B, K, N)
        err = lib.kukeon_int8_matmul_bf16(h.data_ptr(), q.data_ptr(), s.data_ptr(),
                                          out.data_ptr(), B, K, N, ks, stream)
    else:
        ks = k_slice(B, K, N, transpose)
        ws = torch.empty((K // ks, B, N), dtype=torch.float32, device=h.device)
        err = lib.kukeon_int8_matmul(
            h.data_ptr(), q.data_ptr(), s.data_ptr(), out.data_ptr(), ws.data_ptr(),
            B, K, N, ks, int(transpose), int(h.dtype == torch.bfloat16), stream)
    if err != 0:
        raise RuntimeError(f"int8_matmul kernel launch failed: CUDA error {err} "
                           f"(B={B}, K={K}, N={N}, ks={ks}, transpose={transpose})")
    int8_matmul.launches += 1
    int8_matmul.launches_t += int(transpose)
    return out


int8_matmul.launches = 0      # every kernel launch
int8_matmul.launches_t = 0    # the transposed (tied LM head) ones among them


def _check_expert(x: torch.Tensor, q: torch.Tensor,
                  s: torch.Tensor) -> tuple[int, int, int, int]:
    if x.ndim != 3 or q.ndim != 3 or s.ndim != 2:
        raise ValueError(f"int8_matmul_expert wants x [E,C,K], q [E,K,N], s [E,N]; got "
                         f"{tuple(x.shape)}, {tuple(q.shape)}, {tuple(s.shape)}")
    E, C, K = x.shape
    N = q.shape[2]
    if tuple(q.shape) != (E, K, N) or tuple(s.shape) != (E, N) or C < 1:
        raise ValueError(f"int8_matmul_expert shape mismatch: x {tuple(x.shape)}, "
                         f"q {tuple(q.shape)}, s {tuple(s.shape)}")
    if q.dtype != torch.int8 or s.dtype != torch.float32:
        raise ValueError(f"int8_matmul_expert wants q int8 and s float32; got "
                         f"{q.dtype}, {s.dtype}")
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"int8_matmul_expert wants x bfloat16 or float32; got {x.dtype}")
    if not (x.device == q.device == s.device):
        raise ValueError(f"int8_matmul_expert operands on different devices: "
                         f"{x.device}, {q.device}, {s.device}")
    if not (x.is_contiguous() and q.is_contiguous() and s.is_contiguous()):
        raise ValueError("int8_matmul_expert wants contiguous x, q and s")
    return E, C, K, N


def int8_matmul_expert(x: torch.Tensor, q: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """Per-expert x [E, C, K] @ q [E, K, N] * s [E, N] -> [E, C, N]: the MoE
    decode expert stacks (w_gate/w_up/w_down), all experts in one launch.
    On CUDA with bf16 x, rows of x that are exactly 0 cost no weight reads
    (the kernel skips a block whose rows are all 0) and come out +0."""
    E, C, K, N = _check_expert(x, q, s)
    route = _route(x.device.type, C, K, N)
    if route == "plain":
        return int8_matmul_expert_reference(x, q, s)
    if route == "dequant":
        return int8_matmul_expert_dequant(x, q, s)
    if q.data_ptr() % 16 or x.data_ptr() % 16:
        raise ValueError("int8_matmul_expert kernel wants x and q 16-byte aligned")
    lib = _build.load_int8_matmul()
    bf16 = x.dtype == torch.bfloat16
    ks = k_slice_expert(C, K, N, E) if bf16 else k_slice(C, K, N, False, E)
    out = torch.empty((E, C, N), dtype=x.dtype, device=x.device)
    ws = torch.empty((K // ks, E * C, N), dtype=torch.float32, device=x.device)
    err = lib.kukeon_int8_matmul_expert(
        x.data_ptr(), q.data_ptr(), s.data_ptr(), out.data_ptr(), ws.data_ptr(),
        E, C, K, N, ks, int(bf16), torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"int8_matmul_expert kernel launch failed: CUDA error {err} "
                           f"(E={E}, C={C}, K={K}, N={N}, ks={ks})")
    int8_matmul_expert.launches += 1
    return out


int8_matmul_expert.launches = 0
