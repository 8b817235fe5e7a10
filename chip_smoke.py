"""Drive the PyTorch/CUDA port on one GPU: build its kernels, hold each
against its plain version, check the 8B and Mixtral models, serve both,
and train.

    python3 chip_smoke.py
    python3 chip_smoke.py --phases card,moe_kernel   # a subset; no result line

Phases, in the order they run, each printing one JSON line with its wall
time; any failure ends the run with a nonzero exit and no result line:

  card        nvidia-smi name and power limit, versions, and the build of
              both CUDA sources (csrc/int8_matmul.cu, csrc/flash_attention.cu),
              one nvcc each, started together; ptxas registers, shared
              memory and spills for every kernel; the count of HGMMA (wgmma)
              and HMMA (mma.sync) instructions in each kernel's SASS
              (cuobjdump), which shows the tensor-core path was compiled in
  kernel      int8_matmul vs int8_matmul_reference at every llama3-8b decode
              shape (and the llama3-1b tied head, transposed), B in
              {1, 3, 4, 16, 64}; at B = 4: kernel, plain and library times
              (CUDA events, median of 20 cold-L2 runs) beside the bound, and
              the kernel's device time by projection (torch.profiler, cold
              L2); one bf16 call is one kernel launch (profiler), and a
              second call at every 8B shape, B 4 and 64, is bit-identical
  flash       flash_attention vs flash_attention_reference: llama3-1b
              training heads (B 4, S 2048, H 32, KV 8, D 64), llama3-8b heads
              (B 1, S 1024, D 128), offset positions, KV = H, a ragged S
              (160), and an f32 case; at the llama3-1b shape: kernel, plain
              and library (scaled_dot_product_attention) times beside the
              bound, the kernels' device time (torch.profiler), and the
              shares of the bf16 peak; then S 8192 (B 1, H 8, KV 2, D 64)
              in full and S 65792 (B 1, H 1, D 64, kv-tile lists past
              shared memory) on three 256-row query slices against all keys
  moe_kernel  int8_matmul_expert vs int8_matmul_expert_reference at both
              Mixtral-8x7B expert shapes (E 8; K x N 4096 x 14336 and
              14336 x 4096), C in {1, 3, 4, 16, 64}, and an f32 case; at
              C = 4: kernel, plain and library times beside the bound with
              every expert's rows filled, and with the rows of a decode step
              (4 tokens routed top-2 of 8 from a seed: the experts no token
              chose keep zero rows, their outputs must be exactly +0, and
              the bound counts only the weights of the experts in use); the
              device time of the kernel and of its reduce launch
  model       llama3-8b int8 on the card: one prefill and one decode step
              through the kernel and through the dequant product; logits
              agree; the step makes 225 kernel launches
  serve       the port's ServingCell("llama3-8b", dtype="int8", 4 slots,
              max_seq_len 1024) over HTTP: 4 concurrent 128-token prompts,
              64 greedy tokens each, a repeat for determinism, /readyz;
              torch.profiler over 4 more requests (device busy share, top
              kernels and host operators)
  serve_tied  a short llama3-1b run, whose tied LM head takes the
              transposed kernel
  serve_tiny  short int8 runs of tiny and mixtral-tiny, whose dims off 128
              take the reference's dequant fallback on the card
  moe_model   mixtral-8x7b int8 at full width and depth, drawn once on the
              card by the serving cell of serve_moe: one prefill (B 4,
              S 128) and one decode step through the kernels and through
              the dequant products; the step makes 129 int8_matmul and 96
              int8_matmul_expert launches; logits agree on rows routed
              alike, and a routing flip happens only on a near tie
  serve_moe   that ServingCell over HTTP: 4 concurrent 128-token prompts,
              32 greedy tokens each, a repeat, /readyz, a profiled window
  train       the port's trainer through its entry point
              (kukeon_tpu_torch.training.cli.main): llama3-1b at full width
              and depth, bf16, B 4, S 2048, 8 steps with checkpoints at 4
              and 8, then a resumed run of 2 more steps; the loss falls,
              32 flash launches a step, restored params equal the saved ones

The last lines: the nvidia-smi line, a {"kernels": [...]} line, and
{"ok": true, "device": {...}}. Exits nonzero without a CUDA device, and
in a directory that holds this file and nothing else of the repository.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gc
import io
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request

import numpy as np
import torch

# Peak HBM bandwidth by card (NVIDIA data sheets), bytes/s, and the dense
# bf16 tensor-core rate, FLOP/s. Rates assume the full power limit.
HBM_BPS = (("H200", 4.8e12), ("H100 NVL", 3.9e12), ("H100 PCIe", 2.0e12),
           ("H100", 3.35e12))
BF16_FLOPS = 989e12
K1_REPLACES = "kukeon_tpu/ops/int8_matmul.py:40"      # _kernel
K1T_REPLACES = "kukeon_tpu/ops/int8_matmul.py:46"     # _kernel_t
K1_SOURCE = "kukeon_tpu_torch/csrc/int8_matmul.cu"
K2_REPLACES = "kukeon_tpu/ops/int8_matmul.py:101"     # int8_matmul_expert
K3_REPLACES = "kukeon_tpu/ops/flash_attention.py:36"  # _flash_kernel
K3_SOURCE = "kukeon_tpu_torch/csrc/flash_attention.cu"
# Flash cases: (label, B, S, H, KV, D, dtype, position offsets per batch row).
FLASH_CASES = (
    ("llama3-1b train", 4, 2048, 32, 8, 64, torch.bfloat16, None),
    ("llama3-8b heads", 1, 1024, 32, 8, 128, torch.bfloat16, None),
    ("offset positions", 2, 1024, 8, 2, 64, torch.bfloat16, (100, 7)),
    ("KV = H", 2, 1024, 8, 8, 64, torch.bfloat16, None),
    ("ragged S", 2, 160, 8, 2, 64, torch.bfloat16, None),
    ("f32", 1, 256, 4, 2, 32, torch.float32, (5, )),
)
K3_DESIGN = ("persistent, wgmma + TMA: 128-row q tiles, producer warpgroup with a "
             "3-stage (2 at D 128) K/V ring and double-buffered Q, two consumer "
             "warpgroups taking turns on the tensor cores, P from registers, V MN-major")
K1_DESIGN = ("bf16: one launch; 128-column tiles x at most 8 K slices, 4-stage cp.async "
             "ring of weights and rows of h, mma.sync m16n8k16 with exact prmt/fadd "
             "int8->bf16; the slices of a tile form a cluster that sums them in slice "
             "order through distributed shared memory")
K2_DESIGN = ("bf16: zero-expert skip, 4-stage cp.async weight ring, mma.sync "
             "m16n8k16 with exact prmt/fadd int8->bf16, fixed-order split-K reduce")
MOE_TOKENS, MOE_TOP_K = 4, 2
TRAIN_B, TRAIN_S, TRAIN_STEPS, TRAIN_MORE = 4, 2048, 8, 2
# (K, N) of the llama3-8b decode projections, with launches per step.
SHAPES_8B = {"wq": (4096, 4096, 32), "wk": (4096, 1024, 32), "wv": (4096, 1024, 32),
             "wo": (4096, 4096, 32), "w_gate": (4096, 14336, 32),
             "w_up": (4096, 14336, 32), "w_down": (14336, 4096, 32),
             "lm_head": (4096, 128256, 1)}
TIED_1B = (2048, 128256)
BATCHES = (1, 3, 4, 16, 64)
# Mixtral-8x7B decode: (K, N, launches per step) of the trunk's int8_matmul
# calls and of the expert stacks' int8_matmul_expert calls (E experts each).
MOE_E = 8
SHAPES_MIXTRAL = {"wq": (4096, 4096, 32), "wk": (4096, 1024, 32), "wv": (4096, 1024, 32),
                  "wo": (4096, 4096, 32), "lm_head": (4096, 32000, 1)}
SHAPES_MOE = {"w_gate": (4096, 14336, 32), "w_up": (4096, 14336, 32),
              "w_down": (14336, 4096, 32)}
# Flash past the shape cases: (label, B, S, H, KV, D, query rows checked
# per slice, or None for all). 65792 is the first S above 65536 that
# supports() admits: the kernel's kv-tile lists leave shared memory.
FLASH_LONG = (("S 8192", 1, 8192, 8, 2, 64, None),
              ("S 65792", 1, 65792, 1, 1, 64, 256))
PHASES = ("card", "kernel", "flash", "moe_kernel", "model", "serve", "serve_tied",
          "serve_tiny", "moe_model", "serve_moe", "train")      # in the order they run


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


@contextlib.contextmanager
def phase(name: str, out: dict):
    t0 = time.monotonic()
    yield out
    out["phase"] = name
    out["wall_s"] = round(time.monotonic() - t0, 3)
    emit(out)


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip().splitlines()[0]


def hbm_bps(name: str) -> float:
    return next(bps for key, bps in HBM_BPS if key in name)


def cold_median_ms(fn, flush: torch.Tensor, runs: int = 20, warm: int = 3) -> float:
    """Median of ``runs`` CUDA-event timings of ``fn``, each after the L2
    cache is overwritten (decode finds its weights cold)."""
    for _ in range(warm):
        fn()
    times = []
    for _ in range(runs):
        flush.zero_()
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def bound_ms(B: int, K: int, N: int, bps: float, E: int = 1) -> tuple[float, str]:
    """Least time for h[B,K] bf16 @ int8 [K,N] * s[N] (E such products for
    the experts): each input read once, the bf16 output written once, over
    the peak HBM rate; or the 2BKN operations over the bf16 rate, whichever
    is larger."""
    t_bytes = E * (K * N + 4 * N + 2 * B * K + 2 * B * N) / bps * 1e3
    t_ops = E * 2 * B * K * N / BF16_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def within_tol(out: torch.Tensor, ref: torch.Tensor) -> tuple[bool, float, float]:
    """Kernel vs plain version, both in the working dtype: every element
    within 1 ulp of its own magnitude (2^-7 relative in bf16, 2^-20 in f32:
    the f32 sums differ only in order, then one rounding) plus 1e-3 of the
    output's RMS for outputs near zero, where reordered f32 sums dominate."""
    o, r = out.float(), ref.float()
    err = (o - r).abs()
    ulp = 2.0 ** -7 if ref.dtype == torch.bfloat16 else 2.0 ** -20
    rms = r.pow(2).mean().sqrt()
    ok = bool(torch.all(err <= ulp * r.abs() + 1e-3 * rms))
    return ok, float(err.max()), float((err / (r.abs() + rms)).max())


def library_call(h, q_kn, s):
    """One PyTorch call for the same function, where the installed build
    has it on CUDA: torch._weight_int8pack_mm (q [N,K], scale in h's dtype).
    Else dequant + torch.matmul, labelled as two calls."""
    q_nk = q_kn.T.contiguous()
    s_h = s.to(h.dtype)
    try:
        torch._weight_int8pack_mm(h, q_nk, s_h)
        torch.cuda.synchronize()
        return (lambda: torch._weight_int8pack_mm(h, q_nk, s_h)), "torch._weight_int8pack_mm"
    except (RuntimeError, NotImplementedError, AttributeError):
        return (lambda: (h @ q_kn.to(h.dtype)) * s_h), "dequant+torch.matmul (2 calls)"


def phase_kernel(k1, bps: float, flush: torch.Tensor) -> dict:
    """Hold the kernel against its plain version at every shape; time it at
    B = 4. Returns the per-step K1 and the K1t entries' numbers."""
    g = torch.Generator(device="cuda").manual_seed(1)
    cases = [(name, K, N, False) for name, (K, N, _n) in SHAPES_8B.items()
             if name not in ("wv", "wo", "w_up")]          # shapes repeat
    cases.append(("tied_head_1b", TIED_1B[0], TIED_1B[1], True))
    worst_abs, worst_rel, timings, lib_label = 0.0, 0.0, {}, None
    for name, K, N, transpose in cases:
        qshape = (N, K) if transpose else (K, N)
        q = torch.randint(-127, 128, qshape, generator=g, device="cuda", dtype=torch.int8)
        s = torch.rand(N, generator=g, device="cuda") * 0.02 + 1e-3
        for B in BATCHES:
            h = torch.randn((B, K), generator=g, device="cuda").to(torch.bfloat16)
            out = k1.int8_matmul(h, q, s, transpose=transpose)
            ref = k1.int8_matmul_reference(h, q, s, transpose=transpose)
            torch.cuda.synchronize()
            ok, ea, er = within_tol(out, ref)
            if not ok or not torch.isfinite(out).all():
                raise AssertionError(f"int8_matmul disagrees with its plain version at "
                                     f"{name} B={B}: max abs {ea}, max rel {er}")
            worst_abs, worst_rel = max(worst_abs, ea), max(worst_rel, er)
            if B != 4:
                continue
            t = {"ms": cold_median_ms(lambda: k1.int8_matmul(h, q, s, transpose=transpose), flush),
                 "plain_ms": cold_median_ms(
                     lambda: k1.int8_matmul_reference(h, q, s, transpose=transpose), flush)}
            lib, lib_label = library_call(h, q.T if transpose else q, s)
            t["library_ms"] = cold_median_ms(lib, flush)
            t["bound_ms"], t["bound_by"] = bound_ms(4, K, N, bps)
            t["device_ms"] = sum(kernel_device_ms(
                lambda: k1.int8_matmul(h, q, s, transpose=transpose), flush).values())
            t["max_abs_err"] = ea
            timings[name] = t
        del q, s
    # f32 activations (llama_tiny's dtype) take the kernel's float path.
    h = torch.randn((4, 4096), generator=g, device="cuda")
    q = torch.randint(-127, 128, (4096, 4096), generator=g, device="cuda", dtype=torch.int8)
    s = torch.rand(4096, generator=g, device="cuda") * 0.02
    ok, ea32, _ = within_tol(k1.int8_matmul(h, q, s), k1.int8_matmul_reference(h, q, s))
    if not ok:
        raise AssertionError(f"int8_matmul f32 path disagrees: max abs {ea32}")
    for name in ("wv", "wo", "w_up"):
        timings[name] = timings[{"wv": "wk", "wo": "wq", "w_up": "w_gate"}[name]]
    return {"timings": timings, "max_abs_err": worst_abs, "max_rel_err": worst_rel,
            "f32_max_abs_err": ea32, "library_call": lib_label,
            "tolerance": "|err| <= 2^-7 |ref| + 1e-3 rms(ref) (bf16), 2^-20 (f32)"}


def k1_one_launch(k1) -> dict:
    """K1's bf16 route: a second call at every 8B shape (B 4 and 64) gives
    the first call's bits (every sum in a fixed order), and one call is one
    kernel launch in the profiler."""
    from torch.profiler import ProfilerActivity, profile

    g = torch.Generator(device="cuda").manual_seed(4)
    for name, (K, N, _n) in SHAPES_8B.items():
        q = torch.randint(-127, 128, (K, N), generator=g, device="cuda", dtype=torch.int8)
        s = torch.rand(N, generator=g, device="cuda") * 0.02 + 1e-3
        for B in (4, 64):
            h = torch.randn((B, K), generator=g, device="cuda").to(torch.bfloat16)
            first, second = k1.int8_matmul(h, q, s), k1.int8_matmul(h, q, s)
            torch.cuda.synchronize()
            if not torch.equal(first.view(torch.int16), second.view(torch.int16)):
                raise AssertionError(f"int8_matmul: a repeated call at {name} B={B} "
                                     f"gave other bits")
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        k1.int8_matmul(h, q, s)
        torch.cuda.synchronize()
    kernels = {e.key[:60]: e.count for e in device_kernels(prof)}
    if sum(kernels.values()) != 1:
        raise AssertionError(f"one bf16 int8_matmul call launched {kernels}, want 1 kernel")
    return {"kernels_per_call": kernels, "repeat_bit_identical": True}


def expert_library_call(x, q, s):
    """The same grouped product through PyTorch: no single call computes it,
    so E calls of torch._weight_int8pack_mm (q [N,K], scale in x's dtype)
    where the installed build has it on CUDA, else dequant + torch.bmm."""
    E = x.shape[0]
    try:
        q_nk = [q[e].T.contiguous() for e in range(E)]
        s_x = [s[e].to(x.dtype) for e in range(E)]
        torch._weight_int8pack_mm(x[0], q_nk[0], s_x[0])
        torch.cuda.synchronize()

        def run():
            for e in range(E):
                torch._weight_int8pack_mm(x[e], q_nk[e], s_x[e])
        return run, f"torch._weight_int8pack_mm ({E} calls)"
    except (RuntimeError, NotImplementedError, AttributeError):
        return ((lambda: torch.bmm(x, q.to(x.dtype)) * s[:, None, :].to(x.dtype)),
                "dequant+torch.bmm (3 calls)")


def decode_routing(g: torch.Generator) -> list[int]:
    """Tokens per expert at one Mixtral decode step: MOE_TOKENS tokens, each
    routed to its top MOE_TOP_K of MOE_E experts by seeded router logits.
    Dense dispatch fills an expert's first n slots (full capacity, C =
    MOE_TOKENS) and leaves the rest, and every slot of an expert no token
    chose, at exactly 0."""
    logits = torch.randn((MOE_TOKENS, MOE_E), generator=g, device="cuda")
    top = logits.topk(MOE_TOP_K, dim=-1).indices
    return torch.bincount(top.flatten(), minlength=MOE_E).tolist()


def kernel_device_ms(fn, flush: torch.Tensor, calls: int = 5) -> dict:
    """Device ms a call of each kernel ``fn`` launches: torch.profiler over
    ``calls`` calls, each after the L2 cache is overwritten (as for
    cold_median_ms), the overwrite's own kernel left out."""
    from torch.profiler import ProfilerActivity, profile

    def rows(body) -> dict:
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                body()
            torch.cuda.synchronize()
        return {e.key[:48]: round(dev_us(e) / 1e3 / calls, 4) for e in device_kernels(prof)}

    drop = rows(flush.zero_)
    return {k: v for k, v in rows(lambda: (flush.zero_(), fn())).items() if k not in drop}


def phase_moe_kernel(k1, bps: float, flush: torch.Tensor) -> dict:
    """Hold the grouped expert kernel against its plain version at both
    Mixtral-8x7B expert shapes and every C; time it at C = 4, every
    expert's rows filled and with the rows of a routed decode step."""
    g = torch.Generator(device="cuda").manual_seed(2)
    counts = decode_routing(g)
    empty = [e for e in range(MOE_E) if counts[e] == 0]
    worst_abs, worst_rel, timings, lib_label, split = 0.0, 0.0, {}, None, {}
    for name in ("w_gate", "w_down"):
        K, N, _n = SHAPES_MOE[name]
        q = torch.randint(-127, 128, (MOE_E, K, N), generator=g, device="cuda",
                          dtype=torch.int8)
        s = torch.rand((MOE_E, N), generator=g, device="cuda") * 0.02 + 1e-3
        for C in BATCHES:
            x = torch.randn((MOE_E, C, K), generator=g, device="cuda").to(torch.bfloat16)
            out = k1.int8_matmul_expert(x, q, s)
            ref = k1.int8_matmul_expert_reference(x, q, s)
            torch.cuda.synchronize()
            ok, ea, er = within_tol(out, ref)
            if not ok or not torch.isfinite(out).all():
                raise AssertionError(f"int8_matmul_expert disagrees with its plain version "
                                     f"at {name} C={C}: max abs {ea}, max rel {er}")
            worst_abs, worst_rel = max(worst_abs, ea), max(worst_rel, er)
            if C != 4:
                continue
            lib, lib_label = expert_library_call(x, q, s)
            t = {"ms": cold_median_ms(lambda: k1.int8_matmul_expert(x, q, s), flush),
                 "plain_ms": cold_median_ms(
                     lambda: k1.int8_matmul_expert_reference(x, q, s), flush),
                 "library_ms": cold_median_ms(lib, flush)}
            t["bound_ms"], t["bound_by"] = bound_ms(4, K, N, bps, MOE_E)
            t["max_abs_err"] = ea
            timings[name] = t
            split[name] = kernel_device_ms(lambda: k1.int8_matmul_expert(x, q, s), flush)
        # The rows of a decode step: expert e's first counts[e] slots filled.
        x = torch.zeros((MOE_E, MOE_TOKENS, K), device="cuda", dtype=torch.bfloat16)
        for e, n in enumerate(counts):
            x[e, :n] = torch.randn((n, K), generator=g, device="cuda").to(torch.bfloat16)
        out = k1.int8_matmul_expert(x, q, s)
        ref = k1.int8_matmul_expert_reference(x, q, s)
        torch.cuda.synchronize()
        ok, ea, er = within_tol(out, ref)
        if not ok or not torch.isfinite(out).all():
            raise AssertionError(f"int8_matmul_expert disagrees with its plain version at "
                                 f"{name}, routed rows {counts}: max abs {ea}, max rel {er}")
        for e, n in enumerate(counts):     # zero rows give exactly +0 (bits 0)
            if not (torch.all(out[e, n:].view(torch.int16) == 0)
                    and torch.all(ref[e, n:].view(torch.int16) == 0)):
                raise AssertionError(f"int8_matmul_expert: zero rows of expert {e} at {name} "
                                     f"are not +0 (routed rows {counts})")
        lib, _ = expert_library_call(x, q, s)
        t = {"ms": cold_median_ms(lambda: k1.int8_matmul_expert(x, q, s), flush),
             "plain_ms": cold_median_ms(lambda: k1.int8_matmul_expert_reference(x, q, s), flush),
             "library_ms": cold_median_ms(lib, flush)}
        t["bound_ms"], t["bound_by"] = bound_ms(4, K, N, bps, MOE_E - len(empty))
        t["device_ms"] = sum(kernel_device_ms(lambda: k1.int8_matmul_expert(x, q, s),
                                              flush).values())
        t["max_abs_err"] = ea
        t["empty_experts"] = len(empty)
        timings[name + "_routed"] = t
        del q, s
    # f32 activations take the kernel's float path.
    x = torch.randn((MOE_E, 4, 4096), generator=g, device="cuda")
    q = torch.randint(-127, 128, (MOE_E, 4096, 1024), generator=g, device="cuda",
                      dtype=torch.int8)
    s = torch.rand((MOE_E, 1024), generator=g, device="cuda") * 0.02
    ok, ea32, _ = within_tol(k1.int8_matmul_expert(x, q, s),
                             k1.int8_matmul_expert_reference(x, q, s))
    if not ok:
        raise AssertionError(f"int8_matmul_expert f32 path disagrees: max abs {ea32}")
    timings["w_up"] = timings["w_gate"]
    timings["w_up_routed"] = timings["w_gate_routed"]
    return {"timings": timings, "max_abs_err": worst_abs, "max_rel_err": worst_rel,
            "f32_max_abs_err": ea32, "library_call": lib_label, "experts": MOE_E,
            "routing_tokens_per_expert": counts, "empty_experts": len(empty),
            "device_ms_per_call_c4": split,
            "tolerance": "|err| <= 2^-7 |ref| + 1e-3 rms(ref) (bf16), 2^-20 (f32); "
                         "zero rows exactly +0"}


def logits_agree(a: torch.Tensor, b: torch.Tensor, stage: str) -> dict:
    """Kernel vs dequant logits [B, V]: cosine >= 0.999 per row and the
    same top-1 on all rows but one."""
    if not (torch.isfinite(a).all() and torch.isfinite(b).all()):
        raise AssertionError(f"{stage} logits not finite")
    cos = torch.nn.functional.cosine_similarity(a, b, dim=-1)
    top1 = int((a.argmax(-1) == b.argmax(-1)).sum())
    out = {"min_cosine": float(cos.min()), "top1_agree": f"{top1}/{a.shape[0]}"}
    if float(cos.min()) < 0.999 or top1 < a.shape[0] - 1:
        raise AssertionError(f"{stage}: kernel vs dequant logits {out}")
    return out


def phase_model(k1) -> dict:
    from kukeon_tpu_torch.models import convert, llama

    cfg = llama.llama3_8b()
    g = torch.Generator(device="cuda").manual_seed(0)
    params = convert.init_quantized_params_device(cfg, g, "cuda")
    B, S = 4, 128
    toks = torch.randint(0, cfg.vocab_size, (B, S), generator=g, device="cuda")
    pos = torch.arange(S, device="cuda")[None, :].expand(B, S)
    nxt = torch.randint(0, cfg.vocab_size, (B, 1), generator=g, device="cuda")
    logits = {}
    launches = {}
    with torch.no_grad():
        for flag in (True, False):
            c = dataclasses.replace(cfg, int8_pallas=flag)
            cache = llama.KVCache.create(c, B, 256, device="cuda")
            pre, cache = llama.forward(params, c, toks, pos, cache)
            before = k1.int8_matmul.launches
            dec, cache = llama.forward(params, c, nxt, cache.lengths[:, None], cache)
            torch.cuda.synchronize()
            launches[flag] = k1.int8_matmul.launches - before
            logits[flag] = (pre[:, -1].float(), dec[:, 0].float())
    if launches[True] != 225 or launches[False] != 0:
        raise AssertionError(f"decode step launches {launches}, want 225 with the kernel")
    out = {"decode_step_launches": launches[True]}
    for i, stage in enumerate(("prefill", "decode")):
        out[stage] = logits_agree(logits[True][i], logits[False][i], stage)
    out["tolerance"] = "cosine >= 0.999 per row, same top-1 on >= 3 of 4 rows"
    del params
    return out


# A routing decision whose 2nd and 3rd router probabilities lie this close
# is a near tie: the kernel and dequant paths differ by bf16 roundings
# (relative 2^-8 a product, some 1e-2 after 32 layers), which move router
# logits by ~1e-2 and a probability gap by ~1e-2 at most.
NEAR_TIE = 0.02


def phase_moe_model(k1, params) -> dict:
    """mixtral-8x7b int8 (the serving cell's own weights): a prefill and a
    decode step with the kernels on and off. The decode step's launches are
    counted and the logits compared. Each layer's top-2 routing of the two
    runs is compared too: at decode every row is its own token (full
    capacity, no token sees another), so a row whose routing flips on a
    near tie may leave the cosine bound; it must flip on a near tie, keep
    its top-1, and every row routed alike must meet the bound."""
    from kukeon_tpu_torch.models import llama, moe

    cfg = moe.mixtral_8x7b()
    g = torch.Generator(device="cuda").manual_seed(0)
    B, S = 4, 128
    toks = torch.randint(0, cfg.vocab_size, (B, S), generator=g, device="cuda")
    pos = torch.arange(S, device="cuda")[None, :].expand(B, S)
    nxt = torch.randint(0, cfg.vocab_size, (B, 1), generator=g, device="cuda")
    logits, launches, routes, wall = {}, {}, {}, {}
    real_block = moe.moe_block
    K = cfg.experts_per_token

    def recording_block(h, w, c, inference=False, kernel=False):
        probs = torch.softmax(h.reshape(-1, h.shape[-1]).float() @ w["router"], dim=-1)
        top = torch.topk(probs, K + 1, dim=-1)
        routes[flag].append((top.indices[:, :K].sort(-1)[0],
                             top.values[:, K - 1] - top.values[:, K]))
        return real_block(h, w, c, inference, kernel)

    with torch.no_grad():
        for flag in (True, False):
            c = dataclasses.replace(cfg, int8_pallas=flag)
            cache = llama.KVCache.create(c, B, 256, device="cuda")
            torch.cuda.synchronize()
            t0 = time.monotonic()
            pre, cache = moe.forward(params, c, toks, pos, cache)
            torch.cuda.synchronize()
            t1 = time.monotonic()
            before = (k1.int8_matmul.launches, k1.int8_matmul_expert.launches)
            routes[flag] = []
            moe.moe_block = recording_block
            try:
                dec, cache = moe.forward(params, c, nxt, cache.lengths[:, None], cache)
            finally:
                moe.moe_block = real_block
            torch.cuda.synchronize()
            wall[flag] = {"prefill_ms": round((t1 - t0) * 1e3, 3),
                          "decode_step_ms": round((time.monotonic() - t1) * 1e3, 3)}
            launches[flag] = (k1.int8_matmul.launches - before[0],
                              k1.int8_matmul_expert.launches - before[1])
            logits[flag] = (pre[:, -1].float(), dec[:, 0].float())
            del cache
    if launches[True] != (129, 96) or launches[False] != (0, 0):
        raise AssertionError(f"decode step launches (int8_matmul, int8_matmul_expert) "
                             f"{launches}, want (129, 96) with the kernels")
    first_flip = {}
    for layer, ((ia, ga), (ib, gb)) in enumerate(zip(routes[True], routes[False])):
        for row in torch.nonzero(~(ia == ib).all(-1)).flatten().tolist():
            first_flip.setdefault(row, {"layer": layer, "gap_kernel": float(ga[row]),
                                        "gap_dequant": float(gb[row])})
    a, b = logits[True][1], logits[False][1]
    cos = torch.nn.functional.cosine_similarity(a, b, dim=-1).tolist()
    top1 = int((a.argmax(-1) == b.argmax(-1)).sum())
    out = {"decode_step_launches": {"int8_matmul": 129, "int8_matmul_expert": 96},
           "host_clock_ms": {"kernels": wall[True], "dequant": wall[False]},
           "prefill": logits_agree(logits[True][0], logits[False][0], "prefill"),
           "decode": {"cosine_per_row": cos, "top1_agree": f"{top1}/{B}",
                      "first_routing_flip_by_row": first_flip},
           "routing_agreement_per_layer": [float((ia == ib).all(-1).float().mean())
                                           for (ia, _), (ib, _) in zip(routes[True],
                                                                       routes[False])],
           "tolerance": f"cosine >= 0.999 on every row routed alike at every layer; a row "
                        f"that flips does so first where both runs' 2nd-3rd router "
                        f"probability gap is <= {NEAR_TIE}; same top-1 on >= 3 of 4 rows"}
    ok = (torch.isfinite(a).all() and torch.isfinite(b).all() and top1 >= B - 1
          and all(cos[r] >= 0.999 for r in range(B) if r not in first_flip)
          and all(max(f["gap_kernel"], f["gap_dequant"]) <= NEAR_TIE
                  for f in first_flip.values()))
    if not ok:
        raise AssertionError(f"decode: kernel vs dequant {out}")
    return out


def post(url: str, body: dict) -> dict:
    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=600) as r:
        return json.loads(r.read())


def dev_us(e) -> float:
    """Device time of a profiler row, in microseconds."""
    return getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)


def device_kernels(prof) -> list:
    """The profiler's kernel rows (not the host-side operators, whose
    device time repeats their kernels')."""
    return [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA and dev_us(e) > 0]


def profile_serving(engine, prompts, new: int) -> dict:
    """torch.profiler over requests submitted straight to the running
    engine: device busy share of the wall time, the kernels that take the
    device time, and the host operators that take the host's, by name."""
    from torch.profiler import ProfilerActivity, profile

    from kukeon_tpu_torch.serving.sampling import SamplingParams

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        reqs = [engine.submit(p, SamplingParams(max_new_tokens=new)) for p in prompts]
        for r in reqs:
            r.done.wait(600)
        torch.cuda.synchronize()
        wall_ms = (time.monotonic() - t0) * 1e3

    kernels = device_kernels(prof)
    busy_ms = sum(dev_us(e) for e in kernels) / 1e3
    top = sorted(kernels, key=dev_us, reverse=True)[:8]
    host = sorted((e for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CPU),
                  key=lambda e: e.self_cpu_time_total, reverse=True)[:8]
    return {"wall_ms": round(wall_ms, 2), "device_busy_ms": round(busy_ms, 2),
            "device_idle_share": round(1 - busy_ms / wall_ms, 4),
            "top_device_ms": [[e.key[:60], round(dev_us(e) / 1e3, 3), e.count] for e in top],
            "top_host_self_ms": [[e.key[:60], round(e.self_cpu_time_total / 1e3, 3), e.count]
                                 for e in host]}


def make_cell(model: str, max_seq_len: int):
    from kukeon_tpu_torch.runtime.serving_cell import ServingCell

    return ServingCell(model, dtype="int8", num_slots=4, max_seq_len=max_seq_len,
                       device="cuda")


def serve_model(k1, model: str, *, max_seq_len: int, prompt_len: int, new: int,
                requests: int = 4, profile_new: int = 0, cell=None) -> dict:
    """The port's main path: ServingCell over HTTP, int8 weights, 4 slots
    (``cell``: one already built, whose boot is then only its warmup).
    Kernel counts are zeroed just before the requests and read just after."""
    from kukeon_tpu_torch.runtime.serving_cell import serve

    t0 = time.monotonic()
    torch.cuda.reset_peak_memory_stats()
    cell = cell or make_cell(model, max_seq_len)
    cell.warmup(prompt_len)
    cell.engine.start()
    server = serve(cell)
    cell.mark_ready()
    base = f"http://127.0.0.1:{server.server_address[1]}"
    boot_s = time.monotonic() - t0
    try:
        with urllib.request.urlopen(base + "/readyz", timeout=30) as r:
            ready = r.status
        g = torch.Generator().manual_seed(7)
        prompts = [torch.randint(0, cell.cfg.vocab_size, (prompt_len,), generator=g).tolist()
                   for _ in range(requests)]
        results = [None] * requests
        k1.int8_matmul.launches = k1.int8_matmul.launches_t = 0
        k1.int8_matmul_expert.launches = 0

        def run(i):
            results[i] = post(base + "/v1/generate",
                              {"promptTokens": prompts[i], "maxNewTokens": new})

        t1 = time.monotonic()
        threads = [threading.Thread(target=run, args=(i,)) for i in range(requests)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        wall = time.monotonic() - t1
        repeat = post(base + "/v1/generate", {"promptTokens": prompts[0], "maxNewTokens": new})
        torch.cuda.synchronize()
        launches = {"k1": k1.int8_matmul.launches - k1.int8_matmul.launches_t,
                    "k1t": k1.int8_matmul.launches_t, "k2": k1.int8_matmul_expert.launches}
        prof = (profile_serving(cell.engine, prompts, profile_new)
                if profile_new else None)
    finally:
        server.shutdown()
        server.server_close()
        cell.engine.stop()
    if ready != 200:
        raise AssertionError(f"/readyz answered {ready}")
    for i, r in enumerate(results):
        if r is None or r["numTokens"] != new or len(r["tokens"]) != new:
            raise AssertionError(f"request {i} came back wrong: {r}")
    if repeat["tokens"] != results[0]["tokens"]:
        raise AssertionError("the same prompt sent twice gave different tokens")
    step_ms = [(r["seconds"] - r["ttftSeconds"]) / (new - 1) * 1e3 for r in results]
    out = {
        "model": model, "requests": requests, "prompt_len": prompt_len, "new_tokens": new,
        "boot_s": round(boot_s, 3),
        "decode_tok_s": round(requests * new / wall, 2),
        "ttft_ms": sorted(round(r["ttftSeconds"] * 1e3, 2) for r in results),
        "ms_per_decode_step": round(statistics.median(step_ms), 3),
        "launches": launches, "repeat_identical": True, "readyz": ready,
        "peak_mem_gb": round(torch.cuda.max_memory_allocated() / 1e9, 2),
    }
    if prof is not None:
        out["profile"] = prof
    del cell
    gc.collect()
    torch.cuda.empty_cache()
    return out


def flash_within_tol(out: torch.Tensor, ref: torch.Tensor,
                     v: torch.Tensor) -> tuple[bool, float, float]:
    """Kernel vs plain version. f32: 2e-5 relative plus absolute (the same
    math summed in another order). bf16: the two round p at different
    places (the kernel casts the unnormalised p to bf16 and divides by the
    f32 sum at the end; the plain version normalises, then casts), each a
    relative 2^-8 on every weight of the average, and both round the
    output: |err| <= 2^-7 (|ref| + max|v|), and the error's RMS within
    2^-7 of the output's, which a systematic error of 1% would break."""
    o, r = out.float(), ref.float()
    err = (o - r).abs()
    rel_rms = float(err.pow(2).mean().sqrt() / r.pow(2).mean().sqrt())
    if ref.dtype == torch.float32:
        ok = bool(torch.all(err <= 2e-5 * (r.abs() + 1)))
    else:
        ok = bool(torch.all(err <= 2.0 ** -7 * (r.abs() + v.float().abs().max())))
        ok = ok and rel_rms <= 2.0 ** -7
    return ok and bool(torch.isfinite(o).all()), float(err.max()), rel_rms


def flash_flops(B: int, S: int, H: int, D: int) -> float:
    """Operations of causal attention's two products: 2 B H S^2 D."""
    return 2.0 * B * H * S * S * D


def phase_flash(fa, bps: float, flush: torch.Tensor) -> dict:
    """Hold the flash kernel against its plain version at every case; time
    it at the llama3-1b training shape."""
    import torch.nn.functional as F

    from kukeon_tpu_torch.ops.attention import repeat_kv

    g = torch.Generator(device="cuda").manual_seed(3)
    cases, timing = [], None
    for label, B, S, H, KV, D, dt, offsets in FLASH_CASES:
        q = torch.randn((B, S, H, D), generator=g, device="cuda").to(dt)
        k = torch.randn((B, S, KV, D), generator=g, device="cuda").to(dt)
        v = torch.randn((B, S, KV, D), generator=g, device="cuda").to(dt)
        pos = torch.arange(S, device="cuda", dtype=torch.int32)[None, :].expand(B, S)
        if offsets is not None:
            pos = pos + torch.tensor(offsets, device="cuda", dtype=torch.int32)[:B, None]
        pos = pos.contiguous()
        out = fa.flash_attention(q, k, v, pos, pos)
        ref = fa.flash_attention_reference(q, k, v, pos, pos)
        torch.cuda.synchronize()
        ok, ea, rel = flash_within_tol(out, ref, v)
        cases.append({"case": label, "shape": [B, S, H, KV, D], "dtype": str(dt)[6:],
                      "max_abs_err": ea, "rel_rms_err": rel})
        if not ok:
            raise AssertionError(f"flash_attention disagrees with its plain version: "
                                 f"{cases[-1]}")
        if label != "llama3-1b train":
            continue
        n_rep = H // KV
        qt, kt, vt = (x.transpose(1, 2) for x in (q, repeat_kv(k, n_rep), repeat_kv(v, n_rep)))
        timing = {
            "ms": cold_median_ms(lambda: fa.flash_attention(q, k, v, pos, pos), flush),
            "plain_ms": cold_median_ms(
                lambda: fa.flash_attention_reference(q, k, v, pos, pos), flush),
            "library_ms": cold_median_ms(
                lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True), flush),
            "library_call": "torch.nn.functional.scaled_dot_product_attention"
                            "(is_causal=True) on expanded K/V",
            "max_abs_err": ea, "shape": [B, S, H, KV, D],
        }
        e = q.element_size()
        t_bytes = (2 * B * S * H * D + 2 * B * S * KV * D) * e / bps * 1e3
        t_ops = flash_flops(B, S, H, D) / BF16_FLOPS * 1e3
        timing["bound_ms"], timing["bound_by"] = ((t_ops, "operations") if t_ops >= t_bytes
                                                  else (t_bytes, "bytes"))
        timing["tflops"] = flash_flops(B, S, H, D) / timing["ms"] / 1e9
        timing["peak_share"] = timing["tflops"] * 1e12 / BF16_FLOPS
        # The kernels' own device time (the cold median above also holds
        # whatever host time of the wrapper the L2 flush does not hide).
        timing["device_ms_per_call"] = kernel_device_ms(
            lambda: fa.flash_attention(q, k, v, pos, pos), flush)
        timing["device_ms"] = sum(timing["device_ms_per_call"].values())
        timing["device_peak_share"] = (flash_flops(B, S, H, D) / (timing["device_ms"] / 1e3)
                                       / BF16_FLOPS)
        del qt, kt, vt
    return {"cases": cases, "timing": timing,
            "tolerance": "bf16: |err| <= 2^-7 (|ref| + max|v|) and rms(err) <= 2^-7 "
                         "rms(ref); f32: |err| <= 2e-5 (|ref| + 1)"}


def flash_long(fa) -> list:
    """The flash kernel past the shape cases (FLASH_LONG), against the
    plain version on the query rows checked: all of them, or three slices
    (start, middle, end) against every key, the same function restricted
    to those rows, which keeps the plain version's f32 scores small."""
    g = torch.Generator(device="cuda").manual_seed(5)
    cases = []
    for label, B, S, H, KV, D, rows in FLASH_LONG:
        q = torch.randn((B, S, H, D), generator=g, device="cuda").to(torch.bfloat16)
        k = torch.randn((B, S, KV, D), generator=g, device="cuda").to(torch.bfloat16)
        v = torch.randn((B, S, KV, D), generator=g, device="cuda").to(torch.bfloat16)
        pos = torch.arange(S, device="cuda", dtype=torch.int32)[None, :].expand(B, S).contiguous()
        before = fa.flash_attention.launches
        out = fa.flash_attention(q, k, v, pos, pos)
        torch.cuda.synchronize()
        if fa.flash_attention.launches != before + 1:
            raise AssertionError(f"flash_attention at {label} launched no kernel")
        starts = [0] if rows is None else [0, (S - rows) // 2, S - rows]
        n = S if rows is None else rows
        worst_abs, worst_rel = 0.0, 0.0
        for a in starts:
            ref = fa.flash_attention_reference(q[:, a:a + n], k, v, pos[:, a:a + n], pos)
            ok, ea, rel = flash_within_tol(out[:, a:a + n], ref, v)
            if not ok:
                raise AssertionError(f"flash_attention disagrees with its plain version at "
                                     f"{label}, query rows {a}..{a + n}: max abs {ea}, "
                                     f"rel rms {rel}")
            worst_abs, worst_rel = max(worst_abs, ea), max(worst_rel, rel)
            del ref
        cases.append({"case": label, "shape": [B, S, H, KV, D], "query_rows_from": starts,
                      "query_rows": n, "max_abs_err": worst_abs, "rel_rms_err": worst_rel})
        del q, k, v, out
        torch.cuda.empty_cache()
    return cases


def zipf_dataset(path: str, n_tokens: int, seed: int) -> None:
    """Token ids with a Zipf-like law over the first 4096 ids of the
    vocabulary: a unigram the model can learn within a few steps."""
    from kukeon_tpu_torch.training import TokenDataset

    rng = np.random.default_rng(seed)
    TokenDataset.write(path, (rng.zipf(1.2, n_tokens) - 1) % 4096)


def profile_train_step(data: str) -> dict:
    """torch.profiler over one llama3-1b train step (after two warm-up
    steps), outside the CLI: device busy share of the step's wall time,
    the flash kernel's device time, and the kernels that take the most."""
    from torch.profiler import ProfilerActivity, profile

    from kukeon_tpu_torch.models import llama
    from kukeon_tpu_torch.training import TokenDataset, batches, create_train_state
    from kukeon_tpu_torch.training.train_step import make_optimizer, make_train_step

    cfg = llama.llama3_1b()
    opt = make_optimizer(3e-4, warmup_steps=1, total_steps=TRAIN_STEPS)
    state, opt = create_train_state(cfg, torch.Generator(device="cuda").manual_seed(1),
                                    "cuda", opt)
    step = make_train_step(cfg, opt)
    feed = batches(TokenDataset(data), TRAIN_B, TRAIN_S, num_steps=3, device="cuda")
    for i, (_s, *batch) in enumerate(feed):
        if i < 2:
            state, loss = step(state, *batch)
            float(loss)
            continue
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.monotonic()
            state, loss = step(state, *batch)
            float(loss)
            torch.cuda.synchronize()
            wall_ms = (time.monotonic() - t0) * 1e3
    kernels = device_kernels(prof)
    busy_ms = sum(dev_us(e) for e in kernels) / 1e3

    def kind(name: str) -> str:
        low = name.lower()
        if "flash_fwd" in name:
            return "flash"
        if any(w in low for w in ("gemm", "xmma", "nvjet", "cutlass")):
            return "gemm_f32" if "f32f32_f32f32" in low or "sgemm" in low else "gemm_bf16"
        return "softmax" if "softmax" in low else "other"

    by_kind: dict[str, float] = {}
    for e in kernels:
        by_kind[kind(e.key)] = by_kind.get(kind(e.key), 0.0) + dev_us(e) / 1e3
    top = sorted(kernels, key=dev_us, reverse=True)[:10]
    return {"wall_ms": round(wall_ms, 2), "device_busy_ms": round(busy_ms, 2),
            "device_idle_share": round(1 - busy_ms / wall_ms, 4),
            "device_ms_by_kind": {k: round(v, 3) for k, v in sorted(by_kind.items())},
            "top_device_ms": [[e.key[:70], round(dev_us(e) / 1e3, 3), e.count] for e in top]}


def phase_train(fa) -> dict:
    """The port's trainer, in process, through its entry point."""
    import kukeon_tpu_torch.training as training
    from kukeon_tpu_torch.models import llama
    from kukeon_tpu_torch.training import cli
    from kukeon_tpu_torch.training.train_step import tree_leaves

    cfg = llama.llama3_1b()
    saved, restored = {}, {}
    real_save, real_restore = training.save_checkpoint, training.restore_checkpoint

    def save(root, state):          # keeps a host copy of what was saved at the end
        if state.step == TRAIN_STEPS and "params" not in saved:
            saved["params"] = [t.detach().to("cpu", copy=True) for t in tree_leaves(state.params)]
        return real_save(root, state)

    def restore(root, template, step=None):
        state = real_restore(root, template, step)
        restored["step"] = state.step
        restored["params"] = [t.detach().to("cpu", copy=True) for t in tree_leaves(state.params)]
        return state

    tmp = tempfile.mkdtemp(prefix="kukeon-train-")
    try:
        data = os.path.join(tmp, "tokens.bin")
        zipf_dataset(data, 4_000_000, seed=0)
        ckpt = os.path.join(tmp, "ckpt")
        common = ["--dataset", data, "--model", "llama3-1b", "--batch", str(TRAIN_B),
                  "--seq-len", str(TRAIN_S), "--lr", "3e-4", "--warmup-steps", "1",
                  "--log-every", "1", "--ckpt-dir", ckpt, "--save-every", "4"]
        training.save_checkpoint, training.restore_checkpoint = save, restore
        try:
            gc.collect()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            buf = io.StringIO()
            fa.flash_attention.launches = 0
            with contextlib.redirect_stdout(buf):
                rc = cli.main(common + ["--steps", str(TRAIN_STEPS)])
            torch.cuda.synchronize()
            launches = fa.flash_attention.launches
            peak_gb = torch.cuda.max_memory_allocated() / 1e9
            first_log = buf.getvalue()
            steps_saved = sorted(os.listdir(ckpt))
            shutil.rmtree(os.path.join(ckpt, "step_00000004"))   # disk: keep the newest
            gc.collect()
            torch.cuda.empty_cache()
            buf = io.StringIO()
            fa.flash_attention.launches = 0
            with contextlib.redirect_stdout(buf):
                rc2 = cli.main(common + ["--steps", str(TRAIN_STEPS + TRAIN_MORE)])
            torch.cuda.synchronize()
            launches2 = fa.flash_attention.launches
            second_log = buf.getvalue()
        finally:
            training.save_checkpoint, training.restore_checkpoint = real_save, real_restore
        gc.collect()
        torch.cuda.empty_cache()
        prof = profile_train_step(data)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    sys.stdout.write(first_log + second_log)

    def parse(log):
        rows = [ln.split() for ln in log.splitlines() if ln.startswith("step ")]
        return {int(r[1]): (float(r[3]), float(r[4].lstrip("("))) for r in rows}

    run1, run2 = parse(first_log), parse(second_log)
    losses = [run1[i][0] for i in sorted(run1)] + [run2[i][0] for i in sorted(run2)]
    if rc != 0 or rc2 != 0:
        raise AssertionError(f"training exited {rc}, {rc2}")
    if sorted(run1) != list(range(1, TRAIN_STEPS + 1)) or \
            sorted(run2) != list(range(TRAIN_STEPS + 1, TRAIN_STEPS + TRAIN_MORE + 1)):
        raise AssertionError(f"unexpected step lines: {sorted(run1)}, {sorted(run2)}")
    if not all(math.isfinite(x) for x in losses) or not losses[-1] < losses[0]:
        raise AssertionError(f"loss did not fall: {losses}")
    if steps_saved != ["step_00000004", "step_00000008"]:
        raise AssertionError(f"checkpoints {steps_saved}, want steps 4 and 8")
    if f"train: resumed from step {TRAIN_STEPS}" not in second_log or \
            restored.get("step") != TRAIN_STEPS:
        raise AssertionError(f"the second run did not resume at step {TRAIN_STEPS}")
    if len(saved["params"]) != len(restored["params"]) or not all(
            torch.equal(a, b) for a, b in zip(saved["params"], restored["params"])):
        raise AssertionError("restored params differ from the saved ones")
    per_step = 2 * cfg.num_layers       # forward + remat recompute, every layer
    if launches != per_step * TRAIN_STEPS or launches2 != per_step * TRAIN_MORE:
        raise AssertionError(f"flash launches {launches} and {launches2}, want "
                             f"{per_step} a step")
    tokens = TRAIN_B * TRAIN_S
    step_ms = statistics.median(tokens / run1[i][1] * 1e3 for i in range(3, TRAIN_STEPS + 1))
    flops = (6.0 * cfg.param_count() * tokens
             + 3 * cfg.num_layers * flash_flops(TRAIN_B, TRAIN_S, cfg.num_heads, cfg.head_dim))
    return {"model": "llama3-1b", "batch": TRAIN_B, "seq_len": TRAIN_S,
            "steps": TRAIN_STEPS, "resumed_steps": TRAIN_MORE,
            "params": cfg.param_count(), "losses": losses,
            "first_loss": losses[0], "last_loss": losses[-1],
            "step_ms_median_3_8": round(step_ms, 3),
            "tokens_per_s": round(tokens / step_ms * 1e3, 1),
            "mfu": round(flops / (step_ms / 1e3) / BF16_FLOPS, 4),
            "mfu_flops_per_step": flops,
            "peak_mem_gb": round(peak_gb, 2),
            "flash_launches": launches, "flash_launches_per_step": launches // TRAIN_STEPS,
            "flash_launches_resumed": launches2,
            "resumed_from": restored["step"], "restored_params_bitwise_equal": True,
            "profile": prof}


def sass_counts(built: dict) -> dict:
    """{source: {kernel: {"HGMMA": n, "HMMA": n}}} from cuobjdump's SASS of
    each built library: the tensor-core instructions each kernel holds."""
    from kukeon_tpu_torch.ops import _build

    tool = os.path.join(os.path.dirname(_build.find_nvcc()), "cuobjdump")
    out = {}
    for src, (path, _log, _secs) in built.items():
        sass = subprocess.run([tool, "--dump-sass", str(path)], capture_output=True, text=True,
                              timeout=300, check=True).stdout
        counts, fn = {}, None
        for line in sass.splitlines():
            if "Function :" in line:
                fn = line.split("Function :")[1].strip()
                counts[fn] = {"HGMMA": 0, "HMMA": 0}
            elif fn is not None:
                for op in ("HGMMA", "HMMA"):
                    if op + "." in line:
                        counts[fn][op] += 1
        out[src] = {k: v for k, v in counts.items() if v["HGMMA"] or v["HMMA"]}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default=",".join(PHASES),
                    help="comma-separated subset of " + ",".join(PHASES)
                         + " (card always runs); a subset prints no result line")
    phases = ap.parse_args(argv).phases.split(",")
    if not set(phases) <= set(PHASES):
        ap.error(f"unknown phases {sorted(set(phases) - set(PHASES))}")
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script needs a GPU",
              file=sys.stderr)
        return 2
    from kukeon_tpu_torch.ops import _build
    from kukeon_tpu_torch.ops import flash_attention as fa
    from kukeon_tpu_torch.ops import int8_matmul as k1

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = nvidia_smi()
    name = torch.cuda.get_device_name(0)
    bps = hbm_bps(name)

    with phase("card", {}) as p:
        t0 = time.monotonic()
        built = _build.build_all()
        p.update(nvidia_smi=smi, device=name, torch=torch.__version__,
                 cuda=torch.version.cuda, python=sys.version.split()[0],
                 hbm_bytes_per_s=bps, build_wall_s=round(time.monotonic() - t0, 2),
                 build_s={src: round(secs, 2) for src, (_p, _l, secs) in built.items()},
                 tmp_free_gb=round(shutil.disk_usage(tempfile.gettempdir()).free / 1e9, 1),
                 ptxas={src: [ln.strip() for ln in log.splitlines()
                              if "Compiling entry" in ln or "registers" in ln or "spill" in ln
                              or "warning" in ln]
                        for src, (_p, log, _s) in built.items()},
                 sass_tensor_core_ops=sass_counts(built))
        flash_hgmma = sum(v["HGMMA"] for k, v in p["sass_tensor_core_ops"][
            _build.FLASH_ATTENTION].items() if "flash_fwd_bf16" in k)
        if flash_hgmma == 0:
            raise AssertionError("the bf16 flash kernels hold no HGMMA instruction")
        k1_hmma = sum(v["HMMA"] for k, v in p["sass_tensor_core_ops"][
            _build.INT8_MATMUL].items() if "int8_mm_bf16" in k)
        if k1_hmma == 0:
            raise AssertionError("int8_mm_bf16_kernel holds no HMMA instruction")

    res = {}

    def run(phase_name, fn):
        if phase_name in phases:
            with phase(phase_name, {}) as p:
                p.update(fn())
            res[phase_name] = p
        gc.collect()
        torch.cuda.empty_cache()

    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    run("kernel", lambda: {**phase_kernel(k1, bps, flush), **k1_one_launch(k1)})
    run("flash", lambda: {**phase_flash(fa, bps, flush), "long_s": flash_long(fa)})
    run("moe_kernel", lambda: phase_moe_kernel(k1, bps, flush))
    del flush
    run("model", lambda: phase_model(k1))
    run("serve", lambda: {
        **serve_model(k1, "llama3-8b", max_seq_len=1024, prompt_len=128, new=64,
                      profile_new=32),
        "bound_ms_per_decode_step": round(sum(
            bound_ms(4, K, N, bps)[0] * n for K, N, n in SHAPES_8B.values()), 4)})
    run("serve_tied", lambda: serve_model(k1, "llama3-1b", max_seq_len=256, prompt_len=32,
                                          new=16))
    run("serve_tiny", lambda: {m: serve_model(k1, m, max_seq_len=256, prompt_len=32, new=16)
                               for m in ("tiny", "mixtral-tiny")})
    # One Mixtral-8x7B draw (46.7 GB of int8) serves both of its phases.
    cell = {}
    if "moe_model" in phases or "serve_moe" in phases:
        t0 = time.monotonic()
        cell["moe"] = make_cell("mixtral-8x7b", 1024)
        cell["draw_s"] = round(time.monotonic() - t0, 3)
    run("moe_model", lambda: {"draw_s": cell["draw_s"],
                              **phase_moe_model(k1, cell["moe"].engine.params)})
    run("serve_moe", lambda: {
        **serve_model(k1, "mixtral-8x7b", max_seq_len=1024, prompt_len=128, new=32,
                      profile_new=16, cell=cell["moe"]),
        "bound_ms_per_decode_step": round(
            sum(bound_ms(4, K, N, bps)[0] * n for K, N, n in SHAPES_MIXTRAL.values())
            + sum(bound_ms(4, K, N, bps, MOE_E)[0] * n for K, N, n in SHAPES_MOE.values()),
            4)})
    cell.clear()

    def train():
        out = phase_train(fa)
        if "flash" in res:
            out["flash_share_of_step"] = round(res["flash"]["timing"]["ms"]
                                               * out["flash_launches_per_step"]
                                               / out["step_ms_median_3_8"], 4)
        return out

    run("train", train)
    if set(phases) != set(PHASES):
        print("chip_smoke: ran a subset of the phases; no result line", file=sys.stderr)
        return 0

    kern, flash, moe_kern = res["kernel"], res["flash"], res["moe_kernel"]
    serve8, serve1, serve_moe, train = (res["serve"], res["serve_tied"], res["serve_moe"],
                                        res["train"])
    ft = flash["timing"]
    for label, run_, key in (("llama3-8b", serve8, "k1"), ("llama3-1b", serve1, "k1t"),
                             ("mixtral-8x7b", serve_moe, "k1"), ("mixtral-8x7b", serve_moe, "k2")):
        if run_["launches"][key] <= 0:
            raise AssertionError(f"{label} serving launched no {key} kernel")

    # K1: one llama3-8b decode step's worth of calls at B = 4 (225 launches).
    fields = ("ms", "plain_ms", "library_ms", "bound_ms")
    t = kern["timings"]
    per_step = {f: round(sum(t[nm][f] * SHAPES_8B[nm][2] for nm in SHAPES_8B), 4)
                for f in fields}
    tied = t["tied_head_1b"]
    # K2: one mixtral-8x7b decode step's worth at C = 4 (96 launches).
    tm = moe_kern["timings"]
    per_step_moe = {f: round(sum(tm[nm][f] * SHAPES_MOE[nm][2] for nm in SHAPES_MOE), 4)
                    for f in fields}
    kernels = [
        {"name": "int8_matmul", "route": "cuda", "source": K1_SOURCE,
         "replaces": K1_REPLACES, "launches": serve8["launches"]["k1"],
         "max_abs_err": kern["max_abs_err"], **per_step, "bound_by": "bytes",
         "library_ms_call": kern["library_call"],
         "device_ms": round(sum(t[nm]["device_ms"] * SHAPES_8B[nm][2] for nm in SHAPES_8B), 4),
         "device_ms_per_call": {nm: round(t[nm]["device_ms"], 4) for nm in SHAPES_8B},
         "kernels_per_call": sum(kern["kernels_per_call"].values()),
         "repeat_bit_identical": kern["repeat_bit_identical"], "design": K1_DESIGN,
         "unit": "one llama3-8b decode step at B=4 (225 launches); device_ms_per_call: "
                 "one call of each projection at B=4"},
        {"name": "int8_matmul_transposed", "route": "cuda", "source": K1_SOURCE,
         "replaces": K1T_REPLACES, "launches": serve1["launches"]["k1t"],
         "max_abs_err": tied["max_abs_err"], "ms": round(tied["ms"], 4),
         "plain_ms": round(tied["plain_ms"], 4), "bound_ms": round(tied["bound_ms"], 4),
         "bound_by": tied["bound_by"], "library_ms": round(tied["library_ms"], 4),
         "library_ms_call": kern["library_call"], "device_ms": round(tied["device_ms"], 4),
         "unit": "llama3-1b tied LM head, B=4"},
        {"name": "flash_attention", "route": "cuda", "source": K3_SOURCE,
         "replaces": K3_REPLACES, "launches": train["flash_launches"],
         "max_abs_err": max(c["max_abs_err"] for c in flash["cases"]),
         **{f: round(ft[f], 4) for f in fields},
         "bound_by": ft["bound_by"], "library_ms_call": ft["library_call"],
         "peak_share": round(ft["peak_share"], 4), "device_ms": round(ft["device_ms"], 4),
         "device_peak_share": round(ft["device_peak_share"], 4), "design": K3_DESIGN,
         "unit": "one call at B=4 S=2048 H=32 KV=8 D=64 bf16 (llama3-1b training); "
                 f"{train['flash_launches_per_step']} launches per train step"},
        {"name": "int8_matmul_expert", "route": "cuda", "source": K1_SOURCE,
         "replaces": K2_REPLACES, "launches": serve_moe["launches"]["k2"],
         "max_abs_err": moe_kern["max_abs_err"], **per_step_moe,
         "bound_by": tm["w_gate"]["bound_by"], "library_ms_call": moe_kern["library_call"],
         "per_call": {nm: {f: round(tm[nm][f], 4) for f in fields}
                      for nm in ("w_gate", "w_down", "w_gate_routed", "w_down_routed")},
         "device_ms_per_call": {nm: round(sum(moe_kern["device_ms_per_call_c4"][nm].values()), 4)
                                for nm in ("w_gate", "w_down")},
         "empty_experts_routed": moe_kern["empty_experts"], "design": K2_DESIGN,
         "unit": "one mixtral-8x7b decode step at C=4 (96 launches of E=8 experts), every "
                 "expert's rows filled; per_call: one launch, filled and with the rows of a "
                 "routed decode step (its bound counts the experts in use)"},
    ]
    # The serve phases' end-to-end numbers again, short, so that the last
    # lines of the output carry every number the run is quoted for.
    e2e_keys = ("decode_tok_s", "ttft_ms", "ms_per_decode_step", "launches")
    emit({"end_to_end": {
        "llama3-8b": {**{k: serve8[k] for k in e2e_keys},
                      "bound_ms_per_decode_step": serve8["bound_ms_per_decode_step"],
                      "device_idle_share": serve8["profile"]["device_idle_share"]},
        "llama3-1b": {k: serve1[k] for k in e2e_keys},
        "mixtral-8x7b": {**{k: serve_moe[k] for k in e2e_keys + ("peak_mem_gb",)},
                         "bound_ms_per_decode_step": serve_moe["bound_ms_per_decode_step"],
                         "device_idle_share": serve_moe["profile"]["device_idle_share"]},
        "train_llama3-1b": {k: train[k] for k in (
            "step_ms_median_3_8", "tokens_per_s", "mfu", "peak_mem_gb", "first_loss",
            "last_loss", "flash_launches_per_step", "flash_share_of_step")}}})
    print(smi, flush=True)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
