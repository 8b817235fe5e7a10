"""Drive the PyTorch/CUDA port on one GPU: build its kernels, hold each
against its plain version, check the 8B model, and serve.

    python3 chip_smoke.py

Phases, each printing one JSON line with its wall time; any failure ends
the run with a nonzero exit and no result line:

  1. card     nvidia-smi name and power limit, versions, kernel build
  2. kernel   int8_matmul vs int8_matmul_reference at every llama3-8b decode
              shape (and the llama3-1b tied head, transposed), B in
              {1, 3, 4, 16, 64}; at B = 4: kernel, plain and library times
              (CUDA events, median of 20 cold-L2 runs) beside the bound
  3. model    llama3-8b int8 on the card: one prefill and one decode step
              through the kernel and through the dequant product; logits
              agree; the step makes 225 kernel launches
  4. serve    the port's ServingCell("llama3-8b", dtype="int8", 4 slots,
              max_seq_len 1024) over HTTP: 4 concurrent 128-token prompts,
              64 greedy tokens each, a repeat for determinism, /readyz;
              torch.profiler over 4 more requests (device busy share,
              top kernels); then a short llama3-1b run, whose tied LM
              head takes the transposed kernel

The last lines: the nvidia-smi line, a {"kernels": [...]} line, and
{"ok": true, "device": {...}}. Exits nonzero without a CUDA device, and
in a directory that holds this file and nothing else of the repository.
"""

from __future__ import annotations

import contextlib
import gc
import json
import statistics
import subprocess
import sys
import threading
import time
import urllib.request

import torch

# Peak HBM bandwidth by card (NVIDIA data sheets), bytes/s, and the dense
# bf16 tensor-core rate, FLOP/s. Rates assume the full power limit.
HBM_BPS = (("H200", 4.8e12), ("H100 NVL", 3.9e12), ("H100 PCIe", 2.0e12),
           ("H100", 3.35e12))
BF16_FLOPS = 989e12
K1_REPLACES = "kukeon_tpu/ops/int8_matmul.py:40"      # _kernel
K1T_REPLACES = "kukeon_tpu/ops/int8_matmul.py:46"     # _kernel_t
K1_SOURCE = "kukeon_tpu_torch/csrc/int8_matmul.cu"
# (K, N) of the llama3-8b decode projections, with launches per step.
SHAPES_8B = {"wq": (4096, 4096, 32), "wk": (4096, 1024, 32), "wv": (4096, 1024, 32),
             "wo": (4096, 4096, 32), "w_gate": (4096, 14336, 32),
             "w_up": (4096, 14336, 32), "w_down": (14336, 4096, 32),
             "lm_head": (4096, 128256, 1)}
TIED_1B = (2048, 128256)
BATCHES = (1, 3, 4, 16, 64)


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


def bound_ms(B: int, K: int, N: int, bps: float) -> tuple[float, str]:
    """Least time for h[B,K] bf16 @ int8 [K,N] * s[N]: each input read
    once, the bf16 output written once, over the peak HBM rate; or the
    2BKN operations over the bf16 rate, whichever is larger."""
    t_bytes = (K * N + 4 * N + 2 * B * K + 2 * B * N) / bps * 1e3
    t_ops = 2 * B * K * N / BF16_FLOPS * 1e3
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


def phase_model(k1) -> dict:
    import dataclasses

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
        a, b = logits[True][i], logits[False][i]
        if not (torch.isfinite(a).all() and torch.isfinite(b).all()):
            raise AssertionError(f"{stage} logits not finite")
        cos = torch.nn.functional.cosine_similarity(a, b, dim=-1)
        top1 = int((a.argmax(-1) == b.argmax(-1)).sum())
        out[stage] = {"min_cosine": float(cos.min()), "top1_agree": f"{top1}/{B}"}
        if float(cos.min()) < 0.999 or top1 < B - 1:
            raise AssertionError(f"{stage}: kernel vs dequant logits {out[stage]}")
    out["tolerance"] = "cosine >= 0.999 per row, same top-1 on >= 3 of 4 rows"
    del params
    return out


def post(url: str, body: dict) -> dict:
    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=600) as r:
        return json.loads(r.read())


def profile_serving(engine, prompts, new: int) -> dict:
    """torch.profiler over requests submitted straight to the running
    engine: device busy share of the wall time, and the kernels that take
    the device time, by name."""
    from torch.profiler import ProfilerActivity, profile

    from kukeon_tpu_torch.serving.sampling import SamplingParams

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        reqs = [engine.submit(p, SamplingParams(max_new_tokens=new)) for p in prompts]
        for r in reqs:
            r.done.wait(600)
        torch.cuda.synchronize()
        wall_ms = (time.monotonic() - t0) * 1e3

    def dev_us(e):
        return getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)

    kernels = [e for e in prof.key_averages() if dev_us(e) > 0]
    busy_ms = sum(dev_us(e) for e in kernels) / 1e3
    top = sorted(kernels, key=dev_us, reverse=True)[:8]
    return {"wall_ms": round(wall_ms, 2), "device_busy_ms": round(busy_ms, 2),
            "device_idle_share": round(1 - busy_ms / wall_ms, 4),
            "top_device_ms": [[e.key[:60], round(dev_us(e) / 1e3, 3), e.count] for e in top]}


def serve_model(k1, model: str, *, max_seq_len: int, prompt_len: int, new: int,
                requests: int = 4, profile_new: int = 0) -> dict:
    """The port's main path: ServingCell over HTTP, int8 weights, 4 slots.
    Kernel counts are zeroed just before the requests and read just after."""
    from kukeon_tpu_torch.runtime.serving_cell import ServingCell, serve

    t0 = time.monotonic()
    torch.cuda.reset_peak_memory_stats()
    cell = ServingCell(model, dtype="int8", num_slots=4, max_seq_len=max_seq_len,
                       device="cuda")
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
                    "k1t": k1.int8_matmul.launches_t}
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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script needs a GPU",
              file=sys.stderr)
        return 2
    from kukeon_tpu_torch.ops import _build
    from kukeon_tpu_torch.ops import int8_matmul as k1

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = nvidia_smi()
    name = torch.cuda.get_device_name(0)
    bps = hbm_bps(name)

    with phase("card", {}) as p:
        _path, log, secs = _build.build(_build.SOURCE)
        p.update(nvidia_smi=smi, device=name, torch=torch.__version__,
                 cuda=torch.version.cuda, python=sys.version.split()[0],
                 hbm_bytes_per_s=bps, build_s=round(secs, 2),
                 ptxas=[ln.strip() for ln in log.splitlines()
                        if "registers" in ln or "spill" in ln])

    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    with phase("kernel", {}) as p:
        p.update(phase_kernel(k1, bps, flush))
        kern = p
    del flush
    with phase("model", {}) as p:
        p.update(phase_model(k1))
    gc.collect()
    torch.cuda.empty_cache()
    with phase("serve", {}) as p:
        p.update(serve_model(k1, "llama3-8b", max_seq_len=1024, prompt_len=128, new=64,
                             profile_new=32))
        p["bound_ms_per_decode_step"] = round(sum(
            bound_ms(4, K, N, bps)[0] * n for K, N, n in SHAPES_8B.values()), 4)
        serve8 = p
    with phase("serve_tied", {}) as p:
        p.update(serve_model(k1, "llama3-1b", max_seq_len=256, prompt_len=32, new=16))
        serve1 = p
    for label, run, key in (("llama3-8b", serve8, "k1"), ("llama3-1b", serve1, "k1t")):
        if run["launches"][key] <= 0:
            raise AssertionError(f"{label} serving launched no {key} kernel")

    # K1: one llama3-8b decode step's worth of calls at B = 4 (225 launches).
    t = kern["timings"]
    per_step = {f: round(sum(t[nm][f] * SHAPES_8B[nm][2] for nm in SHAPES_8B), 4)
                for f in ("ms", "plain_ms", "library_ms", "bound_ms")}
    tied = t["tied_head_1b"]
    kernels = [
        {"name": "int8_matmul", "route": "cuda", "source": K1_SOURCE,
         "replaces": K1_REPLACES, "launches": serve8["launches"]["k1"],
         "max_abs_err": kern["max_abs_err"], **per_step, "bound_by": "bytes",
         "library_ms_call": kern["library_call"],
         "unit": "one llama3-8b decode step at B=4 (225 launches)"},
        {"name": "int8_matmul_transposed", "route": "cuda", "source": K1_SOURCE,
         "replaces": K1T_REPLACES, "launches": serve1["launches"]["k1t"],
         "max_abs_err": tied["max_abs_err"], "ms": round(tied["ms"], 4),
         "plain_ms": round(tied["plain_ms"], 4), "bound_ms": round(tied["bound_ms"], 4),
         "bound_by": tied["bound_by"], "library_ms": round(tied["library_ms"], 4),
         "library_ms_call": kern["library_call"],
         "unit": "llama3-1b tied LM head, B=4"},
    ]
    # The serve phases' end-to-end numbers again, short, so that the last
    # lines of the output carry every number the run is quoted for.
    e2e_keys = ("decode_tok_s", "ttft_ms", "ms_per_decode_step", "launches")
    emit({"end_to_end": {
        "llama3-8b": {**{k: serve8[k] for k in e2e_keys},
                      "bound_ms_per_decode_step": serve8["bound_ms_per_decode_step"],
                      "device_idle_share": serve8["profile"]["device_idle_share"]},
        "llama3-1b": {k: serve1[k] for k in e2e_keys}}})
    print(smi, flush=True)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
