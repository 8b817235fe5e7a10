"""Compare the port's hand-written kernels across checkouts on one GPU,
through one measurement code: the ``kernel``, ``flash`` and ``moe_kernel``
phases of this checkout's ``chip_smoke.py``, run against each checkout's own
``kukeon_tpu_torch`` (built there), one fresh process a checkout, in the
order given. To compare a parent commit with a change, unpack the parent
with ``git archive`` and alternate:

    python3 tools/kernel_ab.py PARENT_DIR . . PARENT_DIR

The flash phase runs only its timed case (the llama3-1b training shape).
Every kernel goes through its checkout's public wrapper, so a cold median
(CUDA events, L2 overwritten before each call) holds the same wrapper host
time on both sides; the device time (torch.profiler, cold L2) holds the
kernels alone. Prints the nvidia-smi line, then one JSON line a run;
exits nonzero if a phase failed (a kernel disagreeing with its plain
version included). Needs a GPU.

``--k1t-slices`` times this checkout's K1t bf16 kernel instead, at the
llama3-1b tied head, B 4 and 64, at each K slice given, through the built
library's C entry (so the plan is bypassed, not edited):

    python3 tools/kernel_ab.py --k1t-slices 2048,1024 --rounds 6

The slices alternate within each round, so drift across the call falls on
each alike. Each reading is the profiler's device time of 5 cold-L2 calls,
after the output is held against the plain version; a streaming read of
the same weights (``q.view(int32).max()``) opens each round as a yardstick.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def load_chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke_measure",
                                                  os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def summarise(cs, res: dict) -> dict:
    """Per-call and per-step numbers, ms, of the kernels whose phase ran."""
    out = {}
    if "kernel" in res:
        t = res["kernel"]["timings"]
        out["k1_step"] = {f: round(sum(t[nm][f] * n for nm, (_k, _n, n) in cs.SHAPES_8B.items()),
                                   4) for f in ("ms", "device_ms", "bound_ms")}
        out["k1_device_ms_by_projection"] = {nm: round(t[nm]["device_ms"], 4)
                                             for nm in cs.SHAPES_8B}
        out["k1t"] = {f: round(t["tied_head_1b"][f], 4) for f in ("ms", "device_ms", "bound_ms")}
        out["k1t_device_ms_by_shape"] = res["kernel"]["transposed_device_ms_b4"]
    if "flash" in res:
        ft = res["flash"]["timing"]
        out["k3"] = {f: round(ft[f], 4) for f in ("ms", "device_ms", "library_ms", "bound_ms")}
    if "moe_kernel" in res:
        moe = res["moe_kernel"]
        tm, dev = moe["timings"], moe["device_ms_per_call_c4"]
        out["k2"] = {nm: {"ms": round(tm[nm]["ms"], 4),
                          "device_ms": round(sum(dev[nm].values()), 4),
                          "bound_ms": round(tm[nm]["bound_ms"], 4),
                          "routed_ms": round(tm[nm + "_routed"]["ms"], 4),
                          "routed_device_ms": round(tm[nm + "_routed"]["device_ms"], 4),
                          "routed_bound_ms": round(tm[nm + "_routed"]["bound_ms"], 4)}
                     for nm in ("w_gate", "w_down")}
        out["k2"]["empty_experts"] = moe["empty_experts"]
    out["max_abs_err"] = {k: res[p]["max_abs_err"] for k, p in (("k1", "kernel"),
                                                                ("k2", "moe_kernel")) if p in res}
    return out


def measure(tree: str) -> dict:
    """The three phases against ``tree``'s package, in this process."""
    tree = os.path.abspath(tree)
    sys.path.insert(0, tree)
    import torch

    from kukeon_tpu_torch.ops import _build
    from kukeon_tpu_torch.ops import flash_attention as fa
    from kukeon_tpu_torch.ops import int8_matmul as k1

    if not os.path.abspath(k1.__file__).startswith(tree + os.sep):
        raise RuntimeError(f"imported {k1.__file__}, not the package under {tree}")
    cs = load_chip_smoke()
    # Only the timed flash case: an older checkout may refuse the others
    # (the ragged S 160 before its repair); chip_smoke.py checks them all.
    cs.FLASH_CASES = tuple(c for c in cs.FLASH_CASES if c[0] == "llama3-1b train")
    torch.backends.cuda.matmul.allow_tf32 = False
    bps = cs.hbm_bps(torch.cuda.get_device_name(0))
    built = _build.build_all()
    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    res, errors = {}, {}
    for name, fn in (("kernel", cs.phase_kernel), ("flash", cs.phase_flash),
                     ("moe_kernel", cs.phase_moe_kernel)):
        try:
            res[name] = fn(fa if name == "flash" else k1, bps, flush)
        except Exception as e:   # recorded, and the run exits nonzero
            errors[name] = f"{type(e).__name__}: {e}"
    out = {"tree": tree, "build_s": {src: round(sec, 2) for src, (_p, _l, sec) in built.items()},
           **summarise(cs, res)}
    if "flash" in res:
        out["max_abs_err"]["k3"] = res["flash"]["cases"][0]["max_abs_err"]
    if errors:
        out["errors"] = errors
    return out


def k1t_slices(slices: list[int], rounds: int) -> int:
    """Device ms of K1t's bf16 kernel at each K slice, alternating; one JSON
    line a reading. Nonzero if a slice disagrees with the plain version."""
    sys.path.insert(0, ROOT)
    import torch

    from kukeon_tpu_torch.ops import _build
    from kukeon_tpu_torch.ops import int8_matmul as k1

    cs = load_chip_smoke()
    lib = _build.load_int8_matmul()
    K, N = cs.TIED_1B
    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    g = torch.Generator(device="cuda").manual_seed(6)
    q = torch.randint(-127, 128, (N, K), generator=g, device="cuda", dtype=torch.int8)
    s = torch.rand(N, generator=g, device="cuda") * 0.02 + 1e-3
    rows = {B: torch.randn((B, K), generator=g, device="cuda").to(torch.bfloat16)
            for B in (4, 64)}
    refs = {B: k1.int8_matmul_reference(h, q, s, transpose=True) for B, h in rows.items()}
    failed = False
    for r in range(1, rounds + 1):
        read = sum(cs.kernel_device_ms(q.view(torch.int32).max, flush).values())
        print(json.dumps({"round": r, "case": "streaming read of q",
                          "device_ms": round(read, 4)}), flush=True)
        for B, h in rows.items():
            out = torch.empty((B, N), dtype=torch.bfloat16, device="cuda")
            for ks in slices:
                def call():
                    err = lib.kukeon_int8_matmul_t_bf16(
                        h.data_ptr(), q.data_ptr(), s.data_ptr(), out.data_ptr(), B, K, N, ks,
                        torch.cuda.current_stream().cuda_stream)
                    if err:
                        raise RuntimeError(f"K1t launch failed: CUDA error {err} (B={B}, ks={ks})")
                out.zero_()
                call()
                torch.cuda.synchronize()
                ok = cs.within_tol(out, refs[B])[0]
                failed = failed or not ok
                dev = sum(cs.kernel_device_ms(call, flush).values())
                print(json.dumps({"round": r, "B": B, "ks": ks, "slices": K // ks,
                                  "plan": k1.k_slice_t_bf16(B, K, N) == ks, "ok": ok,
                                  "device_ms": round(dev, 4)}), flush=True)
    return 1 if failed else 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("trees", nargs="*", help="checkout directories, measured in this order")
    ap.add_argument("--one", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--k1t-slices", help="comma-separated K slices: time K1t at each instead")
    ap.add_argument("--rounds", type=int, default=6, help="rounds of --k1t-slices")
    args = ap.parse_args(argv)
    if args.one:
        print(json.dumps(measure(args.trees[0])), flush=True)
        return 0
    if not args.trees and not args.k1t_slices:
        ap.error("give checkout directories or --k1t-slices")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip(),
          flush=True)
    if args.k1t_slices:
        return k1t_slices([int(ks) for ks in args.k1t_slices.split(",")], args.rounds)
    failed = False
    for i, tree in enumerate(args.trees, 1):
        r = subprocess.run([sys.executable, os.path.abspath(__file__), "--one", tree],
                           capture_output=True, text=True, timeout=900)
        last = (r.stdout.strip().splitlines() or [""])[-1]
        try:
            run = json.loads(last)
        except ValueError:
            run = {"tree": tree, "errors": {"process": r.stderr[-2000:]}}
        run["run"] = i
        failed = failed or r.returncode != 0 or "errors" in run
        print(json.dumps(run), flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
