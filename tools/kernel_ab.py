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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("trees", nargs="+", help="checkout directories, measured in this order")
    ap.add_argument("--one", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.one:
        print(json.dumps(measure(args.trees[0])), flush=True)
        return 0
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip(),
          flush=True)
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
