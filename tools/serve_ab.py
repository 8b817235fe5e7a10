"""Compare serving across checkouts on one GPU: each checkout's own
``chip_smoke.py --phases card,serve,serve_moe`` (its package, its kernels
built there), one fresh process a run, in the order given. To compare a
parent commit with a change, unpack the parent with ``git archive`` and
alternate:

    python3 tools/serve_ab.py PARENT_DIR . . PARENT_DIR PARENT_DIR . . PARENT_DIR

Prints the nvidia-smi line, then one JSON line a run: for llama3-8b
(``serve``) and mixtral-8x7b (``serve_moe``), ms a decode step, decode
tok/s, TTFT, capture seconds and pool bytes, peak memory, the prefill
programs' counters where the checkout has them, and the profiled
window's device idle share, as each checkout's script measures them.
Each run's whole output goes to ``chiprun_out/serve_ab/run<i>.log``. Exits nonzero if a run failed.
Needs a GPU.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KEYS = ("ms_per_decode_step", "decode_tok_s", "ttft_ms", "capture_s", "pool_bytes",
        "peak_mem_gb", "prefill")


def summary(phase: dict) -> dict:
    out = {k: phase[k] for k in KEYS if k in phase}
    prof = phase.get("profile", {})
    out.update({k: prof[k] for k in ("device_idle_share", "wall_ms", "device_busy_ms")
                if k in prof})
    return out


def run(tree: str, i: int, log_dir: str) -> dict:
    proc = subprocess.run([sys.executable, "chip_smoke.py", "--phases", "card,serve,serve_moe"],
                          cwd=tree, capture_output=True, text=True, timeout=1500)
    with open(os.path.join(log_dir, f"run{i}.log"), "w") as f:
        f.write(proc.stdout + proc.stderr)
    phases = {}
    for line in proc.stdout.splitlines():
        if line.startswith("{"):
            obj = json.loads(line)
            if "phase" in obj:
                phases[obj["phase"]] = obj
    out = {"run": i, "tree": tree, "rc": proc.returncode}
    for name in ("serve", "serve_moe"):
        if name in phases:
            out[name] = summary(phases[name])
    return out


def main(argv=None) -> int:
    trees = (argv if argv is not None else sys.argv[1:])
    if not trees:
        print(__doc__, file=sys.stderr)
        return 2
    log_dir = os.path.join(ROOT, "chiprun_out", "serve_ab")
    os.makedirs(log_dir, exist_ok=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    failed = 0
    for i, tree in enumerate(trees, 1):
        res = run(os.path.abspath(tree), i, log_dir)
        failed += res["rc"] != 0
        print(json.dumps(res), flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
