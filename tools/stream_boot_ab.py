"""Compare the streamed HF int8 boot across checkouts on one GPU.

Writes two HF checkpoints once with this checkout's writer
(``synthesize_hf_checkpoint``, f16, seed 0, 1 GiB shards): llama3-1b and
llama3-8b at full width and depth. Then, for each checkout given, in the
order given, boots ``ServingCell(model, checkpoint=dir, dtype="int8")``
from each directory in a fresh process whose ``PYTHONPATH`` is that
checkout (its package, its kernels built there before the clock starts):
the reader threads quantize on the host while the engine captures its
programs, as a cell boots in production. To compare a parent commit with
a change, unpack the parent with ``git archive`` and alternate:

    python3 tools/stream_boot_ab.py PARENT_DIR . . PARENT_DIR

``--models llama3-1b`` writes and boots that model alone.

Prints the nvidia-smi line, then one JSON line a boot: seconds from the
cell's construction to ready (captured, warmed, started), the stream's
disk and cast seconds (summed over its readers) and upload seconds, the
boot process's peak resident set (``ru_maxrss``) and its ``VmRSS`` growth
over the boot (sampled every 5 ms), and the first request's greedy tokens
(equal across checkouts, or the tool fails). The checkpoints are read
warm: they were just written, and every boot reads the same files. The
directories are removed at the end. Exits nonzero if a boot failed.
Needs a GPU.
"""

from __future__ import annotations

import json
import os
import resource
import shutil
import subprocess
import sys
import tempfile
import threading
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODELS = {"llama3-1b": 256, "llama3-8b": 1024}      # model -> max_seq_len
PROMPT_LEN, NEW = 32, 8


def _vm_rss_kb() -> int:
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith("VmRSS:"):
                return int(line.split()[1])
    raise RuntimeError("no VmRSS in /proc/self/status")


def child(model: str, path: str) -> dict:
    """One boot in this process (run with the checkout on ``PYTHONPATH``)."""
    import numpy as np
    import torch

    from kukeon_tpu_torch.ops import int8_matmul as ops
    from kukeon_tpu_torch.runtime.serving_cell import ServingCell
    from kukeon_tpu_torch.serving.sampling import SamplingParams

    # Build (or load) this checkout's kernels before the clock starts.
    h = torch.zeros((4, 256), dtype=torch.bfloat16, device="cuda")
    q = torch.zeros((256, 256), dtype=torch.int8, device="cuda")
    s = torch.ones((256,), dtype=torch.float32, device="cuda")
    ops.int8_matmul(h, q, s)
    ops.int8_matmul(h, q.t().contiguous(), s, transpose=True)
    torch.cuda.synchronize()
    base = peak = _vm_rss_kb()
    done = threading.Event()

    def sample():
        nonlocal peak
        while not done.wait(0.005):
            peak = max(peak, _vm_rss_kb())

    sampler = threading.Thread(target=sample, daemon=True)
    sampler.start()
    t0 = time.monotonic()
    cell = ServingCell(model, checkpoint=path, dtype="int8", num_slots=4,
                       max_seq_len=MODELS[model], device="cuda")
    cell.warmup(PROMPT_LEN)
    cell.engine.start()
    cell.mark_ready()
    ready_s = time.monotonic() - t0
    done.set()
    sampler.join()
    eng = cell.engine
    stats = eng._ckpt_stream.stat_snapshot() if eng._ckpt_stream is not None else {}
    prompt = np.arange(3, 3 + PROMPT_LEN, dtype=np.int32)
    req = eng.submit(prompt, SamplingParams(temperature=0.0, max_new_tokens=NEW))
    req.done.wait(300)
    if req.error is not None or len(req.generated) != NEW:
        raise RuntimeError(f"the request failed: {req.error}, {len(req.generated)} tokens")
    eng.stop()
    return {"model": model, "ready_s": round(ready_s, 3),
            "streamed": eng._ckpt_stream is not None,
            "disk_s": round(stats.get("disk_s", 0.0), 3),
            "cast_s": round(stats.get("cast_s", 0.0), 3),
            "upload_s": round(eng.load_stats["upload_s"], 3),
            "ru_maxrss_mb": round(resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024, 1),
            "rss_growth_mb": round((peak - base) / 1024, 1),
            "tokens": [int(t) for t in req.generated]}


def boot(tree: str, model: str, path: str) -> dict:
    env = {**os.environ, "PYTHONPATH": os.path.abspath(tree)}
    proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--child", model, path],
                          cwd=tree, env=env, capture_output=True, text=True, timeout=900)
    if proc.returncode != 0:
        raise RuntimeError(f"{tree} {model}: exit {proc.returncode}\n{proc.stderr[-4000:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if argv[:1] == ["--child"]:
        print(json.dumps(child(argv[1], argv[2])), flush=True)
        return 0
    models = list(MODELS)
    if argv[:1] == ["--models"]:
        models, argv = argv[1].split(","), argv[2:]
    if not argv or not set(models) <= set(MODELS):
        print(__doc__, file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from kukeon_tpu_torch.models import checkpoints, llama

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout.strip(),
          flush=True)
    root = tempfile.mkdtemp(prefix="kukeon-stream-ab-")
    failed = 0
    try:
        print(json.dumps({"tmp_free_gb": round(shutil.disk_usage(root).free / 1e9, 1)}),
              flush=True)
        dirs = {}
        for model, cfg in (("llama3-1b", llama.llama3_1b()), ("llama3-8b", llama.llama3_8b())):
            if model not in models:
                continue
            t0 = time.monotonic()
            dirs[model] = checkpoints.synthesize_hf_checkpoint(
                os.path.join(root, model), cfg, seed=0, max_shard_bytes=1 << 30,
                tokenizer=False)
            print(json.dumps({"write": model, "s": round(time.monotonic() - t0, 3)}), flush=True)
        tokens = {}
        for i, tree in enumerate(argv):
            for model, path in dirs.items():
                try:
                    r = boot(tree, model, path)
                except Exception as e:  # noqa: BLE001 — reported, the others still run
                    failed += 1
                    print(json.dumps({"run": i, "tree": tree, "model": model,
                                      "error": str(e)[-2000:]}), flush=True)
                    continue
                want = tokens.setdefault(model, r["tokens"])
                if r["tokens"] != want:
                    failed += 1
                    r["tokens_differ"] = True
                print(json.dumps({"run": i, "tree": tree, **r}), flush=True)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
