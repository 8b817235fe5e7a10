"""Sweep the port's serving levers on the card and save the winner as the
tuning profile the serving cell boots from: the port's counterpart of the
reference's ``bench.py --autotune`` (``phase_autotune``).

    python3 tools/autotune.py                          # llama3-8b int8, random weights
    python3 tools/autotune.py --checkpoint DIR         # a kukeon int8 or HF directory
    python3 tools/autotune.py --arms chunk16,chunk64   # a subset of the grid
    python3 tools/autotune.py --device cpu --model tiny --max-seq-len 256 --prompt-len 32

Each arm is a ``ServingCell`` booted with its levers left ``None`` under a
tuning profile of its own holding the arm's levers (so the arm boots as a
tuned production cell would), on the model's random weights drawn from
seed 0 or on ``--checkpoint``, served over HTTP with
``chip_smoke.py``'s ``serve`` traffic: 4 concurrent prompts of 128 tokens,
64 greedy tokens each, once to warm and once timed. An arm scores its
decode tokens/s; the best is saved with ``serving.tuning.save`` under
``model|gpu|1`` (``KUKEON_TUNE_PATH`` overrides the file), so a cell
started later with those levers left out takes it. The reference's arm
grid: decode chunk 4, 16 and 64, each with and without the int8 KV cache;
chunk 64 with the coarse buckets 256, 1024, 4096; chunk 64 on the paged KV
cache with pages of 64 and of 128 (the latter on the bucket ladder from
128 up: a page must tile every bucket, and the reference's arm, on the
full ladder, is refused by its own engine). Prints the nvidia-smi line (on the
card), one JSON line an arm and a last line with every arm, the winner and
the profile's path. Needs a GPU unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time
import urllib.request
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import torch  # noqa: E402

from kukeon_tpu_torch.serving import tuning  # noqa: E402
from kukeon_tpu_torch.serving.engine import PREFILL_BUCKETS  # noqa: E402

REQUESTS, PROMPT_LEN, NEW_TOKENS = 4, 128, 64


def arm_grid() -> list[tuple[str, dict]]:
    """The reference's autotune arms (``bench.py:1033-1058``) on one card:
    (name, levers), levers the cell's ``decode_chunk``, ``kv_cache_int8``,
    ``kv_page_tokens`` and the engine's ``prefill_buckets``."""
    arms = []
    for c in (4, 16, 64):
        for kv in (False, True):
            arms.append((f"chunk{c}" + ("+kvint8" if kv else ""),
                         {"decode_chunk": c, "kv_cache_int8": kv, "kv_page_tokens": 0}))
    arms.append(("chunk64+coarse-buckets",
                 {"decode_chunk": 64, "kv_cache_int8": False, "kv_page_tokens": 0,
                  "prefill_buckets": (256, 1024, 4096)}))
    for pt in (64, 128):
        # A page must tile every prefill bucket below max_seq_len (the
        # engine refuses the layout otherwise, as the reference's does), so
        # pages of 128 take the ladder without bucket 64.
        ladder = tuple(b for b in PREFILL_BUCKETS if b % pt == 0)
        arms.append((f"chunk64+paged{pt}",
                     {"decode_chunk": 64, "kv_cache_int8": False, "kv_page_tokens": pt,
                      **({"prefill_buckets": ladder} if ladder != PREFILL_BUCKETS else {})}))
    return arms


def _post(url: str, body: dict) -> dict:
    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=600) as r:
        return json.loads(r.read())


def measure_arm(cell, prompts: list, new: int) -> dict:
    """``prompts`` as concurrent greedy requests through ``cell`` over
    HTTP: warmed (programs captured), served once to warm and once timed;
    the timed pass's decode tokens/s, TTFT and ms a decode step (request
    seconds less TTFT over the tokens after the first, median), and the
    tokens, which must come out the same both times. The cell's engine is
    stopped at the end."""
    from kukeon_tpu_torch.runtime.serving_cell import serve

    t0 = time.monotonic()
    cell.warmup(len(prompts[0]))
    cell.engine.start()
    server = serve(cell)
    cell.mark_ready()
    ready_s = time.monotonic() - t0
    base = f"http://127.0.0.1:{server.server_address[1]}/v1/generate"
    passes = []
    try:
        for _ in range(2):
            t1 = time.monotonic()
            with ThreadPoolExecutor(len(prompts)) as ex:
                outs = list(ex.map(lambda p: _post(base, {"promptTokens": p,
                                                          "maxNewTokens": new}), prompts))
            passes.append((time.monotonic() - t1, outs))
    finally:
        server.shutdown()
        server.server_close()
        cell.engine.stop()
    wall, outs = passes[-1]
    if any(o["numTokens"] != new for o in outs):
        raise AssertionError(f"an arm's request came back short: {[o['numTokens'] for o in outs]}")
    tokens = [o["tokens"] for o in outs]
    if tokens != [o["tokens"] for o in passes[0][1]]:
        raise AssertionError("an arm's greedy tokens changed between its two passes")
    eng = cell.engine
    return {"tok_per_s": round(len(prompts) * new / wall, 2),
            "ttft_ms": sorted(round(o["ttftSeconds"] * 1e3, 2) for o in outs),
            "ms_per_decode_step": round(statistics.median(
                (o["seconds"] - o["ttftSeconds"]) / (new - 1) * 1e3 for o in outs), 3),
            "ready_s": round(ready_s, 3), "decode_chunk": eng.decode_chunk,
            "kv_cache_int8": eng.kv_cache_int8, "kv_page_tokens": eng.page_tokens,
            "prefill_buckets": list(eng.prefill_buckets), "tokens": tokens}


def sweep(make_cell, arms: list[tuple[str, dict]], prompts: list, new: int,
          log=None) -> tuple[dict, str | None]:
    """Every arm through :func:`measure_arm` on ``make_cell(levers)`` ->
    ({arm: result, or {"error": ...}}, the name of the arm with the most
    tokens/s). Each arm's cell is dropped before the next is built."""
    results: dict = {}
    best, best_rate = None, -1.0
    for name, levers in arms:
        try:
            cell = make_cell(levers)
            results[name] = {"levers": levers, **measure_arm(cell, prompts, new)}
            del cell
        except Exception as e:  # noqa: BLE001 — one failed arm leaves the sweep standing
            results[name] = {"levers": levers, "error": f"{type(e).__name__}: {e}"}
        gc.collect()
        if torch.cuda.is_available():
            torch.cuda.empty_cache()
        if log is not None:
            log({"arm": name, **{k: v for k, v in results[name].items() if k != "tokens"}})
        rate = results[name].get("tok_per_s", -1.0)
        if rate > best_rate:
            best, best_rate = name, rate
    return results, best


def save_winner(model: str, device, result: dict, path: str | None = None) -> str:
    """The winning arm's levers as the profile of ``model`` on ``device``'s
    backend (one chip) -> the profile file's path."""
    levers = result["levers"]
    buckets = levers.get("prefill_buckets")
    return tuning.save(model, tuning.backend_name(device), 1, tuning.ServingTune(
        decode_chunk=levers["decode_chunk"], kv_cache_int8=levers["kv_cache_int8"],
        prefill_buckets=tuple(buckets) if buckets else None,
        kv_page_tokens=levers.get("kv_page_tokens") or None,
        tok_per_s=result["tok_per_s"]), path)


def traffic(vocab: int, requests: int = REQUESTS, prompt_len: int = PROMPT_LEN) -> list:
    """``chip_smoke.py``'s ``serve`` prompts: ``requests`` random prompts of
    ``prompt_len`` tokens from a seed of 7."""
    g = torch.Generator().manual_seed(7)
    return [torch.randint(0, vocab, (prompt_len,), generator=g).tolist()
            for _ in range(requests)]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model", default="llama3-8b")
    ap.add_argument("--checkpoint", default=None)
    ap.add_argument("--dtype", default="int8")
    ap.add_argument("--num-slots", type=int, default=REQUESTS)
    ap.add_argument("--max-seq-len", type=int, default=1024)
    ap.add_argument("--prompt-len", type=int, default=PROMPT_LEN)
    ap.add_argument("--new", type=int, default=NEW_TOKENS)
    ap.add_argument("--arms", default=None, help="comma-separated arm names (default: all)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    from kukeon_tpu_torch.runtime.serving_cell import ServingCell

    device = torch.device(args.device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            print("autotune: no CUDA device (use --device cpu)", file=sys.stderr)
            return 2
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             check=True).stdout.strip(), flush=True)
    arms = arm_grid()
    if args.arms:
        want = args.arms.split(",")
        unknown = set(want) - {n for n, _ in arms}
        if unknown:
            ap.error(f"unknown arms {sorted(unknown)}; known: {[n for n, _ in arms]}")
        arms = [a for a in arms if a[0] in want]

    def make_cell(levers: dict):
        with arm_profile(args.model, device, levers):
            return ServingCell(args.model, dtype=args.dtype, checkpoint=args.checkpoint,
                               num_slots=args.num_slots, max_seq_len=args.max_seq_len,
                               device=device)

    def log(obj):
        print(json.dumps(obj), flush=True)

    results, best = sweep(make_cell, arms, traffic(_vocab(args), args.num_slots,
                                                   args.prompt_len), args.new, log)
    line: dict = {"model": args.model, "backend": tuning.backend_name(device),
                  "arms": {n: {k: v for k, v in r.items() if k != "tokens"}
                           for n, r in results.items()}}
    if best is not None:
        line["best"] = {"arm": best, "tok_per_s": results[best]["tok_per_s"]}
        line["profile"] = {"path": save_winner(args.model, device, results[best]),
                           "key": tuning.profile_key(args.model, tuning.backend_name(device), 1)}
    print(json.dumps(line), flush=True)
    return 0 if best is not None else 1


@contextlib.contextmanager
def arm_profile(model: str, device, levers: dict):
    """While open, ``KUKEON_TUNE_PATH`` names a file of its own holding
    ``levers`` as ``model``'s profile: a cell built inside, its levers left
    ``None``, boots with the arm's levers through the tuning read (the
    prefill bucket ladder included, which the cell takes no argument
    for)."""
    old = os.environ.get("KUKEON_TUNE_PATH")
    with tempfile.TemporaryDirectory(prefix="kukeon-arm-") as d:
        path = os.path.join(d, "serving_tune.json")
        buckets = levers.get("prefill_buckets")
        tuning.save(model, tuning.backend_name(device), 1, tuning.ServingTune(
            decode_chunk=levers["decode_chunk"], kv_cache_int8=levers["kv_cache_int8"],
            prefill_buckets=tuple(buckets) if buckets else None,
            kv_page_tokens=levers.get("kv_page_tokens") or None), path)
        os.environ["KUKEON_TUNE_PATH"] = path
        try:
            yield path
        finally:
            if old is None:
                os.environ.pop("KUKEON_TUNE_PATH", None)
            else:
                os.environ["KUKEON_TUNE_PATH"] = old


def _vocab(args) -> int:
    """The vocabulary of the model the arms serve (the checkpoint's, when
    one is given)."""
    from kukeon_tpu_torch.models import checkpoints, hf_convert
    from kukeon_tpu_torch.runtime.serving_cell import MODELS

    if args.checkpoint is None:
        return MODELS[args.model]().vocab_size
    if checkpoints.is_quantized_checkpoint(args.checkpoint):
        with open(os.path.join(args.checkpoint, checkpoints.QUANT_MANIFEST)) as f:
            return json.load(f)["config"]["vocab_size"]
    return hf_convert.config_from_hf(args.checkpoint).vocab_size


if __name__ == "__main__":
    sys.exit(main())
