"""Time the trainer's checkpoint save against the save it replaced, on one
GPU, in one process, on one state: a ``create_train_state`` of the given
model on the card (llama3-1b by default, the ``train`` phase's model of
``chip_smoke.py``), saved alternately

- ``torch``: ``torch.save`` of ``{"params", "opt_state", "step"}`` into one
  ``state.pt`` under a temp name, fsynced, then renamed into place (the
  port's save before it wrote orbax), and
- ``orbax``: ``training.checkpointing.save_checkpoint`` (the JAX
  TrainState layout through ``orbax_ckpt.write_tree``, leaf by leaf),

in the order torch, orbax, orbax, torch, each into a fresh directory that
is removed after it. Prints the ``nvidia-smi`` name and power limit, then
one JSON line a save: its seconds, the step directory's bytes, and the
growth of the process's resident set over the save (the largest
``VmRSS`` of ``/proc/self/status``, read every millisecond on a thread
while the save runs, less the value before it).

    python3 tools/time_train_save.py [--model llama3-1b] [--dir DIR]

``--device cpu`` (with ``--model tiny``) checks the script without a card.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile
import threading
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def _status_kb(field: str) -> int:
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith(field + ":"):
                return int(line.split()[1])
    raise KeyError(field)


class _PeakRss:
    """The largest ``VmRSS`` seen, in kB, sampled on a thread between
    ``start`` and ``stop``."""

    def start(self) -> None:
        self.peak = _status_kb("VmRSS")
        self._done = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self) -> None:
        while not self._done.wait(0.001):
            self.peak = max(self.peak, _status_kb("VmRSS"))

    def stop(self) -> int:
        self._done.set()
        self._thread.join()
        return max(self.peak, _status_kb("VmRSS"))


def torch_save(root: str, state) -> str:
    """The port's earlier save: one torch.save payload, crash-atomic."""
    import torch

    step = int(state.step)
    path = os.path.join(root, f"step_{step:08d}")
    tmp = os.path.join(root, f"tmp-step_{step:08d}.{os.getpid()}")
    os.makedirs(tmp)
    payload = {"params": state.params, "opt_state": state.opt_state, "step": step}
    torch.save(payload, os.path.join(tmp, "state.pt"))
    for p in (os.path.join(tmp, "state.pt"), tmp):
        fd = os.open(p, os.O_RDONLY)
        try:
            os.fsync(fd)
        finally:
            os.close(fd)
    os.replace(tmp, path)
    return path


def dir_bytes(path: str) -> int:
    return sum(os.path.getsize(os.path.join(d, f))
               for d, _, files in os.walk(path) for f in files)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model", default="llama3-1b", choices=("tiny", "llama3-1b", "llama3-8b"))
    ap.add_argument("--dir", default=None, help="where the step directories go "
                    "(default: a new temporary directory)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    import torch

    from kukeon_tpu_torch.models import llama
    from kukeon_tpu_torch.training import checkpointing, train_step

    cuda = torch.device(args.device).type == "cuda"
    if cuda:
        if not torch.cuda.is_available():
            print("time_train_save: no CUDA device", file=sys.stderr)
            return 1
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True)
        print(smi.stdout.strip().splitlines()[0] if smi.returncode == 0
              else "nvidia-smi failed", flush=True)
    cfg = {"tiny": llama.llama_tiny, "llama3-1b": llama.llama3_1b,
           "llama3-8b": llama.llama3_8b}[args.model]()
    gen = torch.Generator(device=args.device)
    gen.manual_seed(0)
    state, _ = train_step.create_train_state(cfg, gen, args.device)
    if cuda:
        torch.cuda.synchronize()
    state_bytes = sum(t.numel() * t.element_size() for t in
                      train_step.tree_leaves(state.params)
                      + train_step.tree_leaves(state.opt_state["mu"])
                      + train_step.tree_leaves(state.opt_state["nu"]))
    base = args.dir or tempfile.mkdtemp(prefix="kukeon-save-")
    saves = {"torch": torch_save, "orbax": checkpointing.save_checkpoint}
    try:
        for i, kind in enumerate(("torch", "orbax", "orbax", "torch")):
            root = os.path.join(base, f"{i}-{kind}")
            state.step = i + 1
            rss0 = _status_kb("VmRSS")
            sampler = _PeakRss()
            sampler.start()
            t0 = time.monotonic()
            path = saves[kind](root, state)
            seconds = time.monotonic() - t0
            peak = sampler.stop()
            print(json.dumps({
                "save": kind, "model": args.model, "state_bytes": state_bytes,
                "seconds": seconds, "step_dir_bytes": dir_bytes(path),
                "host_peak_growth_bytes": (peak - rss0) * 1024,
            }), flush=True)
            shutil.rmtree(root)
    finally:
        if args.dir is None:
            shutil.rmtree(base, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
