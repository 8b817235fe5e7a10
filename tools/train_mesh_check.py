"""Train the Llama family on meshes of this host's devices and hold each to
one device: the port's training mesh (``training/mesh_trainer.py``) across
real GPUs, where ``chip_smoke.py``'s ``train_tp`` has one.

For ``--model`` (llama3-1b by default: ``chip_smoke.py``'s ``train``
configuration, B 4, S 2048, lr 3e-4, warmup 1, seed 0, its Zipf dataset):

1. ``--steps`` steps on one device (``create_train_state``,
   ``make_train_step`` on device 0): the losses to hold the meshes to;
2. the same steps through ``MeshTrainer`` on each mesh of ``--meshes``
   (a rank group of one process per device, NCCL): the losses, each
   step's host-clock ms (ending in the loss's read), the leader's peak
   memory and each follower's (its allocator counters, reported to the
   leader every second), flash launches a step on the leader; the first
   mesh then saves its state (seconds, bytes) and the last restores it
   and gathers it back, bit for bit against what the first gathered;
3. ``--big-model`` (llama3-8b) on each mesh of ``--big-meshes``: steps,
   ms and peaks, with no one-device run (its state and activations do
   not fit one card); its meshes' losses held to each other.

Losses are bf16 sums in another order than one device's (ROADMAP §C), so
each mesh's first loss, before any update, must be within 1e-2 relative
of one device's (the big model's: of its first mesh's, at every step),
every loss finite, and ``--model``'s last below its first (at lr 3e-4
and warmup 1, llama3-8b's third loss rises from random weights, on every
mesh alike). Prints the ``nvidia-smi`` name and power limit, then one
JSON line a run. An empty ``--meshes`` skips ``--model``.

    python3 tools/train_mesh_check.py              # on a host with 4 GPUs

``--device cpu --model tiny --big-model tiny --batch 8 --seq-len 32``
checks the script on gloo ranks without a card.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

from kukeon_tpu_torch.ops import flash_attention as fa  # noqa: E402
from kukeon_tpu_torch.parallel import launch  # noqa: E402
from kukeon_tpu_torch.parallel.mesh import make_mesh  # noqa: E402
from kukeon_tpu_torch.training import (TokenDataset, batches,  # noqa: E402
                                       create_train_state)
from kukeon_tpu_torch.training.checkpointing import latest_step  # noqa: E402
from kukeon_tpu_torch.training.mesh_trainer import MODELS, MeshTrainer  # noqa: E402
from kukeon_tpu_torch.training.train_step import make_optimizer, make_train_step  # noqa: E402

LR, WARMUP, TOTAL, SEED = 3e-4, 1, 8, 0


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def parse_mesh(text: str) -> dict[str, int]:
    """``"fsdp=2,tensor=2"`` -> ``{"data": 1, "fsdp": 2, "tensor": 2}``."""
    axes = {"data": 1, "fsdp": 1, "tensor": 1}
    for part in text.split(","):
        k, v = part.split("=")
        axes[k] = int(v)
    return axes


def zipf_dataset(path: str, n_tokens: int, vocab: int) -> None:
    """``chip_smoke.py``'s training data: Zipf-like ids over the first
    min(4096, vocab) of the vocabulary, seed 0."""
    rng = np.random.default_rng(0)
    TokenDataset.write(path, (rng.zipf(1.2, n_tokens) - 1) % min(4096, vocab))


def sync(device: str) -> None:
    if device == "cuda":
        torch.cuda.synchronize()


def one_device(model: str, data: str, args) -> dict:
    cfg = MODELS[model]()
    dev = "cuda" if args.device == "cuda" else "cpu"
    opt = make_optimizer(LR, warmup_steps=WARMUP, total_steps=TOTAL)
    state, opt = create_train_state(cfg, torch.Generator(device=dev).manual_seed(SEED), dev,
                                    opt)
    step = make_train_step(cfg, opt)
    losses, ms = [], []
    for _s, *batch in batches(TokenDataset(data), args.batch, args.seq_len,
                              num_steps=args.steps, seed=SEED, device=dev):
        t0 = time.monotonic()
        state, loss = step(state, *batch)
        losses.append(float(loss))
        ms.append((time.monotonic() - t0) * 1e3)
    del state, step
    return {"losses": losses, "step_ms": [round(x, 3) for x in ms]}


def mesh_run(model: str, axes: dict, data: str, args, save_to: str | None = None,
             restore_from: str | None = None) -> tuple[dict, dict | None]:
    """One mesh's run -> (its report, the state it gathered after a save
    or a restore, else None)."""
    if args.device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    t0 = time.monotonic()
    mesh = make_mesh(axes["data"], axes["tensor"], args.device, fsdp=axes["fsdp"])
    tr = MeshTrainer(mesh, model=model, dataset=data, batch=args.batch, seq_len=args.seq_len,
                     seed=SEED, lr=LR, warmup_steps=WARMUP, total_steps=TOTAL)
    boot_s = time.monotonic() - t0
    out = {"model": model, "mesh": mesh.axes, "ranks": mesh.size, "boot_s": round(boot_s, 3)}
    gathered = None
    try:
        if restore_from:
            t0 = time.monotonic()
            out["restored_step"] = tr.restore(restore_from)
            out["restore_s"] = round(time.monotonic() - t0, 3)
            gathered = tr.full_state()
        else:
            fa.flash_attention.launches = 0
            losses, ms = [], []
            for i in range(args.steps):
                t0 = time.monotonic()
                losses.append(float(tr.step(i)))
                ms.append((time.monotonic() - t0) * 1e3)
            out.update(losses=losses, step_ms=[round(x, 3) for x in ms],
                       step_ms_median_2_on=round(statistics.median(ms[1:] or ms), 3),
                       tokens_per_s=round(args.batch * args.seq_len
                                          / statistics.median(ms[1:] or ms) * 1e3, 1),
                       flash_launches_per_step_rank0=fa.flash_attention.launches // args.steps)
            if save_to:
                t0 = time.monotonic()
                tr.save(save_to)
                out["save_s"] = round(time.monotonic() - t0, 3)
                out["save_bytes"] = sum(os.path.getsize(os.path.join(d, f))
                                        for d, _, fs in os.walk(save_to) for f in fs)
                gathered = tr.full_state()
        if args.device == "cuda":
            sync("cuda")
            out["peak_gb_rank0"] = round(torch.cuda.max_memory_allocated() / 1e9, 3)
            out["peak_gb_followers"] = {r: round(s.get("peak", 0) / 1e9, 3) for r, s in
                                        sorted(mesh.group.peer_stats.items())}
        tr.close()
    finally:
        del tr
        launch.shutdown()
        if args.device == "cuda":
            torch.cuda.empty_cache()
    return out, gathered


def check_losses(label: str, got: list, want: list | None, falling: bool = True,
                 steps: int = 1) -> None:
    """``got`` finite (and falling), its first ``steps`` within 1e-2
    relative of ``want``'s."""
    if not all(np.isfinite(got)) or (falling and not got[-1] < got[0]):
        raise AssertionError(f"{label}: losses {got} not finite or not falling")
    for a, b in zip(got[:steps], (want or [])[:steps]):
        if abs(a - b) > 1e-2 * abs(b):
            raise AssertionError(f"{label}: losses {got} against {want}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model", default="llama3-1b", choices=sorted(MODELS))
    ap.add_argument("--big-model", default="llama3-8b", choices=sorted(MODELS))
    ap.add_argument("--meshes", default="fsdp=4;fsdp=2,tensor=2;data=2,tensor=2;tensor=4")
    ap.add_argument("--big-meshes", default="fsdp=4;fsdp=2,tensor=2")
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq-len", type=int, default=2048)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    if args.device == "cuda":
        if not torch.cuda.is_available():
            print("train_mesh_check: no CUDA device", file=sys.stderr)
            return 2
        torch.backends.cuda.matmul.allow_tf32 = False
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True).stdout.strip(), flush=True)
    tmp = tempfile.mkdtemp(prefix="kukeon-train-mesh-")
    try:
        data = os.path.join(tmp, "tokens.bin")
        zipf_dataset(data, 4_000_000 if args.device == "cuda" else 20_000,
                     MODELS[args.model]().vocab_size)
        if args.meshes:
            small(data, tmp, args)
        big = None
        for axes in [parse_mesh(m) for m in args.big_meshes.split(";") if m]:
            rep, _ = mesh_run(args.big_model, axes, data, args)
            check_losses(f"{args.big_model} {axes}", rep["losses"], big, falling=False,
                         steps=args.steps)
            big = big or rep["losses"]
            emit({"run": "mesh", **rep})
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return 0


def small(data: str, tmp: str, args) -> None:
    """``--model`` on one device, then on each of ``--meshes``, the first
    saving its state under ``tmp`` and the last restoring it."""
    ref = one_device(args.model, data, args)
    emit({"run": "one_device", "model": args.model, **ref})
    if args.device == "cuda":
        torch.cuda.empty_cache()
    meshes = [parse_mesh(m) for m in args.meshes.split(";")]
    ckpt = os.path.join(tmp, "ckpt")
    saved = None
    for i, axes in enumerate(meshes):
        rep, got = mesh_run(args.model, axes, data, args, save_to=ckpt if i == 0 else None)
        check_losses(str(axes), rep["losses"], ref["losses"])
        rep["first_loss_rel_diff"] = abs(rep["losses"][0] - ref["losses"][0]) / abs(
            ref["losses"][0])
        saved = got if got is not None else saved
        emit({"run": "mesh", **rep})
    if saved is not None and latest_step(ckpt) == args.steps:
        rep, got = mesh_run(args.model, meshes[-1], data, args, restore_from=ckpt)
        rep["restored_bitwise"] = sorted(got) == sorted(saved) and all(
            torch.equal(got[k], saved[k]) for k in saved)
        if not rep["restored_bitwise"]:
            raise AssertionError(f"restore on {meshes[-1]} differs from the save")
        emit({"run": "restore", **rep})
    shutil.rmtree(ckpt, ignore_errors=True)


if __name__ == "__main__":
    sys.exit(main())
