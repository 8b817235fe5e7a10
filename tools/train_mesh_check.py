"""Train the Llama or MoE family on meshes of this host's devices and hold
each to one device: the port's training mesh (``training/mesh_trainer.py``)
across real GPUs, where ``chip_smoke.py``'s ``train_tp`` and
``train_moe_tp`` have one.

For ``--model`` (llama3-1b by default: ``chip_smoke.py``'s ``train``
configuration, B 4, S 2048, lr 3e-4, warmup 1, seed 0, its Zipf dataset;
``mixtral-8x7b`` cut to ``--layers`` layers, the config handed to each
rank's trainer):

1. ``--steps`` steps on one device (``create_train_state``,
   ``make_train_step``, or their MoE twins, on device 0): the losses to
   hold the meshes to;
2. the same steps through ``MeshTrainer`` on each mesh of ``--meshes``
   (a rank group of one process per device, NCCL): the losses, each
   step's host-clock ms (ending in the loss's read), the leader's peak
   memory and each follower's (its allocator counters, reported to the
   leader every second), flash launches a step on the leader, a MoE
   model's load-balance loss, and whether every leaf replicated over an
   axis holds the same bits on each of its peers
   (``MeshTrainer.replica_mismatches``); the first mesh then saves its
   state (seconds, bytes) and the last restores it and gathers it back,
   bit for bit against what the first gathered;
3. ``--big-model`` (llama3-8b; ``--big-layers`` cuts a Mixtral) on each
   mesh of ``--big-meshes`` at ``--big-batch`` rows: steps, ms and peaks,
   with no one-device run (its state and activations do not fit one
   card); its meshes' losses held to each other;
4. with ``--long S``: ``--model`` at B 1 and sequence length S on one
   device (an out-of-memory error is recorded, not raised) and on
   ``--long-mesh`` (``seq=4``), then on that mesh at 2 S, 4 S and 8 S
   until a length does not fit, each in a child process of its own (a rank
   that runs out of memory may leave its peers waiting in a collective:
   the child's group times out after ``KUKEON_TP_TIMEOUT_S``, 120 s
   here, and its exit marks the length as not fitting).

A mesh may hold ``seq`` (either family: a Llama model attends through
ring attention, a MoE model over every key gathered, as the reference's
steps do) and ``pipe`` (the Llama family's GPipe step, at
``--microbatches`` microbatches, default 2 x pipe; each pipeline run
reports its bubble share ``(P - 1) / (M + P - 1)``); every run reports a
rank's counted state bytes (``TrainLayout.state_bytes``).

Losses are bf16 sums in another order than one device's (ROADMAP §C), so
each mesh's first loss, before any update, must be within ``--rtol``
(1e-2) relative of one device's (the big model's: of its first mesh's, at
every step),
every loss finite, and a Llama ``--model``'s last below its first (at lr
3e-4 and warmup 1, llama3-8b's third loss rises from random weights, and
a MoE model's as its router collapses, ROADMAP C8, on every mesh alike).
Prints the ``nvidia-smi`` name and power limit, then one JSON line a
run. An empty ``--meshes`` skips ``--model``.

    python3 tools/train_mesh_check.py              # on a host with 4 GPUs
    python3 tools/train_mesh_check.py --rtol 1e-3 --microbatches 4 \
        --meshes "pipe=4;seq=4;data=2,seq=2;seq=2,tensor=2;pipe=2,data=2;pipe=2,tensor=2" \
        --restore-mesh fsdp=4 --big-meshes "pipe=4;fsdp=4" --big-batch 8 --long 16384
    python3 tools/train_mesh_check.py --model mixtral-8x7b --layers 4 \
        --meshes "expert=4;fsdp=4;expert=2,fsdp=2;expert=2,tensor=2" \
        --big-model mixtral-8x7b --big-layers 16 --big-meshes "expert=4;fsdp=4"
    python3 tools/train_mesh_check.py --model mixtral-8x7b --layers 4 \
        --meshes "seq=2,expert=2;data=2,seq=2;seq=4" --big-meshes ""

``--device cpu --model tiny --big-model tiny --batch 8 --seq-len 32``
(or ``--model mixtral-tiny --big-model mixtral-tiny``) checks the script
on gloo ranks without a card.
"""

from __future__ import annotations

import argparse
import dataclasses
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
from kukeon_tpu_torch.models import moe  # noqa: E402
from kukeon_tpu_torch.training import (TokenDataset, batches,  # noqa: E402
                                       create_moe_train_state, create_train_state)
from kukeon_tpu_torch.training.checkpointing import latest_step  # noqa: E402
from kukeon_tpu_torch.training.mesh_trainer import MODELS, MeshTrainer  # noqa: E402
from kukeon_tpu_torch.training.train_step import (make_moe_train_step,  # noqa: E402
                                                  make_optimizer, make_train_step)

LR, WARMUP, TOTAL, SEED = 3e-4, 1, 8, 0


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def parse_mesh(text: str) -> dict[str, int]:
    """``"fsdp=2,tensor=2"`` -> ``{"data": 1, "fsdp": 2, "expert": 1,
    "tensor": 2, "seq": 1, "pipe": 1}``."""
    axes = {"data": 1, "fsdp": 1, "expert": 1, "tensor": 1, "seq": 1, "pipe": 1}
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


def config(model: str, layers: int):
    """``model``'s config, cut to ``layers`` layers (0: its own depth)."""
    cfg = MODELS[model]()
    return dataclasses.replace(cfg, num_layers=layers) if layers else cfg


def loss_of(out) -> tuple[float, float | None]:
    """(loss, load balance or None) of a step's output (a MoE step's
    metrics, else the loss)."""
    if isinstance(out, dict):
        return float(out["loss"]), float(out["load_balance"])
    return float(out), None


def one_device(model: str, layers: int, data: str, args, batch: int | None = None,
               seq_len: int | None = None) -> dict:
    batch, seq_len = batch or args.batch, seq_len or args.seq_len
    cfg = config(model, layers)
    dev = "cuda" if args.device == "cuda" else "cpu"
    is_moe = isinstance(cfg, moe.MoEConfig)
    opt = make_optimizer(LR, warmup_steps=WARMUP, total_steps=TOTAL)
    state, opt = (create_moe_train_state if is_moe else create_train_state)(
        cfg, torch.Generator(device=dev).manual_seed(SEED), dev, opt)
    step = (make_moe_train_step if is_moe else make_train_step)(cfg, opt)
    losses, ms = [], []
    for _s, *rows in batches(TokenDataset(data), batch, seq_len,
                             num_steps=args.steps, seed=SEED, device=dev):
        t0 = time.monotonic()
        state, out = step(state, *rows)
        losses.append(loss_of(out)[0])
        ms.append((time.monotonic() - t0) * 1e3)
    del state, step
    out = {"losses": losses, "step_ms": [round(x, 3) for x in ms]}
    if args.device == "cuda":
        out["peak_gb"] = round(torch.cuda.max_memory_allocated() / 1e9, 3)
    return out


def mesh_run(model: str, layers: int, axes: dict, data: str, args,
             save_to: str | None = None, restore_from: str | None = None,
             batch: int | None = None, seq_len: int | None = None,
             microbatches: int | None = None) -> tuple[dict, dict | None]:
    """One mesh's run -> (its report, the state it gathered after a save
    or a restore, else None)."""
    batch, seq_len = batch or args.batch, seq_len or args.seq_len
    if args.device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    t0 = time.monotonic()
    mesh = make_mesh(axes["data"], axes["tensor"], args.device, fsdp=axes["fsdp"],
                     expert=axes["expert"], seq=axes["seq"], pipe=axes["pipe"])
    cfg = config(model, layers)
    tr = MeshTrainer(mesh, model=model, cfg=cfg, dataset=data, batch=batch,
                     seq_len=seq_len, seed=SEED, lr=LR, warmup_steps=WARMUP,
                     total_steps=TOTAL, num_microbatches=microbatches if axes["pipe"] > 1
                     else None)
    boot_s = time.monotonic() - t0
    out = {"model": model, "layers": cfg.num_layers, "mesh": mesh.axes, "ranks": mesh.size,
           "batch": batch, "seq_len": seq_len, "boot_s": round(boot_s, 3),
           "state_gb_rank0": round(tr.layout.state_bytes() / 1e9, 3)}
    if tr.pipeline:
        m = microbatches or 2 * mesh.pipe
        out.update(microbatches=m, bubble_share=round((mesh.pipe - 1) / (m + mesh.pipe - 1), 4))
    gathered = None
    try:
        if restore_from:
            t0 = time.monotonic()
            out["restored_step"] = tr.restore(restore_from)
            out["restore_s"] = round(time.monotonic() - t0, 3)
            gathered = tr.full_state()
        else:
            fa.flash_attention.launches = 0
            losses, lbs, ms = [], [], []
            for i in range(args.steps):
                t0 = time.monotonic()
                loss, lb = loss_of(tr.step(i))
                ms.append((time.monotonic() - t0) * 1e3)
                losses.append(loss)
                lbs.append(lb)
            out.update(losses=losses, step_ms=[round(x, 3) for x in ms],
                       step_ms_median_2_on=round(statistics.median(ms[1:] or ms), 3),
                       tokens_per_s=round(batch * seq_len
                                          / statistics.median(ms[1:] or ms) * 1e3, 1),
                       flash_launches_per_step_rank0=fa.flash_attention.launches // args.steps,
                       replica_mismatches=tr.replica_mismatches())
            if lbs[0] is not None:
                out["load_balance"] = lbs
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
                 steps: int = 1, rtol: float = 1e-2) -> None:
    """``got`` finite (and falling), its first ``steps`` within ``rtol``
    relative of ``want``'s."""
    if not all(np.isfinite(got)) or (falling and not got[-1] < got[0]):
        raise AssertionError(f"{label}: losses {got} not finite or not falling")
    for a, b in zip(got[:steps], (want or [])[:steps]):
        if abs(a - b) > rtol * abs(b):
            raise AssertionError(f"{label}: losses {got} against {want}")


def check_replicas(rep: dict) -> None:
    if rep["replica_mismatches"]:
        raise AssertionError(f"{rep['mesh']}: replicated leaves differ across peers: "
                             f"{rep['replica_mismatches']}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model", default="llama3-1b", choices=sorted(MODELS))
    ap.add_argument("--layers", type=int, default=0,
                    help="cut --model to this many layers (0: its own depth)")
    ap.add_argument("--big-model", default="llama3-8b", choices=sorted(MODELS))
    ap.add_argument("--big-layers", type=int, default=0,
                    help="cut --big-model to this many layers (0: its own depth)")
    ap.add_argument("--meshes", default="fsdp=4;fsdp=2,tensor=2;data=2,tensor=2;tensor=4")
    ap.add_argument("--big-meshes", default="fsdp=4;fsdp=2,tensor=2")
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--big-batch", type=int, default=0, help="0: --batch")
    ap.add_argument("--seq-len", type=int, default=2048)
    ap.add_argument("--microbatches", type=int, default=0,
                    help="--model's pipeline microbatches (0: 2 x pipe)")
    ap.add_argument("--restore-mesh", default="",
                    help="the mesh that restores the first mesh's save (default: the last)")
    ap.add_argument("--rtol", type=float, default=1e-2,
                    help="a mesh's first loss against one device's, relative")
    ap.add_argument("--long", type=int, default=0,
                    help="sequence length of the long-context runs at B 1 (0: none)")
    ap.add_argument("--long-mesh", default="seq=4")
    ap.add_argument("--long-one", type=int, default=0, help=argparse.SUPPRESS)
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
                     min(MODELS[args.model]().vocab_size, MODELS[args.big_model]().vocab_size))
        if args.long_one:
            rep, _ = mesh_run(args.model, args.layers, parse_mesh(args.long_mesh), data, args,
                              batch=1, seq_len=args.long_one)
            check_replicas(rep)
            emit({"run": "long", **rep})
            return 0
        if args.meshes:
            small(data, tmp, args)
        if args.long:
            long_context(data, args)
        big = None
        for axes in [parse_mesh(m) for m in args.big_meshes.split(";") if m]:
            rep, _ = mesh_run(args.big_model, args.big_layers, axes, data, args,
                              batch=args.big_batch or None)
            check_losses(f"{args.big_model} {axes}", rep["losses"], big, falling=False,
                         steps=args.steps)
            check_replicas(rep)
            big = big or rep["losses"]
            emit({"run": "mesh", **rep})
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return 0


def small(data: str, tmp: str, args) -> None:
    """``--model`` on one device, then on each of ``--meshes``, the first
    saving its state under ``tmp`` and the last restoring it."""
    ref = one_device(args.model, args.layers, data, args)
    emit({"run": "one_device", "model": args.model, **ref})
    if args.device == "cuda":
        torch.cuda.empty_cache()
    meshes = [parse_mesh(m) for m in args.meshes.split(";")]
    ckpt = os.path.join(tmp, "ckpt")
    saved = None
    for i, axes in enumerate(meshes):
        rep, got = mesh_run(args.model, args.layers, axes, data, args,
                            save_to=ckpt if i == 0 else None,
                            microbatches=args.microbatches or None)
        # A MoE model's third loss rises at lr 3e-4 and warmup 1, on one
        # device and every mesh alike: the router's collapse (ROADMAP C8).
        check_losses(str(axes), rep["losses"], ref["losses"],
                     falling=not isinstance(config(args.model, 0), moe.MoEConfig),
                     rtol=args.rtol)
        check_replicas(rep)
        rep["first_loss_rel_diff"] = abs(rep["losses"][0] - ref["losses"][0]) / abs(
            ref["losses"][0])
        saved = got if got is not None else saved
        emit({"run": "mesh", **rep})
    if saved is not None and latest_step(ckpt) == args.steps:
        where = parse_mesh(args.restore_mesh) if args.restore_mesh else meshes[-1]
        rep, got = mesh_run(args.model, args.layers, where, data, args, restore_from=ckpt)
        rep["restored_bitwise"] = sorted(got) == sorted(saved) and all(
            torch.equal(got[k], saved[k]) for k in saved)
        if not rep["restored_bitwise"]:
            raise AssertionError(f"restore on {where} differs from the save")
        emit({"run": "restore", **rep})
    shutil.rmtree(ckpt, ignore_errors=True)


def long_context(data: str, args) -> None:
    """``--model`` at B 1 and S ``--long`` on one device (its running out
    of memory recorded), then on ``--long-mesh`` at S, 2 S, 4 S and 8 S,
    each in a child process, up to the first length that does not fit."""
    S = args.long
    try:
        ref = one_device(args.model, args.layers, data, args, batch=1, seq_len=S)
        emit({"run": "long_one_device", "seq_len": S, **ref})
    except torch.OutOfMemoryError as e:
        ref = None
        emit({"run": "long_one_device", "seq_len": S, "out_of_memory": str(e)[:300]})
    finally:
        if args.device == "cuda":
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
    fits = []
    while S <= 8 * args.long:
        cmd = [sys.executable, os.path.abspath(__file__), "--model", args.model,
               "--layers", str(args.layers), "--long-one", str(S), "--long-mesh",
               args.long_mesh, "--steps", str(args.steps), "--device", args.device,
               "--meshes", "", "--big-meshes", ""]
        env = {**os.environ, launch.TIMEOUT_ENV: "120"}
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True, env=env, timeout=600)
        except subprocess.TimeoutExpired as e:
            got = e.stdout.decode() if isinstance(e.stdout, bytes) else e.stdout
            proc = subprocess.CompletedProcess(cmd, None, got or "", str(e))
        lines = [ln for ln in (proc.stdout or "").splitlines() if ln.startswith("{")]
        rep = json.loads(lines[-1]) if proc.returncode == 0 and lines else None
        if rep is None:
            emit({"run": "long", "mesh": args.long_mesh, "seq_len": S, "fits": False,
                  "exit_code": proc.returncode, "stderr_tail": str(proc.stderr)[-600:]})
            break
        if ref is not None and S == args.long:
            check_losses(f"long {args.long_mesh}", rep["losses"], ref["losses"],
                         falling=False, rtol=args.rtol)
        fits.append(S)
        emit({**rep, "fits": True})
        S *= 2
    emit({"run": "long_summary", "mesh": args.long_mesh, "longest_fitting_seq_len":
          max(fits) if fits else None, "tried_up_to": min(S, 8 * args.long)})


if __name__ == "__main__":
    sys.exit(main())
