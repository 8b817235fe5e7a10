"""Training entry point, the port of ``kukeon_tpu/training/cli.py``:
data pipeline + train step + checkpoints, on one device or a mesh.

    python -m kukeon_tpu_torch.training.cli \\
        --dataset /data/tokens.bin --model llama3-8b \\
        --fsdp 4 --tensor 2 --steps 1000 --ckpt-dir /ckpts --save-every 500

The flags are the JAX entry point's, plus ``--device`` (default ``cuda``,
which raises without a GPU; ``--device cpu`` runs the plain PyTorch path,
a mesh's ranks as gloo processes). Batches are memmapped and a pure
function of (seed, step); the run resumes from the newest checkpoint in
``--ckpt-dir``.

``--data``, ``--fsdp``, ``--expert``, ``--seq``, ``--pipe`` and
``--tensor`` lay either family (``tiny``, ``llama3-1b``, ``llama3-8b``,
``mixtral-tiny``, ``mixtral-8x7b``) over a rank group of one process per
device (``training/mesh_trainer.py``); ``--expert`` cuts a MoE model's
experts (a Llama model's leaves are replicated over it, as the
reference's are); ``--seq`` cuts the sequence, a Llama model attending
through ring attention and a MoE model over every key gathered, as the
reference's steps do; ``--pipe`` trains a Llama model through the GPipe
step (``parallel/pipeline.py``). A MoE model at ``--pipe`` > 1 exits 2
with the reference's message. With no axis given and more than one visible
device (``mesh.visible_devices``: the visible GPUs, 8 gloo ranks on the
CPU), the default is the reference's, ``data = gcd(devices, batch)``, for
every model. The first line prints the mesh as the reference prints it.
More ranks than the host shows exits before any byte reaches a device.
``mixtral-*`` trains through
:func:`~kukeon_tpu_torch.training.train_step.make_moe_train_step` and
prints the load-balance loss on each step line (``lb=``); at full depth,
Mixtral-8x7B's training state (about 374 GB) does not fit one GPU and the
run fails with CUDA's out-of-memory error, as the reference's does on a
chip too small: on eight, ``--expert 8`` holds about 47 GB a rank.
"""

from __future__ import annotations

import argparse
import math
import os
import sys
import time

import torch

from kukeon_tpu_torch.device import resolve_device
from kukeon_tpu_torch.models import llama, moe

MESH_AXES = ("data", "fsdp", "tensor", "seq", "expert", "pipe")


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="kukeon-train")
    ap.add_argument("--dataset", required=True, help="token .bin file")
    ap.add_argument("--model", default="tiny",
                    choices=["tiny", "llama3-1b", "llama3-8b",
                             "mixtral-tiny", "mixtral-8x7b"])
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=512)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--warmup-steps", type=int, default=100)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--save-every", type=int, default=500)
    ap.add_argument("--log-every", type=int, default=10)
    for axis in MESH_AXES:
        ap.add_argument(f"--{axis}", type=int, default=1)
    ap.add_argument("--device", default=None,
                    help="cuda (the default; raises without a GPU) or cpu")
    return ap


def mesh_axes(args, device: torch.device) -> dict[str, int]:
    """``{"data", "fsdp", "expert", "tensor", "seq", "pipe"}`` of the run:
    the flags, or with none above 1 the reference's default, ``data =
    gcd(devices, batch)`` over the visible devices."""
    from kukeon_tpu_torch.parallel.mesh import visible_devices

    axes = {a: getattr(args, a) for a in ("data", "fsdp", "expert", "tensor", "seq", "pipe")}
    n = visible_devices(device.type)
    if math.prod(axes.values()) == 1 and n > 1:
        axes["data"] = math.gcd(n, args.batch)
    return axes


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    is_moe = args.model.startswith("mixtral")
    if is_moe and args.pipe > 1:
        print("error: pipeline parallelism is llama-only for now", file=sys.stderr)
        return 2
    device = resolve_device(args.device)
    axes = mesh_axes(args, device)
    if math.prod(axes.values()) > 1:
        return train_on_mesh(args, device, axes, is_moe)

    from kukeon_tpu_torch.training import (
        TokenDataset,
        batches,
        create_moe_train_state,
        create_train_state,
        latest_step,
        make_moe_train_step,
        make_train_step,
        restore_checkpoint,
        save_checkpoint,
    )
    from kukeon_tpu_torch.training.train_step import make_optimizer

    cfgs = {"tiny": llama.llama_tiny, "llama3-1b": llama.llama3_1b,
            "llama3-8b": llama.llama3_8b,
            "mixtral-tiny": moe.moe_tiny, "mixtral-8x7b": moe.mixtral_8x7b}
    cfg = cfgs[args.model]()
    mesh_shape = {"pipe": 1, "data": 1, "fsdp": 1, "expert": 1, "seq": 1, "tensor": 1}
    print(f"train: model={args.model} mesh={mesh_shape} batch={args.batch} "
          f"seq={args.seq_len}", flush=True)

    ds = TokenDataset(args.dataset)
    optimizer = make_optimizer(
        learning_rate=args.lr, warmup_steps=args.warmup_steps,
        total_steps=max(args.steps, args.warmup_steps + 1),
    )
    generator = torch.Generator(device=device).manual_seed(args.seed)
    if is_moe:
        state, optimizer = create_moe_train_state(cfg, generator, device, optimizer)
        step_fn = make_moe_train_step(cfg, optimizer)
    else:
        state, optimizer = create_train_state(cfg, generator, device, optimizer)
        step_fn = make_train_step(cfg, optimizer)

    start = 0
    if args.ckpt_dir and latest_step(args.ckpt_dir) is not None:
        # Restores in place into the fresh state: no second copy on the device.
        state = restore_checkpoint(args.ckpt_dir, state)
        start = state.step
        print(f"train: resumed from step {start}", flush=True)

    feed = batches(ds, args.batch, args.seq_len, start_step=start,
                   num_steps=args.steps - start, seed=args.seed, device=device)

    def run(_step: int):
        nonlocal state
        _s, tok, tgt, mask = next(feed)
        state, out = step_fn(state, tok, tgt, mask)
        return out

    def save() -> int:
        save_checkpoint(args.ckpt_dir, state)
        return state.step

    train_loop(args, start, run, save, is_moe)
    return 0


def train_loop(args, start: int, run, save, is_moe: bool = False) -> None:
    """Steps ``start`` .. ``--steps`` - 1: ``run(step)`` -> the step's loss
    (the MoE step's metrics), a step line every ``--log-every`` steps and
    at the last, ``save()`` every ``--save-every`` steps and at the end
    (it returns the step it saved)."""
    t0 = time.monotonic()
    last_logged = start
    for step in range(start, args.steps):
        out = run(step)
        if (step + 1) % args.log_every == 0 or step + 1 == args.steps:
            loss = float(out["loss"] if is_moe else out)    # waits for the device
            dt = time.monotonic() - t0
            window = step + 1 - last_logged   # may be < log_every at the tail
            tput = args.batch * args.seq_len * window / max(dt, 1e-9)
            extra = f" lb={float(out['load_balance']):.3f}" if is_moe else ""
            print(f"step {step + 1} loss {loss:.4f}{extra} ({tput:.0f} tok/s)", flush=True)
            t0 = time.monotonic()
            last_logged = step + 1
        if (args.ckpt_dir and args.save_every
                and (step + 1) % args.save_every == 0):
            save()
    if args.ckpt_dir:
        print(f"train: checkpoint at step {save()} -> {args.ckpt_dir}", flush=True)


def train_on_mesh(args, device: torch.device, axes: dict[str, int], is_moe: bool) -> int:
    """Either family over ``axes`` (pipe x data x fsdp x expert x seq x
    tensor), this process the group's leader: :func:`train_loop` through a
    :class:`~kukeon_tpu_torch.training.mesh_trainer.MeshTrainer`. A rank
    that dies ends the run with exit 1."""
    from kukeon_tpu_torch.parallel import launch
    from kukeon_tpu_torch.parallel.mesh import make_mesh
    from kukeon_tpu_torch.training.checkpointing import latest_step
    from kukeon_tpu_torch.training.mesh_trainer import MeshTrainer

    try:
        mesh = make_mesh(axes["data"], axes["tensor"], device.type, fsdp=axes["fsdp"],
                         expert=axes["expert"], seq=axes["seq"], pipe=axes["pipe"])
    except ValueError as e:
        raise SystemExit(" ".join(f"--{a} {n}" for a, n in axes.items()) + f": {e}") from e

    def _rank_failed(why: str):
        print(f"train: {why}; exiting 1", file=sys.stderr, flush=True)
        os._exit(1)

    mesh.group.on_failure = _rank_failed
    print(f"train: model={args.model} mesh={mesh.axes} batch={args.batch} "
          f"seq={args.seq_len}", flush=True)
    try:
        trainer = MeshTrainer(mesh, model=args.model, dataset=args.dataset, batch=args.batch,
                              seq_len=args.seq_len, seed=args.seed, lr=args.lr,
                              warmup_steps=args.warmup_steps,
                              total_steps=max(args.steps, args.warmup_steps + 1))
        start = 0
        if args.ckpt_dir and latest_step(args.ckpt_dir) is not None:
            start = trainer.restore(args.ckpt_dir)
            print(f"train: resumed from step {start}", flush=True)

        def save() -> int:
            trainer.save(args.ckpt_dir)
            return trainer.state.step

        train_loop(args, start, trainer.step, save, is_moe)
        trainer.close()
    finally:
        launch.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
