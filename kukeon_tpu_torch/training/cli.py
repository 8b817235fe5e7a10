"""Training entry point, the port of ``kukeon_tpu/training/cli.py``:
data pipeline + train step + checkpoints, on one device.

    python -m kukeon_tpu_torch.training.cli \\
        --dataset /data/tokens.bin --model llama3-1b \\
        --batch 4 --seq-len 2048 --steps 1000 --ckpt-dir /ckpts --save-every 500

The flags are the JAX entry point's, plus ``--device`` (default ``cuda``,
which raises without a GPU; ``--device cpu`` runs the plain PyTorch path).
Batches are memmapped and a pure function of (seed, step); the run resumes
from the newest checkpoint in ``--ckpt-dir``. ``mixtral-*`` trains the MoE
family through :func:`~kukeon_tpu_torch.training.train_step.make_moe_train_step`
and prints the load-balance loss on each step line (``lb=``); at full
depth, Mixtral-8x7B's training state (about 374 GB) does not fit one GPU
and the run fails with CUDA's out-of-memory error, as the reference's does
on a chip too small. A mesh axis above 1 (``--data``, ``--fsdp``,
``--tensor``, ``--seq``, ``--expert``, ``--pipe``) is not ported yet and
raises (ROADMAP A13c).
"""

from __future__ import annotations

import argparse
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


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    sharded = {a: getattr(args, a) for a in MESH_AXES if getattr(args, a) > 1}
    if sharded:
        raise NotImplementedError(
            f"mesh axes {sharded}: the port trains on one GPU; multi-GPU "
            "(data/fsdp/tensor/seq/expert/pipeline parallelism) is ROADMAP.md A13c")
    device = resolve_device(args.device)

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

    is_moe = args.model.startswith("mixtral")
    cfgs = {"tiny": llama.llama_tiny, "llama3-1b": llama.llama3_1b,
            "llama3-8b": llama.llama3_8b,
            "mixtral-tiny": moe.moe_tiny, "mixtral-8x7b": moe.mixtral_8x7b}
    cfg = cfgs[args.model]()
    print(f"train: model={args.model} device={device} "
          f"batch={args.batch} seq={args.seq_len}", flush=True)

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

    t0 = time.monotonic()
    last_logged = start
    for step, tok, tgt, mask in batches(
        ds, args.batch, args.seq_len, start_step=start,
        num_steps=args.steps - start, seed=args.seed, device=device,
    ):
        state, out = step_fn(state, tok, tgt, mask)
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
            save_checkpoint(args.ckpt_dir, state)
    if args.ckpt_dir:
        save_checkpoint(args.ckpt_dir, state)
        print(f"train: checkpoint at step {state.step} -> {args.ckpt_dir}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
