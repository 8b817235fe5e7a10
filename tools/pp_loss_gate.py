"""Whether ``chip_smoke.py``'s ``train_sp_pp`` (b) gate (each GPipe loss
within ``PP_LOSS_RTOL`` relative of ``train``'s) sees a pipeline that
loses or mis-weights one microbatch's gradient, on one GPU.

It runs (b) as the phase runs it (llama3-1b at full width and depth
through ``MeshTrainer``'s GPipe step, 2 microbatches of ``train``'s B 4,
S 2048, ``--steps`` steps, the phase's 3 by default, on a one-rank NCCL
group), then once for each weight of ``FAULT_WEIGHTS`` with a fault planted
at run time in the loss the pipeline step backpropagates
(``training.train_step.cross_entropy_loss``, as ``make_pp_train_step``
takes it): the first microbatch of every step keeps its loss's value but
backpropagates ``weight`` times its gradient (0: its backward skipped; 2:
counted twice). The code on disk is not changed.

Prints the ``nvidia-smi`` name and power limit, then one JSON line a run:
its losses, their relative gaps from ``train``'s, and whether the gate
holds. Exits 1 unless the sound run holds the gate and every planted
fault breaks it.

    python3 tools/pp_loss_gate.py [--steps 3]
"""

from __future__ import annotations

import argparse
import contextlib
import itertools
import json
import os
import sys
from unittest import mock

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from kukeon_tpu_torch.ops import flash_attention as fa  # noqa: E402
from kukeon_tpu_torch.training import train_step as tts  # noqa: E402

# The planted faults: the first microbatch's gradient skipped, and doubled.
FAULT_WEIGHTS = (0.0, 2.0)


def weighted_first_microbatch(weight: float):
    """``cross_entropy_loss`` whose value is unchanged but whose gradient
    is ``weight`` times the true one on the first microbatch of each step
    (every PP_MICROBATCHES-th call, as one rank runs them in order)."""
    real = tts.cross_entropy_loss
    calls = itertools.count()

    def cross_entropy_loss(*args, **kwargs):
        share = real(*args, **kwargs)
        if next(calls) % cs.PP_MICROBATCHES:
            return share
        kept = share.detach()
        return kept + weight * (share - kept)

    return cross_entropy_loss


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=cs.PP_STEPS,
                    help="steps a run (the phase's PP_STEPS by default; at most train's "
                         "TRAIN_STEPS)")
    args = ap.parse_args(argv)
    cs.PP_STEPS = args.steps
    if not torch.cuda.is_available():
        print("pp_loss_gate: needs a CUDA GPU", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(cs.nvidia_smi())
    runs = [("sound", None)] + [(f"weight {w:g}", w) for w in FAULT_WEIGHTS]
    want, ok = None, True
    for name, weight in runs:
        patch = (contextlib.nullcontext() if weight is None else
                 mock.patch.object(tts, "cross_entropy_loss", weighted_first_microbatch(weight)))
        with patch:
            out = cs.train_pp_mesh(fa, want)
        want = out["train_losses"]
        rel = out["loss_rel_diff"]
        holds = len(rel) == cs.PP_STEPS and max(rel) <= cs.PP_LOSS_RTOL
        ok = ok and holds == (weight is None)
        print(json.dumps({"run": name, "losses": out["losses"], "train_losses": want,
                          "loss_rel_diff": rel, "max_rel": max(rel),
                          "loss_rtol": cs.PP_LOSS_RTOL, "gate_holds": holds,
                          "step_ms": out["step_ms"]}), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
