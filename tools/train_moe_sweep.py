"""The MoE train step's loss curve under several optimizer settings, from
one initial state and one batch sequence: chip_smoke.py's ``train_moe``
configuration (Mixtral-8x7B at full width and 4 layers, bf16, B 2, S 2048,
Zipf tokens), on one GPU.

    python3 tools/train_moe_sweep.py

One JSON line per setting: lr, warmup steps, steps, and each step's
(loss, load balance, router z). Each setting starts from the same draw
(generator seed 2, as ``train_moe``), so the curves differ only by the
optimizer.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
import sys
import tempfile

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

# (lr, warmup steps, steps): train_moe's setting twice (a repeat shows
# whether the curve is deterministic), longer, a longer warmup, lower lrs.
SETTINGS = ((3e-4, 1, 6), (3e-4, 1, 6), (3e-4, 1, 10), (3e-4, 3, 6), (1e-4, 1, 6),
            (3e-5, 1, 6))


def main() -> int:
    if not torch.cuda.is_available():
        print("train_moe_sweep: needs a GPU", file=sys.stderr)
        return 2
    spec = importlib.util.spec_from_file_location("chip_smoke_sweep",
                                                  os.path.join(ROOT, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    from kukeon_tpu_torch.models import moe
    from kukeon_tpu_torch.training import (
        TokenDataset,
        batches,
        create_moe_train_state,
        make_moe_train_step,
    )
    from kukeon_tpu_torch.training.train_step import make_optimizer

    torch.backends.cuda.matmul.allow_tf32 = False
    print(cs.nvidia_smi(), flush=True)
    cfg = dataclasses.replace(moe.mixtral_8x7b(), num_layers=cs.MOE_TRAIN_LAYERS)
    with tempfile.TemporaryDirectory() as tmp:
        data = os.path.join(tmp, "tokens.bin")
        cs.zipf_dataset(data, 1_000_000, seed=1, vocab=cfg.vocab_size)
        feed = list(batches(TokenDataset(data), cs.MOE_TRAIN_B, cs.MOE_TRAIN_S,
                            num_steps=max(s for *_x, s in SETTINGS), seed=0, device="cuda"))
    for lr, warmup, steps in SETTINGS:
        opt = make_optimizer(lr, warmup_steps=warmup, total_steps=steps)
        state, opt = create_moe_train_state(cfg, torch.Generator(device="cuda").manual_seed(2),
                                            "cuda", opt)
        step = make_moe_train_step(cfg, opt)
        rows = []
        for _s, tok, tgt, mask in feed[:steps]:
            state, m = step(state, tok, tgt, mask)
            rows.append([round(float(m[k]), 4) for k in ("loss", "load_balance", "router_z")])
        print(json.dumps({"lr": lr, "warmup": warmup, "steps": steps, "loss_lb_z": rows}),
              flush=True)
        del state, opt, step
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
