"""Training data, the port of ``kukeon_tpu/training/data.py``.

:class:`TokenDataset` and :func:`sample_batch` are the JAX package's, as
they are (pure numpy): the same ``(seed, step)`` gives the same batch in
both packages, so a job resumed from a checkpoint at step N continues on
the exact data schedule. :func:`batches` moves each batch to a torch
device where the JAX package places it on a mesh.

Format: a flat ``.bin`` of token ids (uint16 when vocab < 65536, else
uint32) with a sibling ``<name>.meta.json`` {"dtype", "num_tokens"}.
"""

from __future__ import annotations

import itertools
import json
import os

import numpy as np
import torch


class TokenDataset:
    """Read-only memmapped token stream."""

    def __init__(self, path: str):
        meta_path = path.rsplit(".bin", 1)[0] + ".meta.json"
        if os.path.exists(meta_path):
            with open(meta_path) as f:
                meta = json.load(f)
            dtype = np.dtype(meta["dtype"])
        else:
            dtype = np.dtype(np.uint16)
        self.path = path
        self.tokens = np.memmap(path, dtype=dtype, mode="r")

    def __len__(self) -> int:
        return int(self.tokens.shape[0])

    @staticmethod
    def write(path: str, tokens, dtype=None) -> "TokenDataset":
        """Write a token array as a dataset (tools/tests)."""
        tokens = np.asarray(tokens)
        if dtype is None:
            dtype = np.uint16 if tokens.max(initial=0) < 65536 else np.uint32
        arr = tokens.astype(dtype)
        arr.tofile(path)
        with open(path.rsplit(".bin", 1)[0] + ".meta.json", "w") as f:
            json.dump({"dtype": np.dtype(dtype).name,
                       "num_tokens": int(arr.shape[0])}, f)
        return TokenDataset(path)


def sample_batch(ds: TokenDataset, step: int, batch_size: int, seq_len: int,
                 *, seed: int = 0):
    """(tokens, targets, mask) numpy batch for ``step`` — deterministic:
    the same (seed, step) always yields the same batch."""
    n = len(ds)
    if n < seq_len + 1:
        raise ValueError(
            f"dataset {ds.path} has {n} tokens < seq_len+1 ({seq_len + 1})"
        )
    rng = np.random.default_rng([seed, step])
    # Exclusive high: the last valid window starts at n - seq_len - 1
    # (targets slice reaches o + seq_len + 1 == n).
    offsets = rng.integers(0, n - seq_len, size=batch_size)
    tokens = np.stack([np.asarray(ds.tokens[o:o + seq_len]) for o in offsets])
    targets = np.stack(
        [np.asarray(ds.tokens[o + 1:o + seq_len + 1]) for o in offsets]
    )
    mask = np.ones((batch_size, seq_len), np.float32)
    return tokens.astype(np.int32), targets.astype(np.int32), mask


def batches(ds: TokenDataset, batch_size: int, seq_len: int, *,
            device: torch.device | str, start_step: int = 0,
            num_steps: int | None = None, seed: int = 0):
    """Yield (step, tokens, targets, mask) from ``start_step`` (resume
    point), as torch tensors on ``device``."""
    steps = (range(start_step, start_step + num_steps)
             if num_steps is not None else itertools.count(start_step))
    for step in steps:
        batch = sample_batch(ds, step, batch_size, seq_len, seed=seed)
        yield (step, *(torch.from_numpy(a).to(device) for a in batch))
