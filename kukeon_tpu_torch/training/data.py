"""Training data, the port of ``kukeon_tpu/training/data.py``.

:class:`TokenDataset` and :func:`sample_batch` are the JAX package's, as
they are (pure numpy): the same ``(seed, step)`` gives the same batch in
both packages, so a job resumed from a checkpoint at step N continues on
the exact data schedule. :func:`batches` moves each batch to a torch
device where the JAX package places it on a mesh; on a training mesh each
rank takes its own rows of it (:func:`rank_rows`) and, on a ``seq`` axis,
its own block of their columns (:func:`rank_cols`).

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


def rank_rows(batch_size: int, mesh) -> slice:
    """The rows of a ``batch_size`` batch that ``mesh``'s rank trains on:
    the reference's batch spec ``P((data, fsdp), seq)`` cuts them over
    data x fsdp, data-major, so block ``replica * fsdp + fsdp_rank`` of
    ``data * fsdp`` equal blocks; expert and tensor peers share their rows
    (the reference's batch is not cut over ``expert``: a MoE block's
    dispatch stays on the rank, ``models/moe.py``). A batch
    those axes do not divide is a ``ValueError`` (the reference's
    ``device_put`` refuses it too)."""
    n = mesh.data * mesh.fsdp
    if batch_size % n:
        raise ValueError(f"batch {batch_size} does not divide over data {mesh.data} x "
                         f"fsdp {mesh.fsdp}")
    rows = batch_size // n
    i = mesh.replica * mesh.fsdp + mesh.fsdp_rank
    return slice(i * rows, (i + 1) * rows)


def rank_cols(seq_len: int, mesh) -> slice:
    """The columns of a ``seq_len`` batch that ``mesh``'s rank trains on:
    the reference's batch spec ``P((data, fsdp), seq)`` cuts the sequence
    over ``seq``, so block ``seq_rank`` of ``seq`` equal blocks (all of
    them at ``seq`` 1). A length ``seq`` does not divide is a
    ``ValueError`` (the reference's ``device_put`` refuses it too)."""
    if seq_len % mesh.seq:
        raise ValueError(f"seq_len {seq_len} does not divide over seq {mesh.seq}")
    cols = seq_len // mesh.seq
    return slice(mesh.seq_rank * cols, (mesh.seq_rank + 1) * cols)


def batches(ds: TokenDataset, batch_size: int, seq_len: int, *,
            device: torch.device | str, start_step: int = 0,
            num_steps: int | None = None, seed: int = 0, mesh=None):
    """Yield (step, tokens, targets, mask) from ``start_step`` (resume
    point), as torch tensors on ``device``; with a training ``mesh``, only
    its rank's rows and columns (:func:`rank_rows`, :func:`rank_cols`),
    which every rank computes from ``(seed, step)`` on its own, as the
    reference's ``batches(..., sharding=)`` places them."""
    steps = (range(start_step, start_step + num_steps)
             if num_steps is not None else itertools.count(start_step))
    block = ((slice(None), slice(None)) if mesh is None
             else (rank_rows(batch_size, mesh), rank_cols(seq_len, mesh)))
    for step in steps:
        batch = sample_batch(ds, step, batch_size, seq_len, seed=seed)
        yield (step, *(torch.from_numpy(np.ascontiguousarray(a[block])).to(device)
                       for a in batch))
