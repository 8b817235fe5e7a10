"""Ulysses sequence parallelism over the ``seq`` axis, the port of
``kukeon_tpu/parallel/ulysses.py``.

Each rank holds one block of the sequence ([B, S/n, h, D], its ``seq``
coordinate's positions, ``h`` its heads after any ``tensor`` cut). One
all-to-all (:func:`parallel.autograd.all_to_all`, split on the heads,
concatenated on the sequence) gives every rank the whole sequence for
``h / n`` of the heads, the positions are all-gathered, attention runs
over the whole sequence on those heads (``attention_reference``, the
reference's local body), and the inverse all-to-all gives each rank its
block of the sequence back with all its heads. Both all-to-alls are their
own adjoints with the dims swapped, so the backward is two more.

The per-rank head counts must divide by the ``seq`` size; the reference's
``ValueError`` (its words) says so and points at ring attention.
"""

from __future__ import annotations

import torch

from kukeon_tpu_torch.ops.attention import attention_mask, attention_reference, repeat_kv
from kukeon_tpu_torch.parallel.mesh import AXIS_SEQ


def ulysses_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      q_positions: torch.Tensor, kv_positions: torch.Tensor, mesh,
                      axis_name: str = AXIS_SEQ) -> torch.Tensor:
    """Sequence-parallel causal GQA attention of this rank's block via two
    all-to-alls: the same contract as
    :func:`~kukeon_tpu_torch.parallel.ring_attention.ring_attention`."""
    from kukeon_tpu_torch.parallel import autograd as pa

    n = mesh.axis_size(axis_name)
    if q.shape[2] % n or k.shape[2] % n:
        # Before any collective, so every rank raises alike.
        raise ValueError(
            f"ulysses needs seq axis ({n}) to divide the local head counts "
            f"(q heads {q.shape[2]}, kv heads {k.shape[2]}); use ring "
            "attention for odd head layouts"
        )
    # seq-sharded -> head-sharded: the whole sequence for h / n heads.
    qf, kf, vf = (pa.all_to_all(x, 2, 1, mesh, axis_name) for x in (q, k, v))
    q_pos = mesh.gather(q_positions, 1, axis_name)
    kv_pos = mesh.gather(kv_positions, 1, axis_name)
    n_rep = qf.shape[2] // kf.shape[2]
    out = attention_reference(qf, repeat_kv(kf, n_rep), repeat_kv(vf, n_rep),
                              attention_mask(q_pos, kv_pos))
    # head-sharded -> seq-sharded.
    return pa.all_to_all(out, 1, 2, mesh, axis_name)

