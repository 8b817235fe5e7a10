"""Ring attention over the ``seq`` axis, the port of
``kukeon_tpu/parallel/ring_attention.py``.

Each rank holds one block of the sequence's queries, keys and values (its
``seq`` coordinate's positions) and computes its queries' exact causal
attention over the whole sequence: the K/V blocks and their positions
travel around the ring (:func:`parallel.autograd.ring_hop`: to the next
seq rank, from the previous one) while each rank folds every block it
holds into an online softmax (running max ``m``, sum ``l`` and output
``o``, all f32), so the [S, S] score matrix never exists. The mask is by
absolute position (``kv_pos <= q_pos``, the blocks' positions travel with
them), so every step is exact whichever block a rank holds.

The reference runs ``n`` steps of update-then-permute under one
``shard_map``; the port runs the same ``n`` updates in the same order and
the ``n - 1`` hops they need (the reference's last permute returns the
blocks home and feeds nothing). K/V travel compact and are expanded to
the q heads after the transfer, as the reference's are; the port
expands them by grouping the q heads (``[B, S, KV, G, D]``), which reads
each key once and computes the same products. Heads are cut on
``tensor`` and rows on data x fsdp by the caller's layout; this module
sees only its rank's blocks.

The body is plain PyTorch, as the reference's is plain ``jnp``: no TPU
kernel is on this path.
"""

from __future__ import annotations

import math

import torch

from kukeon_tpu_torch.ops.attention import NEG_INF
from kukeon_tpu_torch.parallel.mesh import AXIS_SEQ


def block_update(o: torch.Tensor, m: torch.Tensor, l: torch.Tensor, q: torch.Tensor,
                 k: torch.Tensor, v: torch.Tensor, q_pos: torch.Tensor,
                 kv_pos: torch.Tensor, scale: float):
    """One online-softmax step against a K/V block (the reference's
    ``_block_update``).

    o: [B, Sq, H, D] f32 running (unnormalized) output; m, l: [B, H, Sq]
    f32 running max and sum; q: [B, Sq, H, D]; k, v: [B, Sk, KV, D]
    compact (H % KV == 0); q_pos [B, Sq], kv_pos [B, Sk] absolute
    positions. -> (o, m, l) after the block.
    """
    B, Sq, H, D = q.shape
    KV = k.shape[2]
    G = H // KV
    qg = q.reshape(B, Sq, KV, G, D).float()
    scores = torch.einsum("bqkgd,btkd->bkgqt", qg, k.float()) * scale
    mask = (kv_pos[:, None, :] <= q_pos[:, :, None])[:, None, None]      # [B,1,1,Sq,Sk]
    scores = torch.where(mask, scores, NEG_INF).reshape(B, H, Sq, -1)

    m_new = torch.maximum(m, scores.amax(dim=-1))                         # [B, H, Sq]
    correction = torch.exp(m - m_new)
    p = torch.exp(scores - m_new[..., None])                              # [B, H, Sq, Sk]
    l_new = l * correction + p.sum(dim=-1)
    pv = torch.einsum("bkgqt,btkd->bqkgd", p.reshape(B, KV, G, Sq, -1), v.float())
    o_new = o * correction.transpose(1, 2)[..., None] + pv.reshape(B, Sq, H, D)
    return o_new, m_new, l_new


def finish(o: torch.Tensor, l: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """The normalized output of the online softmax, in ``dtype``: ``l``
    clamped at 1e-30 (a query no key reached) as the reference's."""
    return (o / torch.clamp(l, min=1e-30).transpose(1, 2)[..., None]).to(dtype)


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                   q_positions: torch.Tensor, kv_positions: torch.Tensor, mesh,
                   axis_name: str = AXIS_SEQ) -> torch.Tensor:
    """Sequence-parallel causal GQA attention of this rank's block.

    q: [B, Sq, H, D] and k, v: [B, Sk, KV, D], the rank's block of the
    sequence on ``axis_name`` (its seq coordinate's positions; every seq
    peer holds a block of the same shape); q_positions [B, Sq] and
    kv_positions [B, Sk], their absolute positions. Returns [B, Sq, H, D]
    in q's dtype: the rank's queries attended over every peer's keys.
    Differentiable: the ring's hops run backward the other way round.
    """
    n = mesh.axis_size(axis_name)
    B, Sq, H, D = q.shape
    scale = 1.0 / math.sqrt(D)
    o = q.new_zeros((B, Sq, H, D), dtype=torch.float32)
    m = q.new_full((B, H, Sq), NEG_INF, dtype=torch.float32)
    l = q.new_zeros((B, H, Sq), dtype=torch.float32)
    from kukeon_tpu_torch.parallel import autograd as pa

    for step in range(n):
        o, m, l = block_update(o, m, l, q, k, v, q_positions, kv_positions, scale)
        if step + 1 < n:
            k, v, kv_positions = pa.ring_hop(mesh, axis_name, k, v, kv_positions)
    return finish(o, l, q.dtype)
