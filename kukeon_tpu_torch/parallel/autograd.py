"""Collectives that autograd differentiates: the training step's seams on
a ``data`` x ``fsdp`` x ``expert`` x ``tensor`` mesh (``parallel/mesh.py``).

The reference's training step is one GSPMD program: XLA places an
all-gather of each fsdp-cut weight where a layer runs, a reduce-scatter
of its gradient, the tensor-parallel sums and their adjoints. The port
runs one process per device and places them itself, each a
``torch.autograd.Function`` whose backward is its forward's adjoint:

- :func:`copy_to_tensor`: identity forward, a sum over ``tensor``
  backward. A column-parallel product's input (each tensor peer's
  gradient of it is a partial sum over that peer's columns);
- :func:`reduce_from_tensor`: a sum over ``tensor`` forward, identity
  backward. A row-parallel product's partial;
- :func:`copy_to` and :func:`reduce_from`: the same pair over any named
  axis group. A MoE block's expert input and gate weights are copied to
  ``expert_tensor`` (each rank's gradient of them is a partial over its
  local experts and intermediate columns) and its output partial summed
  over it; the load-balance and z-loss sums are summed over ``batch``
  with an identity backward (every rank's loss holds the global term
  once, and its gradient reaches only that rank's tokens, which the
  step's sum of gradients over ``batch`` then adds up);
- :func:`gather_from_tensor`: an all-gather over ``tensor`` forward, the
  rank's slice backward. The vocabulary-sharded logits: every tensor
  peer computes the same loss from the gathered logits, so the gradient
  it gets is already the whole one, not a partial to sum;
- :func:`masked_lookup`: the vocabulary-sharded embedding, a lookup of the
  rank's rows (others zero) through :func:`reduce_from_tensor`;
- :func:`fsdp_gather`: an all-gather over ``fsdp`` forward, a
  reduce-scatter over ``fsdp`` backward (FSDP's pair: the gradient is the
  sum over the ranks that split the batch rows, each keeping its block).

Over an axis of one rank each is the identity and adds no node to the
graph, so a one-rank mesh computes the one-device step bit for bit.
"""

from __future__ import annotations

import torch

from kukeon_tpu_torch.parallel.mesh import AXIS_FSDP, AXIS_TENSOR


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh.reduce(g, ctx.axis), None, None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        return mesh.reduce(x, axis)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _GatherFromTensor(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, mesh):
        ctx.mesh, ctx.dim, ctx.n = mesh, dim, x.shape[dim]
        return mesh.gather(x, dim, AXIS_TENSOR)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(ctx.dim, ctx.mesh.rank * ctx.n, ctx.n), None, None


class _FsdpGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, mesh):
        ctx.mesh, ctx.dim = mesh, dim
        return mesh.gather(x, dim, AXIS_FSDP)

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh.reduce_scatter(g, ctx.dim, AXIS_FSDP), None, None


def copy_to_tensor(x: torch.Tensor, mesh) -> torch.Tensor:
    return x if mesh.world == 1 else _CopyTo.apply(x, mesh, AXIS_TENSOR)


def reduce_from_tensor(x: torch.Tensor, mesh) -> torch.Tensor:
    return x if mesh.world == 1 else _ReduceFrom.apply(x, mesh, AXIS_TENSOR)


def copy_to(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """Identity forward, a sum over ``axis`` backward."""
    return x if mesh.axis_size(axis) == 1 else _CopyTo.apply(x, mesh, axis)


def reduce_from(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """A sum over ``axis`` forward, identity backward."""
    return x if mesh.axis_size(axis) == 1 else _ReduceFrom.apply(x, mesh, axis)


def gather_from_tensor(x: torch.Tensor, dim: int, mesh) -> torch.Tensor:
    return x if mesh.world == 1 else _GatherFromTensor.apply(x, dim % x.ndim, mesh)


def fsdp_gather(x: torch.Tensor, dim: int, mesh) -> torch.Tensor:
    """The whole of an fsdp-cut leaf's axis ``dim`` (``x`` is this rank's
    block of it); its gradient is reduce-scattered back."""
    return x if mesh.fsdp == 1 else _FsdpGather.apply(x, dim % x.ndim, mesh)


def masked_lookup(table: torch.Tensor, tokens: torch.Tensor, mesh) -> torch.Tensor:
    """Rows of ``tokens`` from the vocabulary-sharded ``table`` (the
    ``mesh.rank``-th block of the vocabulary, its rows): ids outside it
    look up row 0 and come out as zeros, and the sum over ``tensor`` adds
    the one rank's row to zeros, exactly. ``table[tokens]`` at one rank."""
    if mesh.world == 1:
        return table[tokens]
    rows = table.shape[0]
    local = tokens - mesh.rank * rows
    hit = (local >= 0) & (local < rows)
    x = table[torch.where(hit, local, torch.zeros_like(local))]
    return reduce_from_tensor(torch.where(hit[..., None], x, torch.zeros_like(x)), mesh)
