"""Collectives that autograd differentiates: the training step's seams on
a ``data`` x ``fsdp`` x ``tensor`` mesh (``parallel/mesh.py``).

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


class _CopyToTensor(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh.reduce(g, AXIS_TENSOR), None


class _ReduceFromTensor(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        return mesh.reduce(x, AXIS_TENSOR)

    @staticmethod
    def backward(ctx, g):
        return g, None


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
    return x if mesh.world == 1 else _CopyToTensor.apply(x, mesh)


def reduce_from_tensor(x: torch.Tensor, mesh) -> torch.Tensor:
    return x if mesh.world == 1 else _ReduceFromTensor.apply(x, mesh)


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
