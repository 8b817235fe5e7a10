"""Collectives that autograd differentiates: the training step's seams on
a ``pipe`` x ``data`` x ``fsdp`` x ``expert`` x ``seq`` x ``tensor`` mesh
(``parallel/mesh.py``).

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
  sum over the ranks that split the batch rows, each keeping its block);
  :func:`gather` the same pair over any axis (``seq``: the keys and
  values of the whole sequence, each seq rank's gradient of them a
  partial over its own queries);
- :func:`all_to_all`: the reference's tiled ``all_to_all`` over an axis,
  its own adjoint with the split and concat dims swapped (Ulysses'
  sequence-to-heads reshard and back);
- :func:`ring_hop`: one step of a ring over an axis, every tensor given
  sent to the next rank and the previous rank's received, in one
  ``batch_isend_irecv`` list; the backward sends the gradients to the
  previous rank and receives the next rank's (the ring attention's K, V
  and positions, ``parallel/ring_attention.py``).

The pipeline's hops between stages are not nodes of a graph: the
schedule (``parallel/pipeline.py``) sends each microbatch's activation
and receives its gradient itself, in one order on every stage.

Over an axis of one rank each is the identity and adds no node to the
graph, so a one-rank mesh computes the one-device step bit for bit.
"""

from __future__ import annotations

import torch

import torch.distributed as dist

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


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, mesh, axis):
        ctx.mesh, ctx.dim, ctx.axis = mesh, dim, axis
        return mesh.gather(x, dim, axis)

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh.reduce_scatter(g, ctx.dim, ctx.axis), None, None, None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, split_dim, concat_dim, mesh, axis):
        ctx.args = (split_dim, concat_dim, mesh, axis)
        return mesh.all_to_all(x, split_dim, concat_dim, axis)

    @staticmethod
    def backward(ctx, g):
        split_dim, concat_dim, mesh, axis = ctx.args
        return mesh.all_to_all(g, concat_dim, split_dim, axis), None, None, None, None


def _hop(mesh, axis: str, xs, shift: int) -> list[torch.Tensor]:
    """Send each of ``xs`` to the ``axis`` peer ``shift`` places on and
    receive as many from the peer ``shift`` places back, as one
    ``batch_isend_irecv`` list (sends first, then receives, in ``xs``'
    order on every rank)."""
    me = mesh.coord(axis)
    dst, src = mesh.peer(axis, me + shift), mesh.peer(axis, me - shift)
    pg = mesh.group.pgs.get(axis)
    xs = [x.contiguous() for x in xs]
    out = [torch.empty_like(x) for x in xs]
    ops = ([dist.P2POp(dist.isend, x, dst, pg) for x in xs]
           + [dist.P2POp(dist.irecv, y, src, pg) for y in out])
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    return out


class _RingHop(torch.autograd.Function):
    @staticmethod
    def forward(ctx, mesh, axis, *xs):
        ctx.mesh, ctx.axis = mesh, axis
        ctx.floating = [x.is_floating_point() for x in xs]
        ctx.like = [(x.shape, x.dtype) for x in xs]
        out = _hop(mesh, axis, xs, 1)
        ctx.mark_non_differentiable(*(y for y, f in zip(out, ctx.floating) if not f))
        return tuple(out)

    @staticmethod
    def backward(ctx, *gs):
        # Every rank sends the gradients of its floating outputs, zeros
        # where autograd gives none, so each rank issues the same list.
        send = [g if g is not None else torch.zeros(shape, dtype=dtype, device=ctx.mesh.device)
                for g, f, (shape, dtype) in zip(gs, ctx.floating, ctx.like) if f]
        back = iter(_hop(ctx.mesh, ctx.axis, send, -1))
        return (None, None, *(next(back) if f else None for f in ctx.floating))


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
    return x if mesh.fsdp == 1 else _Gather.apply(x, dim % x.ndim, mesh, AXIS_FSDP)


def gather(x: torch.Tensor, dim: int, mesh, axis: str) -> torch.Tensor:
    """Every ``axis`` peer's ``x`` concatenated along ``dim`` in the axis's
    order; its gradient is reduce-scattered back (the sum over the peers,
    each keeping its block)."""
    return x if mesh.axis_size(axis) == 1 else _Gather.apply(x, dim % x.ndim, mesh, axis)


def all_to_all(x: torch.Tensor, split_dim: int, concat_dim: int, mesh,
               axis: str) -> torch.Tensor:
    """:meth:`Mesh.all_to_all` under autograd: its adjoint is the same
    exchange with ``split_dim`` and ``concat_dim`` swapped."""
    if mesh.axis_size(axis) == 1:
        return x
    return _AllToAll.apply(x, split_dim % x.ndim, concat_dim % x.ndim, mesh, axis)


def ring_hop(mesh, axis: str, *xs: torch.Tensor) -> tuple[torch.Tensor, ...]:
    """One ring step over ``axis``: each of ``xs`` sent to the next rank
    (coordinate + 1, mod the axis's size) and the previous rank's
    received, in one ``batch_isend_irecv`` list; the backward sends the
    floating tensors' gradients back the other way, in one list too.
    Integer tensors (positions) travel along and take no gradient. Over
    one rank, ``xs`` themselves."""
    if mesh.axis_size(axis) == 1:
        return xs
    return _RingHop.apply(mesh, axis, *xs)


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
