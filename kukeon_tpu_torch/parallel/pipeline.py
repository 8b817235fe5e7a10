"""Pipeline parallelism over the ``pipe`` axis: the GPipe schedule, the
port of ``kukeon_tpu/parallel/pipeline.py``.

The layer stacks' axis 0 is cut on ``pipe`` (the reference's
``pp_param_specs``, which ``sharding.train_specs(pipeline=True)`` gives
and ``sharding.TrainLayout(pipeline=True)`` cuts by): the stage at pipe
coordinate s holds layers ``[s * L / P, (s + 1) * L / P)``; the
embedding, the final norm and the LM head are replicated over the stages
(the first stage looks tokens up, the last computes the logits; a tied
embedding serves both). The rest of a leaf's spec is the reference's
``llama_param_specs(fsdp=False)``: ``tensor`` cuts a stage's matrices as
in the other training steps, ``fsdp`` cuts none.

A batch of B rows is M microbatches of B / M rows (M defaults to 2 P).
The reference's ``shard_map`` is manual over ``pipe`` only and runs M + P
- 1 ticks on every stage, each stage's idle ticks computing on zeros that
are discarded; the port runs one process per rank and only the real
work:

- the ranks that share a stage's position in the mesh but differ on
  ``data``, ``fsdp`` or ``seq`` (the batch group: none of them cuts a
  leaf here, and the reference's pipeline attends each microbatch whole)
  split the M microbatches into contiguous runs (:func:`microbatches`);
- every stage runs all its microbatches forward in order, each received
  from the previous stage and sent to the next (``torch.distributed``
  point-to-point over the ``pipe`` group), keeping each one's graph;
- then the backwards, in the same order on every stage: the last stage
  computes microbatch m's logits and its share of the global masked mean
  and backpropagates it; every other stage receives the gradient of its
  output from the next stage and runs ``torch.autograd.backward(out_m,
  grad_m)``; each stage but the first sends its input's gradient back.
  One ``loss.backward()`` over all microbatches would leave the order of
  the hops to the autograd engine, which need not be the peers' order.

The gradients are then summed where the reference's are: over the batch
group for every leaf, and over ``pipe`` too for the leaves the stages
share (a tied embedding gets the lookup's term on the first stage and the
head's on the last), so every stage's copy takes the same update and
stays bitwise equal to its peers'. No remat, as in the reference's
``make_pp_train_step``.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from kukeon_tpu_torch.models import llama
from kukeon_tpu_torch.parallel.mesh import (AXIS_BATCH, AXIS_FSDP, AXIS_PIPE, AXIS_SEQ,
                                            AXIS_WORLD)


def check_microbatches(cfg, batch: int, pipe: int, m: int | None = None) -> int:
    """M for a batch of ``batch`` rows over ``pipe`` stages (``m`` None:
    2 P), refusing what the reference refuses, in its words."""
    if cfg.num_layers % pipe:
        raise ValueError(f"num_layers {cfg.num_layers} % pipe {pipe} != 0")
    m = m or max(2 * pipe, 1)
    if batch % m:
        raise ValueError(f"batch {batch} % microbatches {m} != 0")
    return m


def microbatches(m: int, mesh) -> range:
    """The microbatches of ``m`` that ``mesh``'s rank runs: its batch
    group's (data x fsdp x seq) coordinate i of n takes ``[i m // n, (i +
    1) m // n)`` (none when m < n leaves it out)."""
    n = mesh.axis_size(AXIS_BATCH)
    i = (mesh.replica * mesh.fsdp + mesh.fsdp_rank) * mesh.seq + mesh.seq_rank
    return range(i * m // n, (i + 1) * m // n)


def _send(x: torch.Tensor, mesh, stage: int) -> None:
    dist.send(x.contiguous(), dst=mesh.peer(AXIS_PIPE, stage),
              group=mesh.group.pgs.get(AXIS_PIPE))


def _recv(shape, dtype, mesh, stage: int) -> torch.Tensor:
    x = torch.empty(shape, dtype=dtype, device=mesh.device)
    dist.recv(x, src=mesh.peer(AXIS_PIPE, stage), group=mesh.group.pgs.get(AXIS_PIPE))
    return x


def _stage_forward(params, cfg, tokens, positions, mesh, m_range, rows: int,
                   attn_impl: str, grad: bool) -> list:
    """Every microbatch of ``m_range`` through this rank's stage, in order:
    ``[(input, output)]``, the input the activation received from the
    previous stage (a leaf that takes a gradient when ``grad``; None on the
    first stage, which looks the tokens up), each output sent on to the
    next stage. The blocks run on the mesh without ``fsdp`` and ``seq``
    (:meth:`Mesh.without`): no gather over either."""
    stage, pipe = mesh.pipe_rank, mesh.pipe
    blocks = mesh.without(AXIS_FSDP, AXIS_SEQ)
    S = tokens.shape[1]
    out = []
    for m in m_range:
        sl = slice(m * rows, (m + 1) * rows)
        pos = positions[sl]
        rope = llama.rope_tables(pos, cfg.head_dim, cfg.rope_theta)
        if stage == 0:
            x_in = None
            x = llama.train_embed(params, cfg, tokens[sl], blocks)
        else:
            x_in = _recv((rows, S, cfg.hidden_size), cfg.dtype, mesh, stage - 1)
            x = x_in.requires_grad_(grad)
        for w in llama.layer_slices(params):
            x = llama.train_block(x, w, cfg, pos, attn_impl, rope, blocks)
        if stage + 1 < pipe:
            _send(x.detach(), mesh, stage + 1)
        out.append((x_in, x))
    return out


def pipeline_forward(params, cfg, tokens: torch.Tensor, positions: torch.Tensor, mesh, *,
                     num_microbatches: int | None = None,
                     attn_impl: str = "auto") -> torch.Tensor:
    """Pipeline-parallel forward of the whole batch -> logits [B, S, V]
    f32, the reference's, on every rank. ``params`` the rank's blocks (a
    pipeline ``TrainLayout``'s); ``tokens``/``positions`` [B, S], the
    whole batch, with B divisible by ``num_microbatches`` (default 2 x
    pipe). Each rank runs its microbatches through its stage; the last
    stage's logits, zeros elsewhere, are summed over the batch group and
    over ``pipe``. No KV cache: the training and prefill layout."""
    B, S = tokens.shape
    M = check_microbatches(cfg, B, mesh.pipe, num_microbatches)
    rows = B // M
    mine = microbatches(M, mesh)
    logits = torch.zeros((B, S, cfg.vocab_size), dtype=torch.float32, device=tokens.device)
    with torch.no_grad():
        outs = _stage_forward(params, cfg, tokens, positions, mesh, mine, rows, attn_impl,
                              grad=False)
        if mesh.pipe_rank == mesh.pipe - 1:
            for m, (_x_in, x) in zip(mine, outs):
                logits[m * rows:(m + 1) * rows] = llama.train_logits(
                    params, cfg, x, mesh.without(AXIS_FSDP, AXIS_SEQ))
    return mesh.reduce(mesh.reduce(logits, AXIS_BATCH), AXIS_PIPE)


def make_pp_train_step(cfg, optimizer, *, mesh, num_microbatches: int | None = None):
    """``step(state, tokens, targets, mask) -> (state, loss)``: the
    reference's pipeline-parallel step (GPipe forward and backward, the
    loss and AdamW update of ``training.train_step``, no remat) on this
    rank of ``mesh``. ``state`` is the rank's (``create_train_state(mesh=,
    layout=)`` with ``TrainLayout.of(cfg, mesh, pipeline=True)``);
    ``tokens``, ``targets`` and ``mask`` the whole batch [B, S], on every
    rank. Returns the global loss, the same on every rank. The MoE family
    is refused, as the reference's CLI refuses it."""
    from kukeon_tpu_torch.models import moe
    from kukeon_tpu_torch.parallel.sharding import TrainLayout
    from kukeon_tpu_torch.training.train_step import (cross_entropy_loss, grad_reducer,
                                                      tree_items, tree_leaves)

    if isinstance(cfg, moe.MoEConfig):
        raise ValueError("pipeline parallelism is llama-only for now")
    layout = TrainLayout.of(cfg, mesh, pipeline=True)
    reduce_grads = grad_reducer(layout, mesh)
    owned = [layout.owned(p, mesh.replica, mesh.seq_rank)
             for p, _ in tree_items(layout.meta())]
    first, last = mesh.pipe_rank == 0, mesh.pipe_rank == mesh.pipe - 1
    blocks = mesh.without(AXIS_FSDP, AXIS_SEQ)

    def train_step(state, tokens, targets, mask):
        B, S = tokens.shape
        M = check_microbatches(cfg, B, mesh.pipe, num_microbatches)
        rows = B // M
        mine = microbatches(M, mesh)
        positions = torch.arange(S, dtype=torch.int32, device=tokens.device)
        positions = positions[None, :].expand(B, S).contiguous()
        count = torch.clamp(torch.sum(mask), min=1.0)
        leaves = tree_leaves(state.params)
        for p in leaves:
            p.requires_grad_(True)
            p.grad = None
        local = torch.zeros((), dtype=torch.float32, device=tokens.device)
        with torch.enable_grad():
            outs = _stage_forward(state.params, cfg, tokens, positions, mesh, mine, rows,
                                  "auto", grad=True)
            for i, m in enumerate(mine):
                x_in, x = outs[i]
                outs[i] = None
                if last:
                    sl = slice(m * rows, (m + 1) * rows)
                    logits = llama.train_logits(state.params, cfg, x, blocks)
                    share = cross_entropy_loss(logits, targets[sl], mask[sl],
                                               count=lambda _n: count)
                    local = local + share.detach()
                    torch.autograd.backward(share)
                    del logits, share
                else:
                    g = _recv(x.shape, x.dtype, mesh, mesh.pipe_rank + 1)
                    torch.autograd.backward(x, g)
                if not first:
                    _send(x_in.grad, mesh, mesh.pipe_rank - 1)
                del x_in, x
        grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in leaves]
        for p in leaves:
            p.grad = None
        optimizer.update_(reduce_grads(grads), state.opt_state, state.params, owned,
                          lambda sq: mesh.reduce(sq, AXIS_WORLD))
        state.step += 1
        return state, mesh.reduce(mesh.reduce(local, AXIS_BATCH), AXIS_PIPE)

    return train_step

