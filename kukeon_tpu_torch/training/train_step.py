"""Training step for the Llama family on one device, the port of
``kukeon_tpu/training/train_step.py``.

The JAX step is a jitted, donated GSPMD program over a mesh; the port's is
eager PyTorch on one device, or on each rank of a training mesh
(``mesh=``: data x fsdp x expert x seq x tensor, one process per device,
:func:`make_train_step`, :func:`make_moe_train_step`; the GPipe step over
``pipe`` is ``parallel/pipeline.py``'s :func:`make_pp_train_step`). What
it computes is the same: next-token cross entropy of ``llama.forward``
without a cache (attention through
:func:`kukeon_tpu_torch.ops.attention.gqa_attention`, which takes the flash
kernel on the GPU at S >= 1024), its gradients, and the optax chain of
:func:`make_optimizer`, written out by hand. The update happens in place
under ``torch.no_grad()``: the port's counterpart of ``donate_argnums``.

Remat is non-reentrant ``torch.utils.checkpoint`` around each transformer
block (the JAX step checkpoints the whole forward; both give the same
numbers, and per-block remat bounds the memory).

The MoE step (:func:`make_moe_train_step`) adds the Switch load-balance
loss and the router z-loss of ``moe.forward_with_aux`` to the cross
entropy, with the training capacity (the GShard drops), on one device or
on a data x fsdp x expert x seq x tensor mesh.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, ClassVar

import numpy as np
import torch

from kukeon_tpu_torch.models import llama, moe


@dataclasses.dataclass
class TrainState:
    params: Any          # the model's parameter tree (llama layout)
    opt_state: dict      # {"count": int, "mu": tree, "nu": tree}
    step: int


def tree_leaves(tree) -> list[torch.Tensor]:
    """The tensors of a nested dict, keys sorted at every level (JAX's
    order for a dict pytree), so trees built in any key order line up."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    return [tree]


def tree_items(tree, path=()) -> list[tuple[tuple[str, ...], Any]]:
    """``(path, leaf)`` of a nested dict in :func:`tree_leaves`' order."""
    if isinstance(tree, dict):
        return [item for k in sorted(tree) for item in tree_items(tree[k], path + (k,))]
    return [(path, tree)]


def tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def cross_entropy_loss(logits: torch.Tensor, targets: torch.Tensor,
                       mask: torch.Tensor, count=None) -> torch.Tensor:
    """Mean next-token cross entropy over masked positions.

    logits: [B, S, V] f32; targets: [B, S] integer; mask: [B, S] {0,1}.
    ``count`` (a mesh's sum over the ranks of a batch) turns the mask's sum
    into the whole batch's: the result is then this rank's share of the
    global mean, its rows' sum over every row's count.
    """
    logp = torch.log_softmax(logits, dim=-1)
    nll = -torch.gather(logp, -1, targets[..., None].long())[..., 0]
    total = torch.sum(nll * mask)
    n = torch.sum(mask)
    denom = torch.clamp(n if count is None else count(n), min=1.0)
    return total / denom


def warmup_cosine_decay_schedule(init_value: float, peak_value: float,
                                 warmup_steps: int, decay_steps: int,
                                 end_value: float = 0.0) -> Callable[[int], float]:
    """optax.warmup_cosine_decay_schedule (exponent 1): linear from
    ``init_value`` to ``peak_value`` over ``warmup_steps``, then cosine down
    to ``end_value`` at ``decay_steps``."""
    alpha = end_value / peak_value if peak_value else 0.0
    cos_steps = decay_steps - warmup_steps

    def schedule(count: int) -> float:
        if count < warmup_steps:
            frac = 1.0 - max(count, 0) / warmup_steps
            return (init_value - peak_value) * frac + peak_value
        c = min(count - warmup_steps, cos_steps)
        cosine = 0.5 * (1.0 + math.cos(math.pi * c / cos_steps))
        return peak_value * ((1.0 - alpha) * cosine + alpha)

    return schedule


@dataclasses.dataclass(frozen=True)
class AdamW:
    """``optax.chain(clip_by_global_norm(max_norm), adamw(schedule, b1, b2,
    eps, eps_root=0, weight_decay))``, step by step:

    1. g <- g / ||g|| * max_norm when the global norm ||g|| >= max_norm.
    2. mu <- (1-b1) g + b1 mu; nu <- (1-b2) g^2 + b2 nu, kept in the param
       dtype; u = mu_hat / (sqrt(nu_hat + eps_root) + eps) with the bias
       corrections 1 - b^(count+1) (computed in f32, then cast).
    3. u <- u + weight_decay * p on every leaf (optax's mask is None).
    4. p <- p + (-lr(count)) u, the schedule read at the count *before* the
       increment, so step 0 (lr 0) leaves every parameter as it was.

    The constants are the JAX package's (``make_optimizer``). Python
    scalars enter each leaf's arithmetic in the leaf's dtype, as JAX's
    weakly typed constants do. One difference in bf16: the global norm sums
    each leaf's squares into an f32 total, where optax rounds each leaf's
    sum to bf16.
    """

    schedule: Callable[[int], float]
    weight_decay: float = 0.1
    b1: ClassVar[float] = 0.9
    b2: ClassVar[float] = 0.95
    eps: ClassVar[float] = 1e-8
    eps_root: ClassVar[float] = 0.0
    max_norm: ClassVar[float] = 1.0

    def init(self, params) -> dict:
        zeros = lambda p: torch.zeros_like(p, requires_grad=False)  # noqa: E731
        return {"count": 0, "mu": tree_map(zeros, params), "nu": tree_map(zeros, params)}

    @torch.no_grad()
    def update_(self, grads: list[torch.Tensor], opt_state: dict, params,
                owned: list[bool] | None = None, total=None) -> None:
        """Apply one update in place to ``params`` and ``opt_state``;
        ``grads`` in :func:`tree_leaves` order of ``params``. On a mesh
        (each leaf a rank's block): ``owned[i]`` whether this rank counts
        leaf i's squares in the global norm (one rank of those holding a
        block), and ``total`` sums the count over every rank."""
        count = opt_state["count"]
        owned = owned or [True] * len(grads)
        sq = sum(torch.sum(torch.square(g), dtype=torch.float32)
                 for g, own in zip(grads, owned) if own)
        if total is not None:
            if not isinstance(sq, torch.Tensor):       # no leaf owned here
                sq = torch.zeros((), dtype=torch.float32, device=grads[0].device)
            sq = total(sq)
        norm = float(torch.sqrt(sq))
        clip = norm >= self.max_norm
        lr = -self.schedule(count)
        bc1 = np.float32(1) - np.float32(self.b1) ** (count + 1)
        bc2 = np.float32(1) - np.float32(self.b2) ** (count + 1)
        for p, g, mu, nu in zip(tree_leaves(params), grads, tree_leaves(opt_state["mu"]),
                                tree_leaves(opt_state["nu"])):
            c = lambda x: torch.tensor(float(x), dtype=p.dtype)  # noqa: E731
            if clip:
                g = g / torch.tensor(norm, dtype=torch.float32).to(g.dtype) * c(self.max_norm)
            mu.mul_(c(self.b1)).add_(g * c(1 - self.b1))
            nu.mul_(c(self.b2)).add_(g * g * c(1 - self.b2))
            u = (mu / c(bc1)) / (torch.sqrt(nu / c(bc2) + c(self.eps_root)) + c(self.eps))
            u.add_(p * c(self.weight_decay))
            u.mul_(torch.tensor(np.float32(lr)).to(p.dtype))
            p.add_(u)
        opt_state["count"] = count + 1


def make_optimizer(learning_rate: float = 3e-4, weight_decay: float = 0.1,
                   warmup_steps: int = 100, total_steps: int = 10_000) -> AdamW:
    schedule = warmup_cosine_decay_schedule(
        0.0, learning_rate, warmup_steps, max(total_steps, warmup_steps + 1))
    return AdamW(schedule, weight_decay=weight_decay)


def create_train_state(cfg: llama.LlamaConfig, generator: torch.Generator,
                       device: torch.device | str,
                       optimizer: AdamW | None = None, *, mesh=None,
                       leaves=None, layout=None) -> tuple[TrainState, AdamW]:
    """Random parameters (``llama.init_params`` on ``device``) and fresh
    optimizer state. On a training ``mesh`` (``parallel.mesh.Mesh``) the
    state is this rank's: each full leaf drawn as one device draws it
    (``llama.iter_params`` on ``generator``, which lives on the mesh's
    device), or taken from ``leaves`` (``(path, tensor)`` pairs, e.g. a
    ``sharding.Recipe``'s), cut to the rank's block
    (``sharding.TrainLayout``; ``layout`` another than the mesh's
    default, a pipeline's) and freed before the next is drawn, so its
    blocks are the cut of the one-device state; the moments are zeros of
    the blocks' shapes."""
    optimizer = optimizer or make_optimizer()
    params = (llama.init_params(cfg, generator, device) if mesh is None
              else _rank_params(cfg, llama.iter_params, generator, mesh, leaves, layout))
    return TrainState(params=params, opt_state=optimizer.init(params), step=0), optimizer


def _rank_params(cfg, iter_params, generator: torch.Generator, mesh, leaves,
                 layout=None) -> dict:
    """A training mesh's rank's params: each full leaf of ``leaves``, or
    drawn by ``iter_params(cfg, generator, mesh.device)`` as one device
    draws it, cut to the rank's block (``layout``, by default the mesh's
    ``sharding.TrainLayout``) and freed before the next."""
    from kukeon_tpu_torch.parallel.sharding import TrainLayout

    layout = layout or TrainLayout.of(cfg, mesh)
    local = []
    for path, full in (leaves if leaves is not None
                       else iter_params(cfg, generator, mesh.device)):
        local.append((path, layout.cut(path, full).to(mesh.device)))
        del full
    return llama.nest(local)


def _make_step(optimizer: AdamW, loss_fn, reduce_grads=None, owned=None, total=None,
               seq_rank: int = 0):
    """``step(state, tokens, targets, mask) -> (state, out)``: ``loss_fn(params,
    tokens, targets, mask, positions) -> (loss, out)`` under autograd, its
    gradients (through ``reduce_grads`` on a mesh), and the optimizer's
    update in place of params and moments (``owned`` and ``total``: the
    global norm's, :meth:`AdamW.update_`). ``positions`` are absolute: a
    ``seq_rank``'s block of S columns starts at ``seq_rank * S``."""

    def train_step(state: TrainState, tokens, targets, mask):
        B, S = tokens.shape
        positions = torch.arange(S, dtype=torch.int32, device=tokens.device)
        if seq_rank:
            positions = positions + seq_rank * S
        positions = positions[None, :].expand(B, S).contiguous()
        leaves = tree_leaves(state.params)
        for p in leaves:
            p.requires_grad_(True)
        with torch.enable_grad():
            loss, out = loss_fn(state.params, tokens, targets, mask, positions)
            grads = list(torch.autograd.grad(loss, leaves))
        if reduce_grads is not None:
            grads = reduce_grads(grads)
        optimizer.update_(grads, state.opt_state, state.params, owned, total)
        state.step += 1
        return state, out

    return train_step


def make_train_step(cfg: llama.LlamaConfig, optimizer: AdamW, *, remat: bool = True,
                    mesh=None, use_ring_attention: bool | None = None):
    """``step(state, tokens, targets, mask) -> (state, loss)``: one forward,
    backward and update, with params and moments updated in place. ``remat``
    recomputes each block's activations in the backward.

    On a training ``mesh`` (the reference's GSPMD step over data x fsdp x
    seq x tensor): ``state`` is the rank's (:func:`create_train_state` with
    ``mesh=``) and the batch its rows and, on ``seq``, its block of their
    columns (``data.batches(mesh=)``), at their absolute positions; the
    forward is ``llama.forward_train``, attending through ring attention
    when ``use_ring_attention`` (default: ``seq`` > 1, the reference's
    rule), else ``auto`` over the whole sequence's keys; the loss is the global masked mean, each
    rank's tokens' sum over the mask count summed over the batch's ranks
    (data x fsdp x seq), and the step returns the global loss. The
    gradients then hold each rank's share: an fsdp-cut leaf's is
    reduce-scattered over ``fsdp`` in the backward and summed here over
    data x seq, a leaf the fsdp axis does not cut (the norms) summed over
    data x fsdp x seq (every weight is replicated over ``seq``), and a
    ``wk``/``wv`` replicated over ``tensor`` (partial on each peer, which
    attends only its q heads' kv heads) summed over ``tensor`` first. The
    clip's global norm counts each block once over every rank; the update
    is elementwise on the blocks. At one rank it is the one-device step,
    bit for bit."""
    if mesh is None:
        def loss_fn(params, tokens, targets, mask, positions):
            logits, _ = llama.forward(params, cfg, tokens, positions, remat=remat)
            loss = cross_entropy_loss(logits, targets, mask)
            return loss, loss.detach()

        return _make_step(optimizer, loss_fn)

    if use_ring_attention is None:
        use_ring_attention = mesh.seq > 1
    attn_impl = "ring" if use_ring_attention else "auto"

    def loss_fn(params, tokens, targets, mask, positions):
        logits = llama.forward_train(params, cfg, tokens, positions, mesh, remat=remat,
                                     attn_impl=attn_impl)
        local = _mesh_ce(logits, targets, mask, mesh)
        return local, _batch_sum(local.detach(), mesh)

    return _mesh_step(cfg, optimizer, mesh, loss_fn)


def _batch_sum(x: torch.Tensor, mesh) -> torch.Tensor:
    from kukeon_tpu_torch.parallel.mesh import AXIS_BATCH

    return mesh.reduce(x, AXIS_BATCH)


def _mesh_ce(logits, targets, mask, mesh) -> torch.Tensor:
    """This rank's share of the global masked mean: its tokens' sum over
    the mask count summed over the batch's ranks (data x fsdp x seq)."""
    return cross_entropy_loss(logits, targets, mask, count=lambda n: _batch_sum(n, mesh))


def _mesh_step(cfg, optimizer: AdamW, mesh, loss_fn):
    """:func:`_make_step` on a training mesh, either family: the gradients
    of each rank's share summed where the reference's are (an fsdp-cut
    leaf's reduce-scattered over ``fsdp`` in the backward, then summed
    over data x seq; a leaf the fsdp axis does not cut summed over data x
    fsdp x seq; a ``wk``/``wv`` replicated over ``tensor``, partial on
    each peer, summed over ``tensor`` first; nothing over ``expert``,
    where every peer holds its whole gradient already), and the clip's
    global norm counting each block once over every rank."""
    from kukeon_tpu_torch.parallel.mesh import AXIS_WORLD
    from kukeon_tpu_torch.parallel.sharding import TrainLayout

    layout = TrainLayout.of(cfg, mesh)
    paths = [p for p, _ in tree_items(layout.meta())]
    owned = [layout.owned(p, mesh.replica, mesh.seq_rank) for p in paths]
    return _make_step(optimizer, loss_fn, grad_reducer(layout, mesh), owned,
                      lambda sq: mesh.reduce(sq, AXIS_WORLD), seq_rank=mesh.seq_rank)


def grad_reducer(layout, mesh):
    """``reduce_grads(grads) -> grads``: each leaf's gradient (in
    :func:`tree_leaves` order of ``layout``'s tree) summed over the ranks
    whose shares of it it has not summed yet: over ``tensor`` first for a
    ``wk``/``wv`` that ``tensor`` does not cut, then over data x seq for
    an fsdp-cut leaf (its reduce-scatter over ``fsdp`` summed that axis),
    over data x fsdp x seq for the others, and over ``pipe`` too for a
    pipeline's leaves that stages share (embedding, final norm, LM head)."""
    from kukeon_tpu_torch.parallel.mesh import (AXIS_BATCH, AXIS_DATA_SEQ, AXIS_PIPE,
                                                AXIS_TENSOR)

    paths = [p for p, _ in tree_items(layout.meta())]
    partial = {p for p in paths if p[-1] in ("wk", "wv") and not layout.kv_shard}
    shared = {p for p in paths if layout.pipeline and AXIS_PIPE not in layout.spec(p)}

    def reduce_grads(grads):
        out = []
        for path, g in zip(paths, grads):
            if path in partial:
                g = mesh.reduce(g, AXIS_TENSOR)
            g = mesh.reduce(g, AXIS_DATA_SEQ if layout.gathered(path) else AXIS_BATCH)
            out.append(mesh.reduce(g, AXIS_PIPE) if path in shared else g)
        return out

    return reduce_grads


def create_moe_train_state(cfg: moe.MoEConfig, generator: torch.Generator,
                           device: torch.device | str,
                           optimizer: AdamW | None = None, *, mesh=None,
                           leaves=None) -> tuple[TrainState, AdamW]:
    """:func:`create_train_state` for the MoE tree (``moe.init_params``;
    on a ``mesh``, each leaf drawn by ``moe.iter_params`` or taken from
    ``leaves`` and cut to the rank's block, its experts' among them). The
    router stays f32, and so do its moments."""
    optimizer = optimizer or make_optimizer()
    params = (moe.init_params(cfg, generator, device) if mesh is None
              else _rank_params(cfg, moe.iter_params, generator, mesh, leaves))
    return TrainState(params=params, opt_state=optimizer.init(params), step=0), optimizer


def make_moe_train_step(cfg: moe.MoEConfig, optimizer: AdamW, *, remat: bool = True,
                        mesh=None):
    """``step(state, tokens, targets, mask) -> (state, metrics)``: the MoE
    step, ``loss = ce + load_balance_coef * load_balance + router_z_coef *
    router_z`` (the aux terms averaged over layers), with ``metrics``
    {"loss", "ce", "load_balance", "router_z"} as detached scalars.

    On a training ``mesh`` (the reference's step over data x fsdp x expert
    x seq x tensor): the forward is ``moe.forward_train``, whose aux
    losses are the global batch's on every rank, their gradients reaching
    only the rank's tokens; each rank's loss is its share of the global
    cross entropy plus the whole aux terms, so the sum of the gradients
    over ``batch`` counts each term once (:func:`make_train_step`'s
    reductions); the metrics are the global ones, the same on every rank.
    On ``seq`` the batch is the rank's block of positions at their
    absolute places, attended over every key with ``auto`` (the
    reference's MoE step has no ring option), and each slot is the one
    the global batch's dispatch gives it (``moe._row_offsets``). At one
    rank it is the one-device step, bit for bit."""
    if mesh is None:
        def loss_fn(params, tokens, targets, mask, positions):
            logits, _, aux = moe.forward_with_aux(params, cfg, tokens, positions, remat=remat)
            ce = cross_entropy_loss(logits, targets, mask)
            loss = (ce + cfg.load_balance_coef * aux["load_balance"]
                    + cfg.router_z_coef * aux["router_z"])
            metrics = {"loss": loss, "ce": ce, "load_balance": aux["load_balance"],
                       "router_z": aux["router_z"]}
            return loss, {k: v.detach() for k, v in metrics.items()}

        return _make_step(optimizer, loss_fn)

    def mesh_loss_fn(params, tokens, targets, mask, positions):
        logits, aux = moe.forward_train(params, cfg, tokens, positions, mesh, remat=remat)
        ce = _mesh_ce(logits, targets, mask, mesh)
        local = (ce + cfg.load_balance_coef * aux["load_balance"]
                 + cfg.router_z_coef * aux["router_z"])
        lb, z = aux["load_balance"].detach(), aux["router_z"].detach()
        ce = _batch_sum(ce.detach(), mesh)
        loss = ce + cfg.load_balance_coef * lb + cfg.router_z_coef * z
        return local, {"loss": loss, "ce": ce, "load_balance": lb, "router_z": z}

    return _mesh_step(cfg, optimizer, mesh, mesh_loss_fn)
