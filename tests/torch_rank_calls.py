"""A function run on every rank of a test's rank group, its results
gathered to the leader.

The leader posts ``new`` with :class:`Calls` once per group
(:func:`calls`), then each :func:`run` posts the function's path and
keyword arguments; every rank (the leader too) calls ``fn(mesh,
**kwargs)`` and the leader gets every rank's result, by global rank
(``torch.distributed.gather_object``). The followers import this module
as ``tests.torch_rank_calls`` from the repository's root."""

import importlib

import torch.distributed as dist

_CALLS: dict = {}


class Calls:
    def __init__(self, mesh):
        self.mesh = mesh

    def follow(self, action, args):
        if action != "call":
            raise ValueError(f"unknown action {action!r}")
        return _call(self.mesh, *args)


def _resolve(fn: str):
    module, _, name = fn.partition(":")
    return getattr(importlib.import_module(module), name)


def _call(mesh, fn: str, kwargs: dict):
    out = _resolve(fn)(mesh, **kwargs)
    got = [None] * mesh.size if mesh.leader else None
    dist.gather_object(out, got, dst=0)
    return got


def run(mesh, fn: str, **kwargs) -> list:
    """``fn`` (``"module:function"``) on every rank of ``mesh``'s group ->
    the results by global rank."""
    g = mesh.group
    if mesh.size == 1:
        return [_resolve(fn)(mesh, **kwargs)]
    if _CALLS.get("group") is not g:
        _CALLS["group"], _CALLS["oid"] = g, g.new_id()
        g.post(_CALLS["oid"], "new", ("tests.torch_rank_calls:Calls", {}))
    g.post(_CALLS["oid"], "call", (fn, kwargs), flush=True)
    return _call(mesh, fn, kwargs)


# --- the functions the tests run on every rank -------------------------------


def _batch_block(mesh, rows: int, cols: int, heads: int | None = None):
    """This rank's (rows, cols, heads) slices of a ``[B, S, H, ...]``
    array: rows over data x fsdp, columns over ``seq``, heads over
    ``tensor`` (None: all)."""
    b = mesh.replica * mesh.fsdp + mesh.fsdp_rank
    r = slice(b * rows, (b + 1) * rows)
    c = slice(mesh.seq_rank * cols, (mesh.seq_rank + 1) * cols)
    h = slice(None) if heads is None else slice(mesh.rank * heads, (mesh.rank + 1) * heads)
    return r, c, h


def seq_attention(mesh, impl: str, q, k, v, pos, cot):
    """The rank's block of ``impl`` (``ring`` or ``ulysses``) attention
    of the whole-batch numpy arrays q [B, S, H, D], k/v [B, S, KV, D],
    positions [B, S], and the gradients of ``sum(out * cot)`` with respect
    to its blocks of q, k and v -> (coordinates, out, dq, dk, dv), numpy."""
    import torch

    from kukeon_tpu_torch.ops.attention import gqa_attention

    B, S, H, _ = q.shape
    KV = k.shape[2]
    n_rows, n_cols = B // (mesh.data * mesh.fsdp), S // mesh.seq
    r, c, hq = _batch_block(mesh, n_rows, n_cols, H // mesh.world)
    _, _, hk = _batch_block(mesh, n_rows, n_cols, KV // mesh.world)
    qb, kb, vb = (torch.from_numpy(x[r, c, h].copy()).requires_grad_(True)
                  for x, h in ((q, hq), (k, hk), (v, hk)))
    p = torch.from_numpy(pos[r, c].copy())
    out = gqa_attention(qb, kb, vb, q_positions=p, kv_positions=p, impl=impl, mesh=mesh)
    (out * torch.from_numpy(cot[r, c, hq].copy())).sum().backward()
    coords = (r.start, r.stop, c.start, c.stop, hq.start, hq.stop, hk.start, hk.stop)
    return coords, *(t.detach().numpy() for t in (out, qb.grad, kb.grad, vb.grad))


def _local_params(layout, params: dict) -> dict:
    """``layout``'s blocks of the full numpy ``params`` (``{"a/b":
    array}``), as the nested tree of torch tensors a rank holds."""
    import torch

    from kukeon_tpu_torch.models import llama

    return llama.nest([(tuple(k.split("/")), layout.cut(tuple(k.split("/")),
                                                          torch.from_numpy(v.copy())))
                       for k, v in params.items()])


def seq_loss(mesh, impl: str, cfg, params: dict, tokens, targets, mask) -> float:
    """The global masked-mean loss of ``llama.forward_train(attn_impl=impl)``
    on this rank's blocks (its training layout's cut) of the full numpy
    ``params`` and its rows and columns of the whole batch (``tokens``,
    ``targets``, ``mask`` [B, S]) at their absolute positions, as the
    reference's test takes the loss of ``llama.forward(attn_impl=)`` on a
    seq-cut batch -> the loss (every rank's the same)."""
    import torch

    from kukeon_tpu_torch.models import llama
    from kukeon_tpu_torch.parallel.sharding import TrainLayout
    from kukeon_tpu_torch.training.train_step import _batch_sum, _mesh_ce

    B, S = tokens.shape
    r, c, _ = _batch_block(mesh, B // (mesh.data * mesh.fsdp), S // mesh.seq)
    tok, tgt, msk = (torch.from_numpy(x[r, c].copy()) for x in (tokens, targets, mask))
    pos = torch.arange(S, dtype=torch.int32)[c][None, :].expand(tok.shape).contiguous()
    with torch.no_grad():
        logits = llama.forward_train(_local_params(TrainLayout.of(cfg, mesh), params), cfg,
                                     tok, pos, mesh, remat=False, attn_impl=impl)
        return float(_batch_sum(_mesh_ce(logits, tgt, msk, mesh), mesh))


def pipeline_logits(mesh, cfg, params: dict, tokens, positions, m: int):
    """``parallel.pipeline.pipeline_forward`` on this rank's blocks (its
    pipeline layout's cut) of the full numpy ``params`` (``{"a/b":
    array}``) -> the logits, numpy."""
    import torch

    from kukeon_tpu_torch.parallel.pipeline import pipeline_forward
    from kukeon_tpu_torch.parallel.sharding import TrainLayout

    local = _local_params(TrainLayout.of(cfg, mesh, pipeline=True), params)
    out = pipeline_forward(local, cfg, torch.from_numpy(tokens.copy()),
                           torch.from_numpy(positions.copy()), mesh, num_microbatches=m)
    return out.numpy()
