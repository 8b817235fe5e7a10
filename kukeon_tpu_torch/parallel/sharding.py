"""Megatron layout of the Llama family, the port of
``kukeon_tpu/parallel/sharding.py``.

The reference annotates ``PartitionSpec``s and lets GSPMD place the
collectives. Here the same specs, as tuples of axis names, cut each rank's
local tree (:func:`shard_params`), and the forward
(``models/llama.py``) places the collectives itself:

- ``wq``/``wk``/``wv`` and ``w_gate``/``w_up`` are column-parallel (their
  output dim on ``tensor``), ``wo`` and ``w_down`` row-parallel (their
  input dim), so one ``all_reduce`` closes each attention and each MLP
  block: two a layer;
- the embedding is vocab-sharded (a masked lookup, then an
  ``all_reduce``), the untied LM head column-sharded and the tied one the
  vocab-sharded embedding, both followed by an ``all_gather`` of the
  logits;
- an int8 scale takes its matrix's spec minus the contracted axis
  (:func:`_quant_scale_spec`);
- an int8 LM head's vocabulary shard (the tied embedding's rows, or the
  untied head's columns) is zero-padded to a multiple of 128
  (:func:`pad_vocab`), so the hand-written kernel, whose tiles are 128
  wide, takes it at every world (llama3-8b's 128256 / 4 = 32064 is not a
  multiple of 128); the forward cuts the padding off the logits;
- the KV cache holds each rank's kv heads (:func:`kv_cache_spec`). With
  ``kv_shard`` off, or kv heads that ``tensor`` does not divide (the
  reference's ``_cache_shardings``), ``wk``, ``wv`` and the cache are
  replicated and each rank attends its q heads to their groups.

Counterparts in the reference: ``llama_param_specs`` :34,
``specs_for_params`` :63, ``_quant_scale_spec`` :68, ``shard_params``
:102, ``kv_cache_spec`` :208. The MoE and BERT specs wait for A13b.
"""

from __future__ import annotations

import dataclasses
import importlib
from typing import Any

import numpy as np
import torch

from kukeon_tpu_torch.models import llama
from kukeon_tpu_torch.parallel.mesh import AXIS_DATA, AXIS_FSDP, AXIS_TENSOR

Spec = tuple


def llama_param_specs(fsdp: bool = False) -> dict:
    """The reference's spec tree for ``models.llama.init_params`` (stacked
    layers keep their leading [L] axis replicated)."""
    f = AXIS_FSDP if fsdp else None
    t = AXIS_TENSOR
    return {
        "embed": (t, f),                        # vocab-sharded
        "layers": {
            "attn_norm": (None, None),
            "wq": (None, f, t),                 # column-parallel (heads)
            "wk": (None, f, t),
            "wv": (None, f, t),
            "wo": (None, t, f),                 # row-parallel
            "mlp_norm": (None, None),
            "w_gate": (None, f, t),             # column-parallel (intermediate)
            "w_up": (None, f, t),
            "w_down": (None, t, f),             # row-parallel
        },
        "final_norm": (None,),
        "lm_head": (f, t),                      # untied configs only
    }


def specs_for_params(params, fsdp: bool = False) -> dict:
    """The spec tree pruned to the keys present in ``params``."""
    full = llama_param_specs(fsdp)
    return {k: full[k] for k in params}


def _quant_scale_spec(spec: Spec, q, s) -> Spec:
    """Spec of an int8 scale vector: the matrix spec minus the contracted
    axis (the scale spans the surviving ones)."""
    if q.ndim == 4:                      # experts [L, E, in, out] -> s [L, E, out]
        return (spec[0], spec[1], spec[3])
    if q.ndim == 3:                      # stacked [L, in, out] -> s [L, out]
        return (spec[0], spec[2])
    # 2-D: s aligns with whichever matrix axis it matches in size.
    return (spec[0] if s.shape[0] == q.shape[0] else spec[1],)


def kv_cache_spec(shard_batch: bool = False) -> Spec:
    """KV cache k/v [L, B, S, KV, D]: kv heads on ``tensor``; a serving
    engine keeps its decode slots replicated."""
    batch = (AXIS_DATA, AXIS_FSDP) if shard_batch else None
    return (None, batch, None, AXIS_TENSOR, None)


def kv_sharded(num_kv_heads: int, world: int, kv_shard: bool | None = None) -> bool:
    """The reference's rule (``serving/engine.py:665-677``): the cache
    shards unless ``kv_shard`` is False or the kv heads do not divide the
    tensor axis."""
    return kv_shard is not False and num_kv_heads % world == 0


def check_tensor_parallel(cfg, world: int, kv_shard: bool | None = None) -> bool:
    """Refuse (``SystemExit``, naming A13b) a tensor axis the port cannot
    cut ``cfg`` over: one that does not divide the heads, the intermediate
    size or the vocabulary, or, with a replicated cache, whose q-head
    groups would straddle kv heads. -> whether the cache shards."""
    for what, n in (("num_heads", cfg.num_heads),
                    ("intermediate_size", cfg.intermediate_size),
                    ("vocab_size", cfg.vocab_size)):
        if n % world:
            raise SystemExit(
                f"tensor parallelism over {world} ranks: {what} {n} is not a multiple of "
                f"{world}; uneven shards are not ported yet (ROADMAP.md A13b)")
    sharded = kv_sharded(cfg.num_kv_heads, world, kv_shard)
    if not sharded and world % cfg.num_kv_heads and cfg.num_kv_heads % world:
        raise SystemExit(
            f"tensor parallelism over {world} ranks: {cfg.num_kv_heads} kv heads neither "
            f"divide nor are divided by {world}, so a rank's q heads would span part of a "
            "kv group; not ported yet (ROADMAP.md A13b)")
    return sharded


def _cut(x, spec: Spec, rank: int, world: int):
    """The ``rank``-th of ``world`` equal blocks of ``x`` along the axis
    ``spec`` puts on ``tensor`` (``x`` itself when none does), as a copy:
    contiguous, and holding no reference to ``x`` (a view of a row block
    would keep the whole leaf's storage alive)."""
    if AXIS_TENSOR not in spec or world == 1:
        return x
    axis = spec.index(AXIS_TENSOR)
    n = x.shape[axis]
    if n % world:
        raise ValueError(f"axis {axis} of a {tuple(x.shape)} leaf does not split {world} ways")
    m = n // world
    if isinstance(x, torch.Tensor):
        return x.narrow(axis, rank * m, m).clone(memory_format=torch.contiguous_format)
    return np.ascontiguousarray(np.take(x, np.arange(rank * m, (rank + 1) * m), axis=axis))


def param_specs(params, kv_shard: bool = True) -> dict:
    """The spec of every leaf of ``params`` (int8 ``{"q", "s"}`` leaves
    expanded, the scale by :func:`_quant_scale_spec`); ``kv_shard`` False
    replicates ``wk`` and ``wv``."""
    specs = specs_for_params(params)
    if not kv_shard:
        specs["layers"] = {**specs["layers"], "wk": (None, None, None),
                           "wv": (None, None, None)}

    def expand(spec, leaf):
        if isinstance(leaf, dict):                   # int8 {"q", "s"}
            return {"q": spec, "s": _quant_scale_spec(spec, leaf["q"], leaf["s"])}
        return spec

    return {k: ({n: expand(specs[k][n], w) for n, w in leaf.items()}
                if k == "layers" else expand(specs[k], leaf))
            for k, leaf in params.items()}


VOCAB_TILE = 128


def pad_vocab(params, rows: int) -> dict[str, Any]:
    """``params`` (a rank's tree of ``rows`` vocabulary entries) with its
    int8 LM head zero-padded to a multiple of :data:`VOCAB_TILE` entries:
    the tied embedding's rows (K1t's N), or the untied ``lm_head``'s
    columns (K1's N), their scales padded with ones. A tree already
    padded, full-precision, or of a multiple of the tile, comes back as
    it is. Torch leaves only (the engine's device tree)."""
    pad = -rows % VOCAB_TILE
    key, axis = ("lm_head", 1) if "lm_head" in params else ("embed", 0)
    head = params[key]
    if not pad or not isinstance(head, dict) or head["q"].shape[axis] != rows:
        return params
    q, s = head["q"], head["s"]
    shape = list(q.shape)
    shape[axis] = pad
    return {**params, key: {"q": torch.cat([q, q.new_zeros(shape)], axis),
                            "s": torch.cat([s, s.new_ones((pad,))])}}


@dataclasses.dataclass(frozen=True)
class Recipe:
    """How every rank of a group makes the same weights, so none is sent
    over the control channel: ``factory`` (``"module:function"``, in a
    module that imports no jax), called as ``factory(device=, **kwargs)``,
    yields the full tree's ``(path tuple, tensor)`` leaves one at a time,
    the same on every rank (drawn from a seed, or read from a checkpoint).
    :func:`local_params` keeps each rank's slice."""

    factory: str
    kwargs: dict


def local_params(recipe: Recipe, cfg, mesh, kv_shard: bool = True) -> dict[str, Any]:
    """This rank's tree, on its device, from ``recipe``: each full leaf is
    cut by its spec as it comes and freed before the next is made, so a
    rank holds its local tree and at most one full leaf (plus what the
    factory holds to make it), never the model. An int8 LM head's
    vocabulary shard comes padded (:func:`pad_vocab`)."""
    module, _, name = recipe.factory.partition(":")
    factory = getattr(importlib.import_module(module), name)
    # The spec of a leaf by its path: from the int8 tree of cfg's shapes,
    # whose {"q", "s"} node also gives a full-precision matrix's spec.
    meta = llama.init_params(cfg, None, "meta")
    specs = param_specs(llama.quantize_params(meta), kv_shard)
    local = []
    for path, full in factory(device=mesh.device, **recipe.kwargs):
        spec = specs
        for k in path:
            spec = spec[k]
        if isinstance(spec, dict):
            spec = spec["q"]
        local.append((path, _cut(full, spec, mesh.rank, mesh.world).to(mesh.device)))
        del full
    return pad_vocab(llama.nest(local), cfg.vocab_size // mesh.world)


def shard_params(params, mesh, kv_shard: bool = True) -> dict[str, Any]:
    """This rank's local tree of a full tree (host or device leaves, numpy
    or torch, int8 or full precision): each leaf cut by its spec on
    ``mesh.rank`` of ``mesh.world``. The concatenation of every rank's
    cut along the spec's axis is the leaf, bit for bit."""
    return shard_tree(params, mesh.rank, mesh.world, kv_shard)


def shard_tree(params, rank: int, world: int, kv_shard: bool = True) -> dict[str, Any]:
    """:func:`shard_params` by rank and world."""
    specs = param_specs(params, kv_shard)

    def walk(node, spec):
        if isinstance(node, dict):
            return {k: walk(v, spec[k]) for k, v in node.items()}
        return _cut(node, spec, rank, world)

    return walk(params, specs)
