"""Megatron layout of the Llama, MoE and BERT families, the port of
``kukeon_tpu/parallel/sharding.py``.

The reference annotates ``PartitionSpec``s and lets GSPMD place the
collectives. Here the same specs, as tuples of axis names, cut each rank's
local tree (:func:`shard_params`), and the forwards (``models/llama.py``,
``models/moe.py``, ``models/bert.py``) place the collectives themselves:

- ``wq``/``wk``/``wv`` and ``w_gate``/``w_up`` (BERT's ``w_in``) are
  column-parallel (their output dim on ``tensor``), ``wo`` and ``w_down``
  (``w_out``) row-parallel (their input dim), so one ``all_reduce``
  closes each attention and each MLP block: two a layer. A MoE layer's
  expert stacks ``[L, E, in, out]`` keep that pairing inside each expert
  (``expert`` is size 1 when serving, as in the reference's
  ``serving_mesh``), and its one ``all_reduce`` follows the combine; the
  router is replicated. BERT's column-parallel biases are cut with their
  matrices; ``bo``/``b_out`` are replicated and added after the sum;
- the embedding (BERT's ``word``) is vocab-sharded (a masked lookup, then
  an ``all_reduce``), the untied LM head column-sharded and the tied one
  the vocab-sharded embedding, both followed by an ``all_gather`` of the
  logits. A vocabulary the world does not divide is cut in blocks of
  ``ceil(V / world)`` (:func:`vocab_rows`), the last rank's zero-padded;
  the masked lookup never reads a padded row, and the forward cuts the
  padded columns off the logits;
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
  replicated and each rank attends each of its q heads to its own kv
  head (``models/llama.py _heads``), whether or not its block of q heads
  straddles a kv group;
- the attention leaves (:data:`HEAD_LEAVES`) are cut in whole heads:
  where ``tensor`` does not divide the heads, a rank holds ``ceil(heads /
  tensor)`` of them and the trailing ranks' blocks are zero-padded, as a
  vocabulary is; a zero head's columns of ``wq`` give a zero query and its
  rows of ``wo`` are zero, so it adds exactly zero to the sum. The
  reference's GSPMD cuts a head where it must instead; both compute the
  same model. What the reference's shardings cannot cut,
  :func:`check_tensor_parallel` refuses.

Every cut goes by a rank's **tensor** coordinate and the tensor size
(``Mesh.rank``, ``Mesh.world``): a data replica holds the
blocks its tensor peer of replica 0 holds, and reads only those. One rule
cuts every leaf, in memory and on disk: :func:`rank_block` gives a
rank's :class:`Block` of a leaf (the ``ceil(n / world)`` blocks in whole
units (a head's ``head_dim`` columns or rows on :data:`HEAD_LEAVES`),
their zero padding, an int8 head's tile padding); :func:`_cut` cuts a full
leaf by it, and :class:`Layout` gives it by leaf path to the readers of
``models/`` (``checkpoints.stream_quantized``, ``hf_convert``'s streams
and ``moe_rank_leaves``, ``orbax_ckpt.rank_leaves``), which read only a
rank's blocks from a checkpoint. :func:`local_meta` is a rank's abstract
local tree, what its streamed engine allocates; a :class:`Recipe` says
whether its factory yields full leaves, a rank's blocks, or a rank's
stream (:func:`open_stream`).

Counterparts in the reference: ``llama_param_specs`` :34,
``specs_for_params`` :63, ``_quant_scale_spec`` :68, ``shard_params``
:102, ``moe_param_specs`` :130, ``moe_specs_for_params`` :161,
``bert_param_specs`` :166, ``shard_bert_params`` :194, ``kv_cache_spec``
:208.
"""

from __future__ import annotations

import dataclasses
import importlib
import itertools
import math
from typing import Any

import numpy as np
import torch

from kukeon_tpu_torch.models import bert, llama, moe
from kukeon_tpu_torch.models.llama import vocab_rows
from kukeon_tpu_torch.parallel.mesh import (AXES, AXIS_DATA, AXIS_EXPERT, AXIS_FSDP,
                                            AXIS_PIPE, AXIS_SEQ, AXIS_TENSOR)

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


def moe_param_specs(fsdp: bool = False) -> dict:
    """The reference's spec tree for ``models.moe.init_params``: the
    attention trunk as Llama's, the router replicated, each expert stack's
    E axis on ``expert`` and the column -> row pairing on ``tensor``
    inside every expert."""
    f = AXIS_FSDP if fsdp else None
    t = AXIS_TENSOR
    e = AXIS_EXPERT
    return {
        "embed": (t, f),
        "layers": {
            "attn_norm": (None, None),
            "wq": (None, f, t),
            "wk": (None, f, t),
            "wv": (None, f, t),
            "wo": (None, t, f),
            "mlp_norm": (None, None),
            "router": (None, None, None),
            "w_gate": (None, e, f, t),          # [L, E, H, I]
            "w_up": (None, e, f, t),
            "w_down": (None, e, t, f),          # [L, E, I, H]
        },
        "final_norm": (None,),
        "lm_head": (f, t),
    }


def moe_specs_for_params(params, fsdp: bool = False) -> dict:
    full = moe_param_specs(fsdp)
    return {k: full[k] for k in params}


def bert_param_specs(fsdp: bool = False) -> dict:
    """The reference's spec tree for ``models.bert.init_params``: the
    decoder's column -> row pairing, each column-parallel bias cut with
    its matrix, ``bo``/``b_out`` replicated."""
    f = AXIS_FSDP if fsdp else None
    t = AXIS_TENSOR
    return {
        "embed": {
            "word": (t, f),                     # vocab-sharded
            "position": (None, f),
            "type": (None, f),
            "norm_scale": (None,),
            "norm_bias": (None,),
        },
        "layers": {
            "wq": (None, f, t), "bq": (None, t),
            "wk": (None, f, t), "bk": (None, t),
            "wv": (None, f, t), "bv": (None, t),
            "wo": (None, t, f), "bo": (None, None),
            "attn_norm_scale": (None, None), "attn_norm_bias": (None, None),
            "w_in": (None, f, t), "b_in": (None, t),
            "w_out": (None, t, f), "b_out": (None, None),
            "mlp_norm_scale": (None, None), "mlp_norm_bias": (None, None),
        },
    }


def family(tree) -> str:
    """``"bert"``, ``"moe"`` or ``"llama"``: the family of a parameter tree
    (BERT's embedding is a dict with ``word``; a MoE layer has a router)."""
    embed = tree.get("embed")
    if isinstance(embed, dict) and "word" in embed:
        return "bert"
    return "moe" if "router" in tree.get("layers", {}) else "llama"


def tree_specs(params, fsdp: bool = False) -> dict:
    """The spec tree of ``params``' family, pruned to its keys."""
    kind = family(params)
    if kind == "bert":
        return bert_param_specs(fsdp)
    if kind == "moe":
        return moe_specs_for_params(params, fsdp)
    return specs_for_params(params, fsdp)


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
    """Refuse (``SystemExit``) exactly the tensor sizes the reference's
    shardings refuse, the vocabulary aside: one that does not divide a dim
    its specs put on ``tensor`` (its ``device_put`` of the leaf raises
    there): the attention width (``wq``'s columns, ``wo``'s rows; BERT's
    hidden width), the kv width (``wk``'s and ``wv``'s columns, cut
    whether or not the cache shards) or the intermediate size (each
    expert's, in a MoE layer). Heads it does not divide are cut in whole,
    zero-padded heads (:func:`rank_block`), and a vocabulary it does not
    divide is padded (:func:`vocab_rows`). ``world`` is the tensor size.
    -> whether the cache shards (BERT has none: True)."""
    dims = ((("hidden width", cfg.hidden_size),) if isinstance(cfg, bert.BertConfig)
            else (("num_heads*head_dim", cfg.q_dim), ("num_kv_heads*head_dim", cfg.kv_dim)))
    for what, n in dims + (("intermediate_size", cfg.intermediate_size),):
        if n % world:
            raise SystemExit(
                f"tensor parallelism over {world} ranks: {what} {n} is not a multiple of "
                f"{world}; the reference's shardings cannot cut it over {world} devices "
                "either")
    return kv_sharded(getattr(cfg, "num_kv_heads", cfg.num_heads), world, kv_shard)


@dataclasses.dataclass(frozen=True)
class Block:
    """A rank's block of one leaf: ``[lo, hi)`` of the full leaf along
    ``axis`` (the spec's ``tensor`` axis; None: the whole leaf, replicated),
    held as ``size`` entries along it: the ``hi - lo`` real ones, zeros up
    to ``rows`` (:func:`vocab_rows`), then ``fill`` up to ``size`` (an int8
    head's tile padding, :func:`pad_vocab`: ones for its scale)."""

    axis: int | None
    lo: int
    hi: int
    rows: int
    size: int
    fill: int = 0

    def local_shape(self, shape) -> tuple[int, ...]:
        """The rank's shape of a leaf of full ``shape``."""
        if self.axis is None:
            return tuple(shape)
        return tuple(self.size if i == self.axis else d for i, d in enumerate(shape))

    def take(self, x):
        """The real part of the block of ``x`` (a full leaf): a view."""
        if self.axis is None:
            return x
        if isinstance(x, torch.Tensor):
            return x.narrow(self.axis, self.lo, self.hi - self.lo)
        index = [slice(None)] * x.ndim
        index[self.axis] = slice(self.lo, self.hi)
        return x[tuple(index)]

    def place(self, part):
        """``part`` (the real ``hi - lo`` entries along ``axis``, numpy or
        torch) padded to the local shape, as a contiguous copy that holds no
        reference to what ``part`` views."""
        torch_part = isinstance(part, torch.Tensor)
        if self.axis is None or (self.size == self.hi - self.lo):
            return (part.clone(memory_format=torch.contiguous_format) if torch_part
                    else np.array(part, order="C", copy=True))
        pads = ((self.rows - (self.hi - self.lo), 0), (self.size - self.rows, self.fill))
        pieces = [part]
        for n, value in pads:
            if n:
                shape = list(part.shape)
                shape[self.axis] = n
                pieces.append(part.new_full(shape, value) if torch_part
                              else np.full(shape, value, part.dtype))
        return torch.cat(pieces, self.axis) if torch_part else np.concatenate(pieces, self.axis)


def rank_block(spec: Spec, shape, rank: int, world: int, head: str | None = None,
               unit: int = 1, axis_name: str = AXIS_TENSOR) -> Block:
    """THE rule for a rank's block of a leaf of full ``shape`` and ``spec``
    (``rank`` and ``world`` the tensor coordinate and size): along the
    spec's ``tensor`` axis, blocks of ``ceil(n / unit / world)`` whole
    units of ``unit`` entries (a head's ``head_dim`` on
    :data:`HEAD_LEAVES`, else one), the last one(s) zero-padded (a
    vocabulary, heads the world does not divide:
    :func:`check_tensor_parallel` refuses the rest); ``head`` (``"q"`` or
    ``"s"``, an int8 LM head's leaves) pads the block further to a multiple
    of :data:`VOCAB_TILE` (with ones for ``"s"``). Every cut in memory
    (:func:`_cut`) and every slice read from disk goes through it; a train
    state's cut takes it once an axis, ``axis_name`` ``tensor`` and then
    ``fsdp`` (:class:`TrainLayout`)."""
    if axis_name not in spec:
        return Block(None, 0, 0, 0, 0)
    axis = spec.index(axis_name)
    n = shape[axis]
    m = vocab_rows(n // unit, world) * unit
    lo, hi = min(rank * m, n), min((rank + 1) * m, n)
    size = m + (-m % VOCAB_TILE if head else 0)
    return Block(axis, lo, hi, m, size, 1 if head == "s" else 0)


def _cut(x, spec: Spec, rank: int, world: int, unit: int = 1):
    """The ``rank``-th of ``world`` blocks of ``x`` along the axis ``spec``
    puts on ``tensor`` (``x`` itself when none does, or at one rank), as a
    copy: contiguous, and holding no reference to ``x`` (a view of a row
    block would keep the whole leaf's storage alive); :func:`rank_block`'s
    rule, in whole units of ``unit`` entries."""
    if AXIS_TENSOR not in spec or world == 1:
        return x
    block = rank_block(spec, x.shape, rank, world, unit=unit)
    return block.place(block.take(x))


# The layer leaves cut in whole heads (their spec's ``tensor`` axis is a
# heads x head_dim axis): the attention projections, and BERT's biases.
HEAD_LEAVES = frozenset({"wq", "wk", "wv", "wo", "bq", "bk", "bv"})


def head_unit(path: tuple[str, ...], head_dim: int) -> int:
    """The unit :func:`rank_block` cuts the leaf at ``path`` in: one head's
    ``head_dim`` entries on :data:`HEAD_LEAVES` (int8 ``q``/``s`` alike),
    else 1."""
    if len(path) >= 2 and path[0] == "layers" and path[1] in HEAD_LEAVES:
        return head_dim
    return 1


def param_specs(params, kv_shard: bool = True) -> dict:
    """The spec of every leaf of ``params`` (its family's spec tree, int8
    ``{"q", "s"}`` leaves expanded, the scale by
    :func:`_quant_scale_spec`); ``kv_shard`` False replicates a decoder's
    ``wk`` and ``wv``."""
    specs = tree_specs(params)
    if not kv_shard and family(params) != "bert":
        specs["layers"] = {**specs["layers"], "wk": (None, None, None),
                           "wv": (None, None, None)}

    def walk(node, spec):
        if isinstance(spec, dict):
            return {k: walk(v, spec[k]) for k, v in node.items()}
        if isinstance(node, dict):                   # int8 {"q", "s"}
            return {"q": spec, "s": _quant_scale_spec(spec, node["q"], node["s"])}
        return spec

    return walk(params, specs)


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
    module that imports no jax) and its ``kwargs``. ``reads`` says what the
    factory gives:

    - ``"leaves"``: called as ``factory(device=, **kwargs)``, it yields the
      full tree's ``(path tuple, tensor)`` leaves one at a time, the same on
      every rank (drawn from a seed), and :func:`local_params` cuts each;
    - ``"slices"``: called as ``factory(device=, rank=, world=, kv_shard=,
      **kwargs)``, it yields this rank's block of each leaf
      (:class:`Layout`), read from a checkpoint, padding included;
    - ``"stream"``: called as ``factory(rank=, world=, kv_shard=,
      **kwargs)``, it returns a ``CheckpointStream`` of this rank's blocks
      on the host, whose abstract tree is :func:`local_meta`'s: the engine
      boots from it as from a one-device stream (:func:`open_stream`)."""

    factory: str
    kwargs: dict
    reads: str = "leaves"

    def resolve(self):
        module, _, name = self.factory.partition(":")
        return getattr(importlib.import_module(module), name)


def meta_params(cfg) -> dict:
    """``cfg``'s tree on the meta device (shapes only): int8 for the
    decoder families, whose ``{"q", "s"}`` node also gives a
    full-precision matrix's spec; full precision for BERT, which has no
    int8 form."""
    return _meta(cfg, quantized=True)


def _meta(cfg, quantized: bool) -> dict:
    if isinstance(cfg, bert.BertConfig):
        return bert.init_params(cfg, None, "meta")
    mod = moe if isinstance(cfg, moe.MoEConfig) else llama
    tree = mod.init_params(cfg, None, "meta")
    return mod.quantize_params(tree) if quantized else tree


class Layout:
    """Where each leaf of ``cfg``'s tree lies on tensor coordinate ``rank``
    of a tensor axis of ``world``: its spec and its :func:`rank_block`
    (attention leaves in whole heads; the int8 head's leaves tile-padded:
    the tied embedding's, else the untied ``lm_head``'s). The readers of
    ``models/`` cut what they read from disk by it."""

    def __init__(self, cfg, rank: int, world: int, kv_shard: bool = True):
        meta = meta_params(cfg)
        self.rank, self.world = rank, world
        self.head_dim = cfg.head_dim
        self.specs = param_specs(meta, kv_shard)
        self.head = (None if isinstance(cfg, bert.BertConfig)
                     else ("lm_head",) if "lm_head" in meta else ("embed",))

    def spec(self, path: tuple[str, ...]) -> Spec:
        spec = self.specs
        for k in path:
            spec = spec[k]
        return spec["q"] if isinstance(spec, dict) else spec

    def unit(self, path: tuple[str, ...]) -> int:
        return head_unit(path, self.head_dim)

    def block(self, path: tuple[str, ...], shape) -> Block:
        head = path[-1] if path[:-1] == self.head and path[-1] in ("q", "s") else None
        return rank_block(self.spec(path), tuple(shape), self.rank, self.world, head,
                          self.unit(path))


def local_meta(cfg, mesh, kv_shard: bool = True, *, quantized: bool = False) -> dict:
    """The abstract local tree of ``mesh``'s tensor coordinate
    (``TensorSpec`` leaves: shape and dtype), padding included, from
    ``cfg``'s meta tree (int8 ``{"q", "s"}`` leaves when ``quantized``;
    BERT is never) and the specs: the shapes :func:`local_params` gives
    that rank."""
    from kukeon_tpu_torch.models.checkpoints import TensorSpec, _walk_tree

    layout = Layout(cfg, mesh.rank, mesh.world, kv_shard)
    leaves = [(path, TensorSpec(layout.block(path, t.shape).local_shape(t.shape), t.dtype))
              for path, t in _walk_tree(_meta(cfg, quantized))]
    return llama.nest(leaves)


def local_params(recipe: Recipe, cfg, mesh, kv_shard: bool = True) -> dict[str, Any]:
    """This rank's tree, on its device, from a ``"leaves"`` or ``"slices"``
    ``recipe`` (any family; its specs from ``cfg``'s), cut by its tensor
    coordinate (a data replica's tree is its replica-0 peer's). Full leaves are cut
    by their spec as they come and each freed before the next is made, so
    a rank holds its local tree and at most one full leaf (plus what the
    factory holds to make it), never the model; slices come cut. The
    vocabulary rows come zero-padded to :func:`vocab_rows`, and an int8
    LM head's shard padded further to the kernel's tile
    (:func:`pad_vocab`)."""
    factory = recipe.resolve()
    rank, world = mesh.rank, mesh.world
    if recipe.reads == "slices":
        tree = llama.nest(list(factory(device=mesh.device, rank=rank, world=world,
                                       kv_shard=kv_shard, **recipe.kwargs)))
    elif recipe.reads == "leaves":
        layout = Layout(cfg, rank, world, kv_shard)
        local = []
        for path, full in factory(device=mesh.device, **recipe.kwargs):
            local.append((path, _cut(full, layout.spec(path), rank, world,
                                     layout.unit(path)).to(mesh.device)))
            del full
        tree = llama.nest(local)
    else:
        raise ValueError(f"a {recipe.reads!r} recipe boots through open_stream")
    if isinstance(cfg, bert.BertConfig):
        return tree
    return pad_vocab(tree, vocab_rows(cfg.vocab_size, world))


def open_stream(recipe: Recipe, cfg, mesh, kv_shard: bool = True):
    """This rank's ``CheckpointStream`` of a ``"stream"`` ``recipe``: its
    blocks on the host, read by the stream's own threads. Its abstract tree
    must have :func:`local_meta`'s shapes (a ``ValueError`` names the first
    leaf that does not)."""
    from kukeon_tpu_torch.models.checkpoints import _walk_tree

    stream = recipe.resolve()(rank=mesh.rank, world=mesh.world,
                              kv_shard=kv_shard, **recipe.kwargs)
    got = dict(_walk_tree(stream.abstract_params))
    quantized = any(p[-1] == "q" for p in got)
    want = dict(_walk_tree(local_meta(cfg, mesh, kv_shard, quantized=quantized)))
    for path in sorted(got.keys() | want.keys()):
        if path not in got or path not in want or got[path].shape != want[path].shape:
            stream.close()
            raise ValueError(
                f"rank {mesh.rank}'s stream leaf {'.'.join(path)} is "
                f"{getattr(got.get(path), 'shape', None)}, its layout's "
                f"{getattr(want.get(path), 'shape', None)}")
    return stream


def shard_params(params, mesh, kv_shard: bool = True, *, head_dim: int) -> dict[str, Any]:
    """This rank's local tree of a full tree (host or device leaves, numpy
    or torch, int8 or full precision): each leaf cut by its spec on
    ``mesh.rank`` of ``mesh.world``. The concatenation of
    every rank's cut along the spec's axis is the leaf, bit for bit."""
    return shard_tree(params, mesh.rank, mesh.world, kv_shard, head_dim=head_dim)


def shard_tree(params, rank: int, world: int, kv_shard: bool = True, *,
               head_dim: int) -> dict[str, Any]:
    """:func:`shard_params` by tensor coordinate and size (a vocabulary the
    world does not divide comes zero-padded, as :func:`local_params` cuts
    it), the attention leaves in whole heads of ``head_dim``
    (:func:`head_unit`), as :class:`Layout` cuts them."""
    specs = param_specs(params, kv_shard)

    def walk(node, spec, path):
        if isinstance(node, dict):
            return {k: walk(v, spec[k], path + (k,)) for k, v in node.items()}
        return _cut(node, spec, rank, world, head_unit(path, head_dim))

    return walk(params, specs, ())


# --- training: a train state over pipe x data x fsdp x expert x seq x tensor ---


def train_model(cfg):
    """The model module of a config: ``moe`` for a ``MoEConfig``, else
    ``llama``."""
    return moe if isinstance(cfg, moe.MoEConfig) else llama


def check_train_mesh(cfg, fsdp: int, tensor: int, expert: int = 1, pipe: int = 1,
                     pipeline: bool = False) -> None:
    """Refuse (``SystemExit``) a training mesh whose ``fsdp``, ``expert``
    or ``tensor`` axis does not divide what its specs cut: ``fsdp`` the
    hidden width (every matrix's ``fsdp`` axis; a ``pipeline`` layout cuts
    none on it), ``expert`` a MoE model's experts (the expert stacks' axis
    1; a Llama model's leaves are replicated over it), ``tensor`` the
    vocabulary, the kv width and the intermediate size (the reference's
    ``device_put`` of the train state raises there too), and the heads:
    the port's training step cuts whole heads and pads none (zero-padded
    heads would take gradient steps in ``wo``'s padded rows), where the
    reference's GSPMD would cut a head's columns. A ``pipeline`` layout's
    ``pipe`` must divide the layers: the reference's ``ValueError``, its
    words."""
    if pipeline and cfg.num_layers % pipe:
        raise ValueError(f"num_layers {cfg.num_layers} % pipe {pipe} != 0")
    if isinstance(cfg, moe.MoEConfig) and cfg.num_experts % expert:
        raise SystemExit(
            f"training mesh: expert {expert} does not divide num_experts {cfg.num_experts}: "
            f"the global size of the expert stacks' dimension 1 should be divisible by "
            f"{expert}, but it is equal to {cfg.num_experts}; the reference's shardings "
            "cannot cut it either")
    dims = ((AXIS_FSDP, 1 if pipeline else fsdp, "hidden_size", cfg.hidden_size),
            (AXIS_TENSOR, tensor, "vocab_size", cfg.vocab_size),
            (AXIS_TENSOR, tensor, "num_kv_heads*head_dim", cfg.kv_dim),
            (AXIS_TENSOR, tensor, "intermediate_size", cfg.intermediate_size),
            (AXIS_TENSOR, tensor, "num_heads", cfg.num_heads))
    for axis, n, what, dim in dims:
        if dim % n:
            raise SystemExit(
                f"training mesh: {axis} {n} does not divide {what} {dim}"
                + (" (the port's training step cuts whole heads)" if what == "num_heads"
                   else "; the reference's shardings cannot cut it either"))


def train_specs(cfg, tensor: int, pipeline: bool = False) -> dict:
    """The spec of every leaf of ``cfg``'s train-state params (the
    reference's ``llama_param_specs(fsdp=True)``, or
    ``moe_specs_for_params(fsdp=True)`` for a ``MoEConfig``, pruned to the
    tree; a ``pipeline``'s, the reference's ``pp_specs_for_params``:
    ``llama_param_specs(fsdp=False)`` with the layer stacks' axis 0 on
    ``pipe``), with ``wk``/``wv`` replicated over ``tensor`` when it does
    not divide the kv heads (each rank then computes every kv head and
    attends its q heads' own, as serving does)."""
    specs = tree_specs(train_model(cfg).init_params(cfg, None, "meta"), fsdp=not pipeline)
    if pipeline:
        specs["layers"] = {k: (AXIS_PIPE, *v[1:]) for k, v in specs["layers"].items()}
    if cfg.num_kv_heads % tensor:
        specs["layers"] = {**specs["layers"],
                           **{k: tuple(a if a != AXIS_TENSOR else None
                                       for a in specs["layers"][k]) for k in ("wk", "wv")}}
    return specs


class TrainLayout:
    """Where each leaf of a Llama or MoE train state lies on the rank at
    fsdp coordinate ``fsdp_rank`` of ``fsdp``, expert coordinate
    ``expert_rank`` of ``expert``, tensor coordinate ``rank`` of ``world``
    and, in a ``pipeline`` layout (the GPipe step's, ``parallel/
    pipeline.py``), pipe coordinate ``pipe_rank`` of ``pipe``
    (:func:`train_specs`; every data and seq coordinate holds the same
    blocks): a block on each cut axis by :func:`rank_block`, in whole
    heads on :data:`HEAD_LEAVES`' tensor axis, with no padding
    (:func:`check_train_mesh`). A leaf whose spec does not cut ``expert``
    (the whole Llama tree, a MoE model's trunk and router) is the same on
    every expert peer; one whose spec does not cut ``pipe`` (a pipeline's
    embedding, final norm and LM head) on every stage. The moments mirror
    the params. A mesh's :meth:`of` gives its rank's layout; the
    checkpoint readers and writers cut and place by :meth:`regions`."""

    def __init__(self, cfg, fsdp_rank: int, fsdp: int, rank: int, world: int, *,
                 expert_rank: int = 0, expert: int = 1, pipe_rank: int = 0, pipe: int = 1,
                 pipeline: bool = False):
        check_train_mesh(cfg, fsdp, world, expert, pipe, pipeline)
        self.cfg = cfg
        self.fsdp_rank, self.fsdp, self.rank, self.world = fsdp_rank, fsdp, rank, world
        self.expert_rank, self.expert = expert_rank, expert
        self.pipe_rank, self.pipe, self.pipeline = pipe_rank, pipe, pipeline
        self.specs = train_specs(cfg, world, pipeline)
        self.kv_shard = cfg.num_kv_heads % world == 0

    @classmethod
    def of(cls, cfg, mesh, pipeline: bool = False) -> "TrainLayout":
        """The layout of ``mesh``'s rank (``pipeline``: the GPipe step's,
        its layers cut on ``pipe``; else ``pipe`` must be 1)."""
        pipe = dict(pipe_rank=mesh.pipe_rank, pipe=mesh.pipe) if pipeline else {}
        return cls(cfg, mesh.fsdp_rank, mesh.fsdp, mesh.rank, mesh.world,
                   expert_rank=mesh.expert_rank, expert=mesh.expert, pipeline=pipeline,
                   **pipe)

    def peers(self, data: int = 1, seq: int = 1) -> list[tuple["TrainLayout", int, int]]:
        """``(layout, data coordinate, seq coordinate)`` of every rank of a
        mesh whose other axes are this layout's and whose ``data`` and
        ``seq`` have these sizes, by global rank (``mesh.AXES``' order)."""
        sizes = {AXIS_PIPE: self.pipe, AXIS_DATA: data, AXIS_FSDP: self.fsdp,
                 AXIS_EXPERT: self.expert, AXIS_SEQ: seq, AXIS_TENSOR: self.world}
        out = []
        for p, d, f, x, s, t in itertools.product(*(range(sizes[a]) for a in AXES)):
            out.append((TrainLayout(self.cfg, f, self.fsdp, t, self.world, expert_rank=x,
                                    expert=self.expert, pipe_rank=p, pipe=self.pipe,
                                    pipeline=self.pipeline), d, s))
        return out

    def meta(self) -> dict:
        """``cfg``'s params on the meta device (shapes and dtypes, no
        storage)."""
        return train_model(self.cfg).init_params(self.cfg, None, "meta")

    def spec(self, path: tuple[str, ...]) -> Spec:
        spec = self.specs
        for k in path:
            spec = spec[k]
        return spec

    def blocks(self, path: tuple[str, ...], shape) -> tuple[Block, ...]:
        """The leaf's (tensor, fsdp, expert, pipe) blocks (``axis`` None
        where its spec does not cut that axis)."""
        spec, shape = self.spec(path), tuple(shape)
        return (rank_block(spec, shape, self.rank, self.world,
                           unit=head_unit(path, self.cfg.head_dim)),
                rank_block(spec, shape, self.fsdp_rank, self.fsdp, axis_name=AXIS_FSDP),
                rank_block(spec, shape, self.expert_rank, self.expert, axis_name=AXIS_EXPERT),
                rank_block(spec, shape, self.pipe_rank, self.pipe, axis_name=AXIS_PIPE))

    def regions(self, path: tuple[str, ...], shape) -> tuple[tuple[int, int, int], ...]:
        """``(axis, lo, hi)`` of each cut axis: this rank's block of a full
        leaf of ``shape`` (empty: the whole leaf)."""
        return tuple((b.axis, b.lo, b.hi) for b in self.blocks(path, shape)
                     if b.axis is not None and (b.lo, b.hi) != (0, shape[b.axis]))

    def local_shape(self, path: tuple[str, ...], shape) -> tuple[int, ...]:
        out = list(shape)
        for axis, lo, hi in self.regions(path, shape):
            out[axis] = hi - lo
        return tuple(out)

    def cut(self, path: tuple[str, ...], x):
        """This rank's block of the full leaf ``x``, a contiguous copy that
        holds no reference to ``x`` (``x`` itself when no axis cuts it)."""
        regions = self.regions(path, x.shape)
        if not regions:
            return x
        for axis, lo, hi in regions:
            x = x.narrow(axis, lo, hi - lo)
        return x.clone(memory_format=torch.contiguous_format)

    def gathered(self, path: tuple[str, ...]) -> bool:
        """Whether the leaf's spec cuts its ``fsdp`` axis: its block is
        gathered over ``fsdp`` where a layer runs, and its gradient
        reduce-scattered back."""
        return AXIS_FSDP in self.spec(path)

    def owned(self, path: tuple[str, ...], replica: int, seq_rank: int = 0) -> bool:
        """Whether the rank of data coordinate ``replica`` and seq
        coordinate ``seq_rank`` counts the leaf's block once in a global
        sum over every rank: it is the first of the ranks holding that
        block (coordinate 0 on every axis the spec does not cut: ``data``
        and ``seq`` always, ``fsdp``, ``expert``, ``pipe`` and ``tensor``
        where the leaf is replicated on them)."""
        spec = self.spec(path)
        return (replica == 0 and seq_rank == 0
                and (AXIS_FSDP in spec or self.fsdp_rank == 0)
                and (AXIS_EXPERT in spec or self.expert_rank == 0)
                and (AXIS_PIPE in spec or self.pipe_rank == 0)
                and (AXIS_TENSOR in spec or self.rank == 0))

    def state_bytes(self) -> int:
        """The bytes of the rank's train state: its params and the two
        moments (kept in the params' dtype), counted from the local shapes
        of ``cfg``'s meta tree (nothing allocated)."""
        from kukeon_tpu_torch.models.checkpoints import _walk_tree

        return 3 * sum(math.prod(self.local_shape(path, t.shape)) * t.element_size()
                       for path, t in _walk_tree(self.meta()))
