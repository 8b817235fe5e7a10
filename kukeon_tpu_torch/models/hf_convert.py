"""HuggingFace Llama and Mixtral checkpoints -> the port's parameter trees,
the port of ``kukeon_tpu/models/hf_convert.py``.

Reads ``*.safetensors`` shards (the HF hub layout: an index with its
shards, a single ``model.safetensors``, or one lone shard) with the port's
own reader (:mod:`kukeon_tpu_torch.models.checkpoints`), one tensor at a
time, and lays them out as :mod:`kukeon_tpu_torch.models.llama`'s stacked
tree of CPU tensors. HF Linear stores ``[out, in]`` and the port's
products take ``[in, out]``, so every matrix is transposed:

  model.embed_tokens.weight            [V, H]   -> embed [V, H]
  model.layers.N.input_layernorm       [H]      -> layers.attn_norm [L, H]
  model.layers.N.self_attn.{q,k,v,o}_proj       -> layers.w{q,k,v,o} (T)
  model.layers.N.post_attention_layernorm       -> layers.mlp_norm
  model.layers.N.mlp.{gate,up,down}_proj        -> layers.w_{gate,up,down} (T)
  model.norm.weight                    [H]      -> final_norm
  lm_head.weight                       [V, H]   -> lm_head [H, V] (T);
                                                   dropped when tied

Counterparts in the reference (``kukeon_tpu/models/hf_convert.py``):

  config_from_hf         :35
  _open_shards           :56
  load_params            :81
  moe_config_from_hf     :143
  load_moe_params        :169  (and its stream, ``stream_moe_params``)
  load_params_quantized  :253  (host quantization with ``llama.quantize_np``)
  _llama_hf_names, _check_mapped  :343-370
  stream_params          :394-473
  stream_params_quantized  :476-594

The mapping is written once, as one row per final leaf (``_llama_rows``).
The streams run one reader job a row, with an abstract tree from
``config.json`` alone and the tensor names checked against the shard
headers before any tensor byte is read. The materialized loaders drain the
same stream with one reader, so both give the same leaves bit for bit. The
MoE loader is materialized only, as in the reference.
"""

from __future__ import annotations

import dataclasses
import json
import os
import time

import numpy as np
import torch

from kukeon_tpu_torch.models.checkpoints import (
    CheckpointStream,
    TensorSpec,
    _ThreadReaders,
    drain,
    read_safetensors_header,
)
from kukeon_tpu_torch.models.llama import LlamaConfig, Params, quantize_np
from kukeon_tpu_torch.models.moe import MoEConfig


def config_from_hf(checkpoint_dir: str) -> LlamaConfig:
    with open(os.path.join(checkpoint_dir, "config.json")) as f:
        hf = json.load(f)
    head_dim = hf.get("head_dim") or (
        hf["hidden_size"] // hf["num_attention_heads"]
    )
    return LlamaConfig(
        vocab_size=hf["vocab_size"],
        hidden_size=hf["hidden_size"],
        intermediate_size=hf["intermediate_size"],
        num_layers=hf["num_hidden_layers"],
        num_heads=hf["num_attention_heads"],
        num_kv_heads=hf.get("num_key_value_heads", hf["num_attention_heads"]),
        head_dim=head_dim,
        rope_theta=hf.get("rope_theta", 500_000.0),
        rms_norm_eps=hf.get("rms_norm_eps", 1e-5),
        max_seq_len=hf.get("max_position_embeddings", 8192),
        tie_embeddings=hf.get("tie_word_embeddings", False),
    )


def _open_shards(checkpoint_dir: str) -> dict[str, str]:
    """tensor name -> shard path. Index, single-file and lone-shard layouts."""
    index_path = os.path.join(checkpoint_dir, "model.safetensors.index.json")
    if os.path.exists(index_path):
        with open(index_path) as f:
            index = json.load(f)
        return {
            name: os.path.join(checkpoint_dir, shard)
            for name, shard in index["weight_map"].items()
        }
    single = os.path.join(checkpoint_dir, "model.safetensors")
    if not os.path.exists(single):
        cands = [f for f in os.listdir(checkpoint_dir)
                 if f.endswith(".safetensors")]
        if len(cands) != 1:
            raise FileNotFoundError(
                f"no model.safetensors[.index.json] in {checkpoint_dir}"
            )
        single = os.path.join(checkpoint_dir, cands[0])
    return {name: single for name in read_safetensors_header(single)}


# --- the mapping, one row per final leaf ------------------------------------------
#
# A row is ``(path, spec, names, build)``: the leaf's path in the port's
# tree, its abstract spec (a TensorSpec, or a {"q", "s"} pair of them), the
# HF tensors it reads, and ``build(g)``, which makes the leaf from
# ``g.get(name)``. A stream runs one reader job a row; the materialized
# loaders drain a stream with one reader.

def _names(fmt: str, L: int) -> list[str]:
    """The HF tensors of a row: every layer's for a per-layer ``fmt``."""
    return [fmt.format(i) for i in range(L)] if "{}" in fmt else [fmt]


def _plain_row(path: tuple, fmt: str, shape: tuple, transpose: bool, L: int,
               dtype: torch.dtype) -> tuple:
    """A full-precision leaf: the tensor (a per-layer row stacks every
    layer's into a contiguous ``[L, ...]``), transposed if asked, then cast."""
    names = _names(fmt, L)

    def build(g) -> torch.Tensor:
        ts = [g.get(n).T if transpose else g.get(n) for n in names]
        return (torch.stack(ts) if "{}" in fmt else ts[0].contiguous()).to(dtype)

    return path, TensorSpec(shape, dtype), names, build


def _tensor(a: np.ndarray) -> torch.Tensor:
    """A host array as a contiguous CPU tensor (a transposed quantization
    comes out column-major, and the kernels want row-major leaves)."""
    return torch.from_numpy(np.ascontiguousarray(a))


def _f32(t: torch.Tensor) -> np.ndarray:
    """A stored tensor as f32 numpy, exactly (bf16 goes through torch:
    numpy has no bfloat16 of its own)."""
    return t.to(torch.float32).numpy()


def _int8_row(path: tuple, fmt: str, shape: tuple, transpose: bool, L: int) -> tuple:
    """An int8 {"q", "s"} leaf quantized on the host with
    :func:`~kukeon_tpu_torch.models.llama.quantize_np` (the reference's
    recipe): a transposed HF matrix per output channel on axis 0, the
    embedding per vocab row on axis 1. A per-layer row quantizes each
    layer, then stacks."""
    names = _names(fmt, L)
    axis = 0 if transpose else 1
    spec = {"q": TensorSpec(shape, torch.int8),
            "s": TensorSpec(shape[:-2] + shape[-1:] if transpose else shape[:-1],
                            torch.float32)}

    def build(g) -> dict[str, torch.Tensor]:
        leaves = [quantize_np(_f32(g.get(n)).T if transpose else _f32(g.get(n)), axis=axis)
                  for n in names]
        if "{}" not in fmt:
            return {k: _tensor(leaves[0][k]) for k in ("q", "s")}
        return {k: _tensor(np.stack([leaf[k] for leaf in leaves])) for k in ("q", "s")}

    return path, spec, names, build


def _llama_rows(cfg: LlamaConfig | MoEConfig, quantized: bool,
                mlp: list | None = None) -> list[tuple]:
    """The Llama mapping of the module docstring, in the tree's order.
    ``quantized``: every matrix an int8 leaf, the norms in the activation
    dtype. ``mlp``: rows in place of the MLP's three (Mixtral's)."""
    c, L, p = cfg, cfg.num_layers, "model.layers.{}."
    H, V, I = c.hidden_size, c.vocab_size, c.intermediate_size

    def path(name: str, fmt: str) -> tuple:
        return ("layers", name) if "{}" in fmt else (name,)

    def matrix(name: str, fmt: str, shape: tuple, transpose: bool = True) -> tuple:
        if quantized:
            return _int8_row(path(name, fmt), fmt, shape, transpose, L)
        return _plain_row(path(name, fmt), fmt, shape, transpose, L, c.dtype)

    def norm(name: str, fmt: str, shape: tuple) -> tuple:
        return _plain_row(path(name, fmt), fmt, shape, False, L, c.dtype)

    rows = [matrix("embed", "model.embed_tokens.weight", (V, H), transpose=False),
            norm("attn_norm", p + "input_layernorm.weight", (L, H)),
            matrix("wq", p + "self_attn.q_proj.weight", (L, H, c.q_dim)),
            matrix("wk", p + "self_attn.k_proj.weight", (L, H, c.kv_dim)),
            matrix("wv", p + "self_attn.v_proj.weight", (L, H, c.kv_dim)),
            matrix("wo", p + "self_attn.o_proj.weight", (L, c.q_dim, H)),
            norm("mlp_norm", p + "post_attention_layernorm.weight", (L, H))]
    rows += mlp if mlp is not None else [
        matrix("w_gate", p + "mlp.gate_proj.weight", (L, H, I)),
        matrix("w_up", p + "mlp.up_proj.weight", (L, H, I)),
        matrix("w_down", p + "mlp.down_proj.weight", (L, I, H))]
    rows.append(norm("final_norm", "model.norm.weight", (H,)))
    if not c.tie_embeddings:
        rows.append(matrix("lm_head", "lm_head.weight", (H, V)))
    return rows


def _check_mapped(where: dict[str, str], rows: list[tuple], materialized: bool) -> None:
    """The tensor names against the mapping, from the headers alone. A
    tied checkpoint may still ship ``lm_head.weight``, which is dropped.
    The materialized loaders fail on a missing tensor as the reference's
    do, with the ``KeyError`` of the first one they would read."""
    names = [n for row in rows for n in row[2]]
    missing = [n for n in names if n not in where]
    if missing and materialized:
        raise KeyError(missing[0])
    unmapped = sorted(set(where) - set(names) - {"lm_head.weight"})
    if unmapped:
        raise ValueError(f"unmapped tensors in checkpoint: {unmapped[:5]}")
    if missing:
        raise ValueError(f"missing tensors in checkpoint: {sorted(missing)[:5]}")


class _TimedReads:
    """``get(name)`` through ``readers``, summing the seconds spent reading
    (a job's disk time; the rest of the job is its cast time)."""

    def __init__(self, readers: _ThreadReaders):
        self._readers = readers
        self.seconds = 0.0

    def get(self, name: str) -> torch.Tensor:
        t0 = time.monotonic()
        out = self._readers.get(name)
        self.seconds += time.monotonic() - t0
        return out


def _stream(checkpoint_dir: str, cfg, rows: list[tuple], *, threads: int, buffer: int,
            materialized: bool = False) -> CheckpointStream:
    """A stream with one reader job a row; its abstract tree is the rows'
    specs, so no tensor byte is read before the first job."""
    where = _open_shards(checkpoint_dir)
    _check_mapped(where, rows, materialized)
    readers = _ThreadReaders(where)
    abstract: dict = {}
    for path, spec, _, _ in rows:
        node = abstract
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = spec

    def make_job(path: tuple[str, ...], build):
        def job():
            reads = _TimedReads(readers)
            t0 = time.monotonic()
            leaf = build(reads)
            total = time.monotonic() - t0
            pairs = ([(path + (k,), leaf[k]) for k in ("q", "s")] if isinstance(leaf, dict)
                     else [(path, leaf)])
            return pairs, reads.seconds, total - reads.seconds
        return job

    return CheckpointStream(abstract, cfg, [make_job(path, build) for path, _, _, build in rows],
                            threads=threads, buffer=buffer, finalize=readers.close_local)


def _loaded(checkpoint_dir: str, cfg, rows: list[tuple]) -> Params:
    """The materialized loaders' tree: the rows' stream, one reader, drained."""
    return drain(_stream(checkpoint_dir, cfg, rows, threads=1, buffer=1, materialized=True))


def _int8_cfg(checkpoint_dir: str, cfg: LlamaConfig | None,
              dtype: torch.dtype | None) -> LlamaConfig:
    """The int8 loaders' config: ``dtype`` sets the activation and norm
    dtype (default: cfg's, or bfloat16 when cfg comes from config.json)."""
    if cfg is None:
        return dataclasses.replace(config_from_hf(checkpoint_dir), dtype=dtype or torch.bfloat16)
    return cfg if dtype is None else dataclasses.replace(cfg, dtype=dtype)


# --- Llama ----------------------------------------------------------------------

def load_params(checkpoint_dir: str, cfg: LlamaConfig | None = None,
                dtype: torch.dtype = torch.bfloat16) -> tuple[Params, LlamaConfig]:
    """An HF Llama checkpoint directory -> (params, cfg), CPU tensors in
    ``dtype``, stacked along the layer axis (each leaf stacked in the
    file's dtype, then cast)."""
    cfg = dataclasses.replace(cfg or config_from_hf(checkpoint_dir), dtype=dtype)
    return _loaded(checkpoint_dir, cfg, _llama_rows(cfg, False)), cfg


def load_params_quantized(checkpoint_dir: str,
                          cfg: LlamaConfig | None = None,
                          dtype: torch.dtype | None = None) -> tuple[Params, LlamaConfig]:
    """An HF Llama checkpoint straight into the int8 tree ({"q", "s"}
    leaves), quantized on the host one leaf at a time: the full-precision
    tree is never materialized, and the peak beyond the int8 tree is one
    leaf's f32 tensors. ``dtype`` sets the activation and norm dtype
    (default: cfg's, or bfloat16 when cfg comes from config.json)."""
    cfg = _int8_cfg(checkpoint_dir, cfg, dtype)
    return _loaded(checkpoint_dir, cfg, _llama_rows(cfg, True)), cfg


def stream_params(checkpoint_dir: str, cfg: LlamaConfig | None = None,
                  dtype: torch.dtype = torch.bfloat16, *, threads: int = 2,
                  buffer: int = 4) -> CheckpointStream:
    """The streamed twin of :func:`load_params`: a :class:`CheckpointStream`
    whose abstract tree comes from the config alone, one reader job per
    final leaf (a stacked leaf's job reads its L tensors, transposes,
    stacks and casts)."""
    cfg = dataclasses.replace(cfg or config_from_hf(checkpoint_dir), dtype=dtype)
    return _stream(checkpoint_dir, cfg, _llama_rows(cfg, False), threads=threads, buffer=buffer)


def stream_params_quantized(checkpoint_dir: str, cfg: LlamaConfig | None = None,
                            dtype: torch.dtype | None = None, *, threads: int = 2,
                            buffer: int = 4) -> CheckpointStream:
    """The streamed twin of :func:`load_params_quantized`: quantized on the
    host as it loads, one reader job per final {"q", "s"} (or norm) leaf,
    so the transient host memory is about one f32 leaf a reader thread."""
    cfg = _int8_cfg(checkpoint_dir, cfg, dtype)
    return _stream(checkpoint_dir, cfg, _llama_rows(cfg, True), threads=threads, buffer=buffer)


# --- Mixtral (sparse MoE) -----------------------------------------------------

def moe_config_from_hf(checkpoint_dir: str) -> MoEConfig:
    """config.json (MixtralForCausalLM layout) -> MoEConfig."""
    with open(os.path.join(checkpoint_dir, "config.json")) as f:
        hf = json.load(f)
    head_dim = hf.get("head_dim") or (
        hf["hidden_size"] // hf["num_attention_heads"]
    )
    return MoEConfig(
        vocab_size=hf["vocab_size"],
        hidden_size=hf["hidden_size"],
        intermediate_size=hf["intermediate_size"],
        num_layers=hf["num_hidden_layers"],
        num_heads=hf["num_attention_heads"],
        num_kv_heads=hf.get("num_key_value_heads", hf["num_attention_heads"]),
        head_dim=head_dim,
        num_experts=hf.get("num_local_experts", 8),
        experts_per_token=hf.get("num_experts_per_tok", 2),
        rope_theta=hf.get("rope_theta", 1_000_000.0),
        rms_norm_eps=hf.get("rms_norm_eps", 1e-5),
        max_seq_len=hf.get("max_position_embeddings", 8192),
        tie_embeddings=hf.get("tie_word_embeddings", False),
    )


def load_moe_params(checkpoint_dir: str, cfg: MoEConfig | None = None,
                    dtype: torch.dtype = torch.bfloat16) -> tuple[Params, MoEConfig]:
    """HF Mixtral checkpoint -> (MoE params, MoEConfig), CPU tensors.

      model.layers.N.block_sparse_moe.gate.weight   [E, H] -> router [L, H, E] (f32)
      ...experts.E.w1.weight [I, H] -> w_gate [L, E, H, I]  (T per expert)
      ...experts.E.w3.weight [I, H] -> w_up   [L, E, H, I]
      ...experts.E.w2.weight [H, I] -> w_down [L, E, I, H]

    Attention, norms and embedding map as in Llama (the same rows). The
    router stays f32, so routing does not wobble with the activation dtype.
    """
    cfg = dataclasses.replace(cfg or moe_config_from_hf(checkpoint_dir), dtype=dtype)
    return _loaded(checkpoint_dir, cfg, _moe_rows(cfg)), cfg


def stream_moe_params(checkpoint_dir: str, cfg: MoEConfig | None = None,
                      dtype: torch.dtype = torch.bfloat16) -> CheckpointStream:
    """:func:`load_moe_params`' leaves as a stream, one leaf at a time (one
    reader, a buffer of one: an expert stack of Mixtral-8x7B is 30 GB in
    bf16): what a tensor-parallel rank's recipe cuts its slices from."""
    cfg = dataclasses.replace(cfg or moe_config_from_hf(checkpoint_dir), dtype=dtype)
    return _stream(checkpoint_dir, cfg, _moe_rows(cfg), threads=1, buffer=1, materialized=True)


def _moe_rows(cfg: MoEConfig) -> list[tuple]:
    """The Mixtral mapping: Llama's rows with the router and the three
    expert stacks in place of the MLP's."""
    L, E, H, I = cfg.num_layers, cfg.num_experts, cfg.hidden_size, cfg.intermediate_size
    dtype = cfg.dtype

    def experts(name: str, w: str, shape: tuple) -> tuple:
        names = [f"model.layers.{i}.block_sparse_moe.experts.{e}.{w}.weight"
                 for i in range(L) for e in range(E)]

        def build(g) -> torch.Tensor:
            return torch.stack([torch.stack([g.get(names[i * E + e]).T for e in range(E)])
                                for i in range(L)]).to(dtype)

        return ("layers", name), TensorSpec(shape, dtype), names, build

    return _llama_rows(cfg, False, mlp=[
        _plain_row(("layers", "router"), "model.layers.{}.block_sparse_moe.gate.weight",
                   (L, H, E), True, L, torch.float32),
        experts("w_gate", "w1", (L, E, H, I)),
        experts("w_up", "w3", (L, E, H, I)),
        experts("w_down", "w2", (L, E, I, H))])

