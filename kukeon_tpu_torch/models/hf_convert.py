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
  load_moe_params        :169
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

A tensor-parallel rank's streams (``stream_params(rank=, world=)``, and
the quantized one) and its Mixtral reader (:func:`moe_rank_leaves`) read
only that rank's rows or columns of each HF matrix (:class:`_Slicer`), so
its host holds its slices and a staging block; its leaves equal the cut
of the one-device leaves bit for bit, int8 scales included.
"""

from __future__ import annotations

import dataclasses
import json
import os
import time

import numpy as np
import torch

from kukeon_tpu_torch.models import checkpoints
from kukeon_tpu_torch.models.checkpoints import (
    CheckpointStream,
    HostMeter,
    STREAM_BUFFER_BYTES,
    JobPeak,
    TensorSpec,
    _ThreadReaders,
    drain,
    read_safetensors_header,
)
from kukeon_tpu_torch.models.llama import LlamaConfig, Params, _int8_sym, quantize_np
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


class _Slicer:
    """A tensor-parallel rank's reads (``parallel.sharding.Layout``): each
    row's leaf built from the rank's rows of each HF matrix, read in staging
    blocks of ``checkpoints.STAGE_BYTES`` (``SafetensorsReader.row_blocks``),
    never a full matrix at once. An HF matrix is ``[out, in]``: a column-parallel
    leaf (its ``out`` cut, and the embedding's vocabulary) is a block of
    rows; a row-parallel one (``wo``, ``w_down``: ``in`` cut) a strided
    block of columns, read as whole rows, whose int8 scale, per output over
    all of ``in``, each whole row gives: so a rank's ``q`` and ``s`` are the
    cut of the one-device quantization bit for bit, with no collective.
    ``peak``: the most a job declared at once (its leaf and its staging;
    ``HostMeter``)."""

    def __init__(self, layout, cast: torch.dtype | None = None):
        self.layout = layout
        # Under int8, the dtype a matrix is cast to before it is quantized
        # (Mixtral's one-device load quantizes its cast tree).
        self.cast = cast
        self.peak = JobPeak()

    def matrix(self, path: tuple, fmt: str, shape: tuple, transpose: bool, L: int,
               dtype: torch.dtype | None) -> tuple:
        """The row of a matrix leaf of full port ``shape``: int8 ``{"q",
        "s"}`` when ``dtype`` is None (quantized as :func:`_int8_row`),
        else ``dtype`` (as :func:`_plain_row`)."""
        names = _names(fmt, L)
        stacked = "{}" in fmt
        quantized = dtype is None
        s_shape = shape[:-2] + shape[-1:] if transpose else shape[:-1]
        qb = self.layout.block(path + (("q",) if quantized else ()), shape)
        q_spec = TensorSpec(qb.local_shape(shape), torch.int8 if quantized else dtype)
        spec = q_spec
        if quantized:
            sb = self.layout.block(path + ("s",), s_shape)
            spec = {"q": q_spec, "s": TensorSpec(sb.local_shape(s_shape), torch.float32)}
        # The cut of one layer's port matrix: 0 its rows (in; the
        # embedding's vocabulary), 1 its columns (out), None none.
        cut = None if qb.axis is None else qb.axis - stacked
        slicer = self

        def build(g):
            meter = HostMeter()
            q = torch.zeros(q_spec.shape, dtype=q_spec.dtype)
            meter.hold(q_spec.nbytes)
            s = None
            if quantized:
                s = torch.zeros(spec["s"].shape, dtype=torch.float32)
                meter.hold(spec["s"].nbytes)
                if sb.fill:
                    s.narrow(sb.axis, sb.rows, sb.size - sb.rows).fill_(sb.fill)
            for i, name in enumerate(names):
                slicer._layer(g, name, q[i] if stacked else q,
                              (s[i] if stacked else s) if quantized else None,
                              transpose, cut, qb, meter)
            slicer.peak.note(meter)
            return {"q": q, "s": s} if quantized else q

        return path, spec, names, build

    def _layer(self, g, name: str, q: torch.Tensor, s: torch.Tensor | None, transpose: bool,
               cut: int | None, qb, meter: HostMeter) -> None:
        """One HF matrix's share into ``q`` (and ``s``): its rows ``[r_lo,
        r_hi)`` (the port's output block, or all), whole, in staging blocks;
        of each, the port's input block ``[c_lo, c_hi)``."""
        spec = g.spec(name)
        rows_out = (transpose and cut == 1) or (not transpose and cut == 0)
        r_lo, r_hi = (qb.lo, qb.hi) if rows_out else (0, spec.shape[0])
        c_lo, c_hi = (qb.lo, qb.hi) if transpose and cut == 0 else (0, spec.shape[1])
        if transpose and cut == 0:
            # A row-parallel block's real rows (a padded block's zeros after).
            q = q.narrow(0, 0, c_hi - c_lo)
        # Staging: the raw block and its f32 (or cast) copy within STAGE_BYTES.
        item = spec.dtype.itemsize
        stage = checkpoints.STAGE_BYTES * item // (item + 4)
        for r0, rows in g.row_blocks(name, r_lo, r_hi, stage_bytes=stage, meter=meter):
            at = r0 - r_lo
            n = rows.shape[0]
            extra = rows.numel() * 4
            meter.hold(extra)
            if s is not None:
                # Each whole row's max (every output's scale), the quotient
                # on this rank's columns.
                qs = quantize_np(_f32(rows if self.cast is None else rows.to(self.cast)), 1,
                                 part=(c_lo, c_hi))
                q_rows = torch.from_numpy(qs["q"])
                if transpose:
                    q[:, at:at + n] = q_rows.T
                else:
                    q[at:at + n] = q_rows
                s[at:at + n] = torch.from_numpy(qs["s"])
                del qs, q_rows
            elif transpose:
                q[:, at:at + n] = rows[:, c_lo:c_hi].T.to(q.dtype)
            else:
                q[at:at + n] = rows.to(q.dtype)
            meter.free(extra)

    def norm(self, path: tuple, fmt: str, shape: tuple, L: int, dtype: torch.dtype,
             transpose: bool = False) -> tuple:
        """A replicated leaf (a norm, the router): :func:`_plain_row`'s,
        its bytes noted."""
        path, spec, names, build = _plain_row(path, fmt, shape, transpose, L, dtype)

        def noted(g):
            out = build(g)
            meter = HostMeter()
            meter.hold(out.numel() * out.element_size())
            self.peak.note(meter)
            return out

        return path, spec, names, noted


def _llama_rows(cfg: LlamaConfig | MoEConfig, quantized: bool,
                mlp: list | None = None, slicer: _Slicer | None = None) -> list[tuple]:
    """The Llama mapping of the module docstring, in the tree's order.
    ``quantized``: every matrix an int8 leaf, the norms in the activation
    dtype. ``mlp``: rows in place of the MLP's three (Mixtral's).
    ``slicer``: a rank's rows, each leaf that rank's block."""
    c, L, p = cfg, cfg.num_layers, "model.layers.{}."
    H, V, I = c.hidden_size, c.vocab_size, c.intermediate_size

    def path(name: str, fmt: str) -> tuple:
        return ("layers", name) if "{}" in fmt else (name,)

    def matrix(name: str, fmt: str, shape: tuple, transpose: bool = True) -> tuple:
        if slicer is not None:
            return slicer.matrix(path(name, fmt), fmt, shape, transpose, L,
                                 None if quantized else c.dtype)
        if quantized:
            return _int8_row(path(name, fmt), fmt, shape, transpose, L)
        return _plain_row(path(name, fmt), fmt, shape, transpose, L, c.dtype)

    def norm(name: str, fmt: str, shape: tuple) -> tuple:
        if slicer is not None:
            return slicer.norm(path(name, fmt), fmt, shape, L, c.dtype)
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

    def spec(self, name: str) -> TensorSpec:
        return self._readers.reader(name).spec(name)

    def row_blocks(self, name: str, lo: int, hi: int, **kw):
        """:meth:`SafetensorsReader.row_blocks` of ``name``, each block's
        read timed."""
        blocks = self._readers.reader(name).row_blocks(name, lo, hi, **kw)
        while True:
            t0 = time.monotonic()
            try:
                item = next(blocks)
            except StopIteration:
                return
            finally:
                self.seconds += time.monotonic() - t0
            yield item


def _stream(checkpoint_dir: str, cfg, rows: list[tuple], *, threads: int, buffer_bytes: int,
            materialized: bool = False, slicer: _Slicer | None = None,
            full_rows: list[tuple] | None = None) -> CheckpointStream:
    """A stream with one reader job a row; its abstract tree is the rows'
    specs, so no tensor byte is read before the first job. With
    ``slicer`` (a rank's rows), its ``bytes`` count the full leaves' bytes
    (the one-device ``full_rows``'), ``read_bytes`` what was requested from disk, and
    ``job_peak_bytes`` the slicer's peak."""
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

    count = extra = None
    if slicer is not None:
        full = _full_bytes(full_rows)
        count = lambda p, t: full[p]                                   # noqa: E731
        extra = lambda: {"read_bytes": readers.bytes_read(),                  # noqa: E731
                         "job_peak_bytes": slicer.peak.bytes}
    return CheckpointStream(abstract, cfg, [make_job(path, build) for path, _, _, build in rows],
                            threads=threads, buffer_bytes=buffer_bytes,
                            finalize=readers.close_local, count=count, extra_stats=extra)


def _full_bytes(rows: list[tuple]) -> dict[tuple, int]:
    """Each leaf path's bytes in the one-device ``rows``: what a rank's
    slice of it counts, the leaf the reference loads."""
    out = {}
    for path, spec, _, _ in rows:
        if isinstance(spec, dict):
            out.update({path + (k,): v.nbytes for k, v in spec.items()})
        else:
            out[path] = spec.nbytes
    return out


def _loaded(checkpoint_dir: str, cfg, rows: list[tuple]) -> Params:
    """The materialized loaders' tree: the rows' stream, one reader, drained."""
    return drain(_stream(checkpoint_dir, cfg, rows, threads=1, buffer_bytes=0,
                         materialized=True))


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
                  buffer_bytes: int = STREAM_BUFFER_BYTES, rank: int = 0,
                  world: int | None = None, kv_shard: bool = True) -> CheckpointStream:
    """The streamed twin of :func:`load_params`: a :class:`CheckpointStream`
    whose abstract tree comes from the config alone, one reader job per
    final leaf (a stacked leaf's job reads its L tensors, transposes,
    stacks and casts). With ``world``, rank ``rank``'s stream: each leaf
    that rank's block (:class:`_Slicer`), the abstract tree
    ``sharding.local_meta``'s."""
    cfg = dataclasses.replace(cfg or config_from_hf(checkpoint_dir), dtype=dtype)
    return _rank_stream(checkpoint_dir, cfg, False, threads, buffer_bytes, rank, world,
                        kv_shard)


def stream_params_quantized(checkpoint_dir: str, cfg: LlamaConfig | None = None,
                            dtype: torch.dtype | None = None, *, threads: int = 2,
                            buffer_bytes: int = STREAM_BUFFER_BYTES, rank: int = 0,
                            world: int | None = None, kv_shard: bool = True
                            ) -> CheckpointStream:
    """The streamed twin of :func:`load_params_quantized`: quantized on the
    host as it loads, one reader job per final {"q", "s"} (or norm) leaf,
    so the transient host memory is about one f32 leaf a reader thread.
    With ``world``, rank ``rank``'s stream, as :func:`stream_params`'s; a
    row-parallel leaf's scale still from its whole rows."""
    cfg = _int8_cfg(checkpoint_dir, cfg, dtype)
    return _rank_stream(checkpoint_dir, cfg, True, threads, buffer_bytes, rank, world,
                        kv_shard)


def _rank_stream(checkpoint_dir: str, cfg, quantized: bool, threads: int, buffer_bytes: int,
                 rank: int, world: int | None, kv_shard: bool) -> CheckpointStream:
    rows = _llama_rows(cfg, quantized)
    if world is None:
        return _stream(checkpoint_dir, cfg, rows, threads=threads, buffer_bytes=buffer_bytes)
    slicer = _Slicer(_layout(cfg, rank, world, kv_shard))
    return _stream(checkpoint_dir, cfg, _llama_rows(cfg, quantized, slicer=slicer),
                   threads=threads, buffer_bytes=buffer_bytes, slicer=slicer, full_rows=rows)


def _layout(cfg, rank: int, world: int, kv_shard: bool):
    from kukeon_tpu_torch.parallel.sharding import Layout

    return Layout(cfg, rank, world, kv_shard)


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


def moe_rank_leaves(checkpoint_dir: str, cfg: MoEConfig, *, rank: int, world: int,
                    kv_shard: bool, device: torch.device | str, quantize: bool,
                    peak: JobPeak | None = None):
    """Rank ``rank``'s blocks of an HF Mixtral checkpoint (``cfg``'s
    activation dtype; int8 when ``quantize``), ``(path, tensor on
    device)`` one leaf at a time: the cut of :func:`load_moe_params` (then
    ``moe.quantize_params``) bit for bit. The trunk through
    :class:`_Slicer` (cast, then quantized on the host, as the one-device
    load does); each expert matrix's rows (``w1``, ``w3``) or columns
    (``w2``, whose scale its whole rows give) read in staging blocks, moved
    to ``device``, cast and quantized there into the rank's stacked leaf,
    so the host holds one staging block of an expert, never a stack.
    ``peak`` (when given) notes the most a leaf's read held on the host at
    once."""
    where = _open_shards(checkpoint_dir)
    _check_mapped(where, _moe_rows(cfg), True)
    L, E, H, I = cfg.num_layers, cfg.num_experts, cfg.hidden_size, cfg.intermediate_size
    layout = _layout(cfg, rank, world, kv_shard)
    slicer = _Slicer(layout, cast=cfg.dtype if quantize else None)
    if peak is not None:
        slicer.peak = peak
    readers = _ThreadReaders(where)
    g = _TimedReads(readers)
    router = slicer.norm(("layers", "router"), "model.layers.{}.block_sparse_moe.gate.weight",
                         (L, H, E), L, torch.float32, transpose=True)
    try:
        for path, _, _, build in _llama_rows(cfg, quantize, mlp=[router], slicer=slicer):
            leaf = build(g)
            for p, t in ([(path + (k,), leaf[k]) for k in ("q", "s")] if isinstance(leaf, dict)
                         else [(path, leaf)]):
                yield p, t.to(device)
            del leaf
        for name, w, shape in (("w_gate", "w1", (L, E, H, I)), ("w_up", "w3", (L, E, H, I)),
                               ("w_down", "w2", (L, E, I, H))):
            fmt = "model.layers.{}.block_sparse_moe.experts.{}." + w + ".weight"
            yield from _expert_slices(readers, fmt, ("layers", name), shape, layout, slicer,
                                      device, cfg.dtype, quantize)
    finally:
        readers.close_local()


def _expert_slices(readers: _ThreadReaders, fmt: str, path: tuple, shape: tuple, layout,
                   slicer: _Slicer, device, dtype: torch.dtype, quantize: bool):
    """A rank's block of one expert stack ``[L, E, in, out]`` on ``device``
    (:func:`moe_rank_leaves`), one HF matrix at a time."""
    L, E = shape[:2]
    qb = layout.block(path + (("q",) if quantize else ()), shape)
    local = qb.local_shape(shape)
    cut = None if qb.axis is None else qb.axis - 2
    q = torch.empty(local, dtype=torch.int8 if quantize else dtype, device=device)
    s = (torch.empty((L, E, local[3]), dtype=torch.float32, device=device) if quantize
         else None)
    meter = HostMeter()
    for i in range(L):
        for e in range(E):
            name = fmt.format(i, e)
            reader = readers.reader(name)
            rows_n, cols_n = reader.spec(name).shape
            r_lo, r_hi = (qb.lo, qb.hi) if cut == 1 else (0, rows_n)
            c_lo, c_hi = (qb.lo, qb.hi) if cut == 0 else (0, cols_n)
            for r0, rows in reader.row_blocks(name, r_lo, r_hi, meter=meter):
                at, n = r0 - r_lo, rows.shape[0]
                wt = rows.to(device).to(dtype).T          # [in, n], as the one-device leaf
                if quantize:
                    qw, sw = _int8_sym(wt, 0)
                    q[i, e, :, at:at + n] = qw[c_lo:c_hi]
                    s[i, e, at:at + n] = sw[0]
                else:
                    q[i, e, :, at:at + n] = wt[c_lo:c_hi]
    slicer.peak.note(meter)
    if quantize:
        yield path + ("q",), q
        yield path + ("s",), s
    else:
        yield path, q


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

