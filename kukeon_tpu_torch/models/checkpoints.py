"""Checkpoint tooling, the port of ``kukeon_tpu/models/checkpoints.py``:
synthesize HF-layout checkpoints, and save and load the kukeon int8
quantized format.

Safetensors files are read and written here with torch and numpy alone:
the format is an 8-byte little-endian header length, a JSON header (each
tensor's dtype, shape and ``data_offsets`` into the data that follows, and
an optional ``__metadata__``), then the tensors' raw row-major bytes. So
the port needs neither the ``safetensors`` package nor a numpy bfloat16
dtype (BF16 goes through torch). :class:`SafetensorsReader` reads one
named tensor at a time into a fresh CPU tensor; :func:`save_safetensors`
writes files the ``safetensors`` package reads.

Counterparts in the reference (``kukeon_tpu/models/checkpoints.py``):

  QUANT_MANIFEST                 :40
  _CFG_FIELDS, _cfg_to_json,
  _cfg_from_json                 :42-54
  write_hf_config                :59
  write_tokenizer_json           :78
  synthesize_hf_checkpoint       :102  (the same draws, in the same order)
  _flatten_quant, _unflatten_quant  :200-226
  save_quantized                 :229
  is_quantized_checkpoint        :248
  load_quantized                 :252
  CheckpointStreamError          :283
  TensorSpec                     :290
  _ST_DTYPES                     :320  (torch dtypes here)
  read_safetensors_header        :327
  _walk_tree                     :343
  CheckpointStream               :353-455
  _timed_get                     :458
  stream_quantized               :464-516

:func:`drain` reads a stream to its end into a tree; ``load_quantized``
is :func:`stream_quantized` drained with one reader. A tensor-parallel
rank's stream (``stream_quantized(rank=, world=)``) reads only that rank's
block of each leaf (:meth:`SafetensorsReader.read_block`: a run a read, a
column range as whole rows in staging blocks of :data:`STAGE_BYTES`), and
:class:`HostMeter` counts what a reader job holds at once.

Loaders return trees of CPU tensors in the reference's layout (stacked
``[L, ...]`` leaves, int8 matrices as ``{"q", "s"}``); the serving cell
moves them to its device. The streamed boot's :class:`CheckpointStream`
hands the same leaves over one at a time, read by threads of its own, so
the engine can copy each to the card as it arrives while it captures its
programs from the abstract tree (``TensorSpec`` leaves, from headers and
configs alone).
"""

from __future__ import annotations

import dataclasses
import json
import os
import struct
import threading
import time
from collections import deque
from collections.abc import Callable, Iterator
from typing import Any

import numpy as np
import torch

from kukeon_tpu_torch import faults
from kukeon_tpu_torch.models.llama import LlamaConfig

QUANT_MANIFEST = "kukeon_quant.json"

_CFG_FIELDS = (
    "vocab_size", "hidden_size", "intermediate_size", "num_layers",
    "num_heads", "num_kv_heads", "head_dim", "rope_theta", "rms_norm_eps",
    "max_seq_len", "tie_embeddings",
)


def _cfg_to_json(cfg: LlamaConfig) -> dict:
    return {f: getattr(cfg, f) for f in _CFG_FIELDS}


def _cfg_from_json(d: dict) -> LlamaConfig:
    return LlamaConfig(**{f: d[f] for f in _CFG_FIELDS if f in d})


# --- safetensors I/O ----------------------------------------------------------

# safetensors header dtype strings -> torch dtypes.
_ST_DTYPES = {
    "F64": torch.float64, "F32": torch.float32, "F16": torch.float16,
    "BF16": torch.bfloat16, "I64": torch.int64, "I32": torch.int32,
    "I16": torch.int16, "I8": torch.int8, "U8": torch.uint8, "BOOL": torch.bool,
}
_ST_NAMES = {v: k for k, v in _ST_DTYPES.items()}


class TensorSpec:
    """Shape and dtype of one tensor, parsed from a safetensors header
    before any tensor byte is read."""

    __slots__ = ("shape", "dtype")

    def __init__(self, shape: tuple[int, ...], dtype: torch.dtype) -> None:
        self.shape = tuple(int(d) for d in shape)
        self.dtype = dtype

    @property
    def ndim(self) -> int:
        return len(self.shape)

    @property
    def nbytes(self) -> int:
        return self.dtype.itemsize * int(np.prod(self.shape, dtype=np.int64))

    def __repr__(self) -> str:
        return f"TensorSpec(shape={self.shape}, dtype={self.dtype})"


def _read_header(f) -> tuple[dict, int]:
    """(the JSON header without ``__metadata__``, the file offset where the
    data begins) of an open safetensors file."""
    (n,) = struct.unpack("<Q", f.read(8))
    header = json.loads(f.read(n))
    header.pop("__metadata__", None)
    return header, 8 + n


def read_safetensors_header(path: str) -> dict[str, TensorSpec]:
    """tensor name -> TensorSpec from a safetensors file's JSON header: the
    8-byte length prefix and the header itself, no tensor byte."""
    with open(path, "rb") as f:
        header, _ = _read_header(f)
    return {name: TensorSpec(meta["shape"], _ST_DTYPES[meta["dtype"]])
            for name, meta in header.items()}


class HostMeter:
    """The host bytes a reader job declares it holds in its buffers at once
    (the slice it builds and its staging blocks), and their peak. A count
    of those buffers, not of the process's memory: the temporaries of a
    cast or a quotient, the stream's queued leaves and its threads are not
    in it."""

    def __init__(self) -> None:
        self.live = 0
        self.peak = 0

    def hold(self, nbytes: int) -> None:
        self.live += nbytes
        self.peak = max(self.peak, self.live)

    def free(self, nbytes: int) -> None:
        self.live -= nbytes


class JobPeak:
    """The most any one reader job held at once (its :class:`HostMeter`'s
    peak), over a stream's threads: a rank stream's ``job_peak_bytes``."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self.bytes = 0

    def note(self, meter: HostMeter) -> None:
        with self._lock:
            self.bytes = max(self.bytes, meter.peak)

# The rows a slice reader takes from disk at once, at most this many bytes:
# a rank's staging block (a column range is read as whole rows).
STAGE_BYTES = 16 << 20


class SafetensorsReader:
    """One safetensors file opened for reading tensor by tensor (the port's
    ``safe_open``): :meth:`get_tensor` seeks to the tensor's data and reads
    it into a fresh CPU tensor, so no more than that tensor is held. A
    rank's slice reads: :meth:`row_blocks` (a row range, in blocks of
    bounded bytes through one staging buffer) and :meth:`read_block` (a
    block along any axis). ``bytes_read`` sums the bytes requested."""

    def __init__(self, path: str):
        self.path = path
        self.bytes_read = 0
        self._f = open(path, "rb")
        try:
            self._header, self._base = _read_header(self._f)
        except BaseException:
            self._f.close()
            raise

    def keys(self) -> list[str]:
        return list(self._header)

    def spec(self, name: str) -> TensorSpec:
        """``name``'s shape and dtype, its byte count checked against its
        offsets."""
        meta = self._header[name]
        spec = TensorSpec(meta["shape"], _ST_DTYPES[meta["dtype"]])
        start, end = meta["data_offsets"]
        if end - start != spec.nbytes:
            raise ValueError(f"{self.path}: tensor {name!r} holds {end - start} bytes, "
                             f"its dtype and shape {meta['dtype']} {list(spec.shape)} need "
                             f"{spec.nbytes}")
        return spec

    def _read_at(self, name: str, offset: int, out: torch.Tensor) -> None:
        """``out``'s bytes from ``offset`` bytes into ``name``'s data."""
        view = memoryview(out.reshape(-1).view(torch.uint8).numpy())
        self._f.seek(self._base + self._header[name]["data_offsets"][0] + offset)
        got = 0
        while got < len(view):
            n = self._f.readinto(view[got:])
            if not n:
                raise ValueError(f"{self.path}: tensor {name!r} is cut short "
                                 f"({got} of {len(view)} bytes at {offset})")
            got += n
        self.bytes_read += got

    def get_tensor(self, name: str) -> torch.Tensor:
        spec = self.spec(name)
        out = torch.empty(spec.shape, dtype=spec.dtype)
        self._read_at(name, 0, out)
        return out

    def row_blocks(self, name: str, lo: int, hi: int, *, width: int | None = None,
                   stage_bytes: int | None = None,
                   meter: HostMeter | None = None) -> Iterator[tuple[int, torch.Tensor]]:
        """Rows ``[lo, hi)`` of ``name``'s first axis (of ``name`` seen as
        rows of ``width`` elements, when given) as ``(first row, rows)``
        blocks of at most ``stage_bytes`` (default :data:`STAGE_BYTES`; one
        row at least), each one read into the same staging buffer: a block
        is valid until the next is read."""
        spec = self.spec(name)
        row_shape = (width,) if width is not None else spec.shape[1:]
        row = spec.dtype.itemsize * int(np.prod(row_shape, dtype=np.int64))
        stage = STAGE_BYTES if stage_bytes is None else stage_bytes
        n = max(1, min(hi - lo, stage // max(1, row)))
        buf = torch.empty((n, *row_shape), dtype=spec.dtype)
        held = n * row
        if meter is not None:
            meter.hold(held)
        try:
            for r0 in range(lo, hi, n):
                part = buf[:min(n, hi - r0)]
                self._read_at(name, r0 * row, part)
                yield r0, part
        finally:
            if meter is not None:
                meter.free(held)

    def read_block(self, name: str, axis: int | None, lo: int, hi: int, *,
                   meter: HostMeter | None = None) -> torch.Tensor:
        """``name`` cut to ``[lo, hi)`` along ``axis`` (None: whole) into a
        fresh tensor. A block with contiguous runs is read a run at a time
        (one read per index of the axes before ``axis``); a range of the
        last axis of a tensor of more than one row is read as whole rows
        through :meth:`row_blocks`, never a read per row."""
        spec = self.spec(name)
        if axis is None:
            return self.get_tensor(name)
        shape = spec.shape
        outer = int(np.prod(shape[:axis], dtype=np.int64))
        inner = int(np.prod(shape[axis + 1:], dtype=np.int64))
        n = shape[axis]
        out = torch.empty((outer, hi - lo, inner), dtype=spec.dtype)
        if meter is not None:
            meter.hold(out.numel() * out.element_size())
        if inner > 1 or outer == 1:
            item = spec.dtype.itemsize
            for o in range(outer):
                self._read_at(name, (o * n + lo) * inner * item, out[o])
        else:
            flat = out[:, :, 0]
            for r0, rows in self.row_blocks(name, 0, outer, width=n, meter=meter):
                flat[r0:r0 + rows.shape[0]] = rows[:, lo:hi]
        return out.reshape(*shape[:axis], hi - lo, *shape[axis + 1:])

    def close(self) -> None:
        self._f.close()

    def __enter__(self) -> SafetensorsReader:
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def save_safetensors(tensors: dict[str, torch.Tensor], path: str) -> None:
    """Write ``tensors`` (CPU or device tensors) as one safetensors file:
    their bytes contiguous in the header's order, the header padded with
    spaces to a multiple of 8 bytes."""
    header, offset = {}, 0
    for name, t in tensors.items():
        nbytes = t.numel() * t.element_size()
        header[name] = {"dtype": _ST_NAMES[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + nbytes]}
        offset += nbytes
    blob = json.dumps(header, separators=(",", ":")).encode()
    blob += b" " * (-len(blob) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(blob)))
        f.write(blob)
        for t in tensors.values():
            flat = t.detach().to("cpu").contiguous().reshape(-1)
            f.write(memoryview(flat.view(torch.uint8).numpy()))


# --- HF-layout synthesis ------------------------------------------------------

def write_hf_config(path: str, cfg: LlamaConfig) -> None:
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump({
            "architectures": ["LlamaForCausalLM"],
            "vocab_size": cfg.vocab_size,
            "hidden_size": cfg.hidden_size,
            "intermediate_size": cfg.intermediate_size,
            "num_hidden_layers": cfg.num_layers,
            "num_attention_heads": cfg.num_heads,
            "num_key_value_heads": cfg.num_kv_heads,
            "head_dim": cfg.head_dim,
            "rope_theta": cfg.rope_theta,
            "rms_norm_eps": cfg.rms_norm_eps,
            "max_position_embeddings": cfg.max_seq_len,
            "tie_word_embeddings": cfg.tie_embeddings,
            "torch_dtype": "float16",
        }, f, indent=1)


def write_tokenizer_json(path: str) -> None:
    """A real (HF ``tokenizers``-format) byte-level BPE with Llama-3 special
    tokens: a small trained vocab, byte-complete, so any text round-trips
    through the same ``HFTokenizer`` path a downloaded tokenizer.json takes.
    Needs the ``tokenizers`` package (imported here, lazily)."""
    from tokenizers import Tokenizer, decoders, models, pre_tokenizers, trainers

    tk = Tokenizer(models.BPE(unk_token=None))
    tk.pre_tokenizer = pre_tokenizers.ByteLevel(add_prefix_space=False)
    tk.decoder = decoders.ByteLevel()
    trainer = trainers.BpeTrainer(
        vocab_size=2048,
        special_tokens=["<|begin_of_text|>", "<|end_of_text|>", "<|eot_id|>"],
        initial_alphabet=pre_tokenizers.ByteLevel.alphabet(),
    )
    corpus = [
        "def main(argv):\n    return run(argv)\n",
        "the quick brown fox jumps over the lazy dog",
        "kukeon serves agent sessions on gpu cells with scoped secrets",
        "import torch\nimport numpy as np\n",
    ] * 64
    tk.train_from_iterator(corpus, trainer)
    tk.save(os.path.join(path, "tokenizer.json"))


def synthesize_hf_checkpoint(
    path: str,
    cfg: LlamaConfig,
    *,
    seed: int = 0,
    dtype: torch.dtype = torch.float16,
    max_shard_bytes: int = 4 << 30,
    tokenizer: bool = True,
) -> str:
    """Write a random-weights checkpoint at ``cfg``'s shapes in the HF hub
    layout (sharded safetensors + index + config.json [+ tokenizer.json]).

    The reference's draws, in its order, from ``np.random.default_rng(seed)``
    (normal f32 times ``fan_in ** -0.5``, cast to ``dtype``; norms are ones),
    and its shard and rename scheme, so the tensors equal the reference's
    bit for bit. A shard is written once it would pass ``max_shard_bytes``,
    so at most one shard is held. Idempotent: returns at once if the
    directory already has a config and weights.
    """
    os.makedirs(path, exist_ok=True)
    if os.path.exists(os.path.join(path, "config.json")) and (
        os.path.exists(os.path.join(path, "model.safetensors.index.json"))
        or os.path.exists(os.path.join(path, "model.safetensors"))
    ):
        return path

    rng = np.random.default_rng(seed)
    c = cfg
    H, I, V = c.hidden_size, c.intermediate_size, c.vocab_size

    def tensor_specs():
        yield "model.embed_tokens.weight", (V, H), H
        for i in range(c.num_layers):
            p = f"model.layers.{i}."
            yield p + "input_layernorm.weight", (H,), None
            yield p + "self_attn.q_proj.weight", (c.q_dim, H), H
            yield p + "self_attn.k_proj.weight", (c.kv_dim, H), H
            yield p + "self_attn.v_proj.weight", (c.kv_dim, H), H
            yield p + "self_attn.o_proj.weight", (H, c.q_dim), c.q_dim
            yield p + "post_attention_layernorm.weight", (H,), None
            yield p + "mlp.gate_proj.weight", (I, H), H
            yield p + "mlp.up_proj.weight", (I, H), H
            yield p + "mlp.down_proj.weight", (H, I), I
        yield "model.norm.weight", (H,), None
        if not c.tie_embeddings:
            yield "lm_head.weight", (V, H), H

    def make(shape, fan_in) -> torch.Tensor:
        if fan_in is None:
            return torch.ones(shape, dtype=dtype)          # norm scales
        w = rng.standard_normal(shape, np.float32)
        w *= fan_in ** -0.5
        return torch.from_numpy(w).to(dtype)

    weight_map: dict[str, str] = {}
    shard: dict[str, torch.Tensor] = {}
    shard_bytes = 0
    shard_names: list[str] = []

    def flush():
        nonlocal shard, shard_bytes
        if not shard:
            return
        name = f"model-part-{len(shard_names):05d}.safetensors"
        save_safetensors(shard, os.path.join(path, name))
        shard_names.append(name)
        for n in shard:
            weight_map[n] = name
        shard = {}
        shard_bytes = 0

    for name, shape, fan_in in tensor_specs():
        t = make(shape, fan_in)
        nbytes = t.numel() * t.element_size()
        if shard_bytes + nbytes > max_shard_bytes:
            flush()
        shard[name] = t
        shard_bytes += nbytes
    flush()

    # Rename to the canonical HF n-of-m scheme now that m is known.
    total = len(shard_names)
    renames: dict[str, str] = {}
    for idx, name in enumerate(shard_names):
        final = f"model-{idx + 1:05d}-of-{total:05d}.safetensors"
        renames[name] = final
        os.rename(os.path.join(path, name), os.path.join(path, final))
    final_map = {n: renames[shard_name] for n, shard_name in weight_map.items()}
    with open(os.path.join(path, "model.safetensors.index.json"), "w") as f:
        json.dump({"weight_map": final_map}, f)
    write_hf_config(path, cfg)
    if tokenizer:
        write_tokenizer_json(path)
    return path


# --- kukeon int8 quantized checkpoint ----------------------------------------

def _flatten_quant(params: dict) -> dict[str, torch.Tensor]:
    flat: dict[str, torch.Tensor] = {}

    def walk(prefix: str, node):
        if isinstance(node, dict):
            if "q" in node and "s" in node and len(node) == 2:
                flat[prefix + ".q"] = node["q"]
                flat[prefix + ".s"] = node["s"]
            else:
                for k, v in node.items():
                    walk(f"{prefix}.{k}" if prefix else k, v)
        else:
            flat[prefix] = node

    walk("", params)
    return flat


def _unflatten_quant(flat: dict[str, torch.Tensor]) -> dict:
    tree: dict = {}
    for name, t in flat.items():
        parts = name.split(".")
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = t
    return tree


def save_quantized(path: str, params: dict, cfg: LlamaConfig) -> str:
    """Persist an int8 {"q","s"} tree (tensors on any device) as
    ``model.quant.safetensors`` + the ``kukeon_quant.json`` manifest. Norms
    in another dtype than int8, f32 or f16 are stored as f32, as the
    reference stores them."""
    os.makedirs(path, exist_ok=True)
    flat = {
        k: (v if v.dtype in (torch.int8, torch.float32, torch.float16) else v.float())
        for k, v in _flatten_quant(params).items()
    }
    save_safetensors(flat, os.path.join(path, "model.quant.safetensors"))
    with open(os.path.join(path, QUANT_MANIFEST), "w") as f:
        json.dump({"format": "kukeon-int8-v1", "config": _cfg_to_json(cfg)}, f)
    return path


def is_quantized_checkpoint(path: str) -> bool:
    return os.path.exists(os.path.join(path, QUANT_MANIFEST))


def quantized_config(path: str, dtype: torch.dtype | None = None) -> LlamaConfig:
    """The config in a kukeon int8 checkpoint's manifest (its activation
    dtype ``dtype`` when given)."""
    with open(os.path.join(path, QUANT_MANIFEST)) as f:
        manifest = json.load(f)
    if manifest.get("format") != "kukeon-int8-v1":
        raise ValueError(f"unknown quantized checkpoint format in {path}")
    cfg = _cfg_from_json(manifest["config"])
    return cfg if dtype is None else dataclasses.replace(cfg, dtype=dtype)


def load_quantized(path: str, dtype: torch.dtype | None = None) -> tuple[dict, LlamaConfig]:
    """The int8 tree back as CPU tensors, with the manifest's config (its
    activation dtype ``dtype`` when given). f32 leaves other than the ``.s``
    scales (the norms) are cast to the activation dtype. Read through
    :func:`stream_quantized` with one reader, drained."""
    stream = stream_quantized(path, dtype, threads=1, buffer_bytes=0)
    return drain(stream), stream.cfg


# --- streamed (tensor-granular) checkpoint pipeline ----------------------------

class CheckpointStreamError(RuntimeError):
    """A reader thread died mid-stream (an I/O or format error, or the armed
    ``checkpoint.stream`` fault point). The consumer raises it, so a boot
    fails clean: a half-loaded engine never turns ready."""


def _walk_tree(node, prefix: tuple[str, ...] = ()) -> Iterator[tuple[tuple[str, ...], Any]]:
    """(path tuple, leaf) pairs of a nested-dict parameter tree ({"q", "s"}
    dicts are interior nodes here: their tensors are the leaves)."""
    if isinstance(node, dict):
        for k in node:
            yield from _walk_tree(node[k], prefix + (k,))
    else:
        yield prefix, node


# The leaves a stream's readers may queue ahead of its consumer, in bytes
# (a job's leaves larger than this queue alone). Every reader runs its
# job whatever the bound: it waits only to queue what it read.
STREAM_BUFFER_BYTES = 256 << 20


class CheckpointStream:
    """Byte-bounded, tensor-granular checkpoint reader.

    ``jobs`` are zero-argument callables, each returning ``(leaves, disk_s,
    cast_s)`` with ``leaves`` a list of ``(path tuple, CPU tensor)`` pairs
    in their final dtype and layout. ``threads`` reader threads take the
    jobs in order and run them, all at once. A reader queues a job's
    leaves once the queue holds none, or holds them within
    ``buffer_bytes``, and the consumer gives a leaf's bytes back as it
    takes it. So host memory holds at most ``buffer_bytes`` of queued
    leaves (or one job's), plus ``threads`` jobs in flight (each with its
    own temporaries) and the leaf the consumer holds, however far the disk
    runs ahead of it; the bound never changes how many readers work.
    ``finalize``, if
    given, runs in each reader thread as it exits (closing the files it
    opened). The readers start at construction, as the reference's do, so
    the disk runs while the consumer builds what the leaves go into.

    Iterating yields ``(path, tensor)`` until every leaf of
    :attr:`abstract_params` has arrived. A reader's error (or the armed
    ``checkpoint.stream`` point, tried before each job) surfaces on the
    consumer as :class:`CheckpointStreamError`, never as a half tree; so
    does a stream whose readers all ended short of the tree.

    :attr:`stats` sums ``disk_s``, ``cast_s``, ``bytes`` and ``tensors``
    under a lock; :meth:`stat_snapshot` reads it, with ``extra_stats()``'s
    keys when given. ``count(path, leaf)``, when given, is what a leaf adds
    to ``bytes`` (a rank's stream: the full leaf's bytes, the reference's
    count, not its slice's).
    """

    def __init__(self, abstract_params: dict, cfg, jobs: list[Callable], *,
                 threads: int = 4, buffer_bytes: int = STREAM_BUFFER_BYTES,
                 finalize: Callable | None = None,
                 count: Callable | None = None, extra_stats: Callable | None = None):
        self.abstract_params = abstract_params
        self.cfg = cfg
        self.total_leaves = sum(1 for _ in _walk_tree(abstract_params))
        self._jobs = list(jobs)
        self._jobs_lock = threading.Lock()
        self._stats_lock = threading.Lock()
        self.stats = {"disk_s": 0.0, "cast_s": 0.0, "bytes": 0, "tensors": 0}  # guarded-by: _stats_lock
        self._limit = max(0, int(buffer_bytes))
        self._cond = threading.Condition()
        self._items: deque = deque()   # guarded-by: _cond; (item, bytes)
        self._queued = 0               # guarded-by: _cond; bytes of the queued leaves
        self._closed = threading.Event()
        self._finalize = finalize
        self._count = count
        self._extra_stats = extra_stats
        self._threads = [
            threading.Thread(target=self._reader, daemon=True, name=f"ckpt-stream-{i}")
            for i in range(max(1, min(threads, len(self._jobs) or 1)))]
        for t in self._threads:
            t.start()

    # --- reader side ---------------------------------------------------------

    def _reader(self) -> None:
        try:
            self._read_jobs()
        finally:
            if self._finalize is not None:
                self._finalize()

    def _read_jobs(self) -> None:
        while not self._closed.is_set():
            with self._jobs_lock:
                if not self._jobs:
                    return
                job = self._jobs.pop(0)
            try:
                faults.maybe_fail("checkpoint.stream")
                leaves, disk_s, cast_s = job()
            except BaseException as e:  # noqa: BLE001 — surfaced to the consumer
                self._put([(("err", CheckpointStreamError(
                    f"checkpoint stream reader failed: {type(e).__name__}: {e}"), e), 0)])
                return
            sizes = [t.numel() * t.element_size() for _, t in leaves]
            nbytes = sum(self._count(p, t) if self._count is not None else n
                         for (p, t), n in zip(leaves, sizes))
            with self._stats_lock:
                self.stats["disk_s"] += disk_s
                self.stats["cast_s"] += cast_s
                self.stats["bytes"] += nbytes
                self.stats["tensors"] += len(leaves)
            if not self._put([(("leaf", path, t), n) for (path, t), n in zip(leaves, sizes)]):
                return

    def _put(self, items: list) -> bool:
        """Queue one job's ``(item, bytes)`` pairs together, waiting while
        the queue holds leaves and these would take it past
        ``buffer_bytes``; False once the stream is closed (a consumer that
        stopped must not leave readers blocked)."""
        n = sum(b for _, b in items)
        with self._cond:
            while self._items and self._queued + n > self._limit:
                if self._closed.is_set():
                    return False
                self._cond.wait(0.2)
            if self._closed.is_set():
                return False
            self._items.extend(items)
            self._queued += n
            self._cond.notify_all()
            return True

    def _get(self, timeout: float):
        """The next queued item, its bytes given back; None after
        ``timeout``."""
        with self._cond:
            if not self._items:
                self._cond.wait(timeout)
                if not self._items:
                    return None
            item, n = self._items.popleft()
            self._queued -= n
            self._cond.notify_all()
            return item

    # --- consumer side -------------------------------------------------------

    def __iter__(self) -> Iterator[tuple[tuple[str, ...], torch.Tensor]]:
        remaining = self.total_leaves
        try:
            while remaining:
                item = self._get(0.2)
                if item is None:
                    if any(t.is_alive() for t in self._threads) or self._items:
                        continue
                    raise CheckpointStreamError(
                        f"checkpoint stream ended after {self.total_leaves - remaining} of "
                        f"{self.total_leaves} leaves") from None
                if item[0] == "err":
                    raise item[1] from item[2]
                yield item[1], item[2]
                remaining -= 1
        finally:
            self.close()

    def close(self) -> None:
        """Stop the readers (idempotent). Iteration closes on completion
        and on error; a consumer that stops early calls this too."""
        self._closed.set()
        with self._cond:
            self._cond.notify_all()

    def stat_snapshot(self) -> dict:
        with self._stats_lock:
            out = dict(self.stats)
        if self._extra_stats is not None:
            out.update(self._extra_stats())
        return out


def drain(stream: CheckpointStream) -> dict:
    """A stream read to its end: its tree of CPU tensors, in the abstract
    tree's order (what the materialized loaders return). A reader's error
    is raised as the reader met it, so a materialized load fails as it
    would have failed reading in the caller's thread."""
    try:
        leaves = dict(stream)
    except CheckpointStreamError as e:
        raise (e.__cause__ or e) from None

    def fill(node, path: tuple[str, ...]):
        if isinstance(node, dict):
            return {k: fill(v, path + (k,)) for k, v in node.items()}
        return leaves[path]

    return fill(stream.abstract_params, ())


def _timed_get(get: Callable[[], torch.Tensor]) -> tuple[torch.Tensor, float]:
    t0 = time.monotonic()
    out = get()
    return out, time.monotonic() - t0


class _ThreadReaders:
    """Tensors by name from safetensors files (``where``: name -> file), one
    :class:`SafetensorsReader` per file and thread, as the reference keeps
    one ``safe_open`` handle per thread. :meth:`close_local` closes the
    calling thread's readers (a stream's ``finalize``)."""

    def __init__(self, where: dict[str, str]):
        self.where = where
        self._tls = threading.local()
        self._lock = threading.Lock()
        self._opened: list[SafetensorsReader] = []   # guarded-by: _lock

    def reader(self, name: str) -> SafetensorsReader:
        """The calling thread's reader of the file that holds ``name``."""
        readers = getattr(self._tls, "readers", None)
        if readers is None:
            readers = self._tls.readers = {}
        path = self.where[name]
        r = readers.get(path)
        if r is None:
            r = readers[path] = SafetensorsReader(path)
            with self._lock:
                self._opened.append(r)
        return r

    def get(self, name: str) -> torch.Tensor:
        return self.reader(name).get_tensor(name)

    def bytes_read(self) -> int:
        """The bytes every reader has requested so far."""
        with self._lock:
            return sum(r.bytes_read for r in self._opened)

    def close_local(self) -> None:
        for r in getattr(self._tls, "readers", {}).values():
            r.close()
        self._tls.readers = {}


def stream_quantized(path: str, dtype: torch.dtype | None = None, *, threads: int = 4,
                     buffer_bytes: int = STREAM_BUFFER_BYTES, rank: int = 0,
                     world: int | None = None,
                     kv_shard: bool = True) -> CheckpointStream:
    """The streamed twin of :func:`load_quantized`: the abstract tree and
    the config come from the manifest and the safetensors header alone (no
    tensor byte read), then reader threads walk the file tensor by tensor,
    casting the norms to the activation dtype. The leaves equal the
    materialized loader's bit for bit.

    With ``world``, rank ``rank``'s stream (a tensor-parallel rank's
    recipe): each job reads only that rank's block of its leaf
    (``parallel.sharding.Layout``; a scale the spec replicates, as ``wo``'s
    and ``w_down``'s, whole), padding included, so its abstract tree has
    ``sharding.local_meta``'s shapes; no full leaf is held on the host
    (:meth:`SafetensorsReader.read_block`, staging blocks of
    :data:`STAGE_BYTES`). Its ``bytes`` count the full leaves' bytes, the
    reference's count; ``read_bytes`` the bytes requested from disk and
    ``job_peak_bytes`` the most a job held at once."""
    cfg = quantized_config(path, dtype)
    st_path = os.path.join(path, "model.quant.safetensors")
    header = read_safetensors_header(st_path)
    layout = None
    if world is not None:
        from kukeon_tpu_torch.parallel.sharding import Layout

        layout = Layout(cfg, rank, world, kv_shard)
    blocks = {name: layout.block(tuple(name.split(".")), spec.shape) if layout else None
              for name, spec in header.items()}
    abstract_flat = {
        name: TensorSpec(blocks[name].local_shape(spec.shape) if layout else spec.shape,
                         cfg.dtype if spec.dtype == torch.float32 and not name.endswith(".s")
                         else spec.dtype)
        for name, spec in header.items()}
    readers = _ThreadReaders({name: st_path for name in header})
    peak = JobPeak()

    def make_job(name: str):
        want = abstract_flat[name].dtype

        def job():
            if layout is None:
                t, disk_s = _timed_get(lambda: readers.get(name))
            else:
                t, disk_s = _timed_get(lambda: _read_rank_block(
                    readers.reader(name), name, header[name].shape, blocks[name], peak))
            t0 = time.monotonic()
            if t.dtype != want:
                t = t.to(want)
            return [(tuple(name.split(".")), t)], disk_s, time.monotonic() - t0

        return job

    full = {tuple(name.split(".")): TensorSpec(spec.shape, abstract_flat[name].dtype).nbytes
            for name, spec in header.items()}
    return CheckpointStream(
        _unflatten_quant(abstract_flat), cfg, [make_job(name) for name in header],
        threads=threads, buffer_bytes=buffer_bytes, finalize=readers.close_local,
        count=(lambda p, t: full[p]) if layout else None,
        extra_stats=(lambda: {"read_bytes": readers.bytes_read(), "job_peak_bytes": peak.bytes})
        if layout else None)


def _read_rank_block(reader: SafetensorsReader, name: str, shape: tuple, block,
                     peak: JobPeak) -> torch.Tensor:
    """A rank's block of ``name`` (a ``sharding.Block``) read from disk and
    padded to its local shape; ``peak`` notes the most the read held at
    once."""
    meter = HostMeter()
    whole = block.axis is None or (block.lo == 0 and block.hi == shape[block.axis])
    part = reader.read_block(name, None if whole else block.axis, block.lo, block.hi,
                             meter=meter)
    if whole:
        meter.hold(part.numel() * part.element_size())
    if block.axis is not None and block.size != block.hi - block.lo:
        part = block.place(part)
        meter.hold(part.numel() * part.element_size())
    peak.note(meter)
    return part
