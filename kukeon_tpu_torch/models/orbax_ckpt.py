"""Orbax checkpoints, read and written by the port's own code: the JAX
package serves and trains from them (``StandardCheckpointer``), and the
port takes the same paths, with no ``orbax``, ``tensorstore``, ``jax``,
``zstandard`` or ``ml_dtypes`` import.

What ``StandardCheckpointer().save(path, tree)`` writes, and this module
reads and writes:

- ``_METADATA``: JSON. ``tree_metadata`` maps each leaf's key path, written
  as a Python tuple (``"('opt_state', '1', '0', 'mu', 'embed')"``), to its
  ``key_metadata`` (each key with ``key_type`` 1 for a sequence index, 2
  for a dict key) and ``value_metadata`` (``value_type`` ``jax.Array`` or
  ``None``, ``write_shape``); and ``use_ocdbt``, ``use_zarr3``.
- Each array as zarr v2 under the leaf's keys joined by dots
  (``params.layers.wq``): ``<name>/.zarray`` (JSON: shape, chunks, dtype,
  compressor, fill_value, order, dimension_separator) and one value per
  chunk, ``<name>/0.0.0``, each a zstd frame. Edge chunks are stored at
  full chunk size; a missing chunk is ``fill_value`` (null: zeros).
- With ``use_ocdbt`` (orbax's default) those keys live in an OCDBT store
  (:mod:`kukeon_tpu_torch.models.ocdbt`); without it, as files.
- ``_CHECKPOINT_METADATA``, ``_sharding`` and ``array_metadatas/process_0``,
  which the writer fills in as a one-process, one-device save would.

Dtypes: ``<f4``, ``<f2``, ``bfloat16``, ``<i4``, ``<i8``, ``|i1``, ``|u1``,
``|b1`` (and the other plain numpy ones). A bfloat16 leaf reads as uint16
bits marked :class:`~kukeon_tpu_torch.models.convert.BFloat16Bits`;
``convert.tensor_from_numpy`` views it as ``torch.bfloat16``.

The writer stores one chunk per array in a stored zstd frame
(:func:`zstd.compress_stored`), where orbax compresses at level 1: the
values are equal, the files larger.

A tensor-parallel rank reads its blocks (:func:`rank_leaves`): each
array's region through :meth:`OrbaxCheckpoint.read_array`, which decodes
only the chunks the region overlaps (a one-chunk array, what one device
saves, whole). :func:`load_params` reads leaf by leaf too, never the tree
at once.

The trees: a Llama or BERT parameter tree reads as the reference's nested
dict and goes through ``convert.params_from_numpy``; the JAX ``TrainState``
(``params``, ``opt_state`` = (clip: None, (adam: {count, mu, nu}, None,
schedule: {count})), ``step``) maps to the port's ``{"count", "mu",
"nu"}`` state (:func:`train_state_tree`; the trainer's restore reads it
back leaf by leaf).
"""

from __future__ import annotations

import ast
import base64
import concurrent.futures
import itertools
import json
import math
import os
import threading
import time
from typing import Any, Iterator

import numpy as np
import torch

from kukeon_tpu_torch.models import llama, ocdbt, zstd
from kukeon_tpu_torch.models.convert import BFloat16Bits, tensor_from_numpy

METADATA = "_METADATA"
CHECKPOINT_METADATA = "_CHECKPOINT_METADATA"
SHARDING = "_sharding"
ARRAY_METADATAS = "array_metadatas"
KEY_SEQUENCE, KEY_DICT = 1, 2
# Reader threads: frames decode in parallel (the decoder drops the GIL),
# and at most this many arrays are held on the host ahead of the consumer.
_READ_THREADS = 4
_HANDLER = ("orbax.checkpoint._src.handlers.standard_checkpoint_handler."
            "StandardCheckpointHandler")
# A one-device save from the host: the arrays reach the writer in host
# memory, so the sharding metadata names JAX's first CPU device.
_SHARDING = json.dumps({"sharding_type": "SingleDeviceSharding", "device_str": "TFRT_CPU_0"})
_TORCH_DTYPES = {torch.float32: "<f4", torch.float16: "<f2", torch.bfloat16: "bfloat16",
                 torch.float64: "<f8", torch.int32: "<i4", torch.int64: "<i8",
                 torch.int16: "<i2", torch.int8: "|i1", torch.uint8: "|u1", torch.bool: "|b1"}


class CheckpointError(ValueError):
    """A checkpoint this reader cannot take: its message names the path."""


def is_orbax_checkpoint(path: str) -> bool:
    """True for a directory orbax's ``StandardCheckpointer`` wrote (it has
    ``_METADATA``)."""
    return os.path.isdir(path) and os.path.isfile(os.path.join(path, METADATA))


def _numpy_dtype(name: str) -> np.dtype:
    if name == "bfloat16":
        return np.dtype(np.uint16)
    dt = np.dtype(name)
    if dt.kind not in "fiub":
        raise CheckpointError(f"zarr dtype {name!r} is not supported")
    return dt


def _fill(meta: dict, dt: np.dtype):
    v = meta.get("fill_value")
    if v is None:
        return 0
    if isinstance(v, str):       # "NaN", "Infinity", "-Infinity"
        v = float(v.replace("Infinity", "inf"))
    if meta["dtype"] == "bfloat16":
        return int(np.float32(v).view(np.uint32) >> 16)
    return v


class _FileStore:
    """The ``use_ocdbt: false`` layout: each zarr key is a file."""

    def __init__(self, root: str):
        self.root = root

    def has(self, key: bytes) -> bool:
        return os.path.isfile(ocdbt.resolve_under(self.root, key.decode()))

    def read(self, key: bytes) -> bytes:
        with open(ocdbt.resolve_under(self.root, key.decode()), "rb") as f:
            return f.read()


class Leaf:
    """One entry of ``_METADATA``'s tree."""

    def __init__(self, keys: list[tuple[str, int]], value_type: str):
        self.keys = keys
        self.value_type = value_type
        self.name = ".".join(k for k, _ in keys)


class OrbaxCheckpoint:
    """A checkpoint directory, opened: :attr:`leaves` from ``_METADATA``,
    arrays read on demand (:meth:`read_array`, :meth:`iter_arrays`, the whole
    tree by :meth:`read_tree`). ``stats`` sums the seconds spent reading the
    files (``disk_s``) and decoding the frames (``decode_s``) over the
    reader threads, and the bytes of the frames read (``bytes_read``)."""

    def __init__(self, path: str):
        if not is_orbax_checkpoint(path):
            raise CheckpointError(f"{path!r} is not an orbax checkpoint (no {METADATA})")
        self.path = path
        with open(os.path.join(path, METADATA)) as f:
            meta = json.load(f)
        if meta.get("use_zarr3"):
            raise CheckpointError(f"{path}: zarr v3 arrays are not supported")
        self.leaves: list[Leaf] = []
        for k, v in meta["tree_metadata"].items():
            keys = [(str(m["key"]), int(m["key_type"])) for m in v["key_metadata"]]
            if [k for k, _ in keys] != [str(x) for x in ast.literal_eval(k)]:
                raise CheckpointError(f"{path}: tree key {k} disagrees with its key_metadata")
            self.leaves.append(Leaf(keys, v["value_metadata"]["value_type"]))
        try:
            self._store = (ocdbt.Store(path) if meta.get("use_ocdbt", True)
                           else _FileStore(path))
        except ocdbt.FormatError as e:
            raise CheckpointError(f"{path}: {e}") from e
        self.stats = {"disk_s": 0.0, "decode_s": 0.0, "bytes_read": 0}
        self._stats_lock = threading.Lock()

    def array_names(self) -> list[str]:
        return [lf.name for lf in self.leaves if lf.value_type != "None"]

    def zarray(self, name: str) -> dict:
        return json.loads(self._store.read(f"{name}/.zarray".encode()))

    def _chunk(self, key: bytes, compressor, out: np.ndarray) -> bool:
        """Decode chunk ``key`` into ``out``; False when it is missing."""
        if not self._store.has(key):
            return False
        t0 = time.perf_counter()
        raw = self._store.read(key)
        t1 = time.perf_counter()
        if compressor is None:
            if len(raw) != out.nbytes:
                raise CheckpointError(f"{self.path}: chunk {key.decode()} holds "
                                      f"{len(raw)} bytes, want {out.nbytes}")
            out.reshape(-1).view(np.uint8)[:] = np.frombuffer(raw, np.uint8)
        else:
            try:
                got = len(zstd.decompress(raw, out))
            except zstd.ZstdError as e:
                raise CheckpointError(f"{self.path}: chunk {key.decode()}: {e}") from e
            if got != out.nbytes:
                raise CheckpointError(f"{self.path}: chunk {key.decode()} decodes to "
                                      f"{got} bytes, want {out.nbytes}")
        t2 = time.perf_counter()
        with self._stats_lock:
            self.stats["disk_s"] += t1 - t0
            self.stats["decode_s"] += t2 - t1
            self.stats["bytes_read"] += len(raw)
        return True

    def _meta(self, name: str) -> tuple[dict, np.dtype]:
        meta = self.zarray(name)
        if meta.get("zarr_format") != 2 or meta.get("order", "C") != "C" or meta.get("filters"):
            raise CheckpointError(f"{self.path}: {name}: only C-order zarr v2 arrays "
                                  "without filters are supported")
        comp = meta.get("compressor")
        if comp is not None and comp.get("id") != "zstd":
            raise CheckpointError(f"{self.path}: {name}: compressor {comp.get('id')!r} "
                                  "is not supported (zstd or none)")
        return meta, _numpy_dtype(meta["dtype"])

    def one_chunk(self, name: str) -> bool:
        """Whether array ``name`` is stored as one chunk (the port's writer
        and a one-device save): any region of it decodes the whole."""
        meta = self.zarray(name)
        return tuple(meta["chunks"]) == tuple(meta["shape"])

    def read_array(self, name: str, region=None) -> np.ndarray:
        """Array ``name`` (``"params.layers.wq"``) in host memory; with
        ``region`` ``(axis, lo, hi)``, or a tuple of such on distinct axes
        (empty: the whole array), only ``[lo, hi)`` along each ``axis``, decoding only the chunks that
        overlap it (a one-chunk array is decoded whole into a staging
        buffer, then cut)."""
        meta, dt = self._meta(name)
        comp = meta.get("compressor")
        shape, chunks = tuple(meta["shape"]), tuple(meta["chunks"])
        sep = meta.get("dimension_separator", ".")
        regions = () if not region else (
            (region,) if isinstance(region[0], int) else tuple(region))
        box = [(0, d) for d in shape]
        for axis, lo, hi in regions:
            if not 0 <= lo <= hi <= shape[axis]:
                raise CheckpointError(f"{self.path}: {name}: region {region} is outside "
                                      f"{shape}")
            box[axis] = (lo, hi)
        want = tuple(hi - lo for lo, hi in box)
        arr = np.empty(want, dt)
        grid = [math.ceil(s / c) if c else 0 for s, c in zip(shape, chunks)]
        if chunks == shape and want == shape:           # one chunk, whole: in place
            key = f"{name}/{sep.join('0' * len(shape)) if shape else '0'}".encode()
            if not self._chunk(key, comp, arr):
                arr.fill(_fill(meta, dt))
        elif all(grid):
            buf = np.empty(chunks, dt)
            ranges = [range(lo // c, (hi - 1) // c + 1) if hi > lo else range(0)
                      for (lo, hi), c in zip(box, chunks)]
            for idx in itertools.product(*ranges):
                key = f"{name}/{sep.join(map(str, idx))}".encode()
                full = [slice(max(i * c, lo), min((i + 1) * c, s, hi))
                        for i, c, s, (lo, hi) in zip(idx, chunks, shape, box)]
                src = tuple(slice(f.start - i * c, f.stop - i * c)
                            for f, i, c in zip(full, idx, chunks))
                dst = tuple(slice(f.start - lo, f.stop - lo) for f, (lo, _) in zip(full, box))
                if self._chunk(key, comp, buf):
                    arr[dst] = buf[src]
                else:
                    arr[dst] = _fill(meta, dt)
        if meta["dtype"] == "bfloat16":
            arr = arr.view(BFloat16Bits)
        return arr

    def iter_arrays(self, names: list[str],
                    regions: dict | None = None) -> Iterator[tuple[str, np.ndarray]]:
        """(name, array) for each of ``names`` as the reader threads finish
        them, at most :data:`_READ_THREADS` arrays in host memory ahead of
        the consumer; ``regions`` maps a name to its :meth:`read_array`
        region (a mesh rank's block)."""
        regions = regions or {}
        with concurrent.futures.ThreadPoolExecutor(_READ_THREADS) as pool:
            pending: dict = {}
            todo = iter(names)
            for name in todo:
                pending[pool.submit(self.read_array, name, regions.get(name))] = name
                if len(pending) >= _READ_THREADS:
                    break
            while pending:
                done, _ = concurrent.futures.wait(
                    pending, return_when=concurrent.futures.FIRST_COMPLETED)
                for fut in done:
                    name = pending.pop(fut)
                    yield name, fut.result()
                    nxt = next(todo, None)
                    if nxt is not None:
                        pending[pool.submit(self.read_array, nxt, regions.get(nxt))] = nxt

    def read_tree(self) -> Any:
        """The whole tree: nested dicts (dict keys) and lists (sequence
        indices) of host arrays; ``None`` leaves stay ``None``."""
        arrays = dict(self.iter_arrays(self.array_names()))
        return _unflatten([(lf.keys, arrays.get(lf.name)) for lf in self.leaves])

    def bytes_on_disk(self) -> int:
        total = 0
        for d, _, files in os.walk(self.path):
            total += sum(os.path.getsize(os.path.join(d, f)) for f in files)
        return total


def _unflatten(leaves: list[tuple[list[tuple[str, int]], Any]]) -> Any:
    root: dict = {}
    for keys, value in leaves:
        node = root
        for k, kt in keys[:-1]:
            node = node.setdefault(int(k) if kt == KEY_SEQUENCE else k, {})
        k, kt = keys[-1]
        node[int(k) if kt == KEY_SEQUENCE else k] = value

    def fix(node, seq: bool):
        if not isinstance(node, dict):
            return node
        out = {k: fix(v, isinstance(v, dict) and all(isinstance(x, int) for x in v))
               for k, v in node.items()}
        if seq:
            if sorted(out) != list(range(len(out))):
                raise CheckpointError(f"sequence indices {sorted(out)} are not 0..n-1")
            return [out[i] for i in range(len(out))]
        return out

    return fix(root, False)


def read_tree(path: str) -> Any:
    """:meth:`OrbaxCheckpoint.read_tree` of ``path``."""
    return OrbaxCheckpoint(path).read_tree()


def _open_checked(path: str, abstract: dict) -> tuple[OrbaxCheckpoint, list]:
    """The checkpoint at ``path`` and ``abstract``'s ``(keys, meta leaf)``
    pairs, every leaf checked against the arrays' metadata before any frame
    is read: each leaf of ``abstract`` must be in the checkpoint at its
    shape, and nothing else may be, or :class:`CheckpointError` names the
    leaf."""
    try:
        ckpt = OrbaxCheckpoint(path)
        leaves = list(flatten(abstract))
        want = {".".join(k for k, _ in keys): tuple(v.shape) for keys, v in leaves}
        arrays = set(ckpt.array_names())
        stored = {lf.name for lf in ckpt.leaves}
        for name in sorted(want.keys() | stored):
            if name not in stored:
                raise CheckpointError(f"checkpoint {path!r} has no leaf {name} "
                                      f"(the model's is {want[name]})")
            if name not in want:
                raise CheckpointError(f"checkpoint {path!r} has a leaf {name} the model "
                                      "does not")
            shape = tuple(ckpt.zarray(name)["shape"]) if name in arrays else None
            if shape != want[name]:
                raise CheckpointError(f"checkpoint {path!r}: leaf {name} is {shape}, the "
                                      f"model's is {want[name]}")
    except CheckpointError as e:
        raise CheckpointError(str(e) if str(e).startswith("checkpoint ")
                              else f"checkpoint {path!r}: {e}") from e
    except OSError as e:
        raise CheckpointError(f"checkpoint {path!r}: {e}") from e
    return ckpt, leaves


def _cast(a: np.ndarray, key: str, dtype: torch.dtype) -> torch.Tensor:
    """A host array as a CPU tensor cast as ``convert.params_from_numpy``
    casts a leaf: floating leaves but int8 scales and the router."""
    t = tensor_from_numpy(a)
    return t.to(dtype) if t.is_floating_point() and key not in ("s", "router") else t


def _stats(ckpt: OrbaxCheckpoint, leaf_bytes: int, leaves: int, t0: float, t1: float,
           device) -> dict:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
    return {"format": "orbax", "bytes_on_disk": ckpt.bytes_on_disk(),
            "frame_bytes": ckpt.stats["bytes_read"], "leaf_bytes": leaf_bytes,
            "leaves": leaves, "disk_s": ckpt.stats["disk_s"],
            "decode_s": ckpt.stats["decode_s"], "read_s": t1 - t0,
            "upload_s": time.monotonic() - t1}


def load_params(path: str, abstract: dict, dtype: torch.dtype,
                device: torch.device | str) -> tuple[dict, dict]:
    """(parameter tree on ``device``, the load's stats) of an orbax
    checkpoint, as the reference restores one into ``init_params``'
    abstract tree: every leaf of ``abstract`` (meta tensors) must be in the
    checkpoint at its shape, and nothing else may be, or
    :class:`CheckpointError` names the leaf (from the metadata, before any
    frame is read); floating leaves are cast to ``dtype``
    (``convert.params_from_numpy``). Read leaf by leaf
    (:meth:`OrbaxCheckpoint.iter_arrays`), each placed before the reader
    threads run further ahead. The stats: the bytes on disk, the frame
    bytes read, the leaf bytes placed, the reader threads' summed
    ``disk_s`` and ``decode_s``, and the wall seconds of the read and
    placing (``read_s``) and of the last copies' wait (``upload_s``)."""
    t0 = time.monotonic()
    ckpt, leaves = _open_checked(path, abstract)
    keys_of = {".".join(k for k, _ in keys): keys for keys, _ in leaves}
    placed = {}
    try:
        for name, arr in ckpt.iter_arrays(list(keys_of)):
            placed[name] = _cast(arr, keys_of[name][-1][0], dtype).to(device)
            del arr
    except (CheckpointError, OSError) as e:
        raise CheckpointError(f"checkpoint {path!r}: {e}") from e
    t1 = time.monotonic()
    params = _unflatten([(keys, placed[name]) for name, keys in keys_of.items()])
    return params, _stats(ckpt, sum(t.numel() * t.element_size() for t in placed.values()),
                          len(leaves), t0, t1, device)


def rank_leaves(path: str, abstract: dict, layout, dtype: torch.dtype,
                device: torch.device | str, *, quantize: bool = False, stats: dict | None = None):
    """A tensor-parallel rank's blocks of an orbax checkpoint
    (``parallel.sharding.Layout``), ``(path tuple, tensor on device)`` one
    leaf at a time, checked as :func:`load_params` checks: each array's
    region decoded (:meth:`OrbaxCheckpoint.read_array`), cast, padded and
    placed; a one-chunk array is decoded whole, once, one leaf at a time.
    ``quantize``: a decoder's matrices as int8 ``{"q", "s"}`` on the
    device, as ``llama.quantize_params`` quantizes the one-device tree; a
    row-parallel matrix (its cut on the contracted axis) a layer at a time
    from its whole layer, so its scale is the one-device scale. ``stats``
    (when given) gets :func:`load_params`' keys, ``leaf_bytes`` the full
    leaves' (the reference's count)."""
    t0 = time.monotonic()
    ckpt, leaves = _open_checked(path, abstract)
    leaf_bytes = 0
    try:
        for keys, meta in leaves:
            tpath = tuple(k for k, _ in keys)
            name = ".".join(tpath)
            shape = tuple(meta.shape)
            leaf_bytes += meta.numel() * meta.element_size()
            if quantize and tpath[-1] not in ("attn_norm", "mlp_norm", "final_norm"):
                yield from _rank_int8(ckpt, name, tpath, shape, layout, dtype, device)
                continue
            blk = layout.block(tpath, shape)
            whole = blk.axis is None or (blk.lo, blk.hi) == (0, shape[blk.axis])
            host = ckpt.read_array(name, None if whole else (blk.axis, blk.lo, blk.hi))
            t = _cast(host, tpath[-1], dtype)
            del host
            if blk.axis is not None and blk.size != blk.hi - blk.lo:
                t = blk.place(t)
            yield tpath, t.to(device)
            del t
    except (CheckpointError, OSError) as e:
        raise CheckpointError(f"checkpoint {path!r}: {e}") from e
    if stats is not None:
        t1 = time.monotonic()
        stats.update(_stats(ckpt, leaf_bytes, len(leaves), t0, t1, device))


def _rank_int8(ckpt: OrbaxCheckpoint, name: str, tpath: tuple, shape: tuple, layout,
               dtype: torch.dtype, device):
    """:func:`rank_leaves`' int8 leaf: ``q`` and ``s`` of this rank."""
    axis = 0 if tpath[-1] == "lm_head" else 1     # the contracted axis (quantize_leaf's)
    qb = layout.block(tpath + ("q",), shape)
    s_shape = tuple(d for i, d in enumerate(shape) if i != axis)
    sb = layout.block(tpath + ("s",), s_shape)
    if qb.axis != axis:
        # The block holds every contracted entry: its scale is the full one.
        whole = qb.axis is None or (qb.lo, qb.hi) == (0, shape[qb.axis])
        host = ckpt.read_array(name, None if whole else (qb.axis, qb.lo, qb.hi))
        w = _cast(host, tpath[-1], dtype).to(device)
        del host
        leaf = llama.quantize_leaf(tpath, w)
        del w
        q, s = leaf["q"], leaf["s"]
        if qb.axis is not None and qb.size != qb.hi - qb.lo:
            q, s = qb.place(q), sb.place(s)
        yield tpath + ("q",), q
        yield tpath + ("s",), s
        return
    # Row-parallel ([L, in, out], ``in`` cut): a layer at a time, whole.
    src = ckpt.read_array(name) if ckpt.one_chunk(name) else None
    # Zeros past the real rows: a block of padded heads.
    q = torch.zeros(qb.local_shape(shape), dtype=torch.int8, device=device)
    s = torch.empty(s_shape, dtype=torch.float32, device=device)
    for i in range(shape[0]):
        layer = src[i:i + 1] if src is not None else ckpt.read_array(name, (0, i, i + 1))
        w = _cast(np.ascontiguousarray(layer), tpath[-1], dtype).to(device)
        qw, sw = llama._int8_sym(w[0], 0)
        q[i, :qb.hi - qb.lo], s[i] = qw[qb.lo:qb.hi], sw[0]
        del layer, w
    del src
    yield tpath + ("q",), q
    yield tpath + ("s",), s


# ------------------------------------------------------------------ writer --

def flatten(tree, keys=()) -> Iterator[tuple[list[tuple[str, int]], Any]]:
    """``(keys, leaf)`` of ``tree`` in the order :func:`write_tree` writes
    it (dict keys sorted), each key with its orbax key type."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from flatten(tree[k], keys + ((str(k), KEY_DICT),))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from flatten(v, keys + ((str(i), KEY_SEQUENCE),))
    else:
        yield list(keys), tree


def _host_array(value) -> tuple[np.ndarray, str]:
    """(C-contiguous host array, zarr dtype) of a leaf: a tensor on any
    device, a numpy array, a Python number, or a callable that returns one
    of those when the writer reaches the leaf (a mesh's leaf, gathered
    then)."""
    if callable(value):
        value = value()
    if isinstance(value, torch.Tensor):
        t = value.detach().to("cpu").contiguous()
        if t.dtype not in _TORCH_DTYPES:
            raise CheckpointError(f"dtype {t.dtype} has no zarr v2 name here")
        name = _TORCH_DTYPES[t.dtype]
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), name
        return t.numpy(), name
    if isinstance(value, BFloat16Bits):
        return np.ascontiguousarray(value.view(np.ndarray)), "bfloat16"
    if isinstance(value, (bool, int)):
        value = np.asarray(value, np.bool_ if isinstance(value, bool) else np.int32)
    a = np.asarray(value)
    if not a.flags.c_contiguous:    # (np.ascontiguousarray would make a 0-d array 1-d)
        a = a.copy()
    if a.dtype.kind not in "fiub":
        raise CheckpointError(f"dtype {a.dtype} has no zarr v2 name here")
    return a, a.dtype.str


def _zarray(shape: tuple, dtype: str) -> bytes:
    # zarr wants chunks >= 1: an empty array has no chunk at all.
    return json.dumps({"chunks": [max(1, s) for s in shape],
                       "compressor": {"id": "zstd", "level": 1},
                       "dimension_separator": ".", "dtype": dtype, "fill_value": None,
                       "filters": None, "order": "C", "shape": list(shape),
                       "zarr_format": 2}, sort_keys=True, separators=(",", ":")).encode()


def _write_json(path: str, obj) -> None:
    with open(path, "w") as f:
        json.dump(obj, f)
        f.flush()
        os.fsync(f.fileno())


def write_tree(path: str, tree) -> dict:
    """Write ``tree`` (nested dicts, lists and tuples of tensors on any
    device, numpy arrays, Python numbers, callables that return one of
    those, and ``None``) at ``path`` in the
    layout ``StandardCheckpointer().save`` writes, so orbax restores it and
    :class:`OrbaxCheckpoint` reads it. Dict keys are written sorted (JAX's
    order). One leaf at a time is copied to the host and written before the
    next is copied, so the host holds one leaf of the tree, not the tree.
    Every file is fsynced. Returns ``{"leaf_bytes", "bytes_written",
    "seconds"}``."""
    t0 = time.perf_counter()
    t_init = time.time_ns()
    os.makedirs(path, exist_ok=True)
    tree_meta, array_meta, sharding = {}, [], {}
    leaf_bytes = 0

    def items():
        nonlocal leaf_bytes
        for keys, value in flatten(tree):
            if not keys:
                raise CheckpointError("write_tree: the tree's root must be a dict or a "
                                      "sequence")
            name = ".".join(k for k, _ in keys)
            key_meta = [{"key": k, "key_type": kt} for k, kt in keys]
            tkey = str(tuple(k for k, _ in keys))
            if value is None:
                tree_meta[tkey] = {"key_metadata": key_meta,
                                   "value_metadata": {"value_type": "None",
                                                      "skip_deserialize": True}}
                continue
            arr, dtype = _host_array(value)
            shape = tuple(arr.shape)
            yield f"{name}/.zarray", _zarray(shape, dtype)
            if arr.size:
                chunk = ".".join("0" * len(shape)) if shape else "0"
                yield f"{name}/{chunk}", zstd.stored_frame_parts(arr.reshape(-1).view(np.uint8))
            leaf_bytes += arr.nbytes
            del arr                # written: free before the next leaf's copy
            tree_meta[tkey] = {"key_metadata": key_meta,
                               "value_metadata": {"value_type": "jax.Array",
                                                  "skip_deserialize": False,
                                                  "write_shape": list(shape)}}
            array_meta.append({"array_metadata": {"param_name": name,
                                                  "write_shape": list(shape),
                                                  "chunk_shape": [max(1, s) for s in shape],
                                                  "ext_metadata": None}})
            sharding[base64.b64encode(name.encode()).decode()] = _SHARDING

    written = ocdbt.write_store(path, items())
    os.makedirs(os.path.join(path, ARRAY_METADATAS), exist_ok=True)
    _write_json(os.path.join(path, ARRAY_METADATAS, "process_0"),
                {"array_metadatas": array_meta})
    _write_json(os.path.join(path, SHARDING), sharding)
    _write_json(os.path.join(path, METADATA),
                {"tree_metadata": tree_meta, "use_ocdbt": True, "use_zarr3": False,
                 "store_array_data_equal_to_fill_value": True, "custom_metadata": None})
    _write_json(os.path.join(path, CHECKPOINT_METADATA),
                {"item_handlers": _HANDLER, "metrics": {}, "performance_metrics": {},
                 "init_timestamp_nsecs": t_init, "commit_timestamp_nsecs": time.time_ns(),
                 "custom_metadata": {}})
    return {"leaf_bytes": leaf_bytes, "bytes_written": written,
            "seconds": time.perf_counter() - t0}


# ------------------------------------------------------ the JAX TrainState --

def train_state_tree(params, opt_state: dict, step: int) -> dict:
    """The JAX ``TrainState`` layout of the port's state: ``opt_state`` is
    optax's chain (clip_by_global_norm, then adamw's scale_by_adam,
    add_decayed_weights and scale_by_schedule), the two counts int32."""
    count = np.asarray(int(opt_state["count"]), np.int32)
    adam = {"count": count, "mu": opt_state["mu"], "nu": opt_state["nu"]}
    return {"params": params, "opt_state": [None, [adam, None, {"count": count}]],
            "step": np.asarray(int(step), np.int32)}
