"""OCDBT, the key-value store under orbax checkpoints, read and written by
the port's own code (tensorstore's "optionally-cooperative distributed
B+tree" format; no ``tensorstore`` import).

A store is a directory. ``manifest.ocdbt`` holds the config and the
version tree; each version names the root of an immutable B+tree. Tree
nodes and large values live in data files under ``d/``, several to a file
at (offset, length). Every manifest and node is an envelope:

    magic u32be | length u64le | version varint | compression varint
    | body (zstd frame when compression is 1) | crc32c u32le

where ``length`` counts the whole envelope and the CRC-32C covers all that
precedes it. Integers inside are LEB128 varints, laid out by column (every
entry's first field, then every entry's second, ...).

- A data-file table opens each node and the manifest's version list: the
  file count, then for files 1.. the length each full path shares with the
  one before, each path's suffix length, each path's base-path length, and
  the suffixes. A file's path is its base path plus its relative path,
  and the base path of the file a node was read from prefixes the base
  paths in that node's table (a root store references the
  ``ocdbt.process_N/`` stores' files this way).
- A leaf node (height 0): entry count; key prefix lengths (shared with the
  previous key, from the second entry on), key suffix lengths, key bytes;
  value lengths; value kinds (0 inline, 1 indirect); the indirect values'
  file ids, then their offsets; the inline values' bytes.
- An interior node (height > 0): entry count; keys as above plus each
  entry's subtree common-prefix length before the key bytes; the children's
  file ids, offsets and lengths; their key counts, tree bytes and indirect
  value bytes. A child's keys are stored without the parent's prefix plus
  the first ``subtree_common_prefix_length`` bytes of its entry's key.
- The manifest (kind 0, "single"): config (uuid[16], manifest kind,
  max inline value bytes, max decoded node bytes, version-tree arity log2
  as one byte, compression method, and for zstd an int32le level), then the
  newest versions inline (a data-file table, their count, and the columns
  generation, root height, root file id, offset, length, key count, tree
  bytes, indirect value bytes, commit time as u64le), then references to
  older version-tree nodes (count; generation, file id, offset, length,
  generation count, commit time u64le, height). The newest version is the
  last inline one, so reading never follows the older nodes.

Orbax writes one store per process (``ocdbt.process_N/``) and a root
manifest whose tree references their data files; :class:`Store` reads the
root when it has a manifest and otherwise merges the process stores.
:func:`write_store` writes that layout for one process and one version.
"""

from __future__ import annotations

import dataclasses
import os
import struct
import time
import uuid as uuid_mod

from kukeon_tpu_torch.models import zstd

MANIFEST_MAGIC = 0x0CDB3A2A
BTREE_MAGIC = 0x0CDB20DE
MANIFEST = "manifest.ocdbt"
PROCESS_PREFIX = "ocdbt.process_"
# The writer's limits: orbax's inline-value limit, tensorstore's default
# decoded-node limit, version tree arity 2^4.
MAX_INLINE_VALUE_BYTES = 1024
MAX_DECODED_NODE_BYTES = 100_000_000
VERSION_TREE_ARITY_LOG2 = 4


class FormatError(ValueError):
    """A malformed or unsupported OCDBT store."""


@dataclasses.dataclass(frozen=True)
class DataFileId:
    base: str
    rel: str

    @property
    def path(self) -> str:
        return self.base + self.rel


@dataclasses.dataclass(frozen=True)
class IndirectRef:
    """A value, or a node, at (offset, length) of a data file."""
    file: DataFileId
    offset: int
    length: int


@dataclasses.dataclass(frozen=True)
class Config:
    uuid: bytes
    manifest_kind: int
    max_inline_value_bytes: int
    max_decoded_node_bytes: int
    version_tree_arity_log2: int
    compression: int          # 0 none, 1 zstd
    zstd_level: int = 0


@dataclasses.dataclass(frozen=True)
class Version:
    generation: int
    root_height: int
    root: IndirectRef | None  # None: the empty tree
    num_keys: int
    num_tree_bytes: int
    num_indirect_value_bytes: int
    commit_time_ns: int


class _Reader:
    """A cursor over a body's bytes; every read is bounds-checked."""

    def __init__(self, buf: bytes, what: str):
        self.buf, self.pos, self.what = buf, 0, what

    def fail(self, why: str):
        raise FormatError(f"ocdbt {self.what}: {why} at byte {self.pos}")

    def u8(self) -> int:
        if self.pos >= len(self.buf):
            self.fail("truncated")
        self.pos += 1
        return self.buf[self.pos - 1]

    def varint(self) -> int:
        v = shift = 0
        while True:
            b = self.u8()
            v |= (b & 0x7F) << shift
            if not b & 0x80:
                return v
            shift += 7
            if shift > 63:
                self.fail("varint longer than 64 bits")

    def varints(self, n: int) -> list[int]:
        return [self.varint() for _ in range(n)]

    def take(self, n: int) -> bytes:
        if n < 0 or self.pos + n > len(self.buf):
            self.fail(f"truncated (need {n} bytes)")
        self.pos += n
        return self.buf[self.pos - n:self.pos]

    def done(self):
        if self.pos != len(self.buf):
            self.fail(f"{len(self.buf) - self.pos} trailing bytes")


def _decode_envelope(buf: bytes, magic: int, what: str) -> bytes:
    if len(buf) < 18:
        raise FormatError(f"ocdbt {what}: {len(buf)} bytes, too short")
    got_magic, length = struct.unpack_from(">I", buf)[0], struct.unpack_from("<Q", buf, 4)[0]
    if got_magic != magic:
        raise FormatError(f"ocdbt {what}: magic {got_magic:#010x}, want {magic:#010x}")
    if length != len(buf):
        raise FormatError(f"ocdbt {what}: header says {length} bytes, read {len(buf)}")
    want_crc = struct.unpack_from("<I", buf, len(buf) - 4)[0]
    if zstd.crc32c(memoryview(buf)[:-4]) != want_crc:
        raise FormatError(f"ocdbt {what}: crc32c mismatch")
    r = _Reader(buf[:-4], what)
    r.pos = 12
    if (version := r.varint()) != 0:
        r.fail(f"format version {version}")
    compression = r.varint()
    body = bytes(buf[r.pos:-4])
    if compression == 0:
        return body
    if compression == 1:
        return zstd.decompress(body)
    r.fail(f"compression format {compression}")


def _encode_envelope(magic: int, body: bytes) -> bytes:
    head = struct.pack(">I", magic)
    n = 4 + 8 + 2 + len(body) + 4
    out = head + struct.pack("<Q", n) + b"\x00\x00" + body   # version 0, uncompressed
    return out + struct.pack("<I", zstd.crc32c(out))


def _read_data_file_table(r: _Reader, transitive: str) -> list[DataFileId]:
    n = r.varint()
    prefix = [0] + r.varints(max(n - 1, 0))
    suffix = r.varints(n)
    base_len = r.varints(n)
    files, prev = [], b""
    for i in range(n):
        if prefix[i] > len(prev):
            r.fail("data file path prefix longer than the previous path")
        full = prev[:prefix[i]] + r.take(suffix[i])
        if base_len[i] > len(full):
            r.fail("base path longer than the path")
        files.append(DataFileId(transitive + full[:base_len[i]].decode(),
                                full[base_len[i]:].decode()))
        prev = full
    return files


def _read_keys(r: _Reader, n: int, interior: bool) -> tuple[list[bytes], list[int]]:
    prefix = [0] + r.varints(max(n - 1, 0))
    suffix = r.varints(n)
    common = r.varints(n) if interior else []
    keys, prev = [], b""
    for i in range(n):
        if prefix[i] > len(prev):
            r.fail("key prefix longer than the previous key")
        prev = prev[:prefix[i]] + r.take(suffix[i])
        keys.append(prev)
    return keys, common


def _file(files: list[DataFileId], i: int, r: _Reader) -> DataFileId:
    if i >= len(files):
        r.fail(f"data file id {i} of {len(files)}")
    return files[i]


def parse_manifest(buf: bytes) -> tuple[Config, list[Version]]:
    """(config, the inline versions oldest first) of a manifest file."""
    r = _Reader(_decode_envelope(buf, MANIFEST_MAGIC, "manifest"), "manifest")
    uid = r.take(16)
    kind, max_inline, max_node = r.varint(), r.varint(), r.varint()
    arity_log2, compression = r.u8(), r.varint()
    level = 0
    if compression == 1:
        level = struct.unpack("<i", r.take(4))[0]
    elif compression != 0:
        r.fail(f"compression method {compression}")
    config = Config(uid, kind, max_inline, max_node, arity_log2, compression, level)
    if kind != 0:
        raise FormatError(f"ocdbt manifest kind {kind} (numbered) is not supported; "
                          "orbax writes single manifests")
    files = _read_data_file_table(r, "")
    n = r.varint()
    gen, height = r.varints(n), [r.u8() for _ in range(n)]
    fid, off, length = r.varints(n), r.varints(n), r.varints(n)
    nkeys, tbytes, ibytes = r.varints(n), r.varints(n), r.varints(n)
    ctime = [struct.unpack("<Q", r.take(8))[0] for _ in range(n)]
    versions = []
    for i in range(n):
        root = (IndirectRef(_file(files, fid[i], r), off[i], length[i])
                if nkeys[i] or length[i] else None)
        versions.append(Version(gen[i], height[i], root, nkeys[i], tbytes[i], ibytes[i],
                                ctime[i]))
    # References to older version-tree nodes: parsed to check the layout,
    # never followed (the newest version is inline).
    m = r.varint()
    for _ in range(5):    # generation, file id, offset, length, generation count
        r.varints(m)
    r.take(8 * m)         # commit times
    r.take(m)             # heights
    r.done()
    return config, versions


def resolve_under(root: str, rel: str) -> str:
    """``rel``, a path named by a checkpoint's own bytes, joined onto
    ``root``; refused unless it is relative, has no ``..`` component and
    stays under ``root`` once symbolic links are resolved (a crafted store
    must not make the reader read any other file on the host)."""
    if not rel or rel.startswith("/") or "\0" in rel or ".." in rel.split("/"):
        raise FormatError(f"ocdbt: data file path {rel!r} is not a relative path "
                          "inside the checkpoint")
    real_root = os.path.realpath(root)
    full = os.path.realpath(os.path.join(real_root, rel))
    if os.path.commonpath([full, real_root]) != real_root:
        raise FormatError(f"ocdbt: data file path {rel!r} leaves the checkpoint")
    return full


def _pread_into(path: str, offset: int, view: memoryview) -> None:
    """Fill ``view`` from ``path`` at ``offset``; one read call moves at
    most about 2 GiB, so large values take several."""
    with open(path, "rb") as f:
        done = 0
        while done < len(view):
            got = os.preadv(f.fileno(), [view[done:]], offset + done)
            if got <= 0:
                raise FormatError(f"ocdbt: {path} ends before byte {offset + len(view)}")
            done += got


def _pread(path: str, offset: int, length: int) -> bytearray:
    buf = bytearray(length)
    _pread_into(path, offset, memoryview(buf))
    return buf


class Store:
    """The newest version of an OCDBT store, as a sorted key -> value map.

    Values are ``bytes`` when inline and :class:`IndirectRef` otherwise;
    :meth:`read` gives any value's bytes."""

    def __init__(self, root: str):
        self.root = root
        self.entries: dict[bytes, bytes | IndirectRef] = {}
        manifest = os.path.join(root, MANIFEST)
        if os.path.exists(manifest):
            self._load(root, "")
        else:
            procs = sorted(d for d in os.listdir(root) if d.startswith(PROCESS_PREFIX)
                           and os.path.exists(os.path.join(root, d, MANIFEST)))
            if not procs:
                raise FormatError(f"ocdbt: no {MANIFEST} under {root}")
            for d in procs:
                self._load(os.path.join(root, d), d + "/")
        self.entries = dict(sorted(self.entries.items()))

    def _load(self, store_dir: str, base: str):
        with open(os.path.join(store_dir, MANIFEST), "rb") as f:
            self.config, versions = parse_manifest(f.read())
        if versions and versions[-1].root is not None:
            v = versions[-1]
            root = IndirectRef(DataFileId(base + v.root.file.base, v.root.file.rel),
                               v.root.offset, v.root.length)
            self._walk(root, v.root_height, b"")
            if len(self.entries) < v.num_keys:
                raise FormatError(f"ocdbt: {store_dir} version {v.generation} declares "
                                  f"{v.num_keys} keys, its tree holds {len(self.entries)}")

    def _walk(self, ref: IndirectRef, height: int, prefix: bytes):
        what = f"node {ref.file.path}@{ref.offset}"
        buf = _pread(resolve_under(self.root, ref.file.path), ref.offset, ref.length)
        r = _Reader(_decode_envelope(buf, BTREE_MAGIC, what), what)
        if r.u8() != height:
            r.fail(f"height differs from the parent's {height}")
        files = _read_data_file_table(r, ref.file.base)
        n = r.varint()
        keys, common = _read_keys(r, n, interior=height > 0)
        if height > 0:
            fid, off, length = r.varints(n), r.varints(n), r.varints(n)
            r.varints(n), r.varints(n), r.varints(n)   # key count, tree bytes, value bytes
            r.done()
            for i in range(n):
                if common[i] > len(keys[i]):
                    r.fail("subtree common prefix longer than the key")
                self._walk(IndirectRef(_file(files, fid[i], r), off[i], length[i]),
                           height - 1, prefix + keys[i][:common[i]])
            return
        lengths, kinds = r.varints(n), r.varints(n)
        indirect = [i for i in range(n) if kinds[i] == 1]
        if any(k not in (0, 1) for k in kinds):
            r.fail("value kind not 0 or 1")
        fid, off = r.varints(len(indirect)), r.varints(len(indirect))
        for j, i in enumerate(indirect):
            self.entries[prefix + keys[i]] = IndirectRef(_file(files, fid[j], r), off[j],
                                                         lengths[i])
        for i in range(n):
            if kinds[i] == 0:
                self.entries[prefix + keys[i]] = r.take(lengths[i])
        r.done()

    def has(self, key: bytes) -> bool:
        return key in self.entries

    def read(self, key: bytes) -> bytes | bytearray:
        """Value ``key``'s bytes (an indirect one read straight into a new
        ``bytearray``)."""
        v = self.entries[key]
        if isinstance(v, bytes):
            return v
        return _pread(resolve_under(self.root, v.file.path), v.offset, v.length)


# ------------------------------------------------------------------ writer --

def _varint(v: int) -> bytes:
    out = bytearray()
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _varints(vs) -> bytes:
    return b"".join(_varint(v) for v in vs)


def _data_file_table(files: list[DataFileId]) -> bytes:
    paths = [(f.base + f.rel).encode() for f in files]
    prefix = []
    for a, b in zip(paths, paths[1:]):
        k = 0
        while k < min(len(a), len(b)) and a[k] == b[k]:
            k += 1
        prefix.append(k)
    suffix = [len(p) - k for p, k in zip(paths, [0] + prefix)]
    return (_varint(len(files)) + _varints(prefix) + _varints(suffix)
            + _varints(len(f.base.encode()) for f in files)
            + b"".join(p[k:] for p, k in zip(paths, [0] + prefix)))


def _leaf_node(entries: list[tuple[bytes, bytes | IndirectRef]], files: list[DataFileId]) -> bytes:
    keys = [k for k, _ in entries]
    prefix = []
    for a, b in zip(keys, keys[1:]):
        k = 0
        while k < min(len(a), len(b)) and a[k] == b[k]:
            k += 1
        prefix.append(k)
    suffix_bytes = [key[k:] for key, k in zip(keys, [0] + prefix)]
    values = [v for _, v in entries]
    indirect = [v for v in values if isinstance(v, IndirectRef)]
    body = (b"\x00" + _data_file_table(files) + _varint(len(entries))
            + _varints(prefix) + _varints(len(s) for s in suffix_bytes) + b"".join(suffix_bytes)
            + _varints(v.length if isinstance(v, IndirectRef) else len(v) for v in values)
            + _varints(int(isinstance(v, IndirectRef)) for v in values)
            + _varints(files.index(v.file) for v in indirect)
            + _varints(v.offset for v in indirect)
            + b"".join(v for v in values if isinstance(v, bytes)))
    if len(body) > MAX_DECODED_NODE_BYTES:
        raise FormatError(f"ocdbt writer: one leaf of {len(body)} bytes exceeds "
                          f"{MAX_DECODED_NODE_BYTES}")
    return _encode_envelope(BTREE_MAGIC, body)


def _manifest(uid: bytes, files: list[DataFileId], root: IndirectRef | None,
              num_keys: int, tree_bytes: int, value_bytes: int) -> bytes:
    body = (uid + _varint(0) + _varint(MAX_INLINE_VALUE_BYTES)
            + _varint(MAX_DECODED_NODE_BYTES) + bytes([VERSION_TREE_ARITY_LOG2])
            + _varint(0))                                  # compression: none
    commit = time.time_ns()
    body += _data_file_table(files) + _varint(1) + _varint(1) + b"\x00"   # generation 1, leaf root
    body += (_varint(files.index(root.file) if root else 0) + _varint(root.offset if root else 0)
             + _varint(root.length if root else 0) + _varint(num_keys) + _varint(tree_bytes)
             + _varint(value_bytes) + struct.pack("<Q", commit))
    body += _varint(0)                                     # no older version-tree nodes
    return _encode_envelope(MANIFEST_MAGIC, body)


def _fsync_write(path: str, parts) -> int:
    n = 0
    with open(path, "wb") as f:
        for p in parts:
            f.write(p)
            n += len(p)
        f.flush()
        os.fsync(f.fileno())
    return n


def _put_value(f, file: DataFileId, offset: int, value) -> bytes | IndirectRef:
    """``value``'s entry: its bytes when inline, else an :class:`IndirectRef`
    to ``offset`` of ``file``, where it is written through ``f``."""
    views = [memoryview(p).cast("B") for p in (value if isinstance(value, list) else [value])]
    size = sum(len(v) for v in views)
    if size <= MAX_INLINE_VALUE_BYTES:
        return b"".join(bytes(v) for v in views)
    for v in views:
        f.write(v)
    return IndirectRef(file, offset, size)


def write_store(root: str, items) -> int:
    """Write ``items``, (key, value) pairs whose value is bytes-like or a
    list of bytes-like parts written one after another, as orbax lays a
    one-process store out: ``ocdbt.process_0/`` holds the values larger
    than :data:`MAX_INLINE_VALUE_BYTES` in one data file, followed by the
    leaf node of its one version, and its manifest; the root's
    ``manifest.ocdbt`` and ``d/`` leaf reference that data file. The pairs
    are drawn one at a time and each large value is written before the
    next is drawn, so a generator's values are never in memory together.
    Nodes and manifests are stored uncompressed, and the config says so.
    Returns the bytes written."""
    proc = f"{PROCESS_PREFIX}0"
    proc_dir = os.path.join(root, proc)
    os.makedirs(os.path.join(proc_dir, "d"), exist_ok=True)
    os.makedirs(os.path.join(root, "d"), exist_ok=True)
    data_rel = f"d/{uuid_mod.uuid4().hex}"
    data_file = DataFileId("", data_rel)
    values: dict[bytes, bytes | IndirectRef] = {}
    offset = 0
    with open(os.path.join(proc_dir, data_rel), "wb") as f:
        for key, value in items:
            key_b = key.encode() if isinstance(key, str) else bytes(key)
            if key_b in values:
                raise FormatError(f"ocdbt writer: key {key_b!r} given twice")
            values[key_b] = _put_value(f, data_file, offset, value)
            if isinstance(values[key_b], IndirectRef):
                offset += values[key_b].length
            del value              # this value's memory is free before the next is drawn
        value_bytes = offset
        entries = sorted(values.items())
        files = [data_file] if value_bytes else []
        leaf = _leaf_node(entries, files)
        f.write(leaf)
        f.flush()
        os.fsync(f.fileno())
    written = value_bytes + len(leaf)
    proc_root = IndirectRef(data_file, value_bytes, len(leaf)) if entries else None
    manifest = _manifest(uuid_mod.uuid4().bytes, [data_file], proc_root, len(entries),
                         len(leaf), value_bytes)
    written += _fsync_write(os.path.join(proc_dir, MANIFEST), [manifest])
    # The root store: one leaf in its own d/, every indirect value still in
    # the process store's data file (its base path names the store).
    root_files = [DataFileId(proc + "/", data_rel)] if value_bytes else []
    root_entries = [(k, IndirectRef(root_files[0], v.offset, v.length)
                     if isinstance(v, IndirectRef) else v) for k, v in entries]
    root_leaf = _leaf_node(root_entries, root_files)
    root_rel = f"d/{uuid_mod.uuid4().hex}"
    written += _fsync_write(os.path.join(root, root_rel), [root_leaf])
    root_ref = (IndirectRef(DataFileId("", root_rel), 0, len(root_leaf))
                if entries else None)
    manifest = _manifest(uuid_mod.uuid4().bytes, [DataFileId("", root_rel)], root_ref,
                         len(entries), len(root_leaf), value_bytes)
    written += _fsync_write(os.path.join(root, MANIFEST), [manifest])
    return written
