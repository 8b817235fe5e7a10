"""zstd frames for the checkpoint reader: decode with the port's own
decoder (``csrc/zstd_decode.cpp``, RFC 8878), write stored frames.

:func:`decompress` decodes every frame of a buffer into a new ``bytes`` or
into a buffer the caller supplies (a preallocated numpy array, or the
memory behind a pinned tensor), so a zarr chunk lands where its array
lives without another copy. The call releases the GIL (ctypes), so reader
threads decode frames in parallel. :func:`frame_info` reports the decoded
size, exact when the headers carry it and an upper bound otherwise.
:func:`compress_stored` writes a valid frame of raw blocks, with the
content size in its header: the port has no entropy encoder, so its
writer stores what orbax would have compressed.

The library is built from source with the host compiler at first use
(``ops._build.load_zstd``); no ``zstandard`` package is imported.
"""

from __future__ import annotations

import ctypes

import numpy as np

from kukeon_tpu_torch.ops import _build

_MAGIC = b"\x28\xb5\x2f\xfd"
_BLOCK = 1 << 17          # 128 KiB, zstd's largest block
_WINDOW_128K = 0x38       # window descriptor: 2^(10 + 7) bytes
_FHD_FCS8 = 0xC0          # frame header descriptor: 8-byte content size

_ERRORS = {
    -1: "source truncated", -2: "unknown frame magic", -3: "bad frame header",
    -4: "frame needs a dictionary", -5: "corrupt block", -6: "destination too small",
    -7: "corrupt literals section", -8: "corrupt Huffman table or stream",
    -9: "corrupt FSE table", -10: "corrupt sequences section", -11: "offset out of range",
    -12: "content checksum mismatch", -13: "content size mismatch",
}


class ZstdError(ValueError):
    """A corrupt or unsupported zstd frame."""


def _check(code: int) -> int:
    if code < 0:
        raise ZstdError(f"zstd: {_ERRORS.get(code, f'error {code}')}")
    return code


def _src(buf) -> tuple[object, int, int]:
    """(keep-alive object, address, length) of a bytes-like source."""
    if isinstance(buf, np.ndarray):
        arr = np.ascontiguousarray(buf).view(np.uint8).reshape(-1)
    else:
        arr = np.frombuffer(memoryview(buf).cast("B"), np.uint8)
    if arr.size == 0:
        return arr, 0, 0
    return arr, arr.ctypes.data, arr.size


def frame_info(buf) -> tuple[int, bool]:
    """(decoded size, exact) of every frame in ``buf`` summed: exact when
    each frame header carries its content size, else an upper bound from
    the block headers. Raises :class:`ZstdError` on a malformed buffer."""
    keep, addr, n = _src(buf)
    size, exact = ctypes.c_uint64(0), ctypes.c_int(0)
    _check(_build.load_zstd().kukeon_zstd_frame_info(addr, n, ctypes.byref(size),
                                                     ctypes.byref(exact)))
    del keep
    return int(size.value), bool(exact.value)


def decompress(buf, out: np.ndarray | None = None):
    """Decode every frame in ``buf``.

    Without ``out``: returns the content as ``bytes``. With ``out`` (a
    writable C-contiguous array of any dtype, e.g. the destination leaf or
    a view of pinned memory): decodes into its bytes and returns the
    ``uint8`` view of the part written. Raises :class:`ZstdError` on a
    corrupt frame, a failed checksum or an ``out`` too small."""
    keep, addr, n = _src(buf)
    lib = _build.load_zstd()
    if out is None:
        size, _exact = frame_info(buf)
        dst = np.empty(size, np.uint8)
    else:
        if not (out.flags.c_contiguous and out.flags.writeable):
            raise ValueError("decompress: out must be a writable C-contiguous array")
        dst = out.reshape(-1).view(np.uint8)
    written = _check(lib.kukeon_zstd_decompress(addr, n, dst.ctypes.data if dst.size else 0,
                                                dst.size))
    del keep
    return dst[:written].tobytes() if out is None else dst[:written]


def crc32c(buf, crc: int = 0) -> int:
    """CRC-32C (Castagnoli) of ``buf``, chained from ``crc``."""
    keep, addr, n = _src(buf)
    c = int(_build.load_zstd().kukeon_crc32c(addr, n, crc))
    del keep
    return c


def stored_frame_parts(buf) -> list:
    """The pieces of :func:`compress_stored`'s frame in order (header and
    block headers as ``bytes``, the payload as memoryview slices of
    ``buf``), so a writer streams a large leaf to disk without a copy."""
    mv = memoryview(buf).cast("B")
    n = len(mv)
    parts = [_MAGIC + bytes((_FHD_FCS8, _WINDOW_128K)) + n.to_bytes(8, "little")]
    if n == 0:
        parts.append((1).to_bytes(3, "little"))   # one empty raw block, last
        return parts
    for start in range(0, n, _BLOCK):
        size = min(_BLOCK, n - start)
        last = start + size == n
        parts.append(((size << 3) | int(last)).to_bytes(3, "little"))
        parts.append(mv[start:start + size])
    return parts


def compress_stored(buf) -> bytes:
    """A valid zstd frame holding ``buf`` in raw blocks: a 128 KiB window,
    the content size in the header, no checksum. Any zstd decoder reads it;
    nothing is entropy-coded, so it is as large as its content plus a
    header and 3 bytes a block."""
    return b"".join(stored_frame_parts(buf))
