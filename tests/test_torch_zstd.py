"""The port's zstd decoder (``csrc/zstd_decode.cpp`` through
``kukeon_tpu_torch.models.zstd``) against the ``zstandard`` package's
encoder and decoder, on the CPU: the library builds here with the host
compiler. Only this test imports ``zstandard``; the port never does.

Every decode must equal the original bytes exactly. Corrupt input must
raise ``ZstdError`` (the decoder bounds-checks every read): a truncated
frame always, a bit-flipped one unless what it decodes to is still the
original (a flip in a field that does not change the content, such as the
window size, is legal), never a crash or wrong bytes past the checksum.
"""

import io

import numpy as np
import pytest
import torch
import zstandard
from hypothesis import given, settings
from hypothesis import strategies as st

from kukeon_tpu_torch.models import zstd
from kukeon_tpu_torch.ops import _build

torch.set_num_threads(2)


def _data(kind: str, n: int, seed: int = 0) -> bytes:
    rng = np.random.default_rng(seed)
    if kind == "random":
        return rng.bytes(n)
    if kind == "bf16":        # bf16-like: the top halves of normal f32 draws
        f = rng.standard_normal(n // 2).astype(np.float32)
        return (f.view(np.uint32) >> 16).astype(np.uint16).tobytes()[:n]
    if kind == "repetitive":
        unit = b"kukeon " * 37 + rng.bytes(11)
        return (unit * (n // len(unit) + 1))[:n]
    raise ValueError(kind)


CASES = [("empty", b""), ("one", b"x")] + [
    (k, _data(k, 300_000)) for k in ("random", "bf16", "repetitive")]


@pytest.mark.parametrize("level", [1, 3, 19])
@pytest.mark.parametrize("checksum", [False, True])
@pytest.mark.parametrize("content_size", [False, True])
@pytest.mark.parametrize("kind", [k for k, _ in CASES])
def test_decode_equals_zstandard(level, checksum, content_size, kind):
    data = dict(CASES)[kind]
    frame = zstandard.ZstdCompressor(level=level, write_checksum=checksum,
                                     write_content_size=content_size).compress(data)
    assert zstd.decompress(frame) == data
    size, exact = zstd.frame_info(frame)
    if content_size:
        assert (size, exact) == (len(data), True)
    else:
        assert size >= len(data) and not exact
    out = np.empty(len(data) + 16, np.uint8)
    assert zstd.decompress(frame, out).tobytes() == data


@pytest.mark.parametrize("kind", ["random", "bf16", "repetitive"])
def test_decode_64_mib(kind):
    data = _data(kind, 64 << 20, seed=1)
    frame = zstandard.ZstdCompressor(level=1, write_checksum=True).compress(data)
    out = np.empty(len(data), np.uint8)
    assert zstd.decompress(frame, out).nbytes == len(data)
    assert out.tobytes() == data


def test_frames_without_content_size_from_a_stream():
    """A streamed frame (no content size, many blocks, repeat tables and
    treeless literals across them) decodes; frame_info bounds it."""
    data = _data("bf16", 3_000_000, seed=2) + _data("repetitive", 1_000_000)
    buf = io.BytesIO()
    with zstandard.ZstdCompressor(level=3).stream_writer(buf, closefd=False) as w:
        for i in range(0, len(data), 65_536):
            w.write(data[i:i + 65_536])
    frame = buf.getvalue()
    assert zstd.decompress(frame) == data
    size, exact = zstd.frame_info(frame)
    assert size >= len(data) and not exact


def test_concatenated_and_skippable_frames():
    parts = [_data("bf16", 100_000), b"", _data("repetitive", 50_000), b"z"]
    stream = b""
    for i, p in enumerate(parts):
        stream += zstandard.ZstdCompressor(level=[1, 3, 19, 1][i],
                                           write_checksum=bool(i % 2)).compress(p)
        # A skippable frame (magic 0x184D2A5X, 4-byte size, payload) between.
        stream += (0x184D2A50 + i).to_bytes(4, "little") + (5).to_bytes(4, "little") + b"skip!"
    stream += zstd.compress_stored(b"tail")
    want = b"".join(parts) + b"tail"
    assert zstd.decompress(stream) == want
    assert zstd.frame_info(stream) == (len(want), True)     # every header has its size


@pytest.mark.parametrize("n", [0, 1, 131_071, 131_072, 131_073, 1_000_000])
def test_compress_stored_round_trips(n):
    data = _data("random", n, seed=n)
    frame = zstd.compress_stored(data)
    # A 14-byte header, then 3 bytes a block of at most 128 KiB (one at 0).
    assert len(frame) == 14 + 3 * max(1, -(-n // (128 << 10))) + n
    assert zstandard.ZstdDecompressor().decompress(frame) == data
    assert zstd.decompress(frame) == data
    assert zstd.frame_info(frame) == (n, True)
    assert b"".join(bytes(p) for p in zstd.stored_frame_parts(data)) == frame


def test_errors_are_raised_not_crashes():
    frame = zstandard.ZstdCompressor(level=3, write_checksum=True).compress(
        _data("bf16", 200_000))
    with pytest.raises(zstd.ZstdError, match="destination too small"):
        zstd.decompress(frame, np.empty(1000, np.uint8))
    with pytest.raises(zstd.ZstdError, match="truncated"):
        zstd.decompress(b"")
    with pytest.raises(zstd.ZstdError, match="magic"):
        zstd.decompress(b"not a zstd frame")
    bad = bytearray(frame)
    bad[-1] ^= 0xFF                                   # the checksum
    with pytest.raises(zstd.ZstdError, match="checksum"):
        zstd.decompress(bytes(bad))
    samples = [b"kukeon %d dictionary sample %s" % (i, b"ab" * (i % 7)) for i in range(400)]
    d = zstandard.train_dictionary(2048, samples)     # a trained one carries its id
    with_dict = zstandard.ZstdCompressor(dict_data=d).compress(samples[3])
    with pytest.raises(zstd.ZstdError, match="dictionary"):
        zstd.decompress(with_dict)


def test_crc32c_known_value():
    assert zstd.crc32c(b"123456789") == 0xE3069283          # the CRC-32C check value
    assert zstd.crc32c(b"6789", zstd.crc32c(b"12345")) == 0xE3069283


def test_build_uses_the_host_compiler(monkeypatch):
    """No nvcc: the decoder is plain C++17; a missing host compiler is a
    clear error."""
    assert _build.library_path(_build.ZSTD_DECODE).name.startswith("libzstd_decode_")
    monkeypatch.setenv("CXX", "/nonexistent/c++")
    with pytest.raises(RuntimeError, match="host C\\+\\+ compiler"):
        _build.find_cxx()


_ORIGINALS = [_data("bf16", 20_000, 3), _data("repetitive", 20_000), _data("random", 3_000, 4)]
_FRAMES = [zstandard.ZstdCompressor(level=lvl, write_checksum=True).compress(d)
           for lvl, d in zip((1, 19, 3), _ORIGINALS)]


@settings(max_examples=300, deadline=None)
@given(which=st.integers(0, len(_FRAMES) - 1), cut=st.floats(0, 1, exclude_max=True))
def test_truncated_frames_raise(which, cut):
    frame = _FRAMES[which]
    with pytest.raises(zstd.ZstdError):
        zstd.decompress(frame[:int(cut * len(frame))])


@settings(max_examples=400, deadline=None)
@given(which=st.integers(0, len(_FRAMES) - 1),
       flips=st.lists(st.tuples(st.floats(0, 1, exclude_max=True), st.integers(0, 7)),
                      min_size=1, max_size=3))
def test_bit_flipped_frames_raise_or_decode_the_original(which, flips):
    frame = bytearray(_FRAMES[which])
    for where, bit in flips:
        frame[int(where * len(frame))] ^= 1 << bit
    try:
        got = zstd.decompress(bytes(frame))
    except zstd.ZstdError:
        return
    assert got == _ORIGINALS[which]
