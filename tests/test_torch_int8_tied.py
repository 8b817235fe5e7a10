"""K1t, the tied LM head ``h @ q[N, K]^T * s``, on the CPU: the plan of
the bf16 kernel's K slices, which C entry each call takes, what the
wrapper hands that entry, and the plain version against the Pallas
``_kernel_t`` itself (interpreted, at the llama3-1b head's K).

The CUDA kernel is held against the same plain version on the card by
chip_smoke.py (its ``kernel`` phase, at the llama3-1b head and three more
transposed shapes, every B of its list).
"""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from kukeon_tpu.ops import int8_matmul as jk1
from kukeon_tpu_torch.ops import int8_matmul as tk1

torch.set_num_threads(2)


def _most_slices(K: int) -> int:
    """The most K slices a cluster takes: slices of a multiple of 128 that
    divide K, at most 8 of them."""
    return max(K // c for c in range(128, K + 1, 128) if K % c == 0 and K // c <= 8)


@pytest.mark.parametrize("B,K,N,ks", [
    (4, 2048, 128256, 1024),    # llama3-1b tied head: 1002 tiles x 2 slices
    (1, 2048, 128256, 1024),
    (64, 2048, 128256, 2048),   # 8 row groups x 1002 tiles: no split
    (4, 128, 128, 128),         # one tile, one stage
    (4, 128, 1024, 128),
    (4, 4096, 4096, 512),       # 32 tiles x 8 slices, the most
    (4, 14336, 4096, 1792),     # long K: 8 slices of 1792
    (4, 28672, 4096, 3584),     # 8 slices of 3584 (past 2048: any length fits)
    (64, 14336, 4096, 2048),    # 8 row groups x 32 tiles x 7 slices
])
def test_k_slice_plan_for_the_tied_bf16_kernel(B, K, N, ks):
    got = tk1.k_slice_t_bf16(B, K, N)
    assert got == ks
    assert got % 128 == 0 and K % got == 0 and K // got <= 8
    blocks = (N // 128) * -(-B // 8) * (K // got)
    assert blocks >= tk1._T_BF16_BLOCKS or K // got == _most_slices(K)


@pytest.mark.parametrize("transpose", [False, True])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_kernel_entry_by_dtype_and_layout(dtype, transpose):
    want = {(torch.bfloat16, False): ("kukeon_int8_matmul_bf16", tk1.k_slice_bf16),
            (torch.bfloat16, True): ("kukeon_int8_matmul_t_bf16", tk1.k_slice_t_bf16),
            (torch.float32, False): ("kukeon_int8_matmul", None),
            (torch.float32, True): ("kukeon_int8_matmul", None)}[dtype, transpose]
    assert tk1._kernel_entry(dtype, transpose) == want


class _FakeInt8Lib:
    """Stands in for the built library: records each entry's arguments and
    answers ``err``."""

    def __init__(self, err=0):
        self.calls, self.err = [], err

    def __getattr__(self, name):
        if not name.startswith("kukeon_int8_matmul"):
            raise AttributeError(name)

        def entry(*args):
            self.calls.append((name, args))
            return self.err
        return entry


def _fake_launch(monkeypatch, lib, B, K, N, dtype, transpose):
    monkeypatch.setattr(tk1._build, "load_int8_matmul", lambda: lib)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda dev: SimpleNamespace(cuda_stream=0))
    monkeypatch.setattr(tk1.int8_matmul, "launches", 0)
    monkeypatch.setattr(tk1.int8_matmul, "launches_t", 0)
    h = torch.zeros((B, K), dtype=dtype)
    q = torch.zeros((N, K) if transpose else (K, N), dtype=torch.int8)
    s = torch.ones(N)
    return tk1._launch(h, q, s, transpose)


@pytest.mark.parametrize("transpose", [False, True])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_wrapper_hands_each_entry_its_plan_and_counts(monkeypatch, dtype, transpose):
    """bf16 goes to a one-launch entry with its own plan and no workspace;
    f32 to the first design with a [K/ks, B, N] workspace. Each call is one
    launch, and the transposed ones are counted apart."""
    B, K, N = 4, 2048, 1024
    lib = _FakeInt8Lib()
    out = _fake_launch(monkeypatch, lib, B, K, N, dtype, transpose)
    assert out.shape == (B, N) and out.dtype == dtype
    ((name, args),) = lib.calls
    entry, plan = tk1._kernel_entry(dtype, transpose)
    assert name == entry
    if dtype == torch.bfloat16:
        assert len(args) == 9 and args[4:8] == (B, K, N, plan(B, K, N))
    else:
        assert len(args) == 11
        assert args[5:10] == (B, K, N, tk1.k_slice(B, K, N, transpose), int(transpose))
    assert tk1.int8_matmul.launches == 1
    assert tk1.int8_matmul.launches_t == int(transpose)


def test_wrapper_raises_with_the_shape_when_the_tied_launch_fails(monkeypatch):
    """No fallback: an error from the entry raises, and nothing is counted."""
    with pytest.raises(RuntimeError, match="B=4, K=2048, N=1024, ks=256, transpose=True"):
        _fake_launch(monkeypatch, _FakeInt8Lib(err=1), 4, 2048, 1024, torch.bfloat16, True)
    assert tk1.int8_matmul.launches == 0 and tk1.int8_matmul.launches_t == 0


def _kernel_t_interpret(h, q, s):
    """``_kernel_t`` as kukeon_tpu/ops/int8_matmul.py launches it on a TPU
    (B padded to 16, the ``_tile_n`` grid, its BlockSpecs), interpreted."""
    B, K = h.shape
    N = q.shape[0]
    Bp = max(16, -(-B // 16) * 16)
    h = jnp.pad(h, ((0, Bp - B), (0, 0)))
    T = jk1._tile_n(K, N)
    out = pl.pallas_call(
        jk1._kernel_t,
        out_shape=jax.ShapeDtypeStruct((Bp, N), h.dtype),
        grid=(N // T,),
        in_specs=[pl.BlockSpec((Bp, K), lambda j: (0, 0)),
                  pl.BlockSpec((T, K), lambda j: (j, 0)),
                  pl.BlockSpec((1, T), lambda j: (0, j))],
        out_specs=pl.BlockSpec((Bp, T), lambda j: (0, j)),
        interpret=True,
    )(h, q, s.reshape(1, N))
    return out[:B]


@pytest.mark.parametrize("B", [4, 64])
def test_tied_reference_matches_the_pallas_kernel_t_bf16(B):
    """The plain version the card's kernel is held against vs the
    interpreted Pallas body at the llama3-1b head's K, bf16: within 1 bf16
    ulp of each output (the f32 sums differ only in order; one rounding
    to bf16 can then land one ulp apart)."""
    rng = np.random.default_rng(80 + B)
    K, N = 2048, 256
    h = torch.from_numpy(rng.standard_normal((B, K)).astype(np.float32)).to(torch.bfloat16)
    q = rng.integers(-127, 128, (N, K)).astype(np.int8)
    s = (rng.random(N) * 0.02 + 1e-3).astype(np.float32)
    ref = _kernel_t_interpret(jnp.asarray(h.float().numpy(), jnp.bfloat16), jnp.asarray(q),
                              jnp.asarray(s))
    ref = np.asarray(ref.astype(jnp.float32))
    out = tk1.int8_matmul_reference(h, torch.from_numpy(q), torch.from_numpy(s), transpose=True)
    assert out.dtype == torch.bfloat16 and out.shape == (B, N)
    out = out.float().numpy()
    ulp = np.abs(ref) * 2.0 ** -7 + 1e-30
    assert np.all(np.abs(out - ref) <= ulp), np.max(np.abs(out - ref) / ulp)
