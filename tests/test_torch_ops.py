"""The port's ops against the JAX package's, on the CPU.

Inputs are drawn with numpy from a seed and fed to both. The int8 matmul's
plain version is held against the Pallas kernel bodies themselves
(``_kernel``/``_kernel_t`` under ``pl.pallas_call(interpret=True)`` with the
kernel's own BlockSpecs and tile rule), the way test_flash_attention.py runs
the flash kernel; the CUDA kernel is held against the same plain version on
the card by chip_smoke.py.
"""

import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from kukeon_tpu.ops import attention as jattn
from kukeon_tpu.ops import int8_matmul as jk1
from kukeon_tpu.ops import norms as jnorms
from kukeon_tpu.ops import rope as jrope
from kukeon_tpu_torch.ops import _build
from kukeon_tpu_torch.ops import attention as tattn
from kukeon_tpu_torch.ops import int8_matmul as tk1
from kukeon_tpu_torch.ops.norms import rms_norm
from kukeon_tpu_torch.ops.rope import apply_rope, rope_frequencies

torch.set_num_threads(2)

# f32 algorithm parity: same math, different summation order.
F32_TOL = dict(rtol=1e-5, atol=1e-5)


def _k1_interpret(h, q, s, transpose):
    """K1 exactly as kukeon_tpu/ops/int8_matmul.py launches it on a TPU
    (B padded to 16, ``_tile_n`` grid, the same BlockSpecs), interpreted."""
    B, K = h.shape
    N = q.shape[0] if transpose else q.shape[1]
    Bp = max(16, ((B + 15) // 16) * 16)
    h = jnp.pad(h, ((0, Bp - B), (0, 0)))
    T = jk1._tile_n(K, N)
    if transpose:
        kernel, q_spec = jk1._kernel_t, pl.BlockSpec((T, K), lambda j: (j, 0))
    else:
        kernel, q_spec = jk1._kernel, pl.BlockSpec((K, T), lambda j: (0, j))
    out = pl.pallas_call(
        kernel,
        out_shape=jax.ShapeDtypeStruct((Bp, N), h.dtype),
        grid=(N // T,),
        in_specs=[pl.BlockSpec((Bp, K), lambda j: (0, 0)), q_spec,
                  pl.BlockSpec((1, T), lambda j: (0, j))],
        out_specs=pl.BlockSpec((Bp, T), lambda j: (0, j)),
        interpret=True,
    )(h, q, s.reshape(1, N))
    return out[:B]


def _int8_operands(rng, B, K, N, transpose):
    h = rng.standard_normal((B, K)).astype(np.float32)
    qshape = (N, K) if transpose else (K, N)
    q = rng.integers(-127, 128, qshape).astype(np.int8)
    s = (rng.random(N).astype(np.float32) * 0.02 + 1e-3).astype(np.float32)
    return h, q, s


def _bf16_np(x_t: torch.Tensor) -> np.ndarray:
    return x_t.float().numpy()


@pytest.mark.parametrize("transpose", [False, True])
@pytest.mark.parametrize("B", [1, 3, 16])
def test_int8_matmul_reference_matches_pallas_body_bf16(B, transpose):
    """bf16: the port's plain version vs the interpreted Pallas body, to
    within 1 bf16 ulp of the output's magnitude (the f32 sums differ only
    in order; one rounding to bf16 can then land one ulp apart)."""
    rng = np.random.default_rng(10 + B)
    K, N = 256, 384
    h, q, s = _int8_operands(rng, B, K, N, transpose)
    h_bf = torch.from_numpy(h).to(torch.bfloat16)
    ref = _k1_interpret(jnp.asarray(_bf16_np(h_bf), jnp.bfloat16), jnp.asarray(q),
                        jnp.asarray(s), transpose)
    ref = np.asarray(ref.astype(jnp.float32))
    out = tk1.int8_matmul_reference(h_bf, torch.from_numpy(q), torch.from_numpy(s),
                                    transpose=transpose)
    assert out.dtype == torch.bfloat16 and out.shape == (B, N)
    out = _bf16_np(out)
    ulp = np.abs(ref) * 2.0 ** -7 + 1e-30      # 1 bf16 ulp at each output
    assert np.all(np.abs(out - ref) <= ulp), np.max(np.abs(out - ref) / ulp)


@pytest.mark.parametrize("transpose", [False, True])
def test_int8_matmul_reference_matches_jax_f32(transpose):
    """f32: the port's plain version vs the JAX int8_matmul (its XLA path
    off TPU) and vs the interpreted body, within 1e-5 relative."""
    rng = np.random.default_rng(3)
    h, q, s = _int8_operands(rng, 5, 256, 256, transpose)
    out = tk1.int8_matmul_reference(torch.from_numpy(h), torch.from_numpy(q),
                                    torch.from_numpy(s), transpose=transpose).numpy()
    xla = np.asarray(jk1.int8_matmul(jnp.asarray(h), jnp.asarray(q), jnp.asarray(s),
                                     transpose=transpose))
    body = np.asarray(_k1_interpret(jnp.asarray(h), jnp.asarray(q), jnp.asarray(s),
                                    transpose))
    scale = np.max(np.abs(xla))
    np.testing.assert_allclose(out, xla, rtol=1e-5, atol=1e-5 * scale)
    np.testing.assert_allclose(out, body, rtol=1e-5, atol=1e-5 * scale)


def test_int8_matmul_cpu_takes_plain_version_and_counts_no_launch():
    rng = np.random.default_rng(4)
    h, q, s = _int8_operands(rng, 4, 128, 256, False)
    before = tk1.int8_matmul.launches
    out = tk1.int8_matmul(torch.from_numpy(h), torch.from_numpy(q), torch.from_numpy(s))
    ref = tk1.int8_matmul_reference(torch.from_numpy(h), torch.from_numpy(q),
                                    torch.from_numpy(s))
    assert torch.equal(out, ref)
    assert tk1.int8_matmul.launches == before


@pytest.mark.parametrize("bad", ["dtype_q", "dtype_s", "dtype_h", "shape", "contig"])
def test_int8_matmul_rejects_what_the_kernel_does_not_take(bad):
    h = torch.ones(4, 128)
    q = torch.ones(128, 256, dtype=torch.int8)
    s = torch.ones(256)
    if bad == "dtype_q":
        q = q.float()
    elif bad == "dtype_s":
        s = s.to(torch.bfloat16)
    elif bad == "dtype_h":
        h = h.half()
    elif bad == "shape":
        q = torch.ones(256, 256, dtype=torch.int8)
    else:
        h = torch.ones(128, 4).T
    with pytest.raises(ValueError):
        tk1.int8_matmul(h, q, s)


@pytest.mark.parametrize("B,K,N,transpose,ks", [
    (4, 4096, 4096, False, 64),       # 8B wq/wo: 8 tiles x 64 slices
    (4, 4096, 1024, False, 64),       # 8B wk/wv: 2 tiles, as many slices as allowed
    (4, 4096, 14336, False, 256),     # 28 tiles x 16 slices
    (4, 14336, 4096, False, 256),
    (4, 4096, 128256, False, 512),    # 8B untied head: 251 tiles x 8 slices
    (4, 2048, 128256, True, 512),     # 1B tied head
    (64, 4096, 4096, False, 512),     # 8 row groups x 8 tiles x 8 slices
])
def test_k_slice_plan(B, K, N, transpose, ks):
    got = tk1.k_slice(B, K, N, transpose)
    assert got == ks and K % got == 0 and got <= 512


def test_kernel_build_needs_nvcc_and_is_lazy(monkeypatch):
    """Importing the op builds nothing; asking for the library on a host
    without nvcc raises a clear error (no silent fallback)."""
    monkeypatch.setenv("PATH", "/nonexistent")
    monkeypatch.setenv("CUDA_HOME", "/nonexistent")
    monkeypatch.setattr(_build.os, "access", lambda *a: False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.find_nvcc()
    lib = _build.library_path("int8_matmul.cu")
    assert lib.parent == _build.BUILD_DIR and lib.name.startswith("libint8_matmul_")


def test_rms_norm_matches_jax():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 5, 64)).astype(np.float32)
    w = rng.standard_normal(64).astype(np.float32)
    ref = np.asarray(jnorms.rms_norm(jnp.asarray(x), jnp.asarray(w)))
    out = rms_norm(torch.from_numpy(x), torch.from_numpy(w)).numpy()
    np.testing.assert_allclose(out, ref, **F32_TOL)


def test_rope_matches_jax():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 7, 4, 32)).astype(np.float32)
    pos = rng.integers(0, 300, (2, 7)).astype(np.int32)
    ref = np.asarray(jrope.apply_rope(jnp.asarray(x), jnp.asarray(pos), 10_000.0))
    out = apply_rope(torch.from_numpy(x), torch.from_numpy(pos).long(), 10_000.0).numpy()
    np.testing.assert_allclose(out, ref, **F32_TOL)
    np.testing.assert_allclose(rope_frequencies(32, 500_000.0).numpy(),
                               np.asarray(jrope.rope_frequencies(32, 500_000.0)),
                               **F32_TOL)


def _qkv(rng, B, Sq, Skv, H, KV, D):
    return (rng.standard_normal((B, Sq, H, D)).astype(np.float32),
            rng.standard_normal((B, Skv, KV, D)).astype(np.float32),
            rng.standard_normal((B, Skv, KV, D)).astype(np.float32))


def test_attention_grouped_and_reference_match_jax():
    rng = np.random.default_rng(2)
    B, S, H, KV, D = 2, 9, 4, 2, 16
    q, k, v = _qkv(rng, B, S, S, H, KV, D)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S)).copy()
    klen = np.array([9, 5], np.int32)
    jmask = jattn.attention_mask(jnp.asarray(pos), jnp.asarray(pos), jnp.asarray(klen))
    tmask = tattn.attention_mask(torch.from_numpy(pos), torch.from_numpy(pos),
                                 torch.from_numpy(klen))
    assert np.array_equal(np.asarray(jmask), tmask.numpy())
    ref = np.asarray(jattn.attention_grouped(*map(jnp.asarray, (q, k, v)), jmask))
    out = tattn.attention_grouped(*map(torch.from_numpy, (q, k, v)), tmask).numpy()
    np.testing.assert_allclose(out, ref, **F32_TOL)
    jrk, trk = jattn.repeat_kv(jnp.asarray(k), 2), tattn.repeat_kv(torch.from_numpy(k), 2)
    np.testing.assert_array_equal(trk.numpy(), np.asarray(jrk))
    ref = np.asarray(jattn.attention_reference(
        jnp.asarray(q), jrk, jattn.repeat_kv(jnp.asarray(v), 2), jmask))
    out = tattn.attention_reference(torch.from_numpy(q), trk,
                                    tattn.repeat_kv(torch.from_numpy(v), 2), tmask).numpy()
    np.testing.assert_allclose(out, ref, **F32_TOL)
    out = tattn.gqa_attention(*map(torch.from_numpy, (q, k, v)),
                              q_positions=torch.from_numpy(pos),
                              kv_positions=torch.from_numpy(pos),
                              kv_length=torch.from_numpy(klen)).numpy()
    ref = np.asarray(jattn.gqa_attention(*map(jnp.asarray, (q, k, v)),
                                         q_positions=jnp.asarray(pos),
                                         kv_positions=jnp.asarray(pos),
                                         kv_length=jnp.asarray(klen)))
    np.testing.assert_allclose(out, ref, **F32_TOL)


@pytest.mark.parametrize("impl", ["flash", "ring", "ulysses"])
def test_unported_attention_impls_raise(impl):
    x = torch.zeros(1, 4, 2, 8)
    pos = torch.zeros(1, 4, dtype=torch.long)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tattn.gqa_attention(x, x, x, q_positions=pos, kv_positions=pos, impl=impl)


@pytest.mark.parametrize("quantized", [False, True])
def test_decode_gqa_attention_matches_jax(quantized):
    rng = np.random.default_rng(5 + quantized)
    B, S, H, KV, D = 3, 12, 4, 2, 16
    q, kn, vn = _qkv(rng, B, 1, 1, H, KV, D)
    ck = rng.standard_normal((B, S, KV, D)).astype(np.float32)
    cv = rng.standard_normal((B, S, KV, D)).astype(np.float32)
    lengths = np.array([0, 7, 12], np.int32)
    ks = vs = None
    if quantized:
        ck = rng.integers(-127, 128, ck.shape).astype(np.int8)
        cv = rng.integers(-127, 128, cv.shape).astype(np.int8)
        ks = (rng.random((B, S, KV)) * 0.02).astype(np.float32)
        vs = (rng.random((B, S, KV)) * 0.02).astype(np.float32)
    jargs = [jnp.asarray(a) if a is not None else None
             for a in (q, kn, vn, ck, cv, lengths, ks, vs)]
    targs = [torch.from_numpy(a) if a is not None else None
             for a in (q, kn, vn, ck, cv, lengths, ks, vs)]
    ref = np.asarray(jattn.decode_gqa_attention(*jargs[:6], k_scale=jargs[6],
                                                v_scale=jargs[7]))
    out = tattn.decode_gqa_attention(*targs[:6], k_scale=targs[6], v_scale=targs[7]).numpy()
    np.testing.assert_allclose(out, ref, **F32_TOL)


def test_port_imports_no_jax_and_no_reference_module():
    """Every module of kukeon_tpu_torch imports with jax made unimportable,
    and afterwards no ``kukeon_tpu`` / ``kukeon_tpu.*`` module is loaded."""
    code = r"""
import importlib, pkgutil, sys
sys.modules["jax"] = None
import kukeon_tpu_torch
names = [m.name for m in pkgutil.walk_packages(kukeon_tpu_torch.__path__, "kukeon_tpu_torch.")]
for name in names:
    importlib.import_module(name)
leaked = sorted(m for m in sys.modules if m == "kukeon_tpu" or m.startswith("kukeon_tpu."))
assert not leaked, leaked
assert len(names) >= 14, names
print("ok", len(names))
"""
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.startswith("ok")
