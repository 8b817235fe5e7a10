"""Where the port's int8 products go, against the JAX package's rule, on
the CPU.

``int8_matmul`` and ``int8_matmul_expert`` pick a route with
``_route(device type, rows, K, N)``: the plain version on the CPU, the
kernel on CUDA where the reference's TPU path reaches ``pl.pallas_call``,
and the reference's own dequant fallback on CUDA everywhere else. The
reference's rule is read off the JAX functions themselves: each runs with
``jax.default_backend`` reporting a TPU and ``pallas_call`` (for the
expert product, the per-expert ``int8_matmul``) replaced by a marker that
records the kernel route. The fallback's formula is held against the JAX
fallback's output, and K1's bf16 plan against every llama3-8b and Mixtral
trunk decode shape.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kukeon_tpu.ops import int8_matmul as jk1
from kukeon_tpu_torch.ops import int8_matmul as tk1

torch.set_num_threads(2)


class _ReachedKernel(Exception):
    pass


def _reach(*args, **kwargs):
    raise _ReachedKernel


def _jax_route_on_tpu(monkeypatch, B, K, N, expert):
    """"kernel" when the JAX function, told it runs on a TPU, reaches its
    kernel at these sizes, else "dequant" (it computed its fallback)."""
    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    if expert:
        monkeypatch.setattr(jk1, "int8_matmul", _reach)
        call = lambda: jk1.int8_matmul_expert(   # noqa: E731
            jnp.zeros((2, B, K), jnp.float32), jnp.zeros((2, K, N), jnp.int8),
            jnp.ones((2, N), jnp.float32))
    else:
        monkeypatch.setattr(jk1.pl, "pallas_call", _reach)
        # Unjitted, so that a trace cached under the real backend is not reused.
        call = lambda: jk1.int8_matmul.__wrapped__(   # noqa: E731
            jnp.zeros((B, K), jnp.float32), jnp.zeros((K, N), jnp.int8),
            jnp.ones((N,), jnp.float32))
    try:
        out = call()
    except _ReachedKernel:
        return "kernel"
    assert out.shape == ((2, B, N) if expert else (B, N))
    return "dequant"


# tiny's wk/wv have N 64 and mixtral-tiny's hidden size is 64.
@pytest.mark.parametrize("expert", [False, True])
@pytest.mark.parametrize("N", [64, 128, 384])
@pytest.mark.parametrize("K", [64, 128, 192])
@pytest.mark.parametrize("B", [1, 64, 65])
@pytest.mark.parametrize("device", ["cpu", "cuda"])
def test_route_follows_the_reference_rule(monkeypatch, device, B, K, N, expert):
    got = tk1._route(device, B, K, N)
    if device == "cpu":
        assert got == "plain"
    else:
        assert got == _jax_route_on_tpu(monkeypatch, B, K, N, expert)


def test_route_refuses_other_devices():
    with pytest.raises(ValueError, match="unsupported device"):
        tk1._route("meta", 4, 128, 128)


def _operands(seed, B, K, N, transpose, E=None):
    rng = np.random.default_rng(seed)
    lead = () if E is None else (E,)
    h = rng.standard_normal((*lead, B, K)).astype(np.float32)
    qshape = (N, K) if transpose else (K, N)
    q = rng.integers(-127, 128, (*lead, *qshape)).astype(np.int8)
    s = (rng.random((*lead, N)) * 0.02 + 1e-3).astype(np.float32)
    return h, q, s


def _bf16(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(a).to(torch.bfloat16)


# Both sides compute the same dequant product: f32 agrees to summation
# order (1e-5 relative to the largest output). In bf16 each rounds its
# matmul to bf16 and rounds again after the bf16 scale: a sum that lands
# on the other side of a rounding boundary moves one ulp, which the scale's
# rounding can carry into a second, so 2 bf16 ulps (2^-6) of each output's
# own magnitude.
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("transpose", [False, True])
def test_dequant_fallback_matches_the_jax_fallback(dtype, transpose):
    B, K, N = 5, 192, 64                     # off 128: the fallback's own case
    h, q, s = _operands(21, B, K, N, transpose)
    if dtype == "bfloat16":
        ht = _bf16(h)
        hj = jnp.asarray(ht.float().numpy(), jnp.bfloat16)
    else:
        ht, hj = torch.from_numpy(h), jnp.asarray(h)
    out = tk1.int8_matmul_dequant(ht, torch.from_numpy(q), torch.from_numpy(s),
                                  transpose=transpose)
    ref = jk1.int8_matmul(hj, jnp.asarray(q), jnp.asarray(s), transpose=transpose)
    assert out.dtype == ht.dtype and out.shape == (B, N)
    out, ref = out.float().numpy(), np.asarray(ref.astype(jnp.float32))
    if dtype == "float32":
        np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5 * np.abs(ref).max())
    else:
        assert np.all(np.abs(out - ref) <= 2.0 ** -6 * np.abs(ref) + 1e-30)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_expert_dequant_fallback_matches_the_jax_fallback(dtype):
    E, C, K, N = 3, 4, 128, 64
    x, q, s = _operands(22, C, K, N, False, E=E)
    if dtype == "bfloat16":
        xt = _bf16(x)
        xj = jnp.asarray(xt.float().numpy(), jnp.bfloat16)
    else:
        xt, xj = torch.from_numpy(x), jnp.asarray(x)
    out = tk1.int8_matmul_expert_dequant(xt, torch.from_numpy(q), torch.from_numpy(s))
    ref = jk1.int8_matmul_expert(xj, jnp.asarray(q), jnp.asarray(s))
    assert out.dtype == xt.dtype and out.shape == (E, C, N)
    out, ref = out.float().numpy(), np.asarray(ref.astype(jnp.float32))
    if dtype == "float32":
        np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5 * np.abs(ref).max())
    else:
        assert np.all(np.abs(out - ref) <= 2.0 ** -6 * np.abs(ref) + 1e-30)


# (B, K, N, ks) at every llama3-8b and Mixtral trunk decode shape: 128-column
# tiles x 8-row groups x K/ks slices reach 128 blocks where at most 8
# slices of at most 2048 allow it.
@pytest.mark.parametrize("B,K,N,ks", [
    (4, 4096, 4096, 1024),      # wq/wo (both models): 32 tiles x 4 slices
    (4, 4096, 1024, 512),       # wk/wv (both models): 8 tiles x 8 slices, the most
    (4, 4096, 14336, 2048),     # 8B w_gate/w_up: 112 tiles x 2 slices
    (4, 14336, 4096, 2048),     # 8B w_down: 32 tiles x 7 slices
    (4, 4096, 128256, 2048),    # 8B untied head: 1002 tiles x 2 slices
    (4, 4096, 32000, 2048),     # Mixtral head: 250 tiles x 2 slices
    (1, 4096, 1024, 512),
    (64, 4096, 4096, 2048),     # 32 tiles x 8 row groups x 2 slices
    (64, 4096, 1024, 2048),     # 8 tiles x 8 row groups x 2 slices
    (4, 384, 256, 128),         # nothing reaches 128 blocks: 3 slices
    (4, 28672, 4096, 3584),     # K past 8 x 2048: 8 slices of 3584
])
def test_k_slice_plan_for_the_bf16_kernel(B, K, N, ks):
    got = tk1.k_slice_bf16(B, K, N)
    assert got == ks
    assert K % got == 0 and got % 128 == 0 and K // got <= 8
    blocks = (N // 128) * -(-B // 8) * (K // got)
    assert (blocks >= 128 and got <= 2048) or K // got == max(
        K // c for c in range(128, K + 1, 128) if K % c == 0 and K // c <= 8)
