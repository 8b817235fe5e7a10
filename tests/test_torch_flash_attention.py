"""The port's flash attention against the JAX package's, on the CPU.

On CPU tensors the port's ``flash_attention`` takes its plain version;
the JAX side runs the Pallas kernel in interpret mode, as
tests/test_flash_attention.py does. Inputs are drawn with numpy from a
seed and fed to both. f32 throughout, within 2e-5 (the same algorithm
summed in a different order; the tolerance of the JAX package's own flash
tests). The CUDA kernel is held against the same plain version on the
card by chip_smoke.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kukeon_tpu.ops import attention as jattn
from kukeon_tpu.ops import flash_attention as jfa
from kukeon_tpu_torch.ops import attention as tattn
from kukeon_tpu_torch.ops import flash_attention as tfa

torch.set_num_threads(2)

TOL = dict(rtol=2e-5, atol=2e-5)


def _qkv(seed, B, S, H, KV, D):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, S, H, D)).astype(np.float32),
            rng.standard_normal((B, S, KV, D)).astype(np.float32),
            rng.standard_normal((B, S, KV, D)).astype(np.float32))


def _jax_flash(q, k, v, pos, block_q, block_k):
    """The Pallas kernel, interpreted, on GQA-expanded inputs."""
    B, S, H, D = q.shape
    n_rep = H // k.shape[2]
    fold = lambda x: x.transpose(0, 2, 1, 3).reshape(B * H, S, D)  # noqa: E731
    k = jattn.repeat_kv(jnp.asarray(k), n_rep)
    v = jattn.repeat_kv(jnp.asarray(v), n_rep)
    pos = jnp.asarray(pos, jnp.int32)
    out = jfa._flash_forward(fold(jnp.asarray(q)), fold(k), fold(v), pos, pos, H,
                             block_q=block_q, block_k=block_k, interpret=True)
    return np.asarray(out.reshape(B, H, S, D).transpose(0, 2, 1, 3))


def _torch_flash(q, k, v, pos):
    t = lambda a: torch.from_numpy(np.array(a))  # noqa: E731
    before = tfa.flash_attention.launches
    out = tfa.flash_attention(t(q), t(k), t(v), t(pos), t(pos)).numpy()
    assert tfa.flash_attention.launches == before     # CPU: the plain version
    return out


@pytest.mark.parametrize("case", ["s256_blocks128", "uneven_blocks", "offset_positions",
                                  "gqa"])
def test_flash_forward_matches_pallas_interpret(case):
    """The three cases of tests/test_flash_attention.py, and K/V at KV < H
    (the port's kernel reads them unexpanded; JAX gets repeat_kv's)."""
    seed, (B, S, H, KV, D) = {"s256_blocks128": (0, (1, 256, 2, 2, 32)),
                              "uneven_blocks": (1, (1, 256, 1, 1, 32)),
                              "offset_positions": (2, (2, 256, 2, 2, 32)),
                              "gqa": (3, (2, 256, 4, 2, 32))}[case]
    q, k, v = _qkv(seed, B, S, H, KV, D)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S))
    if case == "offset_positions":
        pos = np.array([[100], [7]], np.int32) + pos        # per-batch starts
    block_k = 64 if case == "uneven_blocks" else 128
    np.testing.assert_allclose(_torch_flash(q, k, v, pos),
                               _jax_flash(q, k, v, pos, 128, block_k), **TOL)


def test_flash_forward_matches_pallas_interpret_at_a_ragged_s():
    """S = 160 (supports() admits it with one 160-row block; the CUDA kernel
    runs it as a 128-row tile and a ragged one), B 2, GQA."""
    B, S, H, KV, D = 2, 160, 4, 2, 32
    assert tfa.supports(S, S) and jfa.supports(S, S)
    q, k, v = _qkv(4, B, S, H, KV, D)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S))
    np.testing.assert_allclose(_torch_flash(q, k, v, pos), _jax_flash(q, k, v, pos, 256, 256),
                               **TOL)


@pytest.mark.parametrize("layout", ["contiguous", "fused_qkv_slice", "heads_major", "d128",
                                    "d32"])
def test_tma_geometry_of_strided_views(layout):
    """The views the callers pass are ones the bf16 kernel's tensor maps
    can take: D contiguous, every other byte stride and the base address a
    multiple of 16. The same view one element off its aligned base is
    refused."""
    B, S, X, D = 2, 160, 4, 64
    if layout == "contiguous":
        shape, view = (B, S, X, D), lambda t: t
    elif layout == "fused_qkv_slice":       # q of a fused [B, S, X + 2 KV, D] projection
        shape, view = (B, S, X + 4, D), lambda t: t[:, :, :X]
    elif layout == "heads_major":           # a [B, X, S, D] tensor seen as [B, S, X, D]
        shape, view = (B, X, S, D), lambda t: t.transpose(1, 2)
    elif layout == "d128":
        shape, view = (B, S, X, 128), lambda t: t
    else:
        shape, view = (B, S, X, 32), lambda t: t
    n = int(np.prod(shape))
    base = torch.zeros(n + 8, dtype=torch.bfloat16)
    aligned = base[-(base.data_ptr() // 2) % 8:][:n]
    assert aligned.data_ptr() % 16 == 0
    t = view(aligned.view(shape))
    assert t.shape[1:3] == (S, X) and t.stride(3) == 1
    tfa.check_tma_operand(t.stride(), t.data_ptr())
    off = view(base[(-(base.data_ptr() // 2) % 8 + 1):][:n].view(shape))
    with pytest.raises(ValueError, match="16-byte aligned"):
        tfa.check_tma_operand(off.stride(), off.data_ptr())


def test_tma_geometry_refuses_strides_tma_cannot_take():
    """A head stride of 36 bf16 (72 bytes) is not a multiple of 16 bytes, a
    non-unit D stride is not a tile TMA can load: both raise."""
    t = torch.zeros(1, 128, 2, 36, dtype=torch.bfloat16)[..., :32]
    with pytest.raises(ValueError, match="multiples of 16"):
        tfa.check_tma_operand(t.stride(), 0)
    t = torch.zeros(1, 128, 2, 64, dtype=torch.bfloat16)[..., ::2]
    with pytest.raises(ValueError, match="head dim contiguous"):
        tfa.check_tma_operand(t.stride(), 0)


@pytest.mark.parametrize("kv", [4, 2])
def test_flash_gradients_match_jax_vjp(kv):
    """The backward recomputes the reference attention, as the JAX
    ``_flash_bwd`` does: dq, dk, dv against ``jax.vjp`` of
    attention_reference with attention_mask (through repeat_kv for GQA, so
    dk and dv come back at the kv head count)."""
    B, S, H, D = 2, 128, 4, 16
    q, k, v = _qkv(10 + kv, B, S, H, kv, D)
    pos = np.array([[3], [0]], np.int32) + np.arange(S, dtype=np.int32)[None, :]
    g = np.random.default_rng(99).standard_normal((B, S, H, D)).astype(np.float32)

    def ref(q, k, v):
        p = jnp.asarray(pos)
        n_rep = H // kv
        return jattn.attention_reference(q, jattn.repeat_kv(k, n_rep),
                                         jattn.repeat_kv(v, n_rep), jattn.attention_mask(p, p))

    _, vjp = jax.vjp(ref, *map(jnp.asarray, (q, k, v)))
    want = [np.asarray(x) for x in vjp(jnp.asarray(g))]

    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    tp = torch.from_numpy(pos)
    out = tfa.flash_attention(tq, tk, tv, tp, tp)
    got = torch.autograd.grad(out, (tq, tk, tv), torch.from_numpy(g))
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert a.shape == b.shape, name
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-5, atol=1e-5, err_msg=name)


def test_supports_equals_jax():
    lens = [1, 64, 100, 127, 128, 192, 256, 384, 512, 640, 768, 1024, 1536, 2048, 4096]
    for sq in lens:
        for skv in (sq, 2048, 128):
            for block in (128, 256, 512):
                assert tfa.supports(sq, skv, block) == jfa.supports(sq, skv, block), (
                    sq, skv, block)


def test_gqa_attention_dispatch_on_cpu():
    """"auto" never takes flash on the CPU (the JAX package takes it only on
    a TPU, the port only on a GPU): the counter stays 0 and the result is
    the grouped path's. "flash" takes the plain version on the CPU and
    refuses what JAX refuses."""
    B, S, H, KV, D = 1, 1024, 4, 2, 16
    q, k, v = map(torch.from_numpy, _qkv(3, B, S, H, KV, D))
    pos = torch.arange(S, dtype=torch.int32)[None, :]
    before = tfa.flash_attention.launches
    auto = tattn.gqa_attention(q, k, v, q_positions=pos, kv_positions=pos, impl="auto")
    grouped = tattn.attention_grouped(q, k, v, tattn.attention_mask(pos, pos))
    torch.testing.assert_close(auto, grouped, rtol=0, atol=0)
    flash = tattn.gqa_attention(q, k, v, q_positions=pos, kv_positions=pos, impl="flash")
    np.testing.assert_allclose(flash.numpy(), grouped.numpy(), **TOL)
    assert tfa.flash_attention.launches == before == 0

    x = torch.zeros(1, 256, 2, 8)
    p = torch.arange(256)[None, :]
    jx, jp = jnp.zeros((1, 256, 2, 8)), jnp.arange(256)[None, :]
    for kv_length in (torch.tensor([5]), None):
        klen = None if kv_length is None else jnp.asarray(kv_length.numpy())
        xs = (x, x[:, :200]) if kv_length is None else (x, x)
        with pytest.raises(ValueError, match="requires full self-attention"):
            jattn.gqa_attention(jx, jnp.asarray(xs[1].numpy()), jnp.asarray(xs[1].numpy()),
                                q_positions=jp, kv_positions=jp[:, :xs[1].shape[1]],
                                kv_length=klen, impl="flash")
        with pytest.raises(ValueError, match="requires full self-attention"):
            tattn.gqa_attention(x, xs[1], xs[1], q_positions=p,
                                kv_positions=p[:, :xs[1].shape[1]], kv_length=kv_length,
                                impl="flash")


@pytest.mark.parametrize("shape, match", [((1, 128, 2, 48), "D in"),
                                          ((1, 96, 2, 32), "S >= 128")])
def test_kernel_wrapper_refuses_what_the_kernel_does_not_take(shape, match):
    """The wrapper's checks run before any build or launch, and raise:
    the kernel is never replaced by the plain version on a GPU."""
    x = torch.zeros(shape, dtype=torch.bfloat16)
    pos = torch.zeros(shape[:2], dtype=torch.int32)
    with pytest.raises(ValueError, match=match):
        tfa._launch(x, x, x, pos, pos)
