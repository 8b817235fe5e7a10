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


def test_max_s_admits_every_long_s_that_supports_admits():
    """The kernel's bound sits far past what the JAX rule admits in use:
    65792 (the first S above 65536 that ``supports`` takes) and longer."""
    for S in (65536, 65792, 1 << 17, 1 << 20):
        assert tfa.supports(S, S) and jfa.supports(S, S)
        assert tfa.MIN_S <= S <= tfa.MAX_S


class _FakeFlashLib:
    """Stands in for the built library: records each call's arguments."""

    def __init__(self):
        self.calls = []

    def kukeon_flash_attention(self, *args):
        self.calls.append(args)
        return 0


@pytest.mark.parametrize("S, listed", [(2048, False), (65792, True)])
def test_wrapper_passes_long_s_to_the_kernel_with_a_tile_list(monkeypatch, S, listed):
    """Past 512 kv tiles (S 65536) the wrapper gives the bf16 kernel a
    kv-tile list workspace of two lists an SM; below, none. Nothing is
    refused before the launch."""
    from types import SimpleNamespace

    lib = _FakeFlashLib()
    monkeypatch.setattr(tfa._build, "load_flash_attention", lambda: lib)
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda dev: SimpleNamespace(multi_processor_count=132))
    monkeypatch.setattr(torch.cuda, "current_stream", lambda dev: SimpleNamespace(cuda_stream=0))
    monkeypatch.setattr(tfa.flash_attention, "launches", 0)
    x = torch.zeros((1, S, 1, 32), dtype=torch.bfloat16)
    pos = torch.arange(S, dtype=torch.int32)[None, :]
    out = tfa._launch(x, x, x, pos, pos)
    assert out.shape == x.shape and tfa.flash_attention.launches == 1
    (args,) = lib.calls
    tile_list, tile_list_len, B, S_arg = args[7:11]
    assert (B, S_arg) == (1, S)
    if listed:
        assert tile_list is not None and tile_list_len == 132 * 2 * -(-S // 128)
    else:
        assert tile_list is None and tile_list_len == 0


def test_wrapper_refuses_s_past_max_s():
    S = tfa.MAX_S + 256
    x = torch.zeros((1, 1, 1, 32), dtype=torch.bfloat16).expand(1, S, 1, 32)
    pos = torch.zeros((1, 1), dtype=torch.int32).expand(1, S)
    with pytest.raises(ValueError, match="S >= 128 and <="):
        tfa._launch(x, x, x, pos, pos)


def _block(seed, B, S, H, KV, D, seq, rank):
    """A seq rank's view: its block of the queries and their positions,
    and every key, value and position of the sequence."""
    q, k, v = _qkv(seed, B, S, H, KV, D)
    pos = np.array([[0], [9]][:B], np.int32) + np.arange(S, dtype=np.int32)[None, :]
    rows = slice(rank * S // seq, (rank + 1) * S // seq)
    return q, k, v, pos, rows


@pytest.mark.parametrize("seq, rank", [(2, 0), (2, 1), (4, 2)])
def test_flash_query_block_is_its_rows_of_the_whole(seq, rank):
    """A block of queries (Sq = S / seq, a seq rank's) against every key
    gives its rows of the whole sequence's attention: the Pallas kernel,
    interpreted, over the whole S, sliced. The port's wrapper takes the
    block on the CPU through its plain version; the CUDA kernel is held to
    the same plain version at a Mixtral seq rank's shapes by chip_smoke.py."""
    B, S, H, KV, D = 2, 512, 4, 2, 32
    q, k, v, pos, rows = _block(20 + rank, B, S, H, KV, D, seq, rank)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))  # noqa: E731
    got = tfa.flash_attention(t(q[:, rows]), t(k), t(v), t(pos[:, rows]), t(pos)).numpy()
    assert got.shape == (B, S // seq, H, D)
    np.testing.assert_allclose(got, _jax_flash(q, k, v, pos, 128, 128)[:, rows], **TOL)


def test_flash_query_block_gradients_match_jax_vjp():
    """The backward of a block (the reference attention recomputed): dq of
    the block, and dk, dv over every key, against ``jax.vjp`` of the JAX
    reference attention of the block's queries over all keys."""
    B, S, H, KV, D, seq, rank = 2, 256, 4, 2, 16, 2, 1
    q, k, v, pos, rows = _block(30, B, S, H, KV, D, seq, rank)
    qb, pb = np.ascontiguousarray(q[:, rows]), np.ascontiguousarray(pos[:, rows])
    g = np.random.default_rng(98).standard_normal(qb.shape).astype(np.float32)

    def ref(q, k, v):
        return jattn.attention_reference(q, jattn.repeat_kv(k, H // KV),
                                         jattn.repeat_kv(v, H // KV),
                                         jattn.attention_mask(jnp.asarray(pb), jnp.asarray(pos)))

    _, vjp = jax.vjp(ref, *map(jnp.asarray, (qb, k, v)))
    want = [np.asarray(x) for x in vjp(jnp.asarray(g))]
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (qb, k, v))
    out = tfa.flash_attention(tq, tk, tv, torch.from_numpy(pb), torch.from_numpy(pos))
    got = torch.autograd.grad(out, (tq, tk, tv), torch.from_numpy(g))
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert a.shape == b.shape, name
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-5, atol=1e-5, err_msg=name)


def test_gqa_attention_decides_a_query_block_on_the_whole_length():
    """``whole_len``: a rank's block of queries over every key dispatches
    as the whole sequence would. "flash" takes the block (the plain version
    on the CPU, its rows of the whole) where Sq == Skv == whole_len passes
    the JAX rule, and refuses it without ``whole_len`` (Sq != Skv) or where
    the whole fails the rule; "auto" takes the grouped path on the CPU."""
    B, S, H, KV, D = 1, 1024, 4, 2, 16
    q, k, v, pos, rows = _block(40, B, S, H, KV, D, 2, 1)
    q, k, v, pos = map(torch.from_numpy, (q, k, v, pos))
    qb, pb = q[:, rows], pos[:, rows]
    whole = tattn.attention_grouped(q, k, v, tattn.attention_mask(pos, pos))[:, rows]
    before = tfa.flash_attention.launches
    for impl in ("flash", "auto"):
        got = tattn.gqa_attention(qb, k, v, q_positions=pb, kv_positions=pos, impl=impl,
                                  whole_len=S)
        np.testing.assert_allclose(got.numpy(), whole.numpy(), **TOL)
    assert tfa.flash_attention.launches == before
    with pytest.raises(ValueError, match="requires full self-attention"):
        tattn.gqa_attention(qb, k, v, q_positions=pb, kv_positions=pos, impl="flash")
    x, p = torch.zeros(1, 100, 2, 8), torch.arange(100)[None, :]
    with pytest.raises(ValueError, match="requires full self-attention"):
        tattn.gqa_attention(x[:, 50:], x, x, q_positions=p[:, 50:], kv_positions=p,
                            impl="flash", whole_len=100)


def test_wrapper_passes_a_query_block_to_the_kernel(monkeypatch):
    """Sq 1024 queries against Skv 2048 keys (a seq-2 rank of S 2048, H 32,
    KV 8, D 128): the wrapper hands the kernel both lengths, an output of
    the block's rows and a chunk workspace over the longer; mismatched
    positions, and a block under 128 rows, raise before any launch."""
    from types import SimpleNamespace

    lib = _FakeFlashLib()
    monkeypatch.setattr(tfa._build, "load_flash_attention", lambda: lib)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda dev: SimpleNamespace(cuda_stream=0))
    monkeypatch.setattr(tfa.flash_attention, "launches", 0)
    B, Sq, Skv, H, KV, D = 2, 1024, 2048, 32, 8, 128
    q = torch.zeros((B, Sq, H, D), dtype=torch.bfloat16)
    kv = torch.zeros((B, Skv, KV, D), dtype=torch.bfloat16)
    pos = torch.arange(Skv, dtype=torch.int32)[None, :].expand(B, Skv).contiguous()
    out = tfa._launch(q, kv, kv, pos[:, Sq:].contiguous(), pos)
    assert out.shape == q.shape and tfa.flash_attention.launches == 1
    (args,) = lib.calls
    assert args[9:14] == (B, Sq, Skv, H, KV) and args[14] == D
    with pytest.raises(ValueError, match=r"\[B,Sq\] and \[B,Skv\] positions"):
        tfa.flash_attention(q, kv, kv, pos, pos)
    with pytest.raises(ValueError, match=r"S >= 128 and <= \d+ \(Sq\)"):
        tfa._launch(q[:, :64], kv, kv, pos[:, :64].contiguous(), pos)
    assert len(lib.calls) == 1


@pytest.mark.parametrize("impl", ["flash", "auto"])
def test_seq_attention_gives_the_flash_path_each_ranks_block(impl, monkeypatch):
    """``llama.seq_attention`` on each rank of seq 2 (a stand-in mesh whose
    gather checks it is given the rank's block and returns the whole):
    "flash" hands the flash function the rank's S/2 queries and all S keys
    and positions; "auto" on the CPU takes the grouped path; both give the
    rank's rows of the whole sequence's attention."""
    from types import SimpleNamespace

    from kukeon_tpu_torch.models import llama as tl

    B, S, H, KV, D, seq = 1, 1024, 4, 2, 16, 2
    q, k, v, pos, _ = _block(50, B, S, H, KV, D, seq, 0)
    q, k, v, pos = map(torch.from_numpy, (q, k, v, pos))
    whole = tattn.attention_grouped(q, k, v, tattn.attention_mask(pos, pos))
    calls = []
    real = tfa.flash_attention

    def spy(qb, kb, vb, qp, kp):
        calls.append((tuple(qb.shape), tuple(kb.shape), tuple(qp.shape), tuple(kp.shape)))
        return real(qb, kb, vb, qp, kp)

    monkeypatch.setattr(tfa, "flash_attention", spy)
    for r in range(seq):
        c = slice(r * S // seq, (r + 1) * S // seq)
        by_ptr = {t.untyped_storage().data_ptr(): t for t in (k, v, pos)}

        def gather(x, dim, axis, c=c):
            full = by_ptr[x.untyped_storage().data_ptr()]
            assert (dim, axis) == (1, "seq") and torch.equal(x, full[:, c])
            return full

        mesh = SimpleNamespace(seq=seq, axis_size=lambda axis: seq, gather=gather)
        got = tl.seq_attention(q[:, c], k[:, c], v[:, c], pos[:, c], impl, mesh)
        np.testing.assert_allclose(got.numpy(), whole[:, c].numpy(), **TOL)
    want = [((B, S // seq, H, D), (B, S, KV, D), (B, S // seq), (B, S))] * seq
    assert calls == (want if impl == "flash" else [])
