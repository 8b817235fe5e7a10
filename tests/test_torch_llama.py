"""The port's Llama against the JAX package's, on ``llama_tiny`` (f32).

One reference parameter tree (``kukeon_tpu.models.llama.init_params``,
optionally ``quantize_params``) goes to torch through numpy with
``params_from_numpy``; prefill, cached prefill, ``logit_positions`` and
decode logits, across full-precision/int8 weights and full-precision/int8
KV, are held at f32 within 1e-4 (the two frameworks sum in different
orders through 2 layers), and a 32-token greedy rollout token for token.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kukeon_tpu.models import llama as jl
from kukeon_tpu_torch.models import convert
from kukeon_tpu_torch.models import llama as tl
from kukeon_tpu_torch.ops import int8_matmul as tk1

torch.set_num_threads(2)

TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(scope="module")
def trees():
    """(jax cfg, torch cfg) and {"fp": (jax tree, torch tree), "int8": ...}."""
    jcfg, tcfg = jl.llama_tiny(), tl.llama_tiny()
    jp = jl.init_params(jax.random.key(0), jcfg)
    out = {}
    for name, tree in (("fp", jp), ("int8", jl.quantize_params(jp))):
        out[name] = (tree, convert.params_from_numpy(jax.tree.map(np.asarray, tree), "cpu"))
    return jcfg, tcfg, out


def _tokens(rng, B, S, V=512):
    return rng.integers(0, V, (B, S)).astype(np.int32)


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def test_presets_match_reference():
    for name in ("llama3_8b", "llama3_1b", "llama_tiny"):
        j, t = getattr(jl, name)(), getattr(tl, name)()
        jd = {f.name: getattr(j, f.name) for f in dataclasses.fields(j) if f.name != "dtype"}
        td = {f.name: getattr(t, f.name) for f in dataclasses.fields(t) if f.name != "dtype"}
        assert jd == td, name
        assert t.param_count() == j.param_count()
        assert str(t.dtype).split(".")[-1] == np.dtype(j.dtype).name


def test_quantize_recipes_match_reference_bitwise():
    rng = np.random.default_rng(0)
    w = rng.standard_normal((64, 96)).astype(np.float32)
    # Exact .5 ties exercise round-half-to-even.
    w[0, :4] = [0.5, 1.5, 2.5, -2.5]
    w[0, 4] = 127.0
    for axis in (0, 1):
        jq, js = jl._int8_sym(jnp.asarray(w), axis)
        tq, ts = tl._int8_sym(torch.from_numpy(w), axis)
        np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
        hn = tl.quantize_np(w, axis)
        jn = jl.quantize_np(w, axis)
        np.testing.assert_array_equal(hn["q"], jn["q"])
        np.testing.assert_array_equal(hn["s"], jn["s"])
    x = rng.standard_normal((2, 3, 5, 16)).astype(np.float32)
    jq, js = jl.quantize_kv(jnp.asarray(x))
    tq, ts = tl.quantize_kv(torch.from_numpy(x))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


def test_host_int8_init_matches_reference_and_params_from_numpy_is_exact():
    cfg_j, cfg_t = jl.llama_tiny(), tl.llama_tiny()
    jt = jl.init_quantized_params_host(cfg_j, seed=3)
    tt = tl.init_quantized_params_host(cfg_t, seed=3)
    flat_j = jax.tree_util.tree_leaves_with_path(jt)
    flat_t = dict(jax.tree_util.tree_leaves_with_path(tt))
    for path, leaf in flat_j:
        np.testing.assert_array_equal(np.asarray(flat_t[path], leaf.dtype), leaf)
    # bf16 leaves (ml_dtypes) cross bit for bit.
    bf = jnp.asarray(np.random.default_rng(1).standard_normal(33), jnp.bfloat16)
    t = convert.params_from_numpy({"w": np.asarray(bf)}, "cpu")["w"]
    assert t.dtype == torch.bfloat16
    np.testing.assert_array_equal(t.float().numpy(), np.asarray(bf.astype(jnp.float32)))


def test_device_int8_init_shapes_and_recipe():
    cfg = tl.LlamaConfig(vocab_size=256, hidden_size=128, intermediate_size=256,
                         num_layers=2, num_heads=4, num_kv_heads=2, head_dim=32)
    g = torch.Generator().manual_seed(0)
    p = convert.init_quantized_params_device(cfg, g, "cpu")
    ref = jax.tree.map(np.asarray, jl.init_quantized_params_host(
        jl.LlamaConfig(**{f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)
                          if f.name != "dtype"}), seed=0))
    for path, leaf in jax.tree_util.tree_leaves_with_path(ref):
        got = dict(jax.tree_util.tree_leaves_with_path(p))[path]
        assert tuple(got.shape) == leaf.shape, path
    wq = p["layers"]["wq"]
    assert wq["q"].dtype == torch.int8 and wq["s"].dtype == torch.float32
    # Per-column symmetric: every column's max |q| is 127.
    assert torch.all(wq["q"].abs().amax(dim=1) == 127)


@pytest.mark.parametrize("weights", ["fp", "int8"])
def test_forward_no_cache_and_logit_positions(trees, weights):
    jcfg, tcfg, t = trees
    jp, tp = t[weights]
    rng = np.random.default_rng(0)
    toks = _tokens(rng, 2, 11)
    pos = np.broadcast_to(np.arange(11, dtype=np.int32), (2, 11)).copy()
    jlog, _ = jl.forward(jp, jcfg, jnp.asarray(toks), jnp.asarray(pos))
    tlog, _ = tl.forward(tp, tcfg, torch.from_numpy(toks).long(), torch.from_numpy(pos).long())
    np.testing.assert_allclose(_np(tlog), np.asarray(jlog), **TOL)
    lp = np.array([10, 4], np.int32)
    jlog, _ = jl.forward(jp, jcfg, jnp.asarray(toks), jnp.asarray(pos),
                         logit_positions=jnp.asarray(lp))
    tlog, _ = tl.forward(tp, tcfg, torch.from_numpy(toks).long(),
                         torch.from_numpy(pos).long(),
                         logit_positions=torch.from_numpy(lp).long())
    assert tuple(tlog.shape) == (2, 1, 512)
    np.testing.assert_allclose(_np(tlog), np.asarray(jlog), **TOL)


@pytest.mark.parametrize("weights,kv_int8", [("fp", False), ("fp", True),
                                             ("int8", False), ("int8", True)])
def test_cached_prefill_then_decode(trees, weights, kv_int8):
    """Cached prefill into a [L, 2, 32, KV, D] cache (rows at different
    lengths), a second cached chunk, then three single-token decode steps:
    logits and cache contents against the reference."""
    jcfg, tcfg, t = trees
    jp, tp = t[weights]
    rng = np.random.default_rng(1)
    jc = jl.KVCache.create(jcfg, 2, 32, quantized=kv_int8)
    tc = tl.KVCache.create(tcfg, 2, 32, quantized=kv_int8)
    for S in (6, 3, 1, 1, 1):
        toks = _tokens(rng, 2, S)
        lengths = np.asarray(jc.lengths)
        pos = (lengths[:, None] + np.arange(S)[None, :]).astype(np.int32)
        jlog, jc = jl.forward(jp, jcfg, jnp.asarray(toks), jnp.asarray(pos), jc)
        tlog, tc = tl.forward(tp, tcfg, torch.from_numpy(toks).long(),
                              torch.from_numpy(pos).long(), tc)
        np.testing.assert_allclose(_np(tlog), np.asarray(jlog), **TOL, err_msg=f"S={S}")
        np.testing.assert_array_equal(_np(tc.lengths), np.asarray(jc.lengths))
        if kv_int8:
            # int8 rows can round one step apart where the f32 K/V differ
            # in the last bits: hold the dequantized rows instead.
            for a, s_t, b, s_j in ((tc.k, tc.k_scale, jc.k, jc.k_scale),
                                   (tc.v, tc.v_scale, jc.v, jc.v_scale)):
                deq_t = _np(a).astype(np.float32) * _np(s_t)[..., None]
                deq_j = np.asarray(b).astype(np.float32) * np.asarray(s_j)[..., None]
                np.testing.assert_allclose(deq_t, deq_j, rtol=1e-4,
                                           atol=np.max(np.asarray(s_j)) * 1.01)
        else:
            np.testing.assert_allclose(_np(tc.k), np.asarray(jc.k), **TOL)
            np.testing.assert_allclose(_np(tc.v), np.asarray(jc.v), **TOL)


def test_kernel_flag_on_cpu_is_the_plain_version(trees):
    """int8_pallas=True routes decode through int8_matmul, which on CPU
    tensors is its plain version: same logits as the dequant path at f32,
    and no kernel launch is counted."""
    _, tcfg, t = trees
    tp = t["int8"][1]
    rng = np.random.default_rng(2)
    toks = torch.from_numpy(_tokens(rng, 3, 5)).long()
    pos = torch.arange(5)[None, :].expand(3, 5)
    outs = []
    before = tk1.int8_matmul.launches
    for flag in (False, True):
        cfg = dataclasses.replace(tcfg, int8_pallas=flag)
        cache = tl.KVCache.create(cfg, 3, 16)
        tl.forward(tp, cfg, toks, pos, cache)
        log, _ = tl.forward(tp, cfg, toks[:, :1], cache.lengths[:, None], cache)
        outs.append(log)
    np.testing.assert_allclose(_np(outs[1]), _np(outs[0]), **TOL)
    assert tk1.int8_matmul.launches == before


@pytest.mark.parametrize("weights", ["fp", "int8"])
def test_greedy_rollout_token_for_token(trees, weights):
    """32 greedy tokens through decode steps: identical ids."""
    jcfg, tcfg, t = trees
    jp, tp = t[weights]
    prompt = _tokens(np.random.default_rng(4), 1, 7)
    jc = jl.KVCache.create(jcfg, 1, 64)
    tc = tl.KVCache.create(tcfg, 1, 64)
    pos = np.arange(7, dtype=np.int32)[None, :]
    jlog, jc = jl.forward(jp, jcfg, jnp.asarray(prompt), jnp.asarray(pos), jc)
    tlog, tc = tl.forward(tp, tcfg, torch.from_numpy(prompt).long(),
                          torch.from_numpy(pos).long(), tc)
    jtok, ttok = [int(jnp.argmax(jlog[0, -1]))], [int(torch.argmax(tlog[0, -1]))]
    decode = jax.jit(lambda p, tok, ps, c: jl.forward(p, jcfg, tok, ps, c))
    for i in range(31):
        assert jtok == ttok, f"diverged at step {i}"
        p = 7 + i
        jlog, jc = decode(jp, jnp.asarray([[jtok[-1]]], jnp.int32),
                          jnp.asarray([[p]], jnp.int32), jc)
        tlog, tc = tl.forward(tp, tcfg, torch.tensor([[ttok[-1]]]), torch.tensor([[p]]), tc)
        jtok.append(int(jnp.argmax(jlog[0, 0])))
        ttok.append(int(torch.argmax(tlog[0, 0])))
    assert jtok == ttok
    assert len(ttok) == 32


def test_transformer_block_matches_reference(trees):
    jcfg, tcfg, t = trees
    jp, tp = t["fp"]
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 6, 128)).astype(np.float32)
    pos = np.broadcast_to(np.arange(6, dtype=np.int32), (2, 6)).copy()
    jw = jax.tree.map(lambda a: a[1], jp["layers"])
    ref = jl.transformer_block(jnp.asarray(x), jw, jcfg, jnp.asarray(pos))
    out = tl.transformer_block(torch.from_numpy(x), tl.layer_weights(tp, 1), tcfg,
                               torch.from_numpy(pos).long())
    np.testing.assert_allclose(_np(out), np.asarray(ref), **TOL)
