"""The port's MoE (``kukeon_tpu_torch/models/moe.py``) and its grouped int8
expert product against the JAX package's, on the CPU.

Inputs come from numpy seeds and ``kukeon_tpu``'s own parameter trees,
carried to torch with ``params_from_numpy``. ``moe_tiny`` is f32, so the
port's dequant products and the reference's einsums agree to summation
order: blocks and aux losses within 1e-5, logits through 2 layers within
1e-4 (the tolerance of test_torch_llama.py), greedy streams token for
token. Routing inputs are checked tie-free (a gap >= 1e-4 between the
k-th and (k+1)-th probability of every routed row), so a routing mismatch
is a fault, not a tie broken another way.
"""

import dataclasses
import json
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_ops import _k1_interpret

from kukeon_tpu.models import moe as jm
from kukeon_tpu.ops import int8_matmul as jk
from kukeon_tpu.parallel import make_mesh, moe_specs_for_params
from kukeon_tpu.serving import ServingEngine as JaxEngine
from kukeon_tpu_torch.models import convert
from kukeon_tpu_torch.models import llama as tl
from kukeon_tpu_torch.models import moe as tm
from kukeon_tpu_torch.ops import int8_matmul as tk
from kukeon_tpu_torch.runtime.serving_cell import ServingCell, serve
from kukeon_tpu_torch.serving import SamplingParams, ServingEngine

torch.set_num_threads(2)

TOL = dict(rtol=1e-4, atol=1e-4)       # logits through 2 layers
BLOCK_TOL = dict(rtol=1e-5, atol=1e-5)  # one block, aux losses, one decode step


@pytest.fixture(scope="module")
def trees():
    """(jax cfg, torch cfg) and {"fp": (jax tree, torch tree), "int8": ...}."""
    jcfg, tcfg = jm.moe_tiny(), tm.moe_tiny()
    jp = jm.init_params(jax.random.key(0), jcfg)
    out = {}
    for name, tree in (("fp", jp), ("int8", jm.quantize_params(jp))):
        out[name] = (tree, convert.params_from_numpy(jax.tree.map(np.asarray, tree), "cpu"))
    return jcfg, tcfg, out


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _tokens(rng, B, S, V=512):
    return rng.integers(0, V, (B, S)).astype(np.int32)


# --- K2: the grouped expert product -------------------------------------------------


def _expert_operands(rng, E, C, K, N):
    x = rng.standard_normal((E, C, K)).astype(np.float32)
    q = rng.integers(-127, 128, (E, K, N)).astype(np.int8)
    s = (rng.random((E, N)) * 0.02 + 1e-3).astype(np.float32)
    return x, q, s


def _k2_interpret(x, q, s):
    """The TPU route of int8_matmul_expert: one interpreted K1 launch per
    expert (``kukeon_tpu/ops/int8_matmul.py:117``)."""
    return jnp.stack([_k1_interpret(x[e], q[e], s[e], False) for e in range(x.shape[0])])


@pytest.mark.parametrize("C", [1, 3, 16])
def test_int8_matmul_expert_reference_matches_pallas_route_bf16(C):
    """bf16: the plain version vs the interpreted Pallas route, within 1
    bf16 ulp of each output (f32 sums in another order, one rounding)."""
    rng = np.random.default_rng(20 + C)
    x, q, s = _expert_operands(rng, 3, C, 256, 384)
    x_bf = torch.from_numpy(x).to(torch.bfloat16)
    ref = _k2_interpret(jnp.asarray(x_bf.float().numpy(), jnp.bfloat16), jnp.asarray(q),
                        jnp.asarray(s))
    ref = np.asarray(ref.astype(jnp.float32))
    out = tk.int8_matmul_expert_reference(x_bf, torch.from_numpy(q), torch.from_numpy(s))
    assert out.dtype == torch.bfloat16 and out.shape == (3, C, 384)
    out = out.float().numpy()
    ulp = np.abs(ref) * 2.0 ** -7 + 1e-30
    assert np.all(np.abs(out - ref) <= ulp), np.max(np.abs(out - ref) / ulp)


@pytest.mark.parametrize("C", [1, 3, 16])
def test_int8_matmul_expert_reference_matches_jax_f32(C):
    """f32: the plain version vs the interpreted Pallas route and the JAX
    function (its einsum path off the TPU), within 1e-5 relative."""
    rng = np.random.default_rng(30 + C)
    x, q, s = _expert_operands(rng, 4, C, 256, 256)
    out = tk.int8_matmul_expert_reference(*map(torch.from_numpy, (x, q, s))).numpy()
    body = np.asarray(_k2_interpret(jnp.asarray(x), jnp.asarray(q), jnp.asarray(s)))
    xla = np.asarray(jk.int8_matmul_expert(jnp.asarray(x), jnp.asarray(q), jnp.asarray(s)))
    scale = np.max(np.abs(body))
    np.testing.assert_allclose(out, body, rtol=1e-5, atol=1e-5 * scale)
    np.testing.assert_allclose(out, xla, rtol=1e-5, atol=1e-5 * scale)


def test_int8_matmul_expert_cpu_takes_plain_version_and_counts_no_launch():
    x, q, s = map(torch.from_numpy, _expert_operands(np.random.default_rng(5), 2, 4, 128, 256))
    before = tk.int8_matmul_expert.launches
    assert torch.equal(tk.int8_matmul_expert(x, q, s), tk.int8_matmul_expert_reference(x, q, s))
    assert tk.int8_matmul_expert.launches == before


@pytest.mark.parametrize("bad", ["dtype_q", "dtype_s", "dtype_x", "shape", "contig"])
def test_int8_matmul_expert_rejects_what_the_kernel_does_not_take(bad):
    x = torch.ones(2, 4, 128)
    q = torch.ones(2, 128, 256, dtype=torch.int8)
    s = torch.ones(2, 256)
    if bad == "dtype_q":
        q = q.float()
    elif bad == "dtype_s":
        s = s.to(torch.bfloat16)
    elif bad == "dtype_x":
        x = x.half()
    elif bad == "shape":
        s = torch.ones(3, 256)
    else:
        x = torch.ones(2, 128, 4).transpose(1, 2)
    with pytest.raises(ValueError):
        tk.int8_matmul_expert(x, q, s)


@pytest.mark.parametrize("C,K,N,ks", [
    (4, 4096, 14336, 512),     # Mixtral w_gate/w_up: 8 experts x 28 tiles x 8 slices
    (4, 14336, 4096, 512),     # w_down: 8 x 8 tiles x 28 slices
    (1, 4096, 14336, 512),
    (64, 14336, 4096, 512),
])
def test_k_slice_plan_for_experts(C, K, N, ks):
    got = tk.k_slice(C, K, N, False, E=8)
    assert got == ks and K % got == 0


@pytest.mark.parametrize("C,K,N,ks", [
    (4, 4096, 14336, 2048),    # Mixtral w_gate/w_up: 112 tiles x 8 experts x 2 slices
    (4, 14336, 4096, 2048),    # w_down: 32 x 8 x 7 slices
    (64, 14336, 4096, 2048),   # 8 row groups: 2048 tiles x 7 slices
    (4, 4096, 1024, 256),      # 64 tiles need 16 slices for 1024 blocks
    (4, 384, 256, 128),        # nothing reaches 1024 blocks: the smallest that divides K
])
def test_k_slice_plan_for_the_bf16_expert_kernel(C, K, N, ks):
    got = tk.k_slice_expert(C, K, N, E=8)
    assert got == ks and K % got == 0 and got % 128 == 0


# --- configs and weights ----------------------------------------------------------------


def test_presets_match_reference():
    for name in ("mixtral_8x7b", "moe_tiny"):
        j, t = getattr(jm, name)(), getattr(tm, name)()
        jd = {f.name: getattr(j, f.name) for f in dataclasses.fields(j) if f.name != "dtype"}
        td = {f.name: getattr(t, f.name) for f in dataclasses.fields(t) if f.name != "dtype"}
        assert jd == td, name
        assert str(t.dtype).split(".")[-1] == np.dtype(j.dtype).name
    jp = jm.init_params(jax.random.key(1), jm.moe_tiny())
    assert tm.moe_tiny().param_count() == sum(x.size for x in jax.tree.leaves(jp))
    assert tm.mixtral_8x7b().param_count() == 46_702_792_704


def test_host_int8_init_matches_reference_bitwise():
    jt = jm.init_quantized_params_host(jm.moe_tiny(), seed=3)
    tt = tm.init_quantized_params_host(tm.moe_tiny(), seed=3)
    flat_t = dict(jax.tree_util.tree_leaves_with_path(tt))
    flat_j = jax.tree_util.tree_leaves_with_path(jt)
    assert len(flat_j) == len(flat_t)
    for path, leaf in flat_j:
        got = flat_t[path]
        assert got.dtype == np.asarray(leaf).dtype, path
        np.testing.assert_array_equal(got, leaf, err_msg=str(path))


def test_quantize_params_matches_reference(trees):
    _, _, t = trees
    jq = t["int8"][0]
    tq = tm.quantize_params(t["fp"][1])
    flat_t = dict(jax.tree_util.tree_leaves_with_path(tq))
    for path, leaf in jax.tree_util.tree_leaves_with_path(jq):
        np.testing.assert_array_equal(_np(flat_t[path]), np.asarray(leaf), err_msg=str(path))
    assert tq["layers"]["router"].dtype == torch.float32


def test_params_from_numpy_keeps_the_router_f32():
    """A bf16 tree converted with dtype=bf16: every float leaf but the int8
    scales and the router is bf16; the router stays f32, as the reference
    keeps it."""
    jcfg = dataclasses.replace(jm.moe_tiny(), dtype=jnp.bfloat16)
    jp = jax.tree.map(np.asarray, jm.init_params(jax.random.key(2), jcfg))
    tp = convert.params_from_numpy(jp, "cpu", dtype=torch.bfloat16)
    assert tp["layers"]["router"].dtype == torch.float32
    np.testing.assert_array_equal(tp["layers"]["router"].numpy(), jp["layers"]["router"])
    assert tp["layers"]["w_gate"].dtype == torch.bfloat16
    assert tp["layers"]["attn_norm"].dtype == torch.bfloat16
    host = convert.params_from_numpy(tm.init_quantized_params_host(tm.moe_tiny(), seed=0),
                                     "cpu", dtype=torch.bfloat16)
    assert host["layers"]["router"].dtype == torch.float32
    assert host["layers"]["w_up"]["s"].dtype == torch.float32
    assert host["final_norm"].dtype == torch.bfloat16


def test_device_int8_init_shapes_and_recipe():
    cfg = dataclasses.replace(tm.moe_tiny(), tie_embeddings=False)
    p = convert.init_quantized_moe_params_device(cfg, torch.Generator().manual_seed(0), "cpu")
    ref = jm.init_quantized_params_host(
        dataclasses.replace(jm.moe_tiny(), tie_embeddings=False), seed=0)
    flat_p = dict(jax.tree_util.tree_leaves_with_path(p))
    for path, leaf in jax.tree_util.tree_leaves_with_path(ref):
        assert tuple(flat_p[path].shape) == np.shape(leaf), path
    assert p["layers"]["router"].dtype == torch.float32
    w = p["layers"]["w_gate"]
    assert w["q"].dtype == torch.int8 and w["s"].dtype == torch.float32
    # Per expert, per output column: every column's max |q| is 127.
    assert torch.all(w["q"].abs().amax(dim=2) == 127)


# --- moe_block ------------------------------------------------------------------------


def _routing(x, router, K):
    """(jax top-k indices, torch top-k indices, smallest k-th vs (k+1)-th gap)."""
    jprobs = jax.nn.softmax(jnp.asarray(x) @ jnp.asarray(router), axis=-1)
    jidx = np.asarray(jax.lax.top_k(jprobs, K)[1])
    tprobs = torch.softmax(torch.from_numpy(x) @ torch.from_numpy(router), dim=-1)
    tidx = torch.topk(tprobs, K, dim=-1, sorted=True).indices.numpy()
    srt = np.sort(np.asarray(jprobs), axis=-1)[:, ::-1]
    return jidx, tidx, float(np.min(srt[:, K - 1] - srt[:, K]))


@pytest.mark.parametrize("policy", ["inference", "training", "training_drops"])
def test_moe_block_matches_reference(trees, policy):
    """One block, both capacity policies; ``training_drops`` overflows an
    expert, so dispatch positions >= C occur: jax.nn.one_hot gives them a
    zero row, and the port must too (F.one_hot would raise)."""
    jcfg, tcfg, t = trees
    if policy == "training_drops":
        jcfg = dataclasses.replace(jcfg, capacity_factor=0.5)
        tcfg = dataclasses.replace(tcfg, capacity_factor=0.5)
    jp, tp = t["fp"]
    rng = np.random.default_rng(6)
    h = rng.standard_normal((2, 8, 64)).astype(np.float32)
    jw = jax.tree.map(lambda a: a[1], jp["layers"])
    tw = tl.layer_weights(tp, 1)
    inference = policy == "inference"

    jidx, tidx, gap = _routing(h.reshape(16, 64), np.array(jw["router"]), 2)
    assert gap >= 1e-4, gap
    np.testing.assert_array_equal(tidx, jidx)
    C = tm._capacity(tcfg, 16, inference)
    assert C == jm._capacity(jcfg, 16, inference)
    per_expert = np.bincount(jidx.reshape(-1), minlength=4)
    assert (per_expert.max() > C) == (policy == "training_drops"), (per_expert, C)

    jy, jaux = jm.moe_block(jnp.asarray(h), jw, jcfg, inference=inference)
    ty, taux = tm.moe_block(torch.from_numpy(h), tw, tcfg, inference=inference)
    np.testing.assert_allclose(_np(ty), np.asarray(jy), **BLOCK_TOL)
    for k in ("load_balance", "router_z"):
        np.testing.assert_allclose(float(taux[k]), float(jaux[k]), **BLOCK_TOL)


# Router logits of 4 decode tokens over moe_tiny's 4 experts, each row's
# 2nd and 3rd largest at least 0.5 apart: top-2 picks {0,1}, {1,0}, {1,2},
# {0,2}, so expert 3 gets no token and experts 0, 1, 2 get 3, 3, 2 of the
# 4 capacity slots.
_DECODE_LOGITS = np.array([[3.0, 2.0, 0.0, -1.0],
                           [2.0, 3.0, 0.5, -1.0],
                           [0.1, 2.5, 1.5, -2.0],
                           [3.0, 0.2, 1.0, -3.0]], np.float32)


@pytest.mark.parametrize("weights", ["fp", "int8"])
def test_decode_moe_block_leaves_unrouted_rows_exactly_zero(trees, weights, monkeypatch):
    """The contract the grouped expert kernel's skip rests on. At a decode
    step (N = C = 4, full capacity), dense dispatch leaves the rows of an
    expert no token chose, and every empty slot of the others, exactly 0 in
    both expert inputs: ``xe`` (w_gate, w_up) and ``gate * up`` (w_down,
    silu(0) * 0 = 0), in the port and in the JAX ``moe_block`` alike; and
    the plain version of the expert product gives exactly +0 on those rows."""
    jcfg, tcfg, t = trees
    jp, tp = t[weights]
    E, N, H = tcfg.num_experts, 4, tcfg.hidden_size
    router = np.zeros((H, E), np.float32)
    router[np.arange(E), np.arange(E)] = 1.0          # logits = h[:, :E]
    rng = np.random.default_rng(12)
    h = rng.standard_normal((N, 1, H)).astype(np.float32)
    h[:, 0, :E] = _DECODE_LOGITS
    counts = np.bincount(np.argsort(-_DECODE_LOGITS, axis=1)[:, :2].ravel(), minlength=E)
    assert counts.tolist() == [3, 3, 2, 0]
    srt = np.sort(jax.nn.softmax(jnp.asarray(_DECODE_LOGITS), axis=-1), axis=-1)[:, ::-1]
    assert np.min(srt[:, 1] - srt[:, 2]) >= 1e-4

    jw = dict(jax.tree.map(lambda a: a[1], jp["layers"]), router=jnp.asarray(router))
    tw = dict(tl.layer_weights(tp, 1), router=torch.from_numpy(router))
    seen = {"jax": [], "torch": []}
    real_j, real_t = jm._expert_mm, tm._expert_mm

    def rec_j(x, w, eq, pallas=False):
        seen["jax"].append(np.asarray(x))
        return real_j(x, w, eq, pallas)

    def rec_t(x, w, eq, kernel=False):
        seen["torch"].append(x.detach().clone())
        return real_t(x, w, eq, kernel)

    monkeypatch.setattr(jm, "_expert_mm", rec_j)
    monkeypatch.setattr(tm, "_expert_mm", rec_t)
    jy, _ = jm.moe_block(jnp.asarray(h), jw, jcfg, inference=True)
    ty, _ = tm.moe_block(torch.from_numpy(h), tw, tcfg, inference=True)
    np.testing.assert_allclose(_np(ty), np.asarray(jy), **BLOCK_TOL)
    assert len(seen["jax"]) == len(seen["torch"]) == 3      # w_gate, w_up, w_down
    assert tm._capacity(tcfg, N, True) == N
    for which in (0, 2):                                     # xe, gate * up
        jx, tx = seen["jax"][which], seen["torch"][which].numpy()
        assert tx.shape == jx.shape == (E, N, tx.shape[2])
        for e in range(E):
            assert np.all(tx[e, counts[e]:] == 0) and np.all(jx[e, counts[e]:] == 0), (which, e)
            assert np.all(np.any(tx[e, :counts[e]] != 0, axis=-1)), (which, e)
        np.testing.assert_allclose(tx, jx, **BLOCK_TOL)
        xq = torch.from_numpy(tx)
        K, Nout = xq.shape[2], (tcfg.intermediate_size if which == 0 else H)
        q = torch.from_numpy(rng.integers(-127, 128, (E, K, Nout)).astype(np.int8))
        s = torch.from_numpy((rng.random((E, Nout)) * 0.02 + 1e-3).astype(np.float32))
        out = tk.int8_matmul_expert_reference(xq, q, s)
        for e in range(E):
            assert torch.all(out[e, counts[e]:].view(torch.int32) == 0), (which, e)
        out_bf = tk.int8_matmul_expert_reference(xq.to(torch.bfloat16), q, s)
        for e in range(E):
            assert torch.all(out_bf[e, counts[e]:].view(torch.int16) == 0), (which, e)


# --- forward ----------------------------------------------------------------------------


@pytest.mark.parametrize("weights", ["fp", "int8"])
def test_forward_with_aux_no_cache(trees, weights):
    jcfg, tcfg, t = trees
    jp, tp = t[weights]
    toks = _tokens(np.random.default_rng(8), 2, 10)
    pos = np.broadcast_to(np.arange(10, dtype=np.int32), (2, 10)).copy()
    jlog, jc, jaux = jm.forward_with_aux(jp, jcfg, jnp.asarray(toks), jnp.asarray(pos))
    tlog, tc, taux = tm.forward_with_aux(tp, tcfg, torch.from_numpy(toks).long(),
                                         torch.from_numpy(pos).long())
    assert jc is None and tc is None
    np.testing.assert_allclose(_np(tlog), np.asarray(jlog), **TOL)
    for k in ("load_balance", "router_z"):
        np.testing.assert_allclose(float(taux[k]), float(jaux[k]), **BLOCK_TOL)


@pytest.mark.parametrize("weights", ["fp", "int8"])
def test_cached_prefill_then_decode(trees, weights):
    """Cached prefill (rows at different lengths), a second chunk with
    logit_positions, then three decode steps: logits and caches."""
    jcfg, tcfg, t = trees
    jp, tp = t[weights]
    rng = np.random.default_rng(9)
    jc = jm.KVCache.create(jcfg, 2, 32)
    tc = tl.KVCache.create(tcfg, 2, 32)
    for S in (6, 3, 1, 1, 1):
        toks = _tokens(rng, 2, S)
        lengths = np.asarray(jc.lengths)
        pos = (lengths[:, None] + np.arange(S)[None, :]).astype(np.int32)
        lp = np.array([S - 1, 0], np.int32) if S == 3 else None
        jlog, jc = jm.forward(jp, jcfg, jnp.asarray(toks), jnp.asarray(pos), jc,
                              logit_positions=None if lp is None else jnp.asarray(lp))
        tlog, tc = tm.forward(tp, tcfg, torch.from_numpy(toks).long(),
                              torch.from_numpy(pos).long(), tc,
                              logit_positions=None if lp is None else torch.from_numpy(lp).long())
        np.testing.assert_allclose(_np(tlog), np.asarray(jlog), **TOL, err_msg=f"S={S}")
        np.testing.assert_array_equal(_np(tc.lengths), np.asarray(jc.lengths))
        np.testing.assert_allclose(_np(tc.k), np.asarray(jc.k), **TOL)
        np.testing.assert_allclose(_np(tc.v), np.asarray(jc.v), **TOL)


def test_kernel_flag_on_a_decode_step(trees):
    """int8_pallas=True routes the decode step through int8_matmul and
    int8_matmul_expert, which on CPU tensors are their plain versions
    (scale in f32): the same logits as the dequant path within 1e-5, and
    no kernel launch is counted."""
    _, tcfg, t = trees
    tp = t["int8"][1]
    rng = np.random.default_rng(10)
    toks = torch.from_numpy(_tokens(rng, 2, 8)).long()
    pos = torch.arange(8)[None, :].expand(2, 8)
    step = torch.from_numpy(_tokens(rng, 2, 1)).long()
    before = (tk.int8_matmul.launches, tk.int8_matmul_expert.launches)
    outs = []
    for flag in (False, True):
        cfg = dataclasses.replace(tcfg, int8_pallas=flag)
        cache = tl.KVCache.create(cfg, 2, 32)
        tm.forward(tp, cfg, toks, pos, cache)
        outs.append(tm.forward(tp, cfg, step, cache.lengths[:, None], cache)[0])
    np.testing.assert_allclose(_np(outs[1]), _np(outs[0]), **BLOCK_TOL)
    assert (tk.int8_matmul.launches, tk.int8_matmul_expert.launches) == before


# --- engine and cell ---------------------------------------------------------------------


@pytest.mark.parametrize("weights", ["fp", "int8"])
def test_engine_greedy_streams_match_reference(trees, weights):
    """The port's engine with ``forward_fn=moe.forward`` against the JAX
    engine on a 1-device mesh: mixed prompt lengths over two prefill
    buckets (padding tokens routed in both), more requests than slots."""
    jcfg, tcfg, t = trees
    jp, tp = t[weights]
    rng = np.random.default_rng(11)
    lengths = (5, 70, 23, 9)
    prompts = [rng.integers(1, 512, n).astype(np.int32) for n in lengths]
    new = (9, 6, 12, 8)
    kw = dict(num_slots=2, max_seq_len=160, decode_chunk=4)
    jeng = JaxEngine(jcfg, jp, make_mesh(tensor=1, devices=jax.devices()[:1]),
                     forward_fn=jm.forward, param_specs=moe_specs_for_params(jp), **kw)
    teng = ServingEngine(tcfg, tp, device="cpu", forward_fn=tm.forward, **kw)
    streams = []
    for eng in (jeng, teng):
        reqs = [eng.submit(p, SamplingParams(max_new_tokens=n)) for p, n in zip(prompts, new)]
        while not all(r.done.is_set() for r in reqs):
            eng.step()
        streams.append([list(r.generated) for r in reqs])
    assert streams[1] == streams[0]
    assert [len(s) for s in streams[1]] == list(new)


def _post(url, body):
    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=60) as r:
        return r.status, json.loads(r.read())


def test_serving_cell_serves_mixtral_tiny_over_http():
    with pytest.raises(SystemExit, match="kv-cache-int8"):
        ServingCell("mixtral-tiny", num_slots=2, max_seq_len=64, kv_cache_int8=True,
                    device="cpu")
    cell = ServingCell("mixtral-tiny", dtype="int8", num_slots=2, max_seq_len=64,
                       decode_chunk=4, device="cpu")
    assert cell.engine._forward is tm.forward
    assert cell.engine.params["layers"]["router"].dtype == torch.float32
    cell.warmup(8)
    cell.engine.start()
    server = serve(cell)
    cell.mark_ready()
    base = f"http://127.0.0.1:{server.server_address[1]}"
    try:
        code, body = _post(base + "/v1/generate", {"promptTokens": [3, 1, 4, 1, 5],
                                                   "maxNewTokens": 6})
        assert code == 200 and body["numTokens"] == 6
        again = _post(base + "/v1/generate", {"promptTokens": [3, 1, 4, 1, 5],
                                              "maxNewTokens": 6})[1]
        assert again["tokens"] == body["tokens"]
        with urllib.request.urlopen(base + "/v1/stats", timeout=30) as r:
            stats = json.loads(r.read())
        assert stats["model"] == "mixtral-tiny" and not stats["kvCacheInt8"]
    finally:
        server.shutdown()
        cell.engine.stop()
