"""Heads a tensor axis does not divide, and q-head blocks that straddle a
replicated cache's kv groups, on gloo ranks on the CPU: ``tiny`` (4 heads, 2
kv heads) and ``mixtral-tiny`` over 8 ranks give the JAX engine's greedy
tokens on ``serving_mesh(8)``, the case of ``tests/test_disagg.py:190-191``
(GSPMD cuts each head in half there; the port gives ranks 0-3 one whole
head each and ranks 4-7 a zero head), and bge-tiny's vectors the JAX
embedding engine's within 1e-5; two configs whose q-head blocks
straddle kv groups (one of them with uneven heads too) give the JAX
forward's logits on ``serving_mesh(8)`` within rtol = atol = 1e-4
(``tests/test_torch_llama.py``'s tolerance); the port refuses a tensor size
exactly where the reference's ``shard_params`` cannot place the tree. Then
the per-layer profile of a rank group: at 8 ranks and at 2 (``tiny|cpu|2``)
its FLOPs and bytes are the one-device profile's, as the reference's on
``serving_mesh(2)`` are its one-device ones, each component's FLOPs within
the reference's 5% of the JAX cost analysis's, and a Mixtral group answers
as the reference's does on a MoE tree.

Two rank groups serve the file in turn (8 ranks, then 2); their
collectives time out after ``GROUP_TIMEOUT_S``."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kukeon_tpu.models import bert as jb
from kukeon_tpu.models import llama as jl
from kukeon_tpu.models import moe as jm
from kukeon_tpu.obs import profile as jprofile
from kukeon_tpu.parallel import moe_specs_for_params
from kukeon_tpu.parallel import serving_mesh as jax_serving_mesh
from kukeon_tpu.parallel import sharding as jshd
from kukeon_tpu.serving import EmbeddingEngine as JaxEmbeddingEngine
from kukeon_tpu.serving import SamplingParams as JaxSampling
from kukeon_tpu.serving import ServingEngine as JaxEngine
from kukeon_tpu_torch.models import bert as tb
from kukeon_tpu_torch.models import convert
from kukeon_tpu_torch.models import llama as tl
from kukeon_tpu_torch.models import moe as tm
from kukeon_tpu_torch.models.checkpoints import _walk_tree
from kukeon_tpu_torch.obs import profile as tprofile
from kukeon_tpu_torch.parallel import launch, serving_mesh
from kukeon_tpu_torch.parallel import sharding as tshd
from kukeon_tpu_torch.parallel.forward import TensorParallelForward
from kukeon_tpu_torch.parallel.sharding import Recipe
from kukeon_tpu_torch.runtime.serving_cell import ServingCell
from kukeon_tpu_torch.serving import EmbeddingEngine, SamplingParams, ServingEngine

torch.set_num_threads(2)

PROMPTS = [np.arange(2, 12, dtype=np.int32),
           np.array([5, 300, 7, 411, 9, 13, 40, 41, 42, 43, 44, 45, 46, 47], np.int32)]
GREEDY = SamplingParams(temperature=0.0, max_new_tokens=8)
KW = dict(num_slots=2, max_seq_len=128, decode_chunk=4)
LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)       # tests/test_torch_llama.py's
EMBED_TOL = dict(rtol=1e-5, atol=1e-5)       # tests/test_torch_embedding.py's
GROUP_TIMEOUT_S = "60"
# The reference's acceptance bound on a profile's FLOPs (tests/test_profile.py).
FLOPS_REL = 0.05


@pytest.fixture(scope="module", autouse=True)
def _groups():
    mp = pytest.MonkeyPatch()
    mp.setenv(launch.TIMEOUT_ENV, GROUP_TIMEOUT_S)
    yield
    launch.shutdown()
    mp.undo()


def _mesh(n: int):
    """The leader's mesh of n gloo ranks, all on tensor: the open group
    when it has n ranks, else a new one (the other closed first)."""
    g = launch.current()
    if g is not None and g.world != n:
        launch.shutdown()
    return serving_mesh(n, "cpu")


def _recipe(tree, path) -> Recipe:
    np.savez(path, **{"/".join(k): np.asarray(v) for k, v in _walk_tree(tree)})
    return Recipe("kukeon_tpu_torch.models.convert:npz_leaves", {"path": str(path)})


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    """family -> (the JAX tree, a recipe of it): tiny and mixtral-tiny from
    the JAX init, f32."""
    tmp = tmp_path_factory.mktemp("weights")
    out = {}
    for name, jp in (("tiny", jl.init_params(jax.random.key(0), jl.llama_tiny())),
                     ("moe", jm.init_params(jax.random.key(0), jm.moe_tiny()))):
        out[name] = (jp, _recipe(jax.tree.map(np.asarray, jp), tmp / f"{name}.npz"))
    return out


def _jax_tokens(cfg, jp, mesh, **kw):
    eng = JaxEngine(cfg, jp, mesh, **{**KW, **kw})
    sp = JaxSampling(temperature=0.0, max_new_tokens=8)
    return [list(eng.generate(p, sp)) for p in PROMPTS]


# --- the cut -------------------------------------------------------------------------------


def test_whole_heads_are_cut_and_padded():
    """tiny's wq (4 heads of 32) at 8: ranks 0-3 hold one head each, ranks
    4-7 one head of zeros; the real blocks concatenate to the leaf; wo's
    rows likewise; the int8 scale of wq by the same heads."""
    cfg = tl.llama_tiny()
    full = tl.quantize_params(tl.init_params(cfg, torch.Generator().manual_seed(0), "cpu"))
    wq, wo = full["layers"]["wq"], full["layers"]["wo"]
    shards = [tshd.shard_tree(full, r, 8, kv_shard=False, head_dim=cfg.head_dim)
              for r in range(8)]
    for key, leaf, axis in (("q", wq["q"], 2), ("s", wq["s"], 1)):
        parts = [s["layers"]["wq"][key] for s in shards]
        assert all(p.shape[axis] == cfg.head_dim for p in parts)
        assert torch.equal(torch.cat(parts[:4], axis), leaf)
        assert all(not p.any() for p in parts[4:])
    rows = [s["layers"]["wo"]["q"] for s in shards]
    assert torch.equal(torch.cat(rows[:4], 1), wo["q"]) and not torch.cat(rows[4:], 1).any()
    # The replicated cache's wk/wv and wo's scale are whole on every rank.
    assert all(torch.equal(s["layers"]["wk"]["q"], full["layers"]["wk"]["q"]) for s in shards)
    assert all(torch.equal(s["layers"]["wo"]["s"], wo["s"]) for s in shards)


@pytest.mark.parametrize("family", ["llama", "moe", "bert"])
def test_refusals_are_the_reference_s(family):
    """At every tensor size 1..8 the port refuses a config exactly where the
    reference's ``shard_params`` raises (a dim of the attention, kv or
    intermediate width it does not divide), for configs whose vocabulary
    every size divides (a vocabulary the port pads)."""
    if family == "llama":
        jcfg = dataclasses.replace(jl.llama_tiny(), vocab_size=840, num_heads=6,
                                   num_kv_heads=2, head_dim=20, intermediate_size=120)
        tcfg = dataclasses.replace(tl.llama_tiny(), vocab_size=840, num_heads=6,
                                   num_kv_heads=2, head_dim=20, intermediate_size=120)
        tree = jl.init_params(jax.random.key(0), jcfg)
    elif family == "moe":
        jcfg = dataclasses.replace(jm.moe_tiny(), vocab_size=840, intermediate_size=84)
        tcfg = dataclasses.replace(tm.moe_tiny(), vocab_size=840, intermediate_size=84)
        tree = jm.init_params(jax.random.key(0), jcfg)
    else:
        jcfg = dataclasses.replace(jb.bge_tiny(), vocab_size=840, hidden_size=60,
                                   num_heads=6, intermediate_size=120)
        tcfg = dataclasses.replace(tb.bge_tiny(), vocab_size=840, hidden_size=60,
                                   num_heads=6, intermediate_size=120)
        tree = jb.init_params(jax.random.key(0), jcfg)
    shard = {"llama": jshd.shard_params, "bert": jshd.shard_bert_params}.get(family)
    for n in range(1, 9):
        mesh = jax_serving_mesh(n)
        try:
            if family == "moe":
                jshd.shard_params(tree, mesh, specs=moe_specs_for_params(tree))
            else:
                shard(tree, mesh)
            places = True
        except ValueError:
            places = False
        try:
            tshd.check_tensor_parallel(tcfg, n)
            serves = True
        except SystemExit:
            serves = False
        assert serves == places, (family, n, places)


# --- 8 ranks ------------------------------------------------------------------------------


@pytest.mark.parametrize("layout", ["legacy", "paged"])
def test_tiny_greedy_on_8_ranks_matches_jax(trees, layout):
    """tiny over 8 ranks (ranks 4-7 holding a zero head; the cache
    replicated, each rank attending its head to its kv head) gives the JAX
    engine's tokens on ``serving_mesh(8)``, serially and concurrently."""
    jp, recipe = trees["tiny"]
    kw = dict(kv_page_tokens=16, kv_pool_pages=16) if layout == "paged" else {}
    want = _jax_tokens(jl.llama_tiny(), jp, jax_serving_mesh(8), **kw)
    eng = ServingEngine(tl.llama_tiny(), recipe, mesh=_mesh(8), **KW, **kw)
    try:
        cfg = tl.llama_tiny()
        assert not eng.kv_sharded and eng.state.cache.k.shape[3] == cfg.num_kv_heads
        assert eng.params["layers"]["wq"].shape[-1] == cfg.head_dim
        assert [eng.generate(p, GREEDY) for p in PROMPTS] == want
        reqs = [eng.submit(p, GREEDY) for p in PROMPTS]
        while not all(r.done.is_set() for r in reqs):
            eng.step()
        assert [r.generated for r in reqs] == want
    finally:
        eng.close()


def test_mixtral_greedy_on_8_ranks_matches_jax(trees):
    """mixtral-tiny over 8 ranks: 4 heads, 2 kv heads and 128 intermediate
    columns an expert, cut 8 ways; the JAX MoE engine's tokens on
    ``serving_mesh(8)``."""
    jp, recipe = trees["moe"]
    want = _jax_tokens(jm.moe_tiny(), jp, jax_serving_mesh(8), forward_fn=jm.forward,
                       param_specs=moe_specs_for_params(jp))
    eng = ServingEngine(tm.moe_tiny(), recipe, mesh=_mesh(8), forward_fn=tm.forward, **KW)
    try:
        assert [eng.generate(p, GREEDY) for p in PROMPTS] == want
    finally:
        eng.close()


def test_bge_vectors_on_8_ranks_match_jax(tmp_path):
    """bge-tiny (4 heads of 16) over 8 ranks, ranks 4-7 holding a zero head
    and zero biases for it: the vectors of a ragged burst within 1e-5 of
    the JAX EmbeddingEngine on ``serving_mesh(8)``."""
    cfg = tb.bge_tiny()
    jp = jax.tree.map(np.asarray, jb.init_params(jax.random.key(5), jb.bge_tiny()))
    rng = np.random.default_rng(3)
    prompts = [rng.integers(1, 512, n).astype(np.int32) for n in (3, 17, 40, 9, 1, 33)]
    want = JaxEmbeddingEngine(jb.bge_tiny(), jp, jax_serving_mesh(8),
                              batch_size=4).embed_batch(prompts)
    eng = EmbeddingEngine(cfg, _recipe(jp, tmp_path / "w.npz"), batch_size=4, mesh=_mesh(8))
    try:
        assert eng.params["layers"]["wq"].shape[-1] == cfg.head_dim
        np.testing.assert_allclose(eng.embed_batch(prompts), np.asarray(want), **EMBED_TOL)
    finally:
        eng.close()


@pytest.mark.parametrize("heads", [(24, 6, 8), (12, 4, 16)],
                         ids=["straddle_even", "straddle_uneven"])
def test_straddling_head_blocks_match_jax_logits(heads, tmp_path):
    """Over 8 ranks with the cache replicated: 24 heads in 6 kv groups of 4
    (3 heads a rank: rank 1's heads 3-5 span groups 0 and 1), and 12 heads
    in 4 groups of 3 (2 heads a rank, ranks 6-7 padded: rank 1's heads 2-3
    span groups 0 and 1). A prefill of 8 and two decode steps against the
    cache give the JAX forward's logits, its weights sharded on
    ``serving_mesh(8)``, within 1e-4."""
    nh, kv, d = heads
    changes = dict(num_heads=nh, num_kv_heads=kv, head_dim=d)
    cfg_j = dataclasses.replace(jl.llama_tiny(), **changes)
    cfg_t = dataclasses.replace(tl.llama_tiny(), **changes)
    assert tshd.check_tensor_parallel(cfg_t, 8) is False
    jp = jl.init_params(jax.random.key(2), cfg_j)
    recipe = _recipe(jax.tree.map(np.asarray, jp), tmp_path / "w.npz")
    jmesh = jax_serving_mesh(8)
    jps = jshd.shard_params(jp, jmesh)
    fwd = jax.jit(lambda p, t, pos, c: jl.forward(p, cfg_j, t, pos, c))
    jcache = jl.KVCache.create(cfg_j, 1, 32)
    tfwd = TensorParallelForward(_mesh(8), cfg_t, recipe, batch=1, max_len=32)
    try:
        assert tfwd.params["layers"]["wq"].shape[-1] == -(-nh // 8) * d
        toks = np.array([[5, 300, 7, 411, 9, 13, 2, 8]], np.int32)
        steps = [(toks, np.arange(8, dtype=np.int32)[None])]
        steps += [(np.array([[t]], np.int32), np.array([[8 + i]], np.int32))
                  for i, t in enumerate((17, 250))]
        for t, pos in steps:
            want, jcache = fwd(jps, jnp.asarray(t), jnp.asarray(pos), jcache)
            got = tfwd(torch.from_numpy(t.astype(np.int64)),
                       torch.from_numpy(pos.astype(np.int64)))
            np.testing.assert_allclose(got.numpy(), np.asarray(want), **LOGIT_TOL)
    finally:
        tfwd.close()


def _counts(prof) -> list:
    return [(c["name"], c.get("prefill", {}).get("flops"), c.get("prefill", {}).get("bytes"),
             c.get("decode", {}).get("flops"), c.get("decode", {}).get("bytes"))
            for c in prof["components"]]


def _one_device_profile(jp, cfg_t, **kw):
    params = convert.params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    return tprofile.profile_layers(params, cfg_t, "cpu", measure=False, **kw)


@pytest.mark.parametrize("int8", [False, True], ids=["f32", "int8"])
def test_the_profile_of_8_ranks_counts_the_whole_model(trees, int8):
    """The per-layer profile of tiny over 8 ranks (uneven heads), every
    rank running each component with its collectives: no error, and the
    one-device profile's FLOPs and bytes, component by component."""
    jp, recipe = trees["tiny"]
    if int8:
        jp = jl.quantize_params(jp)
        recipe = _recipe(jax.tree.map(np.asarray, jp),
                         recipe.kwargs["path"].replace(".npz", "_int8.npz"))
    eng = ServingEngine(tl.llama_tiny(), recipe, mesh=_mesh(8), **KW)
    try:
        prof = eng.profile_layers(prefill_len=16, decode_batch=2, measure=False)
        assert prof["errors"] == 0
        want = _one_device_profile(jp, tl.llama_tiny(), prefill_len=16, decode_batch=2)
        assert _counts(prof) == _counts(want)
        assert (prof["model_flops"], prof["model_bytes"]) == (want["model_flops"],
                                                            want["model_bytes"])
        assert eng.generate(PROMPTS[0], GREEDY)
    finally:
        eng.close()


# --- 2 ranks: the profile against the reference -------------------------------------------


def test_the_profile_of_a_two_rank_group_counts_as_the_reference(trees, tmp_path,
                                                                  monkeypatch):
    """A two-rank cell's ``profile_layers`` (``measure=False`` through the
    engine, then the cell's, keyed ``tiny|cpu|2``): the reference reports
    the same FLOPs and bytes on ``serving_mesh(2)`` as on one device, and
    so does the port; each of its components' FLOPs is within the
    reference's 5% of the JAX cost analysis's (the port counts by formula,
    ``obs/profile.py layer_cost``; XLA's count adds the elementwise
    operations), at both shapes."""
    jp, recipe = trees["tiny"]
    jcfg, tcfg = jl.llama_tiny(), tl.llama_tiny()
    kw = dict(prefill_len=16, decode_batch=2)
    jone = jprofile.profile_layers(jp, jcfg, None, measure=False, **kw)
    jmesh = jprofile.profile_layers(jshd.shard_params(jp, jax_serving_mesh(2)), jcfg,
                                    jax_serving_mesh(2), measure=False, **kw)
    assert jmesh["errors"] == jone["errors"] == 0
    assert _counts(jmesh) == _counts(jone)
    eng = ServingEngine(tcfg, recipe, mesh=_mesh(2), **KW)
    try:
        prof = eng.profile_layers(measure=False, **kw)
    finally:
        eng.close()
    assert _counts(prof) == _counts(_one_device_profile(jp, tcfg, **kw))
    for mine, ref in zip(prof["components"], jmesh["components"]):
        assert mine["name"] == ref["name"]
        for shape in ("prefill", "decode"):
            rel = abs(mine[shape]["flops"] - ref[shape]["flops"]) / ref[shape]["flops"]
            assert rel < FLOPS_REL, (mine["name"], shape, mine[shape], ref[shape])
    monkeypatch.setenv("KUKEON_LAYER_PROFILE_PATH", str(tmp_path / "layers.json"))
    cell = ServingCell("tiny", num_slots=2, max_seq_len=96, device="cpu", chips=2)
    try:
        got = cell.profile_layers(**kw)
        assert got["errors"] == 0 and got["key"] == "tiny|cpu|2" and "path" in got
        assert _counts(got) == _counts(prof)
    finally:
        cell.engine.close()


def test_a_moe_group_profiles_as_the_reference_does(trees):
    """mixtral-tiny over 2 ranks: the reference's profile of a MoE tree on
    ``serving_mesh(2)`` runs its dense block over the expert stacks, which
    fails at a decode batch that is neither 1 nor the expert count; the
    port's group fails the same components, and profiles the others."""
    jp, recipe = trees["moe"]
    kw = dict(prefill_len=8, decode_batch=2)
    ref = jprofile.profile_layers(
        jshd.shard_params(jp, jax_serving_mesh(2), specs=moe_specs_for_params(jp)),
        jm.moe_tiny(), jax_serving_mesh(2), measure=False, **kw)
    eng = ServingEngine(tm.moe_tiny(), recipe, mesh=_mesh(2), forward_fn=tm.forward, **KW)
    try:
        prof = eng.profile_layers(measure=False, **kw)
        assert eng.generate(PROMPTS[0], GREEDY)
    finally:
        eng.close()
    assert [("error" in c) for c in prof["components"]] == [
        ("error" in c) for c in ref["components"]] == [False, True, True, False]
    assert prof["errors"] == ref["errors"] == 2


def test_a_follower_failing_inside_a_component_ends_the_group(trees):
    """One follower of a two-rank group raises inside the profile's first
    block, after its attention's ``all_reduce`` (a fault planted in that
    process alone, ``tests/torch_follower_faults.py``). Its peer is then in
    a collective the follower never enters, so no ``error`` entry can keep
    the ranks in step: the follower's error ends the group, naming rank 1,
    and the leader's profile call raises well inside the collectives'
    timeout, instead of pairing its next collective with another one. Last
    in the file: it ends the file's group of two."""
    import time

    _, recipe = trees["tiny"]
    mesh = _mesh(2)
    heard = []
    mesh.group.on_failure = heard.append
    eng = ServingEngine(tl.llama_tiny(), recipe, mesh=mesh, **KW)
    assert eng.generate(PROMPTS[0], GREEDY)
    mesh.group.post(mesh.group.new_id(), "new",
                    ("tests.torch_follower_faults:fail_mlp", {"calls": 1}))
    t0 = time.monotonic()
    with pytest.raises(Exception):
        eng.profile_layers(measure=False, prefill_len=8, decode_batch=2)
    assert time.monotonic() - t0 < float(GROUP_TIMEOUT_S) / 2
    assert mesh.group.failed and "rank 1" in mesh.group.failed, mesh.group.failed
    assert "planted" in mesh.group.failed, mesh.group.failed
    assert heard == [mesh.group.failed]
    with pytest.raises(launch.RankFailure, match="rank 1"):
        eng.generate(PROMPTS[0], GREEDY)
    launch.shutdown()
