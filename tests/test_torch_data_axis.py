"""Serving on a ``data`` x ``tensor`` mesh of the port, the counterpart of the
reference's ``make_mesh(data=, tensor=)`` serving, on gloo ranks on the CPU:
at ``llama_tiny`` (legacy and paged KV) and ``mixtral-tiny`` the port's
engine over data 2 x tensor 2 (this process the leader, three follower
processes) gives the greedy tokens of the JAX engine on ``make_mesh(data=2,
tensor=2)``; bge-tiny over data 2 x tensor 1 gives the JAX
``EmbeddingEngine``'s vectors on ``make_mesh(data=2, tensor=1)`` within
1e-5; a cell without ``--chips`` takes the reference's ``auto_mesh_shape``
layout (12 and 16 GPUs, no group started), a cell on data 2 x tensor 2 from
a kukeon int8 checkpoint (each replica's ranks streaming their tensor
peer's blocks) answers as one device and profiles under ``tiny|cpu|4``; a
KV export gathered over the leader's replica imports back; a
tuning profile whose ``mesh_tensor`` is not the world gives both engines
the same levers (C11); a dead rank of replica 1 ends the group, named.

Two rank groups serve the file in turn (data 2 x tensor 2, then data 2 x
tensor 1, :func:`_mesh`); their collectives and rendezvous time out after
``GROUP_TIMEOUT_S``, so no case can hang the suite. Greedy tokens are
compared exactly; embeddings within rtol = atol = 1e-5
(``tests/test_torch_embedding.py``'s tolerance)."""

import dataclasses
import time

import jax
import numpy as np
import pytest
import torch

from kukeon_tpu.models import bert as jb
from kukeon_tpu.models import llama as jl
from kukeon_tpu.models import moe as jm
from kukeon_tpu.parallel import mesh as jmesh
from kukeon_tpu.parallel import moe_specs_for_params
from kukeon_tpu.serving import EmbeddingEngine as JaxEmbeddingEngine
from kukeon_tpu.serving import SamplingParams as JaxSampling
from kukeon_tpu.serving import ServingEngine as JaxEngine
from kukeon_tpu.serving import tuning as jtuning
from kukeon_tpu_torch.models import bert as tb
from kukeon_tpu_torch.models import checkpoints, convert
from kukeon_tpu_torch.models import llama as tl
from kukeon_tpu_torch.models import moe as tm
from kukeon_tpu_torch.models.checkpoints import _walk_tree
from kukeon_tpu_torch.parallel import launch, make_mesh
from kukeon_tpu_torch.parallel.forward import TensorParallelForward
from kukeon_tpu_torch.parallel.sharding import Recipe
from kukeon_tpu_torch.runtime import serving_cell
from kukeon_tpu_torch.runtime.serving_cell import ServingCell
from kukeon_tpu_torch.serving import EmbeddingEngine, SamplingParams, ServingEngine
from kukeon_tpu_torch.serving import tuning

torch.set_num_threads(2)

PROMPTS = [np.arange(2, 12, dtype=np.int32),
           np.array([5, 300, 7, 411, 9, 13, 40, 41, 42, 43, 44, 45, 46, 47], np.int32)]
GREEDY = SamplingParams(temperature=0.0, max_new_tokens=8)
KW = dict(num_slots=2, max_seq_len=128, decode_chunk=4)
PAGED = dict(kv_page_tokens=16, kv_pool_pages=16)
EMBED_TOL = dict(rtol=1e-5, atol=1e-5)       # tests/test_torch_embedding.py's
GROUP_TIMEOUT_S = "60"


@pytest.fixture(scope="module", autouse=True)
def _groups():
    """The file's rank groups time out after ``GROUP_TIMEOUT_S``; the last
    one is closed, and its followers joined, at the end."""
    mp = pytest.MonkeyPatch()
    mp.setenv(launch.TIMEOUT_ENV, GROUP_TIMEOUT_S)
    yield
    launch.shutdown()
    mp.undo()


def _mesh(data: int, tensor: int):
    """The leader's mesh of data x tensor gloo ranks: the open group when
    it has that shape, else a new one (the other closed first)."""
    g = launch.current()
    if g is not None and (g.world, g.tensor) != (data * tensor, tensor):
        launch.shutdown()
    return make_mesh(data, tensor, device="cpu")


def _jax_mesh(data: int, tensor: int):
    return jmesh.make_mesh(data=data, tensor=tensor, devices=jax.devices()[:data * tensor])


def _recipe(tree, path) -> Recipe:
    """A weight recipe every rank runs: ``tree`` (numpy leaves) in an
    ``.npz`` that ``convert.npz_leaves`` reads back leaf by leaf."""
    np.savez(path, **{"/".join(k): np.asarray(v) for k, v in _walk_tree(tree)})
    return Recipe("kukeon_tpu_torch.models.convert:npz_leaves", {"path": str(path)})


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    """family -> (the JAX tree, the port's CPU tree, a recipe of it): tiny
    and mixtral-tiny from the JAX init, f32."""
    tmp = tmp_path_factory.mktemp("weights")
    out = {}
    for name, jp in (("tiny", jl.init_params(jax.random.key(0), jl.llama_tiny())),
                     ("moe", jm.init_params(jax.random.key(0), jm.moe_tiny()))):
        host = jax.tree.map(np.asarray, jp)
        out[name] = (jp, convert.params_from_numpy(host, "cpu"), _recipe(host, tmp / f"{name}.npz"))
    return out


def _run(eng, reqs):
    while not all(r.done.is_set() for r in reqs):
        eng.step()
    assert all(r.error is None for r in reqs), [r.error for r in reqs]
    return [r.generated for r in reqs]


def _jax_tokens(cfg, jp, mesh, **kw):
    eng = JaxEngine(cfg, jp, mesh, **{**KW, **kw})
    sp = JaxSampling(temperature=0.0, max_new_tokens=8)
    return [list(eng.generate(p, sp)) for p in PROMPTS]


# --- the grant ----------------------------------------------------------------------------


@pytest.mark.parametrize("visible,want", [(12, {"data": 2, "tensor": 6}),
                                          (16, {"data": 2, "tensor": 8})])
def test_a_cell_without_chips_lays_out_the_reference_layout(monkeypatch, visible, want):
    """No ``--chips`` at 12 and 16 visible GPUs: the reference's
    ``auto_mesh_shape`` layout (data 2 x tensor 6, data 2 x tensor 8),
    for every family, without a group started."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: visible)
    before = launch.current()
    assert jmesh.auto_mesh_shape(visible) == want
    assert serving_cell.grant(None, "cuda") == want
    for model in ("llama3-8b", "mixtral-8x7b", "bge-base"):
        assert serving_cell.cell_world(model, None, "cuda") == want
    assert serving_cell.grant(4, "cuda") == {"data": 1, "tensor": 4}
    assert launch.current() is before


# --- data 2 x tensor 2 --------------------------------------------------------------------


def test_the_mesh_has_both_coordinates():
    """The leader's mesh of data 2 x tensor 2: four ranks, two replicas of
    two, the leader at (0, 0) with a tensor subgroup of its own; ``rank``
    and ``world`` are the tensor axis's, ``size`` the mesh's."""
    mesh = _mesh(2, 2)
    assert (mesh.replica, mesh.rank, mesh.world, mesh.size) == (0, 0, 2, 4)
    assert mesh.shape == {"data": 2, "expert": 1, "tensor": 2}
    assert mesh.group.tensor == 2 and mesh.leader
    assert len(mesh.group.pids) == 3 and mesh.group.tensor_pg is not None


@pytest.mark.parametrize("layout", ["legacy", "paged"])
def test_tiny_greedy_matches_jax_data2_tensor2(trees, layout):
    """The tentpole: tiny over data 2 x tensor 2 gives the JAX engine's
    tokens on ``make_mesh(data=2, tensor=2)``, serially and as concurrent
    requests, on both KV layouts; each rank holds half the heads and one of
    the two kv heads (the tensor cut), and the engine's world is 4."""
    jp, _, recipe = trees["tiny"]
    kw = PAGED if layout == "paged" else {}
    want = _jax_tokens(jl.llama_tiny(), jp, _jax_mesh(2, 2), **kw)
    eng = ServingEngine(tl.llama_tiny(), recipe, mesh=_mesh(2, 2), **KW, **kw)
    try:
        assert (eng.world, eng.tensor, eng.kv_sharded) == (4, 2, True)
        assert eng.params["layers"]["wq"].shape[-1] == tl.llama_tiny().q_dim // 2
        assert eng.state.cache.k.shape[3] == 1
        assert [eng.generate(p, GREEDY) for p in PROMPTS] == want
        assert _run(eng, [eng.submit(p, GREEDY) for p in PROMPTS]) == want
    finally:
        eng.close()


@pytest.mark.parametrize("kind", ["fp", "int8"])
def test_mixtral_greedy_matches_jax_data2_tensor2(trees, kind):
    """mixtral-tiny over data 2 x tensor 2 gives the JAX MoE engine's tokens
    on ``make_mesh(data=2, tensor=2)``, f32 and int8 (each rank quantizes
    its drawn slices as the one-device tree is quantized)."""
    jp, _, recipe = trees["moe"]
    if kind == "int8":
        jp = jm.quantize_params(jp)
        recipe = _recipe(jax.tree.map(np.asarray, jp),
                         recipe.kwargs["path"].replace(".npz", "_int8.npz"))
    want = _jax_tokens(jm.moe_tiny(), jp, _jax_mesh(2, 2), forward_fn=jm.forward,
                       param_specs=moe_specs_for_params(jp))
    eng = ServingEngine(tm.moe_tiny(), recipe, mesh=_mesh(2, 2), forward_fn=tm.forward, **KW)
    try:
        w_gate = eng.params["layers"]["w_gate"]
        w_gate = w_gate["q"] if isinstance(w_gate, dict) else w_gate
        assert w_gate.shape[-1] == tm.moe_tiny().intermediate_size // 2
        assert [eng.generate(p, GREEDY) for p in PROMPTS] == want
    finally:
        eng.close()


def test_moe_routes_gather_over_the_tensor_subgroup(trees):
    """A MoE rank's expert choices are gathered over its replica's tensor
    subgroup: two peers' choices, equal (the router is replicated), where
    the whole group would give four."""
    cfg = tm.moe_tiny()
    fwd = TensorParallelForward(_mesh(2, 2), cfg, trees["moe"][2], batch=1, max_len=32)
    try:
        toks = torch.tensor([[5, 300, 7, 411, 9]])
        routes = fwd.routes(toks, torch.arange(5)[None])
        assert routes.shape[:2] == (2, cfg.num_layers)
        assert torch.equal(routes[0], routes[1])
    finally:
        fwd.close()


def test_handoff_across_a_data_axis(trees):
    """A KV export of data 2 x tensor 2 gathers the kv heads over the
    leader's replica into one device's wire format (equal to one device's
    export within 1e-5); imported into data 2 x tensor 2 (each rank of
    each replica given its tensor coordinate's kv heads) it continues with
    the one-device tokens."""
    prompt = np.arange(1, 24, dtype=np.int32)
    one = ServingEngine(tl.llama_tiny(), trees["tiny"][1], device="cpu", **KW, **PAGED)
    ref = one.generate(prompt, GREEDY)
    r1 = one.submit(prompt, GREEDY, export=True)
    p1 = _run(one, [r1]) and r1.export_payload
    eng = ServingEngine(tl.llama_tiny(), trees["tiny"][2], mesh=_mesh(2, 2), **KW, **PAGED)
    try:
        r = eng.submit(prompt, GREEDY, export=True)
        p = _run(eng, [r]) and r.export_payload
        assert p["token"] == ref[0] and tuple(p["k"].shape) == tuple(p1["k"].shape)
        for name in ("k", "v"):
            np.testing.assert_allclose(p[name].numpy(), p1[name].numpy(), rtol=1e-5, atol=1e-5)
        imp = {"token": p["token"], "length": p["length"], "k": p["k"], "v": p["v"]}
        assert _run(eng, [eng.submit(prompt, GREEDY, kv_import=imp)]) == [ref]
    finally:
        eng.close()


def test_cell_data2_tensor2_from_a_checkpoint(trees, tmp_path, monkeypatch):
    """A cell whose grant lays out data 2 x tensor 2 (the CPU shows no GPU
    count, so the grant is given): each rank streams its tensor
    coordinate's blocks of a kukeon int8 checkpoint, replica 1 the blocks
    of its replica-0 peer; /v1/stats reports the reference's mesh keys;
    its greedy tokens are the one-device cell's from the same directory;
    its per-layer profile runs on all four ranks, keyed ``tiny|cpu|4``."""
    cfg = tl.llama_tiny()
    checkpoints.save_quantized(str(tmp_path / "q"), tl.quantize_params(trees["tiny"][1]), cfg)
    body = {"promptTokens": [int(t) for t in PROMPTS[1]], "maxNewTokens": 6}
    one = ServingCell("tiny", num_slots=2, max_seq_len=96, device="cpu",
                      checkpoint=str(tmp_path / "q"))
    want = one.generate(body)["tokens"]
    _mesh(2, 2)
    monkeypatch.setattr(serving_cell, "grant", lambda chips, dtype: {"data": 2, "tensor": 2})
    monkeypatch.setenv("KUKEON_LAYER_PROFILE_PATH", str(tmp_path / "layers.json"))
    cell = ServingCell("tiny", num_slots=2, max_seq_len=96, device="cpu",
                       checkpoint=str(tmp_path / "q"))
    try:
        assert cell.engine._ckpt_stream is not None
        assert cell.stats()["mesh"] == {"chips": 4, "shape": {"data": 2, "tensor": 2},
                                        "kvSharded": True}
        cell.warmup(8)
        assert cell.generate(body)["tokens"] == want
        prof = cell.profile_layers(prefill_len=8, decode_batch=2)
        assert prof["errors"] == 0 and prof["key"] == "tiny|cpu|4"
        assert tuning.load_layer_profile("tiny", "cpu", 4)["components"] == prof["components"]
    finally:
        cell.engine.close()


def test_a_dead_rank_of_replica_1_ends_the_group(trees):
    """A follower of data replica 1 (global rank 3) killed mid-serving:
    the group fails naming it, and the leader's next device action raises
    ``RankFailure`` instead of waiting in a collective."""
    mesh = _mesh(2, 2)
    eng = ServingEngine(tl.llama_tiny(), trees["tiny"][2], mesh=mesh, **KW)
    assert eng.generate(PROMPTS[0], GREEDY)
    proc = mesh.group._procs[2]
    proc.kill()
    proc.wait()
    deadline = time.monotonic() + 30
    while mesh.group.failed is None and time.monotonic() < deadline:
        time.sleep(0.05)
    assert mesh.group.failed is not None and "rank 3" in mesh.group.failed
    with pytest.raises(launch.RankFailure, match="rank 3"):
        eng.generate(PROMPTS[0], GREEDY)
    launch.shutdown()


# --- data 2 x tensor 1 --------------------------------------------------------------------


def test_bge_vectors_match_the_jax_engine_data2_tensor1(tmp_path):
    """bge-tiny over data 2 x tensor 1 (two whole replicas): the vectors of
    a ragged burst within 1e-5 of the JAX EmbeddingEngine on
    ``make_mesh(data=2, tensor=1)``; each replica holds the whole tree."""
    cfg = tb.bge_tiny()
    jp = jax.tree.map(np.asarray, jb.init_params(jax.random.key(4), jb.bge_tiny()))
    rng = np.random.default_rng(3)
    prompts = [rng.integers(1, 512, n).astype(np.int32) for n in (3, 17, 40, 9, 1, 33)]
    want = JaxEmbeddingEngine(jb.bge_tiny(), jp, _jax_mesh(2, 1),
                              batch_size=4).embed_batch(prompts)
    eng = EmbeddingEngine(cfg, _recipe(jp, tmp_path / "w.npz"), batch_size=4, mesh=_mesh(2, 1))
    try:
        assert eng.params["layers"]["wq"].shape[-1] == cfg.hidden_size
        np.testing.assert_allclose(eng.embed_batch(prompts), np.asarray(want), **EMBED_TOL)
    finally:
        eng.close()


def test_c11_a_profile_of_another_tensor_axis_gives_both_engines_its_levers(
        trees, tmp_path, monkeypatch):
    """C11: a tuning profile stored under ``tiny|cpu|2`` whose
    ``mesh_tensor`` is 1 (the tuned layout: data 2 x tensor 1) gives the
    port's engine on data 2 x tensor 1 the levers it gives the JAX engine
    on ``make_mesh(data=2, tensor=1)``, which never reads ``mesh_tensor``;
    the port once refused it."""
    monkeypatch.setenv("KUKEON_TUNE_PATH", str(tmp_path / "tune.json"))
    prof = tuning.ServingTune(decode_chunk=8, kv_cache_int8=False, prefill_buckets=(16, 64),
                              kv_page_tokens=16, mesh_tensor=1)
    tuning.save("tiny", "cpu", 2, prof)
    assert jtuning.load("tiny", "cpu", 2).mesh_tensor == 1
    jp, _, recipe = trees["tiny"]
    jeng = JaxEngine(jl.llama_tiny(), jp, _jax_mesh(2, 1), num_slots=2, max_seq_len=128,
                     model_name="tiny")
    eng = ServingEngine(tl.llama_tiny(), recipe, mesh=_mesh(2, 1), num_slots=2,
                        max_seq_len=128, model_name="tiny")
    try:
        def levers(e):
            return (e.decode_chunk, e.kv_cache_int8, tuple(e.prefill_buckets), e.page_tokens)

        assert jeng.tune is not None and eng.tune is not None
        assert levers(eng) == levers(jeng) == (8, False, (16, 64), 16)
        assert dataclasses.replace(eng.tune, tuned_at=None) == prof
        assert eng.generate(PROMPTS[0], GREEDY) == list(
            jeng.generate(PROMPTS[0], JaxSampling(temperature=0.0, max_new_tokens=8)))
    finally:
        eng.close()
