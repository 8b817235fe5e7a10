"""Tensor-parallel serving of the MoE family and of the embedding cell on
two gloo ranks, against the JAX package on ``serving_mesh(2)``: at
``mixtral-tiny`` the port's engine over a two-rank group (this process the
leader, one follower process started by ``parallel/launch.py``) gives the
greedy tokens of the JAX MoE engine and of the port at one rank (f32 and
int8, legacy and paged, prefix hits), its logits agree with the JAX MoE
forward on the 2-device mesh within 1e-4, and every rank routes every
token to the same experts; at ``bge-tiny`` the two-rank embedding engine's
vectors agree with the JAX engine's within 1e-5, also with a vocabulary
the world does not divide (padded); both cells serve at ``chips=2`` and
bge-base at ``chips=4`` (30522 padded); what stays refused names A13b2;
and a dead follower ends the embedding cell's group, naming the follower.
One rank group serves the file (four ranks for its last case); its
collectives and rendezvous time out after ``GROUP_TIMEOUT_S``, so no case
can hang the suite, and every wait has a deadline.
"""

import dataclasses
import os
import signal
import time

import jax
import numpy as np
import pytest
import torch
from test_torch_checkpoints import _write_mixtral_hf

from kukeon_tpu.models import bert as jb
from kukeon_tpu.models import llama as jl
from kukeon_tpu.models import moe as jm
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
from kukeon_tpu_torch.parallel import launch, serving_mesh
from kukeon_tpu_torch.parallel import sharding as tshd
from kukeon_tpu_torch.parallel.forward import TensorParallelForward
from kukeon_tpu_torch.parallel.sharding import Recipe
from kukeon_tpu_torch.runtime import serving_cell
from kukeon_tpu_torch.runtime.serving_cell import EmbeddingCell, ServingCell
from kukeon_tpu_torch.serving import EmbeddingEngine, SamplingParams, ServingEngine

torch.set_num_threads(2)

GREEDY = SamplingParams(temperature=0.0, max_new_tokens=8)
LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)       # tests/test_torch_llama.py's
EMBED_TOL = dict(rtol=1e-5, atol=1e-5)       # tests/test_torch_embedding.py's
GROUP_TIMEOUT_S = "60"


@pytest.fixture(scope="module")
def mesh2():
    """One two-rank gloo group for the file; closed, and its followers
    joined, at the end."""
    mp = pytest.MonkeyPatch()
    mp.setenv(launch.TIMEOUT_ENV, GROUP_TIMEOUT_S)
    mesh = serving_mesh(2, "cpu")
    yield mesh
    launch.shutdown()
    mp.undo()


def _recipe(tree, path) -> Recipe:
    """A weight recipe every rank runs: ``tree`` (numpy leaves) in an
    ``.npz`` that ``convert.npz_leaves`` reads back leaf by leaf."""
    np.savez(path, **{"/".join(k): np.asarray(v) for k, v in _walk_tree(tree)})
    return Recipe("kukeon_tpu_torch.models.convert:npz_leaves", {"path": str(path)})


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (k,))
    else:
        yield path, tree


@pytest.fixture(scope="module")
def moe_trees(tmp_path_factory):
    """name -> (the JAX tree, the port's CPU tree, a recipe of it), at
    ``mixtral-tiny`` from the JAX init, f32 and int8."""
    jp = jm.init_params(jax.random.key(0), jm.moe_tiny())
    tmp = tmp_path_factory.mktemp("moe")
    out = {}
    for name, tree in (("fp", jp), ("int8", jm.quantize_params(jp))):
        host = jax.tree.map(np.asarray, tree)
        out[name] = (tree, convert.params_from_numpy(host, "cpu"), _recipe(host, tmp / f"{name}.npz"))
    return out


def _bert_tree(cfg, seed: int):
    """The JAX ``bert.init_params`` tree with every bias and norm drawn
    too (the init's are 0 and 1), so a bias added on the wrong side of a
    row-parallel sum shows."""
    jp = jax.tree.map(np.asarray, jb.init_params(jax.random.key(seed), cfg))
    rng = np.random.default_rng(seed)
    for group in (jp["embed"], jp["layers"]):
        for name, leaf in group.items():
            if name.startswith("b") or "norm" in name:
                group[name] = (leaf + 0.1 * rng.standard_normal(leaf.shape)).astype(leaf.dtype)
    return jp


@pytest.fixture(scope="module")
def bert_tree(tmp_path_factory):
    jp = _bert_tree(jb.bge_tiny(), 0)
    return jp, _recipe(jp, tmp_path_factory.mktemp("bert") / "w.npz")


PROMPTS = [np.arange(2, 12, dtype=np.int32),
           np.array([5, 300, 7, 411, 9, 13, 40, 41, 42, 43, 44, 45, 46, 47], np.int32)]
KW = dict(num_slots=2, max_seq_len=128, decode_chunk=4)


def _moe_engine(moe_trees, mesh=None, kind="fp", **kw):
    kw = {**KW, **kw}
    if mesh is None:
        kw["device"] = "cpu"
    return ServingEngine(tm.moe_tiny(), moe_trees[kind][1] if mesh is None
                         else moe_trees[kind][2], mesh=mesh, forward_fn=tm.forward, **kw)


def _run(eng, reqs):
    while not all(r.done.is_set() for r in reqs):
        eng.step()
    assert all(r.error is None for r in reqs), [r.error for r in reqs]
    return [r.generated for r in reqs]


# --- specs and shards (no group) ---------------------------------------------------


@pytest.mark.parametrize("fsdp", [False, True])
def test_moe_and_bert_spec_trees_equal_reference(fsdp):
    ours, ref = tshd.moe_param_specs(fsdp), jshd.moe_param_specs(fsdp)
    assert dict(_leaves(ours)).keys() == {p for p, _ in _leaves_p(ref)}
    for path, spec in _leaves_p(ref):
        assert dict(_leaves(ours))[path] == tuple(spec), path
    ours, ref = tshd.bert_param_specs(fsdp), jshd.bert_param_specs(fsdp)
    for path, spec in _leaves_p(ref):
        assert dict(_leaves(ours))[path] == tuple(spec), path
    assert len(list(_leaves(ours))) == len(list(_leaves_p(ref)))
    tree = {"embed": 0, "layers": 0, "final_norm": 0}
    assert set(tshd.moe_specs_for_params(tree)) == set(jshd.moe_specs_for_params(tree))


def _leaves_p(tree, path=()):
    """A PartitionSpec tree's (path, spec) leaves."""
    from jax.sharding import PartitionSpec as P

    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves_p(v, path + (k,))
    else:
        assert isinstance(tree, P)
        yield path, tree


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.view({torch.float32: torch.int32, torch.bfloat16: torch.int16}.get(t.dtype, t.dtype))


@pytest.mark.parametrize("model,dtype", [("mixtral", "f32"), ("mixtral", "int8"),
                                         ("bge", "f32"), ("bge_odd_vocab", "f32")])
@pytest.mark.parametrize("world", [2, 4])
def test_shards_concatenate_to_each_leaf(model, dtype, world):
    """Every leaf's ``world`` shards, concatenated on the axis its spec
    puts on ``tensor`` (and cut to the leaf's length: an odd vocabulary's
    last block is zero-padded), give the leaf bit for bit; the specs are
    the reference's (``moe_specs_for_params``, ``bert_param_specs``, the
    4-D scale spec cutting ``w_gate``'s scales on I and leaving
    ``w_down``'s whole); a leaf with no ``tensor`` axis is the same
    object on every rank."""
    if model == "mixtral":
        cfg = jm.moe_tiny()
        jp = jm.init_params(jax.random.key(0), cfg)
        jp = jm.quantize_params(jp) if dtype == "int8" else jp
        ref_specs = jshd.moe_specs_for_params(jp)
    else:
        cfg = jb.bge_tiny()
        if model == "bge_odd_vocab":
            cfg = dataclasses.replace(cfg, vocab_size=509)
        jp = jb.init_params(jax.random.key(0), cfg)
        ref_specs = jshd.bert_param_specs()
    full = convert.params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    specs = dict(_leaves(tshd.param_specs(full)))
    if model == "mixtral":
        ref = dict(_leaves_p(ref_specs))
        for path, spec in specs.items():
            key = path[:-1] if path[-1] in ("q", "s") else path
            if path[-1] == "s":
                leaf = dict(_leaves(full))
                assert spec == tshd._quant_scale_spec(ref[key], leaf[key + ("q",)],
                                                      leaf[path]), path
            else:
                assert spec == tuple(ref[key]), path
        if dtype == "int8":
            assert specs[("layers", "w_gate", "s")] == (None, "expert", "tensor")
            assert specs[("layers", "w_down", "s")] == (None, "expert", None)
    shards = [dict(_leaves(tshd.shard_tree(full, r, world, head_dim=cfg.head_dim)))
              for r in range(world)]
    for path, leaf in _leaves(full):
        spec, parts = specs[path], [s[path] for s in shards]
        if "tensor" in spec:
            axis = spec.index("tensor")
            joined = torch.cat(parts, axis).narrow(axis, 0, leaf.shape[axis])
            assert all(p.is_contiguous() and p.shape == parts[0].shape for p in parts), path
        else:
            assert all(p is leaf for p in parts), path
            joined = parts[0]
        assert torch.equal(_bits(joined), _bits(leaf)), path
    if model == "bge_odd_vocab":
        word = [s[("embed", "word")] for s in shards]
        assert word[0].shape[0] == -(-509 // world)
        assert not word[-1][509 - (world - 1) * word[0].shape[0]:].any()


# --- the MoE family over two ranks ---------------------------------------------------


@pytest.fixture(scope="module")
def jax_moe_tokens(moe_trees):
    """The reference: the JAX MoE engine on its 2-device serving mesh, per
    weight kind, greedy on PROMPTS."""
    out = {}
    for kind in ("fp", "int8"):
        jp = moe_trees[kind][0]
        eng = JaxEngine(jm.moe_tiny(), jp, jax_serving_mesh(2), forward_fn=jm.forward,
                        param_specs=moe_specs_for_params(jp), **KW)
        sp = JaxSampling(temperature=0.0, max_new_tokens=8)
        out[kind] = [list(eng.generate(p, sp)) for p in PROMPTS]
    return out


@pytest.mark.parametrize("kind", ["fp", "int8"])
@pytest.mark.parametrize("paged", [False, True], ids=["legacy", "paged"])
def test_moe_greedy_matches_jax_mesh2_and_one_rank(mesh2, moe_trees, jax_moe_tokens, kind,
                                                   paged):
    """The tentpole: mixtral-tiny at two ranks gives the JAX MoE engine's
    tokens on serving_mesh(2) and the port's at one rank, serially and as
    concurrent requests; each rank holds one of the two kv heads and half
    of every expert's intermediate columns."""
    kw = {"kv_page_tokens": 16, "kv_pool_pages": 16} if paged else {}
    eng2 = _moe_engine(moe_trees, mesh2, kind, **kw)
    cfg = tm.moe_tiny()
    w_gate = eng2.params["layers"]["w_gate"]
    w_gate = w_gate["q"] if isinstance(w_gate, dict) else w_gate
    assert eng2.kv_sharded and eng2.state.cache.k.shape[3] == cfg.num_kv_heads // 2
    assert w_gate.shape == (cfg.num_layers, cfg.num_experts, cfg.hidden_size,
                            cfg.intermediate_size // 2)
    got2 = [eng2.generate(p, GREEDY) for p in PROMPTS]
    eng1 = _moe_engine(moe_trees, None, kind, **kw)
    got1 = [eng1.generate(p, GREEDY) for p in PROMPTS]
    assert got2 == got1 == jax_moe_tokens[kind], (got2, got1, jax_moe_tokens[kind])
    assert _run(eng2, [eng2.submit(p, GREEDY) for p in PROMPTS]) == jax_moe_tokens[kind]
    if paged:
        assert eng2._pool.in_use == 0
    eng2.close()


@pytest.mark.parametrize("kind", ["fp", "int8"])
def test_moe_prefix_hits_match_one_rank(mesh2, moe_trees, kind):
    """A growing session on the prefix cache at two ranks: each rank's
    stored blocks, hits loading them; tokens and hit counts equal one
    rank's."""
    base = np.arange(3, 40, dtype=np.int32)
    prompts = [base[:n] for n in (10, 20, 37)] + [PROMPTS[0]]
    out = []
    for mesh in (mesh2, None):
        eng = _moe_engine(moe_trees, mesh, kind, prefix_cache_size=1)
        toks = [eng.generate(p, GREEDY) if i == 3 else
                _run(eng, [eng.submit(p, GREEDY, prefix_id="s")])[0]
                for i, p in enumerate(prompts)]
        out.append((toks, eng.prefix_hits))
        if mesh is not None:
            eng.close()
    assert out[0] == out[1] and out[0][1] == 2


@pytest.mark.parametrize("case", ["fp", "int8", "untied_int8", "kv_replicated"])
def test_moe_logits_match_jax_forward_on_mesh2(mesh2, moe_trees, case, tmp_path):
    """The two-rank MoE forward (a prefill of 8, then two decode steps
    against the cache) against the JAX MoE forward with its weights sharded
    by ``moe_specs_for_params`` on serving_mesh(2): logits within 1e-4.
    ``untied_int8``: Mixtral's untied int8 head, column-sharded."""
    import jax.numpy as jnp

    cfg_j, cfg_t = jm.moe_tiny(), tm.moe_tiny()
    jp, _, recipe = moe_trees["int8" if case == "int8" else "fp"]
    if case == "untied_int8":
        cfg_j = dataclasses.replace(cfg_j, tie_embeddings=False)
        cfg_t = dataclasses.replace(cfg_t, tie_embeddings=False)
        jp = jm.quantize_params(jm.init_params(jax.random.key(1), cfg_j))
        recipe = _recipe(jax.tree.map(np.asarray, jp), tmp_path / "w.npz")
    jmesh = jax_serving_mesh(2)
    jps = jshd.shard_params(jp, jmesh, specs=jshd.moe_specs_for_params(jp))
    fwd = jax.jit(lambda p, t, pos, c: jm.forward(p, cfg_j, t, pos, c))
    jcache = jl.KVCache.create(cfg_j, 1, 32)
    tfwd = TensorParallelForward(mesh2, cfg_t, recipe, batch=1, max_len=32,
                                 kv_shard=case != "kv_replicated")
    toks = np.array([[5, 300, 7, 411, 9, 13, 2, 8]], np.int32)
    steps = [(toks, np.arange(8, dtype=np.int32)[None])]
    steps += [(np.array([[t]], np.int32), np.array([[8 + i]], np.int32))
              for i, t in enumerate((17, 250))]
    for t, pos in steps:
        want, jcache = fwd(jps, jnp.asarray(t), jnp.asarray(pos), jcache)
        got = tfwd(torch.from_numpy(t.astype(np.int64)), torch.from_numpy(pos.astype(np.int64)))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **LOGIT_TOL)
    tfwd.close()


def test_every_rank_routes_every_token_alike(mesh2, moe_trees):
    """The router runs on the replicated activations: the follower's
    expert choices equal the leader's in every layer, at a prefill and at
    a decode step, and equal the one-device forward's."""
    cfg = tm.moe_tiny()
    tfwd = TensorParallelForward(mesh2, cfg, moe_trees["fp"][2], batch=2, max_len=32)
    cache = tl.KVCache.create(cfg, 2, 32)
    rng = np.random.default_rng(5)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 9)))
    steps = [(toks, torch.arange(9)[None].expand(2, -1))]
    steps.append((torch.tensor([[7], [300]]), torch.tensor([[9], [9]])))
    for t, pos in steps:
        routes = tfwd.routes(t, pos)
        assert routes.shape == (2, cfg.num_layers, t.numel(), cfg.experts_per_token)
        assert torch.equal(routes[0], routes[1])
        with tm.record_routes() as log:
            tm.forward(moe_trees["fp"][1], cfg, t, pos, cache)
        assert torch.equal(routes[0], torch.stack(log))
    tfwd.close()


@pytest.mark.parametrize("paged,uploads", [(False, (4, 4)), (True, (7, 6))])
def test_moe_host_sync_budget_at_two_ranks(mesh2, moe_trees, paged, uploads):
    """The one-rank budget of the MoE engine, unchanged at two ranks: one
    blocking fetch a chunk, per request the prompt upload and the three
    sampling arrays (paged: the block table too, as often as the slot's
    pages change: 3 and 2 times for these prompts), never one per rank;
    the same counts as the one-rank engine on the same traffic."""
    kw = {"kv_page_tokens": 16, "kv_pool_pages": 16} if paged else {}
    engines = [_moe_engine(moe_trees, mesh, **kw) for mesh in (mesh2, None)]
    for prompt, want in zip(PROMPTS, uploads):
        deltas = []
        for eng in engines:
            base = dict(eng.sync_stats)
            req = eng.submit(prompt, SamplingParams(max_new_tokens=24))
            while not req.done.is_set():
                eng.step()
            d = {k: eng.sync_stats[k] - base[k] for k in ("chunks", "fetches", "uploads")}
            assert len(req.generated) == 24 and d["chunks"] >= 5
            assert d["chunks"] - 1 <= d["fetches"] <= d["chunks"] + 1
            assert d["uploads"] == want, d
            deltas.append(d)
        assert deltas[0] == deltas[1]
    engines[0].close()


# --- the embedding cell's engine over two ranks ---------------------------------------


def test_bge_vectors_match_the_jax_engine_on_mesh2(mesh2, bert_tree):
    """bge-tiny (its biases and norms drawn, so their placement around the
    sums shows) at two ranks: the vectors of a ragged burst over two grids
    and two length buckets within 1e-5 of the JAX EmbeddingEngine on
    serving_mesh(2), and of the port at one rank."""
    jp, recipe = bert_tree
    rng = np.random.default_rng(3)
    prompts = [rng.integers(1, 512, n).astype(np.int32) for n in (3, 17, 40, 9, 1, 33)]
    want = JaxEmbeddingEngine(jb.bge_tiny(), jp, jax_serving_mesh(2),
                              batch_size=4).embed_batch(prompts)
    eng2 = EmbeddingEngine(tb.bge_tiny(), recipe, batch_size=4, mesh=mesh2)
    assert eng2.params["layers"]["wq"].shape[-1] == tb.bge_tiny().hidden_size // 2
    assert eng2.params["layers"]["bo"].shape[-1] == tb.bge_tiny().hidden_size
    got = eng2.embed_batch(prompts)
    one = EmbeddingEngine(tb.bge_tiny(), convert.params_from_numpy(jp, "cpu"), batch_size=4,
                          device="cpu").embed_batch(prompts)
    np.testing.assert_allclose(got, np.asarray(want), **EMBED_TOL)
    np.testing.assert_allclose(got, one, **EMBED_TOL)
    eng2.close()


def test_an_odd_vocabulary_is_padded_and_matches_jax(mesh2, tmp_path):
    """A vocabulary of 509 at two ranks: each rank's word block is 255
    rows, the leader's last row real and the follower's last one zero
    padding, never read; the vectors, for ids at both ends of both
    blocks, within 1e-5 of the JAX forward (on one device: 509 does not
    split over its mesh)."""
    import jax.numpy as jnp

    cfg_j = dataclasses.replace(jb.bge_tiny(), vocab_size=509)
    cfg_t = dataclasses.replace(tb.bge_tiny(), vocab_size=509)
    jp = _bert_tree(cfg_j, 7)
    eng = EmbeddingEngine(cfg_t, _recipe(jp, tmp_path / "w.npz"), batch_size=4, mesh=mesh2)
    assert eng.params["embed"]["word"].shape[0] == 255
    prompts = [np.array([0, 254, 255, 508, 3], np.int32), np.array([508, 507, 1], np.int32)]
    got = eng.embed_batch(prompts)
    tokens = np.zeros((4, 16), np.int32)
    mask = np.zeros((4, 16), np.int32)
    for row, p in enumerate(prompts):
        tokens[row, :p.size], mask[row, :p.size] = p, 1
    mask[2:, 0] = 1
    want = np.asarray(jb.embed(jp, cfg_j, jnp.asarray(tokens), jnp.asarray(mask)))[:2]
    np.testing.assert_allclose(got, want, **EMBED_TOL)
    eng.close()


# --- the cells at chips=2 ------------------------------------------------------------


def test_mixtral_cell_chips2_serves_one_devices_tokens(mesh2):
    """``ServingCell("mixtral-tiny", chips=2)``, f32 and int8: every rank
    draws the one-device cell's leaves from the seed and keeps its slice;
    ``/v1/stats`` mesh, and the one-device cell's answers; ``--kv-cache-int8``
    still refused."""
    body = {"promptTokens": [int(t) for t in PROMPTS[1]], "maxNewTokens": 6}
    for dtype in (None, "int8"):
        out = []
        for chips in (2, None):
            cell = ServingCell("mixtral-tiny", num_slots=2, max_seq_len=96, device="cpu",
                               chips=chips, dtype=dtype, decode_chunk=4)
            want_mesh = ({"chips": 2, "shape": {"tensor": 2}, "kvSharded": True} if chips
                         else {"chips": 1, "shape": {}, "kvSharded": True})
            assert cell.stats()["mesh"] == want_mesh
            out.append(cell.generate(body)["tokens"])
            cell.engine.close()
        assert out[0] == out[1] and len(out[0]) == 6, (dtype, out)
    with pytest.raises(SystemExit, match="kv-cache-int8"):
        ServingCell("mixtral-tiny", num_slots=2, max_seq_len=96, device="cpu", chips=2,
                    kv_cache_int8=True)


def test_mixtral_cell_chips2_from_an_hf_checkpoint(mesh2, tmp_path):
    """An HF Mixtral directory at two ranks: each rank reads only its
    blocks (``hf_convert.moe_rank_leaves``), int8 quantized on the rank's
    device an expert matrix at a time; the one-device cell's tokens from
    the same directory, f32 and int8."""
    cfg = jm.moe_tiny()
    path = _write_mixtral_hf(str(tmp_path / "hf"), jm.init_params(jax.random.key(2), cfg),
                             cfg, np.float32)
    body = {"promptTokens": [int(t) for t in PROMPTS[0]], "maxNewTokens": 6}
    for dtype in (None, "int8"):
        out = []
        for chips in (2, None):
            cell = ServingCell("mixtral-tiny", num_slots=2, max_seq_len=96, device="cpu",
                               chips=chips, dtype=dtype, checkpoint=path)
            assert cell.engine.world == (chips or 1)
            out.append(cell.generate(body)["tokens"])
            cell.engine.close()
        assert out[0] == out[1], (dtype, out)


def test_embedding_cell_chips2_stats_metrics_and_vectors(mesh2):
    """``EmbeddingCell("bge-tiny", chips=2)``: /v1/stats mesh, the
    followers' memory on /metrics beside the leader's (none on the CPU),
    and the one-device cell's vectors."""
    from kukeon_tpu_torch.obs import render

    body = {"inputTokens": [[1, 2, 3], list(range(5, 40))]}
    cell = EmbeddingCell("bge-tiny", batch_size=4, device="cpu", chips=2)
    assert cell.stats()["mesh"] == {"chips": 2, "shape": {"tensor": 2}}
    got = cell.embed(body)
    assert "kukeon_hbm_bytes_in_use" in render(cell.registry)
    cell.engine.close()
    want = EmbeddingCell("bge-tiny", batch_size=4, device="cpu").embed(body)
    np.testing.assert_allclose(np.array(got["embeddings"]), np.array(want["embeddings"]),
                               **EMBED_TOL)


# --- what stays refused ----------------------------------------------------------------


def test_a13b2_refusals(mesh2, moe_trees, monkeypatch, tmp_path):
    """A tensor size the reference's shardings cannot cut exits before any
    weight or rank, saying so (bge-base's hidden width 768 at 5,
    mixtral-tiny's attention width 64 at 3; uneven heads alone are served
    now); a streamed boot on a mesh, no longer refused, boots (a
    ``"stream"`` recipe of a kukeon int8 checkpoint: each rank streams its
    blocks) and gives the one-device engine's tokens; a two-rank Mixtral
    cell's layer profile, once refused, answers as the reference's does on
    a MoE tree: its layers fail (a dense block's shapes), embed and head
    are profiled, and nothing is persisted."""
    def no_weights(*a, **k):
        raise AssertionError("weights made before the grant was checked")

    for name in ("rank_leaves", "embedding_leaves", "_drawn_params"):
        monkeypatch.setattr(serving_cell, name, no_weights)
    before = launch.current()
    with pytest.raises(SystemExit, match="hidden width 768 is not a multiple of 5.*"
                                         "reference's shardings cannot cut it"):
        EmbeddingCell("bge-base", device="cpu", chips=5)
    with pytest.raises(SystemExit, match="num_heads\\*head_dim 64 is not a multiple of 3"):
        ServingCell("mixtral-tiny", num_slots=2, max_seq_len=96, device="cpu", chips=3)
    assert launch.current() is before
    monkeypatch.undo()

    from kukeon_tpu_torch.models import checkpoints

    cfg = tl.llama_tiny()
    checkpoints.save_quantized(str(tmp_path / "q"), convert.params_from_numpy(
        tl.init_quantized_params_host(cfg, seed=1), "cpu"), cfg)
    recipe = Recipe("kukeon_tpu_torch.runtime.serving_cell:rank_stream", {
        "model": "tiny", "dtype": None, "checkpoint": str(tmp_path / "q"),
        "max_seq_len": None}, reads="stream")
    eng = ServingEngine(cfg, recipe, mesh=mesh2, **KW)
    one = ServingEngine(cfg, checkpoints.stream_quantized(str(tmp_path / "q"), cfg.dtype),
                        device="cpu", **KW)
    assert eng._ckpt_stream is not None
    assert eng.generate(PROMPTS[0], GREEDY) == one.generate(PROMPTS[0], GREEDY)
    # The leader's stream counts the full leaves' bytes, the one-device count.
    assert eng._ckpt_stream.stat_snapshot()["bytes"] == one._ckpt_stream.stat_snapshot()["bytes"]
    eng.close()
    cell = ServingCell("mixtral-tiny", num_slots=2, max_seq_len=96, device="cpu", chips=2)
    monkeypatch.setenv("KUKEON_LAYER_PROFILE_PATH", str(tmp_path / "layers.json"))
    prof = cell.profile_layers(prefill_len=8, decode_batch=2)
    assert prof["key"] == "mixtral-tiny|cpu|2" and "path" not in prof
    assert [("error" in c) for c in prof["components"]] == [False, True, True, False]
    assert prof["errors"] == cell.cfg.num_layers == 2
    assert cell.generate({"promptTokens": [1, 2, 3], "maxNewTokens": 3})["numTokens"] == 3
    cell.engine.close()


# --- a rank's death ----------------------------------------------------------------------


def _gone(pid: int, within: float) -> bool:
    deadline = time.monotonic() + within
    while time.monotonic() < deadline:
        try:
            with open(f"/proc/{pid}/stat") as f:
                if f.read().split()[2] == "Z":
                    return True
        except FileNotFoundError:
            return True
        time.sleep(0.05)
    return False


def test_a_dead_follower_fails_the_embedding_burst_and_ends_the_group(mesh2):
    """Last of the two-rank cases (it ends the file's group): the follower
    killed under a two-rank embedding cell, the next burst fails instead of
    pooling the leader's half, the group names rank 1 and calls the cell's
    failure hook (under ``main`` the cell exits 1), and a later burst
    fails at once."""
    cell = EmbeddingCell("bge-tiny", batch_size=4, device="cpu", chips=2)
    heard = []
    mesh2.group.on_failure = heard.append
    assert len(cell.embed({"inputTokens": [[1, 2, 3]]})["embeddings"]) == 1
    os.kill(mesh2.group.pids[0], signal.SIGKILL)
    assert _gone(mesh2.group.pids[0], 10.0)
    with pytest.raises(Exception):
        cell.embed({"inputTokens": [[4, 5, 6, 7]]})
    deadline = time.monotonic() + 10
    while not heard and time.monotonic() < deadline:
        time.sleep(0.05)
    assert mesh2.group.failed and "rank 1" in mesh2.group.failed, mesh2.group.failed
    assert heard == [mesh2.group.failed]
    with pytest.raises(launch.RankFailure, match="rank 1"):
        cell.embed({"inputTokens": [[4, 5]]})


def test_bge_base_at_chips4_pads_its_vocabulary():
    """bge-base (30522 words, 4 does not divide them) at four ranks, f32:
    each rank's word block is 7631 rows, the last rank's 3 of them zero
    padding; the vectors equal the one-device cell's within 1e-5. Last in
    the file: its group of four replaces the closed group of two."""
    launch.shutdown()
    mp = pytest.MonkeyPatch()
    mp.setenv(launch.TIMEOUT_ENV, GROUP_TIMEOUT_S)
    try:
        body = {"inputTokens": [[101, 7592, 30521, 102], [0, 15, 30000, 7630, 7631]]}
        cell = EmbeddingCell("bge-base", batch_size=2, device="cpu", chips=4, dtype="float32")
        assert cell.stats()["mesh"] == {"chips": 4, "shape": {"tensor": 4}}
        assert cell.engine.params["embed"]["word"].shape[0] == 7631
        got = cell.embed(body)
        cell.engine.close()
        launch.shutdown()
        want = EmbeddingCell("bge-base", batch_size=2, device="cpu", dtype="float32").embed(body)
        np.testing.assert_allclose(np.array(got["embeddings"]), np.array(want["embeddings"]),
                                   **EMBED_TOL)
    finally:
        launch.shutdown()
        mp.undo()
