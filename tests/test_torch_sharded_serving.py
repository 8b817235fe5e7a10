"""Tensor-parallel serving of the port on two gloo ranks, the counterpart
of ``tests/test_sharded_serving.py``: at ``llama_tiny`` the port's engine
over a two-rank group (this process the leader, one follower process
started by ``parallel/launch.py``) gives the greedy tokens of the JAX
engine on ``serving_mesh(2)`` and of the port at one rank, on the legacy
and paged layouts, with the KV cache sharded and replicated, across a KV
handoff; its logits agree with the JAX forward on the 2-device mesh
within the tolerance of ``tests/test_torch_llama.py``; it keeps the
single-device compile and host-sync budgets; and the cell honours the
runner's ``--chips`` grant, refuses what is not ported naming A13b2, and
ends when a rank dies. One rank group serves the whole file; its
collectives and rendezvous time out after ``GROUP_TIMEOUT_S``, so no case
can hang the suite, and every subprocess wait has a deadline.
"""

import dataclasses
import json
import os
import signal
import subprocess
import sys
import select
import time
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kukeon_tpu.models import llama as jl
from kukeon_tpu.parallel import serving_mesh as jax_serving_mesh
from kukeon_tpu.parallel import sharding as jshd
from kukeon_tpu.serving import ServingEngine as JaxEngine
from kukeon_tpu.serving import SamplingParams as JaxSampling
from kukeon_tpu_torch import faults
from kukeon_tpu_torch.models import convert
from kukeon_tpu_torch.models import llama as tl
from kukeon_tpu_torch.models.checkpoints import _walk_tree
from kukeon_tpu_torch.obs import expo
from kukeon_tpu_torch.parallel import launch, serving_mesh
from kukeon_tpu_torch.parallel.forward import TensorParallelForward
from kukeon_tpu_torch.parallel.sharding import Recipe
from kukeon_tpu_torch.runtime import serving_cell
from kukeon_tpu_torch.runtime.serving_cell import ServingCell
from kukeon_tpu_torch.serving import SamplingParams, ServingEngine

torch.set_num_threads(2)

PROMPTS = [np.arange(1, 9, dtype=np.int32), np.array([5, 300, 7, 411, 9, 13, 40, 41, 42, 43,
                                                      44, 45, 46, 47], np.int32)]
GREEDY = SamplingParams(temperature=0.0, max_new_tokens=8)
RTOL = ATOL = 1e-4          # tests/test_torch_llama.py's tolerance
GROUP_TIMEOUT_S = "60"
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def mesh2():
    """One two-rank gloo group for the file (its follower is a process of
    its own); closed, and its follower joined, at the end."""
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


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    """name -> (the JAX tree, the port's CPU tree, a recipe of it)."""
    cfg = jl.llama_tiny()
    jp = jl.init_params(jax.random.key(0), cfg)
    out = {}
    tmp = tmp_path_factory.mktemp("weights")
    for name, tree in (("fp", jp), ("int8", jl.quantize_params(jp))):
        host = jax.tree.map(np.asarray, tree)
        out[name] = (tree, convert.params_from_numpy(host, "cpu"),
                     _recipe(host, tmp / f"{name}.npz"))
    return out


@pytest.fixture(scope="module")
def jax_engine(trees):
    """The reference: the JAX engine on its 2-device serving mesh."""
    return JaxEngine(jl.llama_tiny(), trees["fp"][0], jax_serving_mesh(2), num_slots=2,
                     max_seq_len=128)


@pytest.fixture(scope="module")
def jax_tokens(jax_engine):
    sp = JaxSampling(temperature=0.0, max_new_tokens=8)
    return [list(jax_engine.generate(p, sp)) for p in PROMPTS]


def _engine(trees, mesh=None, kind="fp", **kw):
    kw.setdefault("num_slots", 2)
    kw.setdefault("max_seq_len", 128)
    if mesh is None:
        kw["device"] = "cpu"
    return ServingEngine(tl.llama_tiny(), trees[kind][1] if mesh is None else trees[kind][2],
                         mesh=mesh, **kw)


def _gauge(eng, name: str) -> list[float]:
    text = expo.render(eng.registry)
    return [float(line.split()[-1]) for line in text.splitlines()
            if line.startswith(name + " ") or line.startswith(name + "{")]


def _run(eng, reqs):
    while not all(r.done.is_set() for r in reqs):
        eng.step()
    assert all(r.error is None for r in reqs), [r.error for r in reqs]
    return [r.generated for r in reqs]


# --- greedy parity -------------------------------------------------------------


def test_greedy_legacy_matches_jax_mesh2_and_one_rank(mesh2, trees, jax_tokens):
    """The tentpole: two ranks on the legacy layout give the JAX engine's
    tokens on serving_mesh(2) and the port's at one rank, serially and as
    concurrent requests; each rank holds one of tiny's two kv heads, and
    the mesh gauge reads 2."""
    eng2 = _engine(trees, mesh2)
    assert eng2.kv_sharded and eng2.state.cache.k.shape[3] == 1
    assert eng2.params["layers"]["wq"].shape[-1] == tl.llama_tiny().q_dim // 2
    assert _gauge(eng2, "kukeon_engine_mesh_chips") == [2.0]
    got2 = [eng2.generate(p, GREEDY) for p in PROMPTS]
    eng1 = _engine(trees)
    got1 = [eng1.generate(p, GREEDY) for p in PROMPTS]
    assert got2 == got1 == jax_tokens, (got2, got1, jax_tokens)
    assert _run(eng2, [eng2.submit(p, GREEDY) for p in PROMPTS]) == jax_tokens
    eng2.close()


def test_greedy_paged_matches(mesh2, trees, jax_tokens):
    """The paged layout at two ranks: the pool pages hold each rank's kv
    heads, the allocator lives on the leader alone, tokens equal, the pool
    drains."""
    eng2 = _engine(trees, mesh2, kv_page_tokens=16, kv_pool_pages=16)
    assert eng2.state.cache.k.shape[3] == 1
    assert _run(eng2, [eng2.submit(p, GREEDY) for p in PROMPTS]) == jax_tokens
    assert [eng2.generate(p, GREEDY) for p in PROMPTS] == jax_tokens
    assert eng2._pool.in_use == 0
    eng2.close()


def test_kv_shard_off_replicates_and_matches(mesh2, trees, jax_tokens):
    """kv_shard=False (the reference's replicated cache): every rank holds
    both kv heads and attends its q heads to their group; tokens equal,
    on both layouts."""
    for kw in ({}, {"kv_page_tokens": 16, "kv_pool_pages": 16}):
        eng = _engine(trees, mesh2, kv_shard=False, **kw)
        assert not eng.kv_sharded and eng.state.cache.k.shape[3] == 2
        assert eng.params["layers"]["wk"].shape == trees["fp"][1]["layers"]["wk"].shape
        assert [eng.generate(p, GREEDY) for p in PROMPTS] == jax_tokens, kw
        eng.close()


def test_int8_weights_and_kv_match_one_rank(mesh2, trees):
    """int8 weights (the scales sharded as _quant_scale_spec says) with an
    int8 KV cache, and stochastic sampling (every rank draws the same
    noise from the same generator state): two ranks give the one-rank
    tokens."""
    stoch = SamplingParams(temperature=0.9, top_k=40, top_p=0.9, max_new_tokens=8)
    for sp in (GREEDY, stoch):
        eng2 = _engine(trees, mesh2, kind="int8", kv_cache_int8=True, seed=3)
        eng1 = _engine(trees, kind="int8", kv_cache_int8=True, seed=3)
        assert [eng2.generate(p, sp) for p in PROMPTS] == \
            [eng1.generate(p, sp) for p in PROMPTS], sp
        eng2.close()


def test_prefix_cache_matches_one_rank(mesh2, trees):
    """A growing agent session on the legacy prefix cache: the stored
    blocks live on every rank, a hit loads each rank's own, the LRU drop
    reaches the follower; tokens and hit counts equal one rank's."""
    base = np.arange(3, 40, dtype=np.int32)
    prompts = [base[:n] for n in (10, 20, 37)] + [PROMPTS[0]]
    out = []
    for mesh in (mesh2, None):
        eng = _engine(trees, mesh, prefix_cache_size=1)
        toks = [eng.generate(p, GREEDY) if i == 3 else
                _run(eng, [eng.submit(p, GREEDY, prefix_id="s")])[0]
                for i, p in enumerate(prompts)]
        out.append((toks, eng.prefix_hits, list(eng._prefix_cache)))
        if mesh is not None:
            eng.close()
    assert out[0] == out[1]
    assert out[0][1] == 2


# --- logits --------------------------------------------------------------------


@pytest.mark.parametrize("case", ["fp", "int8", "untied", "kv_replicated", "vocab_pad_tied",
                                  "vocab_pad_untied"])
def test_logits_match_jax_forward_on_mesh2(mesh2, trees, case, tmp_path):
    """The two-rank forward (a prefill of 8, then two decode steps against
    the cache) against the JAX forward with its weights sharded on
    serving_mesh(2): logits within rtol=atol=1e-4. ``vocab_pad``: an int8
    model of 640 tokens, whose 320-entry head shards are padded to 384 for
    the kernel's tiles (pad_vocab) and cut back in the logits."""
    cfg_j, cfg_t = jl.llama_tiny(), tl.llama_tiny()
    kind = "int8" if case == "int8" else "fp"
    jp, _, recipe = trees[kind]
    if case != "fp" and case not in ("int8", "kv_replicated"):
        changes = {"tie_embeddings": case != "untied" and case != "vocab_pad_untied"}
        if case.startswith("vocab_pad"):
            changes["vocab_size"] = 640
        cfg_j = dataclasses.replace(cfg_j, **changes)
        cfg_t = dataclasses.replace(cfg_t, **changes)
        jp = jl.init_params(jax.random.key(1), cfg_j)
        if case.startswith("vocab_pad"):
            jp = jl.quantize_params(jp)
        recipe = _recipe(jax.tree.map(np.asarray, jp), tmp_path / "w.npz")
    jmesh = jax_serving_mesh(2)
    jps = jshd.shard_params(jp, jmesh)
    fwd = jax.jit(lambda p, t, pos, c: jl.forward(p, cfg_j, t, pos, c))
    jcache = jl.KVCache.create(cfg_j, 1, 32)
    tfwd = TensorParallelForward(mesh2, cfg_t, recipe, batch=1, max_len=32,
                                 kv_shard=case != "kv_replicated")
    if case.startswith("vocab_pad"):
        head = tfwd.params["embed" if cfg_t.tie_embeddings else "lm_head"]["q"]
        assert head.shape[0 if cfg_t.tie_embeddings else 1] == 384
    toks = np.array([[5, 300, 7, 411, 9, 13, 2, 8]], np.int32)
    steps = [(toks, np.arange(8, dtype=np.int32)[None])]
    steps += [(np.array([[t]], np.int32), np.array([[8 + i]], np.int32))
              for i, t in enumerate((17, 250))]
    for t, pos in steps:
        want, jcache = fwd(jps, jnp.asarray(t), jnp.asarray(pos), jcache)
        got = tfwd(torch.from_numpy(t.astype(np.int64)), torch.from_numpy(pos.astype(np.int64)))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)
    tfwd.close()


# --- the KV handoff ------------------------------------------------------------


def test_handoff_export_at_two_ranks_imports_anywhere(mesh2, trees, jax_engine):
    """A two-rank paged export gathers the kv heads to the leader in the
    wire format of one device (full heads, host tensors); the port at one
    rank, the JAX engine on serving_mesh(2) and the port at two ranks
    (legacy) each seat it and continue with the one-rank tokens."""
    prompt = np.arange(1, 24, dtype=np.int32)
    ref = _engine(trees, kv_page_tokens=16, kv_pool_pages=16).generate(prompt, GREEDY)
    exporter = _engine(trees, mesh2, kv_page_tokens=16, kv_pool_pages=16)
    r = exporter.submit(prompt, GREEDY, export=True)
    p = _run(exporter, [r]) and r.export_payload
    assert p["token"] == ref[0] and p["length"] == prompt.size
    assert tuple(p["k"].shape) == (2, 1, prompt.size, 2, 32)
    assert exporter._pool.in_use == 0
    one = _engine(trees, kv_page_tokens=16, kv_pool_pages=16)
    r1 = one.submit(prompt, GREEDY, export=True)
    p1 = _run(one, [r1]) and r1.export_payload
    for name in ("k", "v"):
        np.testing.assert_allclose(p[name].numpy(), p1[name].numpy(), rtol=1e-5, atol=1e-5)
    imp = {"token": p["token"], "length": p["length"], "k": p["k"], "v": p["v"]}

    one_rank = _engine(trees)
    assert _run(one_rank, [one_rank.submit(prompt, GREEDY, kv_import=imp)]) == [ref]
    two = _engine(trees, mesh2)
    assert _run(two, [two.submit(prompt, GREEDY, kv_import=imp)]) == [ref]
    jr = jax_engine.submit(prompt, JaxSampling(temperature=0.0, max_new_tokens=8), kv_import={
        "token": p["token"], "length": p["length"], "k": p["k"].numpy(), "v": p["v"].numpy()})
    while not jr.done.is_set():
        jax_engine.step()
    assert jr.error is None and list(jr.generated) == ref
    exporter.close()
    two.close()


# --- compile stability and the host-sync budget --------------------------------


def _churn(eng):
    """test_sharded_serving.py's slot churn: occupancy 1 -> 2 -> 1 -> 2 -> 0."""
    p = PROMPTS[0]
    r1 = eng.submit(p, SamplingParams(max_new_tokens=12))
    eng.step()
    r2 = eng.submit(p[:4], SamplingParams(max_new_tokens=3))
    while not r2.done.is_set():
        eng.step()
    r3 = eng.submit(p, SamplingParams(max_new_tokens=2))
    while not (r1.done.is_set() and r3.done.is_set()):
        eng.step()


@pytest.mark.parametrize("paged", [False, True])
def test_programs_flat_across_churn(mesh2, trees, paged):
    """Slot (and page) churn after warmup builds no program on the leader:
    its followers build what it builds, when it builds it."""
    kw = {"kv_page_tokens": 16, "kv_pool_pages": 12} if paged else {}
    eng = _engine(trees, mesh2, max_seq_len=96, decode_chunk=4, **kw)
    eng.precompile((8,))
    eng.warmup(8)
    base = (eng.compiles.count("decode"), eng.program_stats["captures"],
            eng.program_stats["prefill"]["captures"])
    assert base[0] >= 1
    _churn(eng)
    assert (eng.compiles.count("decode"), eng.program_stats["captures"],
            eng.program_stats["prefill"]["captures"]) == base
    if paged:
        assert eng._pool.in_use == 0
    eng.close()


@pytest.mark.parametrize("paged,uploads", [(False, 4), (True, 6)])
def test_host_sync_budget_at_two_ranks(mesh2, trees, paged, uploads):
    """The one-rank budget, unchanged at two ranks (the reference's
    test_decode_host_sync_budget_sharded): one blocking fetch a chunk, and
    per request the prompt upload and the three sampling arrays (paged:
    the page ids ride in the prompt's upload, where the reference makes a
    second, and the block table goes up twice), never one per rank; the
    same counts as the port's one-rank engine on the same traffic."""
    kw = {"kv_page_tokens": 16, "kv_pool_pages": 16} if paged else {}
    engines = [_engine(trees, mesh, decode_chunk=4, **kw) for mesh in (mesh2, None)]
    for prompt in (np.arange(1, 9, dtype=np.int32), np.arange(3, 17, dtype=np.int32)):
        deltas = []
        for eng in engines:
            base = dict(eng.sync_stats)
            req = eng.submit(prompt, SamplingParams(max_new_tokens=24))
            while not req.done.is_set():
                eng.step()
            d = {k: eng.sync_stats[k] - base[k] for k in ("chunks", "fetches", "uploads")}
            assert len(req.generated) == 24
            assert d["chunks"] >= 5
            assert d["chunks"] - 1 <= d["fetches"] <= d["chunks"] + 1
            assert d["uploads"] == uploads, d
            deltas.append(d)
        assert deltas[0] == deltas[1]
    engines[0].close()


def test_an_armed_upload_fails_one_request_not_the_group(mesh2, trees, monkeypatch):
    """``engine.upload`` armed for one fire: it fires on the leader alone
    (the followers run without ``KUKEON_FAULTS``), fails that request, and
    the ranks stay in step: the group is whole and the next requests give
    the one-rank tokens."""
    eng = _engine(trees, mesh2)
    eng.start()
    monkeypatch.setenv(faults.ENV, "engine.upload:1:1")
    faults.reset()
    try:
        req = eng.submit(PROMPTS[0], GREEDY)
        assert req.done.wait(timeout=30)
        assert isinstance(req.error, faults.FaultInjected), req.error
        assert faults.fired("engine.upload") == 1
        want = [_engine(trees).generate(p, GREEDY) for p in PROMPTS]
        assert [eng.generate(p, GREEDY) for p in PROMPTS] == want
        assert mesh2.group.failed is None and eng.running
    finally:
        monkeypatch.delenv(faults.ENV)
        faults.reset()
        eng.close()


# --- the serving cell ----------------------------------------------------------


def test_cell_chips2_stats_metrics_and_refusals(mesh2, tmp_path, monkeypatch):
    """``ServingCell(chips=2)``: /v1/stats ``mesh`` with the reference's
    keys, the gauge at 2, a request served; the layer profile, once
    refused (501), answered over HTTP by both ranks, keyed ``tiny|cpu|2``
    and persisted, and a request served after it."""
    cell = ServingCell("tiny", num_slots=2, max_seq_len=96, device="cpu", chips=2)
    try:
        assert cell.stats()["mesh"] == {"chips": 2, "shape": {"tensor": 2}, "kvSharded": True}
        assert _gauge(cell.engine, "kukeon_engine_mesh_chips") == [2.0]
        cell.warmup(8)
        out = cell.generate({"promptTokens": [1, 2, 3, 4], "maxNewTokens": 4})
        assert out["numTokens"] == 4
        monkeypatch.setenv("KUKEON_LAYER_PROFILE_PATH", str(tmp_path / "layers.json"))
        prof = cell.profile_layers(prefill_len=8, decode_batch=2)
        assert prof["errors"] == 0 and prof["key"] == "tiny|cpu|2"
        cell.engine.start()
        server = serving_cell.serve(cell)
        try:
            req = urllib.request.Request(
                f"http://127.0.0.1:{server.server_address[1]}/v1/profile",
                data=json.dumps({"layers": True, "prefillLen": 8}).encode(), method="POST")
            with urllib.request.urlopen(req, timeout=60) as resp:
                got = json.loads(resp.read())
            assert resp.status == 200 and got["errors"] == 0 and got["key"] == "tiny|cpu|2"
            assert got["path"] == str(tmp_path / "layers.json")
            assert len(got["components"]) == tl.llama_tiny().num_layers + 2
            out = cell.generate({"promptTokens": [1, 2, 3, 4], "maxNewTokens": 4})
            assert out["numTokens"] == 4
        finally:
            server.shutdown()
            server.server_close()
            cell.engine.stop()
    finally:
        cell.engine.close()


def test_cell_chips2_from_a_checkpoint_matches_one_device(mesh2, trees, tmp_path):
    """``--checkpoint`` at two ranks: each rank streams its blocks of the
    kukeon int8 checkpoint into its booting engine (a ``"stream"`` recipe),
    as the one-device cell streams the whole; the cell gives the one-device
    cell's tokens from the same directory."""
    from kukeon_tpu_torch.models import checkpoints

    checkpoints.save_quantized(str(tmp_path / "q"), trees["int8"][1], tl.llama_tiny())
    body = {"promptTokens": [int(t) for t in PROMPTS[1]], "maxNewTokens": 6}
    out = []
    for chips in (2, None):
        cell = ServingCell("tiny", num_slots=2, max_seq_len=96, device="cpu", chips=chips,
                           checkpoint=str(tmp_path / "q"))
        assert cell.engine._ckpt_stream is not None
        out.append(cell.generate(body)["tokens"])
        cell.engine.close()
    assert out[0] == out[1]


@pytest.mark.parametrize("fmt", ["hf", "orbax"])
def test_cell_chips2_from_hf_and_orbax_matches_one_device(mesh2, tmp_path, fmt):
    """The other two formats at two ranks, int8: an HF directory through
    its stream (quantized on the host), the JAX-written orbax fixture read
    whole on each rank's host and each leaf quantized on the rank's device
    as it comes; the one-device cell's tokens."""
    from kukeon_tpu_torch.models import checkpoints

    if fmt == "hf":
        path = checkpoints.synthesize_hf_checkpoint(str(tmp_path / "hf"), tl.llama_tiny(),
                                                    seed=0)
    else:
        path = os.path.join(REPO, "tests", "data", "orbax_llama_tiny")
    body = {"promptTokens": [int(t) for t in PROMPTS[1]], "maxNewTokens": 6}
    out = []
    for chips in (2, None):
        cell = ServingCell("tiny", num_slots=2, max_seq_len=96, device="cpu", chips=chips,
                           checkpoint=path, dtype="int8")
        assert cell.engine.world == (chips or 1)
        out.append(cell.generate(body)["tokens"])
        cell.engine.close()
    assert out[0] == out[1]


def test_overgrant_exits_before_any_weight(monkeypatch):
    """A grant above what the host shows is a SystemExit naming the grant,
    raised before a weight is drawn or a rank starts."""
    def no_weights(*a, **k):
        raise AssertionError("weights allocated before the grant was checked")

    monkeypatch.setattr(serving_cell, "_drawn_params", no_weights)
    monkeypatch.setattr(serving_cell, "rank_leaves", no_weights)
    before = launch.current()
    with pytest.raises(SystemExit, match="--chips 64: serving mesh wants 64"):
        ServingCell("tiny", num_slots=2, max_seq_len=96, device="cpu", chips=64)
    assert launch.current() is before


def test_moe_and_embedding_refused_at_chips2(mesh2, monkeypatch):
    """Refused until A13b1, served since (the name kept): a Mixtral cell
    at ``chips=2`` serves over the file's group without the one-device
    draw; the runner's way for the embedding cell, ``main --chips 2``,
    comes up on two ranks, answers ``/v1/embed`` and drains to exit 0."""
    monkeypatch.setattr(serving_cell, "_drawn_params", None)
    cell = ServingCell("mixtral-tiny", num_slots=2, max_seq_len=96, device="cpu", chips=2)
    try:
        assert cell.stats()["mesh"] == {"chips": 2, "shape": {"tensor": 2}, "kvSharded": True}
        assert cell.generate({"promptTokens": [1, 2, 3], "maxNewTokens": 3})["numTokens"] == 3
    finally:
        cell.engine.close()
    env = dict(os.environ, **{launch.TIMEOUT_ENV: GROUP_TIMEOUT_S})
    proc = subprocess.Popen(
        [sys.executable, "-m", "kukeon_tpu_torch.runtime.serving_cell", "--model", "bge-tiny",
         "--device", "cpu", "--chips", "2", "--port", "0", "--num-slots", "4"],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env, cwd=REPO)
    try:
        line = _readline(proc, 90.0)
        assert "ready on" in line, (line, proc.stderr.read() if proc.poll() is not None else "")
        base = f"http://127.0.0.1:{int(line.rsplit(':', 1)[1])}"
        with urllib.request.urlopen(base + "/v1/stats", timeout=30) as r:
            assert json.load(r)["mesh"] == {"chips": 2, "shape": {"tensor": 2}}
        req = urllib.request.Request(base + "/v1/embed", method="POST", data=json.dumps(
            {"inputTokens": [[1, 2, 3], [4, 5]]}).encode())
        with urllib.request.urlopen(req, timeout=60) as r:
            assert json.load(r)["numSequences"] == 2
        urllib.request.urlopen(urllib.request.Request(base + "/drain", method="POST"),
                               timeout=30).close()
        assert proc.wait(timeout=30) == 0
    finally:
        proc.kill()
        proc.wait()


def test_runner_command_line_parses():
    """The JAX runner's command line for a model cell (which always ends in
    ``--chips N``) is one the port's cell parses, flag for flag."""
    from types import SimpleNamespace

    from kukeon_tpu.runtime.api import types as t
    from kukeon_tpu.runtime.runner import Runner

    m = t.ModelSpec(model="llama3-8b", num_slots=4, max_seq_len=2048, dtype="int8",
                    kv_cache_int8=True, kv_page_tokens=64, max_pending=32, chips=2,
                    deadline_s=30.0, slo_ttft_p95_ms=500.0, slo_availability=0.999)
    fake = SimpleNamespace(opts=SimpleNamespace(serving_python=sys.executable),
                           backend=SimpleNamespace(isolated=True))
    cmd = Runner._model_container(fake, m, port=9123, role="decode").command
    assert cmd[1:3] == ["-m", "kukeon_tpu.runtime.serving_cell"] and "--chips" in cmd
    args = serving_cell.build_parser().parse_args(cmd[3:])
    assert (args.model, args.chips, args.port, args.role, args.num_slots) == \
        ("llama3-8b", 2, 9123, "decode", 4)
    assert (args.max_seq_len, args.dtype, args.kv_cache_int8, args.kv_page_tokens,
            args.max_pending, args.deadline_s, args.host) == \
        (2048, "int8", True, 64, 32, 30.0, "0.0.0.0")


# --- the tune ------------------------------------------------------------------


def test_tune_mesh_fields_roundtrip_and_world_key(mesh2, trees, tmp_path, monkeypatch):
    """``mesh_tensor`` and ``kv_shard`` cross both packages' ServingTune;
    a two-rank engine reads the profile stored under ``tiny|cpu|2`` (its
    kv_shard False replicates the cache), and takes the levers of one whose
    tensor axis is not the world's as well, as the reference's engine,
    which never reads ``mesh_tensor`` (C11: this once raised)."""
    from kukeon_tpu.serving.tuning import ServingTune as JaxTune
    from kukeon_tpu_torch.serving import tuning

    ours = tuning.ServingTune(decode_chunk=4, mesh_tensor=2, kv_shard=False)
    back = JaxTune.from_dict(ours.to_dict())
    assert (back.mesh_tensor, back.kv_shard, back.decode_chunk) == (2, False, 4)
    assert tuning.ServingTune.from_dict(back.to_dict()) == ours
    monkeypatch.setenv("KUKEON_TUNE_PATH", str(tmp_path / "tune.json"))
    tuning.save("tiny", "cpu", 2, ours)
    eng = _engine(trees, mesh2, model_name="tiny")
    assert dataclasses.replace(eng.tune, tuned_at=None) == ours
    assert not eng.kv_sharded and eng.decode_chunk == 4
    eng.close()
    tuning.save("tiny", "cpu", 2, dataclasses.replace(ours, mesh_tensor=1))
    eng = _engine(trees, mesh2, model_name="tiny")
    assert eng.tune.mesh_tensor == 1
    assert not eng.kv_sharded and eng.decode_chunk == 4
    eng.close()


# --- a rank's death ends the cell ----------------------------------------------


def _readline(proc, timeout: float) -> str:
    ready, _, _ = select.select([proc.stdout], [], [], timeout)
    return proc.stdout.readline() if ready else ""


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


def test_a_dead_follower_ends_the_cell(tmp_path):
    """The runner's way, ``main --chips 2 --device cpu``, with ``jax`` made
    unimportable (the leader and its follower run the port alone): the
    cell serves over two ranks; its follower killed, the cell exits 1 in
    seconds, never serving on one rank."""
    poison = tmp_path / "jax"
    poison.mkdir()
    (poison / "__init__.py").write_text("raise ImportError('the port imports no jax')\n")
    env = dict(os.environ, KUKEON_WATCHDOG_S="0", KUKEON_TUNE_PATH=str(tmp_path / "t.json"),
               **{launch.TIMEOUT_ENV: GROUP_TIMEOUT_S})
    env["PYTHONPATH"] = os.pathsep.join(p for p in (str(tmp_path), env.get("PYTHONPATH")) if p)
    proc = subprocess.Popen(
        [sys.executable, "-m", "kukeon_tpu_torch.runtime.serving_cell", "--model", "tiny",
         "--device", "cpu", "--chips", "2", "--port", "0", "--num-slots", "2",
         "--max-seq-len", "128"],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env, cwd=REPO)
    try:
        line = _readline(proc, 90.0)
        if "ready on" not in line:
            proc.kill()
        assert "ready on" in line, (line, proc.stderr.read() if proc.poll() is not None else "")
        base = f"http://127.0.0.1:{int(line.rsplit(':', 1)[1])}"
        with urllib.request.urlopen(base + "/v1/stats", timeout=30) as r:
            assert json.load(r)["mesh"] == {"chips": 2, "shape": {"tensor": 2},
                                            "kvSharded": True}
        req = urllib.request.Request(base + "/v1/generate", method="POST", data=json.dumps(
            {"promptTokens": [1, 2, 3], "maxNewTokens": 3}).encode())
        with urllib.request.urlopen(req, timeout=60) as r:
            assert json.load(r)["numTokens"] == 3
        with open(f"/proc/{proc.pid}/task/{proc.pid}/children") as f:
            followers = [int(x) for x in f.read().split()]
        assert len(followers) == 1, followers
        os.kill(followers[0], signal.SIGKILL)
        assert proc.wait(timeout=20) == 1
        assert "rank 1 exited" in proc.stderr.read()
    finally:
        proc.kill()
        proc.wait()


ORPHAN = """
import subprocess, sys
child = subprocess.Popen([sys.executable, "-c", (
    "import os, threading, time; from kukeon_tpu_torch.parallel import launch; "
    "threading.Thread(target=launch._watch_leader, args=(os.getppid(),), daemon=True).start(); "
    "print('up', flush=True); time.sleep(60)")], stdout=subprocess.PIPE, text=True)
assert child.stdout.readline() == "up\\n"
print(child.pid, flush=True)
child.wait()
"""


def test_a_dead_leader_ends_its_follower():
    """A follower's watch on its leader (``launch._watch_leader``): the
    leader killed outright (no exit descriptor, no atexit), the follower
    is gone in seconds, even with its main thread asleep."""
    proc = subprocess.Popen([sys.executable, "-c", ORPHAN], stdout=subprocess.PIPE, text=True,
                            cwd=REPO)
    try:
        line = _readline(proc, 60.0)
        assert line.strip().isdigit(), line
        follower = int(line)
        assert not _gone(follower, 0.3)
        os.kill(proc.pid, signal.SIGKILL)
        proc.wait(timeout=10)
        assert _gone(follower, 10.0)
    finally:
        proc.kill()
        proc.wait()


def test_a_dead_follower_fails_the_engine_and_stops_it(mesh2, trees):
    """Last in the file (it ends the file's group): the follower killed
    under a running two-rank engine, the request in flight fails, later
    submissions fail too, and the engine's driver stops, instead of
    serving on the leader's rank alone; the group says which rank died."""
    eng = _engine(trees, mesh2)
    eng.warmup(8)
    eng.start()
    assert eng.generate(PROMPTS[0], GREEDY) == _engine(trees).generate(PROMPTS[0], GREEDY)
    os.kill(mesh2.group.pids[0], signal.SIGKILL)
    req = eng.submit(PROMPTS[1], SamplingParams(max_new_tokens=64))
    assert req.done.wait(timeout=30), "the request hung after its follower died"
    assert req.error is not None
    deadline = time.monotonic() + 10
    while eng.running and time.monotonic() < deadline:
        time.sleep(0.05)
    assert not eng.running and mesh2.group.failed and "rank 1" in mesh2.group.failed
    with pytest.raises(launch.RankFailure, match="rank 1"):
        mesh2.group.post(0, "noop")
    eng.stop()
