"""The port's embedding cell (``kukeon_tpu_torch/models/bert.py``,
``serving/embedding.py``, ``runtime/serving_cell.py`` ``EmbeddingCell``)
against the JAX package's, on the CPU.

Weights are the JAX package's ``bge_tiny`` (f32) tree, carried across with
``params_from_numpy``. f32 hidden states, embeddings and the engine's
batched vectors agree within 1e-5 (the same math summed in another order);
a bf16 run is held to cosine 0.999 against the f32 one. The ports of every
test of ``tests/test_bert.py``, of ``tests/test_obs.py``'s embedding-cell
stats parity, and the cell over HTTP, alone, beside the JAX cell and behind
the JAX gateway.
"""

import dataclasses
import http.client
import json
import os
import subprocess
import sys
import threading
from http.server import ThreadingHTTPServer

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kukeon_tpu.gateway.cell import GatewayCell, make_gateway_handler
from kukeon_tpu.models import bert as jb
from kukeon_tpu.obs import federate as fed
from kukeon_tpu.parallel import make_mesh
from kukeon_tpu.runtime import serving_cell as jcell_mod
from kukeon_tpu.serving import EmbeddingEngine as JaxEmbeddingEngine
from kukeon_tpu_torch.device import NoGPUError
from kukeon_tpu_torch.models import bert as tb
from kukeon_tpu_torch.models import convert
from kukeon_tpu_torch.obs import render
from kukeon_tpu_torch.runtime import serving_cell
from kukeon_tpu_torch.runtime.serving_cell import EmbeddingCell, ServingCell, make_handler
from kukeon_tpu_torch.serving import EmbeddingEngine
from kukeon_tpu_torch.serving.embedding import bucket_length

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def setup():
    """(cfg, the JAX tree, the port's tree) at bge_tiny: the reference's
    ``init_params`` from key 0, as the JAX cell draws it."""
    jcfg = jb.bge_tiny()
    jp = jb.init_params(jax.random.key(0), jcfg)
    tp = convert.params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    return tb.bge_tiny(), jp, tp


def _ragged(rng, lengths, V=512):
    return [rng.integers(1, V, size=n).astype(np.int32) for n in lengths]


def _grid(rng, B, S, pad_from=None, V=512):
    tokens = rng.integers(0, V, (B, S)).astype(np.int32)
    mask = np.ones((B, S), np.int32)
    for row, n in enumerate(pad_from or []):
        mask[row, n:] = 0
    return tokens, mask


# --- the model against the JAX package -------------------------------------------


def test_forward_hidden_states_match_jax(setup):
    cfg, jp, tp = setup
    tokens, mask = _grid(np.random.default_rng(0), 3, 20, pad_from=[20, 7, 1])
    types = np.random.default_rng(1).integers(0, 2, (3, 20)).astype(np.int32)
    for tt in (None, types):
        want = np.asarray(jb.forward(jp, jb.bge_tiny(), jnp.asarray(tokens), jnp.asarray(mask),
                                     None if tt is None else jnp.asarray(tt)))
        got = tb.forward(tp, cfg, torch.from_numpy(tokens), torch.from_numpy(mask),
                         None if tt is None else torch.from_numpy(tt))
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("pooling", ["cls", "mean"])
def test_embed_matches_jax(setup, pooling):
    cfg, jp, tp = setup
    tokens, mask = _grid(np.random.default_rng(2), 4, 33, pad_from=[33, 12, 5, 30])
    want = np.asarray(jb.embed(jp, jb.bge_tiny(), jnp.asarray(tokens), jnp.asarray(mask),
                               pooling=pooling))
    got = tb.embed(tp, cfg, torch.from_numpy(tokens), torch.from_numpy(mask), pooling=pooling)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    with pytest.raises(ValueError, match="pooling"):
        tb.embed(tp, cfg, torch.from_numpy(tokens), torch.from_numpy(mask), pooling="max")


def test_a_fully_padded_row_stays_finite(setup):
    """finfo(f32).min, not -inf, on padded keys: a row with no live key
    softmaxes to finite numbers, in both packages alike."""
    cfg, jp, tp = setup
    tokens, mask = _grid(np.random.default_rng(3), 2, 16, pad_from=[16, 0])
    got = tb.forward(tp, cfg, torch.from_numpy(tokens), torch.from_numpy(mask))
    assert torch.isfinite(got).all()
    want = np.asarray(jb.forward(jp, jb.bge_tiny(), jnp.asarray(tokens), jnp.asarray(mask)))
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_engine_embed_batch_matches_the_jax_engine(setup):
    """Ragged lengths over several grids and buckets, order kept."""
    cfg, jp, tp = setup
    lengths = (5, 30, 12, 3, 21, 17, 64, 1, 100, 33, 16)
    prompts = _ragged(np.random.default_rng(4), lengths)
    jeng = JaxEmbeddingEngine(jb.bge_tiny(), jp, make_mesh(tensor=1, devices=jax.devices()[:1]),
                              batch_size=4)
    want = jeng.embed_batch(prompts)
    eng = EmbeddingEngine(cfg, tp, batch_size=4, device="cpu")
    got = eng.embed_batch(prompts)
    assert got.shape == (len(prompts), cfg.hidden_size) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, **TOL)
    # The caller's order: each row is its own sequence's embedding.
    for i in (0, 6, 8):
        alone = eng.embed_batch([prompts[i]])
        np.testing.assert_allclose(got[i], alone[0], **TOL)


def test_engine_refuses_an_unknown_pooling_and_needs_a_device(setup):
    cfg, _jp, tp = setup
    with pytest.raises(ValueError, match="pooling"):
        EmbeddingEngine(cfg, tp, pooling="max", device="cpu")
    assert not torch.cuda.is_available()
    with pytest.raises(NoGPUError):
        EmbeddingEngine(cfg, tp)


def test_bf16_run_holds_cosine_to_f32(setup):
    """The same weights cast to bf16 (the serving dtype of bge-base): each
    vector within cosine 0.999 of the f32 port's and of the JAX package's
    bf16 run."""
    cfg, jp, tp = setup
    cfg16 = dataclasses.replace(cfg, dtype=torch.bfloat16)
    tp16 = convert.params_from_numpy(jax.tree.map(np.asarray, jp), "cpu", dtype=torch.bfloat16)
    jp16 = jax.tree.map(lambda x: x.astype(jnp.bfloat16), jp)
    prompts = _ragged(np.random.default_rng(5), (9, 40, 3, 120, 64))
    f32 = EmbeddingEngine(cfg, tp, batch_size=4, device="cpu").embed_batch(prompts)
    b16 = EmbeddingEngine(cfg16, tp16, batch_size=4, device="cpu").embed_batch(prompts)
    j16 = JaxEmbeddingEngine(dataclasses.replace(jb.bge_tiny(), dtype=jnp.bfloat16), jp16,
                             make_mesh(tensor=1, devices=jax.devices()[:1]),
                             batch_size=4).embed_batch(prompts)
    np.testing.assert_allclose(np.linalg.norm(b16, axis=-1), 1.0, atol=1e-3)
    assert np.all(np.sum(b16 * f32, axis=-1) >= 0.999)
    assert np.all(np.sum(b16 * j16, axis=-1) >= 0.999)


# --- the ports of tests/test_bert.py ---------------------------------------------


class TestModel:
    def test_forward_shapes(self, setup):
        cfg, _jp, tp = setup
        B, S = 3, 17
        tokens = torch.randint(0, cfg.vocab_size, (B, S), generator=torch.Generator().manual_seed(1))
        hidden = tb.forward(tp, cfg, tokens, torch.ones((B, S), dtype=torch.int32))
        assert hidden.shape == (B, S, cfg.hidden_size)
        assert hidden.dtype == torch.float32

    def test_embed_unit_norm(self, setup):
        cfg, _jp, tp = setup
        tokens = torch.randint(0, cfg.vocab_size, (2, 9), generator=torch.Generator().manual_seed(2))
        mask = torch.ones((2, 9), dtype=torch.int32)
        for pooling in ("cls", "mean"):
            v = tb.embed(tp, cfg, tokens, mask, pooling=pooling)
            assert v.shape == (2, cfg.hidden_size)
            np.testing.assert_allclose(torch.linalg.vector_norm(v, dim=-1).numpy(), 1.0,
                                       rtol=1e-5)

    def test_padding_invariance(self, setup):
        """The same sequence embeds alike whatever padding follows it."""
        cfg, _jp, tp = setup
        seq = torch.randint(1, cfg.vocab_size, (1, 8), generator=torch.Generator().manual_seed(3))
        short_mask = torch.ones((1, 8), dtype=torch.int32)
        v_short = tb.embed(tp, cfg, seq, short_mask)
        long_tokens = torch.cat([seq, torch.zeros((1, 24), dtype=seq.dtype)], dim=1)
        long_mask = torch.cat([short_mask, torch.zeros((1, 24), dtype=torch.int32)], dim=1)
        v_long = tb.embed(tp, cfg, long_tokens, long_mask)
        np.testing.assert_allclose(v_short.numpy(), v_long.numpy(), atol=2e-5)

    def test_bidirectional_not_causal(self, setup):
        """Changing a later token changes an earlier position's state."""
        cfg, _jp, tp = setup
        base = torch.randint(1, cfg.vocab_size, (1, 8), generator=torch.Generator().manual_seed(4))
        mask = torch.ones((1, 8), dtype=torch.int32)
        h1 = tb.forward(tp, cfg, base, mask)
        changed = base.clone()
        changed[0, 7] = (base[0, 7] + 1) % cfg.vocab_size
        h2 = tb.forward(tp, cfg, changed, mask)
        assert not np.allclose(h1[0, 0].numpy(), h2[0, 0].numpy())

    @pytest.mark.parametrize("which", ["bge_tiny", "bge_base"])
    def test_param_count_matches_tree(self, setup, which):
        cfg = getattr(tb, which)()
        if which == "bge_base":       # count the tree without drawing it
            cfg = dataclasses.replace(cfg, dtype=torch.float32)
            with torch.device("meta"):
                params = tb.init_params(cfg, None, "meta")
        else:
            params = setup[2]
        leaves = [params["embed"][k] for k in params["embed"]] + list(params["layers"].values())
        assert sum(t.numel() for t in leaves) == cfg.param_count()
        assert cfg.param_count() == getattr(jb, which)().param_count()


class TestEngine:
    def test_bucket_length(self):
        assert bucket_length(5, 512) == 16
        assert bucket_length(16, 512) == 16
        assert bucket_length(17, 512) == 32
        assert bucket_length(600, 512) == 512
        assert bucket_length(100, 64) == 64   # clamped to the model's max

    def test_embed_batch_matches_direct(self, setup):
        cfg, _jp, tp = setup
        engine = EmbeddingEngine(cfg, tp, batch_size=4, device="cpu")
        prompts = _ragged(np.random.default_rng(0), (5, 30, 12, 3, 21))   # 5 > batch 4
        vecs = engine.embed_batch(prompts)
        assert vecs.shape == (5, cfg.hidden_size)
        for i, p in enumerate(prompts):
            direct = tb.embed(tp, cfg, torch.from_numpy(p)[None, :],
                              torch.ones((1, p.size), dtype=torch.int32))
            np.testing.assert_allclose(vecs[i], direct[0].numpy(), atol=3e-5)

    def test_oversized_sequence_rejected(self, setup):
        cfg, _jp, tp = setup
        engine = EmbeddingEngine(cfg, tp, batch_size=2, device="cpu")
        too_long = np.ones((cfg.max_position_embeddings + 1,), np.int32)
        with pytest.raises(ValueError, match="max_position_embeddings"):
            engine.embed_batch([too_long])

    def test_out_of_vocab_ids_rejected(self, setup):
        cfg, _jp, tp = setup
        engine = EmbeddingEngine(cfg, tp, batch_size=2, device="cpu")
        for bad in ([1, cfg.vocab_size], [-1, 2], [[1, 2]]):
            with pytest.raises(ValueError, match="token ids"):
                engine.embed_batch([np.asarray(bad, np.int32)])

    def test_empty_batch(self, setup):
        cfg, _jp, tp = setup
        engine = EmbeddingEngine(cfg, tp, batch_size=2, device="cpu")
        assert engine.embed_batch([]).shape == (0, cfg.hidden_size)


def test_warmup_runs_each_bucket_its_lengths_hit(setup, monkeypatch):
    cfg, _jp, tp = setup
    engine = EmbeddingEngine(cfg, tp, batch_size=3, device="cpu")
    shapes = []
    real = tb.embed
    monkeypatch.setattr(tb, "embed", lambda p, c, t, m, pooling: (
        shapes.append(tuple(t.shape)), real(p, c, t, m, pooling=pooling))[1])
    engine.warmup((5, 64, 100, 1000))
    assert shapes == [(3, 16), (3, 64), (3, 128), (3, 128)]


# --- the cell ---------------------------------------------------------------------


def _parse_expo(text):
    """{family: {"type", "samples": [(name, labels, value)]}} of an
    exposition (the reference test's helper, on the JAX federation parser)."""
    return {name: {"type": f.kind, "samples": [(n, lab, float(v)) for n, lab, v in f.samples]}
            for name, f in fed.parse(text).items()}


def test_embedding_cell_stats_parity():
    """The port of ``tests/test_obs.py::test_embedding_cell_stats_parity``:
    the embedding cell's stats carry the decoder cell's ready, draining
    and uptime fields, and both flavours expose a scrapeable registry."""
    ec = EmbeddingCell("bge-tiny", batch_size=4, device="cpu")
    dc = ServingCell("tiny", num_slots=1, max_seq_len=96, device="cpu")
    try:
        for key in ("ready", "draining", "uptimeSeconds", "unreadyReason"):
            assert key in ec.stats(), key
            assert key in dc.stats(), key
        ec.mark_ready()
        s = ec.stats()
        assert s["ready"] is True and "unreadyReason" not in s
        for cell, kind in ((ec, "embedding"), (dc, "decoder")):
            fams = _parse_expo(render(cell.registry))
            assert "kukeon_cell_ready" in fams
            info = fams["kukeon_cell_info"]["samples"]
            assert any(lab.get("kind") == kind for _n, lab, _v in info)
        assert "kukeon_embed_sequences_total" in _parse_expo(render(ec.registry))
    finally:
        dc.engine.stop()


def test_stats_have_the_reference_keys():
    jc = jcell_mod.EmbeddingCell("bge-tiny", batch_size=4, chips=1)
    tc = EmbeddingCell("bge-tiny", batch_size=4, device="cpu")
    assert set(tc.stats()) == set(jc.stats())
    jc.mark_ready()
    tc.mark_ready()
    assert set(tc.stats()) == set(jc.stats())
    assert tc.stats()["kind"] == "embedding" and tc.stats()["batchSize"] == 4


def test_checkpoint_is_refused_naming_a10(tmp_path):
    # An empty directory is no orbax checkpoint (orbax ones boot:
    # test_torch_orbax.py).
    with pytest.raises(SystemExit, match="not an orbax checkpoint"):
        EmbeddingCell("bge-tiny", checkpoint=str(tmp_path), device="cpu")
    with pytest.raises(SystemExit, match="bge-huge"):
        EmbeddingCell("bge-huge", device="cpu")


def _serve(cell):
    srv = ThreadingHTTPServer(("127.0.0.1", 0), make_handler(cell))
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return srv


def _request(port, method, path, body=None):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    conn.request(method, path, body=None if body is None else json.dumps(body),
                 headers={"Content-Type": "application/json"})
    resp = conn.getresponse()
    raw = resp.read()
    conn.close()
    return resp.status, raw


def _post(port, path, body):
    status, raw = _request(port, "POST", path, body)
    return status, json.loads(raw) if raw else {}


@pytest.fixture(scope="module")
def cells(setup):
    """A port cell on the JAX cell's weights and the JAX cell, each behind
    its HTTP server, ready."""
    _cfg, _jp, tp = setup
    jc = jcell_mod.EmbeddingCell("bge-tiny", batch_size=4, chips=1)
    tc = EmbeddingCell("bge-tiny", batch_size=4, device="cpu")
    tc.engine.params = tp
    jc.mark_ready()
    tc.mark_ready()
    js = ThreadingHTTPServer(("127.0.0.1", 0), jcell_mod.make_handler(jc))
    threading.Thread(target=js.serve_forever, daemon=True).start()
    ts = _serve(tc)
    yield tc, ts, jc, js
    for srv in (ts, js):
        srv.shutdown()
        srv.server_close()


TOKENS = [[5, 300, 7, 200, 9], list(range(1, 40)), [42], list(range(100, 117))]


def test_v1_embed_over_http_equals_the_jax_cell(cells):
    tc, ts, _jc, js = cells
    for body in ({"inputTokens": TOKENS}, {"inputs": "hello, embeddings"},
                 {"inputs": ["one", "two words", ""]}):
        s1, got = _post(ts.server_address[1], "/v1/embed", body)
        s2, want = _post(js.server_address[1], "/v1/embed", body)
        assert s1 == s2 == 200
        assert got["dim"] == want["dim"] == 64
        assert got["numSequences"] == want["numSequences"]
        np.testing.assert_allclose(np.array(got["embeddings"]), np.array(want["embeddings"]),
                                   **TOL)
    steps = tc.recorder.snapshot()
    assert steps[-1]["occupancy"] == 3 and "embed" in steps[-1]["programs"]


def test_v1_embed_without_inputs_is_400_and_other_routes_404(cells):
    _tc, ts, _jc, _js = cells
    status, out = _post(ts.server_address[1], "/v1/embed", {"maxNewTokens": 3})
    assert status == 400 and "inputs" in out["error"]
    status, out = _post(ts.server_address[1], "/v1/embed", {"inputTokens": [[1, 99999]]})
    assert status == 400 and "token ids" in out["error"]
    assert _post(ts.server_address[1], "/v1/generate", {"promptTokens": [1]})[0] == 404
    assert _request(ts.server_address[1], "GET", "/v1/trace")[0] == 404


def test_v1_embed_behind_the_jax_gateway(cells):
    tc, ts, _jc, js = cells
    gw = GatewayCell("bge-tiny", [f"http://127.0.0.1:{ts.server_address[1]}"],
                     poll_interval_s=0.05, request_timeout_s=60.0)
    gw.start()
    gw.router.poll_once()
    gw_srv = ThreadingHTTPServer(("127.0.0.1", 0), make_gateway_handler(gw))
    threading.Thread(target=gw_srv.serve_forever, daemon=True).start()
    try:
        before = tc.total_sequences
        status, got = _post(gw_srv.server_address[1], "/v1/embed", {"inputTokens": TOKENS})
        assert status == 200
        _s, want = _post(js.server_address[1], "/v1/embed", {"inputTokens": TOKENS})
        np.testing.assert_allclose(np.array(got["embeddings"]), np.array(want["embeddings"]),
                                   **TOL)
        assert tc.total_sequences - before == len(TOKENS)
    finally:
        gw_srv.shutdown()
        gw_srv.server_close()
        gw.stop()


def test_metrics_read_by_the_jax_federation_parser(cells):
    tc, ts, _jc, _js = cells
    _post(ts.server_address[1], "/v1/embed", {"inputTokens": TOKENS[:2]})
    status, raw = _request(ts.server_address[1], "GET", "/metrics")
    assert status == 200
    fams = fed.parse(raw.decode())
    total = fams["kukeon_embed_sequences_total"]
    assert total.kind == "counter" and float(total.samples[0][2]) == tc.total_sequences
    assert float(fams["kukeon_embed_batch_size"].samples[0][2]) == 4
    assert fams["kukeon_cell_info"].samples[0][1] == {"model": "bge-tiny", "kind": "embedding"}
    for name in ("kukeon_cell_ready", "kukeon_timeline_depth", "kukeon_hbm_bytes_in_use",
                 "kukeon_watchdog_trips_total"):
        assert name in fams, name


def test_main_boots_bge_tiny_and_answers_v1_embed():
    """``python -m kukeon_tpu_torch.runtime.serving_cell --model bge-tiny
    --device cpu``: ready, /v1/embed, /v1/stats, then /drain ends it with
    exit code 0."""
    proc = subprocess.Popen(
        [sys.executable, "-m", "kukeon_tpu_torch.runtime.serving_cell", "--model", "bge-tiny",
         "--device", "cpu", "--port", "0", "--num-slots", "4"],
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True,
        env={**os.environ, "OMP_NUM_THREADS": "2"})
    try:
        line = proc.stdout.readline()
        assert "ready on 127.0.0.1:" in line, line
        port = int(line.rsplit(":", 1)[1])
        status, out = _post(port, "/v1/embed", {"inputTokens": TOKENS})
        assert status == 200 and out["numSequences"] == 4 and out["dim"] == 64
        norms = np.linalg.norm(np.array(out["embeddings"]), axis=-1)
        np.testing.assert_allclose(norms, 1.0, atol=1e-5)
        stats = json.loads(_request(port, "GET", "/v1/stats")[1])
        assert stats["batchSize"] == 4 and stats["totalSequences"] == 4 and stats["ready"]
        assert _post(port, "/drain", {})[1]["started"] is True
        assert proc.wait(timeout=30) == 0
    finally:
        proc.kill()
        proc.wait()


def test_main_without_device_raises_on_a_gpu_less_host():
    assert not torch.cuda.is_available()
    with pytest.raises(NoGPUError):
        serving_cell.main(["--model", "bge-tiny", "--no-warmup"])
