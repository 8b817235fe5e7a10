"""The port's sampling, engine and serving cell against the JAX package's.

The slice as a whole: the port's ``ServingEngine(device="cpu")`` and the
JAX ``ServingEngine`` (1-device mesh) on ``llama_tiny`` with the same
weights give identical greedy token streams, for mixed prompt lengths,
more requests than slots, int8 weights and int8 KV. On a mismatch the
message shows the port's top-2 logit gap at the diverging step.
"""

import json
import threading
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kukeon_tpu.models import llama as jl
from kukeon_tpu.parallel import make_mesh
from kukeon_tpu.serving import ServingEngine as JaxEngine
from kukeon_tpu.serving import sampling as jsampling
from kukeon_tpu.serving.tokenizer import ByteTokenizer as JaxByteTokenizer
from kukeon_tpu_torch.device import NoGPUError
from kukeon_tpu_torch.models import convert
from kukeon_tpu_torch.models import llama as tl
from kukeon_tpu_torch.runtime.serving_cell import ServingCell, serve
from kukeon_tpu_torch.serving import (
    RejectedError,
    SamplingParams,
    ServingEngine,
    bucket_length,
)
from kukeon_tpu_torch.serving import sampling as tsampling
from kukeon_tpu_torch.serving.tokenizer import ByteTokenizer

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def tiny_trees():
    jp = jl.init_params(jax.random.key(0), jl.llama_tiny())
    out = {}
    for name, tree in (("fp", jp), ("int8", jl.quantize_params(jp))):
        out[name] = (tree, convert.params_from_numpy(jax.tree.map(np.asarray, tree), "cpu"))
    return out


# --- sampling ------------------------------------------------------------------


def test_greedy_sampling_is_exact():
    rng = np.random.default_rng(0)
    logits = rng.standard_normal((5, 300)).astype(np.float32)
    zeros = np.zeros(5, np.float32)
    ref = np.asarray(jsampling.sample_per_slot(
        jnp.asarray(logits), jax.random.key(0), jnp.asarray(zeros),
        jnp.zeros(5, jnp.int32), jnp.ones(5, jnp.float32)))
    out = tsampling.sample_per_slot(torch.from_numpy(logits), None, torch.zeros(5),
                                    torch.zeros(5, dtype=torch.long), torch.ones(5))
    np.testing.assert_array_equal(out.numpy(), ref)
    assert int(tsampling.sample(torch.from_numpy(logits[:1]), None, SamplingParams())[0]) \
        == int(np.argmax(logits[0]))


def test_topk_topp_filter_is_exact_with_shared_noise(monkeypatch):
    """Both samplers get the same Gumbel noise (jax's categorical is
    replaced by argmax(logits + noise), which is what it computes), so the
    top-k/top-p masks must agree exactly: every draw matches."""
    rng = np.random.default_rng(1)
    B, V = 6, 64
    logits = (rng.standard_normal((B, V)) * 2).astype(np.float32)
    temps = np.array([0.0, 0.7, 1.0, 1.3, 0.9, 1.0], np.float32)
    top_k = np.array([0, 5, 0, 12, 3, 1], np.int32)
    top_p = np.array([1.0, 1.0, 0.8, 0.6, 0.95, 0.5], np.float32)
    holder = {}
    monkeypatch.setattr(jax.random, "categorical",
                        lambda key, s, axis=-1: jnp.argmax(s + holder["g"], axis=axis))
    for i in range(12):
        g = np.random.default_rng(100 + i).gumbel(size=(B, V)).astype(np.float32)
        holder["g"] = jnp.asarray(g)
        ref = np.asarray(jsampling.sample_per_slot(
            jnp.asarray(logits), jax.random.key(i), jnp.asarray(temps),
            jnp.asarray(top_k), jnp.asarray(top_p)))
        out = tsampling.sample_per_slot(
            torch.from_numpy(logits), None, torch.from_numpy(temps),
            torch.from_numpy(top_k).long(), torch.from_numpy(top_p),
            noise=torch.from_numpy(g))
        np.testing.assert_array_equal(out.numpy(), ref, err_msg=f"draw {i}")
    # The mask itself: slot 4 keeps exactly its top 3, slot 5 only its argmax.
    masked = tsampling.filter_topk_topp(torch.from_numpy(logits), torch.from_numpy(top_k),
                                        torch.from_numpy(top_p))
    assert int(torch.isfinite(masked[4]).sum()) <= 3
    assert torch.isfinite(masked[5]).nonzero().flatten().tolist() == [int(np.argmax(logits[5]))]


def test_stochastic_draws_match_in_distribution():
    """torch's generator cannot reproduce jax's bits: the port's draws are
    held to softmax(logits / T) by frequency (4000 draws, 4 sigma)."""
    logits = torch.tensor([[2.0, 1.0, 0.5, 0.0, -1.0]])
    T, n = 0.8, 4000
    g = torch.Generator().manual_seed(0)
    draws = torch.stack([
        tsampling.sample_per_slot(logits, g, torch.tensor([T]), torch.tensor([0]),
                                  torch.tensor([1.0]))[0] for _ in range(n)])
    freq = torch.bincount(draws, minlength=5).double() / n
    p = torch.softmax(logits[0].double() / T, dim=0)
    sigma = torch.sqrt(p * (1 - p) / n)
    assert torch.all((freq - p).abs() <= 4 * sigma + 1e-9), (freq, p)


# --- engine parity ---------------------------------------------------------------


def _top2_gap(tp, prompt, generated, step):
    """The port's top-2 logit gap at ``step`` of a request's stream."""
    cfg = tl.llama_tiny()
    seq = np.concatenate([prompt, np.asarray(generated[:step], np.int32)])
    logits, _ = tl.forward(tp, cfg, torch.from_numpy(seq[None]).long(),
                           torch.arange(seq.size)[None, :])
    top = torch.topk(logits[0, -1], 2).values
    return float(top[0] - top[1])


@pytest.mark.parametrize("weights,kv_int8", [("fp", False), ("int8", False), ("int8", True)])
def test_engine_greedy_streams_match_reference(tiny_trees, weights, kv_int8):
    jp, tp = tiny_trees[weights]
    rng = np.random.default_rng(7)
    lengths = (5, 23, 64, 9, 70)            # mixed, two past the first bucket
    prompts = [rng.integers(1, 512, n).astype(np.int32) for n in lengths]
    new = (10, 16, 7, 20, 12)
    kw = dict(num_slots=2, max_seq_len=160, decode_chunk=4, kv_cache_int8=kv_int8)

    jeng = JaxEngine(jl.llama_tiny(), jp, make_mesh(tensor=1, devices=jax.devices()[:1]),
                     **kw)
    teng = ServingEngine(tl.llama_tiny(), tp, device="cpu", **kw)
    streams = []
    for eng in (jeng, teng):
        reqs = [eng.submit(p, SamplingParams(max_new_tokens=n)) for p, n in zip(prompts, new)]
        while not all(r.done.is_set() for r in reqs):
            eng.step()
        streams.append([list(r.generated) for r in reqs])
    for i, (js, ts) in enumerate(zip(*streams)):
        if js != ts:
            step = next(t for t in range(min(len(js), len(ts))) if js[t] != ts[t])
            gap = _top2_gap(tp, prompts[i], ts, step)
            pytest.fail(f"request {i} diverges at token {step}: jax {js[step]} vs "
                        f"torch {ts[step]}; port's top-2 logit gap there {gap:.3g}")
        assert len(ts) == new[i]


def test_decode_host_sync_budget(tiny_trees):
    """One blocking device->host fetch per decode chunk (plus the stacked
    prefill first-token fetch); uploads only at composition changes: the
    prompt plus the three sampling arrays."""
    eng = ServingEngine(tl.llama_tiny(), tiny_trees["fp"][1], num_slots=2, max_seq_len=128,
                        decode_chunk=4, device="cpu")
    for prompt in (np.arange(1, 9, dtype=np.int32), np.arange(3, 17, dtype=np.int32)):
        base = dict(eng.sync_stats)
        req = eng.submit(prompt, SamplingParams(max_new_tokens=24))
        while not req.done.is_set():
            eng.step()
        d = {k: eng.sync_stats[k] - base[k] for k in base}
        assert len(req.generated) == 24
        assert d["chunks"] >= 5
        assert d["chunks"] - 1 <= d["fetches"] <= d["chunks"] + 1
        assert d["uploads"] == 4, d


def test_engine_without_device_raises_on_a_gpu_less_host(tiny_trees):
    assert not torch.cuda.is_available()
    with pytest.raises(NoGPUError, match="device='cpu'"):
        ServingEngine(tl.llama_tiny(), tiny_trees["fp"][1], num_slots=2)
    with pytest.raises(NoGPUError):
        ServingCell("tiny", num_slots=2)


def test_engine_stop_tokens_cancel_and_admission(tiny_trees):
    tp = tiny_trees["fp"][1]
    eng = ServingEngine(tl.llama_tiny(), tp, num_slots=1, max_seq_len=64,
                        decode_chunk=4, max_pending=2, device="cpu")
    prompt = np.arange(1, 6, dtype=np.int32)
    free = eng.generate(prompt, SamplingParams(max_new_tokens=6))
    assert len(free) == 6
    stop = free[2]
    got = eng.generate(prompt, SamplingParams(max_new_tokens=6, stop_tokens=(stop,)))
    assert got == free[:free.index(stop) + 1]
    a = eng.submit(prompt, SamplingParams(max_new_tokens=40))
    b = eng.submit(prompt, SamplingParams(max_new_tokens=40))
    with pytest.raises(RejectedError):
        eng.submit(prompt)
    assert eng.shed_stats["rejected"] == 1
    b.cancel()
    eng.step()
    assert b.done.is_set() and b.generated == []
    a.cancel()
    while not a.done.is_set():
        eng.step()
    assert len(a.generated) < 40
    with pytest.raises(ValueError):
        eng.submit(np.arange(64, dtype=np.int32))
    for bad in ([1, 512], [-1, 2]):        # vocab is 512
        with pytest.raises(ValueError, match="token ids"):
            eng.submit(np.asarray(bad, np.int32))
    assert bucket_length(65) == 128 and bucket_length(5000) == 8192


def test_engine_driver_thread_and_tokenizer_copy(tiny_trees):
    eng = ServingEngine(tl.llama_tiny(), tiny_trees["int8"][1], num_slots=2,
                        max_seq_len=64, decode_chunk=4, device="cpu")
    eng.start()
    try:
        outs = [None] * 3

        def run(i):
            outs[i] = eng.generate(np.arange(1, 4 + i, dtype=np.int32),
                                   SamplingParams(max_new_tokens=5))

        threads = [threading.Thread(target=run, args=(i,)) for i in range(3)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
            assert not t.is_alive()
    finally:
        eng.stop()
    assert [len(o) for o in outs] == [5, 5, 5]
    text = "héllo, kukeon"
    assert ByteTokenizer().encode(text) == JaxByteTokenizer().encode(text)
    assert ByteTokenizer().decode(ByteTokenizer().encode(text)) == text


# --- serving cell over HTTP --------------------------------------------------------


def _post(url, body):
    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, dict(r.headers), json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), json.loads(e.read())


def _get(url):
    try:
        with urllib.request.urlopen(url, timeout=30) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def test_serving_cell_http_generate_429_and_readyz():
    cell = ServingCell("tiny", num_slots=2, max_seq_len=64, decode_chunk=4,
                       max_pending=1, device="cpu")
    server = serve(cell)
    base = f"http://127.0.0.1:{server.server_address[1]}"
    try:
        assert _get(base + "/healthz")[0] == 200
        code, body = _get(base + "/readyz")
        assert code == 503 and body["reason"] == "warming up"
        code, _h, _b = _post(base + "/v1/generate", {"promptTokens": [1, 2, 3]})
        assert code == 503
        cell.warmup(8)
        cell.mark_ready()
        assert _get(base + "/readyz") == (200, {"ready": True})
        # Fill the one-deep queue while no driver runs: the next POST sheds.
        held = cell.engine.submit(np.arange(1, 5, dtype=np.int32),
                                  SamplingParams(max_new_tokens=2))
        code, headers, body = _post(base + "/v1/generate", {"promptTokens": [1, 2]})
        assert code == 429 and headers["Retry-After"] == "1", body
        cell.engine.start()
        held.done.wait(30)
        code, _h, body = _post(base + "/v1/generate",
                               {"prompt": "hi", "maxNewTokens": 7})
        assert code == 200, body
        assert body["numTokens"] == 7 and len(body["tokens"]) == 7
        assert 0 <= body["ttftSeconds"] <= body["seconds"]
        again = _post(base + "/v1/generate", {"prompt": "hi", "maxNewTokens": 7})[2]
        assert again["tokens"] == body["tokens"]
        assert _post(base + "/v1/generate", {"maxNewTokens": 2})[0] == 400
        stats = _get(base + "/v1/stats")[1]
        assert stats["rejected"] == 1 and stats["ready"] and stats["device"] == "cpu"
    finally:
        server.shutdown()
        cell.engine.stop()
