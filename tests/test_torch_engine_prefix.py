"""The port's prefix cache on the contiguous KV layout against the JAX
engine's (``kukeon_tpu/serving/engine.py`` ``_prefix_lookup``,
``_prefix_store``, ``_dispatch_prefill``), on the CPU: the ports of
``tests/test_serving.py``'s ``TestPrefixCache`` and
``test_prefix_cache_byte_budget_and_canonical_shapes``, each run through
both engines with the same weights.

- a hit (``prefill_ext`` over the new tail against the stored block)
  streams the JAX engine's greedy tokens and an uncached run's, for tiny
  f32, tiny int8 weights with an int8 KV cache, and ``mixtral-tiny``;
- a growing conversation misses on its first turn only; a mismatched
  prefix misses and is stored again; the entry-count LRU and the byte
  budget evict as the reference does, and an entry past the budget is
  never kept; stored blocks have the reference's canonical row counts;
- the serving cell passes ``prefixId`` through, answers 400 for one that
  is not a string, and reports ``prefixCache`` in ``/v1/stats``.
"""

import jax
import numpy as np
import pytest
import torch
from test_torch_engine import _get, _post
from test_torch_engine_programs import models  # noqa: F401 — fixture

from kukeon_tpu.models import llama as jl
from kukeon_tpu.parallel import make_mesh
from kukeon_tpu.serving import ServingEngine as JaxEngine
from kukeon_tpu_torch.models import convert
from kukeon_tpu_torch.models import llama as tl
from kukeon_tpu_torch.runtime.serving_cell import ServingCell, serve
from kukeon_tpu_torch.serving import PREFILL_BUCKETS, SamplingParams, ServingEngine

torch.set_num_threads(2)

VARIANTS = ("f32", "int8_kv8", "mixtral")


@pytest.fixture(scope="module")
def variants(models):  # noqa: F811 — the imported fixture
    """name -> (jax engine kwargs, torch engine kwargs): tiny f32, tiny
    int8 weights with int8 KV, and mixtral-tiny int8 weights."""
    jp = jl.init_params(jax.random.key(0), jl.llama_tiny())
    out = {"f32": (dict(cfg=jl.llama_tiny(), params=jp),
                   dict(cfg=tl.llama_tiny(), params=convert.params_from_numpy(
                       jax.tree.map(np.asarray, jp), "cpu")))}
    out["int8_kv8"] = models["llama"]
    out["mixtral"] = models["mixtral"]
    return out


def _pair(variants, name, **kw):
    """(jax engine, torch engine) over the same weights."""
    jkw, tkw = dict(variants[name][0]), dict(variants[name][1])
    jeng = JaxEngine(jkw.pop("cfg"), jkw.pop("params"),
                     make_mesh(tensor=1, devices=jax.devices()[:1]), decode_chunk=4, **jkw, **kw)
    teng = ServingEngine(tkw.pop("cfg"), tkw.pop("params"), device="cpu", decode_chunk=4,
                         **tkw, **kw)
    return jeng, teng


def _run(eng, prompt, sp, prefix_id=None) -> list[int]:
    r = eng.submit(prompt, sp, prefix_id=prefix_id)
    while not r.done.is_set():
        eng.step()
    assert r.error is None, r.error
    return list(r.generated)


def _counters(eng) -> tuple:
    return eng.prefix_hits, eng.prefix_misses, list(eng._prefix_cache)


@pytest.mark.parametrize("name", VARIANTS)
def test_hit_streams_the_reference_and_the_uncached_tokens(variants, name):
    """Suffix-only prefill over the stored prefix KV gives the same greedy
    continuation as a full prefill of the whole prompt, and as the JAX
    engine's hit."""
    system = np.arange(1, 70, dtype=np.int32) % 512            # 69 tokens
    turn1 = np.concatenate([system, np.array([7, 8, 9], np.int32)])
    sp = SamplingParams(max_new_tokens=6)
    got = {}
    for eng in _pair(variants, name, num_slots=2, max_seq_len=128):
        want = _run(eng, turn1, sp)                              # no prefix id
        _run(eng, system, sp, prefix_id="sess")                  # seeds the cache
        assert eng.prefix_misses == 1 and eng.prefix_hits == 0
        hit = _run(eng, turn1, sp, prefix_id="sess")
        assert eng.prefix_hits == 1
        assert hit == want, f"{type(eng).__module__}: hit {hit} vs uncached {want}"
        got[type(eng).__module__] = (hit, _counters(eng))
    (jax_hit, jax_counters), (port_hit, port_counters) = got.values()
    assert port_hit == jax_hit and port_counters == jax_counters


@pytest.mark.parametrize("name", ("f32", "mixtral"))
def test_growing_conversation_misses_only_its_first_turn(variants, name):
    """Each turn stores its whole prompt's KV again, so turn N + 1 hits on
    turn N's context; the turns stream the JAX engine's tokens."""
    sp = SamplingParams(max_new_tokens=4)
    streams = []
    for eng in _pair(variants, name, num_slots=2, max_seq_len=128):
        prompt = np.arange(1, 40, dtype=np.int32)
        turns = []
        for turn in range(3):
            turns.append(_run(eng, prompt, sp, prefix_id="chat"))
            prompt = np.concatenate([prompt, np.asarray(turns[-1], np.int32),
                                     np.array([11 + turn], np.int32)])
        assert (eng.prefix_misses, eng.prefix_hits) == (1, 2)
        streams.append(turns)
    assert streams[1] == streams[0]


def test_mismatched_prefix_misses_and_is_stored_again(variants):
    sp = SamplingParams(max_new_tokens=2)
    a = np.arange(1, 30, dtype=np.int32)
    b = np.arange(2, 40, dtype=np.int32)           # not an extension of a
    seen = []
    for eng in _pair(variants, "f32", num_slots=2, max_seq_len=128):
        streams = [_run(eng, p, sp, prefix_id="s") for p in (a, b)]
        assert (eng.prefix_hits, eng.prefix_misses) == (0, 2)
        # b is now the stored prefix: extending it hits.
        streams.append(_run(eng, np.concatenate([b, np.array([5], np.int32)]), sp,
                            prefix_id="s"))
        assert eng.prefix_hits == 1
        seen.append((streams, _counters(eng)))
    assert seen[1] == seen[0]


def test_lru_eviction_by_entry_count(variants):
    sp = SamplingParams(max_new_tokens=1)
    kept = []
    for eng in _pair(variants, "f32", num_slots=2, max_seq_len=128, prefix_cache_size=2):
        for name in ("a", "b", "c"):
            _run(eng, np.arange(1, 20, dtype=np.int32), sp, prefix_id=name)
        # A hit moves "b" to the end: the next store evicts "c".
        _run(eng, np.arange(1, 22, dtype=np.int32), sp, prefix_id="b")
        _run(eng, np.arange(1, 20, dtype=np.int32), sp, prefix_id="d")
        kept.append(_counters(eng))
    assert kept[1] == kept[0] and kept[0][2] == ["b", "d"]


def test_byte_budget_and_canonical_shapes(variants):
    """Stored blocks keep canonical bucket row counts (a grown turn's
    ``prefill_ext`` block is re-bucketed, not Pb + S), the byte budget
    evicts LRU-first, and an entry larger than the budget is not kept; the
    entry sizes and what is kept equal the JAX engine's."""
    sp = SamplingParams(max_new_tokens=2)
    prompt = np.arange(1, 70, dtype=np.int32)                    # bucket 128
    jeng, teng = _pair(variants, "f32", num_slots=2, max_seq_len=256)
    rows, nbytes = [], []
    for eng in (jeng, teng):
        gen = _run(eng, prompt, sp, prefix_id="a")
        first = eng._prefix_cache["a"]
        rows.append([first.kv_k.shape[2]])
        nbytes.append(first.nbytes)
        _run(eng, np.concatenate([prompt, np.asarray(gen, np.int32)]), sp, prefix_id="a")
        rows[-1].append(eng._prefix_cache["a"].kv_k.shape[2])
        assert eng.prefix_hits == 1
    assert rows[1] == rows[0] and nbytes[1] == nbytes[0]
    assert rows[1][0] in PREFILL_BUCKETS and rows[1][1] == 256      # min(bucket(128 + 64), 256)
    entry = nbytes[1]
    kept = []
    for budget in (entry, entry // 2):
        for eng in _pair(variants, "f32", num_slots=2, max_seq_len=256,
                         prefix_cache_bytes=budget):
            for name in ("x", "y"):
                _run(eng, prompt, sp, prefix_id=name)
            kept.append(list(eng._prefix_cache))
    assert kept == [["y"], ["y"], [], []]


def test_a_stored_entry_is_not_a_view_of_the_programs_buffers(variants):
    _jeng, teng = _pair(variants, "int8_kv8", num_slots=2, max_seq_len=128)
    prompt = np.arange(3, 50, dtype=np.int32)
    _run(teng, prompt, SamplingParams(max_new_tokens=2), prefix_id="p")
    e = teng._prefix_cache["p"]
    saved = e.kv_k.clone()
    progs = teng._prefill_programs
    for t in (e.kv_k, e.kv_v):
        assert t.untyped_storage().data_ptr() not in {
            b.untyped_storage().data_ptr() for b in progs.buffers().values()}
    _run(teng, np.arange(100, 190, dtype=np.int32), SamplingParams(max_new_tokens=2))
    assert torch.equal(e.kv_k, saved)


def test_cell_passes_prefix_id_refuses_a_non_string_and_reports_the_cache():
    cell = ServingCell("tiny", num_slots=2, max_seq_len=128, decode_chunk=4, device="cpu")
    cell.warmup(8)
    cell.engine.start()
    cell.mark_ready()
    server = serve(cell)
    base = f"http://127.0.0.1:{server.server_address[1]}"
    try:
        prompt = list(range(1, 40))
        code, _h, first = _post(base + "/v1/generate", {"promptTokens": prompt,
                                                        "maxNewTokens": 3, "prefixId": "s1"})
        assert code == 200, first
        grown = prompt + first["tokens"] + [9]
        code, _h, body = _post(base + "/v1/generate", {"promptTokens": grown,
                                                       "maxNewTokens": 3, "prefixId": "s1"})
        assert code == 200, body
        plain = _post(base + "/v1/generate", {"promptTokens": grown, "maxNewTokens": 3})[2]
        assert body["tokens"] == plain["tokens"]
        code, _h, body = _post(base + "/v1/generate", {"promptTokens": prompt,
                                                       "prefixId": 7})
        assert code == 400 and "prefixId must be a string" in body["error"]
        stats = _get(base + "/v1/stats")[1]
        assert stats["prefixCache"] == {"hits": 1, "misses": 1, "entries": 1}
        assert stats["prefillPrograms"]["capturesAfterWarmup"] >= 1      # the prefill_ext key
        assert stats["prefillPrograms"]["staticBytes"] > 0
    finally:
        server.shutdown()
        cell.engine.stop()
