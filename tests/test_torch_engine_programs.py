"""The port's decode programs (``kukeon_tpu_torch/serving/programs.py``)
through its engine, on the CPU, where each program runs eagerly on the
same static buffers a CUDA graph reads on the GPU.

- ``precompile`` builds the reference's chunk set
  (``kukeon_tpu/serving/engine.py:1310-1314``) and nothing more;
- across prefills, inserts, chunks, releases, cancellations and the
  driver's error path, every static buffer keeps its storage;
- a churn mix (greedy and stochastic requests, arrivals while a chunk is
  in flight, cancellations, changed temperatures) builds each program
  once, and its greedy streams equal the JAX engine's, for ``tiny`` (int8
  weights and int8 KV) and ``mixtral-tiny``;
- a program run is undone by its snapshot (how a capture leaves the state
  as it found it).
"""

import threading

import jax
import numpy as np
import pytest
import torch

from kukeon_tpu.models import llama as jl
from kukeon_tpu.models import moe as jm
from kukeon_tpu.parallel import make_mesh, moe_specs_for_params
from kukeon_tpu.serving import ServingEngine as JaxEngine
from kukeon_tpu_torch.models import convert
from kukeon_tpu_torch.models import llama as tl
from kukeon_tpu_torch.models import moe as tm
from kukeon_tpu_torch.runtime.serving_cell import ServingCell
from kukeon_tpu_torch.serving import SamplingParams, ServingEngine

torch.set_num_threads(2)

FAMILIES = ("llama", "mixtral")


@pytest.fixture(scope="module")
def models():
    """family -> (jax engine kwargs, torch engine kwargs), int8 weights from
    one JAX tree each; the llama engines also keep an int8 KV cache."""
    out = {}
    jp = jl.quantize_params(jl.init_params(jax.random.key(0), jl.llama_tiny()))
    out["llama"] = (
        dict(cfg=jl.llama_tiny(), params=jp, kv_cache_int8=True),
        dict(cfg=tl.llama_tiny(), params=convert.params_from_numpy(
            jax.tree.map(np.asarray, jp), "cpu"), kv_cache_int8=True))
    jp = jm.quantize_params(jm.init_params(jax.random.key(0), jm.moe_tiny()))
    out["mixtral"] = (
        dict(cfg=jm.moe_tiny(), params=jp, forward_fn=jm.forward,
             param_specs=moe_specs_for_params(jp)),
        dict(cfg=tm.moe_tiny(), params=convert.params_from_numpy(
            jax.tree.map(np.asarray, jp), "cpu"), forward_fn=tm.forward))
    return out


def _engine(models, family, **kw):
    tkw = dict(models[family][1])
    cfg, params = tkw.pop("cfg"), tkw.pop("params")
    return ServingEngine(cfg, params, device="cpu", **tkw, **kw)


def _reference_chunk_sizes(decode_chunk):
    """``kukeon_tpu/serving/engine.py:1310-1314``, restated."""
    sizes, size = {1, 4}, 1
    while size * 4 <= decode_chunk:
        size *= 4
        sizes.add(size)
    return sizes


def _pointers(eng):
    ptrs = {name: t.data_ptr() for name, t in eng.state.buffers().items()}
    ptrs.update({f"out{k}": eng._programs.output(k).data_ptr() for k in (1, 4)})
    return ptrs


def _drive(eng, reqs):
    while not all(r.done.is_set() for r in reqs):
        eng.step()


# Churn: (prompt length, sampling, arrives after this many steps,
# cancelled after this many steps or None). Three slots, so requests wait,
# and arrivals land while a chunk is in flight.
CHURN = (
    (7, dict(max_new_tokens=12), 0, None),
    (11, dict(max_new_tokens=10, temperature=0.9, top_k=20), 0, None),
    (5, dict(max_new_tokens=9, top_k=5), 0, None),         # temperature 0: greedy
    (23, dict(max_new_tokens=14), 2, None),
    (9, dict(max_new_tokens=6, temperature=0.7, top_p=0.8), 2, None),
    (13, dict(max_new_tokens=30), 2, 4),                    # cancelled mid-stream
    (6, dict(max_new_tokens=8), 5, None),
    (17, dict(max_new_tokens=7, temperature=1.3), 5, None),  # no filter
    (4, dict(max_new_tokens=5), 5, 5),                      # cancelled while queued
)


def _churn_prompts(seed=3):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, 512, n).astype(np.int32) for n, *_ in CHURN]


def _run_churn(eng, prompts):
    """Drive the CHURN mix through ``eng`` step by step -> its requests."""
    reqs = [None] * len(CHURN)
    step = 0
    while step < 8 or not all(r is not None and r.done.is_set() for r in reqs):
        for i, (_n, sp, at, cancel_at) in enumerate(CHURN):
            if at == step:
                reqs[i] = eng.submit(prompts[i], SamplingParams(**sp))
            if cancel_at == step:
                reqs[i].cancel()
        eng.step()
        step += 1
        assert step < 500
    return reqs


@pytest.mark.parametrize("decode_chunk", [1, 4, 8, 16])
def test_precompile_builds_the_reference_chunk_set(models, decode_chunk):
    eng = _engine(models, "llama", num_slots=2, max_seq_len=64, decode_chunk=decode_chunk)
    eng.precompile((8,))
    want = sorted((k, False, False) for k in _reference_chunk_sizes(decode_chunk))
    assert eng._programs.keys() == want
    assert eng.program_stats["captures"] == len(want)
    eng.precompile((8,))                                  # a second call builds nothing
    assert eng.program_stats["captures"] == len(want)
    eng.warmup(8)                                         # greedy traffic: no new key
    assert eng._programs.keys() == want and eng.program_stats["replays"] >= 1


@pytest.mark.parametrize("family", FAMILIES)
def test_churn_builds_each_program_once_and_keeps_static_buffers(models, family):
    eng = _engine(models, family, num_slots=3, max_seq_len=96, decode_chunk=4)
    state = eng.state
    ptrs = _pointers(eng)
    eng.precompile()
    greedy_keys = set(eng._programs.keys())
    prompts = _churn_prompts()
    first = _run_churn(eng, prompts)
    captures = eng.program_stats["captures"]
    keys = set(eng._programs.keys())
    stochastic = {k for k in keys if k[2]}
    assert keys == greedy_keys | stochastic and stochastic       # both stochastic branches
    assert {k[1] for k in stochastic} == {False, True}
    assert all(not k[1] for k in greedy_keys)     # greedy mixes never filter, top_k or not
    assert first[-1].generated == [] and first[5].cancelled
    second = _run_churn(eng, prompts)
    assert eng.program_stats["captures"] == captures, "a program was built twice"
    assert eng._programs.keys() == sorted(keys)
    assert eng.state is state and eng._programs.state is state
    assert _pointers(eng) == ptrs
    # The same greedy prompts give the same streams on the second round.
    for i, (_n, sp, _at, cancel_at) in enumerate(CHURN):
        if sp.get("temperature", 0) == 0 and cancel_at is None:
            assert second[i].generated == first[i].generated, i
            assert len(first[i].generated) == sp["max_new_tokens"]


@pytest.mark.parametrize("family", FAMILIES)
def test_greedy_streams_through_programs_match_jax_under_churn(models, family):
    """A greedy request's stream depends on its prompt alone (rows are
    independent at decode, MoE capacity is full), so the JAX engine runs
    the greedy prompts plainly and the port's engine under the churn."""
    prompts = _churn_prompts()
    teng = _engine(models, family, num_slots=3, max_seq_len=96, decode_chunk=4)
    teng.precompile()
    treqs = _run_churn(teng, prompts)
    greedy = [i for i, (_n, sp, *_r) in enumerate(CHURN) if sp.get("temperature", 0) == 0]
    jkw = dict(models[family][0])
    jeng = JaxEngine(jkw.pop("cfg"), jkw.pop("params"),
                     make_mesh(tensor=1, devices=jax.devices()[:1]),
                     num_slots=3, max_seq_len=96, decode_chunk=4, **jkw)
    jreqs = [jeng.submit(prompts[i], SamplingParams(max_new_tokens=CHURN[i][1]["max_new_tokens"]))
             for i in greedy]
    _drive(jeng, jreqs)
    for i, jr in zip(greedy, jreqs):
        got, want = treqs[i].generated, list(jr.generated)
        if CHURN[i][3] is None:
            assert got == want, f"request {i}: port {got} vs jax {want}"
        else:
            assert got == want[:len(got)], f"cancelled request {i}: port {got} vs jax {want}"
    for i, (_n, sp, _at, cancel_at) in enumerate(CHURN):
        if sp.get("temperature", 0) > 0:
            r = treqs[i]
            assert len(r.generated) == sp["max_new_tokens"] and r.error is None
            assert all(0 <= t < 512 for t in r.generated)


@pytest.mark.parametrize("family", FAMILIES)
def test_snapshot_undoes_a_program_run(models, family):
    """What a capture relies on to leave the state as it found it: the
    snapshot of a k-step program covers every buffer the run writes."""
    eng = _engine(models, family, num_slots=3, max_seq_len=40, decode_chunk=4)
    rng = np.random.default_rng(5)
    reqs = [eng.submit(rng.integers(1, 512, n).astype(np.int32), SamplingParams(max_new_tokens=50))
            for n in (5, 33, 12)]
    eng.step()
    eng.step()
    reqs[2].cancel()
    eng.step()                   # one inactive slot; slot 1 near the end of its cache
    progs, st = eng._programs, eng.state
    st.temps.fill_(0.8)
    st.top_ks.fill_(7)
    key = (4, True, True)
    before = {n: t.clone() for n, t in st.buffers().items()}
    out_before = progs.output(4).clone()
    snap = progs.snapshot(4)
    first = progs.run_eager(key).clone()
    assert not torch.equal(st.cache.lengths, before["lengths"])
    progs.restore(snap)
    for n, t in st.buffers().items():
        assert torch.equal(t, before[n]), n
    assert torch.equal(progs.output(4), out_before)
    again = progs.run_eager(key)             # the generator state came back too
    assert torch.equal(again, first)
    progs.restore(snap)
    for r in reqs:
        r.cancel()
    _drive(eng, reqs)


def test_stochastic_sync_budget(models):
    """The program path keeps one blocking fetch per chunk and four uploads
    per composition change with a stochastic request, as with greedy ones
    (``test_torch_engine.py::test_decode_host_sync_budget``)."""
    eng = _engine(models, "llama", num_slots=2, max_seq_len=128, decode_chunk=4)
    base = dict(eng.sync_stats)
    req = eng.submit(np.arange(1, 9, dtype=np.int32),
                     SamplingParams(max_new_tokens=24, temperature=0.8, top_p=0.9))
    _drive(eng, [req])
    d = {k: eng.sync_stats[k] - base[k] for k in base}
    assert len(req.generated) == 24 and d["chunks"] >= 5
    assert d["chunks"] - 1 <= d["fetches"] <= d["chunks"] + 1
    assert d["uploads"] == 4, d
    assert eng._programs.keys() == [(4, True, True)]


def test_error_path_resets_static_buffers_in_place(models):
    prompt = np.arange(2, 13, dtype=np.int32)
    want = _engine(models, "llama", num_slots=2, max_seq_len=64,
                   decode_chunk=4).generate(prompt, SamplingParams(max_new_tokens=9))
    eng = _engine(models, "llama", num_slots=2, max_seq_len=64, decode_chunk=4)
    eng.precompile()
    ptrs = _pointers(eng)
    real, calls = eng._programs.run, {"n": 0}

    def failing_once(key):
        calls["n"] += 1
        if calls["n"] == 2:
            raise RuntimeError("injected decode fault")
        return real(key)

    eng._programs.run = failing_once
    eng.start()
    try:
        doomed = eng.submit(np.arange(1, 20, dtype=np.int32), SamplingParams(max_new_tokens=30))
        assert doomed.done.wait(60)
        assert isinstance(doomed.error, RuntimeError) and "injected" in str(doomed.error)
        assert not bool(eng.state.active.any()) and int(eng.state.cache.lengths.sum()) == 0
        assert _pointers(eng) == ptrs
        out = [None]

        def run():
            out[0] = eng.generate(prompt, SamplingParams(max_new_tokens=9))

        t = threading.Thread(target=run)
        t.start()
        t.join(timeout=60)
        assert not t.is_alive()
    finally:
        eng.stop()
    assert out[0] == want
    assert _pointers(eng) == ptrs


def test_precompile_refuses_a_running_driver(models):
    eng = _engine(models, "llama", num_slots=1, max_seq_len=32, decode_chunk=4)
    eng.start()
    try:
        with pytest.raises(RuntimeError, match="before start"):
            eng.precompile()
    finally:
        eng.stop()


def test_cell_warmup_captures_before_readiness():
    cell = ServingCell("mixtral-tiny", dtype="int8", num_slots=2, max_seq_len=64,
                       decode_chunk=16, device="cpu")
    assert cell.readiness() == (False, "warming up")
    cell.warmup(8)
    stats = cell.stats()
    assert stats["decodePrograms"]["captures"] == 3          # chunk sizes 1, 4, 16
    assert stats["decodePrograms"]["replays"] >= 1
    assert set(stats["bootSeconds"]) == {"precompile", "warmup"}
    assert not stats["ready"]
    cell.mark_ready()
    assert cell.readiness() == (True, None)
