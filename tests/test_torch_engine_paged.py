"""The port's paged KV engine against the JAX paged engine
(``kukeon_tpu/serving/engine.py`` ``decode_chunk_paged``, ``insert_paged``,
``gather_block``, ``_dispatch_prefill_paged``, ``_ensure_decode_pages``,
``_preempt_slot``), and against its own legacy layout, on the CPU, where
each paged program runs eagerly on the static buffers a CUDA graph reads
on the GPU.

- the same weights and agent traffic (a shared prefix under one
  ``prefixId``, prompts of several lengths, a pool small enough to
  preempt): token-for-token equal greedy streams, and equal prefix hits,
  misses and preemptions, for ``tiny`` f32 (full-precision KV), ``tiny``
  int8 weights with int8 KV, and ``mixtral-tiny`` int8;
- the port's paged engine streams its own legacy engine's tokens;
- a paged decode program and a paged prefill program are undone by their
  snapshots, and run again from one give the same pool rows (page 0
  aside), lengths and tokens; the static buffers keep their storage;
- the block table is uploaded only when a slot's pages changed;
- ``_chunk_size`` clamps to 4 while a preempted request waits and a slot
  is free; ``precompile`` captures the paged keys;
- the cell's ``kv_page_tokens`` and ``/v1/stats`` ``kvPages``.
"""

import jax
import numpy as np
import pytest
import torch
from test_torch_engine_programs import models  # noqa: F401 — fixture

from kukeon_tpu.models import llama as jl
from kukeon_tpu.parallel import make_mesh
from kukeon_tpu.serving import SamplingParams as JaxSamplingParams
from kukeon_tpu.serving import ServingEngine as JaxEngine
from kukeon_tpu_torch.models import convert
from kukeon_tpu_torch.models import llama as tl
from kukeon_tpu_torch.runtime.serving_cell import ServingCell
from kukeon_tpu_torch.serving import SamplingParams, ServingEngine
from kukeon_tpu_torch.serving.engine import Request
from kukeon_tpu_torch.serving.kv_pages import SCRATCH_PAGE
from kukeon_tpu_torch.serving.programs import program_key

torch.set_num_threads(2)

VARIANTS = ("f32", "int8_kv8", "mixtral")
PAGED = dict(num_slots=3, max_seq_len=128, decode_chunk=4, kv_page_tokens=16)


@pytest.fixture(scope="module")
def variants(models):  # noqa: F811 — the imported fixture
    jp = jl.init_params(jax.random.key(0), jl.llama_tiny())
    return {"f32": (dict(cfg=jl.llama_tiny(), params=jp),
                    dict(cfg=tl.llama_tiny(), params=convert.params_from_numpy(
                        jax.tree.map(np.asarray, jp), "cpu"))),
            "int8_kv8": models["llama"], "mixtral": models["mixtral"]}


def _jax(variants, name, **kw):
    jkw = dict(variants[name][0])
    return JaxEngine(jkw.pop("cfg"), jkw.pop("params"),
                     make_mesh(tensor=1, devices=jax.devices()[:1]), **jkw, **kw)


def _port(variants, name, **kw):
    tkw = dict(variants[name][1])
    return ServingEngine(tkw.pop("cfg"), tkw.pop("params"), device="cpu", **tkw, **kw)


def _agent_traffic(eng, sp_cls) -> dict:
    """Five requests on one 49-token prefix (``prefixId`` "agent") with
    tails of 3-7 tokens and 30-50 greedy tokens each, all queued at once."""
    prefix = np.arange(1, 50, dtype=np.int32)
    reqs = [eng.submit(np.concatenate([prefix, np.full((3 + i,), 100 + i, np.int32)]),
                       sp_cls(max_new_tokens=30 + 5 * i), prefix_id="agent")
            for i in range(5)]
    n = 0
    while not all(r.done.is_set() for r in reqs) and n < 2000:
        eng.step()
        n += 1
    assert all(r.done.is_set() and r.error is None for r in reqs)
    return {"streams": [list(r.generated) for r in reqs],
            "prefix": (eng.prefix_hits, eng.prefix_misses),
            "preemptions": [r.preemptions for r in reqs]}


@pytest.mark.parametrize("name", VARIANTS)
def test_paged_streams_hits_and_preemptions_equal_the_reference(variants, name):
    """A 9-page pool for three slots: requests are preempted and resumed,
    and hit the shared prefix pages, as in the JAX paged engine."""
    ref = _agent_traffic(_jax(variants, name, kv_pool_pages=9, **PAGED), JaxSamplingParams)
    eng = _port(variants, name, kv_pool_pages=9, **PAGED)
    port = _agent_traffic(eng, SamplingParams)
    assert sum(ref["preemptions"]) > 0 and ref["prefix"][0] > 0
    assert port == ref
    assert eng.preemptions == sum(port["preemptions"])
    assert eng._pool.in_use == eng._prefix_shared_pages()


@pytest.mark.parametrize("name", VARIANTS)
def test_paged_streams_equal_the_legacy_layout(variants, name):
    """The paged layout, preempting or not, is a layout change: the greedy
    streams equal the port's legacy engine's."""
    legacy = _agent_traffic(_port(variants, name, num_slots=3, max_seq_len=128,
                                  decode_chunk=4), SamplingParams)
    for pool in (9, 24):
        paged = _agent_traffic(_port(variants, name, kv_pool_pages=pool, **PAGED),
                               SamplingParams)
        assert paged["streams"] == legacy["streams"]
        assert (sum(paged["preemptions"]) > 0) == (pool == 9)


def _arm(eng, sp_cls) -> tuple:
    """``bench.py``'s paged arm (``:340-400``) at a quarter of its lengths
    (page 16, prefix 64, tails 8/96, 16/32 new tokens, max_seq_len 256),
    its 64-page pool holding 4 slots x 256 rows, each engine stepped as the
    bench steps it: three warm requests, then the 24. Every request takes
    the full-size arm's page counts. -> (streams, preemptions, peak pages
    in use)."""
    rng = np.random.default_rng(7)
    prefix = rng.integers(1, 512, 64).astype(np.int32)
    work = [(np.concatenate([prefix, rng.integers(1, 512, 96 if i % 2 else 8)
                             .astype(np.int32)]), 32 if i % 2 else 16) for i in range(24)]
    for p, n in work[:3]:
        r = eng.submit(p, sp_cls(max_new_tokens=n), prefix_id="agent")
        while not r.done.is_set():
            eng.step()
    base = eng.preemptions if hasattr(eng, "preemptions") else int(
        eng._m_preempt.value(reason="kv_pressure"))
    reqs = [eng.submit(p, sp_cls(max_new_tokens=n), prefix_id="agent") for p, n in work]
    peak = 0
    while not all(r.done.is_set() for r in reqs):
        eng.step()
        peak = max(peak, eng._pool.in_use)
    assert [len(r.generated) for r in reqs] == [n for _, n in work]
    now = eng.preemptions if hasattr(eng, "preemptions") else int(
        eng._m_preempt.value(reason="kv_pressure"))
    return [list(r.generated) for r in reqs], now - base, peak


@pytest.mark.parametrize("slots,preempts", [(12, False), (16, True)])
def test_bench_paged_arm_preempts_as_the_reference(variants, slots, preempts):
    """The reference's paged arm: at its 12 slots the pool peaks one page
    short of full and nothing is preempted, in both engines; 16 slots on
    the same pool preempt. Equal streams, preemptions and peaks."""
    kw = dict(num_slots=slots, max_seq_len=256, decode_chunk=4, kv_page_tokens=16,
              kv_pool_pages=64, prefill_buckets=(16, 32, 64, 128, 256))
    ref = _arm(_jax(variants, "f32", **kw), JaxSamplingParams)
    port = _arm(_port(variants, "f32", **kw), SamplingParams)
    assert port == ref
    assert (port[1] > 0) == preempts
    if not preempts:
        assert port[2] == 63


def _seat(eng, prompts, sp=None) -> list:
    reqs = [eng.submit(p, sp or SamplingParams(max_new_tokens=64)) for p in prompts]
    eng.step()
    eng.step()
    return reqs


def _state(eng) -> dict:
    st = eng.state
    pt = st.page_tokens
    out = {"lengths": st.cache.lengths.clone(), "tokens": st.tokens.clone(),
           "bt": st.bt.clone()}
    out.update({n: t[:, 1:].clone() for n, t in st.cache_rows().items()})   # page 0 aside
    assert pt and all(t.shape[2] == pt for t in st.cache_rows().values())
    return out


def _equal(a: dict, b: dict) -> list:
    return [n for n in a if not torch.equal(a[n], b[n])]


@pytest.mark.parametrize("name", ("int8_kv8", "mixtral"))
def test_paged_decode_program_is_undone_by_its_snapshot(variants, name):
    eng = _port(variants, name, kv_pool_pages=24, **PAGED)
    _seat(eng, [np.arange(1, 20 + 7 * i, dtype=np.int32) for i in range(2)])
    progs, key = eng._programs, program_key(4, False, False)
    before = _state(eng)
    snap = progs.snapshot(4)
    progs.run(key)
    runs = [(_state(eng), progs.written_rows(snap))]
    assert _equal(before, runs[0][0]), "the program wrote nothing"
    progs.restore(snap)
    assert not _equal(before, _state(eng))
    progs.run_eager(key)
    runs.append((_state(eng), progs.written_rows(snap)))
    assert not _equal(runs[0][0], runs[1][0]) and not _equal(runs[0][1], runs[1][1])
    advanced = runs[0][0]["lengths"] - before["lengths"]
    assert advanced.tolist() == [4, 4, 0]            # the free slot stays put
    progs.restore(snap)


def test_paged_prefill_programs_are_undone_by_their_snapshots(variants):
    """A cold paged prefill and a ``prefill_ext_paged`` over shared pages,
    staged for slot 1, each undone by its snapshot and equal on a rerun."""
    eng = _port(variants, "int8_kv8", kv_pool_pages=24, **PAGED)
    stored = np.arange(1, 40, dtype=np.int32)
    r = eng.submit(stored, SamplingParams(max_new_tokens=1), prefix_id="p")
    while not r.done.is_set():
        eng.step()
    progs = eng._prefill_programs
    cases = {"prefill_paged": (np.arange(3, 30, dtype=np.int32), None),
             "prefill_ext_paged": (np.concatenate([stored, np.arange(5, 15, dtype=np.int32)]),
                                   "p")}
    for kind, (prompt, pid) in cases.items():
        req = Request(-1, prompt, SamplingParams(), prefix_id=pid)
        cached = eng._prefix_lookup_paged(req, prompt)
        pages = (list(cached.pages) if cached else []) + eng._pool.alloc(
            prompt.size // 16 + 1 - (len(cached.pages) if cached else 0))
        key = eng._stage_prefill_paged(req, 1, prompt, cached, pages)
        assert key[0] == kind
        before = _state(eng)
        snap = progs.snapshot_key(key)
        runs = []
        for how in (progs.run, progs.run_eager):
            progs.restore(snap)
            how(key)
            runs.append(_state(eng))
        assert not _equal(runs[0], runs[1])
        assert int(runs[0]["lengths"][1]) == prompt.size
        assert _equal(before, runs[0])
        progs.restore(snap)
        assert not _equal(before, _state(eng))
        eng._pool.unref(pages[len(cached.pages) if cached else 0:])


def test_paged_buffers_keep_their_storage_and_the_table_uploads_when_dirty(variants):
    eng = _port(variants, "f32", kv_pool_pages=24, **PAGED)
    ptrs = {n: t.data_ptr() for n, t in eng.state.buffers().items()}
    assert {"bt", "view_k", "view_v"} <= set(ptrs)
    reqs = _seat(eng, [np.arange(1, 30, dtype=np.int32)], SamplingParams(max_new_tokens=40))
    uploads = []
    real = eng._upload

    def counting(x, into):
        uploads.append(into is eng.state.bt)
        return real(x, into)

    eng._upload = counting
    while not reqs[0].done.is_set():
        eng.step()
    # Chunks whose slots kept their pages upload no table: only page growth
    # (one page every 16 tokens) and the release make it dirty.
    assert 0 < sum(uploads) <= 4 and eng.sync_stats["chunks"] >= 8
    assert {n: t.data_ptr() for n, t in eng.state.buffers().items()} == ptrs
    # The released slot's row points at scratch, uploaded with the next chunk.
    assert (eng._bt == SCRATCH_PAGE).all() and eng._bt_dirty


def test_chunk_size_clamps_while_a_preempted_request_waits(variants):
    eng = _port(variants, "f32", kv_pool_pages=24, **PAGED)
    _seat(eng, [np.arange(1, 20, dtype=np.int32)])
    assert eng._chunk_size() == 4                     # decode_chunk 4
    eng.decode_chunk = 16
    assert eng._chunk_size() == 16
    eng._resume.append(Request(99, np.ones((3,), np.int32), SamplingParams()))
    assert eng._chunk_size() == 4 and eng.queue_depth == 1
    eng._resume.clear()


def test_precompile_captures_the_paged_keys(variants):
    eng = _port(variants, "f32", kv_pool_pages=24, **PAGED)
    eng.precompile((20, 100))
    assert eng._prefill_programs.keys() == [("prefill_paged", 64, False, False),
                                            ("prefill_paged", 128, False, False)]
    assert eng._programs.keys() == [(1, False, False), (4, False, False)]
    assert eng._pool.in_use == 0


@pytest.mark.parametrize("model", ("tiny", "mixtral-tiny"))
def test_cell_serves_paged_and_reports_kv_pages(model):
    cell = ServingCell(model, num_slots=2, max_seq_len=128, decode_chunk=4, device="cpu",
                       kv_page_tokens=16)
    legacy = ServingCell(model, num_slots=2, max_seq_len=128, decode_chunk=4, device="cpu")
    body = {"promptTokens": list(range(1, 40)), "maxNewTokens": 6}
    assert cell.generate(body)["tokens"] == legacy.generate(body)["tokens"]
    st = cell.stats()
    assert st["kvPageTokens"] == 16
    assert st["kvPages"]["total"] == 16 and st["kvPages"]["inUse"] == 0
    assert st["kvPages"]["preemptions"] == 0 and st["kvPages"]["shedKvExhausted"] == 0
    assert st["kvPages"]["viewBytes"] > 0
    assert legacy.stats()["kvPages"]["total"] == 0 and legacy.stats()["kvPageTokens"] == 0
