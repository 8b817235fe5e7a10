"""The port's paged KV cache on the CPU: the ports of every test in
``tests/test_kv_pages.py`` (allocator books, paged-engine parity with the
legacy layout, page tiling, an overlong prompt, shared prefix pages,
preemption and its resume order, a deadline while parked, ``kv.alloc``
exhaustion with and without work in flight, and the driver's recovery),
run on ``kukeon_tpu_torch.serving`` with the port's own ``tiny`` weights.
The parity with the JAX paged engine is ``test_torch_engine_paged.py``'s.
"""

import os
import time

import numpy as np
import pytest
import torch

from kukeon_tpu_torch import faults
from kukeon_tpu_torch.models import llama as tl
from kukeon_tpu_torch.serving import RejectedError, SamplingParams, ServingEngine
from kukeon_tpu_torch.serving.kv_pages import (
    SCRATCH_PAGE,
    PageAllocator,
    PagePoolExhausted,
    pages_for,
)

torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def _port_faults():
    """The port keeps its own fault table: start and end each test unarmed."""
    os.environ.pop(faults.ENV, None)
    faults.reset()
    yield
    os.environ.pop(faults.ENV, None)
    faults.reset()


# --- allocator books ----------------------------------------------------------


class TestPageAllocator:
    def test_alloc_free_roundtrip(self):
        a = PageAllocator(8, 16)
        assert a.free == 8 and a.in_use == 0
        pages = a.alloc(3)
        assert len(pages) == 3 and len(set(pages)) == 3
        assert SCRATCH_PAGE not in pages
        assert a.free == 5 and a.in_use == 3
        assert all(a.refcount(p) == 1 for p in pages)
        assert a.unref(pages) == 3
        assert a.free == 8 and a.in_use == 0

    def test_refcounted_sharing(self):
        a = PageAllocator(4, 8)
        pages = a.alloc(2)
        a.ref(pages)
        assert all(a.refcount(p) == 2 for p in pages)
        assert a.unref(pages) == 0
        assert a.free == 2
        assert a.unref(pages) == 2
        assert a.free == 4

    def test_exhaustion_is_all_or_nothing(self):
        a = PageAllocator(4, 8)
        a.alloc(3)
        with pytest.raises(PagePoolExhausted):
            a.alloc(2)
        assert a.free == 1

    def test_freed_pages_reissue_fifo(self):
        a = PageAllocator(3, 8)
        first = a.alloc(2)
        a.unref([first[0]])
        assert a.alloc(1)[0] != first[0]

    def test_ref_unref_unallocated_fail_loudly(self):
        a = PageAllocator(2, 8)
        with pytest.raises(ValueError):
            a.ref([1])
        with pytest.raises(ValueError):
            a.unref([2])
        a.ref([SCRATCH_PAGE])
        a.unref([SCRATCH_PAGE])

    def test_pages_for(self):
        assert pages_for(0, 16) == 0
        assert pages_for(1, 16) == 1
        assert pages_for(16, 16) == 1
        assert pages_for(17, 16) == 2
        assert PageAllocator(4, 16).pages_for(33) == 3


# --- paged engine -------------------------------------------------------------

CFG = tl.llama_tiny()
PARAMS = tl.init_params(CFG, torch.Generator().manual_seed(0), "cpu")


def _make(**kw):
    kw.setdefault("num_slots", 2)
    kw.setdefault("max_seq_len", 128)
    kw.setdefault("decode_chunk", 4)
    return ServingEngine(CFG, PARAMS, device="cpu", **kw)


def _drive(eng, reqs, limit=800):
    n = 0
    while not all(r.done.is_set() for r in reqs) and n < limit:
        eng.step()
        n += 1


def test_paged_greedy_matches_legacy():
    """A pure layout change: greedy output equals the legacy engine's, and
    the pages free as the request finishes."""
    eng_p = _make(kv_page_tokens=16, kv_pool_pages=16)
    eng_l = _make()
    prompt = np.arange(1, 20, dtype=np.int32)
    sp = SamplingParams(max_new_tokens=8)
    assert eng_p.generate(prompt, sp) == eng_l.generate(prompt, sp)
    assert eng_p._pool.in_use == 0


def test_paged_page_size_must_tile():
    with pytest.raises(ValueError, match="max_seq_len"):
        _make(kv_page_tokens=48)                     # 128 % 48
    with pytest.raises(ValueError, match="bucket"):
        _make(kv_page_tokens=32, prefill_buckets=(48, 128))


def test_paged_overlong_prompt_fails_at_submit():
    eng = _make(kv_page_tokens=16, kv_pool_pages=4)
    with pytest.raises(ValueError, match="pool"):
        eng.submit(np.ones((100,), np.int32))        # 7 pages, the pool holds 4


def test_prefix_pages_shared_not_copied():
    """Sessions on one prefix pay its KV once: the second references the
    stored pages and gathers them for a tail-only prefill, with the tokens
    a cold prefill gives."""
    eng = _make(num_slots=4, kv_page_tokens=16, kv_pool_pages=32)
    prefix = np.arange(1, 65, dtype=np.int32)        # 4 full pages
    sp = SamplingParams(max_new_tokens=4)
    r1 = eng.submit(np.concatenate([prefix, np.array([70, 71], np.int32)]), sp,
                    prefix_id="agent")
    _drive(eng, [r1])
    assert eng.prefix_misses == 1
    entry = eng._prefix_cache["agent"]
    assert entry.length == 64 and len(entry.pages) == 4
    assert all(eng._pool.refcount(p) == 1 for p in entry.pages)
    assert eng._prefix_shared_pages() == 4
    r2 = eng.submit(np.concatenate([prefix, np.array([80, 81], np.int32)]), sp,
                    prefix_id="agent")
    _drive(eng, [r2])
    assert eng.prefix_hits == 1
    cold = _make(num_slots=4, kv_page_tokens=16, kv_pool_pages=32)
    assert r2.generated == cold.generate(np.concatenate([prefix, np.array([80, 81], np.int32)]),
                                         sp)
    assert eng._prefix_cache["agent"].length == 64  # a hit does not re-point the entry


def test_preemption_under_pressure_completes_everything():
    """A pool too small for every context forces preemption; every request
    still finishes with its full budget and the pool drains to zero."""
    eng = _make(num_slots=3, kv_page_tokens=16, kv_pool_pages=8, prefix_cache_size=0)
    sp = SamplingParams(max_new_tokens=40, temperature=0.8)
    reqs = [eng.submit(np.arange(1, 40, dtype=np.int32), sp) for _ in range(3)]
    _drive(eng, reqs)
    assert all(r.done.is_set() and r.error is None for r in reqs)
    assert all(len(r.generated) == 40 for r in reqs)
    assert eng.preemptions >= 1
    assert sum(r.preemptions for r in reqs) == eng.preemptions
    assert eng._pool.in_use == 0


def test_preempted_request_resumes_before_new_admissions():
    eng = _make(num_slots=2, kv_page_tokens=16, kv_pool_pages=6, prefill_buckets=(64,),
                prefix_cache_size=0)
    sp = SamplingParams(max_new_tokens=48, temperature=0.5)
    a = eng.submit(np.arange(1, 33, dtype=np.int32), sp)
    b = eng.submit(np.arange(1, 33, dtype=np.int32), sp)
    while not b.preemptions and not (a.done.is_set() and b.done.is_set()):
        eng.step()
    assert b.preemptions >= 1 and not b.done.is_set()
    assert b in eng._resume and eng.queue_depth >= 1
    c = eng.submit(np.arange(1, 9, dtype=np.int32), SamplingParams(max_new_tokens=4))
    while not b.done.is_set():
        eng.step()
        if eng._slot_req.count(None) < 2 and c.slot >= 0:
            assert b.slot >= 0 or b.done.is_set(), \
                "newly admitted request seated before the preempted one"
    _drive(eng, [c])
    assert b.error is None and len(b.generated) == 48
    assert c.error is None


def test_preempted_request_respects_deadline_while_parked():
    eng = _make(num_slots=2, kv_page_tokens=16, kv_pool_pages=6, prefill_buckets=(64,),
                prefix_cache_size=0)
    sp = SamplingParams(max_new_tokens=48, temperature=0.5)
    a = eng.submit(np.arange(1, 33, dtype=np.int32), sp)
    b = eng.submit(np.arange(1, 33, dtype=np.int32), sp, deadline_s=30.0)
    while not b.preemptions and not (a.done.is_set() and b.done.is_set()):
        eng.step()
    assert b.preemptions >= 1 and not b.done.is_set()
    b.deadline = time.monotonic() - 0.001
    _drive(eng, [b])
    assert b.timed_out and isinstance(b.error, Exception)
    _drive(eng, [a])
    assert a.error is None and len(a.generated) == 48


@pytest.mark.faults
def test_kv_alloc_exhaustion_sheds_never_deadlocks():
    """Injected exhaustion on an idle engine: nothing would ever free a
    page, so the request is shed (RejectedError, Retry-After) with its
    terminal event, and the engine serves on once disarmed."""
    eng = _make(kv_page_tokens=16, kv_pool_pages=16)
    os.environ[faults.ENV] = "kv.alloc:1"
    events = []
    req = eng.submit(np.arange(1, 9, dtype=np.int32), SamplingParams(max_new_tokens=4),
                     emit=lambda t, d: events.append((t, d)))
    for _ in range(10):
        eng.step()
        if req.done.is_set():
            break
    assert req.done.is_set()
    assert isinstance(req.error, RejectedError) and req.error.retry_after_s > 0
    assert events[-1] == (-1, True)
    assert eng.shed_stats["kv_exhausted"] == 1
    os.environ.pop(faults.ENV, None)
    faults.reset()
    assert len(eng.generate(np.arange(1, 9, dtype=np.int32),
                            SamplingParams(max_new_tokens=4))) == 4


@pytest.mark.faults
def test_kv_alloc_exhaustion_with_inflight_work_retries():
    """With work in flight, injected exhaustion parks the request: pages
    will free, and it completes."""
    eng = _make(kv_page_tokens=16, kv_pool_pages=16)
    sp = SamplingParams(max_new_tokens=12)
    a = eng.submit(np.arange(1, 9, dtype=np.int32), sp)
    eng.step()
    os.environ[faults.ENV] = "kv.alloc:1:1"          # fail exactly one alloc
    b = eng.submit(np.arange(1, 9, dtype=np.int32), sp)
    _drive(eng, [a, b], limit=200)
    assert faults.fired("kv.alloc") == 1
    assert a.error is None and b.error is None
    assert len(a.generated) == 12 and len(b.generated) == 12


@pytest.mark.faults
def test_paged_engine_loop_recovers_with_fresh_pool():
    """After a driver failure the pool, block table and prefix entries
    start over, and serving continues with the same tokens."""
    eng = _make(kv_page_tokens=16, kv_pool_pages=16)
    sp = SamplingParams(max_new_tokens=4)
    want = eng.generate(np.arange(1, 9, dtype=np.int32), sp)
    eng.start()
    try:
        os.environ[faults.ENV] = "engine.decode:1:1"
        req = eng.submit(np.arange(1, 9, dtype=np.int32), sp, prefix_id="s")
        assert req.done.wait(20)
        assert req.error is not None
        os.environ.pop(faults.ENV, None)
        faults.reset()
        req2 = eng.submit(np.arange(1, 9, dtype=np.int32), sp)
        assert req2.done.wait(30)
        assert req2.error is None and req2.generated == want
        assert eng._pool.in_use == 0
        assert not eng._prefix_cache
    finally:
        eng.stop()


@pytest.mark.faults
def test_cell_answers_429_when_the_pool_is_exhausted():
    """The cell maps the engine's KV-exhaustion shed to 429 with
    Retry-After, and serves on once pages can be had."""
    from test_torch_engine import _post

    from kukeon_tpu_torch.runtime.serving_cell import ServingCell, serve

    cell = ServingCell("tiny", num_slots=2, max_seq_len=128, decode_chunk=4, device="cpu",
                       kv_page_tokens=16)
    cell.engine.start()
    cell.mark_ready()
    server = serve(cell)
    url = f"http://127.0.0.1:{server.server_address[1]}/v1/generate"
    try:
        os.environ[faults.ENV] = "kv.alloc:1"      # every allocation fails
        code, headers, body = _post(url, {"promptTokens": [1, 2, 3], "maxNewTokens": 4})
        assert code == 429 and int(headers["Retry-After"]) >= 1
        assert "KV page pool exhausted" in body["error"]
        assert cell.stats()["kvPages"]["shedKvExhausted"] == 1
        os.environ.pop(faults.ENV)
        faults.reset()
        code, _, body = _post(url, {"promptTokens": [1, 2, 3], "maxNewTokens": 4})
        assert code == 200 and body["numTokens"] == 4
    finally:
        server.shutdown()
        server.server_close()
        cell.engine.stop()
