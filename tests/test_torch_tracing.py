"""Distributed tracing on the port (``kukeon_tpu_torch/obs/trace.py`` and
the engine's and cell's spans) against the reference
(``kukeon_tpu/obs/trace.py``, ``tests/test_tracing.py``), on the CPU:

- ``traceparent`` parsing and formatting, the tracer's ring and phases,
  and the tail sampler (``KUKEON_TRACE_SAMPLE``), each verdict equal to
  the reference's for the same trace id;
- the port engine's span joins a propagated context and puts its trace
  id on the TTFT and e2e exemplars; a shed span joins the caller's trace;
  a preempted request keeps one continuous span;
- port cells behind the reference's ``GatewayCell``: the gateway's
  ``traceparent`` reaches the port engine, ``daemon.fetch_traces`` joins
  the gateway's span and the port cell's under one trace id (a KV handoff
  too: the prefill and decode cells' spans), ``daemon.fetch_timelines``
  tags the port cell's steps, and ``finish_boot`` leaves the boot span
  and the cold-start gauges.
"""

import http.client
import json
import pathlib
import re
import threading
import time
from http.server import ThreadingHTTPServer

import numpy as np
import pytest
import torch
from test_torch_disagg import _make_stack, _teardown

from kukeon_tpu import obs as jobs
from kukeon_tpu.obs import federate as fed
from kukeon_tpu.obs import trace as jtrace
from kukeon_tpu.runtime import daemon
from kukeon_tpu.runtime.cli import render_trace
from kukeon_tpu_torch import obs as tobs
from kukeon_tpu_torch.models import llama as tl
from kukeon_tpu_torch.obs import trace as ttrace
from kukeon_tpu_torch.runtime.serving_cell import ServingCell, make_handler
from kukeon_tpu_torch.serving import SamplingParams, ServingEngine
from kukeon_tpu_torch.serving.engine import RejectedError

torch.set_num_threads(2)

PROMPT = np.arange(1, 9, dtype=np.int32)
ROOT = pathlib.Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def params():
    g = torch.Generator().manual_seed(0)
    return tl.init_params(tl.llama_tiny(), g, "cpu")


def _engine(params, **kw):
    kw = {"num_slots": 1, "max_seq_len": 96, "decode_chunk": 4, **kw}
    return ServingEngine(tl.llama_tiny(), params, device="cpu", **kw)


def _drive(eng, reqs):
    while not all(r.done.is_set() for r in reqs):
        eng.step()


def _wait_spans(tracer, trace_id, n=1, timeout=10.0):
    """The engine's span reaches the ring just after its terminal token."""
    deadline = time.monotonic() + timeout
    spans = tracer.for_trace(trace_id)
    while len(spans) < n and time.monotonic() < deadline:
        time.sleep(0.01)
        spans = tracer.for_trace(trace_id)
    return spans


def _wait_gateway_span(tracer, route, timeout=10.0):
    """The gateway finishes its span only after it writes the response,
    so the client can read the response before the span is in the ring."""
    deadline = time.monotonic() + timeout
    while True:
        span = next((s for s in tracer.recent(10) if s["component"] == "gateway"
                     and s.get("attrs", {}).get("route") == route), None)
        if span is not None or time.monotonic() >= deadline:
            assert span is not None, f"no gateway span for {route} within {timeout} s"
            return span
        time.sleep(0.01)


# --- context plumbing and the tracer ---------------------------------------------


def test_traceparent_roundtrip_and_rejects_garbage():
    tid, sid = tobs.new_trace_id(), tobs.new_span_id()
    assert len(tid) == 32 and len(sid) == 16
    header = tobs.format_traceparent(tid, sid)
    assert header == jobs.format_traceparent(tid, sid)
    ctx = tobs.parse_traceparent(header)
    assert (ctx.trace_id, ctx.span_id) == (tid, sid)
    assert tobs.TRACEPARENT_HEADER == jobs.TRACEPARENT_HEADER == "traceparent"
    for bad in (None, "", "junk", "00-short-deadbeef00000000-01",
                "00-" + "g" * 32 + "-" + "0" * 16 + "-01",
                "00-" + "0" * 32 + "-" + "1" * 16 + "-01",
                header + "-extra"):
        assert tobs.parse_traceparent(bad) is None is jobs.parse_traceparent(bad), bad
    assert tobs.PHASES == jobs.PHASES


def test_span_joins_context_and_mints_when_absent():
    t = tobs.Tracer()
    ctx = ttrace.TraceContext(trace_id=tobs.new_trace_id(), span_id=tobs.new_span_id())
    child = t.begin(1, 4, trace_ctx=ctx)
    assert child.trace_id == ctx.trace_id and child.parent_span_id == ctx.span_id
    assert child.span_id != ctx.span_id
    root = t.begin(2, 4)
    assert len(root.trace_id) == 32 and root.parent_span_id is None
    d = t.finish(child, "ok").to_dict()
    assert (d["traceId"], d["parentSpanId"], d["spanId"]) == \
        (ctx.trace_id, ctx.span_id, child.span_id)


def test_tracer_ring_buffer_bounded_and_phases_partition_e2e():
    t = tobs.Tracer(capacity=3)
    for i in range(10):
        t.finish(t.begin(i, 1), "ok")
    assert [s["requestId"] for s in t.recent(100)] == [9, 8, 7]
    t = tobs.Tracer()
    s = t.begin(7, 16)
    s.event("admitted")
    time.sleep(0.01)
    s.event("prefill_dispatched")
    s.event("first_token")
    time.sleep(0.005)
    t.finish(s, "ok", tokens=3)
    d = t.recent(1)[0]
    assert d["outcome"] == "ok" and d["tokens"] == 3
    assert set(d["phasesS"]) == {"queued", "prefill_dispatch", "prefill_wait", "decode"}
    assert abs(sum(d["phasesS"].values()) - d["e2eS"]) < 1e-3


def _span_with_e2e(t, rid: int, e2e_s: float, **kw):
    return t.begin(rid, 4, start_mono=time.monotonic() - e2e_s, **kw)


def test_tail_sampler_flood_keeps_what_matters():
    """With keep-probability 0 the sampler keeps every error, timeout,
    preempted and retried span and the slow tail, and drops every boring
    fast one (the reference's acceptance test)."""
    t = tobs.Tracer(capacity=2048, keep_probability=0.0)
    boring = [t.finish(_span_with_e2e(t, i, 0.04), "ok") for i in range(300)]
    errors = [t.finish(_span_with_e2e(t, 1000 + i, 0.04), "error") for i in range(40)]
    timeouts = [t.finish(_span_with_e2e(t, 2000 + i, 0.04), "timeout") for i in range(40)]
    preempted, retried = [], []
    for i in range(40):
        s = _span_with_e2e(t, 3000 + i, 0.04)
        s.event("preempted")
        preempted.append(t.finish(s, "ok"))
    for i in range(40):
        s = _span_with_e2e(t, 4000 + i, 0.04)
        s.attrs["retries"] = 1
        retried.append(t.finish(s, "ok"))
    slow = t.finish(_span_with_e2e(t, 9999, 10.0), "ok")
    kept = {d["spanId"] for d in t.recent(4096)}
    for group in (errors, timeouts, preempted, retried):
        assert all(s.span_id in kept for s in group)
    assert slow.span_id in kept and not any(s.span_id in kept for s in boring)
    assert t.sample_stats == {"kept": 161, "dropped": len(boring)}


def test_tail_sampler_default_and_env(monkeypatch):
    t = tobs.Tracer(capacity=64)
    for i in range(10):
        t.finish(_span_with_e2e(t, i, 0.0006), "ok")
    assert len(t) == 10 and t.sample_stats["dropped"] == 0
    monkeypatch.setenv(ttrace.TRACE_SAMPLE_ENV, "0.25")
    assert tobs.Tracer().keep_probability == 0.25
    monkeypatch.setenv(ttrace.TRACE_SAMPLE_ENV, "junk")
    assert tobs.Tracer().keep_probability == 1.0


def test_tail_sampler_verdict_matches_the_reference_per_trace():
    """Every component of one trace reaches one verdict: the port's tracer
    and the reference's keep or drop the same trace ids."""
    tp, tj = tobs.Tracer(keep_probability=0.5), jobs.Tracer(keep_probability=0.5)
    verdicts = []
    for i in range(64):
        tid = tobs.new_trace_id()
        tp.finish(tp.begin(i, 1, trace_ctx=ttrace.TraceContext(tid, tobs.new_span_id())), "ok")
        tj.finish(tj.begin(i, 1, trace_ctx=jtrace.TraceContext(tid, jobs.new_span_id())), "ok")
        verdicts.append((bool(tp.for_trace(tid)), bool(tj.for_trace(tid))))
    assert all(a == b for a, b in verdicts)
    assert tp.sample_stats == tj.sample_stats


def test_every_span_event_of_the_port_is_a_declared_phase():
    """Each ``.event("x")`` literal in the port's code names a phase of
    ``PHASES`` (the reference's lint rule KUKE010, as a test)."""
    used = {m for f in (ROOT / "kukeon_tpu_torch").rglob("*.py")
            for m in re.findall(r'\.event\(\s*"([^"]+)"', f.read_text())}
    assert {"admitted", "prefill_dispatched", "first_token", "preempted", "kv_exported",
            "kv_imported", "boot_imports", "boot_warmup"} <= used
    assert used <= set(tobs.PHASES), used - set(tobs.PHASES)


# --- the port engine's spans ---------------------------------------------------


def test_engine_span_joins_propagated_context_and_attaches_exemplars(params):
    eng = _engine(params)
    ctx = ttrace.TraceContext(trace_id=tobs.new_trace_id(), span_id=tobs.new_span_id())
    req = eng.submit(PROMPT, SamplingParams(max_new_tokens=4), trace_ctx=ctx)
    _drive(eng, [req])
    (span,) = eng.tracer.for_trace(ctx.trace_id)
    assert span["parentSpanId"] == ctx.span_id
    assert span["outcome"] == "ok" and span["tokens"] == 4 and span["decodeChunks"] >= 1
    assert [e["event"] for e in span["events"]] == [
        "submitted", "admitted", "prefill_dispatched", "first_token", "finished"]
    assert abs(sum(span["phasesS"].values()) - span["e2eS"]) < 1e-3
    for metric in ("kukeon_engine_ttft_seconds", "kukeon_engine_e2e_seconds"):
        assert ctx.trace_id in {tid for _v, tid in eng.registry.get(metric).exemplars().values()}
    fams = fed.parse(tobs.render(eng.registry))
    assert any(tid == ctx.trace_id
               for _n, _l, tid, _v in fams["kukeon_engine_ttft_seconds"].exemplars)
    kept = {lab["decision"]: float(v) for _n, lab, v in
            fams["kukeon_trace_tail_sampled_total"].samples}
    assert kept["kept"] >= 1


def test_engine_shed_span_joins_the_callers_trace(params):
    eng = _engine(params, max_pending=1)
    ctx = ttrace.TraceContext(trace_id=tobs.new_trace_id(), span_id=tobs.new_span_id())
    held = eng.submit(PROMPT, SamplingParams(max_new_tokens=2))
    with pytest.raises(RejectedError):
        eng.submit(PROMPT, SamplingParams(max_new_tokens=2), trace_ctx=ctx)
    spans = eng.tracer.for_trace(ctx.trace_id)
    assert [s["outcome"] for s in spans] == ["shed"]
    assert spans[0]["parentSpanId"] == ctx.span_id and spans[0]["requestId"] == -1
    held.cancel()
    _drive(eng, [held])
    assert eng.tracer.recent(1)[0]["outcome"] == "cancelled"


def test_preempt_resume_keeps_one_continuous_span(params, monkeypatch):
    """A preempted request (paged KV under pressure) keeps ONE span: its
    events hold the preemption and a second prefill, and the tail sampler
    keeps it even at keep-probability 0."""
    monkeypatch.setenv(ttrace.TRACE_SAMPLE_ENV, "0")
    eng = _engine(params, num_slots=3, max_seq_len=128, kv_page_tokens=16, kv_pool_pages=8,
                  prefix_cache_size=0)
    assert eng.tracer.keep_probability == 0.0
    sp = SamplingParams(max_new_tokens=40, temperature=0.8)
    reqs = [eng.submit(np.arange(1, 40, dtype=np.int32), sp) for _ in range(3)]
    for _ in range(800):
        if all(r.done.is_set() for r in reqs):
            break
        eng.step()
    assert all(r.done.is_set() and r.error is None for r in reqs)
    victims = [r for r in reqs if r.preemptions > 0]
    assert victims
    for r in victims:
        (span,) = eng.tracer.for_trace(r.trace.trace_id)
        events = [e["event"] for e in span["events"]]
        assert "preempted" in events and events.index("preempted") < len(events) - 1
        assert events.count("prefill_dispatched") >= 2 and events.count("admitted") >= 2
        assert events.count("first_token") == 1 and span["outcome"] == "ok"
    assert eng.registry.get("kukeon_preemptions_total").value(reason="kv_pressure") \
        == sum(r.preemptions for r in reqs)


# --- port cells behind the reference's gateway -----------------------------------


def _post(port, path, body, headers=None):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    conn.request("POST", path, body=json.dumps(body),
                 headers={"Content-Type": "application/json", **(headers or {})})
    resp = conn.getresponse()
    raw = resp.read()
    conn.close()
    return resp.status, raw


def test_fetch_traces_joins_the_gateway_and_the_port_cell_under_one_trace():
    """A client's traceparent through the reference's gateway reaches the
    port engine: the daemon's ``fetch_traces`` unions the gateway span and
    the port cell's engine span (its child) under the client's trace id,
    and ``fetch_timelines`` tags the cell's steps with it."""
    cells, servers, gw, gw_srv = _make_stack(("mixed",))
    tid, sid = tobs.new_trace_id(), tobs.new_span_id()
    try:
        status, raw = _post(gw_srv.server_address[1], "/v1/generate",
                            {"promptTokens": PROMPT.tolist(), "maxNewTokens": 3},
                            {"traceparent": jobs.format_traceparent(tid, sid)})
        assert status == 200 and json.loads(raw)["numTokens"] == 3
        assert _wait_spans(cells[0].engine.tracer, tid)
        cell_url = f"http://127.0.0.1:{servers[0].server_address[1]}"
        endpoints = [("default/default/default/llm", f"http://127.0.0.1:{gw_srv.server_address[1]}",
                      {}), ("default/default/default/llm/r0", cell_url, {})]
        spans = daemon.fetch_traces(endpoints, trace_id=tid, timeout_s=10.0)
        assert {s["component"] for s in spans} == {"gateway", "engine"}
        assert all(s["traceId"] == tid for s in spans)
        gspan = next(s for s in spans if s["component"] == "gateway")
        espan = next(s for s in spans if s["component"] == "engine")
        assert gspan["parentSpanId"] == sid and espan["parentSpanId"] == gspan["spanId"]
        assert espan["cell"] == "default/default/default/llm/r0" and espan["tokens"] == 3
        out = render_trace(tid, spans)
        assert "gateway" in out and "engine" in out and "3 tokens" in out
        steps = daemon.fetch_timelines(endpoints[1:], n=512, timeout_s=10.0)
        assert steps and all(s["cell"] == endpoints[1][0] for s in steps)
        assert any(tid in s["traces"] for s in steps)
        assert all(s["slots"] == 2 and "programs" in s for s in steps)
    finally:
        _teardown(cells, servers, gw, gw_srv)


def test_disagg_handoff_is_one_trace_with_both_hops():
    """The port of ``tests/test_disagg.py:253``: a request handed off from
    a port prefill cell to a port decode cell through the reference's
    gateway is ONE trace, the gateway span the parent of both cells'."""
    cells, servers, gw, gw_srv = _make_stack(("prefill", "decode"))
    try:
        body = {"promptTokens": list(range(1, 20)), "maxNewTokens": 6}
        ref = cells[1].generate(body)
        status, raw = _post(gw_srv.server_address[1], "/v1/generate",
                            {**body, "prefixId": "sess-1"})
        assert status == 200 and json.loads(raw)["tokens"] == ref["tokens"]
        gspan = _wait_gateway_span(gw.tracer, "/v1/generate")
        trace_id = gspan["traceId"]
        pspans = _wait_spans(cells[0].engine.tracer, trace_id)
        dspans = _wait_spans(cells[1].engine.tracer, trace_id)
        assert len(pspans) == 1 and len(dspans) == 1
        for espan in (pspans[0], dspans[0]):
            assert espan["parentSpanId"] == gspan["spanId"]
            assert abs(sum(espan["phasesS"].values()) - espan["e2eS"]) < 1e-3
        pev = [e for e in pspans[0]["events"]]
        assert [e["event"] for e in pev] == ["submitted", "admitted", "prefill_dispatched",
                                             "kv_exported", "finished"]
        assert pev[3]["attrs"]["bytes"] == 2 * 2 * 19 * 2 * 32 * 4     # K, V [L, 1, n, KV, D] f32
        dev = [e["event"] for e in dspans[0]["events"]]
        assert dev[:4] == ["submitted", "admitted", "kv_imported", "first_token"]
        hand = next(e for e in gspan["events"] if e["event"] == "kv_handoff")
        assert (hand["attrs"]["prefill"], hand["attrs"]["decode"]) == ("r0", "r1")
        assert "handoff r0->r1" in render_trace(trace_id, [gspan, pspans[0], dspans[0]])
    finally:
        _teardown(cells, servers, gw, gw_srv)


# --- the cell: streamed traceparent, boot span ----------------------------------


@pytest.fixture(scope="module")
def cell():
    c = ServingCell("tiny", num_slots=2, max_seq_len=96, max_pending=8, device="cpu",
                    decode_chunk=4)
    c.warmup(prompt_len=16)
    c.engine.start()
    c.mark_ready()
    server = ThreadingHTTPServer(("127.0.0.1", 0), make_handler(c))
    threading.Thread(target=server.serve_forever, daemon=True).start()
    yield c, server.server_address[1]
    server.shutdown()
    server.server_close()
    c.engine.stop()


def test_streamed_generate_reads_traceparent(cell):
    c, port = cell
    tid, sid = tobs.new_trace_id(), tobs.new_span_id()
    status, raw = _post(port, "/v1/generate",
                        {"promptTokens": PROMPT.tolist(), "maxNewTokens": 5, "stream": True},
                        {"traceparent": tobs.format_traceparent(tid, sid)})
    assert status == 200
    recs = [json.loads(x) for x in raw.splitlines() if x]
    assert recs[-1]["done"] and recs[-1]["numTokens"] == 5
    (span,) = _wait_spans(c.engine.tracer, tid)
    assert span["parentSpanId"] == sid and span["tokens"] == 5
    # A malformed header roots a fresh trace instead of failing the request.
    status, raw = _post(port, "/v1/generate", {"promptTokens": PROMPT.tolist(),
                                               "maxNewTokens": 2}, {"traceparent": "junk"})
    assert status == 200


def test_finish_boot_exports_phases_and_boot_span(cell):
    c, _port = cell
    phases = c.finish_boot()
    assert set(phases) >= {"imports", "init", "compile", "warmup", "serve"}
    assert all(v >= 0 for v in phases.values())
    reg = c.registry
    total = reg.get("kukeon_cold_start_seconds").value()
    assert total > 0 and abs(sum(phases.values()) - total) < 0.5
    assert reg.get("kukeon_cold_start_phase_seconds").value(phase="compile") == phases["compile"]
    boot = [s for s in c.engine.tracer.recent(50) if s["component"] == "boot"]
    assert boot and {"boot_imports", "boot_init", "boot_compile", "boot_warmup"} <= {
        e["event"] for e in boot[0]["events"]}
    fams = fed.parse(tobs.render(reg))
    assert {"imports", "init", "compile", "warmup", "serve"} <= {
        lab["phase"] for _n, lab, _v in fams["kukeon_cold_start_phase_seconds"].samples}
