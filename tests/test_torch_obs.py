"""The port's observability layer (``kukeon_tpu_torch/obs``, the engine's
and the cell's instruments) against the reference's (``kukeon_tpu/obs``),
on the CPU:

- the same registry operations through both packages' registries render
  byte-equal exposition text (the port of
  ``tests/test_obs.py:173 test_exposition_golden_format``), and the other
  registry, exposition, percentile, scrape-hardening, device-memory and
  SLO tests of ``tests/test_obs.py``/``tests/test_obs_device.py`` hold for
  both packages' classes;
- the same traffic through the JAX engine and the port engine (``tiny``,
  the same weights; a shed, a queued deadline expiry, cancels, a prefix
  hit) gives the same families, types and label sets, equal request,
  token, shed and prefix-cache counters, equal histogram counts and the
  same span events per request;
- the compile counter stays flat across slot churn on both layouts;
- a port cell's ``/metrics`` parses under a flood, and the reference's
  unchanged consumers read it: ``kukeon_tpu.obs.federate.parse`` and the
  ``FleetScaler``'s queue-depth and burn-rate signals.
"""

import http.client
import json
import threading
import time
import urllib.request
from http.server import ThreadingHTTPServer

import jax
import numpy as np
import pytest
import torch
from test_obs import _parse_expo

from kukeon_tpu import obs as jobs
from kukeon_tpu.models import llama as jl
from kukeon_tpu.obs import federate as fed
from kukeon_tpu.parallel import make_mesh
from kukeon_tpu.serving import RejectedError as JaxRejected
from kukeon_tpu.serving import SamplingParams as JaxSamplingParams
from kukeon_tpu.serving import ServingEngine as JaxEngine
from kukeon_tpu_torch import faults
from kukeon_tpu_torch import obs as tobs
from kukeon_tpu_torch.models import convert
from kukeon_tpu_torch.models import llama as tl
from kukeon_tpu_torch.runtime.serving_cell import ServingCell, make_handler
from kukeon_tpu_torch.serving import SamplingParams, ServingEngine
from kukeon_tpu_torch.serving.engine import RejectedError

torch.set_num_threads(2)

PROMPT = np.arange(1, 9, dtype=np.int32)
PACKAGES = {"reference": jobs, "port": tobs}


@pytest.fixture(autouse=True)
def _port_faults():
    faults.reset()
    yield
    faults.reset()


@pytest.fixture(params=sorted(PACKAGES))
def pkg(request):
    """The obs package under test: each case holds for both."""
    return PACKAGES[request.param]


# --- registry and exposition: byte-equal to the reference --------------------


def _registry_ops(pkg):
    """One script of registry operations -> its registry: labelled
    counters with escapes, gauges set, moved and callable-backed,
    histograms with exemplars and an overflow, a collector family, a
    raising gauge callable and a raising collector."""
    reg = pkg.Registry()
    c = reg.counter("kukeon_g_total", "a counter", labels=("kind",))
    c.inc(kind='weird "value"\nwith escapes')
    c.inc(2.5, kind="plain")
    reg.counter("kukeon_g_plain_total", "no labels").inc(3)
    g = reg.gauge("kukeon_g_gauge", "a gauge")
    g.set(1.5)
    g.inc(2)
    g.dec(0.25)
    reg.gauge("kukeon_g_fn", "callable", labels=("slot",)).set_function(lambda: 7, slot="0")
    reg.gauge("kukeon_g_bad", "boom").set_function(lambda: 1 / 0)
    h = reg.histogram("kukeon_g_seconds", "a histogram")
    for v, ex in ((0.0001, None), (0.01, "ab" * 16), (1.0, None), (500.0, "cd" * 16)):
        h.observe(v, exemplar=ex)
    hl = reg.histogram("kukeon_g_lab_seconds", "labelled", labels=("bucket",))
    hl.observe(0.003, bucket="64")
    hl.observe(0.2, bucket="128", exemplar="ef" * 16)
    reg.histogram("kukeon_g_empty_seconds", "never observed")
    reg.register_collector(lambda: iter([
        ("kukeon_extra_total", "counter", "from a collector", [({"k": "v"}, 3.0)])]))

    def bad_collector():
        raise RuntimeError("collector died")
        yield  # pragma: no cover

    reg.register_collector(bad_collector)
    return reg


def test_exposition_is_byte_equal_to_the_reference():
    ref = jobs.render(_registry_ops(jobs))
    port = tobs.render(_registry_ops(tobs))
    assert port == ref
    # The golden parser of tests/test_obs.py accepts it.
    fams = _parse_expo(port)
    assert fams["kukeon_g_seconds"]["type"] == "histogram"
    assert "# EXEMPLAR kukeon_g_seconds_bucket" in port


def test_exposition_golden_format(pkg):
    reg = pkg.Registry()
    c = reg.counter("kukeon_g_total", "a counter", labels=("kind",))
    c.inc(kind='weird "value"\nwith escapes')
    reg.gauge("kukeon_g_gauge", "a gauge").set(1.5)
    h = reg.histogram("kukeon_g_seconds", "a histogram")
    for v in (0.0001, 0.01, 1.0, 500.0):
        h.observe(v)
    families = _parse_expo(pkg.render(reg))
    assert families["kukeon_g_total"]["type"] == "counter"
    assert families["kukeon_g_gauge"]["type"] == "gauge"
    assert families["kukeon_g_seconds"]["type"] == "histogram"
    (_n, labels, v), = families["kukeon_g_total"]["samples"]
    assert labels["kind"] == 'weird \\"value\\"\\nwith escapes'
    assert v == "1"
    hs = families["kukeon_g_seconds"]["samples"]
    buckets = [(lab["le"], float(val)) for n, lab, val in hs if n.endswith("_bucket")]
    assert buckets[-1][0] == "+Inf"
    values = [v for _le, v in buckets]
    assert values == sorted(values)
    count = next(float(v) for n, _l, v in hs if n.endswith("_count"))
    total = next(float(v) for n, _l, v in hs if n.endswith("_sum"))
    assert values[-1] == count == 4
    assert abs(total - 501.0101) < 1e-6
    finite = [float(le) for le, _v in buckets[:-1]]
    assert finite == sorted(finite) and len(set(finite)) == len(finite)


def test_counter_gauge_histogram_basics(pkg):
    reg = pkg.Registry()
    c = reg.counter("kukeon_t_total", "help", labels=("kind",))
    c.inc(kind="a")
    c.inc(2, kind="a")
    c.inc(kind="b")
    assert c.value(kind="a") == 3 and c.value(kind="b") == 1
    with pytest.raises(ValueError):
        c.inc(-1, kind="a")
    g = reg.gauge("kukeon_t_gauge", "g")
    g.set(5)
    g.dec(2)
    assert g.value() == 3
    g.set_function(lambda: 42)
    assert g.value() == 42
    h = reg.histogram("kukeon_t_seconds", "h")
    h.observe(0.001)
    counts, total, n = h.snapshot()
    assert n == 1 and abs(total - 0.001) < 1e-9 and sum(counts) == 1


def test_registry_get_or_create_is_idempotent_and_typed(pkg):
    reg = pkg.Registry()
    a = reg.counter("kukeon_same_total", "x")
    assert reg.counter("kukeon_same_total", "different help ignored") is a
    with pytest.raises(ValueError):
        reg.gauge("kukeon_same_total", "now a gauge?")
    with pytest.raises(ValueError):
        reg.counter("kukeon_same_total", "x", labels=("k",))


def test_histogram_percentiles_and_edges(pkg):
    reg = pkg.Registry()
    h = reg.histogram("kukeon_p_seconds", "p")
    assert h.percentile(0.5) is None and h.percentile(0.0) is None
    assert pkg.percentile_from_counts(h.buckets, [0] * (len(h.buckets) + 1), 0.99) is None
    for v in (0.001, 0.002, 0.004, 0.008, 0.016, 0.032):
        h.observe(v)
    assert 0.001 <= h.percentile(0.5) <= 0.008
    assert h.percentile(2.0) == h.percentile(1.0)
    assert h.percentile(-1.0) == h.percentile(0.0)
    h.observe(10_000.0)
    assert h.percentile(1.0) == h.buckets[-1]
    assert pkg.LATENCY_BUCKETS_S[0] <= 0.001
    assert tobs.LATENCY_BUCKETS_S == jobs.LATENCY_BUCKETS_S


def test_registry_hammer_counts_are_exact():
    """Eight threads hammering one registry: no lost increment."""
    reg = tobs.Registry()
    c = reg.counter("kukeon_hammer_total", "h", labels=("t",))
    h = reg.histogram("kukeon_hammer_seconds", "h")
    g = reg.gauge("kukeon_hammer_gauge", "h")
    n_threads, n_iter = 8, 2000

    def worker(tid: int):
        for i in range(n_iter):
            c.inc(t=str(tid % 2))
            h.observe(0.0001 * (i % 50))
            g.inc()

    threads = [threading.Thread(target=worker, args=(t,)) for t in range(n_threads)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    assert c.value(t="0") + c.value(t="1") == n_threads * n_iter
    counts, _total, n = h.snapshot()
    assert n == sum(counts) == n_threads * n_iter
    assert g.value() == n_threads * n_iter


def test_raising_callables_skip_their_samples_and_count(pkg):
    fams = _parse_expo(pkg.render(_registry_ops(pkg)))
    assert fams["kukeon_g_bad"]["samples"] == []
    assert "kukeon_extra_total" in fams
    errs = {lab["metric"] for _n, lab, _v in fams["kukeon_scrape_errors_total"]["samples"]}
    assert "kukeon_g_bad" in errs and any("bad_collector" in m for m in errs)


def test_every_port_fault_point_has_a_fired_counter():
    reg = tobs.Registry()
    reg.register_collector(tobs.faults_collector)
    seen = {lab["point"]: float(v) for _n, lab, v in
            _parse_expo(tobs.render(reg))["kukeon_faults_fired_total"]["samples"]}
    assert set(seen) == set(faults.POINTS) and not any(seen.values())
    import os

    os.environ[faults.ENV] = "engine.decode:1:2"
    try:
        for _ in range(2):
            with pytest.raises(faults.FaultInjected):
                faults.maybe_fail("engine.decode")
    finally:
        os.environ.pop(faults.ENV)
    seen = {lab["point"]: float(v) for _n, lab, v in
            _parse_expo(tobs.render(reg))["kukeon_faults_fired_total"]["samples"]}
    assert seen["engine.decode"] == 2


def test_device_memory_families_declared_on_the_cpu():
    """The three kukeon_hbm_bytes_* families are part of the schema on every
    device; a CPU engine contributes no samples (the reference's CPU
    backend alike)."""
    for pkg, collector in ((jobs, jobs.device_memory_collector),
                           (tobs, tobs.device_memory_collector(torch.device("cpu")))):
        reg = pkg.Registry()
        reg.register_collector(collector)
        fams = _parse_expo(pkg.render(reg))
        for name in ("kukeon_hbm_bytes_in_use", "kukeon_hbm_bytes_limit",
                     "kukeon_hbm_bytes_peak"):
            assert fams[name]["type"] == "gauge" and fams[name]["samples"] == [], name


# --- SLO burn rates ------------------------------------------------------------


def _slo_registry(pkg):
    reg = pkg.Registry()
    c = reg.counter("kukeon_engine_requests_total", "", labels=("outcome",))
    h = reg.histogram("kukeon_engine_ttft_seconds", "")
    return reg, c, h


def test_slo_burn_rates_windowed(pkg):
    clock = [0.0]
    reg, c, h = _slo_registry(pkg)
    tr = pkg.SloTracker(reg, pkg.SloObjectives(availability=0.99, ttft_p95_ms=100.0),
                        clock=lambda: clock[0])

    def collect():
        return {f[0]: f for f in tr.collect()}

    collect()
    for _ in range(100):
        c.inc(outcome="ok")
        h.observe(0.01)
    clock[0] = 10.0
    fams = collect()
    burns = {(lab["slo"], lab["window"]): v for lab, v in fams["kukeon_slo_burn_rate"][3]}
    assert burns[("availability", "5m")] == 0.0 and burns[("ttft_p95", "1h")] == 0.0
    clock[0] = 310.0
    for _ in range(8):
        c.inc(outcome="ok")
        h.observe(1.0)
    for _ in range(2):
        c.inc(outcome="error")
    fams = collect()
    burns = {(lab["slo"], lab["window"]): v for lab, v in fams["kukeon_slo_burn_rate"][3]}
    assert abs(burns[("availability", "5m")] - 20.0) < 1e-6
    assert 0 < burns[("availability", "1h")] < burns[("availability", "5m")]
    assert burns[("ttft_p95", "5m")] > 1.0
    remaining = {lab["slo"]: v for lab, v in fams["kukeon_slo_error_budget_remaining"][3]}
    assert remaining["availability"] == 0.0


def test_slo_no_traffic_is_clean(pkg):
    reg, _c, _h = _slo_registry(pkg)
    fams = {f[0]: f for f in pkg.SloTracker(reg, clock=lambda: 0.0).collect()}
    assert all(v == 0.0 for _l, v in fams["kukeon_slo_burn_rate"][3])
    assert all(v == 1.0 for _l, v in fams["kukeon_slo_error_budget_remaining"][3])


# --- the same traffic through both engines -------------------------------------


@pytest.fixture(scope="module")
def tiny():
    jp = jl.init_params(jax.random.key(0), jl.llama_tiny())
    return jp, convert.params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")


ENGINE = dict(num_slots=2, max_seq_len=96, decode_chunk=4, max_pending=2)


def _traffic(eng, sp_cls, rejected) -> list:
    """One script driven by hand: two requests (one opening a prefix
    session) and a shed at the queue bound, a prefix hit, then two hogs
    seat both slots, a queued request's deadline passes, and the hogs are
    cancelled. Returns the requests in submission order."""

    def drive(reqs):
        while not all(r.done.is_set() for r in reqs):
            eng.step()

    a = eng.submit(PROMPT, sp_cls(max_new_tokens=5), prefix_id="sess")
    b = eng.submit(PROMPT[:5], sp_cls(max_new_tokens=3))
    with pytest.raises(rejected):
        eng.submit(PROMPT, sp_cls(max_new_tokens=2))
    drive([a, b])
    d = eng.submit(np.concatenate([PROMPT, np.array([40, 41, 42, 43], np.int32)]),
                   sp_cls(max_new_tokens=4), prefix_id="sess")
    drive([d])
    hogs = [eng.submit(PROMPT[2:], sp_cls(max_new_tokens=40)),
            eng.submit(PROMPT[1:], sp_cls(max_new_tokens=40))]
    eng.step()
    victim = eng.submit(PROMPT, sp_cls(max_new_tokens=4), deadline_s=0.01)
    time.sleep(0.05)
    eng.step()
    assert victim.done.is_set() and victim.timed_out
    for h in hogs:
        h.cancel()
    drive(hogs)
    return [a, b, d, *hogs, victim]


def _families(text: str) -> dict:
    """{family: (type, {label names}, {label sets})} of a scrape."""
    out = {}
    for name, fam in fed.parse(text).items():
        labels = [frozenset((k, v) for k, v in lab.items() if k != "le")
                  for _n, lab, _v in fam.samples]
        out[name] = (fam.kind, {frozenset(k for k, _v in s) for s in labels}, set(labels))
    return out


@pytest.fixture(scope="module")
def both_engines(tiny):
    jp, tp = tiny
    jeng = JaxEngine(jl.llama_tiny(), jp, make_mesh(tensor=1, devices=jax.devices()[:1]),
                     **ENGINE)
    teng = ServingEngine(tl.llama_tiny(), tp, device="cpu", **ENGINE)
    for eng in (jeng, teng):
        eng.precompile((8,))
    jreqs = _traffic(jeng, JaxSamplingParams, JaxRejected)
    treqs = _traffic(teng, SamplingParams, RejectedError)
    return jeng, jreqs, teng, treqs


def test_engine_families_types_and_label_sets_match_the_reference(both_engines):
    jeng, _jr, teng, _tr = both_engines
    ref, port = _families(jobs.render(jeng.registry)), _families(tobs.render(teng.registry))
    assert {n: t for n, (t, _k, _s) in port.items()} == {n: t for n, (t, _k, _s) in ref.items()}
    for name, (_t, keys, sets) in port.items():
        rkeys, rsets = ref[name][1], ref[name][2]
        if keys and rkeys:
            assert keys == rkeys, name
        if name.startswith(("kukeon_compile", "kukeon_program")):
            # The port's fused programs: a subset of the reference's labels.
            assert sets <= rsets, (name, sets, rsets)
        elif name == "kukeon_faults_fired_total":
            assert sets <= rsets, name                  # the port's points: a subset
        elif name.startswith("kukeon_hbm") or name.startswith("kukeon_program"):
            continue
        else:
            assert sets == rsets, name


def test_engine_counters_and_histogram_counts_equal_the_reference(both_engines):
    jeng, jreqs, teng, treqs = both_engines
    for r, t in zip(jreqs, treqs):
        assert list(r.generated) == list(t.generated)
    for outcome in ("ok", "shed", "timeout", "cancelled", "error"):
        assert teng._m_requests.value(outcome=outcome) == \
            jeng._m_requests.value(outcome=outcome), outcome
    assert jeng._m_requests.value(outcome="ok") == 3
    assert teng.tokens_total == jeng._m_tokens.value()
    assert dict(teng.shed_stats) == dict(jeng.shed_stats) == {
        "rejected": 1, "timed_out": 1, "kv_exhausted": 0}
    assert (teng.prefix_hits, teng.prefix_misses) == (jeng.prefix_hits, jeng.prefix_misses) \
        == (1, 1)
    for name in ("kukeon_engine_queue_wait_seconds", "kukeon_engine_ttft_seconds",
                 "kukeon_engine_inter_token_seconds", "kukeon_engine_e2e_seconds"):
        assert teng.registry.get(name).snapshot()[2] == jeng.registry.get(name).snapshot()[2], name
    pre_t, pre_j = teng.registry.get("kukeon_engine_prefill_seconds"), \
        jeng.registry.get("kukeon_engine_prefill_seconds")
    assert pre_t.snapshot(bucket="64")[2] == pre_j.snapshot(bucket="64")[2] == 5
    # Host syncs mirror sync_stats on the scrape.
    fams = fed.parse(tobs.render(teng.registry))
    hs = {lab["kind"]: float(v) for _n, lab, v in fams["kukeon_engine_host_sync_total"].samples}
    assert hs == {"fetch": teng.sync_stats["fetches"], "upload": teng.sync_stats["uploads"]}


def test_span_events_per_request_follow_the_reference(both_engines):
    jeng, jreqs, teng, treqs = both_engines
    for r, t in zip(jreqs, treqs):
        (js,), (ts,) = jeng.tracer.for_trace(r.trace.trace_id), \
            teng.tracer.for_trace(t.trace.trace_id)
        assert [e["event"] for e in ts["events"]] == [e["event"] for e in js["events"]]
        assert ts["outcome"] == js["outcome"] and ts["tokens"] == js["tokens"]
        assert abs(sum(ts["phasesS"].values()) - ts["e2eS"]) < 1e-3
    assert [s["outcome"] for s in teng.tracer.recent(50) if s["requestId"] == -1] == ["shed"]


# --- compile counter ---------------------------------------------------------


@pytest.mark.parametrize("paged", [False, True], ids=["legacy", "paged"])
def test_decode_compile_counter_flat_across_slot_churn(tiny, paged):
    """After warmup, slot churn (and on the paged layout page churn) moves
    no compile counter (the port of tests/test_obs_device.py:65,96)."""
    kw = dict(kv_page_tokens=16, kv_pool_pages=12) if paged else {}
    eng = ServingEngine(tl.llama_tiny(), tiny[1], device="cpu", num_slots=2, max_seq_len=96,
                        decode_chunk=4, **kw)
    eng.precompile((8,))
    eng.warmup(8)
    base = {p: eng.compiles.count(p) for p in ("prefill", "insert", "decode")}
    assert base["decode"] >= 1 and base["prefill"] >= 1
    r1 = eng.submit(PROMPT, SamplingParams(max_new_tokens=12))
    eng.step()
    r2 = eng.submit(PROMPT[:4], SamplingParams(max_new_tokens=3))
    while not r2.done.is_set():
        eng.step()
    r3 = eng.submit(PROMPT, SamplingParams(max_new_tokens=2))
    while not (r1.done.is_set() and r3.done.is_set()):
        eng.step()
    assert {p: eng.compiles.count(p) for p in base} == base
    fams = _parse_expo(tobs.render(eng.registry))
    assert fams["kukeon_compiles_total"]["type"] == "counter"
    assert fams["kukeon_compile_seconds"]["type"] == "histogram"
    assert {"prefill", "decode"} <= {lab["program"] for _n, lab, _v
                                     in fams["kukeon_compiles_total"]["samples"]}
    if paged:
        assert eng._pool.in_use == 0


def test_compile_counter_counts_a_new_bucket(tiny):
    eng = ServingEngine(tl.llama_tiny(), tiny[1], device="cpu", num_slots=1, max_seq_len=160,
                        decode_chunk=4)
    eng.generate(PROMPT, SamplingParams(max_new_tokens=2))
    before = eng.compiles.count("prefill")
    eng.generate(np.ones((70,), np.int32), SamplingParams(max_new_tokens=2))   # bucket 128
    assert eng.compiles.count("prefill") == before + 1


# --- a port cell over HTTP -------------------------------------------------------


@pytest.fixture(scope="module")
def obs_cell():
    cell = ServingCell("tiny", num_slots=2, max_seq_len=96, max_pending=8, device="cpu",
                       decode_chunk=4, slo_ttft_p95_ms=500.0, slo_availability=0.995)
    cell.engine.start()
    cell.mark_ready()
    server = ThreadingHTTPServer(("127.0.0.1", 0), make_handler(cell))
    threading.Thread(target=server.serve_forever, daemon=True).start()
    yield cell, server.server_address[1]
    server.shutdown()
    server.server_close()
    cell.engine.stop()


def _get(port, path):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    conn.request("GET", path)
    resp = conn.getresponse()
    raw = resp.read()
    ctype = resp.getheader("Content-Type")
    conn.close()
    return resp.status, raw, ctype


def test_metrics_scrape_is_valid_while_flooded(obs_cell):
    """/metrics parses (the reference's strict parser and its federation
    parser) with the required families while a flood is in flight, and
    agrees with /v1/stats."""
    cell, port = obs_cell
    eng = cell.engine
    flood, rejected = [], 0
    for _ in range(24):
        try:
            flood.append(eng.submit(PROMPT, SamplingParams(max_new_tokens=3)))
        except RejectedError:
            rejected += 1
    for _ in range(5):
        status, raw, ctype = _get(port, "/metrics")
        assert status == 200 and ctype.startswith("text/plain")
        fams = _parse_expo(raw.decode())
        fed.parse(raw.decode())
        for name in ("kukeon_engine_ttft_seconds", "kukeon_engine_inter_token_seconds",
                     "kukeon_engine_e2e_seconds", "kukeon_engine_queue_wait_seconds",
                     "kukeon_engine_prefill_seconds", "kukeon_engine_shed_total",
                     "kukeon_engine_slots_free", "kukeon_engine_queue_depth",
                     "kukeon_watchdog_probes_total", "kukeon_watchdog_trips_total",
                     "kukeon_faults_fired_total", "kukeon_cell_ready",
                     "kukeon_cell_uptime_seconds", "kukeon_cell_info",
                     "kukeon_cell_http_inflight", "kukeon_cell_draining"):
            assert name in fams, name
    deadline = time.monotonic() + 120
    for r in flood:
        assert r.done.wait(timeout=max(0.0, deadline - time.monotonic()))
    stats = json.loads(_get(port, "/v1/stats")[1])
    fams = _parse_expo(_get(port, "/metrics")[1].decode())
    shed = {lab["reason"]: float(v) for _n, lab, v in fams["kukeon_engine_shed_total"]["samples"]}
    assert shed.get("rejected", 0) == stats["rejected"] == rejected
    tokens = float(fams["kukeon_engine_tokens_total"]["samples"][0][2])
    assert stats["generatedTokens"] == tokens == eng.tokens_total
    info = fams["kukeon_cell_info"]["samples"]
    assert info == [("kukeon_cell_info", {"kind": "decoder", "model": "tiny"}, "1")]


def test_cell_exposes_device_compile_and_slo_families(obs_cell):
    cell, port = obs_cell
    cell.engine.generate(PROMPT, SamplingParams(max_new_tokens=3))
    fams = _parse_expo(_get(port, "/metrics")[1].decode())
    for name, kind in (("kukeon_hbm_bytes_in_use", "gauge"), ("kukeon_hbm_bytes_limit", "gauge"),
                       ("kukeon_hbm_bytes_peak", "gauge"), ("kukeon_compiles_total", "counter"),
                       ("kukeon_compile_seconds", "histogram"),
                       ("kukeon_slo_objective", "gauge"), ("kukeon_slo_burn_rate", "gauge"),
                       ("kukeon_slo_error_budget_remaining", "gauge"),
                       ("kukeon_profile_captures_total", "counter"),
                       ("kukeon_scrape_errors_total", "counter"),
                       ("kukeon_engine_mesh_chips", "gauge"), ("kukeon_kv_pages_total", "gauge")):
        assert fams.get(name, {}).get("type") == kind, name
    obj = {lab["slo"]: float(v) for _n, lab, v in fams["kukeon_slo_objective"]["samples"]}
    assert obj["availability"] == 0.995 and abs(obj["ttft_p95"] - 0.5) < 1e-9
    burn = {(lab["slo"], lab["window"]) for _n, lab, _v in fams["kukeon_slo_burn_rate"]["samples"]}
    assert ("availability", "5m") in burn and ("ttft_p95", "1h") in burn


def test_trace_endpoint_bounds_and_validates(obs_cell):
    cell, port = obs_cell
    req = cell.engine.submit(PROMPT, SamplingParams(max_new_tokens=2))
    assert req.done.wait(timeout=60)
    status, raw, _ = _get(port, "/v1/trace?n=1")
    assert status == 200 and len(json.loads(raw)["spans"]) <= 1
    assert _get(port, "/v1/trace?n=bogus")[0] == 400
    deadline = time.monotonic() + 10
    spans = []
    while not spans and time.monotonic() < deadline:
        spans = json.loads(_get(port, f"/v1/trace?request_id={req.id}")[1])["spans"]
        time.sleep(0.01)
    assert spans and all(s["requestId"] == req.id for s in spans)
    assert json.loads(_get(port, "/v1/trace?request_id=999999")[1])["spans"] == []
    assert _get(port, "/v1/trace?request_id=bogus")[0] == 400
    assert _get(port, "/v1/timeline?n=bogus")[0] == 400


# --- the reference's consumers read a port cell --------------------------------


def test_reference_scaler_sees_the_port_cells_queue_depth_and_burn_rate(tmp_path):
    """The reference's FleetScaler, fed the port cell's scrape through the
    reference's federation parser (``cell=`` relabel, TSDB ingest, as the
    daemon's telemetry tick does), reads its queue depth and its 5m burn
    rate."""
    from kukeon_tpu import obs as jax_obs
    from kukeon_tpu.obs.tsdb import TSDB
    from kukeon_tpu.runtime import scaler as scaler_mod
    from kukeon_tpu.runtime.api import types as t
    from kukeon_tpu.runtime.cells import FakeBackend
    from kukeon_tpu.runtime.controller import Controller
    from kukeon_tpu.runtime.devices import TPUDeviceManager
    from kukeon_tpu.runtime.metadata import MetadataStore
    from kukeon_tpu.runtime.runner import Runner, RunnerOptions
    from kukeon_tpu.runtime.store import ResourceStore

    cell = ServingCell("tiny", num_slots=2, max_seq_len=96, max_pending=10, device="cpu",
                       decode_chunk=4)
    eng = cell.engine
    server = ThreadingHTTPServer(("127.0.0.1", 0), make_handler(cell))
    threading.Thread(target=server.serve_forever, daemon=True).start()
    url = f"http://127.0.0.1:{server.server_address[1]}/metrics"
    try:
        urllib.request.urlopen(url, timeout=30).read()      # the burn windows' baseline
        # One request's deadline passes in the queue (an availability
        # burn), then three wait: the engine is stepped by hand.
        late = eng.submit(PROMPT, SamplingParams(max_new_tokens=2), deadline_s=0.01)
        time.sleep(0.05)
        eng.step()
        assert late.timed_out
        for _ in range(3):
            eng.submit(PROMPT, SamplingParams(max_new_tokens=2))
        with urllib.request.urlopen(url, timeout=30) as r:
            fams = fed.parse(r.read().decode())
    finally:
        server.shutdown()
        server.server_close()
    store = ResourceStore(MetadataStore(str(tmp_path)))
    runner = Runner(store, FakeBackend(), cgroups=None,
                    devices=TPUDeviceManager(store.ms, chips=[0, 1, 2, 3]),
                    options=RunnerOptions(stop_grace_s=0.2), registry=jax_obs.Registry())
    ctl = Controller(store, runner)
    ctl.bootstrap()
    ctl.create_cell(t.Document(
        kind=t.KIND_CELL, metadata=t.Metadata(name="llm"),
        spec=t.CellSpec(model=t.ModelSpec(model="tiny", chips=1, port=9300, replicas=1,
                                          min_replicas=1, max_replicas=3, max_pending=10))))
    key = "default/default/default/llm"
    now = 1_000_000.0
    tsdb = TSDB(clock=lambda: now)
    fed.inject_label(fams, cell=f"{key}/r0")
    tsdb.ingest(fams, at=now)
    sc = scaler_mod.FleetScaler(ctl, tsdb, clock=lambda: now, drain_timeout_s=1.0)
    sc.tick(at=now)
    state = {s["cell"]: s for s in sc.states()}[key]
    burn = max(float(v) for _n, lab, v in fams["kukeon_slo_burn_rate"].samples
               if lab["window"] == "5m")
    assert state["scraped"] and state["queueRatio"] == 0.3
    # One bad event of one against a 1% allowance; the scaler rounds to 4 places.
    assert abs(burn - 100.0) < 1e-9 and state["burnRate"] == round(burn, 4)
