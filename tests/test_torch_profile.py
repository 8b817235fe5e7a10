"""The port's roofline instruments (``kukeon_tpu_torch/obs/profile.py``,
``obs/device.py``'s profiler spool, and their seams in the engine and the
programs) on the CPU:

- ``program_cost`` equals a hand count at ``tiny`` and ``mixtral-tiny``
  for every program kind, and the fused programs take the reference's
  labels (``serving/programs.py`` ``program_labels``);
- ``ProgramTimers``: a mark counts at dispatch and times at the first
  settle that finds its end event done; utilization only for programs
  with a recorded cost, clamped to 1;
- the engine's host-sync budget is unchanged with the timers armed (each
  chunk still one blocking fetch; the same fetches as with the settle
  disabled), every dispatch settles, and after a flood the MFU and
  bandwidth gauges are above 0 and at most 1;
- the flight recorder's ring, its dropped counter and the engine's step
  records; ``device_peaks``' table and overrides;
- ``POST|GET /v1/profile``: single flight (409), the spool's keep-last-K,
  the ``profile.capture`` fault, ``"layers"`` answered with the
  per-layer profile, and the capture lock held around the profiler's
  start and stop.
"""

import http.client
import json
import os
import threading
import time
from http.server import ThreadingHTTPServer

import numpy as np
import pytest
import torch

from kukeon_tpu.obs import federate as fed
from kukeon_tpu_torch import faults
from kukeon_tpu_torch import obs as tobs
from kukeon_tpu_torch.models import llama as tl
from kukeon_tpu_torch.models import moe as tm
from kukeon_tpu_torch.obs import profile as tprofile
from kukeon_tpu_torch.runtime.serving_cell import ServingCell, make_handler
from kukeon_tpu_torch.serving import SamplingParams, ServingEngine
from kukeon_tpu_torch.serving.programs import program_labels

torch.set_num_threads(2)

PROMPT = np.arange(1, 9, dtype=np.int32)


@pytest.fixture(autouse=True)
def _port_faults():
    faults.reset()
    yield
    faults.reset()


@pytest.fixture(scope="module")
def params():
    return tl.init_params(tl.llama_tiny(), torch.Generator().manual_seed(0), "cpu")


# --- program costs and labels ----------------------------------------------------


def test_program_cost_equals_a_hand_count_at_tiny():
    """llama_tiny: L 2, D 128, I 256, H 4, KV 2, head_dim 32, V 512, f32.
    Weights a token multiplies: per layer 128*(128+128) + 128*128 + 3*128*256
    = 147,456, x2, plus the head 512*128: N = 360,448 (f32: W = 4 N =
    1,441,792 bytes; int8: 370,688 with the f32 scale columns). A KV row:
    2 layers x K,V x 2 heads x 32 x 4 bytes = 1,024 (int8 KV: 288).
    Attention: 4 x 2 x 4 x 32 = 1,024 FLOPs a query-key pair. B 2, S_max 96."""
    cfg = tl.llama_tiny()

    def cost(program, key, **kw):
        return tobs.program_cost(cfg, program, key, num_slots=2, max_seq_len=96,
                                 int8_weights=kw.pop("int8", False), **kw)

    # Decode, 4 steps: 4 (2 N B + 1024 B S_max), 4 (W + B S_max R).
    assert cost("decode_chunk", (4, False, False)) == (6_553_600.0, 6_553_600.0)
    assert cost("decode_chunk", (4, False, False), int8=True)[1] == 2_269_184.0
    assert cost("decode_chunk", (4, False, False), kv_cache_int8=True)[1] == 5_988_352.0
    assert cost("decode_chunk_paged", (4, False, False))[1] == 6_946_816.0
    # Prefill at 64: 2 N 64 + 1024 64 64; W + 2 x 64 rows (block, insert).
    assert cost("prefill", ("prefill", 64, False, False)) == (50_331_648.0, 1_572_864.0)
    assert cost("prefill", ("prefill_paged", 64, False, True)) == (50_331_648.0, 1_572_864.0)
    assert cost("prefill", ("prefill_export", 64, False, False))[1] == 1_507_328.0
    # prefill_ext over a 64-row prefix: 64 queries x 128 keys; W + (64 + 128) rows.
    assert cost("prefill_ext", ("prefill_ext", 64, 64, False, False)) == \
        (54_525_952.0, 1_638_400.0)
    assert cost("insert", ("insert", 64)) == (0.0, 131_072.0)


def test_program_cost_of_the_moe_counts_every_expert_read_and_top_k_used():
    """moe_tiny: L 2, D 64, I 128, H 4, KV 2, head_dim 16, E 4, top 2, V 512,
    f32. Bytes read: per layer 64*(64+64) + 64*64 + 4 x 3*64*128 = 110,592
    elements, x2, plus the head 512*64, at 4 bytes, plus the f32 router
    2 x 64 x 4 x 4 = 1,017,856. Multiplied a token: per layer 12,288 +
    2 x 24,576 + 64 x 4 = 61,696, x2, plus the head: 156,160."""
    cfg = tm.moe_tiny()
    flops, nbytes = tobs.program_cost(cfg, "decode_chunk", (1, False, False), num_slots=2,
                                      max_seq_len=64, int8_weights=False)
    # 2 N B + 512 B S_max; W + B S_max x 512-byte rows.
    assert (flops, nbytes) == (2 * 156_160 * 2 + 512 * 2 * 64, 1_017_856 + 2 * 64 * 512)


def test_fused_programs_take_the_reference_labels():
    """The contract: a fused prefill (prefill, paged or export) times as
    ``prefill``, any ``prefill_ext*`` as ``prefill_ext``, the insert-only
    keys as themselves, a decode key by the layout; builds count as
    prefill, insert or decode."""
    cases = {
        (("prefill", 64, False, False), False): ("prefill", "prefill"),
        (("prefill_paged", 64, True, True), True): ("prefill", "prefill"),
        (("prefill_export", 64, False, False), False): ("prefill", "prefill"),
        (("prefill_ext", 512, 64, False, False), False): ("prefill_ext", "prefill"),
        (("prefill_ext_paged", 512, 64, False, False), True): ("prefill_ext", "prefill"),
        (("prefill_ext_export", 512, 64, False, True), False): ("prefill_ext", "prefill"),
        (("insert", 64), False): ("insert", "insert"),
        (("insert_paged", 64), True): ("insert_paged", "insert"),
        ((16, False, False), False): ("decode_chunk", "decode"),
        ((4, True, True), True): ("decode_chunk_paged", "decode"),
    }
    for (key, paged), want in cases.items():
        assert program_labels(key, paged) == want, key
        assert want[0] in tobs.PROGRAMS


# --- the timers ------------------------------------------------------------------


class _Event:
    """A stand-in for a CUDA end event: done once ``done`` is set."""

    def __init__(self):
        self.done = False

    def query(self):
        return self.done


def test_a_mark_times_at_the_first_settle_that_finds_it_done():
    reg = tobs.Registry()
    timers = tobs.ProgramTimers(reg, peaks=(1e12, 1e9))
    ev = _Event()
    t0 = time.monotonic()
    timers.track("decode_chunk").dispatched(t0, ev, (2e9, 1e8))
    assert reg.get("kukeon_program_dispatch_total").value(program="decode_chunk") == 1
    timers.settle()
    assert reg.get("kukeon_program_seconds").snapshot(program="decode_chunk")[2] == 0
    time.sleep(0.02)
    ev.done = True
    timers.settle()
    _counts, busy, n = reg.get("kukeon_program_seconds").snapshot(program="decode_chunk")
    assert n == 1 and busy >= 0.02
    # No recorded cost yet: no utilization (the reference's rule).
    fams = fed.parse(tobs.render(reg))
    assert fams["kukeon_program_mfu"].samples == []
    timers.set_cost("decode_chunk", 2e9, 1e8)
    mfu = fed.parse(tobs.render(reg))["kukeon_program_mfu"].samples[0]
    assert float(mfu[2]) == pytest.approx(2e9 / (busy * 1e12))
    # A dispatch marked without a cost takes the recorded one; busy-clamped.
    timers.track("decode_chunk").dispatched(time.monotonic(), None)
    timers.settle()
    snap = timers.snapshot()["decode_chunk"]
    assert snap["dispatches"] == snap["settled"] == 2 and 0 < snap["membw_util"] <= 1


def test_host_sync_budget_unchanged_with_the_timers_armed(params):
    """One blocking fetch a chunk (port of the budget tests), the same
    fetches and uploads as an engine whose settle does nothing, and every
    decode and prefill dispatch settled when the engine is idle."""
    counts = []
    for armed in (True, False):
        eng = ServingEngine(tl.llama_tiny(), params, num_slots=2, max_seq_len=128,
                            decode_chunk=4, device="cpu")
        if not armed:
            eng.timers.settle = lambda: None
        base = dict(eng.sync_stats)
        req = eng.submit(np.arange(1, 9, dtype=np.int32), SamplingParams(max_new_tokens=24))
        while not req.done.is_set():
            eng.step()
        while eng.step():
            pass
        d = {k: eng.sync_stats[k] - base[k] for k in ("fetches", "uploads", "chunks")}
        assert d["chunks"] >= 5 and d["chunks"] - 1 <= d["fetches"] <= d["chunks"] + 1
        assert d["uploads"] == 4, d
        counts.append(d)
        if armed:
            snap = eng.timers.snapshot()
            for program in ("decode_chunk", "prefill"):
                assert snap[program]["dispatches"] == snap[program]["settled"] > 0, program
            assert snap["decode_chunk"]["dispatches"] == eng.sync_stats["chunks"]
            assert snap["decode_chunk"]["tokens"] == 4 * eng.sync_stats["chunks"]
    assert counts[0] == counts[1]


def test_utilization_gauges_after_a_flood(params):
    """After a flood through a warmed cell (costs recorded at precompile),
    the decode and prefill MFU and bandwidth gauges lie in (0, 1], and the
    cost gauges are the largest chunk's and bucket's."""
    cell = ServingCell("tiny", num_slots=2, max_seq_len=96, max_pending=64, device="cpu",
                       decode_chunk=4)
    cell.warmup(prompt_len=8)
    eng = cell.engine
    reqs = [eng.submit(PROMPT, SamplingParams(max_new_tokens=12)) for _ in range(12)]
    while not all(r.done.is_set() for r in reqs):
        eng.step()
    fams = fed.parse(tobs.render(cell.registry))
    for family in ("kukeon_program_mfu", "kukeon_program_membw_util"):
        got = {lab["program"]: float(v) for _n, lab, v in fams[family].samples}
        assert set(got) == {"decode_chunk", "prefill"}, got
        assert all(0 < v <= 1 for v in got.values()), (family, got)
    flops = {lab["program"]: float(v) for _n, lab, v in fams["kukeon_program_flops"].samples}
    want = tobs.program_cost(eng.cfg, "decode_chunk", (4, False, False), num_slots=2,
                             max_seq_len=96, int8_weights=False)[0]
    assert flops["decode_chunk"] == want
    assert eng.timers.snapshot()["decode_chunk"]["dispatches"] == eng.sync_stats["chunks"]


def test_device_peaks_table_and_overrides(monkeypatch):
    assert tobs.device_peaks() == tprofile._DEFAULT_PEAKS
    assert tobs.device_peaks("cpu") == tprofile._DEFAULT_PEAKS
    for name, want in (("NVIDIA H100 80GB HBM3", (989e12, 3.35e12)),
                       ("NVIDIA H100 PCIe", (756e12, 2.0e12)),
                       ("NVIDIA H100 NVL", (835e12, 3.9e12)),
                       ("Some Other Card", tprofile._DEFAULT_PEAKS)):
        monkeypatch.setattr(torch.cuda, "get_device_name", lambda d=None, n=name: n)
        assert tobs.device_peaks("cuda") == want, name
    monkeypatch.setenv(tprofile.PEAK_FLOPS_ENV, "5e14")
    monkeypatch.setenv(tprofile.PEAK_HBM_BPS_ENV, "2e12")
    assert tobs.device_peaks("cuda") == (5e14, 2e12)


# --- the flight recorder ---------------------------------------------------------


def test_flight_recorder_ring_and_dropped_counter():
    reg = tobs.Registry()
    rec = tobs.FlightRecorder(capacity=4, registry=reg)
    for i in range(10):
        assert rec.record({"i": i}) == i
    snap = rec.snapshot()
    assert [r["i"] for r in snap] == [6, 7, 8, 9] and [r["seq"] for r in snap] == [6, 7, 8, 9]
    assert [r["i"] for r in rec.snapshot(2)] == [8, 9] and rec.snapshot(0) == []
    assert rec.dropped == 6 and len(rec) == 4
    assert reg.get("kukeon_timeline_dropped_total").value() == 6
    assert reg.get("kukeon_timeline_depth").value() == 4


def test_flight_recorder_concurrent_writers_lose_nothing():
    rec = tobs.FlightRecorder(capacity=100_000)
    threads = [threading.Thread(target=lambda: [rec.record({}) for _ in range(2000)])
               for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    assert sorted(r["seq"] for r in rec.snapshot()) == list(range(16_000))


def test_engine_records_one_step_a_working_step(params):
    eng = ServingEngine(tl.llama_tiny(), params, num_slots=2, max_seq_len=96, decode_chunk=4,
                        device="cpu")
    reqs = [eng.submit(PROMPT, SamplingParams(max_new_tokens=6)) for _ in range(3)]
    steps = 0
    while not all(r.done.is_set() for r in reqs):
        steps += eng.step()
    steps += eng.step()
    records = eng.recorder.snapshot()
    assert len(records) == steps
    assert sum(r["tokens"] for r in records) == eng.tokens_total == 18
    assert sum(r["prefills"] for r in records) == 3
    assert sum(r["fetches"] for r in records) == eng.sync_stats["fetches"]
    assert {r.trace.trace_id for r in reqs} <= {t for rec in records for t in rec["traces"]}
    assert all(set(rec) >= {"wall_s", "occupancy", "slots", "queue_depth", "chunk_k",
                            "uploads", "preemptions", "programs", "seq", "t"}
               for rec in records)
    assert any("decode_chunk" in rec["programs"] for rec in records)


# --- the profiler spool and /v1/profile ------------------------------------------


@pytest.fixture(scope="module")
def profiled_cell(tmp_path_factory):
    cell = ServingCell("tiny", num_slots=2, max_seq_len=96, device="cpu", decode_chunk=4)
    cell.profiler.base_dir = str(tmp_path_factory.mktemp("spool"))
    cell.engine.start()
    cell.mark_ready()
    server = ThreadingHTTPServer(("127.0.0.1", 0), make_handler(cell))
    threading.Thread(target=server.serve_forever, daemon=True).start()
    yield cell, server.server_address[1]
    server.shutdown()
    server.server_close()
    cell.engine.stop()


def _req(port, method, path, body=None):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    conn.request(method, path, body=json.dumps(body) if body is not None else None,
                 headers={"Content-Type": "application/json"})
    resp = conn.getresponse()
    raw = resp.read()
    conn.close()
    return resp.status, json.loads(raw)


def _wait_idle(prof, timeout=30.0):
    deadline = time.monotonic() + timeout
    while prof._active is not None:
        assert time.monotonic() < deadline
        time.sleep(0.02)


def test_profile_capture_single_flight_and_spool(profiled_cell):
    cell, port = profiled_cell
    status, out = _req(port, "POST", "/v1/profile", {"durationMs": 400})
    assert status == 200 and out["started"]
    name = out["capture"]["name"]
    status, _ = _req(port, "POST", "/v1/profile", {"durationMs": 100})
    assert status == 409
    cell.engine.generate(PROMPT, SamplingParams(max_new_tokens=3))
    _wait_idle(cell.profiler)
    status, listing = _req(port, "GET", "/v1/profile")
    assert status == 200 and listing["dir"] == cell.profiler.base_dir
    done = next(c for c in listing["captures"] if c["name"] == name and c["state"] == "done")
    assert done["sizeBytes"] > 0 and os.path.isfile(os.path.join(done["path"], "trace.json"))
    fams = fed.parse(tobs.render(cell.registry))
    ok = {lab["outcome"]: float(v) for _n, lab, v in fams["kukeon_profile_captures_total"].samples}
    assert ok["ok"] >= 1
    assert _req(port, "POST", "/v1/profile", {"durationMs": -5})[0] == 400
    assert _req(port, "POST", "/v1/profile", {"durationMs": "soon"})[0] == 400


def test_layer_profiles_are_refused_naming_a12d(profiled_cell, tmp_path, monkeypatch):
    """A12d is ported: ``{"layers": true}`` is no longer refused but
    answered with the live model's per-layer profile (200, no error),
    persisted under the cell's tuning key."""
    _cell, port = profiled_cell
    monkeypatch.setenv("KUKEON_LAYER_PROFILE_PATH", str(tmp_path / "layers.json"))
    status, out = _req(port, "POST", "/v1/profile",
                       {"layers": True, "prefillLen": 8, "decodeBatch": 2})
    assert status == 200 and out["errors"] == 0 and "error" not in out
    assert out["key"] == "tiny|cpu|1" and out["path"] == str(tmp_path / "layers.json")


def test_profile_capture_fault_path(profiled_cell):
    """The profile.capture fault point fails the start cleanly (500 with
    the injected error) and leaves the single-flight latch open."""
    cell, port = profiled_cell
    os.environ[faults.ENV] = "profile.capture:1:1"
    try:
        status, out = _req(port, "POST", "/v1/profile", {"durationMs": 100})
    finally:
        os.environ.pop(faults.ENV)
    assert status == 500 and "injected fault" in out["error"]
    assert faults.fired("profile.capture") == 1
    status, _ = _req(port, "POST", "/v1/profile", {"durationMs": 100})
    assert status == 200
    _wait_idle(cell.profiler)


def test_profile_spool_keeps_last_k_and_holds_its_guard(tmp_path):
    entered = []

    class Guard:
        def __enter__(self):
            entered.append(time.monotonic())

        def __exit__(self, *exc):
            return False

    spool = tobs.ProfileSpool(base_dir=str(tmp_path / "spool"), keep=2, guard=Guard())
    for _ in range(4):
        spool.start(30)
        _wait_idle(spool)
        time.sleep(1.01)        # capture names carry the second
    assert len(entered) == 8    # the profiler's start and stop, each capture
    assert len([c for c in spool.list() if c["state"] == "done"]) == 2
    assert len([e for e in os.scandir(spool.base_dir) if e.is_dir()]) == 2


def test_a_finished_capture_is_listed_once_and_with_its_size(tmp_path, monkeypatch):
    """A reader polling ``list()`` while the capture thread finishes sees the
    active record either running or done with its size, and never also as
    a second entry read from disk."""
    from kukeon_tpu_torch.obs import device as tdevice

    spool = tobs.ProfileSpool(base_dir=str(tmp_path / "spool"), keep=2)
    seen = []
    tree_size = tdevice._tree_size

    def sizing(path):
        if threading.current_thread().name == "profile-capture":
            seen.append(spool.list())     # between the export and "done"
        return tree_size(path)

    monkeypatch.setattr(tdevice, "_tree_size", sizing)
    name = spool.start(30)["name"]
    _wait_idle(spool)
    seen.append(spool.list())
    for listing in seen:
        mine = [c for c in listing if c["name"] == name]
        assert len(mine) == 1, listing
        assert mine[0]["state"] == "running" or mine[0].get("sizeBytes"), listing
    assert seen[-1][0]["state"] == "done" and seen[-1][0]["sizeBytes"] > 0


def test_cell_profiler_takes_the_programs_capture_lock(profiled_cell):
    cell, _port = profiled_cell
    assert cell.profiler._guard is cell.engine._programs.capture_lock
    assert cell.engine._prefill_programs.capture_lock is cell.engine._programs.capture_lock
    assert cell.recorder is cell.engine.recorder
