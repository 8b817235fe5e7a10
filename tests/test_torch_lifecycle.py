"""The port cell's lifecycle (``kukeon_tpu_torch/runtime/serving_cell.py``
``LifecycleMixin``, the port of ``kukeon_tpu/runtime/serving_cell.py:92-260``)
and its role, on the CPU:

- ``readiness()`` through warming up -> ready -> draining, and
  ``begin_drain`` firing once;
- 503 with ``Retry-After`` on ``/v1/generate`` and both ``/v1/kv/*``
  routes while warming up and while draining;
- ``/drain`` lets an in-flight stream finish before the engine stops, and
  a ``main()`` process exits 0 once drained;
- ``draining`` and ``inflight`` in ``/v1/stats``;
- a ``--role`` other than mixed, prefill or decode is a ``SystemExit``;
- the reference's ``GatewayCell`` takes a draining port cell out of
  rotation and retries its 503 on another (``tests/test_gateway.py:402``,
  on port cells).
"""

import http.client
import json
import os
import socket
import subprocess
import sys
import threading
import time
import urllib.request

import numpy as np
import pytest
import torch
from test_torch_disagg import _gateway, _make_cell, _post

from kukeon_tpu_torch.runtime import serving_cell
from kukeon_tpu_torch.runtime.serving_cell import ServingCell, pack_kv

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KV = np.zeros((2, 1, 3, 2, 32), np.float32)
IMPORT = pack_kv({"token": 5, "length": 3, "promptTokens": [1, 2, 3], "maxNewTokens": 4}, KV, KV)
GENERATE = {"promptTokens": [1, 2, 3], "maxNewTokens": 4}


def _routes_answer(port: int) -> dict:
    """Status and Retry-After of each admission-gated POST route."""
    out = {}
    for path, body in (("/v1/generate", GENERATE), ("/v1/generate", {**GENERATE, "stream": True}),
                       ("/v1/kv/export", GENERATE), ("/v1/kv/import", IMPORT)):
        status, _, headers = _post(port, path, body)
        out.setdefault(path, []).append((status, headers.get("Retry-After")))
    return out


def _stop(cell, srv):
    srv.shutdown()
    srv.server_close()
    cell.engine.stop()


def test_readiness_through_warming_up_ready_and_draining():
    cell = ServingCell("tiny", num_slots=2, max_seq_len=64, decode_chunk=4, device="cpu")
    drained = threading.Event()
    cell.on_drained = drained.set
    assert cell.readiness() == (False, "warming up")
    cell.warmup(8)
    assert cell.readiness() == (False, "warming up")
    cell.mark_ready()
    assert cell.readiness() == (True, None)
    cell.engine.start()
    assert cell.begin_drain() is True
    assert cell.readiness() == (False, "draining")
    assert cell.begin_drain() is False               # one drain
    assert drained.wait(10) and cell.drained.is_set()
    assert not cell.engine.running
    with pytest.raises(serving_cell.RejectedError, match="draining"):
        cell.check_admission()
    cell.mark_unready("wedged")
    assert cell.readiness() == (False, "draining")   # draining wins


def test_503_with_retry_after_while_warming_up_and_draining():
    cell, srv = _make_cell("decode")
    port = srv.server_address[1]
    try:
        cell.mark_unready("warming up")
        for path, answers in _routes_answer(port).items():
            assert all(a == (503, "5") for a in answers), (path, answers)
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/v1/stats") as r:
            st = json.loads(r.read())
        assert st["ready"] is False and st["unreadyReason"] == "warming up"
        cell.mark_ready()
        assert _post(port, "/v1/generate", GENERATE)[0] == 200
        status, out, _ = _post(port, "/drain", {})
        assert status == 200 and out == {"draining": True, "started": True}
        assert _post(port, "/drain", {})[1] == {"draining": True, "started": False}
        for path, answers in _routes_answer(port).items():
            assert all(a == (503, "5") for a in answers), (path, answers)
        try:
            urllib.request.urlopen(f"http://127.0.0.1:{port}/readyz")
            raise AssertionError("/readyz answered 200 while draining")
        except urllib.error.HTTPError as e:
            assert e.code == 503 and json.loads(e.read())["reason"] == "draining"
    finally:
        _stop(cell, srv)


def test_drain_finishes_an_inflight_stream_before_the_engine_stops():
    """A stream in flight when ``/drain`` arrives runs to its terminal
    record; ``/v1/stats`` shows the drain and the request in flight; the
    engine stops, and ``on_drained`` fires, only after."""
    cell, srv = _make_cell("mixed")
    port = srv.server_address[1]
    drained = threading.Event()
    cell.on_drained = drained.set
    slow = cell.engine._decode_chunk

    def chunk(k, flags):                             # a chunk in 20 ms: the drain lands mid-stream
        time.sleep(0.02)
        return slow(k, flags)

    cell.engine._decode_chunk = chunk
    try:
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
        conn.request("POST", "/v1/generate",
                     body=json.dumps({"promptTokens": [5, 300, 7], "maxNewTokens": 60,
                                      "stream": True}))
        resp = conn.getresponse()
        first = json.loads(resp.readline())
        assert "token" in first
        assert _post(port, "/drain", {})[1]["started"] is True
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/v1/stats") as r:
            st = json.loads(r.read())
        assert st["draining"] is True and st["inflight"] == 1 and st["ready"] is False
        assert not drained.is_set() and cell.engine.running
        assert _post(port, "/v1/generate", GENERATE)[0] == 503
        rest = [json.loads(ln) for ln in resp.read().splitlines() if ln]
        conn.close()
        assert rest[-1]["done"] is True and rest[-1]["numTokens"] == 60
        assert len(rest) == 60                       # 59 more tokens and the terminal record
        assert drained.wait(10) and not cell.engine.running
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/v1/stats") as r:
            st = json.loads(r.read())
        assert st["inflight"] == 0 and st["draining"] is True
    finally:
        _stop(cell, srv)


def test_stats_count_unfinished_engine_requests_as_inflight():
    cell = ServingCell("tiny", num_slots=2, max_seq_len=64, decode_chunk=4, device="cpu",
                       role="prefill")
    st = cell.stats()
    assert (st["role"], st["draining"], st["inflight"]) == ("prefill", False, 0)
    reqs = [cell.engine.submit(np.array([1, 2, 3], np.int32)) for _ in range(3)]
    assert cell.stats()["inflight"] == 3
    while not all(r.done.is_set() for r in reqs):
        cell.engine.step()
    assert cell.stats()["inflight"] == 0


def test_an_unknown_role_is_a_system_exit():
    with pytest.raises(SystemExit, match="role"):
        ServingCell("tiny", num_slots=2, max_seq_len=64, device="cpu", role="router")
    with pytest.raises(SystemExit, match="role"):
        serving_cell.main(["--model", "tiny", "--device", "cpu", "--role", "both"])
    for role in ("mixed", "prefill", "decode"):
        assert ServingCell("tiny", num_slots=1, max_seq_len=64, device="cpu",
                           role=role).stats()["role"] == role


def test_main_exits_0_once_drained():
    """``python -m kukeon_tpu_torch.runtime.serving_cell``: ``POST /drain``
    ends the process with exit code 0."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    proc = subprocess.Popen(
        [sys.executable, "-m", "kukeon_tpu_torch.runtime.serving_cell", "--model", "tiny",
         "--device", "cpu", "--port", str(port), "--max-seq-len", "64", "--no-warmup",
         "--role", "decode"],
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True,
        env={**os.environ, "OMP_NUM_THREADS": "2"})
    try:
        assert "ready on" in proc.stdout.readline()
        assert _post(port, "/v1/generate", GENERATE)[0] == 200
        assert _post(port, "/drain", {})[1]["started"] is True
        assert proc.wait(timeout=30) == 0
    finally:
        proc.kill()
        proc.wait()


def test_gateway_takes_a_draining_port_cell_out_of_rotation():
    """``tests/test_gateway.py:402`` on port cells: the cell a session is
    affine to drains between polls; the gateway's first contact is its
    503, which demotes it and retries on the other cell (200). The next
    poll keeps it out of rotation."""
    (a, sa), (b, sb) = _make_cell("mixed"), _make_cell("mixed")
    gw, gw_srv = _gateway([f"http://127.0.0.1:{s.server_address[1]}" for s in (sa, sb)],
                          poll_interval_s=30.0)
    try:
        sess = next(p for p in (f"s{i}" for i in range(64))
                    if gw.router.affine(p).name == "r0")
        assert a.begin_drain()
        served = b.engine.tokens_total
        status, out, _ = _post(gw_srv.server_address[1], "/v1/generate",
                               {**GENERATE, "prefixId": sess})
        assert status == 200 and len(out["tokens"]) == 4
        assert b.engine.tokens_total - served == 4 and a.engine.tokens_total == 0
        assert gw.registry.get("kukeon_gateway_retries_total").value(reason="status_503") == 1
        assert not gw.router.by_name["r0"].ready
        gw.router.poll_once()
        rep = gw.router.by_name["r0"]
        assert rep.draining and not rep.ready and gw.router.by_name["r1"].ready
    finally:
        gw_srv.shutdown()
        gw_srv.server_close()
        gw.stop()
        for cell, srv in ((a, sa), (b, sb)):
            _stop(cell, srv)
