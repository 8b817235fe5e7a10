"""Streaming and stop strings on the port's ``/v1/generate``
(``kukeon_tpu_torch/runtime/serving_cell.py``), against the reference cell
(``kukeon_tpu/runtime/serving_cell.py`` ``generate_stream``,
``_stream_events``, ``_stream``), on the CPU. These repair ROADMAP C4.

- the port of ``tests/test_runtime_manifests.py``'s
  ``test_serving_cell_stop_strings`` and
  ``test_stream_deltas_survive_split_utf8_codepoint`` on the port's cell;
- both cells at ``tiny`` with the same weights (both ``ByteTokenizer``)
  give equal ndjson records, plain, cut by a stop string and stopped by a
  stop token (``seconds`` aside);
- a stop match cancels the request and frees its slot;
- over HTTP: ``"stream": true`` answers ndjson, a non-string ``stop``
  answers 400 before any header of a stream, a full queue 429, a
  deadline ends the stream with an in-band ``timedOut`` record, and an
  error after the headers stays in-band.
"""

import http.client
import json
import threading
import time
import urllib.request

import jax
import numpy as np
import pytest
import torch
from test_torch_engine import _get, _post

from kukeon_tpu.runtime.serving_cell import ServingCell as JaxCell
from kukeon_tpu_torch.models import convert
from kukeon_tpu_torch.runtime.serving_cell import ServingCell, make_handler, serve
from kukeon_tpu_torch.serving import ServingEngine

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def cells():
    """(reference cell, port cell) at ``tiny``, the port's engine over the
    reference cell's weights."""
    jcell = JaxCell("tiny", num_slots=2, max_seq_len=64, checkpoint=None, dtype=None)
    tcell = ServingCell("tiny", num_slots=2, max_seq_len=64, device="cpu")
    jcell.engine._ensure_loaded()               # the reference loads weights off-thread
    params = convert.params_from_numpy(jax.tree.map(np.asarray, jcell.engine.params), "cpu")
    tcell.engine = ServingEngine(tcell.cfg, params, num_slots=2, max_seq_len=64,
                                 decode_chunk=4, device="cpu")
    return jcell, tcell


def _records(recs: list[dict]) -> list[dict]:
    return [{k: v for k, v in r.items() if k != "seconds"} for r in recs]


def test_stop_strings_cut_generation_in_both_modes(cells):
    """``stop`` strings cut generation (and text) at the first match in
    both modes; ``stopTokens`` stop token-exactly."""
    cell = cells[1]
    base = cell.generate({"prompt": "hello", "maxNewTokens": 6})
    assert base["numTokens"] == 6 and base["ttftSeconds"] <= base["seconds"]
    out = cell.generate({"prompt": "hello", "maxNewTokens": 6,
                         "stopTokens": [int(base["tokens"][1])]})
    assert out["tokens"] == base["tokens"][:2]
    full = base["text"]
    assert len(full) >= 2
    stop_s = full[1:2]
    out = cell.generate({"prompt": "hello", "maxNewTokens": 6, "stop": stop_s})
    assert stop_s not in out["text"] and full.startswith(out["text"])
    assert out["numTokens"] < 6
    recs = list(cell.generate_stream({"prompt": "hello", "maxNewTokens": 6,
                                      "stop": [stop_s]}))
    final = recs[-1]
    assert final["done"] and final["stopped"] and not final["cancelled"]
    assert "".join(r["text"] for r in recs[:-1]) == final["text"] == out["text"]
    for bad in ([42], 5, [""], {"s": 1}):
        with pytest.raises(ValueError, match="stop"):
            cell.generate({"prompt": "x", "stop": bad})


def test_stop_match_cancels_and_frees_the_slot(cells):
    cell = cells[1]
    base = cell.generate({"prompt": "hello", "maxNewTokens": 24})
    stop_s = base["text"][1:2]
    before = cell.engine.tokens_total
    out = cell.generate({"prompt": "hello", "maxNewTokens": 24, "stop": stop_s})
    # Cancelled at the match: the engine decoded at most one chunk past it.
    assert cell.engine.tokens_total - before < 24
    assert len(cell.engine._free_slots()) == cell.engine.num_slots
    assert cell.stats()["freeSlots"] == 2 and out["numTokens"] < 24


@pytest.mark.parametrize("body", [
    {"prompt": "hello", "maxNewTokens": 6},
    {"prompt": "hello", "maxNewTokens": 6, "stop": "STOP-AT-2"},
    {"prompt": "hello", "maxNewTokens": 6, "stopTokens": "STOP-AT-2"},
    {"promptTokens": [104, 101, 108, 108, 111], "maxNewTokens": 6,
     "stop": ["zz", "STOP-AT-3"]},
], ids=["plain", "stop-string", "stop-token", "stop-list"])
def test_ndjson_records_equal_the_reference_cells(cells, body):
    """The same weights and body through both cells: equal records, the
    deltas and the terminal record alike."""
    jcell, tcell = cells
    base = tcell.generate({k: v for k, v in body.items() if k not in ("stop", "stopTokens")})
    body = dict(body)
    for field in ("stop", "stopTokens"):
        marks = [body[field]] if isinstance(body.get(field), str) else body.get(field, [])
        if any(isinstance(m, str) and m.startswith("STOP-AT-") for m in marks):
            at = int(next(m for m in marks if m.startswith("STOP-AT-"))[8:])
            body[field] = ([base["tokens"][at]] if field == "stopTokens"
                           else [m for m in marks if not m.startswith("STOP-AT-")]
                           + [base["text"][at:at + 1]])
    port, ref = list(tcell.generate_stream(body)), list(jcell.generate_stream(body))
    assert _records(port) == _records(ref)
    assert port[-1]["done"] and port[-1]["tokens"] == ref[-1]["tokens"]


def test_stream_deltas_survive_split_utf8_codepoint(cells):
    """A character split across tokens decodes to U+FFFD until its last
    byte arrives: the stream holds it back and the joined deltas equal the
    final text."""
    cell = ServingCell("tiny", num_slots=2, max_seq_len=64, device="cpu")
    script = [0x68] + list("é".encode()) + [0x21]

    class FakeReq:
        def __init__(self):
            self.done = threading.Event()
            self.error = None
            self.cancelled = False
            self.timed_out = False

        def cancel(self):
            self.cancelled = True

    class FakeEngine:
        running = True          # the consumer reads straight off the queue

        def submit(self, prompt, sp, emit=None, prefix_id=None, deadline_s=None, trace_ctx=None):
            r = FakeReq()
            for i, tok in enumerate(script):
                emit(tok, i == len(script) - 1)
            r.done.set()
            return r

    cell.engine = FakeEngine()
    recs = list(cell.generate_stream({"prompt": "x", "maxNewTokens": 8}))
    deltas = [r["text"] for r in recs[:-1]]
    assert "".join(deltas) == "hé!" == recs[-1]["text"]
    assert not any("�" in d for d in deltas)
    assert deltas == ["h", "", "é", "!"]


def _stream_post(base: str, body: dict) -> tuple[int, str, list]:
    req = urllib.request.Request(base + "/v1/generate", data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return (r.status, r.headers.get("Content-Type"),
                    [json.loads(x) for x in r.read().splitlines() if x])
    except urllib.error.HTTPError as e:
        return e.code, e.headers.get("Content-Type"), [json.loads(e.read())]


def test_http_stream_stop_and_400(cells):
    cell = ServingCell("tiny", num_slots=2, max_seq_len=64, decode_chunk=4, device="cpu")
    cell.engine = cells[1].engine
    cell.engine.start()
    cell.mark_ready()
    server = serve(cell)
    base = f"http://127.0.0.1:{server.server_address[1]}"
    try:
        whole = _post(base + "/v1/generate", {"prompt": "hello", "maxNewTokens": 8})[2]
        stop_s = whole["text"][2:3]
        code, ctype, recs = _stream_post(base, {"prompt": "hello", "maxNewTokens": 8,
                                                "stop": stop_s, "stream": True})
        assert code == 200 and ctype == "application/x-ndjson"
        final = recs[-1]
        assert final["done"] and final["stopped"]
        want = whole["text"][:whole["text"].find(stop_s)]
        assert "".join(r["text"] for r in recs[:-1]) == final["text"] == want
        code, _, recs = _stream_post(base, {"prompt": "hello", "maxNewTokens": 3,
                                            "stream": True})
        assert code == 200 and recs[-1]["tokens"] == whole["tokens"][:3]
        assert [r["token"] for r in recs[:-1]] == whole["tokens"][:3]
        for body in ({"prompt": "x", "stop": 5}, {"prompt": "x", "stop": 5, "stream": True},
                     {"prompt": "x", "stop": [42], "stream": True}):
            code, ctype, recs = _stream_post(base, body)
            assert code == 400 and ctype == "application/json" and "stop" in recs[0]["error"]
        for _ in range(50):
            if _get(base + "/v1/stats")[1]["freeSlots"] == 2:
                break
            time.sleep(0.05)
        assert _get(base + "/v1/stats")[1]["freeSlots"] == 2
    finally:
        server.shutdown()
        server.server_close()
        cell.engine.stop()


def test_http_stream_429_and_in_band_timeout():
    """A full queue answers a stream 429 before any header; a deadline
    that passes mid-stream ends it with an in-band ``timedOut`` record."""
    cell = ServingCell("tiny", num_slots=1, max_seq_len=64, decode_chunk=4, max_pending=1,
                       device="cpu")
    server = serve(cell)
    cell.mark_ready()
    base = f"http://127.0.0.1:{server.server_address[1]}"
    try:
        cell.engine.submit(np.ones((4,), np.int32))        # fills the queue (no driver)
        code, _, recs = _stream_post(base, {"prompt": "x", "stream": True})
        assert code == 429 and "queue full" in recs[0]["error"]
        cell.engine.start()
        code, _, recs = _stream_post(base, {"prompt": "x", "maxNewTokens": 60, "stream": True,
                                            "deadlineS": 1e-4})
        assert code == 200 and recs[-1]["timedOut"] and "deadline" in recs[-1]["error"]
    finally:
        server.shutdown()
        server.server_close()
        cell.engine.stop()


def test_ndjson_error_after_headers_stays_in_band():
    """A failure after the headers went out ends the body with an
    ``{"error"}`` record, not a second status line."""
    from http.server import ThreadingHTTPServer

    class BoomCell:
        model_name = "boom"

        def readiness(self):
            return True, None

        def generate_stream(self, req, trace_ctx=None):
            yield {"token": 1, "text": "a"}
            raise RuntimeError("device lost mid-stream")

    server = ThreadingHTTPServer(("127.0.0.1", 0), make_handler(BoomCell()))
    threading.Thread(target=server.serve_forever, daemon=True).start()
    try:
        conn = http.client.HTTPConnection("127.0.0.1", server.server_address[1], timeout=30)
        conn.request("POST", "/v1/generate", body=json.dumps({"stream": True}),
                     headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        assert resp.status == 200
        lines = [json.loads(x) for x in resp.read().splitlines() if x]
        assert lines == [{"token": 1, "text": "a"},
                         {"error": "RuntimeError: device lost mid-stream"}]
    finally:
        server.shutdown()
        server.server_close()
