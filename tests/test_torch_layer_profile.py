"""The port's per-layer profile (``kukeon_tpu_torch/obs/profile.py``
``profile_layers``, ``layer_cost``) and the cell's ``POST /v1/profile
{"layers": true}``, on the CPU at ``tiny``, as ``tests/test_profile.py``
(``:196-353``) holds the reference: the schema, the component names, the
prefill FLOPs summing to the whole model within 5%, wall times, the armed
``profile.layers`` fault recorded and not fatal, and a port cell's profile
over HTTP persisted where the reference's ``kuke profile layers`` reads and
renders it. FLOP counts are compared exactly where they are plain counts.
"""

import http.client
import json
import os
import threading
from http.server import ThreadingHTTPServer

import pytest
import torch

from kukeon_tpu.runtime.cli import render_layer_profile
from kukeon_tpu.serving import tuning as jtuning
from kukeon_tpu_torch import faults
from kukeon_tpu_torch.models import llama as tl
from kukeon_tpu_torch.obs.profile import (
    LAYER_PROFILE_SCHEMA,
    layer_cost,
    profile_layers,
    program_cost,
)
from kukeon_tpu_torch.runtime.serving_cell import ServingCell, make_handler
from kukeon_tpu_torch.serving import tuning

torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def _port_faults(monkeypatch):
    monkeypatch.delenv(faults.ENV, raising=False)
    faults.reset()
    yield
    faults.reset()


@pytest.fixture(scope="module")
def params():
    return tl.init_params(tl.llama_tiny(), torch.Generator().manual_seed(0), "cpu")


@pytest.mark.parametrize("int8", [False, True], ids=["bf16", "int8"])
def test_schema_names_and_flops_sum_to_the_whole_model(params, int8):
    cfg = tl.llama_tiny()
    p = tl.quantize_params(params) if int8 else params
    prof = profile_layers(p, cfg, "cpu", prefill_len=16, decode_batch=2, measure=False)
    assert prof["schema"] == LAYER_PROFILE_SCHEMA == "kukeon-layer-profile/v1"
    assert prof["errors"] == 0 and (prof["prefill_len"], prof["decode_batch"]) == (16, 2)
    names = [c["name"] for c in prof["components"]]
    assert names == ["embed"] + [f"layer{i}" for i in range(cfg.num_layers)] + ["head"]
    total = sum(c["prefill"]["flops"] for c in prof["components"])
    assert abs(total - prof["model_flops"]) / prof["model_flops"] < 0.05
    # The whole model is the engine's own prefill count; the components add
    # the embedding's casts to it and nothing else.
    want_flops, want_bytes = program_cost(cfg, "prefill", ("prefill", 16, False, False),
                                          num_slots=1, max_seq_len=16, int8_weights=int8)
    assert (prof["model_flops"], prof["model_bytes"]) == (want_flops, want_bytes)
    assert total - prof["model_flops"] == 16 * cfg.hidden_size
    for c in prof["components"]:
        for shape in ("prefill", "decode"):
            assert c[shape]["flops"] > 0 and c[shape]["bytes"] > 0 and "wall_s" not in c[shape]


def test_layer_cost_by_hand():
    """One llama3-8b layer at decode B 4: 2 x 218,103,808 projection
    elements a token plus 4 H d of attention a query; int8 bytes: one a
    weight and 4 an output column, plus the rows in and out."""
    cfg = tl.llama3_8b()
    mats = 4096 * (4096 + 2 * 1024) + 4096 * 4096 + 3 * 4096 * 14336
    assert mats == 218_103_808
    cols = 4096 + 2 * 1024 + 4096 + 2 * 14336 + 4096
    flops, nbytes = layer_cost(cfg, "layer", 4, 1, int8_weights=True)
    assert flops == 2.0 * 4 * mats + 4.0 * 32 * 128 * 4
    assert nbytes == mats + 4 * cols + 2 * 4 * 4096 * 2
    flops, nbytes = layer_cost(cfg, "head", 4, 1, int8_weights=True)
    assert flops == 2.0 * 4 * 4096 * 128256
    assert nbytes == 128256 * 4096 + 4 * 128256 + 4 * 4096 * 2 + 4 * 128256 * 4


def test_wall_times_are_measured(params):
    prof = profile_layers(params, tl.llama_tiny(), "cpu", prefill_len=8, decode_batch=1, reps=1)
    assert prof["errors"] == 0
    for c in prof["components"]:
        assert c["prefill"]["wall_s"] >= 0 and c["decode"]["wall_s"] >= 0


def test_armed_fault_is_recorded_per_component(params, monkeypatch):
    """``profile.layers`` armed at probability 1: every component records
    an error entry (the injected fault) and the profile still returns."""
    cfg = tl.llama_tiny()
    monkeypatch.setenv(faults.ENV, "profile.layers:1")
    prof = profile_layers(params, cfg, "cpu", prefill_len=8, decode_batch=1, measure=False)
    assert prof["errors"] == cfg.num_layers + 2
    assert all("FaultInjected" in c["error"] for c in prof["components"])
    assert faults.fired("profile.layers") == cfg.num_layers + 2
    # Capped at one fire: the second shape's check of the first component
    # never runs; every later component profiles cleanly.
    faults.reset()
    monkeypatch.setenv(faults.ENV, "profile.layers:1:1")
    prof = profile_layers(params, cfg, "cpu", prefill_len=8, decode_batch=1, measure=False)
    assert prof["errors"] == 1 and "error" in prof["components"][0]
    assert all("error" not in c for c in prof["components"][1:])


def test_profile_runs_under_the_guard(params):
    held = []

    class Guard:
        def __enter__(self):
            held.append("in")

        def __exit__(self, *exc):
            held.append("out")

    profile_layers(params, tl.llama_tiny(), "cpu", prefill_len=4, decode_batch=1,
                   measure=False, guard=Guard())
    assert held == ["in", "out"]


# --- the live cell over HTTP --------------------------------------------------------------

@pytest.fixture(scope="module")
def live_cell():
    cell = ServingCell("tiny", num_slots=2, max_seq_len=96, device="cpu", decode_chunk=4,
                       dtype="int8")
    cell.warmup(16)
    cell.engine.start()
    cell.mark_ready()
    server = ThreadingHTTPServer(("127.0.0.1", 0), make_handler(cell))
    threading.Thread(target=server.serve_forever, daemon=True).start()
    yield cell, server.server_address[1]
    server.shutdown()
    server.server_close()
    cell.engine.stop()


def _post(port, path, body):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    conn.request("POST", path, body=json.dumps(body), headers={"Content-Type": "application/json"})
    resp = conn.getresponse()
    raw = resp.read()
    conn.close()
    return resp.status, json.loads(raw)


def test_cell_layer_profile_over_http_is_persisted_and_rendered(live_cell, tmp_path,
                                                                monkeypatch):
    """``POST /v1/profile {"layers": true}`` profiles the live int8 model
    and persists it under ``tiny|cpu|1``; the reference reads the file and
    its ``kuke profile layers`` renderer draws it."""
    _cell, port = live_cell
    store = tmp_path / "layer_profile.json"
    monkeypatch.setenv("KUKEON_LAYER_PROFILE_PATH", str(store))
    status, prof = _post(port, "/v1/profile", {"layers": True, "prefillLen": 8, "decodeBatch": 2})
    assert status == 200 and prof["errors"] == 0
    assert prof["path"] == str(store) and prof["key"] == "tiny|cpu|1"
    assert len(prof["components"]) == tl.llama_tiny().num_layers + 2
    stored = jtuning.load_layer_profiles()
    assert stored[prof["key"]]["profiled_at"]
    assert stored[prof["key"]]["components"] == prof["components"]
    assert tuning.load_layer_profile("tiny", "cpu", 1) == stored[prof["key"]]
    out = render_layer_profile(prof["key"], stored[prof["key"]])
    assert "COMPONENT" in out and "layer0" in out and "prefill" in out


def test_cell_layer_profile_fault_is_recorded_not_fatal(live_cell, tmp_path, monkeypatch):
    _cell, port = live_cell
    monkeypatch.setenv("KUKEON_LAYER_PROFILE_PATH", str(tmp_path / "layers.json"))
    monkeypatch.setenv(faults.ENV, "profile.layers:1")
    status, prof = _post(port, "/v1/profile", {"layers": True, "prefillLen": 8, "decodeBatch": 1})
    monkeypatch.delenv(faults.ENV)
    faults.reset()
    assert status == 200 and prof["errors"] > 0 and "path" not in prof
    assert not os.path.exists(tmp_path / "layers.json")
    status, out = _post(port, "/v1/generate", {"promptTokens": [1, 2, 3], "maxNewTokens": 2})
    assert status == 200 and out["numTokens"] == 2


def test_bad_profile_arguments_answer_400(live_cell):
    _cell, port = live_cell
    status, out = _post(port, "/v1/profile", {"layers": True, "prefillLen": "long"})
    assert status == 400 and "error" in out


def test_the_port_reads_a_layer_profile_the_reference_wrote(tmp_path, monkeypatch):
    """A profile the reference's writer stored is read back by the port
    under the same key (the port's CLI-free reader)."""
    monkeypatch.setenv("KUKEON_LAYER_PROFILE_PATH", str(tmp_path / "layers.json"))
    prof = profile_layers(tl.init_params(tl.llama_tiny(), torch.Generator().manual_seed(1), "cpu"),
                          tl.llama_tiny(), "cpu", prefill_len=4, decode_batch=1, measure=False)
    jtuning.save_layer_profile("tiny", "gpu", 1, prof)
    got = tuning.load_layer_profile("tiny", "gpu", 1)
    assert got["components"] == prof["components"] and got["schema"] == LAYER_PROFILE_SCHEMA
