"""The port's tuning profiles (``kukeon_tpu_torch/serving/tuning.py``) and
their read at boot (``ServingEngine(model_name=)``, ``ServingCell``, the
CLI's ``None`` levers), on the CPU at ``tiny``, as ``tests/test_tuning.py``
holds the reference: the file round trip, stale keys and a corrupt file
as misses, explicit arguments beating the profile, and each package
reading the other's profile and layer-profile files (the same format and
keys). Greedy tokens are compared exactly.
"""

import json
import os
import socket
import subprocess
import sys
import time
import urllib.request

import numpy as np
import pytest
import torch

from kukeon_tpu.serving import tuning as jtuning
from kukeon_tpu_torch.models import llama as tl
from kukeon_tpu_torch.runtime.serving_cell import ServingCell
from kukeon_tpu_torch.serving import SamplingParams, ServingEngine
from kukeon_tpu_torch.serving import tuning

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PROMPT = np.arange(1, 9, dtype=np.int32)


@pytest.fixture()
def tune_path(tmp_path, monkeypatch):
    p = str(tmp_path / "serving_tune.json")
    monkeypatch.setenv("KUKEON_TUNE_PATH", p)
    return p


@pytest.fixture(scope="module")
def params():
    return tl.init_params(tl.llama_tiny(), torch.Generator().manual_seed(0), "cpu")


def _engine(params, **kw):
    return ServingEngine(tl.llama_tiny(), params, num_slots=2, max_seq_len=128, device="cpu",
                         **kw)


# --- the profile file -----------------------------------------------------------

def test_round_trip_and_normalization(tune_path):
    t = tuning.ServingTune(decode_chunk=64, kv_cache_int8=True, prefill_buckets=(128, 32),
                           kv_page_tokens=16, tok_per_s=261.2)
    assert tuning.save("llama3-8b", "gpu", 1, t) == tune_path
    got = tuning.load("llama3-8b", "gpu", 1)
    assert (got.decode_chunk, got.kv_cache_int8, got.prefill_buckets, got.kv_page_tokens,
            got.tok_per_s) == (64, True, (32, 128), 16, 261.2)
    assert got.tuned_at


def test_keys_coexist_and_stale_keys_miss(tune_path):
    tuning.save("llama3-8b", "gpu", 1, tuning.ServingTune(decode_chunk=64))
    tuning.save("tiny", "cpu", 1, tuning.ServingTune(decode_chunk=4))
    assert tuning.load("llama3-8b", "gpu", 1).decode_chunk == 64
    assert tuning.load("tiny", "cpu", 1).decode_chunk == 4
    for key in (("llama3-1b", "gpu", 1), ("llama3-8b", "cpu", 1), ("llama3-8b", "gpu", 4),
                (None, "gpu", 1)):
        assert tuning.load(*key) is None, key


def test_corrupt_or_missing_file_degrades(tune_path):
    assert tuning.load("tiny", "cpu", 1) is None
    with open(tune_path, "w") as f:
        f.write("{ not json")
    assert tuning.load("tiny", "cpu", 1) is None
    with open(tune_path, "w") as f:
        json.dump({"tiny|cpu|1": {"kv_cache_int8": True}}, f)
    assert tuning.load("tiny", "cpu", 1) is None            # malformed entry
    tuning.save("tiny", "cpu", 1, tuning.ServingTune(decode_chunk=4))
    assert tuning.load("tiny", "cpu", 1).decode_chunk == 4


def test_backend_names():
    assert tuning.backend_name(torch.device("cpu")) == "cpu"
    assert tuning.backend_name(torch.device("cuda", 0)) == "gpu"
    assert tuning.profile_key("llama3-8b", "gpu", 1) == jtuning.profile_key("llama3-8b", "gpu", 1)


def test_the_port_reads_the_references_file_and_the_reference_the_ports(tmp_path):
    """One file, both writers: each package's entry read back by the
    other, field for field (the reference's ``kuke`` CLI reads the port's
    profiles)."""
    path = str(tmp_path / "tune.json")
    jtuning.save("tiny", "cpu", 1, jtuning.ServingTune(
        decode_chunk=4, kv_cache_int8=True, prefill_buckets=(32, 64), kv_page_tokens=16,
        tok_per_s=12.5), path)
    tuning.save("llama3-8b", "gpu", 1, tuning.ServingTune(
        decode_chunk=64, kv_cache_int8=False, kv_page_tokens=64, tok_per_s=250.0), path)
    mine = tuning.load("tiny", "cpu", 1, path)
    theirs = jtuning.load("llama3-8b", "gpu", 1, path)
    assert mine.to_dict() == jtuning.load("tiny", "cpu", 1, path).to_dict()
    assert theirs.to_dict() == tuning.load("llama3-8b", "gpu", 1, path).to_dict()
    assert (theirs.decode_chunk, theirs.kv_page_tokens, theirs.tok_per_s) == (64, 64, 250.0)
    # Layer profiles, both ways.
    lp = str(tmp_path / "layers.json")
    jtuning.save_layer_profile("tiny", "cpu", 8, {"schema": "kukeon-layer-profile/v1",
                                                  "components": [], "errors": 0}, lp)
    tuning.save_layer_profile("tiny", "cpu", 1, {"schema": "kukeon-layer-profile/v1",
                                                 "components": [{"name": "embed"}],
                                                 "errors": 0}, lp)
    assert tuning.load_layer_profile("tiny", "cpu", 8, lp)["schema"] == "kukeon-layer-profile/v1"
    assert jtuning.load_layer_profile("tiny", "cpu", 1, lp)["components"] == [{"name": "embed"}]
    assert set(jtuning.load_layer_profiles(lp)) == set(tuning.load_layer_profiles(lp)) \
        == {"tiny|cpu|8", "tiny|cpu|1"}


# --- the engine's read at boot --------------------------------------------------------

def test_engine_takes_a_profile_the_reference_wrote(tune_path, params):
    """A profile written by ``kukeon_tpu.serving.tuning.save`` under the
    port's key: every lever left None takes it (int8 KV in the allocated
    state, the bucket ladder, the page size), and the engine serves."""
    jtuning.save("tiny", "cpu", 1, jtuning.ServingTune(
        decode_chunk=64, kv_cache_int8=True, prefill_buckets=(32, 128), kv_page_tokens=16))
    eng = _engine(params, model_name="tiny")
    assert eng.tune is not None
    assert (eng.decode_chunk, eng.kv_cache_int8, eng.prefill_buckets, eng.page_tokens) == \
        (64, True, (32, 128), 16)
    assert eng.state.cache.quantized and eng.paged
    assert len(eng.generate(PROMPT, SamplingParams(max_new_tokens=4))) == 4


def test_explicit_arguments_beat_the_profile(tune_path, params):
    tuning.save("tiny", "cpu", 1, tuning.ServingTune(decode_chunk=64, kv_cache_int8=True,
                                                     kv_page_tokens=16))
    eng = _engine(params, model_name="tiny", decode_chunk=8, kv_cache_int8=False,
                  kv_page_tokens=0)
    assert (eng.decode_chunk, eng.kv_cache_int8, eng.page_tokens) == (8, False, 0)
    assert not eng.paged and not eng.state.cache.quantized
    # kv_page_tokens 0 forces the legacy layout while the rest comes from
    # the profile.
    eng = _engine(params, model_name="tiny", kv_page_tokens=0)
    assert (eng.decode_chunk, eng.kv_cache_int8, eng.paged) == (64, True, False)


def test_stale_or_absent_profile_boots_the_defaults(tune_path, params):
    tuning.save("llama3-8b", "cpu", 1, tuning.ServingTune(decode_chunk=64, kv_cache_int8=True))
    tuning.save("tiny", "gpu", 1, tuning.ServingTune(decode_chunk=64))
    eng = _engine(params, model_name="tiny")
    assert eng.tune is None and (eng.decode_chunk, eng.kv_cache_int8, eng.page_tokens) == \
        (16, False, 0)
    with open(tune_path, "w") as f:
        f.write("{ not json")
    eng = _engine(params)                       # no model_name: never read
    assert eng.tune is None and eng.decode_chunk == 16
    eng = _engine(params, model_name="tiny")    # corrupt: a miss
    assert eng.tune is None and eng.decode_chunk == 16


@pytest.mark.parametrize("entry", [{"mesh_tensor": 2}, {"kv_shard": True}],
                         ids=["mesh_tensor", "kv_shard"])
def test_a_sharded_profile_is_refused_naming_a13(tune_path, params, entry):
    """A profile whose tensor axis is not the engine's device count, once
    refused naming A13b2, gives the engine its levers, as the reference's
    engine, which never reads ``mesh_tensor`` (C11). Its ``kv_shard``, a
    lever since tensor parallelism is ported (A13a), is taken, as the
    reference takes it; a caller that pins it keeps its own."""
    with open(tune_path, "w") as f:
        json.dump({"tiny|cpu|1": {"decode_chunk": 4, **entry}}, f)
    if "mesh_tensor" in entry:
        eng = _engine(params, model_name="tiny")
        assert eng.tune.mesh_tensor == 2 and eng.decode_chunk == 4
    else:
        eng = _engine(params, model_name="tiny")
        assert eng.tune.kv_shard is True and eng.kv_sharded and eng.decode_chunk == 4
        eng = _engine(params, model_name="tiny", kv_shard=False)
        assert not eng.kv_sharded and eng.decode_chunk == 4
    # A caller that pins every lever reads no profile.
    eng = _engine(params, model_name="tiny", decode_chunk=4, kv_cache_int8=False,
                  prefill_buckets=(64,), kv_page_tokens=0, kv_shard=True)
    assert eng.tune is None


def test_tuned_engine_gives_the_untuned_engines_tokens(tune_path, params):
    """The chunk size and the bucket ladder change how the work is cut,
    not what greedy decoding says."""
    want = _engine(params, decode_chunk=16).generate(PROMPT, SamplingParams(max_new_tokens=12))
    tuning.save("tiny", "cpu", 1, tuning.ServingTune(decode_chunk=4, prefill_buckets=(16, 128)))
    eng = _engine(params, model_name="tiny")
    assert eng.decode_chunk == 4 and eng.generate(PROMPT, SamplingParams(max_new_tokens=12)) \
        == want


# --- the cell and its CLI ----------------------------------------------------------------

def test_cell_boots_from_the_profile_and_reports_it(tune_path):
    tuning.save("tiny", "cpu", 1, tuning.ServingTune(decode_chunk=4, tok_per_s=99.0))
    cell = ServingCell("tiny", num_slots=2, max_seq_len=64, device="cpu")
    assert cell.engine.decode_chunk == 4
    assert cell.stats()["tuning"] == {"decodeChunk": 4, "kvCacheInt8": False,
                                      "kvPageTokens": 0, "fromProfile": True}
    assert cell.generate({"prompt": "hello", "maxNewTokens": 4})["numTokens"] == 4
    pinned = ServingCell("tiny", num_slots=2, max_seq_len=64, device="cpu", decode_chunk=16)
    assert pinned.engine.decode_chunk == 16 and pinned.stats()["tuning"]["fromProfile"]


def test_moe_cell_never_takes_int8_kv_from_a_profile(tune_path):
    tuning.save("mixtral-tiny", "cpu", 1, tuning.ServingTune(decode_chunk=4, kv_cache_int8=True))
    cell = ServingCell("mixtral-tiny", num_slots=2, max_seq_len=64, device="cpu")
    assert cell.engine.decode_chunk == 4 and not cell.engine.kv_cache_int8


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_cli_levers_left_out_take_the_profile(tmp_path):
    """``python -m kukeon_tpu_torch.runtime.serving_cell`` without
    ``--decode-chunk``/``--kv-cache-int8``/``--kv-page-tokens`` boots at the
    profile's levers (``/v1/stats``), then drains to exit 0."""
    path = str(tmp_path / "tune.json")
    tuning.save("tiny", "cpu", 1, tuning.ServingTune(decode_chunk=4, kv_cache_int8=True,
                                                     kv_page_tokens=16), path)
    port = _free_port()
    env = {**os.environ, "KUKEON_TUNE_PATH": path, "KUKEON_WATCHDOG_S": "0",
           "OMP_NUM_THREADS": "2"}
    proc = subprocess.Popen(
        [sys.executable, "-m", "kukeon_tpu_torch.runtime.serving_cell", "--model", "tiny",
         "--device", "cpu", "--port", str(port), "--num-slots", "2", "--max-seq-len", "128"],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        base = f"http://127.0.0.1:{port}"
        deadline = time.monotonic() + 60
        while True:
            try:
                with urllib.request.urlopen(base + "/v1/stats", timeout=5) as r:
                    stats = json.loads(r.read())
                if stats["ready"]:
                    break
            except OSError:
                pass
            assert proc.poll() is None and time.monotonic() < deadline, proc.stdout.read()
            time.sleep(0.2)
        assert stats["tuning"] == {"decodeChunk": 4, "kvCacheInt8": True, "kvPageTokens": 16,
                                   "fromProfile": True}
        req = urllib.request.Request(base + "/drain", data=b"{}", method="POST")
        urllib.request.urlopen(req, timeout=10).read()
        assert proc.wait(timeout=60) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


# --- the writer -------------------------------------------------------------------

def test_autotune_sweeps_its_arms_and_saves_a_winner_the_reference_reads(tmp_path, capsys):
    """``tools/autotune.py`` at ``tiny`` on the CPU over four arms of the
    grid (a plain chunk, the coarse buckets, both paged caches): each arm boots
    a cell through a profile of its own and takes its levers, and serves
    with no error; the winner lands in ``KUKEON_TUNE_PATH``, and the
    reference's ``tuning.load`` reads it."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "autotune", os.path.join(ROOT, "tools", "autotune.py"))
    autotune = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(autotune)
    path = str(tmp_path / "serving_tune.json")
    old = os.environ.get("KUKEON_TUNE_PATH")
    os.environ["KUKEON_TUNE_PATH"] = path
    try:
        rc = autotune.main(["--device", "cpu", "--model", "tiny", "--max-seq-len", "256",
                            "--prompt-len", "32", "--new", "6", "--num-slots", "2",
                            "--arms", "chunk4,chunk64+coarse-buckets,chunk64+paged64,"
                                      "chunk64+paged128"])
    finally:
        if old is None:
            os.environ.pop("KUKEON_TUNE_PATH", None)
        else:
            os.environ["KUKEON_TUNE_PATH"] = old
    assert rc == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    arms = line["arms"]
    assert set(arms) == {"chunk4", "chunk64+coarse-buckets", "chunk64+paged64",
                         "chunk64+paged128"}
    assert not [n for n, r in arms.items() if "error" in r]
    took = {n: (r["decode_chunk"], r["kv_page_tokens"], tuple(r["prefill_buckets"]))
            for n, r in arms.items()}
    assert took["chunk4"][:2] == (4, 0)
    assert took["chunk64+coarse-buckets"] == (64, 0, (256, 1024, 4096))
    assert took["chunk64+paged64"][:2] == (64, 64)
    assert took["chunk64+paged128"] == (64, 128, (128, 256, 512, 1024, 2048, 4096))
    best = line["best"]["arm"]
    assert line["profile"] == {"path": path, "key": "tiny|cpu|1"}
    got = jtuning.load("tiny", "cpu", 1, path=path)
    levers = arms[best]["levers"]
    assert got.decode_chunk == levers["decode_chunk"]
    assert (got.kv_page_tokens or 0) == levers["kv_page_tokens"]
    assert got.prefill_buckets == (tuple(levers["prefill_buckets"])
                                   if levers.get("prefill_buckets") else None)
