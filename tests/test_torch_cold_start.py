"""The port's streamed checkpoint boot (``models/checkpoints.py``
``CheckpointStream``/``stream_quantized``, ``models/hf_convert.py``
``stream_params``/``stream_params_quantized``, the engine's streamed
constructor and its load thread, the cell's ``_load_checkpoint``, ``warmup``
and ``finish_boot``) against the materialized loaders and the JAX
package's streams, on the CPU at ``tiny``, as ``tests/test_cold_start.py``
holds the reference.

Tolerances: every leaf is compared bit for bit (dtype, shape and raw
bits); greedy tokens exactly.
"""

import threading
import time

import ml_dtypes
import numpy as np
import pytest
import torch

from kukeon_tpu.models import checkpoints as jck
from kukeon_tpu.models import hf_convert as jhf
from kukeon_tpu.runtime.serving_cell import ServingCell as JaxCell
from kukeon_tpu_torch import faults
from kukeon_tpu_torch.models import checkpoints as tck
from kukeon_tpu_torch.models import hf_convert as thf
from kukeon_tpu_torch.models import llama as tl
from kukeon_tpu_torch.models.checkpoints import (
    CheckpointStream,
    CheckpointStreamError,
    TensorSpec,
    _walk_tree,
)
from kukeon_tpu_torch.obs import expo
from kukeon_tpu_torch.runtime.serving_cell import ServingCell
from kukeon_tpu_torch.serving import SamplingParams, ServingEngine

torch.set_num_threads(2)

PROMPT = np.array([5, 300, 7, 200, 9, 41, 77, 13, 250, 3, 99], np.int32)
GREEDY = SamplingParams(max_new_tokens=8)


@pytest.fixture(autouse=True)
def _port_faults(monkeypatch):
    monkeypatch.delenv(faults.ENV, raising=False)
    faults.reset()
    yield
    faults.reset()


@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
    """A tiny HF checkpoint in f32 (tied) and one in f16 (untied), over
    several shards, written by the port's synthesizer; the f32 one's int8
    twin written by the port's save_quantized."""
    out = {}
    for name, cfg, dtype in (("f32", tl.llama_tiny(), torch.float32),
                             ("f16", _untied(), torch.float16)):
        d = str(tmp_path_factory.mktemp(f"hf_{name}"))
        tck.synthesize_hf_checkpoint(d, cfg, seed=3, dtype=dtype, max_shard_bytes=300_000,
                                     tokenizer=False)
        out[name] = d
    out["quant"] = str(tmp_path_factory.mktemp("quant"))
    tck.save_quantized(out["quant"], *thf.load_params_quantized(out["f32"]))
    return out


def _untied():
    import dataclasses

    return dataclasses.replace(tl.llama_tiny(), tie_embeddings=False)


def _raw(x) -> tuple[str, tuple, bytes]:
    """(dtype name, shape, raw bytes) of a torch tensor or a numpy array."""
    if isinstance(x, torch.Tensor):
        name = str(x.dtype).removeprefix("torch.")
        return name, tuple(x.shape), x.contiguous().view(torch.uint8).numpy().tobytes()
    a = np.ascontiguousarray(x)
    return a.dtype.name, tuple(a.shape), a.tobytes()


def _assert_leaves_equal(got: dict, want_tree) -> None:
    want = dict(_walk_tree(want_tree))
    assert set(got) == set(want)
    for k in want:
        assert _raw(got[k]) == _raw(want[k]), k
        if isinstance(got[k], torch.Tensor):
            assert got[k].is_contiguous(), k


def _stream_cases(dirs):
    return {
        "quantized": (lambda: tck.stream_quantized(dirs["quant"]),
                      lambda: tck.load_quantized(dirs["quant"])[0],
                      lambda: jck.stream_quantized(dirs["quant"], dtype="bfloat16")),
        "hf_bf16": (lambda: thf.stream_params(dirs["f16"]),
                    lambda: thf.load_params(dirs["f16"])[0],
                    lambda: jhf.stream_params(dirs["f16"])),
        "hf_f32": (lambda: thf.stream_params(dirs["f32"], dtype=torch.float32),
                   lambda: thf.load_params(dirs["f32"], dtype=torch.float32)[0],
                   lambda: jhf.stream_params(dirs["f32"], dtype=np.float32)),
        "hf_int8_tied": (lambda: thf.stream_params_quantized(dirs["f32"]),
                         lambda: thf.load_params_quantized(dirs["f32"])[0],
                         lambda: jhf.stream_params_quantized(dirs["f32"])),
        "hf_int8_untied": (lambda: thf.stream_params_quantized(dirs["f16"]),
                           lambda: thf.load_params_quantized(dirs["f16"])[0],
                           lambda: jhf.stream_params_quantized(dirs["f16"])),
    }


CASES = ("quantized", "hf_bf16", "hf_f32", "hf_int8_tied", "hf_int8_untied")


@pytest.mark.parametrize("case", CASES)
def test_stream_leaves_equal_the_materialized_loaders(dirs, case):
    stream_fn, load_fn, _ = _stream_cases(dirs)[case]
    stream = stream_fn()
    got = dict(stream)
    _assert_leaves_equal(got, load_fn())
    st = stream.stat_snapshot()
    assert st["tensors"] == len(got) == stream.total_leaves
    assert st["bytes"] == sum(t.numel() * t.element_size() for t in got.values())
    assert st["disk_s"] > 0.0 and st["cast_s"] >= 0.0


@pytest.mark.parametrize("case", CASES)
def test_stream_leaves_equal_the_references_stream(dirs, case):
    """The reference's stream on the same directory: the same paths, and
    every leaf's dtype, shape and bits (bf16 through ml_dtypes there)."""
    stream_fn, _, ref_fn = _stream_cases(dirs)[case]
    got = dict(stream_fn())
    ref = dict(ref_fn())
    assert set(got) == set(ref)
    for k, a in ref.items():
        a = np.asarray(a)
        assert _raw(got[k]) == _raw(a), (k, a.dtype)
    assert any(np.asarray(a).dtype == ml_dtypes.bfloat16 for a in ref.values()) \
        == (case != "hf_f32")


@pytest.mark.parametrize("case", CASES)
def test_abstract_tree_mirrors_the_tree(dirs, case):
    """The abstract tree (what the engine allocates and captures from)
    comes from headers and configs alone, and has the real tree's shapes
    and dtypes."""
    stream_fn, load_fn, _ = _stream_cases(dirs)[case]
    stream = stream_fn()
    stream.close()
    ab = dict(_walk_tree(stream.abstract_params))
    real = dict(_walk_tree(load_fn()))
    assert set(ab) == set(real)
    for k, spec in ab.items():
        assert isinstance(spec, TensorSpec)
        assert spec.shape == tuple(real[k].shape) and spec.dtype == real[k].dtype, k
        assert spec.nbytes == real[k].numel() * real[k].element_size()


def test_stream_pipeline_overlaps_reads_and_consumer():
    """The reference's overlap proof, device-free: throttled jobs (a slow
    'disk') under a throttled consumer (a slow 'upload') finish well under
    the serial sum."""
    N, D, U = 8, 0.05, 0.05
    abstract = {f"t{i}": TensorSpec((4,), torch.float32) for i in range(N)}

    def make_job(i):
        def job():
            t0 = time.monotonic()
            time.sleep(D)
            return [((f"t{i}",), torch.full((4,), float(i)))], time.monotonic() - t0, 0.0
        return job

    stream = CheckpointStream(abstract, None, [make_job(i) for i in range(N)], threads=2,
                              buffer_bytes=32)
    t0 = time.monotonic()
    seen = []
    for path, _t in stream:
        time.sleep(U)
        seen.append(path)
    wall = time.monotonic() - t0
    assert len(seen) == N and wall < N * (D + U) * 0.75, wall
    assert stream.stat_snapshot()["disk_s"] >= N * D * 0.9


@pytest.mark.parametrize("budget,held", [(1000, 800), (100, 400)], ids=["two_jobs", "one_job"])
def test_stream_reads_ahead_by_at_most_its_byte_budget(budget, held):
    """Four readers ahead of a slow consumer queue at most ``buffer_bytes``
    of leaves (400 bytes a job: two in 1000), or one job alone when a job
    is larger than the budget; every leaf still arrives, whole."""
    N = 8
    abstract = {f"t{i}": TensorSpec((100,), torch.float32) for i in range(N)}
    peak = []

    class Watched(CheckpointStream):
        def _put(self, items):
            ok = super()._put(items)
            with self._cond:
                peak.append(self._queued)
            return ok

    def make_job(i):
        def job():
            time.sleep(0.01)
            return [((f"t{i}",), torch.full((100,), float(i)))], 0.0, 0.0
        return job

    stream = Watched(abstract, None, [make_job(i) for i in range(N)], threads=4,
                     buffer_bytes=budget)
    got = {}
    for path, t in stream:
        got[path] = t
        time.sleep(0.03)
    assert sorted(got) == sorted((k,) for k in abstract)
    assert all(torch.equal(got[(f"t{i}",)], torch.full((100,), float(i))) for i in range(N))
    assert max(peak) == held, peak


@pytest.mark.parametrize("budget", [0, 1 << 30], ids=["none", "large"])
def test_every_reader_runs_whatever_the_byte_budget(budget):
    """The byte bound holds back only what is queued: four readers run
    their jobs at once (each job waits for the other three at a barrier,
    which times out if the readers ran one by one) even when nothing may
    be queued ahead of the consumer."""
    N = 8
    abstract = {f"t{i}": TensorSpec((100,), torch.float32) for i in range(N)}
    together = threading.Barrier(4, timeout=10)

    def make_job(i):
        def job():
            if i < 4:
                together.wait()
            return [((f"t{i}",), torch.full((100,), float(i)))], 0.0, 0.0
        return job

    stream = CheckpointStream(abstract, None, [make_job(i) for i in range(N)], threads=4,
                              buffer_bytes=budget)
    got = dict(stream)
    assert sorted(got) == sorted((k,) for k in abstract)


def test_reader_errors_and_short_streams_fail_clean():
    """A job that raises surfaces as CheckpointStreamError on the consumer;
    so does a stream whose readers end short of the abstract tree; and
    each reader thread's finalize runs."""
    abstract = {"a": TensorSpec((2,), torch.float32), "b": TensorSpec((2,), torch.float32)}
    finals = []

    def ok():
        return [(("a",), torch.zeros(2))], 0.0, 0.0

    def boom():
        raise OSError("disk gone")

    with pytest.raises(CheckpointStreamError, match="OSError: disk gone"):
        dict(CheckpointStream(abstract, None, [ok, boom], threads=1,
                              finalize=lambda: finals.append(1)))
    with pytest.raises(CheckpointStreamError, match="1 of 2 leaves"):
        dict(CheckpointStream(abstract, None, [ok], threads=2))
    assert finals == [1]


def test_streamed_loaders_check_the_tensor_names(dirs, tmp_path):
    """Before a byte is read: a tensor the mapping does not know, or one
    it needs and the index lacks, is refused (the reference's messages)."""
    import json
    import shutil

    d = tmp_path / "hf"
    shutil.copytree(dirs["f32"], d)
    idx_path = d / "model.safetensors.index.json"
    idx = json.loads(idx_path.read_text())
    shard = idx["weight_map"]["model.norm.weight"]
    idx["weight_map"]["model.extra.weight"] = shard
    idx_path.write_text(json.dumps(idx))
    with pytest.raises(ValueError, match="unmapped tensors"):
        thf.stream_params(str(d))
    del idx["weight_map"]["model.extra.weight"], idx["weight_map"]["model.norm.weight"]
    idx_path.write_text(json.dumps(idx))
    with pytest.raises(ValueError, match="missing tensors"):
        thf.stream_params_quantized(str(d))


# --- the engine and the cell ------------------------------------------------------

def test_streamed_engine_generates_the_materialized_engines_tokens(dirs):
    """An engine booted from a stream (its load thread) gives the
    tokens of one booted from the materialized tree, and keeps the boot's
    accounting on load_stats, not on the serving path's sync_stats."""
    ref, cfg = tck.load_quantized(dirs["quant"])
    want = ServingEngine(cfg, ref, num_slots=2, max_seq_len=64, device="cpu").generate(
        PROMPT, GREEDY)
    stream = tck.stream_quantized(dirs["quant"])
    eng = ServingEngine(stream.cfg, stream, num_slots=2, max_seq_len=64, device="cpu")
    uploads0 = eng.sync_stats["uploads"]
    assert eng.generate(PROMPT, GREEDY) == want
    ls = eng.load_stats
    leaf_bytes = sum(t.numel() * t.element_size() for _, t in _walk_tree(eng.params))
    assert ls["tensors"] == stream.total_leaves and ls["bytes"] == leaf_bytes
    assert ls["upload_s"] > 0.0
    # Serving uploads (the prompt, the sampling arrays) only: the boot's
    # copies are not on the host-sync ledger.
    assert eng.sync_stats["uploads"] - uploads0 <= 6
    marks = eng.boot_marks
    assert marks["load_start"] <= marks["first_leaf"] <= marks["last_leaf"] <= marks["load_done"]
    fams = {f[0]: f for f in eng._obs_collect()}
    stages = {lab["stage"]: v for lab, v in fams["kukeon_checkpoint_load_seconds"][3]}
    assert stages["disk"] > 0.0 and stages["upload"] > 0.0
    (_lab, nbytes), = fams["kukeon_checkpoint_load_bytes_total"][3]
    assert nbytes == float(leaf_bytes)


@pytest.mark.parametrize("wait_first", [True, False], ids=["loaded-then-served", "load-thread"])
def test_streamed_engine_from_hf_int8(dirs, wait_first):
    """Served once the load is waited for, or with the load thread still
    running when the first request comes."""
    ref, cfg = thf.load_params_quantized(dirs["f16"])
    want = ServingEngine(cfg, ref, num_slots=2, max_seq_len=64, device="cpu").generate(
        PROMPT, GREEDY)
    stream = thf.stream_params_quantized(dirs["f16"])
    eng = ServingEngine(stream.cfg, stream, num_slots=2, max_seq_len=64, device="cpu")
    if wait_first:
        eng._ensure_loaded()
        assert eng._loaded.is_set()
    assert eng.generate(PROMPT, GREEDY) == want
    _assert_leaves_equal(dict(_walk_tree(eng.params)), ref)


def test_precompile_returns_while_a_reader_is_held(dirs):
    """precompile needs the abstract tree alone: it returns while the
    stream has not yielded a leaf; the engine serves once the gate opens."""
    ref, cfg = tck.load_quantized(dirs["quant"])
    stream = tck.stream_quantized(dirs["quant"])
    stream.close()
    gate = threading.Event()

    class Gated:
        abstract_params = stream.abstract_params

        def stat_snapshot(self):
            return {}

        def close(self):
            pass

        def __iter__(self):
            gate.wait()
            yield from _walk_tree(ref)

    eng = ServingEngine(cfg, Gated(), num_slots=2, max_seq_len=64, device="cpu")
    eng.precompile((8,))
    assert not eng._loaded.is_set() and eng.load_stats["tensors"] == 0
    gate.set()
    want = ServingEngine(cfg, ref, num_slots=2, max_seq_len=64, device="cpu").generate(
        PROMPT, GREEDY)
    assert eng.generate(PROMPT, GREEDY) == want


@pytest.mark.parametrize("source,dtype", [("quant", None), ("f32", "int8"), ("f32", None)],
                         ids=["quantized", "hf-int8", "hf-f32"])
def test_streamed_port_cell_gives_the_jax_cells_tokens(dirs, source, dtype):
    body = {"promptTokens": PROMPT.tolist(), "maxNewTokens": 8}
    jc = JaxCell("tiny", num_slots=2, max_seq_len=64, checkpoint=dirs[source], dtype=dtype)
    tc = ServingCell("tiny", num_slots=2, max_seq_len=64, checkpoint=dirs[source], dtype=dtype,
                     device="cpu")
    assert tc.engine._ckpt_stream is not None
    tc.warmup(16)
    want = jc.generate(body)["tokens"]
    assert tc.generate(body)["tokens"] == want and len(want) == 8


def test_armed_stream_fault_fails_the_engine_and_exits_the_cell(dirs, monkeypatch):
    """checkpoint.stream armed: the stream raises CheckpointStreamError;
    an engine on it fails its load with that cause; a cell on it exits
    from warmup with the reference's message, never ready."""
    monkeypatch.setenv(faults.ENV, "checkpoint.stream:1:1")
    faults.reset()
    with pytest.raises(CheckpointStreamError):
        dict(tck.stream_quantized(dirs["quant"]))
    assert faults.fired("checkpoint.stream") == 1

    faults.reset()
    stream = tck.stream_quantized(dirs["quant"])
    eng = ServingEngine(stream.cfg, stream, num_slots=2, max_seq_len=64, device="cpu")
    with pytest.raises(RuntimeError, match="weight load failed") as ei:
        eng.generate(PROMPT, GREEDY)
    assert isinstance(ei.value.__cause__, CheckpointStreamError)

    faults.reset()
    cell = ServingCell("tiny", num_slots=2, max_seq_len=64, checkpoint=dirs["quant"],
                       device="cpu")
    with pytest.raises(SystemExit, match="checkpoint stream failed during boot"):
        cell.warmup(16)
    assert faults.fired("checkpoint.stream") >= 1
    assert not cell.readiness()[0]


def test_stream_fault_armed_at_prob_zero_boots(dirs, monkeypatch):
    monkeypatch.setenv(faults.ENV, "checkpoint.stream:0")
    faults.reset()
    cell = ServingCell("tiny", num_slots=2, max_seq_len=64, checkpoint=dirs["quant"],
                       device="cpu")
    cell.warmup(16)
    assert cell.generate({"promptTokens": [3, 1, 4], "maxNewTokens": 4})["numTokens"] == 4
    assert faults.fired("checkpoint.stream") == 0


def test_engine_upload_fault_fails_a_boot_and_a_request_cleanly(dirs, monkeypatch):
    """engine.upload armed once: during a streamed boot the load fails
    (its cause the injected fault); in serving, the request fails and the
    engine serves the next one."""
    monkeypatch.setenv(faults.ENV, "engine.upload:1:1")
    faults.reset()
    stream = tck.stream_quantized(dirs["quant"])
    eng = ServingEngine(stream.cfg, stream, num_slots=2, max_seq_len=64, device="cpu")
    with pytest.raises(RuntimeError, match="weight load failed") as ei:
        eng._ensure_loaded()
    assert isinstance(ei.value.__cause__, faults.FaultInjected)

    ref, cfg = tck.load_quantized(dirs["quant"])
    eng = ServingEngine(cfg, ref, num_slots=2, max_seq_len=64, device="cpu")
    faults.reset()
    with pytest.raises(RuntimeError, match="injected fault"):
        eng.generate(PROMPT, GREEDY)
    assert faults.fired("engine.upload") == 1
    assert len(eng.generate(PROMPT, GREEDY)) == 8


@pytest.mark.parametrize("source,dtype", [("quant", None), ("f16", "int8")],
                         ids=["quantized", "hf-int8"])
def test_finish_boot_adds_the_load_stages(dirs, source, dtype):
    """A streamed boot's phases carry the disk, cast and upload seconds on
    top of the serial partition (so they sum past the total), and
    kukeon_checkpoint_load_bytes_total equals the tree's leaf bytes."""
    cell = ServingCell("tiny", num_slots=2, max_seq_len=64, checkpoint=dirs[source],
                       dtype=dtype, device="cpu")
    cell.warmup(16)
    phases = cell.finish_boot()
    for stage in ("disk", "cast", "upload"):
        assert stage in phases, phases
    assert phases["disk"] > 0.0 and phases["upload"] > 0.0
    total = cell.registry.get("kukeon_cold_start_seconds").value()
    assert sum(phases.values()) > total
    leaf_bytes = sum(t.numel() * t.element_size() for _, t in _walk_tree(cell.engine.params))
    text = expo.render(cell.registry)
    line = next(x for x in text.splitlines()
                if x.startswith("kukeon_checkpoint_load_bytes_total"))
    assert float(line.split()[-1]) == leaf_bytes


def test_a_materialized_boot_has_no_load_stages():
    cell = ServingCell("tiny", num_slots=2, max_seq_len=64, device="cpu")
    cell.warmup(16)
    phases = cell.finish_boot()
    assert not {"disk", "cast", "upload"} & set(phases)
    assert cell.engine.load_stats["bytes"] == 0


def test_reference_reads_the_ports_quantized_checkpoint_through_its_stream(dirs):
    """The other direction: the reference's cell streams the directory the
    port wrote and gives the port's streamed cell's tokens."""
    body = {"promptTokens": [7, 8, 9, 10], "maxNewTokens": 6}
    want = ServingCell("tiny", num_slots=2, max_seq_len=64, checkpoint=dirs["quant"],
                       device="cpu").generate(body)["tokens"]
    jc = JaxCell("tiny", num_slots=2, max_seq_len=64, checkpoint=dirs["quant"], dtype=None)
    assert jc.engine._ckpt_stream is not None
    assert jc.generate(body)["tokens"] == want
