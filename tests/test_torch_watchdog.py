"""The port cell's watchdog (``kukeon_tpu_torch/runtime/serving_cell.py``
``EngineWatchdog``) and its CUDA runtime probe
(``kukeon_tpu_torch/runtime/devices.py`` ``probe_cuda_runtime``): the
ports of ``tests/test_serving_resilience.py:202-277`` and
``tests/test_obs.py:492``, on the CPU. Every wedged verdict is injected
(the ``devices.probe_wedged`` fault point or a scripted probe), never
waited for; the last test runs ``python -m
kukeon_tpu_torch.runtime.serving_cell`` under the fault and a short
``KUKEON_WATCHDOG_S`` and sees it exit 86.
"""

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

from kukeon_tpu_torch import faults
from kukeon_tpu_torch.models import llama as tl
from kukeon_tpu_torch.obs import Registry
from kukeon_tpu_torch.runtime import serving_cell
from kukeon_tpu_torch.runtime.devices import probe_cuda_runtime
from kukeon_tpu_torch.runtime.serving_cell import WEDGED_EXIT_CODE, EngineWatchdog
from kukeon_tpu_torch.serving import SamplingParams, ServingEngine

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _port_faults():
    os.environ.pop(faults.ENV, None)
    faults.reset()
    yield
    os.environ.pop(faults.ENV, None)
    faults.reset()


class _StalledEngine:
    """Engine stand-in with a controllable progress heartbeat."""

    def __init__(self, busy=True):
        self.busy = busy
        self._lock = threading.Lock()
        self.last_progress = time.monotonic()

    def stalled_s(self) -> float:
        if not self.busy:
            return 0.0
        return time.monotonic() - self.last_progress


def _watchdog(eng, probe, budget=0.05, **kw):
    return EngineWatchdog(eng, stall_budget_s=budget, probe=probe, interval_s=0.01, **kw)


def test_watchdog_trips_on_wedged_probe():
    eng = _StalledEngine()
    eng.last_progress -= 10
    hits: list[str] = []
    wd = _watchdog(eng, probe=lambda timeout_s: ("wedged", "probe hung"), on_wedged=hits.append)
    wd.start()
    wd.join(timeout=5)
    assert not wd.is_alive() and wd.tripped
    assert hits == ["probe hung"] and wd.last_verdict == ("wedged", "probe hung")


def test_watchdog_rearms_on_healthy_probe():
    """A slow but live runtime (a long capture, a giant prefill) must not
    get the cell killed: an ok probe re-arms the budget."""
    eng = _StalledEngine()
    eng.last_progress -= 10
    wd = _watchdog(eng, probe=lambda timeout_s: ("ok", "backend=cuda"))
    wd.start()
    try:
        deadline = time.monotonic() + 5
        while wd.probes == 0 and time.monotonic() < deadline:
            time.sleep(0.005)
        assert wd.probes >= 1 and not wd.tripped
        assert eng.stalled_s() < 5          # the probe bumped the heartbeat
    finally:
        wd.stop()
        wd.join(timeout=5)
    assert not wd.is_alive()


def test_watchdog_never_probes_an_idle_engine():
    eng = _StalledEngine(busy=False)
    wd = _watchdog(eng, probe=lambda timeout_s: ("wedged", "must not run"))
    wd.start()
    try:
        time.sleep(0.1)
        assert wd.probes == 0 and not wd.tripped
    finally:
        wd.stop()
        wd.join(timeout=5)
    assert not wd.is_alive()


def test_watchdog_counters_land_on_registry():
    eng = _StalledEngine()
    eng.last_progress = 0.0
    reg = Registry()
    wd = _watchdog(eng, probe=lambda timeout_s: ("wedged", "injected"),
                   on_wedged=lambda d: None, registry=reg)
    wd.start()
    wd.join(timeout=10)
    assert wd.tripped
    assert reg.get("kukeon_watchdog_trips_total").value() == 1
    assert reg.get("kukeon_watchdog_probes_total").value(verdict="wedged") == 1


def test_probe_reports_wedged_under_fault_injection():
    os.environ[faults.ENV] = "devices.probe_wedged:1"
    status, detail = probe_cuda_runtime(timeout_s=5)
    assert status == "wedged" and "fault-injected" in detail
    assert faults.fired("devices.probe_wedged") == 1


def test_watchdog_default_probe_uses_devices_seam():
    """With no probe given the watchdog consults probe_cuda_runtime, which
    the fault seam answers without a subprocess."""
    eng = _StalledEngine()
    eng.last_progress -= 10
    hits: list[str] = []
    os.environ[faults.ENV] = "devices.probe_wedged:1"
    wd = _watchdog(eng, probe=None, on_wedged=hits.append)
    wd.start()
    wd.join(timeout=10)
    assert wd.tripped and hits and "fault-injected" in hits[0]


def test_probe_subprocess_verdicts_on_this_host():
    """The throwaway process: killed at its timeout (wedged); on a host
    whose fresh process sees no CUDA device, unavailable."""
    status, detail = probe_cuda_runtime(timeout_s=0.001)
    assert status == "wedged" and "did not finish" in detail
    assert not torch.cuda.is_available()
    status, detail = probe_cuda_runtime(timeout_s=120)
    assert status == "unavailable" and "no CUDA device" in detail


def test_stalled_s_follows_the_engine_heartbeat():
    eng = ServingEngine(tl.llama_tiny(), tl.init_params(tl.llama_tiny(),
                                                        torch.Generator().manual_seed(0),
                                                        "cpu"),
                        num_slots=1, max_seq_len=64, decode_chunk=4, device="cpu")
    assert eng.stalled_s() == 0.0                       # idle: never stalled
    req = eng.submit(np.arange(1, 6, dtype=np.int32), SamplingParams(max_new_tokens=8))
    time.sleep(0.05)
    assert eng.stalled_s() >= 0.05                      # queued, no step yet
    eng.step()
    assert eng.stalled_s() < 0.05
    while not req.done.is_set():
        eng.step()
    while eng.step():
        pass
    assert eng.stalled_s() == 0.0


def test_main_has_the_references_exit_code_and_knobs():
    assert WEDGED_EXIT_CODE == 86
    assert serving_cell.WATCHDOG_ENV == "KUKEON_WATCHDOG_S"
    assert serving_cell.WATCHDOG_PROBE_TIMEOUT_ENV == "KUKEON_WATCHDOG_PROBE_TIMEOUT_S"


def test_wedged_cell_exits_86_end_to_end(tmp_path):
    """``python -m kukeon_tpu_torch.runtime.serving_cell --device cpu``
    under ``KUKEON_FAULTS=devices.probe_wedged:1``: a request's 256-step
    decode chunks each hold the driver well past the 0.05 s budget (the
    heartbeat moves only between steps), the probe answers wedged, and
    the process exits 86 with the watchdog's line."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = {**os.environ, "OMP_NUM_THREADS": "2", "KUKEON_WATCHDOG_S": "0.05",
           "KUKEON_WATCHDOG_PROBE_TIMEOUT_S": "5", faults.ENV: "devices.probe_wedged:1"}
    log_path = tmp_path / "cell.log"
    with open(log_path, "wb") as log:
        proc = subprocess.Popen(
            [sys.executable, "-m", "kukeon_tpu_torch.runtime.serving_cell", "--model", "tiny",
             "--device", "cpu", "--port", str(port), "--no-warmup", "--max-seq-len", "1024",
             "--num-slots", "2", "--decode-chunk", "256"],
            cwd=ROOT, env=env, stdout=log, stderr=log)
    try:
        deadline = time.monotonic() + 120
        while True:
            try:
                urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz", timeout=2).read()
                break
            except OSError:
                assert proc.poll() is None, log_path.read_text(errors="replace")[-2000:]
                assert time.monotonic() < deadline, "the cell never came up"
                time.sleep(0.1)

        def fire():
            try:
                urllib.request.urlopen(urllib.request.Request(
                    f"http://127.0.0.1:{port}/v1/generate",
                    data=b'{"promptTokens": [1, 2, 3, 4], "maxNewTokens": 900}',
                    headers={"Content-Type": "application/json"}), timeout=120).read()
            except OSError:
                pass                      # the cell exits under the request

        threading.Thread(target=fire, daemon=True).start()
        assert proc.wait(timeout=120) == WEDGED_EXIT_CODE
        assert "watchdog tripped" in log_path.read_text(errors="replace")
    finally:
        if proc.poll() is None:
            proc.kill()
        proc.wait()
