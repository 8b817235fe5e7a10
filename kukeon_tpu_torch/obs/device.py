"""Device-level telemetry: device memory gauges, program-build tracking,
and the on-demand profiler spool, the port of ``kukeon_tpu/obs/device.py``.

The request-level layer (registry/trace) answers "how slow"; this module
answers "why": is a bad p95 a rebuild (``kukeon_compiles_total`` moving in
steady state), memory pressure (``kukeon_hbm_bytes_in_use`` near the
limit), or a queue problem (neither)? The families are the reference's, by
name, type and labels.

Three pieces:

- :func:`device_memory_collector` — a scrape-time collector producing
  ``kukeon_hbm_bytes_in_use`` / ``_limit`` / ``_peak{device=}``. On a CUDA
  device the first and last are the caching allocator's host-side
  counters (``torch.cuda.memory_stats``: allocated bytes, current and
  peak) and the limit is the card's capacity, read once when the
  collector is made (at boot). No CUDA runtime call happens at scrape
  time: a scrape may land in the middle of a CUDA-graph capture on the
  engine thread, which any runtime call from another thread would
  invalidate. A CPU device declares the families with no samples, so the
  scrape schema is the same everywhere. A tensor-parallel leader passes
  ``peers``: its followers' counters, which they report over the rank
  group's control channel (``parallel/launch.py``), one sample each under
  its own ``device`` label.
- :class:`CompileTracker` — counts every program build
  (``kukeon_compiles_total{program=}``) and times it
  (``kukeon_compile_seconds{program=}``). Where the reference counts jit
  tracing-cache growth, a build here is a CUDA-graph capture (on the CPU,
  the first eager run of a key). The labels are the reference's coarse
  ``prefill|insert|decode``; after warmup the decode counter must stay
  flat across slot churn.
- :class:`ProfileSpool` — single-flight ``torch.profiler`` captures into a
  bounded keep-last-K spool dir (``KUKEON_PROFILE_DIR``), behind the
  cells' ``POST /v1/profile``.
"""

from __future__ import annotations

import contextlib
import os
import shutil
import tempfile
import threading
import time
from collections import deque

import torch

_HBM_FAMILIES = (
    ("in_use", "kukeon_hbm_bytes_in_use",
     "Device memory currently allocated, per device."),
    ("limit", "kukeon_hbm_bytes_limit",
     "Device memory capacity visible to the runtime, per device."),
    ("peak", "kukeon_hbm_bytes_peak",
     "High-water-mark device memory allocation, per device."),
)


def device_memory_collector(device: torch.device | str | None = None, peers=None):
    """The scrape-time collector of the ``kukeon_hbm_bytes_*`` families for
    ``device`` (None or a CPU device: the families with no samples), and
    for every device ``peers()`` reports (``{"index", "in_use", "limit",
    "peak"}`` dicts, read as they stand).

    On CUDA, ``in_use`` and ``peak`` are the caching allocator's allocated
    bytes (``allocated_bytes.all.current`` / ``.peak``, what
    ``torch.cuda.memory_allocated`` / ``max_memory_allocated`` report) and
    ``limit`` the card's total memory, read here, once."""
    dev = torch.device(device) if device is not None else torch.device("cpu")
    index = None
    capacity = 0.0
    if dev.type == "cuda":
        index = dev.index if dev.index is not None else torch.cuda.current_device()
        capacity = float(torch.cuda.get_device_properties(index).total_memory)

    def device_memory_collector():
        devices: list[dict] = []
        if index is not None:
            ms = torch.cuda.memory_stats(index)
            devices.append({"index": index,
                            "in_use": float(ms.get("allocated_bytes.all.current", 0)),
                            "limit": capacity,
                            "peak": float(ms.get("allocated_bytes.all.peak", 0))})
        if peers is not None:
            devices += [d for d in peers() if "index" in d]
        for key, name, help in _HBM_FAMILIES:
            yield (name, "gauge", help,
                   [({"device": str(d["index"])}, d[key]) for d in devices])

    return device_memory_collector


class CompileTracker:
    """Registers the compile families and counts program builds.

    A build is a real compile (a CUDA-graph capture, or on the CPU the
    first eager run of a key): count it by coarse program and record its
    wall time. Warmup builds land here too; the invariant under test is
    that the counters go FLAT afterwards, whatever the slots do."""

    def __init__(self, registry):
        self._m_compiles = registry.counter(
            "kukeon_compiles_total",
            "Program builds (CUDA-graph captures; on the CPU, first eager "
            "runs of a key), by engine program (prefill|insert|decode). "
            "Flat in steady state.",
            labels=("program",))
        self._m_seconds = registry.histogram(
            "kukeon_compile_seconds",
            "Wall time of program builds, by program.",
            labels=("program",))

    def note_build(self, program: str, seconds: float) -> None:
        self._m_compiles.inc(program=program)
        self._m_seconds.observe(max(0.0, seconds), program=program)

    def count(self, program: str) -> int:
        return int(self._m_compiles.value(program=program))


class ProfileBusy(RuntimeError):
    """A capture is already running (single-flight; HTTP maps this to 409)."""


PROFILE_DIR_ENV = "KUKEON_PROFILE_DIR"
PROFILE_KEEP_ENV = "KUKEON_PROFILE_KEEP"
MAX_CAPTURE_MS = 600_000


class ProfileSpool:
    """Single-flight on-demand ``torch.profiler`` captures.

    ``start(duration_ms)`` kicks a background thread that profiles the live
    process for the requested window and writes a Chrome trace
    (``trace.json``) under the spool dir; only the newest K completed
    captures are kept (K from ``KUKEON_PROFILE_KEEP``). One capture at a
    time: a second start raises :class:`ProfileBusy`. ``cuda``: trace the
    device's kernels too (CUPTI), not only the host's operators.

    ``guard`` (a lock, or any context manager) is held around the
    profiler's start and its stop: the serving engine passes its programs'
    capture lock, because either call made while a CUDA graph is being
    captured on the engine thread would invalidate the capture."""

    def __init__(self, base_dir: str | None = None, keep: int | None = None,
                 registry=None, cuda: bool = False, guard=None):
        self.base_dir = (base_dir or os.environ.get(PROFILE_DIR_ENV)
                         or os.path.join(tempfile.gettempdir(), "kukeon-profiles"))
        self.keep = max(1, keep if keep is not None
                        else int(os.environ.get(PROFILE_KEEP_ENV, "4") or 4))
        self.cuda = cuda
        self._guard = guard if guard is not None else contextlib.nullcontext()
        self._lock = threading.Lock()
        self._active: dict | None = None   # guarded-by: _lock
        # Failed captures leave nothing on disk; keep their records so
        # GET /v1/profile can answer "why did my capture vanish".
        self._failed: deque[dict] = deque(maxlen=8)
        self._m_captures = None
        if registry is not None:
            self._m_captures = registry.counter(
                "kukeon_profile_captures_total",
                "On-demand profiler captures by outcome.",
                labels=("outcome",))

    def start(self, duration_ms: float) -> dict:
        """Begin a capture; returns its record immediately (the trace runs
        in the background for ``duration_ms``). Raises ProfileBusy while a
        capture is in flight and ValueError on a bad duration."""
        from kukeon_tpu_torch import faults

        duration_ms = float(duration_ms)
        if not (0 < duration_ms <= MAX_CAPTURE_MS):
            raise ValueError(f"durationMs must be in (0, {MAX_CAPTURE_MS}]")
        faults.maybe_fail("profile.capture")
        name = f"capture-{time.strftime('%Y%m%d-%H%M%S')}-{os.getpid()}"
        rec = {
            "name": name,
            "path": os.path.join(self.base_dir, name),
            "state": "running",
            "startedAt": time.time(),
            "durationMs": duration_ms,
        }
        with self._lock:
            if self._active is not None:
                raise ProfileBusy(f"capture {self._active['name']} is already running")
            self._active = rec
        threading.Thread(target=self._capture, args=(rec,), daemon=True,
                         name="profile-capture").start()
        return dict(rec)

    def _capture(self, rec: dict) -> None:
        try:
            from torch.profiler import ProfilerActivity, profile

            activities = [ProfilerActivity.CPU]
            if self.cuda:
                activities.append(ProfilerActivity.CUDA)
            os.makedirs(rec["path"], exist_ok=True)
            prof = profile(activities=activities)
            with self._guard:
                prof.start()
            try:
                time.sleep(rec["durationMs"] / 1000.0)
            finally:
                with self._guard:
                    prof.stop()
            prof.export_chrome_trace(os.path.join(rec["path"], "trace.json"))
            # "done" and its size land together: list() copies the active
            # record under the lock, and a reader polling for the end must
            # never see a finished capture without its size.
            size = _tree_size(rec["path"])
            with self._lock:
                rec["state"] = "done"
                rec["sizeBytes"] = size
            if self._m_captures is not None:
                self._m_captures.inc(outcome="ok")
        except Exception as e:  # noqa: BLE001 — the spool must never wedge closed
            rec["state"] = "error"
            rec["error"] = f"{type(e).__name__}: {e}"
            shutil.rmtree(rec["path"], ignore_errors=True)
            if self._m_captures is not None:
                self._m_captures.inc(outcome="error")
        finally:
            with self._lock:
                self._active = None
                if rec["state"] == "error":
                    self._failed.append(rec)
            self._prune()

    def _prune(self) -> None:
        """Keep only the newest K completed captures on disk."""
        try:
            entries = sorted(
                (e for e in os.scandir(self.base_dir) if e.is_dir()),
                key=lambda e: e.stat().st_mtime, reverse=True,
            )
        except OSError:
            return
        for stale in entries[self.keep:]:
            shutil.rmtree(stale.path, ignore_errors=True)

    def list(self) -> list[dict]:
        """Newest-first capture records: the running one (if any), recent
        failures, then completed captures read from the spool dir."""
        with self._lock:
            out = [dict(self._active)] if self._active is not None else []
            active_name = self._active["name"] if self._active is not None else None
            out.extend(dict(r) for r in reversed(self._failed))
        try:
            entries = sorted(
                (e for e in os.scandir(self.base_dir) if e.is_dir()),
                key=lambda e: e.stat().st_mtime, reverse=True,
            )
        except OSError:
            entries = []
        for e in entries:
            if e.name == active_name:
                continue
            out.append({
                "name": e.name,
                "path": e.path,
                "state": "done",
                "startedAt": e.stat().st_mtime,
                "sizeBytes": _tree_size(e.path),
            })
        return out


def _tree_size(path: str) -> int:
    total = 0
    for dirpath, _dirs, files in os.walk(path):
        for f in files:
            try:
                total += os.path.getsize(os.path.join(dirpath, f))
            except OSError:
                pass
    return total
