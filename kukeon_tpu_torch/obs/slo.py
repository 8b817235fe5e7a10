"""SLO evaluation: availability + TTFT-latency burn rates at scrape time,
the port of ``kukeon_tpu/obs/slo.py`` (plain ``threading`` locks; the same
families, windows and burn math, which the reference's scaler reads).

Objectives are declared on the ModelSpec (``sloAvailability``,
``sloTtftP95Ms``) and evaluated against the instruments the engine already
maintains — ``kukeon_engine_requests_total{outcome}`` and the
``kukeon_engine_ttft_seconds`` histogram — so the SLO layer adds ZERO work
to the serving hot path. Each scrape records a counter snapshot; burn rates
are computed from the delta between "now" and the snapshot nearest each
window's start (5m, 1h). With one scraper at a typical 15–60s interval the
windows resolve fine; with no scraper the cell simply reports
since-boot numbers.

Exposed families:

- ``kukeon_slo_objective{slo=}`` — the declared objectives (availability as
  a fraction, ttft_p95 in seconds), so dashboards need no config.
- ``kukeon_slo_burn_rate{slo=,window=5m|1h}`` — observed bad-event rate
  divided by the allowed rate; 1.0 = burning budget exactly at the
  objective, >1 = violating, 0 = clean.
- ``kukeon_slo_error_budget_remaining{slo=}`` — fraction of the budget left
  over the long window: ``max(0, 1 - burn_1h)``.

"Bad" for availability = outcomes ``error`` and ``timeout`` (sheds are
load-management, not failures — they answer 429 with Retry-After). "Bad"
for latency = requests whose TTFT exceeded the objective, estimated from
the histogram's cumulative buckets with interpolation in the landing
bucket; the objective is a p95, so the allowed bad fraction is 5%.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from collections import deque

_BAD_OUTCOMES = ("error", "timeout")
# The ttft objective is a p95: up to 5% of requests may exceed it.
_TTFT_QUANTILE_SLACK = 0.05

WINDOWS = ((300.0, "5m"), (3600.0, "1h"))


@dataclasses.dataclass(frozen=True)
class SloObjectives:
    """Serving objectives; defaults are deliberately loose so a cell with
    no declared SLO still exposes the families without alarming anyone."""

    availability: float = 0.99       # fraction of requests that must succeed
    ttft_p95_ms: float = 2000.0      # 95th-percentile TTFT bound


@dataclasses.dataclass
class _Snapshot:
    at: float
    total: float                     # requests reaching a terminal event
    bad: float                       # of those, error/timeout outcomes
    ttft_counts: list[int]           # per-bucket TTFT counts (+ overflow)


def _count_leq(buckets: tuple[float, ...], counts: list[int],
               threshold: float) -> float:
    """Estimated observations <= threshold from per-bucket counts, linear
    inside the landing bucket (same estimator family as percentile)."""
    good = 0.0
    lo = 0.0
    for b, c in zip(buckets, counts[:-1]):
        if threshold >= b:
            good += c
        else:
            if threshold > lo and b > lo:
                good += c * (threshold - lo) / (b - lo)
            break
        lo = b
    return good


class SloTracker:
    """Windowed burn-rate evaluation over an obs Registry's counters.

    Registered as a scrape-time collector; every ``collect()`` call records
    one snapshot and prunes those older than the longest window. Thread-safe
    (scrapes can overlap), injectable clock for tests.
    """

    def __init__(self, registry, objectives: SloObjectives | None = None, *,
                 requests_counter: str = "kukeon_engine_requests_total",
                 ttft_histogram: str = "kukeon_engine_ttft_seconds",
                 windows=WINDOWS, clock=time.monotonic):
        self._reg = registry
        self.objectives = objectives or SloObjectives()
        self._requests_name = requests_counter
        self._ttft_name = ttft_histogram
        self._windows = tuple(windows)
        self._clock = clock
        self._lock = threading.Lock()
        self._snaps: deque[_Snapshot] = deque()
        registry.register_collector(self.collect)

    # --- snapshotting -------------------------------------------------------

    def _take_snapshot(self) -> _Snapshot:
        total = bad = 0.0
        c = self._reg.get(self._requests_name)
        if c is not None:
            for labels, v in c.samples():
                total += v
                if labels.get("outcome") in _BAD_OUTCOMES:
                    bad += v
        h = self._reg.get(self._ttft_name)
        counts = list(h.snapshot()[0]) if h is not None else []
        return _Snapshot(at=self._clock(), total=total, bad=bad,
                         ttft_counts=counts)

    def _baseline(self, now: float, window_s: float) -> _Snapshot | None:
        """Latest snapshot at or before the window start; the oldest one we
        have when history is still shorter than the window."""
        base = None
        for s in self._snaps:
            if s.at <= now - window_s:
                base = s
            else:
                break
        if base is None and self._snaps:
            base = self._snaps[0]
        return base

    # --- burn math ----------------------------------------------------------

    def _burns(self, cur: _Snapshot, base: _Snapshot | None
               ) -> dict[str, float]:
        if base is None:
            base = _Snapshot(at=cur.at, total=0.0, bad=0.0,
                             ttft_counts=[0] * len(cur.ttft_counts))
        d_total = max(0.0, cur.total - base.total)
        d_bad = max(0.0, cur.bad - base.bad)
        out = {"availability": 0.0, "ttft_p95": 0.0}
        allowed_bad = max(1e-9, 1.0 - self.objectives.availability)
        if d_total > 0:
            out["availability"] = (d_bad / d_total) / allowed_bad
        h = self._reg.get(self._ttft_name)
        if h is not None and cur.ttft_counts:
            base_counts = base.ttft_counts or [0] * len(cur.ttft_counts)
            d_counts = [c - b for c, b in zip(cur.ttft_counts, base_counts)]
            n = sum(d_counts)
            if n > 0:
                thr = self.objectives.ttft_p95_ms / 1000.0
                slow = max(0.0, n - _count_leq(h.buckets, d_counts, thr))
                out["ttft_p95"] = (slow / n) / _TTFT_QUANTILE_SLACK
        return out

    # --- collector ----------------------------------------------------------

    def collect(self):
        cur = self._take_snapshot()
        with self._lock:
            self._snaps.append(cur)
            horizon = cur.at - max(w for w, _ in self._windows) - 120.0
            while self._snaps and self._snaps[0].at < horizon:
                self._snaps.popleft()
            per_window = {
                label: self._burns(cur, self._baseline(cur.at, w))
                for w, label in self._windows
            }
        long_label = max(self._windows)[1]
        yield ("kukeon_slo_objective", "gauge",
               "Declared serving objectives (availability fraction, "
               "ttft_p95 seconds).",
               [({"slo": "availability"}, self.objectives.availability),
                ({"slo": "ttft_p95"}, self.objectives.ttft_p95_ms / 1000.0)])
        yield ("kukeon_slo_burn_rate", "gauge",
               "Observed bad-event rate over allowed rate, per window "
               "(1.0 = exactly at objective).",
               [({"slo": slo, "window": label}, rate)
                for label, burns in per_window.items()
                for slo, rate in sorted(burns.items())])
        yield ("kukeon_slo_error_budget_remaining", "gauge",
               "Fraction of error budget left over the long window.",
               [({"slo": slo}, max(0.0, 1.0 - rate))
                for slo, rate in sorted(per_window[long_label].items())])
