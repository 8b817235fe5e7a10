"""Observability for the port's serving cell, the port of
``kukeon_tpu/obs``: metrics registry, Prometheus exposition, per-request
trace spans, SLO burn rates, device telemetry, program timers and the
step flight recorder.

The families, labels, span dicts and header formats are the reference's,
so the reference's daemon, scaler, gateway and ``kuke`` CLI read a port
cell as they read a JAX cell. Naming convention: ``kukeon_<subsystem>_
<name>`` with ``_total`` for counters and ``_seconds`` for latency
histograms.

Not exported here, unlike the reference: the per-layer profile
(``profile_layers``, ``LAYER_PROFILE_SCHEMA``; ROADMAP A12d),
``cost_summary`` (XLA's ``cost_analysis()``; the port counts a program's
cost with :func:`program_cost`), the process-global registry, and the
daemon's time-series store and alert engine (``tsdb``, ``alerts``), which
no cell runs.
"""

from kukeon_tpu_torch.obs.registry import (  # noqa: F401
    LATENCY_BUCKETS_S,
    Counter,
    Gauge,
    Histogram,
    Registry,
    percentile_from_counts,
)
from kukeon_tpu_torch.obs.expo import faults_collector, render  # noqa: F401
from kukeon_tpu_torch.obs.trace import (  # noqa: F401
    PHASES,
    TRACEPARENT_HEADER,
    Span,
    TraceContext,
    Tracer,
    format_traceparent,
    new_span_id,
    new_trace_id,
    parse_traceparent,
)
from kukeon_tpu_torch.obs.device import (  # noqa: F401
    CompileTracker,
    ProfileBusy,
    ProfileSpool,
    device_memory_collector,
)
from kukeon_tpu_torch.obs.profile import (  # noqa: F401
    PROGRAMS,
    FlightRecorder,
    ProgramTimers,
    device_peaks,
    program_cost,
)
from kukeon_tpu_torch.obs.slo import SloObjectives, SloTracker  # noqa: F401
