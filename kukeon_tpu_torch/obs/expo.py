"""Prometheus text exposition (format 0.0.4) over an obs Registry, the
port of ``kukeon_tpu/obs/expo.py``: the same bytes for the same registry
operations, so the reference's federation parser, scaler and ``kuke``
CLI read a port cell's scrape as a JAX cell's.

Hand-rolled because the container bakes no prometheus_client; the golden
test in tests/test_torch_obs.py parses this output with its own strict parser,
so the format here is pinned by test, not by hope. Histograms emit the
conventional cumulative ``_bucket{le=...}`` series (always ending in
``le="+Inf"``) plus ``_sum``/``_count``.
"""

from __future__ import annotations

CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"


def _escape_label(v: str) -> str:
    return v.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _labels_str(labels: dict[str, str]) -> str:
    if not labels:
        return ""
    inner = ",".join(
        f'{k}="{_escape_label(str(v))}"' for k, v in sorted(labels.items())
    )
    return "{" + inner + "}"


def _fmt(v: float) -> str:
    f = float(v)
    if f == int(f) and abs(f) < 1e15:
        return str(int(f))
    return repr(f)


def _fmt_le(b: float) -> str:
    return ("%.10g" % b)


def render(registry) -> str:
    """The full exposition for one registry: declared metrics first
    (sorted by name), then every registered collector's families. The
    scrape-error counter renders LAST so a callable that fails during THIS
    scrape is already visible in it (ordering by name would render the
    counter before most gauges evaluate)."""
    out: list[str] = []
    err_counter = getattr(registry, "scrape_errors", None)
    deferred = None
    for m in registry.metrics():
        if m is err_counter:
            deferred = m
            continue
        out.append(f"# HELP {m.name} {m.help}".rstrip())
        out.append(f"# TYPE {m.name} {m.kind}")
        if m.kind == "histogram":
            _render_histogram(out, m)
            continue
        for labels, value in sorted(
            m.samples(), key=lambda s: sorted(s[0].items())
        ):
            out.append(f"{m.name}{_labels_str(labels)} {_fmt(value)}")
    for fn in registry.collectors():
        # One raising collector skips only its own families: the rest of
        # the exposition still renders and the failure is counted on
        # kukeon_scrape_errors_total (same scrape-robustness contract the
        # Gauge callables follow).
        lines: list[str] = []
        try:
            for name, kind, help, samples in fn():
                lines.append(f"# HELP {name} {help}".rstrip())
                lines.append(f"# TYPE {name} {kind}")
                for labels, value in samples:
                    lines.append(f"{name}{_labels_str(labels)} {_fmt(value)}")
        except Exception:  # noqa: BLE001 — a dead collector must not kill the scrape
            err = getattr(registry, "scrape_errors", None)
            if err is not None:
                err.inc(metric=getattr(fn, "__qualname__", "collector"))
            continue
        out.extend(lines)
    if deferred is not None:
        out.append(f"# HELP {deferred.name} {deferred.help}".rstrip())
        out.append(f"# TYPE {deferred.name} {deferred.kind}")
        for labels, value in sorted(
            deferred.samples(), key=lambda s: sorted(s[0].items())
        ):
            out.append(f"{deferred.name}{_labels_str(labels)} {_fmt(value)}")
    return "\n".join(out) + "\n"


def _render_histogram(out: list[str], h) -> None:
    with h._lock:
        series = {k: (list(c), s, n) for k, (c, s, n) in h._series.items()}
        exemplars = {k: dict(v) for k, v in h._exemplars.items()}
    if not series:
        # An empty histogram still exposes a zero-count labelless series
        # only when it has no label dimensions (a scraper then sees the
        # family exists); labelled families stay silent until observed.
        if not h.label_names:
            series[()] = ([0] * (len(h.buckets) + 1), 0.0, 0)
    for key in sorted(series):
        counts, total, n = series[key]
        labels = dict(zip(h.label_names, key))
        cum = 0
        for b, c in zip(h.buckets, counts[:-1]):
            cum += c
            le = dict(labels)
            le["le"] = _fmt_le(b)
            out.append(f"{h.name}_bucket{_labels_str(le)} {cum}")
        le = dict(labels)
        le["le"] = "+Inf"
        out.append(f"{h.name}_bucket{_labels_str(le)} {n}")
        out.append(f"{h.name}_sum{_labels_str(labels)} {_fmt(total)}")
        out.append(f"{h.name}_count{_labels_str(labels)} {n}")
        # Exemplar comment lines: one per bucket that has a trace id
        # attached. Comments, so any 0.0.4 scraper ignores them; the
        # in-repo federation parser extracts them (so `kuke top`'s p95
        # row can name a reconstructable trace) and the golden-format
        # test pins the syntax.
        for idx in sorted(exemplars.get(key, {})):
            v, ex = exemplars[key][idx]
            exl = dict(labels)
            exl["le"] = (_fmt_le(h.buckets[idx])
                         if idx < len(h.buckets) else "+Inf")
            out.append(
                f"# EXEMPLAR {h.name}_bucket{_labels_str(exl)} "
                f'trace_id="{ex}" value={_fmt(v)}')


def faults_collector():
    """Scrape-time family for the fault-injection harness: one
    ``kukeon_faults_fired_total{point=...}`` sample per declared fault
    point (zero when never fired), plus any extra point that fired without
    being declared — the port's fault-point guard test turns that situation
    into a failure, but the scrape itself must never hide a fire count."""
    from kukeon_tpu_torch import faults

    points = dict.fromkeys(faults.POINTS, 0)
    points.update(faults.stats)
    yield (
        "kukeon_faults_fired_total", "counter",
        "Fault-injection fires by point (kukeon_tpu_torch.faults).",
        [({"point": p}, float(v)) for p, v in sorted(points.items())],
    )
