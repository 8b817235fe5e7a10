"""Per-request trace spans with W3C-style distributed trace context, a
tail-sampled bounded ring buffer, and the declared phase registry: the
port of ``kukeon_tpu/obs/trace.py`` (plain ``threading`` locks; spans,
headers, sampling verdicts and the exported span dict unchanged, so the
reference's daemon joins a port cell's spans to the gateway's).

A request's life inside one engine is a chain of monotonic timestamps::

    submitted -> admitted -> prefill_dispatched -> first_token -> finished

and the exported span derives phase durations from CONSECUTIVE event
pairs, so the phases partition the request's wall time exactly:
``queued + prefill + decode == e2e`` (the acceptance tolerance exists only
for float rounding). Requests that die early (shed at submit, deadline
expiry while queued, cancel) simply stop the chain where they stopped —
their later phases read 0 and the recorded outcome names why.

**Distributed context.** Request identity used to be an engine-local
integer, so a request flowing gateway -> replica -> engine (retried onto a
second replica, preempted and resumed on the paged KV path) left span
fragments that could not be joined. Every span now carries a
``trace_id``/``span_id``/``parent_span_id`` triple minted at the first hop
(the gateway, or the engine for direct submissions) and propagated over
HTTP via a W3C-``traceparent``-shaped header
(``00-<32 hex trace id>-<16 hex span id>-01``). The daemon's ``Traces``
RPC unions every cell's ring by trace id and ``kuke trace <trace-id>``
renders the reconstructed cross-component timeline.

**Tail sampling.** The ring is bounded, so under flood the interesting
traces (slow, errored, preempted, retried) must not be evicted by a wall
of boring fast ones. :meth:`Tracer.finish` therefore decides keep/drop at
completion time — when the outcome is known — instead of head-sampling at
submit: error/timeout/cancelled/shed outcomes, preempted or retried
spans, and spans slower than the tracer's own running p95 are ALWAYS
kept; the rest are kept with ``KUKEON_TRACE_SAMPLE`` probability
(default 1.0 — sampling is an operator opt-in) decided deterministically
from the trace id, so every component of one trace reaches the same
verdict. Verdict counts surface as
``kukeon_trace_tail_sampled_total{decision=}``.

The buffer is a ``deque(maxlen=capacity)``: O(1) append, oldest spans
evicted, bounded memory no matter the traffic. ``GET /v1/trace?n=K``
returns the newest K spans; ``?trace_id=`` pulls one trace's spans, and
JSON log lines carry the same ``trace_id``/``request_id`` pair so logs
and traces join on one key.
"""

from __future__ import annotations

import dataclasses
import os
import threading
import time
import uuid
from collections import deque

# The shared latency ladder: the tracer's own e2e distribution (slow-trace
# detection) uses it.
from kukeon_tpu_torch.obs.registry import LATENCY_BUCKETS_S

# Event-chain order; phase N is the gap between event N and event N+1.
EVENTS = ("submitted", "admitted", "prefill_dispatched", "first_token",
          "finished")
# Human phase names for the exported span, keyed by the gap's start event.
# Applied to engine-component spans only: gateway/boot spans keep their
# raw event names as phase keys.
_PHASE_OF = {
    "submitted": "queued",            # submit -> dequeued for a slot
    "admitted": "prefill_dispatch",   # dequeue -> prefill program dispatched
    "prefill_dispatched": "prefill_wait",  # dispatch -> first token emitted
    "first_token": "decode",          # first token -> terminal event
}

OUTCOMES = ("ok", "shed", "timeout", "cancelled", "error")

# Every span phase/mark literal of the reference, in hop order: the
# vocabulary ``kuke trace`` renders. The port stamps the engine's and the
# boot span's (its tests hold each call site to this tuple); the gateway
# groups stay declared so one vocabulary serves both packages.
PHASES = (
    # engine request lifecycle (serving/engine.py)
    "submitted", "admitted", "prefill_dispatched", "first_token",
    "finished", "preempted",
    # disaggregated KV handoff (serving/engine.py export/import,
    # gateway/cell.py handoff driver + local-decode fallback)
    "kv_exported", "kv_imported", "kv_handoff", "handoff_fallback",
    # gateway proxy hops (gateway/cell.py)
    "proxy_attempt", "proxy_retry", "proxy_shed",
    # gateway spillover (gateway/cell.py): an all-shed request parking in
    # the bounded deadline-aware queue, and its later retry winning a
    # replica — a brief storm rendered as latency, not an error.
    "spill_park", "spill_resume",
    # cell boot phases (runtime/serving_cell.py finish_boot)
    "boot_imports", "boot_init", "boot_compile", "boot_warmup",
)

# The propagation header. Shaped like W3C traceparent (version-00):
# ``00-<trace_id:32 hex>-<span_id:16 hex>-01``.
TRACEPARENT_HEADER = "traceparent"

# Tail-sampling keep probability for boring fast-path traces; interesting
# traces (non-ok outcome, preempted, retried, slower than the running p95)
# are always kept regardless.
TRACE_SAMPLE_ENV = "KUKEON_TRACE_SAMPLE"



def new_trace_id() -> str:
    """Globally unique 32-hex-char trace id (uuid4 randomness)."""
    return uuid.uuid4().hex


def new_span_id() -> str:
    """16-hex-char span id."""
    return uuid.uuid4().hex[:16]


@dataclasses.dataclass(frozen=True)
class TraceContext:
    """A parsed propagation header: the trace to join and the parent span
    to hang this hop's span under."""

    trace_id: str
    span_id: str


def format_traceparent(trace_id: str, span_id: str) -> str:
    return f"00-{trace_id}-{span_id}-01"


def parse_traceparent(header: str | None) -> TraceContext | None:
    """Strictly parse a traceparent header; None on absence or anything
    malformed (a garbled header must degrade to a fresh root trace, never
    to a crashed request)."""
    if not header:
        return None
    parts = header.strip().split("-")
    if len(parts) != 4:
        return None
    _ver, trace_id, span_id, _flags = parts
    if len(trace_id) != 32 or len(span_id) != 16:
        return None
    try:
        int(trace_id, 16), int(span_id, 16)
    except ValueError:
        return None
    if trace_id == "0" * 32 or span_id == "0" * 16:
        return None
    return TraceContext(trace_id=trace_id.lower(), span_id=span_id.lower())


@dataclasses.dataclass
class Span:
    """One hop's lifecycle record (mutated only by its owning driver
    thread until finish; read-only afterwards).

    ``events`` entries are ``(name, monotonic_t)`` tuples, or
    ``(name, monotonic_t, attrs)`` when the mark carries attributes (a
    gateway attempt records which replica it dialed). Consumers must
    index, not unpack, unless they know the producer."""

    request_id: int
    prompt_tokens: int
    trace_id: str = ""
    span_id: str = ""
    parent_span_id: str | None = None
    component: str = "engine"
    started_wall: float = dataclasses.field(default_factory=time.time)
    events: list[tuple] = dataclasses.field(default_factory=list)
    outcome: str | None = None
    error: str | None = None
    tokens: int = 0
    decode_chunks: int = 0
    attrs: dict = dataclasses.field(default_factory=dict)
    # Back-date the root event (boot spans start at process t0, not at
    # span construction).
    start_mono: float | None = None

    def __post_init__(self):
        if not self.trace_id:
            self.trace_id = new_trace_id()
        if not self.span_id:
            self.span_id = new_span_id()
        self.event("submitted", at=self.start_mono)

    def event(self, name: str, at: float | None = None, **attrs) -> None:
        t = time.monotonic() if at is None else at
        if attrs:
            self.events.append((name, t, attrs))
        else:
            self.events.append((name, t))

    @property
    def finished(self) -> bool:
        return self.outcome is not None

    @property
    def e2e_s(self) -> float:
        return self.events[-1][1] - self.events[0][1]

    def to_dict(self) -> dict:
        first = self.events[0][1]
        last = self.events[-1][1]
        phases: dict[str, float] = {}
        alias = self.component == "engine"
        for ev, nxt in zip(self.events, self.events[1:]):
            name = ev[0]
            phase = _PHASE_OF.get(name, name) if alias else name
            phases[phase] = phases.get(phase, 0.0) + (nxt[1] - ev[1])
        out_events = []
        for ev in self.events:
            d = {"event": ev[0], "atS": round(ev[1] - first, 6)}
            if len(ev) > 2 and ev[2]:
                d["attrs"] = ev[2]
            out_events.append(d)
        return {
            "traceId": self.trace_id,
            "spanId": self.span_id,
            **({"parentSpanId": self.parent_span_id}
               if self.parent_span_id else {}),
            "component": self.component,
            "requestId": self.request_id,
            "startedAt": self.started_wall,
            "outcome": self.outcome,
            **({"error": self.error} if self.error else {}),
            "promptTokens": self.prompt_tokens,
            "tokens": self.tokens,
            "decodeChunks": self.decode_chunks,
            **({"attrs": dict(self.attrs)} if self.attrs else {}),
            "events": out_events,
            "phasesS": {k: round(v, 6) for k, v in phases.items()},
            "e2eS": round(last - first, 6),
        }


def _hash01(trace_id: str) -> float:
    """Deterministic uniform-[0,1) value from a trace id: every component
    of one trace reaches the same probabilistic verdict."""
    try:
        return int(trace_id[:8], 16) / float(16 ** 8)
    except ValueError:
        return 0.0


class Tracer:
    """Span factory + tail-sampled bounded completed-span buffer
    (thread-safe)."""

    def __init__(self, capacity: int = 512,
                 keep_probability: float | None = None):
        self._lock = threading.Lock()
        self._done: deque[Span] = deque(maxlen=max(1, capacity))
        if keep_probability is None:
            try:
                keep_probability = float(
                    os.environ.get(TRACE_SAMPLE_ENV, "") or 1.0)
            except ValueError:
                keep_probability = 1.0
        self.keep_probability = min(1.0, max(0.0, keep_probability))
        # Running e2e distribution over the shared latency ladder: the
        # slow-trace criterion ("always keep p95+") is computed from the
        # tracer's OWN population, so it needs no engine histogram handle.
        self._e2e_counts = [0] * (len(LATENCY_BUCKETS_S) + 1)
        # Tail-sampler verdicts, exposed as
        # kukeon_trace_tail_sampled_total{decision=} by the owning
        # component's collector.
        self.sample_stats = {"kept": 0, "dropped": 0}

    def begin(self, request_id: int, prompt_tokens: int, *,
              trace_ctx: TraceContext | None = None,
              component: str = "engine",
              start_mono: float | None = None) -> Span:
        """New span — joining ``trace_ctx``'s trace as a child when given,
        else rooting a fresh trace (direct engine submissions still get
        globally unique trace ids)."""
        return Span(
            request_id=request_id, prompt_tokens=prompt_tokens,
            trace_id=trace_ctx.trace_id if trace_ctx is not None else "",
            parent_span_id=(trace_ctx.span_id
                            if trace_ctx is not None else None),
            component=component, start_mono=start_mono,
        )

    # --- tail sampling -----------------------------------------------------

    def _p95_bound_locked(self) -> float:
        """Upper bound of the bucket holding the running p95 (callers hold
        ``_lock``). A span must land in a strictly HIGHER bucket to count
        as slow — with a uniform population nothing outruns its own
        bucket, so uniform fast traffic is all 'boring'."""
        n = sum(self._e2e_counts)
        if n == 0:
            return float("inf")
        rank = 0.95 * n
        seen = 0
        for i, c in enumerate(self._e2e_counts):
            seen += c
            if seen >= rank:
                return LATENCY_BUCKETS_S[min(i, len(LATENCY_BUCKETS_S) - 1)]
        return LATENCY_BUCKETS_S[-1]

    def _interesting(self, span: Span) -> bool:
        """Unconditionally-kept traces: anything that went wrong, anything
        the scheduler disturbed (preemption), anything the gateway had to
        retry. These are exactly what an operator pulls up post-hoc."""
        if span.outcome != "ok":
            return True
        if span.attrs.get("retries"):
            return True
        return any(ev[0] in ("preempted", "proxy_retry")
                   for ev in span.events)

    def finish(self, span: Span, outcome: str, *, tokens: int | None = None,
               error: str | None = None) -> Span:
        """Terminal transition: stamps the ``finished`` event, records the
        outcome, and tail-samples the span into the ring. Idempotent — a
        request failed twice (sweep + fail_all racing) keeps its FIRST
        verdict."""
        if span.finished:
            return span
        span.event("finished")
        span.outcome = outcome
        if tokens is not None:
            span.tokens = tokens
        if error is not None:
            span.error = error
        e2e = span.e2e_s
        with self._lock:
            # Record into the running distribution first so the very first
            # span compares against a population that includes itself.
            for i, b in enumerate(LATENCY_BUCKETS_S):
                if e2e <= b:
                    self._e2e_counts[i] += 1
                    break
            else:
                self._e2e_counts[-1] += 1
            keep = (
                self._interesting(span)
                or e2e > self._p95_bound_locked()
                or _hash01(span.trace_id) < self.keep_probability
            )
            self.sample_stats["kept" if keep else "dropped"] += 1
            if keep:
                self._done.append(span)
        return span

    # --- queries -----------------------------------------------------------

    def recent(self, n: int = 50) -> list[dict]:
        """Newest-first completed spans, at most ``n``."""
        with self._lock:
            spans = list(self._done)
        return [s.to_dict() for s in reversed(spans[-max(0, n):])]

    def for_request(self, request_id: int) -> list[dict]:
        """Exact-match lookup by request id (``GET /v1/trace?request_id=``):
        a slow request found in the logs can be pulled directly instead of
        paging the tail and eyeballing. Newest-first; normally one span,
        but shed spans share id -1."""
        with self._lock:
            spans = [s for s in self._done if s.request_id == request_id]
        return [s.to_dict() for s in reversed(spans)]

    def for_trace(self, trace_id: str) -> list[dict]:
        """All completed spans of one trace (``GET /v1/trace?trace_id=``),
        oldest-first — the order a timeline renders them."""
        with self._lock:
            spans = [s for s in self._done if s.trace_id == trace_id]
        return [s.to_dict() for s in spans]

    def __len__(self) -> int:
        with self._lock:
            return len(self._done)
