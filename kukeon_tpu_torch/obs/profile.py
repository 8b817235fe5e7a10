"""Roofline profiling: per-program timers, the engine step flight
recorder and the per-layer profile, the port of
``kukeon_tpu/obs/profile.py``.

- :class:`ProgramTimers` — dispatch counts, wall-time histograms and
  token counts for every engine program, plus each program's cost
  (:func:`program_cost`, a plain count over the config and the program's
  key, where the reference reads XLA's ``cost_analysis()``). Scrape-time
  collectors derive the roofline gauges: per-program MFU
  (``kukeon_program_mfu``) and memory-bandwidth utilization
  (``kukeon_program_membw_util``). A replay is counted when it is
  dispatched and timed as the wall time from its dispatch to the first
  ``_fetch`` of the engine that finds it done: its end mark is a CUDA
  event recorded on its stream right after ``graph.replay()``, taken from
  a ring made at boot, and queried only inside the engine's counted
  ``_fetch`` seam, after the blocking readback the budget already pays
  for. Zero new host syncs: the engine's host-sync budget tests pass
  unchanged with the timers armed. On the CPU a program runs eagerly, so
  its mark is done when its dispatch returns.
- :class:`FlightRecorder` — a bounded lock-disciplined ring of engine-loop
  step records (occupancy, chunk size, tokens, per-program wall times,
  transfer counts, preemptions, seated trace ids) behind
  ``GET /v1/timeline``.
- :func:`profile_layers` — the reference's per-layer profile (schema
  ``kukeon-layer-profile/v1``): embed, every layer and the head, each at a
  prefill and a decode shape, with FLOPs and bytes from
  :func:`layer_cost` (plain counts, as :func:`program_cost`) and, on the
  card, each component's time as the replay of a CUDA graph captured for
  it (the counterpart of the reference's ``jax.jit``; an eager layer would
  time its launches, not its work).
"""

from __future__ import annotations

import contextlib
import math
import os
import threading
import time
from collections import deque
from typing import Any, Callable, Iterable

import torch

# The reference's seven program labels (its ServingEngine._build_programs):
# the timer-label vocabulary, distinct from the coarse
# prefill|insert|decode compile labels. The port's fused programs take
# these labels by the rule of serving/programs.py ``program_labels``.
PROGRAMS = (
    "prefill",
    "prefill_ext",
    "insert",
    "decode_chunk",
    "gather_block",
    "insert_paged",
    "decode_chunk_paged",
)

PEAK_FLOPS_ENV = "KUKEON_PEAK_FLOPS"
PEAK_HBM_BPS_ENV = "KUKEON_PEAK_HBM_BPS"

# Device-name substring -> (peak FLOP/s, peak memory bytes/s), bf16 dense,
# from NVIDIA's data sheets, first match wins (so the H100's PCIe and NVL
# parts are named before the SXM part's plain "H100"). Unknown devices
# (the CPU) fall back to a deliberately generous default: MFU then reads
# LOW, never a fabricated 90%.
_PEAK_SPECS: tuple[tuple[str, float, float], ...] = (
    ("h100 nvl", 835e12, 3.9e12),
    ("h100 pcie", 756e12, 2.0e12),
    ("h100", 989e12, 3.35e12),
)
_DEFAULT_PEAKS = (1e12, 100e9)


def device_peaks(device: torch.device | str | None = None) -> tuple[float, float]:
    """(peak FLOP/s, peak memory bytes/s) of ``device`` — env overrides
    (``KUKEON_PEAK_FLOPS`` / ``KUKEON_PEAK_HBM_BPS``) beat the built-in
    table, the table beats the conservative unknown-device default. A CPU
    device (or None) is unknown."""
    flops, bw = _DEFAULT_PEAKS
    dev = torch.device(device) if device is not None else None
    if dev is not None and dev.type == "cuda":
        try:
            kind = torch.cuda.get_device_name(dev).lower()
        except (RuntimeError, AssertionError):   # no usable device: unknown
            kind = ""
        for sub, f, b in _PEAK_SPECS:
            if sub in kind:
                flops, bw = f, b
                break
    try:
        flops = float(os.environ.get(PEAK_FLOPS_ENV) or flops)
        bw = float(os.environ.get(PEAK_HBM_BPS_ENV) or bw)
    except ValueError:
        pass
    return max(flops, 1.0), max(bw, 1.0)


def program_cost(cfg, program: str, key: tuple, *, num_slots: int, max_seq_len: int,
                 int8_weights: bool = True, kv_cache_int8: bool = False
                 ) -> tuple[float, float]:
    """(FLOPs, memory bytes) of one dispatch of the engine program ``key``
    (labelled ``program``, serving/programs.py ``program_labels``), a
    plain count over the config ``cfg`` (llama's or the MoE's), the
    engine's ``num_slots`` (B) and ``max_seq_len`` (S_max):

    - W, the weight bytes a forward reads once: every projection matrix of
      every layer (``wq``, ``wk``, ``wv``, ``wo`` and the MLP's
      ``w_gate``, ``w_up``, ``w_down``; the MoE's E experts' three, and
      its router [D, E] in f32) and the LM head [V, D]; ``int8_weights``:
      one byte an element and a 4-byte scale an output column, else the
      config dtype's bytes. Norms and the embedding rows gathered are left
      out.
    - N, the weight elements one token multiplies: the same matrices,
      with ``experts_per_token`` experts where the MoE has E.
    - R, the bytes of one KV row across layers: L x 2 x KV x head_dim x
      the cache element (the config dtype, or one byte plus a 4-byte
      scale a head under ``kv_cache_int8``).
    - A(q, k) = 4 x L x H x head_dim x q x k, the FLOPs of the scores and
      the value product of q queries over k keys each (the dense masked
      attention computes every pair).

    By program (n = the key's prefill bucket S, Pb its stored prefix):

    - ``decode_chunk`` (key (k, nf, st)): k steps of B tokens against
      every slot's S_max cache rows: FLOPs k (2 N B + A(B, S_max)), bytes
      k (W + B S_max R). ``decode_chunk_paged`` adds 2 B S_max R (the
      pages gathered into the dense view).
    - ``prefill`` (``prefill``, ``prefill_paged``, ``prefill_export``):
      2 N S + A(S, S); bytes W + 2 S R (the block written, then inserted
      into the slot's rows; an export, which inserts nowhere, S R).
    - ``prefill_ext``: 2 N S + A(S, Pb + S); bytes W + (Pb + 2 S) R.
    - ``insert``, ``insert_paged``: no FLOPs counted; bytes 2 S R.
    """
    c = cfg
    L, D, V = c.num_layers, c.hidden_size, c.vocab_size
    H, hd, KV = c.num_heads, c.head_dim, c.num_kv_heads
    experts = getattr(c, "num_experts", None)
    mlp = 3 * D * c.intermediate_size
    attn = D * (c.q_dim + 2 * c.kv_dim) + c.q_dim * D
    cols_attn = c.q_dim + 2 * c.kv_dim + D             # output columns (scales)
    cols_mlp = 2 * c.intermediate_size + D
    itemsize = torch.finfo(c.dtype).bits // 8
    if experts:
        mats, cols = attn + experts * mlp, cols_attn + experts * cols_mlp
        per_token = attn + c.experts_per_token * mlp + D * experts
        router_bytes = L * D * experts * 4
    else:
        mats, cols = attn + mlp, cols_attn + cols_mlp
        per_token = attn + mlp
        router_bytes = 0
    if int8_weights:
        W = L * (mats + 4 * cols) + V * D + 4 * V + router_bytes
    else:
        W = (L * mats + V * D) * itemsize + router_bytes
    N = L * per_token + V * D
    R = L * 2 * KV * (hd + 4 if kv_cache_int8 else hd * itemsize)

    def attention(q: int, k: int) -> float:
        return 4.0 * L * H * hd * q * k

    B, S_max = num_slots, max_seq_len
    if program in ("decode_chunk", "decode_chunk_paged"):
        k = key[0]
        flops = k * (2.0 * N * B + attention(B, S_max))
        nbytes = k * (W + B * S_max * R)
        if program == "decode_chunk_paged":
            nbytes += 2 * B * S_max * R
        return flops, float(nbytes)
    kind = key[0]
    if kind in ("insert", "insert_paged"):
        return 0.0, float(2 * key[1] * R)
    if kind.startswith("prefill_ext"):
        Pb, S = key[1], key[2]
        return 2.0 * N * S + attention(S, Pb + S), float(W + (Pb + 2 * S) * R)
    S = key[1]
    rows = S if kind.endswith("_export") else 2 * S
    return 2.0 * N * S + attention(S, S), float(W + rows * R)


class _ProgramTimer:
    """Per-program dispatch marks. ``dispatched`` and ``settle`` both run
    on the engine driver thread only (the programs' launch and the
    ``_fetch`` seam), so the pending deque needs no lock; the shared
    accumulators the scrape thread reads live in the parent under its
    lock."""

    # Marks outliving this many newer dispatches were lost; cap the deque
    # so they can never accumulate.
    MAX_PENDING = 8

    def __init__(self, owner: "ProgramTimers", program: str):
        self._owner = owner
        self.program = program
        self._pending: deque[tuple[float, Any, Any]] = deque(maxlen=self.MAX_PENDING)

    def dispatched(self, t0: float, ready=None, cost: tuple[float, float] | None = None
                   ) -> None:
        """Record a dispatch that started at ``t0`` — counted now, timed
        when a later ``settle`` finds ``ready`` (a CUDA event recorded
        behind it; None: done when the dispatch returned) complete.
        ``cost``: this dispatch's (FLOPs, bytes), for the utilization."""
        self._owner._note_dispatch(self.program)
        self._pending.append((t0, ready, cost))

    def settle(self, now: float) -> None:
        while self._pending:
            t0, ready, cost = self._pending[0]
            if ready is not None and not ready.query():
                break
            self._pending.popleft()
            self._owner._note_settled(self.program, max(0.0, now - t0), cost)


class ProgramTimers:
    """Per-program roofline telemetry.

    Families (all labelled ``program=`` from :data:`PROGRAMS`):

    - ``kukeon_program_dispatch_total`` — dispatches.
    - ``kukeon_program_seconds`` — wall time per settled dispatch.
    - ``kukeon_program_tokens_total`` — tokens the program processed.
    - ``kukeon_program_flops`` / ``kukeon_program_hbm_bytes`` — the
      program's per-dispatch cost (:meth:`set_cost`, at the engine's precompile).
    - ``kukeon_program_mfu`` / ``kukeon_program_membw_util`` — derived
      at scrape time: achieved FLOP/s (bytes/s) over the device peak,
      clamped to 1.0.

    Timing protocol: the programs call ``track(program).dispatched(t0,
    ready, cost)`` after each dispatch (a replay is only enqueued by
    then), and the engine's ``_fetch`` calls :meth:`settle` right after
    its blocking readback. Work on the stream runs in dispatch order, so
    everything enqueued before the fetched copy is complete by then; the
    end marks are probed without blocking and unready ones wait for the
    next fetch. The measured wall time therefore includes queue wait
    behind earlier work (with double-buffered decode chunks, up to the
    chunk before): an overestimate that can only LOWER the derived
    utilization, never inflate it. Achieved work is the sum of the
    settled dispatches' own costs (one program label covers several
    decode K), or, for a dispatch marked without one, the static cost."""

    def __init__(self, registry, peaks: tuple[float, float] | None = None):
        self._peaks = peaks
        self._lock = threading.Lock()
        self._dispatches: dict[str, int] = {}     # guarded-by: _lock
        self._settled: dict[str, int] = {}        # guarded-by: _lock
        self._busy_s: dict[str, float] = {}       # guarded-by: _lock
        self._work: dict[str, list[float]] = {}   # guarded-by: _lock
        self._tokens: dict[str, int] = {}         # guarded-by: _lock
        self._costs: dict[str, tuple[float, float]] = {}  # guarded-by: _lock
        self._timers: dict[str, _ProgramTimer] = {}
        self._events: list = []
        self._next_event = 0
        self._m_dispatch = registry.counter(
            "kukeon_program_dispatch_total",
            "Program dispatches (CUDA-graph replays; eager runs on the CPU), "
            "by engine program.",
            labels=("program",))
        self._m_seconds = registry.histogram(
            "kukeon_program_seconds",
            "Wall time per settled program dispatch (includes device "
            "queue wait), by program.",
            labels=("program",))
        self._m_tokens = registry.counter(
            "kukeon_program_tokens_total",
            "Tokens processed (prompt rows prefilled, batch*k decoded), "
            "by program.",
            labels=("program",))
        self._m_flops = registry.gauge(
            "kukeon_program_flops",
            "Per-dispatch FLOPs of the program (a plain count over the "
            "config and its key; 0 until the engine's precompile records it).",
            labels=("program",))
        self._m_bytes = registry.gauge(
            "kukeon_program_hbm_bytes",
            "Per-dispatch device-memory bytes of the program (weights, "
            "scales and KV rows, counted as kukeon_program_flops).",
            labels=("program",))
        registry.register_collector(self._collect)

    # --- engine-facing seam ------------------------------------------------

    def arm_events(self, device: torch.device, n: int = 64) -> None:
        """Make the ring of ``n`` CUDA events the end marks come from, each
        recorded once here so that its driver event exists before the first
        dispatch (recording a fresh event creates it). Call at boot, on the
        engine's thread, before any program runs."""
        self._events = [torch.cuda.Event() for _ in range(n)]
        with torch.cuda.device(device):
            for ev in self._events:
                ev.record()

    def end_event(self):
        """The next event of the ring, to record behind a replay (its mark
        is long settled or dropped by the time the ring comes round: each
        program keeps at most ``MAX_PENDING`` marks)."""
        ev = self._events[self._next_event]
        self._next_event = (self._next_event + 1) % len(self._events)
        return ev

    def track(self, program: str) -> _ProgramTimer:
        """The (engine-driver-thread) timer handle for one program."""
        t = self._timers.get(program)
        if t is None:
            t = self._timers[program] = _ProgramTimer(self, program)
        return t

    def settle(self) -> None:
        """Retire pending dispatch marks whose work is done. Called from the
        engine's counted ``_fetch`` seam ONLY — right after a blocking
        readback the budget already paid for."""
        now = time.monotonic()
        for t in self._timers.values():
            t.settle(now)

    def set_cost(self, program: str, flops: float, nbytes: float) -> None:
        """Record a program's per-dispatch cost (at the engine's precompile)."""
        with self._lock:
            self._costs[program] = (float(flops), float(nbytes))
        self._m_flops.set(float(flops), program=program)
        self._m_bytes.set(float(nbytes), program=program)

    def note_tokens(self, program: str, n: int) -> None:
        if n <= 0:
            return
        with self._lock:
            self._tokens[program] = self._tokens.get(program, 0) + int(n)
        self._m_tokens.inc(int(n), program=program)

    # --- accumulators (driver thread writes, scrape thread reads) ----------

    def _note_dispatch(self, program: str) -> None:
        with self._lock:
            self._dispatches[program] = self._dispatches.get(program, 0) + 1
        self._m_dispatch.inc(program=program)

    def _note_settled(self, program: str, dt: float, cost=None) -> None:
        with self._lock:
            self._settled[program] = self._settled.get(program, 0) + 1
            self._busy_s[program] = self._busy_s.get(program, 0.0) + dt
            if cost is None:
                cost = self._costs.get(program)
            if cost is not None:
                work = self._work.setdefault(program, [0.0, 0.0])
                work[0] += cost[0]
                work[1] += cost[1]
        self._m_seconds.observe(dt, program=program)

    # --- derived views -----------------------------------------------------

    def _utilization(self) -> dict[str, tuple[float, float]]:
        """{program: (mfu, membw_util)} over settled dispatches, clamped
        to [0, 1], for the programs with a recorded cost (as the
        reference's): achieved = the settled dispatches' FLOPs (bytes) /
        measured busy seconds; peak from :func:`device_peaks`."""
        peak_flops, peak_bw = self._peaks or device_peaks()
        out = {}
        with self._lock:
            for program in self._costs:
                busy = self._busy_s.get(program, 0.0)
                work = self._work.get(program)
                if busy <= 0.0 or work is None:
                    continue
                out[program] = (min(1.0, work[0] / (busy * peak_flops)),
                                min(1.0, work[1] / (busy * peak_bw)))
        return out

    def _collect(self) -> Iterable[object]:
        util = self._utilization()
        yield ("kukeon_program_mfu", "gauge",
               "Model FLOPs utilization per program: FLOPs of the settled "
               "dispatches / (measured busy seconds x device peak FLOP/s), "
               "clamped to 1.",
               [({"program": p}, mfu) for p, (mfu, _bw) in sorted(util.items())])
        yield ("kukeon_program_membw_util", "gauge",
               "Memory bandwidth utilization per program: bytes of the "
               "settled dispatches / (busy seconds x peak bytes/s), "
               "clamped to 1.",
               [({"program": p}, bw) for p, (_mfu, bw) in sorted(util.items())])

    def snapshot(self) -> dict[str, dict[str, float]]:
        """Per-program roofline summary: dispatches, settled count, busy
        seconds, tokens, per-dispatch cost, and derived MFU/bandwidth
        utilization."""
        util = self._utilization()
        out: dict[str, dict[str, float]] = {}
        with self._lock:
            programs = set(self._dispatches) | set(self._costs) | set(self._tokens)
            for p in sorted(programs):
                flops, nbytes = self._costs.get(p, (0.0, 0.0))
                mfu, bw = util.get(p, (0.0, 0.0))
                out[p] = {
                    "dispatches": self._dispatches.get(p, 0),
                    "settled": self._settled.get(p, 0),
                    "busy_s": round(self._busy_s.get(p, 0.0), 6),
                    "tokens": self._tokens.get(p, 0),
                    "flops": flops,
                    "hbm_bytes": nbytes,
                    "mfu": round(mfu, 6),
                    "membw_util": round(bw, 6),
                }
        return out

    def busy_seconds(self) -> dict[str, float]:
        with self._lock:
            return dict(self._busy_s)


class FlightRecorder:
    """Bounded ring of engine-loop step records — the step timeline.

    The engine driver appends one small dict per working step
    (:meth:`record`); HTTP readers snapshot the newest N
    (:meth:`snapshot`). The ring is a preallocated circular list: memory
    is bounded at ``capacity`` records forever, overwritten (dropped)
    records are counted on ``kukeon_timeline_dropped_total``, and both
    sides take one short lock."""

    DEFAULT_CAPACITY = 512

    def __init__(self, capacity: int = DEFAULT_CAPACITY, registry=None):
        self.capacity = max(1, int(capacity))
        self._lock = threading.Lock()
        self._ring: list[dict | None] = [None] * self.capacity  # guarded-by: _lock
        self._next_seq = 0   # guarded-by: _lock
        self._dropped = 0    # guarded-by: _lock
        self._m_dropped = None
        if registry is not None:
            self._m_dropped = registry.counter(
                "kukeon_timeline_dropped_total",
                "Step records overwritten in the flight-recorder ring "
                "before any reader saw the window slide past them.")
            registry.gauge(
                "kukeon_timeline_depth",
                "Step records currently held in the flight-recorder "
                "ring (caps at its capacity).").set_function(
                lambda: float(len(self)))

    def record(self, rec: dict) -> int:
        """Append one step record; returns its sequence number. The
        record is stamped with ``seq`` and ``t`` (wall-clock seconds)
        here so every producer shares one schema spine."""
        rec = dict(rec)
        rec.setdefault("t", time.time())
        with self._lock:
            seq = self._next_seq
            self._next_seq = seq + 1
            rec["seq"] = seq
            idx = seq % self.capacity
            if self._ring[idx] is not None:
                self._dropped += 1
            self._ring[idx] = rec
        if self._m_dropped is not None and seq >= self.capacity:
            self._m_dropped.inc()
        return seq

    def snapshot(self, n: int | None = None) -> list[dict]:
        """The newest ``n`` (default: all held) step records, oldest
        first — the shape `kuke timeline` renders top-to-bottom."""
        with self._lock:
            end = self._next_seq
            held = min(end, self.capacity)
            want = held if n is None else max(0, min(int(n), held))
            out = [self._ring[s % self.capacity] for s in range(end - want, end)]
        return [dict(r) for r in out if r is not None]

    @property
    def dropped(self) -> int:
        with self._lock:
            return self._dropped

    def __len__(self) -> int:
        with self._lock:
            return min(self._next_seq, self.capacity)


# --- per-layer cost profiler -----------------------------------------------------

LAYER_PROFILE_SCHEMA = "kukeon-layer-profile/v1"


def layer_cost(cfg, component: str, B: int, S: int, *, int8_weights: bool
               ) -> tuple[float, float]:
    """(FLOPs, memory bytes) of one component of a cacheless Llama forward
    over ``[B, S]`` tokens, counted as :func:`program_cost` counts:

    - ``embed``: one operation an element of the [B, S, H] rows (the cast,
      and the scale of an int8 table); bytes the rows gathered (and their
      scales), the token ids and the output.
    - ``layer<i>``: 2 x the layer's projection elements a token, and the
      dense attention's scores and value product, 4 H head_dim S a query
      (every query against its S keys); bytes the layer's weights (int8:
      one byte an element and a 4-byte scale an output column; else the
      config dtype's bytes) and its input and output rows.
    - ``head``: 2 H V a token; bytes the LM head's (or the tied
      embedding's) weights, the input rows and the f32 logits.
    """
    c = cfg
    D, V = c.hidden_size, c.vocab_size
    act = torch.finfo(c.dtype).bits // 8
    rows = B * S
    if component == "embed":
        w = 1 if int8_weights else act
        nbytes = rows * D * (w + act) + rows * 8 + (rows * 4 if int8_weights else 0)
        return float(rows * D), float(nbytes)
    if component == "head":
        wbytes = V * D + 4 * V if int8_weights else V * D * act
        return 2.0 * rows * D * V, float(wbytes + rows * D * act + rows * V * 4)
    mats = D * (c.q_dim + 2 * c.kv_dim) + c.q_dim * D + 3 * D * c.intermediate_size
    cols = c.q_dim + 2 * c.kv_dim + D + 2 * c.intermediate_size + D
    wbytes = mats + 4 * cols if int8_weights else mats * act
    flops = 2.0 * rows * mats + 4.0 * c.num_heads * c.head_dim * rows * S
    return flops, float(wbytes + 2 * rows * D * act)


def _time_eager(fn: Callable, args: tuple, reps: int) -> float:
    """Best of ``reps`` wall seconds of one call (the CPU's timing)."""
    best = math.inf
    for _ in range(max(1, reps)):
        t0 = time.monotonic()
        fn(*args)
        best = min(best, time.monotonic() - t0)
    return best


def _time_graph(fn: Callable, args: tuple, reps: int, pool, keep: list) -> float:
    """Best of ``reps`` device seconds of one replay of a CUDA graph of
    ``fn(*args)``, timed with CUDA events: one eager run on a side stream
    first (it builds the handles the capture must not), then the capture,
    one replay to warm, then the timed replays. The graph goes to ``keep``:
    while another capture may still draw on ``pool``, one of its graphs
    must live, for the caching allocator refuses a capture into a shared
    pool whose graphs are all gone until it has freed that pool."""
    dev = args[0].device
    cur = torch.cuda.current_stream(dev)
    side = torch.cuda.Stream(dev)
    side.wait_stream(cur)
    with torch.cuda.stream(side):
        fn(*args)
    cur.wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, pool=pool, capture_error_mode="thread_local"):
        out = fn(*args)
    graph.replay()
    best = math.inf
    for _ in range(max(1, reps)):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        best = min(best, start.elapsed_time(end) / 1e3)
    keep.append(graph)
    del out
    return best


_SHAPES = ("prefill", "decode")


def component_names(num_layers: int) -> list[str]:
    """The profile's components, in the order they run."""
    return ["embed"] + [f"layer{i}" for i in range(num_layers)] + ["head"]


def fault_plan(num_layers: int) -> list[str | None]:
    """The ``profile.layers`` fault point's draws for a profile of
    ``num_layers`` layers, made up front, in the order
    :func:`profile_layers` once drew them as it ran: once a shape of each
    component, a component's draws ending at its first fire. -> per
    component, the injected error's entry text, or None. A mesh's leader
    draws the plan and hands it to every rank, so all skip the same
    components: the followers arm no fault, and every rank must skip a
    skipped component's collectives."""
    from kukeon_tpu_torch import faults

    plan: list[str | None] = []
    for _name in component_names(num_layers):
        why = None
        for _shape in _SHAPES:
            try:
                faults.maybe_fail("profile.layers")
            except Exception as e:  # noqa: BLE001 — recorded as the component's error
                why = f"{type(e).__name__}: {e}"
                break
        plan.append(why)
    return plan


@torch.no_grad()
def profile_layers(params, cfg, device: torch.device | str | None = None, *,
                   prefill_len: int = 64, decode_batch: int = 8, measure: bool = True,
                   reps: int = 3, guard=None, mesh=None, plan: list | None = None) -> dict:
    """Per-component profile of a Llama model (the reference's
    ``profile_layers``, ``kukeon_tpu/obs/profile.py:441-560``): ``embed``,
    ``layer0`` .. ``layer{L-1}`` through the cacheless
    ``llama.transformer_block``, and ``head``, each at a prefill shape
    ``[1, prefill_len]`` and a decode shape ``[decode_batch, 1]``, with
    ``flops`` and ``bytes`` from :func:`layer_cost` and, when ``measure``,
    ``wall_s``: on CUDA the best of ``reps`` replays of a CUDA graph
    captured for the component (device time, CUDA events), on the CPU the
    best of ``reps`` eager calls (without ``measure``, one untimed call).
    Int8 weights take the route the engine's programs take
    (``cfg.int8_pallas``: the hand-written kernel where ``int8_matmul``
    routes a shape to it, as at decode). ``model_flops``/
    ``model_bytes`` are the whole model's prefill by :func:`program_cost`,
    the engine programs' count, so the components' prefill FLOPs sum to it
    (the embed's casts aside).

    ``mesh``: ``params`` is this rank's local tree, and each component
    runs with its collectives (the vocab-sharded lookup's ``all_reduce``,
    the two of a block, the logits' ``all_gather``); every rank of the
    group must make this call, in the same order, with the same ``plan``.
    The counts stay the whole model's, as the reference's cost analysis
    reports the same FLOPs and bytes on any mesh as on one device.

    Failures degrade, never crash, where every rank fails alike: the armed
    ``profile.layers`` fault point (drawn by :func:`fault_plan` unless
    ``plan`` holds the draws) and a MoE tree's layers (not dense blocks:
    the reference runs its dense block over the expert stacks, which fails
    at a batch neither 1 nor the expert count and means nothing at those)
    become ``error`` entries, counted in ``errors``, before any of their
    collectives. So does a component whose run raises on one device. On a
    mesh of more than one rank such a run error propagates instead: the
    rank stopped partway through the component's collectives, which its
    peers are in, so the caller ends the group (the engine's ``_dev``, a
    follower's action). ``guard``: a context manager held throughout (the
    engine's capture lock, so no engine capture runs beside these)."""
    from kukeon_tpu_torch.models import llama
    from kukeon_tpu_torch.ops.norms import rms_norm

    dev = torch.device(device) if device is not None else params["final_norm"].device
    n_layers, hidden = int(cfg.num_layers), int(cfg.hidden_size)
    prefill_len, decode_batch = max(1, int(prefill_len)), max(1, int(decode_batch))
    shapes = tuple(zip(_SHAPES, ((1, prefill_len), (decode_batch, 1))))
    int8 = llama._is_q(params["layers"]["wq"])
    kern = int8 and cfg.int8_pallas
    cuda = dev.type == "cuda"
    plan = fault_plan(n_layers) if plan is None else plan
    rows = llama.vocab_rows(cfg.vocab_size, llama._world(mesh))
    moe = "router" in params["layers"]
    group = mesh is not None and mesh.size > 1

    def embed_fn(tokens):
        return llama._embed(params, tokens, cfg.dtype, mesh, rows)

    def head_fn(x):
        return llama._logits(params, cfg, rms_norm(x, params["final_norm"], cfg.rms_norm_eps),
                             kern, mesh)

    def layer_fn(i: int):
        w = llama.layer_weights(params, i)
        return lambda x, positions: llama.transformer_block(x, w, cfg, positions, mesh=mesh,
                                                            kernel=kern)

    def args_for(name: str, B: int, S: int) -> tuple:
        if name == "embed":
            return (torch.zeros((B, S), dtype=torch.int64, device=dev),)
        x = torch.zeros((B, S, hidden), dtype=cfg.dtype, device=dev)
        if name == "head":
            return (x,)
        return (x, torch.arange(S, device=dev).expand(B, S))

    components: list[dict] = []
    errors = 0
    pool = torch.cuda.graph_pool_handle() if cuda and measure else None
    graphs: list = []       # the pool's graphs, kept until the last capture
    fns = [embed_fn] + [layer_fn(i) for i in range(n_layers)] + [head_fn]
    with guard if guard is not None else contextlib.nullcontext():
        for name, fn, fault in zip(component_names(n_layers), fns, plan):
            kind = name if name in ("embed", "head") else "layer"
            entry: dict[str, Any] = {"name": name}
            if fault is None and moe and kind == "layer":
                fault = "TypeError: a mixture-of-experts layer is not a dense transformer block"
            if fault is not None:
                errors += 1
                components.append({"name": name, "error": fault})
                continue
            try:
                for shape_name, (B, S) in shapes:
                    flops, nbytes = layer_cost(cfg, kind, B, S, int8_weights=int8)
                    rec: dict[str, Any] = {"flops": flops, "bytes": nbytes}
                    args = args_for(name, B, S)
                    if measure:
                        secs = (_time_graph(fn, args, reps, pool, graphs) if cuda
                                else _time_eager(fn, args, reps))
                        rec["wall_s"] = round(secs, 6)
                    else:
                        # Run once, untimed: the reference lowers every
                        # component, so one that cannot run fails either way.
                        fn(*args)
                    entry[shape_name] = rec
            except Exception as e:  # noqa: BLE001 — a partial profile beats a dead cell
                if group:
                    raise
                errors += 1
                entry = {"name": name, "error": f"{type(e).__name__}: {e}"}
            components.append(entry)
        del graphs
        if cuda:
            torch.cuda.empty_cache()
    model_flops, model_bytes = program_cost(
        cfg, "prefill", ("prefill", prefill_len, False, False), num_slots=1,
        max_seq_len=prefill_len, int8_weights=int8)
    return {
        "schema": LAYER_PROFILE_SCHEMA,
        "num_layers": n_layers,
        "prefill_len": prefill_len,
        "decode_batch": decode_batch,
        "model_flops": model_flops,
        "model_bytes": model_bytes,
        "components": components,
        "errors": errors,
    }
