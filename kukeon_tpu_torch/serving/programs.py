"""Decode and prefill programs, the port of the reference's compiled
programs: ``_build_programs`` (``kukeon_tpu/serving/engine.py:732``) with
its ``prefill`` (``:753``), ``prefill_ext`` (``:764``), ``insert``
(``:804``) and ``decode_chunk_fn`` (``:831``), which ``precompile``
(``:1264``) compiles by prompt bucket and chunk size, and the programs the
KV handoff runs (``_dispatch_prefill_export`` ``:2186``, ``_dispatch_import``
``:2263``).

The reference jits each program once per shape and donates the decode
state to it. Here a program reads and writes only static buffers the
engine owns: the decode state (:class:`DecodeState`: the KV cache ``k``/
``v`` and the scales of an int8 cache, ``lengths``, ``tokens``,
``active``, the three sampling arrays), a ``[B, K]`` token output for
each decode K, and the prefill programs' packed inputs and KV block
(:class:`PrefillPrograms`). Every write is a ``copy_``/``index_copy_``
into its buffer, or the forward's in-place row write into a cache.

- **CUDA**: each program is captured once as a CUDA graph
  (:meth:`_Programs.build`) and every run after is one
  ``cudaGraphLaunch``. All programs share one memory pool
  (``torch.cuda.graph_pool_handle()``): they never run at once, and their
  outputs live in the static buffers, not in the pool. A stochastic
  program registers the engine's generator with its graph
  (``CUDAGraph.register_generator_state``), so each replay draws fresh
  Gumbel noise. There is no eager fallback: a program that fails to
  capture raises with its key.
- **CPU** (tests, when the caller asks for it): the same program runs
  eagerly on the same static buffers.

Decode keys are ``(k, needs_filter, any_stochastic)``. The reference has
one program for every sampling mix (``lax.cond`` inside); a graph cannot
branch, so the two branch flags of :func:`sample_per_slot` pick the
program instead. A mix with no stochastic slot never filters, so every
greedy mix shares ``(k, False, False)``. Prefill keys are ``("prefill",
S, needs_filter, any_stochastic)`` and ``("prefill_ext", Pb, S,
needs_filter, any_stochastic)``; each prefill program ends with the
reference's ``insert`` of its block into the request's slot, so one
request's prefill and insert are one replay.

**KV handoff** (disaggregated serving): an export runs the prefill (or
``prefill_ext``) and the first token's sample with no insert, keys
``("prefill_export", S, nf, st)`` and ``("prefill_ext_export", Pb, S, nf,
st)``; it leaves the block in ``block_k``/``block_v`` and the token in
``first`` and touches no slot, block table or page. An import runs an
insert alone, keys ``("insert", S)`` and ``("insert_paged", S)``: the
block uploaded into ``block_k``/``block_v`` goes into the staged slot
(paged: its pages; an int8 cache quantized at insert), with the first
token taken from the inputs, where the tokens would sit.

**Paged layout** (``kv_page_tokens > 0``, the reference's
``decode_chunk_paged`` ``:929``, ``insert_paged`` ``:891`` and
``gather_block`` ``:871``): the cache is a pool ``[L, P + 1, page_tokens,
KV, D]`` (page 0 is scratch), ``lengths`` stay per slot, and a static
block table ``bt`` ``[B, max_pages]`` maps each slot's rows to pages. A
decode program gathers every slot's pages once into the static dense
view ``[L, B, S_max, KV, D]`` the forward already speaks, runs its K
steps there, and scatters the K new rows of each slot back to their
(page, offset) homes in one flat write; released slots' table rows are
zero, so their stray rows land in scratch. Paged prefill keys are
``("prefill_paged", S, nf, st)`` and ``("prefill_ext_paged", Pb, S, nf,
st)``: the block is scattered into the pool by page ids (shared pages
and padding to scratch, an int8 pool quantized at insert), and a
``prefill_ext_paged`` first gathers the shared prefix pages into the
block (dequantized for an int8 pool). The page ids ride in the packed
inputs, after the tokens.

**Instruments** (the engine's obs layer, when it passes them): every run
is marked on the engine's :class:`ProgramTimers` (dispatch counted, and on
CUDA an end event recorded behind the replay, which the engine's
``_fetch`` settles), and every build is counted on its
:class:`CompileTracker`. The labels are the reference's, by
:func:`program_labels`: a fused prefill key (``prefill``,
``prefill_paged``, ``prefill_export``) times as ``prefill`` and a
``prefill_ext*`` key as ``prefill_ext`` (the insert it holds is not timed
apart), the insert-only keys as ``insert`` or ``insert_paged``, a decode
key as ``decode_chunk`` or, paged, ``decode_chunk_paged``; builds count
as ``prefill`` (every prefill and export kind), ``insert`` or ``decode``.
Captures hold ``capture_lock``, which the cell's profiler also takes
around its start and stop.

**Tensor parallelism**: on a mesh the engine's forward carries the
collectives (``models/llama.py``), so a capture records them with the
kernels, and its warm-up run performs them. Every rank builds and runs the
same keys in the same order (the leader posts each build and run to its
followers, ``serving/engine.py``), so the ranks' warm-ups, captures and
replays meet in every collective. The cache and the prefill block hold the
rank's kv heads (``DecodeState.kv_heads``).

Captures run with ``capture_error_mode="thread_local"``: a streamed
boot's load thread copies weights on a stream of its own while the
engine's thread captures (``serving/engine.py``), and only the capturing
thread is held to the capture's rules.

Before a capture the program runs once eagerly on a side stream, under
``torch.cuda.set_sync_debug_mode("error")``: that builds the kernels and
cuBLAS handles, and an op that would synchronise the host (``.item()``,
``nonzero``, boolean indexing, ``F.one_hot`` without ``num_classes``)
raises there with its stack. What that run writes is saved before and put
back after (``snapshot``/``restore``), so capturing changes no state,
even mid-traffic.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Callable

import numpy as np
import torch

from kukeon_tpu_torch.models.llama import KVCache, quantize_kv
from kukeon_tpu_torch.ops.int8_matmul import int8_matmul, int8_matmul_expert
from kukeon_tpu_torch.serving.sampling import SamplingParams, sample_per_slot

Key = tuple[int, bool, bool]
PrefillKey = tuple
# The prefill programs' packed inputs: this header, then the prompt's
# (or tail's) tokens, zero-padded to the bucket. All of it is one upload.
HEADER = 6      # length, slot, plen, top_k, temperature, top_p (floats as f64 bits)


def chunk_sizes(decode_chunk: int) -> list[int]:
    """The chunk sizes ``precompile`` builds, the reference's rule
    (``kukeon_tpu/serving/engine.py:1310-1314``): 1 and 4, and every power
    of 4 up to ``decode_chunk``."""
    sizes, size = {1, 4}, 1
    while size * 4 <= decode_chunk:
        size *= 4
        sizes.add(size)
    return sorted(sizes)


def program_key(k: int, needs_filter: bool, any_stochastic: bool) -> Key:
    return (k, bool(needs_filter and any_stochastic), bool(any_stochastic))


def prefill_key(bucket: int, sp: SamplingParams, prefix_bucket: int | None = None,
                paged: bool = False, export: bool = False) -> PrefillKey:
    """The prefill program of one request: ``("prefill", bucket, nf, st)``,
    or with a stored prefix block of ``prefix_bucket`` rows
    ``("prefill_ext", prefix_bucket, bucket, nf, st)``; the branch flags
    of its sampling as :func:`program_key` takes them. ``paged``: the
    ``_paged`` kinds, which insert into the page pool; ``export``: the
    ``_export`` kinds, which insert nowhere (either layout)."""
    flags = program_key(bucket, sp.top_k > 0 or sp.top_p < 1.0, sp.temperature > 0)[1:]
    suffix = "_export" if export else "_paged" if paged else ""
    if prefix_bucket is None:
        return ("prefill" + suffix, bucket, *flags)
    return ("prefill_ext" + suffix, prefix_bucket, bucket, *flags)


def insert_key(bucket: int, paged: bool = False) -> PrefillKey:
    """The insert-only program of a KV import at ``bucket`` rows."""
    return ("insert_paged" if paged else "insert", bucket)


def program_labels(key, paged: bool) -> tuple[str, str]:
    """(timer label, compile label) of the program of ``key``: the
    reference's program names (``obs/profile.py`` ``PROGRAMS``) and its
    coarse ``prefill|insert|decode``. ``paged``: the engine's layout
    (a decode key does not say it)."""
    if isinstance(key[0], int):
        return ("decode_chunk_paged" if paged else "decode_chunk"), "decode"
    if key[0] in INSERT_KINDS:
        return key[0], "insert"
    return ("prefill_ext" if _is_ext(key) else "prefill"), "prefill"


def pack_prefill_inputs(tokens: np.ndarray, bucket: int, length: int, slot: int,
                        plen: int, sp: SamplingParams,
                        pages: tuple[np.ndarray, np.ndarray, int] | None = None
                        ) -> np.ndarray:
    """The packed prefill inputs, int64 [HEADER + bucket]: ``length`` is the
    whole prompt's, ``plen`` the stored prefix's (0 without one), and
    ``tokens`` the rows the program runs (the prompt, or its tail past
    ``plen``), zero-padded to ``bucket``. ``pages``: the paged layout's
    (gather ids, insert ids, max_pages), each list zero-padded to
    max_pages after the token rows (the paged engine packs S_max of them,
    so the ids sit at fixed offsets)."""
    mp = pages[2] if pages is not None else 0
    out = np.zeros((HEADER + bucket + 2 * mp,), np.int64)
    out[:4] = (length, slot, plen, sp.top_k)
    out[4:HEADER] = np.array([sp.temperature, sp.top_p], np.float64).view(np.int64)
    out[HEADER:HEADER + tokens.size] = tokens
    if pages is not None:
        gather, insert, _ = pages
        at = HEADER + bucket
        out[at:at + gather.size] = gather
        out[at + mp:at + mp + insert.size] = insert
    return out


def _rows(c: KVCache) -> dict[str, torch.Tensor]:
    out = {"k": c.k, "v": c.v}
    if c.quantized:
        out.update(k_scale=c.k_scale, v_scale=c.v_scale)
    return out


@dataclasses.dataclass
class DecodeState:
    """Whole-engine decode state: static device buffers that the engine
    writes in place and every decode program reads. Paged (``bt`` set):
    ``cache`` is the page pool [L, P + 1, page_tokens, KV, D] with
    per-slot ``lengths`` [B], ``bt`` the block table and ``view`` the
    dense view a decode chunk runs on (its lengths unused)."""

    cache: KVCache                # [L, B, S_max, KV, D] (or the pool) + lengths [B]
    tokens: torch.Tensor          # [B] int64: last emitted token per slot
    active: torch.Tensor          # [B] bool: slot currently generating
    temps: torch.Tensor           # [B] f32 sampling arrays (slot_sampling_arrays)
    top_ks: torch.Tensor          # [B] int64
    top_ps: torch.Tensor          # [B] f32
    bt: torch.Tensor | None = None      # paged: [B, max_pages] int64 page ids
    view: KVCache | None = None         # paged: [L, B, S_max, KV, D]

    @staticmethod
    def create(cfg, num_slots: int, max_len: int, quantized: bool,
               device: torch.device, page_tokens: int = 0,
               pool_pages: int = 0, kv_heads: int | None = None) -> "DecodeState":
        """``kv_heads``: the kv heads the cache holds (a rank's share under
        tensor parallelism), default ``cfg.num_kv_heads``."""
        B = num_slots
        bt = view = None
        kw = {"quantized": quantized, "device": device, "kv_heads": kv_heads}
        if page_tokens:
            cache = KVCache.create(cfg, pool_pages + 1, page_tokens, **kw)
            cache.lengths = torch.zeros((B,), dtype=torch.int64, device=device)
            bt = torch.zeros((B, max_len // page_tokens), dtype=torch.int64, device=device)
            view = KVCache.create(cfg, B, max_len, **kw)
        else:
            cache = KVCache.create(cfg, B, max_len, **kw)
        return DecodeState(
            cache=cache,
            tokens=torch.zeros((B,), dtype=torch.int64, device=device),
            active=torch.zeros((B,), dtype=torch.bool, device=device),
            temps=torch.zeros((B,), dtype=torch.float32, device=device),
            top_ks=torch.zeros((B,), dtype=torch.int64, device=device),
            top_ps=torch.ones((B,), dtype=torch.float32, device=device),
            bt=bt, view=view,
        )

    @property
    def paged(self) -> bool:
        return self.bt is not None

    @property
    def page_tokens(self) -> int:
        return self.cache.k.shape[2] if self.paged else 0

    @property
    def kv_heads(self) -> int:
        """The kv heads the cache holds."""
        return self.cache.k.shape[3]

    @property
    def max_len(self) -> int:
        """Rows a slot can hold (S_max)."""
        return (self.view if self.paged else self.cache).max_len

    def cache_rows(self) -> dict[str, torch.Tensor]:
        """The buffers a decode step writes one row of per slot: k and v,
        and the scales of an int8 cache, each [L, B, S_max, ...] (paged:
        the pool's, [L, P + 1, page_tokens, ...])."""
        return _rows(self.cache)

    def view_bytes(self) -> int:
        """Bytes of the paged layout's dense view (0 on the legacy one)."""
        return sum(t.numel() * t.element_size() for t in _rows(self.view).values()
                   ) if self.paged else 0

    def buffers(self) -> dict[str, torch.Tensor]:
        """Every static buffer by name."""
        out = {**self.cache_rows(), "lengths": self.cache.lengths, "tokens": self.tokens,
               "active": self.active, "temps": self.temps, "top_ks": self.top_ks,
               "top_ps": self.top_ps}
        if self.paged:
            out["bt"] = self.bt
            out.update({f"view_{n}": t for n, t in _rows(self.view).items()})
        return out

    def reset(self) -> None:
        """Back to the state :meth:`create` gives, in place: the graphs keep
        reading these very tensors."""
        for name, t in self.buffers().items():
            t.fill_(1 if name == "top_ps" else 0)


def _flat(pool: torch.Tensor) -> torch.Tensor:
    """A page pool [L, P + 1, pt, ...] as flat rows [L, (P + 1) * pt, ...]."""
    return pool.view(pool.shape[0], -1, *pool.shape[3:])


@dataclasses.dataclass
class _Program:
    graph: "torch.cuda.CUDAGraph | None"       # None: runs eagerly (CPU)
    launches: dict[str, int]                    # kernel launches recorded in one run


def _kernel_counts() -> dict[str, int]:
    return {"int8_matmul": int8_matmul.launches - int8_matmul.launches_t,
            "int8_matmul_transposed": int8_matmul.launches_t,
            "int8_matmul_expert": int8_matmul_expert.launches}


class _Programs:
    """What the decode and prefill programs share: one program per key,
    built once (:meth:`build`) and run by :meth:`_launch`.

    ``stats``: ``captures`` (programs built: one capture each on CUDA),
    ``capture_s``, ``captures_after_warmup`` (built while ``warm`` is set:
    the engine sets it once its warmup is done), ``pool_bytes`` (the
    device memory the captures reserved, each measured between emptied
    caches), ``replays``, ``replays_by_key``, and ``launches_by_key``
    (each program's kernel launches in one run, counted by the kernels'
    wrappers while it was captured).

    ``timers`` (a ``ProgramTimers``), ``compiles`` (a ``CompileTracker``)
    and ``cost`` (``(timer label, key) -> (FLOPs, bytes)``, each run's
    cost on its timer mark) are the engine's instruments.
    ``capture_lock``: held by every capture (shared by the decode and the
    prefill programs of one engine)."""

    kind = "program"

    def __init__(self, forward: Callable, params, cfg, state: DecodeState,
                 generator: torch.Generator, pool=None, *, timers=None, compiles=None,
                 cost: Callable | None = None, capture_lock: threading.Lock | None = None):
        self._forward = forward
        self._params = params
        self._cfg = cfg
        self.state = state
        self._gen = generator
        self.device = state.tokens.device
        self._programs: dict = {}
        self.pool = pool
        if pool is None and self.device.type == "cuda":
            self.pool = torch.cuda.graph_pool_handle()
        self._timers = timers
        self._compiles = compiles
        self._cost = cost
        self._key_cost: dict = {}
        self.capture_lock = capture_lock or threading.Lock()
        self.warm = False
        self.stats = {"captures": 0, "capture_s": 0.0, "captures_after_warmup": 0,
                      "pool_bytes": 0, "replays": 0, "replays_by_key": {},
                      "launches_by_key": {}}

    def keys(self) -> list:
        return sorted(self._programs)

    def run_eager(self, key):
        raise NotImplementedError

    def stochastic(self, key) -> bool:
        """Whether the program of ``key`` draws from the generator."""
        return bool(key[-1])

    def snapshot_key(self, key) -> dict:
        """What one run of ``key`` writes, saved (see ``restore``)."""
        raise NotImplementedError

    def restore(self, snap: dict) -> None:
        raise NotImplementedError

    def _launch(self, key) -> None:
        """Run the program of ``key`` (built at first use): one graph replay
        on CUDA, the eager body on the CPU."""
        prog = self._programs.get(key) or self.build(key)
        t0 = time.monotonic()
        ready = None
        if prog.graph is not None:
            prog.graph.replay()
            if self._timers is not None:
                ready = self._timers.end_event()
                ready.record()
        else:
            self.run_eager(key)
        if self._timers is not None:
            self._timers.track(program_labels(key, self.state.paged)[0]).dispatched(
                t0, ready, self._key_cost.get(key))
        s = self.stats
        s["replays"] += 1
        s["replays_by_key"][str(key)] = s["replays_by_key"].get(str(key), 0) + 1

    def build(self, key) -> _Program:
        """Capture the program of ``key`` (CUDA) or register it (CPU); a
        key already built is returned as it is. A capture reads the static
        inputs as they stand: its warm-up run needs them valid."""
        if key in self._programs:
            return self._programs[key]
        t0 = time.monotonic()
        s = self.stats
        if self.device.type == "cuda":
            with self.capture_lock:
                torch.cuda.empty_cache()
                reserved = torch.cuda.memory_reserved(self.device)
                prog = self._capture(key)
                torch.cuda.empty_cache()
                s["pool_bytes"] += torch.cuda.memory_reserved(self.device) - reserved
        else:
            prog = _Program(None, {n: 0 for n in _kernel_counts()})
        self._programs[key] = prog
        secs = time.monotonic() - t0
        s["captures"] += 1
        s["captures_after_warmup"] += self.warm
        s["capture_s"] += secs
        s["launches_by_key"][str(key)] = prog.launches
        label, coarse = program_labels(key, self.state.paged)
        if self._compiles is not None:
            self._compiles.note_build(coarse, secs)
        if self._cost is not None:
            self._key_cost[key] = self._cost(label, key)
        return prog

    def _capture(self, key) -> _Program:
        cur = torch.cuda.current_stream(self.device)
        snap = self.snapshot_key(key)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(cur)
        mode = torch.cuda.get_sync_debug_mode()
        try:
            with torch.cuda.stream(side):
                torch.cuda.set_sync_debug_mode("error")
                self.run_eager(key)
        except RuntimeError as e:
            raise RuntimeError(f"{self.kind} program {key}: its warm-up run failed: {e}") from e
        finally:
            torch.cuda.set_sync_debug_mode(mode)
        cur.wait_stream(side)
        self.restore(snap)
        graph = torch.cuda.CUDAGraph()
        if self.stochastic(key):
            graph.register_generator_state(self._gen)
        before = _kernel_counts()
        try:
            # thread_local: a streamed boot's load thread makes CUDA calls
            # (copies on its own stream, event queries) while the engine's
            # thread captures; under the default "global" mode any of them
            # could void this capture. This thread stays held to the rule.
            with torch.cuda.graph(graph, pool=self.pool, capture_error_mode="thread_local"):
                self.run_eager(key)
        except RuntimeError as e:
            raise RuntimeError(f"{self.kind} program {key} failed to capture: {e}") from e
        after = _kernel_counts()
        return _Program(graph, {n: after[n] - before[n] for n in after})


class DecodePrograms(_Programs):
    """The engine's decode programs over one :class:`DecodeState`; ``stats``
    also counts ``steps`` (the decode steps of the chunks run)."""

    kind = "decode"

    def __init__(self, forward: Callable, params, cfg, state: DecodeState,
                 generator: torch.Generator, pool=None, **instruments):
        super().__init__(forward, params, cfg, state, generator, pool, **instruments)
        self._outputs: dict[int, torch.Tensor] = {}
        self.stats["steps"] = 0

    def output(self, k: int) -> torch.Tensor:
        """The static [B, k] token output of every k-step program."""
        if k not in self._outputs:
            B = self.state.tokens.shape[0]
            self._outputs[k] = torch.zeros((B, k), dtype=torch.int64, device=self.device)
        return self._outputs[k]

    def run_eager(self, key: Key) -> torch.Tensor:
        """The program of ``key``, launched op by op: the body every capture
        records (and the warm-up before it). Returns the static output.
        Paged: the slots' pages are gathered into the dense view first, and
        the chunk's new rows scattered back to the pool after."""
        k, needs_filter, any_stochastic = key
        st, out = self.state, self.output(k)
        lengths = st.cache.lengths
        cache = st.cache
        if st.paged:
            start = lengths.clone()
            idx = st.bt.reshape(-1)
            for pool, view in zip(st.cache_rows().values(), _rows(st.view).values()):
                torch.index_select(pool, 1, idx, out=view.view(
                    pool.shape[0], idx.numel(), *pool.shape[2:]))
            cache = st.view
        for i in range(k):
            # The forward gets a shallow copy of the cache: it writes the
            # new K/V rows in place and returns new lengths, which land in
            # the static buffer below, masked.
            logits, moved = self._forward(self._params, self._cfg, st.tokens[:, None],
                                          lengths[:, None],
                                          dataclasses.replace(cache, lengths=lengths))
            nxt = sample_per_slot(logits[:, 0, :], self._gen, st.temps, st.top_ks, st.top_ps,
                                  needs_filter=needs_filter, any_stochastic=any_stochastic)
            lengths.copy_(torch.where(st.active, moved.lengths, lengths))
            st.tokens.copy_(torch.where(st.active, nxt, st.tokens))
            out[:, i].copy_(st.tokens)
        if st.paged:
            pos, dest = self.pool_dest(start, k)
            slots = torch.arange(pos.shape[0], device=self.device)[:, None]
            for pool, view in zip(st.cache_rows().values(), _rows(st.view).values()):
                rows = view[:, slots, pos]                       # [L, B, K, ...]
                _flat(pool).index_copy_(1, dest, rows.reshape(
                    rows.shape[0], -1, *rows.shape[3:]))
        return out

    def pool_dest(self, start: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
        """Paged: the positions [B, k] a k-step chunk writes from lengths
        ``start`` (clamped to S_max - 1, as the forward clamps them) and
        their flat pool rows [B * k], ``bt[b, pos // pt] * pt + pos % pt``
        (page 0, scratch, for a zeroed table row)."""
        st = self.state
        pt = st.page_tokens
        pos = torch.clamp(start[:, None] + torch.arange(k, device=self.device),
                          max=st.max_len - 1)
        page = torch.gather(st.bt, 1, pos // pt)
        return pos, (page * pt + pos % pt).reshape(-1)

    def run(self, key: Key) -> torch.Tensor:
        """Run the program of ``key`` (built at first use): one graph replay
        on CUDA, the eager body on the CPU. Returns the static [B, k] output."""
        self._launch(key)
        self.stats["steps"] += key[0]
        return self._outputs[key[0]]

    def build(self, key: Key) -> _Program:
        self.output(key[0])
        return super().build(key)

    def snapshot_key(self, key: Key) -> dict:
        return self.snapshot(key[0])

    def snapshot(self, k: int) -> dict:
        """What a k-step program writes, saved: every slot's cache rows at
        its length and the k - 1 after (clamped as the forward clamps them;
        paged: the pool rows they scatter to, and the block table), lengths,
        tokens, the [B, k] output and the generator state. The paged dense
        view is not saved: every run gathers it afresh."""
        st = self.state
        c = st.cache
        snap = {"lengths": c.lengths.clone(), "tokens": st.tokens.clone(),
                "out": self.output(k).clone(), "gen": self._gen.get_state()}
        if st.paged:
            _, dest = self.pool_dest(c.lengths, k)
            return {**snap, "dest": dest, "bt": st.bt.clone(),
                    "kv": {n: _flat(t)[:, dest].clone() for n, t in st.cache_rows().items()}}
        rows = torch.clamp(c.lengths[:, None] + torch.arange(k, device=self.device),
                           max=c.max_len - 1)
        slots = torch.arange(rows.shape[0], device=self.device)[:, None]
        kv = {n: t[:, slots, rows].clone() for n, t in self.state.cache_rows().items()}
        return {**snap, "slots": slots, "rows": rows, "kv": kv}

    def restore(self, snap: dict) -> None:
        """Put back what :meth:`snapshot` saved, in place."""
        st = self.state
        for n, t in self.state.cache_rows().items():
            if st.paged:
                _flat(t).index_copy_(1, snap["dest"], snap["kv"][n])
            else:
                t[:, snap["slots"], snap["rows"]] = snap["kv"][n]
        if st.paged:
            st.bt.copy_(snap["bt"])
        st.cache.lengths.copy_(snap["lengths"])
        st.tokens.copy_(snap["tokens"])
        self.output(snap["out"].shape[1]).copy_(snap["out"])
        self._gen.set_state(snap["gen"])

    def written_rows(self, snap: dict) -> dict[str, torch.Tensor]:
        """The cache rows a snapshot covers, as they are now. Paged: the
        pool rows outside page 0, whose duplicate stray writes land in no
        fixed order."""
        if self.state.paged:
            dest = snap["dest"][snap["dest"] >= self.state.page_tokens]
            return {n: _flat(t)[:, dest].clone() for n, t in self.state.cache_rows().items()}
        return {n: t[:, snap["slots"], snap["rows"]].clone()
                for n, t in self.state.cache_rows().items()}


INSERT_KINDS = ("insert", "insert_paged")


def _is_ext(key: PrefillKey) -> bool:
    return key[0].startswith("prefill_ext")


def _is_export(key: PrefillKey) -> bool:
    return key[0].endswith("_export")


class PrefillPrograms(_Programs):
    """The engine's prefill programs: ``prefill`` and ``prefill_ext``, each
    followed by ``insert``, over the packed ``inputs`` (int64 [HEADER +
    S_max]) and the KV ``block_k``/``block_v`` ([L, 1, S_max, KV, D], the
    model dtype), allocated once at the cache's length; a key runs on
    views of them. The block is a prefill's output (what the prefix cache
    stores, full precision), and a ``prefill_ext``'s input (the stored
    prefix, written in by :meth:`load_prefix`) and output. ``bucket``:
    the engine's bucket rule, which re-buckets a ``prefill_ext`` block to
    ``min(bucket(Pb + S), S_max)`` rows as the reference does.

    The KV handoff's programs run on the same buffers: an export key
    leaves its block and its first token (``first``, int64 [1]) and
    inserts nowhere; an insert-only key inserts the block an import
    uploaded, with the first token from the inputs.

    ``stats`` adds ``static_bytes``, the inputs' and the block's bytes."""

    kind = "prefill"

    def __init__(self, forward: Callable, params, cfg, state: DecodeState,
                 generator: torch.Generator, bucket: Callable[[int], int], pool=None,
                 **instruments):
        super().__init__(forward, params, cfg, state, generator, pool, **instruments)
        self._bucket = bucket
        S = state.max_len
        shape = (cfg.num_layers, 1, S, state.kv_heads, cfg.head_dim)
        # Paged: the gather ids, then the insert ids, after the tokens.
        self.max_pages = state.bt.shape[1] if state.paged else 0
        self.inputs = torch.zeros((HEADER + S + 2 * self.max_pages,), dtype=torch.int64,
                                  device=self.device)
        self.block_k = torch.zeros(shape, dtype=cfg.dtype, device=self.device)
        self.block_v = torch.zeros(shape, dtype=cfg.dtype, device=self.device)
        self.first = torch.zeros((1,), dtype=torch.int64, device=self.device)
        self.stats["static_bytes"] = sum(t.numel() * t.element_size() for t in self.buffers().values())

    def buffers(self) -> dict[str, torch.Tensor]:
        return {"inputs": self.inputs, "block_k": self.block_k, "block_v": self.block_v,
                "first": self.first}

    def reset(self) -> None:
        """Zero every static buffer, in place (the graphs read these very
        tensors)."""
        for t in self.buffers().values():
            t.zero_()

    def stochastic(self, key: PrefillKey) -> bool:
        return key[0] not in INSERT_KINDS and bool(key[-1])

    def block_len(self, key: PrefillKey) -> int:
        """Rows of the block a program leaves (or an insert-only program
        inserts): its bucket, or for ``prefill_ext`` the canonical
        ``min(bucket(Pb + S), S_max)``."""
        if not _is_ext(key):
            return key[1]
        return min(self._bucket(key[1] + key[2]), self.state.max_len)

    def page_ids(self, which: str, n: int) -> torch.Tensor:
        """Paged: the first ``n`` staged ``"gather"`` or ``"insert"`` page ids."""
        at = HEADER + self.state.max_len + (self.max_pages if which == "insert" else 0)
        return self.inputs[at:at + n]

    def block(self, key: PrefillKey) -> tuple[torch.Tensor, torch.Tensor]:
        """Views of the block a run of ``key`` left (copy before the next)."""
        n = self.block_len(key)
        return self.block_k[:, :, :n], self.block_v[:, :, :n]

    def load_prefix(self, kv_k: torch.Tensor, kv_v: torch.Tensor) -> None:
        """Write a stored prefix block [L, 1, Pb, KV, D] into the block, the
        input of a ``prefill_ext`` of that ``Pb``."""
        Pb = kv_k.shape[2]
        self.block_k[:, :, :Pb].copy_(kv_k)
        self.block_v[:, :, :Pb].copy_(kv_v)

    def run(self, key: PrefillKey) -> None:
        """Run the program of ``key`` (built at first use) on the staged
        inputs: one graph replay on CUDA, the eager body on the CPU. The
        first token lands in ``state.tokens[slot]`` (an export's in
        ``first``)."""
        self._launch(key)

    def logits(self, key: PrefillKey) -> torch.Tensor:
        """The forward of ``key`` on the staged inputs -> the last prompt
        position's logits [1, V] f32; the block holds the prompt's KV after.

        ``prefill``: the forward writes the block's first S rows in place.
        ``prefill_ext``: a fresh [L, 1, Pb + S] cache takes the stored
        prefix, the tail runs at positions plen.. against it, and its first
        ``block_len`` rows (zero-padded) go back to the block."""
        inp = self.inputs
        length, plen = inp[0:1], inp[2:3]
        if key[0] == "prefill_ext_paged":
            self._gather_prefix(key[1])
        if not _is_ext(key):
            Pb, S = 0, key[1]
            cache = KVCache(k=self.block_k[:, :, :S], v=self.block_v[:, :, :S], lengths=plen)
        else:
            Pb, S = key[1], key[2]
            cache = KVCache.create(self._cfg, 1, Pb + S, device=self.device,
                                   kv_heads=self.state.kv_heads)
            cache.k[:, :, :Pb].copy_(self.block_k[:, :, :Pb])
            cache.v[:, :, :Pb].copy_(self.block_v[:, :, :Pb])
            cache.lengths = plen
        tokens = inp[HEADER:HEADER + S][None, :]
        positions = plen[:, None] + torch.arange(S, device=self.device)[None, :]
        logits, cache = self._forward(self._params, self._cfg, tokens, positions, cache,
                                      logit_positions=length - plen - 1)
        if Pb:
            n = self.block_len(key)
            keep = min(Pb + S, n)
            for out, t in ((self.block_k, cache.k), (self.block_v, cache.v)):
                out[:, :, :keep].copy_(t[:, :, :keep])
                out[:, :, keep:n].zero_()
        return logits[:, 0, :]

    def _gather_prefix(self, Pb: int) -> None:
        """Paged ``gather_block``: the staged gather ids' pool pages into the
        block's first ``Pb`` rows, dequantized from an int8 pool (f32
        product, cast down, as the reference)."""
        pool, pt = self.state.cache, self.state.page_tokens
        gid = self.page_ids("gather", Pb // pt)
        L = self._cfg.num_layers
        for out, t, sc in ((self.block_k, pool.k, pool.k_scale),
                           (self.block_v, pool.v, pool.v_scale)):
            rows = t.index_select(1, gid).reshape(L, 1, Pb, *t.shape[3:])
            if sc is not None:
                scale = sc.index_select(1, gid).reshape(L, 1, Pb, -1)
                rows = (rows.float() * scale[..., None].float()).to(self._cfg.dtype)
            out[:, :, :Pb].copy_(rows)

    def run_eager(self, key: PrefillKey) -> None:
        """The program of ``key``, launched op by op: the forward
        (:meth:`logits`) and the first token's sample, then the insert
        (:meth:`_insert`). An export key stops after the sample, with the
        token in ``first``; an insert-only key is the insert alone, of the
        token staged where the tokens sit."""
        inp = self.inputs
        if key[0] in INSERT_KINDS:
            first = inp[HEADER:HEADER + 1]
        else:
            top_k = inp[3:4]
            temp, top_p = inp[4:HEADER].view(torch.float64).float().split(1)
            first = sample_per_slot(self.logits(key), self._gen, temp, top_k, top_p,
                                    needs_filter=key[-2], any_stochastic=key[-1])
            if _is_export(key):
                self.first.copy_(first)
                return
        self._insert(key, first)

    def _insert(self, key: PrefillKey, first: torch.Tensor) -> None:
        """The reference's ``insert``: the block into the staged slot's
        first rows (quantized here for an int8 cache; paged,
        ``insert_paged``: into the pool pages of the staged insert ids),
        the slot's length and token, and active."""
        inp = self.inputs
        length, slot = inp[0:1], inp[1:2]
        st = self.state
        c = st.cache
        n = self.block_len(key)
        kv_k, kv_v = self.block(key)
        ks = vs = None
        if c.quantized:
            kv_k, ks = quantize_kv(kv_k)            # [L, 1, n, KV(, D)]
            kv_v, vs = quantize_kv(kv_v)
        if st.paged:
            ids = self.page_ids("insert", n // st.page_tokens)
            L, pt = c.k.shape[0], st.page_tokens
            for pool, x in ((c.k, kv_k), (c.v, kv_v), (c.k_scale, ks), (c.v_scale, vs)):
                if x is not None:
                    pool.index_copy_(1, ids, x.reshape(L, -1, pt, *x.shape[3:]).to(pool.dtype))
        else:
            if c.quantized:
                c.k_scale[:, :, :n].index_copy_(1, slot, ks)
                c.v_scale[:, :, :n].index_copy_(1, slot, vs)
            c.k[:, :, :n].index_copy_(1, slot, kv_k.to(c.k.dtype))
            c.v[:, :, :n].index_copy_(1, slot, kv_v.to(c.v.dtype))
        c.lengths.index_copy_(0, slot, length)
        st.tokens.index_copy_(0, slot, first)
        st.active.index_fill_(0, slot, True)

    def snapshot_key(self, key: PrefillKey) -> dict:
        """What a run of ``key`` writes, saved: the block's rows (a
        ``prefill_ext``'s input too), ``first`` and the generator state, and
        unless it is an export the staged slot's first ``block_len`` cache
        rows (paged: the staged insert pages), lengths, tokens and active."""
        n = self.block_len(key)
        st = self.state
        snap = {"rows": n, "block_k": self.block_k[:, :, :n].clone(),
                "block_v": self.block_v[:, :, :n].clone(), "first": self.first.clone(),
                "gen": self._gen.get_state()}
        if _is_export(key):
            return snap
        slot = self.inputs[1:2].clone()
        snap.update(slot=slot, lengths=st.cache.lengths.clone(), tokens=st.tokens.clone(),
                    active=st.active.clone())
        if st.paged:
            ids = self.page_ids("insert", n // st.page_tokens).clone()
            return {**snap, "ids": ids,
                    "kv": {name: t.index_select(1, ids) for name, t in st.cache_rows().items()}}
        return {**snap, "kv": {name: t[:, :, :n].index_select(1, slot)
                               for name, t in st.cache_rows().items()}}

    def restore(self, snap: dict) -> None:
        """Put back what :meth:`snapshot_key` saved, in place."""
        st, n = self.state, snap["rows"]
        if "kv" in snap:
            for name, t in st.cache_rows().items():
                if st.paged:
                    t.index_copy_(1, snap["ids"], snap["kv"][name])
                else:
                    t[:, :, :n].index_copy_(1, snap["slot"], snap["kv"][name])
            st.cache.lengths.copy_(snap["lengths"])
            st.tokens.copy_(snap["tokens"])
            st.active.copy_(snap["active"])
        self.block_k[:, :, :n].copy_(snap["block_k"])
        self.block_v[:, :, :n].copy_(snap["block_v"])
        self.first.copy_(snap["first"])
        self._gen.set_state(snap["gen"])
