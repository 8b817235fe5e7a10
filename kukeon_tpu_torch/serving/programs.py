"""Decode programs, the port of the reference's compiled decode:
``_build_programs`` (``kukeon_tpu/serving/engine.py:732``) and its
``decode_chunk_fn`` (``:831``), which ``precompile`` (``:1264``) compiles
for every chunk size.

The reference jits ``decode_chunk_fn``, a ``lax.scan`` of K decode steps,
once per K and donates the decode state to it. Here a decode program is K
steps of the engine's forward that read and write only static buffers the
engine owns (:class:`DecodeState`): the KV cache ``k``/``v`` (and the
scales of an int8 cache), ``lengths``, ``tokens``, ``active``, the three
sampling arrays, and a ``[B, K]`` token output for each K. Every write is
a ``copy_`` into its buffer, or the forward's in-place row write into the
cache, with inactive slots masked as before.

- **CUDA**: each program is captured once as a CUDA graph
  (:meth:`DecodePrograms.build`) and every chunk after is one
  ``cudaGraphLaunch``. All programs share one memory pool
  (``torch.cuda.graph_pool_handle()``): they never run at once, and their
  outputs live in the static buffers, not in the pool. A stochastic
  program registers the engine's generator with its graph
  (``CUDAGraph.register_generator_state``), so each replay draws fresh
  Gumbel noise. There is no eager fallback: a program that fails to
  capture raises with its key.
- **CPU** (tests, when the caller asks for it): the same program runs
  eagerly on the same static buffers.

Keys are ``(k, needs_filter, any_stochastic)``. The reference has one
program for every sampling mix (``lax.cond`` inside); a graph cannot
branch, so the two branch flags of :func:`sample_per_slot` pick the
program instead. A mix with no stochastic slot never filters, so every
greedy mix shares ``(k, False, False)``.

Before a capture the program runs once eagerly on a side stream, under
``torch.cuda.set_sync_debug_mode("error")``: that builds the kernels and
cuBLAS handles, and an op that would synchronise the host (``.item()``,
``nonzero``, boolean indexing, ``F.one_hot`` without ``num_classes``)
raises there with its stack. The rows that run writes are saved before
and put back after (:meth:`DecodePrograms.snapshot`), so capturing
changes no state, even mid-traffic.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable

import torch

from kukeon_tpu_torch.models.llama import KVCache
from kukeon_tpu_torch.ops.int8_matmul import int8_matmul, int8_matmul_expert
from kukeon_tpu_torch.serving.sampling import sample_per_slot

Key = tuple[int, bool, bool]


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


@dataclasses.dataclass
class DecodeState:
    """Whole-engine decode state: static device buffers that the engine
    writes in place and every decode program reads."""

    cache: KVCache                # [L, B, S_max, KV, D] + lengths [B]
    tokens: torch.Tensor          # [B] int64: last emitted token per slot
    active: torch.Tensor          # [B] bool: slot currently generating
    temps: torch.Tensor           # [B] f32 sampling arrays (slot_sampling_arrays)
    top_ks: torch.Tensor          # [B] int64
    top_ps: torch.Tensor          # [B] f32

    @staticmethod
    def create(cfg, num_slots: int, max_len: int, quantized: bool,
               device: torch.device) -> "DecodeState":
        B = num_slots
        return DecodeState(
            cache=KVCache.create(cfg, B, max_len, quantized=quantized, device=device),
            tokens=torch.zeros((B,), dtype=torch.int64, device=device),
            active=torch.zeros((B,), dtype=torch.bool, device=device),
            temps=torch.zeros((B,), dtype=torch.float32, device=device),
            top_ks=torch.zeros((B,), dtype=torch.int64, device=device),
            top_ps=torch.ones((B,), dtype=torch.float32, device=device),
        )

    def cache_rows(self) -> dict[str, torch.Tensor]:
        """The buffers a decode step writes one row of per slot: k and v,
        and the scales of an int8 cache, each [L, B, S_max, ...]."""
        c = self.cache
        out = {"k": c.k, "v": c.v}
        if c.quantized:
            out.update(k_scale=c.k_scale, v_scale=c.v_scale)
        return out

    def buffers(self) -> dict[str, torch.Tensor]:
        """Every static buffer by name."""
        return {**self.cache_rows(), "lengths": self.cache.lengths, "tokens": self.tokens,
                "active": self.active, "temps": self.temps, "top_ks": self.top_ks,
                "top_ps": self.top_ps}

    def reset(self) -> None:
        """Back to the state :meth:`create` gives, in place: the graphs keep
        reading these very tensors."""
        for name, t in self.buffers().items():
            t.fill_(1 if name == "top_ps" else 0)


@dataclasses.dataclass
class _Program:
    graph: "torch.cuda.CUDAGraph | None"       # None: runs eagerly (CPU)
    launches: dict[str, int]                    # kernel launches recorded in one run


def _kernel_counts() -> dict[str, int]:
    return {"int8_matmul": int8_matmul.launches - int8_matmul.launches_t,
            "int8_matmul_transposed": int8_matmul.launches_t,
            "int8_matmul_expert": int8_matmul_expert.launches}


class DecodePrograms:
    """The engine's decode programs over one :class:`DecodeState`.

    ``stats``: ``captures`` (programs built: one capture each on CUDA),
    ``capture_s``, ``replays`` and ``steps`` (chunks run and the decode
    steps in them), ``replays_by_key``, and ``launches_by_key`` (each
    program's kernel launches in one run, counted by the kernels' wrappers
    while it was captured)."""

    def __init__(self, forward: Callable, params, cfg, state: DecodeState,
                 generator: torch.Generator):
        self._forward = forward
        self._params = params
        self._cfg = cfg
        self.state = state
        self._gen = generator
        self.device = state.tokens.device
        self._programs: dict[Key, _Program] = {}
        self._outputs: dict[int, torch.Tensor] = {}
        self._pool = torch.cuda.graph_pool_handle() if self.device.type == "cuda" else None
        self.stats = {"captures": 0, "capture_s": 0.0, "replays": 0, "steps": 0,
                      "replays_by_key": {}, "launches_by_key": {}}

    def keys(self) -> list[Key]:
        return sorted(self._programs)

    def output(self, k: int) -> torch.Tensor:
        """The static [B, k] token output of every k-step program."""
        if k not in self._outputs:
            B = self.state.tokens.shape[0]
            self._outputs[k] = torch.zeros((B, k), dtype=torch.int64, device=self.device)
        return self._outputs[k]

    def run_eager(self, key: Key) -> torch.Tensor:
        """The program of ``key``, launched op by op: the body every capture
        records (and the warm-up before it). Returns the static output."""
        k, needs_filter, any_stochastic = key
        st, out = self.state, self.output(k)
        lengths = st.cache.lengths
        for i in range(k):
            # The forward gets a shallow copy of the cache: it writes the
            # new K/V rows in place and returns new lengths, which land in
            # the static buffer below, masked.
            logits, moved = self._forward(self._params, self._cfg, st.tokens[:, None],
                                          lengths[:, None], dataclasses.replace(st.cache))
            nxt = sample_per_slot(logits[:, 0, :], self._gen, st.temps, st.top_ks, st.top_ps,
                                  needs_filter=needs_filter, any_stochastic=any_stochastic)
            lengths.copy_(torch.where(st.active, moved.lengths, lengths))
            st.tokens.copy_(torch.where(st.active, nxt, st.tokens))
            out[:, i].copy_(st.tokens)
        return out

    def run(self, key: Key) -> torch.Tensor:
        """Run the program of ``key`` (built at first use): one graph replay
        on CUDA, the eager body on the CPU. Returns the static [B, k] output."""
        prog = self._programs.get(key) or self.build(key)
        if prog.graph is not None:
            prog.graph.replay()
        else:
            self.run_eager(key)
        s = self.stats
        s["replays"] += 1
        s["steps"] += key[0]
        s["replays_by_key"][str(key)] = s["replays_by_key"].get(str(key), 0) + 1
        return self._outputs[key[0]]

    def build(self, key: Key) -> _Program:
        """Capture the program of ``key`` (CUDA) or register it (CPU); a
        key already built is returned as it is."""
        if key in self._programs:
            return self._programs[key]
        t0 = time.monotonic()
        self.output(key[0])
        if self.device.type == "cuda":
            prog = self._capture(key)
        else:
            prog = _Program(None, {n: 0 for n in _kernel_counts()})
        self._programs[key] = prog
        s = self.stats
        s["captures"] += 1
        s["capture_s"] += time.monotonic() - t0
        s["launches_by_key"][str(key)] = prog.launches
        return prog

    def _capture(self, key: Key) -> _Program:
        cur = torch.cuda.current_stream(self.device)
        snap = self.snapshot(key[0])
        side = torch.cuda.Stream(self.device)
        side.wait_stream(cur)
        mode = torch.cuda.get_sync_debug_mode()
        try:
            with torch.cuda.stream(side):
                torch.cuda.set_sync_debug_mode("error")
                self.run_eager(key)
        except RuntimeError as e:
            raise RuntimeError(f"decode program {key}: its warm-up run failed: {e}") from e
        finally:
            torch.cuda.set_sync_debug_mode(mode)
        cur.wait_stream(side)
        self.restore(snap)
        graph = torch.cuda.CUDAGraph()
        if key[2]:
            graph.register_generator_state(self._gen)
        before = _kernel_counts()
        try:
            with torch.cuda.graph(graph, pool=self._pool):
                self.run_eager(key)
        except RuntimeError as e:
            raise RuntimeError(f"decode program {key} failed to capture: {e}") from e
        after = _kernel_counts()
        return _Program(graph, {n: after[n] - before[n] for n in after})

    def snapshot(self, k: int) -> dict:
        """What a k-step program writes, saved: every slot's cache rows at
        its length and the k - 1 after (clamped as the forward clamps them),
        lengths, tokens, the [B, k] output and the generator state."""
        st = self.state
        c = st.cache
        rows = torch.clamp(c.lengths[:, None] + torch.arange(k, device=self.device),
                           max=c.max_len - 1)
        slots = torch.arange(rows.shape[0], device=self.device)[:, None]
        kv = {n: t[:, slots, rows].clone() for n, t in self.state.cache_rows().items()}
        return {"slots": slots, "rows": rows, "kv": kv, "lengths": c.lengths.clone(),
                "tokens": st.tokens.clone(), "out": self.output(k).clone(),
                "gen": self._gen.get_state()}

    def restore(self, snap: dict) -> None:
        """Put back what :meth:`snapshot` saved, in place."""
        st = self.state
        for n, t in self.state.cache_rows().items():
            t[:, snap["slots"], snap["rows"]] = snap["kv"][n]
        st.cache.lengths.copy_(snap["lengths"])
        st.tokens.copy_(snap["tokens"])
        self.output(snap["out"].shape[1]).copy_(snap["out"])
        self._gen.set_state(snap["gen"])

    def written_rows(self, snap: dict) -> dict[str, torch.Tensor]:
        """The cache rows a snapshot covers, as they are now."""
        return {n: t[:, snap["slots"], snap["rows"]].clone()
                for n, t in self.state.cache_rows().items()}
