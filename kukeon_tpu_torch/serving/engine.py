"""Continuous-batching serving engine, the port of
``kukeon_tpu/serving/engine.py`` (legacy contiguous KV layout).

- **Slot-based decode batch**: a fixed [B_slots] batch over a fixed-shape
  KV cache [L, B, S_max, KV, D], updated in place (the reference donates it
  to its jitted programs instead).
- **Three programs**: :meth:`_prefill` runs a request at a bucketed
  length into a fresh KV block and :meth:`_insert` copies the block into a
  decode slot, both eagerly; :meth:`_decode_chunk` runs K decode steps
  through a decode program (``serving/programs.py``): on CUDA one replay
  of a CUDA graph captured once per (K, sampling branches), on the CPU the
  same program eagerly. It returns one [B, K] token block.
- **Static state**: the decode state (KV cache, lengths, tokens, active
  slots, sampling arrays) is allocated once and only ever written in
  place, since the graphs read those very tensors. :meth:`precompile`
  captures the greedy programs of every chunk size, as the reference's
  compiles them.
- **One blocking fetch per chunk**: the token block is copied to pinned
  host memory without blocking right after the chunk is enqueued, and the
  driver waits on it only after the *next* chunk is enqueued (the
  reference's double buffering). Every blocking device-to-host read goes
  through :meth:`_fetch` and every host-to-device array through
  :meth:`_upload`, both counted in ``sync_stats``.
- **int8 rule**: int8 weights on a CUDA device turn ``cfg.int8_pallas``
  on, so every decode projection and the decode LM head run through the
  hand-written CUDA kernel (ops/int8_matmul.py), and for the MoE family
  every decode expert product through its grouped kernel.
- **Model family**: ``forward_fn`` (default ``llama.forward``) runs the
  model; ``models/moe.py``'s ``forward`` has the same signature and cache
  layout, so the MoE family serves through the same programs.

Python orchestrates: queueing, slot choice, emitting tokens. Not ported
yet (ROADMAP.md): compiled prefill and insert, paged KV and preemption, the
prefix cache, KV export and import, the metrics registry, tracing, timers,
the flight recorder, tuning profiles, async weight load, meshes and
sharding.
"""

from __future__ import annotations

import dataclasses
import queue
import threading
import time
import traceback
from typing import Any, Callable

import numpy as np
import torch

from kukeon_tpu_torch.device import resolve_device
from kukeon_tpu_torch.models import llama
from kukeon_tpu_torch.serving.programs import (
    DecodePrograms,
    DecodeState,
    chunk_sizes,
    program_key,
)
from kukeon_tpu_torch.serving.sampling import (
    SamplingParams,
    branch_flags,
    sample_per_slot,
    slot_sampling_arrays,
)

PREFILL_BUCKETS = (64, 128, 256, 512, 1024, 2048, 4096)


class RejectedError(RuntimeError):
    """Request shed by admission control (queue full, or the cell is not
    admitting). ``retry_after_s`` feeds the HTTP ``Retry-After``."""

    def __init__(self, msg: str, retry_after_s: float = 1.0):
        super().__init__(msg)
        self.retry_after_s = retry_after_s


class DeadlineExceeded(RuntimeError):
    """A request's deadline passed before it finished generating."""


@dataclasses.dataclass
class Request:
    """One generation request, as tracked by the engine."""

    id: int
    prompt: np.ndarray
    sampling: SamplingParams
    # (token, done); a cancelled or failed request's terminal event is (-1, True).
    emit: Callable[[int, bool], None] | None = None
    generated: list[int] = dataclasses.field(default_factory=list)
    error: Exception | None = None
    slot: int = -1
    submitted_at: float = 0.0
    first_token_at: float = 0.0
    last_token_at: float = 0.0
    done: threading.Event = dataclasses.field(default_factory=threading.Event)
    cancelled: bool = False
    deadline: float | None = None     # absolute monotonic time, None = none
    timed_out: bool = False

    def cancel(self) -> None:
        """Ask the engine to stop generating for this request. Only sets a
        flag; the driver releases the slot (or completes the queued
        request) on its next step."""
        self.cancelled = True


@dataclasses.dataclass
class _InflightChunk:
    """An enqueued decode chunk whose token block is not fetched yet."""

    host: torch.Tensor                        # [B, K] host copy in flight
    ready: Any                                # CUDA event, None on the CPU
    k: int
    slots: list[tuple[int, Request]]          # (slot, request) at dispatch


def bucket_length(n: int, buckets: tuple[int, ...] = PREFILL_BUCKETS) -> int:
    for b in buckets:
        if n <= b:
            return b
    last = buckets[-1]
    return ((n + last - 1) // last) * last


class ServingEngine:
    """Slot-based continuous-batching engine over the port's Llama (or
    any model whose forward has ``llama.forward``'s signature).

    Thread model: callers enqueue with :meth:`submit`; one driver (the
    thread of :meth:`start`, or the caller through :meth:`step`) runs
    prefill and decode. ``_lock`` guards the admission state
    (``_pending_n``, ``_next_id``, ``_requests``, ``_running``) and is the
    lock of the ``_work`` condition the idle driver sleeps on.
    """

    def __init__(
        self,
        cfg: llama.LlamaConfig,
        params: llama.Params,
        *,
        num_slots: int = 8,
        max_seq_len: int | None = None,
        eos_ids: tuple[int, ...] = (),
        decode_chunk: int = 16,
        seed: int = 0,
        kv_cache_int8: bool = False,
        prefill_buckets: tuple[int, ...] | None = None,
        max_pending: int | None = None,
        device: str | torch.device | None = None,
        forward_fn: Callable | None = None,
    ):
        self.device = resolve_device(device)
        self._forward = forward_fn or llama.forward
        # int8 weights on a CUDA device always decode through the kernel; a
        # model whose dims it does not take fails at the kernel's shape check.
        if (self.device.type == "cuda" and llama._is_q(params["layers"]["wq"])
                and not cfg.int8_pallas):
            cfg = dataclasses.replace(cfg, int8_pallas=True)
        self.cfg = cfg
        self.params = _to_device(params, self.device)
        self.num_slots = num_slots
        self.max_seq_len = max_seq_len or cfg.max_seq_len
        self.eos_ids = set(eos_ids)
        self.decode_chunk = max(1, decode_chunk)
        self.kv_cache_int8 = bool(kv_cache_int8)
        self.prefill_buckets = (tuple(sorted({int(b) for b in prefill_buckets}))
                                if prefill_buckets else PREFILL_BUCKETS)
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(seed)
        # Transfer-counting seam: every blocking device->host read goes
        # through _fetch and every host->device array through _upload, so
        # tests can hold the decode loop to <= 1 blocking fetch per chunk.
        self.sync_stats = {"fetches": 0, "uploads": 0, "chunks": 0,
                           "fetch_s": 0.0, "upload_s": 0.0}
        # Allocated once: the decode programs read these very tensors.
        self.state = DecodeState.create(cfg, num_slots, self.max_seq_len,
                                        self.kv_cache_int8, self.device)
        self._programs = DecodePrograms(self._forward, self.params, cfg, self.state,
                                        self._gen)

        self._requests: dict[int, Request] = {}
        self._slot_req: list[Request | None] = [None] * num_slots
        self._slot_len: list[int] = [0] * num_slots    # host-side cache lengths
        self._inflight: _InflightChunk | None = None
        # The sampler's branches, from the host copies of the sampling
        # arrays; both re-uploaded only when slot composition changes.
        self._sampling_flags = (False, False)
        self._sampling_dirty = True
        self._pending: queue.Queue[Request] = queue.Queue()
        self._lock = threading.Lock()
        self._work = threading.Condition(self._lock)
        self._next_id = 0        # guarded-by: _lock
        self._pending_n = 0      # guarded-by: _lock
        self._running = False    # guarded-by: _lock
        self._thread: threading.Thread | None = None
        self.error: Exception | None = None
        self.max_pending = max_pending
        self.retry_after_s = 1.0
        self.shed_stats = {"rejected": 0, "timed_out": 0}
        self.tokens_total = 0

    # --- programs ----------------------------------------------------------

    @property
    def program_stats(self) -> dict:
        """The decode programs' counters (``DecodePrograms.stats``) plus
        ``pool_bytes``, the device memory :meth:`precompile` reserved."""
        return self._programs.stats

    def _h2d(self, x: torch.Tensor) -> torch.Tensor:
        """Host tensor -> device without waiting for queued device work
        (pinned staging, non-blocking copy on the current stream)."""
        if self.device.type == "cuda":
            return x.pin_memory().to(self.device, non_blocking=True)
        return x

    def _sample_one(self, logits: torch.Tensor, sp: SamplingParams) -> torch.Tensor:
        """First token of a prefill: [V] logits -> 0-d device tensor."""
        if sp.temperature <= 0:
            return torch.argmax(logits)
        return sample_per_slot(
            logits[None, :], self._gen,
            self._h2d(torch.tensor([sp.temperature], dtype=torch.float32)),
            self._h2d(torch.tensor([sp.top_k], dtype=torch.int64)),
            self._h2d(torch.tensor([sp.top_p], dtype=torch.float32)),
            needs_filter=sp.top_k > 0 or sp.top_p < 1.0,
            any_stochastic=True)[0]

    def _prefill(self, tokens: torch.Tensor, length: int, sp: SamplingParams):
        """tokens [1, S_bucket] -> (first sampled token, kv block k, v
        [L, 1, S_bucket, KV, D]). The LM head runs at the last prompt
        position only."""
        S = tokens.shape[1]
        positions = torch.arange(S, device=self.device)[None, :]
        cache = llama.KVCache.create(self.cfg, 1, S, device=self.device)
        logits, cache = self._forward(
            self.params, self.cfg, tokens, positions, cache,
            logit_positions=torch.full((1,), length - 1, device=self.device))
        return self._sample_one(logits[0, 0], sp), cache.k, cache.v

    def _insert(self, kv_k, kv_v, length: int, slot: int, token) -> None:
        """Copy a prefill's KV block into ``slot`` (in place) and activate
        it. A quantized cache quantizes the block here, once."""
        c = self.state.cache
        S = kv_k.shape[2]
        if c.quantized:
            kv_k, ks = llama.quantize_kv(kv_k)      # [L, 1, S, KV(, D)]
            kv_v, vs = llama.quantize_kv(kv_v)
            c.k_scale[:, slot, :S] = ks[:, 0]
            c.v_scale[:, slot, :S] = vs[:, 0]
        c.k[:, slot, :S] = kv_k[:, 0]
        c.v[:, slot, :S] = kv_v[:, 0]
        c.lengths[slot] = length
        self.state.tokens[slot] = token
        self.state.active[slot] = True

    def _decode_chunk(self, k: int, flags: tuple[bool, bool]) -> torch.Tensor:
        """K decode steps over every slot -> the program's static tokens
        [B, K] on the device. Inactive slots neither advance their length
        nor change token."""
        return self._programs.run(program_key(k, *flags))

    @torch.no_grad()
    def precompile(self, prompt_lens: tuple[int, ...] = (64,)) -> None:
        """Capture the greedy decode program of every chunk size the
        reference compiles (``chunk_sizes``), the counterpart of the
        reference's ``precompile``. Stochastic programs are captured at
        their first use. ``prompt_lens`` names the prefill buckets the
        reference compiles too; the port's prefill and insert stay eager
        (ROADMAP A14b). Call it before :meth:`start`: a capture must not
        meet the driver's launches. A key already built is kept."""
        del prompt_lens
        if self._running:
            raise RuntimeError("precompile() before start(): the driver thread is running")
        cuda = self.device.type == "cuda"
        if cuda:        # each capture empties the cache too: count from an empty one
            torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved(self.device) if cuda else 0
        for k in chunk_sizes(self.decode_chunk):
            self._programs.build(program_key(k, False, False))
        if cuda:
            self._programs.stats["pool_bytes"] = (
                self._programs.stats.get("pool_bytes", 0)
                + torch.cuda.memory_reserved(self.device) - reserved)

    # --- counted transfer seams -------------------------------------------

    def _fetch(self, x: torch.Tensor, ready=None) -> np.ndarray:
        """Blocking device->host read, counted and timed. ``x`` may be a
        host tensor whose copy is in flight behind the CUDA event ``ready``."""
        t0 = time.monotonic()
        if ready is not None:
            ready.synchronize()
        out = x.cpu().numpy()
        self.sync_stats["fetches"] += 1
        self.sync_stats["fetch_s"] += time.monotonic() - t0
        return out

    def _upload(self, x: np.ndarray, into: torch.Tensor | None = None) -> torch.Tensor:
        """Host->device array, counted and timed; ``into``: a static device
        buffer to copy it into (without waiting for queued device work)."""
        t0 = time.monotonic()
        host = torch.from_numpy(np.ascontiguousarray(x))
        if into is None:
            out = self._h2d(host)
        else:
            out = into.copy_(host.pin_memory() if into.is_cuda else host, non_blocking=True)
        self.sync_stats["uploads"] += 1
        self.sync_stats["upload_s"] += time.monotonic() - t0
        return out

    def _bucket(self, n: int) -> int:
        return bucket_length(n, self.prefill_buckets)

    # --- public API --------------------------------------------------------

    def submit(
        self,
        prompt: np.ndarray | list[int],
        sampling: SamplingParams | None = None,
        emit: Callable[[int, bool], None] | None = None,
        deadline_s: float | None = None,
    ) -> Request:
        prompt = np.asarray(prompt, np.int32)
        if prompt.ndim != 1 or prompt.size == 0:
            raise ValueError("prompt must be a non-empty 1-D token array")
        if prompt.size >= self.max_seq_len:
            raise ValueError(
                f"prompt length {prompt.size} >= engine max_seq_len {self.max_seq_len}")
        if prompt.min() < 0 or prompt.max() >= self.cfg.vocab_size:
            # On a GPU an out-of-range id is a device-side assert that
            # poisons the CUDA context; reject it here.
            raise ValueError(f"prompt token ids must lie in [0, {self.cfg.vocab_size})")
        if deadline_s is not None and deadline_s <= 0:
            raise ValueError("deadline_s must be positive")
        now = time.monotonic()
        with self._lock:
            if self.max_pending is not None and self._pending_n >= self.max_pending:
                self.shed_stats["rejected"] += 1
                raise RejectedError(
                    f"pending queue full ({self._pending_n}/{self.max_pending}); "
                    "shedding load", retry_after_s=self.retry_after_s)
            req = Request(id=self._next_id, prompt=prompt,
                          sampling=sampling or SamplingParams(), emit=emit,
                          submitted_at=now,
                          deadline=now + deadline_s if deadline_s is not None else None)
            self._next_id += 1
            self._requests[req.id] = req
            self._pending_n += 1
            self._pending.put(req)
            self._work.notify()
        return req

    @property
    def queue_depth(self) -> int:
        return self._pending_n

    def generate(self, prompt, sampling: SamplingParams | None = None) -> list[int]:
        """Blocking convenience wrapper: submit, then drive (or wait for the
        driver thread) until done."""
        req = self.submit(prompt, sampling)
        if self._running:
            req.done.wait()
        else:
            while not req.done.is_set():
                self.step()
        if req.error is not None:
            raise RuntimeError(f"generation failed: {req.error}") from req.error
        return req.generated

    def warmup(self, prompt_len: int, sampling: SamplingParams | None = None):
        """Run one request through prefill, insert and a decode chunk, so
        first-use costs (kernel library load, cuBLAS handles, allocator
        growth) do not land on live traffic."""
        sp = sampling or SamplingParams()
        req = self.submit(np.ones((max(1, prompt_len),), np.int32),
                          dataclasses.replace(sp, max_new_tokens=2))
        while not req.done.is_set():
            self.step()

    def start(self):
        """Run the engine loop on a background thread."""
        with self._lock:
            self._running = True
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="serving-engine")
        self._thread.start()

    def stop(self):
        with self._lock:
            self._running = False
            self._work.notify_all()
        if self._thread:
            self._thread.join(timeout=30)
            self._thread = None

    @property
    def running(self) -> bool:
        return self._running

    # --- driver ------------------------------------------------------------

    def _idle_locked(self) -> bool:
        return (self._pending_n == 0 and self._inflight is None
                and all(r is None for r in self._slot_req))

    def _loop(self):
        while self._running:
            try:
                if not self.step():
                    with self._work:
                        if self._running and self._idle_locked():
                            self._work.wait(timeout=0.05)
            except Exception as e:  # noqa: BLE001 — the driver thread must not die silently
                traceback.print_exc()
                self.error = e
                self._fail_all(e)
                # The state may be half-written: start it over, in place.
                self.state.reset()
                self._slot_req = [None] * self.num_slots
                self._slot_len = [0] * self.num_slots
                self._inflight = None
                self._sampling_dirty = True

    def _finish(self, req: Request, outcome_error: Exception | None = None) -> None:
        """Terminal event of a request that holds no slot."""
        req.error = req.error or outcome_error
        with self._lock:
            self._requests.pop(req.id, None)
        if req.emit:
            try:
                req.emit(-1, True)
            except Exception:  # noqa: BLE001 — a bad sink must not stop the sweep
                pass
        req.done.set()

    def _fail_all(self, exc: Exception):
        """Fail every active and queued request so no caller hangs."""
        for slot, req in self._active_requests():
            self._slot_req[slot] = None
            self._finish(req, exc)
        while True:
            try:
                req = self._pending.get_nowait()
            except queue.Empty:
                break
            with self._lock:
                self._pending_n -= 1
            self._finish(req, exc)

    def _expired(self, req: Request, now: float) -> bool:
        return req.deadline is not None and now >= req.deadline

    def _timeout_error(self, req: Request, now: float) -> DeadlineExceeded:
        self.shed_stats["timed_out"] += 1
        req.timed_out = True
        return DeadlineExceeded(
            f"request {req.id} deadline exceeded after {now - req.submitted_at:.2f}s "
            f"({len(req.generated)} tokens generated)")

    def _sweep(self) -> bool:
        """Release cancelled or expired active requests and complete queued
        ones now (a queued cancel must not wait for a slot)."""
        did = False
        now = time.monotonic()
        for _slot, req in self._active_requests():
            if req.cancelled:
                self._release_slot(req, terminal=True)
                did = True
            elif self._expired(req, now):
                req.error = self._timeout_error(req, now)
                self._release_slot(req, terminal=True)
                did = True
        kept: list[Request] = []
        while True:
            try:
                req = self._pending.get_nowait()
            except queue.Empty:
                break
            if req.cancelled or self._expired(req, now):
                with self._lock:
                    self._pending_n -= 1
                self._finish(req, None if req.cancelled else self._timeout_error(req, now))
                did = True
            else:
                kept.append(req)
        for req in kept:
            self._pending.put(req)
        return did

    def _free_slots(self) -> list[int]:
        return [i for i, r in enumerate(self._slot_req) if r is None]

    def _active_requests(self) -> list[tuple[int, Request]]:
        return [(i, r) for i, r in enumerate(self._slot_req) if r is not None]

    @torch.no_grad()
    def step(self) -> bool:
        """One scheduler iteration:

          1. prefill + insert for every free slot with a waiting request;
          2. fetch and emit the prefills' first tokens (one stacked fetch);
          3. enqueue the next decode chunk for the active slots;
          4. fetch and emit the PREVIOUS chunk's tokens (double buffering).

        The reference enqueues the chunk before the first-token fetch.
        Here the first tokens are fetched first: the blocking fetch would
        otherwise queue behind the whole chunk on the one stream, and TTFT
        would include it.

        Returns True if any work was done.
        """
        did_work = self._sweep()
        prefills = []
        free = self._free_slots()
        while free:
            try:
                req = self._pending.get_nowait()
            except queue.Empty:
                break
            with self._lock:
                self._pending_n -= 1
            slot = free.pop(0)
            try:
                prefills.append(self._dispatch_prefill(req, slot))
            except Exception as e:
                self._finish(req, e)
                raise
            did_work = True

        if prefills:
            firsts = self._fetch(torch.stack([f for _, f in prefills]))
            for (req, _), first in zip(prefills, firsts):
                self._emit(req, int(first))
        new_inflight = None
        if self._active_requests():
            new_inflight = self._dispatch_decode_chunk()
            did_work = True
        if self._inflight is not None:
            self._flush_inflight()
            did_work = True
        self._inflight = new_inflight
        return did_work

    def _dispatch_prefill(self, req: Request, slot: int):
        n = req.prompt.size
        bucket = min(self._bucket(n), self.max_seq_len)
        tokens = np.zeros((1, bucket), np.int64)
        tokens[0, :n] = req.prompt
        first, kv_k, kv_v = self._prefill(self._upload(tokens), n, req.sampling)
        self._insert(kv_k, kv_v, n, slot, first)
        req.slot = slot
        self._slot_req[slot] = req
        self._slot_len[slot] = n + 1   # prompt + the first generated token's kv-to-be
        self._sampling_dirty = True
        return req, first

    def _chunk_size(self) -> int:
        """Largest safe K: at most decode_chunk, bounded by cache capacity,
        rounded down to a power of 4; 4 at most while a waiting request
        could take a free slot."""
        k = self.decode_chunk
        if not self._pending.empty() and self._free_slots():
            k = min(k, 4)
        inflight_k = self._inflight.k if self._inflight is not None else 0
        for slot, _req in self._active_requests():
            k = min(k, self.max_seq_len - self._slot_len[slot] - inflight_k)
        k = max(1, k)
        size = 1
        while size * 4 <= k:
            size *= 4
        return size

    def _upload_sampling(self) -> None:
        """Copy the slots' sampling arrays into the static buffers, when the
        slot composition changed since the last upload."""
        if self._sampling_dirty:
            temps, top_ks, top_ps = slot_sampling_arrays(
                self._active_requests(), self.num_slots)
            st = self.state
            self._upload(temps, st.temps)
            self._upload(top_ks.astype(np.int64), st.top_ks)
            self._upload(top_ps, st.top_ps)
            self._sampling_flags = branch_flags(temps, top_ks, top_ps)
            self._sampling_dirty = False

    def _dispatch_decode_chunk(self) -> _InflightChunk:
        k = self._chunk_size()
        self._upload_sampling()
        toks = self._decode_chunk(k, self._sampling_flags)
        self.sync_stats["chunks"] += 1
        # Start the device->host copy now, behind the replay on the same
        # stream; the driver waits on it only after the next chunk is
        # enqueued, which overwrites the static output.
        ready = None
        if toks.is_cuda:
            host = torch.empty(toks.shape, dtype=toks.dtype, pin_memory=True)
            host.copy_(toks, non_blocking=True)
            ready = torch.cuda.Event()
            ready.record()
        else:
            host = toks.clone()
        return _InflightChunk(host=host, ready=ready, k=k, slots=self._active_requests())

    def _flush_inflight(self):
        """Fetch and emit the previously enqueued chunk's token block."""
        chunk = self._inflight
        toks = self._fetch(chunk.host, chunk.ready)   # [B, K]: one fetch per chunk
        for slot, req in chunk.slots:
            if req.done.is_set():
                continue   # finished meanwhile (overshoot chunk): discard
            base = self._slot_len[slot]
            for t in range(chunk.k):
                self._slot_len[slot] = base + t + 1
                self._emit(req, int(toks[slot, t]))
                if req.done.is_set():
                    break

    def _emit(self, req: Request, token: int):
        now = time.monotonic()
        if not req.generated:
            req.first_token_at = now
        req.last_token_at = now
        self.tokens_total += 1
        req.generated.append(token)
        finished = (token in self.eos_ids
                    or token in req.sampling.stop_tokens
                    or len(req.generated) >= req.sampling.max_new_tokens
                    or self._slot_len[req.slot] >= self.max_seq_len)
        if req.emit:
            req.emit(token, finished)
        if finished:
            self._release_slot(req)

    def _release_slot(self, req: Request, terminal: bool = False):
        """Free the request's slot. ``terminal``: the request ends without a
        token of its own (cancel, deadline), so stream consumers get the
        (-1, True) sentinel."""
        self._slot_req[req.slot] = None
        self._sampling_dirty = True
        self.state.active[req.slot] = False
        with self._lock:
            self._requests.pop(req.id, None)
        if terminal and req.emit:
            req.emit(-1, True)
        req.done.set()


def _to_device(tree, device: torch.device):
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    return tree.to(device)
