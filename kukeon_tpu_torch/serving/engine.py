"""Continuous-batching serving engine, the port of
``kukeon_tpu/serving/engine.py`` (legacy contiguous KV layout).

- **Slot-based decode batch**: a fixed [B_slots] batch over a fixed-shape
  KV cache [L, B, S_max, KV, D], updated in place (the reference donates it
  to its jitted programs instead).
- **Programs** (``serving/programs.py``): on CUDA each is one replay of a
  CUDA graph captured once per key, on the CPU the same body eagerly.
  :meth:`_dispatch_prefill` runs a request's prefill at a bucketed length
  (or, on a prefix-cache hit, ``prefill_ext`` over the prompt's new tail
  against the stored prefix block) with the first token's sample and the
  insert into its decode slot, one program; :meth:`_decode_chunk` runs K
  decode steps and returns one [B, K] token block.
- **Static state**: the decode state (KV cache, lengths, tokens, active
  slots, sampling arrays) and the prefill programs' packed inputs and KV
  block are allocated once and only ever written in place, since the
  graphs read those very tensors. :meth:`precompile` captures the greedy
  decode programs of every chunk size and the greedy prefill of every
  bucket it is given, as the reference's compiles them; any other key is
  captured at its first use.
- **Prefix cache** (contiguous layout): a request with a ``prefix_id``
  whose stored prompt is a strict prefix of its own prefills only the
  new tail; the prompt's full-precision KV block is stored under the id
  either way (LRU, bounded by ``prefix_cache_size`` entries and
  ``prefix_cache_bytes``), as the reference's ``_prefix_lookup``/
  ``_prefix_store``.
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

- **Paged KV** (``kv_page_tokens > 0``, the reference's paged engine):
  the cache is a pool of fixed-size pages (``serving/kv_pages.py`` keeps
  the books) and a static block table maps each slot's rows to pages; a
  request holds only the pages its rows need, so the pool can be smaller
  than ``num_slots * max_seq_len``. Under pressure the engine flushes the
  chunk in flight, evicts prefix entries, preempts the latest-submitted
  request (it re-prefills ``prompt + generated`` when resumed, ahead of
  new admissions) and at last finishes a lone request at its current
  length; a request no page can be found for on an idle engine is shed
  (429). Prefix entries are shared refcounted pages, not copies.
- **KV handoff** (disaggregated serving, the reference's
  ``_dispatch_prefill_export``/``_finish_export``/``_dispatch_import``):
  ``submit(export=True)`` runs the prefill alone, seats no slot and takes
  no page, and hands the first token and the prompt's KV rows back on
  ``export_payload`` (fetched through :meth:`_fetch`);
  ``submit(kv_import=...)`` seats such a block into a decode slot through
  an insert-only program, on either layout, and emits its first token
  without a prefill. A preempted import re-prefills like any request.

- **Observability** (``obs/``, the reference's instruments by name, type
  and labels): the engine's families on its registry (``registry=``, the
  cell passes its own so one ``/metrics`` holds both), a trace span per
  request (``submit(trace_ctx=)`` joins a caller's trace) stamped at the
  reference's sites, TTFT and e2e exemplars, the program timers (marked
  at every run in ``serving/programs.py``, settled only in :meth:`_fetch`
  after its readback, so no new host sync), the compile tracker, device
  memory from the caching allocator's counters, one flight-recorder
  record a step that did work, and the progress heartbeat
  (``last_progress``, :meth:`stalled_s`) the cell's watchdog reads.

- **Streamed boot** (the reference's ``CheckpointStream`` constructor and
  its async load): ``params`` may be a
  :class:`~kukeon_tpu_torch.models.checkpoints.CheckpointStream`. Every
  leaf of its abstract tree is allocated on the device first, zero-filled,
  so the programs can be captured (and their warm-up runs compute on
  finite values) before a byte of weight arrived: a graph bakes in its
  buffers' addresses, so the leaves are never replaced, only written in
  place. A load thread then drains the stream through
  the counted :meth:`_upload` seam on a CUDA stream of its own, from a
  ring of pinned buffers made before any capture, and makes no
  synchronizing call (it polls its events); the captures run under
  ``capture_error_mode="thread_local"`` (``serving/programs.py``), so a
  CUDA call of the load thread cannot void a capture on the engine's
  thread. :meth:`warmup` and :meth:`step` wait for the load thread, and
  once for the load stream, before anything reads a weight
  (:meth:`_ensure_loaded`). ``load_stats`` and ``boot_marks`` keep the
  boot's accounting apart from ``sync_stats``.
- **Tuning profile** (``serving/tuning.py``): with ``model_name``, a lever
  left ``None`` (``decode_chunk``, ``kv_cache_int8``, ``prefill_buckets``,
  ``kv_page_tokens``) takes the profile stored under ``model|gpu|N`` (or
  ``|cpu|N``; N the mesh's size, 1 on one device), then the default;
  ``kv_page_tokens`` 0 forces the legacy layout. The profile's
  ``mesh_tensor`` is not read (nor is it by the reference's engine).

- **Tensor parallelism** (``mesh=``, a ``parallel.mesh.Mesh`` over a rank
  group, ``parallel/launch.py``; the reference's ``mesh``): the weights
  come as a ``parallel.sharding.Recipe``, which every rank runs, keeping
  its slice of each leaf as it comes (``local_params``), so no rank holds
  the whole model and none is sent a tensor. Every rank holds its shard
  of the weights (``parallel/sharding.py``) and of the KV
  cache (its kv heads; all of them, replicated, when ``kv_shard`` is False
  or the kv heads do not divide the world: the reference's
  ``_cache_shardings`` rule), and its programs run the forward with the
  collectives inside (``models/llama.py``, or ``models/moe.py`` with
  ``forward_fn=moe.forward``: the reference's ``moe_specs_for_params``
  layout, each rank's expert slices through the grouped kernel),
  captured in the graphs. Rank
  0, the leader, is this class as a caller uses it: it keeps every piece
  of host state (queue, slots, page allocator, prefix index, sampling
  flags) and makes every decision. Each device action it takes (an
  upload, a program build or run, a prefix block stored, loaded or
  dropped, a slot deactivated, an export's gather, an import's rows) goes
  through :meth:`_dev`, which posts one descriptor to the followers and
  runs it here; the descriptors of a chunk go out as one message with its
  program run. A follower is this class built by :func:`follower_engine`
  on its rank, and :meth:`follow` applies the descriptors in order. Every
  rank samples the same gathered logits with the same generator state,
  so the tokens agree without a broadcast, and only the leader reads
  them back: the host-sync budget holds per rank. The tuning profile is
  the one stored under ``model|backend|world``, ``world`` the mesh's size.
  On a mesh of ``data`` x ``tensor`` ranks (``parallel/mesh.py``) the
  weights and the cache are cut over ``tensor`` alone: each data replica
  holds the whole model, the leader posts every rank the same descriptors,
  and every replica computes the same step (the reference replicates its
  weights and its cache over ``data``). A ``"stream"`` recipe
  boots each rank streamed (``sharding.open_stream``: its blocks read from
  the checkpoint by its stream's threads into its zero-filled local tree
  while it captures, as on one device); the leader's first
  :meth:`_ensure_loaded` waits for every follower's ``loaded``
  acknowledgement over the control channel, so a cell turns ready only
  once all have loaded, and a follower whose load failed ends the group,
  named. The followers get their recipe before the
  leader reads its own weights, so the ranks read at once.

Python orchestrates: queueing, slot choice, emitting tokens.
"""

from __future__ import annotations

import dataclasses
import functools
import queue
import weakref
from collections import OrderedDict, deque
from collections.abc import Mapping
import threading
import time
import traceback
from typing import Any, Callable

import numpy as np
import torch

from kukeon_tpu_torch import faults
from kukeon_tpu_torch.device import resolve_device
from kukeon_tpu_torch.models import llama
from kukeon_tpu_torch.models.checkpoints import CheckpointStreamError, _walk_tree
from kukeon_tpu_torch.parallel import launch
from kukeon_tpu_torch.parallel.sharding import (
    Recipe,
    check_tensor_parallel,
    kv_sharded,
    local_params,
    open_stream,
)
from kukeon_tpu_torch.obs import profile as obs_profile
from kukeon_tpu_torch.obs import (
    CompileTracker,
    FlightRecorder,
    ProgramTimers,
    Registry,
    Tracer,
    device_memory_collector,
    device_peaks,
    faults_collector,
    program_cost,
)
from kukeon_tpu_torch.serving.kv_pages import (
    SCRATCH_PAGE,
    PageAllocator,
    PagePoolExhausted,
    SharedPrefix,
)
from kukeon_tpu_torch.serving.programs import (
    DecodePrograms,
    DecodeState,
    PrefillPrograms,
    chunk_sizes,
    insert_key,
    pack_prefill_inputs,
    prefill_key,
    program_key,
    program_labels,
)
from kukeon_tpu_torch.serving import tuning
from kukeon_tpu_torch.serving.sampling import (
    SamplingParams,
    branch_flags,
    slot_sampling_arrays,
)

PREFILL_BUCKETS = (64, 128, 256, 512, 1024, 2048, 4096)


class _CounterMapView(Mapping):
    """Read-only dict view over a labelled registry counter (the
    reference's ``shed_stats``): every reader of the dict keeps working
    while the registry is the one source of truth ``/metrics`` scrapes."""

    def __init__(self, counter, label: str, keys: tuple[str, ...]):
        self._counter = counter
        self._label = label
        self._keys = keys

    def __getitem__(self, key: str) -> int:
        if key not in self._keys:
            raise KeyError(key)
        return int(self._counter.value(**{self._label: key}))

    def __iter__(self):
        return iter(self._keys)

    def __len__(self) -> int:
        return len(self._keys)


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
    # The request's trace span (obs/trace.py): the driver stamps lifecycle
    # events on it; /v1/trace exports it.
    trace: Any = None
    done: threading.Event = dataclasses.field(default_factory=threading.Event)
    cancelled: bool = False
    deadline: float | None = None     # absolute monotonic time, None = none
    timed_out: bool = False
    # Prefix caching: requests with the same prefix_id reuse the stored KV
    # of the longest earlier prompt that is a strict prefix of theirs.
    prefix_id: str | None = None
    # Paged KV: times this request lost its slot and pages to pressure; a
    # preempted request waits in the resume queue and re-prefills
    # prompt + generated when it is seated again.
    preemptions: int = 0
    # KV handoff. ``export``: run the prefill only, seat no slot and take no
    # page; the first token and the prompt's KV rows come back on
    # ``export_payload`` ({"token", "length", "k", "v", "pageTokens"}, k
    # and v host tensors [L, 1, length, KV, D]). ``kv_import``: {"token",
    # "length", "k", "v"} from an export; the request is seated with that
    # block and token, without a prefill (a preempted one re-prefills
    # prompt + generated like any other).
    export: bool = False
    export_payload: dict | None = None
    kv_import: dict | None = None

    def cancel(self) -> None:
        """Ask the engine to stop generating for this request. Only sets a
        flag; the driver releases the slot (or completes the queued
        request) on its next step."""
        self.cancelled = True


@dataclasses.dataclass
class _CachedPrefix:
    """Stored prompt KV for one prefix_id (device tensors of their own)."""

    tokens: np.ndarray               # the exact prompt this KV encodes (int32)
    kv_k: torch.Tensor               # [L, 1, Pb, KV, D], Pb a canonical bucket
    kv_v: torch.Tensor
    length: int                      # valid positions in the block

    @property
    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size() for t in (self.kv_k, self.kv_v))


@dataclasses.dataclass
class _Export:
    """A dispatched export whose first token and KV rows are in flight to
    host memory (copies started right after its program)."""

    req: Request
    first: torch.Tensor                       # [1] int64, host
    k: torch.Tensor                           # [L, 1, n, KV, D], host
    v: torch.Tensor
    ready: Any                                # CUDA event, None on the CPU
    length: int


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
    (``_pending_n``, ``_next_id``, ``_requests``, ``_running``,
    ``last_progress``) and is the lock of the ``_work`` condition the idle
    driver sleeps on. Scrapes read the instruments from other threads. A
    streamed boot adds the load thread, which writes
    only the weight leaves (in place), ``load_stats`` and ``boot_marks``.
    """

    def __init__(
        self,
        cfg: llama.LlamaConfig,
        params: llama.Params,
        *,
        num_slots: int = 8,
        max_seq_len: int | None = None,
        eos_ids: tuple[int, ...] = (),
        decode_chunk: int | None = None,
        seed: int = 0,
        kv_cache_int8: bool | None = None,
        prefill_buckets: tuple[int, ...] | None = None,
        max_pending: int | None = None,
        device: str | torch.device | None = None,
        forward_fn: Callable | None = None,
        prefix_cache_size: int = 8,
        prefix_cache_bytes: int = 2 << 30,
        kv_page_tokens: int | None = None,
        kv_pool_pages: int | None = None,
        registry: Registry | None = None,
        model_name: str | None = None,
        mesh=None,
        kv_shard: bool | None = None,
    ):
        # Tensor parallelism: this rank's device, and the forward with the
        # mesh's collectives. ``world`` is the mesh's size (data x tensor:
        # the tune key, the gauge, the stats), ``tensor`` what the weights
        # and the cache are cut over.
        self.mesh = mesh
        self.world = mesh.size if mesh is not None else 1
        self.tensor = mesh.world if mesh is not None else 1
        self.device = mesh.device if mesh is not None else resolve_device(device)
        forward_fn = forward_fn or llama.forward
        self._forward = (functools.partial(forward_fn, mesh=mesh) if mesh is not None
                         else forward_fn)
        t_init = time.monotonic()
        # A streamed boot (duck-typed on .abstract_params, as the
        # reference's): the constructor sees only the abstract tree.
        self._ckpt_stream = params if hasattr(params, "abstract_params") else None
        if mesh is not None and not isinstance(params, Recipe):
            raise TypeError(
                "on a mesh the weights come as a parallel.sharding.Recipe, which every "
                "rank runs (a streamed boot there: a Recipe whose reads are 'stream')")
        # The tuning profile (the reference's :310-335): levers the caller
        # left None take the stored winner for this model on this backend,
        # then the defaults; a missing or stale profile is a miss. Keyed by
        # the mesh's size, as the reference keys ``mesh.size``; its
        # ``mesh_tensor`` is a record of the tuned layout, which the
        # reference's engine never reads, and neither does this one.
        self.tune: tuning.ServingTune | None = None
        if model_name and None in (decode_chunk, kv_cache_int8, prefill_buckets,
                                   kv_page_tokens, kv_shard):
            self.tune = tuning.load(model_name, tuning.backend_name(self.device), self.world)
        if self.tune is not None:
            if decode_chunk is None:
                decode_chunk = self.tune.decode_chunk
            if kv_cache_int8 is None:
                kv_cache_int8 = self.tune.kv_cache_int8
            if prefill_buckets is None:
                prefill_buckets = self.tune.prefill_buckets
            # None: the profile decides; 0 forces the legacy layout.
            if kv_page_tokens is None:
                kv_page_tokens = self.tune.kv_page_tokens
            # None: the profile, then the reference's divisibility rule.
            if kv_shard is None:
                kv_shard = self.tune.kv_shard
        decode_chunk = 16 if decode_chunk is None else decode_chunk
        self.kv_sharded = (check_tensor_parallel(cfg, self.tensor, kv_shard) if mesh is not None
                           else kv_sharded(cfg.num_kv_heads, 1, kv_shard))
        recipe = params if mesh is not None else None
        # The kv heads this rank's cache holds.
        self.kv_heads = (cfg.num_kv_heads // self.tensor if self.kv_sharded
                         else cfg.num_kv_heads)
        self.num_slots = num_slots
        self.max_seq_len = max_seq_len or cfg.max_seq_len
        self.eos_ids = set(eos_ids)
        self.decode_chunk = max(1, decode_chunk)
        self.kv_cache_int8 = bool(kv_cache_int8)
        self.prefill_buckets = (tuple(sorted({int(b) for b in prefill_buckets}))
                                if prefill_buckets else PREFILL_BUCKETS)
        # Paged KV (serving/kv_pages.py): pages of ``kv_page_tokens`` rows
        # replace the slot-contiguous reservation. The page size must tile
        # max_seq_len and every bucket below it, or an insert would split
        # a page between slots.
        self.page_tokens = int(kv_page_tokens or 0)
        self.paged = self.page_tokens > 0
        self._pool: PageAllocator | None = None
        self.max_pages_per_slot = self.kv_pool_pages = 0
        if self.paged:
            pt = self.page_tokens
            if self.max_seq_len % pt:
                raise ValueError(f"kv_page_tokens {pt} must divide max_seq_len "
                                 f"{self.max_seq_len}")
            bad = [b for b in self.prefill_buckets if b < self.max_seq_len and b % pt]
            if bad:
                raise ValueError(f"kv_page_tokens {pt} must divide every prefill bucket "
                                 f"below max_seq_len; offending buckets: {bad}")
            self.max_pages_per_slot = self.max_seq_len // pt
            self.kv_pool_pages = int(kv_pool_pages or num_slots * self.max_pages_per_slot)
            self._pool = PageAllocator(self.kv_pool_pages, pt)
            # One page's bytes (K + V, and the scales of an int8 pool): what
            # a prefix entry pins against prefix_cache_bytes.
            row = cfg.num_layers * self.kv_heads * cfg.head_dim
            itemsize = 1 if self.kv_cache_int8 else torch.finfo(cfg.dtype).bits // 8
            self._page_bytes = 2 * pt * row * itemsize
            if self.kv_cache_int8:
                self._page_bytes += 2 * pt * cfg.num_layers * self.kv_heads * 4
        # The leader's followers build their engines now, from the same
        # recipe with the levers resolved here (each applies the int8
        # kernel rule to its own weights), before this rank reads its own,
        # so every rank reads at once; they drop theirs when this one goes.
        self._group = mesh.group if mesh is not None and mesh.leader and mesh.size > 1 else None
        if self._group is not None:
            self._oid = self._group.new_id()
            followers = dict(
                num_slots=num_slots, max_seq_len=self.max_seq_len, decode_chunk=self.decode_chunk,
                seed=seed, kv_cache_int8=self.kv_cache_int8, prefill_buckets=self.prefill_buckets,
                prefix_cache_size=prefix_cache_size, prefix_cache_bytes=prefix_cache_bytes,
                kv_page_tokens=self.page_tokens, kv_pool_pages=self.kv_pool_pages,
                kv_shard=self.kv_sharded, forward_fn=forward_fn)
            self._group.post(self._oid, "new", (
                "kukeon_tpu_torch.serving.engine:follower_engine",
                {"cfg": cfg, "recipe": recipe, "kwargs": followers}), flush=True)
            weakref.finalize(self, self._group.drop, self._oid)
        if mesh is not None and recipe.reads == "stream":
            # A streamed boot on a mesh: this rank's blocks, read by its
            # stream's threads while its programs capture.
            self._ckpt_stream = open_stream(recipe, cfg, mesh, self.kv_sharded)
        elif mesh is not None:
            params = local_params(recipe, cfg, mesh, self.kv_sharded)
        ptree = self._ckpt_stream.abstract_params if self._ckpt_stream is not None else params
        int8_weights = llama._is_q(ptree["layers"]["wq"])
        # int8 weights on a CUDA device always decode through the kernel; a
        # model whose dims it does not take fails at the kernel's shape check.
        if self.device.type == "cuda" and int8_weights and not cfg.int8_pallas:
            cfg = dataclasses.replace(cfg, int8_pallas=True)
        self.cfg = cfg
        # Streamed-boot accounting, apart from sync_stats (the serving
        # path's host-sync budget): kukeon_checkpoint_load_* read it, and
        # boot_marks the monotonic times of the load's first and last leaf,
        # its end, and the programs' captures.
        self.load_stats = {"upload_s": 0.0, "bytes": 0, "tensors": 0}
        self.boot_marks: dict[str, float] = {"init": t_init}
        self._load_exc: Exception | None = None
        self._loaded = threading.Event()
        self._load_waited = False
        self._stager: _Stager | None = None
        self._load_stream = None
        if self._ckpt_stream is not None:
            # Allocated before any capture, zero-filled: the graphs bake in
            # these addresses, and their warm-up runs read finite values.
            self.params = _zeros(ptree, self.device)
            self._stager = _Stager(self.device)
            self._load_stream = self._stager.stream
        else:
            self.params = _to_device(params, self.device)
            self._loaded.set()
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(seed)
        # Transfer-counting seam: every blocking device->host read goes
        # through _fetch and every host->device array through _upload, so
        # tests can hold the decode loop to <= 1 blocking fetch per chunk.
        self.sync_stats = {"fetches": 0, "uploads": 0, "chunks": 0,
                           "fetch_s": 0.0, "upload_s": 0.0}
        self._init_obs(registry, max_pending, int8_weights=int8_weights)
        # Allocated once: the decode programs read these very tensors.
        self.state = DecodeState.create(cfg, num_slots, self.max_seq_len,
                                        self.kv_cache_int8, self.device,
                                        self.page_tokens, self.kv_pool_pages,
                                        kv_heads=self.kv_heads)
        instruments = {"timers": self.timers, "compiles": self.compiles,
                       "cost": self._program_cost}
        self._programs = DecodePrograms(self._forward, self.params, cfg, self.state,
                                        self._gen, **instruments)
        self._prefill_programs = PrefillPrograms(
            self._forward, self.params, cfg, self.state, self._gen,
            functools.partial(bucket_length, buckets=self.prefill_buckets),
            pool=self._programs.pool, capture_lock=self._programs.capture_lock,
            **instruments)
        self.program_stats = self._programs.stats
        self.program_stats["prefill"] = self._prefill_programs.stats
        self.program_stats["view_bytes"] = self.state.view_bytes()
        # Prefix cache: prefix_id -> stored prompt KV (LRU, the loop's thread
        # only); a follower keeps only the device blocks, by prefix_id.
        self._prefix_cache: OrderedDict[str, _CachedPrefix] = OrderedDict()
        self._prefix_blocks: dict[str, tuple[torch.Tensor, torch.Tensor]] = {}
        self._follower = mesh is not None and not mesh.leader
        self._prefix_cache_size = max(0, prefix_cache_size)
        self._prefix_cache_bytes = max(0, prefix_cache_bytes)
        self.prefix_hits = 0
        self.prefix_misses = 0

        self._requests: dict[int, Request] = {}
        self._slot_req: list[Request | None] = [None] * num_slots
        self._slot_len: list[int] = [0] * num_slots    # host-side cache lengths
        self._inflight: _InflightChunk | None = None
        # The sampler's branches, from the host copies of the sampling
        # arrays; both re-uploaded only when slot composition changes.
        self._sampling_flags = (False, False)
        self._sampling_dirty = True
        # Paged block table: host truth [B, max_pages] (released slots
        # zeroed, so their stray writes land in scratch), uploaded into
        # ``state.bt`` only when a slot's pages changed.
        self._bt = np.zeros((num_slots, self.max_pages_per_slot), np.int64)
        self._bt_dirty = True
        self._slot_pages: list[list[int]] = [[] for _ in range(num_slots)]
        # Device length each slot's dispatched work will have reached: what
        # page growth is planned against.
        self._slot_disp: list[int] = [0] * num_slots
        # Preempted requests, seated again before anything pending.
        self._resume: deque[Request] = deque()
        self._pending: queue.Queue[Request] = queue.Queue()
        self._lock = threading.Lock()
        self._work = threading.Condition(self._lock)
        self._next_id = 0        # guarded-by: _lock
        self._pending_n = 0      # guarded-by: _lock
        self._running = False    # guarded-by: _lock
        self._thread: threading.Thread | None = None
        # Calls other threads hand the engine's thread (on_engine_thread), run
        # between its steps.
        self._calls: list[_ThreadCall] = []      # guarded-by: _lock
        self.error: Exception | None = None
        self.max_pending = max_pending
        self.retry_after_s = 1.0
        # Progress heartbeat for the watchdog: bumped on submit and at the
        # end of every step() that did work. A hung CUDA context blocks the
        # driver inside a device call, so it goes stale while work is
        # queued: what stalled_s() reports.
        self.last_progress = time.monotonic()   # guarded-by: _lock
        self.boot_marks["init_done"] = time.monotonic()
        if not self._loaded.is_set():
            # Started last: everything the load thread writes exists by now.
            threading.Thread(target=self._load_weights, daemon=True,
                             name="engine-weight-load").start()

    # --- device actions (the leader's, mirrored on its followers) ----------

    def _dev(self, action: str, *args, flush: bool = False):
        """One device action: posted to the followers (``flush``: sent now
        with every descriptor queued before it; an action that meets a
        collective flushes), then run here. :class:`launch.PerRank`
        arguments go to each rank as its own item. A flushed action that
        raises here ends the group (:meth:`launch.Group.abort`)."""
        if self._group is not None:
            self._group.post(self._oid, action, args, flush=flush)
        rank = self.mesh.rank if self.mesh is not None else 0
        try:
            return getattr(self, "_act_" + action)(
                *(a.items[rank] if isinstance(a, launch.PerRank) else a for a in args))
        except BaseException as e:
            if self._group is not None and flush:
                # Sent: the followers may wait in its collective, which
                # this rank will not enter. End the group now.
                self._group.abort(f"rank 0 failed in {action}: {type(e).__name__}: {e}")
            raise

    def follow(self, action: str, args: tuple) -> None:
        """A follower applies one of its leader's descriptors (a program
        run only once its own weights are loaded)."""
        if action == "run":
            self._ensure_loaded()
        getattr(self, "_act_" + action)(*args)

    def close(self) -> None:
        """Stop the driver; on a leader, drop the followers' engines now
        (they are dropped when this object is collected otherwise)."""
        self.stop()
        if self._group is not None:
            self._group.drop(self._oid)
            self._group.flush()
            self._group = None

    def _programs_of(self, kind: str):
        return self._programs if kind == "decode" else self._prefill_programs

    def _act_stage(self, packed: np.ndarray) -> None:
        self._upload(packed, self._prefill_programs.inputs[:packed.size])

    def _act_loaded(self, oid: int) -> None:
        """A follower's load done: it waits for its own load (one whose load
        failed raises here, which ends the group naming it), then
        acknowledges ``oid``'s ``loaded`` over the control channel (no
        collective: a rank that failed never enters one)."""
        self._ensure_loaded()
        self.mesh.group.report("ack", (oid, "loaded"))

    def _act_build(self, kind: str, key) -> None:
        self._programs_of(kind).build(key)

    def _act_run(self, kind: str, key):
        return self._programs_of(kind).run(key)

    def _act_sampling(self, temps, top_ks, top_ps) -> None:
        st = self.state
        self._upload(temps, st.temps)
        self._upload(top_ks, st.top_ks)
        self._upload(top_ps, st.top_ps)

    def _act_bt(self, bt: np.ndarray) -> None:
        self._upload(bt, self.state.bt)

    def _act_deactivate(self, slot: int) -> None:
        self.state.active[slot] = False

    def _act_reset(self) -> None:
        self.state.reset()
        self._prefill_programs.reset()

    def _act_prefix_put(self, prefix_id: str, key) -> tuple[torch.Tensor, torch.Tensor]:
        kv_k, kv_v = self._prefill_programs.block(key)
        blocks = (kv_k.clone(), kv_v.clone())
        if self._follower:
            self._prefix_blocks[prefix_id] = blocks
        return blocks

    def _act_prefix_drop(self, prefix_id: str) -> None:
        self._prefix_blocks.pop(prefix_id, None)

    def _act_prefix_load(self, prefix_id: str) -> None:
        if self._follower:
            self._prefill_programs.load_prefix(*self._prefix_blocks[prefix_id])
        else:
            e = self._prefix_cache[prefix_id]
            self._prefill_programs.load_prefix(e.kv_k, e.kv_v)

    def _act_export_rows(self, n: int) -> tuple[torch.Tensor, torch.Tensor]:
        """The block's first ``n`` rows; on a mesh with a sharded cache,
        every rank's kv heads gathered, so the leader holds the block the
        one-device engine would."""
        progs = self._prefill_programs
        rows = progs.block_k[:, :, :n], progs.block_v[:, :, :n]
        if self.mesh is not None and self.kv_sharded:
            rows = tuple(self.mesh.all_gather(t, 3) for t in rows)
        return rows

    def _act_profile(self, plan: list, kwargs: dict) -> dict:
        """The per-layer profile on this rank's weights (``obs/profile.py
        profile_layers``), every rank running each component and its
        collectives in the leader's order; ``plan`` the leader's
        ``profile.layers`` fault draws (the followers arm no fault)."""
        return obs_profile.profile_layers(
            self.params, self.cfg, self.device, mesh=self.mesh, plan=plan,
            guard=self._programs.capture_lock, **kwargs)

    def profile_layers(self, **kwargs) -> dict:
        """The live model's per-layer profile (``obs/profile.py``
        ``profile_layers``'s keywords), run on the engine's thread between two steps
        (:meth:`on_engine_thread`) and, on a mesh, by every rank (:meth:`_dev`):
        the leader's result, its timings the leader's."""
        plan = obs_profile.fault_plan(self.cfg.num_layers)

        def run():
            self._ensure_loaded()
            return self._dev("profile", plan, kwargs, flush=True)

        return self.on_engine_thread(run)

    def _act_import_rows(self, k: torch.Tensor, v: torch.Tensor, bucket: int) -> None:
        """An import's rows (this rank's kv heads, ``rows`` of them) into
        the block, zero-padded to ``bucket``."""
        progs = self._prefill_programs
        rows = k.shape[2]
        for x, block in ((k, progs.block_k), (v, progs.block_v)):
            self._upload(x.to(self.cfg.dtype), block[:, :, :rows])
            block[:, :, rows:bucket].zero_()

    # --- streamed boot ------------------------------------------------------

    def _load_weights(self) -> None:
        """The load thread: drain the stream into the device leaves; a
        failure is kept for :meth:`_ensure_loaded` to raise."""
        try:
            self._consume_stream(self._ckpt_stream)
        except Exception as e:  # noqa: BLE001 — surfaced by _ensure_loaded
            self._load_exc = e
        finally:
            self._loaded.set()

    def _consume_stream(self, stream) -> None:
        """The reference's ``_consume_stream`` (``:1121-1144``): each leaf
        through the counted :meth:`_upload` seam into its device tensor the
        moment it arrives off the stream, so the readers' next tensors
        overlap this one's copy. A leaf that does not fit the abstract tree,
        or a tree left short, raises :class:`CheckpointStreamError`: a half
        boot never serves."""
        dst = dict(_walk_tree(self.params))
        seen: set[tuple[str, ...]] = set()
        marks = self.boot_marks
        marks["load_start"] = time.monotonic()
        try:
            for path, t in stream:
                now = time.monotonic()
                marks.setdefault("first_leaf", now)
                marks["last_leaf"] = now
                into = dst.get(path)
                if (into is None or path in seen or t.dtype != into.dtype
                        or tuple(t.shape) != tuple(into.shape)):
                    raise CheckpointStreamError(
                        f"stream leaf {'.'.join(path)} ({t.dtype} {tuple(t.shape)}) does not "
                        f"fit the abstract tree")
                self._upload(t, into, stager=self._stager)
                seen.add(path)
            self._stager.drain()
        finally:
            stream.close()
        if len(seen) != len(dst):
            raise CheckpointStreamError(
                f"stream ended with {len(seen)} of {len(dst)} leaves; missing "
                f"{sorted('.'.join(p) for p in set(dst) - seen)[:5]}")
        marks["load_done"] = time.monotonic()
        self._stager = None            # the pinned ring goes back

    def _ensure_loaded(self) -> None:
        """Block until the weights are on the device (the reference's
        ``_ensure_loaded``, ``:1215-1220``) and raise if their load failed;
        then, once, make the engine's stream wait for the load stream's
        last copy, so no replay or eager forward reads a weight early. A
        streamed mesh leader also waits for every follower's ``loaded``
        acknowledgement (:meth:`_act_loaded`, ``launch.Group.wait_acks``):
        a follower's failed load raises ``launch.RankFailure`` naming it."""
        if self._load_waited:
            return
        self._loaded.wait()
        if self._load_exc is not None:
            where = f"rank {self.mesh.group.rank}: " if self.mesh is not None else ""
            raise RuntimeError(f"{where}engine weight load failed: "
                               f"{type(self._load_exc).__name__}: {self._load_exc}"
                               ) from self._load_exc
        if self._load_stream is not None:
            done = torch.cuda.Event()
            done.record(self._load_stream)
            torch.cuda.current_stream(self.device).wait_event(done)
        if self._group is not None and self._ckpt_stream is not None:
            # A streamed mesh boot is done when every rank's is: the leader
            # turns ready only once each follower acknowledged its load,
            # and a follower whose load failed ends the group, named.
            self._group.post(self._oid, "loaded", (self._oid,), flush=True)
            self._group.wait_acks((self._oid, "loaded"))
        self._load_waited = True

    # --- observability (obs/) ---------------------------------------------

    def _init_obs(self, registry: Registry | None, max_pending: int | None,
                  int8_weights: bool) -> None:
        """The reference's engine instruments (``kukeon_tpu/serving/
        engine.py:550-645``), by name, type and labels. The registry is the
        engine's own unless the cell passes one; gauges are scrape-time
        callables over the driver's state."""
        self.registry = reg = registry or Registry()
        self.tracer = Tracer()
        self._m_queue_wait = reg.histogram(
            "kukeon_engine_queue_wait_seconds",
            "Submit -> dequeued-for-a-slot wait.")
        self._m_prefill = reg.histogram(
            "kukeon_engine_prefill_seconds",
            "Prefill dispatch latency by padded prompt bucket.",
            labels=("bucket",))
        self._m_ttft = reg.histogram(
            "kukeon_engine_ttft_seconds",
            "Submit -> first token emitted (time to first token).")
        self._m_itl = reg.histogram(
            "kukeon_engine_inter_token_seconds",
            "Gap between consecutive emitted tokens of one request.")
        self._m_e2e = reg.histogram(
            "kukeon_engine_e2e_seconds",
            "Submit -> terminal event (any outcome).")
        self._m_tokens = reg.counter(
            "kukeon_engine_tokens_total", "Tokens emitted.")
        self._m_requests = reg.counter(
            "kukeon_engine_requests_total",
            "Requests reaching a terminal event, by outcome.",
            labels=("outcome",))
        self._m_shed = reg.counter(
            "kukeon_engine_shed_total",
            "Load-shedding events (rejected = queue full at submit, "
            "timed_out = deadline expired).", labels=("reason",))
        self.shed_stats = _CounterMapView(
            self._m_shed, "reason", ("rejected", "timed_out", "kv_exhausted"))
        # Paged-KV telemetry, declared in every mode so the scrape schema is
        # stable; a legacy engine reports a 0-page pool.
        reg.gauge("kukeon_kv_pages_total",
                  "Usable KV pool pages (0 = legacy contiguous layout)."
                  ).set(self.kv_pool_pages)
        reg.gauge("kukeon_kv_pages_in_use",
                  "KV pool pages currently allocated.").set_function(
            lambda: float(self._pool.in_use) if self._pool else 0.0)
        reg.gauge("kukeon_kv_prefix_shared_pages",
                  "Distinct pool pages pinned by prefix-cache entries "
                  "(shared read-only across sessions).").set_function(
            self._prefix_shared_pages)
        self._m_preempt = reg.counter(
            "kukeon_preemptions_total",
            "In-flight requests preempted (pages reclaimed, request "
            "requeued ahead of new admissions), by reason.",
            labels=("reason",))
        reg.gauge("kukeon_engine_mesh_chips",
                  "Devices in this engine's serving mesh (1 = single device)."
                  ).set(self.world)
        reg.gauge("kukeon_engine_slots_total",
                  "Decode slots in the fixed batch.").set(self.num_slots)
        reg.gauge("kukeon_engine_slots_free",
                  "Slots with no active request.").set_function(
            lambda: len(self._free_slots()))
        reg.gauge("kukeon_engine_queue_depth",
                  "Requests waiting for a slot (admitted-not-yet-slotted "
                  "plus preempted-awaiting-resume).").set_function(
            lambda: self._pending_n + len(self._resume))
        reg.gauge("kukeon_engine_max_pending",
                  "Admission bound (-1 = unbounded).").set(
            -1 if max_pending is None else max_pending)
        reg.register_collector(self._obs_collect)
        reg.register_collector(faults_collector)
        group = self.mesh.group if self.mesh is not None and self.mesh.leader else None
        reg.register_collector(device_memory_collector(
            self.device, peers=(lambda: list(group.peer_stats.values())) if group else None))
        self.compiles = CompileTracker(reg)
        # Peaks and the end-mark event ring are read at boot: a scrape may
        # land mid-capture, when no CUDA call may come from another thread.
        self.timers = ProgramTimers(reg, peaks=device_peaks(self.device))
        if self.device.type == "cuda":
            self.timers.arm_events(self.device)
        self._program_cost = functools.partial(
            program_cost, self.cfg, num_slots=self.num_slots,
            max_seq_len=self.max_seq_len, int8_weights=int8_weights,
            kv_cache_int8=self.kv_cache_int8)
        self.recorder = FlightRecorder(registry=reg)
        # Step-local counters the flight recorder takes at the end of each
        # working step (driver thread only).
        self._step_tokens = 0
        self._step_preempts = 0

    @property
    def tokens_total(self) -> int:
        """Tokens emitted since boot (``kukeon_engine_tokens_total``)."""
        return int(self._m_tokens.value())

    @property
    def preemptions(self) -> int:
        """Requests preempted since boot (``kukeon_preemptions_total``)."""
        return int(self._m_preempt.value(reason="kv_pressure"))

    def _obs_collect(self):
        """Scrape-time counter families sourced from the live dicts the
        hot path already maintains (``sync_stats`` is bumped inside
        :meth:`_fetch`/:meth:`_upload` with no lock; mirroring it here keeps
        the decode loop's instrumentation at zero)."""
        s = self.sync_stats
        yield ("kukeon_engine_host_sync_total", "counter",
               "Blocking host<->device transfers (fetch = device->host "
               "readback, upload = host->device array).",
               [({"kind": "fetch"}, float(s["fetches"])),
                ({"kind": "upload"}, float(s["uploads"]))])
        yield ("kukeon_engine_host_sync_seconds_total", "counter",
               "Wall time spent blocked in host<->device transfers.",
               [({"kind": "fetch"}, float(s["fetch_s"])),
                ({"kind": "upload"}, float(s["upload_s"]))])
        yield ("kukeon_engine_decode_chunks_total", "counter",
               "Dispatched multi-step decode chunks.",
               [({}, float(s["chunks"]))])
        # The streamed boot's accounting (the reference's :1166-1180): each
        # stage's summed seconds (they overlap, so their sum exceeds the
        # load's wall time) and the bytes moved; all 0 on a boot from a
        # tree in memory.
        ls = self.load_stats
        cs = self._ckpt_stream.stat_snapshot() if self._ckpt_stream is not None else {}
        yield ("kukeon_checkpoint_load_bytes_total", "counter",
               "Checkpoint bytes streamed host->device during boot.",
               [({}, float(max(int(cs.get("bytes", 0)), ls["bytes"])))])
        yield ("kukeon_checkpoint_load_seconds", "counter",
               "Streamed checkpoint load wall time by pipeline stage "
               "(disk = reader-thread file reads, cast = host dtype "
               "casts/quantize, upload = device copies). Stages run "
               "concurrently: their sum exceeds the load wall clock.",
               [({"stage": "disk"}, float(cs.get("disk_s", 0.0))),
                ({"stage": "cast"}, float(cs.get("cast_s", 0.0))),
                ({"stage": "upload"}, float(ls["upload_s"]))])
        yield ("kukeon_engine_prefix_cache_total", "counter",
               "Prefix-KV cache lookups by result.",
               [({"result": "hit"}, float(self.prefix_hits)),
                ({"result": "miss"}, float(self.prefix_misses))])
        ss = self.tracer.sample_stats
        yield ("kukeon_trace_tail_sampled_total", "counter",
               "Tail-sampler verdicts on finished trace spans (error/"
               "preempted/retried/slow spans are always kept).",
               [({"decision": "kept"}, float(ss["kept"])),
                ({"decision": "dropped"}, float(ss["dropped"]))])

    def _observe_terminal(self, req: Request, outcome: str) -> None:
        """A request's terminal event on every instrument at once: the e2e
        histogram, the outcome counter and its trace span. Exactly one a
        request (``Tracer.finish`` keeps the first verdict)."""
        if req.submitted_at:
            self._m_e2e.observe(
                time.monotonic() - req.submitted_at,
                exemplar=req.trace.trace_id if req.trace is not None else None)
        self._m_requests.inc(outcome=outcome)
        if req.trace is not None:
            self.tracer.finish(
                req.trace, outcome, tokens=len(req.generated),
                error=(f"{type(req.error).__name__}: {req.error}"
                       if req.error is not None else None))

    def _note_prefill(self, req: Request, key: tuple, t0: float) -> None:
        """A prefill (or export) dispatched: its tokens on the prefill timer,
        its dispatch latency by the bucket of the rows it ran, its span
        event."""
        bucket = key[2] if key[0].startswith("prefill_ext") else key[1]
        self.timers.note_tokens("prefill", bucket)
        self._m_prefill.observe(time.monotonic() - t0, bucket=str(bucket))
        if req.trace is not None:
            req.trace.event("prefill_dispatched")

    # --- programs ----------------------------------------------------------

    # ``program_stats`` (set in __init__): the decode programs' counters
    # (``DecodePrograms.stats``), and under "prefill" the prefill programs'
    # (``PrefillPrograms.stats``); both live dicts.

    def _stage_prefill(self, req: Request, slot: int, export: bool = False):
        """Look the request's prefix up and write its prefill inputs into the
        static buffers: one upload, and on a hit the stored block. Returns
        the prefill program's key (``export``: the export kinds, whose
        ``slot`` is unused). A paged engine's export takes no part in the
        prefix cache (the reference's ``:2202``)."""
        n = req.prompt.size
        cached = None if self.paged else self._prefix_lookup(req)
        if cached is not None:
            self.prefix_hits += 1
            tokens, plen = req.prompt[cached.length:], cached.length
            self._dev("prefix_load", req.prefix_id)
        else:
            if req.prefix_id is not None and not self.paged:
                self.prefix_misses += 1
            tokens, plen = req.prompt, 0
        bucket = min(self._bucket(tokens.size), self.max_seq_len)
        packed = pack_prefill_inputs(tokens, bucket, n, slot, plen, req.sampling)
        self._dev("stage", packed)
        return prefill_key(bucket, req.sampling,
                           cached.kv_k.shape[2] if cached is not None else None,
                           export=export)

    def _stage_prefill_paged(self, req: Request, slot: int, seq: np.ndarray,
                             cached: SharedPrefix | None, pages: list[int]):
        """The paged counterpart of :meth:`_stage_prefill` for ``seq`` (the
        prompt, or a resumed request's prompt + generated) into ``pages``
        (the shared prefix pages first): one upload of the tokens and the
        page ids. The block's rows past the shared pages go to their private
        pages; shared pages and bucket padding go to scratch."""
        pt, n = self.page_tokens, int(seq.size)
        mp = self.max_pages_per_slot
        if cached is not None:
            plen, Pb = cached.length, min(self._bucket(cached.length), self.max_seq_len)
            tokens = seq[plen:]
            gather = np.full((Pb // pt,), SCRATCH_PAGE, np.int64)
            gather[:len(cached.pages)] = cached.pages
        else:
            plen, Pb, tokens, gather = 0, None, seq, np.zeros((0,), np.int64)
        bucket = min(self._bucket(tokens.size), self.max_seq_len)
        key = prefill_key(bucket, req.sampling, Pb, paged=True)
        ids = np.full((self._prefill_programs.block_len(key) // pt,), SCRATCH_PAGE, np.int64)
        first = plen // pt
        ids[first:-(-n // pt)] = pages[first:-(-n // pt)]
        packed = pack_prefill_inputs(tokens, self.max_seq_len, n, slot, plen, req.sampling,
                                     pages=(gather, ids, mp))
        self._dev("stage", packed)
        return key

    def _prefix_lookup(self, req: Request) -> _CachedPrefix | None:
        """Stored prefix usable for this request: its tokens must be a
        strict prefix of the prompt (equal would leave nothing to prefill,
        and the stored block carries no logits)."""
        if req.prefix_id is None:
            return None
        e = self._prefix_cache.get(req.prefix_id)
        if (e is not None and req.prompt.size > e.length
                and np.array_equal(req.prompt[:e.length], e.tokens)):
            self._prefix_cache.move_to_end(req.prefix_id)
            return e
        return None

    def _prefix_store(self, prefix_id: str, prompt: np.ndarray, key) -> None:
        """Store copies of the prompt's KV block (the block the program of
        ``key`` left) under ``prefix_id``."""
        if self._prefix_cache_size == 0 or self._prefix_cache_bytes == 0:
            return
        kv_k, kv_v = self._dev("prefix_put", prefix_id, key)
        self._prefix_cache[prefix_id] = _CachedPrefix(
            tokens=prompt.copy(), kv_k=kv_k, kv_v=kv_v, length=int(prompt.size))
        self._prefix_cache.move_to_end(prefix_id)
        # Evict LRU-first past either bound. An entry that alone exceeds the
        # byte budget evicts itself too: keeping it would pin more device
        # memory than the operator allowed.
        while self._prefix_cache and (
                len(self._prefix_cache) > self._prefix_cache_size
                or sum(e.nbytes for e in self._prefix_cache.values())
                > self._prefix_cache_bytes):
            self._dev("prefix_drop", self._prefix_cache.popitem(last=False)[0])

    # --- paged prefix cache (shared refcounted pages, no copies) -----------

    def _prefix_shared_pages(self) -> int:
        """Distinct pool pages pinned by prefix entries."""
        if not self.paged:
            return 0
        return len({p for e in self._prefix_cache.values() for p in e.pages})

    def _prefix_lookup_paged(self, req: Request, seq: np.ndarray) -> SharedPrefix | None:
        """Usable stored prefix for ``seq``: its page-aligned tokens must be
        a strict prefix (equal would leave nothing to prefill)."""
        if req.prefix_id is None:
            return None
        e = self._prefix_cache.get(req.prefix_id)
        if (e is not None and e.length > 0 and seq.size > e.length
                and np.array_equal(seq[:e.length], e.tokens)):
            self._prefix_cache.move_to_end(req.prefix_id)
            return e
        return None

    def _prefix_store_paged(self, prefix_id: str, seq: np.ndarray, pages: list[int]) -> None:
        """Point ``prefix_id`` at the slot's full prompt pages: a refcount
        bump, not a copy. The trailing partial page is left out: the slot's
        decode writes into it."""
        if self._prefix_cache_size == 0 or self._prefix_cache_bytes == 0:
            return
        full = int(seq.size) // self.page_tokens
        if full == 0:
            return
        entry_pages = list(pages[:full])
        self._pool.ref(entry_pages)
        old = self._prefix_cache.pop(prefix_id, None)
        if old is not None:
            self._pool.unref(old.pages)
        self._prefix_cache[prefix_id] = SharedPrefix(
            tokens=np.asarray(seq[:full * self.page_tokens]).copy(), pages=entry_pages,
            length=full * self.page_tokens)
        while self._prefix_cache and (
                len(self._prefix_cache) > self._prefix_cache_size
                or sum(e.nbytes(self._page_bytes) for e in self._prefix_cache.values())
                > self._prefix_cache_bytes):
            _, e = self._prefix_cache.popitem(last=False)
            self._pool.unref(e.pages)

    def _reclaim_prefix_pages(self, need: int) -> bool:
        """Evict prefix entries LRU-first until ``need`` pages are free;
        True when they are. Only entries whose pages the cache alone holds
        are evicted: one a live slot also holds would free nothing now."""
        while self._pool.free < need and self._prefix_cache:
            victim = next((key for key, e in self._prefix_cache.items()
                           if all(self._pool.refcount(p) == 1 for p in e.pages)), None)
            if victim is None:
                break
            self._pool.unref(self._prefix_cache.pop(victim).pages)
        return self._pool.free >= need

    def _decode_chunk(self, k: int, flags: tuple[bool, bool]) -> torch.Tensor:
        """K decode steps over every slot -> the program's static tokens
        [B, K] on the device. Inactive slots neither advance their length
        nor change token."""
        return self._dev("run", "decode", program_key(k, *flags), flush=True)

    @torch.no_grad()
    def precompile(self, prompt_lens: tuple[int, ...] = (64,), *, export: bool = False,
                   imports: bool = False) -> None:
        """Capture the greedy decode program of every chunk size the
        reference compiles (``chunk_sizes``) and the greedy prefill (with
        its insert) of the bucket of every length in ``prompt_lens``, the
        counterpart of the reference's ``precompile``; ``export`` and
        ``imports`` also capture each bucket's greedy export and its
        insert-only program (what a prefill and a decode cell serve). Other
        keys are captured at their first use. Call it before :meth:`start`:
        a capture must not meet the loop's launches. A key already built is
        kept; captures from here to the end of :meth:`warmup` do not count
        as after warmup."""
        if self._running:
            raise RuntimeError("precompile() before start(): the driver thread is running")
        self._programs.warm = self._prefill_programs.warm = False
        self.boot_marks.setdefault("capture_start", time.monotonic())
        for k in chunk_sizes(self.decode_chunk):
            self._dev("build", "decode", program_key(k, False, False), flush=True)
        buckets = sorted({min(self._bucket(max(1, n)), self.max_seq_len) for n in prompt_lens})
        keys = [prefill_key(S, SamplingParams(), paged=self.paged) for S in buckets]
        if export:
            keys += [prefill_key(S, SamplingParams(), export=True) for S in buckets]
        if imports:
            keys += [insert_key(S, self.paged) for S in buckets]
        # The per-dispatch cost gauges, as the reference's precompile notes
        # them: the largest chunk size's and bucket's win (exports share
        # the prefill label and keep the fused prefill's).
        for key in [program_key(k, False, False) for k in chunk_sizes(self.decode_chunk)] + [
                key for key in keys if not key[0].endswith("_export")]:
            label = program_labels(key, self.paged)[0]
            self.timers.set_cost(label, *self._program_cost(label, key))
        for key in keys:
            S = self._prefill_programs.block_len(key)
            if key not in self._prefill_programs.keys():
                # A capture's warm-up run needs valid inputs: half the
                # bucket of token 0 into slot 0 (the reference lowers at
                # length S // 2), paged into scratch pages only; the
                # capture puts back what it writes.
                none = np.zeros((0,), np.int64)
                packed = pack_prefill_inputs(
                    none, self.max_seq_len if self.paged else S, max(1, S // 2), 0, 0,
                    SamplingParams(),
                    pages=(none, none, self.max_pages_per_slot) if self.paged else None)
                self._dev("stage", packed)
                self._dev("build", "prefill", key, flush=True)
        self.boot_marks["capture_end"] = time.monotonic()

    # --- counted transfer seams -------------------------------------------

    def _fetch(self, x: torch.Tensor, ready=None, as_tensor: bool = False):
        """Blocking device->host read, counted and timed -> a numpy array
        (``as_tensor``: a host tensor, for bf16, which numpy lacks). ``x``
        may be a host tensor whose copy is in flight behind the CUDA event
        ``ready``. After the read, the program timers retire the marks
        whose end events are done (non-blocking queries: still one sync)."""
        faults.maybe_fail("engine.fetch")
        t0 = time.monotonic()
        if ready is not None:
            ready.synchronize()
        out = x.cpu() if as_tensor else x.cpu().numpy()
        self.sync_stats["fetches"] += 1
        self.sync_stats["fetch_s"] += time.monotonic() - t0
        self.timers.settle()
        return out

    def _upload(self, x: np.ndarray | torch.Tensor, into: torch.Tensor, *,
                stager: _Stager | None = None) -> torch.Tensor:
        """Host array (or host tensor) -> the static device buffer ``into``,
        counted and timed (pinned staging, a copy that waits for no queued
        device work). ``stager``: the streamed boot's copy (the load
        thread's stream and pinned ring), counted on ``load_stats`` instead
        of ``sync_stats``."""
        faults.maybe_fail("engine.upload")
        t0 = time.monotonic()
        host = (x.contiguous() if isinstance(x, torch.Tensor)
                else torch.from_numpy(np.ascontiguousarray(x)))
        if stager is not None:
            stager.copy(host, into)
            ls = self.load_stats
            ls["upload_s"] += time.monotonic() - t0
            ls["bytes"] += host.numel() * host.element_size()
            ls["tensors"] += 1
            return into
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
        prefix_id: str | None = None,
        deadline_s: float | None = None,
        trace_ctx=None,
        export: bool = False,
        kv_import: dict | None = None,
    ) -> Request:
        """Queue one request. ``trace_ctx`` (a parsed ``traceparent``): the
        request's span joins that trace. ``export``: prefill only, for a
        KV handoff (the payload lands on ``Request.export_payload``);
        ``kv_import``: seat an exported block ({"token", "length", "k",
        "v"}, k and v [L, 1, length, KV, D] host tensors or arrays) instead
        of a prefill."""
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
        if export and kv_import is not None:
            raise ValueError("a request cannot both export and import KV")
        if kv_import is not None:
            self._check_import(kv_import, prompt.size)
        if self.paged and not export and \
                self._pool.pages_for(prompt.size + 1) > self._pool.num_pages:
            # Even an empty pool could never hold it: waiting would deadlock.
            raise ValueError(
                f"prompt needs {self._pool.pages_for(prompt.size + 1)} KV pages but the "
                f"pool holds {self._pool.num_pages} (kv_page_tokens={self.page_tokens})")
        if deadline_s is not None and deadline_s <= 0:
            raise ValueError("deadline_s must be positive")
        now = time.monotonic()
        shed_depth = None
        with self._lock:
            if self.max_pending is not None and self._pending_n >= self.max_pending:
                shed_depth = self._pending_n
            else:
                req = Request(id=self._next_id, prompt=prompt,
                              sampling=sampling or SamplingParams(), emit=emit,
                              submitted_at=now, prefix_id=prefix_id,
                              deadline=now + deadline_s if deadline_s is not None else None,
                              export=export, kv_import=kv_import)
                # The span exists before the driver can pop the request.
                req.trace = self.tracer.begin(req.id, int(prompt.size), trace_ctx=trace_ctx)
                self._next_id += 1
                self._requests[req.id] = req
                self._pending_n += 1
                self.last_progress = now
                self._pending.put(req)
                self._work.notify()
        if shed_depth is not None:
            # A shed leaves a zero-length span (id -1: it never got one) in
            # the caller's trace, so the shed hop shows in /v1/trace too.
            self._m_shed.inc(reason="rejected")
            self._m_requests.inc(outcome="shed")
            self.tracer.finish(self.tracer.begin(-1, int(prompt.size), trace_ctx=trace_ctx),
                               "shed")
            raise RejectedError(f"pending queue full ({shed_depth}/{self.max_pending}); "
                                "shedding load", retry_after_s=self.retry_after_s)
        return req

    def _check_import(self, imp: dict, n: int) -> None:
        """The reference's length rule (the block covers exactly the prompt
        rows), and the block's shape against this engine's model."""
        if int(imp["length"]) != n:
            raise ValueError(
                f"kv_import length {imp['length']} != prompt length {n}: the imported "
                "block must cover exactly the prompt rows")
        cfg = self.cfg
        want = (cfg.num_layers, 1, n, cfg.num_kv_heads, cfg.head_dim)
        for name in ("k", "v"):
            if tuple(imp[name].shape) != want:
                raise ValueError(f"kv_import {name} has shape {tuple(imp[name].shape)}; "
                                 f"this engine's block is {want}")
        if not 0 <= int(imp["token"]) < cfg.vocab_size:
            raise ValueError(f"kv_import token must lie in [0, {cfg.vocab_size})")

    @property
    def queue_depth(self) -> int:
        """Requests waiting for a slot: fresh ones and preempted ones. The
        admission bound (max_pending) counts only the former."""
        return self._pending_n + len(self._resume)

    def stalled_s(self) -> float:
        """Seconds since the engine last made progress WHILE work is
        outstanding; 0.0 when idle (an idle engine is never stalled)."""
        if self._pending_n == 0 and not self._resume and not any(
                r is not None for r in self._slot_req):
            return 0.0
        return max(0.0, time.monotonic() - self.last_progress)

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
        self._ensure_loaded()
        sp = sampling or SamplingParams()
        req = self.submit(np.ones((max(1, prompt_len),), np.int32),
                          dataclasses.replace(sp, max_new_tokens=2))
        while not req.done.is_set():
            self.step()
        self._programs.warm = self._prefill_programs.warm = True

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
        return (self._pending_n == 0 and not self._resume and self._inflight is None
                and all(r is None for r in self._slot_req) and not self._calls)

    def on_engine_thread(self, fn: Callable[[], Any]) -> Any:
        """``fn()`` run by the engine's thread between two steps (here, when
        none runs or this is it), its result returned or its error
        raised: a device action of another thread (a profile) then takes
        its place in the order the steps post theirs, which is the order a
        mesh's followers apply them in."""
        call = _ThreadCall(fn)
        with self._work:
            queued = (self._running and self._thread is not None
                      and threading.current_thread() is not self._thread)
            if queued:
                self._calls.append(call)
                self._work.notify_all()
        if not queued:
            call.run()
        call.done.wait()
        if call.error is not None:
            raise call.error
        return call.result

    def _run_calls(self, error: BaseException | None = None) -> None:
        """Run (or, with ``error``, fail) every call handed to this thread."""
        with self._lock:
            calls, self._calls = self._calls, []
        for call in calls:
            if error is not None:
                call.error = error
                call.done.set()
            else:
                call.run()

    def _loop(self):
        try:
            self._serve()
        finally:
            self._run_calls(RuntimeError("the engine's thread stopped"))

    def _serve(self):
        while self._running:
            try:
                self._run_calls()
                if not self.step():
                    with self._work:
                        if self._running and self._idle_locked():
                            self._work.wait(timeout=0.05)
            except Exception as e:  # noqa: BLE001 — the driver thread must not die silently
                traceback.print_exc()
                self.error = e
                if self._load_exc is None:
                    # The state may be half-written: start it over, in
                    # place, on every rank, before the failed callers wake.
                    try:
                        self._dev("reset", flush=True)
                    except launch.RankFailure:
                        pass
                if self._load_exc is not None or (
                        self._group is not None and self._group.failed is not None):
                    # No weights will come, or a rank is gone (the group
                    # cannot compute any more): fail what waits, and stop.
                    self._fail_all(e)
                    with self._lock:
                        self._running = False
                    return
                self._fail_all(e)
                self._slot_req = [None] * self.num_slots
                self._slot_len = [0] * self.num_slots
                self._inflight = None
                self._sampling_dirty = True
                if self.paged:
                    # The pool was zeroed: every page and prefix entry
                    # pointing into it is void. Start the books over.
                    self._pool = PageAllocator(self.kv_pool_pages, self.page_tokens)
                    self._slot_pages = [[] for _ in range(self.num_slots)]
                    self._slot_disp = [0] * self.num_slots
                    self._bt[:] = SCRATCH_PAGE
                    self._bt_dirty = True
                    self._prefix_cache.clear()

    def _finish(self, req: Request, outcome_error: Exception | None = None) -> None:
        """Terminal event of a request that holds no slot: its outcome is a
        shed (a RejectedError), a timeout, an error, or a cancel."""
        req.error = req.error or outcome_error
        with self._lock:
            self._requests.pop(req.id, None)
        self._observe_terminal(
            req, "shed" if isinstance(req.error, RejectedError) else
            "timeout" if req.timed_out else "error" if req.error is not None else
            "cancelled" if req.cancelled else "ok")
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
        while self._resume:
            self._finish(self._resume.popleft(), exc)
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
        self._m_shed.inc(reason="timed_out")
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
        # Preempted requests waiting to resume keep their deadlines too.
        for req in list(self._resume):
            if req.cancelled or self._expired(req, now):
                self._resume.remove(req)
                self._finish(req, None if req.cancelled else self._timeout_error(req, now))
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

          1. prefill + insert for every free slot with a waiting request (an
             import: the insert of its block, its first token emitted now;
             an export: its prefill alone, taking no slot);
          2. fetch and emit the prefills' first tokens (one stacked fetch);
          3. enqueue the next decode chunk for the active slots;
          4. finish the exports (their first tokens and KV rows fetched);
          5. fetch and emit the PREVIOUS chunk's tokens (double buffering).

        The reference enqueues the chunk before the first-token fetch.
        Here the first tokens are fetched first: the blocking fetch would
        otherwise queue behind the whole chunk on the one stream, and TTFT
        would include it. The exports finish after the chunk's dispatch, as
        the reference's (``:1847-1853``): their host copies were started
        at their dispatch, ahead of the chunk on the stream.

        Returns True if any work was done; such a step leaves one record in
        the flight recorder and bumps the progress heartbeat.
        """
        self._ensure_loaded()
        # Flight-recorder baselines (driver thread only: plain reads).
        step_t0 = time.monotonic()
        fetches0, uploads0 = self.sync_stats["fetches"], self.sync_stats["uploads"]
        busy0 = self.timers.busy_seconds()
        self._step_tokens = 0
        self._step_preempts = 0
        did_work = self._sweep()
        prefills = []
        exports: list[_Export] = []
        free = self._free_slots()
        while free:
            req, resumed = self._pop_waiting()
            if req is None:
                break
            if not resumed:
                self._m_queue_wait.observe(time.monotonic() - req.submitted_at)
            if req.trace is not None:
                req.trace.event("admitted")
            if req.export:
                # Prefill only: no slot, no pages, so a prefill cell drains
                # export bursts whatever its decode slots hold.
                try:
                    exports.append(self._dispatch_prefill_export(req))
                except Exception as e:
                    self._finish(req, e)
                    for exp in exports:
                        self._finish(exp.req, e)
                    raise
                did_work = True
                continue
            slot = free.pop(0)
            try:
                if self._dispatch_prefill(req, slot):
                    prefills.append((slot, req))
            except PagePoolExhausted as e:
                # No pages for it now. With work in flight pages will free:
                # it waits at the front. An otherwise idle engine would
                # never free any: shed it (429) rather than deadlock.
                if self._active_requests() or prefills or self._inflight is not None:
                    self._resume.appendleft(req)
                else:
                    self._shed_kv_exhausted(req, e)
                did_work = True
                break
            except Exception as e:
                self._finish(req, e)
                for exp in exports:
                    self._finish(exp.req, e)
                raise
            did_work = True

        new_inflight = None
        try:
            if prefills:
                # Each first token is read back from its slot's token: the
                # prefills of one step share the programs' static buffers.
                firsts = self._fetch(torch.stack([self.state.tokens[slot]
                                                  for slot, _ in prefills]))
                for (_, req), first in zip(prefills, firsts):
                    self._emit(req, int(first))
            if self._active_requests():
                new_inflight = self._dispatch_decode_chunk()
                did_work = True
        except Exception as e:
            # Dispatched exports hold no slot and sit in no queue: the
            # error path cannot find them, so fail them here.
            for exp in exports:
                self._finish(exp.req, e)
            raise
        for exp in exports:
            self._finish_export(exp)
        if self._inflight is not None:
            self._flush_inflight()
            did_work = True
        self._inflight = new_inflight
        if did_work:
            self._record_step(step_t0, fetches0, uploads0, busy0, len(prefills), new_inflight)
            with self._lock:
                self.last_progress = time.monotonic()
        return did_work

    def _record_step(self, step_t0: float, fetches0: int, uploads0: int, busy0: dict,
                     prefills: int, inflight: _InflightChunk | None) -> None:
        """One flight-recorder record for a step that did work (the
        reference's ``_record_step``): occupancy, chunk size, tokens,
        transfer deltas, per-program wall-time deltas, preemptions and the
        trace ids of everything seated."""
        seated = self._active_requests()
        programs = {}
        for name, busy in self.timers.busy_seconds().items():
            dt = busy - busy0.get(name, 0.0)
            if dt > 0.0:
                programs[name] = round(dt, 6)
        self.recorder.record({
            "wall_s": round(time.monotonic() - step_t0, 6),
            "occupancy": len(seated),
            "slots": self.num_slots,
            "queue_depth": self._pending_n + len(self._resume),
            "prefills": prefills,
            "chunk_k": inflight.k if inflight is not None else 0,
            "tokens": self._step_tokens,
            "fetches": self.sync_stats["fetches"] - fetches0,
            "uploads": self.sync_stats["uploads"] - uploads0,
            "preemptions": self._step_preempts,
            "programs": programs,
            "traces": [req.trace.trace_id for _slot, req in seated if req.trace is not None],
        })

    def _pop_waiting(self) -> tuple[Request | None, bool]:
        """(the next request to seat, whether it was preempted): a preempted
        one before any pending."""
        if self._resume:
            return self._resume.popleft(), True
        try:
            req = self._pending.get_nowait()
        except queue.Empty:
            return None, False
        with self._lock:
            self._pending_n -= 1
        return req, False

    def _shed_kv_exhausted(self, req: Request, cause: Exception) -> None:
        """Shed a request no page can be found for while nothing in flight
        would free one (the injected ``kv.alloc`` fault too): RejectedError
        with Retry-After, so the cell answers 429."""
        self._m_shed.inc(reason="kv_exhausted")
        self._finish(req, RejectedError(f"KV page pool exhausted: {cause}",
                                        retry_after_s=self.retry_after_s))

    def _dispatch_prefill(self, req: Request, slot: int) -> bool:
        """Enqueue the request's prefill and insert into ``slot``, one
        program run (``prefill``, or ``prefill_ext`` over the new tail on a
        prefix hit); the prompt's KV block is then stored under its
        ``prefix_id``. The first token lands in ``state.tokens[slot]``.
        A KV import is seated by :meth:`_dispatch_import` instead, which
        emits its first token itself: False then (nothing to fetch)."""
        faults.maybe_fail("engine.prefill")
        if req.kv_import is not None and not req.generated:
            # A preempted import re-enters with ``generated`` set and takes
            # the re-prefill below: its imported block is stale by then.
            self._dispatch_import(req, slot)
            return False
        t0 = time.monotonic()
        if self.paged:
            self._note_prefill(req, self._dispatch_prefill_paged(req, slot), t0)
            return True
        key = self._stage_prefill(req, slot)
        self._dev("run", "prefill", key, flush=True)
        if req.prefix_id is not None:
            self._prefix_store(req.prefix_id, req.prompt, key)
        self._note_prefill(req, key, t0)
        req.slot = slot
        self._slot_req[slot] = req
        self._slot_len[slot] = req.prompt.size + 1   # prompt + the first token's kv-to-be
        self._sampling_dirty = True
        return True

    # --- KV handoff: export and import ------------------------------------

    def _dispatch_prefill_export(self, req: Request) -> _Export:
        """The reference's ``_dispatch_prefill_export`` (``:2186``): the
        export program of the prompt (a ``prefill_ext`` over a legacy
        engine's prefix hit), which leaves the block and the first token in
        the programs' static buffers and touches no slot, block table or
        page; then copies of the token and the prompt's rows start toward
        host memory, before the next program can overwrite them."""
        faults.maybe_fail("engine.prefill")
        t0 = time.monotonic()
        n = int(req.prompt.size)
        key = self._stage_prefill(req, 0, export=True)
        progs = self._prefill_programs
        self._dev("run", "prefill", key, flush=True)
        if req.prefix_id is not None and not self.paged:
            self._prefix_store(req.prefix_id, req.prompt, key)
        self._note_prefill(req, key, t0)
        rows = [progs.first, *self._dev("export_rows", n, flush=True)]
        ready = None
        if progs.first.is_cuda:
            host = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True) for t in rows]
            for h, t in zip(host, rows):
                h.copy_(t, non_blocking=True)
            ready = torch.cuda.Event()
            ready.record()
        else:
            host = [t.clone() for t in rows]
        return _Export(req, *host, ready=ready, length=n)

    def _finish_export(self, exp: _Export) -> None:
        """The reference's ``_finish_export`` (``:2232``): the first token
        and the KV rows through the counted :meth:`_fetch` seam, then the
        request completes with its payload, the first token emitted as
        terminal. A failed fetch fails this request only."""
        req = exp.req
        try:
            first = int(self._fetch(exp.first, exp.ready)[0])
            k = self._fetch(exp.k, as_tensor=True)
            v = self._fetch(exp.v, as_tensor=True)
        except Exception as e:  # noqa: BLE001 — fail this request, keep serving
            self._finish(req, e)
            return
        req.export_payload = {"token": first, "length": exp.length, "k": k, "v": v,
                              "pageTokens": self.page_tokens}
        if req.trace is not None:
            req.trace.event("kv_exported", bytes=_nbytes(k) + _nbytes(v))
        with self._lock:
            self._requests.pop(req.id, None)
        self._observe_terminal(req, "ok")
        if req.emit:
            try:
                req.emit(first, True)
            except Exception:  # noqa: BLE001 — a bad sink must not stop the driver
                pass
        req.done.set()

    def _dispatch_import(self, req: Request, slot: int) -> None:
        """The reference's ``_dispatch_import`` (``:2263``): seat an
        exported block in ``slot`` without a prefill. The rows go up
        (cast to this engine's dtype, padded or cut to its bucket) into the
        programs' block, and the insert-only program puts them into the
        slot (paged: into ``n // pt + 1`` fresh pages, reclaiming prefix
        pages when the pool is short); the imported first token is then
        emitted as if this engine had sampled it. ``PagePoolExhausted``
        reaches step()'s admission, which parks or sheds it as any
        prefill."""
        imp = req.kv_import
        n, first = int(imp["length"]), int(imp["token"])
        bucket = min(self._bucket(n), self.max_seq_len)
        key = insert_key(bucket, self.paged)
        progs = self._prefill_programs
        if self.paged:
            pt = self.page_tokens
            need = n // pt + 1                 # pages covering positions [0, n]
            try:
                pages = self._pool.alloc(need)
            except PagePoolExhausted:
                if not self._reclaim_prefix_pages(need):
                    raise
                pages = self._pool.alloc(need)
            ids = np.full((bucket // pt,), SCRATCH_PAGE, np.int64)
            ids[:-(-n // pt)] = pages[:-(-n // pt)]
            packed = pack_prefill_inputs(np.array([first]), self.max_seq_len, n, slot, 0,
                                         req.sampling, pages=(np.zeros((0,), np.int64), ids,
                                                              self.max_pages_per_slot))
        else:
            packed = pack_prefill_inputs(np.array([first]), bucket, n, slot, 0, req.sampling)
        self._dev("stage", packed)
        rows = min(n, bucket)
        kv = []
        for name in ("k", "v"):
            x = imp[name]
            x = (x if isinstance(x, torch.Tensor) else torch.from_numpy(np.asarray(x)))[:, :, :rows]
            if self.mesh is not None and self.kv_sharded:
                # Each rank's kv heads (by its tensor coordinate), from the
                # host block.
                h, t = self.kv_heads, self.tensor
                parts = [x[:, :, :, r * h:(r + 1) * h].contiguous() for r in range(t)]
                x = launch.PerRank([parts[r % t] for r in range(self.world)])
            kv.append(x)
        self._dev("import_rows", *kv, bucket)
        self._dev("run", "prefill", key, flush=True)
        if self.paged:
            self._slot_pages[slot] = pages
            self._bt[slot, :] = SCRATCH_PAGE
            self._bt[slot, :len(pages)] = pages
            self._bt_dirty = True
            self._slot_disp[slot] = n
        req.slot = slot
        self._slot_req[slot] = req
        self._slot_len[slot] = n + 1
        self._sampling_dirty = True
        if req.trace is not None:
            req.trace.event("kv_imported", bytes=_nbytes(imp["k"]) + _nbytes(imp["v"]),
                            pages=len(self._slot_pages[slot]) if self.paged else 0)
        self._emit(req, first)

    def _dispatch_prefill_paged(self, req: Request, slot: int) -> tuple:
        """Paged admission: allocate the sequence's pages (evicting prefix
        entries if the pool is short), run the paged prefill (over the
        shared prefix pages on a hit) with its insert into the pool, and
        seat the slot -> the prefill's key. A preempted request re-enters
        here with ``prompt + generated``: its KV was reclaimed, so the
        whole context re-prefills and its first token continues the
        generation."""
        seq = (req.prompt if not req.generated else
               np.concatenate([req.prompt, np.asarray(req.generated, np.int32)]))
        n = int(seq.size)
        cached = self._prefix_lookup_paged(req, seq)

        def private() -> int:                # pages covering positions [0, n]
            return n // self.page_tokens + 1 - (len(cached.pages) if cached else 0)

        try:
            priv = self._pool.alloc(private())
        except PagePoolExhausted:
            if not self._reclaim_prefix_pages(private()):
                raise
            # Eviction may have taken the entry to share; nothing is held
            # yet, so look again.
            cached = self._prefix_lookup_paged(req, seq)
            priv = self._pool.alloc(private())
        shared = list(cached.pages) if cached is not None else []
        self._pool.ref(shared)               # the slot holds them too
        pages = shared + priv
        if cached is not None:
            self.prefix_hits += 1
        elif req.prefix_id is not None:
            self.prefix_misses += 1
        key = self._stage_prefill_paged(req, slot, seq, cached, pages)
        self._dev("run", "prefill", key, flush=True)
        self._slot_pages[slot] = pages
        self._bt[slot, :] = SCRATCH_PAGE
        self._bt[slot, :len(pages)] = pages
        self._bt_dirty = True
        self._slot_disp[slot] = n
        if req.prefix_id is not None and cached is None:
            # Store on a miss only: pointing a hit's entry at this
            # session's prompt would fold its private tail into the entry.
            self._prefix_store_paged(req.prefix_id, seq, pages)
        req.slot = slot
        self._slot_req[slot] = req
        self._slot_len[slot] = n + 1
        self._sampling_dirty = True
        return key

    def _chunk_size(self) -> int:
        """Largest safe K: at most decode_chunk, bounded by cache capacity,
        rounded down to a power of 4; 4 at most while a waiting request
        (pending or preempted) could take a free slot."""
        k = self.decode_chunk
        if (not self._pending.empty() or self._resume) and self._free_slots():
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
            self._dev("sampling", temps, top_ks.astype(np.int64), top_ps)
            self._sampling_flags = branch_flags(temps, top_ks, top_ps)
            self._sampling_dirty = False

    def _preempt_victim(self, exclude: int) -> int | None:
        """Slot of the latest-submitted seated request other than
        ``exclude``: the oldest requests keep their progress."""
        victim, latest = None, -1.0
        for slot, req in self._active_requests():
            if slot != exclude and not req.done.is_set() and req.submitted_at >= latest:
                victim, latest = slot, req.submitted_at
        return victim

    def _preempt_slot(self, slot: int) -> None:
        """Take a seated request's slot and pages: it waits in the resume
        queue and re-prefills prompt + generated when seated again. The
        caller flushed the chunk in flight, so every token decoded for it
        has been emitted; only its KV is lost."""
        req = self._slot_req[slot]
        self._m_preempt.inc(reason="kv_pressure")
        self._step_preempts += 1
        req.preemptions += 1
        if req.trace is not None:
            req.trace.event("preempted")
        self._slot_req[slot] = None
        self._sampling_dirty = True
        self._dev("deactivate", slot)
        self._free_pages(slot)
        self._slot_len[slot] = 0
        req.slot = -1
        self._resume.append(req)

    def _free_pages(self, slot: int) -> None:
        """Drop the slot's page references and zero its block-table row, so
        a write still in flight for it lands in scratch."""
        self._pool.unref(self._slot_pages[slot])
        self._slot_pages[slot] = []
        self._slot_disp[slot] = 0
        self._bt[slot, :] = SCRATCH_PAGE
        self._bt_dirty = True

    def _ensure_decode_pages(self, k: int) -> None:
        """Grow every seated slot's pages to cover the next ``k`` decode
        steps, under pressure in this order: flush the chunk in flight (a
        request it finishes frees its pages), evict prefix entries, preempt
        the latest-submitted other request, and for a lone request finish
        it at its current length."""
        for slot, req in self._active_requests():
            if self._slot_req[slot] is not req or req.done.is_set():
                continue            # preempted or finished meanwhile
            # Never past the request's own final length: rows an
            # overshooting chunk writes past its last page land in scratch.
            limit = min(self.max_seq_len, int(req.prompt.size) + req.sampling.max_new_tokens)
            need = min(self._pool.pages_for(min(self._slot_disp[slot] + k, limit)),
                       self.max_pages_per_slot)
            while need > len(self._slot_pages[slot]):
                delta = need - len(self._slot_pages[slot])
                try:
                    got = self._pool.alloc(delta)
                except PagePoolExhausted:
                    if self._inflight is not None:
                        self._flush_inflight()
                        self._inflight = None
                        if req.done.is_set():
                            break
                        continue
                    if self._reclaim_prefix_pages(delta):
                        continue
                    victim = self._preempt_victim(exclude=slot)
                    if victim is not None:
                        self._preempt_slot(victim)
                        continue
                    self._release_slot(req, terminal=True)
                    break
                base = len(self._slot_pages[slot])
                self._slot_pages[slot].extend(got)
                self._bt[slot, base:base + len(got)] = got
                self._bt_dirty = True

    def _dispatch_decode_chunk(self) -> _InflightChunk | None:
        faults.maybe_fail("engine.decode")
        k = self._chunk_size()
        if self.paged:
            self._ensure_decode_pages(k)
            if not self._active_requests():
                return None         # pressure handling emptied the batch
            if self._bt_dirty:
                self._dev("bt", self._bt.copy())
                self._bt_dirty = False
        self._upload_sampling()
        toks = self._decode_chunk(k, self._sampling_flags)
        active = self._active_requests()
        for slot, req in active:
            self._slot_disp[slot] += k
            if req.trace is not None:
                req.trace.decode_chunks += 1
        self.sync_stats["chunks"] += 1
        self.timers.note_tokens("decode_chunk_paged" if self.paged else "decode_chunk",
                                len(active) * k)
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
        """Hand one token to the request: TTFT (with its trace id as the
        exemplar) and ``first_token`` at the first, the inter-token gap
        after; the time is when the port emits it (a step's first tokens
        are fetched before the next chunk is enqueued)."""
        now = time.monotonic()
        if not req.generated:
            req.first_token_at = now
            self._m_ttft.observe(
                now - req.submitted_at,
                exemplar=req.trace.trace_id if req.trace is not None else None)
            if req.trace is not None:
                req.trace.event("first_token")
        elif req.last_token_at:
            self._m_itl.observe(now - req.last_token_at)
        req.last_token_at = now
        self._m_tokens.inc()
        self._step_tokens += 1
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
        self._dev("deactivate", req.slot)
        if self.paged:
            # Pages a prefix entry or another session also holds stay.
            self._free_pages(req.slot)
        with self._lock:
            self._requests.pop(req.id, None)
        self._observe_terminal(
            req, "timeout" if terminal and req.timed_out else
            "cancelled" if terminal and req.cancelled else "ok")
        if terminal and req.emit:
            req.emit(-1, True)
        req.done.set()


class _ThreadCall:
    """One call handed to the engine's thread (``ServingEngine.on_engine_thread``)."""

    def __init__(self, fn: Callable[[], Any]):
        self.fn = fn
        self.done = threading.Event()
        self.result: Any = None
        self.error: BaseException | None = None

    def run(self) -> None:
        try:
            self.result = self.fn()
        except BaseException as e:  # noqa: BLE001 — handed back to the caller
            self.error = e
        finally:
            self.done.set()


def follower_engine(mesh, *, cfg: llama.LlamaConfig, recipe: Recipe,
                    kwargs: dict) -> ServingEngine:
    """A follower rank's engine (``parallel/launch.py`` builds it at its
    leader's word): its slice of the leader's weight ``recipe``, and the
    leader's resolved levers ``kwargs``."""
    return ServingEngine(cfg, recipe, mesh=mesh, **kwargs)


def _nbytes(x) -> int:
    """Bytes of a tensor or a numpy array."""
    return x.numel() * x.element_size() if isinstance(x, torch.Tensor) else int(x.nbytes)


def _to_device(tree, device: torch.device):
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    return tree.to(device)


def _zeros(tree, device: torch.device):
    """Zero-filled device tensors of an abstract tree (``TensorSpec``
    leaves: shape and dtype)."""
    if isinstance(tree, dict):
        return {k: _zeros(v, device) for k, v in tree.items()}
    return torch.zeros(tree.shape, dtype=tree.dtype, device=device)


class _Stager:
    """The streamed boot's host-to-device copies. On CUDA: a stream of its
    own and a ring of pinned staging buffers, both made at the engine's
    construction, before any capture. A leaf goes up in slices of a
    buffer: copied into the buffer on the host, then ``cudaMemcpyAsync``
    on the stream, then an event recorded behind it; a buffer is reused
    once its event reads done (polled: no synchronizing call, which the
    captures' warm-up runs forbid process-wide). On the CPU a plain copy."""

    SLOT_BYTES = 64 << 20
    SLOTS = 2

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        self.stream = None
        if self.cuda:
            # From the high-priority pool: torch.cuda.Stream() hands out the
            # default-priority pool's 32 streams in turn, and the captures'
            # capture and side streams come from that pool, so a
            # default-priority load stream could be the very stream a
            # capture is recording, and its copies would void the capture.
            self.stream = torch.cuda.Stream(device, priority=-1)
            # A pool stream does not wait for the legacy default stream: the
            # copies must follow the leaves' zero-fill (and any earlier
            # kernel on memory the allocator has just handed out again).
            self.stream.wait_stream(torch.cuda.current_stream(device))
            self._bufs = [torch.empty(self.SLOT_BYTES, dtype=torch.uint8, pin_memory=True)
                          for _ in range(self.SLOTS)]
            # Recorded once here, so each event exists before the load.
            self._events = [torch.cuda.Event() for _ in range(self.SLOTS)]
            for ev in self._events:
                ev.record(self.stream)
            self._next = 0

    @staticmethod
    def _wait(ev) -> None:
        while not ev.query():
            time.sleep(0.0002)

    def copy(self, host: torch.Tensor, into: torch.Tensor) -> None:
        if not self.cuda:
            into.copy_(host)
            return
        src = host.reshape(-1).view(torch.uint8)
        dst = into.reshape(-1).view(torch.uint8)
        n, off = src.numel(), 0
        with torch.cuda.stream(self.stream):
            while off < n:
                i = self._next
                self._next = (i + 1) % self.SLOTS
                self._wait(self._events[i])
                m = min(self.SLOT_BYTES, n - off)
                buf = self._bufs[i][:m]
                buf.copy_(src[off:off + m])
                dst[off:off + m].copy_(buf, non_blocking=True)
                self._events[i].record(self.stream)
                off += m

    def drain(self) -> None:
        """Until every copy enqueued so far is done (polled)."""
        if self.cuda:
            for ev in self._events:
                self._wait(ev)
