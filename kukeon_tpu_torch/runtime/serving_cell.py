"""Model-serving cell, the port of ``kukeon_tpu/runtime/serving_cell.py``.

An HTTP front end over the port's :class:`ServingEngine`:

  GET  /healthz, /v1/health -> liveness (200 while the process answers)
  GET  /readyz              -> readiness (503 warming up or draining)
  GET  /v1/stats            -> role, slots, queue, in-flight and token
                               counters, draining
  GET  /metrics             -> Prometheus text (format 0.0.4): the engine's
                               and the cell's families, SLO burn rates
  GET  /v1/trace            -> finished spans: ?n=K newest (default 50),
                               ?trace_id=, ?request_id= (400 on a bad int)
  GET  /v1/timeline         -> the flight recorder's newest ?n= step records
  GET  /v1/profile          -> the profiler spool's captures
  POST /v1/profile          -> {"durationMs": D}: a torch.profiler capture
                               in the background (409 while one runs);
                               {"layers": true, "prefillLen": P,
                               "decodeBatch": B}: the per-layer profile
  POST /drain               -> stop admitting, finish in-flight work, stop
                               the engine (then the process exits 0)
  POST /v1/kv/export        -> generate body in, KV handoff body out
  POST /v1/kv/import        -> KV handoff body in, the continuation out
  POST /v1/generate         -> {"promptTokens": [...] | "prompt": "text",
                                "maxNewTokens": N, "temperature": T,
                                "topK": K, "topP": P, "stopTokens": [...],
                                "stop": "s" | ["s", ...], "stream": bool,
                                "deadlineS": D, "prefixId": "session"}
                               => {"tokens": [...], "text": "...",
                                   "numTokens": n, "seconds": s,
                                   "ttftSeconds": t}

``"stream": true`` answers newline-delimited JSON instead: one
``{"token", "text"}`` record a token as the engine emits it (``text`` the
new characters), then a terminal record (``done``, ``tokens``, ``text``,
``numTokens``, ``seconds``, ``cancelled``, ``stopped``), or an in-band
``{"error", "timedOut"}`` record. ``stop`` strings are matched on the
decoded text: the first match cuts the text and cancels the request,
which frees its slot. A full queue answers 429 with ``Retry-After``
(also when a paged KV pool is exhausted on an idle engine); a request
the cell will not admit (warming up or draining) answers 503, on every
POST route but ``/drain``. ``prefixId`` names an
agent session: a prompt that extends the session's previous prompt
prefills only its new tail (the engine's prefix cache; ``/v1/stats``
reports ``prefixCache``). ``--kv-page-tokens N`` serves from the paged
KV cache (``/v1/stats`` ``kvPages``). Run it as
``python -m kukeon_tpu_torch.runtime.serving_cell --model llama3-8b
--dtype int8`` (or ``--model mixtral-8x7b``: the MoE family serves through
the same engine with ``models/moe.py``'s forward, and refuses
``--kv-cache-int8`` as the reference does).

**Disaggregated serving** (the reference's KV handoff): ``--role
prefill|decode|mixed`` is advertised on ``/v1/stats`` for a gateway's
two-stage router; it is policy, not capability (every role keeps the whole
engine). ``/v1/kv/export`` runs a prompt's prefill only and answers the
handoff wire format (:func:`pack_kv`: a JSON header line, then the raw K
rows, then the raw V rows, byte-compatible with the reference cell's);
``/v1/kv/import`` seats such a block in a decode slot and answers the
continuation, ndjson when the header says ``"stream"``. The handed-off
first token goes out before the request waits for a slot.

**Lifecycle** (the reference's ``LifecycleMixin``): warming up -> ready
-> draining -> drained. ``/drain`` (or SIGTERM under :func:`main`) stops
admission, waits for in-flight HTTP requests and engine requests (at most
``KUKEON_DRAIN_TIMEOUT_S``, default 30 s), stops the engine and fires
``on_drained``, which :func:`main` points at the server's shutdown.

**Observability** (the reference's, ``obs/``): one registry holds the
engine's and the cell's families (info, uptime, ready, draining, HTTP
in-flight, the watchdog's counters, cold-start phases) and the SLO
tracker's burn rates (``--slo-ttft-p95-ms``, ``--slo-availability``), so
the reference's daemon scrapes, autoscales and federates a port cell as a
JAX one. A ``traceparent`` header on ``/v1/generate`` (streamed too) and
``/v1/kv/export|import`` joins the request's span to the caller's trace.
``KUKEON_TRACE_SAMPLE`` sets the tail sampler's keep probability,
``KUKEON_PROFILE_DIR`` (and ``KUKEON_PROFILE_KEEP``) the profile spool,
``KUKEON_PEAK_FLOPS``/``KUKEON_PEAK_HBM_BPS`` the peaks the utilization
gauges divide by (read at boot). ``{"layers": true}`` on ``POST
/v1/profile`` runs :meth:`ServingCell.profile_layers` in the request: the
live model's per-layer profile, persisted under the tuning key
(``KUKEON_LAYER_PROFILE_PATH``) unless a component failed.

**Tuning** (the reference's serving tune): ``--decode-chunk``,
``--kv-cache-int8`` and ``--kv-page-tokens`` left out take the profile
stored for this model on this backend (``KUKEON_TUNE_PATH``, written by
``tools/autotune.py``), then the defaults; ``/v1/stats`` reports the
levers taken under ``tuning``.

**Watchdog** (the reference's ``EngineWatchdog``): under :func:`main`,
when work has waited ``KUKEON_WATCHDOG_S`` (default 120; 0 disables)
without engine progress, a throwaway process probes the CUDA runtime
(``runtime/devices.py``, killed after
``KUKEON_WATCHDOG_PROBE_TIMEOUT_S``); a ``wedged`` verdict turns the cell
unready and exits :data:`WEDGED_EXIT_CODE` (86) for the restart policy.

**Embedding cells** (the reference's ``EmbeddingCell``): ``--model
bge-base`` (or ``bge-tiny``) serves the BERT encoder behind ``POST
/v1/embed`` instead of ``/v1/generate``, with the same health, readiness,
drain, ``/metrics`` and ``/v1/timeline`` surfaces:

  POST /v1/embed            -> {"inputTokens": [[...], ...] | "inputs":
                                "text" | ["text", ...]}
                               => {"embeddings": [[...], ...], "dim": H,
                                   "numSequences": n, "seconds": s}

**Checkpoints** (the reference's ``_load_checkpoint``): ``--checkpoint
DIR`` serves real weights, the format chosen as the reference chooses it:
a kukeon int8 checkpoint (``kukeon_quant.json``) through
``checkpoints.stream_quantized``; an HF directory (``config.json`` and
safetensors) through ``hf_convert.stream_params_quantized`` under
``--dtype int8``, else ``hf_convert.stream_params``; for the MoE family
``hf_convert.load_moe_params`` (materialized, as in the reference),
quantized on the host under ``--dtype int8``; and an orbax checkpoint
(``_METADATA``, what the JAX package's ``StandardCheckpointer`` writes)
through the port's own reader, ``models/orbax_ckpt.py`` (materialized, as
in the reference: every leaf checked against the preset's shapes, placed
on the card, then quantized there under ``--dtype int8``). The config
comes from the checkpoint (from the preset for orbax), and a
``tokenizer.json`` beside the weights replaces the byte tokenizer.
Embedding cells take orbax checkpoints, as the reference's do. A stream
boots the engine with its weights to come: its reader threads and the
engine's load thread move the weights while
:meth:`ServingCell.warmup` captures the programs; a stream that fails
makes ``warmup`` exit (``SystemExit``), never ready; ``finish_boot`` adds
the load's ``disk``, ``cast`` and ``upload`` seconds to the boot phases.

**Tensor parallelism** (the reference's ``--chips N``, what its runner
always passes): ``--chips N`` serves one model (Llama, Mixtral, or the
embedding cell's BERT) over exactly N
devices, all on ``tensor`` (``parallel/mesh.py``), a grant above what the
host shows exiting before any weight is allocated; without the flag, every
visible GPU, laid out as the reference lays it out (``auto_mesh_shape``:
tensor up to 8, ``data`` replicas beyond, each a whole copy of the model
computing the same step; one rank on the CPU; :func:`cell_world`). This
process is rank 0, the leader: it owns
the HTTP server, the scheduler, the tokenizer, the prefix index and the
page allocator, and starts N - 1 followers (``python -m
kukeon_tpu_torch.parallel.launch``) on ``cuda:1..N-1``. Every rank runs
one weight recipe (:func:`_mesh_recipe`) and the followers apply the
leader's device actions (``serving/engine.py``):

- random weights: :func:`rank_leaves` draws the one-device cell's leaves
  from the seed, and each rank keeps its slice of each as it comes;
- a Llama kukeon int8 or HF ``--checkpoint``: :func:`rank_stream`, each
  rank streaming only its blocks of each leaf from disk (a column block
  read as whole rows in staging blocks; an int8 row-parallel scale from
  the whole rows) into its engine while its programs capture, as the
  one-device cell streams the whole;
- a Llama orbax checkpoint or an HF Mixtral directory:
  :func:`rank_slices`, each rank decoding only the zarr chunks its blocks
  overlap (a one-chunk array whole, once, one leaf at a time), or reading
  each expert matrix's rows or columns, quantized on its device under
  int8; the embedding cell's orbax checkpoint likewise
  (:func:`embedding_slices`).

No rank holds a full leaf of a checkpoint on its host (but a one-chunk
orbax array), and the cell turns ready only once every rank has loaded;
a rank whose read fails ends the group, named. A follower that dies ends
the cell (exit 1 under :func:`main`): it never serves on fewer devices.
``/v1/stats`` ``mesh`` reports ``chips``, ``shape`` and ``kvSharded``;
``/metrics`` carries every rank's ``kukeon_hbm_bytes_*{device=}``, and
``kukeon_checkpoint_load_bytes_total`` the full tree's leaf bytes. The
embedding cell's leader posts each grid to the followers and alone pools.
A vocabulary the tensor size does not divide is padded (bge-base's 30522
at 4), and so are heads it does not divide (whole zero heads); a tensor
size the reference's shardings cannot cut (the attention, kv or
intermediate width) exits at boot. ``/v1/profile {"layers": true}`` runs
on every rank of the group, keyed by the mesh's size.
"""

from __future__ import annotations

import argparse
import dataclasses
import itertools
import json
import math
import os
import queue
import signal
import sys
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlsplit

import numpy as np
import torch

from kukeon_tpu_torch import faults
from kukeon_tpu_torch.device import resolve_device
from kukeon_tpu_torch.models import (
    bert,
    checkpoints,
    convert,
    hf_convert,
    llama,
    moe,
    orbax_ckpt,
)
from kukeon_tpu_torch.obs import (
    FlightRecorder,
    ProfileBusy,
    ProfileSpool,
    Registry,
    SloObjectives,
    SloTracker,
    device_memory_collector,
    expo,
    faults_collector,
)
from kukeon_tpu_torch.obs import profile as obs_profile
from kukeon_tpu_torch.parallel import launch
from kukeon_tpu_torch.parallel.mesh import (
    auto_mesh_shape,
    check_grant,
    make_mesh,
    visible_devices,
)
from kukeon_tpu_torch.parallel.sharding import Layout, Recipe, check_tensor_parallel
from kukeon_tpu_torch.obs import trace as obs_trace
from kukeon_tpu_torch.runtime.devices import probe_cuda_runtime
from kukeon_tpu_torch.serving.embedding import EmbeddingEngine
from kukeon_tpu_torch.serving.engine import (
    DeadlineExceeded,
    RejectedError,
    ServingEngine,
)
from kukeon_tpu_torch.serving import tuning
from kukeon_tpu_torch.serving.sampling import SamplingParams
from kukeon_tpu_torch.serving.tokenizer import load_tokenizer

MODELS = {
    "tiny": llama.llama_tiny,
    "llama3-1b": llama.llama3_1b,
    "llama3-8b": llama.llama3_8b,
    "mixtral-tiny": moe.moe_tiny,
    "mixtral-8x7b": moe.mixtral_8x7b,
}
MOE_MODELS = {"mixtral-tiny", "mixtral-8x7b"}
EMBEDDING_MODELS = {
    "bge-base": bert.bge_base,
    "bge-tiny": bert.bge_tiny,
}
ROLES = ("mixed", "prefill", "decode")
DRAIN_TIMEOUT_ENV = "KUKEON_DRAIN_TIMEOUT_S"
WATCHDOG_ENV = "KUKEON_WATCHDOG_S"
WATCHDOG_PROBE_TIMEOUT_ENV = "KUKEON_WATCHDOG_PROBE_TIMEOUT_S"
# The exit of a cell whose CUDA runtime the watchdog found wedged: nonzero,
# so a restart policy restarts it, and the reference's code, so an operator
# greps one number for both packages.
WEDGED_EXIT_CODE = 86

# Module import: the zero point of the cold-start breakdown finish_boot
# exports (``python -m`` imports it at process start).
_PROC_T0 = time.monotonic()


class LifecycleMixin:
    """Readiness, drain and the cell's observability families, the port of
    the reference's ``LifecycleMixin`` (``kukeon_tpu/runtime/serving_cell.py:92-260``)
    with plain ``threading`` (the reference's ``sanitize`` proxies aside);
    both cell flavours share it.

    States: warming up (unready) -> ready -> draining (unready, in-flight
    finishing) -> drained. The HTTP handler enforces admission. Locks:
    ``_drain_lock`` makes ``draining`` flip once; ``_inflight_lock`` guards
    the HTTP in-flight count, and its condition wakes the drain loop when
    the count reaches 0. They never nest."""

    def _init_lifecycle(self):
        self._ready = threading.Event()
        self.unready_reason: str | None = "warming up"
        self.draining = False       # guarded-by: _drain_lock
        self._drain_lock = threading.Lock()
        self.drained = threading.Event()
        self._inflight = 0          # guarded-by: _inflight_lock
        self._inflight_lock = threading.Lock()
        self._inflight_zero = threading.Condition(self._inflight_lock)
        # main() points this at the server's shutdown, so a finished drain
        # ends serve_forever and the process exits 0.
        self.on_drained = None

    def mark_ready(self):
        self.unready_reason = None
        self._ready.set()

    def mark_unready(self, reason: str):
        self.unready_reason = reason
        self._ready.clear()

    def readiness(self) -> tuple[bool, str | None]:
        if self.draining:
            return False, "draining"
        if not self._ready.is_set():
            return False, self.unready_reason or "not ready"
        return True, None

    def check_admission(self):
        """Raise RejectedError while the cell must not take new requests
        (warming up, draining). Queue-full shedding is the engine's."""
        ok, why = self.readiness()
        if not ok:
            raise RejectedError(f"not admitting requests: {why}", retry_after_s=5.0)

    def _inflight_inc(self):
        with self._inflight_lock:
            self._inflight += 1

    def _inflight_dec(self):
        with self._inflight_lock:
            self._inflight -= 1
            if self._inflight == 0:
                self._inflight_zero.notify_all()

    def _idle(self) -> bool:
        """No in-flight HTTP requests (subclasses add engine occupancy)."""
        with self._inflight_lock:
            return self._inflight == 0

    def begin_drain(self) -> bool:
        """Stop admitting, finish in-flight work, then report drained (and
        fire ``on_drained``). Idempotent: False if a drain already ran."""
        with self._drain_lock:
            if self.draining:
                return False
            self.draining = True
        self.mark_unready("draining")
        threading.Thread(target=self._drain_loop, daemon=True, name="cell-drain").start()
        return True

    def _drain_loop(self):
        timeout = float(os.environ.get(DRAIN_TIMEOUT_ENV, "30") or 30)
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline and not self._idle():
            # The last HTTP request's _inflight_dec wakes this at once; the
            # bounded wait also polls the engine's half of _idle().
            with self._inflight_zero:
                self._inflight_zero.wait(timeout=0.05)
        self._shutdown_engine()
        self.drained.set()
        if self.on_drained is not None:
            self.on_drained()

    def _shutdown_engine(self):
        pass

    def _init_cell_obs(self, registry: Registry, kind: str, device: torch.device,
                       engine: ServingEngine | None = None, peers=None) -> None:
        """The cell's families on the one registry ``GET /metrics`` renders
        (the reference's ``_init_cell_obs``, shared by both cell flavours):
        identity, uptime, readiness, drain and HTTP in-flight gauges
        (scrape-time callables), the watchdog's counters declared at zero,
        the profiler spool, and the flight recorder. A decoder cell passes
        its ``engine``: the recorder is the engine's ring, the spool holds
        the engine's capture lock, and the engine has registered the fault
        and device-memory collectors. Without one (the embedding cell) the
        cell registers those, with its followers' memory counters
        (``peers``) beside its own, and keeps a ring of its own."""
        self.registry = registry
        registry.gauge("kukeon_cell_info", "Static cell identity (value always 1).",
                       labels=("model", "kind")).set(1, model=self.model_name, kind=kind)
        registry.gauge("kukeon_cell_uptime_seconds",
                       "Seconds since cell construction.").set_function(
            lambda: time.time() - self.started_at)
        registry.gauge("kukeon_cell_ready",
                       "1 while admitting requests (readyz).").set_function(
            lambda: 1.0 if self.readiness()[0] else 0.0)
        registry.gauge("kukeon_cell_draining",
                       "1 while a drain is in progress.").set_function(
            lambda: 1.0 if self.draining else 0.0)
        registry.gauge("kukeon_cell_http_inflight",
                       "HTTP requests currently being served.").set_function(
            lambda: float(self._inflight))
        registry.counter("kukeon_watchdog_probes_total",
                         "CUDA runtime probes fired after an engine stall.",
                         labels=("verdict",))
        registry.counter("kukeon_watchdog_trips_total",
                         "Wedged verdicts (the cell exits for restart right after).")
        cuda = device.type == "cuda"
        if engine is not None:
            self.profiler = ProfileSpool(registry=registry, cuda=cuda,
                                         guard=engine._programs.capture_lock)
            self.recorder = engine.recorder
        else:
            registry.register_collector(faults_collector)
            registry.register_collector(device_memory_collector(device, peers=peers))
            self.profiler = ProfileSpool(registry=registry, cuda=cuda)
            self.recorder = FlightRecorder(registry=registry)


class ServingCell(LifecycleMixin):
    """One model behind one engine. ``dtype="int8"`` serves per-channel
    int8 weights (random, drawn on the device from ``seed``, or quantized
    from ``checkpoint``); another dtype name (``"bfloat16"``,
    ``"float32"``) sets the weight and activation dtype. ``checkpoint``: a
    kukeon int8 or HF directory (:meth:`_load_checkpoint`) whose weights
    and config replace the preset's. ``role``: ``mixed``, ``prefill`` or
    ``decode``, what a gateway routes on (every role keeps the whole
    engine: a prefill cell can decode locally, a decode cell re-prefill a
    preempted import). ``decode_chunk``, ``kv_cache_int8`` and
    ``kv_page_tokens`` left ``None`` take the tuning profile of ``model``
    on this backend, then the engine's defaults. ``chips``: the grant,
    exactly that many devices over a rank group (the module docstring's
    tensor parallelism); ``None``: every visible GPU, one device on the
    CPU, the one-device code when that is one (:func:`cell_world`)."""

    def __init__(self, model: str, *, num_slots: int = 8,
                 max_seq_len: int | None = None, dtype: str | None = None,
                 checkpoint: str | None = None,
                 seed: int = 0, kv_cache_int8: bool | None = None,
                 decode_chunk: int | None = None, max_pending: int | None = None,
                 deadline_s: float | None = None,
                 device: str | torch.device | None = None,
                 kv_page_tokens: int | None = None, role: str = "mixed",
                 slo_ttft_p95_ms: float | None = None,
                 slo_availability: float | None = None,
                 chips: int | None = None):
        self._boot_marks: dict[str, float] = {"init_entry": time.monotonic()}
        # A materialized (orbax) load's bytes and seconds; empty otherwise.
        self.checkpoint_load: dict = {}
        if model not in MODELS:
            raise SystemExit(f"unknown model {model!r}; known: {sorted(MODELS)}")
        if role not in ROLES:
            raise SystemExit(f"unknown --role {role!r}; must be mixed|prefill|decode")
        self.role = role
        self.device = resolve_device(device)
        quantize = dtype == "int8"
        cfg = _preset_cfg(model, dtype, max_seq_len)
        world = cell_world(model, chips, self.device.type)
        mesh = None
        if model in MOE_MODELS and kv_cache_int8:
            # The MoE decode ignores int8-KV scales (as the reference's):
            # refuse the flag rather than serve garbage.
            raise SystemExit(f"model {model!r} does not support --kv-cache-int8 yet")
        if world is not None:
            # The grant's group, refused before a weight is allocated or a
            # rank started.
            if checkpoint:
                cfg = self._checkpoint_cfg(checkpoint, cfg)
            check_tensor_parallel(cfg, world["tensor"])
            mesh = make_mesh(**world, device=self.device.type)
            self.device = mesh.device
        gen = torch.Generator(device=self.device)
        gen.manual_seed(seed)
        forward_fn = None
        if model in MOE_MODELS:
            # Pinned, so a tuning profile cannot turn it on behind the guard.
            kv_cache_int8 = False
            forward_fn = moe.forward
        if mesh is not None:
            # Every rank (this one inside the engine) runs one recipe: the
            # draws, each full leaf cut as it comes; a checkpoint, each
            # rank reading only its blocks (streamed from a kukeon int8 or
            # HF directory, as the one-device cell streams them).
            params = _mesh_recipe(model, dtype, checkpoint, seed, max_seq_len)
            if params.reads == "slices":
                self.checkpoint_load = _slices_load(cfg, model)
        elif model in MOE_MODELS and checkpoint:
            params, cfg = hf_convert.load_moe_params(checkpoint, dtype=cfg.dtype)
            if quantize:
                # On the host, before the engine moves the tree: a
                # Mixtral-8x7B bf16 tree would not fit on the card.
                params = moe.quantize_params(params)
        elif model in MOE_MODELS:
            params = (convert.init_quantized_moe_params_device(cfg, gen, self.device)
                      if quantize else moe.init_params(cfg, gen, self.device))
        elif checkpoint:
            params, cfg = self._load_checkpoint(checkpoint, cfg, quantize, device=self.device,
                                                stats=self.checkpoint_load)
        else:
            params = _drawn_params(cfg, quantize, gen)
        if model in MOE_MODELS and checkpoint and max_seq_len:
            cfg = dataclasses.replace(cfg, max_seq_len=max_seq_len)
        self.model_name = model
        self.cfg = cfg
        # One registry for the whole cell: the engine's families and the
        # cell's land in one /metrics. A checkpoint stream loads on the
        # engine's load thread while warmup() captures.
        registry = Registry()
        self.engine = ServingEngine(
            cfg, params, num_slots=num_slots,
            max_seq_len=max_seq_len or min(cfg.max_seq_len, 4096),
            kv_cache_int8=kv_cache_int8, decode_chunk=decode_chunk,
            max_pending=max_pending, seed=seed, device=self.device,
            forward_fn=forward_fn, kv_page_tokens=kv_page_tokens, registry=registry,
            model_name=model, mesh=mesh)
        del params
        if mesh is not None and self.checkpoint_load:
            self.checkpoint_load["upload_s"] = time.monotonic() - self._boot_marks["init_entry"]
        if self.checkpoint_load:
            # The materialized load moved its leaves host->device before
            # the engine: kukeon_checkpoint_load_* count them as a stream's.
            self.engine.load_stats.update(bytes=self.checkpoint_load["leaf_bytes"],
                                          upload_s=self.checkpoint_load["upload_s"],
                                          tensors=self.checkpoint_load["leaves"])
        self.tokenizer = load_tokenizer(checkpoint)
        self.default_deadline_s = deadline_s
        self.started_at = time.time()
        self.boot_s: dict[str, float] = {}
        self._init_lifecycle()
        self._init_cell_obs(registry, "decoder", self.device, self.engine)
        # Burn rates and error budget from the engine's own requests counter
        # and TTFT histogram, at scrape time; unset objectives take the
        # reference's loose defaults.
        d = SloObjectives()
        self.slo = SloTracker(registry, SloObjectives(
            availability=slo_availability or d.availability,
            ttft_p95_ms=slo_ttft_p95_ms or d.ttft_p95_ms))
        self._boot_marks["init_exit"] = time.monotonic()

    @staticmethod
    def _load_checkpoint(path: str, cfg, quantize: bool = False, *,
                         device: torch.device | str = "cpu", stats: dict | None = None):
        """(a checkpoint stream or a tree on ``device``, its cfg) of a Llama
        checkpoint (the reference's ``:556-595``), in its order of
        precedence:

        - a kukeon int8 checkpoint (the ``kukeon_quant.json`` manifest):
          :func:`checkpoints.stream_quantized`, the config and the abstract
          tree from the manifest and the header alone;
        - an HF directory (``config.json`` and safetensors): the same
          pipeline, quantized on the host one leaf at a time when
          ``quantize`` (:func:`hf_convert.stream_params_quantized`), so the
          full-precision tree is never materialized;
        - an orbax checkpoint: read whole on the host, each leaf checked
          against ``cfg``'s shapes (a mismatch exits naming the leaf), cast
          to ``cfg.dtype``, placed on ``device``, then quantized there when
          ``quantize``; ``stats`` (when given) gets the load's bytes and
          seconds (:func:`orbax_ckpt.load_params`).

        Anything else exits. ``cfg`` gives the activation dtype; for the
        first two the rest of the config comes from the checkpoint, and the
        stream returns before any tensor byte is read."""
        kind = _checkpoint_kind(path)
        if kind == "int8":
            stream = checkpoints.stream_quantized(path, dtype=cfg.dtype)
        elif kind == "hf":
            stream = (hf_convert.stream_params_quantized(path, dtype=cfg.dtype) if quantize
                      else hf_convert.stream_params(path, dtype=cfg.dtype))
        else:
            try:
                params, load = orbax_ckpt.load_params(
                    path, llama.init_params(cfg, None, "meta"), cfg.dtype, device)
            except orbax_ckpt.CheckpointError as e:
                raise SystemExit(str(e)) from e
            if stats is not None:
                stats.update(load)
            if quantize:
                t0 = time.monotonic()
                params = llama.quantize_params(params)
                if stats is not None:
                    stats["quantize_s"] = _synced_seconds(device, t0)
            return params, cfg
        return stream, stream.cfg

    @staticmethod
    def _checkpoint_cfg(path: str, cfg):
        """The config :meth:`_load_checkpoint` gives for ``path``, from the
        kukeon manifest or the HF ``config.json`` alone (no tensor byte
        read, no reader started): what a tensor-parallel cell checks its
        grant against before any rank starts."""
        if isinstance(cfg, moe.MoEConfig):
            # Mixtral reads HF directories only (load_moe_params).
            return dataclasses.replace(hf_convert.moe_config_from_hf(path), dtype=cfg.dtype)
        kind = _checkpoint_kind(path)
        if kind == "int8":
            return checkpoints.quantized_config(path, cfg.dtype)
        if kind == "hf":
            return dataclasses.replace(hf_convert.config_from_hf(path), dtype=cfg.dtype)
        return cfg

    def warmup(self, prompt_len: int = 64):
        """Capture the decode programs and the prefill of ``prompt_len``'s
        bucket (``engine.precompile``; a prefill cell also its export
        program, a decode cell its insert-only one), then run one request
        through them, as the reference cell does; ``/readyz`` turns 200
        only at :meth:`mark_ready`, after both. The captures need only the
        weights' shapes, so they overlap a streamed load; the request waits
        for it. A stream that failed exits (``SystemExit``, which no
        ``except Exception`` swallows), so a half-loaded engine never
        turns ready."""
        t0 = time.monotonic()
        self.engine.precompile((prompt_len,), export=self.role == "prefill",
                               imports=self.role == "decode")
        t1 = time.monotonic()
        self._boot_marks.setdefault("compile_done", t1)
        try:
            self.engine.warmup(prompt_len)
        except RuntimeError as e:
            if isinstance(e.__cause__, checkpoints.CheckpointStreamError):
                raise SystemExit(
                    f"serving-cell: checkpoint stream failed during boot ({e.__cause__}); "
                    "exiting for the restart policy to recover") from e
            raise
        t2 = time.monotonic()
        self._boot_marks.setdefault("warmup_done", t2)
        self.boot_s["precompile"] = round(t1 - t0, 3)
        self.boot_s["warmup"] = round(t2 - t1, 3)

    def finish_boot(self) -> dict[str, float]:
        """Close the cold-start record (the reference's ``finish_boot``):
        the boot phases (imports, init, compile, warmup, serve; the first
        two measured from this module's import) on
        ``kukeon_cold_start_seconds`` and
        ``kukeon_cold_start_phase_seconds{phase=}``, and a
        ``component="boot"`` span in the trace ring. Called once, right
        before the cell goes ready."""
        now = time.monotonic()
        m = self._boot_marks
        phases: dict[str, float] = {
            "imports": m["init_entry"] - _PROC_T0,
            "init": m.get("init_exit", m["init_entry"]) - m["init_entry"],
        }
        if "compile_done" in m:
            phases["compile"] = m["compile_done"] - m.get("init_exit", m["init_entry"])
            phases["warmup"] = m.get("warmup_done", m["compile_done"]) - m["compile_done"]
        total = now - _PROC_T0
        phases["serve"] = max(0.0, total - sum(phases.values()))
        # A streamed boot's load stages, on top of the serial partition
        # above: they ran inside its init, compile and warmup, so with them
        # the phases sum past the total, by the overlap the stream bought.
        eng = self.engine
        cs = eng._ckpt_stream.stat_snapshot() if eng._ckpt_stream is not None else {}
        load = {"disk": cs.get("disk_s", 0.0), "cast": cs.get("cast_s", 0.0),
                "upload": eng.load_stats["upload_s"]}
        if any(load.values()):
            phases.update(load)
        reg = self.registry
        reg.gauge("kukeon_cold_start_seconds",
                  "Process start -> ready wall time (the rolling-restart and "
                  "autoscaling latency floor).").set(total)
        g = reg.gauge("kukeon_cold_start_phase_seconds",
                      "Cold-start breakdown by boot phase.", labels=("phase",))
        for phase, dt in phases.items():
            g.set(dt, phase=phase)
        # Each event marks where its phase begins, so the span's phases
        # mirror the gauges; the tail gap covers warmup and serve.
        span = self.engine.tracer.begin(-2, 0, component="boot", start_mono=_PROC_T0)
        span.event("boot_imports", at=_PROC_T0)
        span.event("boot_init", at=m["init_entry"])
        if "compile_done" in m:
            span.event("boot_compile", at=m.get("init_exit", m["init_entry"]))
            span.event("boot_warmup", at=m["compile_done"])
        self.engine.tracer.finish(span, "ok")
        return phases

    def profile_layers(self, prefill_len: int | None = None,
                       decode_batch: int | None = None) -> dict:
        """The live model's per-layer profile (``obs/profile.py``
        ``profile_layers``, the reference's ``:1051-1075``), persisted beside
        the serving tune under the same ``model|backend|N`` key, N the
        mesh's size. On a rank group every rank runs each component with
        its local weights and collectives, and the leader times and
        reports (``engine.profile_layers``: on the engine's thread, between
        two steps). An armed ``profile.layers`` fault, a MoE tree's layers or
        a component that fails on one device come back as ``error`` entries
        (and the profile is not persisted). On a group of more than one
        rank a component that fails as it runs ends the group, as any
        device action does: its ranks are out of step in its collectives.
        The engine's capture lock is held
        throughout, so no engine capture runs beside the profile's."""
        eng = self.engine
        prof = eng.profile_layers(prefill_len=prefill_len or min(64, eng.max_seq_len - 1),
                                  decode_batch=decode_batch or eng.num_slots)
        key_args = (self.model_name, tuning.backend_name(eng.device), eng.world)
        prof["key"] = tuning.profile_key(*key_args)
        if not prof.get("errors"):
            prof["path"] = tuning.save_layer_profile(*key_args, prof)
        return prof

    def _parse_generate(self, req: dict):
        if "promptTokens" in req:
            prompt = np.asarray(req["promptTokens"], np.int32)
        elif "prompt" in req:
            prompt = np.asarray(self.tokenizer.encode(req["prompt"]), np.int32)
        else:
            raise ValueError("need promptTokens or prompt")
        stops = req.get("stop", [])
        if isinstance(stops, str):
            stops = [stops]
        if not isinstance(stops, list) or not all(isinstance(x, str) and x for x in stops):
            raise ValueError("stop must be a non-empty string or list of them")
        sp = SamplingParams(
            temperature=float(req.get("temperature", 0.0)),
            top_k=int(req.get("topK", 0)),
            top_p=float(req.get("topP", 1.0)),
            max_new_tokens=int(req.get("maxNewTokens", 128)),
            stop_tokens=tuple(int(t) for t in req.get("stopTokens", [])),
        )
        prefix_id = req.get("prefixId")
        if prefix_id is not None and not isinstance(prefix_id, str):
            raise ValueError("prefixId must be a string")
        deadline_s = req.get("deadlineS", self.default_deadline_s)
        if deadline_s is not None:
            deadline_s = float(deadline_s)
            if deadline_s <= 0:
                raise ValueError("deadlineS must be positive")
        return prompt, sp, list(stops), prefix_id, deadline_s

    def _submit(self, req: dict, trace_ctx=None):
        """Parse and submit one generate body -> (request, its event queue,
        stop strings, submit time). ``trace_ctx``: a parsed
        ``traceparent``, the trace the request's span joins."""
        prompt, sp, stops, prefix_id, deadline_s = self._parse_generate(req)
        events: queue.Queue = queue.Queue()
        t0 = time.monotonic()
        r = self.engine.submit(prompt, sp, emit=lambda tok, done: events.put((tok, done)),
                               prefix_id=prefix_id, deadline_s=deadline_s,
                               trace_ctx=trace_ctx)
        return r, events, stops, t0

    def generate(self, req: dict, trace_ctx=None) -> dict:
        """Non-streaming generation: the terminal record of the stream (one
        machinery for both modes, stop strings included), plus the time to
        the first token."""
        r, events, stops, t0 = self._submit(req, trace_ctx)
        out = None
        for out in self._stream_events(r, events, stops, t0):
            pass
        if out.get("timedOut"):
            raise DeadlineExceeded(out["error"])
        if "error" in out:
            if isinstance(r.error, RejectedError):
                raise r.error
            raise RuntimeError(out["error"])
        return {**{k: out[k] for k in ("tokens", "text", "numTokens", "seconds")},
                "ttftSeconds": round(r.first_token_at - r.submitted_at, 4)}

    def generate_stream(self, req: dict, trace_ctx=None):
        """Streaming generation: one record a token as the engine emits it,
        then the terminal record (``_stream_events``)."""
        r, events, stops, t0 = self._submit(req, trace_ctx)
        yield from self._stream_events(r, events, stops, t0)

    def _stream_events(self, r, events: queue.Queue, stops: list[str], t0: float, *,
                       tokens: list[int] | None = None, emitted: str = "",
                       skip_first: bool = False):
        """Drain the engine's emit events for ``r``: decode by prefix diff,
        hold back a trailing U+FFFD, match stop strings (the first match
        cuts the text and cancels the request), then yield the terminal
        record, or an in-band error record. ``tokens``/``emitted`` may come
        seeded (an import sent its handed-off first token before it was
        seated); ``skip_first`` drops the engine's re-emit of that token
        and keeps only its terminal flag."""
        driving = not self.engine.running        # no driver thread: drive here
        tokens = [] if tokens is None else tokens
        stopped = False
        while True:
            if driving:
                while events.empty() and not r.done.is_set():
                    self.engine.step()
            tok, done = events.get()
            if skip_first:
                skip_first = False
                if not done:
                    continue
                tok = -1
            if tok >= 0 and not stopped:
                tokens.append(tok)
                # Decoding ids one at a time breaks multi-token characters,
                # so decode them all and send what the previous decode lacked.
                full = self.tokenizer.decode(tokens)
                hit = min((full.find(x) for x in stops if x in full), default=-1)
                if hit >= 0:
                    full = full[:hit]
                    stopped = True
                    r.cancel()
                out = full
                if not (done or stopped):
                    # A character split across tokens decodes to U+FFFD until
                    # its last byte arrives: hold those back, so sent text
                    # never needs taking back.
                    out = full[:len(full) - _trailing_fffd(full)]
                if out.startswith(emitted):
                    delta = out[len(emitted):]
                else:
                    # A tokenizer that rewrites earlier text: resend from
                    # the first character that differs.
                    n = min(len(out), len(emitted))
                    i = next((j for j in range(n) if out[j] != emitted[j]), n)
                    delta = out[i:]
                emitted = out
                if delta or not stopped:
                    yield {"token": tok, "text": delta}
            if done:
                break
        if r.timed_out:
            yield {"error": f"deadline exceeded: {r.error}", "timedOut": True,
                   "numTokens": len(tokens)}
            return
        if r.error is not None:
            yield {"error": f"{type(r.error).__name__}: {r.error}"}
            return
        yield {
            "done": True,
            "tokens": tokens,
            "text": emitted if stops else self.tokenizer.decode(tokens),
            "numTokens": len(tokens),
            "seconds": round(time.monotonic() - t0, 4),
            "cancelled": bool(r.cancelled) and not stopped,
            "stopped": stopped,
        }

    # --- disaggregated serving: KV handoff --------------------------------

    def kv_export(self, req: dict, trace_ctx=None) -> bytes:
        """``POST /v1/kv/export`` (the reference's ``kv_export``,
        ``:834-891``): the prompt's prefill only, no decode slot taken; the
        KV block in the handoff wire format, its header carrying the first
        token and its text (cut at a stop string), ``done`` (the first
        token ends the request: eos, a stop token or string, or a one-token
        budget) and all a decode cell needs to seat the request."""
        prompt, sp, stops, prefix_id, deadline_s = self._parse_generate(req)
        events: queue.Queue = queue.Queue()
        r = self.engine.submit(prompt, sp, emit=lambda tok, done: events.put((tok, done)),
                               prefix_id=prefix_id, deadline_s=deadline_s,
                               trace_ctx=trace_ctx, export=True)
        if not self.engine.running:              # no driver thread: drive here
            while not r.done.is_set():
                self.engine.step()
        r.done.wait()
        if r.timed_out:
            raise DeadlineExceeded(str(r.error))
        if r.error is not None:
            if isinstance(r.error, RejectedError):
                raise r.error
            raise RuntimeError(f"{type(r.error).__name__}: {r.error}")
        p = r.export_payload
        first = int(p["token"])
        first_text = self.tokenizer.decode([first])
        hit = min((first_text.find(x) for x in stops if x in first_text), default=-1)
        done = (hit >= 0 or first in self.engine.eos_ids or first in sp.stop_tokens
                or sp.max_new_tokens <= 1)
        header = {
            "token": first,
            "text": first_text[:hit] if hit >= 0 else first_text,
            "length": int(p["length"]),
            "pageTokens": int(p["pageTokens"]),
            "model": self.model_name,
            "done": done,
            "promptTokens": [int(t) for t in prompt],
            "maxNewTokens": sp.max_new_tokens,
            "temperature": sp.temperature,
            "topK": sp.top_k,
            "topP": sp.top_p,
            "stopTokens": list(sp.stop_tokens),
            "stop": stops,
            **({"prefixId": prefix_id} if prefix_id else {}),
            **({"deadlineS": deadline_s} if deadline_s else {}),
        }
        return pack_kv(header, p["k"], p["v"])

    def kv_import_stream(self, header: dict, k: torch.Tensor, v: torch.Tensor,
                         trace_ctx=None):
        """``POST /v1/kv/import`` (the reference's ``kv_import_stream``,
        ``:893-957``): seat an exported block in this cell's decode batch
        and stream the continuation. The handed-off first token goes out
        before the request waits for a slot, so the client's first token
        costs the prefill and the transfer, not the seat's queueing; the
        engine's re-emit of it at seat time is dropped (``skip_first``).
        The request is submitted before the first yield, so a full queue
        still answers a clean 429."""
        faults.maybe_fail("kv.handoff")
        prompt, sp, stops, prefix_id, deadline_s = self._parse_generate(header)
        try:
            first, n = int(header["token"]), int(header["length"])
        except (KeyError, TypeError, ValueError) as e:
            raise ValueError(f"KV header needs integer token and length: {e}") from e
        t0 = time.monotonic()
        tokens = [first]
        full = self.tokenizer.decode(tokens)
        hit = min((full.find(x) for x in stops if x in full), default=-1)
        stopped = hit >= 0
        if stopped:
            full = full[:hit]
        done_now = (stopped or first in self.engine.eos_ids or first in sp.stop_tokens
                    or sp.max_new_tokens <= 1)
        emitted = full if done_now else full[:len(full) - _trailing_fffd(full)]
        if done_now:
            yield {"token": first, "text": emitted}
            yield {"done": True, "tokens": tokens, "text": emitted if stops else full,
                   "numTokens": 1, "seconds": round(time.monotonic() - t0, 4),
                   "cancelled": False, "stopped": stopped}
            return
        events: queue.Queue = queue.Queue()
        r = self.engine.submit(prompt, sp, emit=lambda tok, done: events.put((tok, done)),
                               prefix_id=prefix_id, deadline_s=deadline_s,
                               trace_ctx=trace_ctx,
                               kv_import={"token": first, "length": n, "k": k, "v": v})
        yield {"token": first, "text": emitted}
        yield from self._stream_events(r, events, stops, t0, tokens=tokens, emitted=emitted,
                                       skip_first=True)

    def kv_import(self, header: dict, k: torch.Tensor, v: torch.Tensor,
                  trace_ctx=None) -> dict:
        """The non-streamed import: the stream's terminal record."""
        out = None
        for out in self.kv_import_stream(header, k, v, trace_ctx):
            pass
        if out.get("timedOut"):
            raise DeadlineExceeded(out["error"])
        if "error" in out:
            raise RuntimeError(out["error"])
        return {key: out[key] for key in ("tokens", "text", "numTokens", "seconds")}

    # --- lifecycle hooks ---------------------------------------------------

    def _idle(self) -> bool:
        # The engine's unfinished requests: queued, seated and mid-dispatch.
        return super()._idle() and not self.engine._requests

    def _shutdown_engine(self):
        self.engine.stop()

    def stats(self) -> dict:
        """The JSON view; uptime and generated tokens read the registry's
        instruments, as the reference's do (one source of truth, two
        presentations)."""
        eng = self.engine
        reg = self.registry
        ready, why = self.readiness()
        return {
            "model": self.model_name,
            # What a gateway's two-stage router builds its pools from.
            "role": self.role,
            "device": (torch.cuda.get_device_name(self.device)
                       if self.device.type == "cuda" else "cpu"),
            "numSlots": eng.num_slots,
            "freeSlots": len(eng._free_slots()),
            "queueDepth": eng.queue_depth,
            # Unfinished engine requests (queued, seated, mid-dispatch):
            # what shows a drain going idle.
            "inflight": len(eng._requests),
            "maxPending": eng.max_pending,
            "generatedTokens": int(eng.registry.get("kukeon_engine_tokens_total").value()),
            "rejected": eng.shed_stats["rejected"],
            "timedOut": eng.shed_stats["timed_out"],
            "int8Kernel": eng.cfg.int8_pallas,
            "kvCacheInt8": eng.kv_cache_int8,
            "decodeChunk": eng.decode_chunk,
            # The levers the engine took, and whether a tuning profile gave
            # any (the reference's block).
            "tuning": {"decodeChunk": eng.decode_chunk, "kvCacheInt8": eng.kv_cache_int8,
                       "kvPageTokens": eng.page_tokens, "fromProfile": eng.tune is not None},
            "decodePrograms": _program_counters(eng.program_stats),
            "prefillPrograms": {**_program_counters(eng.program_stats["prefill"]),
                                "staticBytes": eng.program_stats["prefill"]["static_bytes"]},
            "prefixCache": {"hits": eng.prefix_hits, "misses": eng.prefix_misses,
                            "entries": len(eng._prefix_cache)},
            "kvPageTokens": eng.page_tokens,
            # Paged KV pool occupancy (0 on the legacy layout).
            "kvPages": {"total": eng.kv_pool_pages,
                        "inUse": eng._pool.in_use if eng._pool is not None else 0,
                        "preemptions": eng.preemptions,
                        "shedKvExhausted": eng.shed_stats["kv_exhausted"],
                        "viewBytes": eng.program_stats["view_bytes"]},
            # The serving mesh (the reference's keys): devices, the axes
            # above 1, and whether the KV cache is sharded over them.
            "mesh": {"chips": eng.world, "shape": _mesh_shape(eng.mesh),
                     "kvSharded": eng.kv_sharded},
            "bootSeconds": self.boot_s,
            "uptimeSeconds": round(reg.get("kukeon_cell_uptime_seconds").value(), 1),
            "ready": ready,
            "draining": self.draining,
            **({"unreadyReason": why} if why else {}),
        }


def _mesh_shape(mesh) -> dict[str, int]:
    """``/v1/stats``' mesh ``shape``: the axes above 1 (the reference's)."""
    if mesh is None:
        return {}
    return {k: mesh.shape[k] for k in ("data", "tensor") if mesh.shape[k] > 1}


def grant(chips: int | None, device_type: str) -> dict[str, int]:
    """The layout a cell serves on (the reference's ``:440-454``), as
    ``{"data": d, "tensor": t}``: exactly ``chips`` ranks, all on
    ``tensor`` (more than the host shows exits naming the flag); without
    the flag every visible GPU laid out by the reference's
    ``auto_mesh_shape`` (tensor up to 8, data beyond), one rank on the
    CPU."""
    if chips is not None:
        try:
            return {"data": 1, "tensor": check_grant(chips, device_type)}
        except ValueError as e:
            raise SystemExit(f"--chips {chips}: {e}") from e
    n = max(visible_devices("cuda"), 1) if device_type == "cuda" else 1
    return auto_mesh_shape(n)


def cell_world(model: str, chips: int | None, device_type: str) -> dict[str, int] | None:
    """The layout of a cell's rank group (:func:`grant`), None for the
    one-device code. Every family (Llama, Mixtral, the embedding cell)
    takes its grant: a group whenever ``--chips`` is given (a one-rank
    group at ``--chips 1``) or the visible GPUs are more than one."""
    shape = grant(chips, device_type)
    many = shape["data"] * shape["tensor"] > 1
    return shape if chips is not None or many else None


def _preset_cfg(model: str, dtype: str | None, max_seq_len: int | None):
    """``model``'s preset config with the cell's ``dtype`` (int8: the
    preset's activations) and ``max_seq_len``."""
    cfg = MODELS[model]()
    if dtype and dtype != "int8":
        cfg = dataclasses.replace(cfg, dtype=getattr(torch, dtype))
    if max_seq_len:
        cfg = dataclasses.replace(cfg, max_seq_len=max_seq_len)
    return cfg


def _drawn_params(cfg, quantize: bool, gen: torch.Generator):
    """Random Llama weights drawn on ``gen``'s device: from one seed, the
    same tree on every device of one kind."""
    return llama.nest(_drawn_leaves(cfg, quantize, gen))


def _drawn_leaves(cfg, quantize: bool, gen: torch.Generator):
    if quantize:
        return convert.iter_quantized_params_device(cfg, gen, gen.device)
    return llama.iter_params(cfg, gen, gen.device)


def _mesh_recipe(model: str, dtype: str | None, checkpoint: str | None, seed: int,
                 max_seq_len: int | None) -> Recipe:
    """A decoder cell's weight recipe on a rank group: :func:`rank_leaves`
    (the draws), :func:`rank_stream` (a Llama kukeon int8 or HF
    checkpoint) or :func:`rank_slices` (a Llama orbax checkpoint, a
    Mixtral HF directory)."""
    kwargs = {"model": model, "dtype": dtype, "checkpoint": checkpoint,
              "max_seq_len": max_seq_len}
    if not checkpoint:
        return Recipe("kukeon_tpu_torch.runtime.serving_cell:rank_leaves",
                      {**kwargs, "seed": seed})
    if model not in MOE_MODELS and _checkpoint_kind(checkpoint) != "orbax":
        return Recipe("kukeon_tpu_torch.runtime.serving_cell:rank_stream", kwargs,
                      reads="stream")
    return Recipe("kukeon_tpu_torch.runtime.serving_cell:rank_slices", kwargs, reads="slices")


def _slices_load(cfg, model: str) -> dict:
    """The leader's ``checkpoint_load`` of a ``"slices"`` recipe: the full
    tree's leaf bytes, as a one-device materialized load places them (the
    sum of the ranks' blocks, less their padding)."""
    tree = (moe if model in MOE_MODELS else llama).init_params(cfg, None, "meta")
    leaves = [t for _, t in checkpoints._walk_tree(tree)]
    return {"leaf_bytes": sum(t.numel() * t.element_size() for t in leaves),
            "leaves": len(leaves)}


def rank_leaves(*, device: torch.device, model: str, dtype: str | None,
                checkpoint: str | None, seed: int, max_seq_len: int | None):
    """A tensor-parallel cell's weight recipe of random weights
    (``parallel.sharding.Recipe``, ``"leaves"``): the leaves the one-device
    cell would draw on ``device`` from ``seed``, one at a time, each rank
    keeping its slice (drawing only a slice would change the stream).
    ``checkpoint`` is None: a checkpoint goes through :func:`rank_stream`
    or :func:`rank_slices`."""
    if checkpoint:
        raise ValueError("rank_leaves draws; a checkpoint is read by rank_stream or rank_slices")
    quantize = dtype == "int8"
    cfg = _preset_cfg(model, dtype, max_seq_len)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    if model in MOE_MODELS:
        if quantize:
            yield from convert.iter_quantized_moe_params_device(cfg, gen, device)
        else:
            yield from moe.iter_params(cfg, gen, device)
        return
    yield from _drawn_leaves(cfg, quantize, gen)


def rank_stream(*, rank: int, world: int, kv_shard: bool, model: str, dtype: str | None,
                checkpoint: str, max_seq_len: int | None) -> checkpoints.CheckpointStream:
    """A ``"stream"`` recipe: rank ``rank``'s ``CheckpointStream`` of a
    Llama kukeon int8 or HF checkpoint (quantized on the host under int8),
    each leaf that rank's block read from disk, its abstract tree the
    rank's local tree: what the one-device cell streams
    (:meth:`ServingCell._load_checkpoint`), cut."""
    cfg = _preset_cfg(model, dtype, max_seq_len)
    where = {"rank": rank, "world": world, "kv_shard": kv_shard}
    if _checkpoint_kind(checkpoint) == "int8":
        return checkpoints.stream_quantized(checkpoint, dtype=cfg.dtype, **where)
    read = hf_convert.stream_params_quantized if dtype == "int8" else hf_convert.stream_params
    return read(checkpoint, dtype=cfg.dtype, **where)


def rank_slices(*, device: torch.device, rank: int, world: int, kv_shard: bool, model: str,
                dtype: str | None, checkpoint: str, max_seq_len: int | None):
    """A ``"slices"`` recipe: rank ``rank``'s blocks of a Llama orbax
    checkpoint (``orbax_ckpt.rank_leaves``: each array's region decoded,
    cast, placed, quantized on ``device`` under int8) or of an HF Mixtral
    directory (``hf_convert.moe_rank_leaves``: each expert matrix's rows or
    columns, quantized on ``device`` one matrix at a time), one leaf at a
    time."""
    quantize = dtype == "int8"
    cfg = ServingCell._checkpoint_cfg(checkpoint, _preset_cfg(model, dtype, max_seq_len))
    if model in MOE_MODELS:
        yield from hf_convert.moe_rank_leaves(checkpoint, cfg, rank=rank, world=world,
                                              kv_shard=kv_shard, device=device,
                                              quantize=quantize)
        return
    layout = Layout(cfg, rank, world, kv_shard)
    try:
        yield from orbax_ckpt.rank_leaves(checkpoint, llama.init_params(cfg, None, "meta"),
                                          layout, cfg.dtype, device, quantize=quantize)
    except orbax_ckpt.CheckpointError as e:
        raise SystemExit(str(e)) from e


def embedding_leaves(*, device: torch.device, cfg, seed: int):
    """An embedding cell's weight recipe of random weights on a mesh
    (``"leaves"``): ``bert.init_params``' leaves of ``cfg`` drawn on
    ``device`` from ``seed`` (the one-device cell's draws)."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    yield from bert.iter_params(cfg, gen, device)


def embedding_slices(*, device: torch.device, rank: int, world: int, kv_shard: bool, cfg,
                     checkpoint: str):
    """An embedding cell's ``"slices"`` recipe: rank ``rank``'s blocks of
    its orbax checkpoint (``orbax_ckpt.rank_leaves``), one leaf at a
    time."""
    try:
        yield from orbax_ckpt.rank_leaves(checkpoint, bert.init_params(cfg, None, "meta"),
                                          Layout(cfg, rank, world, kv_shard), cfg.dtype, device)
    except orbax_ckpt.CheckpointError as e:
        raise SystemExit(str(e)) from e


def _require_orbax(path: str) -> None:
    if not orbax_ckpt.is_orbax_checkpoint(path):
        raise SystemExit(f"checkpoint {path!r} is not an orbax checkpoint "
                         f"({orbax_ckpt.METADATA}): embedding cells read only those")


def _embedding_checkpoint(path: str, cfg, device) -> tuple[dict, dict]:
    """(tree, load stats) of an embedding cell's orbax checkpoint (the
    reference's ``:1144-1153``: restored into ``bert.init_params``' shapes)."""
    _require_orbax(path)
    try:
        return orbax_ckpt.load_params(path, bert.init_params(cfg, None, "meta"), cfg.dtype,
                                      device)
    except orbax_ckpt.CheckpointError as e:
        raise SystemExit(str(e)) from e


def _checkpoint_kind(path: str) -> str:
    """``int8`` (a kukeon int8 checkpoint), ``hf`` (an HF directory) or
    ``orbax``, in that order of precedence; anything else exits."""
    if checkpoints.is_quantized_checkpoint(path):
        return "int8"
    if os.path.isdir(path) and os.path.exists(os.path.join(path, "config.json")):
        return "hf"
    if orbax_ckpt.is_orbax_checkpoint(path):
        return "orbax"
    raise SystemExit(f"checkpoint {path!r} is neither a kukeon int8 checkpoint "
                     f"({checkpoints.QUANT_MANIFEST}), nor an HF directory "
                     f"(config.json), nor an orbax checkpoint ({orbax_ckpt.METADATA})")


def _synced_seconds(device, t0: float) -> float:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
    return time.monotonic() - t0


class EmbeddingCell(LifecycleMixin):
    """Embedding-model serving cell (bge-base), the port of the reference's
    ``EmbeddingCell`` (``kukeon_tpu/runtime/serving_cell.py:1079-1206``):
    ``/v1/embed`` instead of ``/v1/generate``, and the same health, stats
    and metrics seams as the decoder cell, so a reconciler treats both
    flavours alike. Weights come from ``checkpoint``, an orbax checkpoint
    (:func:`orbax_ckpt.load_params`), or are random, drawn on the device from
    ``seed``; ``dtype`` (``"bfloat16"``, ``"float32"``) overrides the
    model's. ``chips``: the grant, as the decoder cell's (:func:`cell_world`);
    on a group every rank runs :func:`embedding_leaves` and keeps its
    slice."""

    def __init__(self, model: str, *, batch_size: int = 16, pooling: str = "cls",
                 checkpoint: str | None = None, dtype: str | None = None, seed: int = 0,
                 device: str | torch.device | None = None, chips: int | None = None):
        if model not in EMBEDDING_MODELS:
            raise SystemExit(f"unknown embedding model {model!r}; known: "
                             f"{sorted(EMBEDDING_MODELS)}")
        self.device = resolve_device(device)
        cfg = EMBEDDING_MODELS[model]()
        if dtype:
            cfg = dataclasses.replace(cfg, dtype=getattr(torch, dtype))
        self.checkpoint_load: dict = {}
        world = cell_world(model, chips, self.device.type)
        mesh = None
        if world is not None:
            # Refused before a weight is allocated or a rank started.
            check_tensor_parallel(cfg, world["tensor"])
            if checkpoint:
                _require_orbax(checkpoint)
            mesh = make_mesh(**world, device=self.device.type)
            self.device = mesh.device
            params = (Recipe("kukeon_tpu_torch.runtime.serving_cell:embedding_slices",
                             {"cfg": cfg, "checkpoint": checkpoint}, reads="slices")
                      if checkpoint else
                      Recipe("kukeon_tpu_torch.runtime.serving_cell:embedding_leaves",
                             {"cfg": cfg, "seed": seed}))
        elif checkpoint:
            params, self.checkpoint_load = _embedding_checkpoint(checkpoint, cfg, self.device)
        else:
            gen = torch.Generator(device=self.device)
            gen.manual_seed(seed)
            params = bert.init_params(cfg, gen, self.device)
        self.model_name = model
        self.cfg = cfg
        self.engine = EmbeddingEngine(cfg, params, batch_size=batch_size, pooling=pooling,
                                      device=self.device, mesh=mesh)
        # The checkpoint's tokenizer.json when it ships one (the
        # reference's :1127), else the byte tokenizer.
        self.tokenizer = load_tokenizer(checkpoint)
        self.started_at = time.time()
        self._stats_lock = threading.Lock()
        self.total_sequences = 0   # guarded-by: _stats_lock
        self._init_lifecycle()
        group = mesh.group if mesh is not None and mesh.size > 1 else None
        self._init_cell_obs(Registry(), "embedding", self.device,
                            peers=(lambda: list(group.peer_stats.values())) if group else None)
        self.registry.gauge("kukeon_embed_batch_size",
                            "Embedding micro-batch grid size.").set(batch_size)
        self.registry.register_collector(self._obs_collect)

    def _obs_collect(self):
        yield ("kukeon_embed_sequences_total", "counter", "Sequences embedded since boot.",
               [({}, float(self.total_sequences))])

    def warmup(self, prompt_len: int = 64):
        self.engine.warmup((prompt_len,))

    def embed(self, req: dict) -> dict:
        """``POST /v1/embed``: ``inputTokens`` (a list of token lists) or
        ``inputs`` (a string or a list of them, through the tokenizer);
        one flight-recorder entry per call."""
        if "inputTokens" in req:
            prompts = [np.asarray(p, np.int32) for p in req["inputTokens"]]
        elif "inputs" in req:
            texts = req["inputs"]
            if isinstance(texts, str):
                texts = [texts]
            prompts = [np.asarray(self.tokenizer.encode(x) or [1], np.int32) for x in texts]
        else:
            raise ValueError("need inputs or inputTokens")
        t0 = time.monotonic()
        vecs = self.engine.embed_batch(prompts)
        dt = time.monotonic() - t0
        with self._stats_lock:
            self.total_sequences += len(prompts)
        self.recorder.record({
            "wall_s": round(dt, 6),
            "occupancy": len(prompts),
            "tokens": int(sum(p.size for p in prompts)),
            "programs": {"embed": round(dt, 6)},
            "traces": [],
        })
        return {
            "embeddings": [v.tolist() for v in vecs],
            "dim": int(vecs.shape[1]) if len(prompts) else self.cfg.hidden_size,
            "numSequences": len(prompts),
            "seconds": round(dt, 4),
        }

    def stats(self) -> dict:
        ready, why = self.readiness()
        return {
            "model": self.model_name,
            "kind": "embedding",
            "devices": [torch.cuda.get_device_name(self.device)
                        if self.device.type == "cuda" else "cpu"],
            "batchSize": self.engine.batch_size,
            # A cell on a rank group adds its mesh, as the decoder cell
            # reports it (without a cache); one device keeps the
            # reference's keys.
            **({"mesh": {"chips": self.engine.world, "shape": _mesh_shape(self.engine.mesh)}}
               if self.engine.mesh is not None else {}),
            "uptimeSeconds": round(
                self.registry.get("kukeon_cell_uptime_seconds").value(), 1),
            "totalSequences": self.total_sequences,
            "ready": ready,
            "draining": self.draining,
            **({"unreadyReason": why} if why else {}),
        }


class EngineWatchdog(threading.Thread):
    """Turns a wedged CUDA runtime behind a stuck engine into a restart, the
    port of the reference's ``EngineWatchdog``
    (``kukeon_tpu/runtime/serving_cell.py:1211-1285``).

    A hung CUDA context blocks the engine's driver thread inside a device
    call; nothing in Python times out, and the cell stays Ready serving
    nobody. The watchdog reads the engine's progress heartbeat
    (``stalled_s()``); once work has been outstanding with no progress past
    ``stall_budget_s`` it consults ``probe`` (default
    :func:`~kukeon_tpu_torch.runtime.devices.probe_cuda_runtime`, a killable
    subprocess, so it answers even while this process's runtime hangs). A
    ``wedged`` verdict trips it: ``on_wedged`` runs (under :func:`main`: the
    cell turns unready and exits :data:`WEDGED_EXIT_CODE`). Any other
    verdict re-arms the budget: a long capture or a giant prefill is slow,
    not wedged."""

    def __init__(self, engine, *, stall_budget_s: float, probe=None, on_wedged=None,
                 interval_s: float | None = None, probe_timeout_s: float = 20.0,
                 registry: Registry | None = None):
        super().__init__(daemon=True, name="cuda-watchdog")
        self.engine = engine
        self.stall_budget_s = stall_budget_s
        self.probe = probe
        self.on_wedged = on_wedged
        self.interval_s = (interval_s if interval_s is not None
                           else max(0.5, stall_budget_s / 4))
        self.probe_timeout_s = probe_timeout_s
        self.tripped = False
        self.last_verdict: tuple[str, str] | None = None
        self.probes = 0
        self._halt = threading.Event()
        reg = registry if registry is not None else Registry()
        self._m_probes = reg.counter("kukeon_watchdog_probes_total",
                                     "CUDA runtime probes fired after an engine stall.",
                                     labels=("verdict",))
        self._m_trips = reg.counter("kukeon_watchdog_trips_total",
                                    "Wedged verdicts (the cell exits for restart right after).")

    def stop(self):
        self._halt.set()

    def run(self):
        probe = self.probe or probe_cuda_runtime
        while not self._halt.wait(self.interval_s):
            if self.engine.stalled_s() < self.stall_budget_s:
                continue
            self.probes += 1
            status, detail = probe(timeout_s=self.probe_timeout_s)
            self.last_verdict = (status, detail)
            self._m_probes.inc(verdict=status)
            if status == "wedged":
                self.tripped = True
                self._m_trips.inc()
                if self.on_wedged is not None:
                    self.on_wedged(detail)
                return
            # The runtime answers: the stall is compute or host side. The
            # probe counts as progress, so the next probe waits a whole
            # budget (the heartbeat is _lock-guarded engine state).
            with self.engine._lock:
                self.engine.last_progress = time.monotonic()


def _trailing_fffd(s: str) -> int:
    """Length of the run of U+FFFD at the end of ``s`` (the provisional
    decode of an incomplete multi-byte character)."""
    n = 0
    while n < len(s) and s[-1 - n] == "\ufffd":
        n += 1
    return n


# --- KV handoff wire format ---------------------------------------------
#
# The reference's (``kukeon_tpu/runtime/serving_cell.py:270-313``): one
# binary body, a JSON header line (token, length, dtype, shape, byte counts
# and, for the import, the generation fields), then the raw K rows, then
# the raw V rows, little-endian as both frameworks lay them out. dtype
# names are numpy's, which the reference writes ("float32", and
# "bfloat16" through ml_dtypes); the port reads and writes them through
# torch, so bf16 travels as its raw 2-byte words without ml_dtypes.

KV_CONTENT_TYPE = "application/x-kukeon-kv"
_KV_DTYPES = {"float32": torch.float32, "float16": torch.float16,
              "bfloat16": torch.bfloat16, "float64": torch.float64}


def _kv_tensor(x) -> torch.Tensor:
    """A host tensor of ``x`` (a tensor, or a numpy array of a dtype numpy
    has)."""
    return x.cpu() if isinstance(x, torch.Tensor) else torch.from_numpy(np.asarray(x))


def pack_kv(header: dict, k, v) -> bytes:
    """A KV block and its header in the handoff wire format (``k``, ``v``:
    host tensors or numpy arrays, one shape and dtype)."""
    k, v = _kv_tensor(k), _kv_tensor(v)
    name = str(k.dtype).removeprefix("torch.")
    if name not in _KV_DTYPES or v.dtype != k.dtype or v.shape != k.shape:
        raise ValueError(f"KV block must be two tensors of one shape in one of "
                         f"{sorted(_KV_DTYPES)}, got {k.dtype}/{v.dtype}")
    kb, vb = (t.contiguous().reshape(-1).view(torch.uint8).numpy().tobytes() for t in (k, v))
    head = dict(header)
    head.update({"dtype": name, "shape": list(k.shape), "kBytes": len(kb), "vBytes": len(vb)})
    return json.dumps(head).encode() + b"\n" + kb + vb


def unpack_kv(body: bytes) -> tuple[dict, torch.Tensor, torch.Tensor]:
    """The handoff wire format back into (header, k, v), k and v host
    tensors. A malformed body raises ValueError."""
    nl = body.find(b"\n")
    if nl < 0:
        raise ValueError("KV body has no header line")
    header = json.loads(body[:nl])
    try:
        dtype = _KV_DTYPES[header["dtype"]]
        shape = tuple(int(x) for x in header["shape"])
        kb, vb = int(header["kBytes"]), int(header["vBytes"])
    except (KeyError, TypeError, ValueError) as e:
        raise ValueError(f"malformed KV header: {type(e).__name__}: {e}") from e
    raw = bytearray(memoryview(body)[nl + 1:])
    if len(raw) != kb + vb:
        raise ValueError(f"KV body truncated: header claims {kb + vb} tensor bytes, "
                         f"got {len(raw)}")
    size = math.prod(shape) * dtype.itemsize
    if kb != size or vb != size or size == 0:
        raise ValueError(f"KV header: shape {list(shape)} of {header['dtype']} is {size} "
                         f"bytes, kBytes {kb}, vBytes {vb}")
    k = torch.frombuffer(raw, dtype=dtype, count=math.prod(shape)).reshape(shape)
    v = torch.frombuffer(raw, dtype=dtype, count=math.prod(shape), offset=kb).reshape(shape)
    return header, k, v


def _program_counters(stats: dict) -> dict:
    return {"captures": stats["captures"], "replays": stats["replays"],
            "captureSeconds": round(stats["capture_s"], 3),
            "capturesAfterWarmup": stats["captures_after_warmup"],
            "poolBytes": stats["pool_bytes"]}


def make_handler(cell: ServingCell | EmbeddingCell):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *a):
            sys.stderr.write("serving-cell: " + fmt % a + "\n")

        def _send(self, code: int, obj: dict, headers: dict[str, str] | None = None):
            self._send_bytes(code, json.dumps(obj).encode(), "application/json", headers)

        def _send_text(self, code: int, text: str, content_type: str):
            self._send_bytes(code, text.encode(), content_type)

        def _send_bytes(self, code: int, body: bytes, content_type: str,
                        headers: dict[str, str] | None = None):
            self.send_response(code)
            self.send_header("Content-Type", content_type)
            self.send_header("Content-Length", str(len(body)))
            for k, v in (headers or {}).items():
                self.send_header(k, v)
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            parts = urlsplit(self.path)
            path = parts.path
            if path in ("/healthz", "/v1/health"):
                self._send(200, {"status": "ok", "model": cell.model_name})
            elif path == "/readyz":
                ok, why = cell.readiness()
                self._send(200 if ok else 503,
                           {"ready": True} if ok else {"ready": False, "reason": why})
            elif path == "/v1/stats":
                self._send(200, cell.stats())
            elif path == "/metrics":
                self._send_text(200, expo.render(cell.registry), expo.CONTENT_TYPE)
            elif path == "/v1/trace":
                self._trace(parse_qs(parts.query))
            elif path == "/v1/timeline":
                try:
                    n = int(parse_qs(parts.query).get("n", ["50"])[0])
                except ValueError:
                    self._send(400, {"error": "n must be an integer"})
                    return
                rec = cell.recorder
                self._send(200, {"steps": rec.snapshot(n), "dropped": rec.dropped,
                                 "capacity": rec.capacity})
            elif path == "/v1/profile":
                prof = cell.profiler
                self._send(200, {"captures": prof.list(), "dir": prof.base_dir,
                                 "keep": prof.keep})
            else:
                self._send(404, {"error": f"no route {self.path}"})

        def _trace(self, q: dict):
            """``/v1/trace``: one trace's spans (``trace_id``, oldest
            first, what the reference's daemon unions across cells), one
            request's (``request_id``), or the newest ``n``."""
            tracer = getattr(cell.engine, "tracer", None)
            if tracer is None:
                self._send(404, {"error": "this cell records no request traces"})
                return
            if "trace_id" in q:
                self._send(200, {"spans": tracer.for_trace(q["trace_id"][0])})
                return
            if "request_id" in q:
                try:
                    rid = int(q["request_id"][0])
                except ValueError:
                    self._send(400, {"error": "request_id must be an integer"})
                    return
                self._send(200, {"spans": tracer.for_request(rid)})
                return
            try:
                n = int(q.get("n", ["50"])[0])
            except ValueError:
                self._send(400, {"error": "n must be an integer"})
                return
            self._send(200, {"spans": tracer.recent(n)})

        def _profile(self):
            """``POST /v1/profile`` {"durationMs": D}: start a capture
            (exempt from admission: a draining or overloaded cell is when
            an operator wants a trace); 409 while one runs. ``{"layers":
            true}``: the per-layer profile, run in the request; failed
            components come back recorded in the body (200), the cell
            serving on (404 on a cell without one)."""
            try:
                n = int(self.headers.get("Content-Length", 0))
                req = json.loads(self.rfile.read(n) or b"{}")
                if req.get("layers"):
                    if not hasattr(cell, "profile_layers"):
                        self._send(404, {"error": "this cell has no layer profiler"})
                        return
                    self._send(200, cell.profile_layers(prefill_len=req.get("prefillLen"),
                                                        decode_batch=req.get("decodeBatch")))
                    return
                rec = cell.profiler.start(float(req.get("durationMs", 1000)))
                self._send(200, {"started": True, "capture": rec})
            except ProfileBusy as e:
                self._send(409, {"error": str(e)})
            except NotImplementedError as e:
                self._send(501, {"error": str(e)})
            except (ValueError, TypeError) as e:
                self._send(400, {"error": str(e)})
            except Exception as e:  # noqa: BLE001 — the server must keep serving
                self._send(500, {"error": f"{type(e).__name__}: {e}"})

        def do_POST(self):
            if self.path == "/drain":
                # Counted in flight until its answer is written: an idle
                # cell's drain ends the process at once, and the handler
                # threads are daemons that exit would cut mid-response.
                cell._inflight_inc()
                try:
                    self._send(200, {"draining": True, "started": cell.begin_drain()})
                finally:
                    cell._inflight_dec()
                return
            if self.path == "/v1/profile":
                self._profile()
                return
            routes = (("/v1/embed",) if isinstance(cell, EmbeddingCell)
                      else ("/v1/generate", "/v1/kv/export", "/v1/kv/import"))
            if self.path not in routes:
                self._send(404, {"error": f"no route {self.path}; this cell serves "
                                          f"{['/drain', *routes]}"})
                return
            tracked = False
            try:
                faults.maybe_fail("cell.http")
                n = int(self.headers.get("Content-Length", 0))
                body = self.rfile.read(n)
                # A caller's trace context (the gateway sends one): the
                # request's span joins its trace; a malformed header roots a
                # fresh trace instead.
                ctx = obs_trace.parse_traceparent(
                    self.headers.get(obs_trace.TRACEPARENT_HEADER))
                # Lifecycle admission first (503); the engine's queue-full
                # shedding fires inside submit (429). A cell without the
                # lifecycle (a test double) is held to its readiness.
                if hasattr(cell, "check_admission"):
                    cell.check_admission()
                    cell._inflight_inc()
                    tracked = True
                elif not cell.readiness()[0]:
                    raise RejectedError(f"not admitting requests: {cell.readiness()[1]}",
                                        retry_after_s=5.0)
                if self.path == "/v1/embed":
                    self._send(200, cell.embed(json.loads(body or b"{}")))
                elif self.path == "/v1/kv/export":
                    req = json.loads(body or b"{}")
                    self._send_bytes(200, cell.kv_export(req, trace_ctx=ctx), KV_CONTENT_TYPE)
                elif self.path == "/v1/kv/import":
                    header, k, v = unpack_kv(body)
                    if header.get("stream"):
                        self._stream(cell.kv_import_stream(header, k, v, trace_ctx=ctx))
                    else:
                        self._send(200, cell.kv_import(header, k, v, trace_ctx=ctx))
                else:
                    req = json.loads(body or b"{}")
                    if req.get("stream"):
                        self._stream(cell.generate_stream(req, trace_ctx=ctx))
                    else:
                        self._send(200, cell.generate(req, trace_ctx=ctx))
            except RejectedError as e:
                self._reject(e)
            except DeadlineExceeded as e:
                self._send(504, {"error": str(e), "timedOut": True})
            except ValueError as e:
                self._send(400, {"error": str(e)})
            except Exception as e:  # noqa: BLE001 — the server must keep serving
                self._send(500, {"error": f"{type(e).__name__}: {e}"})
            finally:
                if tracked:
                    cell._inflight_dec()

        def _reject(self, e: RejectedError):
            # 429: queue full (or KV pool dry), retry this cell; 503: not
            # admitting (warming up, draining), go elsewhere.
            code = 429 if cell.readiness()[0] else 503
            self._send(code, {"error": str(e), "retryAfterSeconds": e.retry_after_s},
                       headers={"Retry-After": str(max(1, math.ceil(e.retry_after_s)))})

        def _stream(self, gen):
            """Newline-delimited JSON, framed by connection close (the
            handler speaks HTTP/1.0). The first record is pulled before the
            headers go out, so a refused request still gets a clean 400, 429
            or 503; after that, errors travel in-band."""
            try:
                first = next(gen)
            except RejectedError as e:
                self._reject(e)
                return
            except ValueError as e:
                self._send(400, {"error": str(e)})
                return
            except StopIteration:
                self._send(500, {"error": "empty stream"})
                return
            self.send_response(200)
            self.send_header("Content-Type", "application/x-ndjson")
            self.end_headers()
            try:
                for obj in itertools.chain([first], gen):
                    self.wfile.write((json.dumps(obj) + "\n").encode())
                    self.wfile.flush()
            except OSError:
                pass        # the client went away mid-stream
            except Exception as e:  # noqa: BLE001 — the headers are already out
                # A second status line would land inside the open body.
                try:
                    self.wfile.write((json.dumps({"error": f"{type(e).__name__}: {e}"})
                                      + "\n").encode())
                    self.wfile.flush()
                except OSError:
                    pass

    return Handler


def serve(cell: ServingCell | EmbeddingCell, host: str = "127.0.0.1", port: int = 0) -> ThreadingHTTPServer:
    """Bind the cell's HTTP server (port 0 = any free port) and run it on a
    daemon thread; ``server.shutdown()`` stops it."""
    server = ThreadingHTTPServer((host, port), make_handler(cell))
    server.daemon_threads = True
    threading.Thread(target=server.serve_forever, daemon=True,
                     name="serving-cell-http").start()
    return server


def build_parser() -> argparse.ArgumentParser:
    """The cell's command line: the reference cell's flags, which its
    runner passes (``kukeon_tpu/runtime/runner.py``), ``--chips`` among
    them, plus ``--device``."""
    ap = argparse.ArgumentParser(prog="kukeon-serving-cell-torch")
    ap.add_argument("--model", required=True, choices=sorted({**MODELS, **EMBEDDING_MODELS}))
    ap.add_argument("--port", type=int, default=9000)
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--num-slots", type=int, default=8,
                    help="decode slots; an embedding cell's micro-batch grid size")
    ap.add_argument("--max-seq-len", type=int, default=None)
    ap.add_argument("--dtype", default=None)
    ap.add_argument("--checkpoint", default=None,
                    help="a kukeon int8 checkpoint or an HF safetensors directory "
                         "(absent: random weights from --seed)")
    # Absent (None): the tuning profile decides, then the default; given,
    # the flag wins (serving/tuning.py).
    ap.add_argument("--kv-cache-int8", action="store_true", default=None)
    ap.add_argument("--decode-chunk", type=int, default=None)
    ap.add_argument("--kv-page-tokens", type=int, default=None,
                    help="> 0: the paged KV cache with pages of this many rows; 0: the "
                         "legacy contiguous layout; absent: the tuning profile decides "
                         "(legacy without one)")
    ap.add_argument("--role", default="mixed",
                    help="mixed (default), prefill or decode: the disaggregated-serving "
                         "role /v1/stats advertises (every role keeps the whole engine)")
    ap.add_argument("--no-warmup", action="store_true")
    ap.add_argument("--max-pending", type=int, default=64)
    ap.add_argument("--deadline-s", type=float, default=0.0)
    # SLO objectives: the kukeon_slo_* burn-rate gauges on /metrics. 0 = the
    # loose defaults.
    ap.add_argument("--slo-ttft-p95-ms", type=float, default=0.0)
    ap.add_argument("--slo-availability", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    ap.add_argument("--chips", type=int, default=None,
                    help="serve over exactly this many devices, all on the tensor axis "
                         "(one process each; absent: every visible GPU, laid out data x "
                         "tensor as the reference's auto_mesh_shape; one rank on the CPU)")
    return ap


def _end_on_rank_failure(cell) -> None:
    """A rank that dies ends the cell (exit 1): it never serves on fewer
    devices."""
    group = launch.current()
    if group is None:
        return

    def _rank_failed(why: str):
        cell.mark_unready(f"rank failed: {why}")
        print(f"serving-cell: {why}; exiting 1", file=sys.stderr, flush=True)
        os._exit(1)

    group.on_failure = _rank_failed
    if group.failed is not None:
        _rank_failed(group.failed)


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    embedding = args.model in EMBEDDING_MODELS
    if embedding:
        cell = EmbeddingCell(args.model, batch_size=args.num_slots, dtype=args.dtype,
                             checkpoint=args.checkpoint, seed=args.seed, device=args.device,
                             chips=args.chips)
        _end_on_rank_failure(cell)
        if not args.no_warmup:
            cell.warmup()
    else:
        cell = ServingCell(
            args.model, num_slots=args.num_slots, max_seq_len=args.max_seq_len,
            dtype=args.dtype, checkpoint=args.checkpoint, seed=args.seed,
            kv_cache_int8=args.kv_cache_int8,
            decode_chunk=args.decode_chunk, max_pending=args.max_pending or None,
            deadline_s=args.deadline_s or None, device=args.device,
            kv_page_tokens=args.kv_page_tokens, role=args.role,
            slo_ttft_p95_ms=args.slo_ttft_p95_ms or None,
            slo_availability=args.slo_availability or None, chips=args.chips)
        _end_on_rank_failure(cell)
        # Warmup before the driver thread starts: step() is single-driver.
        if not args.no_warmup:
            cell.warmup()
        cell.engine.start()
    server = ThreadingHTTPServer((args.host, args.port), make_handler(cell))
    # A finished drain (POST /drain, or SIGTERM) ends serve_forever: exit 0.
    cell.on_drained = server.shutdown
    if threading.current_thread() is threading.main_thread():
        signal.signal(signal.SIGTERM, lambda *_a: cell.begin_drain())
    if not embedding:
        # The cold-start record lands on /metrics and in the trace ring.
        cell.finish_boot()
    cell.mark_ready()
    # A stall past the budget that the probe confirms as a wedged CUDA
    # runtime exits WEDGED_EXIT_CODE, for the restart policy. The embedding
    # cell has no engine thread to stall, and no watchdog (as the
    # reference's).
    watchdog = None
    budget = float(os.environ.get(WATCHDOG_ENV, "120") or 0)
    if budget > 0 and not embedding:
        def _wedged(detail: str):
            cell.mark_unready(f"CUDA runtime wedged: {detail}")
            print(f"serving-cell: watchdog tripped — {detail}; exiting "
                  f"{WEDGED_EXIT_CODE} for restart", file=sys.stderr, flush=True)
            os._exit(WEDGED_EXIT_CODE)

        watchdog = EngineWatchdog(
            cell.engine, stall_budget_s=budget, on_wedged=_wedged,
            probe_timeout_s=float(os.environ.get(WATCHDOG_PROBE_TIMEOUT_ENV, "20") or 20),
            registry=cell.registry)
        watchdog.start()
    # The bound port: --port 0 takes any free one.
    print(f"serving-cell: {args.model} ready on {args.host}:{server.server_address[1]}",
          flush=True)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        if watchdog is not None:
            watchdog.stop()
        if not embedding:
            cell.engine.stop()
    return 0


if __name__ == "__main__":
    sys.exit(main())
