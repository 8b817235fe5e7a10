"""Model-serving cell, the port of ``kukeon_tpu/runtime/serving_cell.py``.

An HTTP front end over the port's :class:`ServingEngine`:

  GET  /healthz, /v1/health -> liveness (200 while the process answers)
  GET  /readyz              -> readiness (503 warming up or draining)
  GET  /v1/stats            -> role, slots, queue, in-flight and token
                               counters, draining
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

The ``traceparent`` header is not read (tracing is not ported). Not ported
yet (ROADMAP.md): checkpoints, metrics, traces, tuning profiles, the
watchdog, embedding cells and multi-GPU.
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

import numpy as np
import torch

from kukeon_tpu_torch import faults
from kukeon_tpu_torch.device import resolve_device
from kukeon_tpu_torch.models import convert, llama, moe
from kukeon_tpu_torch.serving.engine import (
    DeadlineExceeded,
    RejectedError,
    ServingEngine,
)
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
ROLES = ("mixed", "prefill", "decode")
DRAIN_TIMEOUT_ENV = "KUKEON_DRAIN_TIMEOUT_S"


class LifecycleMixin:
    """Readiness and drain, the port of the reference's ``LifecycleMixin``
    (``kukeon_tpu/runtime/serving_cell.py:92-260``) with plain
    ``threading`` (the reference's ``sanitize`` proxies aside).

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


class ServingCell(LifecycleMixin):
    """One model behind one engine. ``dtype="int8"`` serves per-channel
    int8 weights (random, drawn on the device from ``seed``); another dtype
    name (``"bfloat16"``, ``"float32"``) sets the weight and activation
    dtype. ``role``: ``mixed``, ``prefill`` or ``decode``, what a gateway
    routes on (every role keeps the whole engine: a prefill cell can decode
    locally, a decode cell re-prefill a preempted import)."""

    def __init__(self, model: str, *, num_slots: int = 8,
                 max_seq_len: int | None = None, dtype: str | None = None,
                 seed: int = 0, kv_cache_int8: bool = False,
                 decode_chunk: int = 16, max_pending: int | None = None,
                 deadline_s: float | None = None,
                 device: str | torch.device | None = None,
                 kv_page_tokens: int = 0, role: str = "mixed"):
        if model not in MODELS:
            raise SystemExit(f"unknown model {model!r}; known: {sorted(MODELS)}")
        if role not in ROLES:
            raise SystemExit(f"unknown --role {role!r}; must be mixed|prefill|decode")
        self.role = role
        self.device = resolve_device(device)
        quantize = dtype == "int8"
        cfg = MODELS[model]()
        if dtype and not quantize:
            cfg = dataclasses.replace(cfg, dtype=getattr(torch, dtype))
        if max_seq_len:
            cfg = dataclasses.replace(cfg, max_seq_len=max_seq_len)
        gen = torch.Generator(device=self.device)
        gen.manual_seed(seed)
        forward_fn = None
        if model in MOE_MODELS:
            # The MoE decode ignores int8-KV scales (as the reference's):
            # refuse the flag rather than serve garbage.
            if kv_cache_int8:
                raise SystemExit(f"model {model!r} does not support --kv-cache-int8 yet")
            forward_fn = moe.forward
            if quantize:
                params = convert.init_quantized_moe_params_device(cfg, gen, self.device)
            else:
                params = moe.init_params(cfg, gen, self.device)
        elif quantize:
            params = convert.init_quantized_params_device(cfg, gen, self.device)
        else:
            params = llama.init_params(cfg, gen, self.device)
        self.model_name = model
        self.cfg = cfg
        self.engine = ServingEngine(
            cfg, params, num_slots=num_slots,
            max_seq_len=max_seq_len or min(cfg.max_seq_len, 4096),
            kv_cache_int8=kv_cache_int8, decode_chunk=decode_chunk,
            max_pending=max_pending, seed=seed, device=self.device,
            forward_fn=forward_fn, kv_page_tokens=kv_page_tokens)
        self.tokenizer = load_tokenizer(None)
        self.default_deadline_s = deadline_s
        self.started_at = time.time()
        self.boot_s: dict[str, float] = {}
        self._init_lifecycle()

    def warmup(self, prompt_len: int = 64):
        """Capture the decode programs and the prefill of ``prompt_len``'s
        bucket (``engine.precompile``; a prefill cell also its export
        program, a decode cell its insert-only one), then run one request
        through them, as the reference cell does; ``/readyz`` turns 200
        only at :meth:`mark_ready`, after both."""
        t0 = time.monotonic()
        self.engine.precompile((prompt_len,), export=self.role == "prefill",
                               imports=self.role == "decode")
        t1 = time.monotonic()
        self.engine.warmup(prompt_len)
        self.boot_s["precompile"] = round(t1 - t0, 3)
        self.boot_s["warmup"] = round(time.monotonic() - t1, 3)

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

    def _submit(self, req: dict):
        """Parse and submit one generate body -> (request, its event queue,
        stop strings, submit time)."""
        prompt, sp, stops, prefix_id, deadline_s = self._parse_generate(req)
        events: queue.Queue = queue.Queue()
        t0 = time.monotonic()
        r = self.engine.submit(prompt, sp, emit=lambda tok, done: events.put((tok, done)),
                               prefix_id=prefix_id, deadline_s=deadline_s)
        return r, events, stops, t0

    def generate(self, req: dict) -> dict:
        """Non-streaming generation: the terminal record of the stream (one
        machinery for both modes, stop strings included), plus the time to
        the first token."""
        r, events, stops, t0 = self._submit(req)
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

    def generate_stream(self, req: dict):
        """Streaming generation: one record a token as the engine emits it,
        then the terminal record (``_stream_events``)."""
        r, events, stops, t0 = self._submit(req)
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

    def kv_export(self, req: dict) -> bytes:
        """``POST /v1/kv/export`` (the reference's ``kv_export``,
        ``:834-891``): the prompt's prefill only, no decode slot taken; the
        KV block in the handoff wire format, its header carrying the first
        token and its text (cut at a stop string), ``done`` (the first
        token ends the request: eos, a stop token or string, or a one-token
        budget) and all a decode cell needs to seat the request."""
        prompt, sp, stops, prefix_id, deadline_s = self._parse_generate(req)
        events: queue.Queue = queue.Queue()
        r = self.engine.submit(prompt, sp, emit=lambda tok, done: events.put((tok, done)),
                               prefix_id=prefix_id, deadline_s=deadline_s, export=True)
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

    def kv_import_stream(self, header: dict, k: torch.Tensor, v: torch.Tensor):
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
                               kv_import={"token": first, "length": n, "k": k, "v": v})
        yield {"token": first, "text": emitted}
        yield from self._stream_events(r, events, stops, t0, tokens=tokens, emitted=emitted,
                                       skip_first=True)

    def kv_import(self, header: dict, k: torch.Tensor, v: torch.Tensor) -> dict:
        """The non-streamed import: the stream's terminal record."""
        out = None
        for out in self.kv_import_stream(header, k, v):
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
        eng = self.engine
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
            "generatedTokens": eng.tokens_total,
            "rejected": eng.shed_stats["rejected"],
            "timedOut": eng.shed_stats["timed_out"],
            "int8Kernel": eng.cfg.int8_pallas,
            "kvCacheInt8": eng.kv_cache_int8,
            "decodeChunk": eng.decode_chunk,
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
            "bootSeconds": self.boot_s,
            "uptimeSeconds": round(time.time() - self.started_at, 1),
            "ready": ready,
            "draining": self.draining,
            **({"unreadyReason": why} if why else {}),
        }


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


def make_handler(cell: ServingCell):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *a):
            sys.stderr.write("serving-cell: " + fmt % a + "\n")

        def _send(self, code: int, obj: dict, headers: dict[str, str] | None = None):
            self._send_bytes(code, json.dumps(obj).encode(), "application/json", headers)

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
            if self.path in ("/healthz", "/v1/health"):
                self._send(200, {"status": "ok", "model": cell.model_name})
            elif self.path == "/readyz":
                ok, why = cell.readiness()
                self._send(200 if ok else 503,
                           {"ready": True} if ok else {"ready": False, "reason": why})
            elif self.path == "/v1/stats":
                self._send(200, cell.stats())
            else:
                self._send(404, {"error": f"no route {self.path}"})

        def do_POST(self):
            if self.path == "/drain":
                self._send(200, {"draining": True, "started": cell.begin_drain()})
                return
            routes = ("/v1/generate", "/v1/kv/export", "/v1/kv/import")
            if self.path not in routes:
                self._send(404, {"error": f"no route {self.path}; this cell serves "
                                          f"{['/drain', *routes]}"})
                return
            tracked = False
            try:
                n = int(self.headers.get("Content-Length", 0))
                body = self.rfile.read(n)
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
                if self.path == "/v1/kv/export":
                    req = json.loads(body or b"{}")
                    self._send_bytes(200, cell.kv_export(req), KV_CONTENT_TYPE)
                elif self.path == "/v1/kv/import":
                    header, k, v = unpack_kv(body)
                    if header.get("stream"):
                        self._stream(cell.kv_import_stream(header, k, v))
                    else:
                        self._send(200, cell.kv_import(header, k, v))
                else:
                    req = json.loads(body or b"{}")
                    if req.get("stream"):
                        self._stream(cell.generate_stream(req))
                    else:
                        self._send(200, cell.generate(req))
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


def serve(cell: ServingCell, host: str = "127.0.0.1", port: int = 0) -> ThreadingHTTPServer:
    """Bind the cell's HTTP server (port 0 = any free port) and run it on a
    daemon thread; ``server.shutdown()`` stops it."""
    server = ThreadingHTTPServer((host, port), make_handler(cell))
    server.daemon_threads = True
    threading.Thread(target=server.serve_forever, daemon=True,
                     name="serving-cell-http").start()
    return server


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="kukeon-serving-cell-torch")
    ap.add_argument("--model", required=True, choices=sorted(MODELS))
    ap.add_argument("--port", type=int, default=9000)
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--num-slots", type=int, default=8)
    ap.add_argument("--max-seq-len", type=int, default=None)
    ap.add_argument("--dtype", default=None)
    ap.add_argument("--kv-cache-int8", action="store_true")
    ap.add_argument("--decode-chunk", type=int, default=16)
    ap.add_argument("--kv-page-tokens", type=int, default=0,
                    help="> 0: the paged KV cache with pages of this many rows; 0 or "
                         "absent: the legacy contiguous layout (no tuning profile "
                         "decides it yet)")
    ap.add_argument("--role", default="mixed",
                    help="mixed (default), prefill or decode: the disaggregated-serving "
                         "role /v1/stats advertises (every role keeps the whole engine)")
    ap.add_argument("--no-warmup", action="store_true")
    ap.add_argument("--max-pending", type=int, default=64)
    ap.add_argument("--deadline-s", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    cell = ServingCell(
        args.model, num_slots=args.num_slots, max_seq_len=args.max_seq_len,
        dtype=args.dtype, seed=args.seed, kv_cache_int8=args.kv_cache_int8,
        decode_chunk=args.decode_chunk, max_pending=args.max_pending or None,
        deadline_s=args.deadline_s or None, device=args.device,
        kv_page_tokens=args.kv_page_tokens, role=args.role)
    # Warmup before the driver thread starts: step() is single-driver.
    if not args.no_warmup:
        cell.warmup()
    cell.engine.start()
    server = ThreadingHTTPServer((args.host, args.port), make_handler(cell))
    # A finished drain (POST /drain, or SIGTERM) ends serve_forever: exit 0.
    cell.on_drained = server.shutdown
    if threading.current_thread() is threading.main_thread():
        signal.signal(signal.SIGTERM, lambda *_a: cell.begin_drain())
    cell.mark_ready()
    print(f"serving-cell: {args.model} ready on {args.host}:{args.port}", flush=True)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        cell.engine.stop()
    return 0


if __name__ == "__main__":
    sys.exit(main())
