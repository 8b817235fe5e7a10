"""Model-serving cell, the port of ``kukeon_tpu/runtime/serving_cell.py``.

An HTTP front end over the port's :class:`ServingEngine`:

  GET  /healthz, /v1/health -> liveness (200 while the process answers)
  GET  /readyz              -> readiness (503 until warmup is done)
  GET  /v1/stats            -> slots, queue and token counters
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
the cell will not admit (not ready) answers 503. ``prefixId`` names an
agent session: a prompt that extends the session's previous prompt
prefills only its new tail (the engine's prefix cache; ``/v1/stats``
reports ``prefixCache``). ``--kv-page-tokens N`` serves from the paged
KV cache (``/v1/stats`` ``kvPages``). Run it as
``python -m kukeon_tpu_torch.runtime.serving_cell --model llama3-8b
--dtype int8`` (or ``--model mixtral-8x7b``: the MoE family serves through
the same engine with ``models/moe.py``'s forward, and refuses
``--kv-cache-int8`` as the reference does). Not ported yet (ROADMAP.md):
checkpoints, drain, metrics, traces, tuning profiles, KV handoff, the
watchdog, embedding cells and multi-GPU.
"""

from __future__ import annotations

import argparse
import dataclasses
import itertools
import json
import math
import queue
import sys
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import torch

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


class ServingCell:
    """One model behind one engine. ``dtype="int8"`` serves per-channel
    int8 weights (random, drawn on the device from ``seed``); another dtype
    name (``"bfloat16"``, ``"float32"``) sets the weight and activation
    dtype."""

    def __init__(self, model: str, *, num_slots: int = 8,
                 max_seq_len: int | None = None, dtype: str | None = None,
                 seed: int = 0, kv_cache_int8: bool = False,
                 decode_chunk: int = 16, max_pending: int | None = None,
                 deadline_s: float | None = None,
                 device: str | torch.device | None = None,
                 kv_page_tokens: int = 0):
        if model not in MODELS:
            raise SystemExit(f"unknown model {model!r}; known: {sorted(MODELS)}")
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
        self._ready = threading.Event()

    def warmup(self, prompt_len: int = 64):
        """Capture the decode programs and the prefill of ``prompt_len``'s
        bucket (``engine.precompile``), then run one request through them,
        as the reference cell does; ``/readyz`` turns 200 only at
        :meth:`mark_ready`, after both."""
        t0 = time.monotonic()
        self.engine.precompile((prompt_len,))
        t1 = time.monotonic()
        self.engine.warmup(prompt_len)
        self.boot_s["precompile"] = round(t1 - t0, 3)
        self.boot_s["warmup"] = round(time.monotonic() - t1, 3)

    def mark_ready(self):
        self._ready.set()

    def readiness(self) -> tuple[bool, str | None]:
        return (True, None) if self._ready.is_set() else (False, "warming up")

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

    def _stream_events(self, r, events: queue.Queue, stops: list[str], t0: float):
        """Drain the engine's emit events for ``r``: decode by prefix diff,
        hold back a trailing U+FFFD, match stop strings (the first match
        cuts the text and cancels the request), then yield the terminal
        record, or an in-band error record."""
        driving = not self.engine.running        # no driver thread: drive here
        tokens: list[int] = []
        emitted = ""
        stopped = False
        while True:
            if driving:
                while events.empty() and not r.done.is_set():
                    self.engine.step()
            tok, done = events.get()
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

    def stats(self) -> dict:
        eng = self.engine
        ready, why = self.readiness()
        return {
            "model": self.model_name,
            "device": (torch.cuda.get_device_name(self.device)
                       if self.device.type == "cuda" else "cpu"),
            "numSlots": eng.num_slots,
            "freeSlots": len(eng._free_slots()),
            "queueDepth": eng.queue_depth,
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
            **({"unreadyReason": why} if why else {}),
        }


def _trailing_fffd(s: str) -> int:
    """Length of the run of U+FFFD at the end of ``s`` (the provisional
    decode of an incomplete multi-byte character)."""
    n = 0
    while n < len(s) and s[-1 - n] == "\ufffd":
        n += 1
    return n


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
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
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
            if self.path != "/v1/generate":
                self._send(404, {"error": f"no route {self.path}; this cell "
                                          "serves ['/v1/generate']"})
                return
            try:
                n = int(self.headers.get("Content-Length", 0))
                req = json.loads(self.rfile.read(n) or b"{}")
                ok, why = cell.readiness()
                if not ok:
                    raise RejectedError(f"not admitting requests: {why}",
                                        retry_after_s=5.0)
                if req.get("stream"):
                    self._stream(cell.generate_stream(req))
                    return
                self._send(200, cell.generate(req))
            except RejectedError as e:
                self._reject(e)
            except DeadlineExceeded as e:
                self._send(504, {"error": str(e), "timedOut": True})
            except ValueError as e:
                self._send(400, {"error": str(e)})
            except Exception as e:  # noqa: BLE001 — the server must keep serving
                self._send(500, {"error": f"{type(e).__name__}: {e}"})

        def _reject(self, e: RejectedError):
            # 429: queue full (or KV pool dry), retry this cell; 503: not
            # ready, go elsewhere.
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
        kv_page_tokens=args.kv_page_tokens)
    # Warmup before the driver thread starts: step() is single-driver.
    if not args.no_warmup:
        cell.warmup()
    cell.engine.start()
    server = ThreadingHTTPServer((args.host, args.port), make_handler(cell))
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
