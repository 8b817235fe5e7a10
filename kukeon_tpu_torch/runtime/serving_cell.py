"""Model-serving cell, the port of ``kukeon_tpu/runtime/serving_cell.py``.

An HTTP front end over the port's :class:`ServingEngine`:

  GET  /healthz, /v1/health -> liveness (200 while the process answers)
  GET  /readyz              -> readiness (503 until warmup is done)
  GET  /v1/stats            -> slots, queue and token counters
  POST /v1/generate         -> {"promptTokens": [...] | "prompt": "text",
                                "maxNewTokens": N, "temperature": T,
                                "topK": K, "topP": P, "stopTokens": [...],
                                "deadlineS": D}
                               => {"tokens": [...], "text": "...",
                                   "numTokens": n, "seconds": s,
                                   "ttftSeconds": t}

A full queue answers 429 with ``Retry-After``; a request the cell will
not admit (not ready) answers 503. Run it as
``python -m kukeon_tpu_torch.runtime.serving_cell --model llama3-8b
--dtype int8``. Not ported yet (ROADMAP.md): checkpoints, streaming,
stop strings, drain, metrics, traces, profiles, KV handoff, the watchdog,
embedding cells, MoE models and multi-GPU.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import sys
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import torch

from kukeon_tpu_torch.device import resolve_device
from kukeon_tpu_torch.models import convert, llama
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
}


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
                 device: str | torch.device | None = None):
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
        if quantize:
            params = convert.init_quantized_params_device(cfg, gen, self.device)
        else:
            params = llama.init_params(cfg, gen, self.device)
        self.model_name = model
        self.cfg = cfg
        self.engine = ServingEngine(
            cfg, params, num_slots=num_slots,
            max_seq_len=max_seq_len or min(cfg.max_seq_len, 4096),
            kv_cache_int8=kv_cache_int8, decode_chunk=decode_chunk,
            max_pending=max_pending, seed=seed, device=self.device)
        self.tokenizer = load_tokenizer(None)
        self.default_deadline_s = deadline_s
        self.started_at = time.time()
        self._ready = threading.Event()

    def warmup(self, prompt_len: int = 64):
        self.engine.warmup(prompt_len)

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
        sp = SamplingParams(
            temperature=float(req.get("temperature", 0.0)),
            top_k=int(req.get("topK", 0)),
            top_p=float(req.get("topP", 1.0)),
            max_new_tokens=int(req.get("maxNewTokens", 128)),
            stop_tokens=tuple(int(t) for t in req.get("stopTokens", [])),
        )
        deadline_s = req.get("deadlineS", self.default_deadline_s)
        if deadline_s is not None:
            deadline_s = float(deadline_s)
            if deadline_s <= 0:
                raise ValueError("deadlineS must be positive")
        return prompt, sp, deadline_s

    def generate(self, req: dict) -> dict:
        prompt, sp, deadline_s = self._parse_generate(req)
        r = self.engine.submit(prompt, sp, deadline_s=deadline_s)
        if self.engine.running:
            r.done.wait()
        else:
            while not r.done.is_set():
                self.engine.step()
        if r.timed_out:
            raise DeadlineExceeded(str(r.error))
        if r.error is not None:
            raise RuntimeError(f"{type(r.error).__name__}: {r.error}")
        return {
            "tokens": r.generated,
            "text": self.tokenizer.decode(r.generated),
            "numTokens": len(r.generated),
            "seconds": round(r.last_token_at - r.submitted_at, 4),
            "ttftSeconds": round(r.first_token_at - r.submitted_at, 4),
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
            "uptimeSeconds": round(time.time() - self.started_at, 1),
            "ready": ready,
            **({"unreadyReason": why} if why else {}),
        }


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
                self._send(200, cell.generate(req))
            except RejectedError as e:
                # 429: queue full, retry this cell; 503: not ready, go elsewhere.
                code = 429 if cell.readiness()[0] else 503
                self._send(code, {"error": str(e), "retryAfterSeconds": e.retry_after_s},
                           headers={"Retry-After": str(max(1, math.ceil(e.retry_after_s)))})
            except DeadlineExceeded as e:
                self._send(504, {"error": str(e), "timedOut": True})
            except ValueError as e:
                self._send(400, {"error": str(e)})
            except Exception as e:  # noqa: BLE001 — the server must keep serving
                self._send(500, {"error": f"{type(e).__name__}: {e}"})

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
        deadline_s=args.deadline_s or None, device=args.device)
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
