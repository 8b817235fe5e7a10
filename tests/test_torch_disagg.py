"""Disaggregated serving on the port (``kukeon_tpu_torch``): the KV handoff
between a prefill cell and a decode cell, against the reference
(``kukeon_tpu/serving/engine.py`` ``_dispatch_prefill_export``,
``_finish_export``, ``_dispatch_import``; ``kukeon_tpu/runtime/
serving_cell.py`` ``pack_kv``, ``unpack_kv``, ``kv_export``,
``kv_import_stream``), on the CPU.

- the ports of the cell-facing tests of ``tests/test_disagg.py``, with port
  cells behind the reference's ``GatewayCell`` (its trace assertions wait
  for the port's tracing);
- handoffs across frameworks on the same weights: a JAX prefill cell to a
  port decode cell and the reverse, through the gateway, give the JAX
  single engine's greedy tokens; the port's ``pack_kv`` bytes equal the
  reference's, f32 and bf16;
- port-to-port handoffs on both layouts and at ``mixtral-tiny`` give the
  JAX engine's tokens; an import under pool pressure parks and resumes,
  or sheds 429 on an idle engine, and a preempted import re-prefills;
- the handoff's programs: the export key's block and first token equal
  the fused prefill's bitwise, and the insert-only key leaves the decode
  state as the fused insert does (paged: outside page 0).
"""

import http.client
import json
import threading
from http.server import ThreadingHTTPServer

import jax
import ml_dtypes
import numpy as np
import pytest
import torch

from kukeon_tpu.gateway.cell import GatewayCell, make_gateway_handler
from kukeon_tpu.models import llama as jl
from kukeon_tpu.models import moe as jm
from kukeon_tpu.parallel import make_mesh, moe_specs_for_params
from kukeon_tpu.runtime import serving_cell as jcell_mod
from kukeon_tpu.serving import SamplingParams as JaxSamplingParams
from kukeon_tpu.serving import ServingEngine as JaxEngine
from kukeon_tpu_torch import faults
from kukeon_tpu_torch.models import convert
from kukeon_tpu_torch.models import llama as tl
from kukeon_tpu_torch.models import moe as tm
from kukeon_tpu_torch.runtime.serving_cell import (
    ServingCell,
    make_handler,
    pack_kv,
    unpack_kv,
)
from kukeon_tpu_torch.serving import SamplingParams, ServingEngine
from kukeon_tpu_torch.serving.engine import RejectedError
from kukeon_tpu_torch.serving.programs import HEADER, insert_key, prefill_key

torch.set_num_threads(2)

ENGINE = dict(num_slots=2, max_seq_len=128, decode_chunk=4)
PROMPT = np.array([5, 300, 7, 200, 9, 41, 77, 13, 250, 3, 99, 180, 64, 22, 310, 8, 17],
                  np.int32)
OTHER = np.arange(30, 60, dtype=np.int32)
LONGER = np.concatenate([PROMPT, np.array([11, 12, 13, 14], np.int32)])


@pytest.fixture(scope="module")
def tiny():
    """The reference's ``tiny`` f32 weights, as JAX params and as the
    port's, and the JAX engine's greedy tokens: PROMPT (40), OTHER (60) and
    LONGER (5); a shorter budget's tokens are these cut."""
    jp = jl.init_params(jax.random.key(0), jl.llama_tiny())
    eng = _jax_engine(jp)
    reqs = {name: eng.submit(p, JaxSamplingParams(max_new_tokens=n))
            for name, p, n in (("prompt", PROMPT, 40), ("other", OTHER, 60),
                               ("longer", LONGER, 5))}
    _drive(eng, list(reqs.values()))
    refs = {name: list(r.generated) for name, r in reqs.items()}
    return jp, convert.params_from_numpy(jax.tree.map(np.asarray, jp), "cpu"), refs


def _jax_engine(jp, **kw):
    return JaxEngine(jl.llama_tiny(), jp, make_mesh(tensor=1, devices=jax.devices()[:1]),
                     **{**ENGINE, **kw})


def _port_engine(params, cfg=None, **kw):
    return ServingEngine(cfg or tl.llama_tiny(), params, device="cpu", **{**ENGINE, **kw})


def _drive(eng, reqs):
    while not all(r.done.is_set() for r in reqs):
        eng.step()


def _export(eng, prompt, sp, **kw):
    r = eng.submit(prompt, sp, export=True, **kw)
    _drive(eng, [r])
    assert r.error is None
    return r.export_payload


def _import(eng, prompt, sp, p):
    r = eng.submit(prompt, sp, kv_import={k: p[k] for k in ("token", "length", "k", "v")})
    _drive(eng, [r])
    assert r.error is None
    return r


# --- cells behind the reference's gateway ----------------------------------


def _make_cell(role: str, **kw) -> tuple[ServingCell, ThreadingHTTPServer]:
    cell = ServingCell("tiny", **{**ENGINE, "kv_page_tokens": 16, "max_pending": 256, **kw},
                       role=role, device="cpu")
    cell.engine.start()
    cell.mark_ready()
    srv = ThreadingHTTPServer(("127.0.0.1", 0), make_handler(cell))
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return cell, srv


def _jax_cell(role: str, kv_page_tokens: int = 16):
    """The reference's cell at ``tiny``, whose weights are the ``tiny``
    fixture's (``init_params`` from key 0)."""
    cell = jcell_mod.ServingCell("tiny", num_slots=2, max_seq_len=128, checkpoint=None,
                                 dtype=None, kv_page_tokens=kv_page_tokens, max_pending=256,
                                 role=role)
    cell.engine.start()
    cell.mark_ready()
    srv = ThreadingHTTPServer(("127.0.0.1", 0), jcell_mod.make_handler(cell))
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return cell, srv


def _gateway(urls, poll_interval_s=0.05):
    gw = GatewayCell("tiny", urls, poll_interval_s=poll_interval_s, request_timeout_s=60.0)
    gw.start()
    gw.router.poll_once()
    gw_srv = ThreadingHTTPServer(("127.0.0.1", 0), make_gateway_handler(gw))
    threading.Thread(target=gw_srv.serve_forever, daemon=True).start()
    return gw, gw_srv


def _make_stack(roles=("prefill", "decode"), poll_interval_s=0.05):
    cells, servers = zip(*(_make_cell(role) for role in roles))
    gw, gw_srv = _gateway([f"http://127.0.0.1:{s.server_address[1]}" for s in servers],
                          poll_interval_s)
    return list(cells), list(servers), gw, gw_srv


def _teardown(cells, servers, gw, gw_srv):
    gw_srv.shutdown()
    gw_srv.server_close()
    gw.stop()
    for srv in servers:
        try:
            srv.shutdown()
            srv.server_close()
        except OSError:
            pass
    for cell in cells:
        cell.engine.stop()


def _post(port: int, path: str, body, timeout: float = 60.0, raw: bool = False):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    payload = body if isinstance(body, (bytes, bytearray)) else json.dumps(body)
    conn.request("POST", path, body=payload, headers={"Content-Type": "application/json"})
    resp = conn.getresponse()
    data = resp.read()
    status, headers = resp.status, dict(resp.getheaders())
    conn.close()
    if raw:
        return status, data
    return status, (json.loads(data) if data else {}), headers


def test_role_census_in_stats_and_gateway_snapshot():
    cells, servers, gw, gw_srv = _make_stack(("prefill", "decode"))
    try:
        assert cells[0].stats()["role"] == "prefill"
        assert cells[1].stats()["role"] == "decode"
        snap = {r["name"]: r["role"] for r in gw.stats()["replicas"]}
        assert snap == {"r0": "prefill", "r1": "decode"}
        assert gw.router.disaggregated()
    finally:
        _teardown(cells, servers, gw, gw_srv)


def test_disagg_e2e_with_both_hops():
    """``test_disagg_e2e_one_trace_with_both_hops`` without its trace
    assertions: the handed-off request decodes as the decode cell alone
    does, and the gateway accounts the handoff."""
    cells, servers, gw, gw_srv = _make_stack(("prefill", "decode"))
    try:
        body = {"promptTokens": PROMPT.tolist(), "maxNewTokens": 6}
        ref = cells[1].generate(body)
        exported = cells[0].engine.sync_stats["fetches"]
        status, out, _ = _post(gw_srv.server_address[1], "/v1/generate",
                               {**body, "prefixId": "sess-1"})
        assert status == 200
        assert out["tokens"] == ref["tokens"]
        # The prefill cell exported (three fetches: token, K, V) and seated
        # nothing; the decode cell imported it.
        assert cells[0].engine.sync_stats["fetches"] - exported == 3
        assert cells[0].engine.tokens_total == 0
        assert gw.registry.get("kukeon_handoff_pages_total").value() >= 1
        assert gw.registry.get("kukeon_handoff_bytes_total").value() == \
            2 * 2 * PROMPT.size * 2 * 32 * 4          # K and V, [L, 1, n, KV, D] f32
        assert sum(gw.registry.get("kukeon_handoff_seconds").snapshot()[0]) >= 1
    finally:
        _teardown(cells, servers, gw, gw_srv)


def test_disagg_streaming_preserves_tokens_and_text():
    cells, servers, gw, gw_srv = _make_stack(("prefill", "decode"))
    try:
        ref = cells[1].generate({"prompt": "hello world", "maxNewTokens": 6})
        status, data = _post(gw_srv.server_address[1], "/v1/generate",
                             {"prompt": "hello world", "maxNewTokens": 6, "stream": True},
                             raw=True)
        assert status == 200
        lines = [json.loads(ln) for ln in data.splitlines()]
        assert [ln["token"] for ln in lines if "token" in ln] == ref["tokens"]
        assert "".join(ln.get("text", "") for ln in lines if "token" in ln) == ref["text"]
        assert lines[-1]["done"] is True
    finally:
        _teardown(cells, servers, gw, gw_srv)


def test_mixed_roles_still_route_single_hop():
    cells, servers, gw, gw_srv = _make_stack(("mixed", "mixed"))
    try:
        assert not gw.router.disaggregated()
        status, out, _ = _post(gw_srv.server_address[1], "/v1/generate",
                               {"promptTokens": [1, 2, 3], "maxNewTokens": 4})
        assert status == 200 and len(out["tokens"]) == 4
        assert gw.registry.get("kukeon_handoff_pages_total").value() == 0
        assert sum(gw.registry.get("kukeon_handoff_seconds").snapshot()[0]) == 0
    finally:
        _teardown(cells, servers, gw, gw_srv)


def test_kv_handoff_fault_falls_back_to_local_decode(monkeypatch):
    """The port's ``kv.handoff`` point, armed once, fails the first import
    (500); the gateway falls back to local decode on the prefill cell."""
    cells, servers, gw, gw_srv = _make_stack(("prefill", "decode"))
    try:
        monkeypatch.setenv("KUKEON_FAULTS", "kv.handoff:1:1")
        faults.reset()
        body = {"promptTokens": list(range(1, 10)), "maxNewTokens": 4}
        status, out, _ = _post(gw_srv.server_address[1], "/v1/generate", body)
        assert status == 200 and len(out["tokens"]) == 4
        assert faults.fired("kv.handoff") == 1
        assert gw.registry.get("kukeon_handoff_failures_total").value(stage="import") == 1
        assert gw.registry.get("kukeon_handoff_fallback_total").value() == 1
        assert cells[0].engine.tokens_total == 4           # decoded where it prefilled
        status, out2, _ = _post(gw_srv.server_address[1], "/v1/generate", body)
        assert status == 200 and out2["tokens"] == out["tokens"]
        assert gw.registry.get("kukeon_handoff_pages_total").value() >= 1
    finally:
        faults.reset()
        _teardown(cells, servers, gw, gw_srv)


def test_decode_replica_death_mid_handoff_only_200_or_429():
    cells, servers, gw, gw_srv = _make_stack(("prefill", "decode"), poll_interval_s=30.0)
    try:
        status, _, _ = _post(gw_srv.server_address[1], "/v1/generate",
                             {"promptTokens": list(range(1, 10)), "maxNewTokens": 3})
        assert status == 200
        servers[1].shutdown()
        servers[1].server_close()
        cells[1].engine.stop()
        statuses: dict[int, int] = {}
        lock = threading.Lock()

        def one(i: int) -> None:
            s, _, _ = _post(gw_srv.server_address[1], "/v1/generate",
                            {"promptTokens": list(range(1, 10 + i)), "maxNewTokens": 3})
            with lock:
                statuses[s] = statuses.get(s, 0) + 1

        threads = [threading.Thread(target=one, args=(i,)) for i in range(6)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=120)
        assert set(statuses) <= {200, 429}, statuses
        assert statuses.get(200, 0) >= 1
        assert gw.registry.get("kukeon_handoff_fallback_total").value() >= 1
        assert gw.registry.get("kukeon_handoff_failures_total").value(stage="import") >= 1
    finally:
        _teardown(cells, servers, gw, gw_srv)


def test_import_sheds_429_when_decode_queue_full():
    cell, srv = _make_cell("decode")
    try:
        eng = cell.engine
        eng.stop()
        eng.max_pending = 1
        eng.submit(np.asarray([1, 2, 3], np.int32))
        body = pack_kv({"token": 5, "length": 3, "promptTokens": [1, 2, 3], "maxNewTokens": 4},
                       np.zeros((2, 1, 3, 2, 32), np.float32),
                       np.zeros((2, 1, 3, 2, 32), np.float32))
        status, out, headers = _post(srv.server_address[1], "/v1/kv/import", body)
        assert status == 429 and "error" in out and "Retry-After" in headers
        status, out, headers = _post(srv.server_address[1], "/v1/kv/import",
                                     {**json.loads(body.split(b"\n")[0]), "stream": True})
        assert status == 400                                # no KV rows: malformed
    finally:
        srv.shutdown()
        srv.server_close()
        cell.engine.stop()


def test_export_and_import_refuse_malformed_bodies_with_400():
    cell, srv = _make_cell("decode")
    port = srv.server_address[1]
    try:
        k = np.zeros((2, 1, 3, 2, 32), np.float32)
        good = {"token": 5, "length": 3, "promptTokens": [1, 2, 3], "maxNewTokens": 4}
        for body in (b"no header line", pack_kv(good, k, k)[:-4],
                     pack_kv({**good, "length": 4}, k, k),
                     pack_kv(good, k[:1], k[:1]),
                     pack_kv({k_: v for k_, v in good.items() if k_ != "token"}, k, k),
                     b'{"dtype": "int3", "shape": [1], "kBytes": 1, "vBytes": 1}\n\x00\x00'):
            assert _post(port, "/v1/kv/import", body)[0] == 400, body[:80]
        assert _post(port, "/v1/kv/export", {"promptTokens": [1], "stop": 5})[0] == 400
        assert _post(port, "/v1/kv/nothing", {})[0] == 404
    finally:
        srv.shutdown()
        srv.server_close()
        cell.engine.stop()


# --- the wire format ---------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kv_wire_format_roundtrip(dtype):
    k = torch.arange(24, dtype=torch.float32).reshape(2, 1, 3, 2, 2).to(getattr(torch, dtype))
    v = k + 100
    body = pack_kv({"token": 7, "length": 3}, k, v)
    header, k2, v2 = unpack_kv(body)
    assert header["token"] == 7 and header["dtype"] == dtype
    assert header["shape"] == [2, 1, 3, 2, 2]
    assert k2.dtype == k.dtype and torch.equal(k, k2) and torch.equal(v, v2)
    with pytest.raises(ValueError, match="truncated"):
        unpack_kv(body[:-4])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_pack_kv_bytes_equal_the_reference(dtype):
    """The same block through both packages' ``pack_kv``: equal bytes, and
    each side's ``unpack_kv`` reads the other's."""
    rng = np.random.default_rng(0)
    k = rng.standard_normal((2, 1, 5, 2, 32)).astype(np.float32)
    v = rng.standard_normal((2, 1, 5, 2, 32)).astype(np.float32)
    head = {"token": 9, "length": 5, "promptTokens": [1, 2, 3, 4, 5], "stop": ["x"]}
    np_dtype = np.float32 if dtype == "float32" else ml_dtypes.bfloat16
    ref = jcell_mod.pack_kv(head, k.astype(np_dtype), v.astype(np_dtype))
    tk, tv = (torch.from_numpy(x).to(getattr(torch, dtype)) for x in (k, v))
    assert pack_kv(head, tk, tv) == ref
    _, k2, _ = unpack_kv(ref)
    assert torch.equal(k2, tk)
    _, k3, _ = jcell_mod.unpack_kv(pack_kv(head, tk, tv))
    assert k3.dtype == np.dtype(np_dtype) and np.array_equal(k3, k.astype(np_dtype))


# --- engine: export -> import ----------------------------------------------


@pytest.mark.parametrize("exporter_pages", [0, 16], ids=["legacy_exporter", "paged_exporter"])
def test_paged_export_import_roundtrip_greedy_parity(tiny, exporter_pages):
    """Export on one port engine, import on a paged and on a legacy one:
    the greedy tokens are the JAX single engine's; the exporter seats no
    slot and takes no page, the importer frees its pages at the end."""
    _, params, refs = tiny
    sp = SamplingParams(max_new_tokens=8)
    ref = refs["prompt"][:8]
    assert len(set(ref)) > 2
    exporter = _port_engine(params, kv_page_tokens=exporter_pages)
    p = _export(exporter, PROMPT, sp)
    assert p["token"] == ref[0] and p["length"] == PROMPT.size
    assert tuple(p["k"].shape) == (2, 1, PROMPT.size, 2, 32)   # the prompt's rows only
    assert p["pageTokens"] == exporter_pages
    assert all(s is None for s in exporter._slot_req) and not exporter._requests
    assert not bool(exporter.state.active.any()) and exporter.tokens_total == 0
    if exporter_pages:
        assert exporter._pool.in_use == 0
    assert exporter.sync_stats["fetches"] == 3 and exporter.sync_stats["chunks"] == 0
    paged = _port_engine(params, kv_page_tokens=16)
    r = _import(paged, PROMPT, sp, p)
    assert r.generated == ref
    assert paged._pool.in_use == 0 and paged.prefix_misses == 0
    assert _import(_port_engine(params), PROMPT, sp, p).generated == ref
    # The block is what the import decodes from: zeroed rows do not.
    zeros = {**p, "k": torch.zeros_like(p["k"]), "v": torch.zeros_like(p["v"])}
    assert _import(_port_engine(params), PROMPT, sp, zeros).generated != ref


def test_export_reuses_the_legacy_prefix_cache_and_refuses_bad_requests(tiny):
    """A legacy exporter's prefix cache serves a session's later export
    (``prefill_ext_export``); a paged one takes no part. submit refuses
    export with import, a length other than the prompt's and a block of
    another shape."""
    _, params, refs = tiny
    sp = SamplingParams(max_new_tokens=5)
    longer, ref = LONGER, refs["longer"]
    for pages in (0, 16):
        eng = _port_engine(params, kv_page_tokens=pages)
        _export(eng, PROMPT, sp, prefix_id="s")
        p = _export(eng, longer, sp, prefix_id="s")
        assert (eng.prefix_hits, eng.prefix_misses) == ((1, 1) if not pages else (0, 0))
        if not pages:
            assert any(k[0] == "prefill_ext_export" for k in eng._prefill_programs.keys())
        assert _import(_port_engine(params, kv_page_tokens=16), longer, sp, p).generated == ref
    eng = _port_engine(params)
    p = _export(eng, PROMPT, sp)
    imp = {k: p[k] for k in ("token", "length", "k", "v")}
    with pytest.raises(ValueError, match="both export and import"):
        eng.submit(PROMPT, sp, export=True, kv_import=imp)
    with pytest.raises(ValueError, match="length"):
        eng.submit(PROMPT[:-1], sp, kv_import=imp)
    with pytest.raises(ValueError, match="shape"):
        eng.submit(PROMPT, sp, kv_import={**imp, "k": imp["k"][:1]})


def test_import_under_pool_pressure_parks_resumes_and_sheds(tiny, monkeypatch):
    """A paged import short of pages waits at the front while work is in
    flight and is seated when pages free; on an idle engine it is shed
    with RejectedError (429). Both give the reference's tokens."""
    _, params, refs = tiny
    sp = SamplingParams(max_new_tokens=40)
    other, ref = OTHER, refs["prompt"]
    p = _export(_port_engine(params), PROMPT, sp)
    eng = _port_engine(params, kv_page_tokens=16, kv_pool_pages=4)
    first = eng.submit(other, SamplingParams(max_new_tokens=33))   # 3 pages from its start
    eng.step()
    imp = eng.submit(PROMPT, sp, kv_import={k: p[k] for k in ("token", "length", "k", "v")})
    eng.step()
    assert imp.slot == -1 and list(eng._resume) == [imp]           # parked, not shed
    _drive(eng, [first, imp])
    assert imp.error is None and imp.generated == ref and eng._pool.in_use == 0
    # Idle, with the allocator failing twice (the reclaim retries once):
    # the import is shed, and the engine serves the next one.
    while eng.step():
        pass
    monkeypatch.setenv("KUKEON_FAULTS", "kv.alloc:1:2")
    faults.reset()
    try:
        shed = eng.submit(PROMPT, sp, kv_import={k: p[k] for k in ("token", "length", "k", "v")})
        _drive(eng, [shed])
        assert isinstance(shed.error, RejectedError) and eng.shed_stats["kv_exhausted"] == 1
    finally:
        monkeypatch.delenv("KUKEON_FAULTS")
        faults.reset()
    assert _import(eng, PROMPT, sp, p).generated == ref


def test_preempted_import_re_prefills_and_keeps_the_reference_tokens(tiny):
    """An import seated last is the preemption victim when the pool runs
    short; it resumes by re-prefilling prompt + generated on this engine
    and still streams the reference's tokens."""
    _, params, refs = tiny
    sp = SamplingParams(max_new_tokens=40)
    other, ref, ref_other = OTHER, refs["prompt"], refs["other"]
    p = _export(_port_engine(params), PROMPT, sp)
    eng = _port_engine(params, kv_page_tokens=16, kv_pool_pages=6)
    a = eng.submit(other, SamplingParams(max_new_tokens=60))
    eng.step()
    imp = eng.submit(PROMPT, sp, kv_import={k: p[k] for k in ("token", "length", "k", "v")})
    _drive(eng, [a, imp])
    assert imp.preemptions > 0 and eng.preemptions > 0
    assert imp.generated == ref and a.generated == ref_other
    assert eng._pool.in_use == 0


def test_mixtral_tiny_export_import_parity():
    """mixtral-tiny int8: a legacy export imported into a paged and into a
    legacy engine gives the JAX engine's greedy tokens."""
    jp = jm.quantize_params(jm.init_params(jax.random.key(0), jm.moe_tiny()))
    jeng = JaxEngine(jm.moe_tiny(), jp, make_mesh(tensor=1, devices=jax.devices()[:1]),
                     forward_fn=jm.forward, param_specs=moe_specs_for_params(jp), **ENGINE)
    ref = jeng.generate(PROMPT, JaxSamplingParams(max_new_tokens=8))
    params = convert.params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    sp = SamplingParams(max_new_tokens=8)
    p = _export(_port_engine(params, tm.moe_tiny(), forward_fn=tm.forward), PROMPT, sp)
    assert p["token"] == ref[0]
    for pages in (16, 0):
        eng = _port_engine(params, tm.moe_tiny(), kv_page_tokens=pages, forward_fn=tm.forward)
        assert _import(eng, PROMPT, sp, p).generated == ref


# --- across frameworks, through the gateway ---------------------------------


@pytest.mark.parametrize("direction,stream", [("jax_to_port", True), ("port_to_jax", False)],
                         ids=["jax_to_port-ndjson", "port_to_jax-json"])
def test_cross_framework_handoff_through_the_gateway(tiny, direction, stream):
    """A JAX prefill cell and a port decode cell (or the reverse) on the
    same weights behind the reference's gateway: the two-hop answer is the
    JAX single engine's greedy tokens."""
    _, params, refs = tiny
    ref = refs["prompt"][:8]
    jcell, jsrv = _jax_cell("prefill" if direction == "jax_to_port" else "decode")
    tcell, tsrv = _make_cell("decode" if direction == "jax_to_port" else "prefill")
    tcell.engine.stop()
    tcell.engine = _port_engine(params, kv_page_tokens=16, max_pending=256)
    tcell.engine.start()
    order = [(jcell, jsrv), (tcell, tsrv)]
    if direction == "port_to_jax":
        order.reverse()
    cells, servers = [c for c, _ in order], [s for _, s in order]
    gw, gw_srv = _gateway([f"http://127.0.0.1:{s.server_address[1]}" for s in servers])
    try:
        body = {"promptTokens": PROMPT.tolist(), "maxNewTokens": 8, "stream": stream}
        if stream:
            status, data = _post(gw_srv.server_address[1], "/v1/generate", body, raw=True)
            lines = [json.loads(ln) for ln in data.splitlines()]
            tokens = [ln["token"] for ln in lines if "token" in ln]
            assert lines[-1]["done"] and lines[-1]["tokens"] == tokens
        else:
            status, out, _ = _post(gw_srv.server_address[1], "/v1/generate", body)
            tokens = out["tokens"]
        assert status == 200 and tokens == ref
        assert gw.registry.get("kukeon_handoff_pages_total").value() == PROMPT.size // 16 + 1
        assert gw.registry.get("kukeon_handoff_fallback_total").value() == 0
    finally:
        _teardown(cells, servers, gw, gw_srv)


# --- the handoff's programs --------------------------------------------------


@pytest.mark.parametrize("pages", [0, 16], ids=["legacy", "paged"])
@pytest.mark.parametrize("kv8", [False, True], ids=["kv_fp", "kv_int8"])
def test_export_and_insert_keys_equal_the_fused_prefill_bitwise(tiny, pages, kv8):
    """From one state: the export key's block and first token are the
    fused prefill's, bitwise; the insert-only key, given that block and
    token, leaves the decode state the fused key left (paged: the pool
    outside page 0), bitwise."""
    _, params, _ = tiny
    eng = _port_engine(params, kv_page_tokens=pages, kv_cache_int8=kv8, num_slots=3)
    busy = eng.submit(np.arange(40, 75, dtype=np.int32), SamplingParams(max_new_tokens=30))
    for _ in range(3):
        eng.step()                                   # a slot decoding, others free
    progs = eng._prefill_programs
    req = eng.submit(PROMPT, SamplingParams(max_new_tokens=4))
    eng._pop_waiting()
    slot, S = 1, 64
    if pages:
        pages_ = eng._pool.alloc(PROMPT.size // 16 + 1)
        fused_key = eng._stage_prefill_paged(req, slot, PROMPT, None, pages_)
    else:
        fused_key = eng._stage_prefill(req, slot)
    assert fused_key[:2] == (("prefill_paged" if pages else "prefill"), S)
    staged = progs.inputs.clone()
    snap = progs.snapshot_key(fused_key)
    state0 = {n: t.clone() for n, t in eng.state.buffers().items()}
    progs.run(fused_key)
    fused = {n: t.clone() for n, t in eng.state.buffers().items()}
    block = [t.clone() for t in progs.block(fused_key)]
    first = eng.state.tokens[slot].clone()

    # Export, from the same state and inputs (the export reads the tokens).
    progs.restore(snap)
    export_key = prefill_key(S, req.sampling, export=True)
    progs.inputs.copy_(staged)
    progs.run(export_key)
    for a, b in zip(progs.block(export_key), block):
        assert torch.equal(a, b)
    assert torch.equal(progs.first, first.reshape(1))
    for n, t in eng.state.buffers().items():         # no slot, table or page touched
        assert torch.equal(t, state0[n]), n

    # Insert-only, from the same state, the fused block and first token.
    progs.restore(snap)
    for n, t in eng.state.buffers().items():
        assert torch.equal(t, state0[n]), n
    progs.inputs.copy_(staged)
    progs.inputs[HEADER] = int(first)                # the first token, where tokens sit
    progs.block_k[:, :, :S].copy_(block[0])
    progs.block_v[:, :, :S].copy_(block[1])
    progs.run(insert_key(S, bool(pages)))
    for n, t in eng.state.buffers().items():
        want = fused[n]
        if pages and n in ("k", "v", "k_scale", "v_scale"):
            t, want = t[:, 1:], want[:, 1:]          # page 0 (scratch) aside
        assert torch.equal(t, want), n
    assert busy.error is None


def test_every_fault_point_of_the_port_is_declared_and_the_references():
    """Each ``maybe_fail`` call site of the port names a point of
    ``faults.POINTS``, and each of those is a point of the reference's list
    (``kukeon_tpu/faults.py``), so one ``KUKEON_FAULTS`` arms both."""
    import pathlib
    import re

    from kukeon_tpu import faults as jfaults

    root = pathlib.Path(__file__).resolve().parent.parent / "kukeon_tpu_torch"
    used = {m for f in root.rglob("*.py") if f.name != "faults.py"
            for m in re.findall(r'maybe_fail\("([^"]+)"\)', f.read_text())}
    assert {"kv.handoff", "engine.upload", "checkpoint.stream", "profile.layers"} <= used
    assert used <= set(faults.POINTS), used
    assert set(faults.POINTS) <= set(jfaults.POINTS)
