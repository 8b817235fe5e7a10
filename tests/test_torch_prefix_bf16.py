"""Prefix-cache hits in bf16, the port against the JAX engine, on the CPU
(ROADMAP C5): ``tiny`` with ``dtype=bfloat16`` in both packages and the
same weights, a 5-turn ``prefixId`` chain whose every turn is the previous
prompt, its greedy tokens and a new 12-token message.

For every hit turn, each engine's first-token logits from the hit
(``prefill_ext`` over the new tail against the stored block, which is
itself built by a chain of hits) are held to that engine's own full
prefill of the same prompt, and the port's hit logits to the reference's.
The port's logits come from its prefill program (``PrefillPrograms.logits``
on the staged inputs); the reference's from its own forward on its own
stored block, as its ``prefill_ext`` (``kukeon_tpu/serving/engine.py:764``)
and ``prefill`` (``:753``) compute them. Both chains send the same prompts,
built from the JAX engine's greedy tokens.

What this shows: on the CPU a bf16 hit drifts from the full prefill by
nothing in either engine (the tolerance below, 2^-10 of the top logit, is
under one bf16 rounding), and the port's hit differs from the reference's
by no more than the two frameworks' full prefills differ from each other.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kukeon_tpu.models import llama as jl
from kukeon_tpu.parallel import make_mesh
from kukeon_tpu.serving import SamplingParams as JaxSamplingParams
from kukeon_tpu.serving import ServingEngine as JaxEngine
from kukeon_tpu_torch.models import convert
from kukeon_tpu_torch.models import llama as tl
from kukeon_tpu_torch.serving import SamplingParams, ServingEngine
from kukeon_tpu_torch.serving.engine import Request

torch.set_num_threads(2)

TURNS, FIRST, USER, NEW = 5, 60, 12, 8
# A hit against its own engine's full prefill: under one bf16 rounding
# (2^-8) of the top logit.
DRIFT_TOL = 2.0 ** -10
# The port's logits against the reference's, hit or full: bf16 through two
# frameworks (measured 0.0078-0.0100 of the top logit on both paths).
CROSS_TOL = 0.03

JCFG = dataclasses.replace(jl.llama_tiny(), dtype=jnp.bfloat16)
TCFG = dataclasses.replace(tl.llama_tiny(), dtype=torch.bfloat16)


def _pad(x: np.ndarray, n: int) -> np.ndarray:
    out = np.zeros((1, n), np.int32)
    out[0, :x.size] = x
    return out


@jax.jit
def _jax_full(params, tokens, n):
    """The reference's ``prefill`` logits: the prompt in its bucket."""
    S = tokens.shape[1]
    cache = jl.KVCache.create(JCFG, 1, S)
    logits, _ = jl.forward(params, JCFG, tokens, jnp.arange(S)[None], cache,
                           logit_positions=jnp.reshape(n - 1, (1,)))
    return logits[0, 0]


@jax.jit
def _jax_ext(params, kv_k, kv_v, plen, tokens, n_tail):
    """The reference's ``prefill_ext`` logits: the tail at plen.. against
    the stored block."""
    S, Pb = tokens.shape[1], kv_k.shape[2]
    base = jl.KVCache.create(JCFG, 1, Pb + S)
    cache = jl.KVCache(k=jax.lax.dynamic_update_slice(base.k, kv_k, (0,) * 5),
                       v=jax.lax.dynamic_update_slice(base.v, kv_v, (0,) * 5),
                       lengths=jnp.full((1,), plen, jnp.int32))
    logits, _ = jl.forward(params, JCFG, tokens, plen + jnp.arange(S)[None], cache,
                           logit_positions=jnp.reshape(n_tail - 1, (1,)))
    return logits[0, 0]


def _jax_logits(eng, prompt, hit: bool) -> np.ndarray:
    if hit:
        e = eng._prefix_cache["chain"]
        assert prompt.size > e.length and np.array_equal(prompt[:e.length], e.tokens)
        tail = prompt[e.length:]
        out = _jax_ext(eng.params, e.kv_k, e.kv_v, e.length,
                       _pad(tail, eng._bucket(tail.size)), tail.size)
    else:
        out = _jax_full(eng.params, _pad(prompt, eng._bucket(prompt.size)), prompt.size)
    return np.asarray(out, np.float32)


def _port_logits(eng, prompt, hit: bool) -> np.ndarray:
    req = Request(-1, prompt, SamplingParams(), prefix_id="chain" if hit else None)
    key = eng._stage_prefill(req, 0)
    assert (key[0] == "prefill_ext") == hit, key
    with torch.no_grad():
        return eng._prefill_programs.logits(key)[0].float().numpy()


def _turn(eng, prompt, sp) -> list[int]:
    r = eng.submit(prompt, sp, prefix_id="chain")
    while not r.done.is_set():
        eng.step()
    assert r.error is None, r.error
    return list(r.generated)


@pytest.fixture(scope="module")
def chain():
    """Per hit turn: (jax hit, jax full, port hit, port full) logits."""
    jp = jl.init_params(jax.random.key(0), JCFG)
    assert jp["layers"]["wq"].dtype == jnp.bfloat16
    tp = convert.params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    kw = dict(num_slots=2, max_seq_len=256, decode_chunk=4)
    jeng = JaxEngine(JCFG, jp, make_mesh(tensor=1, devices=jax.devices()[:1]), **kw)
    teng = ServingEngine(TCFG, tp, device="cpu", **kw)
    rng = np.random.default_rng(0)
    prompt = rng.integers(1, TCFG.vocab_size, FIRST).astype(np.int32)
    rows = []
    for turn in range(TURNS):
        if turn:
            rows.append((_jax_logits(jeng, prompt, True), _jax_logits(jeng, prompt, False),
                         _port_logits(teng, prompt, True), _port_logits(teng, prompt, False)))
        want = _turn(jeng, prompt, JaxSamplingParams(max_new_tokens=NEW))
        _turn(teng, prompt, SamplingParams(max_new_tokens=NEW))
        prompt = np.concatenate([prompt, np.asarray(want, np.int32),
                                 rng.integers(1, TCFG.vocab_size, USER).astype(np.int32)])
    assert (jeng.prefix_misses, jeng.prefix_hits) == (1, TURNS - 1)
    assert teng.prefix_misses == 1
    return rows


def _share(a: np.ndarray, b: np.ndarray) -> float:
    return float(np.abs(a - b).max() / np.abs(b).max())


@pytest.mark.parametrize("turn", range(2, TURNS + 1))
def test_bf16_hit_drifts_from_full_prefill_alike_in_both_engines(chain, turn):
    jhit, jfull, thit, tfull = chain[turn - 2]
    jax_drift, port_drift = _share(jhit, jfull), _share(thit, tfull)
    assert jax_drift <= DRIFT_TOL, f"reference hit vs full: {jax_drift}"
    assert port_drift <= DRIFT_TOL, f"port hit vs full: {port_drift}"
    assert int(thit.argmax()) == int(tfull.argmax()) == int(jhit.argmax())


@pytest.mark.parametrize("turn", range(2, TURNS + 1))
def test_bf16_port_hit_is_as_close_to_the_reference_as_the_full_prefill(chain, turn):
    jhit, jfull, thit, tfull = chain[turn - 2]
    hit_gap, full_gap = _share(thit, jhit), _share(tfull, jfull)
    assert hit_gap <= CROSS_TOL and full_gap <= CROSS_TOL, (hit_gap, full_gap)
    # The hit path adds nothing to the frameworks' own difference.
    assert hit_gap <= full_gap + DRIFT_TOL, (hit_gap, full_gap)
