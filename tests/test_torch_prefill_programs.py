"""The port's prefill programs (``PrefillPrograms`` in
``kukeon_tpu_torch/serving/programs.py``: the reference's ``prefill``,
``prefill_ext`` and ``insert``, ``kukeon_tpu/serving/engine.py:753-829``)
through its engine, on the CPU, where each program runs eagerly on the
same static buffers a CUDA graph reads on the GPU.

- ``precompile(prompt_lens)`` builds the greedy prefill of exactly those
  buckets (the reference's ``:1285-1309``);
- any other bucket, sampling branch or ``prefill_ext`` pair is built
  once, at its first use, and every static buffer keeps its storage;
- three prompts of one bucket admitted in one ``step()`` share the
  programs' static inputs and block, and each still streams its own
  tokens (the JAX engine's);
- a program run is undone by its snapshot (how a capture while slots
  decode leaves them as it found them), and touches no other slot;
- a step's prefills make one blocking fetch (the stacked first tokens)
  and one upload each; the engine loop's error path zeroes the buffers
  in place.
"""

import threading
import time

import jax
import numpy as np
import pytest
import torch
from test_torch_engine_programs import _engine, _pointers, models  # noqa: F401 — fixture

from kukeon_tpu.parallel import make_mesh
from kukeon_tpu.serving import ServingEngine as JaxEngine
from kukeon_tpu_torch.serving import Request, SamplingParams
from kukeon_tpu_torch.serving.programs import HEADER, pack_prefill_inputs, prefill_key

torch.set_num_threads(2)

FAMILIES = ("llama", "mixtral")


def _all_pointers(eng):
    ptrs = _pointers(eng)
    ptrs.update({n: t.data_ptr() for n, t in eng._prefill_programs.buffers().items()})
    return ptrs


def _drive(eng, reqs):
    while not all(r.done.is_set() for r in reqs):
        eng.step()


@pytest.mark.parametrize("prompt_lens,buckets", [((8,), (64,)),
                                                 ((8, 100, 64, 130), (64, 128, 256)),
                                                 ((300,), (256,))])
def test_precompile_builds_the_greedy_prefill_of_each_bucket(models, prompt_lens, buckets):
    eng = _engine(models, "llama", num_slots=2, max_seq_len=256, decode_chunk=4)
    eng.precompile(prompt_lens)
    want = sorted(("prefill", b, False, False) for b in buckets)
    assert eng._prefill_programs.keys() == want
    stats = eng.program_stats["prefill"]
    assert stats["captures"] == len(want) and stats["captures_after_warmup"] == 0
    eng.precompile(prompt_lens)                              # builds nothing more
    assert stats["captures"] == len(want)
    eng.warmup(min(prompt_lens[0], 255))                     # its bucket is built
    assert eng._prefill_programs.keys() == want and stats["captures"] == len(want)
    assert stats["replays"] == 1 and stats["static_bytes"] > 0
    # The precompile's warm-up inputs went into slot 0; the capture put it
    # back, so the warmup request's stream is the plain one.
    assert not bool(eng.state.active.any())


@pytest.mark.parametrize("family", FAMILIES)
def test_first_use_builds_each_key_once_and_keeps_static_buffers(models, family):
    eng = _engine(models, family, num_slots=3, max_seq_len=256, decode_chunk=4)
    eng.precompile((64,))
    eng.warmup(64)
    ptrs = _all_pointers(eng)
    rng = np.random.default_rng(1)
    sessions = [rng.integers(1, 512, n).astype(np.int32) for n in (30, 90, 150)]
    hot = SamplingParams(max_new_tokens=3, temperature=0.9, top_k=9)

    def traffic():
        reqs = []
        for i, p in enumerate(sessions):
            reqs.append(eng.submit(p, SamplingParams(max_new_tokens=3), prefix_id=f"s{i}"))
            reqs.append(eng.submit(p[:20], hot))
        _drive(eng, reqs)
        grown = [eng.submit(np.concatenate([p, np.asarray(r.generated, np.int32)]),
                            SamplingParams(max_new_tokens=3), prefix_id=f"s{i}")
                 for i, (p, r) in enumerate(zip(sessions, reqs[::2]))]
        _drive(eng, grown)
        return [r.generated for r in reqs + grown]

    first = traffic()
    stats = eng.program_stats["prefill"]
    keys = eng._prefill_programs.keys()
    assert ("prefill", 64, True, True) in keys          # the stochastic branch, first use
    assert {k[:3] for k in keys if k[0] == "prefill_ext"} == {
        ("prefill_ext", 64, 64), ("prefill_ext", 128, 64), ("prefill_ext", 256, 64)}
    assert stats["captures"] == len(keys)
    assert stats["captures_after_warmup"] == len(keys) - 1       # all but the precompiled one
    captures = stats["captures"]
    second = traffic()
    assert stats["captures"] == captures, "a prefill program was built twice"
    assert eng.prefix_hits == 6 and eng.prefix_misses == 3 + 3
    assert _all_pointers(eng) == ptrs
    greedy = [0, 2, 4, 6, 7, 8]                       # the streams that do not sample
    assert [first[i] for i in greedy] == [second[i] for i in greedy]


@pytest.mark.parametrize("family", FAMILIES)
def test_three_prompts_of_one_bucket_in_one_step_keep_their_own_tokens(models, family):
    """Three prefills of bucket 64 in one step() run on the same static
    inputs and block, one after the other: each first token is read back
    from its own slot, and every stream equals the JAX engine's."""
    rng = np.random.default_rng(2)
    prompts = [rng.integers(1, 512, n).astype(np.int32) for n in (12, 40, 63)]
    teng = _engine(models, family, num_slots=3, max_seq_len=128, decode_chunk=4)
    reqs = [teng.submit(p, SamplingParams(max_new_tokens=6)) for p in prompts]
    teng.step()
    assert all(len(r.generated) == 1 for r in reqs)
    assert teng.program_stats["prefill"]["replays_by_key"] == {str(("prefill", 64, False, False)): 3}
    _drive(teng, reqs)
    jkw = dict(models[family][0])
    jeng = JaxEngine(jkw.pop("cfg"), jkw.pop("params"),
                     make_mesh(tensor=1, devices=jax.devices()[:1]),
                     num_slots=3, max_seq_len=128, decode_chunk=4, **jkw)
    jreqs = [jeng.submit(p, SamplingParams(max_new_tokens=6)) for p in prompts]
    _drive(jeng, jreqs)
    got = [r.generated for r in reqs]
    assert len({g[0] for g in got}) > 1          # a shared first token would show
    assert got == [list(r.generated) for r in jreqs]


@pytest.mark.parametrize("family", FAMILIES)
@pytest.mark.parametrize("kind", ["prefill", "prefill_ext"])
def test_snapshot_undoes_a_prefill_run_while_slots_decode(models, family, kind):
    """What a capture mid-traffic relies on: a prefill program's run writes
    only its slot's rows, and its snapshot puts back everything it wrote
    (the block a ``prefill_ext`` reads included), so the decoding slots
    keep their tokens and KV."""
    eng = _engine(models, family, num_slots=3, max_seq_len=256, decode_chunk=4)
    rng = np.random.default_rng(4)
    decoding = [eng.submit(rng.integers(1, 512, n).astype(np.int32),
                           SamplingParams(max_new_tokens=60)) for n in (21, 70)]
    stored = rng.integers(1, 512, 50).astype(np.int32)
    seed = eng.submit(stored, SamplingParams(max_new_tokens=1), prefix_id="p")
    for _ in range(3):
        eng.step()
    assert seed.done.is_set() and not any(r.done.is_set() for r in decoding)
    prompt = np.concatenate([stored, rng.integers(1, 512, 9).astype(np.int32)])
    req = Request(id=-1, prompt=prompt, sampling=SamplingParams(temperature=0.7, top_p=0.9),
                  prefix_id="p" if kind == "prefill_ext" else None)
    progs, st = eng._prefill_programs, eng.state
    key = eng._stage_prefill(req, 2)                      # the free slot
    assert key[0] == kind and key[-2:] == (True, True)
    before = {n: t.clone() for n, t in st.buffers().items()}
    block = [t.clone() for t in progs.block(key)]
    snap = progs.snapshot_key(key)
    progs.run_eager(key)
    after = {n: t.clone() for n, t in st.buffers().items()}
    for n in ("k", "v", "k_scale", "v_scale"):
        if n in after:                                   # other slots untouched
            assert torch.equal(after[n][:, :2], before[n][:, :2]), n
    assert torch.equal(after["tokens"][:2], before["tokens"][:2])
    assert int(after["lengths"][2]) == prompt.size and bool(after["active"][2])
    first = int(after["tokens"][2])
    progs.restore(snap)
    for n, t in st.buffers().items():
        assert torch.equal(t, before[n]), n
    assert all(torch.equal(a, b) for a, b in zip(progs.block(key), block))
    progs.run_eager(key)                                  # the generator state came back too
    assert int(st.tokens[2]) == first
    progs.restore(snap)
    for r in decoding:
        r.cancel()
    _drive(eng, decoding)


def test_prefill_sync_budget(models):
    """A step's prefills make one upload each (the packed inputs) and one
    blocking fetch in all (the stacked first tokens), hits included."""
    eng = _engine(models, "llama", num_slots=3, max_seq_len=256, decode_chunk=4)
    rng = np.random.default_rng(6)
    prompts = [rng.integers(1, 512, n).astype(np.int32) for n in (9, 33, 70)]
    for round_ in range(2):
        if round_:
            prompts = [np.concatenate([p, [5, 6]]).astype(np.int32) for p in prompts]
        base = dict(eng.sync_stats)
        reqs = [eng.submit(p, SamplingParams(max_new_tokens=1), prefix_id=f"s{i}")
                for i, p in enumerate(prompts)]
        eng.step()
        d = {k: eng.sync_stats[k] - base[k] for k in base}
        assert all(r.done.is_set() for r in reqs)
        assert d["fetches"] == 1 and d["uploads"] == 3 and d["chunks"] == 0, d
    assert eng.prefix_hits == 3


def test_error_path_resets_the_prefill_buffers_in_place(models):
    prompt = np.arange(2, 13, dtype=np.int32)
    want = _engine(models, "llama", num_slots=2, max_seq_len=64,
                   decode_chunk=4).generate(prompt, SamplingParams(max_new_tokens=5))
    eng = _engine(models, "llama", num_slots=2, max_seq_len=64, decode_chunk=4)
    eng.precompile((8,))
    ptrs = _all_pointers(eng)
    progs = eng._prefill_programs
    real, calls = progs.run, {"n": 0}

    def failing_once(key):
        real(key)                           # the buffers are written, then the fault
        calls["n"] += 1
        if calls["n"] == 1:
            raise RuntimeError("injected prefill fault")

    progs.run = failing_once
    eng.start()
    try:
        doomed = eng.submit(np.arange(1, 20, dtype=np.int32), SamplingParams(max_new_tokens=9))
        assert doomed.done.wait(60)
        assert isinstance(doomed.error, RuntimeError) and "injected" in str(doomed.error)
        # The engine's loop resets the buffers just after it fails the request.
        deadline = time.monotonic() + 30
        while any(bool(t.any()) for t in progs.buffers().values()):
            assert time.monotonic() < deadline, "the prefill buffers were not reset"
            time.sleep(0.01)
        assert not bool(eng.state.active.any())
        assert _all_pointers(eng) == ptrs
        out = [None]

        def run():
            out[0] = eng.generate(prompt, SamplingParams(max_new_tokens=5))

        t = threading.Thread(target=run)
        t.start()
        t.join(timeout=60)
        assert not t.is_alive()
    finally:
        eng.stop()
    assert out[0] == want
    assert _all_pointers(eng) == ptrs


def test_packed_inputs_and_keys():
    sp = SamplingParams(temperature=0.8, top_k=5, top_p=0.9)
    packed = pack_prefill_inputs(np.array([7, 8, 9]), 8, 40, 2, 37, sp)
    assert packed.shape == (HEADER + 8,) and list(packed[:4]) == [40, 2, 37, 5]
    assert list(packed[4:HEADER].view(np.float64)) == [0.8, 0.9]
    assert list(packed[HEADER:]) == [7, 8, 9, 0, 0, 0, 0, 0]
    assert prefill_key(64, sp) == ("prefill", 64, True, True)
    assert prefill_key(64, SamplingParams(top_k=5), 128) == ("prefill_ext", 128, 64, False, False)
    assert prefill_key(64, SamplingParams(temperature=1.0), 128) == (
        "prefill_ext", 128, 64, False, True)
