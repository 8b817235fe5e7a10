"""Sequence parallelism of the port (ring and Ulysses attention on a
``seq`` axis, the trainer at ``seq`` > 1) against the JAX package, on gloo
ranks on the CPU.

- ``ring_attention`` on ``seq=8`` and on ``data=2, seq=4``, and
  ``ulysses_attention`` on ``data=2, seq=2, tensor=2`` at 8 q and 4 kv
  heads: each rank's block of the output and of the q, k and v gradients
  (of ``sum(out * cotangent)``) against the JAX functions on
  ``make_mesh(**axes)`` over 8 forced CPU devices, within 1e-5 in f32
  (the reference's own tolerance); Ulysses' head-count refusal in the
  reference's words.
- ``tiny`` f32 through ``MeshTrainer`` against the JAX ``make_train_step``
  on ``data=2, seq=4`` (the JAX test's ``dp2_sp4``) and ``seq=2, fsdp=2,
  tensor=2``, 3 steps at lr 1e-2, warmup 1, B 8, S 32, under the mesh
  training rule (losses and moments within 1e-5; a param may leave it at
  no more than 1e-4 of a leaf's elements, by at most a hundredth of a
  step); the same with ``use_ring_attention=False`` on both sides (the
  forced ``auto`` path, which must see every key); ring against Ulysses
  against the one-device loss, as ``tests/test_ulysses.py`` holds the
  reference's; a one-rank mesh step bit for bit the one-device step.

The ranks run ``tests/torch_rank_calls.py``'s functions; the JAX side runs
in one child process for the whole file (``tests/torch_jax_refs.py``,
:func:`refs`). One rank group at a time serves the file (:func:`_mesh`),
and its collectives and rendezvous time out after ``GROUP_TIMEOUT_S``, so
no case can hang the suite.
"""

import dataclasses

import numpy as np
import pytest
import torch

from kukeon_tpu_torch.models import llama as tl
from kukeon_tpu_torch.parallel import launch
from kukeon_tpu_torch.parallel.mesh import make_mesh
from kukeon_tpu_torch.parallel.sharding import Recipe
from kukeon_tpu_torch.parallel.ulysses import ulysses_attention
from kukeon_tpu_torch.training import data as tdata
from kukeon_tpu_torch.training import train_step as tts
from kukeon_tpu_torch.training.mesh_trainer import MeshTrainer
from tests import torch_jax_refs
from tests import torch_rank_calls as calls

torch.set_num_threads(2)

TOL = dict(rtol=1e-5, atol=1e-5)
B, S, STEPS, LR = 8, 32, 3, 1e-2
GROUP_TIMEOUT_S = "60"
# Adam's direction on an element whose gradient sits at the f32 rounding
# floor is set by that rounding (tests/test_torch_mesh_training.py): a
# param may leave 1e-5 at no more than RARE of a leaf's elements, by at
# most a hundredth of a step.
RARE, RARE_TOL = 1e-4, LR * 1e-2


@pytest.fixture(scope="module", autouse=True)
def _groups():
    mp = pytest.MonkeyPatch()
    mp.setenv(launch.TIMEOUT_ENV, GROUP_TIMEOUT_S)
    yield
    launch.shutdown()
    mp.undo()


def _mesh(data=1, fsdp=1, seq=1, tensor=1):
    """The leader's mesh of gloo ranks: the open group when it has this
    shape, else a new one (the other closed first)."""
    g = launch.current()
    if g is not None and (g.world, g.fsdp, g.seq, g.pipe, g.tensor) != (
            data * fsdp * seq * tensor, fsdp, seq, 1, tensor):
        launch.shutdown()
    return make_mesh(data, tensor, "cpu", fsdp=fsdp, seq=seq)


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("data") / "tok.bin")
    tdata.TokenDataset.write(path, np.random.default_rng(5).integers(0, 512, 20000))
    return path


RING_CASES = {"seq8": (dict(seq=8), (2, 32, 4, 2, 16)),
              "data2_seq4": (dict(data=2, seq=4), (4, 16, 2, 1, 8))}
ULYSSES_AXES, ULYSSES_SHAPE = dict(data=2, seq=2, tensor=2), (4, 16, 8, 4, 8)
TRAIN_CASES = {"ring": (dict(data=2, seq=4), {}),
               "auto": (dict(data=2, seq=4), {"use_ring_attention": False}),
               "seq2_fsdp2_tensor2": (dict(seq=2, fsdp=2, tensor=2), {})}


@pytest.fixture(scope="module")
def refs(dataset, tmp_path_factory):
    """Every JAX reference of the file, computed in one child process."""
    jobs = [(f"ring_{name}", "attention", dict(fn="ring", axes=axes, **_inputs(shape)))
            for name, (axes, shape) in RING_CASES.items()]
    jobs.append(("ulysses", "attention", dict(fn="ulysses", axes=ULYSSES_AXES,
                                              **_inputs(ULYSSES_SHAPE, seed=11))))
    jobs.append(("ulysses_refusal", "ulysses_refusal", dict(axes=dict(seq=4, data=2),
                                                            q_heads=8, kv_heads=2)))
    jobs += [(f"train_{name}", "train", dict(axes=axes, dataset=dataset, batch=B,
                                             seq_len=S, steps=STEPS, **kw))
             for name, (axes, kw) in TRAIN_CASES.items()]
    jobs.append(("heads84", "train", dict(axes=ULYSSES_AXES, dataset=dataset, batch=B,
                                          seq_len=S, steps=0, one_device_loss=True,
                                          num_heads=8, num_kv_heads=4)))
    return torch_jax_refs.compute(jobs, str(tmp_path_factory.mktemp("jax")))


def _inputs(shape, seed=None) -> dict:
    """q, k, v, a cotangent and positions of ``shape`` (B, S, H, KV, D),
    f32, from a seed (the shape's sum by default)."""
    b, s, h, kv, d = shape
    rng = np.random.default_rng(sum(shape) if seed is None else seed)
    q, k, v, cot = (rng.standard_normal(x).astype(np.float32)
                    for x in ((b, s, h, d), (b, s, kv, d), (b, s, kv, d), (b, s, h, d)))
    pos = np.broadcast_to(np.arange(s, dtype=np.int32)[None, :], (b, s)).copy()
    return dict(q=q, k=k, v=v, cot=cot, pos=pos)


def _assert_blocks(got: list, want: list):
    """Every rank's blocks of (out, dq, dk, dv) against the whole arrays.
    The k/v gradients of ranks that share a block (tensor peers of a
    replicated head) are each the whole gradient of it."""
    out, dq, dk, dv = want
    for coords, *blocks in got:
        r0, r1, c0, c1, q0, q1, k0, k1 = coords
        for name, g, w in zip(("out", "dq", "dk", "dv"), blocks,
                              (out[r0:r1, c0:c1, q0:q1], dq[r0:r1, c0:c1, q0:q1],
                               dk[r0:r1, c0:c1, k0:k1], dv[r0:r1, c0:c1, k0:k1])):
            np.testing.assert_allclose(g, w, err_msg=f"{name} at {coords}", **TOL)


@pytest.mark.parametrize("case", list(RING_CASES))
def test_ring_attention_matches_the_jax_ring(case, refs):
    """The reference's two ring cases (``tests/test_ring_attention.py``):
    out and the q, k, v gradients, every rank's block."""
    axes, shape = RING_CASES[case]
    got = calls.run(_mesh(**axes), "tests.torch_rank_calls:seq_attention", impl="ring",
                    **_inputs(shape))
    assert len(got) == 8
    _assert_blocks(got, refs[f"ring_{case}"])


def _recipe(init: dict, path) -> Recipe:
    """A recipe of the JAX init's leaves (``{"params.a.b": array}``)."""
    np.savez(path, **{k[len("params."):].replace(".", "/"): v for k, v in init.items()})
    return Recipe("kukeon_tpu_torch.models.convert:npz_leaves", {"path": str(path)})


def _trainer(mesh, dataset, init=None, **kw):
    return MeshTrainer(mesh, model="tiny", dataset=dataset, batch=B, seq_len=S, lr=LR,
                       warmup_steps=1, total_steps=10, init=init, **kw)


def _assert_state_close(got: dict, want: dict):
    assert sorted(got) == sorted(want)
    for name in want:
        a, b = got[name].numpy(), want[name]
        if not name.startswith("params."):
            np.testing.assert_allclose(a, b, err_msg=name, **TOL)
            continue
        off = ~np.isclose(a, b, **TOL)
        assert off.sum() <= RARE * off.size, (name, off.sum())
        np.testing.assert_allclose(a, b, err_msg=name, rtol=0, atol=RARE_TOL)


@pytest.mark.parametrize("case", ["ring", "auto"])
def test_seq_steps_match_the_jax_dp2_sp4_step(case, refs, dataset, tmp_path, monkeypatch):
    """``data=2, seq=4``: the reference's step takes ring attention there
    (``use_ring_attention`` default); forced off, it attends through
    ``auto``, whose keys are the whole sequence's: the port gathers them
    over ``seq`` (the leader's attention sees 32 keys for its 8 queries)."""
    axes, kw = TRAIN_CASES[case]
    want = refs[f"train_{case}"]
    seen = []
    if case == "auto":
        real = tl.gqa_attention

        def spy(q, k, *a, **kw):
            seen.append((q.shape[1], k.shape[1], kw.get("impl")))
            return real(q, k, *a, **kw)

        monkeypatch.setattr(tl, "gqa_attention", spy)
    tr = _trainer(_mesh(**axes), dataset, _recipe(want["init"], tmp_path / "init.npz"), **kw)
    try:
        losses = [float(tr.step(i)) for i in range(STEPS)]
        np.testing.assert_allclose(losses, want["losses"], **TOL)
        _assert_state_close(tr.full_state(), want["state"])
        assert tr.replica_mismatches() == []
    finally:
        tr.close()
    if case == "auto":
        assert seen and set(seen) == {(S // 4, S, "auto")}


def test_ulysses_matches_the_jax_ulysses_and_refuses_as_it_does(refs):
    """``data=2, seq=2, tensor=2`` at 8 q and 4 kv heads (the reference's
    ``test_ulysses_composes_with_tensor_axis``): every rank's blocks of
    out and of the gradients. At ``seq`` 4 with 2 kv heads, the port's
    refusal is the reference's, word for word."""
    got = calls.run(_mesh(**ULYSSES_AXES), "tests.torch_rank_calls:seq_attention",
                    impl="ulysses", **_inputs(ULYSSES_SHAPE, seed=11))
    _assert_blocks(got, refs["ulysses"])
    q, k = torch.zeros((2, 4, 8, 8)), torch.zeros((2, 4, 2, 8))
    pos = torch.arange(4, dtype=torch.int32)[None, :].expand(2, 4)
    four = type("Seq4", (), {"axis_size": staticmethod(lambda axis: 4)})()
    with pytest.raises(ValueError) as err:
        # The check runs before any collective: no peer is needed.
        ulysses_attention(q, k, k, q_positions=pos, kv_positions=pos, mesh=four)
    assert str(err.value) == refs["ulysses_refusal"]


def test_ring_and_ulysses_losses_match_the_one_device_loss(refs, dataset, tmp_path):
    """The reference's ``test_train_step_with_ulysses_attention``: ``tiny``
    with 8 heads and 4 kv heads on ``data=2, seq=2, tensor=2``, each rank's
    ``forward_train(attn_impl=)`` loss through Ulysses and through the ring
    is the one-device step's first loss within 1e-5 relative, and so is
    the JAX plain forward's."""
    cfg = dataclasses.replace(tl.llama_tiny(), num_heads=8, num_kv_heads=4)
    init = refs["heads84"]["init"]
    recipe = _recipe(init, tmp_path / "init.npz")
    opt = tts.make_optimizer(LR, warmup_steps=1, total_steps=10)
    params = tl.nest(recipe.resolve()(device="cpu", **recipe.kwargs))
    state = tts.TrainState(params=params, opt_state=opt.init(params), step=0)
    _s, tok, tgt, mask = next(tdata.batches(tdata.TokenDataset(dataset), B, S, num_steps=1,
                                            device="cpu"))
    _, one = tts.make_train_step(cfg, opt)(state, tok, tgt, mask)
    full = {k[len("params."):].replace(".", "/"): v for k, v in init.items()}
    for impl in ("ulysses", "ring"):
        got = calls.run(_mesh(**ULYSSES_AXES), "tests.torch_rank_calls:seq_loss", impl=impl,
                        cfg=cfg, params=full, tokens=tok.numpy(), targets=tgt.numpy(),
                        mask=mask.numpy())
        assert len(got) == 8
        assert got == pytest.approx([float(one)] * 8, rel=1e-5), impl
    assert refs["heads84"]["one_device_loss"] == pytest.approx(float(one), rel=1e-5)


def test_seq_fsdp_tensor_steps_match_the_jax_sharded_step(refs, dataset, tmp_path):
    """``seq=2, fsdp=2, tensor=2``: fsdp gathers and reduce-scatters, the
    tensor sums and the ring in one step."""
    axes, _ = TRAIN_CASES["seq2_fsdp2_tensor2"]
    want = refs["train_seq2_fsdp2_tensor2"]
    tr = _trainer(_mesh(**axes), dataset, _recipe(want["init"], tmp_path / "init.npz"))
    try:
        losses = [float(tr.step(i)) for i in range(STEPS)]
        np.testing.assert_allclose(losses, want["losses"], **TOL)
        _assert_state_close(tr.full_state(), want["state"])
        assert tr.replica_mismatches() == []
    finally:
        tr.close()


def test_one_rank_seq_mesh_step_is_the_one_device_step_bitwise(dataset):
    """``make_mesh(seq=1)`` at one rank: the seq code at its identities
    (positions from 0, the data x seq and batch groups of one rank, the
    ring's hop the identity) computes the one-device step bit for bit."""
    launch.shutdown()
    torch.use_deterministic_algorithms(True)
    cfg = tl.llama_tiny()
    tr = _trainer(_mesh(seq=1), dataset, seed=4)
    opt = tts.make_optimizer(LR, warmup_steps=1, total_steps=10)
    state, opt = tts.create_train_state(cfg, torch.Generator().manual_seed(4), "cpu", opt)
    step = tts.make_train_step(cfg, opt)
    try:
        for i, tok, tgt, mask in tdata.batches(tdata.TokenDataset(dataset), B, S, seed=4,
                                               num_steps=STEPS, device="cpu"):
            state, loss = step(state, tok, tgt, mask)
            assert torch.equal(tr.step(i), loss), i
        for m in ("params", "mu", "nu"):
            a = tr.state.params if m == "params" else tr.state.opt_state[m]
            b = state.params if m == "params" else state.opt_state[m]
            assert all(torch.equal(x, y) for x, y in zip(tts.tree_leaves(a),
                                                         tts.tree_leaves(b)))
        from kukeon_tpu_torch.parallel import autograd as pa

        x = torch.ones(2, 3)
        assert pa.ring_hop(tr.mesh, "seq", x)[0] is x
    finally:
        torch.use_deterministic_algorithms(False)
        tr.close()
        launch.shutdown()
