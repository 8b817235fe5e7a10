"""The port's MoE trainer on meshes with a ``seq`` axis against the JAX
package's ``make_moe_train_step``, on gloo ranks on the CPU.

The JAX step cuts its batch ``P((data, fsdp), seq)`` and attends with
``impl="auto"``: GSPMD over global arrays, so its capacity and every slot
of its dispatch are the global batch's, where a seq rank's tokens are a
block of positions of each of its rows. The same init and batches go
through the JAX step on ``make_mesh(**axes)`` over 8 forced CPU devices and
the port's ``MeshTrainer`` on 8 gloo ranks (this process the leader), as in
``tests/test_torch_moe_mesh_training.py`` (whose helpers this file uses):
at ``mixtral-tiny``, f32, lr 1e-2, warmup 1, B 8, S 32, over 3 steps, the
losses, ``ce``, ``load_balance``, ``router_z`` and every moment agree within
1e-5, and the params by its ``RARE`` rule, on ``data=2, seq=2, expert=2``,
``seq=4, expert=2`` and ``fsdp=2, seq=2, tensor=2``, and with
``capacity_factor`` 1.0 on ``data=2, seq=2, expert=2``, where the JAX run
drops assignments. Each rank's dispatch on a (row, position) grid is its
block of one device's dispatch of the whole batch; a one-rank step at seq 1
stays the one-device step bit for bit; a seq mesh's save restores at
``expert=4`` and in the JAX trainer bit for bit; and a MoE trainer refuses
``use_ring_attention``, which the reference's MoE step does not take.

One rank group at a time serves the file (:func:`_mesh`); its collectives
and rendezvous time out after ``GROUP_TIMEOUT_S``, so no case can hang the
suite.
"""

from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

from kukeon_tpu.models import moe as jm
from kukeon_tpu.parallel import make_mesh as j_make_mesh
from kukeon_tpu.parallel import set_mesh
from kukeon_tpu.training import create_moe_train_state as j_create_moe_train_state
from kukeon_tpu.training import restore_checkpoint as j_restore_checkpoint
from kukeon_tpu.training import train_step as jts
from kukeon_tpu_torch.models import moe as tm
from kukeon_tpu_torch.parallel import launch
from kukeon_tpu_torch.parallel.mesh import make_mesh
from kukeon_tpu_torch.training import data as tdata
from kukeon_tpu_torch.training import train_step as tts
from tests import test_torch_moe_mesh_training as base

torch.set_num_threads(2)

B, S, STEPS, LR = base.B, base.S, base.STEPS, base.LR
MESHES = [dict(data=2, seq=2, expert=2), dict(seq=4, expert=2),
          dict(fsdp=2, seq=2, tensor=2)]
MESH_IDS = ["data2_seq2_expert2", "seq4_expert2", "fsdp2_seq2_tensor2"]
# capacity_factor 1.0 at B 8, S 32: C = 128 of the global 256 tokens' 512
# assignments, which random activations overflow.
BINDING = dict(data=2, seq=2, expert=2)


@pytest.fixture(scope="module", autouse=True)
def _groups():
    mp = pytest.MonkeyPatch()
    mp.setenv(launch.TIMEOUT_ENV, base.GROUP_TIMEOUT_S)
    yield
    launch.shutdown()
    mp.undo()


def _mesh(data=1, fsdp=1, expert=1, seq=1, tensor=1):
    """The leader's mesh of gloo ranks: the open group when it has this
    shape, else a new one (the other closed first)."""
    g = launch.current()
    if g is not None and (g.world, g.fsdp, g.expert, g.seq, g.pipe, g.tensor) != (
            data * fsdp * expert * seq * tensor, fsdp, expert, seq, 1, tensor):
        launch.shutdown()
    return make_mesh(data, tensor, "cpu", fsdp=fsdp, expert=expert, seq=seq)


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("data") / "tok.bin")
    tdata.TokenDataset.write(path, np.random.default_rng(5).integers(0, 512, 20000))
    return path


@pytest.mark.parametrize("axes", MESHES, ids=MESH_IDS)
def test_moe_seq_steps_match_the_jax_sharded_step(axes, dataset, tmp_path):
    """Every metric, moment and param of 3 steps as the JAX step's on the
    same mesh, and every leaf a mesh axis does not cut (``seq`` among
    them) bitwise equal on each of its peers."""
    init, want_rows, jstate = base._jax_run(axes, dataset)
    tr = base._trainer(_mesh(**axes), dataset, base._recipe(init, tmp_path / "init.npz"))
    try:
        base._assert_rows_close(base._port_rows(tr), want_rows)
        base._assert_state_close(tr.full_state(), base._jax_state(jstate))
        assert tr.state.step == STEPS and tr.replica_mismatches() == []
    finally:
        tr.close()


def test_capacity_binding_seq_steps_match_the_jax_step(dataset, tmp_path):
    """``capacity_factor`` 1.0 in both packages on data 2 x seq 2 x expert
    2: the JAX forward drops assignments, and the port's metrics, moments
    and params still hold the JAX step's, as they would not with the
    ``[K, E]`` offsets of a contiguous run on a (row, position) cut."""
    init, want_rows, jstate = base._jax_run(BINDING, dataset, capacity_factor=1.0)
    drops = base._jax_drops(init, dataset, 1.0)
    assert len(drops) == tm.moe_tiny().num_layers and sum(drops) >= 1, drops
    tr = base._trainer(_mesh(**BINDING), dataset, base._recipe(init, tmp_path / "init.npz"),
                       cfg=base._tcfg(1.0))
    try:
        base._assert_rows_close(base._port_rows(tr), want_rows)
        base._assert_state_close(tr.full_state(), base._jax_state(jstate))
    finally:
        tr.close()


@pytest.mark.parametrize("data, fsdp, seq", [(1, 1, 4), (2, 1, 2), (2, 2, 2), (2, 2, 1),
                                             (1, 4, 1)],
                         ids=["seq4", "data2_seq2", "data2_fsdp2_seq2", "data2_fsdp2",
                              "fsdp4"])
def test_row_offsets_give_each_rank_the_global_dispatch(data, fsdp, seq):
    """``moe._row_offsets`` on each rank of a (row block, position block)
    grid, ``seq`` 1 among them (a stand-in mesh whose gather checks that
    it is given the rank's own per-row counts and returns every rank's in
    ``AXES`` order): each rank's dispatch at the global capacity is its
    block of one device's dispatch of the whole [B, S] batch, drops
    included: a token waits behind every choice k' < k, behind the earlier
    rows on all seq peers, and behind its row's earlier seq blocks."""
    cfg = base._tcfg(1.0)
    g = torch.Generator().manual_seed(3)
    K, E = cfg.experts_per_token, cfg.num_experts
    idx = torch.stack([torch.randperm(E, generator=g)[:K] for _ in range(B * S)])
    mask = torch.nn.functional.one_hot(idx.T, E).float().reshape(K, B, S, E)
    C = tm._capacity(cfg, B * S)
    whole = tm._dispatch(mask.reshape(K, B * S, E), C).reshape(B, S, E, C)
    rows, cols = B // (data * fsdp), S // seq

    def block(t, d, f, s):
        r = (d * fsdp + f) * rows
        return t[..., r:r + rows, s * cols:(s + 1) * cols, :]

    ranks = [(d, f, s) for d in range(data) for f in range(fsdp) for s in range(seq)]
    every = torch.stack([block(mask, *r).sum(dim=2) for r in ranks])   # [ranks, K, B, E]

    def gather(i):
        def fn(x, dim, axis):
            assert torch.equal(x[0], every[i]) and (dim, axis) == (0, "batch")
            return every
        return fn

    for i, (d, f, s) in enumerate(ranks):
        mesh = SimpleNamespace(axis_size=lambda axis: len(ranks), seq=seq, seq_rank=s,
                               replica=d, fsdp=fsdp, fsdp_rank=f, gather=gather(i))
        part = block(mask, d, f, s).reshape(K, rows * cols, E)
        got = tm._dispatch(part, C, tm._row_offsets(part, mesh, rows))
        want = block(whole.movedim(2, 0), d, f, s).movedim(0, 2).reshape(rows * cols, E, C)
        assert torch.equal(got, want), (d, f, s)
    assert whole.sum() < K * B * S                                     # something dropped


def test_one_rank_moe_step_at_seq_1_is_the_one_device_step_bitwise(dataset):
    """A one-rank gloo mesh at ``capacity_factor`` 1.0 (assignments
    dropped): its metrics, params and moments equal the one-device MoE
    step's bit for bit, under ``torch.use_deterministic_algorithms``."""
    launch.shutdown()
    torch.use_deterministic_algorithms(True)
    cfg = base._tcfg(1.0)
    tr = base._trainer(_mesh(), dataset, seed=4, cfg=cfg)
    opt = tts.make_optimizer(LR, warmup_steps=1, total_steps=10)
    state, opt = tts.create_moe_train_state(cfg, torch.Generator().manual_seed(4), "cpu", opt)
    step = tts.make_moe_train_step(cfg, opt)
    try:
        for i, tok, tgt, mask in tdata.batches(tdata.TokenDataset(dataset), B, S, seed=4,
                                               num_steps=STEPS, device="cpu"):
            state, want = step(state, tok, tgt, mask)
            got = tr.step(i)
            for k in base.METRICS:
                assert torch.equal(got[k], want[k]), (i, k, got[k], want[k])
        for m in ("params", "mu", "nu"):
            mine = tr.state.params if m == "params" else tr.state.opt_state[m]
            ref = state.params if m == "params" else state.opt_state[m]
            for a, b in zip(tts.tree_leaves(mine), tts.tree_leaves(ref)):
                assert torch.equal(a, b), m
    finally:
        torch.use_deterministic_algorithms(False)
        tr.close()
        launch.shutdown()


def test_a_seq_mesh_save_restores_at_expert_4_and_in_the_jax_trainer(dataset, tmp_path):
    """A save at data 2 x seq 2 x expert 2 after two steps: the port
    restores it at expert 4 and the JAX ``restore_checkpoint`` at seq 4 x
    expert 2, every param and moment bit for bit, and the step and
    counts."""
    root = str(tmp_path / "ckpt")
    tr = base._trainer(_mesh(**MESHES[0]), dataset, seed=1)
    try:
        for i in range(2):
            tr.step(i)
        assert tr.save(root).endswith("step_00000002")
        want = tr.full_state()
    finally:
        tr.close()
    tr = base._trainer(_mesh(expert=4), dataset, seed=5)
    try:
        assert tr.restore(root) == 2 and tr.state.opt_state["count"] == 2
        got = tr.full_state()
        assert sorted(got) == sorted(want)
        for name in want:
            assert torch.equal(got[name], want[name]), name
    finally:
        tr.close()
    mesh = j_make_mesh(**MESHES[1])
    with set_mesh(mesh):
        fresh, _ = j_create_moe_train_state(
            jm.moe_tiny(), mesh, jax.random.key(7),
            jts.make_optimizer(LR, warmup_steps=1, total_steps=10))
        restored = j_restore_checkpoint(root, fresh)
        jgot = base._jax_state(restored)
    assert int(restored.step) == 2 and sorted(jgot) == sorted(want)
    for name, w in want.items():
        np.testing.assert_array_equal(jgot[name], w.numpy(), err_msg=name)


@pytest.mark.parametrize("ring", [True, False])
def test_a_moe_mesh_trainer_refuses_use_ring_attention(dataset, ring):
    """The reference's ``make_moe_train_step`` has no ring option: a MoE
    ``MeshTrainer`` given ``use_ring_attention`` (either value) raises
    before any follower is told to build one, and the group stays usable."""
    mesh = _mesh(seq=2)
    with pytest.raises(ValueError, match="the MoE step has no ring option"):
        base._trainer(mesh, dataset, use_ring_attention=ring)
    tr = base._trainer(mesh, dataset)
    try:
        assert np.isfinite(float(tr.step(0)["loss"]))
    finally:
        tr.close()
