"""The port's MoE trainer on a ``data`` x ``fsdp`` x ``expert`` x ``tensor``
mesh against the JAX package's ``make_moe_train_step``, on gloo ranks on the
CPU.

The same init (the JAX ``create_moe_train_state``'s params, handed to every
rank as a recipe) and the same batches (``sample_batch`` of one dataset,
each rank taking its rows) go through the JAX step on ``make_mesh(**axes)``
over 8 forced CPU devices and the port's ``MeshTrainer`` on 8 gloo ranks
(this process the leader): at ``mixtral-tiny``, f32, lr 1e-2, warmup 1,
B 8, S 32, over 3 steps, the losses, ``ce``, ``load_balance``,
``router_z`` and every moment agree within 1e-5, and the params by the
``RARE`` rule of ``tests/test_torch_mesh_training.py``, on ``expert=2,
fsdp=2, tensor=2``, on ``data=2, expert=4``, on ``data=2, expert=2,
tensor=2`` (the JAX test's mesh), and with ``capacity_factor`` 1.0 on
``data=2, fsdp=2, expert=2``, where the JAX run drops assignments: the
capacity and each slot are the global batch's. ``tiny`` (Llama) trains on
an expert mesh as the JAX step does. A one-rank mesh step is the
one-device MoE step bit for bit; leaves replicated over ``expert`` stay
bitwise equal on every expert peer. Each rank's blocks are the three-axis
cut at the reference's shard indices. Checkpoints cross meshes and
packages bit for bit, and the CLI trains, saves and resumes
``mixtral-tiny`` on a mesh.

One rank group at a time serves the file (:func:`_mesh`); its collectives
and rendezvous time out after ``GROUP_TIMEOUT_S``, so no case can hang the
suite.
"""

import dataclasses
import io
import os
from contextlib import redirect_stdout
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kukeon_tpu.models import llama as jl
from kukeon_tpu.models import moe as jm
from kukeon_tpu.parallel import make_mesh as j_make_mesh
from kukeon_tpu.parallel import set_mesh
from kukeon_tpu.training import create_moe_train_state as j_create_moe_train_state
from kukeon_tpu.training import create_train_state as j_create_train_state
from kukeon_tpu.training import data as jdata
from kukeon_tpu.training import restore_checkpoint as j_restore_checkpoint
from kukeon_tpu.training import save_checkpoint as j_save_checkpoint
from kukeon_tpu.training import train_step as jts
from kukeon_tpu_torch.models import llama as tl
from kukeon_tpu_torch.models import moe as tm
from kukeon_tpu_torch.parallel import launch
from kukeon_tpu_torch.parallel.launch import _axis_groups
from kukeon_tpu_torch.parallel.mesh import make_mesh
from kukeon_tpu_torch.parallel.sharding import Recipe, TrainLayout
from kukeon_tpu_torch.training import checkpointing as tckpt
from kukeon_tpu_torch.training import cli as tcli
from kukeon_tpu_torch.training import data as tdata
from kukeon_tpu_torch.training import train_step as tts
from kukeon_tpu_torch.training.mesh_trainer import MeshTrainer

torch.set_num_threads(2)

TOL = dict(rtol=1e-5, atol=1e-5)
B, S, STEPS, LR = 8, 32, 3, 1e-2
GROUP_TIMEOUT_S = "60"
METRICS = ("loss", "ce", "load_balance", "router_z")
MESHES = [dict(expert=2, fsdp=2, tensor=2), dict(data=2, expert=4),
          dict(data=2, expert=2, tensor=2)]
MESH_IDS = ["expert2_fsdp2_tensor2", "data2_expert4", "data2_expert2_tensor2"]
# capacity_factor 1.0 at B 8, S 32: C = 128 of the global 256 tokens' 512
# assignments, which random activations overflow.
BINDING = dict(data=2, fsdp=2, expert=2)


@pytest.fixture(scope="module", autouse=True)
def _groups():
    mp = pytest.MonkeyPatch()
    mp.setenv(launch.TIMEOUT_ENV, GROUP_TIMEOUT_S)
    yield
    launch.shutdown()
    mp.undo()


def _mesh(data=1, fsdp=1, expert=1, tensor=1):
    """The leader's mesh of gloo ranks: the open group when it has this
    shape, else a new one (the other closed first)."""
    g = launch.current()
    if g is not None and (g.world, g.fsdp, g.expert, g.tensor) != (
            data * fsdp * expert * tensor, fsdp, expert, tensor):
        launch.shutdown()
    return make_mesh(data, tensor, "cpu", fsdp=fsdp, expert=expert)


def _named(tree, prefix):
    """{"<prefix>.a.b": numpy leaf} of a nested dict (JAX or numpy)."""
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        out[".".join([prefix] + [str(k.key) for k in path])] = np.asarray(leaf)
    return out


def _jax_state(state) -> dict:
    adam = state.opt_state[1][0]
    return {**_named(state.params, "params"), **_named(adam.mu, "opt_state.1.0.mu"),
            **_named(adam.nu, "opt_state.1.0.nu")}


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("data") / "tok.bin")
    tdata.TokenDataset.write(path, np.random.default_rng(5).integers(0, 512, 20000))
    return path


def _jcfg(capacity_factor=None):
    cfg = jm.moe_tiny()
    return cfg if capacity_factor is None else dataclasses.replace(
        cfg, capacity_factor=capacity_factor)


def _tcfg(capacity_factor=None):
    cfg = tm.moe_tiny()
    return cfg if capacity_factor is None else dataclasses.replace(
        cfg, capacity_factor=capacity_factor)


def _jax_run(axes, dataset, steps=STEPS, capacity_factor=None):
    """The JAX MoE trainer on ``make_mesh(**axes)``: (its init params as
    numpy, each step's metrics, the state after ``steps``)."""
    cfg = _jcfg(capacity_factor)
    mesh = j_make_mesh(**axes)
    with set_mesh(mesh):
        opt = jts.make_optimizer(learning_rate=LR, warmup_steps=1, total_steps=10)
        state, opt = j_create_moe_train_state(cfg, mesh, jax.random.key(0), opt)
        init = jax.tree.map(np.asarray, state.params)
        step_fn, bsh = jts.make_moe_train_step(cfg, mesh, opt)
        rows = []
        for _s, *batch in jdata.batches(jdata.TokenDataset(dataset), B, S, num_steps=steps,
                                        sharding=bsh):
            state, m = step_fn(state, *batch)
            rows.append({k: float(m[k]) for k in METRICS})
    return init, rows, state


def _recipe(tree, path) -> Recipe:
    np.savez(path, **{k[len("params."):].replace(".", "/"): v
                      for k, v in _named(tree, "params").items()})
    return Recipe("kukeon_tpu_torch.models.convert:npz_leaves", {"path": str(path)})


def _trainer(mesh, dataset, init=None, model="mixtral-tiny", cfg=None, **kw):
    return MeshTrainer(mesh, model=model, dataset=dataset, batch=B, seq_len=S, lr=LR,
                       warmup_steps=1, total_steps=10, init=init, cfg=cfg, **kw)


# As in tests/test_torch_mesh_training.py: a parameter may leave 1e-5 at no
# more than RARE of a leaf's elements (Adam's direction at the f32
# rounding floor of a gradient's sum), and then by at most a hundredth of
# a step; the metrics and the moments hold 1e-5 everywhere.
RARE, RARE_TOL = 1e-4, LR * 1e-2


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


def _port_rows(tr) -> list[dict]:
    rows = []
    for i in range(STEPS):
        m = tr.step(i)
        rows.append({k: float(m[k]) for k in METRICS})
    return rows


def _assert_rows_close(got: list, want: list):
    for k in METRICS:
        np.testing.assert_allclose([r[k] for r in got], [r[k] for r in want], err_msg=k,
                                   **TOL)


@pytest.mark.parametrize("axes", MESHES, ids=MESH_IDS)
def test_moe_steps_match_the_jax_sharded_step(axes, dataset, tmp_path):
    init, want_rows, jstate = _jax_run(axes, dataset)
    tr = _trainer(_mesh(**axes), dataset, _recipe(init, tmp_path / "init.npz"))
    try:
        _assert_rows_close(_port_rows(tr), want_rows)
        _assert_state_close(tr.full_state(), _jax_state(jstate))
        assert tr.state.step == STEPS and tr.state.opt_state["count"] == STEPS
    finally:
        tr.close()


def _jax_drops(init, dataset, capacity_factor) -> list[int]:
    """The assignments each MoE block of the JAX forward drops on the first
    batch from ``init`` (its ``moe_block`` wrapped to count them)."""
    cfg = _jcfg(capacity_factor)
    drops = []
    real = jm.moe_block

    def counting(h, w, c, inference=False, pallas=False):
        N = h.shape[0] * h.shape[1]
        probs = jax.nn.softmax(h.reshape(N, -1).astype(jnp.float32) @ w["router"], axis=-1)
        _, idx = jax.lax.top_k(probs, c.experts_per_token)
        load = jax.nn.one_hot(idx, c.num_experts).sum(axis=(0, 1))
        over = jnp.sum(jnp.maximum(load - jm._capacity(c, N, inference), 0))
        jax.debug.callback(lambda n: drops.append(int(n)), over)
        return real(h, w, c, inference, pallas)

    tok, _tgt, _mask = jdata.sample_batch(jdata.TokenDataset(dataset), 0, B, S)
    params = jax.tree.map(jnp.asarray, init)
    pos = jnp.broadcast_to(jnp.arange(S, dtype=jnp.int32)[None, :], (B, S))
    mp = pytest.MonkeyPatch()
    mp.setattr(jm, "moe_block", counting)
    try:
        jax.block_until_ready(jm.forward_with_aux(params, cfg, jnp.asarray(tok), pos))
    finally:
        mp.undo()
    return drops


def test_capacity_binding_steps_match_the_jax_step(dataset, tmp_path):
    """``capacity_factor`` 1.0 in both packages on data 2 x fsdp 2 x expert
    2 (four batch ranks): the JAX forward drops assignments, and the
    port's metrics, moments and params still hold the JAX step's, as they
    would not with a per-rank capacity or slot order."""
    init, want_rows, jstate = _jax_run(BINDING, dataset, capacity_factor=1.0)
    drops = _jax_drops(init, dataset, 1.0)
    assert len(drops) == tm.moe_tiny().num_layers and sum(drops) >= 1, drops
    tr = _trainer(_mesh(**BINDING), dataset, _recipe(init, tmp_path / "init.npz"),
                  cfg=_tcfg(1.0))
    try:
        _assert_rows_close(_port_rows(tr), want_rows)
        _assert_state_close(tr.full_state(), _jax_state(jstate))
    finally:
        tr.close()


def test_slot_offsets_give_each_batch_rank_the_global_dispatch():
    """``moe._row_offsets`` at ``seq`` 1 on each of four batch ranks of two
    whole rows each (a stand-in mesh whose gather checks that it is given
    the rank's own per-row ``[K, rows, E]`` counts and returns every
    rank's): each rank's dispatch at the global capacity is its rows of one
    device's dispatch of the whole batch, drops included: choice 1 waits
    behind every rank's choice 0, and a rank's choice 0 behind the earlier
    ranks'."""
    cfg = _tcfg(1.0)
    g = torch.Generator().manual_seed(3)
    K, E, ranks, rows, S = cfg.experts_per_token, cfg.num_experts, 4, 2, 32
    N = rows * S
    idx = torch.stack([torch.randperm(E, generator=g)[:K] for _ in range(ranks * N)])
    mask = torch.nn.functional.one_hot(idx.T, E).float()            # [K, 4N, E]
    C = tm._capacity(cfg, ranks * N)
    whole = tm._dispatch(mask, C)
    parts = mask.reshape(K, ranks, N, E)
    every = parts.reshape(K, ranks, rows, S, E).sum(dim=3).permute(1, 0, 2, 3)

    def gather(b):
        def fn(x, dim, axis):
            assert torch.equal(x[0], every[b]) and (dim, axis) == (0, "batch")
            return every
        return fn

    for b in range(ranks):
        mesh = SimpleNamespace(axis_size=lambda axis: ranks, seq=1, seq_rank=0, replica=0,
                               fsdp=ranks, fsdp_rank=b, gather=gather(b))
        offset = tm._row_offsets(parts[:, b], mesh, rows)
        assert torch.equal(tm._dispatch(parts[:, b], C, offset), whole[b * N:(b + 1) * N]), b
        assert bool(offset[1].all()) and (b == 0) != bool(offset[0, 0].any())
    assert whole.sum() < K * ranks * N                              # something dropped


def test_llama_on_an_expert_mesh_matches_the_jax_sharded_step(dataset, tmp_path):
    """``tiny`` on expert 2 x fsdp 2 x tensor 2: its leaves replicated over
    ``expert``, each expert peer repeating its fsdp and tensor peers' work,
    as the reference's step does on that mesh."""
    axes = MESHES[0]
    cfg = jl.llama_tiny()
    mesh = j_make_mesh(**axes)
    with set_mesh(mesh):
        opt = jts.make_optimizer(learning_rate=LR, warmup_steps=1, total_steps=10)
        state, opt = j_create_train_state(cfg, mesh, jax.random.key(0), opt)
        init = jax.tree.map(np.asarray, state.params)
        step_fn, bsh = jts.make_train_step(cfg, mesh, opt)
        want = []
        for _s, *batch in jdata.batches(jdata.TokenDataset(dataset), B, S, num_steps=STEPS,
                                        sharding=bsh):
            state, loss = step_fn(state, *batch)
            want.append(float(loss))
    tr = _trainer(_mesh(**axes), dataset, _recipe(init, tmp_path / "init.npz"), model="tiny")
    try:
        np.testing.assert_allclose([float(tr.step(i)) for i in range(STEPS)], want, **TOL)
        _assert_state_close(tr.full_state(), _jax_state(state))
        assert tr.replica_mismatches() == []
    finally:
        tr.close()


def test_replicated_leaves_stay_bitwise_equal_on_every_expert_peer(dataset):
    """After 3 steps on expert 2 x fsdp 2 x tensor 2, every leaf a mesh
    axis does not cut (the trunk, the router and the norms over
    ``expert``; the norms and the router over ``tensor`` and ``fsdp``)
    holds the same bits, params and moments, on every peer of that axis;
    and the check sees the leader's router moved by one ulp."""
    tr = _trainer(_mesh(**MESHES[0]), dataset, seed=2)
    try:
        for i in range(STEPS):
            tr.step(i)
        assert tr.replica_mismatches() == []
        router = tr.state.params["layers"]["router"]
        with torch.no_grad():
            router.view(-1)[0] = torch.nextafter(router.view(-1)[0], torch.tensor(np.inf))
        assert sorted(tr.replica_mismatches()) == [
            ("params.layers.router", axis) for axis in ("expert", "fsdp", "tensor")]
    finally:
        tr.close()


def test_one_rank_moe_mesh_step_is_the_one_device_step_bitwise(dataset):
    """A one-rank gloo mesh: its draws, metrics, params and moments equal
    the one-device MoE trainer's (``create_moe_train_state``,
    ``make_moe_train_step``) bit for bit, under
    ``torch.use_deterministic_algorithms`` (the embedding's backward)."""
    launch.shutdown()
    torch.use_deterministic_algorithms(True)
    cfg = tm.moe_tiny()
    tr = _trainer(_mesh(), dataset, seed=4)
    opt = tts.make_optimizer(LR, warmup_steps=1, total_steps=10)
    state, opt = tts.create_moe_train_state(cfg, torch.Generator().manual_seed(4), "cpu", opt)
    step = tts.make_moe_train_step(cfg, opt)
    try:
        for i, tok, tgt, mask in tdata.batches(tdata.TokenDataset(dataset), B, S, seed=4,
                                               num_steps=STEPS, device="cpu"):
            state, want = step(state, tok, tgt, mask)
            got = tr.step(i)
            for k in METRICS:
                assert torch.equal(got[k], want[k]), (i, k, got[k], want[k])
        for a, b in zip(tts.tree_leaves(tr.state.params), tts.tree_leaves(state.params)):
            assert torch.equal(a, b)
        for m in ("mu", "nu"):
            for a, b in zip(tts.tree_leaves(tr.state.opt_state[m]),
                            tts.tree_leaves(state.opt_state[m])):
                assert torch.equal(a, b)
    finally:
        torch.use_deterministic_algorithms(False)
        tr.close()
        launch.shutdown()


def _rank(f, F, x, X, t, T, d=0):
    return SimpleNamespace(fsdp_rank=f, fsdp=F, expert_rank=x, expert=X, rank=t, world=T,
                           replica=d, device=torch.device("cpu"))


@pytest.mark.parametrize("axes", MESHES, ids=MESH_IDS)
def test_each_ranks_blocks_are_the_three_axis_cut(axes):
    """A fresh MoE state on each rank (its draws cut as they come) holds
    the one-device state's blocks, and every ``addressable_shards`` index
    of the JAX state on ``make_mesh(**axes)`` is the port's region of the
    rank at that device's (fsdp, expert, tensor) coordinates."""
    cfg = tm.moe_tiny()
    F, X, T = (axes.get(a, 1) for a in ("fsdp", "expert", "tensor"))
    one, _ = tts.create_moe_train_state(cfg, torch.Generator().manual_seed(2), "cpu")
    full = dict(tts.tree_items(one.params))
    for f in range(F):
        for x in range(X):
            for t in range(T):
                state, _ = tts.create_moe_train_state(
                    cfg, torch.Generator().manual_seed(2), "cpu", mesh=_rank(f, F, x, X, t, T))
                lay = TrainLayout(cfg, f, F, t, T, expert_rank=x, expert=X)
                for path, block in tts.tree_items(state.params):
                    want = full[path]
                    for axis, lo, hi in lay.regions(path, want.shape):
                        want = want.narrow(axis, lo, hi - lo)
                    assert torch.equal(block, want), path
                for m in ("mu", "nu"):
                    for (_, z), (_, p) in zip(tts.tree_items(state.opt_state[m]),
                                              tts.tree_items(state.params)):
                        assert z.shape == p.shape and not z.any()
    mesh = j_make_mesh(**axes)
    with set_mesh(mesh):
        jstate, _ = j_create_moe_train_state(jm.moe_tiny(), mesh, jax.random.key(0))
    coords = {d.id: c for c, d in np.ndenumerate(mesh.devices)}  # (pipe, data, fsdp, expert, ..)
    for path, arr in jax.tree_util.tree_flatten_with_path(jstate.params)[0]:
        keys = tuple(str(k.key) for k in path)
        for shard in arr.addressable_shards:
            c = coords[shard.device.id]
            lay = TrainLayout(cfg, c[2], F, c[5], T, expert_rank=c[3], expert=X)
            want = [(i.start or 0, arr.shape[a] if i.stop is None else i.stop)
                    for a, i in enumerate(shard.index)]
            got = [(0, n) for n in arr.shape]
            for axis, lo, hi in lay.regions(keys, arr.shape):
                got[axis] = (lo, hi)
            assert got == want, (keys, c)


@pytest.mark.parametrize("axes", MESHES + [BINDING], ids=MESH_IDS + ["data2_fsdp2_expert2"])
def test_axis_groups_are_the_reference_meshs_axes(axes):
    """Every axis group of the port's rank layout is a line of the JAX
    ``make_mesh(**axes)``'s device array along that axis (global rank r
    the r-th device of the array in C order), and ``batch`` and
    ``expert_tensor`` its (data, fsdp) and (expert, tensor) planes."""
    D, F, X, T = (axes.get(a, 1) for a in ("data", "fsdp", "expert", "tensor"))
    ids = np.asarray(j_make_mesh(**axes).devices).reshape(D, F, X, T)
    order = {d: r for r, d in enumerate(ids.reshape(-1))}
    grid = np.vectorize(order.get)(ids)
    groups = _axis_groups(D * F * X * T, T, F, X)
    want = {"tensor": grid.reshape(-1, T),
            "fsdp": grid.transpose(0, 2, 3, 1).reshape(-1, F),
            "expert": grid.transpose(0, 1, 3, 2).reshape(-1, X),
            "data": grid.transpose(1, 2, 3, 0).reshape(-1, D),
            "batch": grid.transpose(2, 3, 0, 1).reshape(-1, D * F),
            "expert_tensor": grid.reshape(-1, X * T)}
    for axis, lines in want.items():
        if lines.shape[1] > 1 or axis == "tensor":
            assert sorted(map(sorted, groups[axis])) == sorted(map(sorted, lines.tolist())), axis
        else:
            assert axis not in groups, axis


def test_a_port_save_restores_on_another_mesh_and_in_the_jax_trainer(dataset, tmp_path):
    """A save at expert 2 x fsdp 2 x tensor 2 after two steps: the port
    restores it at data 2 x expert 4 and the JAX ``restore_checkpoint``
    at data 2 x expert 2 x tensor 2, every param and moment bit for bit,
    and the step and counts."""
    root = str(tmp_path / "ckpt")
    tr = _trainer(_mesh(**MESHES[0]), dataset, seed=1)
    try:
        for i in range(2):
            tr.step(i)
        assert tr.save(root).endswith("step_00000002")
        want = tr.full_state()
    finally:
        tr.close()
    tr = _trainer(_mesh(**MESHES[1]), dataset, seed=5)
    try:
        assert tr.restore(root) == 2 and tr.state.opt_state["count"] == 2
        got = tr.full_state()
        for name in want:
            assert torch.equal(got[name], want[name]), name
    finally:
        tr.close()
    mesh = j_make_mesh(**MESHES[2])
    with set_mesh(mesh):
        fresh, _ = j_create_moe_train_state(
            jm.moe_tiny(), mesh, jax.random.key(7),
            jts.make_optimizer(LR, warmup_steps=1, total_steps=10))
        jgot = _jax_state(j_restore_checkpoint(root, fresh))
    assert sorted(jgot) == sorted(want)
    for name, w in want.items():
        np.testing.assert_array_equal(jgot[name], w.numpy(), err_msg=name)


def test_a_jax_save_restores_in_the_port_on_another_mesh(dataset, tmp_path):
    """A JAX save at data 2 x expert 2 x tensor 2 after two steps restored
    by the port at data 2 x expert 4: each rank reads its blocks, which
    gather to the JAX state bit for bit, and the leader's own blocks are
    the cut of it; a third step then goes on as the JAX run's does."""
    root = str(tmp_path / "ckpt")
    init, want_rows, jstate = _jax_run(MESHES[2], dataset)
    mesh = j_make_mesh(**MESHES[2])
    with set_mesh(mesh):
        opt = jts.make_optimizer(learning_rate=LR, warmup_steps=1, total_steps=10)
        two, _ = j_create_moe_train_state(jm.moe_tiny(), mesh, jax.random.key(0), opt)
        step_fn, bsh = jts.make_moe_train_step(jm.moe_tiny(), mesh, opt)
        for _s, *batch in jdata.batches(jdata.TokenDataset(dataset), B, S, num_steps=2,
                                        sharding=bsh):
            two, _m = step_fn(two, *batch)
        j_save_checkpoint(root, two)
        want = _jax_state(two)
    tr = _trainer(_mesh(**MESHES[1]), dataset)
    try:
        assert tr.restore(root) == 2 and tr.state.opt_state["count"] == 2
        for prefix, tree in (("params", tr.state.params),
                             ("opt_state.1.0.mu", tr.state.opt_state["mu"]),
                             ("opt_state.1.0.nu", tr.state.opt_state["nu"])):
            for path, block in tts.tree_items(tree):
                w = torch.from_numpy(want[".".join((prefix, *path))].copy())
                assert torch.equal(block, tr.layout.cut(path, w)), path
        got = tr.full_state()
        for name, w in want.items():
            np.testing.assert_array_equal(got[name].numpy(), w, err_msg=name)
        m = tr.step(2)
        for k in METRICS:
            np.testing.assert_allclose(float(m[k]), want_rows[2][k], err_msg=k, **TOL)
        _assert_state_close(tr.full_state(), _jax_state(jstate))
    finally:
        tr.close()


def _cli(argv):
    buf = io.StringIO()
    with redirect_stdout(buf):
        assert tcli.main(argv) == 0
    return buf.getvalue()


def test_cli_trains_saves_and_resumes_mixtral_tiny_on_a_mesh(dataset, tmp_path):
    """``--model mixtral-tiny --expert 2 --fsdp 2 --tensor 2 --device cpu``:
    the mesh on the first line as the reference prints it, step lines with
    ``lb=``, a save every 2 steps, and a resumed run whose saved step is
    what a trainer on that mesh computes from the checkpoint it resumed
    from, bit for bit."""
    launch.shutdown()
    ckpt = str(tmp_path / "ckpts")
    common = ["--dataset", dataset, "--model", "mixtral-tiny", "--device", "cpu",
              "--batch", "8", "--seq-len", "32", "--warmup-steps", "1", "--log-every", "1",
              "--save-every", "2", "--expert", "2", "--fsdp", "2", "--tensor", "2",
              "--ckpt-dir", ckpt]
    first = _cli(common + ["--steps", "3"])
    assert first.splitlines()[0] == (
        "train: model=mixtral-tiny mesh={'pipe': 1, 'data': 1, 'fsdp': 2, 'expert': 2, "
        "'seq': 1, 'tensor': 2} batch=8 seq=32")
    rows = [ln.split() for ln in first.splitlines() if ln.startswith("step ")]
    assert [r[1] for r in rows] == ["1", "2", "3"]
    assert all(r[4].startswith("lb=") and float(r[4][3:]) > 0 for r in rows)
    assert sorted(os.listdir(ckpt)) == ["step_00000002", "step_00000003"]
    assert launch.current() is None                 # the CLI closed its group
    second = _cli(common + ["--steps", "4"])
    assert "train: resumed from step 3" in second
    assert [ln.split()[1] for ln in second.splitlines() if ln.startswith("step ")] == ["4"]
    tr = MeshTrainer(_mesh(expert=2, fsdp=2, tensor=2), model="mixtral-tiny", dataset=dataset,
                     batch=8, seq_len=32, warmup_steps=1, total_steps=4)
    try:
        assert tr.restore(ckpt, 3) == 3
        tr.step(3)
        want = tr.full_state()
    finally:
        tr.close()
    saved = tckpt.restore_checkpoint(ckpt, tts.create_moe_train_state(
        tm.moe_tiny(), torch.Generator().manual_seed(9), "cpu")[0])
    assert saved.step == 4
    for path, leaf in tts.tree_items(saved.params):
        assert torch.equal(leaf, want[".".join(("params", *path))]), path


def test_a_training_mesh_refuses_an_expert_axis_that_does_not_divide_the_experts():
    """``expert`` 3 over mixtral-tiny's 4 experts: refused in the
    reference's terms (its ``device_put`` of the expert stacks raises
    there); a Llama model has no expert axis to cut and takes any."""
    with pytest.raises(SystemExit, match="expert 3 does not divide num_experts 4: the global "
                                         "size of the expert stacks' dimension 1 should be "
                                         "divisible by 3, but it is equal to 4"):
        TrainLayout(tm.moe_tiny(), 0, 1, 0, 1, expert_rank=0, expert=3)
    lay = TrainLayout(tl.llama_tiny(), 0, 1, 0, 1, expert_rank=2, expert=3)
    assert all(b.axis is None for b in lay.blocks(("layers", "wq"), (2, 128, 128))[2:])
    assert not lay.owned(("layers", "wq"), 0)
