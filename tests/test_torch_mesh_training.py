"""The port's trainer on a ``data`` x ``fsdp`` x ``tensor`` mesh against the
JAX package's sharded step, on gloo ranks on the CPU.

The same init (the JAX ``create_train_state``'s params, handed to every
rank as a recipe) and the same batches (``sample_batch`` of one dataset,
each rank taking its rows) go through the JAX ``make_train_step`` on
``make_mesh(**axes)`` over 8 forced CPU devices and the port's
``MeshTrainer`` on 8 gloo ranks (this process the leader): at ``tiny``, f32,
lr 1e-2, warmup 1, B 8, S 32, over 3 steps, the losses and every updated
param and moment agree within 1e-5 (the f32 tolerance of
``tests/test_torch_training.py``; the two sum in different orders), on
``data=2, fsdp=2, tensor=2``, on ``fsdp=4, tensor=2`` (the JAX test's mesh)
and on ``data=2, tensor=4`` (kv heads replicated over tensor). A one-rank
mesh step is the one-device step bit for bit. Each rank's blocks of a
fresh state are the two-axis cut of the one-device state, at the
reference's shard indices. Checkpoints cross meshes and packages bit for
bit, and a resumed run continues with the uninterrupted run's loss. The
CLI trains, saves and resumes on a mesh, lays out the reference's default,
refuses an over-grant before it starts a rank, and trains the MoE family
on data, expert and seq axes and the Llama family on an expert axis
(``tests/test_torch_moe_mesh_training.py`` and
``tests/test_torch_moe_seq_training.py`` hold those to the JAX package).

One rank group at a time serves the file (:func:`_mesh`); its collectives
and rendezvous time out after ``GROUP_TIMEOUT_S``, so no case can hang the
suite.
"""

import io
import math
import os
from contextlib import redirect_stdout
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kukeon_tpu.models import llama as jl
from kukeon_tpu.parallel import make_mesh as j_make_mesh
from kukeon_tpu.parallel import set_mesh
from kukeon_tpu.training import cli as jcli
from kukeon_tpu.training import create_train_state as j_create_train_state
from kukeon_tpu.training import data as jdata
from kukeon_tpu.training import restore_checkpoint as j_restore_checkpoint
from kukeon_tpu.training import save_checkpoint as j_save_checkpoint
from kukeon_tpu.training import train_step as jts
from kukeon_tpu_torch.models import llama as tl
from kukeon_tpu_torch.ops import flash_attention as tfa
from kukeon_tpu_torch.parallel import launch
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
MESHES = [dict(data=2, fsdp=2, tensor=2), dict(fsdp=4, tensor=2), dict(data=2, tensor=4)]
MESH_IDS = ["data2_fsdp2_tensor2", "fsdp4_tensor2", "data2_tensor4"]


@pytest.fixture(scope="module", autouse=True)
def _groups():
    mp = pytest.MonkeyPatch()
    mp.setenv(launch.TIMEOUT_ENV, GROUP_TIMEOUT_S)
    yield
    launch.shutdown()
    mp.undo()


def _mesh(data=1, fsdp=1, tensor=1):
    """The leader's mesh of gloo ranks: the open group when it has this
    shape, else a new one (the other closed first)."""
    g = launch.current()
    if g is not None and (g.world, g.fsdp, g.expert, g.tensor) != (
            data * fsdp * tensor, fsdp, 1, tensor):
        launch.shutdown()
    return make_mesh(data, tensor, "cpu", fsdp=fsdp)


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


def _jax_run(axes, dataset, steps=STEPS):
    """The JAX trainer on ``make_mesh(**axes)``: (its init params as numpy,
    the losses, the state after ``steps``)."""
    cfg = jl.llama_tiny()
    mesh = j_make_mesh(**axes)
    with set_mesh(mesh):
        opt = jts.make_optimizer(learning_rate=LR, warmup_steps=1, total_steps=10)
        state, opt = j_create_train_state(cfg, mesh, jax.random.key(0), opt)
        init = jax.tree.map(np.asarray, state.params)
        step_fn, bsh = jts.make_train_step(cfg, mesh, opt)
        losses = []
        for _s, *batch in jdata.batches(jdata.TokenDataset(dataset), B, S, num_steps=steps,
                                        sharding=bsh):
            state, loss = step_fn(state, *batch)
            losses.append(float(loss))
    return init, losses, state


def _recipe(tree, path) -> Recipe:
    np.savez(path, **{k[len("params."):].replace(".", "/"): v
                      for k, v in _named(tree, "params").items()})
    return Recipe("kukeon_tpu_torch.models.convert:npz_leaves", {"path": str(path)})


def _trainer(mesh, dataset, init=None, **kw):
    return MeshTrainer(mesh, model="tiny", dataset=dataset, batch=B, seq_len=S, lr=LR,
                       warmup_steps=1, total_steps=10, init=init, **kw)


# Adam divides each element's first moment by its second's root: an element
# whose gradient lies at the f32 rounding floor of its sum (a tied
# embedding row whose lookup and head terms cancel) takes an update whose
# direction that rounding sets. On those the JAX package's own step differs
# across its meshes by up to 1.59e-5 after 3 steps here (make_mesh data 8
# against fsdp 4 x tensor 2). So a parameter may leave 1e-5 at no more than
# RARE of a leaf's elements, and then by at most a hundredth of a step
# (lr * 1e-2); the losses and the moments hold 1e-5 everywhere.
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


@pytest.mark.parametrize("axes", MESHES, ids=MESH_IDS)
def test_steps_match_the_jax_sharded_step(axes, dataset, tmp_path):
    init, want_losses, jstate = _jax_run(axes, dataset)
    tr = _trainer(_mesh(**axes), dataset, _recipe(init, tmp_path / "init.npz"))
    try:
        losses = [float(tr.step(i)) for i in range(STEPS)]
        np.testing.assert_allclose(losses, want_losses, **TOL)
        _assert_state_close(tr.full_state(), _jax_state(jstate))
        assert tr.state.step == STEPS and tr.state.opt_state["count"] == STEPS
    finally:
        tr.close()


def test_training_mesh_lays_out_the_references():
    """``training_mesh(8, tensor=2)``: fsdp over what tensor leaves, the
    reference's six axes in its order."""
    from kukeon_tpu.parallel import mesh as jmesh
    from kukeon_tpu_torch.parallel import mesh as tmesh

    want = dict(jmesh.training_mesh(8, tensor=2).shape)
    launch.shutdown()
    got = tmesh.training_mesh(8, tensor=2, device="cpu")
    assert list(got.axes.items()) == list(want.items())
    assert (got.fsdp, got.world, got.fsdp_rank, got.rank, got.replica) == (4, 2, 0, 0, 0)


def test_kv_heads_replicated_over_tensor_are_whole_on_each_rank(dataset):
    """At ``tensor=4`` tiny's 2 kv heads are replicated: ``wk``/``wv`` are
    cut on fsdp only, and each rank's q head is its own."""
    lay = TrainLayout(tl.llama_tiny(), 0, 1, 3, 4)
    assert not lay.kv_shard and lay.spec(("layers", "wk")) == (None, "fsdp", None)
    assert lay.local_shape(("layers", "wk"), (2, 128, 64)) == (2, 128, 64)
    assert lay.local_shape(("layers", "wq"), (2, 128, 128)) == (2, 128, 32)


def test_one_rank_mesh_step_is_the_one_device_step_bitwise(dataset):
    """A one-rank gloo mesh: its draws, losses, params and moments equal
    the one-device trainer's (``create_train_state``, ``make_train_step``)
    bit for bit. Both under ``torch.use_deterministic_algorithms``: the
    CPU's accumulating ``index_put_`` (the embedding's backward) may sum a
    row's terms in another order from one run to the next, either way."""
    launch.shutdown()
    torch.use_deterministic_algorithms(True)
    cfg = tl.llama_tiny()
    tr = _trainer(_mesh(), dataset, seed=4)
    opt = tts.make_optimizer(LR, warmup_steps=1, total_steps=10)
    state, opt = tts.create_train_state(cfg, torch.Generator().manual_seed(4), "cpu", opt)
    step = tts.make_train_step(cfg, opt)
    try:
        for i, tok, tgt, mask in tdata.batches(tdata.TokenDataset(dataset), B, S, seed=4,
                                               num_steps=STEPS, device="cpu"):
            state, loss = step(state, tok, tgt, mask)
            got = tr.step(i)
            assert torch.equal(got, loss), (i, got, loss)
        for tree in ("params",):
            for a, b in zip(tts.tree_leaves(getattr(tr.state, tree)),
                            tts.tree_leaves(getattr(state, tree))):
                assert torch.equal(a, b)
        for m in ("mu", "nu"):
            for a, b in zip(tts.tree_leaves(tr.state.opt_state[m]),
                            tts.tree_leaves(state.opt_state[m])):
                assert torch.equal(a, b)
    finally:
        torch.use_deterministic_algorithms(False)
        tr.close()
        launch.shutdown()


def _rank(f, F, t, T, d=0):
    return SimpleNamespace(fsdp_rank=f, fsdp=F, expert_rank=0, expert=1, rank=t, world=T,
                           replica=d, seq_rank=0, seq=1, device=torch.device("cpu"))


@pytest.mark.parametrize("axes", MESHES, ids=MESH_IDS)
def test_each_ranks_blocks_are_the_two_axis_cut(axes):
    """A fresh state on each rank (its draws cut as they come) holds the
    one-device state's blocks at the reference's shard indices: every
    ``addressable_shards`` index of the JAX state on ``make_mesh(**axes)``
    is the port's region of the rank at that device's coordinates (but for
    ``wk``/``wv`` on a tensor axis that does not divide the kv heads, which
    the port keeps whole on each tensor peer)."""
    cfg, jcfg = tl.llama_tiny(), jl.llama_tiny()
    F, T = axes.get("fsdp", 1), axes.get("tensor", 1)
    one, _ = tts.create_train_state(cfg, torch.Generator().manual_seed(2), "cpu")
    full = dict(tts.tree_items(one.params))
    mesh = j_make_mesh(**axes)
    with set_mesh(mesh):
        jstate, _ = j_create_train_state(jcfg, mesh, jax.random.key(0))
    coords = {d.id: c for c, d in np.ndenumerate(mesh.devices)}   # (pipe, data, fsdp, ...)
    for f in range(F):
        for t in range(T):
            state, _ = tts.create_train_state(cfg, torch.Generator().manual_seed(2), "cpu",
                                              mesh=_rank(f, F, t, T))
            lay = TrainLayout(cfg, f, F, t, T)
            for path, block in tts.tree_items(state.params):
                want = full[path]
                for axis, lo, hi in lay.regions(path, want.shape):
                    want = want.narrow(axis, lo, hi - lo)
                assert torch.equal(block, want), path
            for m in ("mu", "nu"):
                for (path, z), (_, p) in zip(tts.tree_items(state.opt_state[m]),
                                             tts.tree_items(state.params)):
                    assert z.shape == p.shape and not z.any()
    for path, arr in jax.tree_util.tree_flatten_with_path(jstate.params)[0]:
        keys = tuple(str(k.key) for k in path)
        for shard in arr.addressable_shards:
            c = coords[shard.device.id]
            lay = TrainLayout(cfg, c[2], F, c[5], T)
            want = [(i.start or 0, arr.shape[a] if i.stop is None else i.stop)
                    for a, i in enumerate(shard.index)]
            if keys[-1] in ("wk", "wv") and not lay.kv_shard:
                # kv heads tensor does not divide: the reference cuts their
                # columns, the port keeps them whole on every tensor peer.
                want[-1] = (0, arr.shape[-1])
            got = [(0, n) for n in arr.shape]
            for axis, lo, hi in lay.regions(keys, arr.shape):
                got[axis] = (lo, hi)
            assert got == want, (keys, c)


def test_a_port_save_restores_in_the_jax_trainer_on_another_mesh(dataset, tmp_path):
    """A save at ``tensor=2, fsdp=2, data=2`` after two steps, restored by
    the JAX ``restore_checkpoint`` onto ``tensor=4, data=2``: every param
    and moment bit for bit, and the step and counts."""
    root = str(tmp_path / "ckpt")
    tr = _trainer(_mesh(data=2, fsdp=2, tensor=2), dataset, seed=1)
    try:
        for i in range(2):
            tr.step(i)
        assert tr.save(root).endswith("step_00000002")
        want = tr.full_state()
    finally:
        tr.close()
    assert tckpt.latest_step(root) == 2
    mesh = j_make_mesh(tensor=4, data=2)
    with set_mesh(mesh):
        fresh, _ = j_create_train_state(jl.llama_tiny(), mesh, jax.random.key(7),
                                        jts.make_optimizer(LR, warmup_steps=1, total_steps=10))
        got = j_restore_checkpoint(root, fresh)
    assert int(got.step) == 2 and int(got.opt_state[1][0].count) == 2
    jgot = _jax_state(got)
    assert sorted(jgot) == sorted(want)
    for name, w in want.items():
        np.testing.assert_array_equal(jgot[name], w.numpy(), err_msg=name)


def test_a_resumed_mesh_run_continues_with_the_uninterrupted_loss(dataset, tmp_path):
    """Two steps, a save, a third step; then a fresh trainer (its state the
    seed's init again) restored from the save: its third step's loss and
    state equal the uninterrupted run's, bit for bit."""
    root = str(tmp_path / "ckpt")
    mesh = _mesh(data=2, fsdp=2, tensor=2)
    tr = _trainer(mesh, dataset, seed=1)
    try:
        tr.step(0)
        tr.step(1)
        tr.save(root)
        want_loss = tr.step(2)
        want = tr.full_state()
    finally:
        tr.close()
    tr = _trainer(mesh, dataset, seed=1)
    try:
        assert tr.restore(root) == 2
        assert torch.equal(tr.step(2), want_loss)
        got = tr.full_state()
        for name in want:
            assert torch.equal(got[name], want[name]), name
    finally:
        tr.close()


def test_a_jax_save_restores_in_the_port_on_another_mesh(dataset, tmp_path):
    """A JAX save at ``fsdp=4, tensor=2`` after two steps (orbax chunks by
    shard) restored by the port at ``data=2, tensor=4``: each rank reads
    its blocks, which gather to the JAX state bit for bit, and the
    leader's own blocks are the cut of it."""
    root = str(tmp_path / "ckpt")
    init, _losses, jstate = _jax_run(dict(fsdp=4, tensor=2), dataset, steps=2)
    j_save_checkpoint(root, jstate)
    want = _jax_state(jstate)
    mesh = _mesh(data=2, tensor=4)
    tr = _trainer(mesh, dataset, seed=3)
    try:
        assert tr.restore(root) == 2
        assert tr.state.opt_state["count"] == 2
        lay = tr.layout
        for prefix, tree in (("params", tr.state.params),
                             ("opt_state.1.0.mu", tr.state.opt_state["mu"]),
                             ("opt_state.1.0.nu", tr.state.opt_state["nu"])):
            for path, block in tts.tree_items(tree):
                w = torch.from_numpy(want[".".join((prefix, *path))].copy())
                assert torch.equal(block, lay.cut(path, w)), path
        got = tr.full_state()
        for name, w in want.items():
            np.testing.assert_array_equal(got[name].numpy(), w, err_msg=name)
    finally:
        tr.close()


def test_a_dead_rank_ends_the_training_group(dataset):
    """A follower (global rank 3) killed between two steps: the group
    fails naming it, and the leader's next step raises ``RankFailure``
    instead of waiting in a collective."""
    import time

    mesh = _mesh(data=2, tensor=4)
    tr = _trainer(mesh, dataset)
    tr.step(0)
    proc = mesh.group._procs[2]
    proc.kill()
    proc.wait()
    deadline = time.monotonic() + 30
    while mesh.group.failed is None and time.monotonic() < deadline:
        time.sleep(0.05)
    assert mesh.group.failed is not None and "rank 3" in mesh.group.failed
    with pytest.raises(launch.RankFailure, match="rank 3"):
        tr.step(1)
    launch.shutdown()


def test_flash_gets_kv_heads_that_match_each_ranks_q_heads(monkeypatch):
    """On a rank whose q-head block straddles a replicated cache's kv
    groups (6 heads, 3 kv heads, tensor 2: 3 q heads a rank), the
    attention's flash call gets one kv head per q head, so the kernel
    launches on the GPU, and both ranks' blocks compute the reference
    attention of their heads."""
    cfg = tl.LlamaConfig(vocab_size=64, hidden_size=96, intermediate_size=64, num_layers=1,
                         num_heads=6, num_kv_heads=3, head_dim=16, max_seq_len=512,
                         dtype=torch.float32, tie_embeddings=True)
    seen = []
    real = tfa.flash_attention

    def spy(q, k, v, *a, **kw):
        seen.append((q.shape[2], k.shape[2], v.shape[2]))
        return real(q, k, v, *a, **kw)

    monkeypatch.setattr(tfa, "flash_attention", spy)
    full, _ = tts.create_train_state(cfg, torch.Generator().manual_seed(0), "cpu")
    x = torch.randn((1, 256, cfg.hidden_size), generator=torch.Generator().manual_seed(1))
    pos = torch.arange(256)[None, :]
    rope = tl.rope_tables(pos, cfg.head_dim, cfg.rope_theta)
    for t in range(2):
        mesh = SimpleNamespace(**vars(_rank(0, 1, t, 2)), reduce=lambda x, axis: x)
        state, _ = tts.create_train_state(cfg, torch.Generator().manual_seed(0), "cpu",
                                          mesh=mesh)
        w = tl.layer_slices(state.params)[0]
        got = tl.train_block(x, w, cfg, pos, "flash", rope, mesh)
        ref = tl.train_block(x, w, cfg, pos, "reference", rope, mesh)
        torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-5)
    assert seen == [(3, 3, 3), (3, 3, 3)]
    assert full.params["layers"]["wk"].shape[-1] == 3 * 16


def _cli(argv):
    buf = io.StringIO()
    with redirect_stdout(buf):
        assert tcli.main(argv) == 0
    return buf.getvalue()


def test_cli_trains_saves_and_resumes_on_a_mesh(dataset, tmp_path):
    """``--data 2 --fsdp 2 --tensor 2 --device cpu``: the mesh on the first
    line, step lines, a save every 2 steps, and a resumed run that ends at
    the checkpoint the uninterrupted run would have written."""
    launch.shutdown()
    ckpt = str(tmp_path / "ckpts")
    common = ["--dataset", dataset, "--model", "tiny", "--device", "cpu", "--batch", "8",
              "--seq-len", "32", "--warmup-steps", "1", "--log-every", "1",
              "--ckpt-dir", ckpt, "--save-every", "2", "--data", "2", "--fsdp", "2",
              "--tensor", "2"]
    first = _cli(common + ["--steps", "3"])
    assert first.splitlines()[0] == (
        "train: model=tiny mesh={'pipe': 1, 'data': 2, 'fsdp': 2, 'expert': 1, 'seq': 1, "
        "'tensor': 2} batch=8 seq=32")
    assert [ln.split()[1] for ln in first.splitlines() if ln.startswith("step ")] == \
        ["1", "2", "3"]
    assert sorted(os.listdir(ckpt)) == ["step_00000002", "step_00000003"]
    assert launch.current() is None                 # the CLI closed its group
    second = _cli(common + ["--steps", "5"])
    assert "train: resumed from step 3" in second
    assert [ln.split()[1] for ln in second.splitlines() if ln.startswith("step ")] == \
        ["4", "5"]
    losses = [float(ln.split()[3]) for ln in (first + second).splitlines()
              if ln.startswith("step ")]
    assert all(np.isfinite(losses)) and tckpt.latest_step(ckpt) == 5


def test_cli_default_layout_is_the_references(dataset, tmp_path, monkeypatch):
    """With no axis, both CLIs lay the run out as ``data = gcd(devices,
    batch)`` over the 8 CPU devices (gloo ranks for the port): the same
    first line at ``--batch 4``, and the port's rule at other counts, for
    either family."""
    launch.shutdown()
    argv = ["--dataset", dataset, "--model", "tiny", "--batch", "4", "--seq-len", "32",
            "--steps", "1", "--log-every", "1"]
    buf = io.StringIO()
    with redirect_stdout(buf):
        assert jcli.main(argv) == 0
    want = buf.getvalue().splitlines()[0]
    assert "'data': 4" in want
    assert _cli(argv + ["--device", "cpu"]).splitlines()[0] == want
    from kukeon_tpu_torch.parallel import mesh as tmesh

    for n, batch in ((1, 8), (8, 2), (8, 12), (6, 4), (5, 3)):
        monkeypatch.setattr(tmesh, "visible_devices", lambda _t, n=n: n)
        for model in ("tiny", "mixtral-tiny"):
            args = tcli.build_parser().parse_args(["--dataset", "x", "--batch", str(batch),
                                                   "--model", model])
            got = tcli.mesh_axes(args, torch.device("cpu"))
            assert got == {"data": math.gcd(n, batch) if n > 1 else 1, "fsdp": 1,
                           "expert": 1, "tensor": 1, "seq": 1, "pipe": 1}


def test_cli_over_grant_exits_before_any_rank_starts(tmp_path):
    launch.shutdown()
    with pytest.raises(SystemExit, match="wants 16 CPU ranks but only 8 visible"):
        tcli.main(["--dataset", str(tmp_path / "x.bin"), "--device", "cpu", "--data", "8",
                   "--fsdp", "2"])
    assert launch.current() is None


# What the CLI once refused trains: the MoE family on data and expert axes
# (ROADMAP A13c2) and on a seq axis (A13d2).
@pytest.mark.parametrize("extra, mesh", [
    (["--model", "mixtral-tiny", "--data", "2"], "'data': 2, 'fsdp': 1, 'expert': 1, 'seq': 1"),
    (["--model", "mixtral-tiny", "--expert", "2"],
     "'data': 1, 'fsdp': 1, 'expert': 2, 'seq': 1"),
    (["--expert", "2"], "'data': 1, 'fsdp': 1, 'expert': 2, 'seq': 1"),
    (["--model", "mixtral-tiny", "--seq", "2"], "'data': 1, 'fsdp': 1, 'expert': 1, 'seq': 2"),
    (["--model", "mixtral-tiny", "--seq", "2", "--fsdp", "2"],
     "'data': 1, 'fsdp': 2, 'expert': 1, 'seq': 2")])
def test_cli_trains_the_moe_family_and_the_expert_axis_on_a_mesh(dataset, extra, mesh):
    """The MoE family on a data, an expert and a seq axis, and the Llama
    family with its leaves replicated over ``--expert``, one step a run."""
    launch.shutdown()
    out = _cli(["--dataset", dataset, "--device", "cpu", "--batch", "8", "--seq-len", "32",
                "--steps", "1", "--log-every", "1"] + extra)
    assert f"mesh={{'pipe': 1, {mesh}, 'tensor': 1}}" in out.splitlines()[0]
    step = [ln.split() for ln in out.splitlines() if ln.startswith("step ")]
    assert [r[1] for r in step] == ["1"] and np.isfinite(float(step[0][3]))
    assert ("lb=" in step[0][4]) == ("mixtral-tiny" in extra)
    assert launch.current() is None


def test_the_moe_forward_on_a_mesh_without_a_cache_is_the_training_forward():
    """``moe.forward_with_aux`` with a mesh and no cache runs the training
    mesh's forward (``moe.forward_train``): on a one-rank mesh its logits
    and aux losses are the one-device forward's, bit for bit, and so are
    its last position's logits."""
    from kukeon_tpu_torch.models import moe as tm

    launch.shutdown()
    cfg = tm.moe_tiny()
    params = tm.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    tokens = torch.randint(0, cfg.vocab_size, (2, 16), generator=torch.Generator().manual_seed(1))
    pos = torch.arange(16)[None, :].expand(2, 16)
    mesh = _mesh()
    try:
        with torch.no_grad():
            want, _, want_aux = tm.forward_with_aux(params, cfg, tokens, pos)
            got, cache, aux = tm.forward_with_aux(params, cfg, tokens, pos, mesh=mesh)
            last, _, _ = tm.forward_with_aux(params, cfg, tokens, pos, mesh=mesh,
                                             logit_positions=torch.tensor([15, 15]))
        assert cache is None and torch.equal(got, want)
        assert all(torch.equal(aux[k], want_aux[k]) for k in want_aux)
        assert torch.equal(last, want[:, 15:])
    finally:
        launch.shutdown()


def test_a_training_mesh_refuses_what_its_specs_cannot_cut():
    cfg = tl.llama_tiny()
    with pytest.raises(SystemExit, match="fsdp 3 does not divide hidden_size 128"):
        TrainLayout(cfg, 0, 3, 0, 1)
    with pytest.raises(SystemExit, match="tensor 8 does not divide num_heads 4"):
        TrainLayout(cfg, 0, 1, 0, 8)
    with pytest.raises(ValueError, match="batch 6 does not divide over data 2 x fsdp 2"):
        tdata.rank_rows(6, SimpleNamespace(data=2, fsdp=2, replica=0, fsdp_rank=0))
