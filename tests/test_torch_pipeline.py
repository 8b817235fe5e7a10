"""Pipeline parallelism of the port (the GPipe step over ``pipe``) against
the JAX package, on gloo ranks on the CPU.

- ``pipeline_forward`` on ``pipe=4, data=2`` against the JAX
  ``pipeline_forward`` within 2e-4 (the reference's test), ``pipe=1``
  against the plain forward, and the reference's two ``ValueError``\\ s.
- ``tiny`` cut to 4 layers, f32, through ``MeshTrainer`` against the JAX
  ``make_pp_train_step`` on ``pipe=4, data=2`` and ``pipe=2, tensor=2,
  data=2``, 3 steps at lr 1e-2, warmup 1, B 8, S 32, under the mesh
  training rule (losses and moments within 1e-5; a param may leave it at
  no more than 1e-4 of a leaf's elements, by at most a hundredth of a
  step); a microbatch count the batch group does not divide; every
  replicated leaf bitwise equal on its pipe, data and tensor peers.
- A save at ``pipe=4`` restored at ``fsdp=4`` and by the JAX package,
  bit for bit.
- The CLI trains, saves and resumes at ``--pipe 2 --data 2`` and
  ``--seq 2 --data 2``; ``mixtral-tiny`` at ``--pipe 2`` exits 2 with the
  reference's message, also beside ``--seq 2`` (the MoE family trains on
  ``seq``: ``tests/test_torch_moe_seq_training.py``).

The JAX side runs in a child process (``tests/torch_jax_refs.py``: one
for the file's steps and forward, :func:`refs`, one for the restore). One
rank group at a time serves the file (:func:`_mesh`); its collectives and
rendezvous time out after ``GROUP_TIMEOUT_S``, so no case can hang the
suite.
"""

import dataclasses
import io
import os
from contextlib import redirect_stderr, redirect_stdout
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from kukeon_tpu.models import llama as jl
from kukeon_tpu.parallel import pipeline as jpp
from kukeon_tpu_torch.models import llama as tl
from kukeon_tpu_torch.parallel import launch
from kukeon_tpu_torch.parallel import pipeline as tpp
from kukeon_tpu_torch.parallel.mesh import make_mesh
from kukeon_tpu_torch.parallel.sharding import Recipe, TrainLayout
from kukeon_tpu_torch.training import checkpointing as tckpt
from kukeon_tpu_torch.training import cli as tcli
from kukeon_tpu_torch.training import data as tdata
from kukeon_tpu_torch.training.mesh_trainer import MeshTrainer
from tests import torch_jax_refs
from tests import torch_rank_calls as calls

torch.set_num_threads(2)

TOL = dict(rtol=1e-5, atol=1e-5)
B, S, STEPS, LR = 8, 32, 3, 1e-2
GROUP_TIMEOUT_S = "60"
RARE, RARE_TOL = 1e-4, LR * 1e-2      # as tests/test_torch_mesh_training.py
# In the order that lets the next tests reuse the pipe=4 group.
PP_MESHES = [dict(pipe=2, tensor=2, data=2), dict(pipe=4, data=2)]
PP_IDS = ["pipe2_tensor2_data2", "pipe4_data2"]


@pytest.fixture(scope="module", autouse=True)
def _groups():
    mp = pytest.MonkeyPatch()
    mp.setenv(launch.TIMEOUT_ENV, GROUP_TIMEOUT_S)
    yield
    launch.shutdown()
    mp.undo()


def _mesh(data=1, fsdp=1, tensor=1, pipe=1):
    g = launch.current()
    if g is not None and (g.world, g.fsdp, g.seq, g.pipe, g.tensor) != (
            data * fsdp * tensor * pipe, fsdp, 1, pipe, tensor):
        launch.shutdown()
    return make_mesh(data, tensor, "cpu", fsdp=fsdp, pipe=pipe)


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("data") / "tok.bin")
    tdata.TokenDataset.write(path, np.random.default_rng(5).integers(0, 512, 20000))
    return path


FWD_TOKENS = np.random.default_rng(1).integers(0, 512, (4, 16)).astype(np.int32)
FWD_POS = np.broadcast_to(np.arange(16, dtype=np.int32)[None, :], (4, 16)).copy()
MICRO_AXES = dict(pipe=2, data=2, fsdp=2)


@pytest.fixture(scope="module")
def refs(dataset, tmp_path_factory):
    """The JAX ``pipeline_forward`` and ``make_pp_train_step`` runs of the
    file (``tiny`` cut to 4 layers), computed in one child process."""
    jobs = [("forward", "pipeline_logits", dict(axes=dict(pipe=4, data=2), tokens=FWD_TOKENS,
                                                positions=FWD_POS, num_microbatches=4,
                                                num_layers=4))]
    jobs += [(name, "train", dict(axes=axes, dataset=dataset, batch=B, seq_len=S,
                                  steps=STEPS, pipeline=True, num_layers=4))
             for name, axes in zip(PP_IDS, PP_MESHES)]
    jobs.append(("micro", "train", dict(axes=MICRO_AXES, dataset=dataset, batch=B, seq_len=S,
                                        steps=2, pipeline=True, num_microbatches=2,
                                        num_layers=4)))
    return torch_jax_refs.compute(jobs, str(tmp_path_factory.mktemp("jax")))


def _cfgs(layers=4):
    return (dataclasses.replace(tl.llama_tiny(), num_layers=layers),
            dataclasses.replace(jl.llama_tiny(), num_layers=layers))


def _recipe(init: dict, path) -> Recipe:
    """A recipe of the JAX init's leaves (``{"params.a.b": array}``)."""
    np.savez(path, **{k[len("params."):].replace(".", "/"): v for k, v in init.items()})
    return Recipe("kukeon_tpu_torch.models.convert:npz_leaves", {"path": str(path)})


def _trainer(mesh, dataset, init=None, **kw):
    cfg, _ = _cfgs()
    return MeshTrainer(mesh, model="tiny", dataset=dataset, batch=B, seq_len=S, lr=LR,
                       warmup_steps=1, total_steps=10, init=init, cfg=cfg, **kw)


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


@pytest.mark.parametrize("axes", PP_MESHES, ids=PP_IDS)
def test_pp_steps_match_the_jax_pp_step(axes, refs, dataset, tmp_path, request):
    """3 steps of the GPipe step (M = 2 x pipe) against the JAX
    ``make_pp_train_step``: losses, every param and moment; the leaves the
    stages share bitwise equal on every peer after the updates."""
    want = refs[request.node.callspec.id]
    tr = _trainer(_mesh(**axes), dataset, _recipe(want["init"], tmp_path / "init.npz"))
    try:
        assert tr.pipeline and tr.layout.spec(("layers", "wq"))[0] == "pipe"
        losses = [float(tr.step(i)) for i in range(STEPS)]
        np.testing.assert_allclose(losses, want["losses"], **TOL)
        _assert_state_close(tr.full_state(), want["state"])
        assert tr.replica_mismatches() == []
    finally:
        tr.close()


def test_pipeline_forward_matches_the_jax_pipeline(refs):
    """``pipe=4, data=2``, B 4, S 16, 4 microbatches: the port's logits on
    every rank within 2e-4 of the JAX ``pipeline_forward``'s (and of the
    plain forward's, which the reference's test holds it to)."""
    cfg, _ = _cfgs()
    want = refs["forward"]
    got = calls.run(_mesh(pipe=4, data=2), "tests.torch_rank_calls:pipeline_logits", cfg=cfg,
                    params=want["params"], tokens=FWD_TOKENS, positions=FWD_POS, m=4)
    assert len(got) == 8
    for logits in got:
        np.testing.assert_allclose(logits, want["logits"], rtol=2e-4, atol=2e-4)
        np.testing.assert_allclose(logits, want["plain"], rtol=2e-4, atol=2e-4)
    assert all(np.array_equal(g, got[0]) for g in got)


def test_a_pipe4_save_restores_at_fsdp4_and_in_the_jax_trainer(dataset, tmp_path):
    """Two steps at ``pipe=4, data=2``, a save (each stage's layers
    gathered to rank 0); the same checkpoint read at ``fsdp=4`` by the
    port and by the JAX ``restore_checkpoint`` onto ``tensor=4, data=2``:
    every param and moment bit for bit, and the counts; a step and a save
    at ``fsdp=4`` read back at ``pipe=4, data=2``, bit for bit."""
    root = str(tmp_path / "ckpt")
    tr = _trainer(_mesh(pipe=4, data=2), dataset, seed=1)
    try:
        tr.step(0)
        tr.step(1)
        assert tr.save(root).endswith("step_00000002")
        want = tr.full_state()
    finally:
        tr.close()
    root3 = str(tmp_path / "ckpt3")
    tr = _trainer(_mesh(fsdp=4), dataset, seed=3)
    try:
        assert not tr.pipeline and tr.restore(root) == 2
        got = tr.full_state()
        for name, w in want.items():
            assert torch.equal(got[name], w), name
        tr.step(2)
        tr.save(root3)
        want3 = tr.full_state()
    finally:
        tr.close()
    # And back: the fsdp=4 save of step 3 read into each stage's blocks.
    tr = _trainer(_mesh(pipe=4, data=2), dataset, seed=5)
    try:
        assert tr.restore(root3) == 3
        got = tr.full_state()
        for name, w in want3.items():
            assert torch.equal(got[name], w), name
    finally:
        tr.close()
    jax_side = torch_jax_refs.compute(
        [("restore", "restore", dict(root=root, axes=dict(tensor=4, data=2), num_layers=4))],
        str(tmp_path))["restore"]
    assert (jax_side["step"], jax_side["count"]) == (2, 2)
    jgot = jax_side["state"]
    assert sorted(jgot) == sorted(want)
    for name, w in want.items():
        np.testing.assert_array_equal(jgot[name], w.numpy(), err_msg=name)


def test_microbatches_the_batch_group_does_not_divide(refs, dataset, tmp_path):
    """``pipe=2, data=2, fsdp=2`` at 2 microbatches of 4 rows: half the
    batch ranks run none, and the loss and state are still the global
    batch's (the JAX step at ``num_microbatches`` 2 on that mesh); fsdp
    ranks split rows like data ranks (the pipeline's specs cut nothing on
    fsdp)."""
    want = refs["micro"]
    tr = _trainer(_mesh(**MICRO_AXES), dataset, _recipe(want["init"], tmp_path / "init.npz"),
                  num_microbatches=2)
    try:
        coords = [SimpleNamespace(axis_size=lambda _a: 4, replica=d, fsdp=2, fsdp_rank=f,
                                  seq=1, seq_rank=0) for d in (0, 1) for f in (0, 1)]
        assert [list(tpp.microbatches(2, c)) for c in coords] == [[], [0], [], [1]]
        np.testing.assert_allclose([float(tr.step(i)) for i in range(2)], want["losses"],
                                   **TOL)
        _assert_state_close(tr.full_state(), want["state"])
        assert tr.replica_mismatches() == []
    finally:
        tr.close()


def test_a_single_stage_pipeline_is_the_plain_forward():
    """``pipe=1`` (one rank, 2 microbatches): the plain forward's logits
    within the reference's 2e-4 (``test_pipeline_single_stage_degenerates``)."""
    launch.shutdown()
    cfg, _ = _cfgs()
    params = tl.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    tokens = torch.randint(0, cfg.vocab_size, (2, 8), generator=torch.Generator().manual_seed(2))
    pos = torch.arange(8, dtype=torch.int32)[None, :].expand(2, 8).contiguous()
    want, _ = tl.forward(params, cfg, tokens, pos)
    mesh = _mesh()
    got = tpp.pipeline_forward(params, cfg, tokens, pos, mesh, num_microbatches=2)
    torch.testing.assert_close(got, want, rtol=2e-4, atol=2e-4)
    launch.shutdown()


def test_the_pipeline_layout_is_the_references_pp_specs():
    """``TrainLayout(pipeline=True)``'s specs are the reference's
    ``pp_specs_for_params`` leaf for leaf (a tied and an untied tree), and
    a stage's blocks are its ``[s L / P, (s + 1) L / P)`` layers."""
    for tie in (True, False):
        cfg, jcfg = (dataclasses.replace(c, tie_embeddings=tie) for c in _cfgs())
        want = jpp.pp_specs_for_params(jax.eval_shape(lambda k: jl.init_params(k, jcfg),
                                                      jax.random.key(0)))
        lay = TrainLayout(cfg, 0, 1, 1, 2, pipe_rank=3, pipe=4, pipeline=True)
        for path, spec in jax.tree_util.tree_flatten_with_path(
                want, is_leaf=lambda v: isinstance(v, P))[0]:
            keys = tuple(str(k.key) for k in path)
            assert lay.spec(keys) == tuple(spec), keys
        assert lay.regions(("layers", "wq"), (4, 128, 128)) == ((2, 64, 128), (0, 3, 4))


def test_the_references_validations():
    """``B % M`` and ``num_layers % pipe`` raise the reference's
    ``ValueError``\\ s, before any collective."""
    cfg, _ = _cfgs()
    tokens = torch.zeros((4, 8), dtype=torch.int32)
    four = type("Pipe4", (), {"pipe": 4})()
    with pytest.raises(ValueError, match="batch 4 % microbatches 3 != 0"):
        tpp.pipeline_forward({}, cfg, tokens, tokens, four, num_microbatches=3)
    with pytest.raises(ValueError, match="num_layers 3 % pipe 4 != 0"):
        tpp.pipeline_forward({}, dataclasses.replace(cfg, num_layers=3), tokens, tokens, four)
    with pytest.raises(ValueError, match="num_layers 3 % pipe 4 != 0"):
        TrainLayout(dataclasses.replace(cfg, num_layers=3), 0, 1, 0, 1, pipe_rank=0, pipe=4,
                    pipeline=True)


def _cli(argv):
    buf = io.StringIO()
    with redirect_stdout(buf):
        assert tcli.main(argv) == 0
    return buf.getvalue()


@pytest.mark.parametrize("axes, mesh", [
    (["--pipe", "2", "--data", "2"], "{'pipe': 2, 'data': 2, 'fsdp': 1, 'expert': 1, 'seq': 1, "
                                     "'tensor': 1}"),
    (["--seq", "2", "--data", "2"], "{'pipe': 1, 'data': 2, 'fsdp': 1, 'expert': 1, 'seq': 2, "
                                    "'tensor': 1}")], ids=["pipe2_data2", "seq2_data2"])
def test_cli_trains_saves_and_resumes_on_pipe_and_seq(dataset, tmp_path, axes, mesh):
    """The mesh on the first line, step lines, a save every 2 steps, and a
    resumed run that ends at the checkpoint the uninterrupted run would
    have written."""
    launch.shutdown()
    ckpt = str(tmp_path / "ckpts")
    common = ["--dataset", dataset, "--model", "tiny", "--device", "cpu", "--batch", "8",
              "--seq-len", "32", "--warmup-steps", "1", "--log-every", "1",
              "--ckpt-dir", ckpt, "--save-every", "2"] + axes
    first = _cli(common + ["--steps", "3"])
    assert first.splitlines()[0] == f"train: model=tiny mesh={mesh} batch=8 seq=32"
    assert [ln.split()[1] for ln in first.splitlines() if ln.startswith("step ")] == \
        ["1", "2", "3"]
    assert sorted(os.listdir(ckpt)) == ["step_00000002", "step_00000003"]
    assert launch.current() is None
    second = _cli(common + ["--steps", "5"])
    assert "train: resumed from step 3" in second
    losses = [float(ln.split()[3]) for ln in (first + second).splitlines()
              if ln.startswith("step ")]
    assert len(losses) == 5 and all(np.isfinite(losses)) and tckpt.latest_step(ckpt) == 5


def test_cli_refuses_the_moe_family_on_pipe(dataset):
    """``mixtral-tiny`` at ``--pipe 2``, alone and beside ``--seq 2``: exit
    2 with the reference's words and no rank started."""
    launch.shutdown()
    argv = ["--dataset", dataset, "--model", "mixtral-tiny", "--device", "cpu"]
    for extra in (["--pipe", "2"], ["--pipe", "2", "--seq", "2"]):
        err = io.StringIO()
        with redirect_stderr(err):
            assert tcli.main(argv + extra) == 2
        assert err.getvalue() == "error: pipeline parallelism is llama-only for now\n"
        assert launch.current() is None
