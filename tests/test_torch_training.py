"""The port's trainer against the JAX package's, on the CPU.

The slice as a whole: the JAX ``make_train_step`` on a 1-device mesh and
the port's ``make_train_step`` on the CPU, from one ``llama_tiny`` (f32)
parameter tree, give the same losses and parameters step after step. The
optimizer is held against optax itself, the data loader against the JAX
loader, and checkpoints and the CLI are driven end to end. Tolerances are
f32 ones (the two frameworks sum in different orders): 1e-6 for the
optimizer alone, 1e-5 through the model.
"""

import io
import os
from contextlib import redirect_stderr, redirect_stdout

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from kukeon_tpu.models import llama as jl
from kukeon_tpu.parallel import make_mesh, set_mesh
from kukeon_tpu.training import create_train_state as j_create_train_state
from kukeon_tpu.training import data as jdata
from kukeon_tpu.training import train_step as jts
from kukeon_tpu_torch import faults as tfaults
from kukeon_tpu_torch.device import NoGPUError
from kukeon_tpu_torch.models import convert
from kukeon_tpu_torch.models import llama as tl
from kukeon_tpu_torch.ops import flash_attention as tfa
from kukeon_tpu_torch.training import checkpointing as tckpt
from kukeon_tpu_torch.training import cli as tcli
from kukeon_tpu_torch.training import data as tdata
from kukeon_tpu_torch.training import train_step as tts

torch.set_num_threads(2)


def _np_tree(tree):
    return jax.tree.map(lambda x: np.array(x), tree)


def _assert_tree_close(torch_tree, np_tree, tol, msg=""):
    t_leaves = tts.tree_leaves(torch_tree)
    j_leaves = jax.tree.leaves(np_tree)
    assert len(t_leaves) == len(j_leaves)
    for a, b in zip(t_leaves, j_leaves):
        np.testing.assert_allclose(a.detach().numpy(), b, rtol=tol, atol=tol, err_msg=msg)


def test_cross_entropy_loss_matches_jax():
    rng = np.random.default_rng(0)
    logits = (rng.standard_normal((3, 7, 50)) * 3).astype(np.float32)
    targets = rng.integers(0, 50, (3, 7)).astype(np.int32)
    mask = (rng.random((3, 7)) > 0.3).astype(np.float32)
    want = float(jts.cross_entropy_loss(*map(jnp.asarray, (logits, targets, mask))))
    got = float(tts.cross_entropy_loss(*map(torch.from_numpy, (logits, targets, mask))))
    assert abs(got - want) <= 1e-6 * abs(want)
    zero = tts.cross_entropy_loss(torch.from_numpy(logits), torch.from_numpy(targets),
                                  torch.zeros(3, 7))
    assert float(zero) == 0.0                     # denominator clamps at 1


def test_schedule_matches_optax():
    ours = tts.warmup_cosine_decay_schedule(0.0, 3e-4, 10, 100)
    theirs = optax.warmup_cosine_decay_schedule(0.0, 3e-4, 10, 100)
    for count in (0, 1, 5, 9, 10, 11, 50, 99, 100, 150):
        # abs: optax's f32 cosine near its end, 1e-6 of the peak
        assert ours(count) == pytest.approx(float(theirs(count)), rel=1e-6, abs=3e-10)


def test_optimizer_matches_optax():
    """Six updates of a random f32 tree with the same gradients through
    the port's AdamW and the JAX make_optimizer (optax), warmup 2, total 6;
    the gradients are scaled so that clipping acts on some steps only."""
    rng = np.random.default_rng(1)
    shapes = {"a": (5, 7), "b": {"c": (11,), "d": (3, 4, 2)}}
    params_np = jax.tree.map(lambda s: rng.standard_normal(s).astype(np.float32), shapes,
                             is_leaf=lambda x: isinstance(x, tuple))
    scales = [3.0, 0.05, 2.0, 0.1, 0.02, 5.0]
    grads_np = [jax.tree.map(lambda p, s=s: (rng.standard_normal(p.shape) * s / 7)
                             .astype(np.float32), params_np) for s in scales]
    norms = [float(optax.global_norm(g)) for g in grads_np]
    assert any(n >= 1 for n in norms) and any(n < 1 for n in norms)

    jopt = jts.make_optimizer(learning_rate=1e-2, warmup_steps=2, total_steps=6)
    jparams = jax.tree.map(jnp.asarray, params_np)
    jstate = jopt.init(jparams)
    topt = tts.make_optimizer(learning_rate=1e-2, warmup_steps=2, total_steps=6)
    tparams = convert.params_from_numpy(params_np, "cpu")
    tstate = topt.init(tparams)
    for i, g in enumerate(grads_np):
        updates, jstate = jopt.update(jax.tree.map(jnp.asarray, g), jstate, jparams)
        jparams = optax.apply_updates(jparams, updates)
        before = [t.clone() for t in tts.tree_leaves(tparams)]
        topt.update_([torch.from_numpy(x) for x in jax.tree.leaves(g)], tstate, tparams)
        if i == 0:                                # lr(0) = 0: no parameter moves
            for a, b in zip(tts.tree_leaves(tparams), before):
                assert torch.equal(a, b)
        adam = jstate[1][0]
        _assert_tree_close(tparams, _np_tree(jparams), 1e-6, f"params, step {i}")
        _assert_tree_close(tstate["mu"], _np_tree(adam.mu), 1e-6, f"mu, step {i}")
        _assert_tree_close(tstate["nu"], _np_tree(adam.nu), 1e-6, f"nu, step {i}")
        assert tstate["count"] == int(adam.count) == i + 1


def _batch(seed, B, S, V):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, V, (B, S + 1)).astype(np.int32)
    return tokens[:, :-1], tokens[:, 1:], np.ones((B, S), np.float32)


@pytest.fixture(scope="module")
def tiny_jax_run():
    """The JAX trainer, 4 steps of llama_tiny on a 1-device mesh: the
    initial tree, and (loss, params) after each step, as numpy."""
    cfg = jl.llama_tiny()
    mesh = make_mesh(devices=jax.devices()[:1])
    out = []
    with set_mesh(mesh):
        opt = jts.make_optimizer(learning_rate=1e-2, warmup_steps=1, total_steps=10)
        state, opt = j_create_train_state(cfg, mesh, jax.random.key(0), opt)
        init = _np_tree(state.params)
        step_fn, _ = jts.make_train_step(cfg, mesh, opt)
        for i in range(4):
            batch = tuple(map(jnp.asarray, _batch(i, 2, 32, cfg.vocab_size)))
            state, loss = step_fn(state, *batch)
            out.append((float(loss), _np_tree(state.params)))
    return init, out


def _port_state(init, **kw):
    cfg = tl.llama_tiny()
    opt = tts.make_optimizer(learning_rate=1e-2, warmup_steps=1, total_steps=10)
    # Copies: on the CPU the tensors would share the fixture's arrays, and
    # the step updates them in place.
    params = convert.params_from_numpy(jax.tree.map(np.copy, init), "cpu")
    state = tts.TrainState(params=params, opt_state=opt.init(params), step=0)
    return cfg, state, tts.make_train_step(cfg, opt, **kw)


def test_train_steps_match_jax(tiny_jax_run):
    """The slice as a whole: 4 steps, B 2, S 32, lr 1e-2, warmup 1."""
    init, jax_steps = tiny_jax_run
    cfg, state, step = _port_state(init)
    for i, (jloss, jparams) in enumerate(jax_steps):
        batch = tuple(map(torch.from_numpy, _batch(i, 2, 32, cfg.vocab_size)))
        state, loss = step(state, *batch)
        assert abs(float(loss) - jloss) <= 1e-5 * abs(jloss), (i, float(loss), jloss)
        _assert_tree_close(state.params, jparams, 1e-5, f"params after step {i}")
    assert state.step == 4


def test_remat_on_and_off_agree_bitwise(tiny_jax_run):
    init, _ = tiny_jax_run
    runs = []
    for remat in (True, False):
        cfg, state, step = _port_state(init, remat=remat)
        losses = []
        for i in range(2):
            state, loss = step(state, *map(torch.from_numpy, _batch(i, 2, 32, cfg.vocab_size)))
            losses.append(loss)
        runs.append((losses, tts.tree_leaves(state.params)))
    for a, b in zip(runs[0][0], runs[1][0]):
        assert torch.equal(a, b)
    for a, b in zip(runs[0][1], runs[1][1]):
        assert torch.equal(a, b)


def test_flash_and_reference_give_the_same_loss_and_grads(tiny_jax_run):
    """attn_impl="flash" (the plain version on the CPU, the recomputed
    reference backward) against "reference", at S 256."""
    init, _ = tiny_jax_run
    cfg = tl.llama_tiny()
    tokens, targets, mask = map(torch.from_numpy, _batch(7, 1, 256, cfg.vocab_size))
    pos = torch.arange(256, dtype=torch.int32)[None, :]
    results = []
    for impl in ("flash", "reference"):
        params = convert.params_from_numpy(jax.tree.map(np.copy, init), "cpu")
        leaves = tts.tree_leaves(params)
        for p in leaves:
            p.requires_grad_(True)
        logits, _ = tl.forward(params, cfg, tokens, pos, attn_impl=impl, remat=True)
        loss = tts.cross_entropy_loss(logits, targets, mask)
        results.append((loss, torch.autograd.grad(loss, leaves)))
    assert tfa.flash_attention.launches == 0
    (lf, gf), (lr, gr) = results
    lf, lr = float(lf.detach()), float(lr.detach())
    assert abs(lf - lr) <= 1e-5 * abs(lr)
    for a, b in zip(gf, gr):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5, atol=1e-5)


def test_sample_batch_matches_jax(tmp_path):
    rng = np.random.default_rng(3)
    path = str(tmp_path / "tok.bin")
    jds = jdata.TokenDataset.write(path, rng.integers(0, 5000, 4096))
    tds = tdata.TokenDataset(path)
    for seed, step in ((0, 0), (0, 7), (3, 1), (11, 123)):
        want = jdata.sample_batch(jds, step, 4, 64, seed=seed)
        got = tdata.sample_batch(tds, step, 4, 64, seed=seed)
        for a, b in zip(got, want):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("high, dtype", [(60000, "uint16"), (128256, "uint32")])
def test_port_reads_a_dataset_the_jax_package_wrote(tmp_path, high, dtype):
    tokens = np.random.default_rng(4).integers(0, high, 3000)
    path = str(tmp_path / "tok.bin")
    jdata.TokenDataset.write(path, tokens)
    ds = tdata.TokenDataset(path)
    assert ds.tokens.dtype == np.dtype(dtype) and len(ds) == 3000
    np.testing.assert_array_equal(np.asarray(ds.tokens), tokens)


def test_batches_resume_aligned(tmp_path):
    path = str(tmp_path / "tok.bin")
    ds = tdata.TokenDataset.write(path, np.random.default_rng(5).integers(0, 500, 2000))
    full = list(tdata.batches(ds, 2, 16, num_steps=6, seed=1, device="cpu"))
    resumed = list(tdata.batches(ds, 2, 16, start_step=4, num_steps=2, seed=1, device="cpu"))
    assert [s for s, *_ in resumed] == [4, 5]
    for (s1, *b1), (s2, *b2) in zip(full[4:], resumed):
        assert s1 == s2
        for a, b in zip(b1, b2):
            assert isinstance(a, torch.Tensor) and torch.equal(a, b)


def test_save_restore_then_next_step_is_identical(tmp_path, tiny_jax_run):
    init, _ = tiny_jax_run
    root = str(tmp_path / "ckpts")
    cfg, state, step = _port_state(init)
    state, _ = step(state, *map(torch.from_numpy, _batch(0, 2, 32, cfg.vocab_size)))
    tckpt.save_checkpoint(root, state)
    assert tckpt.latest_step(root) == 1
    batch = tuple(map(torch.from_numpy, _batch(1, 2, 32, cfg.vocab_size)))
    ref_state, ref_loss = step(state, *batch)

    # A "fresh job": a different random tree, restored in place.
    fresh, opt = tts.create_train_state(cfg, torch.Generator().manual_seed(9), "cpu",
                                        tts.make_optimizer(1e-2, warmup_steps=1,
                                                           total_steps=10))
    restored = tckpt.restore_checkpoint(root, fresh)
    assert restored.step == 1 and restored.opt_state["count"] == 1
    got_state, got_loss = tts.make_train_step(cfg, opt)(restored, *batch)
    assert torch.equal(got_loss, ref_loss)
    for a, b in zip(tts.tree_leaves(got_state.params), tts.tree_leaves(ref_state.params)):
        assert torch.equal(a, b)


def test_latest_step_empty_and_missing(tmp_path):
    assert tckpt.latest_step(str(tmp_path / "nope")) is None
    (tmp_path / "c").mkdir()
    assert tckpt.latest_step(str(tmp_path / "c")) is None


@pytest.fixture
def port_faults():
    os.environ.pop(tfaults.ENV, None)
    tfaults.reset()
    yield tfaults
    os.environ.pop(tfaults.ENV, None)
    tfaults.reset()


@pytest.mark.faults
def test_interrupted_save_preserves_previous_checkpoint(tmp_path, tiny_jax_run, port_faults):
    init, _ = tiny_jax_run
    root = str(tmp_path / "ckpts")
    _cfg, state, _step = _port_state(init)
    tckpt.save_checkpoint(root, state)                  # step 0: the survivor
    want = [t.detach().clone() for t in tts.tree_leaves(state.params)]
    state.step = 1
    os.environ[port_faults.ENV] = "checkpoint.save:1:1"
    with pytest.raises(port_faults.FaultInjected):
        tckpt.save_checkpoint(root, state)              # killed mid-save
    assert port_faults.fired("checkpoint.save") == 1
    assert tckpt.latest_step(root) == 0
    assert sorted(os.listdir(root)) == ["step_00000000"]

    fresh, _ = tts.create_train_state(tl.llama_tiny(), torch.Generator().manual_seed(3),
                                      "cpu")
    restored = tckpt.restore_checkpoint(root, fresh)
    assert restored.step == 0
    for a, b in zip(tts.tree_leaves(restored.params), want):
        assert torch.equal(a, b)
    # The fault is spent: the same save now goes through.
    assert tckpt.save_checkpoint(root, state).endswith("step_00000001")
    assert tckpt.latest_step(root) == 1


def _cli(argv):
    buf = io.StringIO()
    with redirect_stdout(buf):
        assert tcli.main(argv) == 0
    return buf.getvalue()


def test_cli_trains_saves_and_resumes(tmp_path):
    path = str(tmp_path / "tok.bin")
    tdata.TokenDataset.write(path, np.random.default_rng(6).integers(0, 512, 5000))
    ckpt = str(tmp_path / "ckpts")
    common = ["--dataset", path, "--model", "tiny", "--device", "cpu", "--batch", "2",
              "--seq-len", "32", "--warmup-steps", "1", "--log-every", "1",
              "--ckpt-dir", ckpt, "--save-every", "2"]
    first = _cli(common + ["--steps", "3"])
    assert [ln.split()[1] for ln in first.splitlines() if ln.startswith("step ")] == \
        ["1", "2", "3"]
    assert tckpt.latest_step(ckpt) == 3
    assert sorted(os.listdir(ckpt)) == ["step_00000002", "step_00000003"]
    second = _cli(common + ["--steps", "5"])
    assert "train: resumed from step 3" in second
    assert [ln.split()[1] for ln in second.splitlines() if ln.startswith("step ")] == \
        ["4", "5"]
    losses = [float(ln.split()[3]) for ln in (first + second).splitlines()
              if ln.startswith("step ")]
    assert all(np.isfinite(losses))
    assert tckpt.latest_step(ckpt) == 5


# ``--seq`` trains both families on gloo ranks (the MoE family held to the
# JAX step in tests/test_torch_moe_seq_training.py); ``--pipe`` stays
# llama-only, as in the reference.
@pytest.mark.parametrize("extra", [["--seq", "2"], ["--seq", "4", "--data", "2"]],
                         ids=["seq2", "seq4_data2"])
def test_cli_trains_mixtral_tiny_on_a_seq_axis(tmp_path, extra):
    path = str(tmp_path / "tok.bin")
    tdata.TokenDataset.write(path, np.random.default_rng(6).integers(0, 512, 5000))
    out = _cli(["--dataset", path, "--model", "mixtral-tiny", "--device", "cpu", "--batch",
                "8", "--seq-len", "32", "--steps", "2", "--warmup-steps", "1",
                "--log-every", "1"] + extra)
    assert f"'seq': {extra[1]}" in out.splitlines()[0]
    rows = [ln.split() for ln in out.splitlines() if ln.startswith("step ")]
    assert [r[1] for r in rows] == ["1", "2"]
    assert all(np.isfinite(float(r[3])) and r[4].startswith("lb=") for r in rows)


def test_cli_keeps_the_reference_moe_pipeline_refusal_beside_seq(tmp_path):
    """``mixtral-8x7b --seq 2 --pipe 2``: exit 2 with the reference's
    message, before anything is built."""
    err = io.StringIO()
    with redirect_stderr(err):
        assert tcli.main(["--dataset", str(tmp_path / "x.bin"), "--device", "cpu", "--model",
                          "mixtral-8x7b", "--seq", "2", "--pipe", "2"]) == 2
    assert err.getvalue() == "error: pipeline parallelism is llama-only for now\n"


def test_cli_without_device_raises_on_a_gpu_less_host(tmp_path):
    assert not torch.cuda.is_available()
    with pytest.raises(NoGPUError):
        tcli.main(["--dataset", str(tmp_path / "x.bin")])
