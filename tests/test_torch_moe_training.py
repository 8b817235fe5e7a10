"""The port's MoE trainer against the JAX package's, on the CPU.

The slice as a whole: the JAX ``make_moe_train_step`` on a 1-device mesh
and the port's ``make_moe_train_step`` on the CPU, from one ``moe_tiny``
(f32) parameter tree, give the same loss, cross entropy, load-balance and
router z-loss, and the same parameters, step after step: with the
configuration's capacity (no token dropped) and at ``capacity_factor``
1.0, where the GShard policy drops tokens. Tolerances are those of
``test_torch_training.py``: 1e-5 through the model. Remat is held bitwise
against no remat, the flash route (its plain version on the CPU) against
the reference attention, and the CLI trains, saves and resumes.
"""

import dataclasses
import io
import os
from contextlib import redirect_stdout

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kukeon_tpu.models import moe as jm
from kukeon_tpu.parallel import make_mesh, set_mesh
from kukeon_tpu.training import create_moe_train_state as j_create_moe_train_state
from kukeon_tpu.training import make_moe_train_step as j_make_moe_train_step
from kukeon_tpu.training import train_step as jts
from kukeon_tpu_torch.models import convert
from kukeon_tpu_torch.models import moe as tm
from kukeon_tpu_torch.ops import flash_attention as tfa
from kukeon_tpu_torch.training import checkpointing as tckpt
from kukeon_tpu_torch.training import cli as tcli
from kukeon_tpu_torch.training import data as tdata
from kukeon_tpu_torch.training import train_step as tts

torch.set_num_threads(2)

TOL = 1e-5
METRICS = ("loss", "ce", "load_balance", "router_z")
STEPS, B, S, LR = 4, 2, 32, 1e-2


def _np_tree(tree):
    return jax.tree.map(lambda x: np.array(x), tree)


def _assert_tree_close(torch_tree, np_tree, msg=""):
    t_leaves = tts.tree_leaves(torch_tree)
    j_leaves = jax.tree.leaves(np_tree)
    assert len(t_leaves) == len(j_leaves)
    for a, b in zip(t_leaves, j_leaves):
        np.testing.assert_allclose(a.detach().numpy(), b, rtol=TOL, atol=TOL, err_msg=msg)


def _batch(seed, b, s, V):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, V, (b, s + 1)).astype(np.int32)
    return tokens[:, :-1], tokens[:, 1:], np.ones((b, s), np.float32)


def _configs(capacity_factor):
    jcfg, tcfg = jm.moe_tiny(), tm.moe_tiny()
    if capacity_factor is not None:
        jcfg = dataclasses.replace(jcfg, capacity_factor=capacity_factor)
        tcfg = dataclasses.replace(tcfg, capacity_factor=capacity_factor)
    return jcfg, tcfg


def _jax_run(capacity_factor):
    """The JAX trainer, STEPS steps of moe_tiny on a 1-device mesh: the
    initial tree, and (metrics, params) after each step, as numpy."""
    cfg, _ = _configs(capacity_factor)
    mesh = make_mesh(devices=jax.devices()[:1])
    out = []
    with set_mesh(mesh):
        opt = jts.make_optimizer(learning_rate=LR, warmup_steps=1, total_steps=10)
        state, opt = j_create_moe_train_state(cfg, mesh, jax.random.key(0), opt)
        init = _np_tree(state.params)
        step_fn, _ = j_make_moe_train_step(cfg, mesh, opt)
        for i in range(STEPS):
            batch = tuple(map(jnp.asarray, _batch(i, B, S, cfg.vocab_size)))
            state, metrics = step_fn(state, *batch)
            out.append(({k: float(metrics[k]) for k in METRICS}, _np_tree(state.params)))
    return init, out


@pytest.fixture(scope="module")
def jax_runs():
    """{capacity_factor: run}: the configuration's (8.0, nothing dropped)
    and 1.0 (tokens dropped)."""
    return {cf: _jax_run(cf) for cf in (None, 1.0)}


def _port_state(init, capacity_factor=None, **kw):
    _, cfg = _configs(capacity_factor)
    opt = tts.make_optimizer(learning_rate=LR, warmup_steps=1, total_steps=10)
    # Copies: on the CPU the tensors would share the fixture's arrays, and
    # the step updates them in place.
    params = convert.params_from_numpy(jax.tree.map(np.copy, init), "cpu")
    state = tts.TrainState(params=params, opt_state=opt.init(params), step=0)
    return cfg, state, tts.make_moe_train_step(cfg, opt, **kw)


def _drops(cfg, params, seed, monkeypatch):
    """Tokens (token, choice pairs) the training capacity drops over the
    layers of a forward on batch ``seed``, counted at each block's router."""
    dropped = []
    real = tm.moe_block

    def counting(h, w, c, *a, **kw):
        n = h.shape[0] * h.shape[1]
        probs = torch.softmax(h.reshape(n, -1).float() @ w["router"], -1)
        idx = torch.topk(probs, c.experts_per_token).indices
        counts = torch.bincount(idx.reshape(-1), minlength=c.num_experts)
        dropped.append(int(torch.clamp(counts - tm._capacity(c, n), min=0).sum()))
        return real(h, w, c, *a, **kw)

    tokens = torch.from_numpy(_batch(seed, B, S, cfg.vocab_size)[0])
    pos = torch.arange(S, dtype=torch.int32)[None, :].expand(B, S)
    with monkeypatch.context() as m, torch.no_grad():
        m.setattr(tm, "moe_block", counting)
        tm.forward_with_aux(params, cfg, tokens, pos)
    assert len(dropped) == cfg.num_layers
    return sum(dropped)


@pytest.mark.parametrize("capacity_factor", [None, 1.0], ids=["no_drops", "drops"])
def test_moe_train_steps_match_jax(jax_runs, capacity_factor, monkeypatch):
    """4 steps, B 2, S 32, lr 1e-2, warmup 1: loss, ce, lb, z and every
    parameter within 1e-5 after each step."""
    init, jax_steps = jax_runs[capacity_factor]
    cfg, state, step = _port_state(init, capacity_factor)
    dropped = _drops(cfg, state.params, 0, monkeypatch)
    assert (dropped > 0) == (capacity_factor == 1.0), dropped
    for i, (jm_, jparams) in enumerate(jax_steps):
        batch = tuple(map(torch.from_numpy, _batch(i, B, S, cfg.vocab_size)))
        state, metrics = step(state, *batch)
        assert set(metrics) == set(METRICS)
        for k in METRICS:
            got = float(metrics[k])
            assert abs(got - jm_[k]) <= TOL * abs(jm_[k]), (i, k, got, jm_[k])
        _assert_tree_close(state.params, jparams, f"params after step {i}")
    assert state.step == STEPS
    assert state.params["layers"]["router"].dtype == torch.float32
    assert state.opt_state["mu"]["layers"]["router"].dtype == torch.float32


def test_moe_remat_on_and_off_agree_bitwise(jax_runs):
    init, _ = jax_runs[1.0]
    runs = []
    for remat in (True, False):
        cfg, state, step = _port_state(init, 1.0, remat=remat)
        metrics = []
        for i in range(2):
            state, m = step(state, *map(torch.from_numpy, _batch(i, B, S, cfg.vocab_size)))
            metrics.append(m)
        runs.append((metrics, tts.tree_leaves(state.params)))
    for a, b in zip(runs[0][0], runs[1][0]):
        for k in METRICS:
            assert torch.equal(a[k], b[k]), k
    for a, b in zip(runs[0][1], runs[1][1]):
        assert torch.equal(a, b)


def test_moe_forward_remat_is_bitwise_with_grads(jax_runs):
    """forward_with_aux itself: logits, aux terms and every gradient of
    remat on against off, the router's among them."""
    init, _ = jax_runs[None]
    cfg = tm.moe_tiny()
    tokens, targets, mask = map(torch.from_numpy, _batch(5, B, S, cfg.vocab_size))
    pos = torch.arange(S, dtype=torch.int32)[None, :].expand(B, S)
    results = []
    for remat in (True, False):
        params = convert.params_from_numpy(jax.tree.map(np.copy, init), "cpu")
        leaves = tts.tree_leaves(params)
        for p in leaves:
            p.requires_grad_(True)
        logits, _, aux = tm.forward_with_aux(params, cfg, tokens, pos, remat=remat)
        loss = (tts.cross_entropy_loss(logits, targets, mask)
                + aux["load_balance"] + aux["router_z"])
        router = next(i for i, p in enumerate(leaves) if p is params["layers"]["router"])
        results.append((logits.detach(), aux, torch.autograd.grad(loss, leaves)))
    (la, aa, ga), (lb, ab, gb) = results
    assert torch.equal(la, lb)
    for k in ("load_balance", "router_z"):
        assert torch.equal(aa[k], ab[k])
    for a, b in zip(ga, gb):
        assert torch.equal(a, b)
    # The aux terms reach the router through the recompute.
    assert ga[router].dtype == torch.float32 and float(ga[router].abs().max()) > 0


def test_moe_flash_and_reference_give_the_same_loss_and_grads(jax_runs):
    """attn_impl="flash" (the plain version on the CPU, the recomputed
    reference backward) against "reference", at S 256."""
    init, _ = jax_runs[None]
    cfg = tm.moe_tiny()
    tokens, targets, mask = map(torch.from_numpy, _batch(7, 1, 256, cfg.vocab_size))
    pos = torch.arange(256, dtype=torch.int32)[None, :]
    results = []
    for impl in ("flash", "reference"):
        params = convert.params_from_numpy(jax.tree.map(np.copy, init), "cpu")
        leaves = tts.tree_leaves(params)
        for p in leaves:
            p.requires_grad_(True)
        logits, _, aux = tm.forward_with_aux(params, cfg, tokens, pos, attn_impl=impl,
                                             remat=True)
        loss = (tts.cross_entropy_loss(logits, targets, mask)
                + cfg.load_balance_coef * aux["load_balance"]
                + cfg.router_z_coef * aux["router_z"])
        results.append((loss, torch.autograd.grad(loss, leaves)))
    assert tfa.flash_attention.launches == 0
    (lf, gf), (lr, gr) = results
    lf, lr = float(lf.detach()), float(lr.detach())
    assert abs(lf - lr) <= TOL * abs(lr)
    for a, b in zip(gf, gr):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=TOL, atol=TOL)


def test_moe_train_step_on_one_device():
    """The port of ``tests/test_moe.py::test_moe_train_step_on_expert_mesh``
    on one device: two steps of a fresh state, finite losses, the step
    count, and the aux terms among the metrics."""
    cfg = tm.moe_tiny()
    optimizer = tts.make_optimizer(warmup_steps=1, total_steps=10)
    state, optimizer = tts.create_moe_train_state(cfg, torch.Generator().manual_seed(0),
                                                  "cpu", optimizer)
    train_step = tts.make_moe_train_step(cfg, optimizer)
    g = torch.Generator().manual_seed(1)
    tokens = torch.randint(0, cfg.vocab_size, (4, 32), generator=g, dtype=torch.int32)
    targets = torch.roll(tokens, -1, dims=1)
    mask = torch.ones((4, 32), dtype=torch.float32)
    state, metrics = train_step(state, tokens, targets, mask)
    loss0 = float(metrics["loss"])
    state, metrics = train_step(state, tokens, targets, mask)
    assert np.isfinite(loss0)
    assert np.isfinite(float(metrics["loss"]))
    assert state.step == 2
    assert float(metrics["load_balance"]) > 0
    assert "ce" in metrics and "router_z" in metrics


def _cli(argv):
    buf = io.StringIO()
    with redirect_stdout(buf):
        assert tcli.main(argv) == 0
    return buf.getvalue()


def test_cli_trains_mixtral_tiny_saves_and_resumes(tmp_path, monkeypatch):
    # One visible device: the CLI's one-device branch (with more, the
    # reference's default lays the run out as data = gcd(devices, batch)).
    from kukeon_tpu_torch.parallel import mesh as tmesh

    monkeypatch.setattr(tmesh, "visible_devices", lambda _t: 1)
    path = str(tmp_path / "tok.bin")
    tdata.TokenDataset.write(path, np.random.default_rng(6).integers(0, 512, 5000))
    ckpt = str(tmp_path / "ckpts")
    common = ["--dataset", path, "--model", "mixtral-tiny", "--device", "cpu",
              "--batch", "2", "--seq-len", "32", "--warmup-steps", "1", "--log-every", "1",
              "--ckpt-dir", ckpt, "--save-every", "2"]
    first = _cli(common + ["--steps", "3"])
    rows = [ln.split() for ln in first.splitlines() if ln.startswith("step ")]
    assert [r[1] for r in rows] == ["1", "2", "3"]
    assert all(r[4].startswith("lb=") and r[5].startswith("(") for r in rows)
    assert tckpt.latest_step(ckpt) == 3
    assert sorted(os.listdir(ckpt)) == ["step_00000002", "step_00000003"]

    # What step 3 saved, restored into a fresh MoE state.
    fresh, _ = tts.create_moe_train_state(tm.moe_tiny(), torch.Generator().manual_seed(9),
                                          "cpu")
    saved = [t.detach().clone() for t in
             tts.tree_leaves(tckpt.restore_checkpoint(ckpt, fresh).params)]

    second = _cli(common + ["--steps", "5"])
    assert "train: resumed from step 3" in second
    rows2 = [ln.split() for ln in second.splitlines() if ln.startswith("step ")]
    assert [r[1] for r in rows2] == ["4", "5"]
    losses = [float(r[3]) for r in rows + rows2]
    lbs = [float(r[4][3:]) for r in rows + rows2]
    assert all(np.isfinite(losses)) and all(x > 0 for x in lbs)
    assert tckpt.latest_step(ckpt) == 5

    # Resume is exact: from step 3's checkpoint, two steps in process give
    # the parameters the CLI saved at step 5.
    cfg = tm.moe_tiny()
    opt = tts.make_optimizer(3e-4, warmup_steps=1, total_steps=5)
    state, _ = tts.create_moe_train_state(cfg, torch.Generator().manual_seed(9), "cpu", opt)
    state = tckpt.restore_checkpoint(ckpt, state, step=3)
    for a, b in zip(tts.tree_leaves(state.params), saved):
        assert torch.equal(a, b)
    step = tts.make_moe_train_step(cfg, opt)
    for s_, tok, tgt, mask in tdata.batches(tdata.TokenDataset(path), 2, 32, start_step=3,
                                            num_steps=2, seed=0, device="cpu"):
        state, _ = step(state, tok, tgt, mask)
    final, _ = tts.create_moe_train_state(cfg, torch.Generator().manual_seed(9), "cpu", opt)
    final = tckpt.restore_checkpoint(ckpt, final)
    assert final.step == 5
    for a, b in zip(tts.tree_leaves(state.params), tts.tree_leaves(final.params)):
        assert torch.equal(a, b)
