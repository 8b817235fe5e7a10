"""The MoE train step at ``chip_smoke.py``'s ``train_moe`` optimizer
settings (lr 3e-4, warmup 1, cosine over 6 steps) against the JAX
package's, on the CPU at ``mixtral-tiny``.

On the card, ``train_moe`` (Mixtral-8x7B at 4 layers) spikes at step 3:
the first full-rate AdamW step moves every router weight by about lr,
which moves the router logits by ~1 at 4096 wide. Here both packages take
the same 6 steps from one init: loss, load balance and router z agree
step by step within 1e-5, and so does every parameter (that router step
among them). So the spike is the reference optimizer's own behaviour at
those settings, not a port fault.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch
from test_torch_moe_training import _assert_tree_close, _batch, _np_tree

from kukeon_tpu.models import moe as jm
from kukeon_tpu.parallel import make_mesh, set_mesh
from kukeon_tpu.training import create_moe_train_state as j_create_moe_train_state
from kukeon_tpu.training import make_moe_train_step as j_make_moe_train_step
from kukeon_tpu.training import train_step as jts
from kukeon_tpu_torch.models import convert
from kukeon_tpu_torch.models import moe as tm
from kukeon_tpu_torch.training import train_step as tts

torch.set_num_threads(2)

TOL = 1e-5
METRICS = ("loss", "load_balance", "router_z")
STEPS, B, S, LR, WARMUP = 6, 2, 32, 3e-4, 1


def test_moe_steps_at_train_moe_lr_and_warmup_match_jax():
    cfg = jm.moe_tiny()
    mesh = make_mesh(devices=jax.devices()[:1])
    jax_steps = []
    with set_mesh(mesh):
        opt = jts.make_optimizer(learning_rate=LR, warmup_steps=WARMUP, total_steps=STEPS)
        state, opt = j_create_moe_train_state(cfg, mesh, jax.random.key(0), opt)
        init = _np_tree(state.params)
        step_fn, _ = j_make_moe_train_step(cfg, mesh, opt)
        for i in range(STEPS):
            batch = tuple(map(jnp.asarray, _batch(i, B, S, cfg.vocab_size)))
            state, metrics = step_fn(state, *batch)
            jax_steps.append(({k: float(metrics[k]) for k in METRICS}, _np_tree(state.params)))

    tcfg = tm.moe_tiny()
    topt = tts.make_optimizer(learning_rate=LR, warmup_steps=WARMUP, total_steps=STEPS)
    params = convert.params_from_numpy(jax.tree.map(np.copy, init), "cpu")
    tstate = tts.TrainState(params=params, opt_state=topt.init(params), step=0)
    step = tts.make_moe_train_step(tcfg, topt)
    router0 = init["layers"]["router"]
    for i, (want, jparams) in enumerate(jax_steps):
        batch = tuple(map(torch.from_numpy, _batch(i, B, S, tcfg.vocab_size)))
        tstate, metrics = step(tstate, *batch)
        for k in METRICS:
            got = float(metrics[k])
            assert abs(got - want[k]) <= TOL * abs(want[k]), (i, k, got, want[k])
        _assert_tree_close(tstate.params, jparams, f"params after step {i}")
        if i == 1:
            # The first full-rate step (warmup 1 starts at lr 0): AdamW
            # normalises the gradient, so every router entry moves by about
            # lr, whatever its gradient's size (a median of 0.72 lr here).
            moved = np.abs(tstate.params["layers"]["router"].detach().numpy() - router0)
            assert np.median(moved) > 0.5 * LR, np.median(moved)
    assert tstate.step == STEPS
