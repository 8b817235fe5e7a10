"""The JAX package's side of the sequence and pipeline parity tests, run in
a child process.

``tests/test_torch_seq_parallel.py`` and ``tests/test_torch_pipeline.py``
hold the port against the JAX ring, Ulysses and pipeline functions and
train steps on ``make_mesh(**axes)`` over 8 forced CPU devices. Those are
shard_map programs whose collectives XLA runs on the devices' threads; a
process that XLA aborts takes its pytest worker down with it, and an
xdist run whose worker died can wait on it until its time limit. So each
file computes its JAX references here, in a process of its own
(:func:`compute`: one process for all of a file's cases; a child killed
by a signal is run once more), and compares numpy arrays in the worker.

    python -m tests.torch_jax_refs <jobs.pkl> <out.pkl>

runs each ``(name, case, kwargs)`` of the jobs file (``case`` a function
of this module) and pickles ``{name: result}``.
"""

import os
import pickle
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LR = 1e-2


def compute(jobs: list, tmp_dir: str, timeout: float = 600.0) -> dict:
    """``{name: result}`` of ``jobs`` (``[(name, case, kwargs)]``), computed
    in a child process with 8 forced CPU devices."""
    spec, out = os.path.join(tmp_dir, "jobs.pkl"), os.path.join(tmp_dir, "out.pkl")
    with open(spec, "wb") as f:
        pickle.dump(jobs, f)
    env = {**os.environ, "XLA_FLAGS": os.environ.get("XLA_FLAGS", "")
           + " --xla_force_host_platform_device_count=8", "JAX_PLATFORMS": "cpu"}
    env["PYTHONPATH"] = os.pathsep.join(p for p in (ROOT, env.get("PYTHONPATH")) if p)
    for _attempt in range(2):
        proc = subprocess.run([sys.executable, "-m", "tests.torch_jax_refs", spec, out],
                              cwd=ROOT, env=env, capture_output=True, text=True,
                              timeout=timeout)
        if proc.returncode == 0:
            with open(out, "rb") as f:
                return pickle.load(f)
        if proc.returncode > 0:       # a Python error: it would fail again
            break
    raise AssertionError(f"the JAX reference process exited {proc.returncode}:\n"
                         f"{proc.stderr[-3000:]}")


# --- the cases (run in the child) ----------------------------------------------


def _jax():
    import jax

    jax.config.update("jax_platforms", "cpu")
    return jax


def _named(tree, prefix: str) -> dict:
    import numpy as np

    jax = _jax()
    return {".".join([prefix] + [str(k.key) for k in path]): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _state(state) -> dict:
    adam = state.opt_state[1][0]
    return {**_named(state.params, "params"), **_named(adam.mu, "opt_state.1.0.mu"),
            **_named(adam.nu, "opt_state.1.0.nu")}


def _cfg(num_layers=None, num_heads=None, num_kv_heads=None):
    import dataclasses

    from kukeon_tpu.models import llama

    over = {k: v for k, v in dict(num_layers=num_layers, num_heads=num_heads,
                                  num_kv_heads=num_kv_heads).items() if v is not None}
    return dataclasses.replace(llama.llama_tiny(), **over)


def attention(fn: str, axes: dict, q, k, v, cot, pos) -> list:
    """The JAX ``ring_attention`` or ``ulysses_attention`` on
    ``make_mesh(**axes)``: [out, dq, dk, dv] of ``sum(out * cot)``."""
    import jax.numpy as jnp
    import numpy as np

    from kukeon_tpu.parallel import make_mesh, set_mesh
    from kukeon_tpu.parallel.ring_attention import ring_attention
    from kukeon_tpu.parallel.ulysses import ulysses_attention

    jax = _jax()
    f = {"ring": ring_attention, "ulysses": ulysses_attention}[fn]
    mesh = make_mesh(**axes)

    def loss(q, k, v):
        out = f(q, k, v, q_positions=pos, kv_positions=pos, mesh=mesh)
        return jnp.sum(out * cot), out

    with set_mesh(mesh):
        (_, out), grads = jax.jit(jax.value_and_grad(loss, argnums=(0, 1, 2), has_aux=True))(
            *map(jnp.asarray, (q, k, v)))
    return [np.asarray(x) for x in (out, *grads)]


def train(axes: dict, dataset: str, batch: int, seq_len: int, steps: int,
          use_ring_attention=None, pipeline: bool = False, num_microbatches=None,
          one_device_loss: bool = False, **cfg) -> dict:
    """The JAX trainer on ``make_mesh(**axes)`` at ``tiny`` (``cfg``
    overrides), lr 1e-2, warmup 1: ``make_train_step`` (or, ``pipeline``,
    ``make_pp_train_step`` on the reference CLI's ``pp_specs_for_params``
    state) over ``steps`` batches -> {"init", "losses", "state"}, and with
    ``one_device_loss`` the plain forward's loss on step 0's batch."""
    from kukeon_tpu.models import llama
    from kukeon_tpu.parallel import make_mesh, set_mesh
    from kukeon_tpu.parallel import pipeline as pp
    from kukeon_tpu.training import create_train_state, data
    from kukeon_tpu.training import train_step as ts

    jax = _jax()
    c = _cfg(**cfg)
    mesh = make_mesh(**axes)
    with set_mesh(mesh):
        opt = ts.make_optimizer(learning_rate=LR, warmup_steps=1, total_steps=10)
        if pipeline:
            state, opt = create_train_state(
                c, mesh, jax.random.key(0), opt, init_fn=lambda k: llama.init_params(k, c),
                specs=pp.pp_specs_for_params(jax.eval_shape(
                    lambda k: llama.init_params(k, c), jax.random.key(0))))
            step_fn = pp.make_pp_train_step(c, mesh, opt, num_microbatches=num_microbatches)
            sharding = None
        else:
            state, opt = create_train_state(c, mesh, jax.random.key(0), opt)
            step_fn, sharding = ts.make_train_step(c, mesh, opt,
                                                   use_ring_attention=use_ring_attention)
        init = _named(state.params, "params")
        losses = []
        for _s, *rows in data.batches(data.TokenDataset(dataset), batch, seq_len,
                                      num_steps=steps, sharding=sharding):
            state, loss = step_fn(state, *rows)
            losses.append(float(loss))
    out = {"init": init, "losses": losses, "state": _state(state) if steps else None}
    if one_device_loss:
        out["one_device_loss"] = _one_device_loss(c, init, dataset, batch, seq_len)
    return out


def _one_device_loss(c, init: dict, dataset: str, batch: int, seq_len: int) -> float:
    """The plain forward's masked mean on one device, step 0's batch."""
    import jax.numpy as jnp

    from kukeon_tpu.models import llama
    from kukeon_tpu.training import data
    from kukeon_tpu.training.train_step import cross_entropy_loss

    params: dict = {}
    for name, arr in init.items():
        node = params
        keys = name.split(".")[1:]
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = jnp.asarray(arr)
    tok, tgt, mask = data.sample_batch(data.TokenDataset(dataset), 0, batch, seq_len)
    pos = jnp.broadcast_to(jnp.arange(seq_len, dtype=jnp.int32)[None, :], tok.shape)
    logits, _ = llama.forward(params, c, jnp.asarray(tok), pos)
    return float(cross_entropy_loss(logits, jnp.asarray(tgt), jnp.asarray(mask)))


def pipeline_logits(axes: dict, tokens, positions, num_microbatches: int, **cfg) -> dict:
    """The JAX ``pipeline_forward`` on ``make_mesh(**axes)`` and the plain
    forward, on ``init_params(key(0))`` -> {"params", "logits", "plain"}."""
    import jax.numpy as jnp
    import numpy as np
    from jax.sharding import NamedSharding, PartitionSpec as P

    from kukeon_tpu.models import llama
    from kukeon_tpu.parallel import make_mesh, set_mesh
    from kukeon_tpu.parallel import pipeline as pp

    jax = _jax()
    c = _cfg(**cfg)
    params = llama.init_params(jax.random.key(0), c)
    mesh = make_mesh(**axes)
    sharded = jax.tree.map(lambda x, s: jax.device_put(x, NamedSharding(mesh, s)), params,
                           pp.pp_specs_for_params(params), is_leaf=lambda v: isinstance(v, P))
    with set_mesh(mesh):
        logits = jax.jit(lambda p, t, q: pp.pipeline_forward(
            p, c, t, q, mesh=mesh, num_microbatches=num_microbatches))(
            sharded, tokens, positions)
    plain, _ = llama.forward(params, c, jnp.asarray(tokens), jnp.asarray(positions))
    return {"params": {k[len("params."):].replace(".", "/"): v
                       for k, v in _named(params, "params").items()},
            "logits": np.asarray(logits), "plain": np.asarray(plain)}


def ulysses_refusal(axes: dict, q_heads: int, kv_heads: int) -> str:
    """The JAX ``ulysses_attention``'s ``ValueError`` message at these head
    counts on ``make_mesh(**axes)`` (raised while tracing)."""
    import jax.numpy as jnp

    from kukeon_tpu.parallel import make_mesh, set_mesh
    from kukeon_tpu.parallel.ulysses import ulysses_attention

    jax = _jax()
    q, k = jnp.zeros((2, 16, q_heads, 8)), jnp.zeros((2, 16, kv_heads, 8))
    pos = jnp.broadcast_to(jnp.arange(16, dtype=jnp.int32)[None, :], (2, 16))
    mesh = make_mesh(**axes)
    try:
        with set_mesh(mesh):
            jax.jit(lambda *a: ulysses_attention(a[0], a[1], a[2], q_positions=a[3],
                                                 kv_positions=a[3], mesh=mesh))(q, k, k, pos)
    except ValueError as e:
        return str(e)
    raise AssertionError("the JAX ulysses_attention did not refuse")


def restore(root: str, axes: dict, **cfg) -> dict:
    """The JAX ``restore_checkpoint`` of ``root`` onto a fresh state on
    ``make_mesh(**axes)`` -> {"state", "step", "count"}."""
    from kukeon_tpu.parallel import make_mesh, set_mesh
    from kukeon_tpu.training import create_train_state, restore_checkpoint
    from kukeon_tpu.training import train_step as ts

    jax = _jax()
    mesh = make_mesh(**axes)
    with set_mesh(mesh):
        fresh, _ = create_train_state(_cfg(**cfg), mesh, jax.random.key(7),
                                      ts.make_optimizer(LR, warmup_steps=1, total_steps=10))
        got = restore_checkpoint(root, fresh)
    return {"state": _state(got), "step": int(got.step),
            "count": int(got.opt_state[1][0].count)}


def main(argv=None) -> int:
    _jax()
    spec, out = (argv or sys.argv[1:])[:2]
    with open(spec, "rb") as f:
        jobs = pickle.load(f)
    got = {name: globals()[case](**kwargs) for name, case, kwargs in jobs}
    with open(out, "wb") as f:
        pickle.dump(got, f)
    return 0


if __name__ == "__main__":
    sys.exit(main())
