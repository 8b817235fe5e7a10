"""Orbax checkpoints on the port (``models/zstd.py``, ``models/ocdbt.py``,
``models/orbax_ckpt.py``; the cells' ``checkpoint=`` and the trainer's
checkpointing) against the JAX package on the CPU, both ways.

- The committed fixture (``tests/data/orbax_llama_tiny``, written by
  ``tools/make_orbax_fixture.py`` with orbax) still equals a fresh JAX
  restore, and the port reads it to the same hashes.
- The port reads what the JAX package writes, every leaf bit for bit
  against the JAX restore: ``StandardCheckpointer().save`` of ``llama_tiny``
  (f32 and bf16) and ``bge_tiny`` parameters, and ``save_checkpoint`` of a
  ``llama_tiny`` and a ``mixtral-tiny`` TrainState, each on one device and
  on the 8-device mesh (sharded arrays: grids of chunks).
- Cells booted from such a path give the JAX cells' results: the same
  greedy tokens (f32 and int8) and embeddings within 1e-5, the tolerance of
  ``test_torch_embedding.py``.
- The JAX package reads what the port writes: orbax restores a port-written
  tree, tensorstore lists the same keys and values, and the JAX trainer
  resumes from a step the port's trainer saved, its next loss within 1e-5
  of the port's (the tolerance of ``test_torch_training.py``).
- Refusals (a leaf of the wrong shape, a missing or extra leaf, a path of
  no known format, a store naming a data file outside the checkpoint),
  the writer holding one value at a time, the ``checkpoint.save`` kill, a
  step saved as
  ``state.pt``, and the readers with ``jax``, ``orbax``, ``tensorstore``,
  ``zstandard``, ``safetensors`` and ``ml_dtypes`` unimportable.
"""

import dataclasses
import hashlib
import json
import os
import subprocess
import sys
import weakref

import jax
import jax.numpy as jnp
import numpy as np
import orbax.checkpoint as ocp
import pytest
import tensorstore as ts
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from kukeon_tpu.models import bert as jb
from kukeon_tpu.models import llama as jl
from kukeon_tpu.models import moe as jm
from kukeon_tpu.parallel import make_mesh, set_mesh
from kukeon_tpu.parallel import sharding as shd
from kukeon_tpu.runtime import serving_cell as jcell_mod
from kukeon_tpu.training import checkpointing as jckpt
from kukeon_tpu.training import create_moe_train_state as j_create_moe_train_state
from kukeon_tpu.training import create_train_state as j_create_train_state
from kukeon_tpu.training import train_step as jts
from kukeon_tpu_torch import faults as tfaults
from kukeon_tpu_torch.models import checkpoints as tck
from kukeon_tpu_torch.models import convert, ocdbt, orbax_ckpt
from kukeon_tpu_torch.models import llama as tl
from kukeon_tpu_torch.models import moe as tm
from kukeon_tpu_torch.models.convert import BFloat16Bits
from kukeon_tpu_torch.runtime.serving_cell import EmbeddingCell, ServingCell
from kukeon_tpu_torch.training import checkpointing as tckpt
from kukeon_tpu_torch.training import train_step as tts

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(ROOT, "tests", "data", "orbax_llama_tiny")
GENERATE = {"promptTokens": [5, 300, 7, 200, 9, 41, 77, 13, 250, 3, 99], "maxNewTokens": 8}
EMBED = {"inputTokens": [[101, 7, 300, 42, 102], [101, 5, 102], list(range(1, 40))]}
TOL = dict(rtol=1e-5, atol=1e-5)


def _name(path) -> str:
    return ".".join(str(getattr(k, "key", getattr(k, "idx", getattr(k, "name", k))))
                    for k in path)


def _jax_leaves(tree) -> dict:
    """{dotted name: numpy array} of a JAX tree's array leaves."""
    return {_name(p): np.asarray(x) for p, x in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _port_leaves(tree, prefix="") -> dict:
    """{dotted name: array} of a tree the port's reader returned; None
    leaves dropped (JAX flattens them away)."""
    items = (tree.items() if isinstance(tree, dict) else enumerate(tree)
             if isinstance(tree, list) else None)
    if items is None:
        return {} if tree is None else {prefix[:-1]: tree}
    out = {}
    for k, v in items:
        out.update(_port_leaves(v, f"{prefix}{k}."))
    return out


def _bits(a: np.ndarray) -> tuple[str, tuple, bytes]:
    name = "bfloat16" if isinstance(a, BFloat16Bits) else a.dtype.name
    return name, tuple(a.shape), np.ascontiguousarray(a).reshape(-1).view(np.uint8).tobytes()


def _assert_bitwise(port: dict, ref: dict):
    assert port.keys() == ref.keys(), sorted(port.keys() ^ ref.keys())
    for k, a in port.items():
        assert _bits(a) == _bits(ref[k]), k


# --- the fixture ---------------------------------------------------------------

def _fixture_hashes() -> dict:
    with open(FIXTURE + ".json") as f:
        return json.load(f)


def test_fixture_equals_a_fresh_jax_restore():
    cfg = jl.llama_tiny()
    abstract = jax.eval_shape(lambda k: jl.init_params(k, cfg), jax.random.key(0))
    restored = _jax_leaves(ocp.StandardCheckpointer().restore(FIXTURE, abstract))
    assert {k: {"dtype": a.dtype.name, "shape": list(a.shape),
                "sha256": hashlib.sha256(a.tobytes()).hexdigest()}
            for k, a in restored.items()} == _fixture_hashes()
    size = sum(os.path.getsize(os.path.join(d, n)) for d, _, ns in os.walk(FIXTURE) for n in ns)
    assert size < 2_000_000


def test_port_reads_the_fixture_to_its_hashes():
    ckpt = orbax_ckpt.OrbaxCheckpoint(FIXTURE)
    got = _port_leaves(ckpt.read_tree())
    assert {k: {"dtype": a.dtype.name, "shape": list(a.shape),
                "sha256": hashlib.sha256(a.tobytes()).hexdigest()}
            for k, a in got.items()} == _fixture_hashes()
    # Real level-1 frames: the chunks are smaller than what they decode to.
    assert ckpt.stats["bytes_read"] < sum(a.nbytes for a in got.values())


# --- the port reads what JAX writes ----------------------------------------------

MESH8 = dict(tensor=2, fsdp=2, data=2)


def _shard_last(x, mesh):
    """A bge leaf on the 8-device mesh: its last axis split over tensor."""
    spec = P(*([None] * (x.ndim - 1) + ["tensor"])) if x.ndim and x.shape[-1] % 2 == 0 else P()
    return jax.device_put(x, NamedSharding(mesh, spec))


def _save_params(path: str, kind: str, mesh8: bool):
    """``StandardCheckpointer().save`` of a parameter tree; returns it."""
    if kind == "bge":
        params = jb.init_params(jax.random.key(1), jb.bge_tiny())
        if mesh8:
            mesh = make_mesh(**MESH8)
            params = jax.tree.map(lambda x: _shard_last(x, mesh), params)
    else:
        cfg = jl.llama_tiny()
        if kind == "llama-bf16":
            cfg = dataclasses.replace(cfg, dtype=jnp.bfloat16)
        params = jl.init_params(jax.random.key(2), cfg)
        if mesh8:
            mesh = make_mesh(**MESH8)
            specs = shd.specs_for_params(params, fsdp=True)
            params = jax.tree.map(lambda x, s: jax.device_put(x, NamedSharding(mesh, s)),
                                  params, specs, is_leaf=lambda x: isinstance(x, P))
    ckptr = ocp.StandardCheckpointer()
    ckptr.save(path, params)
    ckptr.wait_until_finished()
    return params


@pytest.mark.parametrize("mesh8", [False, True], ids=["one-device", "mesh8"])
@pytest.mark.parametrize("kind", ["llama", "llama-bf16", "bge"])
def test_port_reads_jax_written_params_bitwise(tmp_path, kind, mesh8):
    path = str(tmp_path / "ckpt")
    params = _save_params(path, kind, mesh8)
    restored = ocp.StandardCheckpointer().restore(
        path, jax.tree.map(lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype,
                                                          sharding=x.sharding), params))
    got = _port_leaves(orbax_ckpt.read_tree(path))
    _assert_bitwise(got, _jax_leaves(restored))
    if mesh8 and kind != "bge":
        # A sharded save is a grid of chunks.
        meta = orbax_ckpt.OrbaxCheckpoint(path).zarray("layers.wq")
        assert meta["chunks"] != meta["shape"]


def _jax_train_state(family: str, mesh8: bool, steps: int = 1):
    mesh = make_mesh(**MESH8) if mesh8 else make_mesh(devices=jax.devices()[:1])
    with set_mesh(mesh):
        opt = jts.make_optimizer(learning_rate=1e-2, warmup_steps=1, total_steps=10)
        if family == "llama":
            cfg = jl.llama_tiny()
            state, opt = j_create_train_state(cfg, mesh, jax.random.key(0), opt)
            step_fn, _ = jts.make_train_step(cfg, mesh, opt)
        else:
            cfg = jm.moe_tiny()
            state, opt = j_create_moe_train_state(cfg, mesh, jax.random.key(0), opt)
            step_fn, _ = jts.make_moe_train_step(cfg, mesh, opt)
        for i in range(steps):
            batch = tuple(map(jnp.asarray, _batch(i, 2, 32, cfg.vocab_size)))
            state, _ = step_fn(state, *batch)
    return mesh, state


def _batch(seed, B, S, V):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, V, (B, S + 1)).astype(np.int32)
    return tokens[:, :-1], tokens[:, 1:], np.ones((B, S), np.float32)


@pytest.mark.parametrize("mesh8", [False, True], ids=["one-device", "mesh8"])
@pytest.mark.parametrize("family", ["llama", "moe"])
def test_port_reads_jax_written_train_states_bitwise(tmp_path, family, mesh8):
    root = str(tmp_path / "ckpts")
    mesh, state = _jax_train_state(family, mesh8)
    with set_mesh(mesh):
        jckpt.save_checkpoint(root, state)
        restored = jckpt.restore_checkpoint(root, state)
    assert tckpt.latest_step(root) == jckpt.latest_step(root) == 1
    tree = orbax_ckpt.read_tree(os.path.join(root, "step_00000001"))
    assert tree["opt_state"][0] is None and tree["opt_state"][1][1] is None
    _assert_bitwise(_port_leaves(tree), _jax_leaves(restored))
    adam, sched = tree["opt_state"][1][0], tree["opt_state"][1][2]
    assert int(tree["step"]) == int(adam["count"]) == int(sched["count"]) == 1
    if family == "moe":
        assert tree["params"]["layers"]["router"].dtype == np.float32
        assert adam["mu"]["layers"]["router"].dtype == np.float32

    # The port's trainer resumes from it: every leaf lands in the template.
    if family == "llama":
        fresh, _ = tts.create_train_state(tl.llama_tiny(), torch.Generator().manual_seed(9),
                                          "cpu")
    else:
        fresh, _ = tts.create_moe_train_state(tm.moe_tiny(), torch.Generator().manual_seed(9),
                                              "cpu")
    back = tckpt.restore_checkpoint(root, fresh)
    assert back.step == 1 and back.opt_state["count"] == 1
    ref = _jax_leaves(restored)
    for prefix, tree_ in (("params", back.params), ("opt_state.1.0.mu", back.opt_state["mu"]),
                          ("opt_state.1.0.nu", back.opt_state["nu"])):
        for keys, t in tckpt._named_leaves(tree_):
            want = ref[".".join((prefix, *keys))]
            assert np.array_equal(t.detach().numpy(), want), keys


# --- cells -------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [None, "int8"], ids=["f32", "int8"])
def test_decoder_cell_serves_the_jax_cells_tokens_from_orbax(tmp_path, dtype):
    path = str(tmp_path / "ckpt")
    _save_params(path, "llama", mesh8=False)
    jc = jcell_mod.ServingCell("tiny", num_slots=2, max_seq_len=64, checkpoint=path,
                               dtype=dtype)
    tc = ServingCell("tiny", num_slots=2, max_seq_len=64, checkpoint=path, dtype=dtype,
                     device="cpu")
    assert tl._is_q(tc.engine.params["layers"]["wq"]) == (dtype == "int8")
    want = jc.generate(GENERATE)["tokens"]
    assert tc.generate(GENERATE)["tokens"] == want and len(want) == 8
    # The materialized load is counted as a stream's bytes.
    load = tc.checkpoint_load
    assert load["format"] == "orbax" and load["leaves"] == 11
    assert tc.engine.load_stats["bytes"] == load["leaf_bytes"] == sum(
        a.nbytes for a in _port_leaves(orbax_ckpt.read_tree(path)).values())
    assert load["bytes_on_disk"] > load["frame_bytes"] > 0


def test_decoder_cell_boots_from_the_fixture():
    cell = ServingCell("tiny", num_slots=2, max_seq_len=64, checkpoint=FIXTURE, device="cpu")
    jc = jcell_mod.ServingCell("tiny", num_slots=2, max_seq_len=64, checkpoint=FIXTURE,
                               dtype=None)
    assert cell.generate(GENERATE)["tokens"] == jc.generate(GENERATE)["tokens"]


def test_embedding_cell_gives_the_jax_cells_embeddings_from_orbax(tmp_path):
    path = str(tmp_path / "ckpt")
    _save_params(path, "bge", mesh8=False)
    tck.write_tokenizer_json(path)
    jc = jcell_mod.EmbeddingCell("bge-tiny", batch_size=4, checkpoint=path, chips=1)
    tc = EmbeddingCell("bge-tiny", batch_size=4, checkpoint=path, device="cpu")
    want = np.asarray(jc.embed(EMBED)["embeddings"])
    got = np.asarray(tc.embed(EMBED)["embeddings"])
    np.testing.assert_allclose(got, want, **TOL)
    # Not the random init: the checkpoint's weights.
    rand = np.asarray(EmbeddingCell("bge-tiny", batch_size=4, device="cpu")
                      .embed(EMBED)["embeddings"])
    assert not np.allclose(got, rand, atol=1e-3)
    assert type(tc.tokenizer).__name__ == type(jc.tokenizer).__name__ == "HFTokenizer"


def test_shape_mismatch_and_unknown_paths_are_refused(tmp_path):
    cfg = tl.llama_tiny()
    good = tl.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    for name, edit, match in (
            ("wrong-shape", lambda t: t["layers"].update(wk=torch.zeros(2, 64, 128)),
             r"leaf layers\.wk is \(2, 64, 128\), the model's is \(2, 128, 64\)"),
            ("missing", lambda t: t["layers"].pop("w_up"), r"has no leaf layers\.w_up"),
            ("extra", lambda t: t.update(lm_head=torch.zeros(128, 512)),
             r"has a leaf lm_head the model does not")):
        tree = {k: (dict(v) if isinstance(v, dict) else v) for k, v in good.items()}
        edit(tree)
        orbax_ckpt.write_tree(str(tmp_path / name), tree)
        with pytest.raises(SystemExit, match=match):
            ServingCell("tiny", num_slots=2, max_seq_len=64, checkpoint=str(tmp_path / name),
                        device="cpu")
    bge = str(tmp_path / "bge")
    _save_params(bge, "bge", mesh8=False)
    with pytest.raises(SystemExit, match=r"leaf embed\.norm_bias is \(64,\), the model's "
                                         r"is \(768,\)"):
        EmbeddingCell("bge-base", checkpoint=bge, device="cpu")
    (tmp_path / "other").mkdir()
    (tmp_path / "other" / "weights.bin").write_bytes(b"\0" * 16)
    with pytest.raises(SystemExit, match="nor an orbax checkpoint"):
        ServingCell("tiny", num_slots=2, max_seq_len=64, checkpoint=str(tmp_path / "other"),
                    device="cpu")
    with pytest.raises(SystemExit, match="not an orbax checkpoint"):
        EmbeddingCell("bge-tiny", checkpoint=str(tmp_path / "other"), device="cpu")


# --- JAX reads what the port writes -------------------------------------------------

def test_orbax_and_tensorstore_read_a_port_written_tree(tmp_path):
    g = torch.Generator().manual_seed(4)
    tree = {"w": torch.randn(300, 200, generator=g).to(torch.bfloat16),
            "layers": {"q": torch.randint(-127, 128, (4, 70, 33), generator=g,
                                          dtype=torch.int8),
                       "s": torch.rand(4, 33, generator=g)},
            "seq": [None, np.arange(5, dtype=np.int64), {"flag": np.array([True, False])}],
            "count": np.asarray(3, np.int32), "empty": torch.zeros(0, 4)}
    path = str(tmp_path / "ckpt")
    out = orbax_ckpt.write_tree(path, tree)
    assert out["leaf_bytes"] == 300 * 200 * 2 + 4 * 70 * 33 + 4 * 33 * 4 + 5 * 8 + 2 + 4
    want = {"w": np.asarray(tree["w"].view(torch.int16).numpy().view(np.uint16)),
            "layers.q": tree["layers"]["q"].numpy(), "layers.s": tree["layers"]["s"].numpy(),
            "seq.1": tree["seq"][1], "seq.2.flag": tree["seq"][2]["flag"],
            "count": tree["count"], "empty": np.zeros((0, 4), np.float32)}
    restored = _jax_leaves(ocp.StandardCheckpointer().restore(path))
    restored["w"] = restored["w"].view(np.uint16)
    assert restored.keys() == want.keys()
    for k, a in want.items():
        # JAX restores int64 as int32 unless x64 is on.
        assert restored[k].dtype == jax.dtypes.canonicalize_dtype(a.dtype), k
        assert np.array_equal(restored[k], a), k
    back = _port_leaves(orbax_ckpt.read_tree(path))
    assert isinstance(back["w"], BFloat16Bits)
    for k, a in want.items():
        assert np.array_equal(back[k].view(np.ndarray), a), k
    # Tensorstore's OCDBT driver lists the same keys, with the same values.
    mine = ocdbt.Store(path)
    kv = ts.KvStore.open({"driver": "ocdbt", "base": "file://" + path}).result()
    keys = kv.list().result()
    assert sorted(keys) == list(mine.entries)
    for k in keys:
        assert kv.read(k).result().value == mine.read(k), k
    assert ocdbt.Store(os.path.join(path, "ocdbt.process_0")).entries.keys() == \
        mine.entries.keys()


def _crafted_store(tmp_path, where: str, rel: str) -> str:
    """A one-key store under ``tmp_path/ckpt`` whose value (``where``
    "value") or root node ("node") is at data file path ``rel``; the other
    lies inside. Beside the checkpoint: ``secret`` and a copy of the node."""
    root = tmp_path / "ckpt"
    (root / "d").mkdir(parents=True)
    (tmp_path / "secret").write_bytes(b"secret bytes")
    (root / "d" / "value").write_bytes(b"inside bytes")
    (root / "link").symlink_to(tmp_path)
    value = ocdbt.DataFileId("", rel if where == "value" else "d/value")
    leaf = ocdbt._leaf_node([(b"w/0", ocdbt.IndirectRef(value, 0, 12))], [value])
    for p in (root / "d" / "leaf", tmp_path / "leaf"):
        p.write_bytes(leaf)
    node = ocdbt.DataFileId("", rel if where == "node" else "d/leaf")
    (root / ocdbt.MANIFEST).write_bytes(ocdbt._manifest(
        bytes(16), [node], ocdbt.IndirectRef(node, 0, len(leaf)), 1, len(leaf), 12))
    return str(root)


@pytest.mark.parametrize("where,rel", [
    ("value", "../secret"), ("value", "/secret"), ("value", "d/../../secret"),
    ("value", "link/secret"), ("node", "../leaf"), ("node", "link/leaf")])
def test_store_refuses_data_files_outside_the_checkpoint(tmp_path, where, rel):
    if rel == "/secret":
        rel = str(tmp_path / "secret")
    with pytest.raises(ocdbt.FormatError,
                       match="is not a relative path inside|leaves the checkpoint"):
        ocdbt.Store(_crafted_store(tmp_path, where, rel)).read(b"w/0")
    # The same store with the path inside reads.
    ok = tmp_path / "ok"
    ok.mkdir()
    assert ocdbt.Store(_crafted_store(ok, "value", "d/value")).read(b"w/0") == b"inside bytes"


def test_write_store_holds_one_value_at_a_time(tmp_path):
    """Each value is written, and its memory free, before the next pair is
    drawn: write_tree's leaves are never on the host together."""
    refs = []

    def items():
        for i in range(3):
            assert all(r() is None for r in refs), f"a value before {i} is still held"
            a = np.full(1 << 16, i, np.uint8)
            refs.append(weakref.ref(a))
            yield f"k{i}", [a[:1 << 15], a[1 << 15:]]
            del a
        yield "small", b"abc"

    root = str(tmp_path / "store")
    ocdbt.write_store(root, items())
    store = ocdbt.Store(root)
    assert list(store.entries) == [b"k0", b"k1", b"k2", b"small"]
    for i in range(3):
        assert store.read(f"k{i}".encode()) == bytes([i]) * (1 << 16)
    assert store.read(b"small") == b"abc"


def test_write_tree_copies_one_leaf_to_the_host_at_a_time(tmp_path, monkeypatch):
    """Each leaf's host copy is written and freed before the next leaf is
    copied (a device leaf's copy is its own; here each CPU leaf gets one)."""
    live, real = [], orbax_ckpt._host_array

    def host_array(value):
        assert all(r() is None for r in live), "an earlier leaf's host copy is still held"
        arr, dtype = real(value)
        arr = arr.copy()
        live.append(weakref.ref(arr))
        return arr, dtype

    monkeypatch.setattr(orbax_ckpt, "_host_array", host_array)
    g = torch.Generator().manual_seed(6)
    tree = {"a": torch.randn(64, 64, generator=g), "b": {"c": torch.randn(128, 32, generator=g),
                                                        "d": torch.ones(3)},
            "e": torch.randn(50, 50, generator=g).to(torch.bfloat16)}
    path = str(tmp_path / "ckpt")
    orbax_ckpt.write_tree(path, tree)
    assert len(live) == 4
    back = _port_leaves(orbax_ckpt.read_tree(path))
    for name, t in (("a", tree["a"]), ("b.c", tree["b"]["c"]), ("b.d", tree["b"]["d"]),
                    ("e", tree["e"])):
        assert torch.equal(convert.tensor_from_numpy(back[name]), t), name


def _port_state(family: str, init, lr=1e-2):
    opt = tts.make_optimizer(learning_rate=lr, warmup_steps=1, total_steps=10)
    params = convert.params_from_numpy(jax.tree.map(np.copy, init), "cpu")
    state = tts.TrainState(params=params, opt_state=opt.init(params), step=0)
    if family == "llama":
        return tl.llama_tiny(), state, tts.make_train_step(tl.llama_tiny(), opt)
    return tm.moe_tiny(), state, tts.make_moe_train_step(tm.moe_tiny(), opt)


def _loss(out) -> float:
    return float(out["loss"] if isinstance(out, dict) else out)


@pytest.mark.parametrize("family", ["llama", "moe"])
def test_jax_trainer_resumes_from_a_port_written_step(tmp_path, family):
    mesh, jstate = _jax_train_state(family, mesh8=False, steps=0)
    init = jax.tree.map(np.asarray, jstate.params)
    cfg, state, step = _port_state(family, init)
    state, _ = step(state, *map(torch.from_numpy, _batch(0, 2, 32, cfg.vocab_size)))
    root = str(tmp_path / "ckpts")
    tckpt.save_checkpoint(root, state)
    saved = {k: t.detach().clone() for k, t in tckpt._named_leaves(state.params)}
    batch = _batch(1, 2, 32, cfg.vocab_size)
    _, port_out = step(state, *map(torch.from_numpy, batch))
    port_loss = _loss(port_out)

    assert jckpt.latest_step(root) == 1
    with set_mesh(mesh):
        # The JAX run's own state is the template; the restore overwrites it.
        restored = jckpt.restore_checkpoint(root, jstate)
        assert int(restored.step) == 1
        assert int(restored.opt_state[1][0].count) == int(restored.opt_state[1][2].count) == 1
        jparams = _jax_leaves(restored.params)
        for keys, t in saved.items():
            assert np.array_equal(jparams[".".join(keys)], t.numpy()), keys
        opt = jts.make_optimizer(learning_rate=1e-2, warmup_steps=1, total_steps=10)
        make = jts.make_train_step if family == "llama" else jts.make_moe_train_step
        step_fn, _ = make(jl.llama_tiny() if family == "llama" else jm.moe_tiny(), mesh, opt)
        _, jout = step_fn(restored, *map(jnp.asarray, batch))
    jloss = _loss(jout)
    assert abs(jloss - port_loss) <= 1e-5 * abs(jloss), (jloss, port_loss)


# --- crash safety, the old format, and no foreign imports ---------------------------

@pytest.fixture
def port_faults():
    os.environ.pop(tfaults.ENV, None)
    tfaults.reset()
    yield tfaults
    os.environ.pop(tfaults.ENV, None)
    tfaults.reset()


@pytest.mark.faults
def test_killed_save_leaves_the_previous_step_newest(tmp_path, port_faults):
    root = str(tmp_path / "ckpts")
    state, _ = tts.create_moe_train_state(tm.moe_tiny(), torch.Generator().manual_seed(1),
                                          "cpu")
    tckpt.save_checkpoint(root, state)
    want = [t.clone() for t in tts.tree_leaves(state.params)]
    state.step = 1
    os.environ[port_faults.ENV] = "checkpoint.save:1:1"
    with pytest.raises(port_faults.FaultInjected):
        tckpt.save_checkpoint(root, state)
    assert sorted(os.listdir(root)) == ["step_00000000"]
    assert tckpt.latest_step(root) == jckpt.latest_step(root) == 0
    fresh, _ = tts.create_moe_train_state(tm.moe_tiny(), torch.Generator().manual_seed(2),
                                          "cpu")
    back = tckpt.restore_checkpoint(root, fresh)
    assert back.step == 0
    for a, b in zip(tts.tree_leaves(back.params), want):
        assert torch.equal(a, b)


def test_a_step_saved_as_state_pt_is_still_read(tmp_path):
    state, _ = tts.create_train_state(tl.llama_tiny(), torch.Generator().manual_seed(5), "cpu")
    state.step, state.opt_state["count"] = 7, 7
    step_dir = tmp_path / "ckpts" / "step_00000007"
    step_dir.mkdir(parents=True)
    torch.save({"params": state.params, "opt_state": state.opt_state, "step": 7},
               str(step_dir / "state.pt"))
    fresh, _ = tts.create_train_state(tl.llama_tiny(), torch.Generator().manual_seed(6), "cpu")
    back = tckpt.restore_checkpoint(str(tmp_path / "ckpts"), fresh)
    assert back.step == 7 and back.opt_state["count"] == 7
    for a, b in zip(tts.tree_leaves(back.params), tts.tree_leaves(state.params)):
        assert torch.equal(a, b)


def test_readers_need_no_jax_orbax_tensorstore_zstandard_or_ml_dtypes(tmp_path):
    """In a process where none of those (nor safetensors or the JAX
    package) can be imported: read the fixture to its hashes, boot a
    decoder cell from it and an embedding cell from a port-written bge
    tree, and save and restore a trainer step."""
    code = r"""
import hashlib, json, sys
BLOCKED = ("jax", "orbax", "tensorstore", "zstandard", "safetensors", "ml_dtypes",
           "kukeon_tpu")
for m in BLOCKED:
    sys.modules[m] = None
import torch
torch.set_num_threads(2)
from kukeon_tpu_torch.models import bert, orbax_ckpt
from kukeon_tpu_torch.runtime.serving_cell import EmbeddingCell, ServingCell
from kukeon_tpu_torch.training import checkpointing, train_step
fixture, tmp = sys.argv[1], sys.argv[2]
tree = orbax_ckpt.read_tree(fixture)
flat = {}
def walk(t, p=""):
    for k, v in t.items():
        walk(v, f"{p}{k}.") if isinstance(v, dict) else flat.__setitem__(p + k, v)
walk(tree)
want = json.load(open(fixture + ".json"))
assert {k: hashlib.sha256(v.tobytes()).hexdigest() for k, v in flat.items()} == \
    {k: v["sha256"] for k, v in want.items()}
out = ServingCell("tiny", num_slots=2, max_seq_len=64, checkpoint=fixture, dtype="int8",
                  device="cpu").generate({"promptTokens": [1, 2, 3], "maxNewTokens": 4})
assert out["numTokens"] == 4, out
orbax_ckpt.write_tree(tmp + "/bge", bert.init_params(bert.bge_tiny(),
                                                     torch.Generator().manual_seed(0), "cpu"))
emb = EmbeddingCell("bge-tiny", checkpoint=tmp + "/bge", device="cpu").embed(
    {"inputTokens": [[1, 2, 3]]})
assert len(emb["embeddings"][0]) == 64
state, _ = train_step.create_train_state(__import__("kukeon_tpu_torch.models.llama",
    fromlist=["x"]).llama_tiny(), torch.Generator().manual_seed(0), "cpu")
checkpointing.save_checkpoint(tmp + "/ck", state)
checkpointing.restore_checkpoint(tmp + "/ck", state)
leaked = sorted(m for m in sys.modules
                if m.split(".")[0] in BLOCKED and sys.modules[m] is not None)
assert not leaked, leaked
print("ok")
"""
    proc = subprocess.run([sys.executable, "-c", code, FIXTURE, str(tmp_path)],
                          capture_output=True, text=True, timeout=120, cwd=ROOT,
                          env={**os.environ, "OMP_NUM_THREADS": "2"})
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.strip().endswith("ok")
