"""The port's mesh and sharding modules (``kukeon_tpu_torch/parallel``)
against the JAX package's ``kukeon_tpu/parallel``, on the CPU: the layout
heuristics equal for every count, the grant's loud failures, the spec
tuples equal to the reference's ``PartitionSpec``s leaf by leaf, and every
leaf of ``llama_tiny`` (f32 and int8, tied and untied) cut into shards
whose concatenation on the spec's axis is the leaf, bit for bit."""

import dataclasses
import functools
import os
import time

import jax
import numpy as np
import pytest
import torch

from kukeon_tpu.models import llama as jl
from kukeon_tpu.parallel import mesh as jmesh
from kukeon_tpu.parallel import sharding as jshd
from kukeon_tpu_torch.models import convert
from kukeon_tpu_torch.models import llama as tl
from kukeon_tpu_torch.parallel import launch, mesh as tmesh, sharding as tshd

torch.set_num_threads(2)


def test_auto_mesh_shape_equals_reference():
    for n in range(1, 17):
        assert tmesh.auto_mesh_shape(n) == jmesh.auto_mesh_shape(n), n
    for n in range(0, 40):
        assert tmesh.largest_pow2_leq(n) == jmesh.largest_pow2_leq(n), n
    with pytest.raises(ValueError, match=">= 1 device"):
        tmesh.auto_mesh_shape(0)


def test_serving_mesh_loud_failures():
    """A grant below 1 or above what the host shows (on the CPU, the
    reference's forced host count of 8) fails before any rank starts (no
    group is opened)."""
    before = launch.current()
    with pytest.raises(ValueError, match=">= 1 device"):
        tmesh.serving_mesh(0, "cpu")
    with pytest.raises(ValueError, match="wants 9 CPU ranks but only 8 visible"):
        tmesh.serving_mesh(9, "cpu")
    with pytest.raises(ValueError, match="wants 9 CPU ranks but only 8 visible"):
        tmesh.check_grant(9, "cpu")
    if not torch.cuda.is_available():
        with pytest.raises(ValueError, match="GPUs but only 0 visible"):
            tmesh.serving_mesh(1, "cuda")
    assert launch.current() is before
    assert tmesh.check_grant(8, "cpu") == 8 == tmesh.CPU_RANKS


@pytest.mark.parametrize("visible", [1, 2, 4, 8, 9, 12])
def test_a_cell_without_chips_takes_every_visible_gpu(monkeypatch, visible):
    """No ``--chips``: a cell's group (Llama, Mixtral or the embedding
    cell alike) is every visible GPU when that is more than one (none, the
    one-device code, at one), laid out as the reference lays it out
    (``auto_mesh_shape``: a data axis at 9 and 12, where this once
    exited). ``--chips N`` is a group of N, all on tensor; one above what
    the host shows exits."""
    from kukeon_tpu_torch.runtime import serving_cell as sc

    monkeypatch.setattr(torch.cuda, "device_count", lambda: visible)
    for model in ("llama3-8b", "mixtral-8x7b", "bge-base"):
        want = jmesh.auto_mesh_shape(visible)
        assert sc.grant(None, "cuda") == want
        assert sc.cell_world(model, None, "cuda") == (want if visible > 1 else None)
        assert sc.cell_world(model, 1, "cuda") == {"data": 1, "tensor": 1}
        if visible >= 2:
            assert sc.cell_world(model, 2, "cuda") == {"data": 1, "tensor": 2}
        with pytest.raises(SystemExit, match=f"--chips {visible + 1}: serving mesh wants"):
            sc.cell_world(model, visible + 1, "cuda")
    assert sc.grant(None, "cpu") == {"data": 1, "tensor": 1}
    assert sc.cell_world("tiny", None, "cpu") is None


def test_followers_start_without_the_fault_table(monkeypatch):
    """Fault points fire on the leader alone: a follower's environment
    drops ``KUKEON_FAULTS`` and keeps the rest."""
    from kukeon_tpu_torch import faults

    monkeypatch.setenv(faults.ENV, "engine.upload:1")
    monkeypatch.setenv("KUKEON_SOMETHING_ELSE", "1")
    env = launch.follower_env(b"\x01\x02")
    assert faults.ENV not in env and env["KUKEON_SOMETHING_ELSE"] == "1"
    assert env[launch._AUTHKEY_ENV] == "0102"


def _pspec(p) -> tuple:
    return tuple(p)


@pytest.mark.parametrize("fsdp", [False, True])
def test_param_specs_equal_reference(fsdp):
    ours = tshd.llama_param_specs(fsdp)
    ref = jshd.llama_param_specs(fsdp)
    assert set(ours) == set(ref)
    for key in ref:
        if key == "layers":
            assert set(ours[key]) == set(ref[key])
            for name, spec in ref[key].items():
                assert ours[key][name] == _pspec(spec), (key, name)
        else:
            assert ours[key] == _pspec(ref[key]), key
    params = {"embed": 0, "layers": 0, "final_norm": 0}
    assert set(tshd.specs_for_params(params, fsdp)) == set(jshd.specs_for_params(params, fsdp))
    assert tshd.kv_cache_spec() == _pspec(jshd.kv_cache_spec())
    assert tshd.kv_cache_spec(True) == _pspec(jshd.kv_cache_spec(True))


@pytest.mark.parametrize("case", ["experts", "stacked", "embed", "lm_head"])
def test_quant_scale_spec_equals_reference(case):
    from jax.sharding import PartitionSpec as P

    spec, q, s = {
        "experts": (("a", "b", "c", "d"), np.zeros((2, 4, 8, 16)), np.zeros((2, 4, 16))),
        "stacked": ((None, "fsdp", "tensor"), np.zeros((2, 8, 16)), np.zeros((2, 16))),
        "embed": (("tensor", None), np.zeros((32, 8)), np.zeros((32,))),
        "lm_head": ((None, "tensor"), np.zeros((8, 32)), np.zeros((32,))),
    }[case]
    assert tshd._quant_scale_spec(spec, q, s) == _pspec(jshd._quant_scale_spec(P(*spec), q, s))


@functools.lru_cache(maxsize=None)
def _trees(tied: bool):
    cfg = dataclasses.replace(jl.llama_tiny(), tie_embeddings=tied)
    jp = jl.init_params(jax.random.key(0), cfg)
    return {"f32": jax.tree.map(np.asarray, jp),
            "int8": jax.tree.map(np.asarray, jl.quantize_params(jp))}


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (k,))
    else:
        yield path, tree


@pytest.mark.parametrize("tied", [True, False])
@pytest.mark.parametrize("dtype", ["f32", "int8"])
@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("kind", ["numpy", "torch"])
def test_shards_concatenate_to_the_leaf(tied, dtype, world, kind):
    """Every leaf's ``world`` shards, concatenated on the axis its spec
    puts on ``tensor``, give the leaf bit for bit (numpy and torch leaves
    alike), followed by zeros where whole heads leave trailing ranks a
    padded block (tiny's 2 kv heads at 4); a leaf with no ``tensor`` axis
    is the same on every rank; a torch shard is contiguous (the kernels
    want it)."""
    full = _trees(tied)[dtype]
    if kind == "torch":
        full = convert.params_from_numpy(full, "cpu")
    specs = dict(_leaves(tshd.param_specs(full)))
    head_dim = jl.llama_tiny().head_dim
    shards = [dict(_leaves(tshd.shard_tree(full, r, world, head_dim=head_dim)))
              for r in range(world)]
    for path, leaf in _leaves(full):
        spec = specs[path]
        parts = [s[path] for s in shards]
        if "tensor" in spec:
            axis, n = spec.index("tensor"), leaf.shape[spec.index("tensor")]
            assert all(p.shape == parts[0].shape for p in parts), path
            padded = parts[0].shape[axis] * world != n
            assert not padded or path[1] in ("wk", "wv") and world == 4, path
            joined = (torch.cat(parts, axis) if kind == "torch"
                      else np.concatenate(parts, axis))
            rest = np.asarray(joined).take(range(n, joined.shape[axis]), axis)
            assert not rest.any(), path
            joined = joined[(slice(None),) * axis + (slice(0, n),)]
            if kind == "torch":
                joined = joined.contiguous()
        else:
            assert all(p is leaf for p in parts), path
            joined = parts[0]
        if kind == "torch":
            assert all(p.is_contiguous() for p in parts), path
            assert torch.equal(_bits(joined), _bits(leaf)), path
        else:
            assert joined.dtype == leaf.dtype and joined.tobytes() == leaf.tobytes(), path
    if not tied and dtype == "int8":
        assert specs[("lm_head", "s")] == ("tensor",)


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.view({torch.float32: torch.int32, torch.bfloat16: torch.int16}.get(t.dtype, t.dtype))


def test_kv_shard_off_replicates_wk_wv():
    full = _trees(True)["int8"]
    specs = dict(_leaves(tshd.param_specs(full, kv_shard=False)))
    for name in ("wk", "wv"):
        assert specs[("layers", name, "q")] == (None, None, None)
        shards = [tshd.shard_tree(full, r, 2, kv_shard=False,
                                  head_dim=jl.llama_tiny().head_dim) for r in range(2)]
        for s in shards:
            np.testing.assert_array_equal(s["layers"][name]["q"], full["layers"][name]["q"])
    assert specs[("layers", "wq", "q")] == (None, None, "tensor")


def test_tensor_parallel_refusals_name_a13b():
    """What the reference's shardings cannot cut is refused, saying so;
    heads a tensor size does not divide, and q-head blocks that straddle a
    replicated cache's kv groups, are served (they once exited naming
    A13b2b)."""
    cfg = tl.llama_tiny()                      # 4 heads, 2 kv heads, d 32, I 256, V 512
    assert tshd.check_tensor_parallel(cfg, 2) is True
    assert tshd.check_tensor_parallel(cfg, 2, kv_shard=False) is False
    assert tshd.check_tensor_parallel(cfg, 4) is False          # 2 kv heads, 4 ranks
    assert tshd.check_tensor_parallel(cfg, 8) is False          # half a head a device there
    with pytest.raises(SystemExit, match="num_heads\\*head_dim 128 is not a multiple of 3.*"
                                         "reference's shardings cannot cut it"):
        tshd.check_tensor_parallel(cfg, 3)
    odd = dataclasses.replace(cfg, num_heads=12, num_kv_heads=6, intermediate_size=256)
    assert tshd.check_tensor_parallel(odd, 4) is False          # straddling groups
    with pytest.raises(SystemExit, match="intermediate_size 256 is not a multiple of 6"):
        tshd.check_tensor_parallel(dataclasses.replace(odd, num_heads=6, num_kv_heads=6), 6)
    with pytest.raises(SystemExit, match="num_kv_heads\\*head_dim 96 is not a multiple of 64"):
        tshd.check_tensor_parallel(dataclasses.replace(odd, num_kv_heads=3,
                                                       intermediate_size=1024), 64)


@pytest.mark.parametrize("tied", [True, False])
def test_pad_vocab_pads_the_int8_head_to_the_kernel_tile(tied):
    """A rank's int8 head shard of 320 entries is padded to 384 (zeros,
    scales of one) on the axis the kernel tiles, and only there; a
    multiple of 128, a padded tree or a full-precision head is left as it
    is."""
    cfg = dataclasses.replace(tl.llama_tiny(), vocab_size=640, tie_embeddings=tied)
    full = tl.quantize_params(tl.init_params(cfg, torch.Generator().manual_seed(0), "cpu"))
    local = tshd.shard_tree(full, 1, 2, head_dim=cfg.head_dim)
    key, axis = ("embed", 0) if tied else ("lm_head", 1)
    padded = tshd.pad_vocab(local, 320)
    q, s = padded[key]["q"], padded[key]["s"]
    assert q.shape[axis] == 384 and s.shape == (384,)
    assert torch.equal(q.narrow(axis, 0, 320), local[key]["q"])
    assert not q.narrow(axis, 320, 64).any() and torch.equal(s[320:], torch.ones(64))
    assert torch.equal(s[:320], local[key]["s"])
    other = "lm_head" if tied else "embed"
    if other in local:
        assert padded[other] is local[other]
    assert tshd.pad_vocab(padded, 320) is padded
    wide = dataclasses.replace(cfg, vocab_size=512)
    tiled = tshd.shard_tree(tl.quantize_params(
        tl.init_params(wide, torch.Generator().manual_seed(0), "cpu")), 0, 2,
        head_dim=cfg.head_dim)
    assert tshd.pad_vocab(tiled, 256) is tiled
    plain = tshd.shard_tree(tl.init_params(cfg, torch.Generator().manual_seed(0), "cpu"), 0, 2,
                            head_dim=cfg.head_dim)
    assert tshd.pad_vocab(plain, 320) is plain


def test_hbm_collector_carries_the_followers_counters():
    """A leader's scrape holds every rank's kukeon_hbm_bytes_*{device=}:
    the followers' allocator counters as they reported them (no CUDA call
    at scrape time); a CPU leader adds none of its own."""
    from kukeon_tpu_torch.obs.device import device_memory_collector

    peers = [{"index": 1, "in_use": 5.0, "limit": 80.0, "peak": 7.0},
             {"index": 2, "in_use": 6.0, "limit": 80.0, "peak": 9.0}, {}]
    fams = {name: samples for name, _kind, _help, samples
            in device_memory_collector("cpu", peers=lambda: peers)()}
    assert fams["kukeon_hbm_bytes_in_use"] == [({"device": "1"}, 5.0), ({"device": "2"}, 6.0)]
    assert fams["kukeon_hbm_bytes_peak"] == [({"device": "1"}, 7.0), ({"device": "2"}, 9.0)]
    assert fams["kukeon_hbm_bytes_limit"] == [({"device": "1"}, 80.0), ({"device": "2"}, 80.0)]
    assert all(v == [] for v in {n: s for n, _k, _h, s in device_memory_collector("cpu")()}
               .values())


def test_a_leader_action_failing_after_its_flush_aborts_the_group(tmp_path):
    """A device action the leader sent (flushed) and then failed to run
    ends the group at once: the followers, who may wait in its collective,
    are killed, ``on_failure`` hears why, and the next post raises. One
    that fails before any flush only raises."""
    import subprocess
    import sys
    import types

    from kukeon_tpu_torch.serving.engine import ServingEngine

    proc = subprocess.Popen([sys.executable, "-c", "import time; time.sleep(60)"])
    try:
        group = launch.Group(0, 2, "cpu", str(tmp_path), [], [proc])
        heard = []
        group.on_failure = heard.append
        sent = []
        group.post = lambda oid, action, args, flush=False: sent.append((action, flush))

        def boom(*a):
            raise RuntimeError("capture failed")

        eng = types.SimpleNamespace(_group=group, _oid=1, mesh=None, _act_stage=boom,
                                    _act_run=boom)
        with pytest.raises(RuntimeError, match="capture failed"):
            ServingEngine._dev(eng, "stage", np.zeros(3))
        assert group.failed is None and proc.poll() is None
        with pytest.raises(RuntimeError, match="capture failed"):
            ServingEngine._dev(eng, "run", "decode", (4,), flush=True)
        assert sent == [("stage", False), ("run", True)]
        assert proc.wait(timeout=10) != 0
        assert group.failed == heard[0] == "rank 0 failed in run: RuntimeError: capture failed"
        with pytest.raises(launch.RankFailure, match="rank 0 failed in run"):
            launch.Group.post(group, 1, "noop")
    finally:
        proc.kill()
        proc.wait()


@pytest.mark.parametrize("watched", [False, True], ids=["no_channel", "channel_open"])
def test_a_leader_action_failing_after_its_follower_died_names_the_follower(tmp_path, watched):
    """The race of a follower's death (C10): its sockets reset, so the
    leader's collective raises before any watch thread has seen the
    follower go. Forced here: the follower is dead (killed, not reaped),
    and its control channel, when there is one, is still open, so the
    watch thread blocks in its read. The leader's action raises after its
    flush; the group records ``rank 1 exited (code -9)``, not the
    leader's own error, and ``on_failure`` hears the same."""
    import multiprocessing
    import subprocess
    import sys
    import types

    from kukeon_tpu_torch.serving.engine import ServingEngine

    proc = subprocess.Popen([sys.executable, "-c", "import time; time.sleep(60)"])
    ends = multiprocessing.Pipe() if watched else None
    try:
        proc.kill()
        while not os.path.exists(f"/proc/{proc.pid}") or open(
                f"/proc/{proc.pid}/stat").read().split()[2] != "Z":
            time.sleep(0.01)
        group = launch.Group(0, 2, "cpu", str(tmp_path), [ends[0]] if watched else [], [proc])
        heard = []
        group.on_failure = heard.append
        group.post = lambda oid, action, args, flush=False: None

        def boom(*a):
            raise RuntimeError("gloo: Connection reset by peer")

        eng = types.SimpleNamespace(_group=group, _oid=1, mesh=None, _act_run=boom)
        with pytest.raises(RuntimeError, match="reset by peer"):
            ServingEngine._dev(eng, "run", "decode", (4,), flush=True)
        assert group.failed == heard[0] == "rank 1 exited (code -9)"
        with pytest.raises(launch.RankFailure, match="rank 1 exited"):
            launch.Group.post(group, 1, "noop")
    finally:
        proc.kill()
        proc.wait()
        if ends is not None:
            for end in ends:
                end.close()


def test_a_followers_error_after_a_peer_died_names_the_dead_peer(tmp_path):
    """The race of C12: a follower whose collective raised because its
    peer was killed reports an error, and that report can reach the leader
    before the dead peer's channel closes. Forced here: rank 2 is dead
    (killed, not reaped) with its channel still open, so its watch thread
    blocks in its read, and rank 1 reports the error its collective
    raised. The group records ``rank 2 exited (code -9)``, not rank 1's
    error, and ``on_failure`` hears the same. A report with every other
    follower alive still names its sender, after ``ABORT_WAIT_S``."""
    import multiprocessing
    import pickle
    import subprocess
    import sys

    live = subprocess.Popen([sys.executable, "-c", "import time; time.sleep(60)"])
    dead = subprocess.Popen([sys.executable, "-c", "import time; time.sleep(60)"])
    pipes = [multiprocessing.Pipe(), multiprocessing.Pipe()]
    try:
        dead.kill()
        while open(f"/proc/{dead.pid}/stat").read().split()[2] != "Z":
            time.sleep(0.01)
        group = launch.Group(0, 3, "cpu", str(tmp_path), [p[0] for p in pipes], [live, dead])
        heard = []
        group.on_failure = heard.append
        pipes[0][1].send_bytes(pickle.dumps(("error", "RuntimeError: gloo: Connection "
                                                      "reset by peer")))
        deadline = time.monotonic() + 10
        while group.failed is None and time.monotonic() < deadline:
            time.sleep(0.01)
        assert group.failed == heard[0] == "rank 2 exited (code -9)"
        with pytest.raises(launch.RankFailure, match="rank 2 exited"):
            launch.Group.post(group, 1, "noop")
    finally:
        for p in (live, dead):
            p.kill()
            p.wait()
        for pair in pipes:
            for end in pair:
                end.close()

    live = subprocess.Popen([sys.executable, "-c", "import time; time.sleep(60)"])
    ends = multiprocessing.Pipe()
    try:
        group = launch.Group(0, 2, "cpu", str(tmp_path), [ends[0]], [live])
        t0 = time.monotonic()
        ends[1].send_bytes(pickle.dumps(("error", "ValueError: its own fault")))
        while group.failed is None and time.monotonic() < t0 + 10:
            time.sleep(0.01)
        assert group.failed == "rank 1 failed: ValueError: its own fault"
        assert time.monotonic() - t0 >= launch.ABORT_WAIT_S * 0.9
    finally:
        live.kill()
        live.wait()
        for end in ends:
            end.close()


class _Rank:
    """A rank's view (``rank``, ``world``, ``device``) for ``local_params``."""

    def __init__(self, rank, world):
        self.rank, self.world, self.device = rank, world, torch.device("cpu")


@pytest.mark.parametrize("quantize", [False, True])
@pytest.mark.parametrize("tied", [True, False])
def test_local_params_cuts_each_leaf_as_it_is_drawn(quantize, tied):
    """The cell's weight recipe at t = 2: each rank's tree from
    ``local_params`` is its ``shard_tree`` of the one-device cell's tree
    (the same draws, bit for bit, its int8 head padded), and every full
    leaf that is cut is freed before the next leaf is drawn, so a rank
    never holds the model, only its slice and one full leaf."""
    import weakref

    from kukeon_tpu_torch.parallel.sharding import Recipe, local_params
    from kukeon_tpu_torch.runtime import serving_cell as sc

    cfg = dataclasses.replace(tl.llama_tiny(), vocab_size=640, tie_embeddings=tied)
    model = "tied" if tied else "untied"
    dtype = "int8" if quantize else None
    refs: dict = {}
    alive_at_draw = []

    def counted(**kw):
        for path, leaf in sc.rank_leaves(**kw):
            alive_at_draw.append((path, {p for p, r in refs.items() if r() is not None}))
            refs[path] = weakref.ref(leaf)
            yield path, leaf
            del leaf

    monkeypatch = pytest.MonkeyPatch()
    monkeypatch.setitem(sc.MODELS, model, lambda: cfg)
    monkeypatch.setattr(sc, "counted", counted, raising=False)
    try:
        gen = torch.Generator(device="cpu").manual_seed(5)
        whole = sc._drawn_params(cfg, quantize, gen)
        recipe = Recipe("kukeon_tpu_torch.runtime.serving_cell:counted",
                        {"model": model, "dtype": dtype, "checkpoint": None, "seed": 5,
                         "max_seq_len": None})
        for rank in range(2):
            refs.clear()
            alive_at_draw.clear()
            got = dict(_leaves(local_params(recipe, cfg, _Rank(rank, 2))))
            want = tshd.pad_vocab(tshd.shard_tree(whole, rank, 2, head_dim=cfg.head_dim),
                                   cfg.vocab_size // 2)
            assert got.keys() == dict(_leaves(want)).keys()
            for path, leaf in _leaves(want):
                assert torch.equal(_bits(got[path]), _bits(leaf)), path
            # Leaves the rank keeps whole (the norms) may live on; of the
            # cut ones, only the other half of the drawn leaf's {q, s}.
            kept = {p for p, r in refs.items() if r() is not None and r() is got[p]}
            assert 0 < len(kept) < len(refs)
            for path, alive in alive_at_draw:
                assert all(p in kept or p[:-1] == path[:-1] != () for p in alive), (path, alive)
    finally:
        monkeypatch.undo()


def test_checkpoint_cfg_is_the_loaders(tmp_path):
    """A tensor-parallel cell checks its grant against the config read from
    the checkpoint's manifest or config.json alone: the config the loader
    gives, for the kukeon int8, the HF and the orbax formats."""
    import os

    from kukeon_tpu_torch.models import checkpoints
    from kukeon_tpu_torch.runtime.serving_cell import ServingCell

    cfg = tl.llama_tiny()
    params = tl.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    checkpoints.save_quantized(str(tmp_path / "q"), tl.quantize_params(params), cfg)
    checkpoints.synthesize_hf_checkpoint(str(tmp_path / "hf"), cfg, seed=0)
    orbax = os.path.join(os.path.dirname(__file__), "data", "orbax_llama_tiny")
    for path in (str(tmp_path / "q"), str(tmp_path / "hf"), orbax):
        src, want = ServingCell._load_checkpoint(path, cfg)
        if hasattr(src, "close"):
            src.close()
        assert ServingCell._checkpoint_cfg(path, cfg) == want, path
