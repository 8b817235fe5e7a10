"""A tensor-parallel rank reads only its blocks of a checkpoint, and a Llama
cell at ``chips=2`` boots streamed: for every family and format a rank
reads (Llama ``tiny``: kukeon int8, HF in bf16 and int8, the orbax fixture
and a many-chunk copy of it; ``mixtral-tiny`` HF in bf16 and int8;
``bge-tiny`` orbax, one chunk and many) each rank's blocks at world 2 and
4 equal ``sharding.shard_tree`` of the one-device load bit for bit, ``q``
and ``s`` alike, padding included; ``local_meta`` has ``local_params``'
shapes; a rank's reader holds its slice and one staging block, never a
full leaf; a two-rank streamed cell from a kukeon int8 and from an HF
directory gives the tokens of the JAX engine on ``serving_mesh(2)``
booted from the JAX package's stream of the same directory, and of the
port's one-device streamed cell, on the legacy and the paged layout; and
a follower whose read fails ends the group, the leader's error naming it.
The cells share one two-rank gloo group (started by the first); its
collectives and rendezvous time out after ``GROUP_TIMEOUT_S``.
"""

import dataclasses
import json
import os
import types

import jax
import numpy as np
import pytest
import torch
from test_torch_checkpoints import _write_mixtral_hf

from kukeon_tpu.models import checkpoints as jck
from kukeon_tpu.models import hf_convert as jhf
from kukeon_tpu.models import moe as jm
from kukeon_tpu.parallel import serving_mesh as jax_serving_mesh
from kukeon_tpu.serving import SamplingParams as JaxSampling
from kukeon_tpu.serving import ServingEngine as JaxEngine
from kukeon_tpu_torch.models import bert as tb
from kukeon_tpu_torch.models import checkpoints as tck
from kukeon_tpu_torch.models import convert
from kukeon_tpu_torch.models import hf_convert as thf
from kukeon_tpu_torch.models import llama as tl
from kukeon_tpu_torch.models import moe as tm
from kukeon_tpu_torch.models import orbax_ckpt, zstd
from kukeon_tpu_torch.models.checkpoints import _walk_tree
from kukeon_tpu_torch.parallel import launch
from kukeon_tpu_torch.parallel import sharding as tshd
from kukeon_tpu_torch.parallel.sharding import Recipe
from kukeon_tpu_torch.runtime import serving_cell
from kukeon_tpu_torch.runtime.serving_cell import ServingCell

torch.set_num_threads(2)

GROUP_TIMEOUT_S = "60"
STAGE = 4096          # a rank reader's staging block here (bytes)
FIXTURE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data", "orbax_llama_tiny")
PROMPTS = [np.arange(1, 9, dtype=np.int32),
           np.array([5, 300, 7, 411, 9, 13, 40, 41, 42, 43, 44, 45, 46, 47], np.int32)]


@pytest.fixture(scope="module", autouse=True)
def _group_timeout():
    """The cells' group times out after GROUP_TIMEOUT_S; closed at the end."""
    mp = pytest.MonkeyPatch()
    mp.setenv(launch.TIMEOUT_ENV, GROUP_TIMEOUT_S)
    yield
    launch.shutdown()
    mp.undo()


def _rechunk(src: str, dst: str) -> str:
    """``src`` rewritten without OCDBT (each zarr key a file), every array
    of two or more dims in chunks of about a third of each axis, so a
    rank's region spans some chunks and misses others."""
    ck = orbax_ckpt.OrbaxCheckpoint(src)
    os.makedirs(dst)
    with open(os.path.join(src, orbax_ckpt.METADATA)) as f:
        meta = json.load(f)
    meta["use_ocdbt"] = False
    with open(os.path.join(dst, orbax_ckpt.METADATA), "w") as f:
        json.dump(meta, f)
    for name in ck.array_names():
        z = ck.zarray(name)
        a = np.asarray(ck.read_array(name).view(np.ndarray))
        chunks = [max(1, -(-d // 3)) if a.ndim > 1 else d for d in a.shape]
        z["chunks"] = chunks
        os.makedirs(os.path.join(dst, name))
        with open(os.path.join(dst, name, ".zarray"), "w") as f:
            json.dump(z, f)
        grid = [-(-d // c) for d, c in zip(a.shape, chunks)]
        for idx in np.ndindex(*grid):
            block = np.zeros(chunks, a.dtype)
            part = a[tuple(slice(i * c, (i + 1) * c) for i, c in zip(idx, chunks))]
            block[tuple(slice(0, n) for n in part.shape)] = part
            with open(os.path.join(dst, name, ".".join(map(str, idx))), "wb") as f:
                f.write(zstd.compress_stored(block.reshape(-1).view(np.uint8)))
    out = orbax_ckpt.OrbaxCheckpoint(dst)
    assert not any(out.one_chunk(n) for n in out.array_names() if len(out.zarray(n)["shape"]) > 1)
    return dst


@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
    """The checkpoints, one of each family and format."""
    tmp = tmp_path_factory.mktemp("ckpts")
    cfg = tl.llama_tiny()
    out = {"orbax": FIXTURE}
    out["quant"] = tck.save_quantized(str(tmp / "quant"), convert.params_from_numpy(
        tl.init_quantized_params_host(cfg, seed=4), "cpu"), cfg)
    out["hf"] = tck.synthesize_hf_checkpoint(str(tmp / "hf"), cfg, seed=5, dtype=torch.float16,
                                             max_shard_bytes=300_000, tokenizer=False)
    out["orbax_chunked"] = _rechunk(FIXTURE, str(tmp / "orbax_chunked"))
    mcfg = tm.moe_tiny()
    out["mixtral"] = str(tmp / "mixtral")
    _write_mixtral_hf(out["mixtral"], jm.init_params(jax.random.key(2), jm.moe_tiny()), mcfg,
                      np.float32)
    bcfg = tb.bge_tiny()
    gen = torch.Generator().manual_seed(6)
    out["bge"] = str(tmp / "bge")
    orbax_ckpt.write_tree(out["bge"], tb.init_params(bcfg, gen, "cpu"))
    out["bge_chunked"] = _rechunk(out["bge"], str(tmp / "bge_chunked"))
    return out


# --- each rank's blocks against the cut of the one-device load -------------------------

def _llama_one_device(dirs, case):
    f32 = torch.float32
    meta = tl.init_params(tl.llama_tiny(), None, "meta")
    if case == "kukeon_int8":
        return tck.load_quantized(dirs["quant"], f32)[0]
    if case == "hf_bf16":
        return thf.load_params(dirs["hf"], dtype=torch.bfloat16)[0]
    if case == "hf_int8":
        return thf.load_params_quantized(dirs["hf"], dtype=f32)[0]
    src = dirs["orbax_chunked" if "chunked" in case else "orbax"]
    tree = orbax_ckpt.load_params(src, meta, f32, "cpu")[0]
    return tl.quantize_params(tree) if case.endswith("int8") else tree


LLAMA_CASES = {
    # case: (the cell's dtype, its checkpoint, a stream or slices)
    "kukeon_int8": (None, "quant", "stream"),
    "hf_bf16": ("bfloat16", "hf", "stream"),
    "hf_int8": ("int8", "hf", "stream"),
    "orbax_f32": (None, "orbax", "slices"),
    "orbax_int8": ("int8", "orbax", "slices"),
    "orbax_chunked_int8": ("int8", "orbax_chunked", "slices"),
}


def _rank_blocks(dirs, family, case, rank, world, kv):
    """Rank ``rank``'s leaves through the cells' own recipes."""
    where = dict(rank=rank, world=world, kv_shard=kv)
    if family == "llama":
        dtype, key, reads = LLAMA_CASES[case]
        kw = dict(model="tiny", dtype=dtype, checkpoint=dirs[key], max_seq_len=None, **where)
        if reads == "stream":
            return dict(_walk_tree(tck.drain(serving_cell.rank_stream(**kw))))
        return dict(serving_cell.rank_slices(device="cpu", **kw))
    if family == "mixtral":
        return dict(serving_cell.rank_slices(
            device="cpu", model="mixtral-tiny", dtype=case, checkpoint=dirs["mixtral"],
            max_seq_len=None, **where))
    return dict(serving_cell.embedding_slices(device="cpu", cfg=tb.bge_tiny(),
                                              checkpoint=dirs[case], **where))


def _one_device(dirs, family, case):
    if family == "llama":
        return _llama_one_device(dirs, case)
    if family == "mixtral":
        tree, _ = thf.load_moe_params(dirs["mixtral"], dtype=torch.bfloat16 if case == "bfloat16"
                                      else torch.float32)
        return tm.quantize_params(tree) if case == "int8" else tree
    return orbax_ckpt.load_params(dirs[case], tb.init_params(tb.bge_tiny(), None, "meta"),
                                  torch.float32, "cpu")[0]


CASES = ([("llama", c) for c in LLAMA_CASES] + [("mixtral", "bfloat16"), ("mixtral", "int8")]
         + [("bge", "bge"), ("bge", "bge_chunked")])
CFGS = {"llama": tl.llama_tiny(), "mixtral": tm.moe_tiny(), "bge": tb.bge_tiny()}


@pytest.mark.parametrize("world", [2, 4, 8])
@pytest.mark.parametrize("family,case", CASES, ids=[f"{f}-{c}" for f, c in CASES])
def test_rank_blocks_equal_the_cut_of_the_one_device_load(dirs, family, case, world):
    """Every rank's blocks, read from disk by the cell's recipe, equal the
    one-device load cut by ``shard_tree`` (and an int8 head tile-padded,
    ``pad_vocab``) bit for bit: dtype, shape and bytes, ``q`` and ``s``
    alike; a row-parallel leaf's int8 scale is its whole column's. At 8
    ranks the decoders' 4 heads are cut in whole heads, ranks 4-7 reading
    none and holding zeros."""
    cfg = CFGS[family]
    full = _one_device(dirs, family, case)
    kv = tshd.kv_sharded(getattr(cfg, "num_kv_heads", cfg.num_heads), world)
    for rank in range(world):
        got = _rank_blocks(dirs, family, case, rank, world, kv)
        want = tshd.shard_tree(full, rank, world, kv, head_dim=cfg.head_dim)
        if family != "bge":
            want = tshd.pad_vocab(want, tshd.vocab_rows(cfg.vocab_size, world))
        want = dict(_walk_tree(want))
        assert set(got) == set(want)
        for path, w in want.items():
            g = got[path]
            assert g.dtype == w.dtype and g.shape == w.shape, (rank, path)
            assert torch.equal(g, w), (rank, path)


# --- the abstract local tree -------------------------------------------------------------

def _npz_recipe(tree, path) -> Recipe:
    np.savez(path, **{"/".join(k): (v.float() if v.dtype == torch.bfloat16 else v).numpy()
                      for k, v in _walk_tree(tree)})
    return Recipe("kukeon_tpu_torch.models.convert:npz_leaves", {"path": str(path)})


LOCAL = {
    "llama_int8_odd_vocab": (dataclasses.replace(tl.llama_tiny(), vocab_size=500), True),
    "llama_f32_untied_odd_vocab": (dataclasses.replace(tl.llama_tiny(), vocab_size=500,
                                                       tie_embeddings=False), False),
    "mixtral_int8": (tm.moe_tiny(), True),
    "bge": (tb.bge_tiny(), False),
}


@pytest.mark.parametrize("world", [2, 4, 8])
@pytest.mark.parametrize("name", list(LOCAL))
def test_local_meta_has_local_params_shapes(name, world, tmp_path):
    """``local_meta`` (what a rank's stream and engine allocate from) has
    the shapes and dtypes ``local_params`` gives that rank, the vocabulary
    and the int8 head's tile padding included."""
    cfg, quantized = LOCAL[name]
    gen = torch.Generator().manual_seed(0)
    if isinstance(cfg, tb.BertConfig):
        tree = tb.init_params(cfg, gen, "cpu")
    else:
        mod = tm if isinstance(cfg, tm.MoEConfig) else tl
        tree = mod.init_params(cfg, gen, "cpu")
        if quantized:
            tree = mod.quantize_params(tree)
    recipe = _npz_recipe(tree, tmp_path / "w.npz")
    kv = tshd.kv_sharded(getattr(cfg, "num_kv_heads", cfg.num_heads), world)
    for rank in range(world):
        mesh = types.SimpleNamespace(rank=rank, world=world, device=torch.device("cpu"))
        local = dict(_walk_tree(tshd.local_params(recipe, cfg, mesh, kv)))
        meta = dict(_walk_tree(tshd.local_meta(cfg, mesh, kv, quantized=quantized)))
        assert set(local) == set(meta)
        for path, spec in meta.items():
            assert tuple(local[path].shape) == spec.shape, (rank, path)
            assert local[path].dtype == spec.dtype, (rank, path)


# --- a rank's host bytes -------------------------------------------------------------------

def _jobs(leaves) -> dict[tuple, int]:
    """The bytes of each job's leaves (a tree, or ``(path, tensor)``
    pairs): an int8 leaf's q and s together."""
    out: dict = {}
    for path, t in (_walk_tree(leaves) if isinstance(leaves, dict) and "embed" in leaves
                    else leaves.items()):
        key = path[:-1] if path[-1] in ("q", "s") else path
        out[key] = out.get(key, 0) + t.numel() * t.element_size()
    return out


@pytest.mark.parametrize("case", ["kukeon_int8", "hf_bf16", "hf_int8", "mixtral_int8"])
def test_a_rank_reader_holds_its_slice_and_one_staging_block(dirs, case, monkeypatch):
    """At world 2 a reader's live buffers (``HostMeter``: the slice it
    builds, its staging blocks) peak under its largest slice plus one
    staging block, and under the largest full leaf: no reader holds a
    full leaf (a column block is read as whole rows, a block at a time)."""
    monkeypatch.setattr(tck, "STAGE_BYTES", STAGE)
    where = dict(rank=1, world=2, kv_shard=True)
    if case == "mixtral_int8":
        cfg = thf.moe_config_from_hf(dirs["mixtral"])
        job = tck.JobPeak()
        local = dict(thf.moe_rank_leaves(dirs["mixtral"], cfg, device="cpu", quantize=True,
                                         peak=job, **where))
        full = thf.load_moe_params(dirs["mixtral"], dtype=torch.float32)[0]
        # The expert stacks go to the device as they are built: on the
        # host, a staging block of an expert matrix.
        slices = [b for p, b in _jobs(local).items() if p[-1] not in ("w_gate", "w_up", "w_down")]
        peak = job.bytes
    else:
        if case == "kukeon_int8":
            stream = tck.stream_quantized(dirs["quant"], torch.float32, threads=1, buffer_bytes=0,
                                          **where)
            full = tck.load_quantized(dirs["quant"], torch.float32)[0]
        else:
            fn = thf.stream_params_quantized if case == "hf_int8" else thf.stream_params
            dtype = torch.float32 if case == "hf_int8" else torch.bfloat16
            stream = fn(dirs["hf"], dtype=dtype, threads=1, buffer_bytes=0, **where)
            full = (thf.load_params_quantized(dirs["hf"], dtype=dtype) if case == "hf_int8"
                    else thf.load_params(dirs["hf"], dtype=dtype))[0]
        local = tck.drain(stream)
        slices = list(_jobs(local).values())
        stats = stream.stat_snapshot()
        peak = stats["job_peak_bytes"]
        assert 0 < stats["read_bytes"]
    largest_full = max(_jobs(full).values())
    assert 0 < peak <= max(slices) + STAGE, (peak, max(slices))
    assert peak < largest_full, (peak, largest_full)


# --- two-rank streamed cells -------------------------------------------------------------

def _jax_tokens(stream, page_tokens: int) -> list:
    eng = JaxEngine(stream.cfg, stream, jax_serving_mesh(2), num_slots=2, max_seq_len=128,
                    kv_page_tokens=page_tokens or None)
    sp = JaxSampling(temperature=0.0, max_new_tokens=8)
    return [list(eng.generate(p, sp)) for p in PROMPTS]


@pytest.mark.parametrize("paged", [False, True], ids=["legacy", "paged"])
@pytest.mark.parametrize("fmt", ["kukeon_int8", "hf"])
def test_two_rank_streamed_cell_matches_jax_mesh2_and_one_device(dirs, fmt, paged):
    """``ServingCell(chips=2, checkpoint=dir)`` boots streamed on both
    ranks (each reads its blocks while its programs capture) and gives the
    greedy tokens of the JAX engine on ``serving_mesh(2)`` booted from the
    JAX package's stream of the same directory, and of the port's
    one-device streamed cell; its load counter reads the full tree's
    bytes, as the one-device cell's."""
    path = dirs["quant" if fmt == "kukeon_int8" else "hf"]
    jstream = (jck.stream_quantized(path, dtype="float32") if fmt == "kukeon_int8"
               else jhf.stream_params(path, dtype=np.float32))
    want = _jax_tokens(jstream, 16 if paged else 0)
    out = []
    for chips in (2, None):
        cell = ServingCell("tiny", num_slots=2, max_seq_len=128, device="cpu", chips=chips,
                           checkpoint=path, dtype=None if fmt == "kukeon_int8" else "float32",
                           kv_page_tokens=16 if paged else 0)
        eng = cell.engine
        assert eng._ckpt_stream is not None and eng.world == (chips or 1)
        cell.warmup(8)
        out.append([eng.generate(p, serving_cell.SamplingParams(temperature=0.0,
                                                                max_new_tokens=8))
                    for p in PROMPTS])
        out.append(eng._ckpt_stream.stat_snapshot()["bytes"])
        eng.close()
    assert out[0] == out[2] == want, (out[0], out[2], want)
    assert out[1] == out[3]


# --- a follower's failed read --------------------------------------------------------------

def test_a_follower_whose_read_fails_ends_the_group_naming_it(dirs, tmp_path):
    """A kukeon int8 file cut short inside rank 1's rows of its last
    tensor: rank 0 reads its blocks, rank 1's read fails on its load
    thread; the leader's warmup raises ``RankFailure`` naming rank 1 (no
    rank falls back to a full read) and the cell never turns ready."""
    src = os.path.join(dirs["quant"], "model.quant.safetensors")
    with tck.SafetensorsReader(src) as r:
        tensors = {n: r.get_tensor(n) for n in r.keys()}
    order = [n for n in tensors if n != "embed.q"] + ["embed.q"]    # embed.q last
    bad = tmp_path / "bad"
    os.makedirs(bad)
    tck.save_safetensors({n: tensors[n] for n in order}, str(bad / "model.quant.safetensors"))
    with open(os.path.join(dirs["quant"], tck.QUANT_MANIFEST)) as f:
        manifest = f.read()
    (bad / tck.QUANT_MANIFEST).write_text(manifest)
    # Cut the file three quarters into embed.q: rank 0's rows (the first
    # half) are whole, rank 1's are not.
    size = os.path.getsize(bad / "model.quant.safetensors")
    os.truncate(bad / "model.quant.safetensors", size - tensors["embed.q"].numel() // 4)
    cell = ServingCell("tiny", num_slots=2, max_seq_len=128, device="cpu", chips=2,
                       checkpoint=str(bad))
    try:
        with pytest.raises(launch.RankFailure, match="rank 1") as e:
            cell.warmup(8)
        assert "cut short" in str(e.value) or "exited" in str(e.value)
        assert not cell.readiness()[0]
    finally:
        cell.engine.stop()
    launch.shutdown()
