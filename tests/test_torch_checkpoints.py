"""Checkpoints on the port (``kukeon_tpu_torch.models.checkpoints`` and
``hf_convert``, the serving cell's ``checkpoint=``) against the JAX
package's on the CPU, at ``tiny`` and ``mixtral-tiny``.

- The port's safetensors reader against ``safetensors.safe_open`` (F32, F16,
  BF16, I8; single-file and index layouts; a ``__metadata__`` entry), and
  its writer read back by ``safe_open`` bit for bit;
- ``synthesize_hf_checkpoint``: tensors, index and ``config.json`` equal
  the reference's for one seed;
- ``load_params``, ``load_params_quantized`` and ``load_moe_params``
  against the reference's on the same directory, every leaf bit for bit
  (tied and untied, f16 and f32 files); ``save_quantized`` and
  ``load_quantized`` cross-read both ways; the unmapped-tensor
  ``ValueError`` and the missing tensor's ``KeyError``;
- port cells against JAX cells booted from the same directory, the same
  greedy tokens: HF f32, HF int8, a quantized directory, ``mixtral-tiny``
  fp and int8, and a text prompt through the synthesized ``tokenizer.json``;
  the int8 path never materializes the full-precision tree; orbax-like
  paths that are not orbax checkpoints are refused; ``main()`` serves ``--checkpoint`` in a subprocess;
- the loaders run with ``jax``, ``safetensors``, ``ml_dtypes`` and
  ``tokenizers`` unimportable.
"""

import dataclasses
import json
import os
import subprocess
import sys
import urllib.request

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import safetensors.numpy
import safetensors.torch
import torch
from safetensors import safe_open

from kukeon_tpu.models import checkpoints as jck
from kukeon_tpu.models import hf_convert as jhf
from kukeon_tpu.models import llama as jl
from kukeon_tpu.models import moe as jm
from kukeon_tpu.runtime.serving_cell import ServingCell as JaxCell
from kukeon_tpu_torch.models import checkpoints as tck
from kukeon_tpu_torch.models import hf_convert as thf
from kukeon_tpu_torch.models import llama as tl
from kukeon_tpu_torch.models import moe as tm
from kukeon_tpu_torch.runtime.serving_cell import EmbeddingCell, ServingCell

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PROMPT = [5, 300, 7, 200, 9, 41, 77, 13, 250, 3, 99]
GENERATE = {"promptTokens": PROMPT, "maxNewTokens": 8}
NP_DTYPES = {torch.float32: np.float32, torch.float16: np.float16,
             torch.bfloat16: ml_dtypes.bfloat16}


def _bits(x) -> tuple[str, tuple, np.ndarray]:
    """(dtype name, shape, the raw bits) of a torch tensor or an array."""
    if isinstance(x, torch.Tensor):
        name = str(x.dtype).removeprefix("torch.")
        a = x.view(torch.int16).numpy() if x.dtype == torch.bfloat16 else x.numpy()
    else:
        a = np.asarray(x)
        name = a.dtype.name
        if name == "bfloat16":
            a = a.view(np.int16)
    if a.dtype == np.float16:
        a = a.view(np.int16)
    elif a.dtype == np.float32:
        a = a.view(np.int32)
    return name, tuple(a.shape), a


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}."))
        return out
    return {prefix[:-1]: tree}


def _assert_trees_bitwise(port, ref):
    fp, fr = _flat(port), _flat(ref)
    assert fp.keys() == fr.keys()
    for k, t in fp.items():
        if isinstance(t, torch.Tensor):
            assert t.is_contiguous(), k
        (na, sa, a), (nb, sb, b) = _bits(t), _bits(fr[k])
        assert (na, sa) == (nb, sb), (k, na, sa, nb, sb)
        assert np.array_equal(a, b), k


def _cfg_fields(cfg) -> dict:
    """A config's fields other than its dtype and kernel switch."""
    return {k: v for k, v in dataclasses.asdict(cfg).items() if k not in ("dtype", "int8_pallas")}


def _cfgs(tied=True):
    return (dataclasses.replace(jl.llama_tiny(), tie_embeddings=tied),
            dataclasses.replace(tl.llama_tiny(), tie_embeddings=tied))


# --- safetensors I/O ----------------------------------------------------------

def _sample_tensors(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {
        "f32": torch.randn(3, 5, generator=g),
        "f16": torch.randn(4, 7, generator=g).half(),
        "bf16": torch.randn(2, 3, 4, generator=g).bfloat16(),
        "i8": torch.randint(-128, 128, (6, 2), generator=g, dtype=torch.int8),
    }


@pytest.mark.parametrize("layout", ["single", "index"])
def test_reader_matches_safe_open(tmp_path, layout):
    """Files the safetensors package wrote, with __metadata__: the port's
    header, specs and tensors equal safe_open's, in both HF layouts."""
    ts = _sample_tensors()
    if layout == "single":
        safetensors.torch.save_file(ts, str(tmp_path / "model.safetensors"),
                                    metadata={"format": "pt"})
    else:
        names = list(ts)
        shards = {"model-00001-of-00002.safetensors": names[:2],
                  "model-00002-of-00002.safetensors": names[2:]}
        for shard, keys in shards.items():
            safetensors.torch.save_file({k: ts[k] for k in keys}, str(tmp_path / shard),
                                        metadata={"format": "pt"})
        (tmp_path / "model.safetensors.index.json").write_text(json.dumps(
            {"metadata": {}, "weight_map": {k: s for s, ks in shards.items() for k in ks}}))
    where = thf._open_shards(str(tmp_path))
    assert where == jhf._open_shards(str(tmp_path))
    assert sorted(where) == sorted(ts)
    for name, shard in where.items():
        specs = tck.read_safetensors_header(shard)
        ref_specs = jck.read_safetensors_header(shard)
        assert "__metadata__" not in specs and specs.keys() == ref_specs.keys()
        for k, spec in specs.items():
            assert spec.shape == ref_specs[k].shape
            assert spec.nbytes == ref_specs[k].nbytes
        with tck.SafetensorsReader(shard) as r, safe_open(shard, framework="pt") as f:
            assert sorted(r.keys()) == sorted(f.keys())
            got, want = r.get_tensor(name), f.get_tensor(name)
            assert got.dtype == want.dtype and got.shape == want.shape
            assert torch.equal(got, want) and got.is_contiguous()


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32, torch.float16, torch.bfloat16,
                                   torch.int64, torch.int32, torch.int16, torch.int8,
                                   torch.uint8, torch.bool])
def test_writer_is_read_back_by_safe_open(tmp_path, dtype):
    """Every safetensors dtype the port maps, a scalar and an empty tensor
    among them: safe_open reads the port's file bit for bit, and the header
    is padded to 8 bytes."""
    g = torch.Generator().manual_seed(1)
    base = torch.randn(5, 6, generator=g) * 50
    ts = {"m": base.to(dtype), "row": base[0].to(dtype), "scalar": base[1, 2].to(dtype),
          "empty": torch.zeros(0, 3, dtype=dtype), "strided": base.T.to(dtype)}
    path = str(tmp_path / "x.safetensors")
    tck.save_safetensors(ts, path)
    with open(path, "rb") as f:
        assert int.from_bytes(f.read(8), "little") % 8 == 0
    with safe_open(path, framework="pt") as f:
        assert sorted(f.keys()) == sorted(ts)
        for k, t in ts.items():
            got = f.get_tensor(k)
            assert got.dtype == dtype and got.shape == t.shape
            assert torch.equal(got, t.contiguous()), k
    with tck.SafetensorsReader(path) as r:
        for k, t in ts.items():
            assert torch.equal(r.get_tensor(k), t), k


def test_reader_refuses_a_cut_file(tmp_path):
    path = str(tmp_path / "x.safetensors")
    tck.save_safetensors({"a": torch.ones(64)}, path)
    with open(path, "r+b") as f:
        f.truncate(os.path.getsize(path) - 4)
    with tck.SafetensorsReader(path) as r, pytest.raises(ValueError, match="cut short"):
        r.get_tensor("a")


# --- synthesis -------------------------------------------------------------------

@pytest.mark.parametrize("tied,dtype", [(True, torch.float16), (False, torch.float16),
                                        (True, torch.bfloat16)])
def test_synthesize_matches_reference(tmp_path, tied, dtype):
    """One seed: the same index (shards and names), config.json and
    tensors, bit for bit."""
    jcfg, tcfg = _cfgs(tied)
    a, b = str(tmp_path / "ref"), str(tmp_path / "port")
    jck.synthesize_hf_checkpoint(a, jcfg, seed=3, dtype=NP_DTYPES[dtype],
                                 max_shard_bytes=150_000, tokenizer=False)
    tck.synthesize_hf_checkpoint(b, tcfg, seed=3, dtype=dtype, max_shard_bytes=150_000,
                                 tokenizer=False)
    idx = json.loads(open(os.path.join(a, "model.safetensors.index.json")).read())
    assert idx == json.loads(open(os.path.join(b, "model.safetensors.index.json")).read())
    assert len(set(idx["weight_map"].values())) > 2
    assert json.load(open(os.path.join(a, "config.json"))) == \
        json.load(open(os.path.join(b, "config.json")))
    assert sorted(os.listdir(a)) == sorted(os.listdir(b))
    for name, shard in idx["weight_map"].items():
        with safe_open(os.path.join(a, shard), framework="pt") as fa, \
                safe_open(os.path.join(b, shard), framework="pt") as fb:
            x, y = fa.get_tensor(name), fb.get_tensor(name)
            assert x.dtype == y.dtype == dtype and torch.equal(x, y), name
    assert thf.config_from_hf(b) == dataclasses.replace(tcfg, dtype=torch.bfloat16)


def test_synthesized_tokenizer_round_trips(tmp_path):
    from kukeon_tpu_torch.serving.tokenizer import HFTokenizer, load_tokenizer

    tck.synthesize_hf_checkpoint(str(tmp_path), tl.llama_tiny(), seed=0)
    tok = load_tokenizer(str(tmp_path))
    assert isinstance(tok, HFTokenizer) and tok.bos_id is not None
    text = "the quick brown fox serves agent sessions"
    assert tok.decode(tok.encode(text)) == text


# --- loaders against the reference's ----------------------------------------------

@pytest.fixture(scope="module")
def hf_dirs(tmp_path_factory):
    """{(tied, file dtype): directory} written by the reference's synthesizer
    (so through the safetensors package); tiny shards, the index layout."""
    out = {}
    for tied in (True, False):
        for dtype in (np.float16, np.float32):
            d = str(tmp_path_factory.mktemp(f"hf_{tied}_{np.dtype(dtype).name}"))
            jck.synthesize_hf_checkpoint(d, _cfgs(tied)[0], seed=11, dtype=dtype,
                                         max_shard_bytes=200_000, tokenizer=False)
            out[(tied, np.dtype(dtype).name)] = d
    return out


CASES = [(t, d) for t in (True, False) for d in ("float16", "float32")]
CASE_IDS = [f"{'tied' if t else 'untied'}-{d}" for t, d in CASES]


@pytest.mark.parametrize("tied,file_dtype", CASES, ids=CASE_IDS)
def test_load_params_matches_reference(hf_dirs, tied, file_dtype):
    d = hf_dirs[(tied, file_dtype)]
    for jd, td in ((jnp.float32, torch.float32), (jnp.bfloat16, torch.bfloat16)):
        pj, cj = jhf.load_params(d, dtype=jd)
        pt, ct = thf.load_params(d, dtype=td)
        _assert_trees_bitwise(pt, pj)
        assert ct == dataclasses.replace(_cfgs(tied)[1], dtype=td)
        assert ("lm_head" in pt) == (not tied)


@pytest.mark.parametrize("tied,file_dtype", CASES, ids=CASE_IDS)
def test_load_params_quantized_matches_reference(hf_dirs, tied, file_dtype):
    """q, s and norms bit for bit, in both activation dtypes; and the host
    quantization equals the port's quantize_params of the f32 tree."""
    d = hf_dirs[(tied, file_dtype)]
    for jd, td in ((None, None), (jnp.float32, torch.float32)):
        qj, cj = jhf.load_params_quantized(d, dtype=jd)
        qt, ct = thf.load_params_quantized(d, dtype=td)
        _assert_trees_bitwise(qt, qj)
        assert ct.dtype == (td or torch.bfloat16)
    full, _ = thf.load_params(d, dtype=torch.float32)
    on_torch = tl.quantize_params(full)
    for k, leaf in _flat(qt).items():
        if k.endswith(".q") or k.endswith(".s"):
            assert torch.equal(leaf, _flat(on_torch)[k]), k


def _write_mixtral_hf(path, params, cfg, dtype, lm_head=None):
    """``tests/test_moe.py:236``'s HF Mixtral layout, in ``dtype``; with
    ``lm_head`` ([H, V]) an untied checkpoint."""
    L, E = cfg.num_layers, cfg.num_experts
    a = lambda x: np.ascontiguousarray(np.asarray(x, np.float32)).astype(dtype)  # noqa: E731
    flat = {"model.embed_tokens.weight": a(params["embed"]),
            "model.norm.weight": a(params["final_norm"])}
    lw = params["layers"]
    for i in range(L):
        p = f"model.layers.{i}."
        flat[p + "input_layernorm.weight"] = a(lw["attn_norm"][i])
        flat[p + "post_attention_layernorm.weight"] = a(lw["mlp_norm"][i])
        for ours, hf in (("wq", "q_proj"), ("wk", "k_proj"), ("wv", "v_proj"),
                         ("wo", "o_proj")):
            flat[p + f"self_attn.{hf}.weight"] = a(np.asarray(lw[ours][i]).T)
        flat[p + "block_sparse_moe.gate.weight"] = a(np.asarray(lw["router"][i]).T)
        for e in range(E):
            q = f"{p}block_sparse_moe.experts.{e}."
            flat[q + "w1.weight"] = a(np.asarray(lw["w_gate"][i, e]).T)
            flat[q + "w3.weight"] = a(np.asarray(lw["w_up"][i, e]).T)
            flat[q + "w2.weight"] = a(np.asarray(lw["w_down"][i, e]).T)
    if lm_head is not None:
        flat["lm_head.weight"] = a(lm_head.T)
    os.makedirs(path, exist_ok=True)
    safetensors.numpy.save_file(flat, os.path.join(path, "model.safetensors"))
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump({
            "architectures": ["MixtralForCausalLM"],
            "vocab_size": cfg.vocab_size, "hidden_size": cfg.hidden_size,
            "intermediate_size": cfg.intermediate_size,
            "num_hidden_layers": L, "num_attention_heads": cfg.num_heads,
            "num_key_value_heads": cfg.num_kv_heads, "head_dim": cfg.head_dim,
            "num_local_experts": E, "num_experts_per_tok": cfg.experts_per_token,
            "rope_theta": cfg.rope_theta, "rms_norm_eps": cfg.rms_norm_eps,
            "max_position_embeddings": cfg.max_seq_len,
            "tie_word_embeddings": lm_head is None,
        }, f)
    return path


@pytest.fixture(scope="module")
def mixtral_dirs(tmp_path_factory):
    """{"float32" | "float16" | "untied": directory}: mixtral-tiny's init
    in the HF layout, tied in f32 and f16, and untied (a drawn head) in f32."""
    cfg = jm.moe_tiny()
    params = jm.init_params(jax.random.key(0), cfg)
    out = {np.dtype(dt).name: _write_mixtral_hf(
        str(tmp_path_factory.mktemp(f"mixtral_{np.dtype(dt).name}")), params, cfg, dt)
        for dt in (np.float32, np.float16)}
    head = np.random.default_rng(0).standard_normal((cfg.hidden_size, cfg.vocab_size))
    out["untied"] = _write_mixtral_hf(str(tmp_path_factory.mktemp("mixtral_untied")), params,
                                      cfg, np.float32, lm_head=head * cfg.hidden_size ** -0.5)
    return out


@pytest.mark.parametrize("file_dtype", ["float32", "float16", "untied"])
def test_load_moe_params_matches_reference(mixtral_dirs, file_dtype):
    """Every leaf bit for bit (router [L, H, E] f32, experts [L, E, in,
    out]), in both activation dtypes; and the port's quantize_params of the
    loaded tree equals the reference's."""
    d = mixtral_dirs[file_dtype]
    for jd, td in ((jnp.float32, torch.float32), (jnp.bfloat16, torch.bfloat16)):
        pj, cj = jhf.load_moe_params(d, dtype=jd)
        pt, ct = thf.load_moe_params(d, dtype=td)
        _assert_trees_bitwise(pt, pj)
        assert pt["layers"]["router"].dtype == torch.float32
        assert ct.dtype == td
        assert _cfg_fields(ct) == _cfg_fields(cj)
        assert ("lm_head" in pt) == (file_dtype == "untied")
    _assert_trees_bitwise(tm.quantize_params(pt), jm.quantize_params(pj))


@pytest.mark.parametrize("tied", [True, False], ids=["tied", "untied"])
def test_quantized_checkpoints_cross_read(hf_dirs, tmp_path, tied):
    """The port reads what the reference saved and the reverse, bit for
    bit, with the config; norms come back in the asked activation dtype."""
    d = hf_dirs[(tied, "float16")]
    qj, cj = jhf.load_params_quantized(d)
    qt, ct = thf.load_params_quantized(d)
    # The reference's stacked leaves come out of np.stack column-major in
    # their last two axes, and its save_quantized writes such an array in
    # memory order (safetensors' numpy save_file), transposing those planes
    # on disk: it gets C-contiguous copies here.
    jck.save_quantized(str(tmp_path / "ref"), jax.tree.map(np.ascontiguousarray, qj), cj)
    tck.save_quantized(str(tmp_path / "port"), qt, ct)
    for path in ("ref", "port"):
        p = str(tmp_path / path)
        assert tck.is_quantized_checkpoint(p) and jck.is_quantized_checkpoint(p)
        back_t, bct = tck.load_quantized(p)
        back_j, bcj = jck.load_quantized(p)
        _assert_trees_bitwise(back_t, qj)
        _assert_trees_bitwise(back_t, back_j)
        assert bct == dataclasses.replace(ct, dtype=torch.bfloat16)
        f32, _ = tck.load_quantized(p, dtype=torch.float32)
        assert f32["final_norm"].dtype == torch.float32
        assert f32["layers"]["wq"]["s"].dtype == torch.float32
    assert not tck.is_quantized_checkpoint(d)


def test_unknown_quantized_format_is_refused(tmp_path):
    tck.save_quantized(str(tmp_path), {"x": {"q": torch.zeros(2, dtype=torch.int8),
                                             "s": torch.ones(2)}}, tl.llama_tiny())
    (tmp_path / tck.QUANT_MANIFEST).write_text(json.dumps({"format": "other", "config": {}}))
    with pytest.raises(ValueError, match="unknown quantized checkpoint format"):
        tck.load_quantized(str(tmp_path))


@pytest.mark.parametrize("loader", ["load_params", "load_params_quantized"])
def test_unmapped_and_missing_tensors_raise_as_the_reference(tmp_path, loader):
    cfg = _cfgs(True)[0]
    extra, short = str(tmp_path / "extra"), str(tmp_path / "short")
    for d in (extra, short):
        jck.synthesize_hf_checkpoint(d, cfg, seed=0, dtype=np.float32, tokenizer=False)
    idx_path = os.path.join(extra, "model.safetensors.index.json")
    idx = json.load(open(idx_path))
    safetensors.numpy.save_file({"model.extra.weight": np.ones(3, np.float32)},
                                os.path.join(extra, "extra.safetensors"))
    idx["weight_map"]["model.extra.weight"] = "extra.safetensors"
    json.dump(idx, open(idx_path, "w"))
    with pytest.raises(ValueError) as want:
        getattr(jhf, loader)(extra)
    with pytest.raises(ValueError) as got:
        getattr(thf, loader)(extra)
    assert str(got.value) == str(want.value) == \
        "unmapped tensors in checkpoint: ['model.extra.weight']"
    idx_path = os.path.join(short, "model.safetensors.index.json")
    idx = json.load(open(idx_path))
    del idx["weight_map"]["model.layers.1.mlp.up_proj.weight"]
    json.dump(idx, open(idx_path, "w"))
    with pytest.raises(KeyError) as want:
        getattr(jhf, loader)(short)
    with pytest.raises(KeyError) as got:
        getattr(thf, loader)(short)
    assert str(got.value) == str(want.value)


def test_lone_shard_layout_and_a_tied_checkpoint_shipping_its_head(tmp_path):
    """One ``*.safetensors`` of another name and no index, holding the
    ``lm_head.weight`` a tied checkpoint may ship: read, and the head dropped."""
    jcfg, tcfg = _cfgs(True)
    params = jax.tree.map(np.asarray, jl.init_params(jax.random.key(2), jcfg))
    flat = {"model.embed_tokens.weight": params["embed"], "model.norm.weight": params["final_norm"],
            "lm_head.weight": params["embed"].copy()}
    lw = params["layers"]
    for i in range(jcfg.num_layers):
        p = f"model.layers.{i}."
        flat[p + "input_layernorm.weight"] = lw["attn_norm"][i]
        flat[p + "post_attention_layernorm.weight"] = lw["mlp_norm"][i]
        for ours, hf in (("wq", "self_attn.q_proj"), ("wk", "self_attn.k_proj"),
                         ("wv", "self_attn.v_proj"), ("wo", "self_attn.o_proj"),
                         ("w_gate", "mlp.gate_proj"), ("w_up", "mlp.up_proj"),
                         ("w_down", "mlp.down_proj")):
            flat[p + hf + ".weight"] = np.ascontiguousarray(lw[ours][i].T)
    safetensors.numpy.save_file(flat, str(tmp_path / "weights.safetensors"))
    jck.write_hf_config(str(tmp_path), jcfg)
    pt, _ = thf.load_params(str(tmp_path), dtype=torch.float32)
    assert "lm_head" not in pt
    _assert_trees_bitwise(pt, params)
    _assert_trees_bitwise(pt, jhf.load_params(str(tmp_path), dtype=jnp.float32)[0])


# --- cells ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def tiny_dirs(tmp_path_factory):
    """A tiny HF checkpoint (f32, tied, with tokenizer.json) written by the
    port's synthesizer, and its int8 twin written by the port's
    save_quantized."""
    hf = str(tmp_path_factory.mktemp("tiny_hf"))
    tck.synthesize_hf_checkpoint(hf, tl.llama_tiny(), seed=5, dtype=torch.float32,
                                 max_shard_bytes=400_000)
    q = str(tmp_path_factory.mktemp("tiny_q"))
    tck.save_quantized(q, *thf.load_params_quantized(hf))
    return {"hf": hf, "quant": q}


def _both_cells(model, checkpoint, dtype, **kw):
    jc = JaxCell(model, num_slots=2, max_seq_len=64, checkpoint=checkpoint, dtype=dtype, **kw)
    tc = ServingCell(model, num_slots=2, max_seq_len=64, checkpoint=checkpoint, dtype=dtype,
                     device="cpu", **kw)
    return jc, tc


@pytest.mark.parametrize("source,dtype", [("hf", None), ("hf", "int8"), ("quant", None)],
                         ids=["hf-f32", "hf-int8", "quantized"])
def test_port_cell_serves_the_jax_cells_tokens_from_a_checkpoint(tiny_dirs, source, dtype):
    jc, tc = _both_cells("tiny", tiny_dirs[source], dtype)
    assert _cfg_fields(tc.cfg) == _cfg_fields(jc.cfg)
    assert tl._is_q(tc.engine.params["layers"]["wq"]) == (source == "quant" or dtype == "int8")
    want = jc.generate(GENERATE)["tokens"]
    assert tc.generate(GENERATE)["tokens"] == want and len(want) == 8
    # A text prompt goes through the checkpoint's tokenizer.json in both.
    if source == "hf" and dtype is None:
        body = {"prompt": "the quick brown fox", "maxNewTokens": 6}
        a, b = jc.generate(body), tc.generate(body)
        assert b["tokens"] == a["tokens"] and b["text"] == a["text"]
        assert type(tc.tokenizer).__name__ == "HFTokenizer"


@pytest.mark.parametrize("dtype", [None, "int8"], ids=["fp", "int8"])
def test_port_mixtral_cell_serves_the_jax_cells_tokens_from_a_checkpoint(mixtral_dirs, dtype):
    jc, tc = _both_cells("mixtral-tiny", mixtral_dirs["float32"], dtype)
    assert tc.engine.params["layers"]["router"].dtype == torch.float32
    assert tl._is_q(tc.engine.params["layers"]["w_gate"]) == (dtype == "int8")
    # On the CPU the engine keeps the host tree: the weights it serves are
    # what the reference cell loads, bit for bit.
    ref, _ = jhf.load_moe_params(mixtral_dirs["float32"], dtype=jnp.float32)
    if dtype == "int8":
        ref = jm.quantize_params(ref)
    _assert_trees_bitwise(tc.engine.params, ref)
    want = jc.generate(GENERATE)["tokens"]
    assert tc.generate(GENERATE)["tokens"] == want and len(want) == 8


def test_int8_checkpoint_boot_never_loads_the_full_precision_tree(tiny_dirs, monkeypatch):
    """``tests/test_checkpoints.py:154`` on the port: --dtype int8 over an
    HF directory quantizes on the host tensor by tensor."""
    def boom(*a, **k):
        raise AssertionError("full-precision load_params used on the int8 path")

    monkeypatch.setattr(thf, "load_params", boom)
    cell = ServingCell("tiny", num_slots=2, max_seq_len=64, checkpoint=tiny_dirs["hf"],
                       dtype="int8", device="cpu")
    assert cell.generate(GENERATE)["numTokens"] == 8


def test_orbax_like_paths_and_embedding_checkpoints_are_refused(tmp_path):
    """A directory that looks like an orbax one (a ``checkpoint`` file, no
    ``_METADATA``) is no format either cell reads: both exit naming the
    formats they take (orbax checkpoints proper: test_torch_orbax.py)."""
    (tmp_path / "checkpoint").write_text("{}")      # an orbax-like directory
    with pytest.raises(SystemExit, match="nor an orbax checkpoint"):
        ServingCell("tiny", num_slots=2, max_seq_len=64, checkpoint=str(tmp_path),
                    device="cpu")
    with pytest.raises(SystemExit, match="not an orbax checkpoint"):
        EmbeddingCell("bge-tiny", checkpoint=str(tmp_path), device="cpu")


def test_main_serves_a_checkpoint_in_a_subprocess(tiny_dirs):
    """``python -m kukeon_tpu_torch.runtime.serving_cell --checkpoint DIR
    --device cpu --port 0`` answers /v1/generate with the in-process cell's
    tokens, then drains to exit 0."""
    want = ServingCell("tiny", num_slots=2, max_seq_len=64, checkpoint=tiny_dirs["hf"],
                       dtype="int8", device="cpu").generate(GENERATE)["tokens"]
    proc = subprocess.Popen(
        [sys.executable, "-m", "kukeon_tpu_torch.runtime.serving_cell", "--model", "tiny",
         "--checkpoint", tiny_dirs["hf"], "--dtype", "int8", "--device", "cpu",
         "--port", "0", "--max-seq-len", "64", "--num-slots", "2", "--no-warmup"],
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True,
        env={**os.environ, "OMP_NUM_THREADS": "2"})
    try:
        line = proc.stdout.readline()
        assert "ready on" in line, line
        base = "http://" + line.split("ready on ")[1].strip()

        def post(path, body):
            req = urllib.request.Request(base + path, data=json.dumps(body).encode(),
                                         headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=60) as r:
                return json.loads(r.read())

        assert post("/v1/generate", GENERATE)["tokens"] == want
        assert post("/drain", {})["started"] is True
        assert proc.wait(timeout=30) == 0
    finally:
        proc.kill()
        proc.wait()


def test_loaders_need_no_jax_safetensors_ml_dtypes_or_tokenizers(tmp_path):
    """In a process where those four cannot be imported: synthesize (no
    tokenizer), all three HF loaders and both streamed ones, save and load
    quantized (and stream it), and boot a cell from each format."""
    code = r"""
import sys
for m in ("jax", "safetensors", "ml_dtypes", "tokenizers", "kukeon_tpu"):
    sys.modules[m] = None
import torch
torch.set_num_threads(2)
from kukeon_tpu_torch.models import checkpoints, hf_convert, llama
from kukeon_tpu_torch.runtime.serving_cell import ServingCell
d, q = sys.argv[1], sys.argv[2]
checkpoints.synthesize_hf_checkpoint(d, llama.llama_tiny(), seed=1, dtype=torch.bfloat16,
                                     max_shard_bytes=300_000, tokenizer=False)
p, cfg = hf_convert.load_params(d)
qp, qcfg = hf_convert.load_params_quantized(d)
checkpoints.save_quantized(q, qp, qcfg)
back, _ = checkpoints.load_quantized(q)
assert torch.equal(back["layers"]["wq"]["q"], qp["layers"]["wq"]["q"])
streamed = {path: t for s in (hf_convert.stream_params(d), hf_convert.stream_params_quantized(d),
                              checkpoints.stream_quantized(q)) for path, t in s}
assert torch.equal(streamed[("layers", "wq", "q")], qp["layers"]["wq"]["q"])
assert torch.equal(streamed[("layers", "wq")], p["layers"]["wq"])
toks = [ServingCell("tiny", num_slots=2, max_seq_len=64, checkpoint=c, dtype=dt,
                    device="cpu").generate({"promptTokens": [1, 2, 3], "maxNewTokens": 4})
        for c, dt in ((d, None), (d, "int8"), (q, None))]
assert toks[1]["tokens"] == toks[2]["tokens"], toks
leaked = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "safetensors", "ml_dtypes", "tokenizers",
                                       "kukeon_tpu") and sys.modules[m] is not None)
assert not leaked, leaked
print("ok")
"""
    proc = subprocess.run([sys.executable, "-c", code, str(tmp_path / "hf"),
                           str(tmp_path / "q")], capture_output=True, text=True, timeout=120,
                          cwd=ROOT, env={**os.environ, "OMP_NUM_THREADS": "2"})
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.strip().endswith("ok")
