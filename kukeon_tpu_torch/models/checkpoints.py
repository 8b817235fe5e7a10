"""Checkpoint tooling, the port of ``kukeon_tpu/models/checkpoints.py``:
synthesize HF-layout checkpoints, and save and load the kukeon int8
quantized format.

Safetensors files are read and written here with torch and numpy alone:
the format is an 8-byte little-endian header length, a JSON header (each
tensor's dtype, shape and ``data_offsets`` into the data that follows, and
an optional ``__metadata__``), then the tensors' raw row-major bytes. So
the port needs neither the ``safetensors`` package nor a numpy bfloat16
dtype (BF16 goes through torch). :class:`SafetensorsReader` reads one
named tensor at a time into a fresh CPU tensor; :func:`save_safetensors`
writes files the ``safetensors`` package reads.

Counterparts in the reference (``kukeon_tpu/models/checkpoints.py``):

  QUANT_MANIFEST                 :40
  _CFG_FIELDS, _cfg_to_json,
  _cfg_from_json                 :42-54
  write_hf_config                :59
  write_tokenizer_json           :78
  synthesize_hf_checkpoint       :102  (the same draws, in the same order)
  _flatten_quant, _unflatten_quant  :200-226
  save_quantized                 :229
  is_quantized_checkpoint        :248
  load_quantized                 :252
  TensorSpec                     :290
  _ST_DTYPES                     :320  (torch dtypes here)
  read_safetensors_header        :327

Loaders return trees of CPU tensors in the reference's layout (stacked
``[L, ...]`` leaves, int8 matrices as ``{"q", "s"}``); the serving cell
moves them to its device. ``CheckpointStream`` and ``stream_quantized``
(the streamed boot) are ROADMAP A10b.
"""

from __future__ import annotations

import dataclasses
import json
import os
import struct

import numpy as np
import torch

from kukeon_tpu_torch.models.llama import LlamaConfig

QUANT_MANIFEST = "kukeon_quant.json"

_CFG_FIELDS = (
    "vocab_size", "hidden_size", "intermediate_size", "num_layers",
    "num_heads", "num_kv_heads", "head_dim", "rope_theta", "rms_norm_eps",
    "max_seq_len", "tie_embeddings",
)


def _cfg_to_json(cfg: LlamaConfig) -> dict:
    return {f: getattr(cfg, f) for f in _CFG_FIELDS}


def _cfg_from_json(d: dict) -> LlamaConfig:
    return LlamaConfig(**{f: d[f] for f in _CFG_FIELDS if f in d})


# --- safetensors I/O ----------------------------------------------------------

# safetensors header dtype strings -> torch dtypes.
_ST_DTYPES = {
    "F64": torch.float64, "F32": torch.float32, "F16": torch.float16,
    "BF16": torch.bfloat16, "I64": torch.int64, "I32": torch.int32,
    "I16": torch.int16, "I8": torch.int8, "U8": torch.uint8, "BOOL": torch.bool,
}
_ST_NAMES = {v: k for k, v in _ST_DTYPES.items()}


class TensorSpec:
    """Shape and dtype of one tensor, parsed from a safetensors header
    before any tensor byte is read."""

    __slots__ = ("shape", "dtype")

    def __init__(self, shape: tuple[int, ...], dtype: torch.dtype) -> None:
        self.shape = tuple(int(d) for d in shape)
        self.dtype = dtype

    @property
    def nbytes(self) -> int:
        return self.dtype.itemsize * int(np.prod(self.shape, dtype=np.int64))

    def __repr__(self) -> str:
        return f"TensorSpec(shape={self.shape}, dtype={self.dtype})"


def _read_header(f) -> tuple[dict, int]:
    """(the JSON header without ``__metadata__``, the file offset where the
    data begins) of an open safetensors file."""
    (n,) = struct.unpack("<Q", f.read(8))
    header = json.loads(f.read(n))
    header.pop("__metadata__", None)
    return header, 8 + n


def read_safetensors_header(path: str) -> dict[str, TensorSpec]:
    """tensor name -> TensorSpec from a safetensors file's JSON header: the
    8-byte length prefix and the header itself, no tensor byte."""
    with open(path, "rb") as f:
        header, _ = _read_header(f)
    return {name: TensorSpec(meta["shape"], _ST_DTYPES[meta["dtype"]])
            for name, meta in header.items()}


class SafetensorsReader:
    """One safetensors file opened for reading tensor by tensor (the port's
    ``safe_open``): :meth:`get_tensor` seeks to the tensor's data and reads
    it into a fresh CPU tensor, so no more than that tensor is held."""

    def __init__(self, path: str):
        self.path = path
        self._f = open(path, "rb")
        try:
            self._header, self._base = _read_header(self._f)
        except BaseException:
            self._f.close()
            raise

    def keys(self) -> list[str]:
        return list(self._header)

    def get_tensor(self, name: str) -> torch.Tensor:
        meta = self._header[name]
        dtype = _ST_DTYPES[meta["dtype"]]
        shape = tuple(meta["shape"])
        start, end = meta["data_offsets"]
        nbytes = TensorSpec(shape, dtype).nbytes
        if end - start != nbytes:
            raise ValueError(f"{self.path}: tensor {name!r} holds {end - start} bytes, "
                             f"its dtype and shape {meta['dtype']} {list(shape)} need {nbytes}")
        raw = torch.empty(nbytes, dtype=torch.uint8)
        view = memoryview(raw.numpy())
        self._f.seek(self._base + start)
        got = 0
        while got < nbytes:
            n = self._f.readinto(view[got:])
            if not n:
                raise ValueError(f"{self.path}: tensor {name!r} is cut short "
                                 f"({got} of {nbytes} bytes)")
            got += n
        return raw.view(dtype).reshape(shape)

    def close(self) -> None:
        self._f.close()

    def __enter__(self) -> SafetensorsReader:
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def save_safetensors(tensors: dict[str, torch.Tensor], path: str) -> None:
    """Write ``tensors`` (CPU or device tensors) as one safetensors file:
    their bytes contiguous in the header's order, the header padded with
    spaces to a multiple of 8 bytes."""
    header, offset = {}, 0
    for name, t in tensors.items():
        nbytes = t.numel() * t.element_size()
        header[name] = {"dtype": _ST_NAMES[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + nbytes]}
        offset += nbytes
    blob = json.dumps(header, separators=(",", ":")).encode()
    blob += b" " * (-len(blob) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(blob)))
        f.write(blob)
        for t in tensors.values():
            flat = t.detach().to("cpu").contiguous().reshape(-1)
            f.write(memoryview(flat.view(torch.uint8).numpy()))


# --- HF-layout synthesis ------------------------------------------------------

def write_hf_config(path: str, cfg: LlamaConfig) -> None:
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump({
            "architectures": ["LlamaForCausalLM"],
            "vocab_size": cfg.vocab_size,
            "hidden_size": cfg.hidden_size,
            "intermediate_size": cfg.intermediate_size,
            "num_hidden_layers": cfg.num_layers,
            "num_attention_heads": cfg.num_heads,
            "num_key_value_heads": cfg.num_kv_heads,
            "head_dim": cfg.head_dim,
            "rope_theta": cfg.rope_theta,
            "rms_norm_eps": cfg.rms_norm_eps,
            "max_position_embeddings": cfg.max_seq_len,
            "tie_word_embeddings": cfg.tie_embeddings,
            "torch_dtype": "float16",
        }, f, indent=1)


def write_tokenizer_json(path: str) -> None:
    """A real (HF ``tokenizers``-format) byte-level BPE with Llama-3 special
    tokens: a small trained vocab, byte-complete, so any text round-trips
    through the same ``HFTokenizer`` path a downloaded tokenizer.json takes.
    Needs the ``tokenizers`` package (imported here, lazily)."""
    from tokenizers import Tokenizer, decoders, models, pre_tokenizers, trainers

    tk = Tokenizer(models.BPE(unk_token=None))
    tk.pre_tokenizer = pre_tokenizers.ByteLevel(add_prefix_space=False)
    tk.decoder = decoders.ByteLevel()
    trainer = trainers.BpeTrainer(
        vocab_size=2048,
        special_tokens=["<|begin_of_text|>", "<|end_of_text|>", "<|eot_id|>"],
        initial_alphabet=pre_tokenizers.ByteLevel.alphabet(),
    )
    corpus = [
        "def main(argv):\n    return run(argv)\n",
        "the quick brown fox jumps over the lazy dog",
        "kukeon serves agent sessions on gpu cells with scoped secrets",
        "import torch\nimport numpy as np\n",
    ] * 64
    tk.train_from_iterator(corpus, trainer)
    tk.save(os.path.join(path, "tokenizer.json"))


def synthesize_hf_checkpoint(
    path: str,
    cfg: LlamaConfig,
    *,
    seed: int = 0,
    dtype: torch.dtype = torch.float16,
    max_shard_bytes: int = 4 << 30,
    tokenizer: bool = True,
) -> str:
    """Write a random-weights checkpoint at ``cfg``'s shapes in the HF hub
    layout (sharded safetensors + index + config.json [+ tokenizer.json]).

    The reference's draws, in its order, from ``np.random.default_rng(seed)``
    (normal f32 times ``fan_in ** -0.5``, cast to ``dtype``; norms are ones),
    and its shard and rename scheme, so the tensors equal the reference's
    bit for bit. A shard is written once it would pass ``max_shard_bytes``,
    so at most one shard is held. Idempotent: returns at once if the
    directory already has a config and weights.
    """
    os.makedirs(path, exist_ok=True)
    if os.path.exists(os.path.join(path, "config.json")) and (
        os.path.exists(os.path.join(path, "model.safetensors.index.json"))
        or os.path.exists(os.path.join(path, "model.safetensors"))
    ):
        return path

    rng = np.random.default_rng(seed)
    c = cfg
    H, I, V = c.hidden_size, c.intermediate_size, c.vocab_size

    def tensor_specs():
        yield "model.embed_tokens.weight", (V, H), H
        for i in range(c.num_layers):
            p = f"model.layers.{i}."
            yield p + "input_layernorm.weight", (H,), None
            yield p + "self_attn.q_proj.weight", (c.q_dim, H), H
            yield p + "self_attn.k_proj.weight", (c.kv_dim, H), H
            yield p + "self_attn.v_proj.weight", (c.kv_dim, H), H
            yield p + "self_attn.o_proj.weight", (H, c.q_dim), c.q_dim
            yield p + "post_attention_layernorm.weight", (H,), None
            yield p + "mlp.gate_proj.weight", (I, H), H
            yield p + "mlp.up_proj.weight", (I, H), H
            yield p + "mlp.down_proj.weight", (H, I), I
        yield "model.norm.weight", (H,), None
        if not c.tie_embeddings:
            yield "lm_head.weight", (V, H), H

    def make(shape, fan_in) -> torch.Tensor:
        if fan_in is None:
            return torch.ones(shape, dtype=dtype)          # norm scales
        w = rng.standard_normal(shape, np.float32)
        w *= fan_in ** -0.5
        return torch.from_numpy(w).to(dtype)

    weight_map: dict[str, str] = {}
    shard: dict[str, torch.Tensor] = {}
    shard_bytes = 0
    shard_names: list[str] = []

    def flush():
        nonlocal shard, shard_bytes
        if not shard:
            return
        name = f"model-part-{len(shard_names):05d}.safetensors"
        save_safetensors(shard, os.path.join(path, name))
        shard_names.append(name)
        for n in shard:
            weight_map[n] = name
        shard = {}
        shard_bytes = 0

    for name, shape, fan_in in tensor_specs():
        t = make(shape, fan_in)
        nbytes = t.numel() * t.element_size()
        if shard_bytes + nbytes > max_shard_bytes:
            flush()
        shard[name] = t
        shard_bytes += nbytes
    flush()

    # Rename to the canonical HF n-of-m scheme now that m is known.
    total = len(shard_names)
    renames: dict[str, str] = {}
    for idx, name in enumerate(shard_names):
        final = f"model-{idx + 1:05d}-of-{total:05d}.safetensors"
        renames[name] = final
        os.rename(os.path.join(path, name), os.path.join(path, final))
    final_map = {n: renames[shard_name] for n, shard_name in weight_map.items()}
    with open(os.path.join(path, "model.safetensors.index.json"), "w") as f:
        json.dump({"weight_map": final_map}, f)
    write_hf_config(path, cfg)
    if tokenizer:
        write_tokenizer_json(path)
    return path


# --- kukeon int8 quantized checkpoint ----------------------------------------

def _flatten_quant(params: dict) -> dict[str, torch.Tensor]:
    flat: dict[str, torch.Tensor] = {}

    def walk(prefix: str, node):
        if isinstance(node, dict):
            if "q" in node and "s" in node and len(node) == 2:
                flat[prefix + ".q"] = node["q"]
                flat[prefix + ".s"] = node["s"]
            else:
                for k, v in node.items():
                    walk(f"{prefix}.{k}" if prefix else k, v)
        else:
            flat[prefix] = node

    walk("", params)
    return flat


def _unflatten_quant(flat: dict[str, torch.Tensor]) -> dict:
    tree: dict = {}
    for name, t in flat.items():
        parts = name.split(".")
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = t
    return tree


def save_quantized(path: str, params: dict, cfg: LlamaConfig) -> str:
    """Persist an int8 {"q","s"} tree (tensors on any device) as
    ``model.quant.safetensors`` + the ``kukeon_quant.json`` manifest. Norms
    in another dtype than int8, f32 or f16 are stored as f32, as the
    reference stores them."""
    os.makedirs(path, exist_ok=True)
    flat = {
        k: (v if v.dtype in (torch.int8, torch.float32, torch.float16) else v.float())
        for k, v in _flatten_quant(params).items()
    }
    save_safetensors(flat, os.path.join(path, "model.quant.safetensors"))
    with open(os.path.join(path, QUANT_MANIFEST), "w") as f:
        json.dump({"format": "kukeon-int8-v1", "config": _cfg_to_json(cfg)}, f)
    return path


def is_quantized_checkpoint(path: str) -> bool:
    return os.path.exists(os.path.join(path, QUANT_MANIFEST))


def load_quantized(path: str, dtype: torch.dtype | None = None) -> tuple[dict, LlamaConfig]:
    """The int8 tree back as CPU tensors, with the manifest's config (its
    activation dtype ``dtype`` when given). f32 leaves other than the ``.s``
    scales (the norms) are cast to the activation dtype."""
    with open(os.path.join(path, QUANT_MANIFEST)) as f:
        manifest = json.load(f)
    if manifest.get("format") != "kukeon-int8-v1":
        raise ValueError(f"unknown quantized checkpoint format in {path}")
    cfg = _cfg_from_json(manifest["config"])
    if dtype is not None:
        cfg = dataclasses.replace(cfg, dtype=dtype)
    flat: dict[str, torch.Tensor] = {}
    with SafetensorsReader(os.path.join(path, "model.quant.safetensors")) as f:
        for name in f.keys():
            t = f.get_tensor(name)
            if t.dtype == torch.float32 and not name.endswith(".s"):
                t = t.to(cfg.dtype)   # norm scales follow the activation dtype
            flat[name] = t
    return _unflatten_quant(flat), cfg
