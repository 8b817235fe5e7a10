"""HuggingFace Llama and Mixtral checkpoints -> the port's parameter trees,
the port of ``kukeon_tpu/models/hf_convert.py``.

Reads ``*.safetensors`` shards (the HF hub layout: an index with its
shards, a single ``model.safetensors``, or one lone shard) with the port's
own reader (:mod:`kukeon_tpu_torch.models.checkpoints`), one tensor at a
time, and lays them out as :mod:`kukeon_tpu_torch.models.llama`'s stacked
tree of CPU tensors. HF Linear stores ``[out, in]`` and the port's
products take ``[in, out]``, so every matrix is transposed:

  model.embed_tokens.weight            [V, H]   -> embed [V, H]
  model.layers.N.input_layernorm       [H]      -> layers.attn_norm [L, H]
  model.layers.N.self_attn.{q,k,v,o}_proj       -> layers.w{q,k,v,o} (T)
  model.layers.N.post_attention_layernorm       -> layers.mlp_norm
  model.layers.N.mlp.{gate,up,down}_proj        -> layers.w_{gate,up,down} (T)
  model.norm.weight                    [H]      -> final_norm
  lm_head.weight                       [V, H]   -> lm_head [H, V] (T);
                                                   dropped when tied

Counterparts in the reference (``kukeon_tpu/models/hf_convert.py``):

  config_from_hf         :35
  _open_shards           :56
  load_params            :81
  moe_config_from_hf     :143
  load_moe_params        :169
  load_params_quantized  :253  (host quantization with ``llama.quantize_np``)

``stream_params`` and ``stream_params_quantized`` (the streamed boot) are
ROADMAP A10b.
"""

from __future__ import annotations

import dataclasses
import json
import os

import numpy as np
import torch

from kukeon_tpu_torch.models.checkpoints import SafetensorsReader, read_safetensors_header
from kukeon_tpu_torch.models.llama import LlamaConfig, Params, quantize_np
from kukeon_tpu_torch.models.moe import MoEConfig


def config_from_hf(checkpoint_dir: str) -> LlamaConfig:
    with open(os.path.join(checkpoint_dir, "config.json")) as f:
        hf = json.load(f)
    head_dim = hf.get("head_dim") or (
        hf["hidden_size"] // hf["num_attention_heads"]
    )
    return LlamaConfig(
        vocab_size=hf["vocab_size"],
        hidden_size=hf["hidden_size"],
        intermediate_size=hf["intermediate_size"],
        num_layers=hf["num_hidden_layers"],
        num_heads=hf["num_attention_heads"],
        num_kv_heads=hf.get("num_key_value_heads", hf["num_attention_heads"]),
        head_dim=head_dim,
        rope_theta=hf.get("rope_theta", 500_000.0),
        rms_norm_eps=hf.get("rms_norm_eps", 1e-5),
        max_seq_len=hf.get("max_position_embeddings", 8192),
        tie_embeddings=hf.get("tie_word_embeddings", False),
    )


def _open_shards(checkpoint_dir: str) -> dict[str, str]:
    """tensor name -> shard path. Index, single-file and lone-shard layouts."""
    index_path = os.path.join(checkpoint_dir, "model.safetensors.index.json")
    if os.path.exists(index_path):
        with open(index_path) as f:
            index = json.load(f)
        return {
            name: os.path.join(checkpoint_dir, shard)
            for name, shard in index["weight_map"].items()
        }
    single = os.path.join(checkpoint_dir, "model.safetensors")
    if not os.path.exists(single):
        cands = [f for f in os.listdir(checkpoint_dir)
                 if f.endswith(".safetensors")]
        if len(cands) != 1:
            raise FileNotFoundError(
                f"no model.safetensors[.index.json] in {checkpoint_dir}"
            )
        single = os.path.join(checkpoint_dir, cands[0])
    return {name: single for name in read_safetensors_header(single)}


class _Shards:
    """The checkpoint's tensors by name, read on demand through one reader
    per shard; remembers what was read, for the unmapped-tensor check."""

    def __init__(self, checkpoint_dir: str):
        self.where = _open_shards(checkpoint_dir)
        self._readers: dict[str, SafetensorsReader] = {}
        self._consumed: set[str] = set()

    def get(self, name: str) -> torch.Tensor:
        shard = self.where[name]          # a missing tensor raises KeyError
        if shard not in self._readers:
            self._readers[shard] = SafetensorsReader(shard)
        self._consumed.add(name)
        return self._readers[shard].get_tensor(name)

    def check_all_mapped(self) -> None:
        """Raise on any tensor the mapping did not read; a tied checkpoint
        may still ship ``lm_head.weight``, which is dropped."""
        self._consumed.add("lm_head.weight")
        unmapped = sorted(set(self.where) - self._consumed)
        if unmapped:
            raise ValueError(f"unmapped tensors in checkpoint: {unmapped[:5]}")

    def __enter__(self) -> _Shards:
        return self

    def __exit__(self, *exc) -> None:
        for r in self._readers.values():
            r.close()


def _stack(shards: _Shards, fmt: str, L: int, transpose: bool, dtype: torch.dtype):
    """``fmt.format(i)`` for every layer, transposed if asked, stacked into
    a contiguous ``[L, ...]`` tensor, then cast."""
    ts = [shards.get(fmt.format(i)) for i in range(L)]
    return torch.stack([t.T for t in ts] if transpose else ts).to(dtype)


def _trunk(shards: _Shards, L: int, dtype: torch.dtype) -> tuple[torch.Tensor, dict]:
    """The embedding and the attention half of every layer, shared by the
    Llama and Mixtral layouts."""
    p = "model.layers.{}."
    embed = shards.get("model.embed_tokens.weight").to(dtype)
    layers = {
        "attn_norm": _stack(shards, p + "input_layernorm.weight", L, False, dtype),
        "wq": _stack(shards, p + "self_attn.q_proj.weight", L, True, dtype),
        "wk": _stack(shards, p + "self_attn.k_proj.weight", L, True, dtype),
        "wv": _stack(shards, p + "self_attn.v_proj.weight", L, True, dtype),
        "wo": _stack(shards, p + "self_attn.o_proj.weight", L, True, dtype),
        "mlp_norm": _stack(shards, p + "post_attention_layernorm.weight", L, False, dtype),
    }
    return embed, layers


def _head(shards: _Shards, params: Params, cfg, dtype: torch.dtype) -> Params:
    params["final_norm"] = shards.get("model.norm.weight").to(dtype)
    if not cfg.tie_embeddings:
        params["lm_head"] = shards.get("lm_head.weight").T.contiguous().to(dtype)
    shards.check_all_mapped()
    return params


def load_params(checkpoint_dir: str, cfg: LlamaConfig | None = None,
                dtype: torch.dtype = torch.bfloat16) -> tuple[Params, LlamaConfig]:
    """An HF Llama checkpoint directory -> (params, cfg), CPU tensors in
    ``dtype``, stacked along the layer axis. Tensors are read as the
    mapping needs them (stacked in the file's dtype, then cast)."""
    cfg = cfg or config_from_hf(checkpoint_dir)
    cfg = dataclasses.replace(cfg, dtype=dtype)   # params and cfg must agree
    L, p = cfg.num_layers, "model.layers.{}."
    with _Shards(checkpoint_dir) as shards:
        embed, layers = _trunk(shards, L, dtype)
        layers.update({
            "w_gate": _stack(shards, p + "mlp.gate_proj.weight", L, True, dtype),
            "w_up": _stack(shards, p + "mlp.up_proj.weight", L, True, dtype),
            "w_down": _stack(shards, p + "mlp.down_proj.weight", L, True, dtype),
        })
        params = _head(shards, {"embed": embed, "layers": layers}, cfg, dtype)
    return params, cfg


# --- Mixtral (sparse MoE) -----------------------------------------------------

def moe_config_from_hf(checkpoint_dir: str) -> MoEConfig:
    """config.json (MixtralForCausalLM layout) -> MoEConfig."""
    with open(os.path.join(checkpoint_dir, "config.json")) as f:
        hf = json.load(f)
    head_dim = hf.get("head_dim") or (
        hf["hidden_size"] // hf["num_attention_heads"]
    )
    return MoEConfig(
        vocab_size=hf["vocab_size"],
        hidden_size=hf["hidden_size"],
        intermediate_size=hf["intermediate_size"],
        num_layers=hf["num_hidden_layers"],
        num_heads=hf["num_attention_heads"],
        num_kv_heads=hf.get("num_key_value_heads", hf["num_attention_heads"]),
        head_dim=head_dim,
        num_experts=hf.get("num_local_experts", 8),
        experts_per_token=hf.get("num_experts_per_tok", 2),
        rope_theta=hf.get("rope_theta", 1_000_000.0),
        rms_norm_eps=hf.get("rms_norm_eps", 1e-5),
        max_seq_len=hf.get("max_position_embeddings", 8192),
        tie_embeddings=hf.get("tie_word_embeddings", False),
    )


def load_moe_params(checkpoint_dir: str, cfg: MoEConfig | None = None,
                    dtype: torch.dtype = torch.bfloat16) -> tuple[Params, MoEConfig]:
    """HF Mixtral checkpoint -> (MoE params, MoEConfig), CPU tensors.

      model.layers.N.block_sparse_moe.gate.weight   [E, H] -> router [L, H, E] (f32)
      ...experts.E.w1.weight [I, H] -> w_gate [L, E, H, I]  (T per expert)
      ...experts.E.w3.weight [I, H] -> w_up   [L, E, H, I]
      ...experts.E.w2.weight [H, I] -> w_down [L, E, I, H]

    Attention, norms and embedding map as in Llama (the same trunk). The
    router stays f32, so routing does not wobble with the activation dtype.
    """
    cfg = cfg or moe_config_from_hf(checkpoint_dir)
    cfg = dataclasses.replace(cfg, dtype=dtype)
    L, E = cfg.num_layers, cfg.num_experts

    def experts(shards: _Shards, w_name: str) -> torch.Tensor:
        return torch.stack([
            torch.stack([
                shards.get(f"model.layers.{i}.block_sparse_moe.experts.{e}.{w_name}.weight").T
                for e in range(E)])
            for i in range(L)]).to(dtype)

    with _Shards(checkpoint_dir) as shards:
        embed, layers = _trunk(shards, L, dtype)
        layers.update({
            "router": _stack(shards, "model.layers.{}.block_sparse_moe.gate.weight", L, True,
                             torch.float32),
            "w_gate": experts(shards, "w1"),
            "w_up": experts(shards, "w3"),
            "w_down": experts(shards, "w2"),
        })
        params = _head(shards, {"embed": embed, "layers": layers}, cfg, dtype)
    return params, cfg


# --- int8 load ------------------------------------------------------------------

def _tensor(a: np.ndarray) -> torch.Tensor:
    """A host array as a contiguous CPU tensor (a transposed quantization
    comes out column-major, and the kernels want row-major leaves)."""
    return torch.from_numpy(np.ascontiguousarray(a))


def _f32(t: torch.Tensor) -> np.ndarray:
    """A stored tensor as f32 numpy, exactly (bf16 goes through torch:
    numpy has no bfloat16 of its own)."""
    return t.to(torch.float32).numpy()


def load_params_quantized(checkpoint_dir: str,
                          cfg: LlamaConfig | None = None,
                          dtype: torch.dtype | None = None) -> tuple[Params, LlamaConfig]:
    """An HF Llama checkpoint straight into the int8 tree ({"q", "s"}
    leaves), quantized on the host one tensor at a time with
    :func:`~kukeon_tpu_torch.models.llama.quantize_np` (the reference's
    recipe): the full-precision tree is never materialized, and the peak
    beyond the int8 tree is one f32 tensor (the embedding is the largest).

    HF matrices are transposed to ``[in, out]`` and quantized per output
    channel on axis 0; the embedding per vocab row on axis 1; ``lm_head``
    only when untied. ``dtype`` sets the activation and norm dtype
    (default: cfg's, or bfloat16 when cfg comes from config.json).
    """
    if cfg is None:
        cfg = dataclasses.replace(config_from_hf(checkpoint_dir),
                                  dtype=dtype or torch.bfloat16)
    elif dtype is not None:
        cfg = dataclasses.replace(cfg, dtype=dtype)
    L = cfg.num_layers

    with _Shards(checkpoint_dir) as shards:
        def stack_q(fmt: str) -> dict[str, torch.Tensor]:
            """Per-layer quantize (HF [out, in] -> ours [in, out]), stack."""
            qs, ss = [], []
            for i in range(L):
                leaf = quantize_np(_f32(shards.get(fmt.format(i))).T, axis=0)
                qs.append(leaf["q"])
                ss.append(leaf["s"])
            return {"q": _tensor(np.stack(qs)), "s": _tensor(np.stack(ss))}

        def quantized(name: str, axis: int, transpose: bool) -> dict[str, torch.Tensor]:
            w = _f32(shards.get(name))
            leaf = quantize_np(w.T if transpose else w, axis=axis)
            return {"q": _tensor(leaf["q"]), "s": _tensor(leaf["s"])}

        p = "model.layers.{}."
        params: Params = {
            "embed": quantized("model.embed_tokens.weight", 1, False),
            "layers": {
                "attn_norm": _stack(shards, p + "input_layernorm.weight", L, False, cfg.dtype),
                "wq": stack_q(p + "self_attn.q_proj.weight"),
                "wk": stack_q(p + "self_attn.k_proj.weight"),
                "wv": stack_q(p + "self_attn.v_proj.weight"),
                "wo": stack_q(p + "self_attn.o_proj.weight"),
                "mlp_norm": _stack(shards, p + "post_attention_layernorm.weight", L, False,
                                   cfg.dtype),
                "w_gate": stack_q(p + "mlp.gate_proj.weight"),
                "w_up": stack_q(p + "mlp.up_proj.weight"),
                "w_down": stack_q(p + "mlp.down_proj.weight"),
            },
            "final_norm": shards.get("model.norm.weight").to(cfg.dtype),
        }
        if not cfg.tie_embeddings:
            params["lm_head"] = quantized("lm_head.weight", 0, True)
        shards.check_all_mapped()
    return params, cfg
