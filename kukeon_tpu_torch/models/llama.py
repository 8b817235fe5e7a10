"""Llama-family decoder, the port of ``kukeon_tpu/models/llama.py``.

Plain functions on tensors over a parameter dict in the reference's
stacked layout (``[L, ...]`` leading axis; int8 matrices as ``{"q", "s"}``
leaves), so a reference tree converted by
:func:`kukeon_tpu_torch.models.convert.params_from_numpy` runs unchanged.
The reference's ``lax.scan`` over layers is a Python loop over ``[l]``
views. bf16 weights and activations, f32 softmax and norms.

KV caches are ``[L, B, S, KV, D]`` and are updated **in place**
(advanced-index assignment): where the reference donates the cache to a
jitted program and gets a new one back, :func:`forward` writes into the
cache it is given and returns that same object with new ``lengths``.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F

from kukeon_tpu_torch.ops.attention import decode_gqa_attention, gqa_attention
from kukeon_tpu_torch.ops.int8_matmul import int8_matmul
from kukeon_tpu_torch.ops.norms import rms_norm
from kukeon_tpu_torch.ops.rope import apply_rope, rope_tables

Params = dict[str, Any]


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 128256
    hidden_size: int = 4096
    intermediate_size: int = 14336
    num_layers: int = 32
    num_heads: int = 32
    num_kv_heads: int = 8
    head_dim: int = 128
    rope_theta: float = 500_000.0
    rms_norm_eps: float = 1e-5
    max_seq_len: int = 8192
    tie_embeddings: bool = False
    dtype: torch.dtype = torch.bfloat16
    # Route int8 decode projections and the decode LM head through the CUDA
    # kernel (ops/int8_matmul.py). The serving engine turns it on for int8
    # weights on a CUDA device; ignored for full-precision weights.
    int8_pallas: bool = False

    @property
    def q_dim(self) -> int:
        return self.num_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.num_kv_heads * self.head_dim

    def param_count(self) -> int:
        embed = self.vocab_size * self.hidden_size
        attn = self.hidden_size * (self.q_dim + 2 * self.kv_dim) + self.q_dim * self.hidden_size
        mlp = 3 * self.hidden_size * self.intermediate_size
        norms = 2 * self.hidden_size
        head = 0 if self.tie_embeddings else embed
        return embed + self.num_layers * (attn + mlp + norms) + self.hidden_size + head


# --- Presets -----------------------------------------------------------------

def llama3_8b() -> LlamaConfig:
    return LlamaConfig()


def llama3_1b() -> LlamaConfig:
    """Llama-3.2-1B shapes (tied embeddings)."""
    return LlamaConfig(
        vocab_size=128256, hidden_size=2048, intermediate_size=8192,
        num_layers=16, num_heads=32, num_kv_heads=8, head_dim=64,
        tie_embeddings=True,
    )


def llama_tiny() -> LlamaConfig:
    """Test-size config: runs fast on a CPU."""
    return LlamaConfig(
        vocab_size=512, hidden_size=128, intermediate_size=256,
        num_layers=2, num_heads=4, num_kv_heads=2, head_dim=32,
        rope_theta=10_000.0, max_seq_len=256, dtype=torch.float32,
        tie_embeddings=True,
    )


# --- Init --------------------------------------------------------------------

def init_params(cfg: LlamaConfig, generator: torch.Generator,
                device: torch.device | str) -> Params:
    """Random full-precision parameters in the reference layout:
      embed [V, H]; layers: attn_norm [L, H], wq [L, H, NH*D],
      wk/wv [L, H, KV*D], wo [L, NH*D, H], mlp_norm [L, H],
      w_gate/w_up [L, H, I], w_down [L, I, H]; final_norm [H];
      lm_head [H, V] (absent when tie_embeddings).
    The draws differ from the reference's (torch's generator, not jax's);
    parity tests convert the reference's tree instead."""
    c = cfg

    def dense(shape, fan_in):
        w = torch.randn(shape, generator=generator, dtype=torch.float32, device=device)
        return (w * fan_in ** -0.5).to(c.dtype)

    L, H, I, V = c.num_layers, c.hidden_size, c.intermediate_size, c.vocab_size
    ones = lambda *shape: torch.ones(shape, dtype=c.dtype, device=device)  # noqa: E731
    params: Params = {
        "embed": dense((V, H), H),
        "layers": {
            "attn_norm": ones(L, H),
            "wq": dense((L, H, c.q_dim), H),
            "wk": dense((L, H, c.kv_dim), H),
            "wv": dense((L, H, c.kv_dim), H),
            "wo": dense((L, c.q_dim, H), c.q_dim),
            "mlp_norm": ones(L, H),
            "w_gate": dense((L, H, I), H),
            "w_up": dense((L, H, I), H),
            "w_down": dense((L, I, H), I),
        },
        "final_norm": ones(H),
    }
    if not c.tie_embeddings:
        params["lm_head"] = dense((H, V), H)
    return params


# --- KV cache ----------------------------------------------------------------

@dataclasses.dataclass
class KVCache:
    """Decode cache. k/v: [L, B, S_max, KV, D]; lengths: [B] used slots.

    Quantized form: int8 k/v with per-token per-kv-head symmetric scales
    k_scale/v_scale [L, B, S_max, KV] f32; dequant is fused into the decode
    attention (ops/attention.py decode_gqa_attention)."""

    k: torch.Tensor
    v: torch.Tensor
    lengths: torch.Tensor
    k_scale: torch.Tensor | None = None
    v_scale: torch.Tensor | None = None

    @staticmethod
    def create(cfg: LlamaConfig, batch: int, max_len: int, dtype=None,
               quantized: bool = False, device=None) -> "KVCache":
        shape = (cfg.num_layers, batch, max_len, cfg.num_kv_heads, cfg.head_dim)
        lengths = torch.zeros((batch,), dtype=torch.int64, device=device)
        if quantized:
            return KVCache(
                k=torch.zeros(shape, dtype=torch.int8, device=device),
                v=torch.zeros(shape, dtype=torch.int8, device=device),
                lengths=lengths,
                k_scale=torch.zeros(shape[:-1], dtype=torch.float32, device=device),
                v_scale=torch.zeros(shape[:-1], dtype=torch.float32, device=device),
            )
        dtype = dtype or cfg.dtype
        return KVCache(k=torch.zeros(shape, dtype=dtype, device=device),
                       v=torch.zeros(shape, dtype=dtype, device=device),
                       lengths=lengths)

    @property
    def max_len(self) -> int:
        return self.k.shape[2]

    @property
    def quantized(self) -> bool:
        return self.k_scale is not None


def quantize_kv(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-token per-head symmetric int8 over the last (head_dim) axis:
    x ~= q * s[..., None]. x: [..., D] -> (int8 [..., D], f32 [...])."""
    q, s = _int8_sym(x, -1)
    return q, s.squeeze(-1)


def _cache_insert(cache_kv: torch.Tensor, new_kv: torch.Tensor,
                  offsets: torch.Tensor) -> None:
    """Write [B, S, ...] at per-row ``offsets`` into [B, S_max, ...], in
    place. Starts clamp to ``S_max - S`` as the reference's
    ``dynamic_update_slice`` does."""
    B, S = new_kv.shape[:2]
    start = torch.clamp(offsets, max=cache_kv.shape[1] - S)
    rows = start[:, None] + torch.arange(S, device=offsets.device)[None, :]
    cache_kv[torch.arange(B, device=offsets.device)[:, None], rows] = new_kv.to(cache_kv.dtype)


# --- int8 weight quantization ------------------------------------------------
#
# Per-output-channel symmetric int8: w ~= q * s with q int8, s f32[out].
# Decode is bound by weight bytes, so int8 halves what every step streams.


def _int8_sym(w: torch.Tensor, axis: int) -> tuple[torch.Tensor, torch.Tensor]:
    """THE symmetric-int8 recipe: w ~= q * s, s keepdims along ``axis``.
    Rounds half to even, as the reference does."""
    wf = w.float()
    a = torch.amax(torch.abs(wf), dim=axis, keepdim=True)
    s = torch.clamp(a / 127.0, min=1e-12)
    q = torch.round(wf / s).to(torch.int8)
    return q, s


def quantize_params(params: Params) -> Params:
    """Full-precision tree -> int8 tree ({"q": int8, "s": f32} leaves for
    every dense matrix; norms stay as they are)."""

    def q(w, axis):
        qw, s = _int8_sym(w, axis)
        return {"q": qw, "s": s.squeeze(axis)}

    L = params["layers"]
    out: Params = {
        "embed": q(params["embed"], 1),                     # scale per vocab row
        "layers": {
            "attn_norm": L["attn_norm"],
            "wq": q(L["wq"], 1), "wk": q(L["wk"], 1), "wv": q(L["wv"], 1),
            "wo": q(L["wo"], 1),
            "mlp_norm": L["mlp_norm"],
            "w_gate": q(L["w_gate"], 1), "w_up": q(L["w_up"], 1),
            "w_down": q(L["w_down"], 1),
        },
        "final_norm": params["final_norm"],
    }
    if "lm_head" in params:
        out["lm_head"] = q(params["lm_head"], 0)            # scale per vocab col
    return out


def quantize_np(w, axis: int):
    """Per-output-channel symmetric int8 on the host (numpy): w ~= q * s.
    Must match :func:`_int8_sym` exactly."""
    w = np.asarray(w, np.float32)
    a = np.max(np.abs(w), axis=axis, keepdims=True)
    s = np.maximum(a / 127.0, 1e-12).astype(np.float32)
    q = np.round(w / s).astype(np.int8)
    return {"q": q, "s": np.squeeze(s, axis=axis)}


def init_quantized_params_host(cfg: LlamaConfig, seed: int = 0) -> Params:
    """Random-init directly in int8 on the host (numpy), leaf by leaf: the
    same draws and recipe as the reference's function of this name, so the
    two packages get identical trees from one seed. Returns numpy leaves;
    :func:`kukeon_tpu_torch.models.convert.params_from_numpy` moves them."""
    c = cfg
    rng = np.random.default_rng(seed)
    L, H, I, V = c.num_layers, c.hidden_size, c.intermediate_size, c.vocab_size
    ndtype = np.float32    # norms; params_from_numpy casts them to cfg.dtype

    def q(shape, fan_in, axis):
        w = rng.standard_normal(shape, np.float32) * (fan_in ** -0.5)
        return quantize_np(w, axis)

    params: Params = {
        "embed": q((V, H), H, 1),
        "layers": {
            "attn_norm": np.ones((L, H), ndtype),
            "wq": q((L, H, c.q_dim), H, 1),
            "wk": q((L, H, c.kv_dim), H, 1),
            "wv": q((L, H, c.kv_dim), H, 1),
            "wo": q((L, c.q_dim, H), c.q_dim, 1),
            "mlp_norm": np.ones((L, H), ndtype),
            "w_gate": q((L, H, I), H, 1),
            "w_up": q((L, H, I), H, 1),
            "w_down": q((L, I, H), I, 1),
        },
        "final_norm": np.ones((H,), ndtype),
    }
    if not c.tie_embeddings:
        params["lm_head"] = q((H, V), H, 0)
    return params


def _is_q(w) -> bool:
    return isinstance(w, dict) and "q" in w


def _mm(h: torch.Tensor, w, kernel: bool = False) -> torch.Tensor:
    """h @ w for plain or quantized weights.

    ``kernel=True`` routes int8 weights through :func:`int8_matmul` (the
    decode path): the CUDA kernel for decode-sized batches, its plain
    version on the CPU, dequant + matmul for prefill-sized batches."""
    if _is_q(w):
        if kernel:
            lead = h.shape[:-1]
            out = int8_matmul(h.reshape(-1, h.shape[-1]).contiguous(), w["q"], w["s"])
            return out.reshape(*lead, out.shape[-1])
        return (h @ w["q"].to(h.dtype)) * w["s"].to(h.dtype)
    return h @ w


def _embed(params: Params, tokens: torch.Tensor, dtype) -> torch.Tensor:
    e = params["embed"]
    if _is_q(e):
        rows = e["q"][tokens].to(dtype)
        return rows * e["s"][tokens][..., None].to(dtype)
    return e[tokens].to(dtype)


def _logits(params: Params, c: LlamaConfig, x: torch.Tensor,
            kernel: bool = False) -> torch.Tensor:
    if c.tie_embeddings:
        e = params["embed"]
        if _is_q(e):
            if kernel:
                lead = x.shape[:-1]
                out = int8_matmul(x.reshape(-1, x.shape[-1]).contiguous(),
                                  e["q"], e["s"], transpose=True)
                return out.reshape(*lead, out.shape[-1]).float()
            raw = torch.einsum("bsh,vh->bsv", x, e["q"].to(x.dtype))
            return (raw * e["s"].to(x.dtype)).float()
        return torch.einsum("bsh,vh->bsv", x, e).float()
    return _mm(x, params["lm_head"], kernel).float()


def layer_weights(params: Params, layer: int) -> dict:
    """The ``layer``-th slice of the stacked layer tree (views, no copy)."""
    return {name: ({"q": w["q"][layer], "s": w["s"][layer]} if _is_q(w) else w[layer])
            for name, w in params["layers"].items()}


def _mlp(x: torch.Tensor, w: dict, c: LlamaConfig, kernel: bool = False) -> torch.Tensor:
    h = rms_norm(x, w["mlp_norm"], c.rms_norm_eps)
    gate = F.silu(_mm(h, w["w_gate"], kernel).float()).to(c.dtype)
    up = _mm(h, w["w_up"], kernel)
    return x + _mm(gate * up, w["w_down"], kernel)


# --- Forward -----------------------------------------------------------------

def transformer_block(
    x: torch.Tensor,
    w: dict,
    cfg: LlamaConfig,
    positions: torch.Tensor,
    attn_impl: str = "auto",
    rope: tuple[torch.Tensor, torch.Tensor] | None = None,
) -> torch.Tensor:
    """One no-cache decoder block (attention + SwiGLU residual) over
    [B, S, H], ``w`` one layer's weights (:func:`layer_weights`); ``rope``
    optionally the positions' precomputed (cos, sin) tables."""
    c = cfg
    B, S = x.shape[:2]
    rope = rope or rope_tables(positions, c.head_dim, c.rope_theta)
    h = rms_norm(x, w["attn_norm"], c.rms_norm_eps)
    q = _mm(h, w["wq"]).reshape(B, S, c.num_heads, c.head_dim)
    k = _mm(h, w["wk"]).reshape(B, S, c.num_kv_heads, c.head_dim)
    v = _mm(h, w["wv"]).reshape(B, S, c.num_kv_heads, c.head_dim)
    q = apply_rope(q, positions, c.rope_theta, rope)
    k = apply_rope(k, positions, c.rope_theta, rope)
    attn = gqa_attention(q, k, v, q_positions=positions, kv_positions=positions,
                         impl=attn_impl)
    x = x + _mm(attn.reshape(B, S, c.q_dim), w["wo"])
    return _mlp(x, w, c)


def forward(
    params: Params,
    cfg: LlamaConfig,
    tokens: torch.Tensor,
    positions: torch.Tensor,
    cache: KVCache | None = None,
    attn_impl: str = "auto",
    logit_positions: torch.Tensor | None = None,
) -> tuple[torch.Tensor, KVCache | None]:
    """Run the decoder.

    Args:
      params: parameter dict (reference layout).
      tokens: [B, S] integer token ids.
      positions: [B, S] absolute positions of those tokens.
      cache: optional KVCache; new K/V are written, in place, at each
        row's current length and attention runs against the cache.
        ``positions`` must equal ``cache.lengths[:, None] + arange(S)``.
      logit_positions: optional [B] sequence indices; the LM head then runs
        at only those positions and logits come back [B, 1, V].

    Returns:
      (logits [B, S, V] float32 — [B, 1, V] with ``logit_positions`` — and
      the cache, updated in place with new lengths, or None).
    """
    c = cfg
    B, S = tokens.shape
    x = _embed(params, tokens, c.dtype)                     # [B, S, H]

    if cache is not None and S == 1 and attn_impl in ("auto", "reference"):
        return _decode_forward(params, c, x, positions, cache, B)

    offsets = cache.lengths if cache is not None else None
    rope = rope_tables(positions, c.head_dim, c.rope_theta)
    for layer in range(c.num_layers):
        w = layer_weights(params, layer)
        if cache is None:
            x = transformer_block(x, w, c, positions, attn_impl, rope)
            continue
        h = rms_norm(x, w["attn_norm"], c.rms_norm_eps)
        q = _mm(h, w["wq"]).reshape(B, S, c.num_heads, c.head_dim)
        k = _mm(h, w["wk"]).reshape(B, S, c.num_kv_heads, c.head_dim)
        v = _mm(h, w["wv"]).reshape(B, S, c.num_kv_heads, c.head_dim)
        q = apply_rope(q, positions, c.rope_theta, rope)
        k = apply_rope(k, positions, c.rope_theta, rope)
        ck, cv = cache.k[layer], cache.v[layer]
        if cache.quantized:
            # Multi-token path: quantize the new K/V in, then dequantize the
            # whole layer cache (f32 product, cast down — the same recipe
            # the fused decode path applies).
            cks, cvs = cache.k_scale[layer], cache.v_scale[layer]
            qk, sk = quantize_kv(k)
            qv, sv = quantize_kv(v)
            _cache_insert(ck, qk, offsets)
            _cache_insert(cv, qv, offsets)
            _cache_insert(cks, sk, offsets)
            _cache_insert(cvs, sv, offsets)
            ak = (ck.float() * cks[..., None].float()).to(c.dtype)
            av = (cv.float() * cvs[..., None].float()).to(c.dtype)
        else:
            _cache_insert(ck, k, offsets)
            _cache_insert(cv, v, offsets)
            ak, av = ck, cv
        kv_positions = torch.arange(ck.shape[1], device=x.device)[None, :].expand(B, -1)
        attn = gqa_attention(q, ak, av, q_positions=positions,
                             kv_positions=kv_positions, kv_length=offsets + S,
                             impl=attn_impl)
        x = x + _mm(attn.reshape(B, S, c.q_dim), w["wo"])
        x = _mlp(x, w, c)

    if cache is not None:
        cache.lengths = cache.lengths + S
    x = rms_norm(x, params["final_norm"], c.rms_norm_eps)
    if logit_positions is not None:
        idx = logit_positions.reshape(B, 1, 1).expand(B, 1, x.shape[-1])
        x = torch.gather(x, 1, idx)
    return _logits(params, c, x), cache


def _decode_forward(
    params: Params,
    c: LlamaConfig,
    x: torch.Tensor,
    positions: torch.Tensor,
    cache: KVCache,
    B: int,
) -> tuple[torch.Tensor, KVCache]:
    """Single-token decode: every layer reads its cache slice read-only
    (append-free attention scores the new token separately); the new K/V of
    all layers are written once at the end, one row per slot, in place.
    With ``cfg.int8_pallas`` the projections and the LM head go through
    :func:`int8_matmul` — at 8B, 7 x 32 + 1 = 225 kernel launches a step."""
    offsets = cache.lengths
    kern = c.int8_pallas
    rope = rope_tables(positions, c.head_dim, c.rope_theta)
    new_k, new_v = [], []
    for layer in range(c.num_layers):
        w = layer_weights(params, layer)
        h = rms_norm(x, w["attn_norm"], c.rms_norm_eps)
        q = _mm(h, w["wq"], kern).reshape(B, 1, c.num_heads, c.head_dim)
        k = _mm(h, w["wk"], kern).reshape(B, 1, c.num_kv_heads, c.head_dim)
        v = _mm(h, w["wv"], kern).reshape(B, 1, c.num_kv_heads, c.head_dim)
        q = apply_rope(q, positions, c.rope_theta, rope)
        k = apply_rope(k, positions, c.rope_theta, rope)
        attn = decode_gqa_attention(
            q, k, v, cache.k[layer], cache.v[layer], offsets,
            k_scale=cache.k_scale[layer] if cache.quantized else None,
            v_scale=cache.v_scale[layer] if cache.quantized else None)
        x = x + _mm(attn.reshape(B, 1, c.q_dim), w["wo"], kern)
        x = _mlp(x, w, c, kern)
        new_k.append(k)
        new_v.append(v)

    # [L, B, KV, D]: one in-place row write per slot covering every layer
    # (layers share the slot's offset). Offsets clamp like the reference's
    # dynamic_update_slice.
    nk = torch.stack(new_k)[:, :, 0]
    nv = torch.stack(new_v)[:, :, 0]
    rows = torch.arange(B, device=x.device)
    pos = torch.clamp(offsets, max=cache.max_len - 1)
    if cache.quantized:
        nk, nks = quantize_kv(nk)
        nv, nvs = quantize_kv(nv)
        cache.k_scale[:, rows, pos] = nks
        cache.v_scale[:, rows, pos] = nvs
    cache.k[:, rows, pos] = nk.to(cache.k.dtype)
    cache.v[:, rows, pos] = nv.to(cache.v.dtype)
    cache.lengths = cache.lengths + 1

    x = rms_norm(x, params["final_norm"], c.rms_norm_eps)
    return _logits(params, c, x, kern), cache
