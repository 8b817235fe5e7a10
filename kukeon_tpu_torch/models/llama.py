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

**Tensor parallelism** (``mesh=``, a ``parallel.mesh.Mesh``): the forward
runs on one rank's local tree (``parallel/sharding.py``): its q heads,
its kv heads (or all of them, replicated), its columns of ``w_gate`` and
``w_up`` and rows of ``w_down``, its vocabulary rows of the embedding. The
head counts come from the local shapes, so the code is the one-device
code, plus a masked embedding lookup and an ``all_reduce`` after it, one
``all_reduce`` after ``wo`` and one after ``w_down`` (the row-parallel
partial scaled and cast to the activation dtype first, then summed in
it), and an ``all_gather`` of the vocabulary-sharded logits. Without a
mesh it is the one-device code.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F
import torch.utils.checkpoint

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
    return nest(iter_params(cfg, generator, device))


def iter_params(cfg: LlamaConfig, generator: torch.Generator, device: torch.device | str):
    """:func:`init_params`' leaves as ``(path, tensor)`` pairs, each drawn
    when it is yielded (the same draws, in the same order), so a caller
    can keep a slice of each and free the rest before the next."""
    c = cfg

    def dense(shape, fan_in):
        w = torch.randn(shape, generator=generator, dtype=torch.float32, device=device)
        return (w * fan_in ** -0.5).to(c.dtype)

    L, H, I, V = c.num_layers, c.hidden_size, c.intermediate_size, c.vocab_size
    ones = lambda *shape: torch.ones(shape, dtype=c.dtype, device=device)  # noqa: E731
    yield ("embed",), dense((V, H), H)
    yield ("layers", "attn_norm"), ones(L, H)
    yield ("layers", "wq"), dense((L, H, c.q_dim), H)
    yield ("layers", "wk"), dense((L, H, c.kv_dim), H)
    yield ("layers", "wv"), dense((L, H, c.kv_dim), H)
    yield ("layers", "wo"), dense((L, c.q_dim, H), c.q_dim)
    yield ("layers", "mlp_norm"), ones(L, H)
    yield ("layers", "w_gate"), dense((L, H, I), H)
    yield ("layers", "w_up"), dense((L, H, I), H)
    yield ("layers", "w_down"), dense((L, I, H), I)
    yield ("final_norm",), ones(H)
    if not c.tie_embeddings:
        yield ("lm_head",), dense((H, V), H)


def nest(leaves) -> dict:
    """The nested-dict tree of ``(path tuple, leaf)`` pairs, in their order."""
    tree: dict = {}
    for path, leaf in leaves:
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = leaf
    return tree


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
               quantized: bool = False, device=None,
               kv_heads: int | None = None) -> "KVCache":
        """``kv_heads``: the heads this cache holds (a rank's share under
        tensor parallelism), default ``cfg.num_kv_heads``."""
        shape = (cfg.num_layers, batch, max_len, kv_heads or cfg.num_kv_heads, cfg.head_dim)
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
    # A divisor filled on the tensor's device (no host copy, so this runs
    # inside a CUDA graph): CUDA turns division by a Python scalar into a
    # product with its reciprocal, which misses the IEEE quotient that
    # numpy (quantize_np) and the reference compute by 1 ulp for ~4% of the
    # llama3-1b scales.
    s = torch.clamp(a / a.new_full((), 127.0), min=1e-12)
    q = torch.round(wf / s).to(torch.int8)
    return q, s


def quantize_params(params: Params) -> Params:
    """Full-precision tree -> int8 tree ({"q": int8, "s": f32} leaves for
    every dense matrix; norms stay as they are)."""
    L = params["layers"]
    out: Params = {
        "embed": quantize_leaf(("embed",), params["embed"]),
        "layers": {n: quantize_leaf(("layers", n), L[n])
                   for n in ("attn_norm", "wq", "wk", "wv", "wo", "mlp_norm",
                             "w_gate", "w_up", "w_down")},
        "final_norm": params["final_norm"],
    }
    if "lm_head" in params:
        out["lm_head"] = quantize_leaf(("lm_head",), params["lm_head"])
    return out


def quantize_leaf(path: tuple[str, ...], w: torch.Tensor):
    """:func:`quantize_params` of one leaf at ``path``: a norm as it is, a
    matrix as {"q", "s"} with a scale per vocabulary row (``embed``), per
    vocabulary column (``lm_head``) or per output column (the layers')."""
    if path[-1] in ("attn_norm", "mlp_norm", "final_norm"):
        return w
    axis = 0 if path[-1] == "lm_head" else 1
    qw, s = _int8_sym(w, axis)
    return {"q": qw, "s": s.squeeze(axis)}


def quantize_np(w, axis: int, part: tuple[int, int] | None = None):
    """Per-output-channel symmetric int8 on the host (numpy): w ~= q * s.
    Must match :func:`_int8_sym` exactly. ``part``: ``(lo, hi)`` along
    ``axis``, ``q`` of that range only, its scale still over all of
    ``axis`` (a row-parallel rank's block of the one-device ``q``)."""
    w = np.asarray(w, np.float32)
    a = np.max(np.abs(w), axis=axis, keepdims=True)
    s = np.maximum(a / 127.0, 1e-12).astype(np.float32)
    if part is not None:
        w = w[(slice(None),) * (axis % w.ndim) + (slice(*part),)]
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


def _cols(w) -> int:
    """Output columns of a plain or quantized [.., K, N] matrix."""
    return (w["q"] if _is_q(w) else w).shape[-1]


def _heads(params: Params, c: LlamaConfig, rank: int
           ) -> tuple[int, int, slice | torch.Tensor]:
    """(q heads, kv heads computed, kv heads attended) of this rank, from the local shapes: its q heads are a contiguous block of
    the model's (zero-padded past its last head, where the tensor size
    does not divide the heads). With a replicated cache (every kv head
    computed) it attends only the kv heads of its q heads' groups: a slice
    of them when the block holds whole groups or lies inside one, else an
    index of one kv head per local q head (a block that straddles groups;
    a padded head takes the last kv head, and its zero ``wo`` rows drop
    what it computes)."""
    w = params["layers"]
    nh = _cols(w["wq"]) // c.head_dim
    nkv = _cols(w["wk"]) // c.head_dim
    if nkv < c.num_kv_heads or nh == c.num_heads:
        return nh, nkv, slice(None)
    g = c.num_heads // c.num_kv_heads
    lo = rank * nh
    if lo + nh <= c.num_heads and ((nh % g == 0 and lo % g == 0) or g % nh == 0):
        return nh, nkv, slice(lo // g, (lo + nh - 1) // g + 1)
    wq = w["wq"]["q"] if _is_q(w["wq"]) else w["wq"]
    heads = torch.arange(lo, lo + nh, device=wq.device)
    return nh, nkv, torch.clamp(heads // g, max=c.num_kv_heads - 1)


def _psum(x: torch.Tensor, mesh) -> torch.Tensor:
    """The row-parallel sum (no-op without a mesh)."""
    return x if mesh is None else mesh.all_reduce(x)


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


def vocab_rows(vocab_size: int, world: int) -> int:
    """A rank's block of a vocabulary cut ``world`` ways: ``ceil(V / world)``
    entries, the last rank's zero-padded when the world does not divide V
    (``parallel/sharding.py``)."""
    return -(-vocab_size // world)


def _world(mesh) -> int:
    return mesh.world if mesh is not None else 1


def masked_lookup(table: torch.Tensor, tokens: torch.Tensor, rows: int, mesh,
                  lookup=None) -> torch.Tensor:
    """The vocab-sharded lookup of ``tokens`` in a rank's block of ``rows``
    entries of ``table`` (``lookup(ids)``, default ``table[ids]``): ids
    outside the block look up row 0 and come out as zeros, and the
    ``all_reduce`` sums the one rank's row with zeros, exactly. No id below
    the vocabulary reads a padded row."""
    local = tokens - mesh.rank * rows
    hit = (local >= 0) & (local < rows)
    x = (lookup or table.__getitem__)(torch.where(hit, local, torch.zeros_like(local)))
    return mesh.all_reduce(torch.where(hit[..., None], x, torch.zeros_like(x)))


def _embed(params: Params, tokens: torch.Tensor, dtype, mesh=None,
           rows: int = 0) -> torch.Tensor:
    """Embedding rows of ``tokens``. With a mesh the local table holds the
    rank's block of ``rows`` vocabulary entries (and any padding after
    them), looked up by :func:`masked_lookup`."""
    e = params["embed"]
    if mesh is not None:
        return masked_lookup(e, tokens, rows, mesh,
                             lambda ids: _embed(params, ids, dtype))
    if _is_q(e):
        rows = e["q"][tokens].to(dtype)
        return rows * e["s"][tokens][..., None].to(dtype)
    return e[tokens].to(dtype)


def _logits(params: Params, c: LlamaConfig, x: torch.Tensor,
            kernel: bool = False, mesh=None) -> torch.Tensor:
    """f32 logits; with a mesh each rank's block of vocabulary columns (the
    kernel tile's padding cut off), gathered in the activation dtype, then
    cut to the vocabulary (the last block's zero-padding off)."""
    out = _local_logits(params, c, x, kernel)
    if mesh is not None:
        out = mesh.all_gather(out[..., :vocab_rows(c.vocab_size, mesh.world)], -1)
        out = out[..., :c.vocab_size]
    return out.float()


def _local_logits(params: Params, c: LlamaConfig, x: torch.Tensor,
                  kernel: bool = False) -> torch.Tensor:
    if c.tie_embeddings:
        e = params["embed"]
        if _is_q(e):
            if kernel:
                lead = x.shape[:-1]
                out = int8_matmul(x.reshape(-1, x.shape[-1]).contiguous(),
                                  e["q"], e["s"], transpose=True)
                return out.reshape(*lead, out.shape[-1])
            raw = torch.einsum("bsh,vh->bsv", x, e["q"].to(x.dtype))
            return raw * e["s"].to(x.dtype)
        return torch.einsum("bsh,vh->bsv", x, e)
    return _mm(x, params["lm_head"], kernel)


def layer_weights(params: Params, layer: int) -> dict:
    """The ``layer``-th slice of the stacked layer tree (views, no copy)."""
    return {name: ({"q": w["q"][layer], "s": w["s"][layer]} if _is_q(w) else w[layer])
            for name, w in params["layers"].items()}


def layer_slices(params: Params) -> list[dict]:
    """Every layer's weights (:func:`layer_weights` for all layers), cut
    with one ``unbind`` per stacked leaf. Under autograd an unbind's
    backward stacks the per-layer gradients once, where L index views would
    each scatter into a zero tensor of the whole stacked shape."""
    cols = {}
    for name, w in params["layers"].items():
        if _is_q(w):
            cols[name] = [{"q": q, "s": s} for q, s in zip(w["q"].unbind(0), w["s"].unbind(0))]
        else:
            cols[name] = w.unbind(0)
    n = len(next(iter(cols.values())))
    return [{name: col[layer] for name, col in cols.items()} for layer in range(n)]


def _mlp(x: torch.Tensor, w: dict, c: LlamaConfig, kernel: bool = False,
         mesh=None) -> torch.Tensor:
    h = rms_norm(x, w["mlp_norm"], c.rms_norm_eps)
    gate = F.silu(_mm(h, w["w_gate"], kernel).float()).to(c.dtype)
    up = _mm(h, w["w_up"], kernel)
    return x + _psum(_mm(gate * up, w["w_down"], kernel), mesh)


# --- Forward -----------------------------------------------------------------

def transformer_block(
    x: torch.Tensor,
    w: dict,
    cfg: LlamaConfig,
    positions: torch.Tensor,
    attn_impl: str = "auto",
    rope: tuple[torch.Tensor, torch.Tensor] | None = None,
    mesh=None,
    kernel: bool = False,
) -> torch.Tensor:
    """One no-cache decoder block (attention + SwiGLU residual) over
    [B, S, H], ``w`` one layer's weights (:func:`layer_weights`); ``rope``
    optionally the positions' precomputed (cos, sin) tables; ``kernel``
    routes int8 projections through :func:`int8_matmul`, as
    :func:`_mm`."""
    c = cfg
    B, S = x.shape[:2]
    nh, nkv, sel = _heads({"layers": w}, c, mesh.rank if mesh is not None else 0)
    rope = rope or rope_tables(positions, c.head_dim, c.rope_theta)
    h = rms_norm(x, w["attn_norm"], c.rms_norm_eps)
    q = _mm(h, w["wq"], kernel).reshape(B, S, nh, c.head_dim)
    k = _mm(h, w["wk"], kernel).reshape(B, S, nkv, c.head_dim)[:, :, sel]
    v = _mm(h, w["wv"], kernel).reshape(B, S, nkv, c.head_dim)[:, :, sel]
    q = apply_rope(q, positions, c.rope_theta, rope)
    k = apply_rope(k, positions, c.rope_theta, rope)
    attn = gqa_attention(q, k, v, q_positions=positions, kv_positions=positions,
                         impl=attn_impl)
    x = x + _psum(_mm(attn.reshape(B, S, nh * c.head_dim), w["wo"], kernel), mesh)
    return _mlp(x, w, c, kernel, mesh)


def forward(
    params: Params,
    cfg: LlamaConfig,
    tokens: torch.Tensor,
    positions: torch.Tensor,
    cache: KVCache | None = None,
    attn_impl: str = "auto",
    logit_positions: torch.Tensor | None = None,
    remat: bool = False,
    mesh=None,
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
      remat: without a cache, run each block under non-reentrant
        ``torch.utils.checkpoint``: its activations are recomputed in the
        backward instead of kept (training; the reference checkpoints the
        whole forward, with the same numbers).
      mesh: optional ``parallel.mesh.Mesh``: ``params`` is then the rank's
        local tree and ``cache`` holds its kv heads (module docstring).

    Returns:
      (logits [B, S, V] float32 — [B, 1, V] with ``logit_positions`` — and
      the cache, updated in place with new lengths, or None).
    """
    c = cfg
    B, S = tokens.shape
    x = _embed(params, tokens, c.dtype, mesh,               # [B, S, H]
               vocab_rows(c.vocab_size, _world(mesh)))

    if cache is not None and S == 1 and attn_impl in ("auto", "reference"):
        return _decode_forward(params, c, x, positions, cache, B, mesh)

    nh, nkv, sel = _heads(params, c, mesh.rank if mesh is not None else 0)
    offsets = cache.lengths if cache is not None else None
    rope = rope_tables(positions, c.head_dim, c.rope_theta)
    for layer, w in enumerate(layer_slices(params)):
        if cache is None:
            if remat:
                x = torch.utils.checkpoint.checkpoint(
                    transformer_block, x, w, c, positions, attn_impl, rope, mesh,
                    use_reentrant=False)
            else:
                x = transformer_block(x, w, c, positions, attn_impl, rope, mesh)
            continue
        h = rms_norm(x, w["attn_norm"], c.rms_norm_eps)
        q = _mm(h, w["wq"]).reshape(B, S, nh, c.head_dim)
        k = _mm(h, w["wk"]).reshape(B, S, nkv, c.head_dim)
        v = _mm(h, w["wv"]).reshape(B, S, nkv, c.head_dim)
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
        attn = gqa_attention(q, ak[:, :, sel], av[:, :, sel], q_positions=positions,
                             kv_positions=kv_positions, kv_length=offsets + S,
                             impl=attn_impl)
        x = x + _psum(_mm(attn.reshape(B, S, nh * c.head_dim), w["wo"]), mesh)
        x = _mlp(x, w, c, mesh=mesh)

    if cache is not None:
        cache.lengths = cache.lengths + S
    x = rms_norm(x, params["final_norm"], c.rms_norm_eps)
    if logit_positions is not None:
        idx = logit_positions.reshape(B, 1, 1).expand(B, 1, x.shape[-1])
        x = torch.gather(x, 1, idx)
    return _logits(params, c, x, mesh=mesh), cache


# The per-layer matrices' fsdp axis (the hidden width) in one layer's
# slice: the rows of a column-parallel [H, N], the columns of a
# row-parallel [N, H] (``parallel/sharding.py`` ``train_specs``).
_FSDP_DIM = {"wq": 0, "wk": 0, "wv": 0, "w_gate": 0, "w_up": 0, "wo": 1, "w_down": 1}


def gather_layer(w: dict, dims: dict, mesh) -> dict:
    """One layer's local blocks with each fsdp-cut matrix (``dims``: its
    fsdp axis by name) gathered over ``fsdp``; its gradient is
    reduce-scattered back (``parallel/autograd.py``)."""
    from kukeon_tpu_torch.parallel import autograd as pa

    return {name: pa.fsdp_gather(t, dims[name], mesh) if name in dims else t
            for name, t in w.items()}


def seq_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, positions: torch.Tensor,
                  attn_impl: str, mesh) -> torch.Tensor:
    """A training rank's attention of its queries (its block of the
    sequence on ``seq``, ``positions`` their absolute positions) over the
    whole sequence: ``ring`` and ``ulysses`` through their collectives;
    any other ``attn_impl`` over the keys, values and positions of every
    seq peer gathered here (the keys' and values' gradients
    reduce-scattered back), as the reference's GSPMD attends a seq-cut
    batch without ring attention: ``auto`` dispatches on the whole
    sequence's length, so where the reference's global arrays reach the
    flash kernel, the rank's block of queries does too. On a mesh whose
    ``seq`` is 1 it is ``gqa_attention`` over the rank's own keys."""
    from kukeon_tpu_torch.parallel import autograd as pa
    from kukeon_tpu_torch.parallel.mesh import AXIS_SEQ

    kv_positions, whole_len = positions, None
    if attn_impl not in ("ring", "ulysses") and mesh.seq > 1:
        k, v = pa.gather(k, 1, mesh, AXIS_SEQ), pa.gather(v, 1, mesh, AXIS_SEQ)
        kv_positions = mesh.gather(positions, 1, AXIS_SEQ)
        whole_len = k.shape[1]
    return gqa_attention(q, k, v, q_positions=positions, kv_positions=kv_positions,
                         impl=attn_impl, mesh=mesh, whole_len=whole_len)


def train_attention(x: torch.Tensor, w: dict, cfg, positions: torch.Tensor, attn_impl: str,
                    rope: tuple[torch.Tensor, torch.Tensor], mesh) -> torch.Tensor:
    """The attention half of a block on a training mesh, ``w`` one layer's
    gathered weights: ``x`` plus the attention of the rank's heads
    (:func:`seq_attention`: over every seq peer's keys), its input
    copied to ``tensor`` and its row-parallel partial summed over it. The
    trunk of both families' training blocks; ``positions`` and ``rope``
    are the rank's tokens' absolute positions and their tables."""
    from kukeon_tpu_torch.parallel import autograd as pa

    c = cfg
    B, S = x.shape[:2]
    nh, nkv, sel = _heads({"layers": w}, c, mesh.rank)
    h = pa.copy_to_tensor(rms_norm(x, w["attn_norm"], c.rms_norm_eps), mesh)
    q = (h @ w["wq"]).reshape(B, S, nh, c.head_dim)
    k = (h @ w["wk"]).reshape(B, S, nkv, c.head_dim)[:, :, sel]
    v = (h @ w["wv"]).reshape(B, S, nkv, c.head_dim)[:, :, sel]
    q = apply_rope(q, positions, c.rope_theta, rope)
    k = apply_rope(k, positions, c.rope_theta, rope)
    attn = seq_attention(q, k, v, positions, attn_impl, mesh)
    return x + pa.reduce_from_tensor(attn.reshape(B, S, nh * c.head_dim) @ w["wo"], mesh)


def train_block(x: torch.Tensor, w: dict, cfg: LlamaConfig, positions: torch.Tensor,
                attn_impl: str, rope: tuple[torch.Tensor, torch.Tensor], mesh) -> torch.Tensor:
    """:func:`transformer_block` on a training mesh, under autograd: ``w``
    one layer's local blocks, each fsdp-cut matrix gathered over ``fsdp``
    here (inside the block that remat wraps, so the backward gathers it
    again and a rank holds one gathered layer at a time), the attention
    and MLP inputs copied to ``tensor`` and their row-parallel partials
    summed over it (``parallel/autograd.py``). At one rank it is
    :func:`transformer_block`, op for op."""
    from kukeon_tpu_torch.parallel import autograd as pa

    c = cfg
    w = gather_layer(w, _FSDP_DIM, mesh)
    x = train_attention(x, w, c, positions, attn_impl, rope, mesh)
    h = pa.copy_to_tensor(rms_norm(x, w["mlp_norm"], c.rms_norm_eps), mesh)
    gate = F.silu((h @ w["w_gate"]).float()).to(c.dtype)
    up = h @ w["w_up"]
    return x + pa.reduce_from_tensor((gate * up) @ w["w_down"], mesh)


def train_embed(params: Params, cfg, tokens: torch.Tensor, mesh) -> torch.Tensor:
    """The embedding rows of a training rank's ``tokens``: the table
    gathered over ``fsdp``, looked up in the rank's vocabulary block and
    summed over ``tensor``."""
    from kukeon_tpu_torch.parallel import autograd as pa

    return pa.masked_lookup(pa.fsdp_gather(params["embed"], 1, mesh), tokens,
                            mesh).to(cfg.dtype)


def train_logits(params: Params, cfg, x: torch.Tensor, mesh) -> torch.Tensor:
    """The final norm and the LM head of a training rank -> f32 logits over
    the whole vocabulary, gathered over ``tensor`` (a tied head the
    embedding, gathered over ``fsdp`` again)."""
    from kukeon_tpu_torch.parallel import autograd as pa

    x = pa.copy_to_tensor(rms_norm(x, params["final_norm"], cfg.rms_norm_eps), mesh)
    if cfg.tie_embeddings:
        logits = torch.einsum("bsh,vh->bsv", x, pa.fsdp_gather(params["embed"], 1, mesh))
    else:
        logits = x @ pa.fsdp_gather(params["lm_head"], 0, mesh)
    return pa.gather_from_tensor(logits, -1, mesh).float()


def forward_train(params: Params, cfg: LlamaConfig, tokens: torch.Tensor,
                  positions: torch.Tensor, mesh, *, remat: bool = True,
                  attn_impl: str = "auto") -> torch.Tensor:
    """The cacheless forward of a training mesh's rank (``mesh``, a
    ``parallel.mesh.Mesh``; ``params`` its local blocks,
    ``parallel/sharding.py`` ``TrainLayout``; ``tokens`` its batch rows,
    and on a ``seq`` axis its block of their columns; ``positions`` their
    absolute positions), under autograd -> logits [B, S, V] f32, the whole
    vocabulary on every tensor peer. The embedding is gathered over
    ``fsdp`` for the lookup and again for a tied LM head; each block is
    :func:`train_block`, under non-reentrant remat when ``remat`` (the
    backward recomputes a block's collectives, the ring's hops among them,
    in the forward's order on every rank); ``attn_impl`` as
    :func:`seq_attention` takes it (``ring`` the reference's step at
    ``seq`` > 1). Each rank's rope reads its own absolute positions. At
    one rank it is :func:`forward` without a cache, op for op."""
    c = cfg
    x = train_embed(params, c, tokens, mesh)
    rope = rope_tables(positions, c.head_dim, c.rope_theta)
    for w in layer_slices(params):
        if remat:
            x = torch.utils.checkpoint.checkpoint(
                train_block, x, w, c, positions, attn_impl, rope, mesh, use_reentrant=False)
        else:
            x = train_block(x, w, c, positions, attn_impl, rope, mesh)
    return train_logits(params, c, x, mesh)


def _decode_forward(
    params: Params,
    c: LlamaConfig,
    x: torch.Tensor,
    positions: torch.Tensor,
    cache: KVCache,
    B: int,
    mesh=None,
) -> tuple[torch.Tensor, KVCache]:
    """Single-token decode: every layer reads its cache slice read-only
    (append-free attention scores the new token separately); the new K/V of
    all layers are written once at the end, one row per slot, in place.
    With ``cfg.int8_pallas`` the projections and the LM head go through
    :func:`int8_matmul` — at 8B, 7 x 32 + 1 = 225 kernel launches a step,
    at every rank's shard shapes under a mesh."""
    offsets = cache.lengths
    kern = c.int8_pallas
    nh, nkv, sel = _heads(params, c, mesh.rank if mesh is not None else 0)
    rope = rope_tables(positions, c.head_dim, c.rope_theta)
    new_k, new_v = [], []
    for layer in range(c.num_layers):
        w = layer_weights(params, layer)
        h = rms_norm(x, w["attn_norm"], c.rms_norm_eps)
        q = _mm(h, w["wq"], kern).reshape(B, 1, nh, c.head_dim)
        k = _mm(h, w["wk"], kern).reshape(B, 1, nkv, c.head_dim)
        v = _mm(h, w["wv"], kern).reshape(B, 1, nkv, c.head_dim)
        q = apply_rope(q, positions, c.rope_theta, rope)
        k = apply_rope(k, positions, c.rope_theta, rope)
        attn = decode_gqa_attention(
            q, k[:, :, sel], v[:, :, sel], cache.k[layer][:, :, sel],
            cache.v[layer][:, :, sel], offsets,
            k_scale=cache.k_scale[layer][:, :, sel] if cache.quantized else None,
            v_scale=cache.v_scale[layer][:, :, sel] if cache.quantized else None)
        x = x + _psum(_mm(attn.reshape(B, 1, nh * c.head_dim), w["wo"], kern), mesh)
        x = _mlp(x, w, c, kern, mesh)
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
    return _logits(params, c, x, kern, mesh), cache
