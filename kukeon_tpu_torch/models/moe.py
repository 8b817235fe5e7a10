"""Mixtral-style sparse Mixture-of-Experts decoder, the port of
``kukeon_tpu/models/moe.py``.

The same attention trunk as :mod:`kukeon_tpu_torch.models.llama` (GQA,
RoPE, RMSNorm, the shared :class:`~kukeon_tpu_torch.models.llama.KVCache`
layout); a sparse-MoE SwiGLU replaces the dense MLP. Plain functions on
tensors over the reference's stacked tree (``[L, ...]`` layers, experts on
axis 1 of the expert stacks, int8 matrices as ``{"q", "s"}`` leaves), so a
reference tree converted by :func:`kukeon_tpu_torch.models.convert.params_from_numpy`
runs unchanged. The reference's ``lax.scan`` over layers is a Python loop;
cache writes happen in place, as in the port's ``llama.forward``.

Dense dispatch (GShard/Switch), as the reference: top-k routing, a
static-capacity one-hot dispatch tensor, and two einsums around batched
per-expert products. Every expert runs on every capacity slot, empty ones
included. Overflow tokens (training capacity) fall through the residual.
At decode, with ``cfg.int8_pallas``, int8 expert stacks go through
:func:`~kukeon_tpu_torch.ops.int8_matmul.int8_matmul_expert` (the CUDA
kernel, all experts in one launch) and the trunk through ``int8_matmul``.

**Tensor parallelism** (``mesh=``, a ``parallel.mesh.Mesh``; the
reference's ``moe_specs_for_params`` on ``serving_mesh``): the forward
runs on one rank's local tree (``parallel/sharding.py``): the attention
trunk cut as Llama's, every expert's ``w_gate``/``w_up`` columns and
``w_down`` rows, the router whole. The head counts come from the local
shapes; the collectives are Llama's (a masked embedding lookup, one
``all_reduce`` after ``wo``, an ``all_gather`` of the logits) plus one
``all_reduce`` a MoE block, after the combine einsum: the rank's partial
``[N, H]`` (E times fewer bytes than ``ye`` ``[E, C, H]``), in the
activation dtype, as the row-parallel contract has it. The router runs on
the replicated activations, so every rank routes the same tokens to the
same experts.

Training (the reference's ``forward_with_aux`` under ``jax.value_and_grad``)
runs the no-cache path, with ``remat=True`` each block under non-reentrant
``torch.utils.checkpoint``; the block returns its aux losses beside its
output, so their gradients reach the router through the recompute.

**Training on a mesh** (:func:`forward_train`, a ``data`` x ``fsdp`` x
``expert`` x ``seq`` x ``tensor`` rank group; the reference's
``make_moe_train_step`` on ``make_mesh(data=, fsdp=, expert=, seq=,
tensor=)``): the reference's batch spec ``P((data, fsdp), seq)`` cuts the
rows over data x fsdp and the positions over seq only, so the expert
peers of a batch rank see the same tokens and compute the same trunk, and
only the expert stacks ``[L, E, ...]`` are cut on ``expert``. The
dispatch is therefore local and no all-to-all is needed: each rank runs
its ``E / expert`` experts over its tokens, and the MoE block's partial
``[N, H]`` is summed once over expert x tensor (:func:`train_moe_block`).
What the reference computes over the global batch stays global: the
capacity counts the global tokens, each assignment's slot is its place in
the global (K, N) order (one all-gather of every batch rank's ``[K, B,
E]`` counts, one a row: on a ``seq`` axis the ranks' tokens interleave row
by row), and the load-balance ``f`` and ``p`` and the z-loss are global
means. On ``seq`` the trunk attends over every key
(``llama.train_attention``).
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F

from kukeon_tpu_torch.models import llama
from kukeon_tpu_torch.models.llama import (
    KVCache,
    _cache_insert,
    _embed,
    _heads,
    _mm,
    _psum,
    _world,
    vocab_rows,
)
from kukeon_tpu_torch.ops.attention import decode_gqa_attention, gqa_attention
from kukeon_tpu_torch.ops.int8_matmul import int8_matmul_expert
from kukeon_tpu_torch.ops.norms import rms_norm
from kukeon_tpu_torch.ops.rope import apply_rope, rope_tables
from kukeon_tpu_torch.parallel.mesh import AXIS_BATCH, AXIS_EXPERT_TENSOR

Params = dict[str, Any]


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    vocab_size: int = 32000
    hidden_size: int = 4096
    intermediate_size: int = 14336
    num_layers: int = 32
    num_heads: int = 32
    num_kv_heads: int = 8
    head_dim: int = 128
    num_experts: int = 8
    experts_per_token: int = 2
    capacity_factor: float = 2.0
    rope_theta: float = 1_000_000.0
    rms_norm_eps: float = 1e-5
    max_seq_len: int = 8192
    tie_embeddings: bool = False
    dtype: torch.dtype = torch.bfloat16
    router_z_coef: float = 1e-3
    load_balance_coef: float = 1e-2
    # Route int8 decode products (trunk through int8_matmul, expert stacks
    # through int8_matmul_expert) through the CUDA kernels. The serving
    # engine turns it on for int8 weights on a CUDA device. Prefill keeps
    # the dequant products.
    int8_pallas: bool = False

    @property
    def q_dim(self) -> int:
        return self.num_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.num_kv_heads * self.head_dim

    def param_count(self) -> int:
        H, I, E = self.hidden_size, self.intermediate_size, self.num_experts
        embed = self.vocab_size * H
        attn = H * (self.q_dim + 2 * self.kv_dim) + self.q_dim * H
        experts = 3 * E * H * I + H * E            # w_gate, w_up, w_down, router
        norms = 2 * H
        head = 0 if self.tie_embeddings else embed
        return embed + self.num_layers * (attn + experts + norms) + H + head


def mixtral_8x7b() -> MoEConfig:
    """Mixtral-8x7B shapes (public architecture)."""
    return MoEConfig()


def moe_tiny() -> MoEConfig:
    """Test-size config: fast on a CPU; 4 experts."""
    return MoEConfig(
        vocab_size=512, hidden_size=64, intermediate_size=128,
        num_layers=2, num_heads=4, num_kv_heads=2, head_dim=16,
        num_experts=4, experts_per_token=2, capacity_factor=8.0,
        rope_theta=10_000.0, max_seq_len=256, dtype=torch.float32,
        tie_embeddings=True,
    )


def init_params(cfg: MoEConfig, generator: torch.Generator,
                device: torch.device | str) -> Params:
    """Random full-precision parameters in the reference layout:
      embed [V, H]; layers: attn_norm/mlp_norm [L, H], wq [L, H, NH*D],
      wk/wv [L, H, KV*D], wo [L, NH*D, H], router [L, H, E] (f32),
      w_gate/w_up [L, E, H, I], w_down [L, E, I, H]; final_norm [H];
      lm_head [H, V] (absent when tie_embeddings).
    The draws differ from the reference's (torch's generator, not jax's);
    parity tests convert the reference's tree instead."""
    return llama.nest(iter_params(cfg, generator, device))


def iter_params(cfg: MoEConfig, generator: torch.Generator, device: torch.device | str):
    """:func:`init_params`' leaves as ``(path, tensor)`` pairs, each drawn
    when it is yielded (the same draws, in the same order), so a caller
    can keep a slice of each and free the rest before the next."""
    c = cfg

    def normal(shape, fan_in):
        # Scaled in place: one f32 leaf at a time on the device (an expert
        # stack of Mixtral-8x7B at 16 layers is 30 GB in f32).
        w = torch.randn(shape, generator=generator, dtype=torch.float32, device=device)
        return w.mul_(fan_in ** -0.5)

    def dense(shape, fan_in):
        return normal(shape, fan_in).to(c.dtype)

    L, H, I, V, E = (c.num_layers, c.hidden_size, c.intermediate_size,
                     c.vocab_size, c.num_experts)
    ones = lambda *shape: torch.ones(shape, dtype=c.dtype, device=device)  # noqa: E731
    yield ("embed",), dense((V, H), H)
    yield ("layers", "attn_norm"), ones(L, H)
    yield ("layers", "wq"), dense((L, H, c.q_dim), H)
    yield ("layers", "wk"), dense((L, H, c.kv_dim), H)
    yield ("layers", "wv"), dense((L, H, c.kv_dim), H)
    yield ("layers", "wo"), dense((L, c.q_dim, H), c.q_dim)
    yield ("layers", "mlp_norm"), ones(L, H)
    # f32: routing decisions must not wobble with the activation dtype.
    yield ("layers", "router"), normal((L, H, E), H)
    yield ("layers", "w_gate"), dense((L, E, H, I), H)
    yield ("layers", "w_up"), dense((L, E, H, I), H)
    yield ("layers", "w_down"), dense((L, E, I, H), I)
    yield ("final_norm",), ones(H)
    if not c.tie_embeddings:
        yield ("lm_head",), dense((H, V), H)


def quantize_params(params: Params) -> Params:
    """Full-precision MoE tree -> int8 ({"q", "s"} leaves for every dense
    matrix, by :func:`quantize_leaf`). Attention and embedding quantize as
    in the Llama tree; expert stacks [L, E, in, out] per output channel
    along the contraction axis (s: [L, E, out]). The router stays f32."""
    out: Params = {"embed": quantize_leaf(("embed",), params["embed"]),
                   "layers": {n: quantize_leaf(("layers", n), w)
                              for n, w in params["layers"].items()},
                   "final_norm": params["final_norm"]}
    if "lm_head" in params:
        out["lm_head"] = quantize_leaf(("lm_head",), params["lm_head"])
    return out


def quantize_leaf(path: tuple[str, ...], w: torch.Tensor):
    """:func:`quantize_params` of one leaf at ``path``: norms and the router
    as they are, the trunk's matrices as Llama's, an expert stack
    ``[L, E, K, N]`` per output column, one ``[K, N]`` matrix at a time
    (the f32 transient one matrix, not the stack; the same bits)."""
    if path[-1] == "router":
        return w
    if w.ndim < 4:
        return llama.quantize_leaf(path, w)
    q = torch.empty(w.shape, dtype=torch.int8, device=w.device)
    s = torch.empty((*w.shape[:2], w.shape[3]), dtype=torch.float32, device=w.device)
    for idx in np.ndindex(*w.shape[:2]):
        qw, sw = llama._int8_sym(w[idx], 0)
        q[idx], s[idx] = qw, sw.squeeze(0)
    return {"q": q, "s": s}


def init_quantized_params_host(cfg: MoEConfig, seed: int = 0) -> Params:
    """Random-init directly in int8 on the host (numpy), leaf by leaf: the
    same draws, order and recipe as the reference's function of this name,
    so the two packages get identical trees from one seed. Norms come as
    float32 (``params_from_numpy(dtype=...)`` casts them)."""
    c = cfg
    rng = np.random.default_rng(seed)
    L, H, I, V, E = (c.num_layers, c.hidden_size, c.intermediate_size,
                     c.vocab_size, c.num_experts)
    ndtype = np.float32

    def q(shape, fan_in, axis):
        w = rng.standard_normal(shape, np.float32) * (fan_in ** -0.5)
        return llama.quantize_np(w, axis)

    params: Params = {
        "embed": q((V, H), H, 1),
        "layers": {
            "attn_norm": np.ones((L, H), ndtype),
            "wq": q((L, H, c.q_dim), H, 1),
            "wk": q((L, H, c.kv_dim), H, 1),
            "wv": q((L, H, c.kv_dim), H, 1),
            "wo": q((L, c.q_dim, H), c.q_dim, 1),
            "mlp_norm": np.ones((L, H), ndtype),
            "router": rng.standard_normal((L, H, E), np.float32) * (H ** -0.5),
            "w_gate": q((L, E, H, I), H, 2),
            "w_up": q((L, E, H, I), H, 2),
            "w_down": q((L, E, I, H), I, 2),
        },
        "final_norm": np.ones((H,), ndtype),
    }
    if not c.tie_embeddings:
        params["lm_head"] = q((H, V), H, 0)
    return params


def _expert_mm(x: torch.Tensor, w, eq: str, kernel: bool = False) -> torch.Tensor:
    """Per-expert batched product ('ech,ehi->eci' or 'eci,eih->ech') for
    plain or int8 ({"q","s"}) expert stacks. ``kernel=True`` routes int8
    stacks through :func:`int8_matmul_expert` (both equations are
    x [E, C, K] @ w [E, K, N]); otherwise dequant, product, scale in
    ``x.dtype``, as the reference's einsum path."""
    if llama._is_q(w):
        if kernel:
            return int8_matmul_expert(x.contiguous(), w["q"], w["s"])
        raw = torch.einsum(eq, x, w["q"].to(x.dtype))
        return raw * w["s"][:, None, :].to(x.dtype)
    return torch.einsum(eq, x, w)


def _capacity(cfg: MoEConfig, n_tokens: int, inference: bool = False) -> int:
    """Per-expert token capacity. Training: the GShard drop policy
    (capacity_factor x fair share). Inference: full capacity (C = N) for
    decode-sized batches, and twice the training buffer for prefill."""
    E, K = cfg.num_experts, cfg.experts_per_token
    if inference:
        if n_tokens <= 64:
            return n_tokens
        factor = max(cfg.capacity_factor, 2.0) * 2.0
        return min(n_tokens, max(int(factor * n_tokens * K / E), K))
    cap = int(cfg.capacity_factor * n_tokens * K / E)
    return max(cap, K)


# Where a forward records each MoE block's expert choices (``record_routes``).
_route_log: list | None = None


@contextlib.contextmanager
def record_routes():
    """Within the block, every :func:`moe_block` appends its ``[N, K]``
    expert choices to the list this yields (a test seam: which experts a
    rank routed each token to, layer by layer)."""
    global _route_log
    prev, _route_log = _route_log, []
    try:
        yield _route_log
    finally:
        _route_log = prev


def _route(x: torch.Tensor, w: dict, cfg: MoEConfig):
    """Top-k routing of the tokens ``x`` [N, H] -> (router logits [N, E],
    probabilities [N, E], normalized gate values [N, K], the choices'
    one-hot mask [K, N, E]), all f32."""
    E, K = cfg.num_experts, cfg.experts_per_token
    router_logits = x.float() @ w["router"]                          # [N, E]
    probs = torch.softmax(router_logits, dim=-1)
    gate_vals, expert_idx = torch.topk(probs, K, dim=-1, sorted=True)   # [N, K]
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(dim=-1, keepdim=True), min=1e-9)
    if _route_log is not None:
        _route_log.append(expert_idx)
    return router_logits, probs, gate_vals, F.one_hot(expert_idx.T, E).float()


def _dispatch(mask: torch.Tensor, C: int, offset: torch.Tensor | None = None) -> torch.Tensor:
    """The one-hot dispatch [N, E, C] of the choices ``mask`` [K, N, E]:
    priority dispatch, choice 0 of every token before choice 1 (GShard),
    through a cumulative count over the flattened (K, N) order. Where the
    N tokens are a rank's part of a larger batch, filling B rows of it,
    ``offset`` [K, B, E] holds for each row the assignments that the larger
    batch's order puts before the row's choice-k ones
    (:func:`_row_offsets`), and the cumulative count runs within each row.
    A slot at or past ``C`` is dropped."""
    K, N, E = mask.shape
    flat = mask.reshape(K * N, E)
    if offset is None:
        pos = torch.cumsum(flat, dim=0) - flat                       # tokens ahead
    else:
        rows = mask.reshape(K, offset.shape[1], -1, E)
        pos = (torch.cumsum(rows, dim=2) - rows + offset[:, :, None, :]).reshape(K * N, E)
    keep = (pos < C).float() * flat                                  # drop overflow
    # One-hot of each slot; a position >= C (dropped) is an all-zero row,
    # as jax.nn.one_hot gives (F.one_hot would raise).
    slot = (pos.long()[..., None] == torch.arange(C, device=mask.device)).float()
    return (keep[..., None] * slot).reshape(K, N, E, C).sum(dim=0)


def _experts(xe: torch.Tensor, w: dict, cfg: MoEConfig, kernel: bool = False) -> torch.Tensor:
    """Every expert's SwiGLU over its capacity slots: [E, C, H] -> [E, C, H]."""
    gate = F.silu(_expert_mm(xe, w["w_gate"], "ech,ehi->eci", kernel).float()).to(cfg.dtype)
    up = _expert_mm(xe, w["w_up"], "ech,ehi->eci", kernel)
    return _expert_mm(gate * up, w["w_down"], "eci,eih->ech", kernel)


def moe_block(h: torch.Tensor, w: dict, cfg: MoEConfig, inference: bool = False,
              kernel: bool = False, mesh=None) -> tuple[torch.Tensor, dict]:
    """Sparse-MoE SwiGLU over [B, S, H] -> ([B, S, H], aux losses), ``w``
    one layer's weights. Router, softmax and aux losses in f32. With a
    mesh ``w`` holds the rank's slice of every expert, and the combined
    partial is summed over the ranks (the module docstring)."""
    c = cfg
    B, S, H = h.shape
    N = B * S
    C = _capacity(c, N, inference)
    x = h.reshape(N, H)
    router_logits, probs, gate_vals, mask = _route(x, w, c)
    dispatch = _dispatch(mask, C)                                    # [N, E, C]
    combine = dispatch * (mask * gate_vals.T[..., None]).sum(dim=0)[..., None]

    xe = torch.einsum("nec,nh->ech", dispatch, x.float()).to(c.dtype)   # [E, C, H]
    ye = _experts(xe, w, c, kernel)                                      # [E, C, H]
    y = _psum(torch.einsum("nec,ech->nh", combine.to(c.dtype), ye), mesh)

    # Switch load balance over first choices, and the router z-loss.
    f = mask[0].mean(dim=0)
    p = probs.mean(dim=0)
    lb = c.num_experts * torch.sum(f * p)
    z = torch.mean(torch.logsumexp(router_logits, dim=-1) ** 2)
    return y.reshape(B, S, H), {"load_balance": lb, "router_z": z}


def _row_offsets(mask: torch.Tensor, mesh, rows: int) -> torch.Tensor | None:
    """[K, B, E]: for each of this batch rank's ``rows`` rows, the
    assignments to each expert that the global batch's (K, N) order puts
    before its choice-k ones in that row: every choice k' < k of the
    global batch, the choice-k ones of every earlier global row on all seq
    peers, and those of the same row on the seq ranks before this one (on
    a ``seq`` axis a rank's tokens are a block of positions of each of its
    rows, and its seq peers' blocks interleave with its own row by row; at
    ``seq`` 1 a rank's rows are whole). One all-gather of each rank's
    per-row ``[K, B, E]`` counts over ``batch``, whose ranks come in
    ``AXES`` order (data, fsdp, seq: a row block's seq ranks in turn); the
    rank's row block is ``replica * fsdp + fsdp_rank`` of them
    (``data.rank_rows``) and its place within it ``seq_rank``
    (``data.rank_cols``). The rank's own earlier positions of a row are its
    cumulative count's (:func:`_dispatch`). The counts are whole numbers
    far below 2^24, so every sum is exact in f32 and the slots are the
    one-device dispatch's. None at one batch rank."""
    if mesh.axis_size(AXIS_BATCH) == 1:
        return None
    K, N, E = mask.shape
    seq = mesh.seq
    counts = mask.reshape(K, rows, N // rows, E).sum(dim=2)          # [K, B, E]
    every = mesh.gather(counts[None], 0, AXIS_BATCH)                 # [ranks, K, B, E]
    every = every.reshape(-1, seq, K, rows, E)                       # [row blocks, seq, ...]
    total = every.sum(dim=(0, 1, 3))                                 # [K, E]
    by_row = every.sum(dim=1).permute(1, 0, 2, 3).reshape(K, -1, E)  # [K, global rows, E]
    earlier_rows = torch.cumsum(by_row, dim=1) - by_row
    block = mesh.replica * mesh.fsdp + mesh.fsdp_rank
    return ((torch.cumsum(total, dim=0) - total)[:, None, :]
            + earlier_rows[:, block * rows:(block + 1) * rows]
            + every[block, :mesh.seq_rank].sum(dim=0))


def _batch_mean(t: torch.Tensor, n: int, mesh) -> torch.Tensor:
    """The mean over the global batch's ``n`` tokens of ``t`` [N, ...]
    (this rank's), the same on every rank; its gradient reaches only this
    rank's tokens (``autograd.reduce_from`` over ``batch``)."""
    from kukeon_tpu_torch.parallel import autograd as pa

    if mesh.axis_size(AXIS_BATCH) == 1:
        return t.mean(dim=0)
    return pa.reduce_from(t.sum(dim=0), mesh, AXIS_BATCH) / n


def train_moe_block(h: torch.Tensor, w: dict, cfg: MoEConfig, mesh) -> tuple[torch.Tensor, dict]:
    """:func:`moe_block` of a training mesh's rank over its batch rows
    ``h`` [B, S, H] (on a ``seq`` axis, its block of S positions of each
    row), under autograd, with the global batch's semantics (the
    reference's GSPMD over global arrays): the capacity of the global
    token count, each slot where the global (K, N) order puts it
    (:func:`_row_offsets`), and ``f``, ``p`` and the z-loss as global
    means (:func:`_batch_mean`). The router runs on the replicated
    activations; the rank runs its ``E / expert`` experts ``w`` (their
    ``tensor`` columns) over every capacity slot, its own tokens' filled,
    and its partial ``[N, H]`` is summed once over ``expert_tensor``. The
    expert input and the gate weights enter through ``autograd.copy_to`` over
    that group, so every expert and tensor peer ends with the whole router
    and trunk gradient of its rows. At one rank it is :func:`moe_block`,
    op for op."""
    from kukeon_tpu_torch.parallel import autograd as pa

    c = cfg
    B, S, H = h.shape
    N = B * S
    n = N * mesh.axis_size(AXIS_BATCH)
    C = _capacity(c, n)
    x = h.reshape(N, H)
    router_logits, probs, gate_vals, mask = _route(x, w, c)
    dispatch = _dispatch(mask, C, _row_offsets(mask, mesh, B))      # [N, E, C]
    gates = pa.copy_to((mask * gate_vals.T[..., None]).sum(dim=0), mesh, AXIS_EXPERT_TENSOR)
    if mesh.expert > 1:
        local = c.num_experts // mesh.expert
        lo = mesh.expert_rank * local
        dispatch, gates = dispatch[:, lo:lo + local], gates[:, lo:lo + local]
    combine = dispatch * gates[..., None]

    xe = torch.einsum("nec,nh->ech", dispatch,
                      pa.copy_to(x, mesh, AXIS_EXPERT_TENSOR).float()).to(c.dtype)
    ye = _experts(xe, w, c)
    y = pa.reduce_from(torch.einsum("nec,ech->nh", combine.to(c.dtype), ye), mesh,
                       AXIS_EXPERT_TENSOR)

    f = _batch_mean(mask[0], n, mesh)
    p = _batch_mean(probs, n, mesh)
    lb = c.num_experts * torch.sum(f * p)
    z = _batch_mean(torch.logsumexp(router_logits, dim=-1) ** 2, n, mesh)
    return y.reshape(B, S, H), {"load_balance": lb, "router_z": z}


def _decode_forward(params: Params, c: MoEConfig, x: torch.Tensor,
                    positions: torch.Tensor, cache: KVCache,
                    B: int, mesh=None) -> tuple[torch.Tensor, KVCache]:
    """Single-token decode (the port's ``llama._decode_forward`` with the
    MoE block): caches read-only per layer, the new K/V of every layer
    written once at the end, in place. The MoE block runs at N = B tokens
    with full capacity. With ``cfg.int8_pallas`` every quantized product
    goes through a kernel: at Mixtral-8x7B, 4 x 32 + 1 = 129 int8_matmul
    and 3 x 32 = 96 int8_matmul_expert launches a step, at every rank's
    shard shapes under a mesh."""
    offsets = cache.lengths
    kern = c.int8_pallas
    nh, nkv, sel = _heads(params, c, mesh.rank if mesh is not None else 0)
    rope = rope_tables(positions, c.head_dim, c.rope_theta)
    new_k, new_v = [], []
    for layer in range(c.num_layers):
        w = llama.layer_weights(params, layer)
        h = rms_norm(x, w["attn_norm"], c.rms_norm_eps)
        q = _mm(h, w["wq"], kern).reshape(B, 1, nh, c.head_dim)
        k = _mm(h, w["wk"], kern).reshape(B, 1, nkv, c.head_dim)
        v = _mm(h, w["wv"], kern).reshape(B, 1, nkv, c.head_dim)
        q = apply_rope(q, positions, c.rope_theta, rope)
        k = apply_rope(k, positions, c.rope_theta, rope)
        attn = decode_gqa_attention(q, k[:, :, sel], v[:, :, sel], cache.k[layer][:, :, sel],
                                    cache.v[layer][:, :, sel], offsets)
        x = x + _psum(_mm(attn.reshape(B, 1, nh * c.head_dim), w["wo"], kern), mesh)
        h = rms_norm(x, w["mlp_norm"], c.rms_norm_eps)
        y, _ = moe_block(h, w, c, inference=True, kernel=kern, mesh=mesh)
        x = x + y
        new_k.append(k)
        new_v.append(v)

    rows = torch.arange(B, device=x.device)
    pos = torch.clamp(offsets, max=cache.max_len - 1)
    cache.k[:, rows, pos] = torch.stack(new_k)[:, :, 0].to(cache.k.dtype)
    cache.v[:, rows, pos] = torch.stack(new_v)[:, :, 0].to(cache.v.dtype)
    cache.lengths = cache.lengths + 1

    x = rms_norm(x, params["final_norm"], c.rms_norm_eps)
    return llama._logits(params, c, x, kern, mesh), cache


def moe_transformer_block(
    x: torch.Tensor,
    w: dict,
    cfg: MoEConfig,
    positions: torch.Tensor,
    attn_impl: str,
    rope: tuple[torch.Tensor, torch.Tensor],
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One no-cache MoE block over [B, S, H] with the training capacity:
    (output, load balance, router z), the unit that ``remat`` recomputes."""
    c = cfg
    B, S = x.shape[:2]
    h = rms_norm(x, w["attn_norm"], c.rms_norm_eps)
    q = _mm(h, w["wq"]).reshape(B, S, c.num_heads, c.head_dim)
    k = _mm(h, w["wk"]).reshape(B, S, c.num_kv_heads, c.head_dim)
    v = _mm(h, w["wv"]).reshape(B, S, c.num_kv_heads, c.head_dim)
    q = apply_rope(q, positions, c.rope_theta, rope)
    k = apply_rope(k, positions, c.rope_theta, rope)
    attn = gqa_attention(q, k, v, q_positions=positions, kv_positions=positions,
                         impl=attn_impl)
    x = x + _mm(attn.reshape(B, S, c.q_dim), w["wo"])
    h = rms_norm(x, w["mlp_norm"], c.rms_norm_eps)
    y, aux = moe_block(h, w, c)
    return x + y, aux["load_balance"], aux["router_z"]


# One layer's fsdp-cut matrices, by their fsdp axis (the hidden width): the
# trunk's as Llama's, the expert stacks' [E, H, I] rows and [E, I, H]
# columns (``parallel/sharding.py`` ``train_specs``).
_FSDP_DIM = {**llama._FSDP_DIM, "w_gate": 1, "w_up": 1, "w_down": 2}


def train_block(x: torch.Tensor, w: dict, cfg: MoEConfig, positions: torch.Tensor,
                attn_impl: str, rope: tuple[torch.Tensor, torch.Tensor], mesh
                ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """:func:`moe_transformer_block` on a training mesh, under autograd:
    ``w`` one layer's local blocks, gathered over ``fsdp`` inside the block
    that remat wraps; the attention trunk is Llama's
    (``llama.train_attention``), the MoE block :func:`train_moe_block`. At
    one rank it is :func:`moe_transformer_block`, op for op."""
    c = cfg
    w = llama.gather_layer(w, _FSDP_DIM, mesh)
    x = llama.train_attention(x, w, c, positions, attn_impl, rope, mesh)
    h = rms_norm(x, w["mlp_norm"], c.rms_norm_eps)
    y, aux = train_moe_block(h, w, c, mesh)
    return x + y, aux["load_balance"], aux["router_z"]


def forward_train(params: Params, cfg: MoEConfig, tokens: torch.Tensor,
                  positions: torch.Tensor, mesh, *, remat: bool = True,
                  attn_impl: str = "auto") -> tuple[torch.Tensor, dict]:
    """The cacheless forward of a training mesh's rank (``params`` its
    local blocks, ``parallel/sharding.py`` ``TrainLayout``; ``tokens`` its
    batch rows), under autograd -> (logits [B, S, V] f32, the whole
    vocabulary on every tensor peer; the aux losses averaged over layers,
    each the global batch's, the same on every rank). The embedding and
    the LM head are Llama's (``llama.train_embed``, ``llama.train_logits``);
    each block is :func:`train_block`, under non-reentrant remat when
    ``remat``. At one rank it is :func:`forward_with_aux` without a cache,
    op for op."""
    c = cfg
    x = llama.train_embed(params, c, tokens, mesh)
    rope = rope_tables(positions, c.head_dim, c.rope_theta)
    lb_sum = torch.zeros((), dtype=torch.float32, device=x.device)
    z_sum = torch.zeros((), dtype=torch.float32, device=x.device)
    for w in llama.layer_slices(params):
        if remat:
            x, lb, z = torch.utils.checkpoint.checkpoint(
                train_block, x, w, c, positions, attn_impl, rope, mesh, use_reentrant=False)
        else:
            x, lb, z = train_block(x, w, c, positions, attn_impl, rope, mesh)
        lb_sum = lb_sum + lb
        z_sum = z_sum + z
    logits = llama.train_logits(params, c, x, mesh)
    return logits, {"load_balance": lb_sum / c.num_layers, "router_z": z_sum / c.num_layers}


def forward_with_aux(
    params: Params,
    cfg: MoEConfig,
    tokens: torch.Tensor,
    positions: torch.Tensor,
    cache: KVCache | None = None,
    attn_impl: str = "auto",
    logit_positions: torch.Tensor | None = None,
    remat: bool = False,
    mesh=None,
) -> tuple[torch.Tensor, KVCache | None, dict]:
    """Run the MoE decoder: (logits, cache, aux-loss dict).

    Cache semantics as ``llama.forward`` (in place, new ``lengths``);
    ``logit_positions`` [B] restricts the LM head to one position per row
    (logits [B, 1, V]). A cache marks the inference path: expert capacity
    takes the no-drop/wide policy of :func:`_capacity`. A quantized
    (int8) KV cache is not supported: the reference's MoE ignores scales.
    ``remat``: without a cache, run each block under non-reentrant
    ``torch.utils.checkpoint`` (training; the reference checkpoints the
    whole forward, with the same numbers). ``mesh``: ``params`` is the
    rank's local tree and ``cache`` holds its kv heads (serving; the
    module docstring); without a cache, a training mesh's forward
    (:func:`forward_train`, its rank's rows)."""
    c = cfg
    B, S = tokens.shape
    if mesh is not None and cache is None:
        logits, aux = forward_train(params, c, tokens, positions, mesh, remat=remat,
                                    attn_impl=attn_impl)
        if logit_positions is not None:
            idx = logit_positions.reshape(B, 1, 1).expand(B, 1, logits.shape[-1])
            logits = torch.gather(logits, 1, idx)
        return logits, None, aux
    x = _embed(params, tokens, c.dtype, mesh, vocab_rows(c.vocab_size, _world(mesh)))

    if cache is not None and S == 1 and attn_impl in ("auto", "reference"):
        logits, cache = _decode_forward(params, c, x, positions, cache, B, mesh)
        zero = torch.zeros((), dtype=torch.float32, device=x.device)
        return logits, cache, {"load_balance": zero, "router_z": zero.clone()}

    offsets = cache.lengths if cache is not None else None
    nh, nkv, sel = _heads(params, c, mesh.rank if mesh is not None else 0)
    rope = rope_tables(positions, c.head_dim, c.rope_theta)
    lb_sum = torch.zeros((), dtype=torch.float32, device=x.device)
    z_sum = torch.zeros((), dtype=torch.float32, device=x.device)
    for layer, w in enumerate(llama.layer_slices(params)):
        if cache is None:
            if remat:
                x, lb, z = torch.utils.checkpoint.checkpoint(
                    moe_transformer_block, x, w, c, positions, attn_impl, rope,
                    use_reentrant=False)
            else:
                x, lb, z = moe_transformer_block(x, w, c, positions, attn_impl, rope)
            lb_sum = lb_sum + lb
            z_sum = z_sum + z
            continue
        h = rms_norm(x, w["attn_norm"], c.rms_norm_eps)
        q = _mm(h, w["wq"]).reshape(B, S, nh, c.head_dim)
        k = _mm(h, w["wk"]).reshape(B, S, nkv, c.head_dim)
        v = _mm(h, w["wv"]).reshape(B, S, nkv, c.head_dim)
        q = apply_rope(q, positions, c.rope_theta, rope)
        k = apply_rope(k, positions, c.rope_theta, rope)
        ck, cv = cache.k[layer], cache.v[layer]
        _cache_insert(ck, k, offsets)
        _cache_insert(cv, v, offsets)
        kv_positions = torch.arange(ck.shape[1], device=x.device)[None, :].expand(B, -1)
        attn = gqa_attention(q, ck[:, :, sel], cv[:, :, sel], q_positions=positions,
                             kv_positions=kv_positions, kv_length=offsets + S,
                             impl=attn_impl)
        x = x + _psum(_mm(attn.reshape(B, S, nh * c.head_dim), w["wo"]), mesh)
        h = rms_norm(x, w["mlp_norm"], c.rms_norm_eps)
        y, aux = moe_block(h, w, c, inference=True, mesh=mesh)
        x = x + y
        lb_sum = lb_sum + aux["load_balance"]
        z_sum = z_sum + aux["router_z"]

    if cache is not None:
        cache.lengths = cache.lengths + S
    x = rms_norm(x, params["final_norm"], c.rms_norm_eps)
    if logit_positions is not None:
        idx = logit_positions.reshape(B, 1, 1).expand(B, 1, x.shape[-1])
        x = torch.gather(x, 1, idx)
    logits = llama._logits(params, c, x, mesh=mesh)
    aux = {"load_balance": lb_sum / c.num_layers, "router_z": z_sum / c.num_layers}
    return logits, cache, aux


def forward(
    params: Params,
    cfg: MoEConfig,
    tokens: torch.Tensor,
    positions: torch.Tensor,
    cache: KVCache | None = None,
    attn_impl: str = "auto",
    logit_positions: torch.Tensor | None = None,
    mesh=None,
) -> tuple[torch.Tensor, KVCache | None]:
    """Serving-signature forward (drop-in for ``llama.forward``)."""
    logits, cache, _ = forward_with_aux(params, cfg, tokens, positions, cache,
                                        attn_impl, logit_positions, mesh=mesh)
    return logits, cache
