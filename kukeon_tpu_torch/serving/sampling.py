"""Token sampling, the port of ``kukeon_tpu/serving/sampling.py``.

Greedy, temperature, top-k and top-p, with per-slot parameters. Random
draws use an explicit ``torch.Generator`` (Gumbel-max, as
``jax.random.categorical`` does); they cannot equal jax's threefry draws,
so stochastic sampling matches the reference in distribution only.

The reference skips the sorts and the Gumbel sweep with ``lax.cond`` on
device values. Here those two branches are decided from the host-side
sampling arrays the engine already holds (``needs_filter`` /
``any_stochastic``), so sampling adds no device-to-host sync.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    temperature: float = 0.0   # 0 => greedy
    top_k: int = 0             # 0 => disabled
    top_p: float = 1.0         # 1 => disabled
    max_new_tokens: int = 256
    # Per-request stop tokens (host-side check in the engine's emit path;
    # the stop token itself is included in the output).
    stop_tokens: tuple[int, ...] = ()


def slot_sampling_arrays(
    slot_requests, num_slots: int
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Per-slot (temps, top_ks, top_ps) host arrays for
    :func:`sample_per_slot`, from (slot, request) pairs whose requests carry
    a :class:`SamplingParams`. Empty slots sample greedily (temp 0)."""
    temps = np.zeros((num_slots,), np.float32)
    top_ks = np.zeros((num_slots,), np.int32)
    top_ps = np.ones((num_slots,), np.float32)
    for slot, req in slot_requests:
        sp = req.sampling
        temps[slot] = sp.temperature
        top_ks[slot] = sp.top_k
        top_ps[slot] = sp.top_p
    return temps, top_ks, top_ps


def branch_flags(temps: np.ndarray, top_ks: np.ndarray,
                 top_ps: np.ndarray) -> tuple[bool, bool]:
    """(needs_filter, any_stochastic) from host sampling arrays."""
    return (bool(np.any(top_ks > 0) or np.any(top_ps < 1.0)),
            bool(np.any(temps > 0)))


def gumbel(shape, generator: torch.Generator | None, device) -> torch.Tensor:
    """Standard Gumbel noise, -log(-log(u)) with u in (0, 1)."""
    u = torch.rand(shape, generator=generator, device=device, dtype=torch.float32)
    tiny = torch.finfo(torch.float32).tiny
    return -torch.log(-torch.log(u.clamp_(min=tiny, max=1.0 - 2 ** -24)))


def sample(logits: torch.Tensor, generator: torch.Generator | None,
           params: SamplingParams) -> torch.Tensor:
    """Sample next tokens from [B, V] logits -> [B] int64 with one static
    set of parameters."""
    if params.temperature <= 0.0:
        return torch.argmax(logits, dim=-1)
    logits = logits / params.temperature
    if params.top_k > 0:
        kth = torch.topk(logits, params.top_k, dim=-1).values[:, -1:]
        logits = torch.where(logits < kth, -torch.inf, logits)
    if params.top_p < 1.0:
        sorted_logits = torch.sort(logits, dim=-1, descending=True).values
        cum = torch.cumsum(torch.softmax(sorted_logits, dim=-1), dim=-1)
        cutoff_idx = torch.sum(cum < params.top_p, dim=-1, keepdim=True)
        cutoff_idx = cutoff_idx.clamp_(max=logits.shape[-1] - 1)
        cutoff_logit = torch.gather(sorted_logits, -1, cutoff_idx)
        logits = torch.where(logits < cutoff_logit, -torch.inf, logits)
    return torch.argmax(logits + gumbel(logits.shape, generator, logits.device), dim=-1)


def filter_topk_topp(scaled: torch.Tensor, top_k: torch.Tensor,
                     top_p: torch.Tensor) -> torch.Tensor:
    """Per-row top-k then top-p masking (to -inf) of [B, V] logits.

    top-k masks logits below the k-th largest (k == 0 keeps all); top-p
    keeps the smallest prefix of the re-sorted, top-k-filtered distribution
    with mass >= top_p (top_p >= 1 keeps all)."""
    V = scaled.shape[-1]
    sorted_desc = torch.sort(scaled, dim=-1, descending=True).values
    kk = (torch.clamp(top_k, 1, V) - 1).long()
    kth = torch.gather(sorted_desc, -1, kk[:, None])
    scaled = torch.where((top_k > 0)[:, None] & (scaled < kth), -torch.inf, scaled)

    sorted_desc = torch.sort(scaled, dim=-1, descending=True).values
    cum = torch.cumsum(torch.softmax(sorted_desc, dim=-1), dim=-1)
    cutoff_idx = torch.sum(cum < top_p[:, None], dim=-1).clamp_(max=V - 1)
    cutoff_logit = torch.gather(sorted_desc, -1, cutoff_idx[:, None])
    apply_p = (top_p < 1.0)[:, None]
    return torch.where(apply_p & (scaled < cutoff_logit), -torch.inf, scaled)


def sample_per_slot(
    logits: torch.Tensor,
    generator: torch.Generator | None,
    temperature: torch.Tensor,
    top_k: torch.Tensor,
    top_p: torch.Tensor,
    *,
    needs_filter: bool | None = None,
    any_stochastic: bool | None = None,
    noise: torch.Tensor | None = None,
) -> torch.Tensor:
    """Sampling with per-slot parameters: [B, V] float32 logits -> [B] int64.

    temperature [B] (<= 0: greedy for that slot), top_k [B] (0 disables),
    top_p [B] (>= 1 disables). ``needs_filter``/``any_stochastic`` decide
    whether the sorts and the noise sweep run at all; left ``None`` they
    are read from the tensors (a device sync on a GPU — the engine passes
    them from its host arrays). ``noise`` replaces the Gumbel draw with
    given [B, V] noise (tests feed both packages the same numbers)."""
    greedy = torch.argmax(logits, dim=-1)
    if any_stochastic is None:
        any_stochastic = bool((temperature > 0).any())
    if not any_stochastic:
        return greedy
    if needs_filter is None:
        needs_filter = bool((top_k > 0).any() or (top_p < 1.0).any())
    t = torch.where(temperature > 0, temperature, torch.ones_like(temperature))[:, None]
    scaled = logits / t
    if needs_filter:
        scaled = filter_topk_topp(scaled, top_k, top_p)
    if noise is None:
        noise = gumbel(scaled.shape, generator, scaled.device)
    sampled = torch.argmax(scaled + noise, dim=-1)
    return torch.where(temperature > 0, sampled, greedy)
