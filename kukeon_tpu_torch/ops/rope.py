"""Rotary position embeddings, the port of ``kukeon_tpu/ops/rope.py``.

Split-half convention: the head dimension splits into two halves that form
the (real, imaginary) pair. Frequencies and the rotation are float32; the
result is cast back to the input dtype.

The cos/sin tables depend only on positions, so a forward computes them
once (:func:`rope_tables`) and hands them to every layer's q and k: in
eager PyTorch each op is a launch, and the reference's per-call recompute
(which XLA hoists) would cost ~10 launches per call.
"""

import torch


def rope_frequencies(head_dim: int, theta: float,
                     device: torch.device | str | None = None) -> torch.Tensor:
    """Inverse frequencies [head_dim // 2] for a RoPE of base ``theta``."""
    exponents = torch.arange(0, head_dim, 2, dtype=torch.float32,
                             device=device) / head_dim
    return 1.0 / (theta ** exponents)


def rope_tables(positions: torch.Tensor, head_dim: int,
                theta: float) -> tuple[torch.Tensor, torch.Tensor]:
    """(cos, sin), each [B, S, 1, head_dim // 2] f32, for [B, S] positions."""
    inv_freq = rope_frequencies(head_dim, theta, positions.device)   # [D/2]
    angles = positions[..., None].float() * inv_freq                  # [B, S, D/2]
    return torch.cos(angles)[:, :, None, :], torch.sin(angles)[:, :, None, :]


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float,
               tables: tuple[torch.Tensor, torch.Tensor] | None = None) -> torch.Tensor:
    """Rotate q or k by position.

    Args:
      x: [batch, seq, heads, head_dim].
      positions: [batch, seq] absolute token positions (integer).
      theta: RoPE base frequency.
      tables: optional (cos, sin) from :func:`rope_tables` for these
        positions, to skip recomputing them.

    Returns:
      Rotated tensor, same shape and dtype as ``x``.
    """
    cos, sin = tables if tables is not None else rope_tables(positions, x.shape[-1], theta)
    x1, x2 = x.float().chunk(2, dim=-1)
    rotated = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return rotated.to(x.dtype)
