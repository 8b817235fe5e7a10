"""RMSNorm, the port of ``kukeon_tpu/ops/norms.py``.

Computed in float32 whatever the input dtype, and the f32 product with
``scale`` is cast back *after* the multiply (the reference's order, not the
Hugging Face one, which casts before scaling).
"""

import torch


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """RMSNorm over the trailing dimension.

    Args:
      x: [..., hidden] activations (any float dtype).
      scale: [hidden] learned gain.
      eps: numerical-stability epsilon.
    """
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    normed = xf * torch.reciprocal(torch.sqrt(var + eps))
    return (normed * scale.float()).to(x.dtype)
