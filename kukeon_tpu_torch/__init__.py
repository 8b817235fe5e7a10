"""kukeon_tpu_torch: the PyTorch/CUDA port of kukeon_tpu's serving path.

The layout mirrors the JAX package (``ops/``, ``models/``, ``serving/``,
``runtime/``): each module names the ``kukeon_tpu`` module it is held
against in its docstring, and keeps that module's public layouts
(``[B, S, H, D]`` attention tensors, stacked ``[L, ...]`` parameter trees
with ``{"q", "s"}`` int8 leaves, ``[L, B, S, KV, D]`` KV caches), so the
tests compare like with like and KV blocks mean the same in both packages.

The package imports torch and numpy only: never jax, never any module of
``kukeon_tpu``. Entry points run on ``cuda`` unless the caller passes
``device="cpu"`` (:mod:`kukeon_tpu_torch.device`).
"""

from kukeon_tpu_torch.device import resolve_device

__all__ = ["resolve_device"]
