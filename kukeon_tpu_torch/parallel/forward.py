"""The Llama forward over a mesh, outside the serving engine: each rank
runs ``models/llama.py``'s :func:`forward` on its shard of the weights and
of one KV cache, and the leader gets the gathered logits. The serving
engine runs the same forward inside its programs, which sample in the
graph and hand back tokens, not logits: this is the seam that holds the
sharded logits against a reference (ROADMAP.md §C)."""

from __future__ import annotations

import torch

from kukeon_tpu_torch.models import llama
from kukeon_tpu_torch.parallel.sharding import Recipe, check_tensor_parallel, local_params


class TensorParallelForward:
    """``llama.forward`` on ``mesh`` with one KV cache of ``batch`` rows of
    ``max_len`` (each rank holding its kv heads), the weights every rank's
    slice of ``recipe``. The leader's call posts the same call to its
    followers, which build their own instance from the same recipe. Calls
    run in order against the cache, as the one-device forward's do."""

    def __init__(self, mesh, cfg: llama.LlamaConfig, recipe: Recipe, *, batch: int,
                 max_len: int, kv_shard: bool = True, kv_int8: bool = False):
        self.mesh = mesh
        self.cfg = cfg
        sharded = check_tensor_parallel(cfg, mesh.world, kv_shard)
        self.params = local_params(recipe, cfg, mesh, sharded)
        self.cache = llama.KVCache.create(
            cfg, batch, max_len, quantized=kv_int8, device=mesh.device,
            kv_heads=cfg.num_kv_heads // mesh.world if sharded else cfg.num_kv_heads)
        self._group = mesh.group if mesh.leader and mesh.world > 1 else None
        if self._group is not None:
            self._oid = self._group.new_id()
            self._group.post(self._oid, "new", (
                "kukeon_tpu_torch.parallel.forward:TensorParallelForward",
                {"cfg": cfg, "recipe": recipe, "batch": batch, "max_len": max_len,
                 "kv_shard": sharded, "kv_int8": kv_int8}), flush=True)

    @torch.no_grad()
    def __call__(self, tokens: torch.Tensor, positions: torch.Tensor,
                 logit_positions: torch.Tensor | None = None) -> torch.Tensor:
        """Logits [B, S, V] f32 (``[B, 1, V]`` with ``logit_positions``) of
        host ``tokens`` at ``positions``, against the cache."""
        if self._group is not None:
            self._group.post(self._oid, "call", (tokens, positions, logit_positions),
                             flush=True)
        return self.follow("call", (tokens, positions, logit_positions))

    def follow(self, action: str, args: tuple):
        tokens, positions, logit_positions = (
            None if a is None else a.to(self.mesh.device) for a in args)
        logits, self.cache = llama.forward(self.params, self.cfg, tokens, positions,
                                           self.cache, logit_positions=logit_positions,
                                           mesh=self.mesh)
        return logits

    def close(self) -> None:
        if self._group is not None:
            self._group.drop(self._oid)
            self._group.flush()
            self._group = None

