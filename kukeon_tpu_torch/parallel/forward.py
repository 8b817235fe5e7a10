"""A decoder's forward over a mesh, outside the serving engine: each rank
runs the family's forward (``models/llama.py`` or ``models/moe.py``) on its
shard of the weights and of one KV cache, and the leader gets the gathered
logits. The serving engine runs the same forward inside its programs, which
sample in the graph and hand back tokens, not logits: this is the seam that
holds the sharded logits, and a MoE rank's expert choices, against a
reference (ROADMAP.md §C)."""

from __future__ import annotations

import torch

from kukeon_tpu_torch.models import llama, moe
from kukeon_tpu_torch.parallel.sharding import Recipe, check_tensor_parallel, local_params


class TensorParallelForward:
    """The forward of ``cfg``'s family (``moe.forward`` for a
    ``MoEConfig``, else ``llama.forward``) on ``mesh`` with one KV cache of
    ``batch`` rows of ``max_len`` (each rank holding its kv heads), the
    weights every rank's slice of ``recipe``. The leader's call posts the
    same call to its followers, which build their own instance from the
    same recipe. Calls run in order against the cache, as the one-device
    forward's do."""

    def __init__(self, mesh, cfg, recipe: Recipe, *, batch: int,
                 max_len: int, kv_shard: bool = True, kv_int8: bool = False):
        self.mesh = mesh
        self.cfg = cfg
        self._forward = moe.forward if isinstance(cfg, moe.MoEConfig) else llama.forward
        sharded = check_tensor_parallel(cfg, mesh.world, kv_shard)
        self.params = local_params(recipe, cfg, mesh, sharded)
        self.cache = llama.KVCache.create(
            cfg, batch, max_len, quantized=kv_int8, device=mesh.device,
            kv_heads=cfg.num_kv_heads // mesh.world if sharded else cfg.num_kv_heads)
        self._group = mesh.group if mesh.leader and mesh.size > 1 else None
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
        return self._run("call", (tokens, positions, logit_positions))

    @torch.no_grad()
    def routes(self, tokens: torch.Tensor, positions: torch.Tensor) -> torch.Tensor:
        """A MoE call that returns, instead of logits, every tensor peer's
        expert choices: ``[tensor, L, N, K]`` (in tensor order, gathered to
        every rank of the replica),
        each MoE block's top-k experts of each token as that rank routed
        them."""
        return self._run("routes", (tokens, positions))

    def _run(self, action: str, args: tuple):
        if self._group is not None:
            self._group.post(self._oid, action, args, flush=True)
        return self.follow(action, args)

    def follow(self, action: str, args: tuple):
        args = tuple(None if a is None else a.to(self.mesh.device) for a in args)
        if action == "call":
            return self._call(*args)
        with moe.record_routes() as log:
            self._call(*args)
        local = torch.stack(log)                                 # [L, N, K]
        return self.mesh.all_gather(local[None], 0)

    def _call(self, tokens, positions, logit_positions=None):
        logits, self.cache = self._forward(self.params, self.cfg, tokens, positions,
                                           self.cache, logit_positions=logit_positions,
                                           mesh=self.mesh)
        return logits

    def close(self) -> None:
        if self._group is not None:
            self._group.drop(self._oid)
            self._group.flush()
            self._group = None
