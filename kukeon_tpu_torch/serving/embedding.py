"""Embedding engine: batched sentence embeddings over the BERT encoder, the
port of ``kukeon_tpu/serving/embedding.py``.

Encoders have no decode loop, so the engine's work is shaping traffic into
fixed grids: sequences sorted by length, grouped ``batch_size`` at a time
and padded to a length bucket (:data:`EMBED_BUCKETS`), so a burst of N
sequences runs in ceil(N / batch_size) forwards of a few shapes. The
padding mask keeps ragged rows exact. The forward runs eagerly under
``torch.inference_mode()``.

**Tensor parallelism** (``mesh=``, the reference's sharded params): the
weights come as a ``parallel.sharding.Recipe`` that every rank runs,
keeping its slice of each leaf (``bert_param_specs``); the leader posts
each grid's ``(tokens, mask)`` to its followers (``parallel/launch.py``),
every rank runs the forward with its collectives (``models/bert.py``),
and the leader alone pools and returns. A grid the leader sent and then
failed to run ends the group (``Group.abort``): a follower may wait in its
collective. A follower is this class built by :func:`follower_embedding`.
"""

from __future__ import annotations

import weakref

import numpy as np
import torch

from kukeon_tpu_torch.device import resolve_device
from kukeon_tpu_torch.models import bert
from kukeon_tpu_torch.parallel.sharding import Recipe, check_tensor_parallel, local_params

EMBED_BUCKETS = (16, 32, 64, 128, 256, 512)


def bucket_length(n: int, max_len: int) -> int:
    """The grid length of a batch whose longest sequence is ``n``."""
    for b in EMBED_BUCKETS:
        if n <= b:
            return min(b, max_len)
    return max_len


class EmbeddingEngine:
    """Batched embed over the BERT forward; one engine per embedding cell.
    ``params`` is the model's tree on ``device`` (default ``cuda``, which
    raises without a GPU; tests pass ``device="cpu"``), or with ``mesh``
    a ``parallel.sharding.Recipe`` of it."""

    def __init__(self, cfg: bert.BertConfig, params, *, batch_size: int = 16,
                 pooling: str = "cls", device: str | torch.device | None = None,
                 mesh=None):
        if pooling not in ("cls", "mean"):
            raise ValueError(f"unknown pooling {pooling!r}")
        self.cfg = cfg
        self.mesh = mesh
        self.world = mesh.size if mesh is not None else 1
        self.device = mesh.device if mesh is not None else resolve_device(device)
        self.batch_size = batch_size
        self.pooling = pooling
        self._group = None
        if mesh is None:
            self.params = params
            return
        if not isinstance(params, Recipe):
            raise TypeError("on a mesh the weights come as a parallel.sharding.Recipe")
        check_tensor_parallel(cfg, mesh.world)
        self.params = local_params(params, cfg, mesh)
        if mesh.leader and mesh.size > 1:
            self._group = mesh.group
            self._oid = self._group.new_id()
            self._group.post(self._oid, "new", (
                "kukeon_tpu_torch.serving.embedding:follower_embedding",
                {"cfg": cfg, "recipe": params, "pooling": pooling}), flush=True)
            weakref.finalize(self, self._group.drop, self._oid)

    def _embed(self, tokens: np.ndarray, mask: np.ndarray) -> np.ndarray:
        """One grid's unit vectors (the leader's, on a mesh: its followers
        run the same grid's forward)."""
        if self._group is not None:
            self._group.post(self._oid, "embed", (tokens, mask), flush=True)
            try:
                return self._forward(tokens, mask)
            except BaseException as e:
                self._group.abort(f"rank 0 failed in embed: {type(e).__name__}: {e}")
                raise
        return self._forward(tokens, mask)

    def _forward(self, tokens: np.ndarray, mask: np.ndarray) -> np.ndarray:
        with torch.inference_mode():
            t = torch.from_numpy(tokens).to(self.device)
            m = torch.from_numpy(mask).to(self.device)
            if self.mesh is None:
                return bert.embed(self.params, self.cfg, t, m, pooling=self.pooling).cpu().numpy()
            if not self.mesh.leader:
                bert.forward(self.params, self.cfg, t, m, mesh=self.mesh)
                return None
            return bert.embed(self.params, self.cfg, t, m, pooling=self.pooling,
                              mesh=self.mesh).cpu().numpy()

    def follow(self, action: str, args: tuple) -> None:
        """A follower runs its leader's grid (``action`` ``"embed"``)."""
        self._forward(*args)

    def close(self) -> None:
        """Drop the followers' engines now (a leader's; otherwise when this
        object is collected)."""
        if self._group is not None:
            self._group.drop(self._oid)
            self._group.flush()
            self._group = None

    def warmup(self, lengths: tuple[int, ...] = (64,)) -> None:
        """Run one grid of each bucket the lengths hit."""
        for n in lengths:
            b = bucket_length(n, self.cfg.max_position_embeddings)
            tokens = np.zeros((self.batch_size, b), np.int32)
            mask = np.zeros((self.batch_size, b), np.int32)
            mask[:, 0] = 1
            self._embed(tokens, mask)

    def embed_batch(self, prompts: list[np.ndarray]) -> np.ndarray:
        """Embed N token sequences -> [N, H] f32 unit vectors, in the
        caller's order. Ids outside ``[0, vocab)`` raise ValueError, where
        the reference has no check: on a GPU an out-of-range gather is a
        device assert that poisons the context."""
        if not prompts:
            return np.zeros((0, self.cfg.hidden_size), np.float32)
        V = self.cfg.vocab_size
        for p in prompts:
            p = np.asarray(p)
            if p.ndim != 1 or (p.size and (p.min() < 0 or p.max() >= V)):
                raise ValueError(f"each sequence must be a list of token ids in [0, {V})")
        max_pos = self.cfg.max_position_embeddings
        out = np.empty((len(prompts), self.cfg.hidden_size), np.float32)
        order = sorted(range(len(prompts)), key=lambda i: len(prompts[i]))
        for start in range(0, len(order), self.batch_size):
            idx = order[start:start + self.batch_size]
            longest = max(len(prompts[i]) for i in idx)
            if longest > max_pos:
                raise ValueError(
                    f"sequence length {longest} exceeds the encoder's "
                    f"max_position_embeddings {max_pos}")
            b = bucket_length(longest, max_pos)
            tokens = np.zeros((self.batch_size, b), np.int32)
            mask = np.zeros((self.batch_size, b), np.int32)
            for row, i in enumerate(idx):
                p = np.asarray(prompts[i], np.int32)
                tokens[row, :p.size] = p
                mask[row, :p.size] = 1
            # Fully padded rows still flow through the softmax: give them
            # one live position.
            mask[len(idx):, 0] = 1
            vecs = self._embed(tokens, mask)
            out[idx] = vecs[:len(idx)]
        return out


def follower_embedding(mesh, *, cfg: bert.BertConfig, recipe: Recipe,
                       pooling: str) -> EmbeddingEngine:
    """A follower rank's engine (``parallel/launch.py`` builds it at its
    leader's word): its slice of the leader's weight ``recipe``."""
    return EmbeddingEngine(cfg, recipe, mesh=mesh, pooling=pooling)
