"""Embedding engine: batched sentence embeddings over the BERT encoder, the
port of ``kukeon_tpu/serving/embedding.py``.

Encoders have no decode loop, so the engine's work is shaping traffic into
fixed grids: sequences sorted by length, grouped ``batch_size`` at a time
and padded to a length bucket (:data:`EMBED_BUCKETS`), so a burst of N
sequences runs in ceil(N / batch_size) forwards of a few shapes. The
padding mask keeps ragged rows exact. The forward runs eagerly under
``torch.inference_mode()`` on one device (the reference shards over a
mesh; the port serves on one GPU).
"""

from __future__ import annotations

import numpy as np
import torch

from kukeon_tpu_torch.device import resolve_device
from kukeon_tpu_torch.models import bert

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
    raises without a GPU; tests pass ``device="cpu"``)."""

    def __init__(self, cfg: bert.BertConfig, params, *, batch_size: int = 16,
                 pooling: str = "cls", device: str | torch.device | None = None):
        if pooling not in ("cls", "mean"):
            raise ValueError(f"unknown pooling {pooling!r}")
        self.cfg = cfg
        self.device = resolve_device(device)
        self.batch_size = batch_size
        self.pooling = pooling
        self.params = params

    def _embed(self, tokens: np.ndarray, mask: np.ndarray) -> np.ndarray:
        with torch.inference_mode():
            t = torch.from_numpy(tokens).to(self.device)
            m = torch.from_numpy(mask).to(self.device)
            return bert.embed(self.params, self.cfg, t, m, pooling=self.pooling).cpu().numpy()

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
