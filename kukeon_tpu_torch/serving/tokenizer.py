"""Tokenizer loading for serving cells, a copy of
``kukeon_tpu/serving/tokenizer.py``.

Real checkpoints ship a ``tokenizer.json`` (HF tokenizers format), loaded
with the ``tokenizers`` runtime (a lazy import). Hosts without a checkpoint
(random-init serving, tests) use a byte tokenizer, so the serving stack
runs the same code either way.
"""

from __future__ import annotations

import os


class ByteTokenizer:
    """One token per byte, offset to keep 0 reserved."""

    vocab_size = 258
    bos_id = 256
    eos_id = 257

    def encode(self, text: str) -> list[int]:
        return [self.bos_id] + list(text.encode("utf-8", errors="replace"))

    def decode(self, ids: list[int]) -> str:
        data = bytes(i for i in ids if 0 <= i < 256)
        return data.decode("utf-8", errors="replace")


class HFTokenizer:
    """tokenizer.json wrapper (Llama-3 style BPE)."""

    def __init__(self, path: str):
        from tokenizers import Tokenizer

        self.tk = Tokenizer.from_file(path)
        self.vocab_size = self.tk.get_vocab_size()
        self.bos_id = self._special("<|begin_of_text|>", "<s>", "<bos>", "[CLS]")
        self.eos_id = self._special("<|end_of_text|>", "</s>", "<eos>",
                                    "<|eot_id|>", "[SEP]")

    def _special(self, *names: str) -> int | None:
        for name in names:
            tid = self.tk.token_to_id(name)
            if tid is not None:
                return tid
        return None

    def encode(self, text: str) -> list[int]:
        ids = self.tk.encode(text, add_special_tokens=False).ids
        if self.bos_id is not None:
            return [self.bos_id] + ids
        return ids

    def decode(self, ids: list[int]) -> str:
        drop = {i for i in (self.bos_id, self.eos_id) if i is not None}
        # Out-of-vocab ids (random-init models sample ids the tokenizer
        # never minted) are dropped, not fatal.
        return self.tk.decode([
            i for i in ids if i not in drop and 0 <= i < self.vocab_size
        ])


def load_tokenizer(checkpoint_dir: str | None):
    """HFTokenizer when the checkpoint ships tokenizer.json, else bytes."""
    if checkpoint_dir:
        path = os.path.join(checkpoint_dir, "tokenizer.json")
        if os.path.exists(path):
            return HFTokenizer(path)
    return ByteTokenizer()
