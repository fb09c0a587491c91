"""Finetunable text encoder (``rmm_tpu/nn/text/finetune.py``): an LM run
inside the tabular forward on a text column's token ids, pooled to one
vector a row, with an optional LoRA output projection; and the hashing
tokenizer that makes its ids.

The LM's self-attention is the port's column-attention kernel
(``nn/transformer.py``), over the L = 64 token positions of a row: at
``cli/finetune_llm.py``'s width (C = 128, 4 heads) its backward core runs
one block an SM (``ops/column_attention.core_budget``).
"""
from __future__ import annotations

import hashlib
from typing import Sequence

import numpy as np
import torch
from torch import nn

from ...utils.pooling import mean_pooling
from ..transformer import TransformerEncoderLayer
from .lora import LoRADense

PAD_ID = 0


class HashingTokenizer:
    """Whitespace words of the lower-cased text, the first ``max_length``,
    each to id ``1 + v % (vocab_size − 1)`` (``v`` the little-endian 4-byte
    blake2b digest of the word), 0 padding: int32 ``[N, max_length]``, bit
    for bit the JAX tokenizer's."""

    def __init__(self, vocab_size: int = 8192, max_length: int = 64):
        self.vocab_size = vocab_size
        self.max_length = max_length
        self._ids: dict[str, int] = {}

    def _id(self, word: str) -> int:
        got = self._ids.get(word)
        if got is None:
            h = hashlib.blake2b(word.encode(), digest_size=4).digest()
            got = self._ids[word] = 1 + int.from_bytes(h, "little") % (
                self.vocab_size - 1)
        return got

    def __call__(self, sentences: Sequence[str]) -> np.ndarray:
        out = np.full((len(sentences), self.max_length), PAD_ID,
                      dtype=np.int32)
        for i, s in enumerate(sentences):
            words = (s or "").lower().split()[:self.max_length]
            out[i, :len(words)] = [self._id(w) for w in words]
        return out


class Embed(nn.Module):
    """A token embedding table, ``embedding [vocab, features]`` (flax's
    ``nn.Embed`` and its parameter name)."""

    def __init__(self, num_embeddings: int, features: int):
        super().__init__()
        self.embedding = nn.Parameter(torch.empty(num_embeddings, features))

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        return nn.functional.embedding(ids, self.embedding)


class TextToEmbeddingFinetune(nn.Module):
    """Token ids ``[B, L]`` → ``[B, hidden]``: ``tok_emb`` (ids clipped to
    the vocabulary) plus ``pos_emb``, ``num_layers`` post-norm encoder
    layers (``layer_i``: column attention over the L positions, ``nhead``
    heads, dropout ``dropout``), ``lora_out`` where ``lora_rank > 0``,
    then the mean over the non-padding positions. As in the reference the
    attention has no key mask (padding positions are attended to; only
    the pooling skips them)."""

    def __init__(self, hidden: int = 128, num_layers: int = 2,
                 nhead: int = 4, vocab_size: int = 8192,
                 max_length: int = 64, dropout: float = 0.1,
                 lora_rank: int = 0):
        super().__init__()
        self.hidden = hidden
        self.num_layers = num_layers
        self.vocab_size = vocab_size
        self.max_length = max_length
        self.tok_emb = Embed(vocab_size, hidden)
        self.pos_emb = nn.Parameter(torch.empty(max_length, hidden))
        for i in range(num_layers):
            self.add_module(f"layer_{i}", TransformerEncoderLayer(
                hidden, nhead, dropout=dropout))
        self.lora_out = (LoRADense(hidden, hidden, rank=lora_rank)
                         if lora_rank > 0 else None)

    def forward(self, token_ids: torch.Tensor) -> torch.Tensor:
        mask = (token_ids != PAD_ID).to(torch.float32)
        ids = torch.clamp(token_ids.long(), 0, self.vocab_size - 1)
        x = self.tok_emb(ids) + self.pos_emb[None, :token_ids.shape[1]]
        for i in range(self.num_layers):
            x = getattr(self, f"layer_{i}")(x)
        if self.lora_out is not None:
            x = self.lora_out(x)
        return mean_pooling(x, mask)[:, 0]
