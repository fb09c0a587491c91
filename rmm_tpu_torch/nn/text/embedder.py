"""Frozen text embedder (``rmm_tpu/nn/text/embedder.py``): character
n-gram feature hashing, computed once at materialization (the
``text_embedded`` path), so training never runs an LM.

Only the hashing backend is ported: the JAX package's HuggingFace
backends (``TextToEmbedding``, ``FlaxTextToEmbedding``) need pretrained
weights and ``transformers``, and :func:`get_text_embedder` refuses them by
name.
"""
from __future__ import annotations

import hashlib
from typing import Sequence

import numpy as np


class HashingTextEmbedder:
    """Deterministic n-gram feature hashing: each lower-cased text's
    character 3- and 4-grams (``ngrams``) go to bucket ``v % dim`` with sign
    +1 where bit 62 of ``v`` is set, else −1, ``v`` the little-endian
    8-byte blake2b digest of ``f"{seed}:{ngram}"``; each row is then
    L2-normalized (norm clamped at 1e-9). Shared n-grams give nearby
    vectors. float32 ``[len(sentences), dim]``, bit for bit the JAX
    embedder's."""

    def __init__(self, dim: int = 256, ngrams: Sequence[int] = (3, 4),
                 seed: int = 0):
        self.dim = dim
        self.ngrams = tuple(ngrams)
        self.seed = seed
        self._buckets: dict[str, tuple[int, float]] = {}

    def _bucket(self, token: str) -> tuple[int, float]:
        got = self._buckets.get(token)
        if got is None:
            h = hashlib.blake2b(f"{self.seed}:{token}".encode(),
                                digest_size=8).digest()
            v = int.from_bytes(h, "little")
            got = self._buckets[token] = (v % self.dim,
                                          1.0 if (v >> 62) & 1 else -1.0)
        return got

    def __call__(self, sentences: Sequence[str]) -> np.ndarray:
        """Each row's signed bucket counts (whole numbers, so summed in any
        order they are exact), then the L2 normalization in float32."""
        out = np.zeros((len(sentences), self.dim), dtype=np.float32)
        for i, s in enumerate(sentences):
            s = (s or "").lower()
            hits = [self._bucket(s[j:j + n]) for n in self.ngrams
                    for j in range(max(len(s) - n + 1, 0))]
            if hits:
                b, sign = zip(*hits)
                out[i] = np.bincount(b, weights=sign, minlength=self.dim)
        norm = np.linalg.norm(out, axis=1, keepdims=True)
        return out / np.maximum(norm, 1e-9)


def get_text_embedder(model: str = "hashing", dim: int = 256, **kw):
    """The frozen embedder named ``model``: ``hashing`` alone (a pretrained
    LM needs weights this package does not load)."""
    if model == "hashing":
        return HashingTextEmbedder(dim=dim, **kw)
    raise ValueError(f"text model {model!r} is not ported: the port has the "
                     "'hashing' embedder and LM only (pretrained LMs need "
                     "HuggingFace weights)")
