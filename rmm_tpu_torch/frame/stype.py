"""Semantic column types (stypes) of the port's tables.

The integer values are those of ``rmm_tpu.frame.stype.Stype``: they fix the
order in which per-stype column blocks are concatenated into the
``[batch, num_cols, channels]`` token tensor, so the two packages lay out
their tokens identically.
"""
from __future__ import annotations

import enum


class Stype(enum.IntEnum):
    numerical = 0
    categorical = 1
    timestamp = 3
    text_embedded = 4    # a frozen embedder's vectors, [N, n, emb_dim]
    text_tokenized = 5   # token ids a text model reads in the forward
    relation = 7   # raw relation/id columns (link targets, node ids)


#: Canonical iteration order for stype blocks in a TensorFrame.
STYPE_ORDER = tuple(sorted(Stype))
