"""TensorFrame: columnar features grouped by stype.

A plain dataclass whose blocks are numpy arrays on the host or torch tensors
on a device (``.to(device)``):

    numerical       [N, n_num]           float32
    categorical     [N, n_cat]           int32 (−1 = missing)
    timestamp       [N, n_ts]            int64 (unix seconds)
    text_embedded   [N, n_text, emb_dim] float32
    text_tokenized  [N, n_text, L]       int32 (0 = padding)
    relation        [N, n_rel]           float32

``col_names`` maps each stype to its column names; ``y`` is an optional
packed target ``[N, T]``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np
import torch

from .stype import Stype


@dataclasses.dataclass
class TensorFrame:
    feats: dict[Stype, Any]
    col_names: dict[Stype, list]
    y: Optional[Any] = None

    @property
    def num_rows(self) -> int:
        for v in self.feats.values():
            return int(v.shape[0])
        return 0 if self.y is None else int(self.y.shape[0])

    @property
    def num_cols(self) -> int:
        return sum(len(v) for v in self.col_names.values())

    def __getitem__(self, idx) -> "TensorFrame":
        """Row selection by an index array (numpy or torch) or a slice."""
        feats = {st: v[idx] for st, v in self.feats.items()}
        y = self.y[idx] if self.y is not None else None
        return TensorFrame(feats=feats, col_names=self.col_names, y=y)

    def to(self, device) -> "TensorFrame":
        """Copy every block to ``device`` as torch tensors (one copy per
        block; the tables go to the card once)."""
        def put(a):
            t = a if isinstance(a, torch.Tensor) else torch.from_numpy(
                np.ascontiguousarray(a))
            return t.to(device)

        return TensorFrame(
            feats={st: put(v) for st, v in self.feats.items()},
            col_names=self.col_names,
            y=None if self.y is None else put(self.y))
