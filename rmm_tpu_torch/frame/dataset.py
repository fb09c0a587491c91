"""Dataset: a table of numpy columns → materialized TensorFrame + stats.

Counterpart of ``rmm_tpu/frame/dataset.py`` without pandas: the table is an
ordered ``dict`` of 1-D numpy columns (object arrays for strings), but a
text column, which holds a row's vector (``text_embedded``) or token ids
(``text_tokenized``) as a 2-D ``[N, D]`` array.
Categorical values are coded by count-descending rank (``value_counts``
order), missing cells as −1; numerical columns stay raw (the encoder
normalizes with the recorded stats); timestamps are unix seconds.
"""
from __future__ import annotations

from typing import Any, Optional

import numpy as np

from .stats import StatType, compute_col_stats, is_missing
from .stype import STYPE_ORDER, Stype
from .tensor_frame import TensorFrame


def categorical_codes(values: np.ndarray, categories: list) -> np.ndarray:
    """Code of each value in ``categories`` (−1 for missing or unseen)."""
    vals = np.asarray(values, dtype=object)
    codes = np.full(len(vals), -1, dtype=np.int32)
    present = ~is_missing(vals)
    if not present.any() or not categories:
        return codes
    keys = np.asarray([str(c) for c in categories])
    order = np.argsort(keys)
    strs = vals[present].astype(str)
    pos = np.clip(np.searchsorted(keys[order], strs), 0, len(keys) - 1)
    hit = keys[order][pos] == strs
    codes[np.nonzero(present)[0][hit]] = order[pos[hit]]
    return codes


class Dataset:
    """A table with a stype schema, materializable to a TensorFrame."""

    def __init__(self, columns: dict[str, np.ndarray],
                 col_to_stype: dict[str, Stype],
                 split_col: Optional[str] = None,
                 target_col: Optional[str] = None):
        self.columns = columns
        self.col_to_stype = dict(col_to_stype)
        self.split_col = split_col
        self.target_col = target_col or None
        self.col_stats: dict[str, dict[StatType, Any]] = {}
        self.tensor_frame: Optional[TensorFrame] = None

    @property
    def feat_cols(self) -> list[str]:
        return [c for c in self.col_to_stype
                if c != self.target_col and c != self.split_col]

    @property
    def num_rows(self) -> int:
        return len(next(iter(self.columns.values())))

    def materialize(self) -> "Dataset":
        if self.tensor_frame is not None:
            return self
        for col, st in self.col_to_stype.items():
            if col != self.target_col:
                self.col_stats[col] = compute_col_stats(self.columns[col], st)

        by_stype: dict[Stype, list[str]] = {}
        for col in self.feat_cols:
            by_stype.setdefault(self.col_to_stype[col], []).append(col)

        feats: dict[Stype, np.ndarray] = {}
        for st in STYPE_ORDER:
            cols = by_stype.get(st)
            if not cols:
                continue
            if st == Stype.numerical:
                block = np.stack([np.asarray(self.columns[c], np.float32)
                                  for c in cols], axis=1)
            elif st == Stype.categorical:
                block = np.stack([categorical_codes(
                    self.columns[c], self.col_stats[c][StatType.COUNT][0])
                    for c in cols], axis=1)
            elif st == Stype.timestamp:
                block = np.stack([np.asarray(self.columns[c], np.int64)
                                  for c in cols], axis=1)
            elif st in (Stype.text_embedded, Stype.text_tokenized):
                dtype = (np.float32 if st == Stype.text_embedded
                         else np.int32)
                block = np.stack([np.asarray(self.columns[c], dtype)
                                  for c in cols], axis=1)
            else:  # relation: scalars or fixed-width rows
                block = np.concatenate(
                    [np.asarray(self.columns[c], np.float32).reshape(
                        self.num_rows, -1) for c in cols], axis=1)
            feats[st] = block

        y = None
        if self.target_col is not None:
            y = np.asarray(self.columns[self.target_col], np.float32)
            y = y.reshape(len(y), -1)
        self.tensor_frame = TensorFrame(
            feats=feats, col_names={st: list(by_stype[st]) for st in feats},
            y=y)
        return self

    def split(self):
        """(train, val, test) views over the integer split column
        (0 = train, 1 = val, 2 = test)."""
        if self.split_col is None:
            raise ValueError("dataset has no split column")
        self.materialize()
        split = np.asarray(self.columns[self.split_col])
        return tuple(DatasetView(self, np.nonzero(split == part)[0])
                     for part in (0, 1, 2))


class DatasetView:
    """Row-subset view of a materialized Dataset (one split)."""

    def __init__(self, parent: Dataset, indices: np.ndarray):
        self.parent = parent
        self.indices = indices
        self.tensor_frame = parent.tensor_frame[indices]
