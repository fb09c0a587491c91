"""Column statistics computed at materialization time (numpy only)."""
from __future__ import annotations

import enum
from typing import Any

import numpy as np

from .stype import Stype


class StatType(enum.Enum):
    COUNT = "COUNT"    # (ordered category values, counts) — count-desc
    MEAN = "MEAN"
    STD = "STD"


def is_missing(values: np.ndarray) -> np.ndarray:
    """Missing cells of an object column: None, NaN or the empty string
    (what a CSV reader yields for an empty field)."""
    return np.array([v is None or v == "" or (isinstance(v, float) and v != v)
                     for v in values], dtype=bool)


def value_counts(values: np.ndarray) -> tuple[list, list]:
    """Distinct non-missing values by descending count, ties in order of
    first appearance — the order of ``pandas.Series.value_counts()``, which
    decides the categorical codes."""
    vals = np.asarray(values, dtype=object)
    vals = vals[~is_missing(vals)]
    if vals.size == 0:
        return [], []
    uniq, first, counts = np.unique(vals.astype(str), return_index=True,
                                    return_counts=True)
    by_first = np.argsort(first, kind="stable")
    first, counts = first[by_first], counts[by_first]
    order = np.argsort(-counts, kind="stable")
    return [vals[first[i]] for i in order], [int(counts[i]) for i in order]


def compute_numerical_stats(values: np.ndarray) -> dict[StatType, Any]:
    vals = np.asarray(values, dtype=np.float64)
    finite = vals[np.isfinite(vals)]
    if finite.size == 0:
        finite = np.zeros(1)
    return {StatType.MEAN: float(finite.mean()),
            StatType.STD: float(finite.std())}


def compute_col_stats(values: np.ndarray, st: Stype) -> dict[StatType, Any]:
    if st == Stype.numerical:
        return compute_numerical_stats(values)
    if st == Stype.categorical:
        return {StatType.COUNT: value_counts(values)}
    return {}
