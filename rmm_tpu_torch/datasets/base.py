"""Dataset plumbing for the supervised path: CSV I/O, the temporal split
and target packing (counterparts of ``rmm_tpu/datasets/base.py``).

A table is an ordered ``dict`` of 1-D numpy columns. Packed supervised
target layout: ``[label, src, dst, edge_id]`` (float32).
"""
from __future__ import annotations

import csv
from typing import Optional, Sequence

import numpy as np


# ---------------------------------------------------------------------------
# CSV (numpy + the csv module; no pandas)
# ---------------------------------------------------------------------------

def _parse_column(cells: list[str]) -> np.ndarray:
    """Infer a column's type as a CSV reader would: int64 if every cell is
    an integer, else float64 if every non-empty cell is a number (empty =
    NaN), else an object column of strings ('' = missing)."""
    arr = np.asarray(cells, dtype=str)
    try:
        return arr.astype(np.int64)
    except ValueError:
        pass
    try:
        return np.where(arr == "", "nan", arr).astype(np.float64)
    except ValueError:
        return np.asarray(cells, dtype=object)


def read_csv_columns(path: str) -> dict[str, np.ndarray]:
    with open(path, newline="") as f:
        rows = csv.reader(f)
        header = next(rows)
        cells = [[] for _ in header]
        for row in rows:
            for c, v in zip(cells, row):
                c.append(v)
    return {name: _parse_column(c) for name, c in zip(header, cells)}


def _format_column(values: np.ndarray) -> np.ndarray:
    """Cell text as pandas' ``to_csv`` writes it: shortest round-trip
    floats (NaN → empty), ints and strings as they are."""
    values = np.asarray(values)
    if values.dtype.kind == "f":
        out = values.astype(str)
        out[np.isnan(values)] = ""
        return out
    if values.dtype.kind in "iub":
        return values.astype(str)
    return np.asarray(["" if v is None else str(v) for v in values])


def write_csv_columns(path: str, columns: dict[str, np.ndarray]) -> None:
    text = [_format_column(v) for v in columns.values()]
    with open(path, "w", newline="") as f:
        w = csv.writer(f, lineterminator="\n")
        w.writerow(list(columns))
        w.writerows(zip(*text))


# ---------------------------------------------------------------------------
# splits and targets
# ---------------------------------------------------------------------------

def temporal_balanced_split(columns: dict[str, np.ndarray],
                            splits: Sequence[float],
                            timestamp_col: str) -> dict[str, np.ndarray]:
    """Day-boundary split minimizing the max relative deviation from the
    target ratios. Rewrites the timestamp column to ``ts - ts.min()`` (the
    encoder sees shifted times) and adds an int64 ``split`` column."""
    ts = np.asarray(columns[timestamp_col])
    ts = ts - ts.min()
    columns[timestamp_col] = ts
    day = (ts // (24 * 3600)).astype(np.int64)
    n_days = int(day.max()) + 1
    daily = np.bincount(day, minlength=n_days).astype(np.float64)

    csum = np.concatenate([[0.0], np.cumsum(daily)])
    total = csum[-1]
    best = None
    if n_days >= 2 and total > 0:
        i_idx, j_idx = np.triu_indices(n_days, k=1)
        t0 = csum[i_idx]
        t1 = csum[j_idx] - csum[i_idx]
        t2 = total - csum[j_idx]
        err = np.maximum.reduce([np.abs(t / total - p) / p
                                 for t, p in zip((t0, t1, t2), splits)])
        k = int(err.argmin())
        best = (int(i_idx[k]), int(j_idx[k]))
    i, j = best if best is not None else (max(n_days - 2, 0),
                                          max(n_days - 1, 1))
    split = np.zeros(len(ts), dtype=np.int64)
    split[(day >= i) & (day < j)] = 1
    split[day >= j] = 2
    columns["split"] = split
    return columns


def pack_link_column(src: np.ndarray, dst: np.ndarray) -> np.ndarray:
    """[src, dst, edge_id] per row, float32."""
    ids = np.arange(len(src), dtype=np.float32)
    return np.stack([src.astype(np.float32), dst.astype(np.float32), ids],
                    axis=1)


def pack_target(link: np.ndarray,
                supervised: Optional[np.ndarray]) -> Optional[np.ndarray]:
    """Supervised packed target ``[label, src, dst, edge_id]``."""
    if supervised is None:
        return None
    sup = supervised.astype(np.float32).reshape(len(supervised), -1)
    return np.concatenate([sup, link], axis=1)
