"""Dataset plumbing: CSV I/O, the temporal split, the pretraining masks and
target packing (counterparts of ``rmm_tpu/datasets/base.py``).

A table is an ordered ``dict`` of 1-D numpy columns. Packed target layouts
(float32):
  supervised:        [label, src, dst, edge_id]
  MASK + LINK_PRED:  [masked_value, masked_col_idx, src, dst, edge_id]
  MASK only:         [masked_value, masked_col_idx]
  LINK_PRED only:    [src, dst, edge_id]
Masked-column indices count the numerical maskable columns first, then the
categorical ones (the order ``SSLoss.mcm_loss`` assumes).
"""
from __future__ import annotations

import csv
import enum
import os
from typing import Optional, Sequence

import numpy as np

from ..frame.stats import is_missing, value_counts


class PretrainType(enum.Enum):
    MASK = 1
    MASK_VECTOR = 2
    LINK_PRED = 3


def parse_pretrain_args(pretrain) -> set:
    """'mask'/'mv'/'lp' strings → a PretrainType set. MASK_VECTOR changes
    no target: the mask vector reads the MASK target's masked-column index,
    and :func:`pack_target` packs by MASK and LINK_PRED alone."""
    table = {"mask": PretrainType.MASK, "mv": PretrainType.MASK_VECTOR,
             "lp": PretrainType.LINK_PRED}
    return {table[p] for p in pretrain or ()}


# ---------------------------------------------------------------------------
# CSV (numpy + the csv module; no pandas)
# ---------------------------------------------------------------------------

#: the cells pandas' reader takes as missing (its default ``na_values``)
PANDAS_NA = frozenset({
    "", "#N/A", "#N/A N/A", "#NA", "-1.#IND", "-1.#QNAN", "-NaN", "-nan",
    "1.#IND", "1.#QNAN", "<NA>", "N/A", "NA", "NULL", "NaN", "None", "n/a",
    "nan", "null"})


def _parse_column(cells: list[str]) -> np.ndarray:
    """Infer a column's type as pandas' reader would: a cell it reads as
    missing (:data:`PANDAS_NA`) is empty; then int64 if every cell is an
    integer, else float64 if every non-empty cell is a number (empty =
    NaN), else an object column of strings ('' = missing)."""
    cells = ["" if c in PANDAS_NA else c for c in cells]
    arr = np.asarray(cells, dtype=str)
    try:
        return arr.astype(np.int64)
    except ValueError:
        pass
    try:
        return np.where(arr == "", "nan", arr).astype(np.float64)
    except ValueError:
        return np.asarray(cells, dtype=object)


def mangle_duplicates(header: list[str]) -> list[str]:
    """A repeated column name gets ``.1``, ``.2``, ... as pandas' reader
    gives it (the raw IBM AML CSV has two ``Account`` columns)."""
    seen: dict[str, int] = {}
    out = []
    for name in header:
        k = seen.get(name, 0)
        seen[name] = k + 1
        out.append(name if k == 0 else f"{name}.{k}")
    return out


def read_csv_columns(path: str, text_columns: Optional[Sequence[str]] = None
                     ) -> dict[str, np.ndarray]:
    """The CSV's columns by name, each typed as :func:`_parse_column` infers.
    With ``text_columns``, only those are inferred; every other column is
    read as float64 by numpy's C parser, in one pass (a wide all-numerical
    table, such as Elliptic's 166 feature columns, reads 4× faster); a cell
    of them that does not parse raises numpy's ``ValueError``."""
    with open(path, newline="") as f:
        header = mangle_duplicates(next(csv.reader(f)))
    keep = (range(len(header)) if text_columns is None else
            [i for i, n in enumerate(header) if n in set(text_columns)])
    floats = [i for i in range(len(header)) if i not in set(keep)]
    block = None
    if floats:
        block = np.loadtxt(path, delimiter=",", skiprows=1, usecols=floats,
                           dtype=np.float64, ndmin=2)
    cells = {i: [] for i in keep}
    with open(path, newline="") as f:
        rows = csv.reader(f)
        next(rows)
        for row in rows:
            for i, c in cells.items():
                c.append(row[i])
    out = {i: _parse_column(c) for i, c in cells.items()}
    out.update((i, block[:, k]) for k, i in enumerate(floats))
    return {name: out[i] for i, name in enumerate(header)}


def shared_node_ids(src: np.ndarray, dst: np.ndarray):
    """Source and destination ids (customers and articles, reviewers and
    items) → codes in one id space: the index of ``str(src)`` or ``"a_" +
    str(dst)`` in their sorted union (pandas' category codes)."""
    keys = np.array([str(v) for v in src] + ["a_" + str(v) for v in dst])
    codes = np.unique(keys, return_inverse=True)[1].astype(np.int64)
    return codes[:len(src)], codes[len(src):]


def text_cells(values: np.ndarray) -> list[str]:
    """A text column of :func:`read_csv_columns` as strings, a missing cell
    as ``""`` (what ``fillna("")`` gives after pandas' reader; a column of
    missing cells alone reads as NaN floats)."""
    return [v if isinstance(v, str) else "" for v in values]


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
    text = [_format_column(v).tolist() for v in columns.values()]
    with open(path, "w", newline="") as f:
        w = csv.writer(f, lineterminator="\n")
        w.writerow(list(columns))
        w.writerows(zip(*text))


# ---------------------------------------------------------------------------
# splits and targets
# ---------------------------------------------------------------------------

def apply_split(columns: dict[str, np.ndarray], split_type: str,
                splits: Sequence[float],
                timestamp_col: Optional[str]) -> dict[str, np.ndarray]:
    """Adds the int64 ``split`` column (0 train, 1 val, 2 test) of an edge
    or node table: ``temporal_daily`` (:func:`temporal_balanced_split`),
    ``temporal`` (:func:`temporal_split`), ``cutoff``
    (:func:`cutoff_split`, ``splits`` the cut-off times) over
    ``timestamp_col``, and ``random`` for any other name
    (:func:`random_split`)."""
    if split_type == "temporal_daily":
        return temporal_balanced_split(columns, splits, timestamp_col)
    if split_type == "temporal":
        return temporal_split(columns, splits, timestamp_col)
    if split_type == "cutoff":
        return cutoff_split(columns, splits, timestamp_col)
    return random_split(columns, splits)


def random_split(columns: dict[str, np.ndarray],
                 splits: Sequence[float]) -> dict[str, np.ndarray]:
    """``RandomState(0)``'s permutation of the rows: its first
    ``int(n · splits[0])`` train, the next ``int(n · splits[1])`` val, the
    rest test."""
    n = len(next(iter(columns.values())))
    perm = np.random.RandomState(0).permutation(n)
    n_train, n_val = int(n * splits[0]), int(n * splits[1])
    split = np.full(n, 2, dtype=np.int64)
    split[perm[:n_train]] = 0
    split[perm[n_train:n_train + n_val]] = 1
    columns["split"] = split
    return columns


def cutoff_split(columns: dict[str, np.ndarray], cutoffs: Sequence[float],
                 timestamp_col: str) -> dict[str, np.ndarray]:
    """Rows before ``cutoffs[0]`` train, after ``cutoffs[-1]`` test, the
    rest (both cut-offs included) val."""
    ts = np.asarray(columns[timestamp_col])
    split = np.ones(len(ts), dtype=np.int64)
    split[ts < cutoffs[0]] = 0
    split[ts > cutoffs[-1]] = 2
    columns["split"] = split
    return columns


def temporal_split(columns: dict[str, np.ndarray], splits: Sequence[float],
                   timestamp_col: str) -> dict[str, np.ndarray]:
    """Rows ranked by ``timestamp_col`` (stable: ties keep the file's
    order): the first ``int(n · splits[0])`` train, the next
    ``int(n · splits[1])`` val, the rest test."""
    ts = np.asarray(columns[timestamp_col])
    rank = np.empty(len(ts), dtype=np.int64)
    rank[np.argsort(ts, kind="stable")] = np.arange(len(ts))
    n_train = int(len(ts) * splits[0])
    n_val = int(len(ts) * splits[1])
    split = np.full(len(ts), 2, dtype=np.int64)
    split[rank < n_train] = 0
    split[(rank >= n_train) & (rank < n_train + n_val)] = 1
    columns["split"] = split
    return columns


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


def create_mask(cache_root: Optional[str], num_rows: int,
                maskable_columns: Sequence[str]) -> np.ndarray:
    """Per-row choice of the column to mask, ``RandomState(0)``, cached
    in ``<cache_root>.mask.npy`` and read back only when its length
    matches."""
    cache = f"{cache_root}.mask.npy" if cache_root else None
    if cache and os.path.exists(cache):
        mask = np.load(cache, allow_pickle=True)
        if len(mask) == num_rows:
            return mask
    rng = np.random.RandomState(0)
    mask = rng.choice(list(maskable_columns), size=num_rows, replace=True)
    if cache:
        try:
            np.save(cache, mask)
        except OSError:
            pass
    return mask


def _to_float(values: np.ndarray) -> np.ndarray:
    """Each value as a float, NaN where it does not parse."""
    values = np.asarray(values)
    if values.dtype.kind in "fiub":
        return values.astype(np.float64)

    def parse(v):
        try:
            return float(v)
        except (TypeError, ValueError):
            return np.nan

    return np.array([parse(v) for v in values], dtype=np.float64)


def category_codes(values: np.ndarray) -> dict:
    """Value → code by descending count (``value_counts`` order)."""
    return {v: i for i, v in enumerate(value_counts(values)[0])}


def build_mask_target(columns: dict[str, np.ndarray], mask_col: np.ndarray,
                      masked_numerical: Sequence[str],
                      masked_categorical: Sequence[str],
                      cat_codes: dict[str, dict]) -> np.ndarray:
    """[original value, masked column index] per row; a categorical value
    is stored as its code (−1 when missing)."""
    col_idx = {c: i for i, c in enumerate(masked_numerical)}
    off = len(masked_numerical)
    col_idx.update({c: off + i for i, c in enumerate(masked_categorical)})
    out = np.zeros((len(mask_col), 2), dtype=np.float32)
    for c in set(mask_col):
        rows = mask_col == c
        vals = np.asarray(columns[c])[rows]
        if c in cat_codes:
            codes = cat_codes[c]
            vals = np.array([-1 if m else codes.get(v, -1) for v, m in
                             zip(vals, is_missing(np.asarray(vals, object)))],
                            dtype=np.float64)
        else:
            vals = _to_float(vals)
        out[rows, 0] = vals
        out[rows, 1] = col_idx[c]
    return out


def blank_masked_cells(columns: dict[str, np.ndarray],
                       mask_col: np.ndarray) -> None:
    """Hide each row's masked cell: it becomes NaN, so a
    numerical cell encodes to the column mean and a categorical one to the
    NA row. Integer columns become float64, as pandas' do."""
    for c in set(mask_col):
        rows = mask_col == c
        col = np.asarray(columns[c])
        col = (col.astype(object) if col.dtype.kind in "OUS"
               else col.astype(np.float64))
        col[rows] = np.nan
        columns[c] = col


def pack_target(pretrain: set, link: np.ndarray,
                mask_target: Optional[np.ndarray],
                supervised: Optional[np.ndarray]) -> Optional[np.ndarray]:
    """The packed target column for the pretraining set (empty: the
    supervised layout)."""
    if not pretrain:
        if supervised is None:
            return None
        sup = supervised.astype(np.float32).reshape(len(supervised), -1)
        return np.concatenate([sup, link], axis=1)
    if {PretrainType.MASK, PretrainType.LINK_PRED}.issubset(pretrain):
        return np.concatenate([mask_target, link], axis=1)
    if PretrainType.MASK in pretrain:
        return mask_target
    if PretrainType.LINK_PRED in pretrain:
        return link
    return None
