"""Raw Kaggle IBM AML transactions → the training CSV
(``rmm_tpu/datasets/prepare_aml.py`` in numpy and the ``csv`` module):

    python -m rmm_tpu_torch.datasets.prepare_aml <raw.csv> <out.csv>

The two ``Account`` columns (``Account`` and ``Account.1`` once read)
become ``From ID`` and ``To ID`` in place, each a global account id: the
code of ``"<bank>_<account>"`` in the sorted union of both sides' keys,
written as float64. ``%Y/%m/%d %H:%M`` timestamps become unix seconds (read
as UTC, as pandas reads a naive time). ``Amount Received`` and ``Amount
Paid`` become ``log1p`` of the amount (a cell that is not a number: NaN),
min-max scaled over the non-NaN values. Every other column is written as
it was read.
"""
from __future__ import annotations

import sys

import numpy as np

from .base import _to_float, read_csv_columns, write_csv_columns


def account_ids(bank_from, acct_from, bank_to, acct_to):
    """Global ids of both sides' (bank, account) pairs: each key's index in
    their sorted union (pandas' category codes of the concatenation)."""
    keys = np.array([f"{b}_{a}" for b, a in zip(bank_from, acct_from)]
                    + [f"{b}_{a}" for b, a in zip(bank_to, acct_to)])
    codes = np.unique(keys, return_inverse=True)[1].astype(np.float64)
    return codes[:len(acct_from)], codes[len(acct_from):]


def unix_seconds(values: np.ndarray) -> np.ndarray:
    """``%Y/%m/%d %H:%M`` strings → int64 seconds since the epoch (UTC)."""
    iso = np.char.replace(np.char.replace(
        np.asarray(values, dtype=str), "/", "-"), " ", "T")
    return iso.astype("datetime64[s]").astype(np.int64)


def prepare_aml_transactions(columns: dict) -> dict:
    """The raw table's columns (``read_csv_columns``' dict) → the prepared
    table's, in the raw column order."""
    rename = {"Account": "From ID", "Account.1": "To ID"}
    if not set(rename) <= set(columns):
        rename = {}
    out = {rename.get(k, k): v for k, v in columns.items()}
    out["From ID"], out["To ID"] = account_ids(
        out["From Bank"], out["From ID"], out["To Bank"], out["To ID"])
    if out["Timestamp"].dtype.kind not in "iuf":
        out["Timestamp"] = unix_seconds(out["Timestamp"])
    for col in ("Amount Received", "Amount Paid"):
        if col in out:
            v = np.log1p(_to_float(out[col]))
            lo, hi = np.nanmin(v), np.nanmax(v)
            out[col] = (v - lo) / max(hi - lo, 1e-12)
    return out


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    src, dst = argv[0], argv[1]
    write_csv_columns(dst, prepare_aml_transactions(read_csv_columns(src)))
    print(f"wrote {dst}")


if __name__ == "__main__":
    main()
