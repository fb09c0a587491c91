"""Synthetic IBM-AML-shaped transactions (numpy only).

Same generator as ``rmm_tpu/datasets/synthetic.py::synthetic_aml_frame``:
the same ``RandomState`` stream, draw for draw, so a seed gives the same
table in both packages. The table is an ordered ``dict`` of numpy columns
in the CSV's column order.
"""
from __future__ import annotations

import numpy as np

from .base import write_csv_columns


def synthetic_aml_frame(num_rows: int = 2000, num_accounts: int = 300,
                        num_days: int = 10, fraud_rate: float = 0.1,
                        seed: int = 0) -> dict[str, np.ndarray]:
    """AML-shaped transactions with a planted fraud signal (large amounts,
    a currency pair and a small ring of accounts)."""
    rng = np.random.RandomState(seed)
    n = num_rows
    is_fraud = rng.rand(n) < fraud_rate
    ring = rng.choice(num_accounts, size=max(num_accounts // 20, 2),
                      replace=False)

    from_id = rng.randint(0, num_accounts, n)
    to_id = rng.randint(0, num_accounts, n)
    from_id[is_fraud] = rng.choice(ring, is_fraud.sum())
    to_id[is_fraud] = rng.choice(ring, is_fraud.sum())
    amount = np.where(is_fraud, rng.lognormal(6, 1, n), rng.lognormal(3, 1, n))
    currencies = np.array(["USD", "EUR", "GBP", "BTC"])
    pay_cur = currencies[rng.randint(0, 4, n)]
    pay_cur[is_fraud & (rng.rand(n) < 0.7)] = "BTC"
    formats = np.array(["Wire", "ACH", "Cheque", "Card", "Bitcoin"])
    fmt = formats[rng.randint(0, 5, n)]
    fmt[is_fraud & (rng.rand(n) < 0.6)] = "Bitcoin"

    # draw order matters: Timestamp, From Bank, To Bank, then Receiving
    # Currency (the JAX generator's dict literal)
    timestamp = rng.randint(0, num_days * 86400, n).astype(np.int64)
    from_bank = rng.randint(0, 10, n)
    to_bank = rng.randint(0, 10, n)
    recv_cur = currencies[rng.randint(0, 4, n)]
    return {
        "Timestamp": timestamp,
        "From Bank": from_bank,
        "From ID": from_id.astype(np.float64),
        "To Bank": to_bank,
        "To ID": to_id.astype(np.float64),
        "Amount Received": amount,
        "Receiving Currency": recv_cur.astype(object),
        "Amount Paid": amount,
        "Payment Currency": pay_cur.astype(object),
        "Payment Format": fmt.astype(object),
        "Is Laundering": is_fraud.astype(int).astype(str).astype(object),
    }


def write_synthetic_aml_csv(path: str, **kw) -> str:
    write_csv_columns(path, synthetic_aml_frame(**kw))
    return path
