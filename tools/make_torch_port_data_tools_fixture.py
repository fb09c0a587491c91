"""Write the inputs and the reference outputs of the port's data tools
(``rmm_tpu_torch.datasets.prepare_aml``, ``...export_eth``) that
``chip_smoke.py``'s ``data_tools`` phase and ``tests/test_torch_data_tools.py``
hold the port to, where neither pandas nor networkx is installed:

- ``raw_aml.csv``: transactions in the raw Kaggle IBM AML layout (two
  ``Account`` columns, ``%Y/%m/%d %H:%M`` times, banks with leading zeros,
  hex accounts, a few amounts that are not numbers);
- ``eth_graph.pkl``: a networkx ``MultiDiGraph`` of accounts and
  transactions, pickled after its views were used (so the pickle holds
  networkx's cached view objects too);
- ``expected.json``: the sha256 and row counts of what the JAX package's
  ``prepare_aml`` (pandas) and ``export_eth`` (networkx) write from them.

    python tools/make_torch_port_data_tools_fixture.py

This tool imports both packages, pandas and networkx; it is not part of
the port.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import os
import pickle
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import networkx as nx  # noqa: E402
import numpy as np  # noqa: E402

OUT = os.path.join(ROOT, "tests", "fixtures", "torch_port", "data_tools")


def write_raw_aml(path: str, rows: int, seed: int) -> str:
    rng = np.random.RandomState(seed)
    banks = ["010", "3208", "1", "0012", "220"]
    accounts = [f"{rng.randint(1 << 32):09X}" for _ in range(rows // 8)]
    currencies = ["US Dollar", "Euro", "Yuan", "Swiss Franc"]
    formats = ["Cheque", "ACH", "Credit Card", "Reinvestment", "Wire"]
    lines = ["Timestamp,From Bank,Account,To Bank,Account,Amount Received,"
             "Receiving Currency,Amount Paid,Payment Currency,"
             "Payment Format,Is Laundering"]
    for _ in range(rows):
        day, hh, mm = 1 + rng.randint(18), rng.randint(24), rng.randint(60)
        amount = rng.lognormal(6, 2)
        bad = rng.rand() < 0.02
        lines.append(",".join([
            f"2022/09/{day:02d} {hh:02d}:{mm:02d}",
            banks[rng.randint(len(banks))],
            accounts[rng.randint(len(accounts))],
            banks[rng.randint(len(banks))],
            accounts[rng.randint(len(accounts))],
            "n/a" if bad else f"{amount:.2f}",
            currencies[rng.randint(len(currencies))],
            f"{amount * rng.uniform(0.9, 1.0):.2f}",
            currencies[rng.randint(len(currencies))],
            formats[rng.randint(len(formats))],
            str(int(rng.rand() < 0.1))]))
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
    return path


def eth_graph(accounts: int, transactions: int, seed: int) -> nx.MultiDiGraph:
    """Accounts as ``0x`` hex strings with an ``isp`` label (some without
    one), transactions with the attributes the reference's export reads
    (some without ``nonce`` or with ``value`` for ``amount``), repeated
    pairs included."""
    rng = np.random.RandomState(seed)
    g = nx.MultiDiGraph()
    addrs = [f"0x{rng.randint(1 << 62):016x}" for _ in range(accounts)]
    for a in addrs:
        if rng.rand() < 0.9:
            g.add_node(a, isp=int(rng.rand() < 0.15))
        else:
            g.add_node(a)
    for _ in range(transactions):
        u, v = (addrs[i] for i in rng.randint(accounts, size=2))
        attrs = {"timestamp": float(rng.randint(1_438_000_000,
                                                1_550_000_000)),
                 "gas": float(rng.randint(21_000, 300_000)),
                 "gas_price": float(rng.randint(1, 100)) * 1e-9}
        attrs["amount" if rng.rand() < 0.8 else "value"] = float(
            rng.lognormal(0, 3))
        if rng.rand() < 0.9:
            attrs["nonce"] = int(rng.randint(5000))
        g.add_edge(u, v, **attrs)
    list(g.nodes()), list(g.edges(data=True))   # cache networkx's views
    return g


def digest(path: str) -> str:
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


def rows(path: str) -> int:
    with open(path) as f:
        return sum(1 for _ in f) - 1


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--out", default=OUT)
    p.add_argument("--aml_rows", type=int, default=2000)
    p.add_argument("--accounts", type=int, default=300)
    p.add_argument("--transactions", type=int, default=1500)
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)

    from rmm_tpu.datasets.export_eth import main as export_eth
    from rmm_tpu.datasets.prepare_aml import main as prepare_aml

    os.makedirs(args.out, exist_ok=True)
    raw = write_raw_aml(os.path.join(args.out, "raw_aml.csv"),
                        args.aml_rows, args.seed)
    pkl = os.path.join(args.out, "eth_graph.pkl")
    with open(pkl, "wb") as f:
        pickle.dump(eth_graph(args.accounts, args.transactions, args.seed),
                    f)
    with tempfile.TemporaryDirectory() as tmp:
        prepared = os.path.join(tmp, "aml.csv")
        prepare_aml([raw, prepared])
        export_eth([pkl, os.path.join(tmp, "eth")])
        expected = {
            "prepare_aml": {"sha256": digest(prepared),
                            "rows": rows(prepared)},
            **{f"export_eth/{name}": {
                "sha256": digest(os.path.join(tmp, "eth", name)),
                "rows": rows(os.path.join(tmp, "eth", name))}
               for name in ("nodes.csv", "edges.csv")}}
    expected["settings"] = vars(args) | {"out": None}
    with open(os.path.join(args.out, "expected.json"), "w") as f:
        json.dump(expected, f, indent=1, sort_keys=True)
    print(json.dumps(expected))


if __name__ == "__main__":
    main()
