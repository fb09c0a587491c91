"""The port's data tools on the CPU against the JAX package's:
``prepare_aml`` (numpy and ``csv`` against pandas) on a raw CSV in the
Kaggle layout written here, exact for the ids and timestamps and within one
float64 ulp for the amounts, and the committed fixture's digests;
``export_eth`` (an unpickler of its own against networkx) on a
``MultiDiGraph`` pickled here, byte for byte, in a process where networkx
cannot be imported, and its refusal of any other class; Ethereum
phishing's ``use_cutoffs`` split against the reference's.
"""
import hashlib
import json
import os
import pickle
import subprocess
import sys

import networkx as nx
import numpy as np
import pytest

from rmm_tpu.datasets import export_eth as jax_export
from rmm_tpu.datasets import prepare_aml as jax_prepare
from rmm_tpu_torch.datasets import export_eth, prepare_aml
from rmm_tpu_torch.datasets.base import read_csv_columns
from tools.make_torch_port_data_tools_fixture import (eth_graph,
                                                      write_raw_aml)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(ROOT, "tests", "fixtures", "torch_port", "data_tools")


def sha(path):
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


@pytest.mark.parametrize("seed", [1, 2])
def test_prepare_aml_matches_the_reference(tmp_path, seed):
    raw = write_raw_aml(str(tmp_path / "raw.csv"), 400, seed)
    jax_prepare.main([raw, str(tmp_path / "ref.csv")])
    prepare_aml.main([raw, str(tmp_path / "port.csv")])
    ref = read_csv_columns(str(tmp_path / "ref.csv"))
    got = read_csv_columns(str(tmp_path / "port.csv"))
    assert list(got) == list(ref) and list(got)[2] == "From ID"
    for col in ("From ID", "To ID", "Timestamp", "From Bank", "Is Laundering"):
        np.testing.assert_array_equal(got[col], ref[col], err_msg=col)
    assert got["From ID"].dtype == np.float64
    assert (np.diff(np.sort(got["Timestamp"])) >= 0).all()
    for col in ("Amount Received", "Amount Paid"):
        g, r = got[col], ref[col]
        np.testing.assert_array_equal(np.isnan(g), np.isnan(r))
        ok = ~np.isnan(r)
        assert (np.abs(g[ok] - r[ok]) <= np.spacing(np.abs(r[ok]))).all()
        assert np.nanmin(g) == 0 and np.nanmax(g) == 1
    for col in ("Receiving Currency", "Payment Format"):
        assert list(got[col]) == list(ref[col])
    # the parsed times are UTC seconds
    assert got["Timestamp"].min() >= 1661990400          # 2022-09-01


def test_committed_fixture_digests(tmp_path):
    with open(os.path.join(FIXTURE, "expected.json")) as f:
        expected = json.load(f)
    out = str(tmp_path / "aml.csv")
    prepare_aml.main([os.path.join(FIXTURE, "raw_aml.csv"), out])
    assert sha(out) == expected["prepare_aml"]["sha256"]
    export_eth.main([os.path.join(FIXTURE, "eth_graph.pkl"),
                     str(tmp_path / "eth")])
    for name in ("nodes.csv", "edges.csv"):
        assert (sha(str(tmp_path / "eth" / name))
                == expected[f"export_eth/{name}"]["sha256"]), name


@pytest.mark.parametrize("cache_views", [False, True])
def test_export_eth_matches_the_reference_without_networkx(tmp_path,
                                                           cache_views):
    g = eth_graph(60, 240, 3)
    if not cache_views:      # a graph whose views were never used
        g = nx.MultiDiGraph(g)
    pkl = str(tmp_path / "g.pkl")
    with open(pkl, "wb") as f:
        pickle.dump(g, f)
    jax_export.main([pkl, str(tmp_path / "ref")])
    code = ("import sys; sys.modules['networkx'] = None\n"
            "from rmm_tpu_torch.datasets import export_eth\n"
            f"export_eth.main([{pkl!r}, {str(tmp_path / 'port')!r}])\n"
            "assert 'networkx' not in sys.modules or "
            "sys.modules['networkx'] is None\n"
            "print('ok')\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    for name in ("nodes.csv", "edges.csv"):
        assert (sha(str(tmp_path / "port" / name))
                == sha(str(tmp_path / "ref" / name))), name
    assert len(read_csv_columns(str(tmp_path / "port" / "nodes.csv"))[
        "node"]) == 60


def test_export_eth_refuses_other_classes_by_name(tmp_path):
    pkl = str(tmp_path / "other.pkl")
    with open(pkl, "wb") as f:
        pickle.dump({"graph": nx.Graph()}, f)
    with pytest.raises(pickle.UnpicklingError, match="networkx.classes.graph"):
        export_eth.load_graph(pkl)
    with open(pkl, "wb") as f:
        pickle.dump(os.path.join, f)
    with pytest.raises(pickle.UnpicklingError, match="join"):
        export_eth.load_graph(pkl)


def test_use_cutoffs_split_matches_the_reference(tmp_path):
    from rmm_tpu.datasets.eth_phishing import EthereumPhishing as JaxEth
    from rmm_tpu.datasets.synthetic import write_synthetic_node_dataset
    from rmm_tpu_torch.datasets import EthereumPhishing

    root = write_synthetic_node_dataset(str(tmp_path / "ethereum-phishing"),
                                        family="eth", num_nodes=300,
                                        num_edges=1500)
    ref = JaxEth(root=root, use_cutoffs=True, khop_neighbors=(4, 4))
    port = EthereumPhishing(root=root, use_cutoffs=True,
                            khop_neighbors=(4, 4))
    plain = EthereumPhishing(root=root, khop_neighbors=(4, 4))
    for got, want in zip(port.edges.split(), ref.edges.split()):
        np.testing.assert_array_equal(got.tensor_frame.y,
                                      np.asarray(want.tensor_frame.y))
    for mode in ("train", "val"):
        np.testing.assert_array_equal(port.graph.sampler(mode).edge_ids,
                                      ref.graph.sampler(mode).edge_ids)
    assert port.nodes.cutoffs == list(ref.nodes.cutoffs)
    ts = read_csv_columns(os.path.join(root, "edges.csv"))[
        "block_timestamp"]
    train = port.graph.sampler("train").edge_ids
    assert (ts[train] < port.nodes.cutoffs[0]).all()
    assert not np.array_equal(train, plain.graph.sampler("train").edge_ids)
