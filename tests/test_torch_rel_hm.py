"""Rel-H&M on the CPU against the JAX package: the synthetic writer's CSV
byte for byte; the tables (every token block, the packed target, the split,
the graph) with numeric ids and with the customers' ids rewritten as hex
strings, as the published data has them; the dispatch by path; three
``--task mcm_edge_table`` steps of ``tabgnn`` and three mcm-lp pretraining
steps against the JAX record ``tests/fixtures/torch_port/rel_hm_record.npz``
(``tools/make_torch_port_device_fixture.py --records rel_hm``: dropout 0)
within ``convert.check_record``'s limits.

The reference's own reader fails on string ids under pandas 3 (its dtype
test does not take pandas' string dtype), so for hex ids it reads the
numeric codes its recoding (``rel_hm.py:51-57``, pandas categories of the
customers and ``"a_"`` + the articles) gives, computed here with pandas.
"""
import json
import os

import numpy as np
import pandas as pd
import pytest

import chip_smoke
from rmm_tpu.datasets.base import PretrainType as JaxPretrainType
from rmm_tpu.datasets.rel_hm import RelHM as JaxRelHM
from rmm_tpu.datasets.synthetic import write_synthetic_hm_csv as jax_writer
from rmm_tpu_torch.convert import load_record
from rmm_tpu_torch.datasets import RelHM, build_dataset, write_synthetic_hm_csv
from rmm_tpu_torch.datasets.base import (PretrainType, read_csv_columns,
                                         write_csv_columns)
from rmm_tpu_torch.utils.config import config_from_args, create_parser
from tests.torch_port_util import one_torch_thread  # noqa: F401

HM_REC = load_record(os.path.join(os.path.dirname(__file__), "fixtures",
                                  "torch_port", "rel_hm_record.npz"))
HM_ST = json.loads(str(HM_REC["settings"]))
JAX_PRETRAIN = {JaxPretrainType.MASK, JaxPretrainType.LINK_PRED}
PRETRAIN = {PretrainType.MASK, PretrainType.LINK_PRED}


@pytest.fixture(autouse=True)
def scatter_sums(monkeypatch):
    monkeypatch.setenv("RMM_SEGMENT_IMPL", "scatter")


@pytest.fixture(scope="module")
def hm_csv(tmp_path_factory):
    return write_synthetic_hm_csv(
        str(tmp_path_factory.mktemp("rel-hm") / "hm.csv"), num_rows=800,
        num_customers=80, num_articles=40, seed=0)


def test_writer_matches_the_reference(tmp_path):
    a = jax_writer(str(tmp_path / "a.csv"), num_rows=300, num_customers=30,
                   num_articles=12, seed=4)
    b = write_synthetic_hm_csv(str(tmp_path / "b.csv"), num_rows=300,
                               num_customers=30, num_articles=12, seed=4)
    with open(a, "rb") as fa, open(b, "rb") as fb:
        assert fa.read() == fb.read()


def hex_ids(csv, out):
    """The CSV with each customer id a 64-digit hex string whose order is
    not the ids' order, and articles as 10-digit numbers."""
    cols = read_csv_columns(csv)
    rng = np.random.RandomState(5)
    names = {c: f"{rng.randint(1 << 62):016x}" * 4
             for c in np.unique(cols["customer_id"])}
    cols["customer_id"] = np.array([names[c] for c in cols["customer_id"]],
                                   dtype=object)
    cols["article_id"] = cols["article_id"] * 1000 + 108775015
    write_csv_columns(out, cols)
    return out


def assert_same_tables(port, ref):
    np.testing.assert_array_equal(port.graph.src, ref.graph.src)
    np.testing.assert_array_equal(port.graph.dst, ref.graph.dst)
    assert port.graph.num_nodes == ref.graph.num_nodes
    for got, want in zip(port.edges.split(), ref.edges.split()):
        tf, jtf = got.tensor_frame, want.tensor_frame
        assert tf.col_names == {k: list(v) for k, v in jtf.col_names.items()}
        for st, block in tf.feats.items():
            np.testing.assert_array_equal(block, np.asarray(jtf.feats[st]),
                                          err_msg=str(st))
        np.testing.assert_array_equal(tf.y, np.asarray(jtf.y))
    assert (port.edges.masked_categorical_cardinalities()
            == ref.edges.masked_categorical_cardinalities())
    assert (port.nodes.tensor_frame.num_rows
            == ref.nodes.tensor_frame.num_rows)


def reference_codes(csv, out):
    """The reference's recoding of string ids, by its pandas code."""
    df = pd.read_csv(csv, header=0)
    cust = df["customer_id"].astype(str)
    art = "a_" + df["article_id"].astype(str)
    codes = pd.concat([cust, art]).astype("category").cat.codes
    n = len(df)
    df["customer_id"] = codes[:n].to_numpy().astype(np.int64)
    df["article_id"] = codes[n:].to_numpy().astype(np.int64)
    df.to_csv(out, index=False)
    return out


@pytest.mark.parametrize("ids", ["numeric", "hex"])
def test_tables_match_the_reference(hm_csv, tmp_path, ids):
    csv = hm_csv if ids == "numeric" else hex_ids(hm_csv,
                                                  str(tmp_path / "hm.csv"))
    ref_csv = csv if ids == "numeric" else reference_codes(
        csv, str(tmp_path / "codes.csv"))
    ref = JaxRelHM(root=ref_csv, pretrain=JAX_PRETRAIN,
                   khop_neighbors=(8, 8), channels=16)
    port = RelHM(root=csv, pretrain=PRETRAIN, khop_neighbors=(8, 8))
    assert_same_tables(port, ref)
    assert port.edges.tensor_frame.num_cols == 14     # the S = 14 tokens
    if ids == "hex":
        n_cust = len(np.unique(read_csv_columns(csv)["customer_id"]))
        assert port.graph.src.max() < n_cust <= port.graph.dst.min()


@pytest.mark.parametrize("path", ["/d/rel-hm", "/d/h-and-m/hm.csv"])
def test_build_dataset_dispatches_rel_hm_by_name(path, monkeypatch):
    import rmm_tpu_torch.datasets as datasets

    seen = {}
    monkeypatch.setattr(datasets, "RelHM",
                        lambda **kw: seen.update(kw) or "RelHM")
    args = create_parser().parse_args(["--data", path, "--model", "tabgnn",
                                       "--task", "mcm_edge_table"])
    assert build_dataset(config_from_args(args)) == "RelHM"
    assert seen["root"] == path and seen["pretrain"] == PRETRAIN
    with pytest.raises(ValueError, match="no supervised column"):
        RelHM(root=path)


@pytest.fixture(scope="module")
def record_csv(tmp_path_factory):
    d = HM_ST["data"]
    return write_synthetic_hm_csv(
        str(tmp_path_factory.mktemp("rel-hm-record") / "hm.csv"),
        num_rows=d["rows"], num_customers=d["customers"],
        num_articles=d["articles"], seed=d["seed"])


@pytest.mark.parametrize("name", ["mcm_edge", "mcm_lp"])
def test_three_steps_match_the_record(record_csv, name):
    """``--task mcm_edge_table`` (tabgnn) and mcm-lp pretraining through
    ``chip_smoke.replay_rel_hm_part``, which the card's ``rel_hm`` phase
    runs: three steps from the record's start on the record's batches (the
    first negatives equal) within ``check_record``'s limits."""
    part = chip_smoke.replay_rel_hm_part(HM_REC, HM_ST, record_csv, name,
                                         "cpu")
    assert len(part["terms"]) == HM_ST["steps"]
