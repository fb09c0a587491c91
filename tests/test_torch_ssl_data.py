"""The SSL data path of the PyTorch port against ``rmm_tpu`` on the CPU: the
negative sampler (bitwise, same seed), the per-row mask and its
``<csv>.mask.npy`` cache, the packed MCM/LP targets, the blanked cells'
encoding, the MCM head sizes, and the link-prediction batches with their
negatives (exactly equal)."""
import os

import numpy as np
import pytest

from rmm_tpu.datasets import IBMTransactionsAML as JaxAML
from rmm_tpu.datasets import write_synthetic_aml_csv
from rmm_tpu.datasets.base import PretrainType as JaxPretrainType
from rmm_tpu.graph.negative import generate_negative_samples as jax_negatives
from rmm_tpu_torch.datasets import IBMTransactionsAML, build_dataset
from rmm_tpu_torch.datasets.base import PretrainType, parse_pretrain_args
from rmm_tpu_torch.frame.stype import Stype
from rmm_tpu_torch.graph.negative import generate_negative_samples
from rmm_tpu_torch.utils.config import Config
from rmm_tpu_torch.utils.seeding import mix_seed

ROWS, ACCOUNTS, FANOUTS, BATCH, NEG = 1500, 94, (8, 8), 48, 6
MODES = {"mcm-lp": ("mask", "lp"), "mcm": ("mask",), "lp": ("lp",)}


def jax_set(names):
    table = {"mask": JaxPretrainType.MASK, "lp": JaxPretrainType.LINK_PRED}
    return {table[n] for n in names}


def make_pair(mode, d):
    """(JAX dataset, port dataset, csvs, mode); each side reads its own
    copy of the CSV, so each writes its own mask cache."""
    csvs = [str(d / f"{side}.csv") for side in ("jax", "port")]
    for csv in csvs:
        write_synthetic_aml_csv(csv, num_rows=ROWS, num_accounts=ACCOUNTS,
                                seed=5)
    names = MODES[mode]
    jax_ds = JaxAML(csvs[0], pretrain=jax_set(names), khop_neighbors=FANOUTS,
                    channels=16)
    port_ds = IBMTransactionsAML(csvs[1], khop_neighbors=FANOUTS,
                                 pretrain=parse_pretrain_args(names))
    return jax_ds, port_ds, csvs, mode


@pytest.fixture(scope="module", params=list(MODES))
def pair(request, tmp_path_factory):
    return make_pair(request.param, tmp_path_factory.mktemp(request.param))


@pytest.fixture(scope="module", params=["mcm-lp", "lp"])
def lp_pair(request, tmp_path_factory):
    """The modes whose targets carry the seed edges (the SSL CLI's)."""
    return make_pair(request.param, tmp_path_factory.mktemp("lp"))


@pytest.fixture(scope="module")
def mcm_lp(tmp_path_factory):
    return make_pair("mcm-lp", tmp_path_factory.mktemp("blank"))


@pytest.mark.parametrize("seed", [0, 1, 123456789])
def test_negatives_bitwise_equal_to_jax(seed):
    rng = np.random.RandomState(seed % 1000)
    n = 40
    ei = rng.randint(0, n, (2, 300))
    pos = ei[:, :25]
    want = jax_negatives(ei, pos, 10, num_nodes=n, seed=seed)
    got = generate_negative_samples(ei, pos, 10, num_nodes=n, seed=seed)
    assert got.dtype == np.int64 and got.shape == (2, 250)
    np.testing.assert_array_equal(got, want)
    # destination corruptions first, then source corruptions
    np.testing.assert_array_equal(got[0].reshape(25, 10)[:, :5],
                                  np.repeat(pos[0][:, None], 5, 1))
    np.testing.assert_array_equal(got[1].reshape(25, 10)[:, 5:],
                                  np.repeat(pos[1][:, None], 5, 1))


def test_negatives_of_a_dense_subgraph_take_the_fallbacks():
    # every node adjacent to the positives: the probe and the last resort
    n = 6
    ei = np.array([[0, 0, 0, 0, 0, 1, 2, 3], [1, 2, 3, 4, 5, 5, 5, 5]])
    pos = ei[:, :3]
    for seed in (0, 9):
        np.testing.assert_array_equal(
            generate_negative_samples(ei, pos, 4, num_nodes=n, seed=seed),
            jax_negatives(ei, pos, 4, num_nodes=n, seed=seed))


def test_mask_cache_targets_and_codes_match_jax(pair):
    jax_ds, port_ds, csvs, mode = pair
    jax_edges, port_edges = jax_ds.edges, port_ds.edges
    caches = [csv + ".mask.npy" for csv in csvs]
    if "mcm" in mode:
        jm, pm = (np.load(c, allow_pickle=True) for c in caches)
        np.testing.assert_array_equal(jm, pm)
        assert len(pm) == ROWS
    else:
        assert not any(os.path.exists(c) for c in caches)
    jtf, ptf = jax_edges.tensor_frame, port_edges.tensor_frame
    np.testing.assert_array_equal(np.asarray(jtf.y), ptf.y)
    assert ptf.y.shape[1] == {"mcm-lp": 5, "mcm": 2, "lp": 3}[mode]
    for st, block in ptf.feats.items():
        np.testing.assert_array_equal(np.asarray(jtf.feats[st]), block,
                                      err_msg=str(st))
    assert (port_edges.masked_categorical_cardinalities()
            == jax_edges.masked_categorical_cardinalities())
    assert port_edges.masked_numerical_columns == ["Amount Paid"]


def test_blanked_cells_encode_as_missing(mcm_lp):
    _, port_ds, csvs, _ = mcm_lp
    edges = port_ds.edges
    mask = np.load(csvs[1] + ".mask.npy", allow_pickle=True)
    tf = edges.tensor_frame
    cat_names = tf.col_names[Stype.categorical]
    for c in edges.masked_categorical_columns:
        codes = tf.feats[Stype.categorical][:, cat_names.index(c)]
        assert (codes[mask == c] == -1).all(), c
        assert (codes[mask != c] >= 0).all(), c
    num = tf.feats[Stype.numerical][:, 0]
    assert np.isnan(num[mask == "Amount Paid"]).all()
    assert np.isfinite(num[mask != "Amount Paid"]).all()


def test_lp_batches_and_negatives_match_jax(lp_pair):
    jax_ds, port_ds, _, _ = lp_pair
    for mode, split in (("train", 0), ("val", 1)):
        jview = jax_ds.edges.split()[split]
        pview = port_ds.edges.split()[split]
        jy, py = np.asarray(jview.tensor_frame.y), pview.tensor_frame.y
        for i in range(2):
            rows = slice(i * BATCH, (i + 1) * BATCH)
            kw = dict(num_neg_samples=NEG, rng_seed=mix_seed(1, 0, i, 1),
                      neg_seed=mix_seed(1, 0, i, 2))
            a = jax_ds.get_lp_inputs(jy[rows], BATCH - i, mode, **kw)
            b = port_ds.get_lp_inputs(py[rows], BATCH - i, mode, **kw)
            assert (port_ds.edge_capacity, port_ds.node_capacity) == (
                jax_ds.edge_capacity, jax_ds.node_capacity)
            for field in ("edge_gather", "edge_mask", "edge_index",
                          "node_gather", "node_mask", "seed_mask", "y",
                          "neg_edge_index"):
                np.testing.assert_array_equal(
                    np.asarray(getattr(a, field)), getattr(b, field),
                    err_msg=f"{mode} batch {i}: {field}")
            assert b.neg_edge_index.shape == (2, BATCH * NEG)
            assert b.neg_edge_index.max() < b.node_mask.sum()


def test_build_dataset_takes_the_pretraining_targets(mcm_lp):
    _, _, csvs, _ = mcm_lp
    ds = build_dataset(Config(data=csvs[1], pretrain=("mask", "lp"),
                              num_neighs=FANOUTS))
    assert ds.edges.pretrain == {PretrainType.MASK, PretrainType.LINK_PRED}
    assert ds.edges.tensor_frame.y.shape[1] == 5
    # --ports adds the two port columns to the edge tokens
    ports = build_dataset(Config(data=csvs[1], pretrain=("mask", "lp"),
                                 num_neighs=FANOUTS, ports=True))
    assert ports.edges.tensor_frame.num_cols == \
        ds.edges.tensor_frame.num_cols + 2
    np.testing.assert_array_equal(ports.edges.tensor_frame.y,
                                  ds.edges.tensor_frame.y)
    # 'mv' adds no target of its own (its loss reads the MASK target), and
    # an mcm task without targets takes the masked-cell and link ones
    mv = build_dataset(Config(data=csvs[1], pretrain=("mask", "mv")))
    assert mv.edges.pretrain == {PretrainType.MASK,
                                 PretrainType.MASK_VECTOR}
    assert mv.edges.tensor_frame.y.shape[1] == 2
    mcm = build_dataset(Config(data=csvs[1], task="mcm_edge_table",
                               num_neighs=FANOUTS))
    assert mcm.edges.pretrain == {PretrainType.MASK, PretrainType.LINK_PRED}
    np.testing.assert_array_equal(mcm.edges.tensor_frame.y,
                                  ds.edges.tensor_frame.y)
