"""The SSL → supervised transfer of the PyTorch port against ``rmm_tpu`` on
the CPU: the stdlib reader of the JAX package's checkpoints, the port's
``load_components``, the supervised fused model ``TABGNNFusedS``,
``--freeze`` on it, three supervised steps after a transfer, and the CLIs.

The committed JAX checkpoint ``tests/fixtures/torch_port/transfer_ssl_ckpt``
(``rmm_tpu``'s ``PretrainTrainer`` after three mcm-lp steps at C = 16, 2
layers, on a 1,000-row synthetic AML) and the record of three supervised
steps from it, ``transfer_record.npz``, are written by
``tools/make_torch_port_transfer_fixture.py``.

Tolerances: the reader's arrays bitwise; the forward's logits 1e-5
(float32, sums in another order); the three steps by
``rmm_tpu_torch.convert.check_record``'s float32 limits (their reasons are
stated there). Grafted and kept leaves are compared by name.
"""
import itertools
import json
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from rmm_tpu.datasets import IBMTransactionsAML as JaxAML
from rmm_tpu.datasets import write_synthetic_aml_csv
from rmm_tpu.train.trainer import Trainer as JaxTrainer
from rmm_tpu.utils import checkpoint as jax_ckpt
from rmm_tpu.utils.config import Config as JaxConfig
from rmm_tpu_torch.cli import fused
from rmm_tpu_torch.cli import main as train_cli
from rmm_tpu_torch.cli import predict
from rmm_tpu_torch.convert import (check_record, flatten_variables, from_jax,
                                   load_record, loss_terms, random_variables,
                                   torch_key)
from rmm_tpu_torch.datasets import IBMTransactionsAML
from rmm_tpu_torch.datasets.base import PretrainType
from rmm_tpu_torch.train.pretrain import PretrainTrainer
from rmm_tpu_torch.train.task_models import TABGNNFusedS
from rmm_tpu_torch.train.trainer import Trainer, is_frozen
from rmm_tpu_torch.utils import checkpoint, jax_checkpoint
from rmm_tpu_torch.utils.config import Config
from tests.torch_port_util import nest, one_torch_thread  # noqa: F401

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures", "torch_port")
RECORD = os.path.join(FIXTURES, "transfer_record.npz")
TRANSFER = ["node_encoder", "edge_encoder"]


@pytest.fixture(scope="module")
def record(tmp_path_factory):
    rec = load_record(RECORD)
    st = json.loads(str(rec["settings"]))
    csv = write_synthetic_aml_csv(
        str(tmp_path_factory.mktemp("transfer") / "aml.csv"),
        num_rows=st["rows"], num_accounts=st["num_accounts"],
        seed=st["data_seed"])
    return rec, st, csv, os.path.join(FIXTURES, st["checkpoint"])


def cli_args(st: dict, model: str) -> list[str]:
    return ["--model", model, "--n_hidden", str(st["channels"]),
            "--n_gnn_layers", str(st["num_layers"]), "--num_neighs",
            *map(str, st["khop_neighbors"]), "--batch_size",
            str(st["batch_size"])]


def jax_trainer(st: dict, csv: str, model: str):
    cfg = JaxConfig(model=model, data=csv, batch_size=st["batch_size"],
                    n_hidden=st["channels"], n_gnn_layers=st["num_layers"],
                    num_neighs=tuple(st["khop_neighbors"]), dropout=0.0,
                    seed=st["seed"])
    ds = JaxAML(csv, khop_neighbors=cfg.num_neighs, channels=st["channels"])
    return JaxTrainer(cfg, ds), ds


def port_trainer(st: dict, csv: str, model: str, freeze=False) -> Trainer:
    cfg = Config(model=model, data=csv, batch_size=st["batch_size"],
                 n_hidden=st["channels"], n_gnn_layers=st["num_layers"],
                 num_neighs=tuple(st["khop_neighbors"]), dropout=0.0,
                 lr=st["lr"], seed=st["seed"], freeze=freeze, device="cpu")
    return Trainer(cfg, IBMTransactionsAML(csv,
                                           khop_neighbors=cfg.num_neighs))


def flat_leaves(tree) -> dict:
    """``{"a/b": array}`` of a nested tree of arrays (lists by index)."""
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        key = "/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                       for k in path)
        out[key] = leaf
    return out


def assert_bitwise_equal(got, want):
    g, w = flat_leaves(got), flat_leaves(want)
    assert set(g) == set(w)
    for k, a in w.items():
        b = g[k]
        if isinstance(a, (np.ndarray, np.generic)) and a.dtype.name == \
                "bfloat16":
            # bf16 decodes to float32: its bit pattern in the high half
            bits = np.asarray(b, np.float32).view(np.uint32)
            assert b.shape == a.shape, k
            assert (bits & 0xFFFF == 0).all(), k
            assert np.array_equal((bits >> 16).astype(np.uint16),
                                  np.asarray(a).view(np.uint16)), k
        elif isinstance(a, (np.ndarray, np.generic)):
            assert a.dtype == b.dtype and a.shape == b.shape, k
            assert np.asarray(a).tobytes() == np.asarray(b).tobytes(), k
        else:
            assert type(a) is type(b) and a == b, k


# ------------------------------------------------------------- reader


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_reader_equals_msgpack_restore(tmp_path, dtype):
    """Every file that ``rmm_tpu``'s ``save_checkpoint`` writes (components,
    ``extras``, ``opt_state``) decodes to ``msgpack_restore``'s arrays,
    bitwise: a leaf of each kind flax writes, in ``dtype``."""
    rng = np.random.RandomState(0)
    cast = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    params = {"model": {"layer_0": {"kernel": jnp.asarray(
        rng.randn(17, 33), cast), "bias": jnp.asarray(rng.randn(33), cast)},
        "scalar": jnp.asarray(1.5, cast), "empty": jnp.zeros((0, 3), cast)},
        "decoder": {"w": jnp.asarray(rng.randn(4, 2, 3), cast),
                    "ids": jnp.arange(7, dtype=jnp.int32)}}
    variables = {"params": params, "batch_stats": {"model": {
        "mean": jnp.asarray(rng.randn(5), jnp.float32)}}}
    opt_state = {"count": np.int32(3), "mu": params["decoder"]["w"],
                 "lr": 2e-4, "step": 12, "flag": True, "none": None}
    ck = jax_ckpt.save_checkpoint(str(tmp_path), 0, variables, opt_state,
                                  best_m=0.5)
    for name in ("model", "decoder", "extras", "opt_state"):
        with open(os.path.join(ck, name), "rb") as f:
            data = f.read()
        assert_bitwise_equal(jax_checkpoint.unpackb(data),
                             serialization.msgpack_restore(data))
    tree = jax_checkpoint.read_checkpoint(ck)
    assert set(tree) == {"params", "batch_stats"}
    assert set(tree["params"]) == {"model", "decoder"}


@pytest.mark.parametrize("name", ["edge_encoder", "model", "mcm_head",
                                  "lp_head", "extras"])
def test_reader_reads_the_committed_jax_checkpoint(record, name):
    ck = record[3]
    with open(os.path.join(ck, name), "rb") as f:
        data = f.read()
    assert_bitwise_equal(jax_checkpoint.read_component(os.path.join(
        ck, name)), serialization.msgpack_restore(data))


def test_reader_refuses_orbax_chunked_and_old_formats(record, tmp_path):
    ck = str(tmp_path / "ck")
    shutil.copytree(record[3], ck)
    os.remove(os.path.join(ck, "model"))
    os.makedirs(os.path.join(ck, "model"))           # an orbax component
    with pytest.raises(NotImplementedError, match="orbax"):
        jax_checkpoint.read_checkpoint(ck)
    shutil.rmtree(os.path.join(ck, "model"))
    with open(os.path.join(ck, "model"), "wb") as f:
        f.write(serialization.msgpack_serialize(
            {"w": {"__msgpack_chunked_array__": True, "shape": {"0": 2},
                   "chunks": {"0": np.zeros(2, np.float32)}}}))
    with pytest.raises(NotImplementedError, match="chunked"):
        jax_checkpoint.read_checkpoint(ck)
    os.remove(os.path.join(ck, "model"))
    for meta in ({"ckpt_format": 1}, None):
        os.remove(os.path.join(ck, "meta.json"))
        if meta is not None:
            with open(os.path.join(ck, "meta.json"), "w") as f:
                json.dump(meta, f)
        with pytest.raises(ValueError, match="format v1"):
            jax_checkpoint.read_checkpoint(ck)
    with pytest.raises(ValueError, match="msgpack"):
        jax_checkpoint.unpackb(b"\xc1")


# ---------------------------------------------------- load_components


@pytest.fixture(scope="module")
def port_ssl_checkpoint(record, tmp_path_factory):
    """The committed JAX SSL checkpoint loaded into the port's pretrainer
    (a JAX checkpoint resumes there) and saved as the port's own."""
    _, st, csv, ck = record
    cfg = fused.config_from_args(fused.build_parser().parse_args([
        "--dataset", csv, "--channels", str(st["channels"]),
        "--num_layers", str(st["num_layers"]), "--num_neg_samples",
        str(st["num_neg_samples"]), "--khop_neighbors",
        *map(str, st["khop_neighbors"]), "--batch_size",
        str(st["batch_size"]), "--device", "cpu"]))
    ds = IBMTransactionsAML(csv, khop_neighbors=cfg.num_neighs, pretrain={
        PretrainType.MASK, PretrainType.LINK_PRED})
    tr = PretrainTrainer(cfg, ds, "mcm-lp")
    tr.restore(ck)
    want = checkpoint.read_state(ck)
    for k, v in tr.model.state_dict().items():
        if k.endswith(("running_mean", "running_var")):
            k = checkpoint.extras_key(k, pretrainer=True)
        assert torch.equal(v, want[k]), k
    return tr.save(str(tmp_path_factory.mktemp("port_ssl")), 0, {})


@pytest.mark.parametrize("source", ["jax", "port"])
@pytest.mark.parametrize("model", ["tabgnn", "tabgnnfused"])
def test_load_components_grafts_what_the_reference_grafts(
        record, port_ssl_checkpoint, model, source):
    """``--load_model`` without ``--checkpoint``: the encoders' leaves that
    the SSL checkpoint holds at the model's shapes, and no BatchNorm
    statistic, for the JAX checkpoint and for the port's own copy of it.
    The reference merges ``extras`` whatever the components, but the JAX
    pretrainer saves its statistics without the ``model`` prefix that a
    task model's have, so it grafts none of them."""
    _, st, csv, ck = record
    jtr, _ = jax_trainer(st, csv, model)
    shapes = {k: np.shape(v)
              for k, v in flatten_variables(jtr.variables).items()}
    start = random_variables(shapes, 5)
    ref = flatten_variables(jax.device_get(jax_ckpt.load_components(
        ck, jax.tree_util.tree_map(jnp.asarray, nest(start)), TRANSFER)))
    ref_grafted = {torch_key(k)[0] for k in start
                   if not np.array_equal(ref[k], start[k])}

    tr = port_trainer(st, csv, model)
    tr.model.load_state_dict(from_jax(start, tr.model))
    loaded = checkpoint.load_components(
        ck if source == "jax" else port_ssl_checkpoint, tr.model, TRANSFER)
    assert set(loaded["grafted"]) == ref_grafted
    assert set(loaded["kept"]) == set(tr.model.state_dict()) - ref_grafted
    assert ref_grafted and all(k.startswith("edge_encoder.")
                               for k in ref_grafted)
    want = from_jax(ref)
    for k, v in tr.model.state_dict().items():
        assert torch.equal(v, want[k]), k
    stats = [k for k in want if k.endswith("running_var")]
    assert stats and not set(stats) & set(loaded["grafted"])


def test_load_components_raises_where_asked(record):
    _, st, csv, ck = record
    tr = port_trainer(st, csv, "tabgnnfused")
    with pytest.raises(FileNotFoundError, match="node_encoder"):
        checkpoint.load_components(ck, tr.model, on_mismatch="raise")
    with pytest.raises(ValueError, match="shape mismatch"):
        checkpoint.load_components(
            ck, port_trainer({**st, "channels": 8}, csv, "tabgnnfused").model,
            ["edge_encoder"], on_mismatch="raise")


# ------------------------------------------------------- TABGNNFusedS


@pytest.fixture(scope="module")
def fused_pair(record):
    """The JAX and the port's supervised fused model on the same seeded
    variables, and a batch of each mode."""
    _, st, csv, _ = record
    jtr, jds = jax_trainer(st, csv, "tabgnnfused")
    shapes = {k: np.shape(v)
              for k, v in flatten_variables(jtr.variables).items()}
    variables = nest(random_variables(shapes, 9))
    tr = port_trainer(st, csv, "tabgnnfused")
    tr.model.load_state_dict(from_jax(variables, tr.model))
    return jtr, jds, tr, variables


@pytest.mark.parametrize("train", [False, True])
def test_tabgnnfused_forward_matches_jax(fused_pair, train, monkeypatch):
    """Logits of the first batch of a split, eval mode on the test split
    (running statistics) and train mode on the train split (batch
    statistics, which move the running ones alike). In train mode the
    reference's PNA sums go through its scatter path: its default path
    takes them as differences of one running float32 cumsum, which here
    lands 1e-2 off the float64 aggregate (see the next test), and the
    BatchNorm over batch statistics carries that to 2.5e-4 in the
    logits."""
    if train:
        monkeypatch.setenv("RMM_SEGMENT_IMPL", "scatter")
    jtr, jds, tr, variables = fused_pair
    split = jds.edges.split()[0 if train else 2]
    mode = "train" if train else "test"
    jb = next(jtr._batches(split, mode, 0))
    pb = next(tr._batches(tr.dataset.edges.split()[0 if train else 2], mode))
    np.testing.assert_array_equal(np.asarray(jb.edge_gather), pb.edge_gather)
    jvars = jax.tree_util.tree_map(jnp.asarray, variables)
    ref, mutated = jtr.model.apply(jvars, jtr.edge_table, jtr.node_table, jb,
                                   train, mutable=["batch_stats"])
    model = tr.model.train(train)
    with torch.no_grad():
        got = model(tr.edge_table, tr.node_table, pb.to("cpu"))
    model.eval()
    assert isinstance(model, TABGNNFusedS)
    assert got.shape == (tr.cfg.batch_size, 2)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)
    if train:
        want = from_jax({"params": variables["params"],
                         "batch_stats": mutated["batch_stats"]})
        for k, v in model.state_dict().items():
            if k.endswith(("running_mean", "running_var")):
                np.testing.assert_allclose(v.numpy(), want[k].numpy(),
                                           rtol=1e-5, atol=1e-6, err_msg=k)
        tr.model.load_state_dict(from_jax(variables, tr.model))


def test_reference_pna_cumsum_sums_part_from_float64_the_port_does_not():
    """A property of the reference, pinned so that no one takes it for a
    port fault: its default PNA aggregation takes each segment's sums of x
    and x² as differences of one running float32 cumsum over all lanes, so
    a segment's E[x²] − E[x]² carries the rounding of the running total
    (~4e4 here) and its std block lands ~1.8e-3 off the float64 aggregate,
    where the port's scatter sums land ~1e-5 off (the cancellation of
    E[x²] − E[x]² alone)."""
    from rmm_tpu.ops.segment import pna_aggregate as jax_pna
    from rmm_tpu_torch.ops.segment import pna_aggregate

    rng = np.random.RandomState(3)
    e, n, f = 4000, 400, 8
    msg = (3.0 + rng.randn(e, f)).astype(np.float32)
    dst = rng.randint(0, n, e).astype(np.int32)
    mask = rng.rand(e) < 0.9
    args = (torch.from_numpy(dst), n, 1.3, torch.from_numpy(mask))
    exact = pna_aggregate(torch.from_numpy(msg).double(), *args).numpy()
    port = pna_aggregate(torch.from_numpy(msg), *args).numpy()
    ref = np.asarray(jax_pna(jnp.asarray(msg), jnp.asarray(dst), n, 1.3,
                             jnp.asarray(mask)))
    std = slice(3 * f, 4 * f)
    assert np.abs(port - exact).max() < 5e-5
    assert np.abs(ref - exact)[:, std].max() > 1e-3


def test_tabgnnfused_refuses_the_unported_tasks(record):
    _, st, csv, _ = record
    with pytest.raises(NotImplementedError, match="edge_regression"):
        TABGNNFusedS(None, None, 16, 2, task="edge_regression")
    # mcm_edge_table (tests/test_torch_mcm_edge.py) and node_classification
    # (tests/test_torch_node_models.py) are ported
    assert {"mcm_edge_table", "node_classification"} <= set(
        TABGNNFusedS.TASKS)
    # every model of the reference's menu is ported: a name outside it
    with pytest.raises(NotImplementedError, match="'gat'"):
        port_trainer(st, csv, "gat")


# ---------------------------------------- three steps after a transfer


def transferred(record):
    """The record's start, its transfer, and ``--freeze`` as it took
    its steps."""
    _, st, csv, ck = record
    tr = port_trainer(st, csv, "tabgnnfused", freeze=True)
    tr.model.load_state_dict(from_jax(random_variables(st["shapes"],
                                                       st["var_seed"]),
                                      tr.model))
    loaded = checkpoint.load_components(ck, tr.model, st["transfer"])
    return tr, loaded


def test_three_steps_after_a_transfer_match_the_jax_record(record):
    """The record's transfer (the same leaves grafted) and its three
    ``--freeze`` steps, by ``check_record``'s float32 limits."""
    rec, st, _, _ = record
    tr, loaded = transferred(record)
    assert loaded["grafted"] == sorted(
        (torch_key(k)[0] for k in st["grafted"]),
        key=list(tr.model.state_dict()).index)
    batches = list(itertools.islice(
        tr._batches(tr.dataset.edges.split()[0], "train", st["epoch"]),
        st["steps"]))
    before = {k: v.clone() for k, v in tr.model.state_dict().items()}
    tr.model.train()
    terms = [loss_terms(tr._step(gb.to("cpu"))[0], {}) for gb in batches]
    faults, summary = check_record(tr.model.state_dict(), terms, rec, "sup/",
                                   st["lr"], st["steps"], st["channels"])
    assert not faults, faults
    unmoved = {k for k, p in tr.model.named_parameters()
               if torch.equal(p, before[k])}
    assert unmoved == {torch_key(k)[0] for k in st["unmoved"]}


def test_freeze_freezes_nothing_in_tabgnnfused_as_in_the_reference(record):
    """``--freeze`` keeps parameters whose path holds ``tab_layer`` out of
    the update; the fused model's tabular layers are ``tab_conv``, so under
    it the reference moved every parameter that a gradient reaches (the
    record's unmoved ones are those of the last layer's edge update, which
    no output reads), and the port freezes nothing."""
    rec, st, _, _ = record
    tr, _ = transferred(record)
    assert not any(is_frozen(k) for k, _ in tr.model.named_parameters())
    assert all(p.requires_grad for p in tr.model.parameters())
    tr.model.train()
    gb = next(tr._batches(tr.dataset.edges.split()[0], "train"))
    tr.optimizer.zero_grad(set_to_none=True)
    torch.nn.functional.cross_entropy(tr._logits(gb.to("cpu")),
                                      torch.zeros(st["batch_size"],
                                                  dtype=torch.long)
                                      ).backward()
    unreached = {k for k, p in tr.model.named_parameters() if p.grad is None}
    assert unreached == {torch_key(k)[0] for k in st["unmoved"]}


# ---------------------------------------------------------------- CLIs


def test_cli_transfers_from_a_port_ssl_run_and_serves(record, tmp_path):
    """SSL CLI ``--save_model``, then the supervised CLI with
    ``--load_model`` alone (the edge encoder grafted), then the predict CLI
    on its checkpoint."""
    _, st, csv, _ = record
    stats = {}
    fused.main(["--dataset", csv, "--mode", "mcm-lp", "--epochs", "1",
                "--testing", "--device", "cpu", "--channels",
                str(st["channels"]), "--num_layers", str(st["num_layers"]),
                "--num_neg_samples", "8", "--khop_neighbors", "8", "8",
                "--batch_size", "64", "--save_model", "--wandb_dir",
                str(tmp_path / "ssl")], stats)
    ssl_ck = os.path.join(stats["run_dir"], "0")
    run = {}
    (rec,), _ = train_cli.main(
        ["--data", csv, *cli_args(st, "tabgnnfused"), "--epochs", "1",
         "--testing", "--device", "cpu", "--load_model", ssl_ck,
         "--wandb_dir", str(tmp_path / "sup")], run)
    assert np.isfinite(rec["loss"]) and np.isfinite(rec["val_f1"])
    grafted = run["transfer"]["grafted"]
    saved = torch.load(os.path.join(ssl_ck, "model.pt"), weights_only=True)
    assert grafted == [k for k in saved if k.startswith("edge_encoder.")]
    served = predict.main(["--data", csv, *cli_args(st, "tabgnnfused"),
                           "--load_model", os.path.join(run["run_dir"], "0"),
                           "--device", "cpu", "--output",
                           str(tmp_path / "p.csv")])
    assert len(served["id"]) == run["split_rows"][2]
    assert np.isfinite(served["score"]).all()


def test_cli_transfers_from_a_jax_checkpoint_and_serves(record, tmp_path):
    _, st, csv, ck = record
    run = {}
    (rec,), _ = train_cli.main(
        ["--data", csv, *cli_args(st, "tabgnnfused"), "--epochs", "1",
         "--testing", "--device", "cpu", "--freeze", "--load_model", ck,
         "--wandb_dir", str(tmp_path)], run)
    assert np.isfinite(rec["loss"])
    assert set(run["transfer"]["grafted"]) == {
        torch_key(k)[0] for k in st["grafted"]}
    served = predict.main(["--data", csv, *cli_args(st, "tabgnnfused"),
                           "--load_model", os.path.join(run["run_dir"], "0"),
                           "--split", "all", "--device", "cpu", "--output",
                           str(tmp_path / "p.csv")])
    assert len(served["id"]) == sum(run["split_rows"])


def test_jax_task_checkpoints_serve_and_resume(fused_pair, record, tmp_path):
    """A JAX ``tabgnnfused`` checkpoint serves through the predict CLI as
    the same weights in a port checkpoint do, and resumes training at the
    next epoch; a JAX SSL checkpoint does not serve (no node encoder, no
    classifier)."""
    _, st, csv, ssl_ck = record
    variables = fused_pair[3]
    ck = jax_ckpt.save_checkpoint(str(tmp_path / "run_jax"), 0, variables,
                                  best_m=0.25)
    port_ck = checkpoint.save_checkpoint(str(tmp_path / "port"),
                                         from_jax(variables))
    args = ["--data", csv, *cli_args(st, "tabgnnfused"), "--device", "cpu"]
    outs = [predict.main(args + ["--load_model", c, "--output",
                                 str(tmp_path / f"{i}.csv")])
            for i, c in enumerate((ck, port_ck))]
    np.testing.assert_array_equal(outs[0]["id"], outs[1]["id"])
    np.testing.assert_array_equal(outs[0]["score"], outs[1]["score"])
    history, _ = train_cli.main(args + ["--epochs", "1", "--testing",
                                        "--checkpoint", "--load_model", ck,
                                        "--wandb_dir", str(tmp_path)])
    assert [h["epoch"] for h in history] == [1]
    assert os.path.isdir(os.path.join(tmp_path, "run_jax", "1"))
    with pytest.raises(FileNotFoundError, match="node_encoder"):
        predict.main(args + ["--load_model", ssl_ck, "--output",
                             str(tmp_path / "x.csv")])
