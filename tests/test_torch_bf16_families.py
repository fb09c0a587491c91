"""``--precision bf16`` across the model menu, the node tasks, the
masked-cell task and the tabular and text trainers, on the CPU against
``rmm_tpu``.

Live, on bf16 inputs made from a numpy seed: the segment sums
(``segment_sum``, ``pna_aggregate``, ``scatter_mean_update``) against a
float64 sum rounded once and against the reference's scatter path (which
adds bf16 in bf16: the distance is pinned); each GNN conv (``GINEConv``,
``GINEConvHetero``, ``TGINEConv``, ``PNAConv``, ``PNAConvHetero``,
``EdgeUpdateMLP``) and each family backbone (``GINe``, ``PNAS``, ``PNA``,
``CPNA``, ``CPNATAB``) forward on bf16 node and edge states and bf16
parameters against the reference with its sums in float32
(``tests.torch_port_util.jax_float32_segment_sums``), as the port sums.
Then every part of ``bf16_family_record.npz``
(``tools/make_torch_port_bf16_family_fixture.py``) through
``chip_smoke.replay_bf16_part``, the code ``chip_smoke.py``'s
``bf16_family_parity`` phase runs on the card, and a planted fault (a
component's last step skipped) that fails the record. Last, both CLIs
at ``--precision bf16`` for every model of the menu on every task.

Tolerances, each with its reason:

* a segment sum: within one bf16 rounding of the float64 sum (the float32
  sum is exact to 2^-24 of it, then rounded once); PNA's float32
  aggregates within 1e-5 of the largest entry of a float64 run on the same
  rounded squares, and within 1e-6 of the reference's run with float32
  sums (the same operations, another order);
* convs and backbones: 1e-4 of the largest entry, as in float32 (both
  sides round at the same places once their sums agree; the port's bf16
  rounding of a Dense product before its bias is flax's);
* the record: ``convert.check_record``'s bf16 limits for each part, as
  ``chip_smoke.bf16_part_limits`` picks them, and ``convert.BF16_OUT_TOL``
  for the start's outputs (each with its measured reason in
  ``rmm_tpu_torch/convert.py``).
"""
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from rmm_tpu.nn.gnn import conv as jconv
from rmm_tpu.nn.gnn import models as jmodels
from rmm_tpu.ops import segment as jseg
from rmm_tpu.utils.precision import compute_cast
from rmm_tpu_torch import convert
from rmm_tpu_torch.nn.gnn import conv, models
from rmm_tpu_torch.ops.segment import (pna_aggregate, scatter_mean_update,
                                       segment_sum)
from rmm_tpu_torch.utils import precision
from tests.torch_port_util import (  # noqa: F401
    init_random, jax_float32_segment_sums, jax_kernel_attention,
    load_from_jax, one_torch_thread)

RECORD = os.path.join(os.path.dirname(__file__), "fixtures", "torch_port",
                      "bf16_family_record.npz")
REC = convert.load_record(RECORD)
ST = json.loads(str(REC["settings"]))
BF16 = torch.bfloat16
C = 16
MODULE_TOL = 1e-4


@pytest.fixture(autouse=True)
def scatter_sums(monkeypatch):
    monkeypatch.setenv("RMM_SEGMENT_IMPL", "scatter")


def f32(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def one_rounding(got, want) -> float:
    """How far ``got`` lies past one bf16 rounding of ``want`` (<= 0
    where it holds)."""
    g, w = f32(got).astype(np.float64), np.asarray(want, np.float64)
    return float((np.abs(g - w) - 2.0 ** -8 * np.abs(w)
                  - 1e-30).max())


def segments(seed: int, e: int = 4000, n: int = 12, f: int = 8):
    """bf16 messages with an offset (sums that cancel nothing) into ``n``
    segments, one of them 1,000 lanes long (past bf16's 256 exact
    integers), a quarter of the lanes masked."""
    rng = np.random.RandomState(seed)
    dst = np.concatenate([np.zeros(1000, np.int32),
                          rng.randint(1, n, e - 1000).astype(np.int32)])
    msg = torch.from_numpy((rng.randn(e, f) + 3.0).astype(np.float32)) \
        .to(BF16)
    mask = rng.rand(e) < 0.75
    return msg, dst, mask, n


# ------------------------------------------------------------ segment sums


def test_segment_sum_adds_bf16_in_float32_and_rounds_once():
    msg, dst, mask, n = segments(0)
    got = segment_sum(msg, torch.from_numpy(dst), n, torch.from_numpy(mask))
    assert got.dtype == BF16
    m = f32(msg).astype(np.float64) * mask[:, None]
    exact = np.zeros((n, msg.shape[1]))
    np.add.at(exact, dst, m)
    assert one_rounding(got, exact) <= 0
    # the reference's scatter path adds in bf16: its 1,000-lane segment
    # lands far past a rounding (pinned, so it is not taken for a port
    # fault); its other segments within a few
    ref = f32(jseg.segment_sum(jnp.asarray(f32(msg)).astype(jnp.bfloat16),
                               jnp.asarray(dst), n, jnp.asarray(mask),
                               impl="scatter"))
    assert np.abs(ref[0] - exact[0]).max() > 0.01 * np.abs(exact[0]).max()


def test_segment_sum_keeps_float32_bit_for_bit():
    rng = np.random.RandomState(1)
    data = torch.from_numpy(rng.randn(500, 6).astype(np.float32))
    ids = torch.from_numpy(rng.randint(0, 9, 500))
    mask = torch.from_numpy(rng.rand(500) < 0.8)
    want = torch.zeros(10, 6).index_add_(
        0, torch.where(mask, ids, torch.full_like(ids, 9)), data)[:9]
    assert torch.equal(segment_sum(data, ids, 9, mask), want)


def test_pna_aggregate_of_bf16_messages_is_float32_as_the_scatter_path():
    """The aggregates are float32 (the reference's scatter path divides its
    sums by a float32 count); the squares are rounded to bf16 as the
    reference takes them, then summed in float32: within 1e-5 of a
    float64 run on the same squares, within 1e-6 of the reference's run
    with float32 sums; the reference's own bf16 sums land far off (its
    std block cancels)."""
    msg, dst, mask, n = segments(2)
    got = pna_aggregate(msg, torch.from_numpy(dst), n, 1.3,
                        torch.from_numpy(mask))
    assert got.dtype == torch.float32
    sq = (msg * msg).double()
    exact = pna_aggregate(msg.double(), torch.from_numpy(dst), n, 1.3,
                          torch.from_numpy(mask))
    # the float64 run squares in float64; take its E[x²] from the rounded
    # squares instead, as both packages' bf16 paths do
    m = torch.from_numpy(mask)[:, None].double()
    ids = torch.from_numpy(dst).long()
    cnt = torch.zeros(n, 1, dtype=torch.float64).index_add_(0, ids, m)
    mean = torch.zeros(n, msg.shape[1], dtype=torch.float64).index_add_(
        0, ids, msg.double() * m) / cnt.clamp(min=1)
    mean2 = torch.zeros(n, msg.shape[1], dtype=torch.float64).index_add_(
        0, ids, sq * m) / cnt.clamp(min=1)
    sd = torch.sqrt((mean2 - mean * mean).clamp(min=0) + 1e-5)
    f = msg.shape[1]
    for block in (0, 3):   # mean, std of the identity scaler
        want = (mean if block == 0 else sd).numpy()
        np.testing.assert_allclose(
            got[:, block * f:(block + 1) * f].numpy(), want, rtol=0,
            atol=1e-5 * np.abs(want).max())
    np.testing.assert_allclose(got[:, f:3 * f].numpy(),
                               exact[:, f:3 * f].numpy(), rtol=0, atol=0)
    args = (jnp.asarray(f32(msg)).astype(jnp.bfloat16), jnp.asarray(dst), n,
            1.3, jnp.asarray(mask))
    with jax_float32_segment_sums():
        same = f32(jseg.pna_aggregate(*args, impl="scatter"))
    np.testing.assert_allclose(got.numpy(), same, rtol=0,
                               atol=1e-6 * np.abs(same).max())
    ref = f32(jseg.pna_aggregate(*args, impl="scatter"))
    sd_ref = ref[:, 3 * f:4 * f]
    assert np.abs(sd_ref - sd.numpy()).max() > 0.05 * float(sd.max())


def test_scatter_mean_update_of_bf16_values_is_float32():
    rng = np.random.RandomState(3)
    x = torch.from_numpy(rng.randn(30, 8).astype(np.float32)).to(BF16)
    values = torch.from_numpy(rng.randn(900, 8).astype(np.float32) + 2) \
        .to(BF16)
    index = np.concatenate([np.zeros(400, np.int64),
                            rng.randint(1, 20, 500)])
    got = scatter_mean_update(x, torch.from_numpy(index), values)
    assert got.dtype == torch.float32
    with jax_float32_segment_sums():
        want = f32(jseg.scatter_mean_update(
            jnp.asarray(f32(x)).astype(jnp.bfloat16), jnp.asarray(index),
            jnp.asarray(f32(values)).astype(jnp.bfloat16)))
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-6 * np.abs(want).max())
    assert torch.equal(got[25:], x[25:].float())   # untouched rows


# ------------------------------------------------------- convs, backbones


def graph(seed: int, v: int = 12, e: int = 60, node_cols: int = 2,
          edge_cols: int = 3):
    """bf16 node and edge tokens (or states), every node but the last with
    >= 2 real in-edges and out-edges, the rest of the lanes real or padded
    at random, the last node padded."""
    rng = np.random.RandomState(seed)
    x = rng.randn(v, node_cols, C).astype(np.float32)
    ea = rng.randn(e, edge_cols, C).astype(np.float32)
    base = 2 * v
    src = np.concatenate([np.tile(np.arange(v), 2),
                          rng.randint(0, v, e - base)])
    dst = np.concatenate([np.tile((np.arange(v) + 1) % (v - 1), 2),
                          rng.randint(0, v - 1, e - base)])
    ei = np.stack([src, dst]).astype(np.int32)
    mask = np.concatenate([np.ones(base, bool), rng.rand(e - base) < 0.7])
    node_mask = np.ones(v, bool)
    node_mask[-1] = False
    return x, ei, ea, mask, node_mask


def bf16_forward_matches(jax_mod, port_mod, args, bf16_at, seed,
                         call_kw=None, init_kw=None):
    """The module's forward on bf16 parameters and on the arguments at
    ``bf16_at`` in bf16, in eval mode (BatchNorm's running statistics),
    against the reference's with float32 sums; the outputs' dtypes agree.
    Returns the port's outputs."""
    jargs = [jnp.asarray(a) for a in args]
    variables = init_random(jax_mod, *jargs, seed=seed, **(init_kw or {}))
    for i in bf16_at:
        jargs[i] = jargs[i].astype(jnp.bfloat16)
    with jax_float32_segment_sums(), jax_kernel_attention():
        ref = jax_mod.apply({**variables, "params": compute_cast(
            variables["params"], "bf16")}, *jargs, **(call_kw or {}))
    port = load_from_jax(port_mod, variables)
    targs = [torch.from_numpy(np.asarray(a)) for a in args]
    targs = [t.long() if t.dtype in (torch.int32, torch.int64) else t
             for t in targs]
    for i in bf16_at:
        targs[i] = targs[i].to(BF16)
    params = precision.compute_cast(dict(port.named_parameters()), "bf16")
    with torch.no_grad():
        outs = torch.func.functional_call(port, params, tuple(targs))
    single = not isinstance(outs, tuple)
    outs, refs = ((outs,), (ref,)) if single else (outs, ref)
    for o, r in zip(outs, refs):
        assert str(o.dtype).split(".")[-1] == str(r.dtype), (o.dtype,
                                                              r.dtype)
        want = f32(r)
        np.testing.assert_allclose(f32(o), want, rtol=0,
                                   atol=MODULE_TOL * np.abs(want).max())
    return outs


CONVS = {
    "gine": (lambda: jconv.GINEConv(C), lambda: conv.GINEConv(C)),
    "gine_hetero": (lambda: jconv.GINEConvHetero(C),
                    lambda: conv.GINEConvHetero(C)),
    "tgine": (lambda: jconv.TGINEConv(C, (5, 7)),
              lambda: conv.TGINEConv(C, (5, 7), edge_in=C)),
    "pna": (lambda: jconv.PNAConv(C, 1.21), lambda: conv.PNAConv(C, 1.21)),
    "pna_hetero": (lambda: jconv.PNAConvHetero(C, 1.21),
                   lambda: conv.PNAConvHetero(C, 1.21)),
}


@pytest.mark.parametrize("name", CONVS)
def test_conv_on_bf16_states_matches_jax(name):
    """bf16 node and edge states: GINE's sums (bf16 out, rounded once),
    PNA's float32 aggregates (the layer out float32, as the scatter
    path's)."""
    x, ei, ea, mask, _ = graph(11)
    jmod, pmod = CONVS[name]
    out, = bf16_forward_matches(jmod(), pmod(), (x[:, 0], ei, ea[:, 0],
                                                 mask), (0, 2), 12)
    assert out.dtype == (torch.float32 if name.startswith("pna") else BF16)


def test_edge_update_mlp_on_bf16_states_matches_jax():
    x, ei, ea, _, _ = graph(13)
    bf16_forward_matches(jconv.EdgeUpdateMLP(C), conv.EdgeUpdateMLP(C),
                         (x[:, 0], ei, ea[:, 0]), (0, 2), 14)


BACKBONES = {
    "gine": (lambda: jmodels.GINe(C, 2, True, False),
             lambda: models.GINe(2, 3, C, C, 2, edge_updates=True)),
    "pnas": (lambda: jmodels.PNAS(C, 2, 1.21, True, False),
             lambda: models.PNAS(2, 3, C, C, 2, 1.21, edge_updates=True)),
    "cpna": (lambda: jmodels.CPNA(C, 2, 3, 1.21, True, False),
             lambda: models.CPNA(2, C, C, 2, 3, 1.21, True, False)),
    "cpnatab": (lambda: jmodels.CPNATAB(C, 2, 3, 1.21, True, False,
                                        dropout=0.0),
                lambda: models.CPNATAB(2, C, C, 2, 3, 1.21, True, False,
                                       dropout=0.0)),
}
EVAL = dict(call_kw={"train": False}, init_kw={"train": False})


@pytest.mark.parametrize("name", BACKBONES)
def test_backbone_on_bf16_tokens_matches_jax(name):
    """A family's backbone, ``--emlps``, on bf16 node and edge tokens (a
    node family's batch: no float32 block), BatchNorm on its running
    statistics."""
    x, ei, ea, mask, node_mask = graph(21)
    jmod, pmod = BACKBONES[name]
    bf16_forward_matches(jmod(), pmod(), (x, ei, ea, mask, node_mask),
                         (0, 2), 22, **EVAL)


def test_pna_backbone_with_target_edges_on_bf16_matches_jax():
    x, ei, ea, mask, node_mask = graph(23)
    tgt = np.random.RandomState(24).randn(7, 3 * C).astype(np.float32)
    bf16_forward_matches(
        jmodels.PNA(C, 2, 1.21, True, False),
        models.PNA(2 * C, 3 * C, C, 2, 1.21, edge_updates=True),
        (x.reshape(len(x), -1), ei, ea.reshape(len(ea), -1), tgt, mask,
         node_mask), (0, 2, 3), 24, **EVAL)


# ---------------------------------------------------------------- record


@pytest.fixture(scope="module")
def roots(tmp_path_factory):
    return chip_smoke.bf16_record_data(
        ST, str(tmp_path_factory.mktemp("bf16_record")))


@pytest.mark.parametrize("name", list(ST["runs"]))
def test_bf16_record_part_on_the_cpu(roots, name):
    out = chip_smoke.replay_bf16_part(REC, ST, roots, name, device="cpu")
    assert out["output_err"] <= out["output_tol"]


def test_the_reference_feeds_bf16_sums_where_edges_hold_no_float32():
    """The record's tool measured, for each GNN part, how far the
    reference lands from its own record when its sums add in float32: not
    at all on AML and Ethereum (their edges hold the float32 timestamp
    block, so every message is float32), and past the default bf16 limits
    on the MUSAE cut (bf16 messages: the bf16-sum limits exist for it)."""
    for name, run in ST["runs"].items():
        gap = run.get("sums_gap")
        if gap is None:
            continue
        moved = gap["param_max_abs_err"] > 0
        assert moved == name.startswith("musae"), (name, gap)
        if moved:
            assert max(gap["param_median_lr"].values()) \
                > convert.BF16_PARAM_MEDIAN_LR
            assert chip_smoke.bf16_part_limits(run)["messages"] == \
                "bf16-sums"


@pytest.mark.parametrize("name,skip", [("fam_pna", "decoder"),
                                       ("musae_pna", "decoder"),
                                       ("fam_cpnatab", "model")])
def test_a_skipped_last_step_fails_the_record(roots, name, skip):
    """A component's last step skipped fails the record at 2.5 times its
    median limit or more: the plain bf16 limits (``pna``), the CPNA rule
    (``cpnatab``), and for a run with bf16 messages the limits it is held
    to against the reference's float32-sum run (its bf16-sum limits are
    the reference's own spread, ~1·lr, which no skipped step passes)."""
    with pytest.raises(chip_smoke.SmokeFailure, match="median parameter "
                       f"error of {skip}"):
        chip_smoke.replay_bf16_part(REC, ST, roots, name, device="cpu",
                                    skip=skip)
    out = chip_smoke.replay_bf16_part(REC, ST, roots, name, device="cpu",
                                      skip=skip, hold=False)
    held = out.get("f32sums", out)
    ratio = held["param_median_abs_err"][skip] / held["param_median_tol"]
    assert ratio >= 2.5, ratio


# ------------------------------------------------------------------ CLIs

MENU = ("fttransformer", "gin", "pna", "cpna", "cpnatab", "tabgnn",
        "tabgnninterleaved", "tabgnnfused")


@pytest.fixture(scope="module")
def cli_data(tmp_path_factory):
    from rmm_tpu_torch.datasets import (write_synthetic_aml_csv,
                                        write_synthetic_node_dataset)

    base = tmp_path_factory.mktemp("bf16_cli")
    return {"aml": write_synthetic_aml_csv(str(base / "aml.csv"),
                                           num_rows=600, num_accounts=40,
                                           seed=3),
            "eth": write_synthetic_node_dataset(
                str(base / "ethereum-phishing"), family="eth",
                num_nodes=300, num_edges=1300, seed=0),
            "runs": str(base / "runs")}


@pytest.mark.parametrize("task,model", [
    (task, model) for task in ("edge_classification", "node_classification",
                               "mcm_edge_table") for model in MENU
    if not (task == "mcm_edge_table" and model == "fttransformer")])
def test_cli_trains_and_serves_every_model_and_task_under_bf16(
        cli_data, task, model):
    """``cli/main.py --precision bf16`` trains an epoch of every model on
    every task it takes (``mcm_edge_table`` all but ``fttransformer``, as
    in the reference) and saves float32 masters with the precision in the
    meta; ``cli/predict.py --precision bf16`` serves the checkpoint (the
    classification tasks; it refuses MCM ones)."""
    from rmm_tpu_torch.cli import main as train_cli
    from rmm_tpu_torch.cli import predict

    data = cli_data["eth" if task == "node_classification" else "aml"]
    args = ["--data", data, "--model", model, "--task", task, "--n_hidden",
            "16", "--num_neighs", "4", "4", "--batch_size", "32", "--device",
            "cpu", "--precision", "bf16"]
    stats = {}
    (rec,), _ = train_cli.main(args + ["--epochs", "1", "--testing",
                                       "--wandb_dir", cli_data["runs"]],
                               stats)
    assert np.isfinite(rec["loss"])
    ck = os.path.join(stats["run_dir"], "0")
    with open(os.path.join(ck, "meta.json")) as f:
        assert json.load(f)["precision"] == "bf16"
    saved = torch.load(os.path.join(ck, "model.pt"), weights_only=True)
    assert all(v.dtype == torch.float32 for v in saved.values()
               if v.is_floating_point())
    if task == "mcm_edge_table":
        return
    out = predict.main(args + ["--load_model", ck, "--output",
                               os.path.join(cli_data["runs"], "p.csv")])
    assert len(out["id"]) > 0 and np.isfinite(out.get("score",
                                                      out["pred"])).all()
