"""The SSL layers and model of the PyTorch port against ``rmm_tpu`` on the CPU,
on seeded inputs with randomized JAX variables carried over by
``from_jax``: the mean-pool update, the LP and MCM heads, ``SSLoss`` (values
and gradients against ``jax.vjp``, degenerate cases included), MRR/Hits and
the MCM accumulator, the fused layer and ``TABGNNFused`` (``lp`` both ways,
train and eval), the pretrainer's variables one to one, the AdamW decay set
against the JAX mask (both over the variables of the JAX pretrainer that
``ssl_tiny_record.npz`` records), and the initialization (flax's
``lecun_normal``).

Tolerances: 1e-5 for the mean pool, heads, losses and metrics (float32,
sums in another order), 1e-4 for what aggregates through PNA, the fused
layer and the model (the PNA sums are taken in another order, the JAX ones
as cumsum differences, and the std aggregator's square root near its 1e-5
floor magnifies that).
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rmm_tpu.datasets import write_synthetic_aml_csv
from rmm_tpu.nn import decoders as jdec
from rmm_tpu.nn.models import fused as jfused
from rmm_tpu.ops.segment import scatter_mean_update as jax_smu
from rmm_tpu.train.pretrain import adamw_no_decay_groups
from rmm_tpu.utils import loss as jloss
from rmm_tpu.utils import metric as jmetric
from rmm_tpu_torch.convert import flatten_variables, from_jax, \
    load_record, random_variables, torch_key
from rmm_tpu_torch.datasets import IBMTransactionsAML
from rmm_tpu_torch.datasets.base import PretrainType
from rmm_tpu_torch.nn.decoders import LinkPredHead, MCMHead
from rmm_tpu_torch.nn.models.fused import FTTransformerPNAFusedLayer, \
    TABGNNFused
from rmm_tpu_torch.ops.segment import scatter_mean_update
from rmm_tpu_torch.train import task_models
from rmm_tpu_torch.train.pretrain import PretrainModel, decays
from rmm_tpu_torch.utils import loss, metric
from rmm_tpu_torch.utils.config import Config
from tests.torch_port_util import init_random, load_from_jax, nest, \
    one_torch_thread  # noqa: F401

TINY_RECORD = os.path.join(os.path.dirname(__file__), "fixtures",
                           "torch_port", "ssl_tiny_record.npz")
LAYER_TOL = dict(rtol=1e-5, atol=1e-5)
MODEL_TOL = dict(rtol=1e-4, atol=1e-4)
C, NH, HEADS = 16, 16, 4


def t(a):
    return torch.from_numpy(np.asarray(a))


def close(got, want, tol):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **tol)


# --------------------------------------------------------- mean pool


@pytest.mark.parametrize("reached", [9, 1])
def test_scatter_mean_update_and_its_gradient_match_jax(reached):
    """Rows below ``reached`` take the mean of their values (one row: all
    30); the others stay as they are."""
    rng = np.random.RandomState(3)
    x = rng.randn(12, 5).astype(np.float32)
    index = rng.randint(0, reached, 30)
    values = rng.randn(30, 5).astype(np.float32)
    cot = rng.randn(12, 5).astype(np.float32)
    ref, vjp = jax.vjp(lambda a, v: jax_smu(a, jnp.asarray(index), v),
                       jnp.asarray(x), jnp.asarray(values))
    xt, vt = t(x).requires_grad_(), t(values).requires_grad_()
    out = scatter_mean_update(xt, t(index), vt)
    gx, gv = torch.autograd.grad(out, (xt, vt), t(cot))
    close(out, ref, LAYER_TOL)
    wx, wv = vjp(jnp.asarray(cot))
    close(gx, wx, LAYER_TOL)
    close(gv, wv, LAYER_TOL)
    np.testing.assert_array_equal(out.detach().numpy()[reached:],
                                  x[reached:])


# ------------------------------------------------------------ heads


def test_link_pred_head_matches_jax():
    rng = np.random.RandomState(4)
    x = rng.randn(20, NH).astype(np.float32)
    pos_ei = rng.randint(0, 20, (2, 6))
    neg_ei = rng.randint(0, 20, (2, 18))
    pos_ea = rng.randn(6, NH).astype(np.float32)
    neg_ea = rng.randn(18, NH).astype(np.float32)
    head = jdec.LinkPredHead(1, NH, 0.0)
    args = [jnp.asarray(a) for a in (x, pos_ei, pos_ea, neg_ei, neg_ea)]
    variables = init_random(head, *args, seed=5)
    ref_pos, ref_neg = head.apply(variables, *args)
    port = load_from_jax(LinkPredHead(1, NH, NH, 0.0), variables)
    pos, neg = port(*[t(a) for a in (x, pos_ei, pos_ea, neg_ei, neg_ea)])
    assert pos.shape == (6, 1) and neg.shape == (18, 1)
    close(pos, ref_pos, LAYER_TOL)
    close(neg, ref_neg, LAYER_TOL)


def test_mcm_head_matches_jax():
    rng = np.random.RandomState(6)
    x = rng.randn(10, 3 * C).astype(np.float32)
    head = jdec.MCMHead(C, 1, (4, 7, 3), w=3)
    variables = init_random(head, jnp.asarray(x), seed=7)
    ref_num, ref_cat = head.apply(variables, jnp.asarray(x))
    port = load_from_jax(MCMHead(C, 1, (4, 7, 3), w=3), variables)
    num, cat = port(t(x))
    close(num, ref_num, LAYER_TOL)
    assert [c.shape[1] for c in cat] == [4, 7, 3]
    for a, b in zip(cat, ref_cat):
        close(a, b, LAYER_TOL)


# ------------------------------------------------------------- losses


def mcm_case(seed, rows="mixed"):
    """MCM targets over one numerical and two categorical columns (index
    0 numerical, 1-2 categorical), some rows invalid; ``rows`` "num" or
    "cat" keeps only numerical or only categorical targets."""
    rng = np.random.RandomState(seed)
    b = 24
    idx = rng.randint(0, 3, b)
    if rows == "num":
        idx[:] = 0
    elif rows == "cat":
        idx = rng.randint(1, 3, b)
    val = np.where(idx == 0, rng.randn(b) * 3, rng.randint(0, 4, b))
    y = np.stack([val, idx], 1).astype(np.float32)
    valid = rng.rand(b) < 0.8
    num = rng.randn(b, 1).astype(np.float32)
    cat = [rng.randn(b, 4).astype(np.float32),
           rng.randn(b, 5).astype(np.float32)]
    return y, valid, num, cat


@pytest.mark.parametrize("rows", ["mixed", "num", "cat"])
def test_mcm_loss_and_its_gradient_match_jax(rows):
    y, valid, num, cat = mcm_case(8, rows)
    ss = jloss.SSLoss(1)

    def jf(n, c0, c1):
        total, (cl, tc, acc), (nl, tn) = ss.mcm_loss(
            [c0, c1], n, jnp.asarray(y), jnp.asarray(valid))
        return total, (cl, tc, acc, nl, tn)

    inputs = [jnp.asarray(a) for a in (num, *cat)]
    ref_total, vjp, ref_aux = jax.vjp(jf, *inputs, has_aux=True)
    grads_ref = vjp(jnp.ones_like(ref_total))
    leaves = [t(a).requires_grad_() for a in (num, *cat)]
    total, (cl, tc, acc), (nl, tn) = loss.SSLoss(1).mcm_loss(
        leaves[1:], leaves[0], t(y), t(valid))
    grads = torch.autograd.grad(total, leaves)
    close(total, ref_total, LAYER_TOL)
    for got, want in zip((cl, tc, acc, nl, tn), ref_aux):
        np.testing.assert_allclose(float(got.detach()), float(want),
                                   rtol=1e-5,
                                   atol=1e-5)
    for g, w in zip(grads, grads_ref):
        assert np.isfinite(g.numpy()).all()
        close(g, w, LAYER_TOL)


@pytest.mark.parametrize("masked", [False, True])
def test_lp_loss_and_its_gradient_match_jax(masked):
    rng = np.random.RandomState(9)
    pos = rng.uniform(0.01, 0.99, (16, 1)).astype(np.float32)
    neg = rng.uniform(0.01, 0.99, (16 * 5, 1)).astype(np.float32)
    pm = rng.rand(16) < 0.75 if masked else None
    nm = None if pm is None else np.repeat(pm, 5)
    jm = [None if m is None else jnp.asarray(m) for m in (pm, nm)]
    ref, grads_ref = jax.value_and_grad(
        lambda p, n: jloss.lp_loss(p, n, *jm), argnums=(0, 1))(
        jnp.asarray(pos), jnp.asarray(neg))
    pt, nt = t(pos).requires_grad_(), t(neg).requires_grad_()
    out = loss.lp_loss(pt, nt, *[None if m is None else t(m)
                                 for m in (pm, nm)])
    close(out, ref, LAYER_TOL)
    for g, w in zip(torch.autograd.grad(out, (pt, nt)), grads_ref):
        close(g, w, LAYER_TOL)


def test_mrr_hits_and_mcm_accumulator_match_jax():
    rng = np.random.RandomState(10)
    pos = np.round(rng.rand(30), 1)          # ties with the negatives
    neg = np.round(rng.rand(30 * 8), 1)
    want = jmetric.SSMetric(1).mrr(pos, neg, [1, 2, 5, 10], 8)
    assert metric.mrr(pos, neg, [1, 2, 5, 10], 8) == want
    acc, jacc = metric.MCMAccumulator(1), jmetric.MCMAccumulator(1)
    for seed in (11, 12):
        y, _, num, cat = mcm_case(seed)
        acc.update(cat, num, y, 20)
        jacc.update(cat, num, y, 20)
    assert (acc.accuracy, acc.rmse, acc.t_c, acc.t_n) == (
        jacc.accuracy, jacc.rmse, jacc.t_c, jacc.t_n)


# -------------------------------------------------------------- model


def graph_case(seed, v=14, e=112, tgt=9, s=6):
    """Every node receives e / v edges (so the PNA std aggregator stays away
    from its 1e-5 floor, where the two packages' sums in another order
    would part), some of them masked."""
    rng = np.random.RandomState(seed)
    ei = np.stack([rng.randint(0, v, e),
                   rng.permutation(np.repeat(np.arange(v), e // v))])
    tei = rng.randint(0, v, (2, tgt))
    emask = rng.rand(e) < 0.85
    nmask = np.ones(v, bool)
    nmask[-2:] = False
    return dict(x_tab=rng.randn(tgt, s, C).astype(np.float32),
                x_gnn=rng.randn(v, NH).astype(np.float32),
                edge_index=ei, edge_attr=rng.randn(e, NH).astype(np.float32),
                target_edge_index=tei, edge_mask=emask, node_mask=nmask,
                x=rng.randn(v, 2).astype(np.float32),
                edge_tok=rng.randn(e, s - 1, C).astype(np.float32),
                target_tok=rng.randn(tgt, s - 1, C).astype(np.float32))


def apply_jax(module, variables, args, train):
    if not train:
        return module.apply(variables, *args, False), None
    out, mutated = module.apply(variables, *args, True,
                                mutable=["batch_stats"],
                                rngs={"dropout": jax.random.PRNGKey(0)})
    return out, mutated["batch_stats"]


def check_stats(port, stats):
    for k, v in flatten_variables({"batch_stats": stats}).items():
        name, _ = torch_key(k)
        close(port.state_dict()[name], v, MODEL_TOL)


@pytest.mark.parametrize("lp", [False, True])
@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("reverse_mp", [False, True])
def test_fused_layer_matches_jax(lp, train, reverse_mp):
    g = graph_case(13)
    names = ("x_tab", "x_gnn", "edge_index", "edge_attr",
             "target_edge_index")
    layer = jfused.FTTransformerPNAFusedLayer(C, NH, 1.3, reverse_mp, HEADS,
                                              0.0)
    args = [jnp.asarray(g[n]) for n in names] + [
        lp, jnp.asarray(g["edge_mask"]), jnp.asarray(g["node_mask"])]
    # lp=False creates every variable (the fuse MLP too), as the model's
    variables = init_random(layer, *args[:5], False, *args[6:], False,
                            seed=14)
    ref, stats = apply_jax(layer, variables, args, train)
    port = load_from_jax(FTTransformerPNAFusedLayer(
        C, NH, 1.3, reverse_mp, HEADS, 0.0), variables).train(train)
    out = port(*[t(g[n]) for n in names], lp, t(g["edge_mask"]),
               t(g["node_mask"]))
    for a, b in zip(out, ref):
        close(a, b, MODEL_TOL)
    if train:
        check_stats(port, stats)


@pytest.mark.parametrize("lp", [False, True])
@pytest.mark.parametrize("train", [False, True])
def test_tabgnn_fused_matches_jax(lp, train):
    g = graph_case(15)
    names = ("x", "edge_index", "edge_tok", "target_edge_index",
             "target_tok")
    model = jfused.TABGNNFused(C, 2, node_dim=2, nhidden=NH, avg_log_deg=1.1,
                               nhead=HEADS, dropout=0.0)
    args = [jnp.asarray(g[n]) for n in names] + [
        lp, jnp.asarray(g["edge_mask"]), jnp.asarray(g["node_mask"])]
    variables = init_random(model, *args[:5], False, *args[6:], False,
                            seed=16)
    ref, stats = apply_jax(model, variables, args, train)
    port = load_from_jax(TABGNNFused(C, 2, edge_cols=5, node_dim=2,
                                     nhidden=NH, avg_log_deg=1.1,
                                     nhead=HEADS, dropout=0.0),
                         variables).train(train)
    out = port(*[t(g[n]) for n in names], lp, t(g["edge_mask"]),
               t(g["node_mask"]))
    assert [tuple(o.shape) for o in out] == [(14, NH), (112, NH), (9, NH)]
    for a, b in zip(out, ref):
        close(a, b, MODEL_TOL)
    if train:
        check_stats(port, stats)


# ------------------------------------- pretrainer variables and AdamW


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    """The port's PretrainModel at the tiny record's config, and the JAX
    pretrainer's variable shapes the record holds (written by
    ``tools/make_torch_port_ssl_fixture.py`` from ``rmm_tpu``)."""
    rec = load_record(TINY_RECORD)
    st = json.loads(str(rec["settings"]))
    csv = str(tmp_path_factory.mktemp("ssl") / "aml.csv")
    write_synthetic_aml_csv(csv, num_rows=st["rows"],
                            num_accounts=st["num_accounts"],
                            seed=st["data_seed"])
    ds = IBMTransactionsAML(csv, khop_neighbors=st["khop_neighbors"],
                            pretrain={PretrainType.MASK,
                                      PretrainType.LINK_PRED})
    cfg = Config(model="tabgnnfused", data=csv, n_hidden=st["channels"],
                 n_gnn_layers=st["num_layers"], dropout=0.0,
                 num_neg_samples=st["num_neg_samples"], device="cpu")
    return PretrainModel(cfg, ds), st["modes"]["mcm-lp"]["shapes"]


def test_pretrainer_variables_map_one_to_one(tiny):
    port, shapes = tiny
    state = from_jax(random_variables(shapes, 0), port)
    port.load_state_dict(state, strict=True)
    assert {k.split(".")[0] for k in state} == {
        "edge_encoder", "model", "mcm_head", "lp_head"}


def test_adamw_decays_what_the_jax_mask_decays(tiny):
    port, shapes = tiny
    tree = nest({k: np.ones(v, np.float32) for k, v in shapes.items()
                 if k.startswith("params/")})["params"]
    # one update of the JAX pretrainer's AdamW on all-ones parameters from
    # zero gradients moves exactly the decayed leaves (by -lr·weight_decay)
    tx = adamw_no_decay_groups(2e-4, 1e-3, 1e-8)
    updates, _ = jax.jit(tx.update)(
        jax.tree_util.tree_map(jnp.zeros_like, tree), tx.init(tree), tree)
    moved = flatten_variables({"params": jax.tree_util.tree_map(
        lambda u: np.asarray(u) != 0, updates)})
    params = dict(port.named_parameters())
    assert len(moved) == len(params)
    for key, m in moved.items():
        name, _ = torch_key(key)
        assert decays(params[name]) == bool(m.any()), key
    assert any(decays(p) for p in params.values())
    assert not all(decays(p) for p in params.values())


# ----------------------------------------------------- initialization


def test_lecun_normal_is_flax_truncated_normal():
    g = torch.Generator().manual_seed(0)
    fan_in = 384
    w = task_models.lecun_normal_(torch.empty(512, fan_in), fan_in, g)
    assert abs(float(w.var()) * fan_in - 1.0) <= 0.02
    assert float(w.abs().max()) * np.sqrt(fan_in) <= 2 / 0.87962566 + 1e-5
    # flax's own draw, for the same law
    ref = jax.nn.initializers.lecun_normal()(jax.random.PRNGKey(0),
                                            (fan_in, 512))
    assert abs(float(jnp.var(ref)) * fan_in - 1.0) <= 0.02


def test_pretrain_model_init_draws_lecun_normal(tiny):
    port, _ = tiny
    task_models.init_parameters(port, seed=3)
    lin = port.model.layer_0.fuse.fc2
    w = lin.weight.detach()
    bound = 2 / 0.87962566 / np.sqrt(lin.in_features)
    assert float(w.abs().max()) <= bound + 1e-6
    assert abs(float(w.var()) * lin.in_features - 1.0) <= 0.02
    assert float(lin.bias.detach().abs().max()) == 0.0
    attn = port.model.tab_conv.self_attn.qkv_kernel.detach()
    assert float(attn.abs().max()) <= 2 / 0.87962566 / np.sqrt(C) + 1e-6
