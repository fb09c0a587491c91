"""``--precision bf16`` in the PyTorch port against ``rmm_tpu`` on the CPU.

The scheme (``rmm_tpu_torch/utils/precision.py``) against
``rmm_tpu/utils/precision.py``; the column attention's plain twin on bf16
against the Pallas kernel in interpret mode (forward, dx and the float32
weight gradients, which must reach float32 masters unrounded, as the
kernel's custom VJP delivers them); float32 tokens with bf16 weights (the
reference's edge tokens, whose timestamp block is float32); LayerNorm,
MaskedBatchNorm and a PNA layer; PNA aggregation of bf16 messages (the
port sums them in float32, the reference in bf16: the difference is
pinned); ``TABGNNS`` and ``TABGNNFused`` forwards; three train steps,
supervised and mcm-lp, against the JAX records of
``tools/make_torch_port_bf16_fixture.py``; float32 masters, optimizer
state and BatchNorm statistics after a bf16 step; and the CLIs.

The reference's attention runs its Pallas kernel (interpret mode) here
(``tests.torch_port_util.jax_kernel_attention``): that is its TPU path,
whose semantics the port copies; its CPU einsum path rounds q, k, v, the
softmax, the context and the weight gradients to bf16.

Tolerances, each with its reason:

* one bf16 rounding (2^-7 of the value, plus 1e-6 of the largest entry)
  where both sides round the same float32 value that their sums (in
  another order) leave a few float32 ulps apart: attention out and dx,
  LayerNorm, BatchNorm and PNA outputs;
* 1e-5 of the largest entry for float32 weight gradients (sums in
  another order);
* models: 1e-4 abs/rel, as in float32 (``test_torch_model.py``): both
  sides round at the same places (flax's Dense rounds its product before
  the bias, and so does the port), so the port's bf16 logits sit 1e-6
  from the reference's while bf16 moves them ~4e-3 from float32;
* three steps: ``convert.check_record``'s bf16 limits, and their reasons
  there (the reference's jitted bf16 step rounds at other places than its
  eager forward, which the port's matches to float32 accuracy).
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rmm_tpu.utils.precision as jprec
from rmm_tpu.nn import norms as jnorms
from rmm_tpu.nn.gnn import conv as jconv
from rmm_tpu.nn.models import fused as jfused
from rmm_tpu.ops.pallas.column_attention import \
    fused_column_attention as jax_fused
from rmm_tpu.ops.segment import pna_aggregate as jax_pna
from rmm_tpu_torch.cli import main as train_cli
from rmm_tpu_torch.cli import predict
from rmm_tpu_torch.convert import (check_record, from_jax, load_record,
                                   loss_terms, random_variables)
from rmm_tpu_torch.datasets import IBMTransactionsAML, write_synthetic_aml_csv
from rmm_tpu_torch.datasets.base import PretrainType
from rmm_tpu_torch.nn import norms
from rmm_tpu_torch.nn.gnn import conv
from rmm_tpu_torch.nn.layers import LayerNorm
from rmm_tpu_torch.nn.models.fused import TABGNNFused
from rmm_tpu_torch.ops import column_attention as ca
from rmm_tpu_torch.ops.segment import pna_aggregate
from rmm_tpu_torch.train.pretrain import PretrainTrainer
from rmm_tpu_torch.train.trainer import Trainer
from rmm_tpu_torch.utils import precision
from rmm_tpu_torch.utils.config import Config
from tests.torch_port_util import (  # noqa: F401
    init_random, jax_kernel_attention, load_from_jax, one_torch_thread)

RECORD = os.path.join(os.path.dirname(__file__), "fixtures", "torch_port",
                      "bf16_tiny_record.npz")
MODEL_TOL = dict(rtol=1e-4, atol=1e-4)
BF16 = torch.bfloat16


def t(a):
    return torch.from_numpy(np.asarray(a))


def f32(a) -> np.ndarray:
    """A torch or JAX array as float32 numpy (bf16 exactly)."""
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def assert_one_rounding(got, want):
    """Within one bf16 rounding of each other (2^-7 of the value) and 1e-6
    of the largest entry."""
    g, w = f32(got), f32(want)
    bound = 2.0 ** -7 * np.maximum(np.abs(g), np.abs(w)) \
        + 1e-6 * np.abs(w).max()
    assert (np.abs(g - w) <= bound).all(), float(np.abs(g - w).max())


def is_bf16(t_: torch.Tensor) -> bool:
    """Every entry representable in bf16."""
    return torch.equal(t_.to(BF16).float(), t_.float())


# ------------------------------------------------------------ the scheme


def test_cast_floats_compute_cast_and_out_f32_match_jax():
    rng = np.random.RandomState(0)
    tree = {"w": rng.randn(3, 4).astype(np.float32) * 1e5,
            "i": np.arange(5, dtype=np.int32), "b": np.array([True, False]),
            "n": None, "nested": [rng.randn(7).astype(np.float32),
                                  np.arange(2, dtype=np.int16)]}
    jtree = jax.tree_util.tree_map(jnp.asarray, tree)
    ptree = {k: v if v is None else
             [t(a) for a in v] if isinstance(v, list) else t(v)
             for k, v in tree.items()}
    for jfn, pfn in ((lambda x: jprec.cast_floats(x, jnp.bfloat16),
                      lambda x: precision.cast_floats(x, BF16)),
                     (lambda x: jprec.compute_cast(x, "bf16"),
                      lambda x: precision.compute_cast(x, "bf16")),
                     (lambda x: jprec.compute_cast(x, "f32"),
                      lambda x: precision.compute_cast(x, "f32")),
                     (lambda x: jprec.out_f32(jprec.cast_floats(
                         x, jnp.bfloat16)),
                      lambda x: precision.out_f32(precision.cast_floats(
                          x, BF16)))):
        want, got = jfn(jtree), pfn(ptree)
        assert got["n"] is None and want["n"] is None
        for key in ("w", "i", "b", "nested"):
            ws = want[key] if key == "nested" else [want[key]]
            gs = got[key] if key == "nested" else [got[key]]
            for w, g in zip(ws, gs):
                assert str(g.dtype).split(".")[-1] == str(w.dtype), key
                np.testing.assert_array_equal(f32(g), f32(w))


def test_cast_records_masters_and_apply_casts_parameters_alone():
    p = torch.randn(4, requires_grad=True)
    frozen = torch.randn(4)
    cast = precision.cast_floats({"p": p, "frozen": frozen}, BF16)
    assert precision.master_of(cast["p"]) is p
    assert precision.master_of(cast["frozen"]) is None
    assert precision.master_of(p) is None

    bn = norms.MaskedBatchNorm(3).train()
    x = torch.randn(5, 3).to(BF16)
    out = precision.apply(bn, "bf16", x)
    assert out.dtype == torch.float32
    assert bn.weight.dtype == bn.running_mean.dtype == torch.float32
    assert not torch.equal(bn.running_mean, torch.zeros(3))  # moved


# -------------------------------------------------------- column attention

def attention_case(seed, b, s, c, masked):
    rng = np.random.RandomState(seed)
    arrays = [rng.randn(b, s, c), rng.randn(c, 3 * c) / np.sqrt(c),
              rng.randn(3 * c) * 0.1, rng.randn(c, c) / np.sqrt(c),
              rng.randn(c) * 0.1]
    arrays = [a.astype(np.float32) for a in arrays]
    h = 8
    mask = rng.rand(b, h, s, s) >= 0.3 if masked else None
    cot = rng.randn(b, s, c).astype(np.float32)
    return arrays, h, mask, cot


def jax_attention_grads(arrays, h, mask, cot, x_dtype=jnp.bfloat16):
    """The Pallas kernel (interpret mode) on x in ``x_dtype`` and bf16
    weights cast from float32 masters: its output and ``jax.grad`` of
    <out, cot> with respect to x and the masters."""
    rate = 0.3 if mask is not None else 0.0
    jmask = None if mask is None else jnp.asarray(mask)

    def fn(x, *masters):
        out = jax_fused(x.astype(x_dtype),
                        *(m.astype(jnp.bfloat16) for m in masters), h,
                        drop_mask=jmask, dropout_rate=rate, block_rows=8,
                        interpret=True)
        return (out.astype(jnp.float32) * cot).sum(), out

    (_, out), grads = jax.value_and_grad(fn, argnums=tuple(range(5)),
                                         has_aux=True)(
        *(jnp.asarray(a) for a in arrays))
    return out, grads


def port_attention_grads(arrays, h, mask, cot, x_dtype=BF16):
    """The port's attention on x in ``x_dtype`` and bf16 weights cast from
    float32 masters by ``precision.cast_floats``: its output and the
    gradients at x and the masters."""
    rate = 0.3 if mask is not None else 0.0
    x, *masters = [t(a).requires_grad_() for a in arrays]
    out = ca.fused_column_attention(
        x.to(x_dtype), *precision.cast_floats(masters, BF16), h,
        drop_mask=None if mask is None else t(mask), dropout_rate=rate)
    grads = torch.autograd.grad(out, [x, *masters], t(cot).to(x_dtype))
    return out, grads


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("c", [32, 128])
def test_bf16_plain_twin_matches_the_pallas_kernel(c, masked):
    """bf16 x and weights, B = 13 (ragged against the kernel's tiles of
    8): out and dx in bf16 within one rounding, the weight and bias
    gradients float32 within 1e-5 of the largest entry."""
    arrays, h, mask, cot = attention_case(c, 13, 6, c, masked)
    out, grads = port_attention_grads(arrays, h, mask, cot)
    want_out, want = jax_attention_grads(arrays, h, mask, cot)
    assert out.dtype == BF16 and want_out.dtype == jnp.bfloat16
    assert_one_rounding(out, want_out)
    assert_one_rounding(grads[0], want[0])
    for g, w in zip(grads[1:], want[1:]):
        assert g.dtype == torch.float32 and w.dtype == jnp.float32
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=1e-5 * np.abs(w).max())


def test_weight_gradients_reach_the_float32_masters_unrounded():
    """PyTorch rounds a gradient to the dtype of the tensor it reaches, so
    the kernel's float32 weight gradients would come back rounded to bf16
    if the bf16 weights were autograd's leaves. Through the masters that
    ``cast_floats`` records they do not: the gradient of Wqkv is not
    bf16-representable, and it is ``jax.grad``'s through the Pallas
    kernel to float32 accuracy."""
    arrays, h, mask, cot = attention_case(5, 24, 6, 32, True)
    _, grads = port_attention_grads(arrays, h, mask, cot)
    _, want = jax_attention_grads(arrays, h, mask, cot)
    assert not is_bf16(grads[1])
    w = np.asarray(want[1])
    assert not np.array_equal(w, f32(jnp.asarray(w).astype(jnp.bfloat16)))
    np.testing.assert_allclose(grads[1].numpy(), w, rtol=0,
                               atol=1e-5 * np.abs(w).max())
    # the same weights as leaves of their own: the gradient arrives rounded
    x = t(arrays[0]).to(BF16)
    leaves = [t(a).to(BF16).requires_grad_() for a in arrays[1:]]
    out = ca.fused_column_attention(x, *leaves, h, t(mask), 0.3)
    (g,) = torch.autograd.grad(out, leaves[0], t(cot).to(BF16))
    assert g.dtype == BF16


@pytest.mark.parametrize("c", [32, 128])
def test_float32_x_with_bf16_weights_matches_the_pallas_kernel(c):
    """The reference's edge tokens under bf16: float32 x, bf16 weights. The
    kernel computes in float32 on the weights' values, out and dx are
    float32."""
    arrays, h, mask, cot = attention_case(c + 1, 13, 6, c, False)
    out, grads = port_attention_grads(arrays, h, mask, cot, torch.float32)
    want_out, want = jax_attention_grads(arrays, h, mask, cot, jnp.float32)
    assert out.dtype == torch.float32 and want_out.dtype == jnp.float32
    np.testing.assert_allclose(f32(out), f32(want_out), rtol=1e-5,
                               atol=1e-5)
    for g, w in zip(grads, want):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=1e-5 * np.abs(w).max())


# ----------------------------------------------------------------- layers


def test_layernorm_bf16_matches_flax():
    """flax takes the statistics in float32 and rounds the output once."""
    import flax.linen as fnn

    x = (np.random.RandomState(1).randn(40, 6, 16) * 3 + 1).astype(
        np.float32)
    layer = fnn.LayerNorm(epsilon=1e-6)
    variables = init_random(layer, jnp.asarray(x), seed=2)
    ref = layer.apply(jprec.compute_cast(variables, "bf16"),
                      jnp.asarray(x).astype(jnp.bfloat16))
    port = load_from_jax(LayerNorm(16), variables)
    with torch.no_grad():
        got = precision.apply(port, "bf16", t(x).to(BF16))
    assert ref.dtype == jnp.bfloat16
    assert_one_rounding(got, ref)


@pytest.mark.parametrize("train", [False, True])
def test_masked_batchnorm_bf16_matches_jax(train):
    """Statistics in float32 (``rmm_tpu/nn/norms.py``), running statistics
    float32, the output in x's dtype."""
    rng = np.random.RandomState(2)
    x = (rng.randn(20, 16) * 2 + 0.5).astype(np.float32)
    mask = rng.rand(20) < 0.7
    jax_bn = jnorms.MaskedBatchNorm(16)
    variables = init_random(jax_bn, jnp.asarray(x), jnp.asarray(mask),
                            False, seed=3)
    ref, mutated = jax_bn.apply(
        {"params": jprec.compute_cast(variables["params"], "bf16"),
         "batch_stats": variables["batch_stats"]},
        jnp.asarray(x).astype(jnp.bfloat16), jnp.asarray(mask), train,
        mutable=["batch_stats"])
    bn = load_from_jax(norms.MaskedBatchNorm(16), variables).train(train)
    params = precision.compute_cast(dict(bn.named_parameters()), "bf16")
    with torch.no_grad():
        got = torch.func.functional_call(bn, params,
                                         (t(x).to(BF16), t(mask)))
    assert got.dtype == BF16 and ref.dtype == jnp.bfloat16
    assert_one_rounding(got, ref)
    stats = (mutated if train else variables)["batch_stats"]
    assert bn.running_mean.dtype == torch.float32
    np.testing.assert_allclose(bn.running_mean.numpy(),
                               np.asarray(stats["mean"]), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(bn.running_var.numpy(),
                               np.asarray(stats["var"]), rtol=1e-5,
                               atol=1e-5)


def test_pna_layer_bf16_matches_jax():
    """One PNA layer as the reference's bf16 path runs it: bf16 node
    states and parameters, float32 edge features (so the messages are
    float32, as in the models)."""
    rng = np.random.RandomState(4)
    v, e, c = 10, 40, 16
    x = rng.randn(v, c).astype(np.float32)
    ea = rng.randn(e, c).astype(np.float32)
    src = np.concatenate([np.tile(np.arange(v), 2), rng.randint(0, v, 20)])
    dst = np.concatenate([np.tile((np.arange(v) + 1) % (v - 1), 2),
                          rng.randint(0, v - 1, 20)])
    ei = np.stack([src, dst]).astype(np.int32)
    mask = np.concatenate([np.ones(20, bool), rng.rand(20) < 0.7])
    jax_conv = jconv.PNAConv(c, 1.21)
    args = (jnp.asarray(x), jnp.asarray(ei), jnp.asarray(ea),
            jnp.asarray(mask))
    variables = init_random(jax_conv, *args, seed=5)
    ref = jax_conv.apply(jprec.compute_cast(variables, "bf16"),
                         args[0].astype(jnp.bfloat16), *args[1:])
    layer = load_from_jax(conv.PNAConv(c, 1.21), variables)
    with torch.no_grad():
        got = precision.apply(layer, "bf16", t(x).to(BF16), t(ei).long(),
                              t(ea), t(mask))
    np.testing.assert_allclose(f32(got), f32(ref), **MODEL_TOL)


def test_pna_aggregate_sums_bf16_messages_in_float32():
    """bf16 messages, a node of 600 (past bf16's exact integers, 256):
    the port sums in float32 and keeps the aggregates float32 (the
    reference's scatter path divides by a float32 count), within a bf16
    rounding of the exact aggregates (the squares rounded to bf16, as the
    reference takes them); the reference's paths sum in bf16 (``cv`` as
    differences of one running cumsum) and land ~0.14 of the largest
    aggregate off, the std up to ~0.96 of its own (its E[x²] − E[x]²
    cancels in bf16). Pinned so that the difference is not taken for a
    port fault."""
    rng = np.random.RandomState(0)
    n, e, f = 12, 3000, 8
    dst = np.concatenate([np.zeros(600, np.int32),
                          rng.randint(1, n, e - 600).astype(np.int32)])
    msg = t((rng.randn(e, f) + 3.0).astype(np.float32)).to(BF16)
    exact = pna_aggregate(msg.double(), t(dst), n, 1.3).numpy()
    got = pna_aggregate(msg, t(dst), n, 1.3)
    assert got.dtype == torch.float32
    assert_one_rounding(got, exact)
    scale = np.abs(exact).max()
    for impl in ("cv", "scatter"):
        ref = f32(jax_pna(jnp.asarray(f32(msg)).astype(jnp.bfloat16),
                          jnp.asarray(dst), n, 1.3, impl=impl))
        assert np.abs(ref - exact).max() > 0.05 * scale, impl


# ----------------------------------------------------------------- models


@pytest.fixture(scope="module")
def record(tmp_path_factory):
    rec = load_record(RECORD)
    st = json.loads(str(rec["settings"]))
    sup = st["sup"]
    csv = write_synthetic_aml_csv(
        str(tmp_path_factory.mktemp("bf16") / "aml.csv"),
        num_rows=sup["rows"], num_accounts=sup["num_accounts"],
        seed=sup["data_seed"])
    return rec, st, csv


def supervised_trainer(st, csv, prec):
    sup = st["sup"]
    ds = IBMTransactionsAML(csv, khop_neighbors=sup["num_neighs"])
    cfg = Config(model="tabgnn", data=csv, batch_size=sup["batch_size"],
                 n_hidden=sup["n_hidden"], n_gnn_layers=sup["n_gnn_layers"],
                 num_neighs=tuple(sup["num_neighs"]), dropout=0.0,
                 seed=st["seed"], edge_capacity=sup["edge_capacity"],
                 node_capacity=sup["node_capacity"], device="cpu",
                 precision=prec)
    tr = Trainer(cfg, ds)
    tr.model.load_state_dict(from_jax(random_variables(sup["shapes"],
                                                       st["var_seed"]),
                                      tr.model))
    return tr, ds


def test_tabgnn_bf16_forward_matches_jax(record):
    """Eval-mode logits of ``TABGNNS`` in bf16 against the reference's on
    the record's start and a test batch; bf16 moves them ~50 times as far
    from float32 as the tolerance."""
    from rmm_tpu.datasets import IBMTransactionsAML as JaxAML
    from rmm_tpu.train.trainer import Trainer as JaxTrainer
    from rmm_tpu.utils.config import Config as JaxConfig
    from tests.torch_port_util import nest

    _, st, csv = record
    sup = st["sup"]
    variables = jax.tree_util.tree_map(jnp.asarray, nest(random_variables(
        sup["shapes"], st["var_seed"])))
    jds = JaxAML(csv, khop_neighbors=tuple(sup["num_neighs"]),
                 channels=sup["n_hidden"])
    jtr = JaxTrainer(JaxConfig(
        model="tabgnn", data=csv, batch_size=sup["batch_size"],
        n_hidden=sup["n_hidden"], n_gnn_layers=sup["n_gnn_layers"],
        num_neighs=tuple(sup["num_neighs"]), seed=st["seed"],
        edge_capacity=sup["edge_capacity"],
        node_capacity=sup["node_capacity"]), jds)
    jgb = next(jtr._batches(jds.edges.split()[2], "test"))
    with jax_kernel_attention():
        ref = jtr.model.apply(
            {"params": jprec.compute_cast(variables["params"], "bf16"),
             "batch_stats": variables["batch_stats"]},
            jprec.compute_cast(jtr.edge_table, "bf16"),
            jprec.compute_cast(jtr.node_table, "bf16"), jgb, False)
    logits = {}
    for prec in ("bf16", "f32"):
        tr, ds = supervised_trainer(st, csv, prec)
        gb = next(tr._batches(ds.edges.split()[2], "test"))
        np.testing.assert_array_equal(gb.edge_gather, jgb.edge_gather)
        with torch.no_grad():
            logits[prec] = tr._logits(gb.to("cpu")).numpy()
    np.testing.assert_allclose(logits["bf16"], f32(ref), **MODEL_TOL)
    assert np.abs(logits["bf16"] - logits["f32"]).max() > 10 * 1e-4


@pytest.mark.parametrize("lp", [False, True])
def test_tabgnn_fused_bf16_forward_matches_jax(lp):
    """``TABGNNFused`` on bf16 parameters and node features with float32
    tokens (the reference's edge tokens under bf16)."""
    rng = np.random.RandomState(15)
    v, e, tgt, s, c = 14, 112, 9, 6, 16
    ei = np.stack([rng.randint(0, v, e),
                   rng.permutation(np.repeat(np.arange(v), e // v))])
    args = dict(x=rng.randn(v, 2).astype(np.float32), edge_index=ei,
                edge_tok=rng.randn(e, s - 1, c).astype(np.float32),
                target_edge_index=rng.randint(0, v, (2, tgt)),
                target_tok=rng.randn(tgt, s - 1, c).astype(np.float32))
    emask, nmask = rng.rand(e) < 0.85, np.arange(v) < v - 2
    model = jfused.TABGNNFused(c, 2, node_dim=2, nhidden=c,
                               avg_log_deg=1.1, nhead=4, dropout=0.0)
    jargs = [jnp.asarray(a) for a in args.values()]
    variables = init_random(model, *jargs, False, jnp.asarray(emask),
                            jnp.asarray(nmask), False, seed=16)
    jargs[0] = jargs[0].astype(jnp.bfloat16)
    with jax_kernel_attention():
        ref = model.apply({"params": jprec.compute_cast(
            variables["params"], "bf16"),
            "batch_stats": variables["batch_stats"]}, *jargs, lp,
            jnp.asarray(emask), jnp.asarray(nmask), False)
    port = load_from_jax(TABGNNFused(c, 2, edge_cols=5, node_dim=2,
                                     nhidden=c, avg_log_deg=1.1, nhead=4,
                                     dropout=0.0), variables)
    pargs = [t(a) for a in args.values()]
    pargs[0] = pargs[0].to(BF16)
    with torch.no_grad():
        out = precision.apply(port, "bf16", *pargs, lp, t(emask), t(nmask))
    for a, b in zip(out, ref):
        np.testing.assert_allclose(f32(a), f32(b), **MODEL_TOL)


# ------------------------------------------------------------- training


def hold_to_record(state, terms, rec, prefix, lr, updates, nhidden):
    """The steps against the bf16 record at ``check_record``'s bf16
    limits."""
    faults, summary = check_record(state, terms, rec, prefix, lr, updates,
                                   nhidden, "bf16")
    assert not faults, faults
    return summary


def test_three_bf16_supervised_steps_match_the_jax_record(record):
    rec, st, csv = record
    tr, ds = supervised_trainer(st, csv, "bf16")
    tr.model.train()
    batches = tr._batches(ds.edges.split()[0], "train", 0)
    terms = [loss_terms(tr._step(gb.to("cpu"))[0], {})
             for _, gb in zip(range(st["steps"]), batches)]
    hold_to_record(tr.model.state_dict(), terms, rec, "sup/", tr.cfg.lr,
                   st["steps"], st["sup"]["n_hidden"])


def test_three_bf16_mcm_lp_steps_match_the_jax_record(record):
    rec, st, csv = record
    ssl = st["ssl"]
    ms = ssl["modes"]["mcm-lp"]
    ds = IBMTransactionsAML(csv, khop_neighbors=ssl["khop_neighbors"],
                            pretrain={PretrainType.LINK_PRED,
                                      PretrainType.MASK})
    cfg = Config(model="tabgnnfused", data=csv, batch_size=ssl["batch_size"],
                 n_hidden=ssl["channels"], n_gnn_layers=ssl["num_layers"],
                 dropout=0.0, num_neg_samples=ssl["num_neg_samples"],
                 num_neighs=tuple(ssl["khop_neighbors"]), lr=ssl["lr"],
                 weight_decay=ssl["weight_decay"], adam_eps=ssl["adam_eps"],
                 seed=st["seed"], edge_capacity=ms["edge_capacity"],
                 node_capacity=ms["node_capacity"], device="cpu",
                 precision="bf16")
    tr = PretrainTrainer(cfg, ds, "mcm-lp")
    tr.model.load_state_dict(from_jax(random_variables(ms["shapes"],
                                                       st["var_seed"]),
                                      tr.model))
    tr.model.train()
    batches = list(zip(range(st["steps"]),
                       tr._batches(ds.edges.split()[0], "train", 0)))
    np.testing.assert_array_equal(batches[0][1].neg_edge_index,
                                  rec["mcm-lp/neg0"])
    terms = [loss_terms(*tr._step(gb.to("cpu"))) for _, gb in batches]
    hold_to_record(tr.model.state_dict(), terms, rec, "mcm-lp/", cfg.lr,
                   2 * st["steps"], ssl["channels"])


def test_bf16_step_keeps_masters_and_optimizer_state_float32(record):
    """The port's counterpart of ``tests/test_precision.py``'s master
    check: after a bf16 step the parameters, their gradients, Adam's
    moments and the BatchNorm statistics are float32, and the parameters
    moved."""
    _, st, csv = record
    tr, ds = supervised_trainer(st, csv, "bf16")
    before = {k: v.clone() for k, v in tr.model.state_dict().items()}
    tr.model.train()
    gb = next(tr._batches(ds.edges.split()[0], "train", 0))
    loss, aux = tr._step(gb.to("cpu"))
    assert loss.dtype == torch.float32 and aux["score"].dtype == torch.float32
    for name, p in tr.model.named_parameters():
        assert p.dtype == p.grad.dtype == torch.float32, name
        state = tr.optimizer.state[p]
        assert state["exp_avg"].dtype == state["exp_avg_sq"].dtype \
            == torch.float32, name
    for name, b in tr.model.named_buffers():
        if b.is_floating_point():
            assert b.dtype == torch.float32, name
    moved = [k for k, v in tr.model.state_dict().items()
             if not torch.equal(v, before[k])]
    assert any(k.endswith("qkv_kernel") for k in moved)


def test_train_and_predict_clis_run_bf16(record, tmp_path):
    """``cli.main --precision bf16`` trains an epoch and saves float32
    masters with the precision in the meta; ``cli.predict --precision
    bf16`` serves the checkpoint, within bf16's reach of the float32
    scores."""
    _, _, csv = record
    base = ["--data", csv, "--model", "tabgnn", "--n_hidden", "16",
            "--num_neighs", "8", "8", "--batch_size", "32", "--device",
            "cpu"]
    stats = {}
    (rec,), _ = train_cli.main(base + [
        "--epochs", "1", "--testing", "--precision", "bf16",
        "--wandb_dir", str(tmp_path)], stats)
    assert np.isfinite(rec["loss"]) and np.isfinite(rec["val_f1"])
    ck = os.path.join(stats["run_dir"], "0")
    with open(os.path.join(ck, "meta.json")) as f:
        assert json.load(f)["precision"] == "bf16"
    saved = torch.load(os.path.join(ck, "model.pt"), weights_only=True)
    assert all(v.dtype == torch.float32 for v in saved.values()
               if v.is_floating_point())
    scores = {}
    for prec in ("bf16", "f32"):
        out = predict.main(base + ["--load_model", ck, "--precision", prec,
                                   "--output", str(tmp_path / f"{prec}.csv")])
        assert np.isfinite(out["score"]).all()
        scores[prec] = out["score"]
    gap = np.abs(scores["bf16"] - scores["f32"])
    assert 0 < gap.max() < 0.05
