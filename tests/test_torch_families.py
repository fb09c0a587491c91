"""The model families of the port's CLIs beyond ``tabgnn`` and
``tabgnnfused`` against ``rmm_tpu`` on the CPU, layer by layer and
backbone by backbone: the masked ``segment_sum``, ``GINEConv``,
``GINEConvHetero``, ``TGINEConv``, ``GINe``, ``PNAS``, ``PNA``, ``CPNA``,
``CPNATAB``, ``FTTransformerConvs``, ``FTTransformer`` and
``TABGNNInterleaved``, each forward and through ``jax.vjp``'s gradients
(parameters and float inputs) in train mode (BatchNorm on batch
statistics, whose running statistics are compared too), from randomized
JAX variables carried over by ``convert.from_jax``; then the task
wrappers' seeded initialization and their refusals.

Inputs are made from a seed with numpy; graphs hold padded lanes
(``edge_mask``) and padded nodes (``node_mask``). The reference's PNA sums
go through its scatter path (``RMM_SEGMENT_IMPL=scatter``): its default
path takes them as differences of one running float32 cumsum, whose
rounding noise the port does not copy.

Tolerances (the port's parity tests' limits): forward 1e-5 absolute;
gradients 1e-4 relative to the reference's largest gradient entry of the
module, BatchNorm statistics 1e-4 relative to each one's largest entry
(float32, sums in another order). Gradients are held to the module's
largest entry, not each tensor's: a tensor whose true gradient is 0 (the
biases right before a train-mode BatchNorm) comes out as float32 noise on
both sides, and PNA's std (``√(var + 1e-5)``) amplifies rounding where a
node's few messages lie close: in ``CPNA``'s six reversed convs here the
reference's float32 weight gradients lie up to 1.5e-4 of their own
largest entry from a float64 run, the port's 2.1e-4 (2-7e-5 and 0.2-1e-4
of the module's largest entry).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rmm_tpu.nn import transformer as jtransformer
from rmm_tpu.nn.gnn import conv as jconv
from rmm_tpu.nn.gnn import models as jmodels
from rmm_tpu.nn.models import ft_transformer as jft
from rmm_tpu.nn.models import interleaved as jinter
from rmm_tpu.ops import segment as jsegment
from rmm_tpu_torch.convert import from_jax
from rmm_tpu_torch.datasets import (IBMTransactionsAML,
                                    write_synthetic_aml_csv)
from rmm_tpu_torch.nn import transformer
from rmm_tpu_torch.nn.gnn import conv, models
from rmm_tpu_torch.nn.models import ft_transformer, interleaved
from rmm_tpu_torch.ops.segment import segment_sum
from rmm_tpu_torch.train import task_models
from rmm_tpu_torch.train.trainer import build_task_model
from rmm_tpu_torch.utils.config import Config
from tests.torch_port_util import init_random, load_from_jax, \
    one_torch_thread  # noqa: F401

FWD_ATOL = 1e-5
GRAD_RTOL = 1e-4
C = 16
FAMILIES = ("fttransformer", "gin", "pna", "cpna", "cpnatab",
            "tabgnninterleaved")


@pytest.fixture(autouse=True)
def scatter_sums(monkeypatch):
    monkeypatch.setenv("RMM_SEGMENT_IMPL", "scatter")


def graph_case(seed=4, v=10, e=40, node_cols=2, edge_cols=3):
    """Tokens ``x [v, node_cols, C]`` and ``ea [e, edge_cols, C]``; every
    node but the last has >= 2 real in-edges (two distinct messages: PNA's
    std stays off its clamp) and >= 2 real out-edges; the remaining lanes
    are real or padded at random; the last node is a padded one."""
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


def to_torch(a):
    a = np.asarray(a)
    t = torch.from_numpy(a)
    return t.long() if a.dtype.kind in "iu" else t


def rel_err(got, want, scale: float = 0.0) -> float:
    """The largest error over ``scale``, at least ``want``'s largest
    entry."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = max(float(np.abs(want).max()), scale, 1e-30)
    return float(np.abs(got - want).max()) / scale


def check_module(jax_mod, port_mod, args, diff, seed, call_kw=None,
                 init_kw=None, train=True):
    """Forward, gradients (of every parameter and of the float inputs at
    positions ``diff``, for a random cotangent of every output) and, in
    train mode, the BatchNorm running statistics of ``port_mod`` against
    ``jax_mod`` on the same ``args`` and randomized variables."""
    jargs = [jnp.asarray(a) for a in args]
    variables = init_random(jax_mod, *jargs, seed=seed, **(init_kw or {}))
    stats = variables.get("batch_stats")

    def f(params, *floats):
        a = list(jargs)
        for i, v in zip(diff, floats):
            a[i] = v
        v = {"params": params}
        if stats is not None:
            v["batch_stats"] = stats
            if train:
                return jax_mod.apply(v, *a, **(call_kw or {}),
                                     mutable=["batch_stats"])
        return jax_mod.apply(v, *a, **(call_kw or {})), {}

    ref, vjp, mutated = jax.vjp(f, variables["params"],
                                *[jargs[i] for i in diff], has_aux=True)
    single = not isinstance(ref, tuple)
    refs = (ref,) if single else ref
    rng = np.random.RandomState(seed + 7)
    cots = [rng.randn(*np.shape(r)).astype(np.float32) for r in refs]
    jgrads = vjp(jnp.asarray(cots[0]) if single
                 else tuple(jnp.asarray(c) for c in cots))

    port = load_from_jax(port_mod, variables)
    port.train(train)
    targs = [to_torch(a) for a in args]
    for i in diff:
        targs[i].requires_grad_()
    outs = port(*targs)
    outs = (outs,) if single else outs
    assert len(outs) == len(refs)
    for o, r in zip(outs, refs):
        assert o.shape == r.shape
        np.testing.assert_allclose(o.detach().numpy(), np.asarray(r),
                                   rtol=0, atol=FWD_ATOL)
    params = dict(port.named_parameters())
    got = torch.autograd.grad(outs, [targs[i] for i in diff]
                              + list(params.values()),
                              [torch.from_numpy(c) for c in cots],
                              allow_unused=True)
    want = {**{f"input {i}": np.asarray(g)
               for i, g in zip(diff, jgrads[1:])},
            **{k: v.numpy() for k, v in from_jax(
                {"params": jax.tree_util.tree_map(np.asarray, jgrads[0])}
            ).items()}}
    names = [f"input {i}" for i in diff] + list(params)
    assert set(names) == set(want)
    scale = max(float(np.abs(w).max()) for w in want.values())
    for name, g in zip(names, got):
        g = np.zeros_like(want[name]) if g is None else g.numpy()
        assert rel_err(g, want[name], scale) <= GRAD_RTOL, name
    if train and stats is not None:
        buffers = dict(port.named_buffers())
        ref_stats = from_jax({"batch_stats": jax.tree_util.tree_map(
            np.asarray, mutated["batch_stats"])})
        assert set(ref_stats) == set(buffers)
        for k, v in ref_stats.items():
            assert rel_err(buffers[k].numpy(), v.numpy()) <= GRAD_RTOL, k
    return port


# ---------------------------------------------------------------- ops


@pytest.mark.parametrize("impl", ["scatter", "sort"])
def test_masked_segment_sum_matches_jax(impl):
    rng = np.random.RandomState(3)
    data = rng.randn(50, 3, 4).astype(np.float32)
    ids = rng.randint(0, 7, 50).astype(np.int32)
    mask = rng.rand(50) < 0.7
    ids[~mask & (rng.rand(50) < 0.5)] = 6     # padding lanes on a real node
    want = jsegment.segment_sum(jnp.asarray(data), jnp.asarray(ids), 8,
                                jnp.asarray(mask), impl=impl)
    got = segment_sum(torch.from_numpy(data), torch.from_numpy(ids), 8,
                      torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=FWD_ATOL)
    assert (got[7] == 0).all()                     # no real lane reaches it
    unmasked = segment_sum(torch.from_numpy(data), torch.from_numpy(ids), 8)
    np.testing.assert_allclose(unmasked.numpy(), np.asarray(
        jsegment.segment_sum(jnp.asarray(data), jnp.asarray(ids), 8,
                             impl=impl)), rtol=0, atol=FWD_ATOL)


# ------------------------------------------------------------- convs


@pytest.mark.parametrize("hetero", [False, True])
def test_gine_conv(hetero):
    x, ei, ea, mask, _ = graph_case(5)
    jcls, pcls = ((jconv.GINEConvHetero, conv.GINEConvHetero) if hetero
                  else (jconv.GINEConv, conv.GINEConv))
    check_module(jcls(C), pcls(C), (x[:, 0], ei, ea[:, 0], mask), (0, 2),
                 seed=11, train=False)


def test_tgine_conv():
    x, ei, _, mask, _ = graph_case(6)
    ea = np.random.RandomState(2).randn(40, 12).astype(np.float32)
    check_module(jconv.TGINEConv(C, (5, 7)),
                 conv.TGINEConv(C, (5, 7), edge_in=12),
                 (x[:, 0], ei, ea, mask), (0, 2), seed=12, train=False)


# --------------------------------------------------------- backbones

FLAGS = [(e, r) for e in (False, True) for r in (False, True)]


@pytest.mark.parametrize("emlps,reverse_mp", FLAGS)
def test_gine_stack(emlps, reverse_mp):
    x, ei, ea, mask, nmask = graph_case(7)
    check_module(
        jmodels.GINe(C, 2, emlps, reverse_mp),
        models.GINe(2, 3, C, C, 2, edge_updates=emlps,
                    reverse_mp=reverse_mp),
        (x, ei, ea, mask, nmask), (0, 2), seed=13,
        call_kw={"train": True}, init_kw={"train": False})


@pytest.mark.parametrize("emlps,reverse_mp", FLAGS)
def test_pnas_stack(emlps, reverse_mp):
    x, ei, ea, mask, nmask = graph_case(8)
    check_module(
        jmodels.PNAS(C, 2, 1.37, emlps, reverse_mp),
        models.PNAS(2, 3, C, C, 2, 1.37, edge_updates=emlps,
                    reverse_mp=reverse_mp),
        (x, ei, ea, mask, nmask), (0, 2), seed=14,
        call_kw={"train": True}, init_kw={"train": False})


@pytest.mark.parametrize("emlps,reverse_mp", FLAGS)
def test_pna_stack_with_target_edges(emlps, reverse_mp):
    x, ei, ea, mask, nmask = graph_case(9)
    target = np.random.RandomState(9).randn(6, 3 * C).astype(np.float32)
    check_module(
        jmodels.PNA(C, 2, 1.37, emlps, reverse_mp),
        models.PNA(2 * C, 3 * C, C, 2, 1.37, edge_updates=emlps,
                   reverse_mp=reverse_mp),
        (x.reshape(10, -1), ei, ea.reshape(40, -1), target, mask, nmask),
        (0, 2, 3), seed=15, call_kw={"train": True},
        init_kw={"train": False})


@pytest.mark.parametrize("emlps,reverse_mp", FLAGS)
def test_cpna_stack(emlps, reverse_mp):
    x, ei, ea, mask, nmask = graph_case(10)
    port = check_module(
        jmodels.CPNA(C, 2, 3, 1.37, emlps, reverse_mp),
        models.CPNA(2, C, C, 2, 3, 1.37, emlps, reverse_mp),
        (x, ei, ea, mask, nmask), (0, 2), seed=16,
        call_kw={"train": True}, init_kw={"train": False})
    # one chain per column, the node states carried across columns
    assert {n.split(".")[0] for n, _ in port.named_children()} >= {
        f"conv_{c}_{i}" for c in range(3) for i in range(2)}


@pytest.mark.parametrize("emlps,reverse_mp", FLAGS)
def test_cpnatab_stack(emlps, reverse_mp):
    x, ei, ea, mask, nmask = graph_case(11)
    check_module(
        jmodels.CPNATAB(C, 2, 3, 1.37, emlps, reverse_mp, dropout=0.0),
        models.CPNATAB(2, C, C, 2, 3, 1.37, emlps, reverse_mp, dropout=0.0),
        (x, ei, ea, mask, nmask), (0, 2), seed=17,
        call_kw={"train": True}, init_kw={"train": False})


def test_cpnatab_row_attention_keeps_the_fixed_dropout():
    """The reference gives the row attention 8 heads and its class default
    dropout 0.1 (``GNNWrap`` passes none)."""
    m = models.CPNATAB(2, C, C, 2, 3)
    attn = m.row_att_1.self_attn
    assert (attn.nhead, attn.dropout, m.row_att_0.drop.rate) == (8, 0.1, 0.1)


@pytest.mark.parametrize("kernel", [False, True])
def test_fttransformer_convs(kernel):
    """The CLS prepend, two encoder layers and the final norm; with
    ``kernel`` the reference's attention goes through its Pallas kernel in
    interpret mode (its TPU path), else through its CPU einsums."""
    from tests.torch_port_util import jax_kernel_attention

    x = np.random.RandomState(18).randn(12, 5, C).astype(np.float32)
    mod = jtransformer.FTTransformerConvs(C, 2, nhead=4, dropout=0.0)
    kw = dict(seed=18, call_kw={"deterministic": True},
              init_kw={"deterministic": True}, train=True)
    if kernel:
        with jax_kernel_attention():
            check_module(mod, transformer.FTTransformerConvs(C, 2, 4, 0.0),
                         (x,), (0,), **kw)
    else:
        check_module(mod, transformer.FTTransformerConvs(C, 2, 4, 0.0),
                     (x,), (0,), **kw)


def test_fttransformer_model():
    x = np.random.RandomState(19).randn(12, 3, C).astype(np.float32)
    port = check_module(jft.FTTransformer(C, 2, dropout=0.0),
                        ft_transformer.FTTransformer(C, 2, dropout=0.0),
                        (x,), (0,), seed=19, call_kw={"deterministic": True},
                        init_kw={"deterministic": True})
    assert hasattr(port.backbone, "cls_token")


@pytest.mark.parametrize("reverse_mp", [False, True])
def test_tabgnn_interleaved(reverse_mp):
    x, ei, ea, mask, nmask = graph_case(12)
    check_module(
        jinter.TABGNNInterleaved(C, 2, node_dim=2 * C, nhidden=C,
                                 avg_log_deg=1.37, reverse_mp=reverse_mp,
                                 dropout=0.0),
        interleaved.TABGNNInterleaved(C, 2, node_dim=2 * C, nhidden=C,
                                      avg_log_deg=1.37,
                                      reverse_mp=reverse_mp, dropout=0.0),
        (x, ei, ea, mask, nmask), (0, 2), seed=20,
        call_kw={"train": True}, init_kw={"train": False})


def test_tabgnn_interleaved_needs_channels_equal_nhidden():
    with pytest.raises(AssertionError, match="channels == nhidden"):
        interleaved.TABGNNInterleaved(C, 2, node_dim=C, nhidden=2 * C)


# ---------------------------------------------- wrappers, initialization


@pytest.fixture(scope="module")
def tiny_aml(tmp_path_factory):
    csv = str(tmp_path_factory.mktemp("families") / "aml.csv")
    write_synthetic_aml_csv(csv, num_rows=400, num_accounts=30, seed=5)
    return csv, IBMTransactionsAML(csv, khop_neighbors=(4, 4))


def tiny_cfg(csv, model, **kw):
    return Config(data=csv, model=model, n_hidden=C, n_gnn_layers=2,
                  num_neighs=(4, 4), batch_size=16, device="cpu", **kw)


@pytest.mark.parametrize("model", FAMILIES)
def test_init_parameters_reaches_every_leaf(tiny_aml, model):
    """Every parameter of each family gets the reference's initializer:
    none is left as it was (NaN here), dense kernels are lecun-normal
    (std 1/√fan_in), biases zero, norm scales one, CLS tokens
    normal(0.01)."""
    csv, ds = tiny_aml
    wrapper = build_task_model(tiny_cfg(csv, model), ds)
    with torch.no_grad():
        for p in wrapper.parameters():
            p.fill_(float("nan"))
    task_models.init_parameters(wrapper, seed=3)
    for name, p in wrapper.named_parameters():
        assert torch.isfinite(p).all(), name
    for name, mod in wrapper.named_modules():
        if isinstance(mod, torch.nn.Linear):
            assert (mod.bias == 0).all(), name
            std = float(mod.weight.detach().std()) * np.sqrt(mod.in_features)
            assert 0.5 < std < 1.5, name
        elif isinstance(mod, torch.nn.LayerNorm):
            assert (mod.weight == 1).all() and (mod.bias == 0).all(), name
        elif isinstance(mod, transformer.CLSToken):
            assert 0.002 < float(mod.cls.detach().std()) < 0.03, name


@pytest.mark.parametrize("model", FAMILIES)
def test_emlps_reaches_the_gnn_baselines_only(tiny_aml, model):
    csv, ds = tiny_aml
    on = build_task_model(tiny_cfg(csv, model, emlps=True), ds)
    off = build_task_model(tiny_cfg(csv, model), ds)
    has = [any("emlp_" in n for n, _ in m.named_modules())
           for m in (on, off)]
    assert has == ([True, False] if model in task_models.GNNWrap.MODELS
                   else [False, False])


@pytest.mark.parametrize("model", FAMILIES)
@pytest.mark.parametrize("task", ["node_classification", "mcm_edge_table"])
def test_other_tasks_are_refused_by_name(tiny_aml, model, task):
    csv, ds = tiny_aml
    with pytest.raises(NotImplementedError, match=f"task {task!r}.*{model}"):
        build_task_model(tiny_cfg(csv, model, task=task), ds)


@pytest.mark.parametrize("model", FAMILIES)
def test_bf16_is_refused_by_name(tiny_aml, model):
    csv, ds = tiny_aml
    with pytest.raises(NotImplementedError,
                       match=f"--precision bf16.*{model}"):
        build_task_model(tiny_cfg(csv, model, precision="bf16"), ds)


def test_wide_gnn_heads_read_every_column(tiny_aml):
    """``cpna`` and ``cpnatab`` keep an edge state per column: the
    classifier's first layer takes 2·n_hidden + num_edge_cols·n_hidden."""
    csv, ds = tiny_aml
    cols = ds.edges.tensor_frame.num_cols
    for model, width in [("pna", C), ("cpna", cols * C),
                         ("cpnatab", cols * C)]:
        head = build_task_model(tiny_cfg(csv, model), ds).decoder
        assert head.mlp.fc1.in_features == 2 * C + width, model
