"""Layers of the PyTorch port against their JAX counterparts, one by one:
encoders, MaskedBatchNorm (eval, and train-mode batch statistics),
TransformerEncoderLayer, FTTransformerLayer, PNAConv, PNAConvHetero,
EdgeUpdateMLP and ClassifierHead. Every JAX leaf is randomized (biases and
BatchNorm statistics included) and carried over with ``from_jax``.
Tolerance 1e-5 abs/rel (float32, sums in another order)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rmm_tpu.frame.stype import Stype as JStype
from rmm_tpu.frame.tensor_frame import TensorFrame as JTensorFrame
from rmm_tpu.nn import decoders as jdec
from rmm_tpu.nn import encoders as jenc
from rmm_tpu.nn import norms as jnorms
from rmm_tpu.nn import transformer as jtr
from rmm_tpu.nn.gnn import conv as jconv
from rmm_tpu_torch.frame.stype import Stype
from rmm_tpu_torch.frame.tensor_frame import TensorFrame
from rmm_tpu_torch.nn import decoders, encoders, norms, transformer
from rmm_tpu_torch.nn.gnn import conv
from tests.torch_port_util import init_random, load_from_jax

TOL = dict(rtol=1e-5, atol=1e-5)
C = 16


def close(port_out, jax_out):
    np.testing.assert_allclose(port_out.detach().numpy(),
                               np.asarray(jax_out), **TOL)


def t(a):
    return torch.from_numpy(np.asarray(a))


def test_stypewise_encoder():
    rng = np.random.RandomState(0)
    n = 17
    num = rng.randn(n, 2).astype(np.float32) * 3 + 1
    num[3, 0] = np.nan                                   # → z-score 0
    cat = rng.randint(-1, 4, (n, 3)).astype(np.int32)    # −1 = missing
    ts = np.concatenate([rng.randint(0, 864000, n - 2),
                         [1_600_000_123, 1_700_000_000]]).astype(np.int64)
    rel = rng.randn(n, 2).astype(np.float32)
    names = {"numerical": ("a", "b"), "categorical": ("c", "d", "e"),
             "timestamp": ("t",), "relation": ("r0", "r1")}
    config = {"numerical": {"means": (1.1, -0.3), "stds": (2.9, 0.0)},
              "categorical": {"cardinalities": (4, 3, 5)}}
    blocks = {"numerical": num, "categorical": cat, "timestamp": ts[:, None],
              "relation": rel}

    jax_enc = jenc.StypeWiseFeatureEncoder(
        channels=C, col_names={JStype[k]: v for k, v in names.items()},
        col_config={JStype[k]: v for k, v in config.items()})
    jtf = JTensorFrame(feats={JStype[k]: jnp.asarray(v)
                              for k, v in blocks.items()},
                       col_names={JStype[k]: list(v)
                                  for k, v in names.items()})
    variables = init_random(jax_enc, jtf, seed=1)
    ref, _ = jax_enc.apply(variables, jtf)

    enc = load_from_jax(encoders.StypeWiseFeatureEncoder(
        C, {Stype[k]: v for k, v in names.items()},
        {Stype[k]: v for k, v in config.items()}), variables)
    tf = TensorFrame(feats={Stype[k]: t(v) for k, v in blocks.items()},
                     col_names={Stype[k]: list(v) for k, v in names.items()})
    close(enc(tf), ref)


@pytest.mark.parametrize("train", [False, True])
def test_masked_batchnorm(train):
    rng = np.random.RandomState(2)
    x = (rng.randn(20, C) * 2 + 0.5).astype(np.float32)
    mask = rng.rand(20) < 0.7
    jax_bn = jnorms.MaskedBatchNorm(C)
    variables = init_random(jax_bn, jnp.asarray(x), jnp.asarray(mask),
                            False, seed=3)
    ref, mutated = jax_bn.apply(variables, jnp.asarray(x), jnp.asarray(mask),
                                train, mutable=["batch_stats"])
    bn = load_from_jax(norms.MaskedBatchNorm(C), variables).train(train)
    close(bn(t(x), t(mask)), ref)
    stats = (mutated if train else variables)["batch_stats"]
    close(bn.running_mean, stats["mean"])
    close(bn.running_var, stats["var"])


@pytest.mark.parametrize("s", [2, 6])
def test_transformer_layers(s):
    x = np.random.RandomState(s).randn(9, s, C).astype(np.float32)
    for jax_cls, port_cls in ((jtr.TransformerEncoderLayer,
                               transformer.TransformerEncoderLayer),
                              (jtr.FTTransformerLayer,
                               transformer.FTTransformerLayer)):
        jax_layer = jax_cls(C, 8, None, 0.3)
        variables = init_random(jax_layer, jnp.asarray(x), True, seed=s)
        ref = jax_layer.apply(variables, jnp.asarray(x), True)
        layer = load_from_jax(port_cls(C, 8, None, 0.3), variables)
        with torch.no_grad():
            close(layer(t(x)), ref)


def graph_case(seed=4, v=10, e=40):
    """Every node but the last has >= 2 real in-edges and every node >= 2
    real out-edges; node v-1 has no in-edge. (A one-message segment has
    variance 0, and the JAX sums, differences of a running cumsum, round
    it to noise that sqrt amplifies; test_torch_segment checks those
    segments with exact sums.)"""
    rng = np.random.RandomState(seed)
    x = rng.randn(v, C).astype(np.float32)
    ea = rng.randn(e, C).astype(np.float32)
    base = 2 * v
    src = np.concatenate([np.tile(np.arange(v), 2),
                          rng.randint(0, v, e - base)])
    dst = np.concatenate([np.tile((np.arange(v) + 1) % (v - 1), 2),
                          rng.randint(0, v - 1, e - base)])
    ei = np.stack([src, dst]).astype(np.int32)
    mask = np.concatenate([np.ones(base, bool), rng.rand(e - base) < 0.7])
    return x, ei, ea, mask


@pytest.mark.parametrize("hetero", [False, True])
def test_pna_conv(hetero):
    x, ei, ea, mask = graph_case()
    jax_cls, port_cls = ((jconv.PNAConvHetero, conv.PNAConvHetero) if hetero
                         else (jconv.PNAConv, conv.PNAConv))
    args = (jnp.asarray(x), jnp.asarray(ei), jnp.asarray(ea),
            jnp.asarray(mask))
    jax_conv = jax_cls(C, 1.21)
    variables = init_random(jax_conv, *args, seed=5)
    ref = jax_conv.apply(variables, *args)
    layer = load_from_jax(port_cls(C, 1.21), variables)
    with torch.no_grad():
        close(layer(t(x), t(ei).long(), t(ea), t(mask)), ref)


def test_edge_update_mlp_and_classifier_head():
    x, ei, ea, _ = graph_case(6)
    args = (jnp.asarray(x), jnp.asarray(ei), jnp.asarray(ea))
    jax_mlp = jconv.EdgeUpdateMLP(C)
    variables = init_random(jax_mlp, *args, seed=7)
    mlp = load_from_jax(conv.EdgeUpdateMLP(C), variables)
    with torch.no_grad():
        close(mlp(t(x), t(ei).long(), t(ea)), jax_mlp.apply(variables, *args))

    b = 7
    head_args = (jnp.asarray(x), jnp.asarray(ei[:, :b]), jnp.asarray(ea[:b]))
    jax_head = jdec.ClassifierHead(2, C, 0.5)
    variables = init_random(jax_head, *head_args, True, seed=8)
    head = load_from_jax(decoders.ClassifierHead(2, C, C, 0.5), variables)
    with torch.no_grad():
        close(head(t(x), t(ei[:, :b]).long(), t(ea[:b])),
              jax_head.apply(variables, *head_args, True))
