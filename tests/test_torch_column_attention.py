"""Column attention of the PyTorch port (its plain twin, which CPU tensors
take) against the JAX package: the XLA reference, the Pallas kernel in
interpret mode, and the flax ``MultiHeadSelfAttention`` on both of its
paths (head-expanded below head_dim 16, canonical at 16); and the twin's
gradients (autograd) against ``jax.vjp`` of the reference and of the Pallas
kernel's custom VJP (``_bwd_kernel``), with and without a keep-mask.

Tolerance 1e-5 abs/rel: float32 on both sides, sums in another order; 1e-4
for the weight and bias gradients, sums over all B·S tokens."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rmm_tpu.nn.transformer import MultiHeadSelfAttention as FlaxAttention
from rmm_tpu.ops.pallas.column_attention import (
    fused_column_attention as jax_fused,
    reference_column_attention as jax_reference,
)
from rmm_tpu_torch.nn.transformer import MultiHeadSelfAttention
from rmm_tpu_torch.ops import column_attention as ca
from tests.torch_port_util import init_random, load_from_jax

TOL = dict(rtol=1e-5, atol=1e-5)
WIDTHS = [(32, 8), (64, 4), (128, 8)]   # (C, nhead): hd 4, 16, 16
B = 13                                  # no multiple of 8


def make_inputs(seed, b, s, c):
    rng = np.random.RandomState(seed)
    return (rng.randn(b, s, c).astype(np.float32),
            (rng.randn(c, 3 * c) / np.sqrt(c)).astype(np.float32),
            (rng.randn(3 * c) * 0.1).astype(np.float32),
            (rng.randn(c, c) / np.sqrt(c)).astype(np.float32),
            (rng.randn(c) * 0.1).astype(np.float32))


def port_attention(arrays, nhead, mask=None, rate=0.0):
    tensors = [torch.from_numpy(a) for a in arrays]
    m = None if mask is None else torch.from_numpy(mask)
    return ca.fused_column_attention(*tensors, nhead, drop_mask=m,
                                     dropout_rate=rate).numpy()


@pytest.mark.parametrize("s", [2, 6])
@pytest.mark.parametrize("c,h", WIDTHS)
def test_plain_matches_jax_reference_and_pallas(c, h, s):
    arrays = make_inputs(c + s, B, s, c)
    out = port_attention(arrays, h)
    jarr = [jnp.asarray(a) for a in arrays]
    np.testing.assert_allclose(out, np.asarray(jax_reference(*jarr, h)),
                               **TOL)
    pallas = jax_fused(*jarr, h, block_rows=8, interpret=True)
    np.testing.assert_allclose(out, np.asarray(pallas), **TOL)


@pytest.mark.parametrize("s", [2, 6])
@pytest.mark.parametrize("c,h", WIDTHS)
def test_module_matches_flax_attention(c, h, s):
    x = np.random.RandomState(s).randn(B, s, c).astype(np.float32)
    flax_mod = FlaxAttention(c, h, dropout=0.0, use_pallas="never")
    variables = init_random(flax_mod, jnp.asarray(x), seed=c)
    ref = flax_mod.apply(variables, jnp.asarray(x), deterministic=True)
    port = load_from_jax(MultiHeadSelfAttention(c, h), variables)
    with torch.no_grad():
        out = port(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(out, np.asarray(ref), **TOL)


@pytest.mark.parametrize("c,h", WIDTHS)
def test_keep_mask_matches_jax(c, h):
    s, rate = 6, 0.3
    arrays = make_inputs(c, B, s, c)
    mask = np.random.RandomState(c + 1).rand(B, h, s, s) >= rate
    out = port_attention(arrays, h, mask, rate)
    jarr = [jnp.asarray(a) for a in arrays]
    ref = jax_reference(*jarr, h, drop_mask=jnp.asarray(mask),
                        dropout_rate=rate)
    np.testing.assert_allclose(out, np.asarray(ref), **TOL)
    pallas = jax_fused(*jarr, h, drop_mask=jnp.asarray(mask),
                       dropout_rate=rate, block_rows=8, interpret=True)
    np.testing.assert_allclose(out, np.asarray(pallas), **TOL)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("s", [2, 6])
@pytest.mark.parametrize("c,h", WIDTHS)
def test_gradients_match_jax_vjp(c, h, s, masked):
    arrays = make_inputs(c + s + 7, B, s, c)
    rng = np.random.RandomState(c * s)
    cot = rng.randn(B, s, c).astype(np.float32)
    rate = 0.3 if masked else 0.0
    mask = rng.rand(B, h, s, s) >= rate if masked else None
    jmask = None if mask is None else jnp.asarray(mask)
    jarr = [jnp.asarray(a) for a in arrays]

    tensors = [torch.from_numpy(a).requires_grad_() for a in arrays]
    out = ca.fused_column_attention(
        *tensors, h, drop_mask=None if mask is None else torch.from_numpy(mask),
        dropout_rate=rate)
    grads = torch.autograd.grad(out, tensors, torch.from_numpy(cot))

    def reference(*a):
        return jax_reference(*a, h, drop_mask=jmask, dropout_rate=rate)

    def pallas(*a):
        return jax_fused(*a, h, drop_mask=jmask, dropout_rate=rate,
                         block_rows=8, interpret=True)

    for fn in (reference, pallas):
        _, vjp = jax.vjp(fn, *jarr)
        want = vjp(jnp.asarray(cot))
        np.testing.assert_allclose(grads[0].numpy(), np.asarray(want[0]),
                                   **TOL)
        for got, ref in zip(grads[1:], want[1:]):
            np.testing.assert_allclose(got.numpy(), np.asarray(ref),
                                       rtol=1e-4, atol=1e-4)


def test_cpu_tensors_never_launch_the_kernel():
    arrays = make_inputs(0, B, 6, 32)
    port_attention(arrays, 8)
    port_attention(arrays, 8, np.ones((B, 8, 6, 6), bool), 0.1)
    tensors = [torch.from_numpy(a).requires_grad_() for a in arrays]
    ca.fused_column_attention(*tensors, 8).sum().backward()
    assert ca.launches == ca.bwd_launches == ca.reduce_launches == 0


def test_wrapper_checks_shapes():
    x, wqkv, bqkv, wout, bout = (torch.from_numpy(a)
                                 for a in make_inputs(0, 4, 6, 32))
    with pytest.raises(ValueError):
        ca.fused_column_attention(x, wqkv.t(), bqkv, wout, bout, 8)
    with pytest.raises(ValueError):
        ca.fused_column_attention(x, wqkv, bqkv, wout, bout, 5)
    with pytest.raises(ValueError):
        ca.fused_column_attention(x, wqkv, bqkv, wout, bout, 8,
                                  drop_mask=torch.ones(4, 8, 5, 5, dtype=bool),
                                  dropout_rate=0.1)
