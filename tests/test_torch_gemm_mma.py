"""The plain twin of the bf16 build's tensor-core GEMM
(``rmm_tpu_torch/ops/gemm_mma.py``, the arithmetic of
``csrc/gemm_mma.cuh``) on the CPU: the ``hi + lo`` split of a float32
operand, each of the six split-route products against a float64 product,
and the bf16 split routes computed through it against the port's plain
column attention (and its autograd) and against the JAX package's
``_attention_math`` / ``_attention_bwd_math`` on bf16 operands, called as
its Pallas kernels call them.

Tolerances, those of ``chip_smoke.py``'s ``kernel_bf16`` phase: out and dx
within one bf16 rounding (2^-7 of the value: both sides round float32
values whose sums run in another order) plus 1e-5 of the largest entry;
the float32 weight and bias gradients within 1e-4 of the largest entry.
A product with a float32 operand within 2^-15 of Σ|a||b| (2^-16 from the
split, the rest float32 sums over K <= 128)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rmm_tpu.ops.pallas.column_attention import (
    _attention_bwd_math,
    _attention_math,
)
from rmm_tpu_torch.ops import column_attention as ca
from rmm_tpu_torch.ops import gemm_mma as gm
from tests.torch_port_util import one_torch_thread  # noqa: F401

BF16, F32 = torch.bfloat16, torch.float32
GRAD_TOL = 1e-4
# (B, S, C, H): S = 6 (the edge tokens) and S = 20 (past 16: the long
# cores on the card), at the SSL width 128/8, the main path's 32/8 and
# C = 100/4 (bf16 rows of C % 8 = 4)
SHAPES = [(b, s, c, h) for s, b in ((6, 11), (20, 5))
          for c, h in ((128, 8), (32, 8), (100, 4))]


@pytest.mark.parametrize("scale", [2.0 ** -90, 1e-20, 1e-3, 1.0, 1e3,
                                   1e20, 2.0 ** 90])
def test_hi_lo_reconstructs_float32(scale):
    rng = np.random.RandomState(0)
    a = torch.from_numpy((rng.randn(4096) * scale).astype(np.float32))
    a[::7] = 0.0
    hi, lo = gm.split_bf16(a)
    assert hi.dtype == lo.dtype == BF16
    back = hi.double() + lo.double()
    err = (back - a.double()).abs()
    assert (err <= 2.0 ** -16 * a.double().abs()).all()
    zero = a == 0
    assert (hi[zero] == 0).all() and (lo[zero] == 0).all()
    # hi alone is a bf16 rounding: lo carries what it drops
    assert ((hi.double() - a.double()).abs()
            > 2.0 ** -16 * a.double().abs()).any()


@pytest.mark.parametrize("problem", list(gm.PROBLEMS))
def test_gemm_twin_matches_float64(problem):
    """Each problem's operand types, ragged sizes, a bias: within 2^-15 of
    Σ|a||b| of the float64 product; a float32 operand rounded to bf16 once
    would miss that where the split keeps it."""
    ta, _, tb, _, _ = gm.PROBLEMS[problem]
    rng = np.random.RandomState(len(problem))
    m, n, k = 37, 20, 100
    a = torch.from_numpy(rng.randn(m, k).astype(np.float32)).to(ta)
    b = torch.from_numpy(rng.randn(k, n).astype(np.float32)).to(tb)
    bias = torch.from_numpy(rng.randn(n).astype(np.float32)).to(tb)
    got = gm.reference_gemm_mma(a, b, bias)
    assert got.dtype == F32 and got.shape == (m, n)
    want = a.double() @ b.double() + bias.double()
    mag = a.double().abs() @ b.double().abs() + bias.double().abs()
    assert ((got.double() - want).abs() <= 2.0 ** -15 * mag).all()
    if F32 in (ta, tb):
        once = a.to(BF16).double() @ b.to(BF16).double() + bias.double()
        assert ((once - want).abs() > 2.0 ** -15 * mag).any()


def test_gemm_twin_takes_one_bf16_operand_at_least():
    a = torch.zeros(2, 3)
    with pytest.raises(TypeError):
        gm.reference_gemm_mma(a, torch.zeros(3, 4))


def bf16_case(b, s, c, h, masked):
    """Seeded bf16 x, do and weights (numpy draws), and the keep-mask
    (rate 0.3) or None."""
    rng = np.random.RandomState(b * s + c + h + int(masked))
    arrays = (rng.randn(b, s, c), rng.randn(c, 3 * c) / np.sqrt(c),
              rng.randn(3 * c) * 0.1, rng.randn(c, c) / np.sqrt(c),
              rng.randn(c) * 0.1, rng.randn(b, s, c))
    x, wqkv, bqkv, wout, bout, do = (
        torch.from_numpy(a.astype(np.float32)).to(BF16) for a in arrays)
    rate = 0.3 if masked else 0.0
    mask = (torch.from_numpy(rng.rand(b, h, s, s) >= rate) if masked
            else None)
    return x, do, (wqkv, bqkv, wout, bout), mask, rate


def assert_bf16_close(got, want):
    g, w = got.double(), want.double()
    bound = 2.0 ** -7 * torch.maximum(g.abs(), w.abs()) + 1e-5 * float(
        w.abs().max())
    excess = float(((g - w).abs() - bound).max())
    assert excess <= 0, excess


def assert_grads_close(got, want):
    for g, w in zip(got, want):
        g, w = torch.as_tensor(np.asarray(g, np.float64)).reshape(-1), \
            torch.as_tensor(np.asarray(w, np.float64)).reshape(-1)
        err = float((g - w).abs().max() / w.abs().max())
        assert err <= GRAD_TOL, err


def twin_route(x, do, weights, h, mask, rate):
    out = gm.reference_split_fwd_bf16(x, *weights, h, mask, rate)
    grads = gm.reference_split_bwd_bf16(x, do, *weights[:3], h, mask, rate)
    assert out.dtype == grads[0].dtype == BF16
    assert all(g.dtype == F32 for g in grads[1:])
    return out, grads


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("b,s,c,h", SHAPES)
def test_split_route_twin_matches_plain_attention(b, s, c, h, masked):
    """The bf16 split routes through the twin against
    ``reference_column_attention`` and its autograd on the same values."""
    x, do, weights, mask, rate = bf16_case(b, s, c, h, masked)
    out, grads = twin_route(x, do, weights, h, mask, rate)
    leaves = [x.detach().requires_grad_()] + [
        w.float().requires_grad_() for w in weights]
    ref = ca.reference_column_attention(*leaves, h, mask, rate)
    want = torch.autograd.grad(ref, leaves, do)
    assert_bf16_close(out, ref.detach())
    assert_bf16_close(grads[0], want[0])
    assert_grads_close([g.numpy() for g in grads[1:]],
                       [w.numpy() for w in want[1:]])


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("b,s,c,h", SHAPES)
def test_split_route_twin_matches_jax_math(b, s, c, h, masked):
    """The same inputs through the JAX package's ``_attention_math`` and
    ``_attention_bwd_math`` on bf16 x and weights, as its ``_fwd_kernel``
    and ``_bwd_kernel`` call them (do as float32 values, the outputs
    rounded to x's dtype, the weight gradients float32)."""
    x, do, weights, mask, rate = bf16_case(b, s, c, h, masked)
    out, grads = twin_route(x, do, weights, h, mask, rate)

    def j(t):
        return jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)

    jx, jw = j(x).reshape(b * s, c), [j(w) for w in weights]
    keep, inv_keep = None, 1.0
    if mask is not None:
        keep = jnp.asarray(mask.numpy().reshape(b, h * s, s), jnp.float32)
        inv_keep = 1.0 / (1.0 - rate)
    jout = _attention_math(jx, *jw, b, s, c, h, keep, inv_keep).astype(
        jnp.bfloat16)
    jdo = jnp.asarray(do.float().numpy().reshape(b * s, c))
    jgrads = _attention_bwd_math(jx, jdo, *jw[:3], b, s, c, h, keep,
                                 inv_keep)

    def f64(a):
        return torch.from_numpy(np.asarray(a.astype(jnp.float32),
                                           np.float64))

    assert_bf16_close(out.reshape(b * s, c), f64(jout))
    assert_bf16_close(grads[0].reshape(b * s, c),
                      f64(jgrads[0].astype(jnp.bfloat16)))
    assert_grads_close([g.numpy() for g in grads[1:]],
                       [np.asarray(g) for g in jgrads[1:]])
