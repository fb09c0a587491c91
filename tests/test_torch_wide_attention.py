"""Column attention at the widths and row lengths past the card's old limits
(C > 128; rows longer than a block's shared memory holds, which the card
walks in place, the long cores' direct form): the port's plain twin (what
CPU tensors take) against the JAX reference and the Pallas kernel in
interpret mode, forward and ``jax.vjp`` gradients, with a keep-mask and
without; and the wrapper's choice of route and core form with an H100's
shared-memory sizes.

Tolerances as ``tests/test_torch_column_attention.py``'s: 1e-5 abs/rel for
the output and dx (float32, sums in another order), 1e-4 for the weight
and bias gradients (sums over every B·S token)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rmm_tpu.ops.pallas.column_attention import (
    fused_column_attention as jax_fused,
    reference_column_attention as jax_reference,
)
from rmm_tpu_torch.ops import column_attention as ca

TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-4)

# (B, S, C, nhead): C = 256 at head widths 32 and 64; C = 130 at 13 (not a
# multiple of 4: the narrow GEMMs); S = 400 at C = 32, past the 392 tokens
# the cores stage there; S = 60 at C = 256, past 55
WIDE = [(3, 6, 256, 8), (3, 6, 256, 4), (5, 6, 130, 10), (2, 400, 32, 8),
        (2, 60, 256, 8)]

# An H100's shared memory: bytes a block may opt into, bytes an SM
H100_BLOCK, H100_SM = 232_448, 233_472


def make_inputs(seed, b, s, c):
    rng = np.random.RandomState(seed)
    return (rng.randn(b, s, c).astype(np.float32),
            (rng.randn(c, 3 * c) / np.sqrt(c)).astype(np.float32),
            (rng.randn(3 * c) * 0.1).astype(np.float32),
            (rng.randn(c, c) / np.sqrt(c)).astype(np.float32),
            (rng.randn(c) * 0.1).astype(np.float32))


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("b,s,c,h", WIDE)
def test_wide_shapes_match_the_reference_and_pallas(b, s, c, h, masked):
    """Forward and gradients of the plain twin against the JAX reference
    and the Pallas kernel (its custom VJP's ``_bwd_kernel``) in interpret
    mode, with the node path's 0.083 keep-mask and without it."""
    arrays = make_inputs(b * s + c + h, b, s, c)
    rng = np.random.RandomState(s + c)
    cot = rng.randn(b, s, c).astype(np.float32)
    rate = 0.083 if masked else 0.0
    mask = rng.rand(b, h, s, s) >= rate if masked else None
    jmask = None if mask is None else jnp.asarray(mask)
    jarr = [jnp.asarray(a) for a in arrays]
    tensors = [torch.from_numpy(a).requires_grad_() for a in arrays]
    out = ca.fused_column_attention(
        *tensors, h, drop_mask=None if mask is None
        else torch.from_numpy(mask), dropout_rate=rate)
    assert out.shape == (b, s, c)
    grads = torch.autograd.grad(out, tensors, torch.from_numpy(cot))

    def reference(*a):
        return jax_reference(*a, h, drop_mask=jmask, dropout_rate=rate)

    def pallas(*a):
        return jax_fused(*a, h, drop_mask=jmask, dropout_rate=rate,
                         block_rows=8, interpret=True)

    for fn in (reference, pallas):
        want_out, vjp = jax.vjp(fn, *jarr)
        np.testing.assert_allclose(out.detach().numpy(),
                                   np.asarray(want_out), **TOL)
        want = vjp(jnp.asarray(cot))
        np.testing.assert_allclose(grads[0].numpy(), np.asarray(want[0]),
                                   **TOL)
        for got, ref in zip(grads[1:], want[1:]):
            np.testing.assert_allclose(got.numpy(), np.asarray(ref),
                                       **GRAD_TOL)


@pytest.mark.parametrize("b,s,c,h", WIDE)
def test_wide_core_between_projections_matches_jax(b, s, c, h):
    """The split forward's plain core (q | k | v in, ctx out, the twin of
    the staged and the direct cores alike) between ``torch.matmul``
    projections is the JAX reference's attention; CPU tensors take it
    whatever ``direct`` asks."""
    x, wqkv, bqkv, wout, bout = make_inputs(c + s, b, s, c)
    tok = (torch.matmul(torch.from_numpy(x), torch.from_numpy(wqkv))
           + torch.from_numpy(bqkv))
    ctx = ca.reference_attention_core(tok, h)
    for direct in (None, True, False):
        assert torch.equal(ca.attention_core_fwd(tok, h, direct=direct),
                           ctx)
    out = (torch.matmul(ctx, torch.from_numpy(wout))
           + torch.from_numpy(bout)).numpy()
    ref = jax_reference(*(jnp.asarray(a) for a in (x, wqkv, bqkv, wout,
                                                  bout)), h)
    np.testing.assert_allclose(out, np.asarray(ref), **TOL)


def h100_row_bytes(s: int, c: int, nhead: int) -> tuple[int, int]:
    """A row's bytes in the staged cores as the CUDA library computes them
    (``fwd_core_smem_floats`` and ``core_smem_floats``; the card test
    ``test_row_bytes_match_the_library`` holds them equal): forward, S
    token rows at the padded stride; backward, S rows of 4C + 4 floats
    and 2·H·S² floats of P and dS (past S = 16: 2·H·S of L and D)."""
    row = (3 * c + 3) // 4 * 4
    stride = (row + 31) // 32 * 32 + 4 if c % 4 else row + 4
    per = 2 * nhead * s if s > 16 else 2 * nhead * s * s
    return 4 * s * stride, 4 * (s * (4 * c + 4) + per)


@pytest.mark.parametrize("c", [32, 128, 256])
@pytest.mark.parametrize("s", [16, 55, 56, 392, 393])
def test_route_and_core_form_on_an_h100(c, s):
    """The wrapper's choice on an H100 (8 heads): the tiled kernels at
    C <= 64 up to S = 16, the split routes elsewhere; their cores stage a
    row where it fits a block (the longest, ``max_s``: 392 tokens at
    C = 32, 109 at C = 128, 55 at C = 256) and walk a longer one in device
    memory."""
    longest = {32: 392, 128: 109, 256: 55}[c]
    assert ca.core_max_s(c, 8, H100_BLOCK, H100_SM,
                         h100_row_bytes) == longest
    form = ca.core_form(s, c, 8, H100_BLOCK, H100_SM, h100_row_bytes)
    assert form == ("staged" if s <= longest else "direct")
    assert ca.route(c, s) == ("tiled" if c == 32 and s <= 16 else "split")


def test_short_rows_of_a_very_wide_c_take_the_direct_form():
    """At S <= 16 only a row wider than a block goes direct: C = 2048 at
    S = 16 (a backward row of 540,928 bytes), not at S = 6 (199,008)."""
    assert ca.core_form(16, 2048, 8, H100_BLOCK, H100_SM,
                        h100_row_bytes) == "direct"
    assert ca.core_form(6, 2048, 8, H100_BLOCK, H100_SM,
                        h100_row_bytes) == "staged"
    assert h100_row_bytes(6, 2048, 8)[1] == 199_008


@pytest.mark.parametrize("b,h,want", [(4096, 8, 1), (4096, 4, 1),
                                      (4096, 1, 1), (3, 1, 1)])
def test_direct_plans_give_each_warp_a_row_head(b, h, want):
    """The direct form stages nothing: a block takes one row (and one of
    its heads: ``core_blocks``), whatever S and the budget; both plans
    carry the form and cover the B rows once."""
    assert ca.core_rows(b, 6, h, None) == want
    fwd = ca.split_fwd_plan(b, 400, h, None)
    bwd = ca.split_plan(b, 400, 256, h, 132, 2, None)
    for plan in (fwd, bwd):
        assert plan.direct and plan.rows == want
        assert (plan.grid - 1) * plan.rows < b <= plan.grid * plan.rows
    staged = ca.split_plan(b, 6, 256, h, 132, 2, 113 * 1024 // 26_976)
    assert not staged.direct


@pytest.mark.parametrize("c", [32, 128, 256])
def test_direct_form_starts_just_past_max_s(c):
    """On an H100 (8 heads) the cores stage every row up to ``max_s``
    tokens and take the direct form from the next token on."""
    longest = ca.core_max_s(c, 8, H100_BLOCK, H100_SM, h100_row_bytes)
    for s in range(ca.MAX_S + 1, 2 * longest):
        form = ca.core_form(s, c, 8, H100_BLOCK, H100_SM, h100_row_bytes)
        assert form == ("staged" if s <= longest else "direct"), s


def test_direct_smem_fits_two_blocks_an_sm_whatever_s():
    """A direct-form block's shared memory (its ring of chunks) is the
    same at every S and leaves room for at least two blocks an SM of an
    H100 (each with the runtime's 1 kB) at every C <= 1024 and every
    nhead that divides it; 32 keys a chunk up to head width 95."""
    for c in range(1, 1025):
        for h in (h for h in range(1, c + 1) if c % h == 0):
            got = {ca.direct_smem_bytes(s, c, h) for s in (1, 17, 167, 5000)}
            assert len(got) == 1, (c, h, got)
            (smem,) = got
            assert 2 * (smem + 1024) <= H100_SM, (c, h, smem)
    assert ca.direct_smem_bytes(167, 256, 8) == 2 * 32 * 68 * 4
    assert ca.direct_smem_bytes(167, 1024, 1) == 2 * 4 * 2052 * 4
    assert ca.direct_smem_bytes(167, 95, 1) == 2 * 32 * 192 * 4


@pytest.mark.parametrize("b,s,c", [(131072, 6, 256), (131072, 6, 128),
                                   (4096, 167, 256), (13, 6, 256)])
def test_bf16_splits_sum_at_most_mma_split_tokens(b, s, c):
    """The bf16 build's weight-gradient GEMM sums at most
    ``MMA_SPLIT_TOKENS`` tokens a split (its tensor cores' float32 sums
    drift with the count), the splits covering the B·S tokens once, in
    order; the float32 build keeps one split a slot of the card."""
    n = b * s
    fit = 113 * 1024 // (4 * s * 1044)
    free = ca.split_plan(b, s, c, 8, 132, 2, fit)
    plan = ca.split_plan(b, s, c, 8, 132, 2, fit,
                         max_split_tokens=ca.MMA_SPLIT_TOKENS)
    assert plan.split_tokens == min(free.split_tokens, ca.MMA_SPLIT_TOKENS)
    assert plan.slices == -(-n // plan.split_tokens)
    assert (plan.slices - 1) * plan.split_tokens < n
    assert plan.slices * plan.split_tokens >= n
    if n > 16 * ca.MMA_SPLIT_TOKENS:
        assert plan.slices > free.slices


def test_widths_nhead_divides_are_the_only_refusal():
    """No width the reference's kernel takes is refused: C = 256 and 130
    run on CPU tensors, and only C % nhead != 0 raises."""
    for b, s, c, h in WIDE[:3]:
        x, *w = (torch.from_numpy(a) for a in make_inputs(0, b, s, c))
        assert ca.fused_column_attention(x, *w, h).shape == (b, s, c)
    x, *w = (torch.from_numpy(a) for a in make_inputs(0, 2, 6, 256))
    with pytest.raises(ca.UnsupportedShape, match="divisible"):
        ca.fused_column_attention(x, *w, 7)
