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
# (C, nhead): hd 4, 16, 16, and 21 (C not a multiple of 4: the split
# routes' narrow GEMMs on the card)
WIDTHS = [(32, 8), (64, 4), (128, 8), (126, 6)]
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


@pytest.mark.parametrize("direction", ["fwd", "bwd"])
@pytest.mark.parametrize("c,want", [(30, "split"), (32, "tiled"),
                                    (64, "tiled"), (96, "split"),
                                    (128, "split"), (126, "split"),
                                    (68, "split")])
def test_backward_route_by_width(c, want, direction):
    """Both directions: the tiled kernels take every multiple of 4 up to
    64, the split routes every other C up to 128 (C not a multiple of 4
    among them, through the narrow GEMMs); each direction counts its tiled
    and split calls."""
    assert ca.route(c, 6) == want
    assert isinstance(getattr(ca, f"{direction}_{want}_launches"), int)


@pytest.mark.parametrize("s", [17, 40, 167, 195])
@pytest.mark.parametrize("c", [4, 32, 64, 128, 126])
def test_rows_past_16_tokens_take_the_split_route(c, s):
    """Past S = 16 every width takes the split route (its long attention
    cores on the card); at S = 16 the tiled widths stay tiled."""
    assert ca.route(c, s) == "split"
    assert ca.route(c, 16) == ("tiled" if c <= 64 and c % 4 == 0
                               else "split")


# Rows past S = 16: S = 17, 33, 40, 65 and the Elliptic node tokens' 167
# at C = 32 with 8 heads, S = 17 and 40 at C = 128 with 8 heads.
LONG = [(17, 32, 8), (33, 32, 8), (40, 32, 8), (65, 32, 8), (167, 32, 8),
        (17, 128, 8), (40, 128, 8)]


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("s,c,h", LONG)
def test_long_rows_match_the_pallas_kernel(s, c, h, masked):
    """The forward and the gradients of the plain twin (what CPU tensors
    take) against the JAX reference and the Pallas kernel in interpret
    mode (its custom VJP's ``_bwd_kernel``), with and without the 0.083
    keep-mask of the node path."""
    b = 5
    arrays = make_inputs(s + c, b, s, c)
    rng = np.random.RandomState(s * c)
    cot = rng.randn(b, s, c).astype(np.float32)
    rate = 0.083 if masked else 0.0
    mask = rng.rand(b, h, s, s) >= rate if masked else None
    jmask = None if mask is None else jnp.asarray(mask)
    jarr = [jnp.asarray(a) for a in arrays]
    tensors = [torch.from_numpy(a).requires_grad_() for a in arrays]
    tmask = None if mask is None else torch.from_numpy(mask)
    out = ca.fused_column_attention(*tensors, h, drop_mask=tmask,
                                    dropout_rate=rate)
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
                                       rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("b,s,sms,per_sm", [
    (131072, 6, 132, 2),      # the SSL edge tokens on an H100
    (13000, 6, 132, 2),       # the SSL target rows
    (100003, 5, 132, 1),      # ragged
    (1, 1, 132, 2),
    (37, 16, 7, 3),
])
def test_split_plan_token_ranges_cover_every_token_once(b, s, sms, per_sm):
    """The weight-gradient GEMM's splits cover the B·S tokens once each,
    in order, one partial slice each; the attention core gives each thread
    at most one (row, head, query) and fits its shared-memory budget."""
    c, h, budget = 128, 8, 113 * 1024
    # the core's bytes a row at C = 128, nhead 8, as the library reports
    # them: S token rows of 4C + 4 floats and 2·nhead·S² floats of P and dS
    per_row = 4 * (s * (4 * c + 4) + 2 * h * s * s)
    plan = ca.split_plan(b, s, c, h, sms, per_sm, budget // per_row)
    n = b * s
    # the kernel's ranges: split i sums tokens i·split_tokens up to the
    # next split or n
    ranges = [(k, min(n, k + plan.split_tokens))
              for k in range(0, n, plan.split_tokens)]
    assert plan.route == "split"
    assert len(ranges) == plan.slices
    assert ranges[0][0] == 0 and ranges[-1][1] == n
    assert all(e > k for k, e in ranges)
    assert all(a[1] == b_[0] for a, b_ in zip(ranges, ranges[1:]))
    covered = np.zeros(n, int)
    for k, e in ranges:
        covered[k:e] += 1
    assert (covered == 1).all()
    assert plan.slices <= max(1, sms * per_sm // 4) + 1
    assert 1 <= plan.rows <= max(1, 256 // (h * s))
    assert plan.grid == -(-b // plan.rows)
    assert plan.rows * per_row <= budget


@pytest.mark.parametrize("b,s,h,budget,per_row,want", [
    (4096, 167, 8, 113 * 1024, 98_912, 1),   # the node path: a warp a head
    (4096, 40, 8, 113 * 1024, 84_608, 1),    # C = 128
    (4096, 20, 4, 113 * 1024, 42_304, 2),    # 4 heads: two rows a block
    (4096, 18, 1, 113 * 1024, 3_744, 8),     # one head: eight rows
    (5, 18, 1, 113 * 1024, 3_744, 5),        # fewer rows than warps
    (4096, 17, 2, 20 * 1024, 6_000, 3),      # a small card: the budget binds
    (4096, 33, 6, 113 * 1024, 70_000, 1),    # 6 heads: 2 warps idle
    (1, 195, 8, 113 * 1024, 115_440, 1),     # one row
])
def test_long_core_rows_give_each_warp_a_row_head(b, s, h, budget,
                                                  per_row, want):
    """Past S = 16 a split route's attention core (the long cores) takes
    as many rows a block as give each of its 8 warps at most one (row,
    head) and fit its budget, at least one; both routes' plans take them
    and cover the B rows once."""
    assert ca.core_rows(b, s, h, budget // per_row) == want
    assert want == 1 or (want * h <= 8 and want * per_row <= budget)
    for plan in (ca.split_fwd_plan(b, s, h, budget // per_row),
                 ca.split_plan(b, s, 32, h, 132, 2, budget // per_row)):
        assert plan.rows == want
        assert (plan.grid - 1) * plan.rows < b <= plan.grid * plan.rows


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("s", [1, 6, 16])
@pytest.mark.parametrize("c,h", [(128, 8), (96, 8), (126, 6)])
def test_attention_core_between_projections_matches_jax(c, h, s, masked):
    """The split forward's plain core (token rows q | k | v in, ctx out)
    between ``torch.matmul`` projections is the JAX reference's and the
    Pallas kernel's attention (head_dim 16, 12 and 21)."""
    x, wqkv, bqkv, wout, bout = make_inputs(c * s + masked, B, s, c)
    rate = 0.3 if masked else 0.0
    mask = (np.random.RandomState(s).rand(B, h, s, s) >= rate
            if masked else None)
    tok = torch.matmul(torch.from_numpy(x), torch.from_numpy(wqkv)) \
        + torch.from_numpy(bqkv)
    keep = None if mask is None else torch.from_numpy(mask)
    ctx = ca.reference_attention_core(tok, h, keep, rate)
    assert ctx.shape == (B, s, c)
    # the kernel's wrapper takes the plain twin for CPU tensors
    assert torch.equal(ca.attention_core_fwd(tok, h, keep, rate), ctx)
    out = (torch.matmul(ctx, torch.from_numpy(wout))
           + torch.from_numpy(bout)).numpy()
    jarr = [jnp.asarray(a) for a in (x, wqkv, bqkv, wout, bout)]
    jmask = None if mask is None else jnp.asarray(mask)
    ref = jax_reference(*jarr, h, drop_mask=jmask, dropout_rate=rate)
    np.testing.assert_allclose(out, np.asarray(ref), **TOL)
    pallas = jax_fused(*jarr, h, drop_mask=jmask, dropout_rate=rate,
                       block_rows=8, interpret=True)
    np.testing.assert_allclose(out, np.asarray(pallas), **TOL)


@pytest.mark.parametrize("b,s,h,budget", [
    (131072, 6, 8, 113 * 1024),   # the SSL edge tokens on an H100
    (13000, 6, 8, 113 * 1024),    # the SSL target rows
    (100003, 5, 3, 113 * 1024),   # ragged, few heads: the budget binds
    (1, 1, 8, 113 * 1024),
    (37, 16, 8, 113 * 1024),      # two rows a block
    (37, 16, 16, 113 * 1024),     # 256 items a row: one row a block
    (4099, 6, 8, 20 * 1024),      # a small card: the budget binds
])
def test_split_forward_plan_covers_every_row_once(b, s, h, budget):
    """The split forward's core gives each of its 256 threads at most one
    (row, head, query), fits its shared-memory budget (S token rows of
    3C + 4 floats a row at C = 128) and its blocks cover the B rows once."""
    per_row = 4 * s * (3 * 128 + 4)
    plan = ca.split_fwd_plan(b, s, h, budget // per_row)
    assert 1 <= plan.rows <= b
    assert plan.rows * h * s <= 256
    assert plan.rows * per_row <= budget
    assert (plan.grid - 1) * plan.rows < b <= plan.grid * plan.rows
    assert plan.rows == min(b, 256 // (h * s), budget // per_row)
    assert ca.split_fwd_plan(b, s, h, budget // per_row, rows=3).rows == 3


@pytest.mark.parametrize("b,s,c,h", [
    (4096, 167, 256, 8),   # Elliptic's node tokens at --n_hidden 256
    (2048, 167, 256, 8),
    (256, 600, 32, 8),     # past max_s at C = 32
    (256, 520, 256, 8),
    (3, 6, 2048, 8),       # a short row too wide for a block
    (5, 60, 130, 10),
])
def test_direct_plans_launch_a_block_per_row_head(b, s, c, h):
    """The direct form's plans, either direction: one row a block and a
    block per (row, head), B·nhead blocks; a staged plan launches one
    block a group of rows."""
    fwd = ca.split_fwd_plan(b, s, h, None)
    bwd = ca.split_plan(b, s, c, h, 132, 2, None)
    for plan in (fwd, bwd):
        assert plan.direct and plan.rows == 1 and plan.grid == b
        assert ca.core_blocks(plan, h) == b * h
    staged = ca.split_fwd_plan(b, s, h, 4)
    assert ca.core_blocks(staged, h) == staged.grid == -(-b // staged.rows)
