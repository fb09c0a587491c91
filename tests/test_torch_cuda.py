"""The PyTorch port on an NVIDIA card: each CUDA kernel against its plain
PyTorch version on the same card (the backward against autograd of the
plain version), the predict CLI on the card against the same CLI on the
CPU, and three train steps (supervised, and SSL pretraining at C = 128) on
the card against the same steps on the CPU.

The kernels have no CPU mode, so these tests skip on a machine without a
card. On one with a card (JAX need not be installed there: the JAX suite's
``tests/conftest.py`` is skipped) run

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Tolerances: kernel against plain 1e-5 abs/rel (float32, sums in another
order), the weight and bias gradients 1e-4 relative to the largest entry
of the reference (sums over every token in another order); bf16 out and
dx within one bf16 rounding (2^-7 of the value: both round float32 sums
that differ in their order) plus 1e-5 of the largest entry, their float32
weight and bias gradients as the float32 ones; served scores,
card against CPU, 1e-4 (PNA sums in another order); train losses 1e-4 rel
and parameters 6.05·lr abs: Adam moves a parameter by at most ~lr a step
(m̂/√v̂ is at most 1.0036 in the first 3 steps), so where near-zero
gradients differ in sign two runs part by up to ~2·lr a step.
"""
import numpy as np
import pytest
import torch

from rmm_tpu_torch.ops import column_attention as ca
from rmm_tpu_torch.ops import gemm_mma as gm
from rmm_tpu_torch.utils.precision import cast_floats

pytestmark = pytest.mark.cuda

TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def attention_inputs(seed, b, s, c, device):
    rng = np.random.RandomState(seed)
    arrays = (rng.randn(b, s, c), rng.randn(c, 3 * c) / np.sqrt(c),
              rng.randn(3 * c) * 0.1, rng.randn(c, c) / np.sqrt(c),
              rng.randn(c) * 0.1)
    return [torch.from_numpy(a.astype(np.float32)).to(device)
            for a in arrays]


# Both directions' shapes. The tiled kernels take every C <= 64 that is a
# multiple of 4; at C = 96 and 128 both directions take the split route.
# S of 1, 5 and 7 and C of 16, 48 and 64 at head_dim 2, 4, 6 and 8: the
# tiled kernels instantiate S = 2, 4, 6, 8 and 16, and a head_dim that is
# not a multiple of 4 takes their scalar loops.
SHAPES = [
    (1, 1, 32, 8),       # one row, one token
    (37, 2, 32, 8),      # node tokens at the serving width, ragged batch
    (4099, 6, 32, 8),    # edge tokens at the serving width
    (515, 3, 48, 6),     # odd S, head_dim 8
    (257, 9, 64, 4),     # largest width with the weights in shared memory
    (70, 16, 16, 1),     # the largest S, one head
    (33, 6, 96, 3),      # split route
    (100, 16, 128, 8),   # the largest S and C
    (300, 1, 32, 8),
    (301, 5, 32, 8),
    (299, 7, 32, 8),
    (203, 6, 16, 4),     # head_dim 4
    (203, 6, 16, 2),     # head_dim 8
    (203, 6, 16, 8),     # head_dim 2
    (157, 6, 48, 12),
    (157, 6, 48, 6),
    (157, 6, 48, 8),     # head_dim 6
    (131, 6, 64, 16),
    (131, 6, 64, 8),
]


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("b,s,c,h", SHAPES)
def test_column_attention_kernel_matches_plain(cuda, b, s, c, h, masked):
    args = attention_inputs(b + s + c, b, s, c, cuda)
    mask, rate = None, 0.0
    if masked:
        rate = 0.3
        mask = torch.from_numpy(
            np.random.RandomState(b).rand(b, h, s, s) >= rate).to(cuda)
    before = (ca.launches, ca.fwd_tiled_launches, ca.fwd_split_launches)
    with torch.inference_mode():
        out = ca.fused_column_attention(*args, h, mask, rate)
        ref = ca.reference_column_attention(*args, h, mask, rate)
    assert (ca.launches, ca.fwd_tiled_launches, ca.fwd_split_launches) == (
        before[0] + 1, before[1] + int(ca.route(c, s) == "tiled"),
        before[2] + int(ca.route(c, s) == "split"))
    np.testing.assert_allclose(out.cpu().numpy(), ref.cpu().numpy(), **TOL)


def forward_case(device, b, s, c, h, plan):
    """The forward at ``plan`` (None: the default one) and the plain
    version on the same seeded inputs, with the keep-mask."""
    args = attention_inputs(b + s + c, b, s, c, device)
    mask = torch.from_numpy(
        np.random.RandomState(b).rand(b, h, s, s) >= 0.3).to(device)
    with torch.inference_mode():
        return (ca.column_attention_fwd(*args, h, mask, 0.3, plan=plan),
                ca.reference_column_attention(*args, h, mask, 0.3))


@pytest.mark.parametrize("delta", [-1, 1])
@pytest.mark.parametrize("s,c,h", [(6, 32, 8), (2, 32, 8), (5, 48, 6)])
def test_tiled_forward_one_row_either_side_of_a_group(cuda, s, c, h, delta):
    """B one row short of a group, and one row past it (a second group
    of one row), at the group size the plan picks for a large batch."""
    rows = ca.fwd_plan(131072, s, c, h).rows
    b = rows + delta
    plan = ca.fwd_plan(b, s, c, h, rows=rows)
    assert plan.rows == rows
    before = ca.fwd_tiled_launches
    out, ref = forward_case(cuda, b, s, c, h, plan)
    assert ca.fwd_tiled_launches == before + 1
    np.testing.assert_allclose(out.cpu().numpy(), ref.cpu().numpy(), **TOL)


def test_forward_repeats_bitwise(cuda):
    """Each output is one thread's sums in a fixed order: two calls on the
    same inputs give the same bits."""
    b, s, c, h = 4099, 6, 32, 8
    plan = ca.fwd_plan(b, s, c, h)
    first, _ = forward_case(cuda, b, s, c, h, plan)
    second, _ = forward_case(cuda, b, s, c, h, plan)
    assert torch.equal(first, second)


# The split forward: C = 128 (the SSL width) and 96 at head_dim 16 and 32,
# S = 1, 6 and 16, ragged batches (B·S no multiple of a GEMM tile's 128
# tokens); and widths that are not a multiple of 4 (the narrow GEMMs and a
# padded scratch row): 126 and 30 at head_dim 21 and 5, odd 21 at 7.
SPLIT_FWD_SHAPES = [
    (1001, 1, 128, 8),
    (1001, 6, 128, 8),
    (203, 16, 128, 8),
    (1001, 6, 96, 8),
    (333, 16, 96, 3),
    (1001, 6, 126, 6),
    (203, 16, 30, 6),
    (129, 7, 21, 3),
]


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("b,s,c,h", SPLIT_FWD_SHAPES)
def test_split_forward_matches_plain(cuda, b, s, c, h, masked):
    args = attention_inputs(b + s + c, b, s, c, cuda)
    mask, rate = None, 0.0
    if masked:
        rate = 0.3
        mask = torch.from_numpy(
            np.random.RandomState(b).rand(b, h, s, s) >= rate).to(cuda)
    before = ca.fwd_split_launches
    with torch.inference_mode():
        out = ca.column_attention_fwd(*args, h, mask, rate)
        ref = ca.reference_column_attention(*args, h, mask, rate)
    assert ca.fwd_split_launches == before + 1
    np.testing.assert_allclose(out.cpu().numpy(), ref.cpu().numpy(), **TOL)


@pytest.mark.parametrize("delta", [-1, 1])
@pytest.mark.parametrize("s", [2, 4, 16])
def test_split_forward_one_row_either_side_of_a_gemm_tile(cuda, s, delta):
    """B·S tokens one row short of three GEMM row tiles (3·128 tokens) and
    one row past them, with the keep-mask."""
    b, c, h = 3 * 128 // s + delta, 128, 8
    before = ca.fwd_split_launches
    out, ref = forward_case(cuda, b, s, c, h, None)
    assert ca.fwd_split_launches == before + 1
    np.testing.assert_allclose(out.cpu().numpy(), ref.cpu().numpy(), **TOL)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("b,s,c,h", SPLIT_FWD_SHAPES)
def test_split_forward_core_matches_plain(cuda, b, s, c, h, masked):
    """The split forward's attention core alone on seeded token rows
    q | k | v against its plain twin, at the plan's rows and at one row a
    block."""
    rng = np.random.RandomState(b + c)
    tok = torch.from_numpy(rng.randn(b, s, 3 * c).astype(np.float32)).to(
        cuda)
    mask, rate = None, 0.0
    if masked:
        rate = 0.5
        mask = torch.from_numpy(rng.rand(b, h, s, s) >= rate).to(cuda)
    want = ca.reference_attention_core(tok, h, mask, rate).cpu().numpy()
    before = ca.launches
    for rows in (None, 1):
        got = ca.attention_core_fwd(tok, h, mask, rate, rows=rows)
        np.testing.assert_allclose(got.cpu().numpy(), want, **TOL)
    assert ca.launches == before


def test_split_forward_repeats_bitwise(cuda):
    """The split forward at C = 128 sums every output in a fixed order:
    two calls on the same inputs give the same bits."""
    b, s, c, h = 4099, 6, 128, 8
    args = attention_inputs(0, b, s, c, cuda)
    mask = torch.rand(b, h, s, s, device=cuda,
                      generator=torch.Generator(cuda).manual_seed(2)) >= 0.5
    with torch.inference_mode():
        first = ca.column_attention_fwd(*args, h, mask, 0.5)
        second = ca.column_attention_fwd(*args, h, mask, 0.5)
    assert ca.route(c, s) == "split"
    assert torch.equal(first, second)


def test_column_attention_kernel_refuses_what_it_cannot_run(cuda):
    x, wqkv, bqkv, wout, bout = attention_inputs(0, 8, 6, 32, cuda)
    before = ca.launches
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        ca.fused_column_attention(x.half(), wqkv.half(), bqkv.half(),
                                  wout.half(), bout.half(), 8)
    with pytest.raises(TypeError, match="one dtype"):
        ca.fused_column_attention(x, wqkv.bfloat16(), bqkv, wout, bout, 8)
    with pytest.raises(TypeError, match="bf16 x takes bf16 weights"):
        ca.fused_column_attention(x.bfloat16(), wqkv, bqkv, wout, bout, 8)
    with pytest.raises(ValueError, match="contiguous"):
        ca.fused_column_attention(x, wqkv.t().contiguous().t(), bqkv, wout,
                                  bout, 8)
    with pytest.raises(ValueError, match="is on cpu"):
        ca.fused_column_attention(x, wqkv.cpu(), bqkv, wout, bout, 8)
    # the only shape no kernel takes: a width nhead does not divide (C =
    # 136 and rows past max_s run: test_wide_and_long_rows_match_plain)
    with pytest.raises(ca.UnsupportedShape, match="divisible"):
        ca.fused_column_attention(x, wqkv, bqkv, wout, bout, 7)
    assert ca.launches == before


# Widths past 128 and rows past max_s (both split routes; the rows that do
# not fit a block's shared memory through the long cores' direct form): C
# = 136 and 256 at head widths 17 and 32 (256 also at S = 2, the node
# tokens' short core), 256 at 64, 512, 130 at 13 (the narrow GEMMs), a row
# past max_s at C = 256 (56 tokens) and at C = 32 (600), 60 tokens at
# C = 130, and 520 at C = 256 (two rounds of the direct forward's query
# groups, a last key chunk of 8).
WIDE_SHAPES = [
    (5, 6, 136, 8),
    (33, 6, 256, 8),
    (37, 2, 256, 8),
    (29, 6, 256, 4),
    (7, 6, 512, 8),
    (45, 6, 130, 10),
    (9, 56, 256, 8),
    (3, 600, 32, 8),
    (4, 60, 130, 10),
    (2, 520, 256, 8),
]


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("b,s,c,h", WIDE_SHAPES)
def test_wide_and_long_rows_match_plain(cuda, b, s, c, h, masked):
    """Both directions through ``fused_column_attention`` against autograd
    of the plain version: the split route, its direct form exactly where a
    row does not fit a block (``max_s``), counted by the direct
    counters."""
    direct = s > ca.max_s(c, h)
    before = (ca.fwd_split_launches, ca.bwd_split_launches,
              ca.fwd_direct_launches, ca.bwd_direct_launches)
    with torch.inference_mode():
        out, ref = forward_case(cuda, b, s, c, h, None)
    np.testing.assert_allclose(out.cpu().numpy(), ref.cpu().numpy(), **TOL)
    got, want = backward_case(cuda, b, s, c, h, masked)
    assert_gradients_match(got, want)
    assert ca.route(c, s) == "split"
    assert ca.fwd_plan(b, s, c, h).direct == ca.bwd_plan(b, s, c, h).direct \
        == direct
    assert (ca.fwd_split_launches, ca.bwd_split_launches,
            ca.fwd_direct_launches, ca.bwd_direct_launches) == (
        before[0] + 2, before[1] + 1, before[2] + 2 * direct,
        before[3] + direct)


@pytest.mark.parametrize("b,s,c,h", [(13, 40, 256, 8), (9, 20, 130, 10),
                                     (7, 6, 256, 8), (5, 17, 96, 4)])
def test_direct_form_gives_the_staged_bits(cuda, b, s, c, h):
    """At rows that fit a block, the direct form (the same walks on the
    rows where they lie) gives the staged long cores' bits in both
    directions, the forward core alone too (head width 32, compiled in
    both forms, and 13 and 24, the runtime-width code of both);
    at S = 6 it holds against the plain twin."""
    args = attention_inputs(b + c, b, s, c, cuda)
    do = torch.from_numpy(np.random.RandomState(s).randn(b, s, c).astype(
        np.float32)).to(cuda)
    mask = torch.from_numpy(
        np.random.RandomState(b).rand(b, h, s, s) >= 0.3).to(cuda)
    fplan, bplan = ca.fwd_plan(b, s, c, h), ca.bwd_plan(b, s, c, h)
    assert not fplan.direct and not bplan.direct
    with torch.inference_mode():
        staged, direct = (
            ca.column_attention_fwd(*args, h, mask, 0.3, plan=p)
            for p in (fplan, fplan._replace(direct=True, rows=1)))
        ref = ca.reference_column_attention(*args, h, mask, 0.3)
    x, wqkv, bqkv, wout, _ = args
    gs, gd = (ca.column_attention_bwd(x, do, wqkv, bqkv, wout, h, mask, 0.3,
                                      plan=p)
              for p in (bplan, bplan._replace(direct=True, rows=1)))
    if s > 16:
        assert torch.equal(staged, direct)
        for g, d in zip(gs, gd):
            assert torch.equal(g, d)
        tok = torch.matmul(x, wqkv) + bqkv
        assert torch.equal(ca.attention_core_fwd(tok, h, mask, 0.3),
                           ca.attention_core_fwd(tok, h, mask, 0.3,
                                                 direct=True))
    np.testing.assert_allclose(direct.cpu().numpy(), ref.cpu().numpy(),
                               **TOL)
    leaves = [a.detach().requires_grad_() for a in args]
    want = torch.autograd.grad(
        ca.reference_column_attention(*leaves, h, mask, 0.3), leaves, do)
    assert_gradients_match(gd, want)


def test_direct_form_repeats_bitwise(cuda):
    """Both directions of the direct form twice on the same inputs (C =
    256, 60 tokens, the keep-mask): the same bits."""
    b, s, c, h = 11, 60, 256, 8
    args = attention_inputs(1, b, s, c, cuda)
    do = torch.from_numpy(np.random.RandomState(2).randn(b, s, c).astype(
        np.float32)).to(cuda)
    mask = torch.from_numpy(
        np.random.RandomState(3).rand(b, h, s, s) >= 0.083).to(cuda)
    assert ca.fwd_plan(b, s, c, h).direct
    with torch.inference_mode():
        first, second = (ca.column_attention_fwd(*args, h, mask, 0.083)
                         for _ in range(2))
    assert torch.equal(first, second)
    x, wqkv, bqkv, wout, _ = args
    first, second = (ca.column_attention_bwd(x, do, wqkv, bqkv, wout, h,
                                             mask, 0.083) for _ in range(2))
    for a, b_ in zip(first, second):
        assert torch.equal(a, b_)


# Rows past S = 16: the long attention cores of the split routes (a warp
# per (row, head), the lanes over the queries, 6 a lane at head width 4
# and 2 at 16 in the forward, 4 and 1 in the backward's query walks, 3
# and 1 keys a lane in its key walk, one a lane up to S = 32; the
# keep-mask in chunks of 32 keys).
# The Elliptic node tokens (S = 167 at C = 32/8, the node path's shape),
# S = 17 and 40 at C = 32 and 128, head widths of 4 and 16 (compile-time),
# 32 (two walks of 16 channels), 5, 21 and 3 (one-float chunks; the narrow
# GEMMs at C = 30 and 126), one head, and key counts that are no multiple
# of 32; S either side of 32 and 64 (a lane's second and third query, a
# second and third chunk of keys), of 192 (a second group of queries at
# head width 4) and the longest rows the cores take at C = 32 and 128;
# one row.
LONG_SHAPES = [
    (203, 167, 32, 8),
    (1001, 17, 32, 8),
    (301, 40, 32, 8),
    (77, 17, 128, 8),
    (129, 40, 128, 8),
    (65, 20, 128, 4),
    (45, 23, 30, 6),
    (40, 33, 126, 6),
    (37, 19, 64, 4),
    (50, 18, 16, 1),
    (33, 25, 24, 8),
    (99, 32, 32, 8),
    (98, 33, 32, 8),
    (51, 64, 32, 8),
    (52, 65, 32, 8),
    (13, 192, 32, 8),
    (14, 193, 32, 8),
    (11, 195, 32, 8),
    (21, 54, 128, 8),
    (1, 167, 32, 8),
    (33, 64, 64, 4),     # the downstream text LM's rows
    (17, 64, 128, 4),    # finetune_llm's: the backward one block an SM
    (5, 110, 128, 4),    # the longest rows one block an SM takes there
]


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("b,s,c,h", LONG_SHAPES)
def test_long_rows_forward_takes_the_split_kernels(cuda, b, s, c, h, masked):
    args = attention_inputs(b + s + c, b, s, c, cuda)
    mask, rate = None, 0.0
    if masked:
        rate = 0.3
        mask = torch.from_numpy(
            np.random.RandomState(b).rand(b, h, s, s) >= rate).to(cuda)
    before = (ca.launches, ca.fwd_split_launches)
    with torch.inference_mode():
        out = ca.fused_column_attention(*args, h, mask, rate)
        ref = ca.reference_column_attention(*args, h, mask, rate)
    assert ca.route(c, s) == "split"
    assert (ca.launches, ca.fwd_split_launches) == (before[0] + 1,
                                                    before[1] + 1)
    np.testing.assert_allclose(out.cpu().numpy(), ref.cpu().numpy(), **TOL)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("b,s,c,h", LONG_SHAPES)
def test_long_rows_forward_core_matches_plain(cuda, b, s, c, h, masked):
    """The long forward core alone on seeded token rows q | k | v against
    its plain twin, at the plan's rows and at one row a block."""
    rng = np.random.RandomState(b + c)
    tok = torch.from_numpy(rng.randn(b, s, 3 * c).astype(np.float32)).to(
        cuda)
    mask, rate = None, 0.0
    if masked:
        rate = 0.083
        mask = torch.from_numpy(rng.rand(b, h, s, s) >= rate).to(cuda)
    want = ca.reference_attention_core(tok, h, mask, rate).cpu().numpy()
    for rows in (None, 1):
        got = ca.attention_core_fwd(tok, h, mask, rate, rows=rows)
        np.testing.assert_allclose(got.cpu().numpy(), want, **TOL)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("b,s,c,h", LONG_SHAPES)
def test_long_rows_backward_takes_the_split_kernels(cuda, b, s, c, h,
                                                    masked):
    before = (ca.bwd_launches, ca.bwd_split_launches, ca.reduce_launches)
    got, want = backward_case(cuda, b, s, c, h, masked)
    assert (ca.bwd_launches, ca.bwd_split_launches,
            ca.reduce_launches) == tuple(n + 1 for n in before)
    assert ca.bwd_plan(b, s, c, h).route == "split"
    assert_gradients_match(got, want)


@pytest.mark.parametrize("c", [32, 128])
def test_longest_row_the_cores_take_matches_plain(cuda, c):
    """Both directions at the longest S both cores take at C (one row of
    a block's share of shared memory), with the keep-mask."""
    b, s, h = 19, ca.max_s(c, 8), 8
    assert s > 16
    with torch.inference_mode():
        out, ref = forward_case(cuda, b, s, c, h, None)
    np.testing.assert_allclose(out.cpu().numpy(), ref.cpu().numpy(), **TOL)
    assert_gradients_match(*backward_case(cuda, b, s, c, h, True))


@pytest.mark.parametrize("b,s,c,h", [(203, 167, 32, 8), (52, 65, 32, 8),
                                     (21, 54, 128, 8), (40, 33, 126, 6)])
def test_long_rows_at_half_dropout_match_plain(cuda, b, s, c, h):
    """Both directions past S = 16 with half the keep-mask's bytes 0 (the
    SSL path's dropout): the keep bits of every chunk of 32 keys."""
    args = attention_inputs(b + c, b, s, c, cuda)
    do = torch.from_numpy(np.random.RandomState(s).randn(b, s, c).astype(
        np.float32)).to(cuda)
    mask = torch.from_numpy(
        np.random.RandomState(b).rand(b, h, s, s) >= 0.5).to(cuda)
    with torch.inference_mode():
        out = ca.column_attention_fwd(*args, h, mask, 0.5)
        ref = ca.reference_column_attention(*args, h, mask, 0.5)
    np.testing.assert_allclose(out.cpu().numpy(), ref.cpu().numpy(), **TOL)
    leaves = [a.requires_grad_() for a in args]
    want = torch.autograd.grad(
        ca.reference_column_attention(*leaves, h, mask, 0.5), leaves, do)
    x, wqkv, bqkv, wout, _ = (t.detach() for t in leaves)
    got = ca.column_attention_bwd(x, do, wqkv, bqkv, wout, h, mask, 0.5)
    assert_gradients_match(got, want)


@pytest.mark.parametrize("offset", [1, 7, 15])
@pytest.mark.parametrize("b,s,c,h", [(203, 167, 32, 8), (52, 65, 32, 8),
                                     (21, 54, 128, 8)])
def test_long_rows_take_a_keep_mask_at_any_offset(cuda, b, s, c, h, offset):
    """A contiguous keep-mask whose first byte is not 16-byte aligned, among
    garbage bytes before and after it (the cores read a row's keep bytes as
    the aligned 16-byte granules that hold them): both directions give the
    bits they give on an aligned copy of it."""
    args = attention_inputs(b + s, b, s, c, cuda)
    do = torch.from_numpy(np.random.RandomState(c).randn(b, s, c).astype(
        np.float32)).to(cuda)
    mask = torch.from_numpy(
        np.random.RandomState(b).rand(b, h, s, s) >= 0.3).to(cuda)
    n = mask.numel()
    raw = torch.randint(0, 256, (n + 64,), dtype=torch.uint8, device=cuda,
                        generator=torch.Generator(cuda).manual_seed(offset))
    assert raw.data_ptr() % 16 == 0
    raw[offset:offset + n] = mask.flatten().to(torch.uint8)
    moved = raw[offset:offset + n].view(torch.bool).view(b, h, s, s)
    assert moved.is_contiguous() and moved.data_ptr() % 16 == offset
    assert torch.equal(moved, mask)
    with torch.inference_mode():
        got, want = (ca.column_attention_fwd(*args, h, m, 0.3)
                     for m in (moved, mask))
    assert torch.equal(got, want)
    x, wqkv, bqkv, wout, _ = args
    got, want = (ca.column_attention_bwd(x, do, wqkv, bqkv, wout, h, m, 0.3)
                 for m in (moved, mask))
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_longest_rows_of_record_fit(cuda):
    """``max_s`` is now the longest row the cores stage (longer ones take
    the direct form): on an H100 392 tokens at C = 32, 109 at C = 128, 55
    at C = 256, 8 heads, and 110 at C = 128, 4 heads, beyond the rows of
    record (195 and 54; the text LM's 64 at C = 128, 4 heads, one block an
    SM: its backward row of 134,144 bytes takes a whole block); the
    library's bytes a row are those ``tests/test_torch_wide_attention.py``
    plans with."""
    assert (ca.max_s(32, 8), ca.max_s(128, 8), ca.max_s(256, 8),
            ca.max_s(128, 4)) == (392, 109, 55, 110)
    assert ca.core_row_bytes(64, 128, 4) == (99_328, 134_144)
    assert ca.core_row_bytes(56, 256, 8) == (4 * 56 * 772,
                                             4 * 56 * (1028 + 16))
    assert ca.core_row_bytes(6, 130, 10) == (4 * 6 * 420,
                                             4 * (6 * 524 + 2 * 10 * 36))
    block, _ = ca._card_smem()
    assert ca._core_budget(134_144) == block


def test_direct_smem_matches_the_library(cuda):
    """A direct-form block's shared memory as the library computes it is
    ``direct_smem_bytes``, the pure function the CPU tests hold to two
    blocks an SM at every width, at every S."""
    lib = ca._kernel()
    for s, c, h in [(167, 256, 8), (600, 32, 8), (6, 2048, 8), (60, 130, 10),
                    (40, 1024, 1), (17, 96, 4), (520, 256, 8), (56, 95, 1)]:
        assert lib.rmm_column_attention_direct_smem_bytes(s, c, h) == \
            ca.direct_smem_bytes(s, c, h)


def test_long_rows_repeat_bitwise(cuda):
    """The long cores sum every output in a fixed order, as the short ones
    do: two calls of each direction at the node path's shape give the same
    bits."""
    b, s, c, h = 1024, 167, 32, 8
    x, wqkv, bqkv, wout, bout = attention_inputs(0, b, s, c, cuda)
    do = torch.randn(b, s, c, device=cuda,
                     generator=torch.Generator(cuda).manual_seed(1))
    mask = torch.rand(b, h, s, s, device=cuda,
                      generator=torch.Generator(cuda).manual_seed(2)) >= 0.083
    with torch.inference_mode():
        first, second = (ca.column_attention_fwd(x, wqkv, bqkv, wout, bout,
                                                 h, mask, 0.083)
                         for _ in range(2))
    assert torch.equal(first, second)
    first, second = (ca.column_attention_bwd(x, do, wqkv, bqkv, wout, h,
                                             mask, 0.083) for _ in range(2))
    for g, a in zip(first, second):
        assert torch.equal(g, a)


# The backward's further shapes. Where C is not a multiple of 4 they take
# the split route with the narrow GEMMs (every stride, N = 3C and the
# weight gradients' rows ragged), at S of 2 to 16 (the core's S = 2, 4, 8
# and 16 instantiations), head widths of 2 to 21 (the core's one-float
# chunks), C below and above the tiled kernels' 64, and B·S of a few
# tokens up to several GEMM tiles. C = 72 and 100 take the aligned split
# route at S = 2 and 4.
BWD_SHAPES = SHAPES + [
    (77, 2, 30, 5),      # narrow split route, C <= 64
    (61, 3, 18, 3),
    (129, 6, 30, 6),
    (45, 11, 14, 2),
    (90, 2, 50, 5),
    (65, 3, 42, 7),
    (47, 7, 54, 6),
    (23, 13, 62, 2),
    (40, 2, 72, 8),      # aligned split route
    (31, 4, 100, 5),
    (40, 2, 70, 7),      # narrow split route, C > 64
    (31, 4, 102, 6),
    (33, 7, 98, 7),
    (12, 16, 126, 6),
]


def backward_case(device, b, s, c, h, masked, plan=None):
    """The backward kernel's gradients and autograd's of the plain version
    on the same seeded inputs."""
    args = [a.requires_grad_() for a in attention_inputs(b + s, b, s, c,
                                                        device)]
    do = torch.from_numpy(np.random.RandomState(c).randn(b, s, c).astype(
        np.float32)).to(device)
    mask, rate = None, 0.0
    if masked:
        rate = 0.3
        mask = torch.from_numpy(
            np.random.RandomState(b).rand(b, h, s, s) >= rate).to(device)
    if plan is None:
        got = torch.autograd.grad(
            ca.fused_column_attention(*args, h, mask, rate), args, do)
    else:
        x, wqkv, bqkv, wout, _ = (t.detach() for t in args)
        got = ca.column_attention_bwd(x, do, wqkv, bqkv, wout, h, mask,
                                      rate, plan=plan)
    want = torch.autograd.grad(
        ca.reference_column_attention(*args, h, mask, rate), args, do)
    return got, want


def assert_gradients_match(got, want):
    np.testing.assert_allclose(got[0].cpu().numpy(), want[0].cpu().numpy(),
                               **TOL)
    for g, w in zip(got[1:], want[1:]):
        scale = float(w.abs().max())
        np.testing.assert_allclose(g.cpu().numpy(), w.cpu().numpy(),
                                   rtol=0, atol=1e-4 * max(scale, 1.0))


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("b,s,c,h", BWD_SHAPES)
def test_column_attention_backward_matches_plain(cuda, b, s, c, h, masked):
    before = (ca.launches, ca.bwd_launches, ca.reduce_launches)
    got, want = backward_case(cuda, b, s, c, h, masked)
    assert (ca.launches, ca.bwd_launches, ca.reduce_launches) == tuple(
        n + 1 for n in before)
    assert_gradients_match(got, want)


@pytest.mark.parametrize("delta", [-1, 1])
@pytest.mark.parametrize("s,c,h", [(6, 32, 8), (2, 32, 8), (5, 48, 6)])
def test_tiled_backward_one_row_either_side_of_a_group(cuda, s, c, h, delta):
    """B one row short of a group, and one row past it (a second group
    of one row), at the group size the plan picks for a large batch."""
    rows = ca.bwd_plan(131072, s, c, h).rows
    b = rows + delta
    plan = ca.bwd_plan(b, s, c, h, rows=rows)
    assert plan.route == "tiled" and plan.rows == rows
    before = ca.bwd_tiled_launches
    got, want = backward_case(cuda, b, s, c, h, True, plan)
    assert ca.bwd_tiled_launches == before + 1
    assert_gradients_match(got, want)


def test_backward_repeats_bitwise(cuda):
    """No atomics: the weight gradients are summed in a fixed order, so
    two calls on the same inputs give the same bits."""
    b, s, c, h = 4099, 6, 32, 8
    x, wqkv, bqkv, wout, _ = attention_inputs(0, b, s, c, cuda)
    do = torch.randn(b, s, c, device=cuda,
                     generator=torch.Generator(cuda).manual_seed(1))
    mask = torch.rand(b, h, s, s, device=cuda,
                      generator=torch.Generator(cuda).manual_seed(2)) >= 0.3
    first = ca.column_attention_bwd(x, do, wqkv, bqkv, wout, h, mask, 0.3)
    second = ca.column_attention_bwd(x, do, wqkv, bqkv, wout, h, mask, 0.3)
    for g, a in zip(first, second):
        assert torch.equal(g, a)


def split_case(device, b, s, c, h, plan=None):
    """The split backward (at ``plan``, else the default one) and autograd
    of the plain version on the same seeded inputs, with the keep-mask."""
    before = ca.bwd_split_launches
    got, want = backward_case(device, b, s, c, h, True,
                              plan or ca.bwd_plan(b, s, c, h))
    assert ca.bwd_split_launches == before + 1
    return got, want


@pytest.mark.parametrize("delta", [-1, 1])
@pytest.mark.parametrize("s", [2, 4, 16])
def test_split_backward_one_row_either_side_of_a_gemm_tile(cuda, s, delta):
    """B·S tokens one row short of three GEMM row tiles (3·128 tokens) and
    one row past them: the last tile ragged, or a fourth of S tokens."""
    b = 3 * 128 // s + delta
    assert_gradients_match(*split_case(cuda, b, s, 128, 8))


@pytest.mark.parametrize("split_tokens", [32, 37, 96, 1000])
def test_split_backward_token_splits(cuda, split_tokens):
    """The weight gradients over other token splits than the plan's: many
    splits (the last one ragged, or all of an odd length), and one longer
    than the tokens."""
    b, s, c, h = 157, 6, 128, 8
    n = b * s
    plan = ca.bwd_plan(b, s, c, h)._replace(
        split_tokens=split_tokens, slices=-(-n // split_tokens))
    assert_gradients_match(*split_case(cuda, b, s, c, h, plan))


def test_split_backward_repeats_bitwise(cuda):
    """The split route at C = 128 sums every output in a fixed order (no
    atomics): two calls on the same inputs give the same bits."""
    b, s, c, h = 4099, 6, 128, 8
    x, wqkv, bqkv, wout, _ = attention_inputs(0, b, s, c, cuda)
    do = torch.randn(b, s, c, device=cuda,
                     generator=torch.Generator(cuda).manual_seed(1))
    mask = torch.rand(b, h, s, s, device=cuda,
                      generator=torch.Generator(cuda).manual_seed(2)) >= 0.5
    first = ca.column_attention_bwd(x, do, wqkv, bqkv, wout, h, mask, 0.5)
    second = ca.column_attention_bwd(x, do, wqkv, bqkv, wout, h, mask, 0.5)
    assert ca.bwd_plan(b, s, c, h).route == "split"
    for g, a in zip(first, second):
        assert torch.equal(g, a)


def test_narrow_split_routes_repeat_bitwise(cuda):
    """Both directions at C = 126 (the narrow GEMMs) sum every output in a
    fixed order: two calls on the same inputs give the same bits."""
    b, s, c, h = 32768, 6, 126, 6
    x, wqkv, bqkv, wout, bout = attention_inputs(0, b, s, c, cuda)
    do = torch.randn(b, s, c, device=cuda,
                     generator=torch.Generator(cuda).manual_seed(1))
    mask = torch.rand(b, h, s, s, device=cuda,
                      generator=torch.Generator(cuda).manual_seed(2)) >= 0.5
    assert ca.route(c, s) == "split"
    with torch.inference_mode():
        first, second = (ca.column_attention_fwd(x, wqkv, bqkv, wout, bout,
                                                 h, mask, 0.5)
                         for _ in range(2))
    assert torch.equal(first, second)
    first, second = (ca.column_attention_bwd(x, do, wqkv, bqkv, wout, h,
                                             mask, 0.5) for _ in range(2))
    for g, a in zip(first, second):
        assert torch.equal(g, a)


def strided(rows, cols, ld, data, dtype, device):
    """``data`` [rows, cols] in a [rows + 2, ld] buffer of NaN that starts
    one element past an allocation (no 16-byte aligned base): the view of
    the first ``rows`` rows, and its pointer."""
    buf = torch.full((1 + (rows + 2) * ld,), float("nan"), dtype=dtype,
                     device=device)
    view = buf[1:1 + rows * ld].view(rows, ld)
    view[:, :cols] = torch.from_numpy(data).to(device, dtype)
    return view, view.data_ptr()


# The narrow GEMM form alone against a float64 product, at ragged M, N and
# K (K % 4 of 1, 2 and 3; N % 4 != 0) in the three layouts of the split
# routes' problems, in both builds. The operands' pad columns and their
# rows past K are NaN, so a chunk copied past K (the aligned form's
# k < klim passes a chunk that starts in range) turns sums NaN; the
# output's guard columns past N and rows past M keep a sentinel that a
# store past N (store4's col < N passes 4 columns) would overwrite.
NARROW_GEMMS = [(300, 126, 125), (129, 378, 126), (257, 30, 127),
                (5, 3, 1), (131, 21, 42)]
SENTINEL = 12345.0


def narrow_gemm_case(device, m, n, k, layout, dtype):
    """The narrow GEMM's output [m + 3, n + 3] (the sentinel outside what
    it writes) and the float64 product it should hold in its first rows
    and n columns."""
    rng = np.random.RandomState(m + n + k + layout)
    a, b = rng.randn(m, k), rng.randn(k, n)
    bias = rng.randn(n)
    if dtype == torch.bfloat16:   # the values the kernel sees
        a, b, bias = (torch.from_numpy(t).bfloat16().double().numpy()
                      for t in (a, b, bias))
    b_dtype = torch.float32 if layout == 2 else dtype
    if layout == 0:      # A m-major, B k-major, a bias
        av, pa = strided(m, k, k + 3, a, dtype, device)
        bv, pb = strided(k, n, n + 1, b, b_dtype, device)
        want = a @ b + bias
    elif layout == 1:    # A m-major, B n-major, a bias
        av, pa = strided(m, k, k + 2, a, dtype, device)
        bv, pb = strided(n, k, k + 1, b.T.copy(), b_dtype, device)
        want = a @ b + bias
    else:                # A and B k-major, B's column sums in row M
        av, pa = strided(k, m, m + 1, a.T.copy(), dtype, device)
        bv, pb = strided(k, n, n + 3, b, b_dtype, device)
        want = np.concatenate([a @ b, b.sum(0, keepdims=True)])
        bias = None
    bias_t = (None if bias is None else
              torch.from_numpy(bias).to(device, b_dtype))
    ldc = n + 3
    out = torch.full((m + 3, ldc), SENTINEL, device=device)
    err = ca._kernel(dtype).rmm_gemm_narrow(
        pa, av.stride(0), pb, bv.stride(0), out.data_ptr(), ldc,
        None if bias_t is None else bias_t.data_ptr(), m, n, k, layout,
        torch.cuda.current_stream().cuda_stream)
    assert err == 0
    return out.double().cpu().numpy(), want


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("layout", [0, 1, 2])
@pytest.mark.parametrize("m,n,k", NARROW_GEMMS)
def test_narrow_gemm_matches_float64(cuda, m, n, k, layout, dtype):
    got, want = narrow_gemm_case(cuda, m, n, k, layout, dtype)
    rows = want.shape[0]
    np.testing.assert_allclose(got[:rows, :n], want, rtol=1e-5, atol=1e-4)
    assert (got[:, n:] == SENTINEL).all()
    assert (got[rows:] == SENTINEL).all()


@pytest.mark.parametrize("layout", [0, 1])
@pytest.mark.parametrize("k", [125, 126, 127])
def test_narrow_gemm_copies_nothing_past_k(cuda, k, layout):
    """K % 4 of 1, 2 and 3 with NaN after each row's K elements: a copy
    of a 4-element chunk that starts below K would bring the NaN in."""
    got, want = narrow_gemm_case(cuda, 129, 96, k, layout, torch.float32)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got[:129, :96], want, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("n", [29, 30, 31, 126])
def test_narrow_gemm_stores_nothing_past_n(cuda, n):
    """N % 4 != 0 with a k-major B (4 columns a thread): the guard columns
    past N keep their sentinel."""
    got, want = narrow_gemm_case(cuda, 129, n, 64, 0, torch.float32)
    np.testing.assert_allclose(got[:129, :n], want, rtol=1e-5, atol=1e-4)
    assert (got[:, n:] == SENTINEL).all()


ROUTES = [
    (16384, 2, 32, 8, "tiled"),     # the main path's node tokens
    (131072, 6, 32, 8, "tiled"),    # the main path's edge tokens
    (33, 6, 96, 3, "split"),
    (100, 16, 128, 8, "split"),
    (129, 6, 30, 6, "split"),       # C not a multiple of 4: narrow GEMMs
    (65, 3, 42, 7, "split"),
    (2048, 167, 32, 8, "split"),    # the Elliptic node tokens
    (300, 17, 32, 8, "split"),      # S > 16 at a tiled width
]


@pytest.mark.parametrize("b,s,c,h,route", ROUTES)
def test_backward_route_by_shape(cuda, b, s, c, h, route):
    x, wqkv, bqkv, wout, _ = attention_inputs(0, b, s, c, cuda)
    before = (ca.bwd_launches, ca.bwd_tiled_launches, ca.bwd_split_launches)
    ca.column_attention_bwd(x, torch.ones_like(x), wqkv, bqkv, wout, h)
    assert ca.route(c, s) == route
    assert (ca.bwd_launches, ca.bwd_tiled_launches,
            ca.bwd_split_launches) == (before[0] + 1,
                                       before[1] + int(route == "tiled"),
                                       before[2] + int(route == "split"))


@pytest.mark.parametrize("b,s,c,h,route", ROUTES)
def test_forward_route_by_shape(cuda, b, s, c, h, route):
    """The forward takes the backward's route: tiled or split."""
    args = attention_inputs(0, b, s, c, cuda)
    before = (ca.launches, ca.fwd_tiled_launches, ca.fwd_split_launches)
    ca.column_attention_fwd(*args, h)
    assert ca.route(c, s) == route
    assert (ca.launches, ca.fwd_tiled_launches, ca.fwd_split_launches) == (
        before[0] + 1, before[1] + int(route == "tiled"),
        before[2] + int(route == "split"))


def test_three_train_steps_on_the_card_match_the_cpu(cuda, tmp_path):
    import itertools

    from rmm_tpu_torch.datasets import build_dataset, write_synthetic_aml_csv
    from rmm_tpu_torch.train.trainer import Trainer
    from rmm_tpu_torch.utils.config import config_from_args, create_parser

    data = str(tmp_path / "aml.csv")
    write_synthetic_aml_csv(data, num_rows=2000, num_accounts=125, seed=0)
    argv = ["--data", data, "--model", "tabgnn", "--num_neighs", "10", "10",
            "--batch_size", "64", "--dropout", "0"]
    runs = []
    for device in ("cpu", "cuda"):
        cfg = config_from_args(create_parser().parse_args(
            argv + ["--device", device]))
        tr = Trainer(cfg, build_dataset(cfg))
        tr.model.train()
        counters = ("launches", "fwd_tiled_launches", "bwd_launches",
                    "bwd_tiled_launches", "reduce_launches",
                    "bwd_split_launches", "fwd_split_launches")
        before = [getattr(ca, n) for n in counters]
        batches = itertools.islice(
            tr._batches(tr.dataset.edges.split()[0], "train"), 3)
        losses = [float(tr._step(gb.to(tr.device))[0]) for gb in batches]
        launched = tuple(getattr(ca, n) - m
                         for n, m in zip(counters, before))
        runs.append((losses, {k: v.cpu() for k, v in
                              tr.model.state_dict().items()}, launched,
                     cfg.lr))
    (cpu_losses, cpu_state, cpu_launched, lr), (losses, state, launched,
                                               _) = runs
    assert cpu_launched == (0,) * 7
    assert launched == (12,) * 5 + (0, 0)   # 2 layers x nodes, edges x 3
    #                                         steps, all tiled
    np.testing.assert_allclose(losses, cpu_losses, rtol=1e-4)
    errs = np.concatenate([np.abs(v.numpy() - cpu_state[k].numpy()).ravel()
                           for k, v in state.items()])
    assert np.median(errs) <= 0.05 * lr     # a wrong gradient moves this
    for k, v in state.items():
        np.testing.assert_allclose(v.numpy(), cpu_state[k].numpy(), rtol=0,
                                   atol=6.05 * lr, err_msg=k)


def test_predict_on_the_card_matches_the_cpu(cuda, tmp_path):
    from rmm_tpu_torch.cli import predict
    from rmm_tpu_torch.datasets import build_dataset, write_synthetic_aml_csv
    from rmm_tpu_torch.train.trainer import Trainer
    from rmm_tpu_torch.utils.checkpoint import save_checkpoint
    from rmm_tpu_torch.utils.config import config_from_args, create_parser

    data = str(tmp_path / "aml.csv")
    write_synthetic_aml_csv(data, num_rows=2000, num_accounts=125, seed=0)
    argv = ["--data", data, "--model", "tabgnn", "--num_neighs", "10", "10",
            "--batch_size", "64", "--split", "test"]
    cfg = config_from_args(create_parser().parse_args(
        argv[:-2] + ["--device", "cpu"]))
    state = Trainer(cfg, build_dataset(cfg)).model.state_dict()
    g = torch.Generator().manual_seed(0)
    for name, t in state.items():   # biases and BatchNorm stats off init
        if t.is_floating_point():
            noise = (torch.rand(t.shape, generator=g)
                     if name.endswith("running_var")
                     else 0.1 * torch.randn(t.shape, generator=g))
            t.add_(noise)
    ckpt = save_checkpoint(str(tmp_path / "ckpt"), state)
    argv += ["--load_model", ckpt]

    host = predict.main(argv + ["--output", str(tmp_path / "cpu.csv"),
                                "--device", "cpu"])
    before = (ca.launches, ca.fwd_tiled_launches)
    card_stats = {}
    card = predict.main(argv + ["--output", str(tmp_path / "cuda.csv"),
                                "--device", "cuda"], card_stats)
    batches = -(-len(card["id"]) // 64)
    # 2 layers x nodes, edges, all through the tiled forward
    assert (ca.launches - before[0], ca.fwd_tiled_launches - before[1]) == (
        4 * batches, 4 * batches)
    assert card_stats["device"].startswith("cuda")
    np.testing.assert_array_equal(card["id"], host["id"])
    np.testing.assert_allclose(card["score"], host["score"], rtol=1e-4,
                               atol=1e-4)
    clear = np.abs(host["score"] - 0.5) > 1e-4
    np.testing.assert_array_equal(card["pred"][clear], host["pred"][clear])


def test_same_seed_same_training_run_on_the_card(cuda, tmp_path):
    """The dropout masks come from the trainer's generator, seeded from
    ``--seed``: two runs draw the same masks, so their losses agree up to
    the order of the float atomics in PyTorch's scatter kernels (1e-5
    rel), far closer than two different masks would give."""
    import itertools

    from rmm_tpu_torch.datasets import build_dataset, write_synthetic_aml_csv
    from rmm_tpu_torch.train.trainer import Trainer
    from rmm_tpu_torch.utils.config import config_from_args, create_parser

    data = str(tmp_path / "aml.csv")
    write_synthetic_aml_csv(data, num_rows=2000, num_accounts=125, seed=0)
    cfg = config_from_args(create_parser().parse_args(
        ["--data", data, "--model", "tabgnn", "--num_neighs", "10", "10",
         "--batch_size", "64", "--dropout", "0.3", "--seed", "3",
         "--device", "cuda"]))
    runs = []
    for mask_seed in (None, None, 99):     # the last run: other masks only
        tr = Trainer(cfg, build_dataset(cfg))
        if mask_seed is not None:
            tr.generator.manual_seed(mask_seed)
        tr.model.train()
        batches = itertools.islice(
            tr._batches(tr.dataset.edges.split()[0], "train"), 3)
        runs.append([float(tr._step(gb.to(tr.device))[0]) for gb in batches])
    np.testing.assert_allclose(runs[1], runs[0], rtol=1e-5)
    assert not np.allclose(runs[2], runs[0], rtol=1e-3)


@pytest.mark.parametrize("direction", ["fwd", "bwd"])
def test_ssl_target_rows_split_backward_scalar_forward_match_plain(
        cuda, direction):
    """The SSL path's target rows (200 seeds x 65) at C = 128 with its 0.5
    keep-mask, each direction against the plain version, both through the
    split route (the forward took PR 1's scalar kernel before it had
    one)."""
    b, s, c, h, rate = 13000, 6, 128, 8, 0.5
    args = attention_inputs(7, b, s, c, cuda)
    mask = torch.from_numpy(
        np.random.RandomState(8).rand(b, h, s, s) >= rate).to(cuda)
    assert ca.route(c, s) == "split"
    before = (ca.launches, ca.fwd_split_launches, ca.bwd_launches,
              ca.bwd_split_launches)
    if direction == "fwd":
        with torch.inference_mode():
            out = ca.fused_column_attention(*args, h, mask, rate)
            ref = ca.reference_column_attention(*args, h, mask, rate)
        np.testing.assert_allclose(out.cpu().numpy(), ref.cpu().numpy(),
                                   **TOL)
        assert (ca.launches, ca.fwd_split_launches) == (before[0] + 1,
                                                        before[1] + 1)
        return
    leaves = [a.requires_grad_() for a in args]
    do = torch.from_numpy(np.random.RandomState(9).randn(b, s, c).astype(
        np.float32)).to(cuda)
    got = torch.autograd.grad(
        ca.fused_column_attention(*leaves, h, mask, rate), leaves, do)
    want = torch.autograd.grad(
        ca.reference_column_attention(*leaves, h, mask, rate), leaves, do)
    assert (ca.bwd_launches, ca.bwd_split_launches) == (before[2] + 1,
                                                        before[3] + 1)
    assert_gradients_match(got, want)


def test_three_ssl_steps_on_the_card_match_the_cpu(cuda, tmp_path):
    """mcm-lp at the SSL widths (C = 128, 3 layers, 8 heads; the split
    forward and backward) on a small graph, dropout 0, from the same seeded start: each
    loss term 1e-4 rel, and every variable by the limits of
    ``rmm_tpu_torch.convert.check_states``."""
    import itertools

    from rmm_tpu_torch.cli import fused
    from rmm_tpu_torch.convert import check_states, loss_terms
    from rmm_tpu_torch.datasets import build_dataset, write_synthetic_aml_csv
    from rmm_tpu_torch.train.pretrain import PretrainTrainer

    data = str(tmp_path / "aml.csv")
    write_synthetic_aml_csv(data, num_rows=2000, num_accounts=125, seed=0)
    argv = ["--dataset", data, "--channels", "128", "--num_layers", "3",
            "--num_neg_samples", "16", "--khop_neighbors", "10", "10",
            "--batch_size", "64", "--dropout", "0"]
    counters = ("launches", "fwd_tiled_launches", "bwd_launches",
                "bwd_tiled_launches", "reduce_launches",
                "bwd_split_launches", "fwd_split_launches")
    runs = []
    for device in ("cpu", "cuda"):
        cfg = fused.config_from_args(fused.build_parser().parse_args(
            argv + ["--device", device]))
        tr = PretrainTrainer(cfg, build_dataset(cfg), "mcm-lp")
        tr.model.train()
        before = [getattr(ca, n) for n in counters]
        batches = itertools.islice(
            tr._batches(tr.dataset.edges.split()[0], "train"), 3)
        terms = [loss_terms(*tr._step(gb.to(tr.device))) for gb in batches]
        launched = tuple(getattr(ca, n) - m
                         for n, m in zip(counters, before))
        runs.append((terms, {k: v.cpu() for k, v in
                             tr.model.state_dict().items()}, launched))
    (cpu_terms, cpu_state, cpu_launched), (terms, state, launched) = runs
    assert cpu_launched == (0,) * 7
    # 10 a step each way, all through the split routes
    assert launched == (30, 0, 30, 0, 30, 30, 30)
    assert set(terms[0]) == {"loss", "lp", "mcm_cat", "mcm_num"}
    faults, _ = check_states(state, terms, cpu_state, cpu_terms, cfg.lr,
                             updates=2 * 3, nhidden=128,
                             loss_rtol=(1e-4, 1e-4))
    assert not faults, faults


def test_transfer_at_the_ssl_width_on_the_card_matches_the_cpu(cuda,
                                                               tmp_path):
    """SSL → supervised at the SSL widths (C = 128, 3 layers, 8 heads; the
    split forward and backward): a port SSL checkpoint's encoders grafted
    into ``tabgnnfused`` (``cli/main.py --load_model``'s
    ``load_components``) on the CPU and on the card, then three steps with
    dropout 0 from the same seeded start: the same leaves grafted, each
    loss 1e-4 rel, and every variable by the limits of
    ``rmm_tpu_torch.convert.check_states``."""
    import itertools

    from rmm_tpu_torch.cli import fused
    from rmm_tpu_torch.convert import check_states, loss_terms
    from rmm_tpu_torch.datasets import build_dataset, write_synthetic_aml_csv
    from rmm_tpu_torch.train.pretrain import PretrainTrainer
    from rmm_tpu_torch.train.trainer import Trainer
    from rmm_tpu_torch.utils.checkpoint import load_components
    from rmm_tpu_torch.utils.config import config_from_args, create_parser

    data = str(tmp_path / "aml.csv")
    write_synthetic_aml_csv(data, num_rows=2000, num_accounts=125, seed=0)
    cfg = fused.config_from_args(fused.build_parser().parse_args(
        ["--dataset", data, "--channels", "128", "--num_layers", "3",
         "--num_neg_samples", "16", "--khop_neighbors", "10", "10",
         "--batch_size", "64", "--device", "cpu"]))
    ck = PretrainTrainer(cfg, build_dataset(cfg), "mcm-lp").save(
        str(tmp_path / "ssl"), 0, {})
    counters = ("launches", "fwd_tiled_launches", "bwd_launches",
                "bwd_tiled_launches", "reduce_launches",
                "bwd_split_launches", "fwd_split_launches")
    runs = []
    for device in ("cpu", "cuda"):
        cfg = config_from_args(create_parser().parse_args(
            ["--data", data, "--model", "tabgnnfused", "--n_hidden", "128",
             "--n_gnn_layers", "3", "--num_neighs", "10", "10",
             "--batch_size", "64", "--dropout", "0", "--device", device]))
        tr = Trainer(cfg, build_dataset(cfg))
        grafted = load_components(ck, tr.model, ["node_encoder",
                                                 "edge_encoder"])["grafted"]
        tr.model.train()
        before = [getattr(ca, n) for n in counters]
        batches = itertools.islice(
            tr._batches(tr.dataset.edges.split()[0], "train"), 3)
        terms = [loss_terms(tr._step(gb.to(tr.device))[0], {})
                 for gb in batches]
        launched = tuple(getattr(ca, n) - m
                         for n, m in zip(counters, before))
        runs.append((grafted, terms, {k: v.cpu() for k, v in
                                      tr.model.state_dict().items()},
                     launched))
    (cpu_grafted, cpu_terms, cpu_state, cpu_launched), (
        grafted, terms, state, launched) = runs
    assert grafted == cpu_grafted and grafted
    assert all(k.startswith("edge_encoder.") for k in grafted)
    assert cpu_launched == (0,) * 7
    # 5 a step each way (the top layer on the edge tokens and the targets,
    # one a fused layer), all through the split routes
    assert launched == (15, 0, 15, 0, 15, 15, 15)
    faults, _ = check_states(state, terms, cpu_state, cpu_terms, cfg.lr,
                             updates=3, nhidden=128, loss_rtol=(1e-4, 1e-4))
    assert not faults, faults


# bf16 (--precision bf16): both directions' tiled and split routes on bf16
# x and weights. C = 100 and 68 are rows of C % 8 = 4 bf16 elements, which
# the split route's GEMMs copy 8 bytes at a time; C = 126, 30 and 21, which
# its narrow GEMMs copy one element at a time.
BF16_SHAPES = [
    (37, 2, 32, 8),      # node tokens at the serving width, ragged batch
    (4099, 6, 32, 8),    # edge tokens
    (515, 3, 48, 6),     # odd S, head_dim 8
    (257, 9, 64, 4),
    (203, 6, 16, 2),
    (157, 6, 48, 8),     # head_dim 6
    (1001, 6, 128, 8),   # split route, the SSL width
    (333, 16, 96, 3),
    (401, 6, 100, 5),
    (77, 5, 68, 4),
    (333, 6, 126, 6),    # C not a multiple of 4: the narrow split route
    (129, 6, 30, 6),
    (77, 5, 21, 3),      # odd C: no two bf16 elements share 4 bytes
    (203, 167, 32, 8),   # Elliptic's node tokens: the long cores
    (77, 17, 32, 8),
    (129, 40, 128, 8),
    (98, 33, 32, 8),     # a lane's second query, a second chunk of keys
    (52, 65, 32, 8),
    (14, 193, 32, 8),    # a second group of queries
    (11, 195, 32, 8),    # the longest rows the cores take
    (21, 54, 128, 8),
    (1, 167, 32, 8),     # one row
    (17, 64, 128, 4),    # finetune_llm's rows: the backward one block an SM
    (4096, 129, 32, 8),  # the node families' node tokens under bf16
    (4096, 130, 32, 8),  # ogbn-arxiv's (its year a feature too)
    (256, 64, 64, 4),    # the downstream LM's 64-token rows
    (8192, 2, 32, 8),    # the node families' edge tokens (tiled)
    (33, 6, 256, 8),     # C = 256 (tensor-core GEMMs)
    (37, 2, 256, 8),     # its node tokens (the bf16 run's bf16 calls)
    (45, 6, 130, 10),    # C = 130 (narrow GEMMs)
    (9, 60, 256, 8),     # past max_s: the direct form
    (3, 600, 32, 8),
]
#: (B, S, C, H) that --precision bf16 puts on a path through the bf16
#: build, by the route they take: the node families' node tokens and the
#: downstream LM's rows (the long cores), their edge tokens and the node
#: tokens of every other dataset (tiled)
BF16_PATH_SHAPES = {(4096, 129, 32, 8): "long", (4096, 130, 32, 8): "long",
                    (256, 64, 64, 4): "long", (8192, 2, 32, 8): "tiled",
                    (16384, 2, 32, 8): "tiled"}


def bf16_inputs(seed, b, s, c, device):
    """The seeded inputs in bf16: x, and float32 masters of the four
    weights whose values are bf16 (so the kernels' rounding of a master to
    bf16 is exact and the plain version can take the masters)."""
    x, *weights = attention_inputs(seed, b, s, c, device)
    return x.bfloat16(), [w.bfloat16().float() for w in weights]


def assert_bf16_close(got, want, scale):
    """Within one bf16 rounding: both sides round float32 values that
    differ by their sums' order, and a bf16 step is at most 2^-7 of the
    value; plus 1e-5 of ``scale`` where the values are near 0."""
    g, w = got.float(), want.float()
    bound = 2.0 ** -7 * torch.maximum(g.abs(), w.abs()) + 1e-5 * scale
    excess = float(((g - w).abs() - bound).max())
    assert excess <= 0, excess


COUNTERS = ("launches", "fwd_tiled_launches", "fwd_split_launches",
            "fwd_bf16_launches", "bwd_launches", "bwd_tiled_launches",
            "bwd_split_launches", "bwd_bf16_launches")


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("b,s,c,h", BF16_SHAPES)
def test_bf16_kernels_match_plain(cuda, b, s, c, h, masked):
    """Both directions through ``fused_column_attention`` on bf16 x and
    bf16 weights cast from float32 masters, against autograd of the plain
    version on the same values: out and dx in bf16 within one bf16
    rounding, the weight and bias gradients float32 at the masters, at the
    float32 tolerance."""
    x, masters = bf16_inputs(b + s + c, b, s, c, cuda)
    x.requires_grad_()
    for m in masters:
        m.requires_grad_()
    rng = np.random.RandomState(c)
    do = torch.from_numpy(rng.randn(b, s, c).astype(np.float32)).to(
        cuda).bfloat16()
    mask, rate = None, 0.0
    if masked:
        rate = 0.3
        mask = torch.from_numpy(rng.rand(b, h, s, s) >= rate).to(cuda)
    before = [getattr(ca, n) for n in COUNTERS]
    out = ca.fused_column_attention(x, *cast_floats(masters, torch.bfloat16),
                                    h, mask, rate)
    got = torch.autograd.grad(out, [x, *masters], do)
    tiled = int(ca.route(c, s) == "tiled")
    split = int(ca.route(c, s) == "split")
    assert [getattr(ca, n) - m for n, m in zip(COUNTERS, before)] == [
        1, tiled, split, 1, 1, tiled, split, 1]
    ref = ca.reference_column_attention(x, *masters, h, mask, rate)
    want = torch.autograd.grad(ref, [x, *masters], do)
    assert out.dtype == got[0].dtype == torch.bfloat16
    assert_bf16_close(out, ref, float(ref.float().abs().max()))
    assert_bf16_close(got[0], want[0], float(want[0].float().abs().max()))
    for g, w in zip(got[1:], want[1:]):
        assert g.dtype == torch.float32
        scale = float(w.abs().max())
        np.testing.assert_allclose(g.cpu().numpy(), w.cpu().numpy(),
                                   rtol=0, atol=1e-4 * max(scale, 1.0))


@pytest.mark.parametrize("shape", list(BF16_PATH_SHAPES))
def test_bf16_path_shapes_launch_the_bf16_build(cuda, shape):
    """A bf16 CUDA tensor at a shape of the bf16 paths launches the bf16
    build through its route (the counters by route and dtype move), each
    way; float32 x at the same shape launches the float32 build (they
    stay)."""
    b, s, c, h = shape
    kind = BF16_PATH_SHAPES[shape]
    x, masters = bf16_inputs(s, b, s, c, cuda)
    names = [f"{d}_{kind}_bf16_launches" for d in ("fwd", "bwd")]
    for x_ in (x, x.float()):
        x_ = x_.detach().requires_grad_()
        before = [getattr(ca, n) for n in names]
        out = ca.fused_column_attention(
            x_, *cast_floats(masters, torch.bfloat16), h)
        out.float().sum().backward()
        moved = [getattr(ca, n) - m for n, m in zip(names, before)]
        bf16 = x_.dtype == torch.bfloat16
        assert out.dtype == x_.dtype and moved == [int(bf16)] * 2, moved


@pytest.mark.parametrize("c", [32, 100, 128, 126])
def test_bf16_kernels_repeat_bitwise(cuda, c):
    """The bf16 builds sum every output in a fixed order, as the float32
    ones do: two calls of each direction give the same bits."""
    b, s, h = 4099, 6, {100: 4, 126: 6}.get(c, 8)
    x, masters = bf16_inputs(0, b, s, c, cuda)
    wqkv, bqkv, wout, bout = (m.bfloat16() for m in masters)
    do = torch.randn(b, s, c, device=cuda,
                     generator=torch.Generator(cuda).manual_seed(1)).bfloat16()
    mask = torch.rand(b, h, s, s, device=cuda,
                      generator=torch.Generator(cuda).manual_seed(2)) >= 0.5
    with torch.inference_mode():
        outs = [ca.column_attention_fwd(x, wqkv, bqkv, wout, bout, h, mask,
                                        0.5) for _ in range(2)]
    assert torch.equal(*outs)
    first, second = (ca.column_attention_bwd(x, do, wqkv, bqkv, wout, h,
                                             mask, 0.5) for _ in range(2))
    for g, a in zip(first, second):
        assert torch.equal(g, a)


@pytest.mark.parametrize("c", [32, 128])
def test_float32_x_with_bf16_weights_takes_the_float32_kernels(cuda, c):
    """The reference's edge tokens under --precision bf16 are float32 (the
    timestamp block is), its weights bf16: the float32 kernels run on the
    weights' exact values, out and dx are float32, and the gradients reach
    the float32 masters unrounded."""
    b, s, h = 301, 6, 8
    x, *masters = attention_inputs(3, b, s, c, cuda)
    x.requires_grad_()
    for m in masters:
        m.requires_grad_()
    do = torch.randn(b, s, c, device=cuda,
                     generator=torch.Generator(cuda).manual_seed(1))
    before = [getattr(ca, n) for n in COUNTERS]
    out = ca.fused_column_attention(x, *cast_floats(masters, torch.bfloat16),
                                    h)
    got = torch.autograd.grad(out, [x, *masters], do)
    tiled = int(ca.route(c, s) == "tiled")
    split = int(ca.route(c, s) == "split")
    assert [getattr(ca, n) - m for n, m in zip(COUNTERS, before)] == [
        1, tiled, split, 0, 1, tiled, split, 0]
    rounded = [m.detach().bfloat16().float().requires_grad_()
               for m in masters]
    ref = ca.reference_column_attention(x, *rounded, h)
    want = torch.autograd.grad(ref, [x, *rounded], do)
    assert out.dtype == torch.float32
    np.testing.assert_allclose(out.detach().cpu().numpy(),
                               ref.detach().cpu().numpy(), **TOL)
    assert_gradients_match(got, want)
    assert not torch.equal(got[1], got[1].bfloat16().float())


# The bf16 build's tensor-core GEMM (csrc/gemm_mma.cuh) alone, through its
# C entry rmm_gemm_mma, against a float64 product of the values it takes:
# each of the split routes' six problems at ragged M, N and K (K of 32,
# 100, 128 and 384), with a bias, the weight gradients' bias row and
# token splits. The operands lie in NaN-padded rows (a copy past K or past
# a k-major operand's M or N turns sums NaN), the output between sentinel
# columns and after sentinel rows (a store past N or past the last split
# overwrites them). Tolerance: 2^-13 of Σ|a||b| (the float32 operand's
# hi + lo split leaves 2^-16, float32 sums over K <= 384 the rest), plus
# one bf16 rounding (2^-8 of the value) for a bf16 output.
MMA_GEMMS = [(300, 124, 100, 0), (129, 384, 384, 160), (257, 36, 32, 0),
             (5, 128, 128, 48), (131, 260, 128, 0), (1000, 20, 384, 0)]


def aligned_strided(rows, cols, ld, data, dtype, device):
    """``data`` [rows, cols] in rows of ``ld`` elements (the rest NaN) of a
    fresh allocation (a 16-byte aligned base), two NaN rows after it."""
    buf = torch.full(((rows + 2) * ld,), float("nan"), dtype=dtype,
                     device=device)
    view = buf[:rows * ld].view(rows, ld)
    view[:, :cols] = torch.from_numpy(data).to(device, dtype)
    return view


def exact(data, dtype):
    """``data``'s values as ``dtype`` holds them, in float64."""
    return torch.from_numpy(data.astype(np.float32)).to(dtype).double(
        ).numpy()


def mma_gemm_case(device, problem, m, n, k, split_k):
    """Runs one problem of the tensor-core GEMM: returns its output as
    float64 [splits, M + bias_row, N], the float64 product it should hold
    (a bias added to every row; the bias row is B's column sums), and
    Σ|a||b| for the tolerance."""
    ta, a_kmajor, tb, b_kmajor, tc = gm.PROBLEMS[problem]
    if a_kmajor:      # the aligned form's chunks: a k-major A's M % 4 == 0
        m = max(4, m // 4 * 4)
    rng = np.random.RandomState(m + n + k + len(problem))
    a, b = exact(rng.randn(m, k), ta), exact(rng.randn(k, n), tb)
    bias = exact(rng.randn(n), tb)
    av = (aligned_strided(k, m, m + 4, a.T.copy(), ta, device) if a_kmajor
          else aligned_strided(m, k, k + 4, a, ta, device))
    bv = (aligned_strided(k, n, n + 4, b, tb, device) if b_kmajor
          else aligned_strided(n, k, k + 8, b.T.copy(), tb, device))
    bias_t = torch.from_numpy(bias).to(device, tb)
    bias_row = int(problem in ("dwq", "dwo"))
    split_k = split_k or k
    splits = -(-k // split_k)
    rows, ldc = m + bias_row, n + 4
    out = torch.full((splits * rows + 3, ldc), SENTINEL, dtype=tc,
                     device=device)
    err = ca._kernel(torch.bfloat16).rmm_gemm_mma(
        av.data_ptr(), av.stride(0), bv.data_ptr(), bv.stride(0),
        out.data_ptr(), ldc, bias_t.data_ptr(), m, n, k, split_k, bias_row,
        list(gm.PROBLEMS).index(problem),
        torch.cuda.current_stream().cuda_stream)
    assert err == 0
    torch.cuda.synchronize()
    got = out.double().cpu().numpy()
    sentinel = float(torch.tensor(SENTINEL, dtype=tc))   # as tc holds it
    assert (got[:, n:] == sentinel).all()
    assert (got[splits * rows:] == sentinel).all()
    want, mag = [], []
    for sp in range(splits):
        ks = slice(sp * split_k, min(k, (sp + 1) * split_k))
        part = [a[:, ks] @ b[ks] + bias]
        size = [np.abs(a[:, ks]) @ np.abs(b[ks]) + np.abs(bias)]
        if bias_row:
            part.append(b[ks].sum(0, keepdims=True))
            size.append(np.abs(b[ks]).sum(0, keepdims=True))
        want.append(np.concatenate(part))
        mag.append(np.concatenate(size))
    shape = (splits, rows, n)
    return (got[:splits * rows, :n].reshape(shape), np.stack(want),
            np.stack(mag), tc)


@pytest.mark.parametrize("m,n,k,split_k", MMA_GEMMS)
@pytest.mark.parametrize("problem", list(gm.PROBLEMS))
def test_mma_gemm_matches_float64(cuda, problem, m, n, k, split_k):
    got, want, mag, tc = mma_gemm_case(cuda, problem, m, n, k, split_k)
    assert np.isfinite(got).all()
    tol = 2.0 ** -13 * mag
    if tc == torch.bfloat16:
        tol = tol + 2.0 ** -8 * np.abs(want)
    excess = np.abs(got - want) - tol
    assert excess.max() <= 0, float(excess.max())


def test_bf16_weight_gradients_over_786k_tokens(cuda):
    """The bf16 build's weight gradients at the SSL edge lanes at C = 256
    (786,432 tokens, the 0.5 keep-mask), their GEMM summing at most
    MMA_SPLIT_TOKENS tokens a split, within 1e-4 of the largest entry of
    the plain version's float32 gradients (one split a slot, ~49k tokens,
    left them 1.4e-4 off: the tensor cores' float32 sums drop low bits)."""
    b, s, c, h = 131072, 6, 256, 8
    x, masters = bf16_inputs(7, b, s, c, cuda)
    weights = [m.bfloat16() for m in masters]
    gen = torch.Generator(cuda).manual_seed(5)
    do = torch.randn(b, s, c, device=cuda, generator=gen).bfloat16()
    mask = torch.rand(b, h, s, s, device=cuda, generator=gen) >= 0.5
    plan = ca.bwd_plan(b, s, c, h, dtype=torch.bfloat16)
    assert plan.split_tokens <= ca.MMA_SPLIT_TOKENS
    got = ca.column_attention_bwd(x, do, *weights[:3], h, mask, 0.5)
    leaves = [m.requires_grad_() for m in masters]
    want = torch.autograd.grad(ca.reference_column_attention(
        x, *leaves, h, mask, 0.5), leaves, do)
    for g, w in zip(got[1:], want):
        err = float((g - w).abs().max() / w.abs().max())
        assert err <= 1e-4, err


@pytest.mark.parametrize("problem", list(gm.PROBLEMS))
def test_mma_gemm_repeats_bitwise(cuda, problem):
    first = mma_gemm_case(cuda, problem, 129, 384, 384, 160)[0]
    second = mma_gemm_case(cuda, problem, 129, 384, 384, 160)[0]
    assert np.array_equal(first, second)


def test_bf16_split_gemm_occupancy(cuda):
    """The bf16 build's plan reads the tensor-core GEMM's blocks an SM."""
    assert ca._kernel(torch.bfloat16).rmm_column_attention_gemm_blocks_per_sm(
        ) >= 1


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("b,s,c,h", [(129, 40, 128, 8), (21, 54, 128, 8),
                                     (301, 6, 100, 4)])
def test_bf16_split_route_matches_mma_twin(cuda, b, s, c, h, masked):
    """The bf16 split routes (tensor-core GEMMs around the long or short
    cores) against their plain twin of the same arithmetic
    (``gemm_mma.reference_split_fwd_bf16`` / ``_bwd_bf16``) on the card:
    out and dx within one bf16 rounding, the weight and bias gradients at
    1e-4 of the largest entry."""
    x, masters = bf16_inputs(b + s, b, s, c, cuda)
    weights = [m.bfloat16() for m in masters]
    rng = np.random.RandomState(s)
    do = torch.from_numpy(rng.randn(b, s, c).astype(np.float32)).to(
        cuda).bfloat16()
    mask, rate = None, 0.0
    if masked:
        rate = 0.083
        mask = torch.from_numpy(rng.rand(b, h, s, s) >= rate).to(cuda)
    assert ca.route(c, s) == "split"
    before = (ca.fwd_split_launches, ca.bwd_split_launches,
              ca.fwd_bf16_launches, ca.bwd_bf16_launches)
    with torch.inference_mode():
        out = ca.column_attention_fwd(x, *weights, h, mask, rate)
    got = ca.column_attention_bwd(x, do, *weights[:3], h, mask, rate)
    assert (ca.fwd_split_launches, ca.bwd_split_launches,
            ca.fwd_bf16_launches, ca.bwd_bf16_launches) == tuple(
                n + 1 for n in before)
    want_out = gm.reference_split_fwd_bf16(x, *weights, h, mask, rate)
    want = gm.reference_split_bwd_bf16(x, do, *weights[:3], h, mask, rate)
    assert_bf16_close(out, want_out, float(want_out.float().abs().max()))
    assert_bf16_close(got[0], want[0], float(want[0].float().abs().max()))
    for g, w in zip(got[1:], want[1:]):
        assert g.dtype == torch.float32
        scale = float(w.abs().max())
        np.testing.assert_allclose(g.cpu().numpy(), w.cpu().numpy(),
                                   rtol=0, atol=1e-4 * max(scale, 1.0))
