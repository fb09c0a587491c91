"""Fused column attention: the CUDA kernels' wrapper and its plain twin.

The tabular models attend over the column-token axis: ``S = num_cols + 1``
tokens (2 for the AML nodes table, 6 for its edges, 167 for the Elliptic
nodes table's 166 feature columns) with a batch axis of up to 131,072
lanes. :func:`fused_column_attention` keeps the JAX signature and
layout (``x [B, S, C]``, ``Wqkv [C, 3C]``, ``Wout [C, C]``, an optional
``[B, nhead, S, S]`` bool keep-mask) and runs ``csrc/column_attention.cu``
for CUDA tensors: the forward kernel (the port of the TPU kernel
``rmm_tpu/ops/pallas/column_attention.py::_fwd_kernel``) and, under
autograd, the backward (the port of ``_bwd_kernel``), through
:class:`ColumnAttentionFunction`. Both directions take one of two routes
by width and row length (:func:`route`):

* ``tiled``: every C <= 64 that is a multiple of 4 (the main path's
  C = 32) at S <= 16, the register-tiled kernels (and the backward's
  reduce);
* ``split``: every other shape (C = 96, the SSL path's C = 128, C = 256
  and wider, every C that is not a multiple of 4, and every S > 16):
  hand-written GEMMs around a per-row attention kernel (past S = 16 its
  long form, which walks the keys with an online softmax): float32 FMA
  tiles (``csrc/gemm_f32.cuh``, in their narrow form where C is not a
  multiple of 4), and in the bf16 build at every C that is a multiple of
  4 bf16 tensor-core tiles (``csrc/gemm_mma.cuh``, whose plain twin is
  :mod:`.gemm_mma`). The forward is three launches, the projections, the
  attention core and the output projection; the backward five, the
  projections, its attention core, dx, the weight gradients and the
  reduce. The core stages a row in shared memory where it fits a block
  (half an SM's where it fits that, two blocks an SM, else a whole
  block's, one block an SM: :func:`core_budget`; :func:`max_s`, the
  longest staged row: 392 tokens at C = 32, 109 at C = 128 and 55 at
  C = 256, 8 heads, on an H100); a longer row takes the direct form
  (:func:`core_form`), a block per (row, head) that streams the head's
  keys (queries) through shared memory in chunks. The kernels take every
  shape whose C ``nhead`` divides; only device memory bounds them.

The backward recomputes from ``x`` alone, as the TPU kernel does: the
Function saves ``x``, the weights and the keep-mask, nothing of the
forward's insides.

Precision, as the TPU kernel's: ``x`` is float32 or bf16, the weights
float32 or bf16. Every product sums in float32; the output and dx come out
in ``x``'s dtype, the weight and bias gradients in float32. Both routes
have bf16 builds (``csrc/column_attention.cu`` compiled with
``RMM_ATTENTION_BF16``: bf16 x, do, out, dx and weights) at every width.
Float32 ``x`` with bf16 weights (the reference's edge tokens
under ``--precision bf16``, whose timestamp block is float32) runs the
float32 kernels on the weights' exact float32 values. A weight cast from a
float32 master (``utils/precision.py``) gets its gradient at the master,
unrounded, as the reference's custom VJP delivers it.

CPU tensors take :func:`reference_column_attention`, the PyTorch twin of
``_attention_math``, whose backward is autograd's; a CUDA tensor launches
the kernels or raises. :func:`reference_attention_core` is the plain twin
of the split forward's attention core alone. Why the kernels are built the
way they are, and what bounds them, is noted in their source.

``launches`` counts forward calls on the card (every route),
``fwd_tiled_launches`` and ``fwd_split_launches`` those through the tiled
and the split route, ``fwd_bf16_launches`` those on bf16 ``x``,
``bwd_launches`` backward calls on the card (every route),
``bwd_tiled_launches`` and ``bwd_split_launches`` those through the tiled
and the split route, ``bwd_bf16_launches`` those on bf16 ``x``, and
``reduce_launches`` launches of the backward's reduce (one per backward),
and nothing else. ``fwd_tiled_bf16_launches`` and ``fwd_long_bf16_launches``
(``bwd_*`` for the backward) count the bf16 calls through the tiled route
and through the split route's long cores (S > 16): the launches by route
and dtype. ``fwd_direct_launches`` and ``bwd_direct_launches`` count
the calls whose attention core took the direct form (either dtype).
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

import torch

from ..utils.precision import master_of

launches = 0
fwd_tiled_launches = 0
fwd_split_launches = 0
fwd_bf16_launches = 0
fwd_tiled_bf16_launches = 0
fwd_long_bf16_launches = 0
bwd_launches = 0
bwd_tiled_launches = 0
bwd_split_launches = 0
bwd_bf16_launches = 0
bwd_tiled_bf16_launches = 0
bwd_long_bf16_launches = 0
fwd_direct_launches = 0
bwd_direct_launches = 0
reduce_launches = 0

MAX_S = 16    # rows up to here keep their S×S scores on chip (the tiled
#               kernels, the split routes' short cores); longer, long cores
_TILED_MAX_C = 64            # the tiled kernels keep their weights in smem
_CORE_THREADS = 256          # the split routes' attention cores: a block
_GEMM_TILE = 128             # rows and columns of a GEMM block tile
_STREAM_STAGES = 2           # the direct form's ring: chunks in flight
_STREAM_BUDGET = 48 * 1024   # its bytes before a chunk takes < 32 keys
#: the most tokens a split of the bf16 build's weight-gradient GEMM sums:
#: its tensor cores' float32 sums drop low bits (``csrc/gemm_mma.cuh``),
#: and a split of ~49k tokens (131072x6x256/8, one a slot of the card) left
#: the weight gradients 1.4e-4 of their largest entry off float32; the
#: reduce adds the splits with float32 adds
MMA_SPLIT_TOKENS = 4096

#: the kernel library of each element type (``ops/build.py`` builds both
#: from ``csrc/column_attention.cu``)
LIBRARIES = {torch.float32: "column_attention",
             torch.bfloat16: "column_attention_bf16"}
_libs: dict = {}

_P, _I, _F, _Z = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_size_t
#: each entry point: (return type, argument types)
_SIGNATURES = {
    "rmm_column_attention_fwd_tiled_smem_bytes": (_Z, [_I] * 4),
    "rmm_column_attention_fwd_tiled_grid": (_I, [_I] * 5),
    "rmm_column_attention_fwd_tiled": (
        _I, [_P] * 7 + [_I] * 4 + [_F, _I, _I, _P]),
    "rmm_column_attention_bwd_tiled_smem_bytes": (_Z, [_I] * 4),
    "rmm_column_attention_bwd_tiled_splits": (_I, [_I]),
    "rmm_column_attention_bwd_tiled_grid": (_I, [_I] * 5),
    "rmm_column_attention_bwd_tiled": (
        _I, [_P] * 9 + [_I] * 4 + [_F, _I, _I, _P]),
    "rmm_column_attention_bwd_core_smem_bytes": (_Z, [_I] * 4),
    "rmm_column_attention_bwd_scratch_floats": (_Z, [_I] * 5),
    "rmm_column_attention_direct_smem_bytes": (_Z, [_I] * 3),
    "rmm_column_attention_fwd_row_floats": (_I, [_I, _I]),
    "rmm_column_attention_fwd_core_smem_bytes": (_Z, [_I] * 4),
    "rmm_column_attention_fwd_core": (
        _I, [_P] * 3 + [_I] * 4 + [_F, _I, _I, _P]),
    "rmm_column_attention_fwd_split": (
        _I, [_P] * 8 + [_I] * 4 + [_F, _I, _I, _P]),
    "rmm_column_attention_bwd_split": (
        _I, [_P] * 10 + [_I] * 4 + [_F, _I, _I, _I, _P]),
    "rmm_cuda_max_smem_per_block": (_I, []),
    "rmm_cuda_smem_per_sm": (_I, []),
    "rmm_column_attention_gemm_blocks_per_sm": (_I, []),
    "rmm_gemm_narrow": (
        _I, [_P, _I, _P, _I, _P, _I, _P] + [_I] * 4 + [_P]),
    "rmm_gemm_mma": (
        _I, [_P, _I, _P, _I, _P, _I, _P] + [_I] * 6 + [_P]),
    "rmm_cuda_error_string": (ctypes.c_char_p, [_I]),
}


def use_library(path: str | None = None):
    """Binds the wrapper's float32 kernels to the library at ``path`` (a
    variant of ``csrc/column_attention.cu`` that a measurement tool built
    with :func:`build.start_cuda_build`), or with None back to the repo's
    own build. The cached plans go with the old library."""
    _libs.pop(torch.float32, None)
    _fwd_plan.cache_clear()
    _bwd_plan.cache_clear()
    return _kernel(torch.float32, path)


def _kernel(dtype=torch.float32, path: str | None = None):
    """The kernel library for ``x`` of ``dtype``, built and bound at first
    use."""
    lib = _libs.get(dtype)
    if lib is None:
        from .build import load_kernel

        lib = ctypes.CDLL(path) if path else load_kernel(LIBRARIES[dtype])
        for name, (restype, argtypes) in _SIGNATURES.items():
            if hasattr(lib, name):
                fn = getattr(lib, name)
                fn.restype, fn.argtypes = restype, argtypes
        _libs[dtype] = lib
    return lib


def reference_column_attention(x, wqkv, bqkv, wout, bout, nhead: int,
                               drop_mask=None, dropout_rate: float = 0.0):
    """Plain PyTorch version (differentiable): per head
    ``softmax(q_h k_hᵀ/√hd)`` (times ``keep/(1−p)`` with a mask) ``· v_h``,
    heads concatenated, then the output projection. bf16 operands are
    taken in float32 (exactly), every intermediate is float32 and the
    output is rounded to ``x``'s dtype, as in the TPU kernel."""
    dtype = x.dtype
    x, wqkv, bqkv, wout, bout = (t.float()
                                 for t in (x, wqkv, bqkv, wout, bout))
    qkv = torch.matmul(x, wqkv) + bqkv
    ctx = reference_attention_core(qkv, nhead, drop_mask, dropout_rate)
    return (torch.matmul(ctx, wout) + bout).to(dtype)


def reference_attention_core(tok, nhead: int, drop_mask=None,
                             dropout_rate: float = 0.0):
    """Plain PyTorch version of the attention between the projections
    (the split forward's core): token rows ``tok`` [B, S, 3C] of
    q | k | v → ctx [B, S, C], per head ``softmax(q_h k_hᵀ/√hd)`` (times
    ``keep/(1−p)`` with a [B, nhead, S, S] keep-mask) ``· v_h``."""
    b, s, c3 = tok.shape
    c = c3 // 3
    hd = c // nhead
    q, k, v = (t.reshape(b, s, nhead, hd).transpose(1, 2)
               for t in tok.split(c, dim=-1))          # [B, H, S, hd]
    scale = 1.0 / math.sqrt(hd)
    attn = torch.softmax(torch.matmul(q, k.transpose(-1, -2)) * scale, -1)
    if drop_mask is not None and dropout_rate > 0.0:
        attn = attn * drop_mask.to(attn.dtype) * (1.0 / (1.0 - dropout_rate))
    return torch.matmul(attn, v).transpose(1, 2).reshape(b, s, c)


def fused_column_attention(x, wqkv, bqkv, wout, bout, nhead: int,
                           drop_mask=None, dropout_rate: float = 0.0):
    """x: [B, S, C] → [B, S, C]. ``drop_mask`` [B, nhead, S, S] bool
    keep-mask enables attention-probability dropout at ``dropout_rate``
    (scaled 1/(1−p)); None = no dropout."""
    if x.dim() != 3:
        raise ValueError(f"x must be [B, S, C], got {tuple(x.shape)}")
    b, s, c = x.shape
    if nhead < 1 or c % nhead:
        raise UnsupportedShape(
            f"channels {c} must be divisible by nhead {nhead}")
    expect = {"wqkv": (c, 3 * c), "bqkv": (3 * c,), "wout": (c, c),
              "bout": (c,)}
    for name, t in zip(expect, (wqkv, bqkv, wout, bout)):
        if tuple(t.shape) != expect[name]:
            raise ValueError(f"{name} must be {expect[name]}, got "
                             f"{tuple(t.shape)}")
    masked = drop_mask is not None and dropout_rate > 0.0
    if masked and tuple(drop_mask.shape) != (b, nhead, s, s):
        raise ValueError(f"drop_mask must be {(b, nhead, s, s)}, got "
                         f"{tuple(drop_mask.shape)}")
    weights = (wqkv, bqkv, wout, bout)
    wdtype = _weights_dtype(x, weights)
    # what autograd differentiates: a weight's float32 master where it has
    # one, so that its float32 gradient is not rounded to the weight's dtype
    masters = [master_of(w) for w in weights]
    leaves = tuple(w if m is None else m for w, m in zip(weights, masters))
    if x.device.type == "cpu":
        return reference_column_attention(
            x, *(_rounded(w, wdtype) for w in leaves), nhead, drop_mask,
            dropout_rate)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    keep = drop_mask if masked else None
    rate = dropout_rate if masked else 0.0
    ops = weights
    if wdtype != x.dtype:
        with torch.no_grad():
            ops = tuple(w.to(x.dtype) for w in weights)
    _check_cuda_inputs(x, *ops, keep)
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, *leaves)):
        return ColumnAttentionFunction.apply(x, *leaves, ops, nhead, keep,
                                             rate)
    return column_attention_fwd(x, *ops, nhead, keep, rate)


def _weights_dtype(x, weights) -> torch.dtype:
    """The dtype the four weights share: float32, or bf16; bf16 ``x``
    takes bf16 weights alone."""
    dtypes = {w.dtype for w in weights}
    if len(dtypes) != 1:
        raise TypeError(f"the weights must share one dtype, got {dtypes}")
    (wdtype,) = dtypes
    for name, dt in (("x", x.dtype), ("the weights", wdtype)):
        if dt not in LIBRARIES:
            raise TypeError(f"{name} must be float32 or bfloat16, got {dt}")
    if x.dtype == torch.bfloat16 and wdtype != torch.bfloat16:
        raise TypeError(f"bf16 x takes bf16 weights, got {wdtype}")
    return wdtype


def _rounded(w, dtype):
    """``w``'s values rounded to ``dtype``, its gradient passing to ``w``
    unrounded (the plain twin's way to a master's float32 gradient)."""
    if w.dtype == dtype:
        return w
    return w + (w.to(dtype).to(w.dtype) - w).detach()


class ColumnAttentionFunction(torch.autograd.Function):
    """The forward kernel, and the backward kernel (which recomputes from
    ``x``) as its gradient. The weights are what autograd differentiates
    (float32 masters, or the weights themselves); ``ops`` are their values
    as the kernels take them, in ``x``'s dtype. Saves ``x``, ``ops`` and
    the keep-mask; the weight and bias gradients are float32."""

    @staticmethod
    def forward(ctx, x, wqkv, bqkv, wout, bout, ops, nhead, keep, rate):
        ctx.nhead, ctx.rate = nhead, rate
        ctx.save_for_backward(x, *ops[:3], keep)
        return column_attention_fwd(x, *ops, nhead, keep, rate)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, do):
        x, wqkv, bqkv, wout, keep = ctx.saved_tensors
        grads = column_attention_bwd(x, do.contiguous(), wqkv, bqkv, wout,
                                     ctx.nhead, keep, ctx.rate)
        return (*grads, None, None, None, None)


class UnsupportedShape(ValueError):
    """A shape no kernel takes: a width ``nhead`` does not divide (the
    only one; the reference's kernel takes no other)."""


def _check_cuda_inputs(x, wqkv, bqkv, wout, bout, keep):
    tensors = {"x": x, "wqkv": wqkv, "bqkv": bqkv, "wout": wout,
               "bout": bout}
    for name, t in tensors.items():
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
        if t.dtype != x.dtype or t.dtype not in LIBRARIES:
            raise TypeError(f"{name} is {t.dtype}: the kernels take x and "
                            "the weights in one dtype, float32 or bfloat16")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if keep is not None and (keep.device != x.device
                             or keep.dtype != torch.bool
                             or not keep.is_contiguous()):
        raise ValueError("drop_mask must be a contiguous bool tensor on the "
                         "device of x")


def _raise_on(err: int, what: str):
    if err != 0:
        raise RuntimeError(f"column attention {what} failed to launch: "
                           + _kernel().rmm_cuda_error_string(err).decode())


def route(c: int, s: int) -> str:
    """The route of both directions for width ``c`` and rows of ``s``
    tokens: ``"tiled"`` for every ``c <= 64`` that is a multiple of 4 at
    ``s <= 16``, ``"split"`` for every other shape (in the GEMMs' narrow
    form where ``c`` is not a multiple of 4, through the long attention
    cores past ``s = 16``; :func:`core_form` says whether the core stages
    a row)."""
    tiled = s <= MAX_S and c <= _TILED_MAX_C and c % 4 == 0
    return "tiled" if tiled else "split"


def _aligned(t):
    """``t``, or a copy of it where a view's offset rules out the float4
    loads of the tiled kernels and of the split routes' aligned GEMMs."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def column_attention_fwd(x, wqkv, bqkv, wout, bout, nhead, keep=None,
                         rate=0.0, plan: FwdPlan | None = None):
    """The forward on checked CUDA inputs (no autograd; x and the weights
    in one dtype), by the route of :func:`route`, into an output of x's
    dtype. ``plan`` (from :func:`fwd_plan`) overrides the default one."""
    global launches, fwd_tiled_launches, fwd_split_launches
    global fwd_bf16_launches, fwd_tiled_bf16_launches, fwd_long_bf16_launches
    global fwd_direct_launches
    b, s, c = x.shape
    out = torch.empty_like(x)
    if b == 0:
        return out
    lib = _kernel(x.dtype)
    inv_keep = 1.0 / (1.0 - rate) if keep is not None else 1.0
    keep_ptr = None if keep is None else keep.data_ptr()
    kind = route(c, s)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        plan = plan or fwd_plan(b, s, c, nhead, dtype=x.dtype)
        x = _aligned(x)
        if kind == "tiled":
            err = lib.rmm_column_attention_fwd_tiled(
                x.data_ptr(), wqkv.data_ptr(), bqkv.data_ptr(),
                wout.data_ptr(), bout.data_ptr(), keep_ptr, out.data_ptr(),
                b, s, c, nhead, inv_keep, plan.rows, plan.grid, stream)
        else:
            wqkv, wout = _aligned(wqkv), _aligned(wout)
            row = lib.rmm_column_attention_fwd_row_floats(c, plan.direct)
            tok = torch.empty(b * s, row, dtype=torch.float32,
                              device=x.device)
            err = lib.rmm_column_attention_fwd_split(
                x.data_ptr(), wqkv.data_ptr(), bqkv.data_ptr(),
                wout.data_ptr(), bout.data_ptr(), keep_ptr, out.data_ptr(),
                tok.data_ptr(), b, s, c, nhead, inv_keep, plan.rows,
                plan.direct, stream)
    _raise_on(err, f"{kind} forward")
    launches += 1
    fwd_tiled_launches += int(kind == "tiled")
    fwd_split_launches += int(kind == "split")
    fwd_direct_launches += int(kind == "split" and plan.direct)
    bf16 = x.dtype == torch.bfloat16
    fwd_bf16_launches += int(bf16)
    fwd_tiled_bf16_launches += int(bf16 and kind == "tiled")
    fwd_long_bf16_launches += int(bf16 and kind == "split" and s > MAX_S)
    return out


def attention_core_fwd(tok, nhead: int, keep=None, rate: float = 0.0,
                       rows: int | None = None, direct: bool | None = None):
    """The split forward's attention core alone on token rows ``tok``
    [B, S, 3C] of q | k | v: ctx [B, S, C], computed on a copy laid out as
    the split forward lays out its scratch rows. The twin of
    :func:`reference_attention_core`
    (which CPU tensors take), for holding the core against it; no forward
    path calls it, and it counts no launch. ``rows`` and ``direct``
    override the plan's."""
    if tok.device.type == "cpu":
        return reference_attention_core(tok, nhead, keep, rate)
    b, s, c3 = tok.shape
    c = c3 // 3
    lib = _kernel()
    with torch.cuda.device(tok.device):
        plan = fwd_plan(b, s, c, nhead, rows)
    if direct is not None:
        plan = plan._replace(direct=direct)
    work = tok.new_zeros(b, s, lib.rmm_column_attention_fwd_row_floats(
        c, plan.direct))
    work[..., :c3] = tok
    ctx = tok.new_empty(b, s, c)
    if b:
        inv_keep = 1.0 / (1.0 - rate) if keep is not None else 1.0
        with torch.cuda.device(tok.device):
            err = lib.rmm_column_attention_fwd_core(
                work.data_ptr(), None if keep is None else keep.data_ptr(),
                ctx.data_ptr(), b, s, c, nhead, inv_keep, plan.rows,
                plan.direct, torch.cuda.current_stream().cuda_stream)
        _raise_on(err, "split forward's attention core")
    return ctx


class FwdPlan(NamedTuple):
    """How the tiled forward runs a shape (rows a group and blocks), or
    the split forward's attention core (rows a block, the row groups that
    cover B once, and whether it takes the direct form, which launches a
    block per row group and head: :func:`core_blocks`)."""
    rows: int
    grid: int
    direct: bool = False


def fwd_plan(b: int, s: int, c: int, nhead: int, rows: int | None = None,
             dtype=torch.float32) -> FwdPlan:
    """The forward's plan for this shape on the current card. The tiled
    kernel runs blocks of 256 threads, two an SM, each with as many rows a
    group as its share of the SM's shared memory holds, evened out so that
    every block walks the same number of groups (the choice of
    ``tools/torch_attn_sweep.py``'s and ``tools/torch_attn_stages.py``'s
    runs, in ``PERF.md``). The split route's core takes the rows of
    :func:`split_fwd_plan` on this card, staged or direct by
    :func:`core_form`. ``rows`` overrides the rows a group (a block of the
    core). ``dtype`` is x's: each has its own build of the kernels. Cached
    by shape, dtype and card, as :func:`bwd_plan` is."""
    return _fwd_plan(b, s, c, nhead, rows, dtype,
                     torch.cuda.current_device())


def core_rows(b: int, s: int, nhead: int, smem_rows: int | None) -> int:
    """Rows a block of a split route's attention core (either direction):
    where the core stages its rows, as many as give each of its 256
    threads at most one (row, head, query) (past S = 16, the long cores:
    each of its 8 warps at most one (row, head)) and at most
    ``smem_rows``, the rows its shared memory holds, at least one (where
    a row has more items, as at 8 heads past S = 32, its warps walk them
    in steps of the block); in the direct form (``smem_rows`` None) one:
    its blocks are (row, head) pairs, B·nhead of them
    (:func:`core_blocks`), whatever S is."""
    if smem_rows is None:
        return 1
    items = (_CORE_THREADS // (nhead * s) if s <= MAX_S
             else _CORE_THREADS // 32 // nhead)
    return max(1, min(b, items, smem_rows))


def core_blocks(plan, nhead: int) -> int:
    """Blocks a split route's attention core launches for ``plan`` (a
    :class:`FwdPlan` or a :class:`BwdPlan`): one a group of ``plan.rows``
    rows where it stages them, one a (row, head) in the direct form."""
    return plan.grid * nhead if plan.direct else plan.grid


def direct_smem_bytes(s: int, c: int, nhead: int) -> int:
    """Shared memory a block of the direct form takes, either direction
    (the library's ``rmm_column_attention_direct_smem_bytes``, which the
    card test ``test_direct_smem_matches_the_library`` holds it to): a
    ring of ``_STREAM_STAGES`` chunks of up to 32 keys, each a row of
    ``2·hd + 2`` floats rounded up to 16 bytes (k | v, or q | dctx | L, D),
    fewer keys a chunk (a multiple of 4, at least 4) where 32 would pass
    ``_STREAM_BUDGET`` bytes. It does not depend on ``s``: 17,408 bytes at
    C = 256, 8 heads, 65,664 at C = 1024, 1 head."""
    del s
    row = (2 * (c // nhead) + 2 + 3) // 4 * 4
    keys = _STREAM_BUDGET // (_STREAM_STAGES * 4 * row) // 4 * 4
    return _STREAM_STAGES * min(32, max(4, keys)) * row * 4


def split_fwd_plan(b: int, s: int, nhead: int, smem_rows: int | None,
                   rows: int | None = None) -> FwdPlan:
    """The split forward's plan: its attention core's rows a block
    (:func:`core_rows`, or ``rows``), the blocks that cover the B rows
    once, and its form (direct where ``smem_rows`` is None)."""
    rows = rows or core_rows(b, s, nhead, smem_rows)
    return FwdPlan(rows, -(-b // rows), smem_rows is None)


def core_budget(row_bytes: int, block_bytes: int, sm_bytes: int) -> int:
    """The shared memory a block of a split route's attention core may
    take, for a core whose row takes ``row_bytes``, on a card whose block
    may opt into ``block_bytes`` and whose SM holds ``sm_bytes`` (less
    1 kB a block that the runtime reserves): two blocks an SM (half an SM
    each, at most a block's) where a row fits that, else one block an SM
    (a whole block's). Rows that fit two blocks an SM keep their plan;
    longer ones, up to a block's bytes, run one block an SM (the LM's
    64-token rows at C = 128, 4 heads, backward); longer still take the
    direct form (:func:`core_form`). H100: 232,448 bytes a block, 233,472
    an SM."""
    half = min(block_bytes, sm_bytes // 2 - 1024)
    return half if row_bytes <= half else block_bytes


def core_form(s: int, c: int, nhead: int, block_bytes: int, sm_bytes: int,
              row_bytes) -> str:
    """How both split routes' attention cores take rows of ``s`` tokens at
    width ``c``: ``"staged"`` where the forward's and the backward's row
    (``row_bytes(s, c, nhead)``) each fit :func:`core_budget` on a card of
    ``block_bytes`` a block and ``sm_bytes`` an SM (a row is staged in
    shared memory), else ``"direct"`` (a block per (row, head) streams the
    row's chunks through shared memory, :func:`direct_smem_bytes`). Past
    S = 16 that is ``s <= core_max_s(...)``; at S <= 16 only a very wide
    row (C near a thousand) goes direct."""
    return ("staged" if all(r <= core_budget(r, block_bytes, sm_bytes)
                            for r in row_bytes(s, c, nhead)) else "direct")


def core_max_s(c: int, nhead: int, block_bytes: int, sm_bytes: int,
               row_bytes) -> int:
    """The longest row, in tokens, whose forward and backward rows
    (``row_bytes(s, c, nhead)``) both fit :func:`core_budget` on a card of
    ``block_bytes`` a block and ``sm_bytes`` an SM: the longest row past
    S = 16 that the cores stage (longer ones take the direct form); at
    least 16 (the short cores' rows)."""
    def fits(s):
        return core_form(s, c, nhead, block_bytes, sm_bytes,
                         row_bytes) == "staged"

    s = MAX_S
    while fits(s + 1):
        s += 1
    return s


def _card_smem() -> tuple[int, int]:
    """(bytes a block may opt into, bytes an SM) of the current card."""
    lib = _kernel()
    return lib.rmm_cuda_max_smem_per_block(), lib.rmm_cuda_smem_per_sm()


def _core_budget(row_bytes: int) -> int:
    """:func:`core_budget` on the current card."""
    return core_budget(row_bytes, *_card_smem())


def _check_rows_fit(smem_bytes, s: int, c: int, nhead: int, rows: int):
    """Raises unless ``rows`` rows of a staged attention core (its bytes
    from the library's ``smem_bytes(S, C, H, rows)``) fit a block: a plan
    given too many ``rows``."""
    most = _kernel().rmm_cuda_max_smem_per_block()
    if smem_bytes(s, c, nhead, rows) > most:
        raise ValueError(f"a split route's attention core does not fit "
                         f"{rows} rows of S={s}, C={c}, nhead={nhead} in "
                         "shared memory")


def core_row_bytes(s: int, c: int, nhead: int) -> tuple[int, int]:
    """(forward, backward) shared-memory bytes a row of S tokens takes in
    a split route's staged attention core: the library's
    ``fwd_core_smem_bytes`` and ``bwd_core_smem_bytes`` at one row."""
    lib = _kernel()
    return (lib.rmm_column_attention_fwd_core_smem_bytes(s, c, nhead, 1),
            lib.rmm_column_attention_bwd_core_smem_bytes(s, c, nhead, 1))


def max_s(c: int, nhead: int) -> int:
    """The longest row, in tokens, that both split routes' attention cores
    stage at width ``c`` on the current card (:func:`core_max_s` with the
    library's bytes a row): on an H100 392 at C = 32, 109 at C = 128 and
    55 at C = 256, 8 heads, and 110 at C = 128, 4 heads. Longer rows take
    the direct form."""
    return core_max_s(c, nhead, *_card_smem(), core_row_bytes)


def _core_form(s: int, c: int, nhead: int) -> str:
    """:func:`core_form` on the current card."""
    return core_form(s, c, nhead, *_card_smem(), core_row_bytes)


@functools.lru_cache(maxsize=256)
def _fwd_plan(b, s, c, nhead, rows, dtype, device) -> FwdPlan:
    del device  # only a cache key: the plan depends on the card
    lib = _kernel(dtype)
    if route(c, s) == "split":
        if _core_form(s, c, nhead) == "direct":
            return split_fwd_plan(b, s, nhead, None, rows)
        smem_bytes = lib.rmm_column_attention_fwd_core_smem_bytes
        row = smem_bytes(s, c, nhead, 1)
        plan = split_fwd_plan(b, s, nhead, _core_budget(row) // row, rows)
        _check_rows_fit(smem_bytes, s, c, nhead, plan.rows)
        return plan
    if rows is None:
        rows = _tiled_rows(
            b, 2,
            lambda r: lib.rmm_column_attention_fwd_tiled_smem_bytes(
                s, c, nhead, r),
            lambda r: lib.rmm_column_attention_fwd_tiled_grid(
                b, s, c, nhead, r))
    grid = lib.rmm_column_attention_fwd_tiled_grid(b, s, c, nhead, rows)
    if grid < 0:
        _raise_on(-grid, "tiled forward kernel")
    return FwdPlan(rows, grid)


def _tiled_rows(b: int, per_sm: int, smem_bytes, grid) -> int:
    """Rows a group for a tiled kernel at ``per_sm`` blocks an SM: as many
    as a block's share of the SM's shared memory holds (``smem_bytes(rows)``
    a block), evened out over the blocks that ``grid(rows)`` launches."""
    lib = _kernel()
    budget = min(lib.rmm_cuda_max_smem_per_block(),
                 lib.rmm_cuda_smem_per_sm() // per_sm - 1024)
    rows = 1
    while rows < b and smem_bytes(rows + 1) <= budget:
        rows += 1
    blocks = grid(rows)
    if blocks < 0:
        _raise_on(-blocks, "tiled kernel")
    groups = -(-b // rows)
    waves = -(-groups // blocks)
    return -(-b // (waves * blocks))


class BwdPlan(NamedTuple):
    """How the backward runs a shape: its route, rows a group and blocks
    (of the tiled kernel, or of the split route's attention core), the
    partial slices of ``4C² + 4C`` floats the reduce adds (blocks ×
    stage-F token splits for the tiled kernel, the token splits of the
    weight-gradient GEMM for the split route) and, for the split route,
    the tokens a split and whether its core takes the direct form (whose
    blocks are ``grid`` row groups times the heads: :func:`core_blocks`)."""
    route: str
    rows: int
    grid: int
    slices: int
    split_tokens: int = 0
    direct: bool = False


def bwd_plan(b: int, s: int, c: int, nhead: int, rows: int | None = None,
             dtype=torch.float32) -> BwdPlan:
    """The backward's plan for this shape on the current card. The tiled
    kernel runs blocks of 256 threads, two an SM where a thread holds one
    stage-F tile (C <= 32), else one, each with as many rows a group as
    its share of the SM's shared memory holds, evened out so that every
    block walks the same number of groups (the choice of
    ``tools/torch_attn_sweep.py``'s runs, in ``PERF.md``); ``rows``
    overrides the rows a group (of the attention core, on the split
    route). The split route's plan is :func:`split_plan` on this card,
    staged or direct by :func:`core_form`.
    Plans are cached by shape, x's dtype (each has its own build) and
    card: a plan costs a few dozen calls into the library, about as long
    as the node-shape kernel itself."""
    return _bwd_plan(b, s, c, nhead, rows, dtype,
                     torch.cuda.current_device())


def split_plan(b: int, s: int, c: int, nhead: int, sms: int,
               gemm_per_sm: int, smem_rows: int | None,
               rows: int | None = None,
               max_split_tokens: int | None = None) -> BwdPlan:
    """The split route's plan on a card of ``sms`` SMs, where an SM holds
    ``gemm_per_sm`` blocks of the weight-gradient GEMM and a block of the
    attention core stages at most ``smem_rows`` rows in its shared memory
    (None: the core's direct form, which stages nothing).

    The attention core takes :func:`core_rows` rows a block (``rows``
    overrides it). The weight-gradient GEMM cuts the B·S tokens into
    ranges of ``split_tokens`` (range ``i`` is tokens ``i·split_tokens`` up
    to the next range or B·S), as many as give its output tiles (4 at
    C = 128) one block on every slot of the card, each at most
    ``max_split_tokens`` (the bf16 build's :data:`MMA_SPLIT_TOKENS`), and
    writes one partial slice per range."""
    rows = rows or core_rows(b, s, nhead, smem_rows)
    tiles = -(-c // _GEMM_TILE) * (-(-3 * c // _GEMM_TILE)
                                   + -(-c // _GEMM_TILE))
    n = b * s
    want = max(1, sms * max(gemm_per_sm, 1) // tiles)
    split_tokens = -(-n // want)
    if max_split_tokens:
        split_tokens = min(split_tokens, max_split_tokens)
    return BwdPlan("split", rows, -(-b // rows), -(-n // split_tokens),
                   split_tokens, smem_rows is None)


@functools.lru_cache(maxsize=256)
def _bwd_plan(b, s, c, nhead, rows, dtype, device) -> BwdPlan:
    del device  # only a cache key: the plan depends on the card
    lib = _kernel(dtype)
    kind = route(c, s)
    if kind == "split":
        per_sm = lib.rmm_column_attention_gemm_blocks_per_sm()
        if per_sm < 0:
            _raise_on(-per_sm, "split backward's GEMM")
        sms = torch.cuda.get_device_properties(
            torch.cuda.current_device()).multi_processor_count
        most = MMA_SPLIT_TOKENS if dtype == torch.bfloat16 else None
        if _core_form(s, c, nhead) == "direct":
            return split_plan(b, s, c, nhead, sms, per_sm, None, rows,
                              max_split_tokens=most)
        smem_bytes = lib.rmm_column_attention_bwd_core_smem_bytes
        row = smem_bytes(s, c, nhead, 1)
        plan = split_plan(b, s, c, nhead, sms, per_sm,
                          _core_budget(row) // row, rows,
                          max_split_tokens=most)
        _check_rows_fit(smem_bytes, s, c, nhead, plan.rows)
        return plan
    if rows is None:
        rows = _tiled_rows(
            b, 2 if c * c // 4 <= 256 else 1,
            lambda r: lib.rmm_column_attention_bwd_tiled_smem_bytes(
                s, c, nhead, r),
            lambda r: lib.rmm_column_attention_bwd_tiled_grid(
                b, s, c, nhead, r))
    grid = lib.rmm_column_attention_bwd_tiled_grid(b, s, c, nhead, rows)
    if grid < 0:
        _raise_on(-grid, "tiled backward kernel")
    return BwdPlan("tiled", rows, grid,
                   grid * lib.rmm_column_attention_bwd_tiled_splits(c))


def column_attention_bwd(x, do, wqkv, bqkv, wout, nhead, keep=None,
                         rate=0.0, plan: BwdPlan | None = None):
    """The backward on checked CUDA inputs (``do`` contiguous like ``x``,
    x, do and the weights in one dtype), by the route of :func:`route`:
    ``(dx, dWqkv, dbqkv, dWout, dbout)``, dx in x's dtype and the weight
    and bias gradients in float32. ``plan`` (from :func:`bwd_plan`)
    overrides the default one."""
    global bwd_launches, bwd_tiled_launches, bwd_split_launches
    global bwd_bf16_launches, reduce_launches
    global bwd_tiled_bf16_launches, bwd_long_bf16_launches
    global bwd_direct_launches
    b, s, c = x.shape
    dx = torch.empty_like(x)
    lib = _kernel(x.dtype)
    f32 = dict(dtype=torch.float32, device=x.device)
    grads = torch.empty(4 * c * c + 4 * c, **f32)
    if b == 0:
        grads.zero_()
    else:
        inv_keep = 1.0 / (1.0 - rate) if keep is not None else 1.0
        with torch.cuda.device(x.device):
            plan = plan or bwd_plan(b, s, c, nhead, dtype=x.dtype)
            partials = torch.empty(plan.slices, grads.numel(), **f32)
            stream = torch.cuda.current_stream().cuda_stream
            x, do = _aligned(x), _aligned(do)
            keep_ptr = None if keep is None else keep.data_ptr()
            if plan.route == "split":
                wqkv, wout = _aligned(wqkv), _aligned(wout)
                tok = torch.empty(lib.rmm_column_attention_bwd_scratch_floats(
                    b, s, c, nhead, plan.direct), **f32)
                err = lib.rmm_column_attention_bwd_split(
                    x.data_ptr(), do.data_ptr(), wqkv.data_ptr(),
                    bqkv.data_ptr(), wout.data_ptr(), keep_ptr,
                    dx.data_ptr(), tok.data_ptr(), partials.data_ptr(),
                    grads.data_ptr(), b, s, c, nhead, inv_keep, plan.rows,
                    plan.split_tokens, plan.direct, stream)
            else:
                err = lib.rmm_column_attention_bwd_tiled(
                    x.data_ptr(), do.data_ptr(), wqkv.data_ptr(),
                    bqkv.data_ptr(), wout.data_ptr(), keep_ptr,
                    dx.data_ptr(), partials.data_ptr(), grads.data_ptr(), b,
                    s, c, nhead, inv_keep, plan.rows, plan.grid, stream)
        _raise_on(err, f"{plan.route} backward")
        bwd_launches += 1
        bwd_tiled_launches += int(plan.route == "tiled")
        bwd_split_launches += int(plan.route == "split")
        bwd_direct_launches += int(plan.route == "split" and plan.direct)
        bf16 = x.dtype == torch.bfloat16
        bwd_bf16_launches += int(bf16)
        bwd_tiled_bf16_launches += int(bf16 and plan.route == "tiled")
        bwd_long_bf16_launches += int(bf16 and plan.route == "split"
                                      and s > MAX_S)
        reduce_launches += 1
    k1, k2, k3 = 3 * c * c, 3 * c * c + 3 * c, 4 * c * c + 3 * c
    return (dx, grads[:k1].view(c, 3 * c), grads[k1:k2],
            grads[k2:k3].view(c, c), grads[k3:])
