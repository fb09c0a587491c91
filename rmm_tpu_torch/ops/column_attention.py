"""Fused column attention: the CUDA kernels' wrapper and its plain twin.

The tabular models attend over the column-token axis: ``S = num_cols + 1``
tokens (2 for the AML nodes table, 6 for its edges) with a batch axis of up
to 131,072 lanes. :func:`fused_column_attention` keeps the JAX signature and
layout (``x [B, S, C]``, ``Wqkv [C, 3C]``, ``Wout [C, C]``, an optional
``[B, nhead, S, S]`` bool keep-mask) and runs ``csrc/column_attention.cu``
for CUDA tensors: the forward kernel (the port of the TPU kernel
``rmm_tpu/ops/pallas/column_attention.py::_fwd_kernel``) and, under
autograd, a backward kernel and its reduce (the port of ``_bwd_kernel``),
through :class:`ColumnAttentionFunction`. Each direction takes one of two
kernels by shape (:func:`tiled`): the register-tiled one for every C <= 64
that is a multiple of 4 (the main path's C = 32), the scalar one of the
first port for the rest (C = 96, 128, or C not a multiple of 4). The
backward recomputes from ``x`` alone, as the TPU kernel does: the Function
saves ``x``, the weights and the keep-mask, nothing of the forward's
insides.

CPU tensors take :func:`reference_column_attention`, the PyTorch twin of
``_attention_math``, whose backward is autograd's; a CUDA tensor launches
the kernels or raises. Why the kernels are built the way they are, and what
bounds them, is noted in their source.

``launches`` counts forward-kernel launches (both kernels),
``fwd_tiled_launches`` those of the tiled one, ``bwd_launches``
backward-kernel launches (both kernels), ``bwd_tiled_launches`` those of the
tiled one and ``reduce_launches`` launches of the backward's reduce (one per
backward), and nothing else.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

import torch

launches = 0
fwd_tiled_launches = 0
bwd_launches = 0
bwd_tiled_launches = 0
reduce_launches = 0

MAX_S = 16                   # the kernel keeps a row's S×S scores in registers
MAX_C = 128
_ROW_BUDGET_FLOATS = 10240   # the scalar forward's x/ctx + qkv a group
_BWD_ROW_BUDGET_FLOATS = 20480  # the backward's 10·S·C + 2·H·S² a row
_WEIGHTS_IN_SMEM_MAX_C = 64  # 4·C² floats = 64 kB at C = 64
_TILED_MAX_C = 64            # the tiled kernels keep their weights in smem

_lib = None


def use_library(path: str | None = None):
    """Binds the wrapper to the kernel library at ``path`` (a variant of
    ``csrc/column_attention.cu`` that a measurement tool built with
    :func:`build.start_cuda_build`), or with None back to the repo's own
    build. The cached plans go with the old library."""
    global _lib
    _lib = None
    _fwd_plan.cache_clear()
    _bwd_plan.cache_clear()
    return _kernel(path)


def _kernel(path: str | None = None):
    global _lib
    if _lib is None:
        from .build import load_kernel

        lib = ctypes.CDLL(path) if path else load_kernel("column_attention")
        p = ctypes.c_void_p
        lib.rmm_column_attention_fwd.restype = ctypes.c_int
        lib.rmm_column_attention_fwd.argtypes = [
            p, p, p, p, p, p, p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_float, ctypes.c_int, ctypes.c_int, p]
        lib.rmm_column_attention_fwd_tiled_smem_bytes.restype = (
            ctypes.c_size_t)
        lib.rmm_column_attention_fwd_tiled_smem_bytes.argtypes = [
            ctypes.c_int] * 4
        lib.rmm_column_attention_fwd_tiled_grid.restype = ctypes.c_int
        lib.rmm_column_attention_fwd_tiled_grid.argtypes = [ctypes.c_int] * 5
        lib.rmm_column_attention_fwd_tiled.restype = ctypes.c_int
        lib.rmm_column_attention_fwd_tiled.argtypes = [
            p, p, p, p, p, p, p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_float, ctypes.c_int, ctypes.c_int, p]
        lib.rmm_column_attention_bwd_grid.restype = ctypes.c_int
        lib.rmm_column_attention_bwd_grid.argtypes = [ctypes.c_int] * 6
        lib.rmm_column_attention_bwd.restype = ctypes.c_int
        lib.rmm_column_attention_bwd.argtypes = [
            p, p, p, p, p, p, p, p, p, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, p]
        lib.rmm_column_attention_bwd_tiled_smem_bytes.restype = (
            ctypes.c_size_t)
        lib.rmm_column_attention_bwd_tiled_smem_bytes.argtypes = [
            ctypes.c_int] * 4
        lib.rmm_column_attention_bwd_tiled_splits.restype = ctypes.c_int
        lib.rmm_column_attention_bwd_tiled_splits.argtypes = [ctypes.c_int]
        lib.rmm_column_attention_bwd_tiled_grid.restype = ctypes.c_int
        lib.rmm_column_attention_bwd_tiled_grid.argtypes = [ctypes.c_int] * 5
        lib.rmm_column_attention_bwd_tiled.restype = ctypes.c_int
        lib.rmm_column_attention_bwd_tiled.argtypes = [
            p, p, p, p, p, p, p, p, p, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_int,
            ctypes.c_int, p]
        for fn in (lib.rmm_cuda_max_smem_per_block, lib.rmm_cuda_smem_per_sm):
            fn.restype = ctypes.c_int
            fn.argtypes = []
        lib.rmm_cuda_error_string.restype = ctypes.c_char_p
        lib.rmm_cuda_error_string.argtypes = [ctypes.c_int]
        _lib = lib
    return _lib


def reference_column_attention(x, wqkv, bqkv, wout, bout, nhead: int,
                               drop_mask=None, dropout_rate: float = 0.0):
    """Plain PyTorch version (differentiable): per head
    ``softmax(q_h k_hᵀ/√hd)`` (times ``keep/(1−p)`` with a mask) ``· v_h``,
    heads concatenated, then the output projection."""
    b, s, c = x.shape
    hd = c // nhead
    qkv = torch.matmul(x, wqkv) + bqkv
    q, k, v = (t.reshape(b, s, nhead, hd).transpose(1, 2)
               for t in qkv.split(c, dim=-1))          # [B, H, S, hd]
    scale = 1.0 / math.sqrt(hd)
    attn = torch.softmax(torch.matmul(q, k.transpose(-1, -2)) * scale, -1)
    if drop_mask is not None and dropout_rate > 0.0:
        attn = attn * drop_mask.to(attn.dtype) * (1.0 / (1.0 - dropout_rate))
    ctx = torch.matmul(attn, v).transpose(1, 2).reshape(b, s, c)
    return torch.matmul(ctx, wout) + bout


def fused_column_attention(x, wqkv, bqkv, wout, bout, nhead: int,
                           drop_mask=None, dropout_rate: float = 0.0):
    """x: [B, S, C] → [B, S, C]. ``drop_mask`` [B, nhead, S, S] bool
    keep-mask enables attention-probability dropout at ``dropout_rate``
    (scaled 1/(1−p)); None = no dropout."""
    if x.dim() != 3:
        raise ValueError(f"x must be [B, S, C], got {tuple(x.shape)}")
    b, s, c = x.shape
    if nhead < 1 or c % nhead:
        raise ValueError(f"channels {c} must be divisible by nhead {nhead}")
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
    if x.device.type == "cpu":
        return reference_column_attention(x, wqkv, bqkv, wout, bout, nhead,
                                          drop_mask, dropout_rate)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    keep = drop_mask if masked else None
    rate = dropout_rate if masked else 0.0
    _check_cuda_inputs(x, wqkv, bqkv, wout, bout, keep)
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, wqkv, bqkv, wout, bout)):
        return ColumnAttentionFunction.apply(x, wqkv, bqkv, wout, bout,
                                             nhead, keep, rate)
    return column_attention_fwd(x, wqkv, bqkv, wout, bout, nhead, keep,
                                rate)


class ColumnAttentionFunction(torch.autograd.Function):
    """The forward kernel, and the backward kernel (which recomputes from
    ``x``) as its gradient. Saves ``x``, the weights and the keep-mask."""

    @staticmethod
    def forward(ctx, x, wqkv, bqkv, wout, bout, nhead, keep, rate):
        ctx.nhead, ctx.rate = nhead, rate
        ctx.save_for_backward(x, wqkv, bqkv, wout, keep)
        return column_attention_fwd(x, wqkv, bqkv, wout, bout, nhead, keep,
                                    rate)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, do):
        x, wqkv, bqkv, wout, keep = ctx.saved_tensors
        grads = column_attention_bwd(x, do.contiguous(), wqkv, bqkv, wout,
                                     ctx.nhead, keep, ctx.rate)
        return (*grads, None, None, None)


def _check_cuda_inputs(x, wqkv, bqkv, wout, bout, keep):
    s, c = x.shape[1], x.shape[2]
    tensors = {"x": x, "wqkv": wqkv, "bqkv": bqkv, "wout": wout,
               "bout": bout}
    for name, t in tensors.items():
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype} (the "
                            "kernel takes float32 in this version)")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if keep is not None and (keep.device != x.device
                             or keep.dtype != torch.bool
                             or not keep.is_contiguous()):
        raise ValueError("drop_mask must be a contiguous bool tensor on the "
                         "device of x")
    if s > MAX_S or c > MAX_C:
        raise ValueError(f"the kernel takes S <= {MAX_S} and C <= {MAX_C}, "
                         f"got S={s}, C={c}")


def _raise_on(err: int, what: str):
    if err != 0:
        raise RuntimeError(f"column attention {what} failed to launch: "
                           + _kernel().rmm_cuda_error_string(err).decode())


def tiled(c: int) -> bool:
    """Whether width ``c`` takes the register-tiled kernels, forward and
    backward (every ``c <= 64`` that is a multiple of 4); the rest take the
    scalar kernels of the first port."""
    return c % 4 == 0 and c <= _TILED_MAX_C


def _aligned(t):
    """``t``, or a copy of it where a view's offset rules out the tiled
    kernels' float4 loads."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def column_attention_fwd(x, wqkv, bqkv, wout, bout, nhead, keep=None,
                         rate=0.0, plan: FwdPlan | None = None):
    """The forward kernel on checked CUDA inputs (no autograd). ``plan``
    (from :func:`fwd_plan`, tiled widths only) overrides the default one."""
    global launches, fwd_tiled_launches
    b, s, c = x.shape
    out = torch.empty_like(x)
    if b == 0:
        return out
    lib = _kernel()
    inv_keep = 1.0 / (1.0 - rate) if keep is not None else 1.0
    use_tiled = tiled(c)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        if use_tiled:
            plan = plan or fwd_plan(b, s, c, nhead)
            x = _aligned(x)
            rows, grid = plan
        else:
            rows = max(1, min(b, _ROW_BUDGET_FLOATS // (4 * s * c + 2)))
        args = (x.data_ptr(), wqkv.data_ptr(), bqkv.data_ptr(),
                wout.data_ptr(), bout.data_ptr(),
                None if keep is None else keep.data_ptr(), out.data_ptr(), b,
                s, c, nhead, inv_keep, rows)
        if use_tiled:
            err = lib.rmm_column_attention_fwd_tiled(*args, grid, stream)
        else:
            err = lib.rmm_column_attention_fwd(
                *args, int(c <= _WEIGHTS_IN_SMEM_MAX_C), stream)
    _raise_on(err, "forward kernel")
    launches += 1
    fwd_tiled_launches += int(use_tiled)
    return out


class FwdPlan(NamedTuple):
    """How the tiled forward runs a shape: rows a group and blocks."""
    rows: int
    grid: int


def fwd_plan(b: int, s: int, c: int, nhead: int,
             rows: int | None = None) -> FwdPlan:
    """The tiled forward's plan for this shape on the current card: blocks
    of 256 threads, two an SM, each with as many rows a group as its share
    of the SM's shared memory holds, evened out so that every block walks
    the same number of groups (the choice of ``tools/torch_attn_sweep.py``'s
    and ``tools/torch_attn_stages.py``'s runs, in ``PERF.md``); ``rows``
    overrides the rows a group. Cached by shape and card, as
    :func:`bwd_plan` is."""
    return _fwd_plan(b, s, c, nhead, rows, torch.cuda.current_device())


@functools.lru_cache(maxsize=256)
def _fwd_plan(b, s, c, nhead, rows, device) -> FwdPlan:
    del device  # only a cache key: the plan depends on the card
    lib = _kernel()
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
    """How the backward runs a shape: which kernel, rows a group and
    blocks, and the partial slices of ``4C² + 4C`` floats the reduce adds
    (blocks × stage-F token splits for the tiled kernel)."""
    tiled: bool
    rows: int
    grid: int
    slices: int


def bwd_plan(b: int, s: int, c: int, nhead: int,
             rows: int | None = None) -> BwdPlan:
    """The backward's plan for this shape on the current card. The tiled
    kernel runs blocks of 256 threads, two an SM where a thread holds one
    stage-F tile (C <= 32), else one, each with as many rows a group as
    its share of the SM's shared memory holds, evened out so that every
    block walks the same number of groups (the choice of
    ``tools/torch_attn_sweep.py``'s runs, in ``PERF.md``); ``rows``
    overrides the rows a group. Plans are cached by shape and card: a plan
    costs a few dozen calls into the library, about as long as the
    node-shape kernel itself."""
    return _bwd_plan(b, s, c, nhead, rows, torch.cuda.current_device())


@functools.lru_cache(maxsize=256)
def _bwd_plan(b, s, c, nhead, rows, device) -> BwdPlan:
    del device  # only a cache key: the plan depends on the card
    lib = _kernel()
    if not tiled(c):
        w_smem = int(c <= _WEIGHTS_IN_SMEM_MAX_C)
        rows = rows or max(1, min(b, _BWD_ROW_BUDGET_FLOATS
                                  // (10 * s * c + 2 * nhead * s * s + 8)))
        grid = lib.rmm_column_attention_bwd_grid(b, s, c, nhead, rows,
                                                 w_smem)
        if grid < 0:
            _raise_on(-grid, "backward kernel")
        return BwdPlan(False, rows, grid, grid)
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
    return BwdPlan(True, rows, grid,
                   grid * lib.rmm_column_attention_bwd_tiled_splits(c))


def column_attention_bwd(x, do, wqkv, bqkv, wout, nhead, keep=None,
                         rate=0.0, plan: BwdPlan | None = None):
    """The backward kernel and its reduce on checked CUDA inputs (``do``
    contiguous like ``x``): ``(dx, dWqkv, dbqkv, dWout, dbout)``. ``plan``
    (from :func:`bwd_plan`) overrides the default one."""
    global bwd_launches, bwd_tiled_launches, reduce_launches
    b, s, c = x.shape
    dx = torch.empty_like(x)
    grads = torch.empty(4 * c * c + 4 * c, dtype=x.dtype, device=x.device)
    if b == 0:
        grads.zero_()
    else:
        inv_keep = 1.0 / (1.0 - rate) if keep is not None else 1.0
        with torch.cuda.device(x.device):
            plan = plan or bwd_plan(b, s, c, nhead)
            partials = torch.empty(plan.slices, grads.numel(),
                                   dtype=x.dtype, device=x.device)
            stream = torch.cuda.current_stream().cuda_stream
            if plan.tiled:
                x, do = _aligned(x), _aligned(do)
            args = (x.data_ptr(), do.data_ptr(), wqkv.data_ptr(),
                    bqkv.data_ptr(), wout.data_ptr(),
                    None if keep is None else keep.data_ptr(), dx.data_ptr(),
                    partials.data_ptr(), grads.data_ptr(), b, s, c, nhead,
                    inv_keep, plan.rows)
            if plan.tiled:
                err = _kernel().rmm_column_attention_bwd_tiled(
                    *args, plan.grid, stream)
            else:
                err = _kernel().rmm_column_attention_bwd(
                    *args, int(c <= _WEIGHTS_IN_SMEM_MAX_C), plan.grid,
                    stream)
        _raise_on(err, "backward kernel")
        bwd_launches += 1
        bwd_tiled_launches += int(plan.tiled)
        reduce_launches += 1
    k1, k2, k3 = 3 * c * c, 3 * c * c + 3 * c, 4 * c * c + 3 * c
    return (dx, grads[:k1].view(c, 3 * c), grads[k1:k2],
            grads[k2:k3].view(c, c), grads[k3:])
