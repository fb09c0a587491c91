"""Fused column attention: the CUDA kernels' wrapper and its plain twin.

The tabular models attend over the column-token axis: ``S = num_cols + 1``
tokens (2 for the AML nodes table, 6 for its edges) with a batch axis of up
to 131,072 lanes. :func:`fused_column_attention` keeps the JAX signature and
layout (``x [B, S, C]``, ``Wqkv [C, 3C]``, ``Wout [C, C]``, an optional
``[B, nhead, S, S]`` bool keep-mask) and runs ``csrc/column_attention.cu``
for CUDA tensors: the forward kernel (the port of the TPU kernel
``rmm_tpu/ops/pallas/column_attention.py::_fwd_kernel``) and, under
autograd, the backward kernel and its reduce (the port of ``_bwd_kernel``),
through :class:`ColumnAttentionFunction`. The backward recomputes from
``x`` alone, as the TPU kernel does: the Function saves ``x``, the weights
and the keep-mask, nothing of the forward's insides.

CPU tensors take :func:`reference_column_attention`, the PyTorch twin of
``_attention_math``, whose backward is autograd's; a CUDA tensor launches
the kernels or raises. Why the kernels are built the way they are, and what
bounds them, is noted in their source.

``launches`` counts forward-kernel launches, ``bwd_launches`` backward-kernel
launches and ``reduce_launches`` launches of the backward's reduce (one per
backward), and nothing else.
"""
from __future__ import annotations

import ctypes
import math

import torch

launches = 0
bwd_launches = 0
reduce_launches = 0

MAX_S = 16                   # the kernel keeps a row's S×S scores in registers
MAX_C = 128
_ROW_BUDGET_FLOATS = 10240   # shared memory for one group's x/ctx + qkv
_BWD_ROW_BUDGET_FLOATS = 20480  # the backward's 10·S·C + 2·H·S² a row
_WEIGHTS_IN_SMEM_MAX_C = 64  # 4·C² floats = 64 kB at C = 64

_lib = None


def _kernel():
    global _lib
    if _lib is None:
        from .build import load_kernel

        lib = load_kernel("column_attention")
        p = ctypes.c_void_p
        lib.rmm_column_attention_fwd.restype = ctypes.c_int
        lib.rmm_column_attention_fwd.argtypes = [
            p, p, p, p, p, p, p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_float, ctypes.c_int, ctypes.c_int, p]
        lib.rmm_column_attention_bwd_grid.restype = ctypes.c_int
        lib.rmm_column_attention_bwd_grid.argtypes = [ctypes.c_int] * 6
        lib.rmm_column_attention_bwd.restype = ctypes.c_int
        lib.rmm_column_attention_bwd.argtypes = [
            p, p, p, p, p, p, p, p, p, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, p]
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


def column_attention_fwd(x, wqkv, bqkv, wout, bout, nhead, keep=None,
                         rate=0.0):
    """The forward kernel on checked CUDA inputs (no autograd)."""
    global launches
    b, s, c = x.shape
    out = torch.empty_like(x)
    if b == 0:
        return out
    lib = _kernel()
    rows = max(1, min(b, _ROW_BUDGET_FLOATS // (4 * s * c + 2)))
    inv_keep = 1.0 / (1.0 - rate) if keep is not None else 1.0
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.rmm_column_attention_fwd(
            x.data_ptr(), wqkv.data_ptr(), bqkv.data_ptr(), wout.data_ptr(),
            bout.data_ptr(), None if keep is None else keep.data_ptr(),
            out.data_ptr(), b, s, c, nhead, inv_keep, rows,
            int(c <= _WEIGHTS_IN_SMEM_MAX_C), stream)
    _raise_on(err, "forward kernel")
    launches += 1
    return out


def bwd_plan(b: int, s: int, c: int, nhead: int) -> tuple[int, int, int]:
    """(rows per group, weights in shared memory, blocks) of the backward
    kernel for this shape on the current card; one partial slice of
    ``4C² + 4C`` floats per block."""
    w_smem = int(c <= _WEIGHTS_IN_SMEM_MAX_C)
    rows = max(1, min(b, _BWD_ROW_BUDGET_FLOATS
                      // (10 * s * c + 2 * nhead * s * s + 8)))
    grid = _kernel().rmm_column_attention_bwd_grid(b, s, c, nhead, rows,
                                                   w_smem)
    if grid < 0:
        _raise_on(-grid, "backward kernel")
    return rows, w_smem, grid


def column_attention_bwd(x, do, wqkv, bqkv, wout, nhead, keep=None,
                         rate=0.0):
    """The backward kernel and its reduce on checked CUDA inputs (``do``
    contiguous like ``x``): ``(dx, dWqkv, dbqkv, dWout, dbout)``."""
    global bwd_launches, reduce_launches
    b, s, c = x.shape
    dx = torch.empty_like(x)
    grads = torch.empty(4 * c * c + 4 * c, dtype=x.dtype, device=x.device)
    if b == 0:
        grads.zero_()
    else:
        inv_keep = 1.0 / (1.0 - rate) if keep is not None else 1.0
        with torch.cuda.device(x.device):
            rows, w_smem, grid = bwd_plan(b, s, c, nhead)
            partials = torch.empty(grid, grads.numel(), dtype=x.dtype,
                                   device=x.device)
            stream = torch.cuda.current_stream().cuda_stream
            err = _kernel().rmm_column_attention_bwd(
                x.data_ptr(), do.data_ptr(), wqkv.data_ptr(),
                bqkv.data_ptr(), wout.data_ptr(),
                None if keep is None else keep.data_ptr(), dx.data_ptr(),
                partials.data_ptr(), grads.data_ptr(), b, s, c, nhead,
                inv_keep, rows, w_smem, grid, stream)
        _raise_on(err, "backward kernel")
        bwd_launches += 1
        reduce_launches += 1
    k1, k2, k3 = 3 * c * c, 3 * c * c + 3 * c, 4 * c * c + 3 * c
    return (dx, grads[:k1].view(c, 3 * c), grads[k1:k2],
            grads[k2:k3].view(c, c), grads[k3:])
