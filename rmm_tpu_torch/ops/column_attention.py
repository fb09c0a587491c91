"""Fused column attention: the CUDA kernel's wrapper and its plain twin.

The tabular models attend over the column-token axis: ``S = num_cols + 1``
tokens (2 for the AML nodes table, 6 for its edges) with a batch axis of up
to 131,072 lanes. :func:`fused_column_attention` keeps the JAX signature and
layout (``x [B, S, C]``, ``Wqkv [C, 3C]``, ``Wout [C, C]``, an optional
``[B, nhead, S, S]`` bool keep-mask) and runs
``csrc/column_attention.cu`` — the port of the TPU kernel
``rmm_tpu/ops/pallas/column_attention.py::_fwd_kernel`` — for CUDA tensors.
CPU tensors take :func:`reference_column_attention`, the PyTorch twin of
``_attention_math``; a CUDA tensor launches the kernel or raises. Why the
kernel is built the way it is, and what bounds it, is noted in its source.

``launches`` counts the kernel's launches (and nothing else).
"""
from __future__ import annotations

import ctypes
import math

import torch

launches = 0

MAX_S = 16                   # the kernel keeps a row's S×S scores in registers
MAX_C = 128
_ROW_BUDGET_FLOATS = 10240   # shared memory for one group's x/ctx + qkv
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
    return _launch(x, wqkv, bqkv, wout, bout, nhead,
                   drop_mask if masked else None, dropout_rate)


def _launch(x, wqkv, bqkv, wout, bout, nhead, keep, dropout_rate):
    global launches
    b, s, c = x.shape
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
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in tensors.values()):
        raise NotImplementedError(
            "the CUDA column-attention kernel has no backward yet")
    out = torch.empty_like(x)
    if b == 0:
        return out
    lib = _kernel()
    rows = max(1, min(b, _ROW_BUDGET_FLOATS // (4 * s * c + 2)))
    inv_keep = 1.0 / (1.0 - dropout_rate) if keep is not None else 1.0
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.rmm_column_attention_fwd(
            x.data_ptr(), wqkv.data_ptr(), bqkv.data_ptr(), wout.data_ptr(),
            bout.data_ptr(), None if keep is None else keep.data_ptr(),
            out.data_ptr(), b, s, c, nhead, inv_keep, rows,
            int(c <= _WEIGHTS_IN_SMEM_MAX_C), stream)
    if err != 0:
        raise RuntimeError("column attention kernel failed to launch: "
                           + lib.rmm_cuda_error_string(err).decode())
    launches += 1
    return out
