"""The plain twin of the bf16 build's tensor-core GEMM
(``csrc/gemm_mma.cuh``), and of the bf16 split routes that run it.

In the bf16 build of the column attention (``csrc/column_attention.cu``
with ``RMM_ATTENTION_BF16``) the split routes' six matrix products run on
bf16 tensor cores at every C that is a multiple of 4. A bf16 operand (x,
do, the weights) is taken exactly. A float32 one (the token rows' scratch:
ctx, dqkv) is taken as two bf16 terms, ``hi = bf16(a)`` and
``lo = bf16(a − hi)`` (:func:`split_bf16`: ``a = hi + lo`` to 2^-16 of
``a``), each multiplied by the exact bf16 operand. Every sum is float32.

:func:`reference_gemm_mma` is that arithmetic in plain PyTorch.
:func:`reference_split_fwd_bf16` and :func:`reference_split_bwd_bf16` run
the bf16 split routes with it around the plain attention core
(:func:`.column_attention.reference_attention_core`, and its autograd for
the backward). The tests use them, on the CPU and against the kernels on
the card; no path calls them.

:data:`PROBLEMS` names the six problems in the order of the bf16 library's
C entry ``rmm_gemm_mma`` (the GEMM alone, which the card tests hold
against a float64 product), each with its element types and layouts.
"""
from __future__ import annotations

import torch

from .column_attention import reference_attention_core

F32, BF16 = torch.float32, torch.bfloat16

#: each problem of the split routes: (A's dtype, A k-major, B's dtype,
#: B k-major, the output's dtype), in ``rmm_gemm_mma``'s order
PROBLEMS = {
    "qkv": (BF16, False, BF16, True, F32),    # x·Wqkv + bqkv
    "dctx": (BF16, False, BF16, False, F32),  # do·Woutᵀ
    "out": (F32, False, BF16, True, BF16),    # ctx·Wout + bout
    "dx": (F32, False, BF16, False, BF16),    # dqkv·Wqkvᵀ
    "dwq": (BF16, True, F32, True, F32),      # xᵀ·dqkv, Σ dqkv
    "dwo": (F32, True, BF16, True, F32),      # ctxᵀ·do, Σ do
}


def split_bf16(a: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """A float32 tensor as two bf16 terms: ``hi = bf16(a)`` and
    ``lo = bf16(a − hi)`` (``a − hi`` is exact in float32), so that
    ``hi + lo`` is ``a`` to 2^-16 of ``a``."""
    hi = a.to(BF16)
    return hi, (a - hi.to(F32)).to(BF16)


def _terms(t: torch.Tensor) -> tuple[torch.Tensor, ...]:
    if t.dtype == BF16:
        return (t,)
    if t.dtype == F32:
        return split_bf16(t)
    raise TypeError(f"operands are bf16 or float32, got {t.dtype}")


def reference_gemm_mma(a, b, bias=None):
    """``a`` [M, K] · ``b`` [K, N] (+ ``bias`` [N]) as the tensor-core
    tiles compute it, in float32: a bf16 operand exactly, a float32 one as
    its ``hi`` and ``lo`` terms (the ``hi`` product first), every product
    of two bf16 values exact and every sum float32. One operand at least
    is bf16, as in every problem of the split routes."""
    if BF16 not in (a.dtype, b.dtype):
        raise TypeError("one operand at least is bf16, got "
                        f"{a.dtype} and {b.dtype}")
    out = None
    for ta in _terms(a):
        for tb in _terms(b):
            term = torch.matmul(ta.to(F32), tb.to(F32))
            out = term if out is None else out + term
    return out if bias is None else out + bias.to(F32)


def reference_split_fwd_bf16(x, wqkv, bqkv, wout, bout, nhead: int,
                             drop_mask=None, dropout_rate: float = 0.0):
    """The bf16 split forward's arithmetic on bf16 ``x`` [B, S, C] and
    weights: the token rows ``x·Wqkv + bqkv`` (float32), the plain
    attention core, then ``ctx·Wout + bout`` rounded to bf16."""
    b, s, c = x.shape
    tok = reference_gemm_mma(x.reshape(b * s, c), wqkv, bqkv)
    ctx = reference_attention_core(tok.view(b, s, 3 * c), nhead, drop_mask,
                                   dropout_rate)
    out = reference_gemm_mma(ctx.reshape(b * s, c), wout, bout)
    return out.to(x.dtype).view(b, s, c)


def reference_split_bwd_bf16(x, do, wqkv, bqkv, wout, nhead: int,
                             drop_mask=None, dropout_rate: float = 0.0):
    """The bf16 split backward's arithmetic on bf16 ``x``, ``do`` and
    weights: ``(dx, dWqkv, dbqkv, dWout, dbout)``, dx rounded to bf16 and
    the weight and bias gradients float32. The token rows and ``do·Woutᵀ``
    come from :func:`reference_gemm_mma`, dqkv and ctx from the plain core
    and its autograd, then dx, the weight gradients and the bias sums
    (float32). Not for use under ``torch.inference_mode``."""
    b, s, c = x.shape
    x2, do2 = x.reshape(b * s, c), do.reshape(b * s, c)
    tok = reference_gemm_mma(x2, wqkv, bqkv).view(b, s, 3 * c)
    dctx = reference_gemm_mma(do2, wout.t())
    with torch.enable_grad():
        tok = tok.detach().requires_grad_()
        ctx = reference_attention_core(tok, nhead, drop_mask, dropout_rate)
        (dtok,) = torch.autograd.grad(ctx, tok, dctx.view(b, s, c))
    dqkv = dtok.reshape(b * s, 3 * c)
    ctx = ctx.detach().reshape(b * s, c)
    dx = reference_gemm_mma(dqkv, wqkv.t()).to(x.dtype).view(b, s, c)
    return (dx, reference_gemm_mma(x2.t(), dqkv), dqkv.sum(0),
            reference_gemm_mma(ctx.t(), do2), do2.to(F32).sum(0))
