"""Mixed precision (``--precision bf16``), as ``rmm_tpu/utils/precision.py``.

The scheme: float32 master parameters (the optimizer and its state stay
float32); at the top of a train or eval step the parameters, the feature
tables and the batch floats are cast to bf16 once; activations follow the
dtypes the modules promote to (a float32 operand keeps a product float32,
as flax's promotion does); norms take their statistics in float32; model
outputs are cast back to float32 before losses and metrics. bf16 has
float32's exponent range, so no loss scaling is needed.

:func:`apply` runs a module so (the reference's ``bf16_apply`` and the
casts at the top of its steps). The cast is differentiable: the gradient
of a bf16 copy reaches its float32 master. PyTorch rounds a gradient to
the dtype of the tensor it flows into, so a kernel whose weight gradients
are float32 (the column attention's, as the TPU kernel's custom VJP gives
them) takes the master itself: :func:`cast_floats` records each cast
parameter's master, and :func:`master_of` hands it over.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

_MASTER = "_rmm_master"


def cast_floats(tree, dtype: torch.dtype):
    """Cast the floating tensors of ``tree`` (tensors, dicts, lists,
    tuples and dataclasses such as ``TensorFrame`` and ``GraphBatch``) to
    ``dtype``; integers, bools, None and the rest pass through. A tensor
    that requires grad and changes dtype keeps its source as its master
    (:func:`master_of`)."""
    if isinstance(tree, torch.Tensor):
        if not tree.is_floating_point() or tree.dtype == dtype:
            return tree
        out = tree.to(dtype)
        if tree.requires_grad:
            setattr(out, _MASTER, tree)
        return out
    if isinstance(tree, dict):
        return {k: cast_floats(v, dtype) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(cast_floats(v, dtype) for v in tree)
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{
            f.name: cast_floats(getattr(tree, f.name), dtype)
            for f in dataclasses.fields(tree)})
    return tree


def compute_cast(tree, precision: str):
    """``tree`` in the compute dtype of ``precision`` (bf16 floats, or
    unchanged under f32)."""
    if precision == "bf16":
        return cast_floats(tree, torch.bfloat16)
    return tree


def out_f32(tree):
    """Model outputs back to float32 before losses and metrics."""
    return cast_floats(tree, torch.float32)


def master_of(t: torch.Tensor) -> Optional[torch.Tensor]:
    """The float32 master that :func:`cast_floats` cast ``t`` from, or
    None."""
    return getattr(t, _MASTER, None)


def apply(module: torch.nn.Module, precision: str, *args):
    """``module(*args)`` with its parameters in the compute dtype of
    ``precision`` (through ``torch.func.functional_call``; the buffers,
    BatchNorm statistics among them, stay the module's own float32 ones)
    and its outputs in float32. The caller casts the inputs, as the
    reference casts the tables and batch floats it chooses."""
    if precision == "f32":
        return module(*args)
    params = compute_cast(dict(module.named_parameters()), precision)
    return out_f32(torch.func.functional_call(module, params, args))


def promote(*tensors: torch.Tensor) -> list:
    """The tensors in their promoted dtype (bf16 with float32 is float32),
    as flax promotes a module's inputs and parameters."""
    dtype = tensors[0].dtype
    for t in tensors[1:]:
        dtype = torch.promote_types(dtype, t.dtype)
    return [t.to(dtype) for t in tensors]
