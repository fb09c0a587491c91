"""Carry JAX weights across: flax variables → the port's ``state_dict``.

``from_jax`` takes ``{"params": ..., "batch_stats": ...}`` as numpy arrays,
either nested dicts or flat keys joined with "/" (``"params/model/..."``).
The port's modules mirror the flax module names, so a leaf's path becomes
the torch key, with these renames:

    Dense ``kernel [in, out]``              → ``weight [out, in]``
    LayerNorm / MaskedBatchNorm ``scale``   → ``weight``
    batch_stats ``mean`` / ``var``          → ``running_mean`` / ``running_var``

Every other leaf (attention ``qkv_kernel``/``qkv_bias``/``out_kernel``/
``out_bias`` in the kernel's layout, encoder tables and weights, the CLS
token) keeps its name and layout. Given the target module, every leaf must
find its entry with the same shape and no entry may be left over.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

_STAT_NAMES = {"mean": "running_mean", "var": "running_var"}


def flatten_variables(variables: dict) -> dict[str, np.ndarray]:
    """Nested (or already flat) variables → ``{"collection/a/b/leaf": arr}``."""
    flat: dict[str, np.ndarray] = {}

    def walk(prefix, node):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(f"{prefix}/{k}" if prefix else str(k), v)
        else:
            flat[prefix] = np.asarray(node)

    walk("", variables)
    return flat


def torch_key(jax_key: str) -> tuple[str, bool]:
    """(torch state_dict key, whether the array is transposed)."""
    collection, *path = jax_key.split("/")
    if not path:
        raise KeyError(f"no collection in variable path {jax_key!r}")
    *mods, leaf = path
    transpose = False
    if collection == "params":
        if leaf == "kernel":
            leaf, transpose = "weight", True
        elif leaf == "scale":
            leaf = "weight"
    elif collection == "batch_stats":
        if leaf not in _STAT_NAMES:
            raise KeyError(f"unknown batch statistic {jax_key!r}")
        leaf = _STAT_NAMES[leaf]
    else:
        raise KeyError(f"unknown variable collection in {jax_key!r}")
    return ".".join(mods + [leaf]), transpose


def from_jax(variables: dict,
             model: Optional[torch.nn.Module] = None
             ) -> dict[str, torch.Tensor]:
    """flax variables → state_dict. With ``model``, raises unless the two
    sides match one to one with equal shapes."""
    state: dict[str, torch.Tensor] = {}
    for key, arr in flatten_variables(variables).items():
        name, transpose = torch_key(key)
        if transpose:
            arr = arr.T
        state[name] = torch.tensor(np.asarray(arr, np.float32))
    if model is not None:
        target = model.state_dict()
        extra = sorted(set(state) - set(target))
        missing = sorted(set(target) - set(state))
        if extra or missing:
            raise KeyError(f"JAX leaves without a torch entry: {extra}; "
                           f"torch entries without a JAX leaf: {missing}")
        for k, t in target.items():
            if tuple(t.shape) != tuple(state[k].shape):
                raise ValueError(f"{k}: JAX shape {tuple(state[k].shape)} "
                                 f"vs torch {tuple(t.shape)}")
    return state
