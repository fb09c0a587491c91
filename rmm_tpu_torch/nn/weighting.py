"""MoCo multi-objective gradient weighting (``rmm_tpu/nn/weighting.py``:
``MoCoState``, ``init_moco``, ``moco_combine``) as plain tensor functions
over one flat float32 vector of the trainable parameters.

Per step t, for the task losses L_k and their flat gradients ∇L_k:

    g_k   = ∇L_k / (‖∇L_k‖ + 1e-8) · L_k
    y     ← y − (β / t^βσ) (y − g)
    λ     ← softmax(λ − (γ / t^γσ) (y yᵀ + ρ I) λ)
    grad  = yᵀ λ

Every operation is elementwise in the flat index, or a sum over it (the
norms, ``y yᵀ``), so the result does not depend on the order in which the
parameters are flattened, as long as the gradients, ``y`` and the write
back share one order. Those sums run over every trainable parameter (~12M
at the SSL widths) and take ``Tensor.sum`` of the products: PyTorch's
float32 ``vector_norm`` and matrix product over such a length land ~5e-4
off float64 on the CPU, ``sum`` ~1e-8.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import torch


@dataclasses.dataclass
class MoCoState:
    y: torch.Tensor          # [task_num, grad_dim] float32
    lambd: torch.Tensor      # [task_num] float32
    step: int = 0


def init_moco(task_num: int, grad_dim: int, device=None) -> MoCoState:
    return MoCoState(
        y=torch.zeros(task_num, grad_dim, device=device),
        lambd=torch.full((task_num,), 1.0 / task_num, device=device),
        step=0)


def moco_combine(state: MoCoState, task_grads: Sequence[torch.Tensor],
                 task_losses: Sequence[torch.Tensor], beta: float = 0.999,
                 beta_sigma: float = 0.1, gamma: float = 0.999,
                 gamma_sigma: float = 0.1, rho: float = 0.05):
    """Combine the tasks' flat gradients ``[grad_dim]`` (with their
    losses, detached) into one. → (combined [grad_dim], the new state,
    λ)."""
    step = state.step + 1
    g = torch.stack([v / ((v * v).sum().sqrt() + 1e-8) * loss
                     for v, loss in zip(task_grads, task_losses)])
    t = float(step)
    y = state.y - (beta / t ** beta_sigma) * (state.y - g)
    k = y.shape[0]
    m = torch.stack([torch.stack([(y[i] * y[j]).sum() for j in range(k)])
                     for i in range(k)])
    m = m + rho * torch.eye(k, dtype=y.dtype, device=y.device)
    lambd = torch.softmax(
        state.lambd - (gamma / t ** gamma_sigma) * (m @ state.lambd), -1)
    return y.T @ lambd, MoCoState(y=y, lambd=lambd, step=step), lambd
