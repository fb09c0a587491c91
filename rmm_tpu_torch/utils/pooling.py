"""Sequence pooling (``rmm_tpu/utils/pooling.py``)."""
from __future__ import annotations

import torch


def mean_pooling(last_hidden_state: torch.Tensor,
                 attention_mask: torch.Tensor) -> torch.Tensor:
    """The mean of the attended tokens' states, weighted by the mask (its
    sum clamped at 1e-9): ``[B, L, H]``, ``[B, L]`` → ``[B, 1, H]``."""
    m = attention_mask[..., None].to(last_hidden_state.dtype)
    summed = (last_hidden_state * m).sum(dim=1)
    denom = m.sum(dim=1).clamp(min=1e-9)
    return (summed / denom)[:, None, :]


def last_pooling(last_hidden_state: torch.Tensor,
                 attention_mask: torch.Tensor) -> torch.Tensor:
    """The state of the last attended token: ``[B, L, H]``, ``[B, L]`` →
    ``[B, H]`` (a row with no attended token takes its last position, as
    an index of −1 does in both packages)."""
    lengths = attention_mask.sum(dim=1).long() - 1
    rows = torch.arange(last_hidden_state.shape[0],
                        device=last_hidden_state.device)
    return last_hidden_state[rows, lengths]
