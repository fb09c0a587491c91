"""Losses (``rmm_tpu/utils/loss.py``): the supervised cross-entropy, and
for self-supervised pretraining :func:`lp_loss` (link prediction) and
:class:`SSLoss` (masked-cell modeling), vectorized over the batch with the
reference's masks.

``mcm_loss`` → (total, (cat_loss_sum, t_c, acc_count), (num_loss_sum, t_n)),
``total = cat_loss_sum / t_c + sqrt(num_loss_sum / t_n)``, each term only
when its count is positive; ``mv_loss`` is the mask vector's
cross-entropy against the masked column.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  weights: Optional[torch.Tensor] = None,
                  mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Per-class-weighted cross-entropy, mean-reduced over the rows that
    ``mask`` keeps: ``Σ w_y·ce / Σ w_y`` (``torch.nn.CrossEntropyLoss``
    with ``weight=``). Out-of-range labels are clipped; their rows must be
    masked out."""
    logp = torch.log_softmax(logits, dim=-1)
    safe = labels.long().clamp(0, logits.shape[-1] - 1)
    ce = -logp.gather(-1, safe[:, None])[:, 0]
    w = torch.ones_like(ce) if weights is None else weights.to(ce)[safe]
    if mask is not None:
        w = w * mask.to(w.dtype)
    return (ce * w).sum() / w.sum().clamp(min=1e-12)


def _masked_row_mean(x: torch.Tensor,
                     row_mask: Optional[torch.Tensor]) -> torch.Tensor:
    """Mean over the elements of the rows ``row_mask`` keeps (rows are axis
    0, trailing axes flattened)."""
    x2 = x.reshape(x.shape[0], -1)
    if row_mask is None:
        return x2.mean()
    m = row_mask.to(x2.dtype).reshape(-1)[:, None]
    return (x2 * m).sum() / (m.sum() * x2.shape[1]).clamp(min=1.0)


def lp_loss(pos_pred, neg_pred, pos_mask=None, neg_mask=None):
    """−mean log pos − mean log (1 − neg)."""
    pos_term = _masked_row_mean(torch.log(pos_pred + 1e-12), pos_mask)
    neg_term = _masked_row_mean(torch.log(1.0 - neg_pred + 1e-12), neg_mask)
    return -pos_term - neg_term


class SSLoss:
    def __init__(self, num_numerical: int):
        self.num_numerical = num_numerical

    def mcm_loss(self, cat_out: Sequence[torch.Tensor],
                 num_out: torch.Tensor, y: torch.Tensor, valid_mask=None):
        """y: [B, ≥2], ``y[:, 0]`` the masked value, ``y[:, 1]`` the masked
        column's index (numerical columns first)."""
        y_val, y_idx = y[:, 0], y[:, 1].long()
        valid = (torch.ones_like(y_val, dtype=torch.bool)
                 if valid_mask is None else valid_mask.bool())
        nn_ = self.num_numerical
        num_mask = (y_idx < nn_) & valid
        col = y_idx.clamp(0, max(num_out.shape[1] - 1, 0))
        pred = num_out.gather(1, col[:, None])[:, 0]
        num_loss = torch.where(num_mask, (pred - y_val) ** 2, 0.0).sum()
        t_n = num_mask.sum()

        cat_loss = y_val.new_zeros(())
        acc = y_val.new_zeros(())
        t_c = torch.zeros((), dtype=torch.int64, device=y.device)
        for j, logits in enumerate(cat_out):
            sel = (y_idx == nn_ + j) & valid
            tgt = y_val.long().clamp(0, logits.shape[1] - 1)
            ce = -torch.log_softmax(logits, -1).gather(1, tgt[:, None])[:, 0]
            cat_loss = cat_loss + torch.where(sel, ce, 0.0).sum()
            hit = logits.argmax(-1) == tgt
            acc = acc + (sel & hit).sum()
            t_c = t_c + sel.sum()

        cat_term = cat_loss / t_c.clamp(min=1).to(cat_loss.dtype)
        num_term = torch.sqrt(num_loss / t_n.clamp(min=1).to(num_loss.dtype))
        total = (torch.where(t_c > 0, cat_term, 0.0)
                 + torch.where(t_n > 0, num_term, 0.0))
        return total, (cat_loss, t_c, acc), (num_loss, t_n)

    def mv_loss(self, mv_out: torch.Tensor, y: torch.Tensor,
                valid_mask=None) -> torch.Tensor:
        """The mask vector's cross-entropy against the masked column's
        index ``y[:, 1]``, over the rows ``valid_mask`` keeps."""
        return cross_entropy(mv_out, y[:, 1].long(), mask=valid_mask)
