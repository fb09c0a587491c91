"""Masked PNA aggregation over padded edge lanes, and the fused model's
mean-pool update.

Counterparts of ``rmm_tpu/ops/segment.py::pna_aggregate`` and
``::scatter_mean_update``. The JAX package
sorts edges by segment because scatters serialize on the TPU; on the GPU the
scatters are the natural form, so this is plain PyTorch (``index_add_`` and
``scatter_reduce_``). Masked lanes go to an extra segment ``num_nodes`` and
drop out, so nothing here synchronizes with the host.
"""
from __future__ import annotations

import torch


def pna_aggregate(messages: torch.Tensor, dst: torch.Tensor, num_nodes: int,
                  avg_log_deg: float, mask: torch.Tensor | None = None
                  ) -> torch.Tensor:
    """[E, F] messages → [N, 12F]: aggregators ``[mean, min, max, std]`` ×
    scalers ``[identity, amplification, attenuation]`` (PyG order).

    ``std = sqrt(max(E[x²] − E[x]², 0) + 1e-5)``; empty segments give 0 for
    min and max; the degree is clamped to ≥ 1 inside ``log(deg + 1)``.

    bf16 messages are summed in float32 and the result rounded to bf16
    once. The reference sums in the messages' dtype (as differences of one
    running cumsum, its degree exact only up to 256 in bf16); the float32
    sums are what it means and closer to it than either of its paths
    (``tests/test_torch_precision.py`` pins the difference)."""
    dtype = messages.dtype
    messages = messages.to(torch.promote_types(dtype, torch.float32))
    e, f = messages.shape
    ids = dst.long()
    if mask is not None:
        ids = torch.where(mask.bool(), ids, torch.full_like(ids, num_nodes))
    n = torch.zeros(num_nodes + 1, dtype=messages.dtype,
                    device=messages.device)
    n.index_add_(0, ids, torch.ones(e, dtype=messages.dtype,
                                    device=messages.device))
    sums = torch.zeros(num_nodes + 1, 2 * f, dtype=messages.dtype,
                       device=messages.device)
    sums.index_add_(0, ids, torch.cat([messages, messages * messages], 1))
    n, sums = n[:num_nodes, None], sums[:num_nodes]
    n1 = n.clamp(min=1.0)
    mean = sums[:, :f] / n1
    mean2 = sums[:, f:] / n1
    sd = torch.sqrt(torch.clamp(mean2 - mean * mean, min=0.0) + 1e-5)

    idx = ids[:, None].expand(e, f)
    mx = torch.full((num_nodes + 1, f), -torch.inf, dtype=messages.dtype,
                    device=messages.device).scatter_reduce_(
        0, idx, messages, "amax")[:num_nodes]
    mn = torch.full((num_nodes + 1, f), torch.inf, dtype=messages.dtype,
                    device=messages.device).scatter_reduce_(
        0, idx, messages, "amin")[:num_nodes]
    empty = n <= 0
    mx = torch.where(empty, 0.0, mx)
    mn = torch.where(empty, 0.0, mn)

    agg = torch.cat([mean, mn, mx, sd], dim=-1)
    log_deg = torch.log(n.clamp(min=1.0) + 1.0)
    return torch.cat([agg, agg * (log_deg / avg_log_deg),
                      agg * (avg_log_deg / log_deg)], dim=-1).to(dtype)


def scatter_mean_update(x: torch.Tensor, index: torch.Tensor,
                        values: torch.Tensor) -> torch.Tensor:
    """``x[u] ← (x[u] + mean_{i: index_i = u} values[i]) / 2`` for every row
    ``u`` that ``index`` reaches; the other rows stay as they are."""
    n = x.shape[0]
    ids = index.long()
    sums = torch.zeros(n, values.shape[1], dtype=values.dtype,
                       device=values.device).index_add_(0, ids, values)
    cnt = torch.zeros(n, dtype=values.dtype,
                      device=values.device).index_add_(
        0, ids, torch.ones(ids.shape[0], dtype=values.dtype,
                           device=values.device))[:, None]
    pooled = sums / cnt.clamp(min=1.0)
    return torch.where(cnt > 0, (x + pooled) / 2.0, x)
