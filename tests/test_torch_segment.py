"""PNA aggregation of the PyTorch port against ``rmm_tpu.ops.segment``.

Random masks, tied maxima/minima, duplicate messages and empty segments
(no edge at all, or only masked edges). Messages are multiples of 1/4 so
every sum is exact in float32: the JAX sums are differences of a running
cumsum, whose rounding would otherwise swamp the variance of a segment of
equal messages. Tolerance 1e-5 abs/rel."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rmm_tpu.ops.segment import pna_aggregate as jax_pna
from rmm_tpu_torch.ops.segment import pna_aggregate

TOL = dict(rtol=1e-5, atol=1e-5)


def make_case(seed, n_nodes=12, n_edges=64, f=5):
    rng = np.random.RandomState(seed)
    msg = (rng.randint(-8, 9, (n_edges, f)) / 4.0).astype(np.float32)
    msg[40:48] = msg[32:40]                       # duplicate edges
    dst = rng.randint(0, n_nodes - 3, n_edges).astype(np.int32)
    dst[:3] = n_nodes - 2                         # a segment fully masked
    mask = rng.rand(n_edges) < 0.8
    mask[:3] = False                              # (node n-1 gets nothing)
    return msg, dst, mask, n_nodes


@pytest.mark.parametrize("masked", [True, False])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_pna_aggregate_matches_jax(seed, masked):
    msg, dst, mask, n = make_case(seed)
    avg_log_deg = 1.37
    ref = jax_pna(jnp.asarray(msg), jnp.asarray(dst), n, avg_log_deg,
                  jnp.asarray(mask) if masked else None)
    out = pna_aggregate(torch.from_numpy(msg), torch.from_numpy(dst), n,
                        avg_log_deg, torch.from_numpy(mask) if masked
                        else None)
    assert out.shape == (n, 12 * msg.shape[1])
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)
    # empty segments: min and max are 0, degree clamps to 1
    f = msg.shape[1]
    assert (out[n - 1, f:3 * f] == 0).all()
