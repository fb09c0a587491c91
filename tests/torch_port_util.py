"""Helpers shared by the port's parity tests (``tests/test_torch_*.py``)
and the fixture tools (``tools/make_torch_port_fixture.py``,
``tools/make_torch_port_ssl_fixture.py``): numpy only, no test cases.

``one_torch_thread`` is an autouse fixture for a test module to import: the
tier-1 suite runs one pytest worker a core, and torch's intra-op threads on
top of that (a pool as wide as the machine in every worker) made the CLI
tests spin for minutes. At these widths one thread is as fast alone.

``jax_kernel_attention`` sends ``rmm_tpu``'s column attention down its
Pallas kernel (in interpret mode) on the CPU, the path it takes on a TPU
and whose semantics the port's kernels copy."""
from __future__ import annotations

import contextlib
import functools
import os

import numpy as np
import pytest


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    import torch

    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def randomize_jax_variables(variables: dict, seed: int) -> dict:
    """Replace every leaf of a flax variable tree with seeded random values
    (numpy arrays), biases and BatchNorm statistics included, so that a
    wrong mapping cannot hide behind a zero or one initialization.
    Kernels get std 1/sqrt(fan_in), 1-D leaves std 0.1 (around 1 for norm
    scales), BatchNorm variances are drawn in [0.5, 2)."""
    rng = np.random.RandomState(seed)

    def leaf(path, a):
        a = np.asarray(a)
        name = path[-1]
        if path[0] == "batch_stats":
            if name == "var":
                return rng.uniform(0.5, 2.0, a.shape).astype(np.float32)
            return (rng.randn(*a.shape) * 0.3).astype(np.float32)
        if name == "scale":
            return (1.0 + 0.1 * rng.randn(*a.shape)).astype(np.float32)
        std = 1.0 / np.sqrt(a.shape[0]) if a.ndim >= 2 else 0.1
        if a.ndim == 3:   # timestamp weight [n_cols, 10, C]
            std = 1.0 / np.sqrt(a.shape[1])
        return (rng.randn(*a.shape) * std).astype(np.float32)

    def walk(path, node):
        if isinstance(node, dict) or hasattr(node, "items"):
            return {k: walk(path + (k,), v) for k, v in node.items()}
        return leaf(path, node)

    return walk((), variables)


def nest(flat: dict) -> dict:
    """``{"a/b/c": arr}`` → ``{"a": {"b": {"c": arr}}}``."""
    out: dict = {}
    for key, arr in flat.items():
        *path, leaf = key.split("/")
        node = out
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = arr
    return out


def init_random(flax_module, *args, seed: int = 0, **kwargs) -> dict:
    """Initialize ``flax_module`` on ``args`` and randomize every leaf."""
    import jax

    variables = flax_module.init(jax.random.PRNGKey(seed), *args, **kwargs)
    return randomize_jax_variables(
        {k: v for k, v in variables.items()}, seed + 1000)


def load_from_jax(port_module, variables: dict):
    """Load converted JAX variables into a port module (strict both ways)
    and put it in eval mode."""
    from rmm_tpu_torch.convert import from_jax

    port_module.load_state_dict(from_jax(variables, port_module),
                                strict=True)
    return port_module.eval()


@contextlib.contextmanager
def jax_kernel_attention():
    """Within the block, ``rmm_tpu.nn.transformer.MultiHeadSelfAttention``
    takes its Pallas kernel, run in interpret mode, at every head_dim, as
    on a TPU (on the CPU it takes an einsum path). Under ``--precision
    bf16`` the two differ: the kernel keeps q, k, v, the softmax and the
    context float32 and returns float32 weight gradients, the einsum path
    rounds each to bf16. Only attributes are patched, for the block's
    duration (jit a function inside it); nothing of ``rmm_tpu`` is
    edited."""
    import jax

    from rmm_tpu.ops.pallas import column_attention as pallas_attention

    saved = (jax.default_backend, pallas_attention.fused_column_attention,
             os.environ.get("RMM_FORCE_PALLAS"))
    jax.default_backend = lambda: "tpu"   # the layer's kernel gate
    pallas_attention.fused_column_attention = functools.partial(
        saved[1], interpret=True)
    os.environ["RMM_FORCE_PALLAS"] = "1"  # the gate's head_dim >= 16 too
    try:
        yield
    finally:
        jax.default_backend = saved[0]
        pallas_attention.fused_column_attention = saved[1]
        if saved[2] is None:
            del os.environ["RMM_FORCE_PALLAS"]
        else:
            os.environ["RMM_FORCE_PALLAS"] = saved[2]


@contextlib.contextmanager
def jax_cpnatab_without_row_dropout():
    """Within the block, ``rmm_tpu``'s ``GNNWrap`` builds ``CPNATAB`` with
    its row attention's dropout at 0 instead of the fixed 0.1 that no flag
    reaches, so that its train steps run at dropout 0 as the port's do
    after ``rmm_tpu_torch.nn.dropout.set_rate(model, 0)``. ``GNNWrap``
    builds its backbone at every trace, so the steps must be traced
    inside the block. Only a module attribute is patched, for the block's
    duration."""
    from rmm_tpu.nn.gnn.models import CPNATAB
    from rmm_tpu.train import task_models

    class CPNATABNoRowDropout(CPNATAB):
        dropout: float = 0.0

    saved = task_models.CPNATAB
    task_models.CPNATAB = CPNATABNoRowDropout
    try:
        yield
    finally:
        task_models.CPNATAB = saved


@contextlib.contextmanager
def jax_float32_segment_sums():
    """Within the block, ``rmm_tpu``'s segment sums add bf16 data in
    float32, as the port's do (``rmm_tpu_torch/ops/segment.py``): a sum
    that a float32 count then divides (the scatter path's means, PNA's
    aggregates, the fused model's mean pool) stays float32, and GINE's sum
    is rounded to the data's dtype once. Everything else of the reference
    is unchanged, so a run inside the block against one outside measures
    how far the reference's own bf16 sums move it. Only module attributes
    are patched, for the block's duration (trace a step inside it)."""
    import jax.numpy as jnp

    from rmm_tpu.nn.gnn import conv as jax_conv
    from rmm_tpu.ops import segment as jax_segment

    saved = (jax_segment.segment_sum, jax_conv.segment_sum)

    def f32_sum(data, segment_ids, num_segments, mask=None, impl=None):
        if data.dtype != jnp.bfloat16:
            return saved[0](data, segment_ids, num_segments, mask, impl)
        return saved[0](data.astype(jnp.float32), segment_ids,
                        num_segments, mask, impl)

    def rounded_sum(data, segment_ids, num_segments, mask=None, impl=None):
        return f32_sum(data, segment_ids, num_segments, mask,
                       impl).astype(data.dtype)

    jax_segment.segment_sum, jax_conv.segment_sum = f32_sum, rounded_sum
    try:
        yield
    finally:
        jax_segment.segment_sum, jax_conv.segment_sum = saved
