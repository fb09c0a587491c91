"""The masked-cell objectives' small parts on the CPU against ``rmm_tpu``:
the self-supervised heads (``SelfSupervisedHead``, ``MVHead``,
``SelfSupervisedMVHead``) on randomized JAX variables, ``SSLoss.mv_loss``
and its gradient, ``mv_accuracy``, the ``mv`` pretraining value in
``parse_pretrain_args`` and ``pack_target``, ``moco_combine`` over three
steps, and the supervised MCM trainer's best rule.

Tolerances: head outputs and gradients 1e-5 (float32, sums in another
order); ``moco_combine`` 1e-6 relative; the rest exact.
"""
import itertools

import jax
import jax.flatten_util  # noqa: F401  (moco_combine's ravel_pytree)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rmm_tpu.datasets import base as jbase
from rmm_tpu.nn import decoders as jdecoders
from rmm_tpu.nn import weighting as jweighting
from rmm_tpu.utils.loss import SSLoss as JaxSSLoss
from rmm_tpu.utils.metric import SSMetric
from rmm_tpu_torch.datasets import base
from rmm_tpu_torch.nn import decoders
from rmm_tpu_torch.nn.weighting import init_moco, moco_combine
from rmm_tpu_torch.train.trainer import mcm_improves, mcm_metrics
from rmm_tpu_torch.utils.loss import SSLoss
from rmm_tpu_torch.utils.metric import mv_accuracy
from tests.torch_port_util import init_random, load_from_jax, \
    one_torch_thread  # noqa: F401

C, N_NUM, N_CAT = 16, 1, (7, 5, 11)
HEADS = ("SelfSupervisedHead", "MVHead", "SelfSupervisedMVHead")


def targets(rng, b):
    """Packed MASK targets ``[value, column]``: numerical columns first."""
    col = rng.randint(0, N_NUM + len(N_CAT), b)
    val = np.where(col < N_NUM, rng.randn(b) * 3.0,
                   rng.randint(0, 5, b)).astype(np.float32)
    return np.stack([val, col.astype(np.float32)], axis=1)


@pytest.mark.parametrize("name", HEADS)
def test_head_and_its_gradient_match_jax(name):
    rng = np.random.RandomState(3)
    x = rng.randn(24, C).astype(np.float32)
    jhead = getattr(jdecoders, name)(C, N_NUM, N_CAT)
    variables = init_random(jhead, jnp.asarray(x), seed=4)
    port = load_from_jax(getattr(decoders, name)(C, N_NUM, N_CAT),
                         variables)

    def flat(out):
        out = out if isinstance(out, tuple) else (out,)
        parts = []
        for o in out:
            parts += list(o) if isinstance(o, list) else [o]
        return parts

    want, vjp = jax.vjp(lambda a: jhead.apply(variables, a), jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    got = port(xt)
    want_parts, got_parts = flat(want), flat(got)
    assert len(want_parts) == len(got_parts)
    cot = [rng.randn(*np.shape(w)).astype(np.float32) for w in want_parts]
    for w, g in zip(want_parts, got_parts):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w),
                                   rtol=1e-5, atol=1e-5)
    (gx,) = vjp(jax.tree_util.tree_unflatten(
        jax.tree_util.tree_structure(want), [jnp.asarray(c) for c in cot]))
    torch.autograd.backward(got_parts, [torch.from_numpy(c) for c in cot])
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("masked", [False, True])
def test_mv_loss_and_its_gradient_match_jax(masked):
    rng = np.random.RandomState(5)
    b, k = 40, N_NUM + len(N_CAT)
    mv = rng.randn(b, k).astype(np.float32)
    y = targets(rng, b)
    valid = (np.arange(b) < 29) if masked else None
    want, grad = jax.value_and_grad(
        lambda m: JaxSSLoss(N_NUM).mv_loss(
            m, jnp.asarray(y), None if valid is None
            else jnp.asarray(valid)))(jnp.asarray(mv))
    mt = torch.from_numpy(mv).requires_grad_(True)
    got = SSLoss(N_NUM).mv_loss(mt, torch.from_numpy(y), None if valid is None
                                else torch.from_numpy(valid))
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-6)
    np.testing.assert_allclose(mt.grad.numpy(), np.asarray(grad), rtol=1e-5,
                               atol=1e-7)


def test_mv_accuracy_matches_jax():
    rng = np.random.RandomState(6)
    for b in (1, 17, 200):
        mv = rng.randn(b, 4).astype(np.float32)
        y = targets(rng, b)
        assert mv_accuracy(mv, y) == SSMetric(N_NUM).mv_accuracy(mv, y)


SETS = [s for n in range(1, 4) for s in itertools.combinations(
    ("mask", "mv", "lp"), n) if "mv" in s]


@pytest.mark.parametrize("names", SETS, ids="+".join)
def test_mv_adds_no_target_of_its_own(names):
    """``parse_pretrain_args`` takes 'mv' to MASK_VECTOR, and
    ``pack_target`` packs as the reference does: by MASK and LINK_PRED
    alone."""
    got = base.parse_pretrain_args(names)
    want = jbase.parse_pretrain_args(names)
    assert sorted(p.name for p in got) == sorted(p.name for p in want)
    assert {p.value for p in got} == {p.value for p in want}
    rng = np.random.RandomState(7)
    link = rng.randn(9, 3).astype(np.float32)
    mask = rng.randn(9, 2).astype(np.float32)
    sup = rng.randint(0, 2, 9)
    a = base.pack_target(got, link, mask, sup)
    b = jbase.pack_target(want, link, mask, sup)
    assert (a is None) == (b is None)
    if a is not None:
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("tasks", [2, 3])
def test_moco_combine_matches_jax_over_three_steps(tasks):
    """Three successive combinations on the same random gradients and
    losses: the combined gradient, ``y`` and λ (1e-6 relative), the
    step."""
    rng = np.random.RandomState(8 + tasks)
    shapes = {"a": (6, 5), "b": (7,), "c": (3, 2, 4)}
    params = {k: jnp.zeros(s) for k, s in shapes.items()}
    jstate = jweighting.init_moco(tasks, params)
    dim = sum(int(np.prod(s)) for s in shapes.values())
    state = init_moco(tasks, dim)
    assert state.y.shape == jstate.y.shape
    for _ in range(3):
        grads = [{k: rng.randn(*s).astype(np.float32)
                  for k, s in shapes.items()} for _ in range(tasks)]
        losses = rng.uniform(0.1, 400.0, tasks).astype(np.float32)
        jcomb, jstate, jl = jweighting.moco_combine(
            jstate, [jax.tree_util.tree_map(jnp.asarray, g) for g in grads],
            [jnp.asarray(x) for x in losses], params)
        # the port flattens in its own order; MoCo does not depend on it
        order = ("c", "a", "b")
        flat = [torch.cat([torch.from_numpy(g[k]).reshape(-1)
                           for k in order]) for g in grads]
        comb, state, lambd = moco_combine(
            state, flat, [torch.tensor(x) for x in losses])
        want = np.concatenate([np.asarray(jcomb[k]).reshape(-1)
                               for k in order])
        scale = np.abs(want).max()
        np.testing.assert_allclose(comb.numpy(), want, rtol=1e-6,
                                   atol=1e-6 * scale)
        np.testing.assert_allclose(lambd.numpy(), np.asarray(jl),
                                   rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(
            np.linalg.norm(state.y.numpy(), axis=1),
            np.linalg.norm(np.asarray(jstate.y), axis=1), rtol=1e-6)
        assert state.step == int(jstate.step)
    np.testing.assert_allclose(float(state.lambd.sum()), 1.0, atol=1e-6)


@pytest.mark.parametrize("val,best,want", [
    ([10.0, 0.5], [1000.0, -1.0], True),    # the first epoch
    ([9.0, 0.6], [10.0, 0.5], True),        # both better
    ([9.0, 0.4], [10.0, 0.5], False),       # RMSE alone better
    ([11.0, 0.6], [10.0, 0.5], False),      # accuracy alone better
    ([9.0, 0.5], [10.0, 0.5], False),       # accuracy tied
    ([9.0, 0.2], [10.0, 1.0], True),        # best accuracy 1: RMSE rules
    ([10.0, 0.9], [10.0, 1.0], False),      # ... and must fall
])
def test_mcm_best_rule_is_the_references(val, best, want):
    """``Trainer.fit``'s MCM rule as ``rmm_tpu/train/trainer.py`` has it:
    ``(val_rmse < best_rmse) and (val_acc > best_acc or best_acc == 1)``,
    a property of the reference kept as it is."""
    assert mcm_improves(val, best) is want


def test_mcm_metrics_from_sums():
    sums = np.array([12.0, 8.0, 6.0, 50.0, 2.0])   # loss_c t_c acc loss_n t_n
    assert mcm_metrics(sums) == [5.0, 0.75]
    assert mcm_metrics(np.zeros(5)) == [0.0, 0.0]
