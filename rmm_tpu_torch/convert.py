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

:func:`from_jax_checkpoint` reads a JAX checkpoint directory (the task
models' components ``node_encoder``, ``edge_encoder``, ``model``,
``decoder``, or the pretrainer's) into such a ``state_dict``.
:func:`pretrain_variables` lays the JAX pretrainer's variables out as the
port's ``PretrainModel``, :func:`tabular_variables` the JAX tabular
trainer's as ``TabularMCMModel``, :func:`text_variables` the JAX text
trainer's as ``TextTabularModel`` and :func:`finetune_llm_variables`
``cli/finetune_llm.py``'s as ``LLMRegressor`` (the LM's ``tok_emb``,
``pos_emb``, ``layer_i`` and LoRA ``lora_out``: ``kernel`` → ``weight``
transposed, ``lora_a``/``lora_b`` as they are), and :func:`random_variables` is the
numpy recipe that both packages' SSL parity records start from.
:func:`check_record` and :func:`check_states` hold three pretraining steps
against such a record or against a second run, with the tolerances below.
"""
from __future__ import annotations

import math
import re
from typing import Optional, Sequence

import numpy as np
import torch

_STAT_NAMES = {"mean": "running_mean", "var": "running_var"}

# Tolerances of a three-step pretraining parity check, each with its reason:
#   * each loss term 1e-4 relative at step 1 and 1e-3 at steps 2-3 (the PNA
#     sums and the matmuls in another order);
#   * parameters 6.05·lr (Adam turns a near-zero gradient of either sign
#     into a ±lr step, so two runs part by up to ~2·lr a step), the median
#     of each component's 0.05·lr (what a wrong gradient would move), and a
#     variable's norm and sum within what its entries' bound implies;
#   * BatchNorm running statistics (1 − momentum)·updates·nhidden·6.05·lr:
#     they are no Adam step but an average of batch means, and no gradient
#     reaches the directions a BatchNorm removes (the layer-0 node states
#     are equal, all node features being ones), so those weights drift by
#     the parameter bound and a batch mean sums up to nhidden of them.
#
# Under --precision bf16 (the records of tools/make_torch_port_bf16_fixture.py)
# two limits widen, set from the reference's own bf16 noise: its jitted
# step rounds at other places than its eager forward and the port (XLA
# fuses bf16 operations and skips roundings between them; the port rounds
# after every operation, as the eager forward does), and a rounding that
# lands elsewhere moves a gradient by a bf16 step. So:
#   * each loss term 1e-3 relative at step 1 and 3e-3 at steps 2-3 (the
#     port lands up to 1.2e-3 from the reference's bf16 record, which lies
#     up to 2.8e-3 from its own float32 run);
#   * the median parameter error 0.1·lr (the port lands at up to 0.062·lr,
#     its bf16 steps at up to 0.17·lr from the float32 record); the largest
#     stays 6.05·lr, which bounds any Adam step.
#
# The column-wise PNA stacks (models cpna and cpnatab) carry the node states
# through a PNA layer and a BatchNorm per edge column and layer, ten at the
# supervised launcher's widths, and those amplify float32 rounding (the
# synthetic AML's node features are all ones, so the BatchNorms have
# degenerate directions): on the families' record
# (tools/make_torch_port_family_fixture.py) float32 runs land from a float64
# run of the port at 0.050·lr (the port's and the reference's) in cpna's
# median parameter and 0.105·lr (the port's) and 0.012·lr (the
# reference's) in cpnatab's, and the reference's own step-3 loss 8.5e-4
# off. On the card the step-3 loss alone moves from run to run on the same
# inputs (the scatters add in no fixed order): 24 runs of
# tools/torch_family_parity_repeat.py landed 1.2e-4 to 4.3e-3 from the
# record at step 3, at most 4.2e-4 at step 2, medians up to 0.064·lr. The
# BatchNorm statistics after the first column's second layer move most:
# the reference's own default PNA path (sums as differences of a sorted
# cumsum) lands 0.062 (cpna) and 0.106 (cpnatab) from its scatter record in
# running_var, three times the statistic limit above (make_torch_port_
# family_fixture.py --against sort), and the port on the CPU, its PNA lanes
# summed in 20 random orders, 0.008-0.038 (torch_family_parity_repeat.py
# --permute). So, for those two models:
#   * each loss term 1e-4 relative at step 1 and 1e-2 at steps 2-3;
#   * the median parameter error 0.15·lr (a wrong gradient moves it by
#     about lr a step); the largest stays 6.05·lr;
#   * the BatchNorm statistics four times the limit above, the smallest
#     whole multiple that holds the reference's sort path with a margin.
#
# MoCo-weighted pretraining at the SSL widths (model="moco"): each loss
# term 1e-4 relative at step 1 and 1e-2 at steps 2-3. After step 1 the MCM
# task's weight λ_mcm is ~6e-7, so the combined gradient of the parameters
# that the LP loss does not reach (the MCM head's) is ~5e-8 an entry,
# beside Adam's eps of 1e-8, and their step moves with λ_mcm's last
# digits: the port's own runs over 1-3 CPU threads spread 1.8e-3 in the
# MCM record's step-3 MCM cross-entropy. The parameter limits stay the
# float32 ones: a λ collapsed to [1, 0] leaves the MCM head's median
# parameter 1.1·lr off the record after three steps, 22 times the limit
# (tests/test_torch_mcm_record.py plants it).
#
# --precision bf16 across the model menu (bf16_family_record.npz, tools/
# make_torch_port_bf16_family_fixture.py: every family, node tasks on
# Ethereum and MUSAE, mcm_edge_table, the tabular and text trainers at
# C = 16) takes the bf16 limits above. That record is eager (its tool runs
# the reference under jax.disable_jit(), rounding where its modules round,
# as the port does), so the port lands far inside them on the CPU: losses
# within 7e-4, medians within 0.08·lr (ethereum tabgnn's node encoder).
# Three rules more, each from what the record's tool measured:
#   * cpna and cpnatab take the wider of each pair of their float32 and
#     the bf16 limits (BF16_CPNA_*): each loss term 1e-3 at step 1 and 1e-2
#     at steps 2-3, medians 0.15·lr, four times the statistic limit. On the
#     CPU they land at 6.8e-4 and 0.055·lr; the card's scatters add in no
#     fixed order, which moved their float32 step-3 loss by up to 4.3e-3
#     (24 runs, above), and bf16 roundings that such sums flip add to it.
#   * runs whose messages reach the segment sums in bf16 (no float32 block
#     in their edge tokens: the node families'; AML and Ethereum edges hold
#     the float32 timestamp block, so every message of theirs is float32)
#     are held to the reference's run with bf16 sums (the record) at
#     BF16_SUMS_*: the reference adds bf16 in bf16, the port in float32,
#     and the reference's own run with float32 sums lands from its record
#     at losses 2.4e-3 / 7.8e-4 / 4.8e-2 (tabgnn at S = 129) and 3.7e-3 /
#     1.4e-2 / 8.5e-3 (pna), medians 0.71·lr and 0.19·lr, statistics 0.037
#     and 0.021 (twice the default limit): losses 5e-3 at step 1 and 6e-2
#     after, medians 1.0·lr, four times the statistic limit. These catch no
#     skipped step, so
#   * such runs are held too to the reference's run with float32 sums, as
#     the port sums (the record's <run>/f32sums/), at BF16_MSG_*: the port
#     rounds the gradients of PNA's aggregates elsewhere than the reference
#     (0.3-0.6% of the std block's), which the BatchNorms and Adam carry to
#     losses 2.9e-4 / 4.1e-3 / 2.7e-2 (tabgnn) and 4e-7 / 2.2e-4 / 5.1e-3
#     (pna) and medians 0.127·lr and 0.156·lr: losses 1e-3 at step 1 and
#     4e-2 after, medians 0.25·lr (a skipped step moves them by ~lr).
# The start's outputs (logits, MCM outputs, ratings) within BF16_OUT_TOL of
# the largest entry past 1: every part within 1.2e-4 on the CPU but the text
# LM's (1.0e-2: its 64-token rows' outputs, rounded to bf16 after float32
# sums in another order than the Pallas kernel's, flip by one bf16 step
# here and there, which the float32 regressor above them carries on); the
# card's kernels sum in yet another order.
LOSS_RTOL = (1e-4, 1e-3)
MOCO_LOSS_RTOL = (1e-4, 1e-2)
PARAM_MAX_LR, PARAM_MEDIAN_LR, BN_MOMENTUM = 6.05, 0.05, 0.9
BF16_LOSS_RTOL, BF16_PARAM_MEDIAN_LR = (1e-3, 3e-3), 0.1
CPNA_LOSS_RTOL, CPNA_PARAM_MEDIAN_LR, CPNA_STAT_SCALE = (1e-4, 1e-2), 0.15, 4
CPNA_MODELS = ("cpna", "cpnatab")
BF16_CPNA_LOSS_RTOL, BF16_CPNA_PARAM_MEDIAN_LR = (1e-3, 1e-2), 0.15
BF16_SUMS_LOSS_RTOL, BF16_SUMS_PARAM_MEDIAN_LR, BF16_SUMS_STAT_SCALE = (
    5e-3, 6e-2), 1.0, 4
BF16_MSG_LOSS_RTOL, BF16_MSG_PARAM_MEDIAN_LR = (1e-3, 4e-2), 0.25
BF16_OUT_TOL = 2e-2
#: a pretraining step's loss and its terms (those of its mode)
LOSS_TERMS = ("loss", "lp", "mcm_cat", "mcm_num")


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


def from_jax_checkpoint(ck_dir: str) -> dict[str, torch.Tensor]:
    """A checkpoint directory of the JAX package (its ``params`` components
    and ``extras``' ``batch_stats``, read by
    ``utils/jax_checkpoint.read_checkpoint``) → ``state_dict`` entries. The
    statistics keep the layout of ``extras``: a pretrainer's have no
    ``model.`` prefix."""
    from .utils.jax_checkpoint import read_checkpoint

    tree = read_checkpoint(ck_dir)
    return from_jax({k: tree[k] for k in ("params", "batch_stats")
                     if k in tree})


def to_jax_layout(state: dict, jax_key: str) -> np.ndarray:
    """The ``state_dict`` entry of a flat JAX variable path, as a numpy
    array in the JAX leaf's layout."""
    name, transpose = torch_key(jax_key)
    arr = state[name].detach().cpu().numpy()
    return arr.T if transpose else arr


def pretrain_variables(params: dict, batch_stats: dict) -> dict:
    """The JAX pretrainer's ``params`` (``encoder``, ``model``,
    ``mcm_head``, ``lp_head``) and its model's ``batch_stats`` → variables
    in the module layout of ``rmm_tpu_torch.train.pretrain.PretrainModel``
    (the encoder under ``edge_encoder``, as the JAX SSL checkpoint names
    it)."""
    return {"params": {"edge_encoder": params["encoder"]["params"],
                       "model": params["model"],
                       "mcm_head": params["mcm_head"]["params"],
                       "lp_head": params["lp_head"]["params"]},
            "batch_stats": {"model": batch_stats}}


def tabular_variables(params: dict) -> dict:
    """The JAX tabular trainer's ``params`` (``encoder``, ``model``,
    ``head``, each a flax variable dict) → variables in the module layout
    of ``rmm_tpu_torch.train.tabular.TabularMCMModel`` (the encoder under
    ``edge_encoder``, as the JAX tabular checkpoint names it)."""
    return {"params": {"edge_encoder": params["encoder"]["params"],
                       "model": params["model"]["params"],
                       "head": params["head"]["params"]}}


def text_variables(params: dict) -> dict:
    """The JAX text trainer's ``params`` (``encoder``, ``model``, ``head``,
    each a flax variable dict; the LM of the finetune path inside the
    encoder as ``text_model``) → variables in the module layout of
    ``rmm_tpu_torch.train.downstream_text.TextTabularModel``."""
    return {"params": {k: params[k]["params"]
                       for k in ("encoder", "model", "head")}}


def finetune_llm_variables(params: dict) -> dict:
    """``cli/finetune_llm.py``'s ``params`` (``encoder``, the LM's flax
    variables, and ``head``, ``{"w", "b"}``) → variables in the layout of
    ``rmm_tpu_torch.cli.finetune_llm.LLMRegressor``."""
    return {"params": {"encoder": params["encoder"]["params"],
                       "head": params["head"]}}


def random_variables(shapes: dict, seed: int) -> dict[str, np.ndarray]:
    """Seeded float32 values for flat variable paths (``{"params/a/b":
    shape}``), one ``RandomState(seed + i)`` for the i-th path in sorted
    order, so that a wrong mapping cannot hide behind a zero or one: 2-D
    kernels std ``1/√shape[0]``, 3-D ones ``1/√shape[1]``, other
    parameters std 0.1 (norm scales around 1), BatchNorm means std 0.3 and
    variances in [0.5, 2)."""
    out = {}
    for i, path in enumerate(sorted(shapes)):
        shape = tuple(int(d) for d in shapes[path])
        rng = np.random.RandomState(seed + i)
        collection, name = path.split("/")[0], path.split("/")[-1]
        if collection == "batch_stats":
            val = (rng.uniform(0.5, 2.0, shape) if name == "var"
                   else rng.randn(*shape) * 0.3)
        elif name == "scale":
            val = 1.0 + 0.1 * rng.randn(*shape)
        else:
            std = 0.1
            if len(shape) == 2:
                std = 1.0 / np.sqrt(shape[0])
            elif len(shape) == 3:
                std = 1.0 / np.sqrt(shape[1])
            val = rng.randn(*shape) * std
        out[path] = np.asarray(val, np.float32)
    return out


def loss_terms(loss, sums: dict) -> dict[str, float]:
    """A pretraining step's loss and its terms, from the loss and the
    step's sums (``lp``; ``loss_c``, ``t_c``, ``loss_n`` and ``t_n`` under
    MCM): the LP loss, the MCM categorical cross-entropy and the MCM
    numerical √MSE, each where the mode has it."""
    out = {"loss": float(loss)}
    if "lp" in sums:
        out["lp"] = float(sums["lp"])
    if "loss_c" in sums:
        out["mcm_cat"] = float(sums["loss_c"]) / max(float(sums["t_c"]), 1.0)
        out["mcm_num"] = math.sqrt(float(sums["loss_n"])
                                   / max(float(sums["t_n"]), 1.0))
    return out


def record_errors(state: dict, record, prefix: str) -> dict[str, tuple]:
    """A ``state_dict`` against a JAX parity record (as
    ``tools/make_torch_port_ssl_fixture.py`` writes it): for each recorded
    variable, by its ``state_dict`` key, (the absolute errors of the sampled
    entries that ``<prefix>idx/<path>`` picks, the error of the variable's
    norm, that of its sum, its entry count)."""
    out = {}
    for key in record.files:
        if not key.startswith(prefix + "idx/"):
            continue
        path = key[len(prefix) + 4:]
        arr = to_jax_layout(state, path).astype(np.float64)
        got = arr.reshape(-1)[record[key]]
        out[torch_key(path)[0]] = (
            np.abs(got - record[f"{prefix}val/{path}"]),
            abs(float(np.linalg.norm(arr))
                - float(record[f"{prefix}norm/{path}"])),
            abs(float(arr.sum()) - float(record[f"{prefix}sum/{path}"])),
            arr.size)
    return out


#: the arrays a record keeps of each sampled variable
SAMPLED = ("idx", "val", "sum", "norm")
_SAMPLED_KEY = re.compile(
    r"^(.*?)(idx|val|sum|norm)/((?:params|batch_stats)/.*)$")


class Record(dict):
    """A parity record in memory: its arrays by key, and the keys as
    ``np.load``'s ``files`` (what :func:`check_record` reads)."""

    @property
    def files(self) -> list[str]:
        return list(self)


def pack_record(arrays: dict) -> dict:
    """The layout every parity record is saved in: its sampled variables
    (``<prefix>idx|val|sum|norm/<path>``, ``<path>`` under ``params/`` or
    ``batch_stats/``) packed a prefix at a time into
    ``<prefix>packed/keys``, ``count`` (entries a variable), ``idx``,
    ``val``, ``sum`` and ``norm``: each npz member costs about 200 bytes
    of zip headers, which a record of many runs and variables would spend
    mostly on them. Every other array stays as it is."""
    out, groups = {}, {}
    for key, arr in arrays.items():
        m = _SAMPLED_KEY.match(key)
        if m is None:
            out[key] = arr
            continue
        prefix, kind, path = m.groups()
        groups.setdefault(prefix, {}).setdefault(path, {})[kind] = arr
    for prefix, paths in groups.items():
        keys = sorted(paths)
        out[f"{prefix}packed/keys"] = np.asarray(keys)
        out[f"{prefix}packed/count"] = np.asarray(
            [len(paths[k]["idx"]) for k in keys], np.int32)
        for kind in SAMPLED:
            out[f"{prefix}packed/{kind}"] = np.concatenate(
                [np.atleast_1d(paths[k][kind]) for k in keys])
    return out


def unpack_record(record) -> Record:
    """:func:`pack_record`'s inverse, on a loaded npz."""
    out = Record()
    for key in record.files:
        if "packed/" not in key:
            out[key] = record[key]
    for key in record.files:
        if not key.endswith("packed/keys"):
            continue
        prefix = key[:-len("packed/keys")]
        keys = [str(k) for k in record[key]]
        ends = np.cumsum(record[f"{prefix}packed/count"])[:-1]
        idx = np.split(record[f"{prefix}packed/idx"], ends)
        val = np.split(record[f"{prefix}packed/val"], ends)
        sums = record[f"{prefix}packed/sum"]
        norms = record[f"{prefix}packed/norm"]
        for i, path in enumerate(keys):
            out[f"{prefix}idx/{path}"] = idx[i]
            out[f"{prefix}val/{path}"] = val[i]
            out[f"{prefix}sum/{path}"] = np.asarray(sums[i])
            out[f"{prefix}norm/{path}"] = np.asarray(norms[i])
    return out


def load_record(path: str) -> Record:
    """A parity record from its file (:func:`pack_record`'s layout)."""
    with np.load(path) as f:
        return unpack_record(f)


def _loss_faults(terms: Sequence[dict], want: dict[str, Sequence[float]],
                 rtol: Sequence[float]) -> tuple[list[str], dict]:
    faults, rel = [], {}
    if not terms or set(terms[0]) != set(want):
        faults.append(f"loss terms {sorted(terms[0]) if terms else []} vs "
                      f"the reference's {sorted(want)}")
    for name, ref in want.items():
        got = [t.get(name, math.nan) for t in terms]
        rel[name] = [abs(a - b) / max(abs(b), 1e-30)
                     for a, b in zip(got, ref)]
        if len(got) != len(ref) or rel[name][0] > rtol[0] or max(
                rel[name]) > rtol[1]:
            faults.append(f"loss term {name}: {got} vs {list(ref)} "
                          f"(relative tolerance {list(rtol)})")
    return faults, {"loss_rel_err": rel, "loss_rtol": list(rtol)}


def _state_faults(errors: dict[str, tuple], lr: float, updates: int,
                  nhidden: int, median_lr: float = PARAM_MEDIAN_LR,
                  stat_scale: float = 1.0) -> tuple[list[str], dict]:
    param_tol = PARAM_MAX_LR * lr
    stat_tol = (stat_scale * (1 - BN_MOMENTUM) * updates * nhidden
                * param_tol)
    faults, worst, parts = [], {"param": 0.0, "stat": 0.0}, {}
    for key, (err, norm_err, sum_err, size) in errors.items():
        kind = ("stat" if key.endswith(tuple(_STAT_NAMES.values()))
                else "param")
        tol = stat_tol if kind == "stat" else param_tol
        worst[kind] = max(worst[kind], float(err.max()))
        if (err.max() > tol or norm_err > tol * math.sqrt(size)
                or sum_err > tol * size):
            faults.append(f"{key}: off by {float(err.max())} (norm "
                          f"{norm_err}, sum {sum_err}; tolerance {tol})")
        if kind == "param":
            parts.setdefault(key.split(".")[0], []).append(err)
    medians = {c: float(np.median(np.concatenate(e)))
               for c, e in parts.items()}
    faults += [f"median parameter error of {c}: {m} > {median_lr * lr}"
               for c, m in medians.items() if m > median_lr * lr]
    return faults, {"param_max_abs_err": worst["param"],
                    "param_tol": param_tol,
                    "param_median_abs_err": medians,
                    "param_median_tol": median_lr * lr,
                    "bn_stat_max_abs_err": worst["stat"],
                    "bn_stat_tol": stat_tol,
                    "compared_entries": int(sum(e[0].size
                                                for e in errors.values()))}


def check_record(state: dict, terms: Sequence[dict], record, prefix: str,
                 lr: float, updates: int, nhidden: int,
                 precision: str = "f32", model: str = "",
                 messages: str = "f32") -> tuple[list[str], dict]:
    """Three training steps against a JAX parity record: ``terms`` the
    :func:`loss_terms` of each step, ``state`` the ``state_dict`` after
    them, ``updates`` the BatchNorm updates they made, at the limits of
    ``precision`` (a bf16 record's are wider, above), ``model`` (those of
    ``CPNA_MODELS`` are wider, above; ``"moco"``'s loss terms too) and,
    under bf16, ``messages``: ``"bf16"`` for a run whose bf16 messages both
    sides sum in float32, ``"bf16-sums"`` for one whose reference sums
    them in bf16 (above). Returns (the faults, empty when everything
    holds; the errors beside their limits)."""
    loss_rtol, median_lr, stat_scale = LOSS_RTOL, PARAM_MEDIAN_LR, 1.0
    if precision == "bf16":
        loss_rtol, median_lr = BF16_LOSS_RTOL, BF16_PARAM_MEDIAN_LR
        if model in CPNA_MODELS:
            loss_rtol, median_lr, stat_scale = (
                BF16_CPNA_LOSS_RTOL, BF16_CPNA_PARAM_MEDIAN_LR,
                CPNA_STAT_SCALE)
        if messages == "bf16":
            loss_rtol, median_lr = BF16_MSG_LOSS_RTOL, max(
                median_lr, BF16_MSG_PARAM_MEDIAN_LR)
        elif messages == "bf16-sums":
            loss_rtol, median_lr, stat_scale = (
                BF16_SUMS_LOSS_RTOL, BF16_SUMS_PARAM_MEDIAN_LR,
                BF16_SUMS_STAT_SCALE)
    elif model in CPNA_MODELS:
        loss_rtol, median_lr, stat_scale = (
            CPNA_LOSS_RTOL, CPNA_PARAM_MEDIAN_LR, CPNA_STAT_SCALE)
    elif model == "moco":
        loss_rtol = MOCO_LOSS_RTOL
    want = {k: record[f"{prefix}term/{k}"] for k in LOSS_TERMS
            if f"{prefix}term/{k}" in record.files}
    errors = record_errors(state, record, prefix)
    faults = ([] if set(errors) == set(state) else
              ["the record and the model hold other variables"])
    f1, s1 = _loss_faults(terms, want, loss_rtol)
    f2, s2 = _state_faults(errors, lr, updates, nhidden, median_lr,
                           stat_scale)
    return faults + f1 + f2, {**s1, **s2}


def check_states(state: dict, terms: Sequence[dict], ref_state: dict,
                 ref_terms: Sequence[dict], lr: float, updates: int,
                 nhidden: int, loss_rtol: Sequence[float] = LOSS_RTOL
                 ) -> tuple[list[str], dict]:
    """:func:`check_record` against a second run's ``state_dict`` and
    terms, every entry compared."""
    errors = {}
    for k, ref in ref_state.items():
        a = state[k].detach().cpu().double().numpy()
        b = ref.detach().cpu().double().numpy()
        errors[k] = (np.abs(a - b).reshape(-1),
                     abs(float(np.linalg.norm(a)) - float(np.linalg.norm(b))),
                     abs(float(a.sum()) - float(b.sum())), a.size)
    f1, s1 = _loss_faults(terms, {k: [t[k] for t in ref_terms]
                                  for k in ref_terms[0]}, loss_rtol)
    f2, s2 = _state_faults(errors, lr, updates, nhidden)
    return f1 + f2, {**s1, **s2}
