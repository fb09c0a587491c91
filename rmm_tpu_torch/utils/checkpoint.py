"""The port's checkpoint: a directory holding ``model.pt`` (the module's
``state_dict``, BatchNorm running stats included) and ``meta.json``.

Serving loads with ``strict=True``: a missing, extra or mis-shaped entry
raises, so a model never serves with weights left at their initialization.

Training writes one such directory per epoch, ``<run_dir>/<epoch>/``
(``rmm_tpu/utils/checkpoint.py``'s layout), adding ``optimizer.pt`` (the
Adam state) and ``best_m.json``; the previous epoch's directory is pruned,
and ``<run_dir>/-1/`` holds the best model under ``--save_model``. Every one
of them serves through ``cli/predict.py`` as it is.

SSL pretraining (``train/pretrain.py``) writes the same per-epoch
directories for its ``PretrainModel`` (encoder, backbone, MCM and LP heads,
BatchNorm statistics; AdamW in ``optimizer.pt``), with ``best_m.json``
holding the best accuracy, RMSE and MRR, and a weights-only snapshot
``best_acc``, ``best_rmse`` or ``best_mrr`` for each metric that improved.

:func:`load_components` loads either package's checkpoint into a module the
way ``rmm_tpu/utils/checkpoint.py::load_components`` does: the port's
directory (its ``meta.json`` says ``"format": "rmm_tpu_torch"``) or the JAX
package's (``utils/jax_checkpoint.py``), grafting by name where the shapes
match: the SSL → supervised transfer. :func:`load_strict` loads every
entry or raises, for resuming and serving either package's checkpoint.
"""
from __future__ import annotations

import json
import logging
import os
import shutil
from typing import Optional, Union

import torch

CKPT_FORMAT = 1
PORT_FORMAT = "rmm_tpu_torch"
#: the components of a pretrainer's checkpoint that no task model has
PRETRAIN_HEADS = ("mcm_head", "lp_head")
_STATS = (".running_mean", ".running_var")


def save_checkpoint(ck_dir: str, state_dict: dict,
                    meta: Optional[dict] = None) -> str:
    os.makedirs(ck_dir, exist_ok=True)
    torch.save({k: v.detach().cpu() for k, v in state_dict.items()},
               os.path.join(ck_dir, "model.pt"))
    with open(os.path.join(ck_dir, "meta.json"), "w") as f:
        json.dump({"format": PORT_FORMAT, "ckpt_format": CKPT_FORMAT,
                   **(meta or {})}, f, indent=1)
    return ck_dir


def load_checkpoint(ck_dir: str, model: torch.nn.Module) -> dict:
    """Load ``ck_dir`` into ``model`` (strict); returns the meta dict."""
    with open(os.path.join(ck_dir, "meta.json")) as f:
        meta = json.load(f)
    if meta.get("format") != PORT_FORMAT:
        raise ValueError(f"{ck_dir} is not an rmm_tpu_torch checkpoint")
    state = torch.load(os.path.join(ck_dir, "model.pt"), map_location="cpu",
                       weights_only=True)
    model.load_state_dict(state, strict=True)
    return meta


def is_port_checkpoint(ck_dir: str) -> bool:
    """The two layouts apart by ``meta.json``: the port's says ``"format":
    "rmm_tpu_torch"``, the JAX package's does not."""
    try:
        with open(os.path.join(ck_dir, "meta.json")) as f:
            return json.load(f).get("format") == PORT_FORMAT
    except (OSError, ValueError):
        return False


def read_state(ck_dir: str) -> dict[str, torch.Tensor]:
    """A checkpoint of either package → its entries by the port's
    ``state_dict`` keys, on the CPU. A pretrainer's BatchNorm statistics
    lose their ``model.`` prefix, as the JAX pretrainer's ``extras`` hold
    them (``rmm_tpu/train/pretrain.py:579-586``)."""
    if not is_port_checkpoint(ck_dir):
        from ..convert import from_jax_checkpoint

        return from_jax_checkpoint(ck_dir)
    state = torch.load(os.path.join(ck_dir, "model.pt"), map_location="cpu",
                       weights_only=True)
    pretrainer = any(k.split(".")[0] in PRETRAIN_HEADS for k in state)
    return {extras_key(k, pretrainer) if k.endswith(_STATS) else k: v
            for k, v in state.items()}


def extras_key(key: str, pretrainer: bool) -> str:
    """A BatchNorm statistic's key in the layout of the JAX checkpoint's
    ``extras``: a task model's under its component (``model.``), a
    pretrainer's without it."""
    if pretrainer and key.startswith("model."):
        return key[len("model."):]
    return key


def _report(ck_dir: str, what: str, failures: list[str], total: int,
            on_mismatch: str, statistics: bool) -> None:
    if not failures:
        return
    detail = "; ".join(failures[:10])
    if len(failures) > 10:
        detail += f"; … (+{len(failures) - 10} more)"
    msg = (f"checkpoint {ck_dir}/{what}: {len(failures)}/{total} leaves kept "
           f"their FRESH INIT (not loaded): {detail}")
    if on_mismatch == "raise":
        raise ValueError(msg)
    if len(failures) >= total and not statistics:
        logging.error("%s — the whole component fell back to fresh init; "
                      "outputs will be garbage", msg)
    else:
        logging.warning(msg)


def load_components(ck_dir: str, model: torch.nn.Module,
                    components: Optional[list] = None,
                    on_mismatch: str = "warn") -> dict[str, list[str]]:
    """``rmm_tpu/utils/checkpoint.py::load_components`` on a module: load
    the parameters of ``components`` (top-level prefixes of the
    ``state_dict``: ``node_encoder``, ``edge_encoder``, ``model``,
    ``decoder``; all of the module's when None) from a checkpoint of either
    package, and the BatchNorm statistics whatever ``components`` says (the
    reference's ``extras``), each leaf by name where the shapes match
    (``strict=False``). Every other leaf keeps its value and is reported:
    a component absent from the checkpoint with a warning, a component of
    which no leaf loaded with an error. ``on_mismatch="raise"`` raises
    instead (FileNotFoundError for an absent component, ValueError for a
    leaf; statistics included, where the reference only warns).

    The statistics are matched in the ``extras`` layout (:func:`extras_key`),
    so a pretrainer's, saved without their ``model.`` prefix by the JAX
    pretrainer and by :func:`read_state` for the port's, graft into no task
    model, as in the reference. Returns the ``state_dict`` keys
    ``grafted`` and those ``kept`` at their values (every other one)."""
    src = read_state(ck_dir)
    target = model.state_dict()
    names = [k for k, _ in model.named_parameters()]
    params = set(names)
    comps = list(dict.fromkeys(k.split(".")[0] for k in names))
    present = {k.split(".")[0] for k in src}
    pretrainer = any(c in PRETRAIN_HEADS for c in comps)
    grafted: dict[str, torch.Tensor] = {}

    def graft(key: str, src_key: str, failures: list[str]) -> None:
        if src_key not in src:
            failures.append(f"{key}: missing from checkpoint")
        elif tuple(src[src_key].shape) != tuple(target[key].shape):
            failures.append(f"{key}: shape mismatch (checkpoint "
                            f"{tuple(src[src_key].shape)} vs model "
                            f"{tuple(target[key].shape)})")
        else:
            grafted[key] = src[src_key]

    for comp in components or comps:
        if comp not in comps:
            continue
        leaves = [k for k in names if k.split(".")[0] == comp]
        if comp not in present:
            msg = (f"checkpoint {ck_dir} has no '{comp}' component — it "
                   "keeps its FRESH INIT")
            if on_mismatch == "raise":
                raise FileNotFoundError(msg)
            logging.warning(msg)
            continue
        failures: list[str] = []
        for key in leaves:
            graft(key, key, failures)
        _report(ck_dir, comp, failures, len(leaves), on_mismatch, False)
    stats = [k for k in target if k not in params]
    failures = []
    for key in stats:
        graft(key, extras_key(key, pretrainer), failures)
    _report(ck_dir, "extras", failures, len(stats), on_mismatch, True)
    model.load_state_dict({**target, **grafted}, strict=True)
    return {"grafted": [k for k in target if k in grafted],
            "kept": [k for k in target if k not in grafted]}


def load_strict(ck_dir: str, model: torch.nn.Module) -> None:
    """Every entry of ``model`` from a checkpoint of either package, or
    raise (resume and serving never run on weights left at their
    initialization): the port's by :func:`load_checkpoint`, the JAX
    package's by :func:`load_components` with ``on_mismatch="raise"``."""
    if is_port_checkpoint(ck_dir):
        load_checkpoint(ck_dir, model)
    else:
        load_components(ck_dir, model, on_mismatch="raise")


def resume(ck_dir: str, model: torch.nn.Module,
           optimizer: Optional[torch.optim.Optimizer], device) -> dict:
    """A trainer's resume: every entry of ``model`` from a checkpoint of
    either package (:func:`load_strict`) and, given an ``optimizer``, its
    state from the port's ``optimizer.pt`` (the JAX package's ``opt_state``
    is not read: a warning says the optimizer starts afresh). → the
    checkpoint's ``best_m`` dict, empty when it has none."""
    load_strict(ck_dir, model)
    if not is_port_checkpoint(ck_dir):
        logging.warning("%s is a JAX checkpoint: its optimizer state is not "
                        "read, AdamW starts afresh", ck_dir)
    opt = os.path.join(ck_dir, "optimizer.pt")
    if optimizer is not None and os.path.exists(opt):
        optimizer.load_state_dict(torch.load(opt, map_location=device,
                                             weights_only=True))
    if os.path.exists(os.path.join(ck_dir, "best_m.json")):
        return load_best_m(ck_dir)
    return {}


def save_epoch(run_dir: str, epoch: Union[int, str], model: torch.nn.Module,
               optimizer: Optional[torch.optim.Optimizer] = None,
               best_m: Union[float, dict, None] = None,
               prune_previous: bool = True, precision: str = "f32") -> str:
    """``<run_dir>/<epoch>/`` (or a ``best_*`` tag): the model, the
    optimizer state (when given) and ``best_m`` (a value, or the SSL
    metrics' dict); prunes ``<run_dir>/<epoch - 1>/``. The weights are the
    float32 masters whatever ``precision`` trained them; the meta says
    which."""
    ck = save_checkpoint(os.path.join(run_dir, str(epoch)),
                         model.state_dict(),
                         {"epoch": epoch, "precision": precision})
    if optimizer is not None:
        torch.save(optimizer.state_dict(), os.path.join(ck, "optimizer.pt"))
    if best_m is not None:
        with open(os.path.join(ck, "best_m.json"), "w") as f:
            json.dump({"best_m": best_m}, f)
    if prune_previous and epoch > 0:
        shutil.rmtree(os.path.join(run_dir, str(epoch - 1)),
                      ignore_errors=True)
    return ck


def load_best_m(ck_dir: str) -> Union[float, dict]:
    with open(os.path.join(ck_dir, "best_m.json")) as f:
        return json.load(f)["best_m"]


def parse_checkpoint_path(path: str) -> tuple[str, int]:
    """``<run_dir>/<epoch>/`` → (run id, epoch). A ``best_*`` tag resumes
    at epoch 0; any other tag that is not an integer raises."""
    parts = [p for p in path.rstrip("/").split(os.sep) if p]
    tag = parts[-1]
    run_id = parts[-2] if len(parts) > 1 else ""
    try:
        epoch = int(tag)
    except ValueError:
        if not tag.startswith("best_"):
            raise ValueError(
                f"checkpoint path must end in an epoch number or a best_* "
                f"tag, got {tag!r}") from None
        logging.warning("checkpoint %s is a weights-only best-metric "
                        "export; resuming from epoch 0", path)
        epoch = 0
    return run_id, epoch
