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
"""
from __future__ import annotations

import json
import logging
import os
import shutil
from typing import Optional, Union

import torch

CKPT_FORMAT = 1


def save_checkpoint(ck_dir: str, state_dict: dict,
                    meta: Optional[dict] = None) -> str:
    os.makedirs(ck_dir, exist_ok=True)
    torch.save({k: v.detach().cpu() for k, v in state_dict.items()},
               os.path.join(ck_dir, "model.pt"))
    with open(os.path.join(ck_dir, "meta.json"), "w") as f:
        json.dump({"format": "rmm_tpu_torch", "ckpt_format": CKPT_FORMAT,
                   **(meta or {})}, f, indent=1)
    return ck_dir


def load_checkpoint(ck_dir: str, model: torch.nn.Module) -> dict:
    """Load ``ck_dir`` into ``model`` (strict); returns the meta dict."""
    with open(os.path.join(ck_dir, "meta.json")) as f:
        meta = json.load(f)
    if meta.get("format") != "rmm_tpu_torch":
        raise ValueError(f"{ck_dir} is not an rmm_tpu_torch checkpoint")
    state = torch.load(os.path.join(ck_dir, "model.pt"), map_location="cpu",
                       weights_only=True)
    model.load_state_dict(state, strict=True)
    return meta


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
