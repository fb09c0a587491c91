"""The port's checkpoint: a directory holding ``model.pt`` (the module's
``state_dict``, BatchNorm running stats included) and ``meta.json``.

Serving loads with ``strict=True``: a missing, extra or mis-shaped entry
raises, so a model never serves with weights left at their initialization.
"""
from __future__ import annotations

import json
import os
from typing import Optional

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
