"""Per-stype feature encoders and the stype-wise dispatcher.

Counterparts of ``rmm_tpu/nn/encoders.py`` for the stypes of the AML path
and of the text columns. Parameter names and layouts follow the JAX
modules (``embedding_{i}``, ``weight [n, ...]``, ``bias [n, C]``) so
converted weights load unchanged; column statistics are non-persistent
buffers (configuration, not state).
"""
from __future__ import annotations

import math
from typing import Any, Optional, Sequence

import torch
from torch import nn

from ..frame.stats import StatType
from ..frame.stype import STYPE_ORDER, Stype
from ..frame.tensor_frame import TensorFrame
from ..utils.precision import promote


class EmbeddingEncoder(nn.Module):
    """Categorical columns → one embedding table per column; code −1
    (missing) maps to row 0 through ``clip(x + 1, 0, card)``. Rows are
    looked up with ``F.embedding``, whose backward sums the many repeats of
    a code (a handful of codes over 131,072 lanes) by sorting, where the
    backward of ``table[idx]`` walks each run of repeats in one thread."""

    def __init__(self, channels: int, cardinalities: Sequence[int]):
        super().__init__()
        self.cardinalities = tuple(int(c) for c in cardinalities)
        for i, card in enumerate(self.cardinalities):
            self.register_parameter(
                f"embedding_{i}",
                nn.Parameter(torch.empty(card + 1, channels)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:   # [B, n_cat] int
        outs = []
        for i, card in enumerate(self.cardinalities):
            idx = torch.clamp(x[:, i].long() + 1, 0, card)
            outs.append(nn.functional.embedding(
                idx, getattr(self, f"embedding_{i}")))
        return torch.stack(outs, dim=1)                   # [B, n_cat, C]


class LinearEncoder(nn.Module):
    """Numerical columns → ``((x − mean)/std)·w + b`` per column; std is
    clamped at 1e-6 and the z-score passes through ``nan_to_num``."""

    def __init__(self, channels: int, means: Sequence[float],
                 stds: Sequence[float]):
        super().__init__()
        n = len(means)
        self.register_buffer("means", torch.tensor(means, dtype=torch.float32),
                             persistent=False)
        self.register_buffer("stds", torch.tensor(stds, dtype=torch.float32),
                             persistent=False)
        self.weight = nn.Parameter(torch.empty(n, channels))
        self.bias = nn.Parameter(torch.empty(n, channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:   # [B, n_num] float
        # the statistics in x's dtype, as the JAX encoder takes them
        means, stds = self.means.to(x.dtype), self.stds.to(x.dtype)
        xn = (x - means) / torch.clamp(stds, min=1e-6)
        xn = torch.nan_to_num(xn)
        return xn[:, :, None] * self.weight[None] + self.bias[None]


def _mod(x: torch.Tensor, y: float) -> torch.Tensor:
    """Floating remainder with the sign of ``y`` (``jnp.mod``), through the
    exact ``fmod``."""
    r = torch.fmod(x, y)
    return torch.where((r != 0) & ((r < 0) != (y < 0)), r + y, r)


def timestamp_cyclic_features(ts: torch.Tensor) -> torch.Tensor:
    """Unix seconds [B, n_ts] → [B, n_ts, 10]: sin/cos of second-of-day,
    day-of-week, day-of-month and month-of-year, a linear day index and a
    constant. The cast to float32 comes first, as in the JAX encoder."""
    ts = ts.to(torch.float32)
    day = ts / 86400.0
    sod = _mod(ts, 86400.0) / 86400.0
    dow = _mod(day + 4.0, 7.0) / 7.0          # 1970-01-01 was a Thursday
    dom = _mod(day, 30.4375) / 30.4375
    moy = _mod(day, 365.2425) / 365.2425
    day_lin = ts / (86400.0 * 365.2425 * 60.0)
    two_pi = 2.0 * math.pi
    feats = [torch.sin(two_pi * sod), torch.cos(two_pi * sod),
             torch.sin(two_pi * dow), torch.cos(two_pi * dow),
             torch.sin(two_pi * dom), torch.cos(two_pi * dom),
             torch.sin(two_pi * moy), torch.cos(two_pi * moy),
             day_lin, torch.ones_like(day_lin)]
    return torch.stack(feats, dim=-1)


class TimestampEncoder(nn.Module):
    def __init__(self, channels: int, num_cols: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(num_cols, 10, channels))
        self.bias = nn.Parameter(torch.empty(num_cols, channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:   # [B, n_ts] int64
        # the features stay float32 whatever the parameters' dtype, so
        # under bf16 the block (and the tokens it joins) is float32, as in
        # the reference
        feats, w, b = promote(timestamp_cyclic_features(x), self.weight,
                              self.bias)
        return torch.einsum("btf,tfc->btc", feats, w) + b[None]


class ProjectionEncoder(nn.Module):
    """Relation/id columns → per-column affine lift."""

    def __init__(self, channels: int, num_cols: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(num_cols, channels))
        self.bias = nn.Parameter(torch.empty(num_cols, channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:   # [B, n_rel] float
        return x[:, :, None] * self.weight[None] + self.bias[None]


class LinearEmbeddingEncoder(nn.Module):
    """Precomputed text vectors ``[B, n, emb_dim]`` → a linear map a column
    (``weight [n, emb_dim, C]``, ``bias [n, C]``): the frozen-embedder
    path."""

    def __init__(self, channels: int, emb_dim: int, num_cols: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(num_cols, emb_dim, channels))
        self.bias = nn.Parameter(torch.empty(num_cols, channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.einsum("bne,nec->bnc", x, self.weight) + self.bias[None]


class LinearModelEncoder(nn.Module):
    """Token ids ``[B, n, L]`` → for each of the n columns, one call of the
    text model (token ids ``[B, L]`` → ``[B, model_dim]``) and a linear map
    (``weight [n, model_dim, C]``, ``bias [n, C]``): the finetune path.
    The text model is one module shared by every column; it is the
    dispatcher's ``text_model`` and is passed to :meth:`forward`, so its
    parameters sit there once, as in the JAX encoder."""

    def __init__(self, channels: int, num_cols: int, model_dim: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(num_cols, model_dim,
                                               channels))
        self.bias = nn.Parameter(torch.empty(num_cols, channels))

    def forward(self, x: torch.Tensor, text_model: nn.Module) -> torch.Tensor:
        return torch.stack([text_model(x[:, i]) @ self.weight[i]
                            + self.bias[i] for i in range(x.shape[1])],
                           dim=1)


class StypeWiseFeatureEncoder(nn.Module):
    """Encode each stype block, concatenate to ``[B, num_cols, C]`` in
    ``STYPE_ORDER``. Build it with :func:`make_stypewise_encoder`.
    ``text_model`` (a module of its own, ``text_model``) reads the
    ``text_tokenized`` columns."""

    def __init__(self, channels: int, col_names: dict, col_config: dict,
                 text_model: Optional[nn.Module] = None):
        super().__init__()
        self.col_names = {st: tuple(v) for st, v in col_names.items()}
        self.stypes = [st for st in STYPE_ORDER if st in self.col_names]
        if Stype.text_tokenized in self.col_names and text_model is None:
            raise ValueError("text_tokenized columns need a text model")
        self.text_model = text_model
        for st in self.stypes:
            cfg = col_config.get(st, {})
            n = len(self.col_names[st])
            if st == Stype.numerical:
                enc = LinearEncoder(channels, cfg["means"], cfg["stds"])
            elif st == Stype.categorical:
                enc = EmbeddingEncoder(channels, cfg["cardinalities"])
            elif st == Stype.timestamp:
                enc = TimestampEncoder(channels, n)
            elif st == Stype.text_embedded:
                enc = LinearEmbeddingEncoder(channels, cfg["emb_dim"], n)
            elif st == Stype.text_tokenized:
                enc = LinearModelEncoder(channels, n, cfg["model_dim"])
            else:
                enc = ProjectionEncoder(channels, cfg.get("width", n))
            self.add_module(st.name, enc)

    @property
    def num_cols(self) -> int:
        return sum(len(v) for v in self.col_names.values())

    def forward(self, tf: TensorFrame) -> torch.Tensor:
        blocks = []
        for st in self.stypes:
            if st not in tf.feats:
                continue
            enc = getattr(self, st.name)
            blocks.append(enc(tf.feats[st], self.text_model)
                          if st == Stype.text_tokenized
                          else enc(tf.feats[st]))
        return torch.cat(blocks, dim=1)


def stype_encoder_config(dataset) -> tuple[dict, dict[Stype, dict[str, Any]]]:
    """(col_names, col_config) of a materialized Dataset."""
    tf = dataset.tensor_frame
    col_names = {st: tuple(cols) for st, cols in tf.col_names.items()}
    col_config: dict[Stype, dict[str, Any]] = {}
    for st, cols in tf.col_names.items():
        if st == Stype.numerical:
            col_config[st] = {
                "means": tuple(dataset.col_stats[c][StatType.MEAN]
                               for c in cols),
                "stds": tuple(dataset.col_stats[c][StatType.STD]
                              for c in cols)}
        elif st == Stype.categorical:
            col_config[st] = {"cardinalities": tuple(
                len(dataset.col_stats[c][StatType.COUNT][0]) for c in cols)}
        elif st == Stype.relation:
            col_config[st] = {"width": int(tf.feats[st].shape[1])}
        elif st == Stype.text_embedded:
            col_config[st] = {"emb_dim": int(tf.feats[st].shape[-1])}
        elif st == Stype.text_tokenized:
            col_config[st] = {"model_dim": 0}   # the text model's width
    return col_names, col_config


def make_stypewise_encoder(dataset, channels: int,
                           text_model: Optional[nn.Module] = None,
                           model_dim: int = 0) -> StypeWiseFeatureEncoder:
    """The dispatcher of a materialized Dataset; ``text_model`` (its output
    ``model_dim`` wide) reads the ``text_tokenized`` columns."""
    col_names, col_config = stype_encoder_config(dataset)
    if Stype.text_tokenized in col_config:
        col_config[Stype.text_tokenized]["model_dim"] = model_dim
    return StypeWiseFeatureEncoder(channels, col_names, col_config,
                                   text_model)
