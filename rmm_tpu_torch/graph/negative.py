"""Negative edge sampling for link prediction (C++ engine,
``rmm_tpu/graph/negative.py`` without its numpy fallback).

For each positive edge: ``num_neg // 2`` destination corruptions, then
``num_neg - num_neg // 2`` source corruptions, drawn uniformly over the local
node ids ``[0, num_nodes)`` and avoiding both endpoints and their undirected
adjacency in the subgraph. The engine's ``std::mt19937_64`` stream makes the
draw a function of ``seed``: the same seed gives the JAX package's negatives.
"""
from __future__ import annotations

import ctypes

import numpy as np

from .build import load_library


def _i64p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))


def generate_negative_samples(edge_index, pos_edge_index, num_neg_samples: int,
                              num_nodes: int, seed: int = 0) -> np.ndarray:
    """→ neg_edge_index [2, n_pos * num_neg_samples] int64. Raises if the
    engine cannot be built."""
    src = np.ascontiguousarray(np.asarray(edge_index)[0], dtype=np.int64)
    dst = np.ascontiguousarray(np.asarray(edge_index)[1], dtype=np.int64)
    pos_src = np.ascontiguousarray(np.asarray(pos_edge_index)[0], np.int64)
    pos_dst = np.ascontiguousarray(np.asarray(pos_edge_index)[1], np.int64)
    n_pos = len(pos_src)
    out = np.empty((2, n_pos * num_neg_samples), dtype=np.int64)
    out_src, out_dst = out[0], out[1]
    load_library().rmm_negative_sample(
        _i64p(src), _i64p(dst), len(src), _i64p(pos_src), _i64p(pos_dst),
        n_pos, int(num_nodes), int(num_neg_samples),
        ctypes.c_uint64(int(seed)), _i64p(out_src), _i64p(out_dst))
    return out
