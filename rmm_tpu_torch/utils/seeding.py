"""Deterministic seed derivation for loaders/samplers.

The reference reshuffles and resamples neighborhoods every epoch
(``main.py:288`` shuffle=True; fresh ``sample_from_edges`` per call,
``ibm_transactions_for_aml.py:88-102``). The TPU build keeps every draw
*explicitly* seeded — so threaded host sampling stays order-independent —
and recovers per-epoch stochasticity by mixing the epoch index into each
derived seed with a splitmix64 finalizer (avalanches all input bits, so
(seed, epoch, i) and (seed, epoch+1, i) share no low-bit structure).
"""
from __future__ import annotations

_M = 0xFFFFFFFFFFFFFFFF


def mix_seed(*parts: int) -> int:
    """Hash integers into a 31-bit seed (stable across runs/platforms)."""
    h = 0x9E3779B97F4A7C15
    for p in parts:
        h = (h + (int(p) & _M) + 0x9E3779B97F4A7C15) & _M
        h ^= h >> 30
        h = (h * 0xBF58476D1CE4E5B9) & _M
        h ^= h >> 27
        h = (h * 0x94D049BB133111EB) & _M
        h ^= h >> 31
    return h & 0x7FFFFFFF
