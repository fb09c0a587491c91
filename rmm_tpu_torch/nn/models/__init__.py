"""Composed models."""
from .tabgnn import PNALayer, TABGNN  # noqa: F401
