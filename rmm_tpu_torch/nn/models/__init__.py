"""Composed models."""
from .tabgnn import PNALayer, TABGNN  # noqa: F401
from .fused import FTTransformerPNAFusedLayer, FuseMLP, TABGNNFused  # noqa: F401
