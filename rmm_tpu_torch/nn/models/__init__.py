"""Composed models."""
from .tabgnn import PNALayer, TABGNN  # noqa: F401
from .fused import FTTransformerPNAFusedLayer, FuseMLP, TABGNNFused  # noqa: F401
from .ft_transformer import FTTransformer  # noqa: F401
from .interleaved import (  # noqa: F401
    FTTransformerPNAInterleavedLayer,
    TABGNNInterleaved,
)
