"""Message-passing convolutions."""
from .conv import EdgeUpdateMLP, PNAConv, PNAConvHetero  # noqa: F401
