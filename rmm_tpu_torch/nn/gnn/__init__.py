"""Message-passing convolutions and the pure-GNN backbones."""
from .conv import (  # noqa: F401
    EdgeUpdateMLP,
    GINEConv,
    GINEConvHetero,
    PNAConv,
    PNAConvHetero,
    TGINEConv,
)
from .models import CPNA, CPNATAB, PNA, PNAS, GINe  # noqa: F401
