"""Ops: the fused column-attention kernel and PNA aggregation."""
from .column_attention import (  # noqa: F401
    fused_column_attention,
    reference_column_attention,
)
from .segment import pna_aggregate  # noqa: F401
