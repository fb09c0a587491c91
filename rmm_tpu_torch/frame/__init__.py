"""ColumnFrame core: stypes, stats, TensorFrame, Dataset, DataLoader."""
from .dataset import Dataset, DatasetView  # noqa: F401
from .loader import DataLoader  # noqa: F401
from .stats import StatType, compute_col_stats  # noqa: F401
from .stype import STYPE_ORDER, Stype  # noqa: F401
from .tensor_frame import TensorFrame  # noqa: F401
