"""Host graph engine: per-split CSR k-hop sampling (C++ via ctypes)."""
from .sampler import NeighborSampler, SampledSubgraph  # noqa: F401
from .store import GraphStore  # noqa: F401
