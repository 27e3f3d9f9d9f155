"""Test-support utilities: fault injection for the planning service.

Importable from production code paths (the service accepts any duck-typed
``faults`` object), but shipped under ``repro_torch.testing`` because its
only in-repo consumers are the chaos tests and ``chip_smoke.py``.
"""
from .faults import (
    FaultInjector,
    chaos_requests,
    corrupt_graph_cyclic,
    corrupt_graph_dangling,
    corrupt_graph_duplicate_edge,
    corrupt_graph_nan_feature,
    corrupt_graph_negative_words,
)

__all__ = [
    "FaultInjector",
    "chaos_requests",
    "corrupt_graph_cyclic",
    "corrupt_graph_dangling",
    "corrupt_graph_duplicate_edge",
    "corrupt_graph_nan_feature",
    "corrupt_graph_negative_words",
]
