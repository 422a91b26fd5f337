from .options import Options, set_global_options, get_global_options
from .sort import Which, SortCriterion
from .monitor import Monitor, ConvMonitor

__all__ = [
    "Options",
    "set_global_options",
    "get_global_options",
    "Which",
    "SortCriterion",
    "Monitor",
    "ConvMonitor",
]
