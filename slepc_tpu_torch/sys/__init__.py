from .options import (Options, apply_module_options, get_global_options,
                      set_global_options)
from .sort import SortCriterion, Which, sort_eigenvalues
from .events import log_event_end_sync
from .mesh import get_mesh, set_mesh
from .monitor import Monitor, ConvMonitor

__all__ = [
    "Options",
    "set_global_options",
    "get_global_options",
    "apply_module_options",
    "sort_eigenvalues",
    "log_event_end_sync",
    "Which",
    "SortCriterion",
    "get_mesh",
    "set_mesh",
    "Monitor",
    "ConvMonitor",
]
