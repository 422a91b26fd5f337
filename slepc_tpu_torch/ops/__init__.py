"""Hand-written CUDA kernels for Hopper and their plain PyTorch versions.

Each wrapper keeps a launch counter (``<module>.launches``), incremented only
where it launches its kernel; :func:`launch_counts` and
:func:`reset_launch_counts` read and clear them all.
"""

from . import bv, csr, dia, rotate, stream

_MODULES = (dia, csr, bv, rotate, stream)


def launch_counts() -> dict:
    counts = {}
    for mod in _MODULES:
        counts.update(mod.launches)
    return counts


def reset_launch_counts() -> None:
    for mod in _MODULES:
        for key in mod.launches:
            mod.launches[key] = 0
