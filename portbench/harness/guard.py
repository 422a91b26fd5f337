"""The check that the process that prints a result holds no JAX: the
top-level name of every loaded module (the part before the first dot) is
compared whole with these names, so the port, whose name begins with the
JAX package's, is not caught."""

from __future__ import annotations

import sys

BANNED = ("jax", "jaxlib", "flax", "slepc_tpu")


def banned_modules(modules=None, banned=BANNED) -> list:
    """Sorted top-level names of loaded modules that are banned."""
    names = sys.modules if modules is None else modules
    return sorted({m.split(".")[0] for m in names} & set(banned))
