"""Hierarchical runtime options database.

The functional analog of the PetscOptions database that the reference uses
for every object (``-eps_nev 10 -st_type sinvert -st_ksp_type cg`` …;
reference: src/eps/interface/epsopts.c).  Options are stored flat under
string keys with prefix composition: an ``EPS`` with prefix ``"eps_"`` owns
``eps_nev``; its child ``ST`` composes to ``st_`` keys, the ST's KSP to
``st_ksp_`` keys, matching the reference's object-tree prefix propagation.

Values may come from:
  * a global database (``set_global_options`` / CLI-style string parsing),
  * per-object keyword arguments (highest precedence),
  * defaults supplied at query time.
"""

from __future__ import annotations

import shlex
from typing import Any, Dict, Iterable, Optional


class Options:
    """A flat string-keyed options dictionary with prefix views."""

    def __init__(self, values: Optional[Dict[str, Any]] = None, prefix: str = ""):
        self._values: Dict[str, Any] = dict(values or {})
        self.prefix = prefix

    # -- construction -----------------------------------------------------
    @classmethod
    def from_cli(cls, argv: Iterable[str] | str) -> "Options":
        """Parse PETSc-style CLI options: ``-eps_nev 10 -eps_monitor``.

        A token starting with ``-`` opens a key; a following non-dash token
        is its value, otherwise the option is a boolean flag (True).
        """
        if isinstance(argv, str):
            argv = shlex.split(argv)
        values: Dict[str, Any] = {}
        key = None
        for tok in argv:
            if tok.startswith("-") and not _is_number(tok):
                if key is not None:
                    values[key] = True
                key = tok.lstrip("-")
            else:
                if key is None:
                    raise ValueError(f"option value {tok!r} with no preceding -key")
                values[key] = _convert(tok)
                key = None
        if key is not None:
            values[key] = True
        return cls(values)

    # -- dict-like --------------------------------------------------------
    def __contains__(self, key: str) -> bool:
        return self.prefix + key in self._values

    def __getitem__(self, key: str) -> Any:
        return self._values[self.prefix + key]

    def __setitem__(self, key: str, value: Any) -> None:
        self._values[self.prefix + key] = value

    def get(self, key: str, default: Any = None) -> Any:
        return self._values.get(self.prefix + key, default)

    def update(self, other: "Options | Dict[str, Any]") -> None:
        if isinstance(other, Options):
            other = other._values
        for k, v in other.items():
            self._values[self.prefix + k] = v

    def items(self):
        n = len(self.prefix)
        for k, v in self._values.items():
            if k.startswith(self.prefix):
                yield k[n:], v

    # -- prefix composition ----------------------------------------------
    def child(self, prefix: str) -> "Options":
        """A view over the same database with an extended prefix."""
        return Options(self._values, self.prefix + prefix)

    def __repr__(self):
        return f"Options(prefix={self.prefix!r}, {dict(self.items())!r})"


def _is_number(tok: str) -> bool:
    try:
        float(tok)
        return True
    except ValueError:
        return False


def _convert(tok: str) -> Any:
    for cast in (int, float):
        try:
            return cast(tok)
        except ValueError:
            pass
    if tok.lower() in ("true", "yes", "on"):
        return True
    if tok.lower() in ("false", "no", "off"):
        return False
    return tok


_global_options = Options()


def set_global_options(opts: Options | Dict[str, Any] | str) -> None:
    """Install a global options database (CLI string, dict, or Options)."""
    global _global_options
    if isinstance(opts, str):
        opts = Options.from_cli(opts)
    elif isinstance(opts, dict):
        opts = Options(opts)
    _global_options = opts


def get_global_options() -> Options:
    return _global_options
