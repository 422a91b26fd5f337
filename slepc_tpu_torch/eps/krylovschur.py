"""EPS Krylov–Schur (``slepc_tpu/eps/krylovschur.py:99-130``).

Ported: the Hermitian fast path — standard Hermitian problem, sigma = 0
shift, which = smallest/largest (real or magnitude) — that runs the
restart cycle of ``ks_jit.py`` (plain, or Chebyshev-amplified with
``-eps_cheb_degree``).  The general host-orchestrated loop (non-Hermitian,
generalized, harmonic, spectrum slicing, two-sided, BSE) is still to be
ported (ROADMAP.md, queue 1, item 11).
"""

from __future__ import annotations

from ..sys.sort import Which
from .base import ProblemType
from .ks_jit import ks_hep_solve

_WHICH = {Which.SMALLEST_REAL: "smallest",
          Which.SMALLEST_MAGNITUDE: "smallest",
          Which.LARGEST_REAL: "largest",
          Which.LARGEST_MAGNITUDE: "largest_magnitude"}


class KrylovSchur:
    """Krylov-Schur, Hermitian fast path."""

    def solve(self, eps) -> None:
        if eps.problem_type != ProblemType.HEP:
            raise NotImplementedError(
                f"EPS krylovschur is ported for problem_type='hep' only, not "
                f"{eps.problem_type.value!r} (ROADMAP.md, queue 1, item 11)")
        if eps.which not in _WHICH:
            raise NotImplementedError(
                f"which={eps.which.value!r} needs the general Krylov-Schur "
                f"loop, still to be ported (ROADMAP.md, queue 1, item 11)")
        ks_hep_solve(eps, eps.st.op(), _WHICH[eps.which])
