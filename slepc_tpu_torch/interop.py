"""Carry slepc_tpu state into slepc_tpu_torch and back, as numpy arrays.

The parity tests use these to feed both packages identical operators and
bases.  slepc_tpu objects are read by their attributes only, so this module
imports neither JAX nor slepc_tpu; JAX arrays convert with ``np.asarray``.

* :func:`dia_from_slepc_tpu`: a slepc_tpu ``DIAOperator`` (offsets, diags),
  ``DIAPaddedOperator`` (prepared ``dp``) or ``DIAPaddedOperatorDS``
  (``dph + dpl`` joined in f64) becomes a port :class:`DIAOperator`.
* :func:`aij_from_slepc_tpu`: a slepc_tpu ``AIJOperator`` (through its host
  CSR, ``to_scipy()``) becomes a port :class:`AIJOperator`.
* :func:`operator_from_slepc_tpu`: DIA / AIJ / Dense / Diagonal / Identity
  operators by class name, and scaled or summed ones of those.
* :func:`sinvert_operator_from_slepc_tpu`, :func:`st_from_slepc_tpu`,
  :func:`ksp_from_slepc_tpu`, :func:`bv_from_slepc_tpu`: a slepc_tpu
  ``SinvertCGOperator``, ``ST*`` / ``STSinvertDevice`` / ``STFilter``,
  ``KSP`` or ``BV`` (diagonals, b_diag, sigma, iters, method; the filter's
  interval, degree, spectral range and damping; basis array, constraints)
  becomes the port's, so both compute the same thing.
* :func:`rg_from_slepc_tpu`: a slepc_tpu region (ellipse, interval,
  polygon, ring) with its complement flag and scale.
* :func:`svd_from_slepc_tpu`: a slepc_tpu ``SVD`` (operator, B, omega, nsv,
  ncv, which, tol, max_it, solver) as the port's, unsolved.
* :func:`fn_from_slepc_tpu`, :func:`mfn_from_slepc_tpu`,
  :func:`lme_from_slepc_tpu`, :func:`pep_from_slepc_tpu`: a slepc_tpu
  function (its type, scales, method and parts), MFN, LME or PEP (the
  operators through :func:`operator_from_slepc_tpu`, the function,
  dimensions, tolerances, solver, problem type, basis, scaling, target,
  interval, extraction and region) as the port's, unsolved.
* :func:`nep_from_slepc_tpu`: a slepc_tpu split-form NEP (its operators,
  functions and region, dimensions, tolerances, solver, target, two-sided
  flag, NLEIGS basis, singularities and deflation) as the port's, unsolved.
* :func:`dia_to_padded_ds`: a port f64 operator as the (offsets, dph, dpl, n)
  arguments of ``DIAPaddedOperatorDS``.
* :func:`basis_from_padded` / :func:`basis_to_padded`: a padded basis
  (K, rows, 512) and a flat (K, n) basis, by the unpad rule of
  ``slepc_tpu/ops/dia_pallas.py:525-527`` (drop the first ``block_rows``
  halo rows, flatten, keep the first n entries).
"""

from __future__ import annotations

import numpy as np
import torch

from .bv.bv import BV, OrthogType
from .fn import fn as _fn
from .ksp.ksp import KSP
from .lme.lme import LME
from .mat.linop import (AIJOperator, DenseOperator, DIAOperator,
                        DiagonalOperator, IdentityOperator, ScaledOperator,
                        SumOperator)
from .mfn.mfn import MFN
from .nep.nep import NEP
from .pep.pep import PEP
from .rg.rg import RGEllipse, RGInterval, RGPolygon, RGRing
from .st.filter import STFilter
from .st.sinvert_jit import SinvertCGOperator, STSinvertDevice
from .st.st import STCayley, STPrecond, STShift, STSinvert
from .svd.svd import SVD
from .sys.device import resolve_device

LANES = 512  # lane width of slepc_tpu's padded 2-D layout


def _prepared_to_diags(dp: np.ndarray, n: int) -> np.ndarray:
    """Prepared diagonal blocks (nd, nblk*Rb, 512) -> (nd, n)."""
    return np.ascontiguousarray(dp.reshape(dp.shape[0], -1)[:, :n])


def dia_from_slepc_tpu(op, device=None) -> DIAOperator:
    if hasattr(op, "dph"):
        n = int(op.n_interior)
        d = (_prepared_to_diags(np.asarray(op.dph), n).astype(np.float64)
             + _prepared_to_diags(np.asarray(op.dpl), n).astype(np.float64))
    elif hasattr(op, "n_interior"):
        n = int(op.n_interior)
        d = _prepared_to_diags(np.asarray(op.dp), n)
    else:
        d = np.asarray(op.diags)
    return DIAOperator(op.offsets, np.array(d), device=resolve_device(device))


def aij_from_slepc_tpu(op, device=None) -> AIJOperator:
    return AIJOperator.from_scipy(op.to_scipy(), device=device)


def operator_from_slepc_tpu(op, device=None):
    """A slepc_tpu operator as the port's operator of the same kind."""
    kind = type(op).__name__
    if kind.startswith("DIA"):
        return dia_from_slepc_tpu(op, device=device)
    if kind == "AIJOperator":
        return aij_from_slepc_tpu(op, device=device)
    if kind == "DenseOperator":
        return DenseOperator(np.array(op.A), device=device)
    if kind == "DiagonalOperator":
        return DiagonalOperator(np.array(op.d), device=device)
    if kind == "IdentityOperator":
        return IdentityOperator(op.shape[0], np.dtype(op.dtype), device)
    if kind == "ScaledOperator":
        return ScaledOperator(operator_from_slepc_tpu(op.op, device=device),
                              op.alpha)
    if kind == "SumOperator":
        return SumOperator(tuple(operator_from_slepc_tpu(o, device=device)
                                 for o in op.ops), op.coeffs)
    raise TypeError(f"no port counterpart for a slepc_tpu {kind}")


def _flat(op, xp) -> np.ndarray:
    """A padded 2-D array of the padded operator ``op`` as a flat (n,)."""
    return np.array(op.unpad(xp))


def sinvert_operator_from_slepc_tpu(jop, device=None) -> SinvertCGOperator:
    """A slepc_tpu ``SinvertCGOperator``: its shifted padded operator, the
    D^{1/2} and Jacobi vectors, iters and method."""
    Sop = dia_from_slepc_tpu(jop.Sop, device=device)

    def vec(xp):
        if xp is None:
            return None
        return torch.from_numpy(_flat(jop.Sop, xp)).to(Sop.device, Sop.dtype)

    return SinvertCGOperator(Sop, vec(jop.dhalf), vec(jop.invdiag),
                             iters=jop.iters, method=jop.method)


def st_from_slepc_tpu(jst, device=None):
    """A slepc_tpu ST (shift, sinvert, cayley, precond, sinvert-device) on
    the port's operators, with its sigma and KSP options."""
    mats = [operator_from_slepc_tpu(M, device=device) for M in jst.mats]
    sigma = jst.sigma
    name = jst.name
    if name == "sinvert-device":
        return STSinvertDevice(mats, sigma=sigma, iters=jst.iters,
                               method=jst.method)
    if name == "sinvert":
        return STSinvert(mats, sigma=sigma, ksp_opts=jst.ksp_opts,
                         hermitian=jst.hermitian)
    if name == "cayley":
        return STCayley(mats, sigma=sigma, nu=jst.nu, ksp_opts=jst.ksp_opts)
    if name == "filter":
        return STFilter(mats, interval=jst.interval, degree=jst.degree,
                        spectral_range=jst.range, damping=jst.damping,
                        transition=jst.transition)
    cls = {"shift": STShift, "precond": STPrecond}.get(name)
    if cls is None:
        raise TypeError(f"no port counterpart for a slepc_tpu ST {name!r}")
    return cls(mats, sigma=sigma, ksp_opts=jst.ksp_opts)


def rg_from_slepc_tpu(jrg):
    """A slepc_tpu RG as the port's region of the same kind (host numpy on
    both sides), with its complement flag and scale factor."""
    kind = type(jrg).__name__
    if kind == "RGEllipse":
        rg = RGEllipse(jrg.center, jrg.radius, jrg.vscale)
    elif kind == "RGInterval":
        rg = RGInterval(jrg.a, jrg.b, jrg.c, jrg.d)
    elif kind == "RGPolygon":
        rg = RGPolygon(np.array(jrg.vertices))
    elif kind == "RGRing":
        rg = RGRing(jrg.center, jrg.radius, jrg.vscale, jrg.start_ang,
                    jrg.end_ang, jrg.width)
    else:
        raise TypeError(f"no port counterpart for a slepc_tpu {kind}")
    rg.set_complement(jrg.complement)
    rg.set_scale(jrg.sfactor)
    return rg


def svd_from_slepc_tpu(jsvd, device=None) -> SVD:
    """A slepc_tpu SVD's settings on the port's operators: the same
    problem, dimensions, side, tolerances and solver."""
    B = None if jsvd.B is None else operator_from_slepc_tpu(jsvd.B,
                                                            device=device)
    omega = None if jsvd.omega is None else np.array(jsvd.omega)
    return SVD(operator_from_slepc_tpu(jsvd.A, device=device), B=B,
               omega=omega, nsv=jsvd.nsv, ncv=jsvd.ncv,
               which=jsvd.which.value, tol=jsvd.tol, max_it=jsvd.max_it,
               solver=jsvd.solver)


def fn_from_slepc_tpu(jfn) -> _fn.FN:
    """A slepc_tpu FN as the port's function of the same type: its inner
    and outer scales, its method, and its parts (phi's k, a rational's
    coefficients, a combination's operation and functions)."""
    kind = type(jfn).__name__
    cls = getattr(_fn, kind, None)
    if cls is None or not issubclass(cls, _fn.FN) or cls is _fn.FN:
        raise TypeError(f"no port counterpart for a slepc_tpu {kind}")
    if kind == "FNPhi":
        f = cls(jfn.k)
    elif kind == "FNRational":
        f = cls(np.array(jfn.num), None if jfn.den is None
                else np.array(jfn.den))
    elif kind == "FNCombine":
        f = cls(jfn.op, fn_from_slepc_tpu(jfn.f1), fn_from_slepc_tpu(jfn.f2))
    else:
        f = cls()
    f.set_scale(jfn.alpha, jfn.beta)
    f.set_method(jfn.method)
    return f


def mfn_from_slepc_tpu(jmfn, device=None) -> MFN:
    """A slepc_tpu MFN's operator, function, dimension, tolerances and
    solver as the port's, unsolved."""
    return MFN(operator_from_slepc_tpu(jmfn.A, device=device),
               fn_from_slepc_tpu(jmfn.fn), ncv=jmfn.ncv, tol=jmfn.tol,
               max_it=jmfn.max_it, solver=jmfn.solver)


def lme_from_slepc_tpu(jlme, device=None) -> LME:
    """A slepc_tpu LME's coefficients, problem type, dimension and
    tolerances as the port's, unsolved."""
    B = None if jlme.B is None else operator_from_slepc_tpu(jlme.B,
                                                            device=device)
    return LME(operator_from_slepc_tpu(jlme.A, device=device), B=B,
               problem_type=jlme.problem_type.value, ncv=jlme.ncv,
               tol=jlme.tol, max_it=jlme.max_it)


def pep_from_slepc_tpu(jpep, device=None) -> PEP:
    """A slepc_tpu PEP's coefficients and settings (dimensions, which,
    target, tolerances, solver, basis, scaling, interval, extraction,
    region) as the port's, unsolved."""
    pep = PEP([operator_from_slepc_tpu(m, device=device) for m in jpep.mats],
              nev=jpep.nev, ncv=jpep.ncv, which=jpep.which.value,
              target=jpep.target, tol=jpep.tol, max_it=jpep.max_it,
              solver=jpep.solver, basis=jpep.basis, scale=jpep.scale)
    if getattr(jpep, "interval", None) is not None:
        pep.set_interval(*jpep.interval)
    if getattr(jpep, "extract", None) is not None:
        pep.set_extraction(jpep.extract)
    if getattr(jpep, "rg", None) is not None:
        pep.set_rg(rg_from_slepc_tpu(jpep.rg))
    return pep


def nep_from_slepc_tpu(jnep, device=None) -> NEP:
    """A slepc_tpu split-form NEP's operators (through
    :func:`operator_from_slepc_tpu`), functions, region and settings (nev,
    tol, max_it, solver, target, two-sided, the NLEIGS basis, the
    singularity set and the deflation) as the port's, unsolved.  A
    callback-form NEP cannot be carried: its callbacks return slepc_tpu
    operators."""
    if jnep.fun is not None:
        raise ValueError("nep_from_slepc_tpu: a callback-form NEP "
                         "(set_function) cannot be carried: its callbacks "
                         "return slepc_tpu operators; build the port's with "
                         "NEP.set_function on port operators")
    nep = NEP(nev=jnep.nev, tol=jnep.tol, max_it=jnep.max_it,
              solver=jnep.solver, target=jnep.target)
    nep.set_split_operators(
        [operator_from_slepc_tpu(m, device=device) for m in jnep.split_A],
        [fn_from_slepc_tpu(f) for f in jnep.split_f])
    if jnep.rg is not None:
        nep.set_rg(rg_from_slepc_tpu(jnep.rg))
    nep.set_two_sided(jnep.two_sided)
    nep.nleigs_full_basis = jnep.nleigs_full_basis
    if getattr(jnep, "_singularities", None) is not None:
        nep.set_singularities(np.array(jnep._singularities))
    if hasattr(jnep, "deflation"):
        nep.deflation = jnep.deflation
    return nep


def ksp_from_slepc_tpu(jksp, device=None) -> KSP:
    """A slepc_tpu KSP: the same operator, method, tolerances and
    preconditioner choice."""
    backend = jksp._direct.backend if jksp._direct is not None else "auto"
    return KSP(operator_from_slepc_tpu(jksp.A, device=device),
               method=jksp.method, pc=jksp._pcname, rtol=jksp.rtol,
               atol=jksp.atol, maxiter=jksp.maxiter,
               hermitian=jksp.hermitian, direct_backend=backend)


def bv_from_slepc_tpu(jbv, device=None) -> BV:
    """A slepc_tpu BV: its (n, nc + m) column array becomes the port's
    (nc + m, n) row array; constraints, active window and the inner-product
    matrix carry over."""
    arr = torch.from_numpy(np.ascontiguousarray(np.asarray(jbv.array).T))
    bv = BV(jbv.n, jbv.m, nc=jbv.nc, array=arr.to(resolve_device(device)))
    bv.set_active_columns(jbv.l, jbv.k)
    bv.orthog_type = OrthogType(jbv.orthog_type.value)
    if jbv.matrix is not None:
        bv.set_matrix(operator_from_slepc_tpu(jbv.matrix, device=device))
    return bv


def _prepare(d: np.ndarray, n: int, block_rows: int) -> np.ndarray:
    nblk = -(-n // (block_rows * LANES))
    out = np.zeros((d.shape[0], nblk * block_rows * LANES), d.dtype)
    out[:, :n] = d[:, :n]
    return out.reshape(d.shape[0], nblk * block_rows, LANES)


def dia_to_padded_ds(op: DIAOperator, block_rows: int = 128):
    """(offsets, dph, dpl, n) with dph + dpl == diags: the hi/lo f32 split
    of slepc_tpu's ``ds_split`` in the prepared layout."""
    d = op.diags.detach().cpu().numpy().astype(np.float64)
    hi = d.astype(np.float32)
    lo = (d - hi.astype(np.float64)).astype(np.float32)
    n = op.shape[0]
    return (op.offsets, _prepare(hi, n, block_rows), _prepare(lo, n, block_rows),
            n)


def basis_from_padded(Vp, n: int, block_rows: int = 128) -> np.ndarray:
    """Padded rows (K, rows, 512) -> flat rows (K, n)."""
    Vp = np.asarray(Vp)
    return np.ascontiguousarray(
        Vp[:, block_rows:, :].reshape(Vp.shape[0], -1)[:, :n])


def basis_to_padded(V, block_rows: int = 128) -> np.ndarray:
    """Flat rows (K, n) -> padded rows (K, (nblk+2)*block_rows, 512) with
    zero halo blocks."""
    V = np.asarray(V.detach().cpu() if torch.is_tensor(V) else V)
    K, n = V.shape
    nblk = -(-n // (block_rows * LANES))
    out = np.zeros((K, (nblk + 2) * block_rows * LANES), V.dtype)
    out[:, block_rows * LANES: block_rows * LANES + n] = V
    return out.reshape(K, (nblk + 2) * block_rows, LANES)
