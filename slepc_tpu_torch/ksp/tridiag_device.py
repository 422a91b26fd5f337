"""Device-side symmetric tridiagonal and block-tridiagonal LDL^T: factor,
solve, inertia (``slepc_tpu/ksp/tridiag_device.py``).

Spectrum slicing reads matrix inertia off an LDL^T factorization per shift;
for tridiagonal (1-D Laplacian / Sturm class) and banded (2-D Laplacian
class) DIA operators the whole factor / solve / inertia pipeline stays on
the operator's device.

Tridiagonal: no sequential loop, everything is a parallel prefix.

* The pivot recurrence ``d_i = a_i - b_{i-1}^2 / d_{i-1}`` is a Moebius
  map: ``d_i = (P_i)_00 / (P_i)_10`` for the prefix product
  ``P_i = M_i ... M_1`` of ``M_i = [[a_i, -b_{i-1}^2], [1, 0]]``.  Each
  partial product is normalized by its largest |entry| (a positive scalar,
  so ratios and signs are exact).
* ``inertia(sigma)`` = #negative pivots = #(sign(P_00) != sign(P_10)).
* The two triangular sweeps are first-order affine recurrences
  ``y_i = alpha_i y_{i-1} + beta_i``, composed as (alpha, beta) pairs.

PyTorch has no associative scan, so the prefixes are Hillis-Steele doubling
written with plain tensor ops: ceil(log2 n) rounds, each combining element
i with element i - 2^r.  The reference runs these outside any Pallas kernel
(``jax.lax.associative_scan``), so plain tensor code is their counterpart.

Block tridiagonal: ``D_i = A_i - B_{i-1} D_{i-1}^{-1} B_{i-1}^T`` is a
Python loop over the m blocks (the reference's ``lax.scan``), each step a
small dense solve on the device; inertia is the sum of the block inertias.

Caveat (as the reference, and LAPACK's stebz): the recurrences run
unpivoted; a shift that hits an eigenvalue of a leading minor loses
accuracy, and the slicing driver perturbs such shifts.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..mat.linop import as_operand


def _operands(where: str, rhs=None, *tensors):
    """The array rule for the free functions here: the matrix arguments
    ``tensors`` (numpy or tensors) on the device of the first one that is
    a tensor (else the default device), in their own dtypes, and ``rhs`` in
    the first one's dtype (complex when rhs is) on that device."""
    dev = next((t.device for t in tensors if torch.is_tensor(t)), None)
    out = [t if torch.is_tensor(t) else as_operand(
        t, where, None, dev, ndims=(np.ndim(t),)) for t in tensors]
    if rhs is not None and not torch.is_tensor(rhs):
        blocks = out[0].dim() == 3  # (m, b, b): rhs is one (m b,) vector
        rhs = as_operand(rhs, where, out[0].dtype, out[0].device,
                         out[0].shape[0] * (out[0].shape[1] if blocks else 1),
                         axis=0, ndims=(1,) if blocks else (1, 2))
    return rhs, out


def _tiny(dtype) -> float:
    return float(torch.finfo(dtype).tiny)


def _mobius_scan(a: torch.Tensor, c: torch.Tensor):
    """Prefix Moebius products for d_i = a_i - c_i / d_{i-1}.

    a: (n,) shifted diagonal; c: (n,) with c_0 = 0, c_i = b_{i-1}^2.
    Returns (p, q) with d_i = p_i / q_i (scale-normalized).  The 2x2
    matrices are carried as their four entry vectors."""
    n = a.shape[0]
    m00, m01 = a.clone(), -c
    m10, m11 = torch.ones_like(a), torch.zeros_like(a)
    tiny = _tiny(a.dtype)
    step = 1
    while step < n:
        # later (y) after earlier (x): z = y @ x, for elements i >= step
        y00, y01, y10, y11 = m00[step:], m01[step:], m10[step:], m11[step:]
        x00, x01, x10, x11 = (m00[:-step], m01[:-step], m10[:-step],
                              m11[:-step])
        z00 = y00 * x00 + y01 * x10
        z01 = y00 * x01 + y01 * x11
        z10 = y10 * x00 + y11 * x10
        z11 = y10 * x01 + y11 * x11
        s = torch.maximum(torch.maximum(z00.abs(), z01.abs()),
                          torch.maximum(z10.abs(), z11.abs())).clamp_min(tiny)
        m00 = torch.cat([m00[:step], z00 / s])
        m01 = torch.cat([m01[:step], z01 / s])
        m10 = torch.cat([m10[:step], z10 / s])
        m11 = torch.cat([m11[:step], z11 / s])
        step *= 2
    # initial direction [1, 0]: d_i = P[i,0,0] / P[i,1,0]
    return m00, m10


def _shifted(a: torch.Tensor, b: torch.Tensor, sigma):
    c = torch.cat([torch.zeros(1, dtype=a.dtype, device=a.device), b * b])
    return a - sigma, c


def tridiag_pivots(a: torch.Tensor, b: torch.Tensor, sigma) -> torch.Tensor:
    """LDL^T pivots d of (T - sigma I), T = tridiag(b, a, b).

    a: (n,) diagonal; b: (n-1,) off-diagonal (tensors or numpy arrays:
    the array rule).  Returns (n,) pivots."""
    if not (torch.is_tensor(a) and torch.is_tensor(b)):
        _, (a, b) = _operands("tridiag_pivots", None, a, b)
    p, q = _mobius_scan(*_shifted(a, b, sigma))
    tiny = _tiny(a.dtype)
    return p / torch.where(q.abs() > tiny, q, torch.full_like(q, tiny))


def tridiag_inertia(a: torch.Tensor, b: torch.Tensor, sigma) -> torch.Tensor:
    """#eigenvalues of T strictly below sigma (Sturm / Sylvester count), a
    0-d integer tensor on a's device.

    Sign-exact: uses only the signs of the normalized prefix entries.  A
    zero pivot (sigma hits an eigenvalue of a leading minor) counts as
    negative, the standard Sturm convention."""
    if not (torch.is_tensor(a) and torch.is_tensor(b)):
        _, (a, b) = _operands("tridiag_inertia", None, a, b)
    p, q = _mobius_scan(*_shifted(a, b, sigma))
    return ((p > 0) != (q > 0)).sum()


def _affine_scan(alpha: torch.Tensor, beta: torch.Tensor) -> torch.Tensor:
    """y_i = alpha_i * y_{i-1} + beta_i with y_0 = beta_0 (alpha_0 ignored:
    set it to 0), along dim 0, in ceil(log2 n) doubling rounds.  alpha and
    beta have the same shape (n, k).  A backward recurrence flips its
    inputs and the result."""
    n = alpha.shape[0]
    a, b = alpha, beta
    step = 1
    while step < n:
        a2, b2 = a[step:], b[step:]
        b = torch.cat([b[:step], a2 * b[:-step] + b2])
        a = torch.cat([a[:step], a2 * a[:-step]])
        step *= 2
    return b


def _tridiag_mv(a, b, sigma, X):
    """(T - sigma I) @ X columns, X (n, k)."""
    Y = (a - sigma)[:, None] * X
    Y[:-1] += b[:, None] * X[1:]
    Y[1:] += b[:, None] * X[:-1]
    return Y


def tridiag_solve(a: torch.Tensor, b: torch.Tensor, sigma,
                  rhs: torch.Tensor, refine: int = 1,
                  pivots: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x = (T - sigma I)^{-1} rhs via the scanned LDL^T (three parallel
    prefix sweeps) + ``refine`` steps of iterative refinement (the prefix
    sweeps carry more roundoff than sequential substitution; one step
    restores it).  rhs may be (n,) or (n, k).  ``pivots``: the result of
    :func:`tridiag_pivots` for the same (a, b, sigma), to factor once and
    solve many times.  Numpy arguments follow the array rule: they go to
    the device of the first tensor among them (else the default device)
    and rhs takes a's dtype."""
    if not (torch.is_tensor(a) and torch.is_tensor(b)
            and torch.is_tensor(rhs)):
        rhs, (a, b) = _operands("tridiag_solve", rhs, a, b)
    d = tridiag_pivots(a, b, sigma) if pivots is None else pivots
    tiny = _tiny(a.dtype)
    dsafe = torch.where(d.abs() > tiny, d, torch.full_like(d, tiny))
    ell = b / dsafe[:-1]  # l_i couples row i -> i+1
    vec = rhs.dim() == 1
    R = rhs[:, None] if vec else rhs
    zero = torch.zeros(1, dtype=a.dtype, device=a.device)
    aF = torch.cat([zero, -ell])[:, None]
    aB = torch.cat([-ell, zero])[:, None]

    def ldl_solve(Rb):
        y = _affine_scan(aF.expand_as(Rb), Rb)
        z = y / dsafe[:, None]
        return _affine_scan(aB.expand_as(Rb).flip(0), z.flip(0)).flip(0)

    x = ldl_solve(R)
    for _ in range(refine):
        x = x + ldl_solve(R - _tridiag_mv(a, b, sigma, x))
    return x[:, 0] if vec else x


# ---------------------------------------------------------------------------
# Block-tridiagonal symmetric LDL^T: banded operators (the 2-D Laplacian
# with bandwidth = side) viewed as block tridiagonal with b x b blocks.
# ---------------------------------------------------------------------------


def btridiag_pivots(Ab: torch.Tensor, Bb: torch.Tensor, sigma) -> torch.Tensor:
    """Block pivots D_i of (T - sigma I).

    Ab: (m, b, b) symmetric diagonal blocks; Bb: (m-1, b, b) with
    T[i+1, i] block = Bb[i] (sub-diagonal); tensors or numpy arrays (the
    array rule).  Returns (m, b, b)."""
    if not (torch.is_tensor(Ab) and torch.is_tensor(Bb)):
        _, (Ab, Bb) = _operands("btridiag_pivots", None, Ab, Bb)
    m, b, _ = Ab.shape
    Ash = Ab - sigma * torch.eye(b, dtype=Ab.dtype, device=Ab.device)
    D = torch.empty_like(Ab)
    D[0] = Ash[0]
    for i in range(1, m):
        X = torch.linalg.solve(D[i - 1], Bb[i - 1].T)  # D_{i-1}^{-1} B_{i-1}^T
        D[i] = Ash[i] - Bb[i - 1] @ X
    return D


def btridiag_inertia(Ab, Bb, sigma, pivots=None) -> torch.Tensor:
    """#eigenvalues of T strictly below sigma via the block Sturm count:
    the negative eigenvalues of each D_i, summed (a 0-d tensor)."""
    if not (torch.is_tensor(Ab) and torch.is_tensor(Bb)):
        _, (Ab, Bb) = _operands("btridiag_inertia", None, Ab, Bb)
    D = btridiag_pivots(Ab, Bb, sigma) if pivots is None else pivots
    w = torch.linalg.eigvalsh(0.5 * (D + D.mT))  # (m, b)
    return (w < 0).sum()


def btridiag_solve(Ab, Bb, sigma, rhs, refine: int = 1, pivots=None):
    """x = (T - sigma I)^{-1} rhs; rhs (n,) with n = m*b.

    Block LDL^T: forward substitution loop, block-diagonal solve, backward
    loop; one refinement step restores sequential-level accuracy.  Numpy
    arguments follow the array rule, as in :func:`tridiag_solve`."""
    if not (torch.is_tensor(Ab) and torch.is_tensor(Bb)
            and torch.is_tensor(rhs)):
        rhs, (Ab, Bb) = _operands("btridiag_solve", rhs, Ab, Bb)
    m, b, _ = Ab.shape
    D = btridiag_pivots(Ab, Bb, sigma) if pivots is None else pivots
    # L sub-blocks: L_i = B_i D_i^{-1}  (i = 0..m-2)
    Lb = torch.linalg.solve(D[:-1].mT, Bb.mT).mT
    Dlu = torch.linalg.lu_factor(D)
    Ash = Ab - sigma * torch.eye(b, dtype=Ab.dtype, device=Ab.device)

    def mv(x):
        Xb = x.reshape(m, b)
        y = torch.einsum("ijk,ik->ij", Ash, Xb)
        y[1:] += torch.einsum("ijk,ik->ij", Bb, Xb[:-1])
        y[:-1] += torch.einsum("ikj,ik->ij", Bb, Xb[1:])
        return y.reshape(-1)

    def ldl_solve(r):
        y = r.reshape(m, b).clone()
        for i in range(1, m):
            y[i] -= Lb[i - 1] @ y[i - 1]
        x = torch.linalg.lu_solve(*Dlu, y[..., None])[..., 0]
        for i in range(m - 2, -1, -1):
            x[i] -= Lb[i].T @ x[i + 1]
        return x.reshape(-1)

    x = ldl_solve(rhs)
    for _ in range(refine):
        x = x + ldl_solve(rhs - mv(x))
    return x


def _dia_host_csr(op):
    """The DIA operator's exact host CSR (A[i, i+o] = diags[d][i])."""
    import scipy.sparse as sp

    n = op.shape[0]
    dd = op.diags.detach().cpu().numpy()
    rows, cols, vals = [], [], []
    for i, o in enumerate(op.offsets):
        idx = np.arange(max(0, -o), n - max(0, o))
        rows.append(idx)
        cols.append(idx + o)
        vals.append(dd[i][idx])
    return sp.csr_matrix((np.concatenate(vals),
                          (np.concatenate(rows), np.concatenate(cols))),
                         shape=(n, n))


def btridiag_of_operator(op, max_bw: int = 512
                         ) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """(Ablocks, Bblocks) as host arrays when ``op`` is a symmetric banded
    real DIAOperator with bandwidth <= max_bw and n divisible into
    bandwidth-sized blocks; None otherwise."""
    from ..mat.linop import DIAOperator

    if not isinstance(op, DIAOperator) or op.dtype.is_complex:
        return None
    offs = tuple(op.offsets)
    if not offs or set(offs) <= {-1, 0, 1}:
        return None  # plain tridiagonal handles this
    bw = max(abs(o) for o in offs)
    n = op.shape[0]
    if bw > max_bw or bw < 2 or n % bw != 0 or n // bw < 2:
        return None
    A = _dia_host_csr(op)
    if abs(A - A.T).max() > 1e-12 * max(abs(A).max(), 1e-300):
        return None
    m = n // bw
    Ab = np.zeros((m, bw, bw))
    Bb = np.zeros((m - 1, bw, bw))
    for i in range(m):
        Ab[i] = A[i * bw:(i + 1) * bw, i * bw:(i + 1) * bw].toarray()
        if i + 1 < m:
            Bb[i] = A[(i + 1) * bw:(i + 2) * bw, i * bw:(i + 1) * bw].toarray()
    return Ab, Bb


def tridiag_of_operator(op) -> Optional[Tuple[torch.Tensor, torch.Tensor]]:
    """(a, b) on the operator's device when ``op`` is a symmetric
    tridiagonal DIAOperator; None otherwise (the device-slicing route
    test)."""
    from ..mat.linop import DIAOperator

    if not isinstance(op, DIAOperator) or op.dtype.is_complex:
        return None
    offs = tuple(op.offsets)
    if 0 not in offs or set(offs) - {-1, 0, 1}:
        return None
    n = op.shape[0]
    a = op.diags[offs.index(0)][:n]
    if offs == (0,):
        return a, torch.zeros(n - 1, dtype=op.dtype, device=op.device)
    if 1 not in offs:
        return None
    b_up = op.diags[offs.index(1)][: n - 1]
    if -1 in offs:
        b_dn = op.diags[offs.index(-1)][1:n]
        if not torch.allclose(b_up, b_dn):
            return None  # not symmetric
    return a, b_up


class TridiagLDLDevice:
    """Factor-per-shift facade over the scanned kernels, with the host
    DirectSolver surface that slicing consumes (``ksp/direct.py``):
    ``solve(rhs)``, ``inertia()``, plus ``shift(sigma)`` rebinding.  The
    pivots are computed once, at the first solve."""

    def __init__(self, a: torch.Tensor, b: torch.Tensor, sigma: float = 0.0):
        if not (torch.is_tensor(a) and torch.is_tensor(b)):
            _, (a, b) = _operands("TridiagLDLDevice", None, a, b)
        self.a, self.b = a, b
        self.sigma = float(sigma)
        self.n = int(a.shape[0])
        self._pivots = None

    def shift(self, sigma: float) -> "TridiagLDLDevice":
        return TridiagLDLDevice(self.a, self.b, sigma)

    def inertia(self):
        """(n_neg, n_zero, n_pos) of T - sigma I; n_zero is folded into
        n_neg by the Sturm zero convention."""
        neg = int(tridiag_inertia(self.a, self.b, self.sigma))
        return neg, 0, self.n - neg

    def solve(self, rhs: torch.Tensor) -> torch.Tensor:
        if not torch.is_tensor(rhs):
            rhs, _ = _operands("TridiagLDLDevice.solve", rhs, self.a)
        if self._pivots is None:
            self._pivots = tridiag_pivots(self.a, self.b, self.sigma)
        return tridiag_solve(self.a, self.b, self.sigma,
                             rhs.to(self.a.dtype), pivots=self._pivots)
