"""BV -- a block of basis vectors on one device (``slepc_tpu/bv/bv.py``).

Layout: ``array`` is (nc + m, n) row-major, row k = basis vector k -- the
port's basis layout (``eps/ks_jit.py``), the transpose of the reference's
(n, m) columns -- so every vector is contiguous and "the vectors before j"
are one contiguous row prefix.  The ``nc`` leading rows are constraints
(deflation space); logical index j is physical row ``nc + j``, as in the
reference.  The sweeps run on kernel K3 (``panel_dots(V, B w)`` for a
B-metric) and ``mult_in_place`` on kernel K4.  Methods update ``array`` in
place.  An indefinite metric (``set_matrix(B, indef=True)``, GHIEP) keeps
the signature ``omega`` (+-1 a row, host numpy): the sweeps scale their
coefficients by it and the norms are signed.  ``biorthogonalize_column``
is the two-sided primitive, on K3.  The TSQR block type runs
``orthog.tsqr`` (CholeskyQR2 under a B-metric, as the reference does).

The public boundary speaks the reference's shapes: a block of vectors
handed in or returned is (n, k), its columns the vectors (``insert_vecs``,
``insert_constraints``, ``to_numpy``), and a coefficient matrix Q is the
reference's (rows of the source, columns of the target).  The block
operations run on the kernels: ``mult`` and ``mult_in_place`` on K4,
``dot`` and ``mat_project`` on K3 (``orthog.gram``), ``mat_mult`` on the
operator's SpMV (a window of one vector: ``mult``, K1 / K2 for DIA) or
its block product (``mult_block``: K5 for DIA, K6 a row for CSR).
"""

from __future__ import annotations

import enum
from typing import Optional

import numpy as np
import torch

from ..mat.linop import LinearOperator, apply_by_parts
from ..ops.bv import panel_dots, panel_update
from ..ops.rotate import rotate
from ..sys.device import resolve_device
from ..sys.dtypes import as_torch_dtype
from . import orthog as _orth


class OrthogType(enum.Enum):
    CGS = "cgs"  # one K3 dots and one K3 update a sweep
    MGS = "mgs"  # the same kernels one basis vector at a time


class OrthogRefine(enum.Enum):
    IFNEEDED = "ifneeded"
    NEVER = "never"
    ALWAYS = "always"


class OrthogBlockType(enum.Enum):
    GS = "gs"  # row loop
    CHOL = "chol"  # CholeskyQR2
    SVQB = "svqb"
    TSQR = "tsqr"


class BV:
    def __init__(self, n: int, m: int, dtype=torch.float64, nc: int = 0,
                 array: Optional[torch.Tensor] = None, device=None):
        self.n = n
        self.m = m
        self.nc = nc
        if array is not None:
            self.array = array
        else:
            self.array = torch.zeros((m + nc, n), dtype=as_torch_dtype(dtype),
                                     device=resolve_device(device))
        self.dtype = self.array.dtype
        self.device = self.array.device
        self.l = 0
        self.k = m
        self.matrix = None  # B inner-product LinearOperator
        self.indef = False
        self.omega: Optional[np.ndarray] = None  # (nc + m,) signature
        self.orthog_type = OrthogType.CGS
        self.orthog_refine = OrthogRefine.IFNEEDED
        self.orthog_block = OrthogBlockType.CHOL

    # -- basic ------------------------------------------------------------
    def copy(self) -> "BV":
        """A BV with its own copy of the vectors (and of the signature): an
        in-place method on either leaves the other as it was."""
        other = BV(self.n, self.m, self.dtype, self.nc,
                   array=self.array.clone())
        other.l, other.k = self.l, self.k
        other.matrix, other.indef = self.matrix, self.indef
        other.omega = None if self.omega is None else self.omega.copy()
        other.orthog_type = self.orthog_type
        other.orthog_refine = self.orthog_refine
        other.orthog_block = self.orthog_block
        return other

    def set_active_columns(self, l: int, k: int) -> None:
        if not 0 <= l <= k <= self.m:
            raise ValueError(f"active window [{l}, {k}) outside [0, {self.m}]")
        self.l, self.k = l, k

    def set_matrix(self, B, indef: bool = False) -> None:
        """Set the inner-product matrix (x, y) = y^H B x; ``indef``: B is
        indefinite and the rows carry a signature (all +1 to start)."""
        self.matrix = B
        self.indef = indef
        if indef and self.omega is None:
            self.omega = np.ones(self.m + self.nc)

    def _ip_mult(self):
        """The metric application (None when there is no B)."""
        return None if self.matrix is None else self.matrix.mult

    def _tensor(self, v) -> torch.Tensor:
        if not torch.is_tensor(v):
            v = torch.from_numpy(np.require(v, requirements="CW"))
        return v.to(self.device, self.dtype)

    # -- column access (logical index excludes constraints) ---------------
    def _phys(self, j: int) -> int:
        return j + self.nc

    def get_column(self, j: int) -> torch.Tensor:
        return self.array[self._phys(j)]

    def set_column(self, j: int, v) -> None:
        self.array[self._phys(j)] = self._tensor(v)

    def insert_vec(self, j: int, v) -> None:
        self.set_column(j, v)

    def insert_vecs(self, s: int, W) -> None:
        """Vectors s, s + 1, ... = the columns of W, (n, k)."""
        W = self._columns(W, "insert_vecs")
        self.array[self._phys(s): self._phys(s) + W.shape[1]] = W.T

    def _columns(self, W, what: str) -> torch.Tensor:
        W = self._tensor(W)
        if W.dim() != 2 or W.shape[0] != self.n:
            raise ValueError(f"BV.{what}: takes an (n, k) = ({self.n}, k) "
                             f"block of columns, got {tuple(W.shape)}")
        return W

    def insert_constraints(self, C) -> int:
        """Prepend constraint vectors, the columns of C, (n, c); they are
        orthonormalized and take part in every orthogonalization but are
        never touched by solvers.  Returns the constraint count."""
        C = self._columns(C, "insert_constraints")
        Q, _ = _orth.cholqr2(C.T.contiguous(), self._ip_mult())
        self.array = torch.cat([Q, self.array])
        self.nc += C.shape[1]
        if self.omega is not None:
            self.omega = np.concatenate([np.ones(C.shape[1]), self.omega])
        return self.nc

    def set_random(self, seed: int = 0, j: Optional[int] = None) -> None:
        """Deterministic random fill from numpy, so both packages draw the
        same vectors."""
        rng = np.random.default_rng(seed)
        if j is None:
            vals = rng.standard_normal((self.n, self.m))
            if self.dtype.is_complex:
                vals = vals + 1j * rng.standard_normal((self.n, self.m))
            self.array[self.nc:] = self._tensor(vals.T)
        else:
            v = rng.standard_normal(self.n)
            if self.dtype.is_complex:
                v = v + 1j * rng.standard_normal(self.n)
            self.set_column(j, v)

    def resize(self, m_new: int) -> None:
        """m_new vectors: the leading ones kept, new ones zero; the active
        window clamped to it."""
        rows = m_new + self.nc
        if rows <= self.array.shape[0]:
            self.array = self.array[:rows].clone()
        else:
            self.array = torch.cat([self.array, self.array.new_zeros(
                (rows - self.array.shape[0], self.n))])
        if self.omega is not None:
            self.omega = np.concatenate([self.omega[:rows], np.ones(
                max(0, rows - len(self.omega)))])
        self.m = m_new
        self.k = min(self.k, m_new)
        self.l = min(self.l, self.k)

    def _window(self) -> torch.Tensor:
        return self.array[self._phys(self.l): self._phys(self.k)]

    def _upto_k(self) -> torch.Tensor:
        return self.array[self._phys(0): self._phys(self.k)]

    # -- block linear algebra ---------------------------------------------
    def mult_vec(self, q) -> torch.Tensor:
        """y = sum_k q[k] V[k] over the first len(q) logical vectors."""
        q = self._tensor(q)
        return rotate(q[:, None], self.array[self.nc: self.nc + q.shape[0]])[0]

    def mult_in_place(self, Q, s: Optional[int] = None,
                      e: Optional[int] = None) -> None:
        """V[s:e] = Q[:, s:e]^T V[:rows of Q]: the restart compaction, on
        kernel K4."""
        Q = self._tensor(Q)
        s = self.l if s is None else s
        e = self.k if e is None else e
        Vact = self.array[self.nc: self.nc + Q.shape[0]]
        rotate(Q[:, s:e].contiguous(), Vact,
               out=self.array[self._phys(s): self._phys(e)])

    def mult(self, alpha, beta, X: "BV", Q) -> None:
        """V[l:k] = beta V[l:k] + alpha X Q[:, l:k] over the active window,
        X's first rows-of-Q vectors combined by Q on kernel K4, then one
        pass over the window."""
        Q = self._tensor(Q)
        upd = rotate((alpha * Q[:, self.l: self.k]).contiguous(),
                     X.array[X._phys(0): X._phys(Q.shape[0])])
        win = self._window()
        torch.add(upd, win, alpha=beta, out=win)

    def mat_mult(self, A, out: Optional["BV"] = None) -> "BV":
        """Y = A V over the active window, into ``out`` (a new BV with no
        constraints when None), which takes the same window.  A window of
        one vector is one ``A.mult`` (K1 / K2 for DIA, K6 for CSR), a wider
        one ``A.mult_block`` (K5 for DIA, K6 a row for CSR)."""
        Y = _apply_rows(A, self._window())
        if out is None:
            out = BV(self.n, self.m, self.dtype, device=self.device)
        out.array[out._phys(self.l): out._phys(self.k)] = Y
        out.set_active_columns(self.l, self.k)
        return out

    def dot(self, Y: "BV") -> torch.Tensor:
        """M = Y^H B X, (k_Y, k_X), over vectors 0..k-1 of Y and of this
        BV (X), on K3; B is this BV's metric."""
        X = self._upto_k()
        if self.matrix is not None:
            X = _apply_rows(self.matrix, X)
        return _orth.gram(Y._upto_k(), X)

    def dot_vec(self, y) -> torch.Tensor:
        """c = V B y over the active vectors; one K3 sweep."""
        y = self._tensor(y)
        By = y if self.matrix is None else self.matrix.mult(y)
        return _orth.gram(self.array[self._phys(0): self._phys(self.k)],
                          By[None])[:, 0]

    def norm_column(self, j: int) -> float:
        """||v_j||_B; for an indefinite metric the signed v^H B v itself,
        as the reference returns it."""
        v = self.get_column(j)
        Bv = v if self.matrix is None else self.matrix.mult(v)
        nsq = float(torch.vdot(v, Bv).real)
        return nsq if self.indef else nsq ** 0.5

    def scale_column(self, j: int, alpha) -> None:
        self.array[self._phys(j)] *= alpha

    def scale(self, alpha) -> None:
        self._window().mul_(alpha)

    def norms(self) -> torch.Tensor:
        """The 2-norms of the active window's vectors (no B metric), in one
        reduction over the rows."""
        return torch.linalg.vector_norm(self._window(), dim=1)

    # -- orthogonalization -------------------------------------------------
    def orthogonalize_vec(self, v):
        """Orthogonalize an external vector against all active vectors.
        Returns (v_new, coeffs (logical), norm_after, lindep)."""
        return self._orth_against(self.k, self._tensor(v))

    def orthogonalize_column(self, j: int):
        """Orthogonalize vector j against constraints + vectors 0..j-1."""
        v_new, c, norm, lindep = self._orth_against(j, self.get_column(j))
        self.array[self._phys(j)] = v_new
        return c, norm, lindep

    def orthonormalize_column(self, j: int, replace_lindep: bool = False):
        """Orthogonalize + normalize vector j.  On linear dependence, with
        ``replace_lindep``, substitute a seeded random vector and
        re-orthogonalize (breakdown restart semantics)."""
        c, norm, lindep = self.orthogonalize_column(j)
        if lindep and replace_lindep:
            self.set_random(seed=j + 12345, j=j)
            _, norm, lindep = self.orthogonalize_column(j)
        if self.indef:  # the signed norm's sign is the row's signature
            self.omega[self._phys(j)] = 1.0 if norm >= 0 else -1.0
            norm_abs = abs(norm)
            self.scale_column(j, 1.0 / (norm_abs if norm_abs != 0 else 1.0))
        else:
            self.scale_column(j, 1.0 / (norm if norm != 0 else 1.0))
        return c, norm, lindep

    def _orth_against(self, j: int, v: torch.Tensor):
        passes = 1 if self.orthog_refine == OrthogRefine.NEVER else 2
        orth = _orth.mgs_vec if self.orthog_type == OrthogType.MGS \
            else _orth.orthogonalize_vec
        v_new, c, nb, na = orth(
            self.array[: self._phys(j)], v, self._ip_mult(), passes=passes,
            omega=self.omega[: self._phys(j)] if self.indef else None)
        # one host read: the coefficients and both norms
        host = torch.cat([c, nb[None], na[None]]).cpu().numpy()
        nb_f, na_f = float(host[-2].real), float(host[-1].real)
        # linear dependence: post-orth norm below sqrt(eps) * pre-orth norm
        # even after refinement (1e-7 for an indefinite metric)
        lindep = abs(na_f) < max(abs(nb_f), 1e-300) * (
            1e-7 if self.indef else float(torch.finfo(self.dtype).eps) ** 0.5)
        return v_new, host[self.nc:-2], na_f, bool(lindep)

    def orthogonalize(self, block_type: Optional[OrthogBlockType] = None):
        """Orthonormalize all active vectors as a block.  Returns the host
        array R with V_old (columns) = V_new R."""
        bt = block_type or self.orthog_block
        sl = slice(self._phys(self.l), self._phys(self.k))
        X = self.array[sl]
        Bmult = self._ip_mult()
        if bt == OrthogBlockType.CHOL:
            Q, R = _orth.cholqr2(X, Bmult)
        elif bt == OrthogBlockType.TSQR:
            Q, R = _orth.cholqr2(X, Bmult) if Bmult is not None \
                else _orth.tsqr(X)
        elif bt == OrthogBlockType.SVQB:
            Q, R = _orth.svqb(X, Bmult, self.omega[sl] if self.indef else None)
        elif bt == OrthogBlockType.GS:
            Q, R = _orth.mgs_block(X, Bmult)
        else:
            raise ValueError(bt)
        self.array[sl] = Q
        return R

    # -- projections --------------------------------------------------------
    def mat_project(self, A, W: Optional["BV"] = None) -> torch.Tensor:
        """M = W^H A V, (k_W, k_V), over vectors 0..k-1 of W (this BV when
        None) and of V; A None is the identity.  A V on A's SpMV or block
        product, the Gram on K3."""
        W = self if W is None else W
        AV = self._upto_k() if A is None else _apply_rows(A, self._upto_k())
        return _orth.gram(W._upto_k(), AV)

    def to_numpy(self) -> np.ndarray:
        """The logical vectors as the COLUMNS of an (n, m) host array (the
        reference's layout)."""
        return self.array[self.nc:].cpu().numpy().T


def _apply_rows(A, X: torch.Tensor) -> torch.Tensor:
    """A applied to each row of X: one ``A.mult`` for a single row, else
    ``A.mult_block``; complex rows of a real operator as their real and
    imaginary parts."""
    if X.shape[0] == 0:
        return X.new_zeros((0, A.shape[0]))
    if X.shape[0] == 1:
        return apply_by_parts(A.mult, X[0], A.dtype)[None]
    return apply_by_parts(LinearOperator.block_of(A), X, A.dtype)


def biorthogonalize_column(V: BV, W: BV, j: int) -> torch.Tensor:
    """Two-sided (bi)orthogonalization of vector j of V and of W against
    the vectors before it in the cross basis, twice: v -= V_<j (W_<j^H v),
    w -= W_<j (V_<j^H w) (one K3 dots and one K3 update each), so that
    <w_i, v_j> = <w_j, v_i> = 0 for i < j when W_<j^H V_<j = I -- the
    two-sided Lanczos primitive (reference BVBiorthogonalizeColumn).
    Returns the normalization factor <w_j, v_j> (a 0-d tensor on the
    device), whose sign and size feed the two-sided recurrence."""
    v = V.get_column(j)[None]
    w = W.get_column(j)[None]
    for _ in range(2):
        if j > 0:
            Vprev = V.array[V._phys(0): V._phys(j)]
            Wprev = W.array[W._phys(0): W._phys(j)]
            v = panel_update(Vprev, panel_dots(Wprev, v), v)
            w = panel_update(Wprev, panel_dots(Vprev, w), w)
    V.set_column(j, v[0])
    W.set_column(j, w[0])
    return torch.vdot(w[0], v[0])
