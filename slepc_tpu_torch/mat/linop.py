"""Linear operators — the Mat tier on PyTorch tensors
(``slepc_tpu/mat/linop.py``).

An operator's tensors live on one device, and its ``mult`` / ``mult_h``
take and return flat ``(n,)`` vectors there; ``mult_block`` takes the b
rows of a ``(b, n)`` block at once (the blocked Krylov-Schur cycle's SpMV).
Formats:

  * :class:`DIAOperator` — diagonal-offset storage for stencil / banded
    matrices; ``mult`` is the DIA kernel K1/K2 (K1c/K2c for complex64 /
    complex128 diagonals), ``mult_h`` the same kernel on the adjoint's
    diagonals (built once, on the device) and ``mult_block`` the block
    kernel K5 (K5c for complex diagonals; ``ops/dia.py``); ``cheb_step`` /
    ``cheb_step_block`` are a Chebyshev filter's step fused into K2's /
    K5's design.
  * :class:`AIJOperator` — general sparsity as plain CSR on the device;
    ``mult`` is the CSR kernel K6 (``ops/csr.py``).  The reference's padded
    ELL and hybrid diagonal/gather packs are TPU layouts and are not ported;
    :meth:`AIJOperator.fast_form` keeps only their routing: a matrix that is
    a few dense diagonals runs as a DIAOperator.
  * :class:`DenseOperator`, :class:`IdentityOperator`,
    :class:`DiagonalOperator` and :class:`ShellOperator` (user callbacks,
    the MATSHELL analog), plus the algebra ``+ - * @``, ``.H`` and
    ``shifted`` (Scaled / Sum / Product / Adjoint operators).  These are
    plain tensor code, as in the reference, where they run outside any
    Pallas kernel.

A CUDA tensor goes to a kernel or raises; only a tensor on the CPU takes a
kernel's plain PyTorch version.  Every public product also takes a numpy
array, as the reference's do (:func:`as_operand`, the array rule): it goes
to the operator's device and then takes the tensor's path.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch

from ..ops.csr import CSR_BUDGET, csr_plan, csr_spmv, row_of_entry
from ..ops.dia import dia_cheb_step, dia_cheb_step_block, dia_spmm, dia_spmv
from ..sys.device import resolve_device
from ..sys.dtypes import as_torch_dtype


def _place(data, device) -> torch.Tensor:
    """``data`` as a tensor on ``device``.  A tensor handed in with
    ``device=None`` keeps its device; a numpy array (or any tensor with an
    explicit ``device``) goes where :func:`resolve_device` says -- the card
    unless the caller names another device."""
    if torch.is_tensor(data):
        return data if device is None else data.to(resolve_device(device))
    return torch.from_numpy(np.ascontiguousarray(data)).to(
        resolve_device(device))


def operand_dtype(dtype: torch.dtype, x_dtype: torch.dtype) -> torch.dtype:
    """The element type a numpy operand takes on an operator of ``dtype``:
    the operator's precision (its kernel takes one element type), complex
    when either is complex (a real operator applies to a complex vector by
    parts)."""
    if x_dtype.is_complex and not dtype.is_complex:
        return torch.complex128 if dtype == torch.float64 else torch.complex64
    return dtype


def as_operand(x, where: str, dtype: Optional[torch.dtype] = None,
               device=None, n: Optional[int] = None, axis: int = -1,
               ndims: Tuple[int, ...] = (1,)) -> torch.Tensor:
    """The array rule: the vector or block argument ``x`` of the public
    method ``where`` (e.g. ``"DIAOperator.mult"``) as a tensor.

    A tensor is returned as it is; its dtype, device and length stay the
    callee's to check, so a CUDA tensor a kernel does not take still
    raises.  A numpy array with ``ndims`` dimensions and ``n`` entries
    along ``axis`` goes to ``device`` (the operator's; None:
    :func:`resolve_device`) in ``operand_dtype(dtype, ...)`` (``dtype``
    None keeps the array's), one copy.  Anything else raises a
    ``TypeError`` or ``ValueError`` naming ``where``.  Callers test
    ``torch.is_tensor(x)`` before calling, so a tensor pays that one
    check."""
    if torch.is_tensor(x):
        return x
    if not isinstance(x, np.ndarray) or x.dtype.kind not in "biufc":
        raise TypeError(f"{where}: takes a tensor or a numpy array of "
                        f"numbers, not {type(x).__name__}"
                        + (f" of {x.dtype}" if isinstance(x, np.ndarray)
                           else ""))
    if x.ndim not in ndims or (n is not None and x.shape[axis] != n):
        raise ValueError(
            f"{where}: an array of shape {x.shape}; it takes "
            f"{' or '.join(map(str, ndims))}-d arrays"
            + (f" with {n} entries along axis {axis}" if n is not None
               else ""))
    t = torch.from_numpy(np.ascontiguousarray(x))
    return t.to(device=resolve_device(device),
                dtype=t.dtype if dtype is None else operand_dtype(dtype,
                                                                  t.dtype))


def apply_by_parts(fn, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``fn`` of a real operator on x; a complex x (a complex operator's
    vector meeting a real B, or a complex shift of a real A) goes as its
    real and imaginary parts, each on the real kernel."""
    if x.is_complex() and not dtype.is_complex:
        return torch.complex(fn(x.real.contiguous()), fn(x.imag.contiguous()))
    return fn(x)


def cheb_passes(y: torch.Tensor, t: torch.Tensor, p, alpha: float,
                beta: float) -> torch.Tensor:
    """A Chebyshev step's three vector passes on the product y = A t, in
    place: y = alpha y + beta t - p (p None: no subtraction)."""
    y.mul_(alpha).add_(t, alpha=beta)
    return y if p is None else y.sub_(p)


class LinearOperator:
    """Abstract operator A: R^n -> R^m on one device.

    ``mult(x)``   computes A @ x for a vector x of shape (n,).
    ``mult_h(x)`` computes A^H @ x.
    """

    shape: Tuple[int, int]
    dtype: torch.dtype
    device: torch.device
    # the row mesh of a partitioned operator (``parallel/halo.py``); an
    # operator of one process holds every row, so the row maps below are
    # the identity
    mesh = None
    # the rows [lo, hi) this rank owns of an operator whose products keep
    # vectors whole (``sys/mesh.py`` ``shard_operator``); None: every row
    own_rows = None

    @property
    def n_global(self) -> int:
        """Rows of the whole operator, over every rank."""
        return self.shape[0]

    def local_rows(self, X: torch.Tensor) -> torch.Tensor:
        """This process's rows of a global (..., n_global) block."""
        return X

    def interior(self, X: torch.Tensor) -> torch.Tensor:
        """This process's own rows of its local rows X."""
        if self.own_rows is None:
            return X
        return X[..., self.own_rows[0]: self.own_rows[1]]

    @property
    def n(self) -> int:
        return self.shape[1]

    @property
    def m(self) -> int:
        return self.shape[0]

    @property
    def nnz(self) -> int:
        """Nonzero count for flop accounting (dense ≙ m*n)."""
        return self.shape[0] * self.shape[1]

    def mult(self, x: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def mult_h(self, x: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def mult_block(self, X: torch.Tensor) -> torch.Tensor:
        """A applied to each row of the (b, n) block X: one ``mult`` per
        row, into a new (b, m) tensor (the reference's ``jax.vmap(op.mult)``
        role, ks_jit.py:930-931)."""
        if not torch.is_tensor(X):
            X = as_operand(X, f"{type(self).__name__}.mult_block", self.dtype,
                           self.device, self.shape[1], ndims=(2,))
        Y = torch.empty((X.shape[0], self.shape[0]), dtype=X.dtype,
                        device=X.device)
        for m in range(X.shape[0]):
            Y[m] = self.mult(X[m])
        return Y

    def cheb_step(self, t: torch.Tensor, p, alpha: float,
                  beta: float) -> torch.Tensor:
        """One step of a Chebyshev filter's recurrence (``st/cheb.py``),
        y = alpha A t + beta t - p (p None: step 1), a new tensor: the
        product, then the three passes (:func:`cheb_passes`)."""
        return cheb_passes(self.mult(t), t, p, alpha, beta)

    def cheb_step_block(self, T: torch.Tensor, P, alpha: float,
                        beta: float) -> torch.Tensor:
        """:meth:`cheb_step` on the rows of a (b, n) block, with the block
        product."""
        return cheb_passes(self.mult_block(T), T, P, alpha, beta)

    def __call__(self, x):
        return self.mult(x)

    @staticmethod
    def block_of(op) -> Callable[[torch.Tensor], torch.Tensor]:
        """``op.mult_block``, or the one-``mult``-per-row default for an
        operator object that has no ``mult_block`` of its own."""
        return getattr(op, "mult_block", None) \
            or (lambda X: LinearOperator.mult_block(op, X))

    # ---- operator algebra ----------------------------------------------
    def __add__(self, other: "LinearOperator") -> "LinearOperator":
        return SumOperator((self, other), (1.0, 1.0))

    def __sub__(self, other: "LinearOperator") -> "LinearOperator":
        return SumOperator((self, other), (1.0, -1.0))

    def __mul__(self, alpha) -> "LinearOperator":
        return ScaledOperator(self, alpha)

    __rmul__ = __mul__

    def __neg__(self) -> "LinearOperator":
        return ScaledOperator(self, -1.0)

    def __matmul__(self, other: "LinearOperator") -> "LinearOperator":
        return ProductOperator((self, other))

    @property
    def H(self) -> "LinearOperator":
        return AdjointOperator(self)

    def shifted(self, sigma, B: Optional["LinearOperator"] = None) -> "LinearOperator":
        """A - sigma*B (B=None ≙ identity): the ST building block."""
        if sigma == 0:
            return self
        if B is None:
            B = IdentityOperator(self.n, self.dtype, self.device)
        return SumOperator((self, B), (1.0, -sigma))

    def norm_estimate(self) -> float:
        """Cheap Frobenius-norm estimate (backward-error weights)."""
        if self.shape[0] > 4096:
            return norm_estimate_randomized(self)
        return float(torch.linalg.norm(self.to_dense()))

    # ---- conversions ----------------------------------------------------
    def to_dense(self) -> torch.Tensor:
        """Materialize as a dense (m, n) tensor, one ``mult`` per column
        (testing / small problems only)."""
        eye = torch.eye(self.n, dtype=self.dtype, device=self.device)
        return torch.stack([self.mult(eye[j]) for j in range(self.n)], dim=1)

    def to_scipy(self):
        """Host scipy sparse view if available, else a dense ndarray."""
        return self.to_dense().cpu().numpy()

    def explicit(self):
        """The host matrix (scipy sparse, or numpy for a dense operator)
        when the operator has an explicit form, else None: a shell, or an
        algebra over one (the factorizations' routing question)."""
        return None


class DenseOperator(LinearOperator):
    """A dense matrix; ``mult`` is a matrix-vector product."""

    # set by sys/mesh.py shard_operator: this rank's rows and an all-gather
    row_shard = row_shard_h = None
    shard_form = shard_form_h = None

    def __init__(self, A, device=None):
        self.A = _place(A, device)
        self.shape = tuple(self.A.shape)
        self.dtype = self.A.dtype
        self.device = self.A.device

    def mult(self, x):
        if not torch.is_tensor(x):
            x = as_operand(x, "DenseOperator.mult", self.dtype, self.device,
                           self.shape[1])
        if self.row_shard is not None:
            return self.row_shard(x)
        return apply_by_parts(lambda v: self.A @ v, x, self.dtype)

    def mult_h(self, x):
        if not torch.is_tensor(x):
            x = as_operand(x, "DenseOperator.mult_h", self.dtype, self.device,
                           self.shape[0])
        if self.row_shard_h is not None:
            return self.row_shard_h(x)
        return apply_by_parts(lambda v: self.A.mH @ v, x, self.dtype)

    def to_dense(self):
        return self.A

    def to_scipy(self):
        return self.A.cpu().numpy()

    explicit = to_scipy


class IdentityOperator(LinearOperator):
    def __init__(self, n: int, dtype=torch.float64, device=None):
        self.shape = (n, n)
        self.dtype = as_torch_dtype(dtype)
        self.device = resolve_device(device)

    @property
    def nnz(self):
        return self.n

    def mult(self, x):
        """x itself; a numpy x comes back as a tensor on the device, in its
        own dtype (the reference returns x as it was given)."""
        if not torch.is_tensor(x):
            x = as_operand(x, "IdentityOperator.mult", None, self.device,
                           self.n)
        return x

    mult_h = mult

    def explicit(self):
        import scipy.sparse as sp

        return sp.identity(self.n, format="csr",
                           dtype=torch.empty(0, dtype=self.dtype).numpy().dtype)


class DIAOperator(LinearOperator):
    """Diagonal-offset (DIA) storage for stencil/banded matrices.

    y[i] = sum_d diags[d][i] * x[i + offsets[d]], with x taken as zero
    outside [0, n) (slepc_tpu pre-zeroes those entries of ``diags``; the
    kernel's bounds check makes that optional).  ``diags`` is a (ndiag, n)
    tensor; a tensor keeps its device unless ``device`` is given, a numpy
    array goes onto ``device`` (default: the card).
    """

    # set by sys/mesh.py shard_operator: this rank's rows and an all-gather
    row_shard = row_shard_block = None
    shard_form = None

    def __init__(self, offsets: Sequence[int], diags, shape=None,
                 device=None):
        self.offsets = tuple(int(o) for o in offsets)
        self.diags = _place(diags, device).contiguous()
        n = self.diags.shape[1]
        self.shape = tuple(shape) if shape is not None else (n, n)
        self.dtype = self.diags.dtype
        self.device = self.diags.device
        self._adjoint: Optional["DIAOperator"] = None

    @property
    def nnz(self):
        # exact: padding entries in diags are zero but stored; report the
        # true nonzero budget for flop/byte accounting
        n = self.shape[0]
        return int(sum(n - abs(o) for o in self.offsets))

    def norm_estimate(self) -> float:
        return float(torch.linalg.vector_norm(self.diags))

    def _check_len(self, x: torch.Tensor, what: str) -> None:
        # the kernels take x's length as n, so a short x would silently give
        # the product of A's leading block
        if x.shape[-1] != self.shape[1]:
            raise ValueError(f"DIAOperator.{what}: x has {x.shape[-1]} "
                             f"entries, the operator {self.shape[1]} columns")

    def mult(self, x: torch.Tensor) -> torch.Tensor:
        if not torch.is_tensor(x):
            x = as_operand(x, "DIAOperator.mult", self.dtype, self.device,
                           self.shape[1])
        self._check_len(x, "mult")
        if self.row_shard is not None:
            return self.row_shard(x)
        return apply_by_parts(lambda v: dia_spmv(self.offsets, self.diags, v),
                              x, self.dtype)

    def mult_block(self, X: torch.Tensor) -> torch.Tensor:
        """Kernel K5 (K5c for complex diagonals): the diagonals are read
        once for every chunk of at most ``SPMM_MAX_B`` (8) rows of X; a
        block of any height, on every device."""
        if not torch.is_tensor(X):
            X = as_operand(X, "DIAOperator.mult_block", self.dtype,
                           self.device, self.shape[1], ndims=(2,))
        self._check_len(X, "mult_block")
        if self.row_shard_block is not None:
            return self.row_shard_block(X)
        return apply_by_parts(lambda V: dia_spmm(self.offsets, self.diags, V),
                              X, self.dtype)

    def _fuses(self, t: torch.Tensor, shard) -> bool:
        """Whether a Chebyshev step on t takes the fused kernel: a real
        operator, t of its own dtype (no split by parts) and rows not
        partitioned."""
        return shard is None and not self.dtype.is_complex \
            and t.dtype == self.dtype

    def cheb_step(self, t: torch.Tensor, p, alpha: float,
                  beta: float) -> torch.Tensor:
        """One launch of the fused step (``ops/dia.py`` ``dia_cheb_step``,
        K2's design) where t allows it (:meth:`_fuses`), else ``mult`` and
        the three passes."""
        self._check_len(t, "cheb_step")
        if self._fuses(t, self.row_shard):
            return dia_cheb_step(self.offsets, self.diags, t, p, alpha, beta)
        return super().cheb_step(t, p, alpha, beta)

    def cheb_step_block(self, T: torch.Tensor, P, alpha: float,
                        beta: float) -> torch.Tensor:
        """The fused block step (``dia_cheb_step_block``, K5's design)
        where T allows it, else ``mult_block`` and the three passes."""
        self._check_len(T, "cheb_step_block")
        if self._fuses(T, self.row_shard_block):
            return dia_cheb_step_block(self.offsets, self.diags, T, P, alpha,
                                       beta)
        return super().cheb_step_block(T, P, alpha, beta)

    def adjoint(self) -> "DIAOperator":
        """A^H as a DIAOperator, built on A's device at the first call and
        kept: A[i, i + o] = d[i] makes A^H[r, r - o] = conj(d[r - o]), so
        diagonal o of A becomes diagonal -o of A^H with entries e[r] =
        conj(d[r - o]) for max(0, o) <= r < min(n, n + o), zero outside."""
        if self._adjoint is None:
            n = self.shape[0]
            e = torch.zeros((len(self.offsets), n), dtype=self.dtype,
                            device=self.device)
            for k, off in enumerate(self.offsets):
                lo, hi = max(0, off), min(n, n + off)
                if hi > lo:
                    e[k, lo:hi] = self.diags[k, lo - off:hi - off].conj()
            self._adjoint = DIAOperator(tuple(-o for o in self.offsets), e,
                                        shape=self.shape[::-1])
        return self._adjoint

    def mult_h(self, x: torch.Tensor) -> torch.Tensor:
        """A^H x on the same kernel as ``mult`` (K1/K2, K1c/K2c), over the
        adjoint's diagonals (:meth:`adjoint`)."""
        if not torch.is_tensor(x):
            x = as_operand(x, "DIAOperator.mult_h", self.dtype, self.device,
                           self.shape[0])
        self._check_len(x, "mult_h")
        return self.adjoint().mult(x)

    def to_scipy(self):
        import scipy.sparse as sp

        n = self.shape[0]
        d = self.diags.cpu().numpy()
        # scipy dia_matrix uses data[k, i] = A[i - offset[k], i] (column i)
        data = np.zeros_like(d)
        for k, off in enumerate(self.offsets):
            if off >= 0:
                data[k, off:] = d[k, : n - off] if off else d[k]
            else:
                data[k, :off] = d[k, -off:]
        return sp.dia_matrix((data, np.array(self.offsets)),
                             shape=self.shape).tocsr()

    explicit = to_scipy


class AIJOperator(LinearOperator):
    """General sparse matrix in CSR on one device.

    ``rowptr`` int64 (m+1), ``cols`` int32 (nnz), ``vals`` (nnz).  ``mult``
    is the CSR kernel K6 over the row-block plan of ``rowptr``, built at the
    first ``mult`` on a card (:meth:`row_plan`); ``mult_h`` runs the same
    kernel on the CSR of A^H, built on the device at the first ``mult_h``
    call (a Hermitian solve never pays for it).  The reference's PETSc
    MPIAIJ MatMult role.
    """

    # set by sys/mesh.py shard_operator: this rank's rows and an all-gather
    row_shard = None
    shard_form = shard_form_h = None

    def __init__(self, rowptr, cols, vals, shape):
        self.rowptr = rowptr.to(torch.int64).contiguous()
        self.cols = cols.to(torch.int32).contiguous()
        self.vals = vals.contiguous()
        self.shape = (int(shape[0]), int(shape[1]))
        self.dtype = self.vals.dtype
        self.device = self.vals.device
        self._adjoint = None  # CSR of A^H
        self._fast = None     # routed form (fast_form)
        self._plan = None     # K6's row blocks (row_plan)

    @classmethod
    def from_scipy(cls, A, dtype=None, device=None) -> "AIJOperator":
        """CSR of the scipy matrix ``A`` on ``device`` (default: the card),
        in ``dtype`` (torch or numpy; default: A's own).  Duplicate entries
        are summed."""
        import scipy.sparse as sp

        A = sp.csr_matrix(A)
        if not A.has_canonical_format:
            A = A.copy()
            A.sum_duplicates()
        indptr = torch.from_numpy(A.indptr.astype(np.int64, copy=False))
        indices = torch.from_numpy(A.indices.astype(np.int32, copy=False))
        vals = torch.from_numpy(np.ascontiguousarray(A.data))
        dtype = as_torch_dtype(dtype) or vals.dtype
        device = resolve_device(device)
        return cls(indptr.to(device), indices.to(device),
                   vals.to(device=device, dtype=dtype), A.shape)

    @property
    def nnz(self):
        return int(self.cols.shape[0])

    def row_plan(self):
        """K6's row-block plan of ``rowptr`` (``ops.csr.csr_plan``), built
        once on a card; None on the CPU, where the plain version runs."""
        if self._plan is None and self.device.type == "cuda":
            self._plan = csr_plan(self.rowptr, CSR_BUDGET[self.dtype])
        return self._plan

    def mult(self, x: torch.Tensor) -> torch.Tensor:
        if not torch.is_tensor(x):
            x = as_operand(x, "AIJOperator.mult", self.dtype, self.device,
                           self.shape[1])
        if self.row_shard is not None:
            return self.row_shard(x)
        return apply_by_parts(
            lambda v: csr_spmv(self.rowptr, self.cols, self.vals, v,
                               self.shape[1], plan=self.row_plan()),
            x, self.dtype)

    def mult_h(self, x: torch.Tensor) -> torch.Tensor:
        if not torch.is_tensor(x):
            x = as_operand(x, "AIJOperator.mult_h", self.dtype, self.device,
                           self.shape[0])
        return self.adjoint().mult(x)

    def adjoint(self) -> "AIJOperator":
        """The CSR of A^H, built on the device at the first call and kept."""
        if self._adjoint is None:
            # a stable sort by column keeps each column's rows ascending
            order = torch.argsort(self.cols, stable=True)
            counts = torch.bincount(self.cols.to(torch.int64),
                                    minlength=self.shape[1])
            rowptr = torch.zeros(self.shape[1] + 1, dtype=torch.int64,
                                 device=self.device)
            torch.cumsum(counts, 0, out=rowptr[1:])
            # a physical conjugate: the kernel reads memory, not torch's
            # lazy conjugate view
            self._adjoint = AIJOperator(
                rowptr, row_of_entry(self.rowptr)[order],
                torch.conj_physical(self.vals[order]),
                (self.shape[1], self.shape[0]))
        return self._adjoint

    def norm_estimate(self) -> float:
        return float(torch.linalg.vector_norm(self.vals))

    def to_scipy(self):
        import scipy.sparse as sp

        return sp.csr_matrix((self.vals.cpu().numpy(), self.cols.cpu().numpy(),
                              self.rowptr.cpu().numpy()), shape=self.shape)

    explicit = to_scipy

    def fast_form(self) -> LinearOperator:
        """The form the solvers run, chosen once and cached: a
        :class:`DIAOperator` (kernels K1/K2) when the matrix is square and
        its nonzeros lie on at most 32 diagonals that each hold at least
        n/2 entries, else this CSR operator (K6).  Reference:
        ``AIJOperator.to_gell`` / ``_try_dia_padded``, same thresholds; its
        n >= 4096 cut (an XLA-or-Pallas choice on the TPU) is not kept:
        every AIJ here runs on a kernel."""
        if self._fast is None:
            self._fast = self._try_dia() or self
        return self._fast

    def _try_dia(self):
        m, n = self.shape
        if m != n or self.nnz == 0:
            return None
        rows = row_of_entry(self.rowptr)
        off = self.cols.to(torch.int64) - rows
        uoff, inv, counts = torch.unique(off, return_inverse=True,
                                         return_counts=True)
        if len(uoff) > 32 or int(counts.min()) < 0.5 * n:
            return None
        diags = torch.zeros(len(uoff) * n, dtype=self.dtype, device=self.device)
        diags[inv * n + rows] = self.vals
        return DIAOperator(uoff.tolist(), diags.view(len(uoff), n),
                           shape=self.shape)


class ShellOperator(LinearOperator):
    """Operator defined by callbacks (MATSHELL analog): ``matvec`` (and
    ``rmatvec`` for A^H) take and return (n,) tensors on ``device``."""

    def __init__(self, shape, dtype, matvec: Callable,
                 rmatvec: Optional[Callable] = None,
                 nnz: Optional[int] = None, device=None):
        self.shape = tuple(shape)
        self.dtype = as_torch_dtype(dtype)
        self.device = resolve_device(device)
        self._matvec = matvec
        self._rmatvec = rmatvec
        self._nnz = nnz

    @property
    def nnz(self):
        return self._nnz if self._nnz is not None else self.shape[0] * self.shape[1]

    def mult(self, x):
        if not torch.is_tensor(x):
            x = as_operand(x, f"{type(self).__name__}.mult", self.dtype,
                           self.device, self.shape[1])
        return self._matvec(x)

    def mult_h(self, x):
        if self._rmatvec is None:
            raise ValueError("ShellOperator has no rmatvec")
        if not torch.is_tensor(x):
            x = as_operand(x, f"{type(self).__name__}.mult_h", self.dtype,
                           self.device, self.shape[0])
        return self._rmatvec(x)


class ScaledOperator(LinearOperator):
    def __init__(self, op: LinearOperator, alpha):
        self.op = op
        self.alpha = alpha
        self.shape = op.shape
        self.dtype = _with_coeffs(op.dtype, (alpha,))
        self.device = op.device

    @property
    def nnz(self):
        return self.op.nnz

    def mult(self, x):
        if not torch.is_tensor(x):
            x = as_operand(x, "ScaledOperator.mult", self.op.dtype,
                           self.device, self.shape[1])
        return self.alpha * self.op.mult(x)

    def mult_h(self, x):
        if not torch.is_tensor(x):
            x = as_operand(x, "ScaledOperator.mult_h", self.op.dtype,
                           self.device, self.shape[0])
        return self.alpha.conjugate() * self.op.mult_h(x)

    def explicit(self):
        M = self.op.explicit()
        return None if M is None else self.alpha * M


def _common(ops):
    dtype = ops[0].dtype
    for o in ops[1:]:
        dtype = torch.promote_types(dtype, o.dtype)
    return dtype, ops[0].device


def _with_coeffs(dtype: torch.dtype, coeffs) -> torch.dtype:
    """``dtype`` promoted to complex when a coefficient is complex (a
    complex shift of a real operator maps real vectors to complex ones)."""
    if any(np.imag(c) != 0 for c in coeffs) and not dtype.is_complex:
        return torch.promote_types(dtype, torch.complex64)
    return dtype


class SumOperator(LinearOperator):
    """sum_i coeff_i * op_i (same shape)."""

    def __init__(self, ops: Sequence[LinearOperator], coeffs: Sequence):
        self.ops = tuple(ops)
        self.coeffs = tuple(coeffs)
        self.shape = self.ops[0].shape
        self.dtype, self.device = _common(self.ops)
        self.dtype = _with_coeffs(self.dtype, self.coeffs)

    @property
    def nnz(self):
        return sum(o.nnz for o in self.ops)

    def _sum(self, x, adjoint: bool):
        y = None
        for c, o in zip(self.coeffs, self.ops):
            c = c.conjugate() if adjoint else c
            t = o.mult_h(x) if adjoint else o.mult(x)
            t = t if c == 1.0 else c * t
            y = t if y is None else y + t
        return y

    def mult(self, x):
        if not torch.is_tensor(x):  # one copy for all the terms
            x = as_operand(x, "SumOperator.mult", self.dtype, self.device,
                           self.shape[1])
        return self._sum(x, adjoint=False)

    def mult_h(self, x):
        if not torch.is_tensor(x):
            x = as_operand(x, "SumOperator.mult_h", self.dtype, self.device,
                           self.shape[0])
        return self._sum(x, adjoint=True)

    def explicit(self):
        """sum_i c_i M_i of the terms' host matrices, sparse while every
        term is; None when a term has no explicit form."""
        import scipy.sparse as sp

        parts = [o.explicit() for o in self.ops]
        if any(M is None for M in parts):
            return None
        dense = any(not sp.issparse(M) for M in parts)
        out = None
        for c, M in zip(self.coeffs, parts):
            t = c * (M.toarray() if dense and sp.issparse(M) else M)
            out = t if out is None else out + t
        return out


class ProductOperator(LinearOperator):
    """op_0 @ op_1 @ ... (applied right to left)."""

    def __init__(self, ops: Sequence[LinearOperator]):
        self.ops = tuple(ops)
        self.shape = (self.ops[0].shape[0], self.ops[-1].shape[1])
        self.dtype, self.device = _common(self.ops)

    @property
    def nnz(self):
        return sum(o.nnz for o in self.ops)

    def mult(self, x):
        if not torch.is_tensor(x):
            x = as_operand(x, "ProductOperator.mult", self.ops[-1].dtype,
                           self.device, self.shape[1])
        for o in reversed(self.ops):
            x = o.mult(x)
        return x

    def mult_h(self, x):
        if not torch.is_tensor(x):
            x = as_operand(x, "ProductOperator.mult_h", self.ops[0].dtype,
                           self.device, self.shape[0])
        for o in self.ops:
            x = o.mult_h(x)
        return x


class AdjointOperator(LinearOperator):
    def __init__(self, op: LinearOperator):
        self.op = op
        self.shape = (op.shape[1], op.shape[0])
        self.dtype = op.dtype
        self.device = op.device

    @property
    def nnz(self):
        return self.op.nnz

    def mult(self, x):
        if not torch.is_tensor(x):
            x = as_operand(x, "AdjointOperator.mult", self.dtype, self.device,
                           self.shape[1])
        return self.op.mult_h(x)

    def mult_h(self, x):
        if not torch.is_tensor(x):
            x = as_operand(x, "AdjointOperator.mult_h", self.dtype,
                           self.device, self.shape[0])
        return self.op.mult(x)

    @property
    def H(self):
        return self.op


class DiagonalOperator(LinearOperator):
    """diag(d); used for balancing, preconditioning, Omega signatures."""

    def __init__(self, d, device=None):
        self.d = _place(d, device)
        n = self.d.shape[0]
        self.shape = (n, n)
        self.dtype = self.d.dtype
        self.device = self.d.device

    @property
    def nnz(self):
        return self.shape[0]

    def mult(self, x):
        if not torch.is_tensor(x):
            x = as_operand(x, "DiagonalOperator.mult", self.dtype,
                           self.device, self.n)
        return self.d * x

    def mult_h(self, x):
        if not torch.is_tensor(x):
            x = as_operand(x, "DiagonalOperator.mult_h", self.dtype,
                           self.device, self.n)
        return self.d.conj() * x

    def explicit(self):
        import scipy.sparse as sp

        return sp.diags(self.d.cpu().numpy()).tocsr()


def norm_estimate_randomized(A: LinearOperator, seed: int = 0) -> float:
    """Randomized matrix-norm estimate: sqrt(n)*||A v|| for a normalized
    Gaussian v (reference: MatNormEstimate, src/sys/mat/matutil.c:391 —
    overestimates ||A||_2 with high probability; one matvec).  v is drawn
    with numpy, so both packages use the same vector."""
    n = A.shape[1]
    rng = np.random.default_rng(seed)
    v = rng.standard_normal(n)
    if A.dtype.is_complex:  # a complex start, as the reference's
        v = v + 1j * rng.standard_normal(n)
    v = v / np.linalg.norm(v)
    w = A.mult(torch.from_numpy(v).to(A.device, A.dtype))
    return float(torch.linalg.vector_norm(w)) * float(np.sqrt(n))


def aslinearoperator(A, device=None) -> LinearOperator:
    """Coerce a scipy sparse matrix, an array or a tensor into an operator
    on ``device`` (default: the card; a tensor keeps its device, a
    LinearOperator is returned as is)."""
    if isinstance(A, LinearOperator):
        return A
    import scipy.sparse as sp

    if sp.issparse(A):
        return AIJOperator.from_scipy(A, device=device)
    return DenseOperator(A, device=device)
