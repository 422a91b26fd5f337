"""Halo-exchange DIA SpMV over the row partition
(``slepc_tpu/parallel/halo.py`` and the layout of ``halo_pallas.py``).

y[i] = sum_d diags[d][i] * x[i + offsets[d]] with the rows split over the
ranks of a :class:`~slepc_tpu_torch.sys.mesh.RowMesh`.  A shifted read
crosses a rank boundary by at most h = max|offset| rows, so each SpMV ships
only the 2h boundary rows to the two neighbours (the role of VecScatter's
ghost update in PETSc's MatMult_MPIAIJ), and the local product is the
single-card kernel, unchanged: K1 / K2 (K1c / K2c for complex diagonals)
for a vector, K5 / K5c for a block of rows, one exchange for the block.

The slab layout (the reference's padded layout, ``halo_pallas.py:1-25``):
every local row -- a basis row, a vector -- is ``h + nloc + h`` long.  The
interior [h, h + nloc) holds the rank's rows; the two halos hold zeros at
rest.  An SpMV writes the neighbours' boundary rows into its input's halos,
runs the kernel on the slab with diagonals that are zero on the halo rows
(so the output's halos come out zero and it chains as the next input),
and zeroes the input's halos again.  The dots and rotations of the Krylov
cycle (K3, K4) then see zeros in the halos and need no mask.  The cost is
2h / nloc of every basis read (1.7% on the 10.35M-row flagship at two
ranks); the other layout, a copy of x into an (nloc + 2h) buffer each SpMV,
would add one n-vector read and write a step (about 20% of K2's bytes).

Requirement: h <= the smallest rank's row count (the halo comes from the
nearest neighbour only); a wider reach raises ``ValueError``.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from ..mat.linop import DIAOperator, LinearOperator, as_operand
from ..sys.mesh import RowMesh, get_mesh


def _halo_width(offsets: Sequence[int]) -> int:
    return max((abs(int(o)) for o in offsets), default=0)


def _with_halos(mesh: RowMesh, X: torch.Tensor, h: int, fn):
    """fn(X) on slab rows X (..., h + nloc + h) with their halos filled by
    one exchange; the halos are zero again after."""
    nloc = X.shape[-1] - 2 * h
    mesh.halo_exchange(X, h, nloc)
    try:
        return fn(X)
    finally:
        X[..., :h] = 0
        X[..., h + nloc:] = 0


class SlabOperator(LinearOperator):
    """An operator on the slab rows of a row partition: ``slab`` is the
    rank's operator on the (h + nloc + h)-long slab (zero rows in the
    halos), and every product fills the input's halos first and zeroes
    them after.  ``shape`` is the slab's (the length of a local row);
    ``n_global`` the partitioned operator's."""

    def __init__(self, slab: LinearOperator, mesh: RowMesh, n_global: int,
                 h: int):
        self.slab, self.mesh, self.h = slab, mesh, int(h)
        self._n_global = int(n_global)
        self.lo, self.hi = mesh.row_range(n_global)
        self.nloc = self.hi - self.lo
        smallest = mesh.row_range(n_global, mesh.world - 1)
        if self.h > smallest[1] - smallest[0]:
            raise ValueError(
                f"{type(self).__name__}: halo {self.h} exceeds the smallest "
                f"rank's {smallest[1] - smallest[0]} rows; offsets must stay "
                f"within the nearest neighbour")
        n = self.nloc + 2 * self.h
        self.shape = (n, n)
        self.dtype, self.device = slab.dtype, slab.device

    @property
    def nnz(self):
        return self.slab.nnz

    @property
    def n_global(self) -> int:
        return self._n_global

    # ---- rows ------------------------------------------------------------
    def local_rows(self, X) -> torch.Tensor:
        """This rank's slab rows of a global (..., n_global) block (numpy or
        tensor): the interior from X[..., lo:hi], zero halos."""
        X = X if torch.is_tensor(X) else torch.from_numpy(X)
        out = torch.zeros(X.shape[:-1] + (self.shape[0],), dtype=self.dtype,
                          device=self.device)
        out[..., self.h: self.h + self.nloc] = X[..., self.lo: self.hi]
        return out

    def interior(self, X: torch.Tensor) -> torch.Tensor:
        """The rank's own rows of slab rows X (a view)."""
        return X[..., self.h: self.h + self.nloc]

    def gather(self, X: torch.Tensor) -> torch.Tensor:
        """The global (..., n_global) rows from every rank's slab rows."""
        return self.mesh.gather_rows(self.interior(X), self.n_global)

    def zero_halos(self, X: torch.Tensor) -> torch.Tensor:
        X[..., : self.h] = 0
        X[..., self.h + self.nloc:] = 0
        return X

    # ---- products ----------------------------------------------------------
    def _shard(self, x, where: str, ndims) -> torch.Tensor:
        """The array rule on a rank: a numpy x is this rank's shard, either
        its slab row(s) or its own nloc rows, which go between zero
        halos."""
        t = as_operand(x, where, self.dtype, self.device, ndims=ndims)
        if t.shape[-1] == self.shape[1]:
            return t
        if t.shape[-1] != self.nloc:
            raise ValueError(
                f"{where}: an array of {t.shape[-1]} entries; this rank "
                f"takes its {self.nloc} rows or its {self.shape[1]}-long "
                f"slab")
        out = torch.zeros(t.shape[:-1] + (self.shape[1],), dtype=t.dtype,
                          device=t.device)
        out[..., self.h: self.h + self.nloc] = t
        return out

    def mult(self, x: torch.Tensor) -> torch.Tensor:
        """y's slab row (its halos zero) from x's: a tensor slab row, or a
        numpy shard (:meth:`_shard`)."""
        if not torch.is_tensor(x):
            x = self._shard(x, f"{type(self).__name__}.mult", (1,))
        return _with_halos(self.mesh, x, self.h, self.slab.mult)

    def mult_block(self, X: torch.Tensor) -> torch.Tensor:
        if not torch.is_tensor(X):
            X = self._shard(X, f"{type(self).__name__}.mult_block", (2,))
        return _with_halos(self.mesh, X, self.h,
                           LinearOperator.block_of(self.slab))


def _slab_diags(offsets, diags: torch.Tensor, lo: int, hi: int,
                h: int) -> torch.Tensor:
    d = torch.zeros((len(offsets), hi - lo + 2 * h), dtype=diags.dtype,
                    device=diags.device)
    d[:, h: h + hi - lo] = diags[:, lo:hi]
    return d


class HaloDIAOperator(SlabOperator):
    """A DIA operator on the row partition (reference ``HaloDIAOperator``):
    the rank's diagonals on its slab, K1 / K2 (K5 for a block) on the
    slab after one halo exchange.  Build with :meth:`from_dia`."""

    def __init__(self, offsets, diags, mesh: Optional[RowMesh] = None,
                 adjoint_of: Optional[DIAOperator] = None):
        mesh = mesh if mesh is not None else get_mesh()
        if mesh is None:
            raise ValueError("HaloDIAOperator requires a row mesh "
                             "(slepc_tpu_torch.set_mesh)")
        self.offsets = tuple(int(o) for o in offsets)
        n = diags.shape[1]
        h = _halo_width(self.offsets)
        lo, hi = mesh.row_range(n)
        self.diags = _slab_diags(self.offsets, diags, lo, hi, h)
        self._source = adjoint_of
        self._adj = None
        super().__init__(DIAOperator(self.offsets, self.diags), mesh, n, h)

    @classmethod
    def from_dia(cls, op: DIAOperator, mesh: Optional[RowMesh] = None):
        return cls(op.offsets, op.diags, mesh, adjoint_of=op)

    def mult_h(self, x: torch.Tensor) -> torch.Tensor:
        """A^H on the same kernel, over the adjoint's diagonals (built from
        the global operator at the first call)."""
        if self._adj is None:
            if self._source is None:
                raise ValueError("HaloDIAOperator.mult_h needs the global "
                                 "operator (build it with from_dia)")
            adj = self._source.adjoint()
            self._adj = HaloDIAOperator(adj.offsets, adj.diags, self.mesh)
        return self._adj.mult(x)

    def rmult(self, x: torch.Tensor) -> torch.Tensor:
        """The adjoint apply (the reference's name): :meth:`mult_h`."""
        return self.mult_h(x)

    def to_dense(self) -> torch.Tensor:
        """The global (n, n) matrix on every rank, its diagonals gathered
        from the ranks (one all-gather); for small test sizes."""
        d = self.mesh.gather_rows(self.interior(self.diags), self.n_global)
        n = self.n_global
        A = torch.zeros((n, n), dtype=self.dtype, device=self.device)
        for k, off in enumerate(self.offsets):
            rows = torch.arange(max(0, -off), min(n, n - off),
                                device=self.device)
            A[rows, rows + off] = d[k, rows]
        return A


def _slab_operands(where: str, diags, x, ndims):
    if not torch.is_tensor(diags):
        diags = as_operand(diags, where, None,
                           x.device if torch.is_tensor(x) else None,
                           ndims=(2,))
    if not torch.is_tensor(x):
        x = as_operand(x, where, diags.dtype, diags.device, diags.shape[1],
                       ndims=ndims)
    return diags, x


def dia_spmv_halo(diags: torch.Tensor, x: torch.Tensor, *, offsets: tuple,
                  mesh: RowMesh) -> torch.Tensor:
    """One halo exchange and K1 / K2 on the slab: ``diags`` are the rank's
    slab diagonals (zero on the halo rows), ``x`` its slab row with zero
    halos (filled here and zeroed again); returns y's slab row.  Numpy
    arguments follow the array rule (on diags' device)."""
    diags, x = _slab_operands("dia_spmv_halo", diags, x, (1,))
    return _with_halos(mesh, x, _halo_width(offsets),
                       DIAOperator(offsets, diags).mult)


def dia_spmm_halo(diags: torch.Tensor, X: torch.Tensor, *, offsets: tuple,
                  mesh: RowMesh) -> torch.Tensor:
    """The block form: one exchange ships the boundary rows of all b rows of
    X (b, slab), then K5 on the slab."""
    diags, X = _slab_operands("dia_spmm_halo", diags, X, (2,))
    return _with_halos(mesh, X, _halo_width(offsets),
                       DIAOperator(offsets, diags).mult_block)
