"""The partitioned operators of the Hermitian fast path
(``slepc_tpu/parallel/halo_pallas.py``).

The reference runs its single-chip Pallas kernels under ``shard_map`` on
padded local slabs; here the same composition is the single-card CUDA
kernels on the slab rows of ``parallel/halo.py``, so this module adds no
kernel of its own:

  * the DIA form is :class:`~slepc_tpu_torch.parallel.halo.HaloDIAOperator`
    (f32 on K1, f64 on K2 -- the reference's double-single f64 tier
    ``ShardedDIAPaddedOperatorDS`` is native f64 here --, complex on K1c /
    K2c, blocks on K5 / K5c): the reference's padded Pallas form
    (``ShardedDIAPaddedOperator``, ``dia_spmv_padded_sharded``) and its
    plain halo form are one operator here, as the slab layout is the
    padded one;
  * :class:`ShardedGELLPaddedOperator` is a CSR matrix on the partition:
    the rank's rows, their column indices remapped into the slab, K6 on
    the slab after one halo exchange.  A matrix whose reach (the farthest
    column from its row's block) exceeds the smallest rank's rows raises
    ``ValueError``; the fast path then partitions it the GSPMD way
    (``sys/mesh.py`` ``shard_operator``), as the reference's ``try`` at
    ``eps/ks_jit.py:1098-1104`` leaves it to GSPMD.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..mat.linop import AIJOperator
from ..sys.mesh import RowMesh, get_mesh
from .halo import SlabOperator

class ShardedGELLPaddedOperator(SlabOperator):
    """A square CSR matrix on the row partition (K6 on the rank's slab).
    Every rank holds the global matrix while it builds its part, and the
    ranks build together: the halo width is the largest reach over the
    ranks (one all-reduce)."""

    def __init__(self, A: AIJOperator, mesh: Optional[RowMesh] = None):
        mesh = mesh if mesh is not None else get_mesh()
        if mesh is None:
            raise ValueError("ShardedGELLPaddedOperator needs a row mesh")
        m, n = A.shape
        if m != n:
            raise ValueError(f"ShardedGELLPaddedOperator: the matrix is "
                             f"{m} x {n}, not square")
        lo, hi = mesh.row_range(n)
        a, b = int(A.rowptr[lo]), int(A.rowptr[hi])
        cols = A.cols[a:b].to(torch.int64)
        reach = 0
        if b > a:
            reach = max(lo - int(cols.min()), int(cols.max()) - (hi - 1), 0)
        reach = torch.tensor([float(reach)], device=mesh.device)
        h = int(mesh.allreduce(reach, "max")[0])
        nloc = hi - lo
        rowptr = torch.cat([
            torch.zeros(h, dtype=torch.int64, device=A.device),
            A.rowptr[lo: hi + 1] - a,
            torch.full((h,), b - a, dtype=torch.int64, device=A.device)])
        slab = AIJOperator(rowptr, cols - (lo - h), A.vals[a:b],
                           (nloc + 2 * h, nloc + 2 * h))
        self._source = A
        self._adj = None
        super().__init__(slab, mesh, n, h)

    def mult_h(self, x: torch.Tensor) -> torch.Tensor:
        """A^H on K6, over the global adjoint's rows (built at the first
        call, by every rank together)."""
        if self._adj is None:
            self._adj = ShardedGELLPaddedOperator(self._source.adjoint(),
                                                  self.mesh)
        return self._adj.mult(x)
