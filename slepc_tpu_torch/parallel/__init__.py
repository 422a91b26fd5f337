"""Multi-rank parallel pieces (``slepc_tpu/parallel/``): the halo-exchange
SpMVs of the row partition (``halo.py``, ``halo_pallas.py``: the
single-card kernels on each rank's slab rows, boundary rows exchanged over
``torch.distributed``), and task parallelism over contour points, slicing
partitions and host threads (``tasks.py``)."""

from .halo import HaloDIAOperator, dia_spmm_halo, dia_spmv_halo
from .halo_pallas import ShardedGELLPaddedOperator
from .tasks import (batched_shifted_solves, batched_shifted_solves_adaptive,
                    make_task_mesh, slice_submeshes, thread_map,
                    thread_map_submesh)

__all__ = ["dia_spmv_halo", "dia_spmm_halo", "HaloDIAOperator",
           "ShardedGELLPaddedOperator",
           "batched_shifted_solves", "batched_shifted_solves_adaptive",
           "make_task_mesh", "slice_submeshes", "thread_map",
           "thread_map_submesh"]
