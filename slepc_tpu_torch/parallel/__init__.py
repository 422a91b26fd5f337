"""Task parallelism over contour points and host threads
(``slepc_tpu/parallel/``): the batched shifted solves of CISS and the host
thread pool.  The reference's device meshes (``make_task_mesh``,
``slice_submeshes``, ``thread_map_submesh``) wait for ROADMAP queue 1 item
16."""

from .tasks import (batched_shifted_solves, batched_shifted_solves_adaptive,
                    thread_map)

__all__ = ["batched_shifted_solves", "batched_shifted_solves_adaptive",
           "thread_map"]
