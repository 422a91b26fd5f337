"""slepc_tpu_torch — the PyTorch + CUDA port of slepc_tpu, for NVIDIA Hopper.

It mirrors slepc_tpu's module tree and names (``sys mat st ksp eps ops``),
so one script can drive either package, and it never imports JAX.  Plain
tensor code is PyTorch; every Pallas kernel of the ported slice is a CUDA
kernel written by hand for ``sm_90a`` (``csrc/``), built with ``nvcc`` at
first use (``ops/_build.py``).

Ported so far: the Hermitian Krylov-Schur main path — ``EPS(A,
problem_type="hep", which=..., nev=...)``, plain or Chebyshev-amplified
(``-eps_cheb_degree``) — on a DIA operator, on any scipy / PETSc-binary
sparse matrix (``from_scipy``, ``load_operator``: CSR on the device) and on
a ``ShellOperator``, with the DIA SpMV (K1/K2), the CSR SpMV (K6), the CGS2
panel sweeps (K3) and the restart rotation (K4) as kernels.

Devices are explicit: an operator's tensors live on the device they were
built on, and all work happens there.  A CUDA tensor goes to the kernel or
raises; only a tensor on the CPU takes the kernel's plain PyTorch version.
"""

__version__ = "0.1.0"

from .sys.options import Options, set_global_options, get_global_options
from .sys.events import log_begin, log_view, log_reset, log_event
from .sys.sort import Which, SortCriterion
from .mat.linop import (LinearOperator, DenseOperator, ShellOperator,
                        AIJOperator, DIAOperator, IdentityOperator,
                        ScaledOperator, SumOperator, ProductOperator,
                        AdjointOperator, DiagonalOperator, aslinearoperator,
                        norm_estimate_randomized)
from .mat.generators import (laplacian_1d, laplacian_2d, laplacian_3d,
                             laplacian_1d_eigs, laplacian_2d_eigs,
                             laplacian_3d_eigs, from_scipy, from_dense,
                             random_sparse)
from .mat.petsc_io import (load_operator, read_petsc_matrix,
                           write_petsc_matrix)
from .st import STShift, ChebAmplifyOperator
from .eps import EPS, EPSConvergedReason, EPSError, ProblemType
from .ops import launch_counts, reset_launch_counts

__all__ = [
    "Options",
    "set_global_options",
    "get_global_options",
    "log_begin",
    "log_view",
    "log_reset",
    "log_event",
    "Which",
    "SortCriterion",
    "LinearOperator",
    "DenseOperator",
    "ShellOperator",
    "AIJOperator",
    "DIAOperator",
    "IdentityOperator",
    "ScaledOperator",
    "SumOperator",
    "ProductOperator",
    "AdjointOperator",
    "DiagonalOperator",
    "aslinearoperator",
    "norm_estimate_randomized",
    "laplacian_1d",
    "laplacian_2d",
    "laplacian_3d",
    "laplacian_1d_eigs",
    "laplacian_2d_eigs",
    "laplacian_3d_eigs",
    "from_scipy",
    "from_dense",
    "random_sparse",
    "load_operator",
    "read_petsc_matrix",
    "write_petsc_matrix",
    "STShift",
    "ChebAmplifyOperator",
    "EPS",
    "EPSConvergedReason",
    "EPSError",
    "ProblemType",
    "launch_counts",
    "reset_launch_counts",
]
