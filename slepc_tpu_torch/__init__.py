"""slepc_tpu_torch — the PyTorch + CUDA port of slepc_tpu, for NVIDIA Hopper.

It mirrors slepc_tpu's module tree and names (``sys mat bv ds st ksp rg eps
svd fn mfn lme pep nep ops``),
so one script can drive either package, and it never imports JAX.  Plain
tensor code is PyTorch; every Pallas kernel of the ported slice is a CUDA
kernel written by hand for ``sm_90a`` (``csrc/``), built with ``nvcc`` at
first use (``ops/_build.py``).

Ported so far: Hermitian Krylov-Schur -- ``EPS(A[, B], problem_type="hep" |
"ghep", which=..., nev=...)`` -- for extreme eigenvalues (plain, blocked or
Chebyshev-amplified with ``-eps_cheb_degree``), for interior eigenvalues
and generalized problems by shift-and-invert (``set_target``,
``STSinvert`` on a direct factorization, ``STSinvertDevice`` on CG / MINRES
inner solves on the card, ``STCayley``, a generalized ``STShift``) and for
all eigenvalues of an interval (spectrum slicing, certified by inertia), on
a DIA operator, on any scipy / PETSc-binary sparse matrix (``from_scipy``,
``load_operator``: CSR on the device) and on a ``ShellOperator``; with KSP,
the direct solvers, BV and DS beside it.  Non-Hermitian Krylov-Schur --
``EPS(A[, B], problem_type="nhep" | "gnhep" | "pgnhep")`` -- with the real
Schur form (conjugate pairs kept whole, complex eigenvectors of a real
operator), harmonic extraction, Krylov balancing, arbitrary selection and
regions (``RGEllipse``, ``RGInterval``, ``RGPolygon``, ``RGRing``); the
polynomial filter ``STFilter`` for interior eigenvalues by SpMVs alone; and
the solvers ``power`` (inverse iteration, RQI), ``subspace``, ``arnoldi``,
``lanczos`` and ``lapack``; the preconditioned solvers ``gd`` / ``jd``
(with the GD cycle), ``lobpcg`` and ``rqcg`` under ``STPrecond``, and the
contour-integral ``ciss`` (``parallel/tasks.py``'s batched shifted solves,
``sys/contour.py``).  The structured variants: the two-sided
Krylov-Schur (``set_two_sided``: left eigenvectors,
``get_left_eigenvector``), the indefinite pencil (``problem_type="ghiep"``,
pseudo-Lanczos) and the Bethe-Salpeter solver (``create_bse``,
``problem_type="bse"``), with the block divide-and-conquer of ``ds/bdc.py``.
Singular values: ``SVD(A, nsv=..., solver=...)`` with ``cross``,
``cyclic``, ``trlanczos`` / ``lanczos`` (thick-restart Golub-Kahan on
device bases), ``randomized`` and ``lapack``, the GSVD of a pair
(``B=``: cross pencil, or joint bidiagonalization for ``trlanczos``) and
the hyperbolic SVD (``omega=``), with ``DSSVD``, ``DSHSVD``, ``DSGSVD``.
Matrix functions and equations: ``FN`` (``FNExp``, ``FNLog``, ``FNSqrt``,
``FNInvSqrt``, ``FNPhi``, ``FNRational``, ``FNCombine``, ``fn_from_name``),
``MFN(A, fn)`` (y = f(A) b by restarted Krylov, ``krylov`` / ``expokit``),
``LME`` (Lyapunov, generalized Lyapunov, Sylvester and Stein equations
with low-rank factors) and the EPS solver ``lyapii``.  Polynomial
eigenproblems: ``PEP(mats, ...)`` with ``toar``, ``qarnoldi``, ``stoar``,
``linear`` and ``jd``, non-monomial bases, scalar and diagonal scaling,
extraction kinds, refinement, interval slicing and the contour ``ciss``,
with ``DSPEP``.  Nonlinear eigenproblems: ``NEP`` in split form
(``set_split_operators``) or callback form (``set_function``) with
``slp``, ``rii``, ``narnoldi``, ``interpol``, ``ciss`` and ``nleigs``
(compact or full basis), two-sided solves, the resolvent and refinement,
with ``DSNEP``.
Kernels: the DIA SpMV (K1/K2) and
block SpMM (K5), the CSR SpMV (K6), the CGS2 panel sweeps (K3), the restart
rotation (K4) and the stream yardstick (K7), with complex instantiations of
all but K7.

Row partition: under ``torch.distributed`` (NCCL on cards, gloo on the
CPU), ``set_mesh(make_row_mesh())`` sends the Hermitian fast path to each
rank's rows (``parallel/``: halo exchange around the same kernels, one
all-reduce per reduction), ``shard_operator`` splits any DIA / CSR
product's rows, TSQR (``BV`` block type ``tsqr``) and CISS's task mesh
(``eps.ciss_task_mesh``) run over the ranks.

Devices: every constructor and generator takes ``device``; ``None`` means
the CUDA card (or the device given to ``set_default_device``) and raises
without one, ``device="cpu"`` must be asked for (``sys/device.py``).  A tensor handed in keeps its device, and all work
happens where the operator lives.  A CUDA tensor goes to the kernel or
raises; only a tensor on the CPU takes the kernel's plain PyTorch version.
"""

__version__ = "0.1.0"

from .sys.options import Options, set_global_options, get_global_options
from .sys.events import (log_begin, log_end, log_event, log_reset,
                         log_spans, log_view)
from .sys.sort import Which, SortCriterion
from .sys.device import set_default_device
from .sys.mesh import (RowMesh, get_mesh, set_mesh, make_row_mesh,
                       init_distributed, shard_operator)
from .parallel import HaloDIAOperator, dia_spmv_halo
from .mat.linop import (LinearOperator, DenseOperator, ShellOperator,
                        AIJOperator, DIAOperator, IdentityOperator,
                        ScaledOperator, SumOperator, ProductOperator,
                        AdjointOperator, DiagonalOperator, aslinearoperator,
                        norm_estimate_randomized)
from .mat.structured import MatBSE, create_bse, create_tile
from .mat.generators import (laplacian_1d, laplacian_2d, laplacian_3d,
                             laplacian_1d_eigs, laplacian_2d_eigs,
                             laplacian_3d_eigs, from_scipy, from_dense,
                             random_sparse, markov, from_complex_dia)
from .mat.petsc_io import (load_operator, read_petsc_matrix,
                           write_petsc_matrix)
from .st import (ST, STShift, STSinvert, STCayley, STPrecond, STShell,
                 STSinvertDevice, SinvertCGOperator, ChebAmplifyOperator,
                 STFilter)
from .rg import RG, RGEllipse, RGInterval, RGPolygon, RGRing
from .ksp import KSP, DirectSolver, solve_linear
from .bv import BV, OrthogBlockType, OrthogRefine, OrthogType
from .ds import (DS, DSHEP, DSGHEP, DSGHIEP, DSNHEP, DSNHEPTS, DSGNHEP,
                 DSSVD, DSHSVD, DSGSVD, DSPEP, DSNEP)
from .fn import (FN, FNExp, FNLog, FNSqrt, FNInvSqrt, FNPhi, FNRational,
                 FNCombine, fn_from_name)
from .eps import EPS, EPSConvergedReason, EPSError, ProblemType
from .svd import SVD, SVDWhich
from .pep import PEP
from .nep import NEP
from .mfn import MFN
from .lme import LME
from .ops import launch_counts, reset_launch_counts

__all__ = [
    "Options",
    "set_global_options",
    "get_global_options",
    "log_begin",
    "log_end",
    "log_spans",
    "log_view",
    "log_reset",
    "log_event",
    "Which",
    "SortCriterion",
    "set_default_device",
    "RowMesh",
    "get_mesh",
    "set_mesh",
    "make_row_mesh",
    "init_distributed",
    "shard_operator",
    "HaloDIAOperator",
    "dia_spmv_halo",
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
    "markov",
    "from_complex_dia",
    "load_operator",
    "read_petsc_matrix",
    "write_petsc_matrix",
    "ST",
    "STShift",
    "STSinvert",
    "STCayley",
    "STPrecond",
    "STShell",
    "STSinvertDevice",
    "SinvertCGOperator",
    "ChebAmplifyOperator",
    "STFilter",
    "RG",
    "RGEllipse",
    "RGInterval",
    "RGPolygon",
    "RGRing",
    "KSP",
    "DirectSolver",
    "solve_linear",
    "BV",
    "OrthogType",
    "OrthogRefine",
    "OrthogBlockType",
    "DS",
    "DSHEP",
    "DSGHEP",
    "DSNHEP",
    "DSGNHEP",
    "DSGHIEP",
    "DSNHEPTS",
    "DSSVD",
    "DSHSVD",
    "DSGSVD",
    "DSPEP",
    "DSNEP",
    "FN",
    "FNExp",
    "FNLog",
    "FNSqrt",
    "FNInvSqrt",
    "FNPhi",
    "FNRational",
    "FNCombine",
    "fn_from_name",
    "create_tile",
    "create_bse",
    "MatBSE",
    "EPS",
    "EPSConvergedReason",
    "EPSError",
    "ProblemType",
    "SVD",
    "SVDWhich",
    "PEP",
    "NEP",
    "MFN",
    "LME",
    "launch_counts",
    "reset_launch_counts",
]
