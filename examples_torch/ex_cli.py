"""CLI-driven eigensolver — the reference's tutorial-binary pattern.

Every SLEPc tutorial binary is a full solver driver through the options
database (reference: src/eps/tutorials/ex1.c + epsopts.c); this script is
the same for slepc_tpu: the 2-D Laplacian eigenproblem, configured
entirely by PETSc-style flags.

    python examples/ex_cli.py -n 30 -m 29 -eps_nev 4 -eps_smallest_real \
        -eps_tol 1e-9 -eps_monitor_conv -eps_converged_reason \
        -eps_error_relative

    python examples/ex_cli.py -n 24 -m 24 -eps_nev 3 -eps_target 0.5 \
        -st_type sinvert -eps_error_relative
"""

import os
import sys

import numpy as np


def main(argv=None):
    import slepc_tpu_torch as st

    if os.environ.get("SLEPC_TPU_TORCH_DEVICE"):
        st.set_default_device(os.environ["SLEPC_TPU_TORCH_DEVICE"])

    st.set_global_options(" ".join(argv if argv is not None
                                   else sys.argv[1:]))
    o = st.sys.options.get_global_options()
    n = int(o.get("n", 30))
    m = int(o.get("m", n))
    A = st.laplacian_2d(n, m, dtype=np.float64)
    print(f"2-D Laplacian eigenproblem, {n}x{m} grid (N={n * m})")
    eps = st.EPS(A, problem_type="hep")
    if o.get("st_type") == "sinvert":
        from slepc_tpu_torch.st.st import STSinvert

        eps.set_st(STSinvert([A], sigma=complex(o.get("eps_target", 0.0)).real,
                             hermitian=True))
    eps.solve()
    if not getattr(eps, "_error_view_on_solve", False):
        eps.error_view()
    return eps


if __name__ == "__main__":
    main()
