"""Krylov (matrix-free) balancing for non-Hermitian problems
(``slepc_tpu/eps/balance.py``).

A diagonal D from a few random +-1 probes through A and A^H, such that
D^-1 A D has more balanced row and column norms (Chen & Demmel): it
improves the accuracy of the Krylov solve on badly scaled non-normal
matrices.  The probes are ``default_rng(seed)`` draws, so both packages
probe with the same vectors; each probe is one ``mult`` and one ``mult_h``
on the operator's device and one host read.
"""

from __future__ import annotations

import numpy as np
import torch

from ..mat.linop import DiagonalOperator, LinearOperator, ProductOperator


def _host(x: torch.Tensor) -> np.ndarray:
    return x.detach().cpu().numpy()


def krylov_balance(A: LinearOperator, its: int = 5, seed: int = 0):
    """The balancing diagonal d (Chen-Demmel two-sided estimate), a host
    array."""
    n = A.shape[0]
    rng = np.random.default_rng(seed)
    d = np.ones(n)

    def dev(v):
        return torch.from_numpy(v).to(A.device, A.dtype)

    for _ in range(its):
        z = rng.choice([-1.0, 1.0], size=n)
        # p_i ~ row norms of A diag(d); q_i ~ column norms of diag(1/d) A.
        # Balance of diag(1/d) A diag(d) means p_i / d_i == q_i d_i: the
        # fixed-point update is d = sqrt(p / q)
        p = np.abs(_host(A.mult(dev(z * d))))
        q = np.abs(_host(A.mult_h(dev(z / d))))
        with np.errstate(divide="ignore", invalid="ignore"):
            d = np.sqrt(np.where((p > 1e-300) & (q > 1e-300), p / q, d ** 2))
        d = np.clip(d, 1e-30, 1e30)
    # normalize so that the geometric mean is 1
    return d / np.exp(np.mean(np.log(np.clip(d, 1e-300, None))))


def balanced_operator(A: LinearOperator, d: np.ndarray) -> LinearOperator:
    """D^-1 A D as an operator composition (the same spectrum)."""
    D = DiagonalOperator(torch.from_numpy(np.asarray(d)).to(A.device, A.dtype))
    Dinv = DiagonalOperator(
        torch.from_numpy(1.0 / np.asarray(d)).to(A.device, A.dtype))
    return ProductOperator((Dinv, A, D))
