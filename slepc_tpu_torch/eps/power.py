"""EPS power iteration, inverse iteration and RQI (``slepc_tpu/eps/power.py``).

Power iteration on the ST-transformed operator: with ``STSinvert`` it is
inverse iteration.  Shift variants (``eps.power_shift_type``):

  * 'constant': the ST's shift stays.  The steps run on the device, with
    no host read inside a chunk of ``eps.power_chunk`` steps (16): one read
    of (theta, ||w - theta v||, breakdown) per convergence check.  The
    reference fuses the chunk into one XLA program for the same reason
    (``power.py:19-40``); here the steps are eager PyTorch calls (the SpMV
    is the operator's kernel), so the iteration count and the trajectory
    are the reference's;
  * 'rayleigh': Rayleigh quotient iteration, the shift moved to the current
    Rayleigh quotient every step (one host read a step);
  * 'wilkinson': run as 'constant', as the reference runs it (SLEPc's
    Wilkinson shift is ROADMAP queue 3's open item).

Converged pairs are deflated: each new vector is kept orthogonal to the
locked ones.  ``EPS.set_power_nonlinear`` runs the nonlinear inverse
iteration A(x) x = lambda B(x) x with a direct solve a step.
"""

from __future__ import annotations

import numpy as np
import torch

from .base import (EPS, EPSConvergedReason, EPSSolver, start_vector,
                   work_dtype)


def _deflate(v: torch.Tensor, X: list) -> torch.Tensor:
    """v minus its projection on the locked rows X (one projector)."""
    if not X:
        return v
    Xs = torch.stack(X)
    return v - (Xs.conj() @ v) @ Xs


def _scalar(x):
    """A host number: float for a real value, complex for a complex one."""
    return complex(x) if np.iscomplexobj(x) else float(x)


class Power(EPSSolver):
    def solve(self, eps: EPS) -> None:
        if getattr(eps, "power_nonlinear", None) is not None:
            _nonlinear_spi(eps)
            return
        st = eps.st
        op = st.op()
        n = eps.n
        # a complex shift of a real operator works in complex arithmetic
        dtype, device = work_dtype(eps, op), eps.A.device
        shift_type = eps.power_shift_type
        if shift_type not in ("constant", "rayleigh", "wilkinson"):
            raise ValueError(f"power shift type {shift_type!r} is not "
                             f"constant, rayleigh or wilkinson")
        rng = np.random.default_rng(0)
        X: list = []  # converged (locked) vectors
        lams: list = []
        errs: list = []
        eps.its = 0
        chunk = int(eps.power_chunk)
        # a transform that solves with a direct factorization other than
        # the dense one steps one iteration at a time, as in the reference
        # (its host-solve rule, slepc_tpu/st/st.py:170-176), so both count
        # the same iterations
        ksp = getattr(st, "ksp", None)
        host_solve = (ksp is not None and ksp.method == "direct"
                      and getattr(ksp, "_direct", None) is not None
                      and ksp._direct.backend != "dense")
        chunked = shift_type != "rayleigh" and chunk > 1 and not host_solve

        for pair in range(eps.nev):
            v = start_vector(rng, n, dtype)
            if eps.initial_space is not None and \
                    pair < eps.initial_space.shape[1]:
                v = np.asarray(eps.initial_space[:, pair])
            vj = _deflate(torch.from_numpy(v).to(device, dtype), X)
            vj = vj / torch.linalg.vector_norm(vj)
            theta, err = 0.0, np.inf
            converged = False
            while chunked and eps.its < eps.max_it:
                steps = min(chunk, eps.max_it - eps.its)
                brk = torch.zeros((), dtype=torch.bool, device=device)
                for _ in range(steps):
                    w = _deflate(op.mult(vj), X)
                    th = torch.vdot(vj, w)
                    rn = torch.linalg.vector_norm(w - th * vj)
                    nw = torch.linalg.vector_norm(w)
                    vj = w / torch.where(nw > 0, nw, torch.ones_like(nw))
                    brk = brk | (nw == 0)
                eps.its += steps
                host = torch.stack([th, rn.to(th.dtype),
                                    brk.to(th.dtype)]).cpu().numpy()
                theta = _scalar(host[0])
                err = eps.conv_measure(theta, float(host[1].real))
                if host[2]:
                    # ||w|| hit zero inside the chunk: breakdown, not
                    # convergence
                    break
                if len(eps.monitor):
                    eps.monitor(eps, eps.its, pair, np.array(lams + [theta]),
                                np.array(errs + [err]))
                if err < eps.tol:
                    converged = True
                    break
                if not np.isfinite(err):
                    break
            while not chunked and eps.its < eps.max_it:
                eps.its += 1
                if shift_type == "rayleigh" and theta != 0.0:
                    # RQI: move the shift to the current Rayleigh quotient
                    st.set_shift(st.back_transform(np.array([theta]))[0])
                    op = st.op()
                w = _deflate(op.mult(vj), X)
                theta = _scalar(torch.vdot(vj, w).cpu().numpy())
                err = eps.conv_measure(theta, float(
                    torch.linalg.vector_norm(w - theta * vj)))
                if len(eps.monitor):
                    eps.monitor(eps, eps.its, pair, np.array(lams + [theta]),
                                np.array(errs + [err]))
                nw = float(torch.linalg.vector_norm(w))
                if nw == 0:
                    break
                vj = w / nw
                if err < eps.tol:
                    converged = True
                    break
            lams.append(st.back_transform(np.array([theta]))[0])
            errs.append(err)
            X.append(vj)
            if not converged:
                eps.reason = EPSConvergedReason.DIVERGED_ITS
                break

        eps.nconv = sum(1 for e in errs if e < eps.tol)
        eps.eigenvalues = np.real(np.array(lams)) \
            if np.all(np.abs(np.imag(lams)) < 1e-14) else np.array(lams)
        eps.errests = np.array(errs)
        eps._eigenvectors = torch.stack(X) if X else \
            torch.zeros((0, n), dtype=dtype, device=device)


def _nonlinear_spi(eps: EPS) -> None:
    """Nonlinear inverse power iteration (SPI) for A(x) x = lambda B(x) x
    (EPSPowerSetNonlinear): each step solves A(x_k) y = B(x_k) x_k with a
    direct KSP, normalizes with the first largest entry positive, and takes
    the generalized Rayleigh quotient at the new iterate."""
    from ..ksp import KSP

    A_of_x, B_of_x = eps.power_nonlinear
    n = eps.n
    dtype, device = eps.A.dtype, eps.A.device
    rng = np.random.default_rng(0)
    x = start_vector(rng, n, dtype)
    if eps.initial_space is not None:
        x = np.asarray(eps.initial_space[:, 0]).copy()
    x = torch.from_numpy(x / np.linalg.norm(x)).to(device, dtype)
    eps.its = 0
    lam, err = 0.0, np.inf
    Ax_op = A_of_x(x)
    while eps.its < eps.max_it:
        eps.its += 1
        Bx = B_of_x(x).mult(x) if B_of_x is not None else x
        y = KSP(Ax_op, method="direct").solve(Bx)
        ny = float(torch.linalg.vector_norm(y))
        if ny == 0:
            break
        y = y / ny
        i0 = int(torch.argmax(y.abs()))
        if y.is_complex():  # the largest entry real and positive
            y = y * (y[i0].abs() / y[i0])
        elif float(y[i0]) < 0:
            y = -y
        # the true residual: the operators at the new iterate (the matrix
        # is reused for the next step's solve)
        Ay_op = A_of_x(y)
        Ay = Ay_op.mult(y)
        By = B_of_x(y).mult(y) if B_of_x is not None else y
        num = _scalar(torch.vdot(y, Ay).cpu().numpy())
        den = _scalar(torch.vdot(y, By).cpu().numpy())
        lam = num / den if abs(den) > 1e-300 else num
        err = eps.conv_measure(lam, float(torch.linalg.vector_norm(
            Ay - lam * By)))
        eps.monitor(eps, eps.its, 0, np.array([lam]), np.array([err]))
        x = y
        Ax_op = Ay_op
        if err < eps.tol:
            break
    eps.nconv = 1 if err < eps.tol else 0
    eps.eigenvalues = np.array([lam])
    eps.errests = np.array([err])
    eps._eigenvectors = x[None].clone()


EPS.register("power", Power)
