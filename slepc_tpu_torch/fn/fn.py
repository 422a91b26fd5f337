"""FN -- scalar and matrix functions (``slepc_tpu/fn/fn.py``, copied).

Reference: src/sys/classes/fn/ -- scalar f(x)/f'(x) plus dense matrix f(A)
and f(A)b with multiple selectable methods per type (exp Pade
scaling-and-squaring fnexp.c:33, Higham s&s :797; sqrt Denman-Beavers;
phi_k functions; rational p/q; combined functions).  Consumed by MFN
(f of the projected Hessenberg), LME and the polynomial solvers.

These act on the small projected matrices, so they are host numpy/scipy, as
in slepc_tpu: the port keeps its own copy of the module (it imports nothing
of slepc_tpu), line for line but for FNCombine's check of its operation,
which raises ValueError where the reference asserts, so both packages
evaluate the same functions the same way.  Scaling semantics follow FNSetScale: the evaluated function
is  beta * f(alpha * x).
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Sequence

import numpy as np
import scipy.linalg as sla


class _FNMeta(type):
    """``FN("exp", ...)`` dispatches to the registered type (slepc4py's
    ``FN().setType('exp')`` role); subclass construction is untouched."""

    def __call__(cls, *args, **kw):
        if cls is FN and args and isinstance(args[0], str):
            return fn_from_name(args[0], *args[1:], **kw)
        return super().__call__(*args, **kw)


class FN(metaclass=_FNMeta):
    """Base scalar/matrix function with FNSetScale semantics:
    alpha = INNER scaling (argument), beta = OUTER scaling (result),
    evaluate beta * f(alpha * x) — exactly the reference convention
    (FNSetScale, src/sys/classes/fn/interface/fnbasic.c:263-286; the
    round-5 NEP-delay golden caught the arguments reversed)."""

    def __init__(self, alpha: complex = 1.0, beta: complex = 1.0):
        self.alpha = alpha
        self.beta = beta
        self.method = 0

    # subclasses implement the unscaled _f / _fprime / _fmat
    def _f(self, x):
        raise NotImplementedError

    def _fprime(self, x):
        raise NotImplementedError

    def _fmat(self, A):
        raise NotImplementedError

    def set_scale(self, alpha, beta=1.0):
        """alpha: inner (argument) scale; beta: outer (result) scale."""
        self.alpha, self.beta = alpha, beta

    def set_method(self, m: int):
        self.method = m

    def eval(self, x):
        """beta * f(alpha x) (reference FNEvaluateFunction)."""
        return self.beta * self._f(self.alpha * np.asarray(x))

    def eval_deriv(self, x):
        """beta*alpha*f'(alpha x) (reference FNEvaluateDerivative)."""
        return self.beta * self.alpha * self._fprime(
            self.alpha * np.asarray(x))

    def eval_mat(self, A) -> np.ndarray:
        """beta * f(alpha A) for dense A (reference FNEvaluateFunctionMat)."""
        A = np.asarray(A)
        return self.beta * self._fmat(self.alpha * A)

    def eval_mat_vec(self, A, b) -> np.ndarray:
        """f(A) b (reference FNEvaluateFunctionMatVec); A small dense."""
        return self.eval_mat(A) @ np.asarray(b)


class FNExp(FN):
    """exp(x).  Methods (reference method table fnexp.c:1656-1664):
    0 = scipy expm (Al-Mohy–Higham scaling & squaring — the reference's
        Higham [m/m] Padé role, fnexp.c:797),
    1 = own Padé scaling-and-squaring (fnexp.c:33 role),
    2 = Hermitian eigendecomposition fast path (ours),
    3 = scaled & squared SUBDIAGONAL Padé, partial-fraction form
        (Güttel–Nakatsukasa SIMAX 2016; fnexp.c:410 role) — robust for
        non-normal A with large norm,
    4 = same, product (root-factored) form."""

    def _f(self, x):
        return np.exp(x)

    _fprime = _f

    def _fmat(self, A):
        if self.method == 1:
            return _expm_pade(A)
        if self.method == 2:
            w, V = np.linalg.eigh(0.5 * (A + A.conj().T))
            return (V * np.exp(w)) @ V.conj().T
        if self.method in (3, 4):
            return _expm_subdiag_pade(
                A, form="pf" if self.method == 3 else "prod")
        return sla.expm(A)


class FNLog(FN):
    """log(x); matrix log via inverse scaling-and-squaring (scipy logm)."""

    def _f(self, x):
        return np.log(x.astype(complex) if np.any(np.real(x) <= 0) else x)

    def _fprime(self, x):
        return 1.0 / x

    def _fmat(self, A):
        F = sla.logm(np.asarray(A))
        return _realify(F, A)


class FNSqrt(FN):
    """sqrt(x).  Methods (reference method table fnsqrt.c:369-374):
    0 = scipy sqrtm (Schur), 1 = Denman–Beavers (pair form),
    2 = Denman–Beavers PRODUCT form, 3 = Newton–Schulz (inverse-free;
    needs ||I - A|| < 1 after scaling), 4 = Sadeghi iteration."""

    def _f(self, x):
        return np.sqrt(x.astype(complex) if np.any(np.real(x) < 0) else x)

    def _fprime(self, x):
        return 0.5 / self._f(x)

    def _fmat(self, A):
        if self.method == 1:
            return _sqrtm_db(A)
        if self.method == 2:
            return _sqrtm_db_product(A)
        if self.method == 3:
            return _sqrtm_newton_schulz(A)
        if self.method == 4:
            return _sqrtm_sadeghi(A)
        F = sla.sqrtm(np.asarray(A))
        return _realify(F, A)


class FNInvSqrt(FN):
    """x^{-1/2}; via DB iteration producing the inverse root directly."""

    def _f(self, x):
        return 1.0 / np.sqrt(x.astype(complex) if np.any(np.real(x) < 0) else x)

    def _fprime(self, x):
        return -0.5 * self._f(x) / x

    def _fmat(self, A):
        if self.method == 1:
            Y, Z = _sqrtm_db_pair(A)
            return Z  # Z -> A^{-1/2}
        F = np.linalg.inv(_realify(sla.sqrtm(np.asarray(A)), A))
        return F


class FNPhi(FN):
    """phi_k functions: phi_0=exp, phi_k(x) = (phi_{k-1}(x) - 1/(k-1)!)/x.

    Matrix phi_k via the augmented-exponential construction
    exp([[A, E],[0, J]]) (Sidje '98) — the reference's FNPHI
    (impls/phi/fnphi.c)."""

    def __init__(self, k: int = 1, alpha=1.0, beta=1.0):
        super().__init__(alpha, beta)
        self.k = int(k)

    def _f(self, x):
        x = np.asarray(x, dtype=complex)
        out = np.empty_like(x)
        flat = x.ravel()
        res = np.array([_phi_scalar(self.k, xi) for xi in flat])
        out = res.reshape(x.shape)
        if np.all(np.isreal(out)):
            out = out.real
        return out

    def _fprime(self, x):
        # phi_k' = phi_{k-1,shifted}: d/dx phi_k = (phi_{k-1} - k phi_k)/x
        x = np.asarray(x, dtype=complex)
        pk = self._f(x)
        pk1 = FNPhi(self.k - 1)._f(x) if self.k > 0 else np.exp(x)
        with np.errstate(divide="ignore", invalid="ignore"):
            d = np.where(x != 0, (pk1 - self.k * pk) / x, 1.0 / math.factorial(self.k + 1))
        return d

    def _fmat(self, A):
        A = np.asarray(A)
        n = A.shape[0]
        k = self.k
        if k == 0:
            return sla.expm(A)
        # Block form: exp([[A, B],[0, J]])[0:n, n+k-1] = phi_k(A) b with
        # B = [b 0 ... 0] and J the k x k upper-shift; process identity
        # columns one at a time for the full matrix phi_k(A).
        F = np.zeros((n, n), dtype=complex)
        J = np.diag(np.ones(k - 1), 1) if k > 1 else np.zeros((1, 1))
        for j in range(n):
            W = np.zeros((n + k, n + k), dtype=complex)
            W[:n, :n] = A
            W[:n, n] = np.eye(n)[:, j]
            W[n:, n:] = J
            E = sla.expm(W)
            F[:, j] = E[:n, n + k - 1]
        return _realify(F, A)


def _phi_scalar(k: int, x: complex) -> complex:
    if abs(x) < 1e-4:
        # Taylor: phi_k(x) = sum_j x^j / (j+k)!
        s, t = 0.0 + 0j, 1.0
        for j in range(12):
            s += t / math.factorial(j + k)
            t *= x
        return s
    if k == 0:
        return np.exp(x)
    return (_phi_scalar(k - 1, x) - 1.0 / math.factorial(k - 1)) / x


class FNRational(FN):
    """p(x)/q(x) with coefficients high-to-low (reference FNRATIONAL,
    impls/rational/fnrational.c).  q omitted => polynomial."""

    def __init__(self, num: Sequence[float], den: Optional[Sequence[float]] = None,
                 alpha=1.0, beta=1.0):
        super().__init__(alpha, beta)
        self.num = np.asarray(num, dtype=float)
        self.den = None if den is None else np.asarray(den, dtype=float)

    def _f(self, x):
        p = np.polyval(self.num, x)
        if self.den is None:
            return p
        return p / np.polyval(self.den, x)

    def _fprime(self, x):
        dp = np.polyval(np.polyder(self.num), x)
        if self.den is None:
            return dp
        p = np.polyval(self.num, x)
        q = np.polyval(self.den, x)
        dq = np.polyval(np.polyder(self.den), x)
        return (dp * q - p * dq) / q**2

    def _fmat(self, A):
        A = np.asarray(A)
        n = A.shape[0]
        P = _polyvalm(self.num, A)
        if self.den is None:
            return P
        Q = _polyvalm(self.den, A)
        return np.linalg.solve(Q, P)


class FNCombine(FN):
    """Combination of two FNs: add / multiply / divide / compose
    (reference FNCOMBINE, impls/combine/fncombine.c)."""

    def __init__(self, op: str, f1: FN, f2: FN, alpha=1.0, beta=1.0):
        super().__init__(alpha, beta)
        if op not in ("add", "multiply", "divide", "compose"):
            raise ValueError(f"unknown FNCombine operation {op!r}")
        self.op = op
        self.f1 = f1
        self.f2 = f2

    def _f(self, x):
        if self.op == "add":
            return self.f1.eval(x) + self.f2.eval(x)
        if self.op == "multiply":
            return self.f1.eval(x) * self.f2.eval(x)
        if self.op == "divide":
            return self.f1.eval(x) / self.f2.eval(x)
        return self.f2.eval(self.f1.eval(x))

    def _fprime(self, x):
        if self.op == "add":
            return self.f1.eval_deriv(x) + self.f2.eval_deriv(x)
        if self.op == "multiply":
            return (self.f1.eval_deriv(x) * self.f2.eval(x)
                    + self.f1.eval(x) * self.f2.eval_deriv(x))
        if self.op == "divide":
            g = self.f2.eval(x)
            return (self.f1.eval_deriv(x) * g
                    - self.f1.eval(x) * self.f2.eval_deriv(x)) / g**2
        return self.f2.eval_deriv(self.f1.eval(x)) * self.f1.eval_deriv(x)

    def _fmat(self, A):
        if self.op == "add":
            return self.f1.eval_mat(A) + self.f2.eval_mat(A)
        if self.op == "multiply":
            return self.f1.eval_mat(A) @ self.f2.eval_mat(A)
        if self.op == "divide":
            return np.linalg.solve(self.f2.eval_mat(A), self.f1.eval_mat(A))
        return self.f2.eval_mat(self.f1.eval_mat(A))


# ---------------------------------------------------------------------------


def _polyvalm(coeffs, A):
    """Horner evaluation of a matrix polynomial (high-to-low coeffs)."""
    n = A.shape[0]
    F = np.zeros_like(A, dtype=np.result_type(A.dtype, float))
    for c in coeffs:
        F = F @ A + c * np.eye(n, dtype=F.dtype)
    return F


def _expm_pade(A, degree: int = 13):
    """Padé scaling-and-squaring exp — own implementation (method 1;
    reference algorithm of fnexp.c:33)."""
    A = np.asarray(A, dtype=np.result_type(A.dtype, float))
    n = A.shape[0]
    nrm = np.linalg.norm(A, 1)
    s = max(0, int(np.ceil(np.log2(nrm / 5.4))) if nrm > 5.4 else 0)
    As = A / (2.0**s)
    # degree-13 Padé coefficients
    b = [64764752532480000.0, 32382376266240000.0, 7771770303897600.0,
         1187353796428800.0, 129060195264000.0, 10559470521600.0,
         670442572800.0, 33522128640.0, 1323241920.0, 40840800.0,
         960960.0, 16380.0, 182.0, 1.0]
    I = np.eye(n, dtype=As.dtype)
    A2 = As @ As
    A4 = A2 @ A2
    A6 = A2 @ A4
    U = As @ (A6 @ (b[13] * A6 + b[11] * A4 + b[9] * A2)
              + b[7] * A6 + b[5] * A4 + b[3] * A2 + b[1] * I)
    V = (A6 @ (b[12] * A6 + b[10] * A4 + b[8] * A2)
         + b[6] * A6 + b[4] * A4 + b[2] * A2 + b[0] * I)
    F = np.linalg.solve(V - U, V + U)
    for _ in range(s):
        F = F @ F
    return F


def _sqrtm_db(A, maxit: int = 50, tol: float = 1e-13):
    Y, _ = _sqrtm_db_pair(A, maxit, tol)
    return Y


def _sqrtm_db_pair(A, maxit: int = 50, tol: float = 1e-13):
    """Denman–Beavers iteration: Y_k -> A^(1/2), Z_k -> A^(-1/2)."""
    A = np.asarray(A, dtype=np.result_type(A.dtype, float))
    n = A.shape[0]
    Y = A.copy()
    Z = np.eye(n, dtype=A.dtype)
    for _ in range(maxit):
        Yn = 0.5 * (Y + np.linalg.inv(Z))
        Zn = 0.5 * (Z + np.linalg.inv(Y))
        if np.linalg.norm(Yn - Y, 1) <= tol * max(np.linalg.norm(Yn, 1), 1e-300):
            Y, Z = Yn, Zn
            break
        Y, Z = Yn, Zn
    return Y, Z


def _realify(F, A):
    """Drop spurious imaginary parts when the input was real."""
    if not np.iscomplexobj(A) and np.iscomplexobj(F):
        if np.linalg.norm(F.imag, 1) <= 1e-12 * max(np.linalg.norm(F.real, 1), 1e-300):
            return F.real
    return F


def _sexpm_params(nrm: float):
    """Scaling s and subdiagonal-Padé degrees (k, m) as a function of the
    1-norm — the published selection table of the sexpm algorithm
    (Güttel & Nakatsukasa, "Scaled and Squared Subdiagonal Padé
    Approximation for the Matrix Exponential", SIMAX 37(1), 2016;
    reference fnexp.c:131)."""
    if nrm > 1:
        for bound, skm in ((200, (4, 5, 4)), (1e4, (4, 4, 5)),
                           (1e6, (4, 3, 4)), (1e9, (3, 3, 4)),
                           (1e11, (2, 3, 4)), (1e12, (2, 2, 3)),
                           (1e14, (2, 1, 2))):
            if nrm < bound:
                return skm
        return 1, 1, 2
    for bound, skm in ((0.5, (4, 4, 3)), (0.3, (3, 4, 3)),
                       (0.15, (2, 4, 3)), (0.07, (1, 4, 3)),
                       (0.01, (0, 4, 3)), (3e-4, (0, 3, 2)),
                       (1e-5, (0, 3, 0)), (1e-8, (0, 2, 0))):
        if nrm > bound:
            return skm
    return 0, 1, 0


def _exp_pade_coeffs(k: int, m: int):
    """(k, m) Padé numerator/denominator of exp, coefficients
    high-to-low (np.polyval order): p(x)/q(x) = exp(x) + O(x^{k+m+1})."""
    p = [math.factorial(k + m - j) * math.factorial(k)
         / (math.factorial(k + m) * math.factorial(j)
            * math.factorial(k - j)) for j in range(k + 1)]
    q = [math.factorial(k + m - j) * math.factorial(m)
         / (math.factorial(k + m) * math.factorial(j)
            * math.factorial(m - j)) * (-1) ** j for j in range(m + 1)]
    return np.array(p[::-1]), np.array(q[::-1])


def _expm_subdiag_pade(A, form: str = "pf"):
    """Scaled & squared subdiagonal Padé matrix exponential
    (Güttel–Nakatsukasa 2016; reference fnexp.c:410 role).

    1. shift A by its rightmost eigenvalue (largest real part -> ~0);
    2. pick (s, k, m) from the 1-norm (published sexpm table);
    3. evaluate the (k, m) Padé of exp at A/2^s either in
       partial-fraction form (``pf``: residues/poles computed
       numerically from the Padé polynomials) or in product form
       (``prod``: interleaved root factors and solves);
    4. square s times and undo the shift.
    """
    A = np.asarray(A)
    n = A.shape[0]
    ev = np.linalg.eigvals(A)
    shift = float(np.max(ev.real))
    As = A.astype(complex) - shift * np.eye(n)
    nrm = float(np.linalg.norm(As, 1))
    s, k, m = _sexpm_params(nrm)
    As = As / (2.0 ** s)
    p, q = _exp_pade_coeffs(k, m)
    if form == "prod" and m > 0:
        # r(A) = c * prod(A - zp_i) * prod(A - zq_i)^{-1}, factors
        # interleaved so intermediate norms stay moderate
        zp = np.roots(p) if k > 0 else np.array([])
        zq = np.roots(q)
        F = np.eye(n, dtype=complex)
        for i in range(max(k, m)):
            if i < k:
                F = (As - zp[i] * np.eye(n)) @ F
            if i < m:
                F = np.linalg.solve(As - zq[i] * np.eye(n), F)
        # leading-coefficient ratio of the root factorizations:
        # p(x) = p_lead prod(x - zp_i), q(x) = q_lead prod(x - zq_i),
        # and all factors commute (polynomials in the same A)
        F = F * (p[0] / q[0])
    elif m > 0:
        # partial fractions: r(x) = rem(x) + w_i / (x - q_i) terms
        if k >= m:
            rem, _ = np.polydiv(p, q)
            num = np.polysub(p, np.polymul(rem, q))
        else:
            rem, num = np.zeros(1), p
        zq = np.roots(q)
        dq = np.polyder(q)
        F = _polyvalm(rem, As.astype(complex))
        for qi in zq:
            wi = np.polyval(num, qi) / np.polyval(dq, qi)
            F = F + wi * np.linalg.inv(As - qi * np.eye(n))
    else:
        F = _polyvalm(p, As.astype(complex))
    # distribute the shift into the pre-squaring factor: each squaring
    # doubles the exponent, so F_final = e^shift (e^{As})^{2^s} with
    # intermediates staying on the scale of the final answer
    F = F * np.exp(shift / (2.0 ** s))
    for _ in range(s):
        F = F @ F
    return _realify(F, A)


def _sqrtm_db_product(A, maxit: int = 50, tol: float = 1e-13):
    """Denman–Beavers iteration, PRODUCT form (reference fnsqrt.c
    method 1 role): M tracks Y Z so only ONE inverse per step:
      Y <- Y (I + M^{-1}) / 2,   M <- (I + (M + M^{-1})/2) / 2,
    M -> I and Y -> sqrt(A)."""
    A = np.asarray(A)
    n = A.shape[0]
    eye = np.eye(n, dtype=A.dtype)
    Y = A.astype(complex)
    M = A.astype(complex)
    for _ in range(maxit):
        Minv = np.linalg.inv(M)
        Y = 0.5 * Y @ (np.eye(n) + Minv)
        M = 0.5 * (np.eye(n) + 0.5 * (M + Minv))
        if np.linalg.norm(M - np.eye(n), "fro") <= tol * max(
                1.0, np.linalg.norm(M, "fro")):
            break
    return _realify(Y, A)


def _sqrtm_newton_schulz(A, maxit: int = 100, tol: float = 1e-13):
    """Inverse-free Newton–Schulz (reference fnsqrt.c method 2 role):
      Y <- Y (3I - Z Y)/2,  Z <- (3I - Z Y)/2 Z,
    converges when ||I - A/c|| < 1; A is pre-scaled by its Frobenius
    norm to enlarge the basin."""
    A = np.asarray(A)
    n = A.shape[0]
    c = float(np.linalg.norm(A, "fro"))
    scale = c if c > 1 else 1.0
    As = A.astype(complex) / scale
    Y = As.copy()
    Z = np.eye(n, dtype=complex)
    eye3 = 3.0 * np.eye(n)
    for _ in range(maxit):
        T = 0.5 * (eye3 - Z @ Y)
        Y = Y @ T
        Z = T @ Z
        if np.linalg.norm(eye3 / 3 - Z @ Y, "fro") <= tol * n:
            break
    return _realify(Y * np.sqrt(scale), A)


def _sqrtm_sadeghi(A, maxit: int = 50, tol: float = 1e-13):
    """Sadeghi iteration (reference fnsqrt.c method 3 role):
      G = (5/16) I + (1/16) M (15 I - 5 M + M^2)
      X <- X G,   M <- M (G^2)^{-1},
    with X -> sqrt(M0) as M -> I; A pre-scaled by its Frobenius norm."""
    A = np.asarray(A)
    n = A.shape[0]
    eye = np.eye(n, dtype=complex)
    nrm = float(np.linalg.norm(A, "fro"))
    scale = nrm if nrm > 1 else 1.0
    M = A.astype(complex) / scale
    X = eye.copy()
    for _ in range(maxit):
        G = (5.0 / 16.0) * eye + (1.0 / 16.0) * M @ (
            15.0 * eye - 5.0 * M + M @ M)
        X = X @ G
        M = M @ np.linalg.inv(G @ G)
        if np.linalg.norm(M - eye, "fro") <= tol * n:
            break
    return _realify(X * np.sqrt(scale), A)


def fn_from_name(name: str, *args, **kw) -> FN:
    table = {"exp": FNExp, "log": FNLog, "sqrt": FNSqrt, "invsqrt": FNInvSqrt,
             "phi": FNPhi, "rational": FNRational, "combine": FNCombine}
    return table[name](*args, **kw)
