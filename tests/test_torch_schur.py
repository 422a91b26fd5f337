"""The port's Schur-form utilities and non-Hermitian DS types
(slepc_tpu_torch/ds/schur.py, ds/types.py) against slepc_tpu's, on the CPU.

Both drive the same LAPACK routines through scipy on the same seeded
matrices, so they agree to 1e-13: the real and complex Schur forms, the
full reordering by sort keys (a real form's 2x2 blocks move whole, so no
conjugate pair is split), eigenvectors from the Schur form, and the
ordered QZ form; DSNHEP and DSGNHEP wrap them.
"""

import numpy as np
import pytest

from slepc_tpu.ds import schur as jschur
from slepc_tpu.ds.types import DSGNHEP as JDSGNHEP, DSNHEP as JDSNHEP
from slepc_tpu_torch.ds import DSGNHEP, DSNHEP, schur

TOL = 1e-13


def _matrix(kind, n=24, seed=0):
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((n, n))
    if kind == "complex":
        A = A + 1j * rng.standard_normal((n, n))
    return A


def _pair_keys(T, keys):
    from slepc_tpu_torch.eps.krylovschur import _pair_keys as pk

    return pk(T, keys)


@pytest.mark.parametrize("kind", ["real", "complex"])
def test_schur_and_sort_match_the_reference(kind):
    A = _matrix(kind)
    T, Q, w = schur.schur(A)
    Tj, Qj, wj = jschur.schur(A)
    np.testing.assert_allclose(T, Tj, atol=TOL)
    np.testing.assert_allclose(Q, Qj, atol=TOL)
    np.testing.assert_allclose(w, wj, atol=TOL)
    np.testing.assert_allclose(Q @ T @ Q.conj().T, A, atol=1e-12)
    keys = -np.abs(w) if kind == "complex" else _pair_keys(T, -np.abs(w))
    Ts, Qs, ws = schur.sort_schur(T, Q, keys)
    Tjs, Qjs, wjs = jschur.sort_schur(Tj, Qj, keys)
    np.testing.assert_allclose(Ts, Tjs, atol=TOL)
    np.testing.assert_allclose(Qs, Qjs, atol=TOL)
    np.testing.assert_allclose(ws, wjs, atol=TOL)
    # wanted first, the decomposition kept
    assert np.all(np.diff(np.abs(ws)) <= 1e-12)
    np.testing.assert_allclose(Qs @ Ts @ Qs.conj().T, A, atol=1e-12)
    if kind == "real":
        # every 2x2 block holds a conjugate pair, in (+imag, -imag) order
        for s in schur._block_starts(Ts):
            if s + 1 < len(ws) and Ts[s + 1, s] != 0.0:
                assert ws[s].imag > 0 and abs(ws[s] - ws[s + 1].conj()) < 1e-12
    lam, X = schur.schur_eigvectors(Ts, Qs)
    lamj, Xj = jschur.schur_eigvectors(Tjs, Qjs)
    np.testing.assert_allclose(lam, lamj, atol=TOL)
    np.testing.assert_allclose(X, Xj, atol=TOL)
    np.testing.assert_allclose(A @ X, X * lam, atol=1e-11)


@pytest.mark.parametrize("kind", ["real", "complex"])
def test_ds_nhep_matches_the_reference(kind):
    H = np.triu(_matrix(kind, 20, seed=3), -1)  # Hessenberg
    ds, dsj = DSNHEP(), JDSNHEP()
    T, Q, w = ds.solve(H)
    Tj, Qj, wj = dsj.solve(H)
    np.testing.assert_allclose(T, Tj, atol=TOL)
    keys = -np.real(w) if kind == "complex" else _pair_keys(T, -np.real(w))
    Ts, Qs, ws = ds.sort(T, Q, keys)
    Tjs, Qjs, wjs = dsj.sort(Tj, Qj, keys)
    np.testing.assert_allclose(ws, wjs, atol=TOL)
    np.testing.assert_allclose(Qs, Qjs, atol=TOL)
    lam, X = ds.vectors(Ts, Qs)
    lamj, Xj = dsj.vectors(Tjs, Qjs)
    np.testing.assert_allclose(lam, lamj, atol=TOL)
    np.testing.assert_allclose(X, Xj, atol=TOL)


@pytest.mark.parametrize("kind", ["real", "complex"])
def test_ds_gnhep_and_ordered_qz_match_the_reference(kind):
    A = _matrix(kind, 16, seed=5)
    B = _matrix(kind, 16, seed=6) + 8 * np.eye(16)
    S, T, Q, Z, w = DSGNHEP().solve(A, B)
    Sj, Tj, Qj, Zj, wj = JDSGNHEP().solve(A, B)
    for a, b in ((S, Sj), (T, Tj), (Q, Qj), (Z, Zj), (w, wj)):
        np.testing.assert_allclose(a, b, atol=TOL)
    np.testing.assert_allclose(Q @ S @ Z.conj().T, A, atol=1e-11)
    np.testing.assert_allclose(Q @ T @ Z.conj().T, B, atol=1e-11)
    if kind == "complex":  # fully ordered, largest magnitude first
        assert np.all(np.diff(np.abs(w)) <= 1e-12)
    lam, X = DSGNHEP().vectors(S, T, Q, Z)
    lamj, Xj = JDSGNHEP().vectors(Sj, Tj, Qj, Zj)
    np.testing.assert_allclose(lam, lamj, atol=TOL)
    np.testing.assert_allclose(X, Xj, atol=TOL)
    np.testing.assert_allclose(A @ X, (B @ X) * lam, atol=1e-10)
    # ordered_qz with the caller's keys, and the QZ eigenvalues
    keys = lambda ev: np.real(ev)
    out = schur.ordered_qz(A, B, keys)
    outj = jschur.ordered_qz(A, B, keys)
    for a, b in zip(out, outj):
        np.testing.assert_allclose(a, b, atol=TOL)
    np.testing.assert_allclose(schur._qz_eigs(out[0], out[1]),
                               jschur._qz_eigs(outj[0], outj[1]), atol=TOL)
