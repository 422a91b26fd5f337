"""NLEIGS in slepc_tpu_torch (``nep/nep.py`` ``_solve_nleigs``,
``nep/nleigs_toar.py``) against slepc_tpu's, on the CPU.

Both packages solve the same numpy problems, the port's NEP built from the
reference's by ``interop.nep_from_slepc_tpu``: the compact (default) and
the full-basis NLEIGS on the 40-row delay problem of
tests/test_modules_advanced.py:30 and on examples/ex_nep_delay.py's
128-row DIA problem (nev 3, tol 1e-9: the slice as a whole); the given
singularity set; the dense-callback divided differences; the pieces of
the interpolation (the AAA poles, the Leja-Bagby points, poles and
scalings, the rational divided differences) to 1e-12; and a solve that
locks pairs across many restarts, where the compact basis keeps the
reference's restart bookkeeping (``nep/nleigs_toar.py``: the polish on
the true T hides the dropped coupling, as the reference with the coupling
kept shows).  Each is held to the reference:
the same nconv and its, values within 1e-9, residuals below the reference
test's 1e-8.
"""

import jax
import numpy as np
import pytest
import torch

import slepc_tpu as jst
import slepc_tpu_torch as tst
from slepc_tpu.nep import nep as jnep_mod
from slepc_tpu_torch import interop
from slepc_tpu_torch.nep import nep as tnep_mod


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True, scope="module")
def _reference_jit_caches_dropped():
    """Drop the reference's jit caches when the module starts and ends, and
    compile its ops with XLA's optimizations off while it runs."""
    old = jax.config.read("jax_disable_most_optimizations")
    jax.clear_caches()
    jax.config.update("jax_disable_most_optimizations", True)
    yield
    jax.config.update("jax_disable_most_optimizations", old)
    jax.clear_caches()


def _fns(pkg, tau=1.0):
    fns = [pkg.FNRational([1.0, 0.0]), pkg.FNRational([1.0]), pkg.FNExp()]
    fns[2].set_scale(-tau)
    return fns


def _dense_mats(n=40):
    """tests/test_modules_advanced.py:11 (dense -I, A0, A1)."""
    h = np.pi / (n + 1)
    A0 = (np.diag(np.full(n, -2.0)) + np.diag(np.ones(n - 1), 1)
          + np.diag(np.ones(n - 1), -1)) / (h * h)
    xi = np.arange(1, n + 1) * h
    return [-np.eye(n), A0, np.diag(4.1 - xi * (1 - np.exp(xi - np.pi)))]


def _dia_ops(n=128):
    """examples/ex_nep_delay.py: -I, the 1-D Laplacian and the delay term
    as DIA operators of the reference."""
    h = np.pi / (n + 1)
    up = np.zeros(n)
    up[: n - 1] = 1.0 / (h * h)
    lo = np.zeros(n)
    lo[1:] = 1.0 / (h * h)
    xi = np.arange(1, n + 1) * h
    return [jst.DIAOperator((0,), -np.ones((1, n))),
            jst.DIAOperator((-1, 0, 1),
                            np.stack([lo, np.full(n, -2.0 / (h * h)), up])),
            jst.DIAOperator((0,), (4.1 - xi * (1 - np.exp(xi - np.pi)))[None])]


def _nleigs(ops, nev=3, tol=1e-10, full=False):
    jnep = jst.NEP(nev=nev, solver="nleigs", target=-1.0, tol=tol)
    jnep.set_split_operators(ops, _fns(jst))
    jnep.set_rg(jst.RGEllipse(center=-1.0, radius=1.5, vscale=0.5))
    jnep.nleigs_full_basis = full
    return jnep


def _both(jnep):
    tnep = interop.nep_from_slepc_tpu(jnep, device="cpu")
    jnep.solve()
    tnep.solve()
    return jnep, tnep


def _held(jnep, tnep, mats, its=True):
    """Same nconv and its, values within 1e-9, true residuals below 1e-8,
    every value inside the ellipse."""
    assert tnep.nconv == jnep.nconv >= 2
    if its:
        assert tnep.its == jnep.its
    k = tnep.nconv
    np.testing.assert_allclose(np.asarray(tnep.eigenvalues[:k], complex),
                               np.asarray(jnep.eigenvalues[:k], complex),
                               rtol=0, atol=1e-9)
    assert np.min(np.abs(tnep.eigenvalues[:k] + 0.19)) < 2e-3
    fns = _fns(tst)
    rg = tst.RGEllipse(center=-1.0, radius=1.5, vscale=0.5)
    X = tnep.get_eigenvectors()
    assert isinstance(X, torch.Tensor) and X.shape == (mats[0].shape[0], k)
    for i in range(k):
        lam = complex(tnep.eigenvalues[i])
        T = sum(complex(f.eval(lam)) * M for M, f in zip(mats, fns))
        x = X[:, i].numpy()
        assert np.linalg.norm(T @ x) / np.linalg.norm(x) < 1e-8
        assert rg.check_inside(lam) >= 0


@pytest.mark.parametrize("full", [False, True], ids=["compact", "full"])
def test_nleigs_matches_the_reference(full):
    """tests/test_modules_advanced.py:30 / :291 on the 40-row dense delay
    problem, compact and full basis."""
    mats = _dense_mats()
    jnep, tnep = _both(_nleigs([jst.DenseOperator(M) for M in mats],
                               full=full))
    _held(jnep, tnep, mats)
    assert tnep.nleigs_degree > 2


@pytest.mark.parametrize("full", [False, True], ids=["compact", "full"])
def test_ex_nep_delay_dia_matches_the_reference(full):
    """examples/ex_nep_delay.py as a whole: the 128-row DIA delay problem
    by NLEIGS, nev 3, tol 1e-9, the port's DIA operators carried from the
    reference's."""
    jops = _dia_ops()
    jnep, tnep = _both(_nleigs(jops, tol=1e-9, full=full))
    assert all(type(m).__name__ == "DIAOperator" for m in tnep.split_A)
    _held(jnep, tnep, [op.to_scipy().toarray() for op in tnep.split_A])


def test_given_singularities_match_the_reference():
    """set_singularities: a given pole set replaces the AAA poles, in both
    packages (the delay problem has none; a far set only shapes the
    rational basis)."""
    mats = _dense_mats()
    jnep = _nleigs([jst.DenseOperator(M) for M in mats])
    jnep.set_singularities(-20.0 + np.linspace(-5, 5, 11) * 1j)
    jnep, tnep = _both(jnep)
    np.testing.assert_array_equal(tnep._singularities, jnep._singularities)
    _held(jnep, tnep, mats)


def test_callback_nleigs_matches_the_reference():
    """A callback-form problem takes the dense matrix divided differences
    (n <= 2048) and one host LU of Q_d(sigma); each package's callback
    builds its own operator from the same arrays."""
    mats = _dense_mats()

    def make(pkg, **kw):
        fns = _fns(pkg)
        nep = pkg.NEP(nev=3, solver="nleigs", target=-1.0, tol=1e-10)
        nep.set_function(lambda lam: pkg.DenseOperator(
            sum(complex(f.eval(lam)) * M for M, f in zip(mats, fns)), **kw))
        nep.set_rg(pkg.RGEllipse(center=-1.0, radius=1.5, vscale=0.5))
        return nep

    jnep, tnep = make(jst), make(tst, device="cpu")
    jnep.solve()
    tnep.solve()
    _held(jnep, tnep, mats)


def test_interpolation_pieces_match_the_reference():
    """The AAA pole list of the delay problem's surrogate (or both
    packages' ImportError branch), the Leja-Bagby points s, poles xi and
    scalings beta, the rational basis and the divided differences, to
    1e-12."""
    rg = jst.RGEllipse(center=-1.0, radius=1.5, vscale=0.5)
    ds = np.asarray(rg.contour(128)[0], dtype=complex)
    jnep = _nleigs([jst.DenseOperator(M) for M in _dense_mats()])
    tnep = interop.nep_from_slepc_tpu(jnep, device="cpu")
    jp = jnep_mod._aaa_singularities(jnep, ds)
    tp = tnep_mod._aaa_singularities(tnep, ds)
    if tp is tnep_mod._NO_AAA:
        assert jp is None
        jp = tp = np.zeros(0, complex)
    np.testing.assert_allclose(tp, jp, rtol=1e-12, atol=1e-12)
    poles = np.concatenate([np.asarray(tp, complex),
                            -30.0 + np.arange(5) * 1j])
    js, jxi, jbeta = jnep_mod._leja_bagby(ds, poles, 40)
    ts, txi, tbeta = tnep_mod._leja_bagby(ds, poles, 40)
    np.testing.assert_allclose(ts, js, rtol=1e-12, atol=0)
    np.testing.assert_array_equal(np.isinf(txi), np.isinf(jxi))
    fin = ~np.isinf(jxi)
    np.testing.assert_allclose(txi[fin], jxi[fin], rtol=1e-12, atol=0)
    np.testing.assert_allclose(tbeta, jbeta, rtol=1e-12, atol=0)
    fns_j, fns_t = jnep.split_f, tnep.split_f
    for k in (1, 5, 20):
        z = ts[k]
        np.testing.assert_allclose(
            tnep_mod._rational_basis(ts, txi, tbeta, k, z),
            jnep_mod._rational_basis(js, jxi, jbeta, k, z), rtol=1e-12,
            atol=1e-300)

    def divided_differences(mod, s, xi, beta, fns, m=25):
        fv = np.array([[complex(f.eval(sk)) for f in fns] for sk in s[:m]])
        D = np.zeros((m, len(fns)), complex)
        D[0] = fv[0] * beta[0]
        for k in range(1, m):
            b = mod._rational_basis(s, xi, beta, k, s[k])
            D[k] = (fv[k] - b[:k] @ D[:k]) / b[k]
        return D

    Dt = divided_differences(tnep_mod, ts, txi, tbeta, fns_t)
    Dj = divided_differences(jnep_mod, js, jxi, jbeta, fns_j)
    np.testing.assert_allclose(Dt, Dj, rtol=1e-12,
                               atol=1e-12 * np.abs(Dj).max())


def test_compact_nleigs_locks_across_restarts_as_the_reference():
    """nev 8 on the 40-row problem: the compact basis locks pairs over 15
    restarts (ncv = nev + 15 = 23).  Its restart keeps the reference's
    diagonal Schur blocks, which drop the coupling of earlier locked
    columns to later ones (the fault ``pep/toar.py`` repairs); with the
    coupling kept the extracted vectors differ before the polish, but the
    Newton polish on the true T gives the same pairs either way, so the
    port keeps the reference's bookkeeping and matches it restart for
    restart."""
    mats = _dense_mats()
    jnep, tnep = _both(_nleigs([jst.DenseOperator(M) for M in mats], nev=8))
    assert tnep.its == jnep.its == 15
    _held(jnep, tnep, mats)
    assert tnep.nconv == 5  # every value of the delay problem in the ellipse


def test_kept_coupling_changes_no_pair(monkeypatch):
    """Why the port keeps the reference's restart: the reference's compact
    NLEIGS with its restart rewritten to keep the whole rotated relation
    (the earlier locked columns' coupling too, as ``pep/toar.py``
    ``ks_lock_restart`` does) and its eigenvectors taken from that whole
    locked block gives the same nconv, its and values on a solve that
    locks across 15 restarts: the Newton polish on the true T hides the
    drop.  The rewrite runs on the reference's source in memory; its file
    is not touched."""
    import inspect
    import types

    import slepc_tpu.nep.nleigs_toar as jtoar

    src = inspect.getsource(jtoar)
    old_restart = """            Hh2 = np.zeros_like(H)
            Hh2[:k2, :k2] = Tlock[:k2, :k2]
            if not done and l > 0:
                Hh2[k2: k2 + l, k2: k2 + l] = \\
                    Tproj[k2 - k: k2 - k + l, k2 - k: k2 - k + l]
                Hh2[k: k2, k2: k2 + l] = Tproj[: k2 - k, k2 - k: k2 - k + l]
                Hh2[k2 + l, k2: k2 + l] = beta_r * last[k2 - k: k2 - k + l]
                S[:, k2 + l] = S[:, nv]"""
    new_restart = """            Hh2 = np.zeros_like(H)
            Hh2[:k, :k] = H[:k, :k]
            Hh2[:k, k: k + kl] = H[:k, k:nv] @ Q[:, :kl]
            Hh2[k: k + kl, k: k + kl] = Tproj[:kl, :kl]
            if not done and l > 0:
                Hh2[k2 + l, k2: k2 + l] = beta_r * last[k2 - k: k2 - k + l]
                S[:, k2 + l] = S[:, nv]"""
    old_eig = "wb, Y = np.linalg.eig(Tlock[:k, :k])"
    assert src.count(old_restart) == 1 and src.count(old_eig) == 1
    coupled = types.ModuleType("slepc_tpu.nep._nleigs_toar_coupled")
    coupled.__package__ = "slepc_tpu.nep"
    exec(compile(src.replace(old_restart, new_restart).replace(
        old_eig, "wb, Y = np.linalg.eig(H[:k, :k])"), "<coupled>", "exec"),
        coupled.__dict__)
    mats = _dense_mats()
    runs = []
    for krylov in (jtoar.nleigs_toar_krylov, coupled.nleigs_toar_krylov):
        monkeypatch.setattr(jtoar, "nleigs_toar_krylov", krylov)
        jnep = _nleigs([jst.DenseOperator(M) for M in mats], nev=8)
        jnep.solve()
        runs.append(jnep)
    ref, kept = runs
    assert kept.its == ref.its == 15
    assert kept.nconv == ref.nconv == 5
    np.testing.assert_allclose(np.asarray(kept.eigenvalues, complex),
                               np.asarray(ref.eigenvalues, complex),
                               rtol=0, atol=1e-10)
