"""A run with the timed path broken underneath comes out not correct: each
fault a cell of one card can have, planted in the program at a tiny grid
on the CPU, with the rest of the run as the command drives it.  (The
exchange between cards is a fault no cell here can have: each runs on one
card.)"""

from __future__ import annotations

import pytest

import slepc_tpu_torch as stt
from conftest import CELLS
from portbench.harness import runner


def _filter_unchanged(monkeypatch):
    """A step that returns its state unchanged: the filter hands back its
    input."""
    monkeypatch.setattr(stt.ChebAmplifyOperator, "mult",
                        lambda self, x: x.clone())
    monkeypatch.setattr(stt.ChebAmplifyOperator, "mult_block",
                        lambda self, X: X.clone())


def _after_solve(monkeypatch, change):
    solve = stt.EPS.solve

    def broken(self, *a, **k):
        out = solve(self, *a, **k)
        change(self)
        return out
    monkeypatch.setattr(stt.EPS, "solve", broken)


def _half_batch(monkeypatch):
    """Half of the batch left out: the second half of the returned pairs
    replaced by the first half's."""
    def change(eps):
        h = eps.nconv // 2
        if h:
            eps.eigenvalues[h:2 * h] = eps.eigenvalues[:h]
            eps._eigenvectors[h:2 * h] = eps._eigenvectors[:h]
    _after_solve(monkeypatch, change)


def _answer_altered(monkeypatch):
    """An answer altered where it is produced: the smallest eigenvalue off
    by a relative 1e-7."""
    def change(eps):
        if eps.nconv:
            eps.eigenvalues[0] *= 1.0 + 1e-7
    _after_solve(monkeypatch, change)


def _product_altered(monkeypatch):
    """An answer altered where it is produced: one entry of every filter
    output off by 1e-6 of its largest (the traced run's filter probe)."""
    mult, block = stt.ChebAmplifyOperator.mult, \
        stt.ChebAmplifyOperator.mult_block

    def alter(y):
        y.view(-1)[0] += 1e-6 * float(y.abs().max())
        return y
    monkeypatch.setattr(stt.ChebAmplifyOperator, "mult",
                        lambda self, x: alter(mult(self, x)))
    monkeypatch.setattr(stt.ChebAmplifyOperator, "mult_block",
                        lambda self, X: alter(block(self, X)))


FAULTS = {"filter_unchanged": (_filter_unchanged, False),
          "half_batch": (_half_batch, False),
          "answer_altered": (_answer_altered, False),
          "product_altered": (_product_altered, True)}


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_fault_is_not_correct(tiny_root, monkeypatch, cell, fault):
    plant, traced = FAULTS[fault]
    plant(monkeypatch)
    r = runner.run(cell, 11, 0.2, traced, root=tiny_root, device="cpu",
                   log=lambda msg: None)
    assert r["correct"] is False
    assert r["failed"] >= 1 or any(
        c["value"] is None or c["value"] > c["limit"]
        for c in r["checks"].values())


def test_unbroken_run_is_correct(tiny_root):
    r = runner.run(CELLS[0], 11, 0.2, True, root=tiny_root, device="cpu",
                   log=lambda msg: None)
    assert r["correct"] is True
