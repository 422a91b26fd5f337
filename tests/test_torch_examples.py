"""The North star's claim that one script can drive either package, held to
code (``tests/_example_pairs.py``): the EPS examples of ``examples/``
against their copies in ``examples_torch/`` on the CPU; the other five
are in ``tests/test_torch_examples_more.py``."""

import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import _example_pairs as pairs  # noqa: E402

SCRIPTS = ["ex1_laplacian.py", "ex2_sinvert.py", "ex5_markov.py", "ex_cli.py",
           "ex_slicing.py"]


@pytest.fixture(scope="module")
def printed():
    return pairs.run_pairs(SCRIPTS)


@pytest.mark.parametrize("name", SCRIPTS)
def test_example_pair_prints_the_same_numbers(printed, name):
    pairs.check_pair(printed, name)


@pytest.mark.parametrize("name", SCRIPTS)
def test_example_copy_differs_only_in_allowed_lines(name):
    pairs.check_copy(name)


def test_every_example_has_a_copy():
    assert sorted(p.name for p in (pairs.ROOT / "examples").glob("*.py")) \
        == sorted(p.name for p in
                  (pairs.ROOT / "examples_torch").glob("*.py"))
