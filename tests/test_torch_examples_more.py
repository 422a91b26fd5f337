"""The examples of ``examples/`` for SVD, MFN, PEP, NEP, BSE and slicing
against their copies in ``examples_torch/`` on the CPU
(``tests/_example_pairs.py``; the EPS examples are in
``tests/test_torch_examples.py``)."""

import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import _example_pairs as pairs  # noqa: E402

SCRIPTS = ["ex_bse.py", "ex_expm.py", "ex_nep_delay.py", "ex_pep_acoustic.py",
           "ex_svd.py"]


@pytest.fixture(scope="module")
def printed():
    return pairs.run_pairs(SCRIPTS)


@pytest.mark.parametrize("name", SCRIPTS)
def test_example_pair_prints_the_same_numbers(printed, name):
    pairs.check_pair(printed, name)


@pytest.mark.parametrize("name", SCRIPTS)
def test_example_copy_differs_only_in_allowed_lines(name):
    pairs.check_copy(name)

