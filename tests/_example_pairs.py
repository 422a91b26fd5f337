"""The checks of ``tests/test_torch_examples*.py``: each script of
``examples/`` and its copy in ``examples_torch/`` run on the CPU, the
numbers they print compared, and the copy diffed against the script.

Compared: eigenvalues, singular values and ||y|| to 1e-8 relative (and the
printing's 1e-8 absolute); nconv (and the slicing count) equal; each
printed error below the script's tolerance in both.  Iteration counts are
not compared (rounding decides them; ``ROADMAP.md`` queue 3).  A copy may
differ from its script only in allow-listed lines: its imports, the lines
that pick the platform, and the lines that read a device tensor into
numpy.
"""

import difflib
import os
import pathlib
import re
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parent.parent

# a changed line (either side) must match one of these
ALLOWED = [
    r"^\s*(import|from)\s",                                  # imports
    r"SLEPC_TPU_EXAMPLES_TPU|SLEPC_TPU_TORCH_DEVICE|jax\.config"
    r"|jax\.default_backend|set_default_device",             # the platform
    r"^\s*# (examples run on|remote relay|to run them on)",  # its comment
    r"np\.asarray\(|\.cpu\(\)\.numpy\(\)|\.mult\(x\)",       # device reads
    r"^\s*$",
]
# the bound on each printed error: the script's tol; ex_pep_acoustic
# prints ||P(lam) x|| / ||x|| unscaled by ||K|| (about 2,400), so the
# solver's 1e-9 backward error reads as up to ~3e-8 in both packages
BOUND = {"ex_bse.py": 1e-9, "ex_nep_delay.py": 1e-9,
         "ex_pep_acoustic.py": 1e-6}
TIMEOUT = 110

VALUE = re.compile(r"(?:lambda\[\d+\]|lambda|sigma_\d+|\|\|y\|\|) = (\S+)")
ERROR = re.compile(r"(?:rel\.err|rel\.res|\|\|[TP]\(lam\)x\|\||diff) = (\S+)"
                   r"|max deviation from closed form: (\S+)")


# a copy runs with every import of jax and slepc_tpu refused
_BLOCKED = """import runpy, sys
class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split('.')[0] in ('jax', 'jaxlib', 'slepc_tpu'):
            raise ImportError('blocked import of ' + name)
sys.meta_path.insert(0, Block())
sys.argv = sys.argv[1:]
runpy.run_path(sys.argv[0], run_name='__main__')
"""


def _run(path: pathlib.Path, torch_copy: bool):
    env = dict(os.environ, OMP_NUM_THREADS="2", PYTHONPATH=str(ROOT))
    cmd = [sys.executable, str(path)]
    if torch_copy:
        env["SLEPC_TPU_TORCH_DEVICE"] = "cpu"
        cmd = [sys.executable, "-c", _BLOCKED, str(path)]
    out = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True,
                         text=True, timeout=TIMEOUT)
    return out.returncode, out.stdout + out.stderr


def run_pairs(names):
    """Every script of ``names`` and its copy, run once, four at a time;
    (name, is_copy) -> (returncode, output)."""
    jobs = [(name, t) for name in names for t in (False, True)]
    with ThreadPoolExecutor(4) as ex:
        outs = list(ex.map(
            lambda j: _run(ROOT / ("examples_torch" if j[1] else "examples")
                           / j[0], j[1]), jobs))
    return dict(zip(jobs, outs))


def _numbers(text: str):
    vals = [complex(v) for v in VALUE.findall(text)]
    arr = re.search(r"\n(\[[^\]]*\])", text)  # ex_slicing's printed array
    if arr:
        vals += [complex(v) for v in arr.group(1).strip("[]").split()]
    counts = [int(c) for c in re.findall(r"nconv=(\d+)", text)]
    counts += [int(c) for c in re.findall(r"eigenvalues in .*: (\d+)", text)]
    errs = [float(a or b) for a, b in ERROR.findall(text)]
    key = lambda z: (round(z.real, 6), round(z.imag, 6))
    return np.array(sorted(vals, key=key)), counts, np.array(errs)


def check_pair(printed, name):
    (rc_j, out_j), (rc_t, out_t) = printed[name, False], printed[name, True]
    assert rc_j == 0, out_j[-3000:]
    assert rc_t == 0, out_t[-3000:]
    vj, cj, ej = _numbers(out_j)
    vt, ct, et = _numbers(out_t)
    assert len(vj) > 0 and vj.shape == vt.shape, (out_j, out_t)
    np.testing.assert_allclose(vt, vj, rtol=1e-8, atol=1e-8)
    assert ct == cj
    bound = BOUND.get(name, 1e-8)
    assert ej.size == et.size and (ej <= bound).all() and (et <= bound).all()


def check_copy(name):
    orig = (ROOT / "examples" / name).read_text().splitlines()
    copy = (ROOT / "examples_torch" / name).read_text().splitlines()
    changed = [line[2:] for line in difflib.ndiff(orig, copy)
               if line[:2] in ("- ", "+ ")]
    bad = [line for line in changed
           if not any(re.search(p, line) for p in ALLOWED)]
    assert not bad, f"{name}: lines outside the allow-list: {bad}"
    text = "\n".join(copy)
    assert not re.search(r"^\s*(import|from)\s+(jax|slepc_tpu)\b(?!_torch)",
                         text, re.M)
