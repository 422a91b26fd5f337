"""Carry slepc_tpu state into slepc_tpu_torch and back, as numpy arrays.

The parity tests use these to feed both packages identical operators and
bases.  slepc_tpu objects are read by their attributes only, so this module
imports neither JAX nor slepc_tpu; JAX arrays convert with ``np.asarray``.

* :func:`dia_from_slepc_tpu`: a slepc_tpu ``DIAOperator`` (offsets, diags),
  ``DIAPaddedOperator`` (prepared ``dp``) or ``DIAPaddedOperatorDS``
  (``dph + dpl`` joined in f64) becomes a port :class:`DIAOperator`.
* :func:`aij_from_slepc_tpu`: a slepc_tpu ``AIJOperator`` (through its host
  CSR, ``to_scipy()``) becomes a port :class:`AIJOperator`.
* :func:`dia_to_padded_ds`: a port f64 operator as the (offsets, dph, dpl, n)
  arguments of ``DIAPaddedOperatorDS``.
* :func:`basis_from_padded` / :func:`basis_to_padded`: a padded basis
  (K, rows, 512) and a flat (K, n) basis, by the unpad rule of
  ``slepc_tpu/ops/dia_pallas.py:525-527`` (drop the first ``block_rows``
  halo rows, flatten, keep the first n entries).
"""

from __future__ import annotations

import numpy as np
import torch

from .mat.linop import AIJOperator, DIAOperator

LANES = 512  # lane width of slepc_tpu's padded 2-D layout


def _prepared_to_diags(dp: np.ndarray, n: int) -> np.ndarray:
    """Prepared diagonal blocks (nd, nblk*Rb, 512) -> (nd, n)."""
    return np.ascontiguousarray(dp.reshape(dp.shape[0], -1)[:, :n])


def dia_from_slepc_tpu(op, device="cpu") -> DIAOperator:
    if hasattr(op, "dph"):
        n = int(op.n_interior)
        d = (_prepared_to_diags(np.asarray(op.dph), n).astype(np.float64)
             + _prepared_to_diags(np.asarray(op.dpl), n).astype(np.float64))
    elif hasattr(op, "n_interior"):
        n = int(op.n_interior)
        d = _prepared_to_diags(np.asarray(op.dp), n)
    else:
        d = np.asarray(op.diags)
    return DIAOperator(op.offsets, torch.from_numpy(np.array(d)), device=device)


def aij_from_slepc_tpu(op, device="cpu") -> AIJOperator:
    return AIJOperator.from_scipy(op.to_scipy(), device=device)


def _prepare(d: np.ndarray, n: int, block_rows: int) -> np.ndarray:
    nblk = -(-n // (block_rows * LANES))
    out = np.zeros((d.shape[0], nblk * block_rows * LANES), d.dtype)
    out[:, :n] = d[:, :n]
    return out.reshape(d.shape[0], nblk * block_rows, LANES)


def dia_to_padded_ds(op: DIAOperator, block_rows: int = 128):
    """(offsets, dph, dpl, n) with dph + dpl == diags: the hi/lo f32 split
    of slepc_tpu's ``ds_split`` in the prepared layout."""
    d = op.diags.detach().cpu().numpy().astype(np.float64)
    hi = d.astype(np.float32)
    lo = (d - hi.astype(np.float64)).astype(np.float32)
    n = op.shape[0]
    return (op.offsets, _prepare(hi, n, block_rows), _prepare(lo, n, block_rows),
            n)


def basis_from_padded(Vp, n: int, block_rows: int = 128) -> np.ndarray:
    """Padded rows (K, rows, 512) -> flat rows (K, n)."""
    Vp = np.asarray(Vp)
    return np.ascontiguousarray(
        Vp[:, block_rows:, :].reshape(Vp.shape[0], -1)[:, :n])


def basis_to_padded(V, block_rows: int = 128) -> np.ndarray:
    """Flat rows (K, n) -> padded rows (K, (nblk+2)*block_rows, 512) with
    zero halo blocks."""
    V = np.asarray(V.detach().cpu() if torch.is_tensor(V) else V)
    K, n = V.shape
    nblk = -(-n // (block_rows * LANES))
    out = np.zeros((K, (nblk + 2) * block_rows * LANES), V.dtype)
    out[:, block_rows * LANES: block_rows * LANES + n] = V
    return out.reshape(K, (nblk + 2) * block_rows, LANES)
