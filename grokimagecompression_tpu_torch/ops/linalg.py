"""Small dense linear algebra for the custom MCT: LUP inversion.

A copy of `grokimagecompression_tpu/ops/linalg.py`, written
from the standard algorithm (reference behavior:
src/lib/jp2/mct/invert.cpp matrix_inversion_f, LUP decompose + solve)."""

from __future__ import annotations

import numpy as np


def lup_inverse(m: np.ndarray) -> np.ndarray:
    """Invert a square matrix via LUP decomposition with partial pivoting.

    Raises ValueError on singular input. float64 internally, returns
    float32 (the MCT wire element type).
    """
    a = np.array(m, dtype=np.float64)
    n = a.shape[0]
    if a.shape != (n, n):
        raise ValueError("matrix must be square")
    perm = np.arange(n)
    for k in range(n):
        p = k + int(np.argmax(np.abs(a[k:, k])))
        if abs(a[p, k]) < 1e-12:
            raise ValueError("singular matrix")
        if p != k:
            a[[k, p]] = a[[p, k]]
            perm[[k, p]] = perm[[p, k]]
        a[k + 1:, k] /= a[k, k]
        a[k + 1:, k + 1:] -= np.outer(a[k + 1:, k], a[k, k + 1:])
    inv = np.zeros((n, n), dtype=np.float64)
    for col in range(n):
        # Solve L y = P e_col, then U x = y.
        b = np.zeros(n)
        b[np.where(perm == col)[0][0]] = 1.0
        y = np.zeros(n)
        for i in range(n):
            y[i] = b[i] - a[i, :i] @ y[:i]
        x = np.zeros(n)
        for i in range(n - 1, -1, -1):
            x[i] = (y[i] - a[i, i + 1:] @ x[i + 1:]) / a[i, i]
        inv[:, col] = x
    return inv.astype(np.float32)
