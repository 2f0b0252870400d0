"""Multiple-component transforms and DC level shift as torch ops.

Port of `grokimagecompression_tpu/ops/mct_jax.py`. Elementwise work that
the reference leaves to XLA fusion; here it is plain torch arithmetic on
tensors of any shape (leading batch axes allowed). RCT and the DC shift
are integer and exact; the forward ICT reproduces the host encoder's
float32 rounding (`ict_fwd`), the inverse runs in float32 with the
reference's coefficients rounded to float32 first. The Part-2 custom
MCT (`custom_fwd` / `custom_inv`) reproduces the host's float32
`np.einsum` product (`ops/mct_np.custom_fwd` of the reference).
"""

from __future__ import annotations

import numpy as np
import torch


def _f32(x: float) -> float:
    """`x` rounded to float32: a Python float scalar enters a float32 torch
    op as that float32 value, like the reference's jnp.float32 constants."""
    return float(np.float32(x))


def rct_fwd(r, g, b):
    y = (r + 2 * g + b) >> 2
    u = b - g
    v = r - g
    return y, u, v


def rct_inv(y, u, v):
    g = y - ((u + v) >> 2)
    r = v + g
    b = u + g
    return r, g, b


# ICT rows, float32, as the reference host encoder's `mct_np._ICT_FWD`
_ICT_FWD = ((0.299, 0.587, 0.114),
            (-0.16875, -0.331260, 0.5),
            (0.5, -0.41869, -0.08131))


def ict_fwd(r, g, b):
    """RGB -> YCbCr in float32 as the host encoder computes it: its matrix
    product (`mct_np.ict_fwd`, BLAS sgemm) rounds the first product and
    then fuses each further multiply-add, y = fma(c2, b, fma(c1, g,
    c0 * r)). Each fused step runs exactly in float64 (a float32
    coefficient times an integer sample, plus a float32, needs fewer than
    53 bits) and is rounded to float32 once."""
    planes = [a.to(torch.float64) for a in (r, g, b)]
    out = []
    for row in _ICT_FWD:
        acc = (_f32(row[0]) * planes[0]).to(torch.float32)
        for c, x in zip(row[1:], planes[1:]):
            acc = (_f32(c) * x + acc.to(torch.float64)).to(torch.float32)
        out.append(acc)
    return tuple(out)


def ict_inv(y, cb, cr):
    y, cb, cr = (a.to(torch.float32) for a in (y, cb, cr))
    r = y + _f32(1.402) * cr
    g = y - _f32(0.34413) * cb - _f32(0.71414) * cr
    b = y + _f32(1.772) * cb
    return r, g, b


def custom_fwd(arrays, matrix):
    """Arbitrary-matrix MCT forward (Part 2): out_j = sum_k M[j, k] in_k
    in float32, as the host encoder's `np.einsum("jk,k...->j...")`
    computes it: each product rounded to float32, then added to the
    running sum in k order, each sum rounded to float32. Every product
    and sum is its own elementwise op, so no multiply-add is fused on
    any device. `matrix` is (n, n), float32 values."""
    planes = [a.to(torch.float32) for a in arrays]
    m = np.asarray(matrix, np.float32)
    out = []
    for row in m:
        acc = planes[0] * float(row[0])
        for c, x in zip(row[1:], planes[1:]):
            acc = acc + x * float(c)
        out.append(acc)
    return out


def custom_inv(arrays, decode_matrix):
    """Arbitrary-matrix MCT inverse: the codestream carries the decoding
    matrix, applied directly (`custom_fwd` with it)."""
    return custom_fwd(arrays, decode_matrix)


def dc_shift_fwd(a, prec: int, signed: bool):
    if signed:
        return a
    return a - (1 << (prec - 1))


def dc_shift_inv(a, prec: int, signed: bool):
    if signed:
        lo, hi = -(1 << (prec - 1)), (1 << (prec - 1)) - 1
        return torch.clamp(a, lo, hi)
    a = a + (1 << (prec - 1))
    return torch.clamp(a, 0, (1 << prec) - 1)
