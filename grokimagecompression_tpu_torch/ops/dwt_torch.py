"""Multi-level 2-D DWT (5/3 and 9/7) as torch slicing and concatenation.

Port of `grokimagecompression_tpu/ops/dwt_jax.py`. The reference lowers
this through XLA (the Pallas DWT runs only on request), so torch ops are
the port; there is no kernel here. Each lifting step is static-shape
slice/concat arithmetic along the last axis, the vertical pass reuses the
line functions through a transpose, and all geometry (canvas origin
parity, level sizes) is static. Leading axes are batch.

The 5/3 path is int32 and bit-exact with the reference. The 9/7 path is
float32 in the reference's operation order; torch does not contract
a*b+c into an FMA on the CPU, so it can differ from an XLA build that
does by a few float32 ulps.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from ..core.geometry import Rect, resolution_rect

# CDF 9/7 lifting constants, rounded to float32 as in the reference; a
# Python float scalar enters a float32 torch op as that float32 value
ALPHA = float(np.float32(-1.586134342059924))
BETA = float(np.float32(-0.052980118572961))
GAMMA = float(np.float32(0.882911075530934))
DELTA = float(np.float32(0.443506852043971))
K = 1.230174104914001
INV_K = float(np.float32(1.0 / K))
K_HALF = float(np.float32(K / 2.0))
TWO_OVER_K = float(np.float32(2.0 / K))
K_F = float(np.float32(K))


def _split(x, u0: int):
    """Split a canvas line into (even-canvas, odd-canvas) samples."""
    if u0 % 2 == 0:
        return x[..., 0::2], x[..., 1::2]
    return x[..., 1::2], x[..., 0::2]


def _interleave(xe, xo, u0: int, n: int):
    """Inverse of _split: weave even/odd canvas samples into a line."""
    ne = xe.shape[-1]
    no = xo.shape[-1]
    if u0 % 2 == 0:
        first, second, nf = xe, xo, ne
    else:
        first, second, nf = xo, xe, no
    if second.shape[-1] < nf:
        pad = torch.zeros(second.shape[:-1] + (1,), dtype=second.dtype,
                          device=second.device)
        second = torch.cat([second, pad], dim=-1)
    woven = torch.stack([first, second], dim=-1).reshape(
        first.shape[:-1] + (2 * nf,))
    return woven[..., :n]


def _odd_nbrs(xe, xo, u0: int):
    """Even-canvas neighbours (left, right) of each odd-canvas sample,
    with symmetric extension at the tile boundary."""
    no = xo.shape[-1]
    if u0 % 2 == 0:
        left = xe[..., :no]
        right = torch.cat([xe[..., 1:], xe[..., -1:]], dim=-1)[..., :no]
    else:
        left = torch.cat([xe[..., :1], xe], dim=-1)[..., :no]
        right = torch.cat([xe, xe[..., -1:]], dim=-1)[..., :no]
    return left, right


def _even_nbrs(xe, xo, u0: int):
    """Odd-canvas neighbours (left, right) of each even-canvas sample."""
    ne = xe.shape[-1]
    if u0 % 2 == 0:
        left = torch.cat([xo[..., :1], xo], dim=-1)[..., :ne]
        right = torch.cat([xo, xo[..., -1:]], dim=-1)[..., :ne]
    else:
        left = xo[..., :ne]
        right = torch.cat([xo[..., 1:], xo[..., -1:]], dim=-1)[..., :ne]
    return left, right


def fwd53_line(x, u0: int):
    """Forward 5/3 lifting along the last axis (int32). Returns (lo, hi)."""
    n = x.shape[-1]
    if n == 0:
        return x[..., :0], x[..., :0]
    if n == 1:
        if u0 % 2 == 1:
            return x[..., :0], x * 2
        return x, x[..., :0]
    xe, xo = _split(x, u0)
    le, re = _odd_nbrs(xe, xo, u0)
    high = xo - ((le + re) >> 1)
    lh, rh = _even_nbrs(xe, high, u0)
    low = xe + ((lh + rh + 2) >> 2)
    return low, high


def inv53_line(low, high, u0: int):
    """Inverse 5/3 lifting along the last axis (int32)."""
    n = low.shape[-1] + high.shape[-1]
    if n == 0:
        return low[..., :0]
    if n == 1:
        if u0 % 2 == 1:
            return high >> 1
        return low
    lh, rh = _even_nbrs(low, high, u0)
    xe = low - ((lh + rh + 2) >> 2)
    le, re = _odd_nbrs(xe, high, u0)
    xo = high + ((le + re) >> 1)
    return _interleave(xe, xo, u0, n)


def fwd97_line(x, u0: int):
    """Forward 9/7 lifting along the last axis (float32). Returns (lo, hi)."""
    n = x.shape[-1]
    x = x.to(torch.float32)
    if n == 0:
        return x[..., :0], x[..., :0]
    if n == 1:
        if u0 % 2 == 1:
            return x[..., :0], x * K_HALF
        return x * INV_K, x[..., :0]
    xe, xo = _split(x, u0)
    le, re = _odd_nbrs(xe, xo, u0)
    h = xo + ALPHA * (le + re)
    lh, rh = _even_nbrs(xe, h, u0)
    lo = xe + BETA * (lh + rh)
    le, re = _odd_nbrs(lo, h, u0)
    h = h + GAMMA * (le + re)
    lh, rh = _even_nbrs(lo, h, u0)
    lo = lo + DELTA * (lh + rh)
    return lo * INV_K, h * K_HALF


def inv97_line(low, high, u0: int):
    """Inverse 9/7 lifting along the last axis (float32)."""
    n = low.shape[-1] + high.shape[-1]
    if n == 0:
        return low[..., :0]
    if n == 1:
        if u0 % 2 == 1:
            return high * TWO_OVER_K
        return low * K_F
    lo = low * K_F
    h = high * TWO_OVER_K
    lh, rh = _even_nbrs(lo, h, u0)
    lo = lo - DELTA * (lh + rh)
    le, re = _odd_nbrs(lo, h, u0)
    h = h - GAMMA * (le + re)
    lh, rh = _even_nbrs(lo, h, u0)
    lo = lo - BETA * (lh + rh)
    le, re = _odd_nbrs(lo, h, u0)
    h = h - ALPHA * (le + re)
    return _interleave(lo, h, u0, n)


def _fwd_line(x, u0, reversible):
    return fwd53_line(x, u0) if reversible else fwd97_line(x, u0)


def _inv_line(lo, hi, u0, reversible):
    return inv53_line(lo, hi, u0) if reversible else inv97_line(lo, hi, u0)


def fwd_dwt_2d(a: torch.Tensor, tc: Rect, numresolutions: int,
               reversible: bool = True) -> Dict[Tuple[int, int], torch.Tensor]:
    """Multi-level forward DWT of a tile-component.

    `a` has shape (..., tc.h, tc.w) at canvas origin (tc.x0, tc.y0);
    leading axes are batch. Returns {(r, orient): band} with the keys and
    shapes of the reference (`dwt_jax.fwd_dwt_2d`, `dwt_np.fwd_dwt_2d`).
    """
    nl = numresolutions - 1
    bands: Dict[Tuple[int, int], torch.Tensor] = {}
    cur = a
    cur_rect = tc
    for lev in range(nl):
        r = nl - lev
        t = cur.transpose(-1, -2)
        lo_v, hi_v = _fwd_line(t, cur_rect.y0, reversible)
        lo_v = lo_v.transpose(-1, -2)
        hi_v = hi_v.transpose(-1, -2)
        ll, hl = _fwd_line(lo_v, cur_rect.x0, reversible)
        lh, hh = _fwd_line(hi_v, cur_rect.x0, reversible)
        bands[(r, 1)] = hl
        bands[(r, 2)] = lh
        bands[(r, 3)] = hh
        cur = ll
        cur_rect = resolution_rect(tc, numresolutions,
                                   numresolutions - 1 - (lev + 1))
    bands[(0, 0)] = cur
    return bands


def inv_dwt_2d(bands: Dict[Tuple[int, int], torch.Tensor], tc: Rect,
               numresolutions: int, reversible: bool = True,
               max_res: int | None = None) -> torch.Tensor:
    """Multi-level inverse DWT (horizontal then vertical)."""
    nl = numresolutions - 1
    if max_res is None:
        max_res = nl
    cur = bands[(0, 0)]
    for r in range(1, max_res + 1):
        res = resolution_rect(tc, numresolutions, r)
        top = _inv_line(cur, bands[(r, 1)], res.x0, reversible)
        bot = _inv_line(bands[(r, 2)], bands[(r, 3)], res.x0, reversible)
        full = _inv_line(top.transpose(-1, -2), bot.transpose(-1, -2),
                         res.y0, reversible)
        cur = full.transpose(-1, -2)
    return cur
