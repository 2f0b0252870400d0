"""Multi-level 2-D DWT (5/3 and 9/7): CUDA kernel and plain torch.

Port of `grokimagecompression_tpu/ops/dwt_pallas.py` (`fwd_dwt_2d` /
`inv_dwt_2d`, the Pallas kernels `_fused_whole` and `_fused_striped`).
The contract is `dwt_torch`'s, which is its plain version:

    fwd_dwt_2d(a (..., h, w), tc, numresolutions, reversible)
        -> {(r, orient): band}
    inv_dwt_2d(bands, tc, numresolutions, reversible, max_res) -> (..., h, w)

5/3 runs on int32, 9/7 on float32; both are bit-exact with `dwt_torch`
and the numpy oracle `dwt_np`. A CUDA tensor launches `csrc/dwt.cu`, one
tiled launch per level and direction (both passes of a level in shared
memory), each counted in `LAUNCHES`, for every geometry; a CPU tensor
takes `dwt_torch`.

On the card the forward transform writes one (N, h, w) buffer in the
Mallat layout: level l's region is its top-left (h_l, w_l) corner, with
low rows above high rows and low columns left of high columns, so every
band is a view of it (HL, LH, HH of each level and the last LL). The LL
bands in between go to one scratch buffer (two slots, used in turn). The
inverse writes each level's (N, h_l, w_l) samples into the output buffer
or a scratch buffer, in turn, so that the last level lands in the output.
Each transform allocates its output once and one scratch buffer.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Dict, Optional, Tuple

import torch

from ..core.geometry import Rect, resolution_rect
from . import _build, dwt_torch

LAUNCHES = {"dwt": 0}

# tile sides of the kernel, largest first, and the CTAs a level should
# give the card's 132 SMs at least; a level takes the largest tile that
# gives as many (else the smallest)
TILES = (64, 32, 16)
MIN_CTAS = 132

BandDict = Dict[Tuple[int, int], torch.Tensor]


@functools.lru_cache(maxsize=None)
def _constants():
    """The eight 9/7 constants of `dwt_torch`, as a ctypes float array in
    the kernel's order (alpha, beta, gamma, delta, 1/K, K/2, 2/K, K)."""
    vals = (dwt_torch.ALPHA, dwt_torch.BETA, dwt_torch.GAMMA,
            dwt_torch.DELTA, dwt_torch.INV_K, dwt_torch.K_HALF,
            dwt_torch.TWO_OVER_K, dwt_torch.K_F)
    return (ctypes.c_float * 8)(*vals)


def _dtype(reversible: bool) -> torch.dtype:
    return torch.int32 if reversible else torch.float32


def _n_even(n: int, parity: int) -> int:
    """Samples of a line of n at canvas parity `parity` that are even on
    the canvas (the low-pass half)."""
    return (n + 1 - parity) // 2


def _tile_for(N: int, h: int, w: int, min_ctas: int) -> int:
    for t in TILES:
        if N * -(-h // t) * -(-w // t) >= min_ctas:
            return t
    return TILES[-1]


def tile_for(N: int, h: int, w: int) -> int:
    """The kernel's tile side for a level's (N, h, w) region: the largest
    of TILES that gives MIN_CTAS CTAs, else the smallest."""
    return _tile_for(N, h, w, MIN_CTAS)


def _unit_cols(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    t = t.to(dtype)
    return t if t.stride(-1) == 1 or t.shape[-1] <= 1 else t.contiguous()


def _launch(fn, *args) -> None:
    rc = fn(*args, ctypes.addressof(_constants()),
            torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{fn.__name__} launch failed: CUDA error {rc}")


def _check(t: torch.Tensor) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"unsupported device {t.device}")


@functools.lru_cache(maxsize=256)
def _fwd_plan(N: int, h: int, w: int, tc: Rect, numresolutions: int,
              min_ctas: int):
    """A forward transform of (N, h, w) at `tc`: (per level (py, px, tile)
    as a ctypes int array, the LL scratch's size and its second slot's
    offset, the bands as (key, rows, columns, offset) in the (h, w)
    Mallat buffer, the launches it makes)."""
    nl = numresolutions - 1
    lv, bands, lls = [], [], []
    W = w
    launches = 0
    for lev in range(nl):
        rect = resolution_rect(tc, numresolutions, numresolutions - 1 - lev)
        py, px = rect.y0 & 1, rect.x0 & 1
        hl, wl = _n_even(h, py), _n_even(w, px)
        lv += [py, px, _tile_for(N, h, w, min_ctas)]
        r = nl - lev
        bands += [((r, 1), hl, w - wl, wl), ((r, 2), h - hl, wl, hl * W),
                  ((r, 3), h - hl, w - wl, hl * W + wl)]
        lls.append(N * hl * wl)
        launches += N * h * w > 0
        h, w = hl, wl
    bands.append(((0, 0), h, w, 0))
    slot1 = lls[0] if nl > 2 else 0
    size = lls[0] + (lls[1] if nl > 2 else 0) if nl > 1 else 0
    return ((ctypes.c_int * len(lv))(*lv), size, slot1, tuple(bands),
            launches)


def fwd_dwt_2d(a: torch.Tensor, tc: Rect, numresolutions: int,
               reversible: bool = True) -> BandDict:
    """Multi-level forward DWT of a tile-component `a` (..., tc.h, tc.w)
    at canvas origin (tc.x0, tc.y0); leading axes are batch. Returns
    {(r, orient): band} with `dwt_torch.fwd_dwt_2d`'s keys and shapes."""
    if a.device.type == "cpu":
        return dwt_torch.fwd_dwt_2d(a, tc, numresolutions, reversible)
    _check(a)
    lead = tuple(a.shape[:-2])
    h, w = a.shape[-2:]
    N = math.prod(lead)
    dt = _dtype(reversible)
    cur = _unit_cols(a.reshape(N, h, w), dt)
    if numresolutions < 2:
        return {(0, 0): cur.view(lead + (h, w))}
    lv, size, slot1, bands, launches = _fwd_plan(
        N, h, w, tc, numresolutions, MIN_CTAS)
    out = torch.empty((N, h, w), dtype=dt, device=a.device)
    scratch = torch.empty(size, dtype=dt, device=a.device)
    with torch.cuda.device(a.device):
        _launch(_build.load().dwt_fwd, cur.data_ptr(), cur.stride(0),
                cur.stride(1), out.data_ptr(), scratch.data_ptr(), slot1, N,
                h, w, numresolutions - 1, lv, 1 if reversible else 0)
    LAUNCHES["dwt"] += launches
    lead_strides = tuple(math.prod(lead[k + 1:]) * h * w
                         for k in range(len(lead)))
    return {key: out.as_strided(lead + (rows, cols),
                                lead_strides + (w, 1), off)
            for key, rows, cols, off in bands}


@functools.lru_cache(maxsize=256)
def _inv_plan(N: int, h: int, w: int, his: Tuple[Tuple[int, int], ...],
              tc: Rect, numresolutions: int, min_ctas: int):
    """An inverse transform from an (N, h, w) LL band through levels of
    (h_hi, w_hi) high bands: (per level (h_hi, w_hi, py, px, tile) as a
    ctypes int array, the output's (rows, columns), the scratch size, the
    launches it makes)."""
    lv, sizes = [], []
    launches = 0
    for r, (h_hi, w_hi) in enumerate(his, start=1):
        res = resolution_rect(tc, numresolutions, r)
        h, w = h + h_hi, w + w_hi
        lv += [h_hi, w_hi, res.y0 & 1, res.x0 & 1, _tile_for(N, h, w,
                                                             min_ctas)]
        sizes.append((h, w))
        launches += N * h * w > 0
    scratch = N * math.prod(sizes[-2]) if len(sizes) > 1 else 0
    return (ctypes.c_int * len(lv))(*lv), sizes[-1], scratch, launches


def inv_dwt_2d(bands: BandDict, tc: Rect, numresolutions: int,
               reversible: bool = True,
               max_res: Optional[int] = None) -> torch.Tensor:
    """Multi-level inverse DWT (horizontal, then vertical pass per level)
    up to resolution `max_res` (default: all)."""
    ll = bands[(0, 0)]
    if ll.device.type == "cpu":
        return dwt_torch.inv_dwt_2d(bands, tc, numresolutions, reversible,
                                    max_res)
    _check(ll)
    if max_res is None:
        max_res = numresolutions - 1
    lead = tuple(ll.shape[:-2])
    N = math.prod(lead)
    dt = _dtype(reversible)

    def flat(t):
        return _unit_cols(t.reshape((N,) + tuple(t.shape[-2:])), dt)

    cur = flat(ll)
    if max_res < 1:
        return cur.view(lead + tuple(cur.shape[1:]))
    highs = [[flat(bands[(r, o)]) for o in (1, 2, 3)]
             for r in range(1, max_res + 1)]
    lv, (h, w), size, launches = _inv_plan(
        N, *cur.shape[1:], tuple((lh.shape[1], hl.shape[2])
                                 for hl, lh, _ in highs),
        tc, numresolutions, MIN_CTAS)
    ptrs = (ctypes.c_int64 * (9 * max_res))(*(
        v for level in highs for t in level
        for v in (t.data_ptr(), t.stride(0), t.stride(1))))
    out = torch.empty((N, h, w), dtype=dt, device=ll.device)
    scratch = torch.empty(size, dtype=dt, device=ll.device)
    with torch.cuda.device(ll.device):
        _launch(_build.load().dwt_inv, cur.data_ptr(), cur.stride(0),
                cur.stride(1), ptrs, out.data_ptr(), scratch.data_ptr(), N,
                cur.shape[1], cur.shape[2], max_res, lv,
                1 if reversible else 0)
    LAUNCHES["dwt"] += launches
    return out.view(lead + (h, w))
