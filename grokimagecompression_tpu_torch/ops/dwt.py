"""Multi-level 2-D DWT (5/3 and 9/7): CUDA kernel and plain torch.

Port of `grokimagecompression_tpu/ops/dwt_pallas.py` (`fwd_dwt_2d` /
`inv_dwt_2d`, the Pallas kernels `_fused_whole` and `_fused_striped`).
The contract is `dwt_torch`'s, which is its plain version:

    fwd_dwt_2d(a (..., h, w), tc, numresolutions, reversible)
        -> {(r, orient): band}
    inv_dwt_2d(bands, tc, numresolutions, reversible, max_res) -> (..., h, w)

5/3 runs on int32, 9/7 on float32; both are bit-exact with `dwt_torch`
and the numpy oracle `dwt_np`. A CUDA tensor launches `csrc/dwt.cu`, two
launches per level (vertical and horizontal pass), each counted in
`LAUNCHES`, for every geometry; a CPU tensor takes `dwt_torch`.

On the card, level l's forward output is one (N, h_l, w_l) buffer with
low rows above high rows and low columns left of high columns: the four
bands are views of it (HL, LH, HH returned, LL the next level's input).
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

# rows wider than this are lifted in a global scratch row, not in shared
# memory (kSmemFloats of csrc/dwt.cu)
SMEM_FLOATS = 12288

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


def _strides(t: torch.Tensor):
    """(frame stride, row stride) of an (N, rows, cols) tensor whose
    columns are contiguous."""
    return t.stride(0), t.stride(1)


def _unit_cols(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    t = t.to(dtype)
    return t if t.stride(-1) == 1 or t.shape[-1] <= 1 else t.contiguous()


def _scratch(rows: int, w: int, like: torch.Tensor) -> torch.Tensor:
    """Global working rows for lines too wide for shared memory."""
    n = rows * w if w > SMEM_FLOATS else 1
    return torch.empty(n, dtype=like.dtype, device=like.device)


def _launch(fn, *args) -> None:
    rc = fn(*args, ctypes.addressof(_constants()),
            torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{fn.__name__} launch failed: CUDA error {rc}")
    LAUNCHES["dwt"] += 1


def _check(t: torch.Tensor) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"unsupported device {t.device}")


def fwd_dwt_2d(a: torch.Tensor, tc: Rect, numresolutions: int,
               reversible: bool = True) -> BandDict:
    """Multi-level forward DWT of a tile-component `a` (..., tc.h, tc.w)
    at canvas origin (tc.x0, tc.y0); leading axes are batch. Returns
    {(r, orient): band} with `dwt_torch.fwd_dwt_2d`'s keys and shapes."""
    if a.device.type == "cpu":
        return dwt_torch.fwd_dwt_2d(a, tc, numresolutions, reversible)
    _check(a)
    lib = _build.load()
    lead = tuple(a.shape[:-2])
    h, w = a.shape[-2:]
    N = math.prod(lead)
    cur = _unit_cols(a.reshape(N, h, w), _dtype(reversible))
    rect = tc
    rev = 1 if reversible else 0
    nl = numresolutions - 1
    bands: BandDict = {}

    def out(t):
        return t.view(lead + tuple(t.shape[1:]))

    with torch.cuda.device(a.device):
        for lev in range(nl):
            r = nl - lev
            h, w = cur.shape[1:]
            py, px = rect.y0 & 1, rect.x0 & 1
            buf = torch.empty((N, h, w), dtype=cur.dtype, device=cur.device)
            if N and h and w:
                _launch(lib.dwt_fwd_v, cur.data_ptr(), *_strides(cur),
                        buf.data_ptr(), N, h, w, py, rev)
                _launch(lib.dwt_fwd_h, buf.data_ptr(),
                        _scratch(N * h, w, buf).data_ptr(), N * h, w, px,
                        rev)
            hl_rows, lo_cols = _n_even(h, py), _n_even(w, px)
            bands[(r, 1)] = out(buf[:, :hl_rows, lo_cols:])
            bands[(r, 2)] = out(buf[:, hl_rows:, :lo_cols])
            bands[(r, 3)] = out(buf[:, hl_rows:, lo_cols:])
            cur = buf[:, :hl_rows, :lo_cols]
            rect = resolution_rect(tc, numresolutions,
                                   numresolutions - 1 - (lev + 1))
    bands[(0, 0)] = out(cur)
    return bands


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
    lib = _build.load()
    nl = numresolutions - 1
    if max_res is None:
        max_res = nl
    lead = tuple(ll.shape[:-2])
    N = math.prod(lead)
    dt = _dtype(reversible)
    rev = 1 if reversible else 0

    def flat(t):
        return _unit_cols(t.reshape((N,) + tuple(t.shape[-2:])), dt)

    cur = flat(ll)
    with torch.cuda.device(ll.device):
        for r in range(1, max_res + 1):
            res = resolution_rect(tc, numresolutions, r)
            hl, lh, hh = (flat(bands[(r, o)]) for o in (1, 2, 3))
            h_lo, w_lo = cur.shape[1:]
            h_hi, w_hi = lh.shape[1], hl.shape[2]
            h, w = h_lo + h_hi, w_lo + w_hi
            rows = torch.empty((N, h, w), dtype=dt, device=ll.device)
            full = torch.empty((N, h, w), dtype=dt, device=ll.device)
            if N and h and w:
                _launch(lib.dwt_inv_h,
                        *(v for t in (cur, hl, lh, hh)
                          for v in (t.data_ptr(), *_strides(t))),
                        rows.data_ptr(), _scratch(N * h, w, rows).data_ptr(),
                        N, h_lo, h_hi, w_lo, w_hi, res.x0 & 1, rev)
                _launch(lib.dwt_inv_v, rows.data_ptr(), full.data_ptr(), N,
                        h, h_lo, w, res.y0 & 1, rev)
            cur = full
    return cur.view(lead + tuple(cur.shape[1:]))
