"""Tier-1 dispatch of the port's host block coder.

A copy of `grokimagecompression_tpu/t1/backend.py` for the routes the
port sends to its host: the Part-1 MQ code-block styles other than the
default (BYPASS, RESET, TERMALL, VSC, PTERM, SEGMARK) and MQ bands deeper
than the CUDA MQ decoder's word. Every call goes to the host library's
coder (`native/t1_native.py`, worker threads inside); there is no Python
coder behind it, and a failed build raises. The reference's switches to
its Python coder and to its device coders are not copied: the port's
device MQ and HT routes are its fused encoder and decoder
(`models/fused_encode.py`, `models/fused_decode.py`).
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from ..native import t1_native


def native_threads() -> int:
    """Worker threads of the native batch entries."""
    return t1_native.default_threads()


def encode_cblk_batch_bands(bands, descs, orients, cblk_style: int = 0,
                            stepsizes=None, nthreads: Optional[int] = None):
    """Batch encode straight from band planes.

    `bands`: 2-D arrays with unit column stride — int32 DWT coefficients
    (reversible), or float32 coefficients with `stepsizes` (one per band)
    for the irreversible path, where the deadzone quantization fuses into
    the native gather. `descs`: (n, 5) int64 rows (band_idx, x0, y0, w,
    h); `orients`: (n,). Returns per block (data, numbps, numpasses,
    passes), `passes` its per-pass rates, distortion decreases (not
    weighted) and terminations."""
    descs = np.asarray(descs, np.int64).reshape(-1, 5)
    return t1_native.encode_cblk_batch_bands(
        bands, descs, np.asarray(orients, np.int64), cblk_style,
        nthreads=nthreads, stepsizes=stepsizes)


def decode_cblk_batch_bands(blocks, bands, placements, cblk_style=0,
                            stepsizes=None, pm_zero=None,
                            nthreads: Optional[int] = None) -> None:
    """Decode blocks (data, seg_lengths, w, h, orient, numbps,
    numpasses[, kmax]) straight into band planes at `placements`
    ((band_idx, x0, y0) each), with the mid-point reconstruction and,
    with `stepsizes`, the dequantization of float32 planes
    (`t1_native.decode_cblk_batch_bands`). `cblk_style` is one style or
    one per block."""
    t1_native.decode_cblk_batch_bands(blocks, bands, placements, cblk_style,
                                      stepsizes=stepsizes, nthreads=nthreads,
                                      pm_zero=pm_zero)


def decode_cblk_batch(blocks, cblk_style: int = 0, signed_out: bool = False,
                      nthreads: Optional[int] = None):
    """Batch decode: blocks = [(data, seg_lengths, w, h, orient, numbps,
    numpasses[, kmax]), ...] -> [(mag, neg), ...], or signed int32
    arrays with `signed_out`."""
    return t1_native.decode_cblk_batch([b[:7] for b in blocks], cblk_style,
                                       nthreads=nthreads,
                                       signed_out=signed_out)
