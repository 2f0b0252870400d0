"""Quantization (ISO/IEC 15444-1 Annex E) as the port's encode and decode
use it.

Copies of `grokimagecompression_tpu/ops/quant.py` (the basis norms,
`band_norm`, `encode_stepsize`, `decode_stepsize`,
`default_irrev_stepsize`, `trunc_plane`, `dequantize`) and of the
irreversible MCT norms of `ops/mct_np.py`;
`tests/test_torch_host_copies.py` holds them equal to the originals.
`deadzone` is the port's quantizer for the 9/7 bands: the host encoder's
rule, floor(|v| / step) in float64 (the MQ coder's magnitudes;
`signed_deadzone`, the HT coder's signed coefficients). `reconstruct` is
the 9/7 decode's
dequantizer on torch tensors, the host's float32 `dequantize`.
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch

# L2 norms of the synthesis basis vectors per [orient][level] — standard
# constants for the 5/3 and 9/7 filter banks (identical tables appear in all
# JPEG 2000 codecs; they derive from the filter taps).
DWT_NORMS_53 = (
    (1.000, 1.500, 2.750, 5.375, 10.68, 21.34, 42.67, 85.33, 170.7, 341.3),
    (1.038, 1.592, 2.919, 5.703, 11.33, 22.64, 45.25, 90.48, 180.9, 362.0),
    (1.038, 1.592, 2.919, 5.703, 11.33, 22.64, 45.25, 90.48, 180.9, 362.0),
    (0.7186, 0.9218, 1.586, 3.043, 6.019, 12.01, 24.00, 47.97, 95.93, 191.9),
)
DWT_NORMS_97 = (
    (1.000, 1.965, 4.177, 8.403, 16.90, 33.84, 67.69, 135.3, 270.6, 540.9),
    (2.022, 3.989, 8.355, 17.04, 34.27, 68.63, 137.3, 274.6, 549.0, 1098.0),
    (2.022, 3.989, 8.355, 17.04, 34.27, 68.63, 137.3, 274.6, 549.0, 1098.0),
    (2.080, 3.865, 8.307, 17.18, 34.42, 68.85, 137.7, 275.4, 550.8, 1101.6),
)

# MCT component norms used by PCRD distortion weighting
# (reference: src/lib/jp2/mct/mct.cpp:67-72).
MCT_NORMS_REV = (1.732, 0.8292, 0.8292)
MCT_NORMS_IRREV = (1.732, 1.805, 1.573)


def band_norm(orient: int, level: int, reversible: bool) -> float:
    table = DWT_NORMS_53 if reversible else DWT_NORMS_97
    level = min(level, len(table[orient]) - 1)
    return table[orient][level]


def encode_stepsize(stepsize: float, numbps: int) -> Tuple[int, int]:
    """Float stepsize -> (expn, mant) per E.1.1 with R_b = numbps."""
    s8192 = max(1, int(math.floor(stepsize * 8192.0)))
    p = s8192.bit_length() - 1 - 13
    n = 11 - (s8192.bit_length() - 1)
    mant = ((s8192 >> -n) if n < 0 else (s8192 << n)) & 0x7FF
    expn = numbps - p
    return expn, mant


def decode_stepsize(expn: int, mant: int, numbps: int) -> float:
    """(expn, mant) -> float stepsize: 2^(R_b - eps) * (1 + mu/2048)."""
    return float(2.0 ** (numbps - expn) * (1.0 + mant / 2048.0))


def default_irrev_stepsize(orient: int, level: int) -> float:
    """Default encoder stepsize for an irreversible band: 1/norm (gain 0)."""
    return 1.0 / band_norm(orient, level, reversible=False)


def deadzone(v: torch.Tensor, step: torch.Tensor) -> torch.Tensor:
    """Deadzone magnitudes floor(|v| / step) as int64: `v` float32
    coefficients, `step` float64 stepsizes broadcast against them. The
    division runs in float64, as the host encoder's block gather does
    (`grok_extract_blocks_f32`, `quant.quantize`); a float32 reciprocal
    would move coefficients on a step boundary to the next magnitude."""
    return torch.floor(v.abs().to(torch.float64) / step).to(torch.int64)


def signed_deadzone(v: torch.Tensor, step: torch.Tensor) -> torch.Tensor:
    """`deadzone`'s magnitudes with the sign of `v`, as int32: the signed
    coefficients the HT encoder reads (`ops/ht_enc.py`), negative where
    v < 0. The same float64 division and truncation, done in place so
    that a block is held in float64 once."""
    q = v.abs().to(torch.float64)
    q.div_(step).floor_()
    mag = q.to(torch.int32)
    del q
    return torch.where(v < 0, -mag, mag)


def trunc_plane(numbps: int, numpasses: int) -> int:
    """Lowest bit-plane reached by `numpasses` decoded passes of a block
    with `numbps` magnitude planes: pass 0 is the MSB cleanup, then
    (sig, ref, cln) triplets per plane (Annex D pass schedule). The
    mid-point reconstruction offset belongs at THIS plane, not plane 0
    — the reference decoder embeds the half at each sample's
    last-touched plane (reference: t1.cpp oneplushalf/poshalf decode
    updates, scaled out in T1Part1.cpp post_decode), so a truncated
    block reconstructs at the center of its actual decision interval.
    """
    if numbps <= 0 or numpasses <= 0:
        return 0
    return max(0, numbps - 1 - ((numpasses + 1) // 3))


def dequantize(mag: np.ndarray, neg: np.ndarray, stepsize: float,
               half_bit: bool = True, p_min: int = 0) -> np.ndarray:
    """Mid-point reconstruction: (q + 0.5 * 2^p_min) * delta for q > 0,
    where p_min is the block's lowest decoded bit-plane (trunc_plane);
    0 for fully decoded blocks."""
    m = mag.astype(np.float32)
    if half_bit:
        half = np.float32(0.5 * (1 << p_min))
        m = np.where(mag > 0, m + half, m)
    v = m * np.float32(stepsize)
    return np.where(neg > 0, -v, v).astype(np.float32)


def reconstruct(mag: torch.Tensor, neg: torch.Tensor, half, step
                ) -> torch.Tensor:
    """`dequantize` on tensors, float32 throughout: (mag + half where
    mag != 0) * step, negated where `neg`. `half` and `step` are float32
    tensors (or floats) that broadcast against `mag`: per lane, the
    factor 0.5 * 2^pm of the block's lowest decoded plane and the band's
    stepsize. Each operation is its own rounding, in the host's order (no
    fused multiply-add)."""
    m = mag.to(torch.float32)
    m = torch.where(mag != 0, m + half, m)
    v = m * step
    return torch.where(neg, -v, v)
