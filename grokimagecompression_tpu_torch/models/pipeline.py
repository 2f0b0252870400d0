"""Tile-transform pipeline: DC shift -> MCT -> multi-level DWT, in torch.

Port of `grokimagecompression_tpu/models/pipeline.py`. The reference jits
this per tile geometry; here it runs eagerly on whatever device the
component tensors live on, batched over leading frame axes. The DWT is
`ops/dwt.py`: the CUDA kernel for CUDA tensors (the reference's Pallas
DWT route, `GROK_TPU_PALLAS=1`), `dwt_torch` for CPU tensors. A Part-2
custom MCT (`mct_matrix`) takes the place of RCT / ICT, as the
reference's host encoder and decoder run it (`ops/mct_torch.custom_fwd`
/ `custom_inv`).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.geometry import Rect, component_rect
from ..core.params import Transform
from ..ops import dwt, mct_torch

BandKey = Tuple[int, int]


@dataclasses.dataclass(frozen=True)
class TileTransformConfig:
    """Static per-tile-geometry description (hashable)."""

    tc_rects: Tuple[Rect, ...]          # per-component tile-component rect
    precs: Tuple[int, ...]
    signeds: Tuple[bool, ...]
    numresolutions: int
    reversible: bool
    mct: bool                            # RCT (reversible) / ICT (irreversible)
    # a Part-2 custom MCT in place of RCT / ICT: the (n, n) matrix as
    # float32 values (the coding matrix of an encode, the decoding matrix
    # of a decode) and a decode's per-component offsets
    mct_matrix: Optional[Tuple[Tuple[float, ...], ...]] = None
    mct_offsets: Optional[Tuple[float, ...]] = None
    # a decode of some of a tile's components: the inverse stops after the
    # DWT (the caller runs `inv_mct_dc` over the whole tile)
    raw: bool = False


def _fwd_transform(cfg: TileTransformConfig, comps) -> List[Dict[BandKey, torch.Tensor]]:
    """comps: sequence of (..., h_c, w_c) tensors -> list of {(r, o): band}."""
    ncomps = len(comps)
    shifted = [
        mct_torch.dc_shift_fwd(comps[c].to(torch.int32), cfg.precs[c],
                               cfg.signeds[c])
        for c in range(ncomps)
    ]
    if cfg.mct_matrix is not None:
        shifted = mct_torch.custom_fwd(shifted, cfg.mct_matrix)
    elif cfg.mct and ncomps >= 3:
        fwd = mct_torch.rct_fwd if cfg.reversible else mct_torch.ict_fwd
        shifted[0], shifted[1], shifted[2] = fwd(shifted[0], shifted[1],
                                                 shifted[2])
    if not cfg.reversible:
        shifted = [a.to(torch.float32) for a in shifted]
    return [dwt.fwd_dwt_2d(shifted[c], cfg.tc_rects[c], cfg.numresolutions,
                           cfg.reversible)
            for c in range(ncomps)]


def _inv_transform(cfg: TileTransformConfig, bands_list,
                   max_res: Optional[int] = None) -> Tuple[torch.Tensor, ...]:
    """Inverse of _fwd_transform: list of band dicts -> tuple of comps, at
    resolution `max_res` (default: full) as the reference's host decode
    reduces: the inverse DWT stops at `max_res`, then the inverse MCT and
    the DC shift run on the reduced planes. A `raw` config stops after the
    inverse DWT."""
    comps = [
        dwt.inv_dwt_2d(bands_list[c], cfg.tc_rects[c], cfg.numresolutions,
                       cfg.reversible, max_res)
        for c in range(len(bands_list))
    ]
    if cfg.raw:
        return tuple(comps)
    return inv_mct_dc(cfg, comps)


def inv_mct_dc(cfg: TileTransformConfig, comps) -> Tuple[torch.Tensor, ...]:
    """Inverse MCT, rounding and DC unshift of inverse-transformed planes
    (int32 on 5/3, float32 on 9/7) -> int32 samples. A float plane is
    rounded (half to even), as the host decoder rounds every plane that
    is not int32. A custom MCT adds its offsets in place of the DC shift
    and clips to the component's range (reference `codestream/tile.py`,
    `decode_tile`)."""
    comps = list(comps)
    ncomps = len(comps)
    if cfg.mct_matrix is not None:
        out = []
        for c, a in enumerate(mct_torch.custom_inv(comps, cfg.mct_matrix)):
            a = torch.round(a).to(torch.int64) + int(round(
                float(cfg.mct_offsets[c])))
            if cfg.signeds[c]:
                lo, hi = -(1 << (cfg.precs[c] - 1)), \
                    (1 << (cfg.precs[c] - 1)) - 1
            else:
                lo, hi = 0, (1 << cfg.precs[c]) - 1
            out.append(torch.clamp(a, lo, hi).to(torch.int32))
        return tuple(out)
    if cfg.mct and ncomps >= 3:
        inv = mct_torch.rct_inv if cfg.reversible else mct_torch.ict_inv
        comps[0], comps[1], comps[2] = inv(comps[0], comps[1], comps[2])
    out = []
    for c in range(ncomps):
        a = comps[c]
        if a.is_floating_point():
            a = torch.round(a).to(torch.int32)
        out.append(mct_torch.dc_shift_inv(a, cfg.precs[c], cfg.signeds[c]))
    return tuple(out)


def _band_keys(numresolutions: int) -> Tuple[BandKey, ...]:
    keys: List[BandKey] = [(0, 0)]
    for r in range(1, numresolutions):
        keys += [(r, 1), (r, 2), (r, 3)]
    return tuple(keys)


def config_for_tile(siz, cod, tile: Rect, custom_mct=None,
                    comps: Optional[Sequence[int]] = None
                    ) -> TileTransformConfig:
    """Build a TileTransformConfig from codestream structs for one tile.

    Tile-component rects are normalised to their origin modulo
    2^(numresolutions-1): the transform depends on the origin only through
    each level's parity, so interior tiles of a uniform grid share one
    config (and so one plan).

    `custom_mct` is a custom MCT's (matrix, offsets) (offsets None for an
    encode), used when the COD signals it (mct 2). `comps`, a subset of
    the tile's components, makes a `raw` config of those components alone
    (no MCT, no DC shift), with `cod`'s resolutions and transform."""
    m = 1 << (cod.numresolutions - 1)

    def _norm(r: Rect) -> Rect:
        dx, dy = r.x0 - r.x0 % m, r.y0 - r.y0 % m
        return Rect(r.x0 - dx, r.y0 - dy, r.x1 - dx, r.y1 - dy)

    raw = comps is not None
    sizs = [siz.comps[c] for c in comps] if raw else siz.comps
    matrix = offsets = None
    if cod.mct == 2 and custom_mct is not None and not raw:
        matrix = tuple(tuple(float(v) for v in row)
                       for row in np.asarray(custom_mct[0], np.float32))
        if custom_mct[1] is not None:
            offsets = tuple(float(v) for v in custom_mct[1])
    return TileTransformConfig(
        tc_rects=tuple(_norm(component_rect(tile, c.dx, c.dy))
                       for c in sizs),
        precs=tuple(c.prec for c in sizs),
        signeds=tuple(c.signed for c in sizs),
        numresolutions=cod.numresolutions,
        reversible=(cod.transform == Transform.DWT_53),
        mct=bool(cod.mct) and not raw,
        mct_matrix=matrix, mct_offsets=offsets, raw=raw,
    )
