"""Tile-transform pipeline: DC shift -> MCT -> multi-level DWT, in torch.

Port of `grokimagecompression_tpu/models/pipeline.py`. The reference jits
this per tile geometry; here it runs eagerly on whatever device the
component tensors live on, batched over leading frame axes. The DWT is
`ops/dwt.py`: the CUDA kernel for CUDA tensors (the reference's Pallas
DWT route, `GROK_TPU_PALLAS=1`), `dwt_torch` for CPU tensors.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

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


def _fwd_transform(cfg: TileTransformConfig, comps) -> List[Dict[BandKey, torch.Tensor]]:
    """comps: sequence of (..., h_c, w_c) tensors -> list of {(r, o): band}."""
    ncomps = len(comps)
    shifted = [
        mct_torch.dc_shift_fwd(comps[c].to(torch.int32), cfg.precs[c],
                               cfg.signeds[c])
        for c in range(ncomps)
    ]
    if cfg.mct and ncomps >= 3:
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
    the DC shift run on the reduced planes."""
    comps = [
        dwt.inv_dwt_2d(bands_list[c], cfg.tc_rects[c], cfg.numresolutions,
                       cfg.reversible, max_res)
        for c in range(len(bands_list))
    ]
    return inv_mct_dc(cfg, comps)


def inv_mct_dc(cfg: TileTransformConfig, comps) -> Tuple[torch.Tensor, ...]:
    """Inverse MCT, rounding (9/7) and DC unshift of inverse-transformed
    planes (int32 on 5/3, float32 on 9/7) -> int32 samples."""
    comps = list(comps)
    ncomps = len(comps)
    if cfg.mct and ncomps >= 3:
        inv = mct_torch.rct_inv if cfg.reversible else mct_torch.ict_inv
        comps[0], comps[1], comps[2] = inv(comps[0], comps[1], comps[2])
    out = []
    for c in range(ncomps):
        a = comps[c]
        if not cfg.reversible:
            a = torch.round(a).to(torch.int32)
        out.append(mct_torch.dc_shift_inv(a, cfg.precs[c], cfg.signeds[c]))
    return tuple(out)


def _band_keys(numresolutions: int) -> Tuple[BandKey, ...]:
    keys: List[BandKey] = [(0, 0)]
    for r in range(1, numresolutions):
        keys += [(r, 1), (r, 2), (r, 3)]
    return tuple(keys)


def config_for_tile(siz, cod, tile: Rect) -> TileTransformConfig:
    """Build a TileTransformConfig from codestream structs for one tile.

    Tile-component rects are normalised to their origin modulo
    2^(numresolutions-1): the transform depends on the origin only through
    each level's parity, so interior tiles of a uniform grid share one
    config (and so one plan)."""
    m = 1 << (cod.numresolutions - 1)

    def _norm(r: Rect) -> Rect:
        dx, dy = r.x0 - r.x0 % m, r.y0 - r.y0 % m
        return Rect(r.x0 - dx, r.y0 - dy, r.x1 - dx, r.y1 - dy)

    return TileTransformConfig(
        tc_rects=tuple(_norm(component_rect(tile, c.dx, c.dy))
                       for c in siz.comps),
        precs=tuple(c.prec for c in siz.comps),
        signeds=tuple(c.signed for c in siz.comps),
        numresolutions=cod.numresolutions,
        reversible=(cod.transform == Transform.DWT_53),
        mct=bool(cod.mct),
    )
