"""Canvas-coordinate geometry for the JPEG 2000 coding hierarchy.

Implements the ISO/IEC 15444-1 Annex B coordinate math: image/tile grid,
per-component tile rects, resolution levels, sub-bands (Eq. B-15), precinct
partitions, and code-block grids.

Everything here is *pure static geometry* — no pixel data. The layout tree
produced by :func:`build_tile_component_layout` is the single source of truth
used by the transform pipeline (device side) and Tier-2 packet assembly
(host side), mirroring the role of ``TileComponent::init``
(reference: src/lib/jp2/TileComponent.cpp:165) and the band-coordinate
mapping in the inverse DWT (reference: src/lib/jp2/transform/dwt.cpp:1131),
but expressed as immutable dataclasses instead of a mutable C++ object tree.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import List, Tuple

__all__ = [
    "ceil_div",
    "ceil_div_pow2",
    "floor_div_pow2",
    "Rect",
    "Band",
    "CodeBlock",
    "Precinct",
    "Resolution",
    "TileComponentLayout",
    "tile_grid_size",
    "tile_rect",
    "component_rect",
    "resolution_rect",
    "band_rect",
    "num_precincts",
    "build_tile_component_layout",
    "BAND_ORIENT_LL",
    "BAND_ORIENT_HL",
    "BAND_ORIENT_LH",
    "BAND_ORIENT_HH",
    "band_gain",
]

# Sub-band orientations (xob, yob) encoding per Annex B: LL=0, HL=1, LH=2, HH=3.
BAND_ORIENT_LL = 0
BAND_ORIENT_HL = 1
BAND_ORIENT_LH = 2
BAND_ORIENT_HH = 3


def ceil_div(a: int, b: int) -> int:
    """Ceiling division for non-negative a, positive b."""
    return -(-a // b)


def ceil_div_pow2(a: int, n: int) -> int:
    # Python's // floors toward -inf, so ceil(a / 2**n) = -((-a) // 2**n).
    return -((-a) // (1 << n))


def floor_div_pow2(a: int, n: int) -> int:
    return a >> n


@dataclasses.dataclass(frozen=True)
class Rect:
    """Half-open rectangle [x0, x1) x [y0, y1) in canvas coordinates."""

    x0: int
    y0: int
    x1: int
    y1: int

    @property
    def w(self) -> int:
        return max(0, self.x1 - self.x0)

    @property
    def h(self) -> int:
        return max(0, self.y1 - self.y0)

    @property
    def area(self) -> int:
        return self.w * self.h

    def is_empty(self) -> bool:
        return self.x1 <= self.x0 or self.y1 <= self.y0

    def clip(self, other: "Rect") -> "Rect":
        return Rect(
            max(self.x0, other.x0),
            max(self.y0, other.y0),
            min(self.x1, other.x1),
            min(self.y1, other.y1),
        )

    def contains(self, x: int, y: int) -> bool:
        return self.x0 <= x < self.x1 and self.y0 <= y < self.y1


def band_gain(orient: int) -> int:
    """Log2 gain of a reversible-path sub-band (LL:0, HL/LH:1, HH:2)."""
    if orient == BAND_ORIENT_LL:
        return 0
    if orient == BAND_ORIENT_HH:
        return 2
    return 1


def tile_grid_size(xsiz: int, ysiz: int, xosiz: int, yosiz: int,
                   xtsiz: int, ytsiz: int, xtosiz: int, ytosiz: int) -> Tuple[int, int]:
    """Number of tiles (numtiles_x, numtiles_y) per Eq. B-5."""
    ntx = ceil_div(xsiz - xtosiz, xtsiz)
    nty = ceil_div(ysiz - ytosiz, ytsiz)
    return ntx, nty


def tile_rect(t: int, xsiz: int, ysiz: int, xosiz: int, yosiz: int,
              xtsiz: int, ytsiz: int, xtosiz: int, ytosiz: int) -> Rect:
    """Canvas rect of tile index t (raster order), per Eq. B-7..B-10."""
    ntx, _ = tile_grid_size(xsiz, ysiz, xosiz, yosiz, xtsiz, ytsiz, xtosiz, ytosiz)
    p = t % ntx
    q = t // ntx
    tx0 = max(xtosiz + p * xtsiz, xosiz)
    ty0 = max(ytosiz + q * ytsiz, yosiz)
    tx1 = min(xtosiz + (p + 1) * xtsiz, xsiz)
    ty1 = min(ytosiz + (q + 1) * ytsiz, ysiz)
    return Rect(tx0, ty0, tx1, ty1)


def component_rect(tile: Rect, dx: int, dy: int) -> Rect:
    """Tile-component rect per Eq. B-12 (subsampling by (dx, dy))."""
    return Rect(
        ceil_div(tile.x0, dx),
        ceil_div(tile.y0, dy),
        ceil_div(tile.x1, dx),
        ceil_div(tile.y1, dy),
    )


def resolution_rect(tc: Rect, numresolutions: int, r: int) -> Rect:
    """Resolution-level r rect per Eq. B-14: trx = ceil(tcx / 2^(NL - r))."""
    n = numresolutions - 1 - r
    return Rect(
        ceil_div(tc.x0, 1 << n),
        ceil_div(tc.y0, 1 << n),
        ceil_div(tc.x1, 1 << n),
        ceil_div(tc.y1, 1 << n),
    )


def band_rect(tc: Rect, numresolutions: int, r: int, orient: int) -> Rect:
    """Sub-band rect per Eq. B-15.

    For r == 0 the only band is LL with nb = NL; for r >= 1 the bands are
    HL/LH/HH at decomposition level nb = NL - r + 1.
    """
    nl = numresolutions - 1
    if r == 0:
        nb = nl
        xob = yob = 0
    else:
        nb = nl - r + 1
        xob = orient & 1
        yob = (orient >> 1) & 1
    shift = nb
    ox = (1 << (nb - 1)) * xob if nb >= 1 else 0
    oy = (1 << (nb - 1)) * yob if nb >= 1 else 0
    return Rect(
        ceil_div(tc.x0 - ox, 1 << shift),
        ceil_div(tc.y0 - oy, 1 << shift),
        ceil_div(tc.x1 - ox, 1 << shift),
        ceil_div(tc.y1 - oy, 1 << shift),
    )


def num_precincts(res: Rect, ppx: int, ppy: int) -> Tuple[int, int]:
    """Precinct grid dimensions for a resolution (Eq. B-16)."""
    if res.is_empty():
        return 0, 0
    pw = ceil_div_pow2_safe(res.x1, ppx) - floor_div_pow2(res.x0, ppx)
    ph = ceil_div_pow2_safe(res.y1, ppy) - floor_div_pow2(res.y0, ppy)
    return pw, ph


def ceil_div_pow2_safe(a: int, n: int) -> int:
    return (a + (1 << n) - 1) >> n


@dataclasses.dataclass(frozen=True)
class CodeBlock:
    """A code-block: `rect` in band coordinates, position (cx, cy) in the
    precinct's code-block grid."""

    rect: Rect
    cx: int
    cy: int


@dataclasses.dataclass(frozen=True)
class Precinct:
    """A precinct within one band: `rect` is the precinct area clipped to the
    band, in band coordinates; `cblk_grid_w/h` span the tag-tree dimensions."""

    index: int  # raster index within the resolution's precinct grid
    rect: Rect
    cblk_grid_w: int
    cblk_grid_h: int
    cblks: Tuple[CodeBlock, ...]


@dataclasses.dataclass(frozen=True)
class Band:
    orient: int
    rect: Rect
    precincts: Tuple[Precinct, ...]


@dataclasses.dataclass(frozen=True)
class Resolution:
    r: int
    rect: Rect
    # Precinct exponents actually used at this resolution (after the r>0
    # halving that maps resolution precincts onto band coordinates).
    ppx: int
    ppy: int
    num_precincts_w: int
    num_precincts_h: int
    bands: Tuple[Band, ...]


@dataclasses.dataclass(frozen=True)
class TileComponentLayout:
    tc_rect: Rect
    numresolutions: int
    cblk_w_exp: int
    cblk_h_exp: int
    resolutions: Tuple[Resolution, ...]

    @property
    def num_cblks(self) -> int:
        return sum(
            len(p.cblks) for res in self.resolutions for b in res.bands for p in b.precincts
        )


def _build_band_precincts(
    band: Rect,
    res: Rect,
    r: int,
    ppx: int,
    ppy: int,
    cblk_w_exp: int,
    cblk_h_exp: int,
) -> Tuple[Precinct, ...]:
    """Partition a band into precincts and code-blocks.

    Precincts are defined on resolution coordinates as a 2^ppx x 2^ppy grid
    anchored at the canvas origin; mapped into band coordinates they become a
    2^bpx x 2^bpy grid where bpx = ppx - 1 for r > 0 (the band is half the
    resolution scale) and bpx = ppx for r == 0.
    Code-blocks are anchored to a 2^xcb' grid in band coordinates with
    xcb' = min(cblk_exp, bpx).
    """
    if r == 0:
        bpx, bpy = ppx, ppy
    else:
        bpx, bpy = ppx - 1, ppy - 1
    xcb = min(cblk_w_exp, bpx)
    ycb = min(cblk_h_exp, bpy)

    if res.is_empty():
        return tuple()
    if band.is_empty():
        # The precinct grid is defined on the resolution rect, so an empty
        # band still carries pw*ph (empty) precinct slots to keep packet
        # indexing aligned across the resolution's bands.
        pw = ceil_div_pow2_safe(res.x1, ppx) - floor_div_pow2(res.x0, ppx)
        ph = ceil_div_pow2_safe(res.y1, ppy) - floor_div_pow2(res.y0, ppy)
        return tuple(
            Precinct(index=i, rect=Rect(0, 0, 0, 0), cblk_grid_w=0,
                     cblk_grid_h=0, cblks=tuple())
            for i in range(pw * ph)
        )

    # Precinct grid computed on the *resolution* rect (so every band of the
    # resolution shares the same precinct count, per B.6).
    pw = ceil_div_pow2_safe(res.x1, ppx) - floor_div_pow2(res.x0, ppx)
    ph = ceil_div_pow2_safe(res.y1, ppy) - floor_div_pow2(res.y0, ppy)
    px0_grid = floor_div_pow2(res.x0, ppx)
    py0_grid = floor_div_pow2(res.y0, ppy)

    precincts: List[Precinct] = []
    for pj in range(ph):
        for pi in range(pw):
            # Precinct rect in band coordinates: the resolution-space cell
            # [ (px0_grid+pi)*2^ppx , ... ) maps to the band-space cell of the
            # same index on the 2^bpx grid.
            bx0 = (px0_grid + pi) << bpx
            by0 = (py0_grid + pj) << bpy
            prect = Rect(bx0, by0, bx0 + (1 << bpx), by0 + (1 << bpy)).clip(band)
            if prect.is_empty():
                precincts.append(
                    Precinct(index=pj * pw + pi, rect=prect, cblk_grid_w=0,
                             cblk_grid_h=0, cblks=tuple())
                )
                continue
            # Code-block grid within the precinct, anchored to 2^xcb in band
            # coordinates.
            cbx0 = floor_div_pow2(prect.x0, xcb)
            cby0 = floor_div_pow2(prect.y0, ycb)
            cbx1 = ceil_div_pow2_safe(prect.x1, xcb)
            cby1 = ceil_div_pow2_safe(prect.y1, ycb)
            gw = cbx1 - cbx0
            gh = cby1 - cby0
            cblks: List[CodeBlock] = []
            for cy in range(gh):
                for cx in range(gw):
                    cx0 = (cbx0 + cx) << xcb
                    cy0 = (cby0 + cy) << ycb
                    crect = Rect(cx0, cy0, cx0 + (1 << xcb), cy0 + (1 << ycb)).clip(prect)
                    cblks.append(CodeBlock(rect=crect, cx=cx, cy=cy))
            precincts.append(
                Precinct(index=pj * pw + pi, rect=prect, cblk_grid_w=gw,
                         cblk_grid_h=gh, cblks=tuple(cblks))
            )
    return tuple(precincts)


@functools.lru_cache(maxsize=512)
def build_tile_component_layout(
    tc_rect: Rect,
    numresolutions: int,
    cblk_w_exp: int,
    cblk_h_exp: int,
    precinct_exps: Tuple[Tuple[int, int], ...] | None = None,
) -> TileComponentLayout:
    """Build the full resolution -> band -> precinct -> code-block tree.

    ``precinct_exps`` gives (PPx, PPy) per resolution r = 0..NL; when None the
    maximal default (15, 15) is used (i.e. one precinct covering everything).
    """
    resolutions: List[Resolution] = []
    for r in range(numresolutions):
        res = resolution_rect(tc_rect, numresolutions, r)
        if precinct_exps is not None:
            ppx, ppy = precinct_exps[r]
        else:
            ppx, ppy = 15, 15
        pw, ph = num_precincts(res, ppx, ppy)
        orients = (BAND_ORIENT_LL,) if r == 0 else (
            BAND_ORIENT_HL, BAND_ORIENT_LH, BAND_ORIENT_HH)
        bands: List[Band] = []
        for orient in orients:
            brect = band_rect(tc_rect, numresolutions, r, orient)
            precincts = _build_band_precincts(
                brect, res, r, ppx, ppy, cblk_w_exp, cblk_h_exp)
            bands.append(Band(orient=orient, rect=brect, precincts=precincts))
        resolutions.append(
            Resolution(r=r, rect=res, ppx=ppx, ppy=ppy,
                       num_precincts_w=pw, num_precincts_h=ph,
                       bands=tuple(bands))
        )
    return TileComponentLayout(
        tc_rect=tc_rect,
        numresolutions=numresolutions,
        cblk_w_exp=cblk_w_exp,
        cblk_h_exp=cblk_h_exp,
        resolutions=tuple(resolutions),
    )
