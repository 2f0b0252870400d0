"""Packet iterator — progression orders (ISO/IEC 15444-1 B.12).

Analog of the reference's resumable nested-loop iterators
(reference: src/lib/jp2/codestream/PacketIter.cpp: pi_next_lrcp:252,
pi_next_rlcp:304, pi_next_rpcl:350, pi_next_pcrl:447, pi_next_cprl:545),
implemented as a pure generator: the packet sequence is a deterministic
function of (tile geometry, progression, counts), which is what makes
multi-host packet assembly order-stable.

Position-based orders (RPCL/PCRL/CPRL) are realized by sorting precincts on
their canvas-projected top-left corner (clamped to the tile origin), which
reproduces the spec's sample-stepping iteration.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, List, Tuple

from ..core.geometry import Rect, floor_div_pow2, resolution_rect
from ..core.params import Progression


@dataclasses.dataclass
class CompIterInfo:
    """Per-component info the iterator needs."""

    numresolutions: int
    dx: int
    dy: int
    tc_rect: Rect                       # tile-component rect
    # Per resolution r: (ppx, ppy, num_prec_w, num_prec_h)
    prec_info: List[Tuple[int, int, int, int]]


def _precinct_canvas_pos(ci: CompIterInfo, r: int, p: int,
                         tile: Rect) -> Tuple[int, int]:
    """Canvas (y, x) sort key of precinct p at resolution r (clamped to the
    tile origin for the first, partial precinct)."""
    ppx, ppy, pw, ph = ci.prec_info[r]
    res = resolution_rect(ci.tc_rect, ci.numresolutions, r)
    pi = p % pw
    pj = p // pw
    shift = ci.numresolutions - 1 - r
    px = ((floor_div_pow2(res.x0, ppx) + pi) << ppx) << shift
    py = ((floor_div_pow2(res.y0, ppy) + pj) << ppy) << shift
    x = max(px * ci.dx, tile.x0)
    y = max(py * ci.dy, tile.y0)
    return y, x


def packet_order(
    progression: Progression,
    numlayers: int,
    comps: List[CompIterInfo],
    tile: Rect,
) -> Iterator[Tuple[int, int, int, int]]:
    """Yields (layer, resno, compno, precno) in progression order."""
    max_res = max(c.numresolutions for c in comps)

    def nprec(c: int, r: int) -> int:
        ci = comps[c]
        if r >= ci.numresolutions:
            return 0
        _, _, pw, ph = ci.prec_info[r]
        return pw * ph

    if progression == Progression.LRCP:
        for l in range(numlayers):
            for r in range(max_res):
                for c in range(len(comps)):
                    for p in range(nprec(c, r)):
                        yield (l, r, c, p)
        return
    if progression == Progression.RLCP:
        for r in range(max_res):
            for l in range(numlayers):
                for c in range(len(comps)):
                    for p in range(nprec(c, r)):
                        yield (l, r, c, p)
        return

    # Position-based orders: build (r, y, x, c, p) tuples and sort.
    entries = []
    for c, ci in enumerate(comps):
        for r in range(ci.numresolutions):
            for p in range(nprec(c, r)):
                y, x = _precinct_canvas_pos(ci, r, p, tile)
                entries.append((r, y, x, c, p))
    if progression == Progression.RPCL:
        entries.sort(key=lambda e: (e[0], e[1], e[2], e[3], e[4]))
    elif progression == Progression.PCRL:
        entries.sort(key=lambda e: (e[1], e[2], e[3], e[0], e[4]))
    elif progression == Progression.CPRL:
        entries.sort(key=lambda e: (e[3], e[1], e[2], e[0], e[4]))
    else:
        raise ValueError(progression)
    for (r, y, x, c, p) in entries:
        for l in range(numlayers):
            yield (l, r, c, p)


def packet_order_poc(pocs, numlayers, comps, tile):
    """Packet order with progression-order changes (A.6.6): each POC entry
    iterates its own progression restricted to its resolution/component/
    layer volume; packets already emitted by an earlier entry are skipped
    (reference: src/lib/jp2/codestream/PacketIter.cpp pi_update_decode_poc).
    """
    seen = set()
    for poc in pocs:
        lye = min(numlayers, poc.lye)
        for tup in packet_order(poc.prog, numlayers, comps, tile):
            l, r, c, p = tup
            if l >= lye or not (poc.rs <= r < poc.re):
                continue
            if not (poc.cs <= c < poc.ce):
                continue
            if tup in seen:
                continue
            seen.add(tup)
            yield tup
