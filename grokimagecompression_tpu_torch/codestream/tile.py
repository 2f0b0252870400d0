"""Per-tile plans, tile T2 encode and tile packet parse, owned by the port.

A copy of the parts of `grokimagecompression_tpu/codestream/tile.py`
that the port's slices run: the static tile-component plan
(`BandPlan`, `TileCompPlan`, `build_comp_plan`, `default_qcd`, both
transforms), the host-T1 half of `encode_tile` for the MQ code-block
styles other than the default and for HT refinement passes
(`encode_t1_blocks`: block descriptors over band planes, 9/7
quantization with each band's step, one batched call of the host
library's Tier-1 coder), T2 of a tile whose
code-block segments were coded on the device or by that coder (the
`t1_segments` branch of `encode_tile`, HT or MQ, with the PCRD
distortion weighting and the `layer_alloc` rate control for MQ segments
that carry their pass tables), and the packet parse of
`decode_tile` up to its `_return_jobs` return, with COC / QCC, POC,
packed headers, ROI shifts (RGN) and the window's code-block filter
(`_band_window`), and the packet index `index_tile_packets`. Packets go
through the native T2 (`native/t2_native.py`): the tile encoder, the
tile simulator of the rate control (with its per-component totals for a
profile's caps) and the tile parser; the Python packet coder runs only
where the reference runs it too (packed headers, packet lengths, the
packet index).

Not copied: the host transforms (the device runs them; a window's
inverse DWT is `ops/dwt_window.py`).
"""

from __future__ import annotations

import dataclasses
import struct
from typing import Dict, List, Optional, Tuple

from ..core.geometry import (
    Rect,
    TileComponentLayout,
    band_gain,
    build_tile_component_layout,
    ceil_div,
    component_rect,
)
from ..core.params import QuantStyle, Transform
from ..native import t2_native
from ..ops import quant
from ..t1 import backend as t1_backend
from .markers import CodInfo, QcdInfo, SizInfo
from .packetiter import CompIterInfo, packet_order, packet_order_poc
from .pcrd import RateControlCtx
from .t2 import (CblkDec, CblkEnc, PassInfo, PrecDec, PrecEnc,
                 decode_packet, decode_packet_split, encode_packet)


@dataclasses.dataclass
class BandPlan:
    r: int
    orient: int
    rect: Rect
    gain: int
    expn: int
    mant: int
    stepsize: float
    kmax: int  # M_b: maximum coded bit-planes


@dataclasses.dataclass
class TileCompPlan:
    layout: TileComponentLayout
    bands: Dict[Tuple[int, int], BandPlan]
    prec: int
    signed: bool


def _band_index(r: int, orient: int) -> int:
    """Index of band in QCD ordering: LL, then (HL, LH, HH) per resolution."""
    if r == 0:
        return 0
    return 3 * (r - 1) + orient


def build_comp_plan(siz: SizInfo, cod: CodInfo, qcd: QcdInfo,
                    tile: Rect, compno: int,
                    roishift: int = 0) -> TileCompPlan:
    """Band plans of one tile-component: exponents (reversible) or
    stepsizes (scalar quantized) and the bands' Kmax.

    `roishift` (RGN marker) inflates Kmax like the reference quantizer
    (reference: Quantizer.cpp:91 band->numbps = roishift + expn + gb - 1);
    the coefficient data itself stays unshifted on the wire: the upshift
    exists in the signalled missing-bit-plane budget, which is what gives
    the component of interest earlier truncation priority."""
    comp = siz.comps[compno]
    tc = component_rect(tile, comp.dx, comp.dy)
    precincts = tuple(cod.precincts) if cod.precincts else None
    layout = build_tile_component_layout(
        tc, cod.numresolutions, cod.cblk_w_exp, cod.cblk_h_exp,
        precincts)
    reversible = cod.transform == Transform.DWT_53
    nl = cod.numresolutions - 1
    bands: Dict[Tuple[int, int], BandPlan] = {}
    for res in layout.resolutions:
        for band in res.bands:
            r, orient = res.r, band.orient
            gain = band_gain(orient) if reversible else 0
            bi = _band_index(r, orient)
            if qcd.style == QuantStyle.NONE:
                expn = qcd.exponents[bi]
                mant = 0
                stepsize = 1.0
            elif qcd.style == QuantStyle.SCALAR_EXPOUNDED:
                expn, mant = qcd.steps[bi]
                stepsize = quant.decode_stepsize(expn, mant, comp.prec + gain)
            else:  # SCALAR_DERIVED
                e0, m0 = qcd.steps[0]
                nb = nl if r == 0 else nl - r + 1
                expn = e0 - nl + nb
                mant = m0
                stepsize = quant.decode_stepsize(expn, mant, comp.prec + gain)
            kmax = qcd.num_guard_bits + expn - 1 + roishift
            bands[(r, orient)] = BandPlan(
                r=r, orient=orient, rect=band.rect, gain=gain,
                expn=expn, mant=mant, stepsize=stepsize, kmax=kmax)
    return TileCompPlan(layout=layout, bands=bands, prec=comp.prec,
                        signed=comp.signed)


def default_qcd(siz: SizInfo, cod: CodInfo, num_guard_bits: int = 2,
                base_step: float = 0.0) -> QcdInfo:
    """Encoder-side QCD derivation (all components share one QCD here)."""
    prec = siz.comps[0].prec
    nl = cod.numresolutions - 1
    reversible = cod.transform == Transform.DWT_53
    nbands = 1 + 3 * nl
    if reversible:
        exponents = []
        for bi in range(nbands):
            orient = 0 if bi == 0 else (bi - 1) % 3 + 1
            exponents.append(prec + band_gain(orient))
        return QcdInfo(style=QuantStyle.NONE, num_guard_bits=num_guard_bits,
                       exponents=tuple(exponents))
    steps = []
    for bi in range(nbands):
        r = 0 if bi == 0 else (bi - 1) // 3 + 1
        orient = 0 if bi == 0 else (bi - 1) % 3 + 1
        level = nl - r
        step = quant.default_irrev_stepsize(orient, level)
        if base_step > 0.0:
            step *= base_step
        steps.append(quant.encode_stepsize(step, prec))
    return QcdInfo(style=QuantStyle.SCALAR_EXPOUNDED,
                   num_guard_bits=num_guard_bits, steps=tuple(steps))


def _comps_iter(siz: SizInfo, cods, plans) -> List[CompIterInfo]:
    return [
        CompIterInfo(
            numresolutions=cods[c].numresolutions,
            dx=siz.comps[c].dx,
            dy=siz.comps[c].dy,
            tc_rect=plans[c].layout.tc_rect,
            prec_info=[(res.ppx, res.ppy, res.num_precincts_w,
                        res.num_precincts_h)
                       for res in plans[c].layout.resolutions],
        )
        for c in range(len(plans))
    ]


# --------------------------------------------------------------------------
# Encode
# --------------------------------------------------------------------------

def encode_t1_blocks(planes, blocks, cblk_style: int, reversible: bool):
    """The host-T1 half of the reference's `encode_tile` over a stack of
    tiles of one geometry. `planes[f]` holds frame f's band planes,
    {(comp, (r, orient)): 2-D plane}: int32 5/3 coefficients, or float32
    9/7 ones, quantized in the native block gather with their band's
    step; `blocks` the tile's code-blocks in t1-desc order, (comp, (r,
    orient), x0, y0, w, h, stepsize, kmax) each, offsets in the band
    plane. Every block of every frame is coded at `cblk_style` in one
    batched call of the host library's Tier-1 coder
    (`t1/backend.encode_cblk_batch_bands`, worker threads inside; with
    the HT style bit, the HT coder with refinement passes at each band's
    Mb, `kmax`). Returns per frame each block's (data, numbps, numpasses,
    passes) in t1-desc order, with the per-pass rates that T2 and the
    rate allocation read and the distortion decreases that `encode_tile`
    weights."""
    bands: List = []
    index: Dict = {}
    for f, fp in enumerate(planes):
        for k, plane in fp.items():
            index[(f, k)] = len(bands)
            bands.append(plane)
    step_of = {(c, key): st for (c, key, _, _, _, _, st, _) in blocks}
    res = t1_backend.encode_cblk_batch_bands(
        bands, [(index[(f, (b[0], b[1]))], *b[2:6])
                for f in range(len(planes)) for b in blocks],
        [b[1][1] for b in blocks] * len(planes), cblk_style,
        stepsizes=None if reversible else [step_of.get(k, 1.0)
                                           for fp in planes for k in fp],
        kmaxs=[b[7] for b in blocks] * len(planes))
    n = len(blocks)
    return [res[f * n:(f + 1) * n] for f in range(len(planes))]


@dataclasses.dataclass
class TileEncResult:
    body: bytes
    num_packets: int
    packet_headers: Optional[bytes] = None   # packed headers (PPM/PPT mode)
    packet_lengths: Optional[List[int]] = None  # per-packet byte counts
    packet_ids: Optional[List[Tuple[int, int, int, int]]] = None  # (l,r,c,p)


def encode_tile(
    t1_segments: List,
    siz: SizInfo,
    cod: CodInfo,
    qcd: QcdInfo,
    tile: Rect,
    layer_alloc=None,
    cod_comp: Optional[List[CodInfo]] = None,
    qcd_comp: Optional[List[QcdInfo]] = None,
    pocs=None,
    roishifts: Optional[List[int]] = None,
    split_headers: bool = False,
    want_packet_lengths: bool = False,
    tile_index: int = -1,
) -> TileEncResult:
    """Encode one tile to its packet body bytes from its code-block
    segments coded on the device (models/fused_encode.py) or by the host
    Tier-1 coder (`encode_t1_blocks`), `t1_segments`, in t1-desc order
    (comp -> resolution -> band -> precinct -> code-block): HT cleanup
    segments as bytes, or MQ segments as (data, numbps, numpasses)
    tuples, one codeword segment terminated at its last pass, or (data,
    numbps, numpasses, passes) with the block's per-pass R-D table
    (`PassInfo` list: for rate control, and for the host coder's
    code-block styles, whose passes end codeword segments of their
    own).

    `layer_alloc(ctx: pcrd.RateControlCtx) -> None` assigns
    `layer_npasses` on each CblkEnc (e.g. pcrd.PCRDAllocator, whose
    per-component caps read `ctx.simulate_comp_upto`); without it every
    pass goes into layer 0. `tile_index` is handed to it in the context.

    `split_headers=True` routes packet headers to a separate packed
    stream (for PPM/PPT signalling); the body then carries only SOP
    markers and packet payloads.

    `cod_comp` / `qcd_comp` hold each component's COC / QCC (None where
    the COD / QCD holds) and `roishifts` each component's ROI shift,
    which raises its bands' Kmax and so the missing bit-planes T2 writes.
    """
    ncomps = len(siz.comps)
    cods = [cod_comp[c] if cod_comp and cod_comp[c] else cod
            for c in range(ncomps)]
    qcds = [qcd_comp[c] if qcd_comp and qcd_comp[c] else qcd
            for c in range(ncomps)]
    plans = [build_comp_plan(siz, cods[c], qcds[c], tile, c,
                             roishifts[c] if roishifts else 0)
             for c in range(ncomps)]
    reversible = cod.transform == Transform.DWT_53

    t1_slots = []           # (comp, (r, orient), precinct_idx, cb, bp)
    for c in range(ncomps):
        plan = plans[c]
        for res in plan.layout.resolutions:
            for band in res.bands:
                bp = plan.bands[(res.r, band.orient)]
                for pi, prc in enumerate(band.precincts):
                    for cb in prc.cblks:
                        t1_slots.append((c, (res.r, band.orient), pi, cb, bp))
    t1_results = []
    for d in t1_segments:
        if isinstance(d, tuple) and len(d) == 4:
            t1_results.append(d)
        elif isinstance(d, tuple):
            data, nb, npas = d
            t1_results.append(
                (data, nb, npas,
                 [PassInfo(rate=len(data), distortion=0.0,
                           terminated=k == npas - 1) for k in range(npas)]))
        else:
            # HT: one cleanup pass
            t1_results.append((d, 1, 1, [PassInfo(
                rate=len(d), distortion=0.0, terminated=True)]))

    all_cblks: List[CblkEnc] = []
    prec_enc: List[Dict[Tuple[int, int], List[PrecEnc]]] = [
        {} for _ in range(ncomps)]
    slot_cblks: Dict[Tuple[int, Tuple[int, int], int], List[CblkEnc]] = {}
    mct_norms = None
    if cod.mct and ncomps >= 3:
        mct_norms = (quant.MCT_NORMS_REV if reversible
                     else quant.MCT_NORMS_IRREV)
    for (c, key, pi, cb, bp), (dat, numbps, npasses, passes) in zip(
            t1_slots, t1_results):
        if numbps > bp.kmax:
            raise ValueError(
                f"code-block numbps {numbps} exceeds Kmax "
                f"{bp.kmax}; increase guard bits")
        # PCRD distortion weighting: band synthesis norm x stepsize x MCT
        # norm, squared (reference: Tier1.cpp encodeCodeblocks stepsize/
        # band weighting + mct.cpp:67 norms).
        r, orient = key
        nl = cods[c].numresolutions - 1
        level = nl - r if r > 0 else nl
        wgt = quant.band_norm(orient, level, reversible) * bp.stepsize
        if mct_norms is not None and c < 3:
            wgt *= mct_norms[c]
        wgt *= wgt
        if wgt != 1.0:
            for p in passes:
                p.distortion *= wgt
        ce = CblkEnc(geom=cb, data=dat, numbps=numbps,
                     imsb=bp.kmax - numbps if numbps else bp.kmax,
                     numpasses=npasses, passes=passes)
        slot_cblks.setdefault((c, key, pi), []).append(ce)
        all_cblks.append(ce)
    for c in range(ncomps):
        plan = plans[c]
        for res in plan.layout.resolutions:
            for band in res.bands:
                key = (res.r, band.orient)
                plist: List[PrecEnc] = []
                for pi, prc in enumerate(band.precincts):
                    cbs = slot_cblks.get((c, key, pi), [])
                    plist.append(PrecEnc(geom=prc, cblks=cbs))
                prec_enc[c].setdefault(key, []).extend(plist)

    comps_iter = _comps_iter(siz, cods, plans)
    numlayers = cod.numlayers

    def _packet_iter():
        if pocs:
            return packet_order_poc(pocs, numlayers, comps_iter, tile)
        return packet_order(cod.progression, numlayers, comps_iter, tile)

    def _reset_t2_state():
        for per_res in prec_enc:
            for plist in per_res.values():
                for pe in plist:
                    for cb in pe.cblks:
                        cb.included = False
                        cb.lblock = 3
                        cb.passes_used = 0
                    pe.init_trees()

    def _groups():
        """(key, comp, band-precincts) of every precinct group, in the
        order of their first packets."""
        groups = []
        seen = set()
        for (l, r, c, p) in _packet_iter():
            key = (r, c, p)
            if key in seen:
                continue
            seen.add(key)
            orients = (0,) if r == 0 else (1, 2, 3)
            precs = [prec_enc[c][(r, o)][p] for o in orients
                     if (r, o) in prec_enc[c]]
            groups.append((key, c, precs))
        return groups

    def _emit(max_layer: int, collect: bytearray) -> Tuple[int, int]:
        """Emit packets for layers 0..max_layer; returns (bytes, packets).
        ONE native call encodes every precinct group; Python assembles
        the per-layer fragments in progression order."""
        nbytes = 0
        npk = 0
        tenc = t2_native.TileEnc(_groups(), numlayers, cod.cblk_style,
                                 cod.eph)
        frags = tenc.encode_all(max_layer)
        for (l, r, c, p) in _packet_iter():
            if l > max_layer:
                continue
            pkt = frags[(r, c, p)][l]
            if cod.sop:
                pkt = struct.pack(">HHH", 0xFF91, 4,
                                  npk & 0xFFFF) + bytes(pkt)
            nbytes += len(pkt)
            collect += pkt
            npk += 1
        return nbytes, npk

    # Layer allocation (PCRD when a rate/quality allocator is given).
    if layer_alloc is None:
        for cb in all_cblks:
            cb.layer_npasses = [cb.numpasses] + [0] * (numlayers - 1)
    else:
        tile_samples = sum(p.layout.tc_rect.w * p.layout.tc_rect.h
                           for p in plans)
        img_samples = sum(ceil_div(siz.xsiz - siz.xosiz, c.dx)
                          * ceil_div(siz.ysiz - siz.yosiz, c.dy)
                          for c in siz.comps)
        tile_sim = t2_native.TileSim(_groups(), numlayers, cod.eph)

        def _simulate(max_layer: int) -> int:
            """Total bytes of layers 0..max_layer (PCRD dry run): one
            native call over every precinct group."""
            total, _per_group = tile_sim.simulate(max_layer)
            if cod.sop:
                total += 6 * sum(1 for (l, *_rest) in _packet_iter()
                                 if l <= max_layer)
            return total

        def _simulate_comps(max_layer: int) -> Dict[int, int]:
            """Per-component packet byte totals for layers 0..max_layer
            (cinema per-component caps, reference T2.cpp:135-186)."""
            totals: Dict[int, int] = {}
            _, per_group = tile_sim.simulate(max_layer)
            for g, c in enumerate(tile_sim.comps):
                totals[c] = totals.get(c, 0) + int(per_group[g])
            if cod.sop:
                for (l, r, c, p) in _packet_iter():
                    if l <= max_layer:
                        totals[c] = totals.get(c, 0) + 6
            return totals

        ctx = RateControlCtx(
            cblks=all_cblks,
            numlayers=numlayers,
            tile_samples=tile_samples,
            image_samples=img_samples,
            max_prec=max(c.prec for c in siz.comps),
            simulate_upto=_simulate,
            simulate_comp_upto=_simulate_comps,
            write_layer=tile_sim.write_rows,
            tile_index=tile_index,
        )
        layer_alloc(ctx)

    # Final packet emission in progression order.
    if split_headers:
        _reset_t2_state()
        hdrs = bytearray()
        body = bytearray()
        npackets = 0
        for (l, r, c, p) in _packet_iter():
            orients = (0,) if r == 0 else (1, 2, 3)
            precs = [prec_enc[c][(r, o)][p] for o in orients
                     if (r, o) in prec_enc[c]]
            h, b = encode_packet(l, precs, cod.cblk_style, sop=cod.sop,
                                 eph=cod.eph, packet_index=npackets,
                                 split=True)
            hdrs += h
            body += b
            npackets += 1
        return TileEncResult(body=bytes(body), num_packets=npackets,
                             packet_headers=bytes(hdrs))
    body = bytearray()
    plens: Optional[List[int]] = [] if want_packet_lengths else None
    pids: Optional[List[Tuple[int, int, int, int]]] = None
    if plens is not None:
        _reset_t2_state()
        pids = []
        npackets = 0
        for (l, r, c, p) in _packet_iter():
            orients = (0,) if r == 0 else (1, 2, 3)
            precs = [prec_enc[c][(r, o)][p] for o in orients
                     if (r, o) in prec_enc[c]]
            pkt = encode_packet(l, precs, cod.cblk_style, sop=cod.sop,
                                eph=cod.eph, packet_index=npackets)
            plens.append(len(pkt))
            pids.append((l, r, c, p))
            body += pkt
            npackets += 1
    else:
        _, npackets = _emit(numlayers - 1, body)
    return TileEncResult(body=bytes(body), num_packets=npackets,
                         packet_lengths=plens, packet_ids=pids)


# --------------------------------------------------------------------------
# Decode
# --------------------------------------------------------------------------

def _band_window(win: Rect, r: int, orient: int, numresolutions: int,
                 reversible: bool) -> Rect:
    """Conservative band-coordinate region needed to reconstruct `win`
    (full-resolution component canvas coords), grown by the synthesis filter
    margin per level (reference: src/lib/jp2/transform/dwt.cpp
    get_band_coordinates:1131, segment_grow:1172)."""
    margin = 2 if reversible else 4
    nl = numresolutions - 1
    x0, y0, x1, y1 = win.x0, win.y0, win.x1, win.y1
    # Walk down from full resolution to resolution r's band split.
    levels = nl - r + 1 if r > 0 else nl
    for _ in range(levels):
        x0 = (x0 >> 1) - margin
        y0 = (y0 >> 1) - margin
        x1 = ((x1 + 1) >> 1) + margin
        y1 = ((y1 + 1) >> 1) + margin
    # Band offset: HL shifts x by floor at odd grid; conservative region
    # already includes the +-margin growth, so the same rect works for all
    # orientations at this level.
    return Rect(x0, y0, x1, y1)


def decode_tile(body: bytes, siz: SizInfo, cod: CodInfo, qcd: QcdInfo,
                tile: Rect, max_layers: int = 0,
                window: Optional[Rect] = None,
                cod_comp: Optional[List[Optional[CodInfo]]] = None,
                qcd_comp: Optional[List[Optional[QcdInfo]]] = None,
                pocs=None, packed_headers: Optional[bytes] = None,
                roishifts: Optional[List[int]] = None):
    """Parse one tile's packet body into its entropy-decode jobs: the
    reference's `decode_tile(..., _return_jobs=True)` without reduce (a
    reduced decode drops the higher resolutions' jobs itself).
    `cod_comp` / `qcd_comp` hold the COC / QCC overrides of
    each component (None where the main COD / QCD holds), `pocs` the POC
    entries, which give the packet order in place of the COD's
    progression, and `packed_headers` the tile's packet headers from its
    PPM or PPT markers, `roishifts` each component's ROI shift (its
    bands' Kmax raised by it). With `max_layers` > 0 only the passes of the
    first `max_layers` quality layers are kept. With `window` (canvas
    coords at full resolution) only the code-blocks that can influence
    it get a job (the reference's filter, `_band_window`); every packet
    is still parsed, as packet order requires.

    Without packed headers the native T2 parses every packet (it parses
    the later layers' packets and drops their passes, where the
    reference parses the whole tile in Python with `decode_packet(...,
    discard=True)`); with them the Python T2 parses one
    `decode_packet_split` a packet, headers from `packed_headers` and
    bodies from `body`, as the reference does.

    Returns (t1_jobs, t1_job_slots, plans, cods): per included
    code-block a job (data, seg_lengths, w, h, orient, numbps,
    numpasses, kmax) and its slot (comp, (r, orient), CblkDec)."""
    ncomps = len(siz.comps)
    cods = [cod_comp[c] if cod_comp and cod_comp[c] else cod
            for c in range(ncomps)]
    qcds = [qcd_comp[c] if qcd_comp and qcd_comp[c] else qcd
            for c in range(ncomps)]
    plans = [build_comp_plan(siz, cods[c], qcds[c], tile, c,
                             roishifts[c] if roishifts else 0)
             for c in range(ncomps)]

    # Build decode structures.
    prec_dec: List[Dict[Tuple[int, int], List[PrecDec]]] = []
    cblk_index: List[Dict[Tuple[int, int], List[CblkDec]]] = []
    for c in range(ncomps):
        plan = plans[c]
        per_res: Dict[Tuple[int, int], List[PrecDec]] = {}
        cb_per_band: Dict[Tuple[int, int], List[CblkDec]] = {}
        for res in plan.layout.resolutions:
            for band in res.bands:
                plist = []
                cbl = []
                for prc in band.precincts:
                    cbs = [CblkDec(geom=cb) for cb in prc.cblks]
                    plist.append(PrecDec(geom=prc, cblks=cbs))
                    cbl.extend(cbs)
                per_res[(res.r, band.orient)] = plist
                cb_per_band[(res.r, band.orient)] = cbl
        prec_dec.append(per_res)
        cblk_index.append(cb_per_band)

    comps_iter = _comps_iter(siz, cods, plans)
    if pocs:
        piter = packet_order_poc(pocs, cod.numlayers, comps_iter, tile)
    else:
        piter = packet_order(cod.progression, cod.numlayers, comps_iter,
                             tile)
    pkt_list = list(piter)
    if packed_headers is not None:
        numlayers = cod.numlayers if max_layers == 0 else min(
            cod.numlayers, max_layers)
        pos = 0
        hpos = 0
        for (l, r, c, p) in pkt_list:
            orients = (0,) if r == 0 else (1, 2, 3)
            precs = [prec_dec[c][(r, o)][p] for o in orients
                     if (r, o) in prec_dec[c]]
            kmaxs = [plans[c].bands[(r, o)].kmax for o in orients
                     if (r, o) in plans[c].bands]
            pos, hpos = decode_packet_split(
                packed_headers, hpos, body, pos, l, precs, kmaxs,
                cods[c].cblk_style, eph=cod.eph, discard=(l >= numlayers))
    else:
        groups = []
        group_idx: Dict[Tuple[int, int, int], int] = {}
        packets = []
        for (l, r, c, p) in pkt_list:
            key = (r, c, p)
            if key not in group_idx:
                group_idx[key] = len(groups)
                orients = (0,) if r == 0 else (1, 2, 3)
                groups.append([
                    (prec_dec[c][(r, o)][p],
                     plans[c].bands[(r, o)].kmax,
                     cods[c].cblk_style)
                    for o in orients if (r, o) in prec_dec[c]
                ])
            packets.append((group_idx[key], l))
        rc = t2_native.decode_tile_packets(body, packets, groups, None,
                                           None, cod.sop, cod.eph,
                                           max_layers)
        if rc is None:
            raise ValueError(
                "the native T2 parser rejected the tile's packets")

    reversible = cod.transform == Transform.DWT_53
    t1_jobs = []
    t1_job_slots = []
    for c in range(ncomps):
        plan = plans[c]
        comp_win = None
        if window is not None:
            comp_win = component_rect(window, siz.comps[c].dx,
                                      siz.comps[c].dy)
        for res in plan.layout.resolutions:
            for band in res.bands:
                bwin = None
                if comp_win is not None:
                    bwin = _band_window(comp_win, res.r, band.orient,
                                        cod.numresolutions, reversible)
                for cb in cblk_index[c][(res.r, band.orient)]:
                    if cb.numpasses == 0:
                        continue
                    if bwin is not None:
                        r_ = cb.geom.rect
                        if (r_.x1 <= bwin.x0 or r_.x0 >= bwin.x1
                                or r_.y1 <= bwin.y0 or r_.y0 >= bwin.y1):
                            continue
                    data, seg_lengths = cb.data_and_seg_lengths()
                    bp_d = plan.bands[(res.r, band.orient)]
                    t1_jobs.append((data, seg_lengths, cb.geom.rect.w,
                                    cb.geom.rect.h, band.orient, cb.numbps,
                                    cb.numpasses, bp_d.kmax))
                    t1_job_slots.append((c, (res.r, band.orient), cb))
    return t1_jobs, t1_job_slots, plans, cods


def index_tile_packets(body: bytes, hdr, tile_index: int):
    """Packet index of one tile: (layer, res, comp, prec, offset, bytes)
    per packet in progression order — the grk_dump codestream-index
    analog (reference: j2k_dump.cpp:176). Parses headers only, with the
    Python T2. `hdr` is a `decoder.read_header` result; the per-component
    byte caps of a profile are checked on it."""
    from ..core.geometry import tile_rect as _tile_rect
    siz, cod, qcd = hdr.siz, hdr.cod, hdr.qcd
    tile = _tile_rect(tile_index, siz.xsiz, siz.ysiz, siz.xosiz, siz.yosiz,
                      siz.xtsiz, siz.ytsiz, siz.xtosiz, siz.ytosiz)
    ncomps = len(siz.comps)
    cod_comp = hdr.cod_comp
    qcd_comp = hdr.qcd_comp
    cods = [cod_comp[c] if cod_comp and cod_comp[c] else cod
            for c in range(ncomps)]
    qcds = [qcd_comp[c] if qcd_comp and qcd_comp[c] else qcd
            for c in range(ncomps)]
    plans = [build_comp_plan(siz, cods[c], qcds[c], tile, c)
             for c in range(ncomps)]
    prec_dec = []
    for c in range(ncomps):
        per_res = {}
        for res in plans[c].layout.resolutions:
            for band in res.bands:
                plist = []
                for prc in band.precincts:
                    pd = PrecDec(geom=prc,
                                 cblks=[CblkDec(geom=cb)
                                        for cb in prc.cblks])
                    pd.init_trees()
                    plist.append(pd)
                per_res[(res.r, band.orient)] = plist
        prec_dec.append(per_res)
    comps_iter = _comps_iter(siz, cods, plans)
    if hdr.pocs:
        piter = packet_order_poc(hdr.pocs, cod.numlayers, comps_iter, tile)
    else:
        piter = packet_order(cod.progression, cod.numlayers, comps_iter,
                             tile)
    out = []
    pos = 0
    for (l, r, c, p) in piter:
        if pos >= len(body):
            break
        orients = (0,) if r == 0 else (1, 2, 3)
        precs = [prec_dec[c][(r, o)][p] for o in orients
                 if (r, o) in prec_dec[c]]
        kmaxs = [plans[c].bands[(r, o)].kmax for o in orients
                 if (r, o) in plans[c].bands]
        start = pos
        pos = decode_packet(body, pos, l, precs, kmaxs,
                            cods[c].cblk_style, sop=cod.sop, eph=cod.eph,
                            discard=True)
        out.append((l, r, c, p, start, pos - start))
    return out
