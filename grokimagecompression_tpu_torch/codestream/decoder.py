"""Decode entry points on a torch device.

Port of `grokimagecompression_tpu/codestream/decoder.py` for the HT and
Part-1 MQ slices, 5/3 or 9/7. The
main-header and tile-part walk (`CodestreamHeader`, `TilePart`,
`_validate_siz`, `read_header`, `iter_tile_parts`) is copied from the
reference. `decode_batch` is the port of the reference's fused
`decode_batch` and `decode` of its per-image `decode`: host T2 (the
port's native T2, or its Python T2 where packed packet headers are),
then the fused device decode of `models/fused_decode.py`, whose block
decoders and inverse transforms run on the device. Both take raw
codestreams and JP2 files, single- or multi-tile, with COC and QCC
overrides (a COC may change a component's transform, resolution count
or block coder: such a tile decodes in groups of components,
`tile_groups`), tile-part header overrides (COD, COC, QCD, QCC, POC
between SOT and SOD, applied per tile as the reference's
`_tile_params`), POC, packed packet headers (PPM, PPT), ROI shifts
(RGN) and a Part-2 custom MCT (MCT / MCC records), and the reference's
requests: a layer limit, a reduced resolution, a single tile and a
window, alone or combined. A window's code-blocks are decoded and
dequantized on the device and inverted on the host by the copy of the
reference's windowed inverse (`ops/dwt_window.py`), as the reference
does.

The MQ code-block styles other than the default (in the COD or a COC),
MQ bands whose Kmax (with its ROI shift) exceeds the CUDA MQ decoder's
word, HT code-blocks with refinement passes (Part 15 full mode) and HT
bands whose Mb + 3 exceeds the CUDA HT decoder's 32 bits take the
reference's host route for them: the host library's Tier-1 decoders
into band planes, one upload, and the inverse transforms on the device
(`fused_decode.FusedT1Decoder`). The route is chosen per component group
from the COD / COC style, the bands' Kmax and the parsed jobs' pass
counts before anything is launched (`_coder`, `tile_plans`); MQ blocks
of the default style and HT blocks of the cleanup pass alone in bands
the HT kernel holds never reach the host decoder.

What is outside the port raises NotImplementedError with its reason
instead of falling back to a host decode: ROI on HT code-blocks, and a
request on the host route on a mesh of more than one shard (the
reference's transform-only mesh route).
"""

from __future__ import annotations

import concurrent.futures
import dataclasses
import os
import struct
from typing import Dict, List, NamedTuple, Optional, Sequence

import numpy as np

import torch

from ..core.geometry import (Rect, ceil_div, component_rect,
                             tile_grid_size, tile_rect)
from ..core.image import Component, Image
from ..core.params import DecoderParams, Transform
from ..models import fused_decode, pipeline
from ..ops import dwt_window
from ..ops.mq_dec import MAX_PLANES as MQ_MAX_PLANES
from ..utils.device import DeviceLike, resolve_mesh
from . import jp2, markers
from .markers import CodInfo, QcdInfo, SizInfo
from .tile import decode_tile


@dataclasses.dataclass
class CodestreamHeader:
    siz: SizInfo
    cod: CodInfo
    qcd: QcdInfo
    comments: List[str]
    main_header_end: int  # offset of first SOT
    cod_comp: Optional[List[Optional[CodInfo]]] = None  # COC overrides
    qcd_comp: Optional[List[Optional[QcdInfo]]] = None  # QCC overrides
    pocs: Optional[list] = None                          # POC entries
    tlm: Optional[list] = None                           # (tile, length)
    roishifts: Optional[List[int]] = None                # RGN per comp
    custom_mct: Optional[tuple] = None                   # (matrix, offsets)
    ppm_sections: Optional[list] = None                  # packed hdrs/tile-part


@dataclasses.dataclass
class TilePart:
    tile_index: int
    body: bytes
    # Tile-part header overrides (COD/COC/QCD/QCC/POC between SOT and SOD);
    # COC/QCC kept as raw payloads, parsed once ncomps is known.
    cod: Optional[CodInfo] = None
    coc_raw: List[bytes] = dataclasses.field(default_factory=list)
    qcd: Optional[QcdInfo] = None
    qcc_raw: List[bytes] = dataclasses.field(default_factory=list)
    poc_raw: Optional[bytes] = None
    ppt_raw: List[bytes] = dataclasses.field(default_factory=list)
    plt_lengths: List[int] = dataclasses.field(default_factory=list)
    # True when the walk skipped this tile-part's header/body (tile not
    # in the caller's `want` set): only tile_index is valid.
    skipped: bool = False


def _validate_siz(siz: SizInfo) -> None:
    """SIZ sanity limits (reference: j2k_read_siz:3361 validation;
    max-tile guard j2k.cpp:2072). Rejecting here keeps corrupt headers
    from driving huge/negative tile grids or absurd allocations."""
    if not (0 <= siz.xosiz < siz.xsiz and 0 <= siz.yosiz < siz.ysiz):
        raise ValueError("SIZ: invalid image area")
    if siz.xtsiz <= 0 or siz.ytsiz <= 0:
        raise ValueError("SIZ: invalid tile size")
    if not (0 <= siz.xtosiz <= siz.xosiz and 0 <= siz.ytosiz <= siz.yosiz):
        raise ValueError("SIZ: tile origin must not exceed image origin")
    if siz.xtosiz + siz.xtsiz <= siz.xosiz or \
            siz.ytosiz + siz.ytsiz <= siz.yosiz:
        raise ValueError("SIZ: first tile does not cover the image origin")
    ntx, nty = tile_grid_size(siz.xsiz, siz.ysiz, siz.xosiz, siz.yosiz,
                              siz.xtsiz, siz.ytsiz, siz.xtosiz, siz.ytosiz)
    if ntx <= 0 or nty <= 0 or ntx * nty > 65535:
        raise ValueError(f"SIZ: invalid tile grid {ntx}x{nty}")
    if not siz.comps or len(siz.comps) > 16384:
        raise ValueError("SIZ: invalid component count")
    for c in siz.comps:
        if not (1 <= c.prec <= 38):
            raise ValueError(f"SIZ: invalid precision {c.prec}")
        if not (1 <= c.dx <= 255 and 1 <= c.dy <= 255):
            raise ValueError("SIZ: invalid subsampling")


def read_header(data: bytes) -> CodestreamHeader:
    if struct.unpack(">H", data[0:2])[0] != markers.SOC:
        raise ValueError("not a J2K codestream (missing SOC)")
    pos = 2
    siz = cod = qcd = None
    comments: List[str] = []
    coc_raw = []
    qcc_raw = []
    rgn_raw = []
    mct_raw = []
    ppm_raw = []
    pocs = None
    tlm = None
    while pos + 4 <= len(data):
        marker = struct.unpack(">H", data[pos:pos + 2])[0]
        if marker == markers.SOT:
            break
        length = struct.unpack(">H", data[pos + 2:pos + 4])[0]
        payload = data[pos + 4:pos + 2 + length]
        if marker == markers.SIZ:
            siz = markers.parse_siz(payload)
        elif marker == markers.COD:
            cod = markers.parse_cod(payload)
        elif marker == markers.COC:
            coc_raw.append(payload)
        elif marker == markers.QCD:
            qcd = markers.parse_qcd(payload)
        elif marker == markers.QCC:
            qcc_raw.append(payload)
        elif marker == markers.POC:
            pocs = payload  # parsed below once ncomps is known
        elif marker == markers.TLM:
            tlm = markers.parse_tlm(payload)
        elif marker == markers.RGN:
            rgn_raw.append(payload)
        elif marker == markers.MCT:
            mct_raw.append(payload)
        elif marker == markers.PPM:
            ppm_raw.append((payload[0], payload[1:]))
        elif marker == markers.COM:
            if len(payload) >= 2:
                comments.append(payload[2:].decode("latin-1", "replace"))
        # PLM/PPM/CRG/CAP: skipped by length.
        pos += 2 + length
    if siz is None or cod is None or qcd is None:
        raise ValueError("incomplete main header (need SIZ, COD, QCD)")
    _validate_siz(siz)
    ncomps = len(siz.comps)
    cod_comp = None
    if coc_raw:
        cod_comp = [None] * ncomps
        for payload in coc_raw:
            compno, cc = markers.parse_coc(payload, ncomps, cod)
            cod_comp[compno] = cc
    qcd_comp = None
    if qcc_raw:
        qcd_comp = [None] * ncomps
        for payload in qcc_raw:
            compno, qq = markers.parse_qcc(payload, ncomps)
            qcd_comp[compno] = qq
    poc_entries = markers.parse_poc(pocs, ncomps) if pocs else None
    roishifts = None
    if rgn_raw:
        roishifts = [0] * ncomps
        for payload in rgn_raw:
            compno, srgn, shift = markers.parse_rgn(payload, ncomps)
            if srgn == 0:
                roishifts[compno] = shift
    ppm_sections = None
    if ppm_raw:
        ppm_sections = markers.split_ppm_sections(markers.merge_ppx(ppm_raw))
    custom_mct = None
    if mct_raw:
        matrix = offsets = None
        n = ncomps
        for payload in mct_raw:
            idx, at, et, data = markers.parse_mct_record(payload)
            if at == markers.MCT_ARRAY_DECORRELATION and data.size == n * n:
                matrix = data.reshape(n, n)
            elif at == markers.MCT_ARRAY_OFFSET and data.size == n:
                offsets = data
        if matrix is not None:
            if offsets is None:
                offsets = np.zeros(n, dtype=np.float32)
            custom_mct = (matrix, offsets)
    return CodestreamHeader(siz=siz, cod=cod, qcd=qcd, comments=comments,
                            main_header_end=pos, cod_comp=cod_comp,
                            qcd_comp=qcd_comp, pocs=poc_entries, tlm=tlm,
                            roishifts=roishifts, custom_mct=custom_mct,
                            ppm_sections=ppm_sections)


def iter_tile_parts(data: bytes, start: int, want=None):
    """Yield TilePart records by walking SOT/Psot; tolerates truncation.

    `want(tile_index) -> bool` (optional) marks which tiles the caller
    will decode: other tiles' parts are yielded as lightweight
    `skipped` records — no header walk, no body slice — so a windowed
    or single-tile decode of a large tiled stream never copies the
    bytes it does not need (the reference's TLM/seek analog)."""
    pos = start
    while pos + 4 <= len(data):
        marker = struct.unpack(">H", data[pos:pos + 2])[0]
        if marker == markers.EOC:
            return
        if marker != markers.SOT:
            # Resync: skip marker segment if it has a length.
            if pos + 4 <= len(data):
                length = struct.unpack(">H", data[pos + 2:pos + 4])[0]
                pos += 2 + length
                continue
            return
        sot = markers.parse_sot(data[pos + 4:pos + 12])
        psot = sot.psot if sot.psot else len(data) - pos
        tp_end = min(pos + psot, len(data))
        if want is not None and not want(sot.tile_index):
            yield TilePart(tile_index=sot.tile_index, body=b"",
                           skipped=True)
            pos = pos + psot if sot.psot else tp_end
            continue
        # Walk markers inside the tile-part header until SOD, collecting
        # per-tile parameter overrides.
        hp = pos + 12
        tp = TilePart(tile_index=sot.tile_index, body=b"")
        while hp + 2 <= tp_end:
            m = struct.unpack(">H", data[hp:hp + 2])[0]
            if m == markers.SOD:
                hp += 2
                break
            ln = struct.unpack(">H", data[hp + 2:hp + 4])[0]
            payload = data[hp + 4:hp + 2 + ln]
            if m == markers.COD:
                tp.cod = markers.parse_cod(payload)
            elif m == markers.QCD:
                tp.qcd = markers.parse_qcd(payload)
            elif m == markers.COC:
                tp.coc_raw.append(payload)
            elif m == markers.QCC:
                tp.qcc_raw.append(payload)
            elif m == markers.POC:
                tp.poc_raw = payload
            elif m == markers.PPT:
                tp.ppt_raw.append(payload)
            elif m == markers.PLT:
                _, lens, _ = markers.parse_plt(payload)
                tp.plt_lengths.extend(lens)
            hp += 2 + ln
        tp.body = data[hp:tp_end]
        yield tp
        pos = pos + psot if sot.psot else tp_end


def batch_key(h: CodestreamHeader) -> tuple:
    """What `decode_batch` requires to be equal in every stream of a
    batch (`_out_of_slice`): SIZ, COD and QCD, then the COC / QCC
    overrides, the POC, whether the stream has packed headers (PPM), the
    ROI shifts (RGN) and the custom MCT's matrix and offsets."""
    mct = None if h.custom_mct is None else tuple(
        tuple(np.asarray(a, np.float32).ravel().tolist())
        for a in h.custom_mct)
    return (h.siz, h.cod, h.qcd, h.cod_comp, h.qcd_comp, h.pocs,
            h.ppm_sections is not None,
            tuple(h.roishifts) if h.roishifts else None, mct)


def _coder(cod: CodInfo) -> str:
    """The block coder route of a COD or COC: "ht" (the CUDA HT
    decoder), "mq" (the default MQ style, the CUDA MQ decoder) or "t1"
    (any other MQ style: the host Tier-1 decoder). `tile_plans` also
    sends "mq" bands deeper than the CUDA MQ decoder's word and "ht"
    components with refinement passes to "t1", and
    `fused_decode.build_plan` "ht" bands deeper than the CUDA HT
    decoder's."""
    if cod.cblk_style & 0x40:
        return "ht"
    return "t1" if cod.cblk_style else "mq"


def _roi_out_of_slice(cods, roishifts) -> Optional[str]:
    """Why ROI shifts are outside the port, or None: a shift on a
    component coded with the HT block coder (no encoder writes it, and
    the HT decoder's Mb would take the shift)."""
    if roishifts and any(s and _coder(cc) == "ht"
                         for s, cc in zip(roishifts, cods)):
        return "ROI shifts on HT code-blocks"
    return None


def _out_of_slice(hdrs: List[CodestreamHeader]) -> Optional[str]:
    """Why a batch of parsed headers is outside the port, or None; the
    tile-part headers are checked as their tiles are parsed
    (`_parse_frame`)."""
    h0 = hdrs[0]
    if any(batch_key(h)[:3] != batch_key(h0)[:3] for h in hdrs[1:]):
        return "streams of different coding parameters"
    siz, cod = h0.siz, h0.cod
    cods = [cc or cod for cc in (h0.cod_comp or [None] * len(siz.comps))]
    why = _roi_out_of_slice(cods, h0.roishifts)
    if why is not None:
        return why
    if cod.mct and len(siz.comps) >= 3 and any(
            (c.dx, c.dy) != (siz.comps[0].dx, siz.comps[0].dy)
            for c in siz.comps[:3]):
        return "an MCT over differently sampled components"
    if any(batch_key(h)[3:] != batch_key(h0)[3:] for h in hdrs[1:]):
        return ("streams of different COC / QCC overrides, POCs, packed "
                "headers (PPM), ROI shifts or custom MCTs")
    return None


class TileParams(NamedTuple):
    """A tile's effective coding parameters (`_tile_params`)."""
    cod: CodInfo
    qcd: QcdInfo
    cod_comp: Optional[List[Optional[CodInfo]]]
    qcd_comp: Optional[List[Optional[QcdInfo]]]
    pocs: Optional[list]


class TileJobs(NamedTuple):
    """One tile's parse, (t1_jobs, t1_job_slots, plans, cods) as
    `tile.decode_tile` returns it, and the coding parameters it was
    parsed with: two streams decode a tile with the same plans exactly
    when their `params` are equal."""
    jobs: list
    slots: list
    plans: list
    cods: list
    params: TileParams

    @property
    def cod(self) -> CodInfo:
        """The tile's COD: its tile-part COD or the main header's, with
        mct 2 where a custom MCT is signalled."""
        return self.params.cod

    @property
    def coc(self) -> bool:
        """Whether COC overrides apply to the tile."""
        return bool(self.params.cod_comp)


def _tile_params(hdr: CodestreamHeader, tp: Optional[TilePart]
                 ) -> TileParams:
    """The tile's effective coding parameters: the main header's with
    the tile-part header overrides `tp` (the last tile-part of the tile
    that has any) applied, as the reference's `decode` does (its
    `_tile_params`). With a custom MCT the main COD signals mct 2, as
    the reference sets it."""
    ncomps = len(hdr.siz.comps)
    tcod, tqcd = hdr.cod, hdr.qcd
    if hdr.custom_mct is not None:
        tcod = dataclasses.replace(tcod, mct=2)
    cod_comp = list(hdr.cod_comp) if hdr.cod_comp else None
    qcd_comp = list(hdr.qcd_comp) if hdr.qcd_comp else None
    pocs = hdr.pocs
    if tp is not None:
        if tp.cod:
            tcod = tp.cod
            cod_comp = None
        if tp.qcd:
            tqcd = tp.qcd
            qcd_comp = None
        if tp.coc_raw:
            cod_comp = cod_comp or [None] * ncomps
            for payload in tp.coc_raw:
                compno, cc = markers.parse_coc(payload, ncomps, tcod)
                cod_comp[compno] = cc
        if tp.qcc_raw:
            qcd_comp = qcd_comp or [None] * ncomps
            for payload in tp.qcc_raw:
                compno, qq = markers.parse_qcc(payload, ncomps)
                qcd_comp[compno] = qq
        if tp.poc_raw:
            pocs = markers.parse_poc(tp.poc_raw, ncomps)
    return TileParams(tcod, tqcd, cod_comp, qcd_comp, pocs)


@dataclasses.dataclass(frozen=True)
class _Request:
    """What a `DecoderParams` asks of one geometry, as the reference's
    `decode` derives it."""
    reduce: int                       # clamped to the resolution levels
    window: Optional[Rect]            # clipped to the image area
    area: Rect                        # the output's canvas area
    tiles: Optional[frozenset]        # the tiles to decode; None: all


def _tile_rects(siz: SizInfo) -> List[Rect]:
    ntx, nty = tile_grid_size(siz.xsiz, siz.ysiz, siz.xosiz, siz.yosiz,
                              siz.xtsiz, siz.ytsiz, siz.xtosiz, siz.ytosiz)
    return [tile_rect(t, siz.xsiz, siz.ysiz, siz.xosiz, siz.yosiz,
                      siz.xtsiz, siz.ytsiz, siz.xtosiz, siz.ytosiz)
            for t in range(ntx * nty)]


def _request(siz: SizInfo, cod: CodInfo, trs: List[Rect],
             params: DecoderParams) -> _Request:
    """The reference's derivation: `reduce` clamped to the COD's levels;
    the window clipped to the image (ValueError when nothing is left);
    the output area of a single tile cropped to the tile; the tiles a
    window or single-tile decode needs, known before T2."""
    reduce = min(params.reduce, cod.numresolutions - 1)
    image = Rect(siz.xosiz, siz.yosiz, siz.xsiz, siz.ysiz)
    win = None
    if params.window is not None:
        win = Rect(*params.window).clip(image)
        if win.is_empty():
            raise ValueError(f"decode window {params.window} is empty "
                             f"after clipping to the image area")
    tiles = None
    area = image if win is None else win
    if params.tile_index is not None:
        if not 0 <= params.tile_index < len(trs):
            raise ValueError(f"tile index {params.tile_index} outside the "
                             f"{len(trs)} tiles")
        tiles = frozenset((params.tile_index,))
        if win is None:
            area = trs[params.tile_index]
    elif win is not None:
        tiles = frozenset(t for t, tr in enumerate(trs)
                          if not tr.clip(win).is_empty())
    return _Request(reduce=reduce, window=win, area=area, tiles=tiles)


def _parse_frame(data: bytes, hdr: CodestreamHeader, trs: List,
                 layers: int, tiles: Optional[frozenset] = None,
                 window: Optional[Rect] = None):
    """T2 of the tiles `tiles` (all when None) of one stream, keeping the
    passes of the first `layers` quality layers (all when 0) and, with a
    `window`, the jobs of its code-blocks only: (per tile (t1_jobs,
    t1_job_slots, plans, cods), None for a tile not asked for; set of the
    asked tiles that have a tile-part). The other tiles' tile-parts are
    skipped unread (`iter_tile_parts(want=)`).

    Packed packet headers go to their tile as the reference's
    `decode_batch` hands them over: a PPM section to each tile-part in
    stream order (a skipped tile-part's section too), or a tile-part's
    PPT segments merged (`markers.merge_ppx`); a tile's sections are
    joined in the order of its tile-parts."""
    tile_bodies: Dict[int, List[bytes]] = {}
    tile_hdrs: Dict[int, List[bytes]] = {}
    tile_over: Dict[int, TilePart] = {}
    ppm_iter = iter(hdr.ppm_sections or [])
    for tp in iter_tile_parts(data, hdr.main_header_end,
                              want=None if tiles is None
                              else tiles.__contains__):
        if tp.skipped:
            if hdr.ppm_sections is not None:
                next(ppm_iter, b"")
            continue
        if tp.cod or tp.qcd or tp.coc_raw or tp.qcc_raw or tp.poc_raw:
            tile_over[tp.tile_index] = tp
        tile_bodies.setdefault(tp.tile_index, []).append(tp.body)
        if hdr.ppm_sections is not None:
            tile_hdrs.setdefault(tp.tile_index, []).append(
                next(ppm_iter, b""))
        elif tp.ppt_raw:
            tile_hdrs.setdefault(tp.tile_index, []).append(
                markers.merge_ppx([(pl[0], pl[1:]) for pl in tp.ppt_raw]))
    out = []
    for t, tr in enumerate(trs):
        if tiles is not None and t not in tiles:
            out.append(None)
            continue
        packed = b"".join(tile_hdrs[t]) if t in tile_hdrs else None
        tparams = _tile_params(hdr, tile_over.get(t))
        tcod, tqcd, cod_comp, qcd_comp, pocs = tparams
        if t in tile_over:
            cods = [(cod_comp[c] if cod_comp and cod_comp[c] else tcod)
                    for c in range(len(hdr.siz.comps))]
            why = _roi_out_of_slice(cods, hdr.roishifts)
            if why is not None:
                raise NotImplementedError(
                    f"the torch decode does not cover {why} yet")
        out.append(TileJobs(*decode_tile(
            b"".join(tile_bodies.get(t, [])), hdr.siz, tcod, tqcd, tr,
            max_layers=layers, window=window, cod_comp=cod_comp,
            qcd_comp=qcd_comp, pocs=pocs, packed_headers=packed,
            roishifts=hdr.roishifts), tparams))
    # tiles with NO tile-parts at all stay zero in the canvas, like the
    # single-stream decode (a truncated stream can lose whole tiles; an
    # empty-BODY tile-part still decodes to DC midline)
    return out, frozenset(tile_bodies)


def _headers(datas: List[bytes]):
    """JP2 unwrap and main headers of a batch of streams; raises
    NotImplementedError outside the slice (`_out_of_slice`)."""
    datas = [jp2.extract_codestream(d) if jp2.is_jp2(d) else d
             for d in datas]
    hdrs = [read_header(d) for d in datas]
    why = _out_of_slice(hdrs)
    if why is not None:
        raise NotImplementedError(
            f"the torch decode does not cover {why} yet")
    return datas, hdrs


def parse_batch(datas: List[bytes], params: Optional[DecoderParams] = None):
    """Headers and T2 of a batch of streams, on a thread pool, for the
    tiles and window that `params` asks for (`_request`). Returns
    (header of stream 0, tile rects, per stream the `_parse_frame`
    result). Raises NotImplementedError outside the slice."""
    params = params or DecoderParams()
    datas, hdrs = _headers(datas)
    trs = _tile_rects(hdrs[0].siz)
    req = _request(hdrs[0].siz, hdrs[0].cod, trs, params)
    nw = max(1, min(len(datas), 2 * (os.cpu_count() or 1)))
    with concurrent.futures.ThreadPoolExecutor(max_workers=nw) as ex:
        parsed = list(ex.map(lambda i: _parse_frame(
            datas[i], hdrs[i], trs, params.layers, req.tiles, req.window),
            range(len(datas))))
    return hdrs[0], trs, parsed


def _comp_groups(tj: TileJobs):
    """[(cod, comps)]: a parsed tile's components grouped by their
    (transform, resolution count, block coder), each group with the COD
    or COC its components share, in the order of their first component;
    [(the tile's COD, None)] when every component shares the tile COD's
    (the tile decodes in one plan)."""
    def sig(cc):
        return (cc.transform, cc.numresolutions, _coder(cc))
    cods = tj.cods
    if all(sig(cc) == sig(tj.cod) for cc in cods):
        return [(tj.cod, None)]
    groups: Dict[tuple, tuple] = {}
    for c, cc in enumerate(cods):
        groups.setdefault(sig(cc), (cc, []))[1].append(c)
    return [(cc, tuple(comps)) for cc, comps in groups.values()]


def tile_config(hdr: CodestreamHeader, tr: Rect, tj: TileJobs):
    """The transform config of a whole parsed tile (its COD's MCT or the
    custom MCT), whose `pipeline.inv_mct_dc` finishes a tile decoded in
    component groups."""
    return pipeline.config_for_tile(hdr.siz, tj.cod, tr, hdr.custom_mct)


def refined_comps(tj: TileJobs) -> frozenset:
    """The components of a parsed tile whose HT code-blocks carry
    refinement passes (a job of more than one pass), which the reference
    decodes on its host (its `decode_tile` skips its device decode for
    them)."""
    return frozenset(c for job, (c, _, _) in zip(tj.jobs, tj.slots)
                     if tj.cods[c].cblk_style & 0x40 and job[6] > 1)


def tile_plans(hdr: CodestreamHeader, tr: Rect, tj: TileJobs,
               reduce: int = 0, window_slots=None,
               refined: Optional[frozenset] = None
               ) -> List[fused_decode.FusedDecPlan]:
    """The decode plans of one parsed tile at resolution reduction
    `reduce`: one plan, or one a component group (`_comp_groups`) when
    its components differ in transform, resolution count or block coder.
    A group of HT components with refinement passes (`refined`, by
    default the tile's own `refined_comps`; a batch passes those of
    every stream) gets the host decoders' "t1" plan.
    ROI components reconstruct their MQ lanes at plane 0 where COC
    overrides apply to the tile, as the reference's host decode does
    there (its per-block `_cblk_pmin`); elsewhere the reference's fused
    native decode ignores the shift. `window_slots` makes window plans
    (`fused_decode.build_plan`)."""
    groups = _comp_groups(tj)
    if refined is None:
        refined = refined_comps(tj)
    if groups[0][1] is not None:
        cfg = tile_config(hdr, tr, tj)
        if cfg.mct and cfg.mct_matrix is None and cfg.reversible and any(
                cc.transform != Transform.DWT_53 for cc in tj.cods[:3]):
            raise NotImplementedError(
                "the torch decode does not cover an RCT over components "
                "coded on 9/7 yet")
    pm_zero = tuple(c for c, sh in enumerate(hdr.roishifts or ())
                    if sh) if tj.coc else ()
    plans = []
    for gcod, comps in groups:
        # a reduction past a component's levels leaves its resolution 0,
        # as the reference's inverse does
        max_res = max(0, gcod.numresolutions - 1 - reduce)
        ours = range(len(tj.cods)) if comps is None else comps
        coder = _coder(gcod)
        if coder == "mq" and max(tj.plans[c].bands[k].kmax for c in ours
                                 for k in tj.plans[c].bands) > MQ_MAX_PLANES:
            coder = "t1"
        if coder == "ht" and any(c in refined for c in ours):
            coder = "t1"
        plans.append(fused_decode.build_plan(
            tj.plans, hdr.siz, gcod, tr, coder=coder, max_res=max_res,
            window_slots=window_slots, comps=comps,
            custom_mct=hdr.custom_mct, pm_zero=pm_zero,
            styles=tuple(tj.cods[c].cblk_style for c in ours)))
    return plans


def _check_mesh(plans, devs) -> None:
    """NotImplementedError for host-T1 plans on a mesh of more than one
    shard (the reference's transform-only mesh route)."""
    if len(devs) > 1 and any(plan.coder == "t1" for plan in plans):
        raise NotImplementedError(
            f"the torch decode does not cover MQ code-block styles other "
            f"than the default, MQ bands deeper than {MQ_MAX_PLANES} "
            f"planes, HT refinement passes or HT bands whose Mb + 3 "
            f"exceeds 32 on a mesh of {len(devs)} shards yet (the "
            f"transform-only mesh route)")


def tile_groups(hdr: CodestreamHeader, trs, parsed, reduce: int = 0
                ) -> Dict[fused_decode.FusedDecPlan, List[int]]:
    """Group the tiles that share one decode plan: {plan: [tile, ...]},
    over the tiles that some stream has a tile-part for, each plan
    decoding its resolutions up to a reduction by `reduce`. A tile whose
    components differ in transform, resolution count or block coder is
    listed under each of its component groups' plans (`tile_plans`).

    A plan (`fused_decode.build_plan`) is the tile's geometry: its
    transform config (`pipeline.config_for_tile`, which carries each
    level's origin parity), band shapes and code-block placement. Two
    tiles with equal band shapes but opposite origin parity invert
    differently and so get two plans. A tile's plans come from the first
    stream that has it: the streams share one main header, and their
    tile-part headers must give each tile the same parameters
    (`_same_tile_params`); its HT components go to the host decoders
    where any stream's code-blocks there carry refinement passes."""
    groups: Dict[fused_decode.FusedDecPlan, List[int]] = {}
    for t, tr in enumerate(trs):
        have = [f for f, (_, tiles) in enumerate(parsed) if t in tiles]
        if have:
            refined = frozenset().union(*(refined_comps(parsed[f][0][t])
                                          for f in have))
            for plan in tile_plans(hdr, tr, parsed[have[0]][0][t], reduce,
                                   refined=refined):
                groups.setdefault(plan, []).append(t)
    return groups


def _same_tile_params(parsed) -> bool:
    """Whether every stream of a parsed batch that has a tile parsed it
    with the same coding parameters (their tile-part headers agree)."""
    for t in range(len(parsed[0][0])):
        params = [p[0][t].params for p in parsed if t in p[1]]
        if any(q != params[0] for q in params[1:]):
            return False
    return True


def _finish(hdr: CodestreamHeader, tr: Rect, tj: TileJobs,
            planes: Dict[int, torch.Tensor]) -> List[np.ndarray]:
    """A tile decoded in component groups: its inverse-transformed
    planes by component, on the device (under a mesh its groups may have
    run on different devices: the planes join on component 0's) -> int32
    samples (`pipeline.inv_mct_dc` over the whole tile on the device,
    then one fetch a component)."""
    dev = planes[0].device
    return [a.cpu().numpy() for a in pipeline.inv_mct_dc(
        tile_config(hdr, tr, tj),
        [planes[c].to(dev) for c in range(len(planes))])]


def _canvas(siz: SizInfo, area: Rect, reduce: int) -> List[np.ndarray]:
    """Zero int32 output planes of `area` at resolution reduction
    `reduce`, one per component."""
    return [np.zeros((ceil_div(area.y1, cs.dy << reduce)
                      - ceil_div(area.y0, cs.dy << reduce),
                      ceil_div(area.x1, cs.dx << reduce)
                      - ceil_div(area.x0, cs.dx << reduce)), np.int32)
            for cs in siz.comps]


def _paste(dst: np.ndarray, arr: np.ndarray, ox: int, oy: int, tx0: int,
           ty0: int) -> None:
    """Write the part of `arr` (origin (tx0, ty0) on the output grid)
    that falls inside `dst` (origin (ox, oy))."""
    y_lo = max(0, oy - ty0)
    x_lo = max(0, ox - tx0)
    y_hi = min(arr.shape[0], oy + dst.shape[0] - ty0)
    x_hi = min(arr.shape[1], ox + dst.shape[1] - tx0)
    if y_hi <= y_lo or x_hi <= x_lo:
        return
    dst[ty0 + y_lo - oy:ty0 + y_hi - oy,
        tx0 + x_lo - ox:tx0 + x_hi - ox] = arr[y_lo:y_hi, x_lo:x_hi]


def _image(siz: SizInfo, planes: List[np.ndarray], area: Rect) -> Image:
    return Image(components=[
        Component(data=planes[c], dx=cs.dx, dy=cs.dy, prec=cs.prec,
                  signed=cs.signed) for c, cs in enumerate(siz.comps)],
        x0=area.x0, y0=area.y0, xsiz=area.x1, ysiz=area.y1)


def decode_batch(datas: List[bytes],
                 params: Optional[DecoderParams] = None,
                 device: DeviceLike = "cuda",
                 chunk: int = 32,
                 mesh: Optional[Sequence[DeviceLike]] = None) -> List[Image]:
    """Decode many same-geometry codestreams or JP2 files (a serving
    batch), coded with the HT block coder or the Part-1 MQ coder (the
    default code-block style on the MQ decoder kernel, the others on the
    host Tier-1 decoder), on the reversible 5/3 or the irreversible
    9/7 path, all quality layers or the first `params.layers`, at a
    resolution reduction `params.reduce`, of one tile
    (`params.tile_index`) or all; with COC / QCC overrides, a POC or
    packed packet headers where every stream has the same
    (`_out_of_slice`). A window (`params.window`) decodes stream by
    stream through `decode`, as the reference's `decode_batch` does.

    T2 of every stream runs on a host thread pool; then the tiles of one
    decode plan are decoded `chunk` at a time, each chunk one host pass
    (the HT prepass or the MQ lane packing), one upload and one fused
    device decode (`models/fused_decode.py`), which decodes and inverts
    only the resolutions kept. Every chunk is submitted before any is
    collected. Frames may include different code-blocks of a tile: each
    job goes to its code-block's lane. Decode mirror of
    `encoder.encode_batch`.

    `mesh` (a sequence of devices, one shard each; it replaces `device`)
    sends each plan's (frame, tile) instances round-robin over the mesh,
    as the reference's `_mesh_fused_decode` sends its tiles, each shard
    decoded `chunk` at a time on its device; the pixels equal the
    one-device decode's."""
    devs = resolve_mesh(mesh, device)
    params = params or DecoderParams()
    if not datas:
        return []
    if params.window is not None:
        return [decode(d, params, mesh=devs) for d in datas]
    hdr, trs, parsed = parse_batch(datas, params)
    siz = hdr.siz
    req = _request(siz, hdr.cod, trs, params)
    if not _same_tile_params(parsed):
        return [decode_batch([d], params, chunk=chunk, mesh=devs)[0]
                for d in datas]
    groups = tile_groups(hdr, trs, parsed, req.reduce)
    _check_mesh(groups, devs)

    submits = []  # (plan, handle, [(frame, tile), ...])
    step = max(1, chunk)
    for plan, tlist in groups.items():
        instances = [(f, t) for t in tlist for f in range(len(datas))
                     if t in parsed[f][1]]
        shards = [(fused_decode.decoder_for(plan, d),
                   instances[di::len(devs)]) for di, d in enumerate(devs)]
        for k in range(0, -(-len(instances) // len(devs)), step):
            for decoder, shard in shards:
                part = shard[k:k + step]
                if not part:
                    continue
                submits.append((plan, fused_decode.decode_tiles_submit(
                    decoder, [fused_decode.jobs_by_block(
                        *parsed[f][0][t][:3], max_res=plan.max_res,
                        comps=plan.comps) for (f, t) in part]), part))

    r = req.reduce
    comps_out = [_canvas(siz, req.area, r) for _ in datas]

    def paste(f, t, c, arr):
        cs = siz.comps[c]
        tc = parsed[f][0][t][2][c].layout.tc_rect
        _paste(comps_out[f][c], arr, ceil_div(req.area.x0, cs.dx << r),
               ceil_div(req.area.y0, cs.dy << r), ceil_div(tc.x0, 1 << r),
               ceil_div(tc.y0, 1 << r))

    # a tile decoded in component groups keeps its groups' planes on the
    # device until `_finish`
    grouped: Dict[tuple, Dict[int, torch.Tensor]] = {}
    for plan, handle, part in submits:
        if plan.comps is None:
            outs = fused_decode.decode_tiles_collect(handle)
            for (f, t), comps in zip(part, outs):
                for c, arr in enumerate(comps):
                    paste(f, t, c, arr)
        else:
            for i, ft in enumerate(part):
                grouped.setdefault(ft, {}).update(
                    (c, a[i]) for c, a in zip(plan.comps, handle))
    for (f, t), planes in grouped.items():
        for c, arr in enumerate(_finish(hdr, trs[t], parsed[f][0][t],
                                        planes)):
            paste(f, t, c, arr)
    return [_image(siz, planes, req.area) for planes in comps_out]


def decode(data: bytes, params: Optional[DecoderParams] = None,
           device: DeviceLike = "cuda",
           mesh: Optional[Sequence[DeviceLike]] = None) -> Image:
    """Decode one codestream or JP2 file: the whole image, a window
    (`params.window`, canvas coords), a reduced resolution
    (`params.reduce`), one tile (`params.tile_index`, the output cropped
    to the tile) and the first `params.layers` quality layers, in any
    combination; pixel-identical to the reference's `decode` with the
    same parameters. The slice is `decode_batch`'s.

    Without a window this is `decode_batch` of one stream. With one,
    only the tiles that meet the window are parsed (the others'
    tile-parts are skipped unread), each tile gets a window plan of the
    code-blocks that can influence the window (`tile.decode_tile(
    window=)`, `fused_decode.build_plan(window_slots=)`), whose decoder
    returns their dequantized per-band bounding boxes; the host fetches
    them and runs the windowed inverse DWT (`ops/dwt_window.py`), then
    the inverse MCT and the DC shift, as the reference does.

    `mesh` (a sequence of devices; it replaces `device`) sends the tiles
    round-robin over it: `decode_batch(mesh=)` without a window, and with
    one, the i-th tile that meets the window to mesh[i % len(mesh)]. A
    failure on any device raises; the pixels equal the one-device
    decode's."""
    devs = resolve_mesh(mesh, device)
    params = params or DecoderParams()
    if params.window is None:
        return decode_batch([data], params, mesh=devs)[0]
    (data,), (hdr,) = _headers([data])
    siz, cod = hdr.siz, hdr.cod
    trs = _tile_rects(siz)
    req = _request(siz, cod, trs, params)
    parsed, have = _parse_frame(data, hdr, trs, params.layers, req.tiles,
                                req.window)
    todo = {t: tile_plans(hdr, trs[t], parsed[t], req.reduce,
                          window_slots=parsed[t][1])
            for t in sorted(have) if not trs[t].clip(req.window).is_empty()}
    _check_mesh([p for plans in todo.values() for p in plans], devs)
    submits = []  # (tile, [(plan, handle)])
    for t, plans in todo.items():
        jobs, slots, tplans = parsed[t][:3]
        dev = devs[len(submits) % len(devs)]
        submits.append((t, [(plan, fused_decode.decode_tiles_submit(
            fused_decode.decoder_for(plan, dev),
            [fused_decode.jobs_by_block(jobs, slots, tplans,
                                        max_res=plan.max_res,
                                        comps=plan.comps)]))
            for plan in plans]))

    r = req.reduce
    planes = _canvas(siz, req.area, r)
    for t, tile_submits in submits:
        comps = [None] * len(siz.comps)
        origins = [None] * len(siz.comps)
        for plan, handle in tile_submits:
            [[flat]] = fused_decode.decode_tiles_collect(handle)
            boxes = fused_decode.window_boxes(plan, flat)
            cfg = plan.cfg
            for i, c in enumerate(fused_decode.plan_comps(plan)):
                cs = siz.comps[c]
                a, wx0, wy0 = dwt_window.inv_dwt_2d_window(
                    _box_fetch(boxes[i], np.int32 if cfg.reversible
                               else np.float32),
                    parsed[t][2][c].layout.tc_rect, cfg.numresolutions,
                    component_rect(req.window, cs.dx, cs.dy),
                    reversible=cfg.reversible,
                    max_res=max(0, cfg.numresolutions - 1 - r))
                comps[c] = torch.from_numpy(a)
                origins[c] = (wx0, wy0)
        samples = pipeline.inv_mct_dc(tile_config(hdr, trs[t], parsed[t]),
                                      comps)
        for c, cs in enumerate(siz.comps):
            _paste(planes[c], samples[c].numpy(),
                   ceil_div(req.area.x0, cs.dx << r),
                   ceil_div(req.area.y0, cs.dy << r), *origins[c])
    return _image(siz, planes, req.area)


def _box_fetch(boxes, dtype):
    """The reference's `fetch` over a banded bounding-box store
    (reference `codestream/tile.py`, windowed decode): band-local
    rectangle [bx0, bx1) x [by0, by1) of band (r, o), zero outside the
    band's box of decoded coefficients."""
    def fetch(r, o, bx0, by0, bx1, by1):
        oy, ox, arr = boxes[(r, o)]
        out_a = np.zeros((by1 - by0, bx1 - bx0), dtype=dtype)
        if arr.size == 0:
            return out_a
        sx0 = max(bx0, ox)
        sy0 = max(by0, oy)
        sx1 = min(bx1, ox + arr.shape[1])
        sy1 = min(by1, oy + arr.shape[0])
        if sx1 > sx0 and sy1 > sy0:
            out_a[sy0 - by0:sy1 - by0, sx0 - bx0:sx1 - bx0] = \
                arr[sy0 - oy:sy1 - oy, sx0 - ox:sx1 - ox]
        return out_a
    return fetch
