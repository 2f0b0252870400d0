"""Decode entry points on a torch device.

Port of `grokimagecompression_tpu/codestream/decoder.py` for the HT and
Part-1 MQ (default code-block style) slices, 5/3 or 9/7. The
main-header and tile-part walk (`CodestreamHeader`, `TilePart`,
`_validate_siz`, `read_header`, `iter_tile_parts`) is copied from the
reference. `decode_batch` is the port of the reference's fused
`decode_batch` and `decode` of its per-image `decode`: host T2 (the
port's native T2, or its Python T2 where packed packet headers are),
then the fused device decode of `models/fused_decode.py`, whose block
decoders and inverse transforms run on the device. Both take raw
codestreams and JP2 files, single- or multi-tile, with COC overrides
that keep the COD's transform, resolution count and code-block style,
QCC, POC, and packed packet headers (PPM, PPT), and the reference's
requests: a layer limit, a reduced resolution, a single tile and a
window, alone or combined. A window's code-blocks are decoded and
dequantized on the device and inverted on the host by the copy of the
reference's windowed inverse (`ops/dwt_window.py`), as the reference
does.

Requests that the reference sends to its host decode (tile-part header
overrides, ROI, a custom MCT, non-default MQ styles, HT refinement)
raise NotImplementedError instead of falling back to a host decode.
"""

from __future__ import annotations

import concurrent.futures
import dataclasses
import os
import struct
from typing import Dict, List, Optional

import numpy as np

import torch

from ..core.geometry import (Rect, ceil_div, component_rect,
                             tile_grid_size, tile_rect)
from ..core.image import Component, Image
from ..core.params import DecoderParams, Transform
from ..models import fused_decode, pipeline
from ..ops import dwt_window
from ..utils.device import DeviceLike, resolve_device
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
    overrides, the POC and whether the stream has packed headers (PPM)."""
    return (h.siz, h.cod, h.qcd, h.cod_comp, h.qcd_comp, h.pocs,
            h.ppm_sections is not None)


def _out_of_slice(hdrs: List[CodestreamHeader]) -> Optional[str]:
    """Why a batch of parsed headers is outside the ported slice, or
    None: the reference's `decode_batch` gate, which sends the same
    streams to its device decode."""
    h0 = hdrs[0]
    if any(batch_key(h)[:3] != batch_key(h0)[:3] for h in hdrs[1:]):
        return "streams of different coding parameters"
    siz, cod = h0.siz, h0.cod
    if not cod.cblk_style & 0x40 and cod.cblk_style != 0:
        return ("an MQ code-block style other than the default (bypass, "
                "RESET, TERMALL, VSC, PTERM or SEGMARK)")
    if cod.mct not in (0, 1) or any(h.custom_mct is not None for h in hdrs):
        return "a custom MCT"
    if any(h.roishifts and any(h.roishifts) for h in hdrs):
        return "ROI shifts"
    if cod.mct and len(siz.comps) >= 3 and any(
            (c.dx, c.dy) != (siz.comps[0].dx, siz.comps[0].dy)
            for c in siz.comps[:3]):
        return "an MCT over differently sampled components"
    if any(batch_key(h)[3:] != batch_key(h0)[3:] for h in hdrs[1:]):
        return ("streams of different COC / QCC overrides, POCs or packed "
                "headers (PPM)")
    if h0.cod_comp and any(
            cc and (cc.transform != cod.transform
                    or cc.numresolutions != cod.numresolutions
                    or cc.cblk_style != cod.cblk_style)
            for cc in h0.cod_comp):
        return ("a COC that changes the transform, the resolution count or "
                "the code-block style")
    return None


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
    ppm_iter = iter(hdr.ppm_sections or [])
    for tp in iter_tile_parts(data, hdr.main_header_end,
                              want=None if tiles is None
                              else tiles.__contains__):
        if tp.skipped:
            if hdr.ppm_sections is not None:
                next(ppm_iter, b"")
            continue
        if tp.cod or tp.qcd or tp.coc_raw or tp.qcc_raw or tp.poc_raw:
            raise NotImplementedError(
                "the torch decode does not cover tile-part header "
                "overrides yet")
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
        r = decode_tile(b"".join(tile_bodies.get(t, [])), hdr.siz, hdr.cod,
                        hdr.qcd, tr, max_layers=layers, window=window,
                        cod_comp=hdr.cod_comp, qcd_comp=hdr.qcd_comp,
                        pocs=hdr.pocs, packed_headers=packed)
        if hdr.cod.cblk_style & 0x40 and any(job[6] > 1 for job in r[0]):
            raise NotImplementedError(
                "the torch decode does not cover HT refinement passes yet")
        out.append(r)
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


def tile_groups(hdr: CodestreamHeader, trs, parsed,
                max_res: Optional[int] = None
                ) -> Dict[fused_decode.FusedDecPlan, List[int]]:
    """Group the tiles that share one decode plan: {plan: [tile, ...]},
    over the tiles that some stream has a tile-part for, each plan
    decoding resolutions 0..`max_res` (all when None).

    A plan (`fused_decode.build_plan`) is the tile's geometry: its
    transform config (`pipeline.config_for_tile`, which carries each
    level's origin parity), band shapes and code-block placement. Two
    tiles with equal band shapes but opposite origin parity invert
    differently and so get two plans. The streams share one header, so
    any stream's component plans of a tile stand for all of them."""
    coder = "ht" if hdr.cod.cblk_style & 0x40 else "mq"
    groups: Dict[fused_decode.FusedDecPlan, List[int]] = {}
    for t, tr in enumerate(trs):
        if not any(t in tiles for _, tiles in parsed):
            continue
        plan = fused_decode.build_plan(parsed[0][0][t][2], hdr.siz,
                                       hdr.cod, tr, coder=coder,
                                       max_res=max_res)
        groups.setdefault(plan, []).append(t)
    return groups


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
                 chunk: int = 32) -> List[Image]:
    """Decode many same-geometry codestreams or JP2 files (a serving
    batch), coded with the HT block coder or the Part-1 MQ coder in the
    default code-block style, on the reversible 5/3 or the irreversible
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
    `encoder.encode_batch`."""
    dev = resolve_device(device)
    params = params or DecoderParams()
    if not datas:
        return []
    if params.window is not None:
        return [decode(d, params, dev) for d in datas]
    hdr, trs, parsed = parse_batch(datas, params)
    siz = hdr.siz
    req = _request(siz, hdr.cod, trs, params)
    max_res = hdr.cod.numresolutions - 1 - req.reduce

    submits = []  # (handle, [(frame, tile), ...])
    for plan, tlist in tile_groups(hdr, trs, parsed, max_res).items():
        decoder = fused_decode.decoder_for(plan, dev)
        instances = [(f, t) for t in tlist for f in range(len(datas))
                     if t in parsed[f][1]]
        for k in range(0, len(instances), max(1, chunk)):
            part = instances[k:k + max(1, chunk)]
            submits.append((fused_decode.decode_tiles_submit(decoder, [
                fused_decode.jobs_by_block(*parsed[f][0][t][:3],
                                           max_res=plan.max_res)
                for (f, t) in part]), part))

    r = req.reduce
    comps_out = [_canvas(siz, req.area, r) for _ in datas]
    for handle, part in submits:
        outs = fused_decode.decode_tiles_collect(handle)
        for (f, t), comps in zip(part, outs):
            for c, arr in enumerate(comps):
                cs = siz.comps[c]
                tc = parsed[f][0][t][2][c].layout.tc_rect
                _paste(comps_out[f][c], arr,
                       ceil_div(req.area.x0, cs.dx << r),
                       ceil_div(req.area.y0, cs.dy << r),
                       ceil_div(tc.x0, 1 << r), ceil_div(tc.y0, 1 << r))
    return [_image(siz, planes, req.area) for planes in comps_out]


def decode(data: bytes, params: Optional[DecoderParams] = None,
           device: DeviceLike = "cuda") -> Image:
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
    the inverse MCT and the DC shift, as the reference does."""
    dev = resolve_device(device)
    params = params or DecoderParams()
    if params.window is None:
        return decode_batch([data], params, dev)[0]
    (data,), (hdr,) = _headers([data])
    siz, cod = hdr.siz, hdr.cod
    trs = _tile_rects(siz)
    req = _request(siz, cod, trs, params)
    parsed, have = _parse_frame(data, hdr, trs, params.layers, req.tiles,
                                req.window)
    max_res = cod.numresolutions - 1 - req.reduce
    coder = "ht" if cod.cblk_style & 0x40 else "mq"
    submits = []  # (tile, plan, handle)
    for t in sorted(have):
        if trs[t].clip(req.window).is_empty():
            continue
        jobs, slots, plans, _ = parsed[t]
        plan = fused_decode.build_plan(plans, siz, cod, trs[t], coder=coder,
                                       max_res=max_res, window_slots=slots)
        submits.append((t, plan, fused_decode.decode_tiles_submit(
            fused_decode.decoder_for(plan, dev),
            [fused_decode.jobs_by_block(jobs, slots, plans,
                                        max_res=plan.max_res)])))

    r = req.reduce
    reversible = cod.transform == Transform.DWT_53
    dtype = np.int32 if reversible else np.float32
    planes = _canvas(siz, req.area, r)
    for t, plan, handle in submits:
        [[flat]] = fused_decode.decode_tiles_collect(handle)
        boxes = fused_decode.window_boxes(plan, flat)
        comps, origins = [], []
        for c, cs in enumerate(siz.comps):
            a, wx0, wy0 = dwt_window.inv_dwt_2d_window(
                _box_fetch(boxes[c], dtype), parsed[t][2][c].layout.tc_rect,
                cod.numresolutions,
                component_rect(req.window, cs.dx, cs.dy),
                reversible=reversible, max_res=max_res)
            comps.append(torch.from_numpy(a))
            origins.append((wx0, wy0))
        samples = pipeline.inv_mct_dc(plan.cfg, comps)
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
