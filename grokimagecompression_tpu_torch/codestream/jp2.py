"""JP2 container (ISO/IEC 15444-1 Annex I): box read/write around the raw
J2K codestream.

Analog of the reference container layer (reference:
src/lib/jp2/codestream/jp2.cpp box handler tables jp2.cpp:433-453,
jp2_read_header:2970, jp2_encode:2389). Boxes supported this round:
jP (signature), ftyp, jp2h { ihdr, bpcc, colr }, jp2c; unknown boxes are
skipped by length on read.

A copy of `grokimagecompression_tpu/codestream/jp2.py` (standard library
and numpy only): `decoder.parse_batch` unwraps JP2 files with
`is_jp2` / `extract_codestream`, as the reference's `decode_batch` does.
"""

from __future__ import annotations

import dataclasses
import struct
from typing import List, Optional, Tuple

JP2_SIGNATURE = b"\x00\x00\x00\x0cjP  \r\n\x87\n"

# Box types
T_FTYP = b"ftyp"
T_JP2H = b"jp2h"
T_IHDR = b"ihdr"
T_CDEF = b"cdef"
T_PCLR = b"pclr"
T_CMAP = b"cmap"
T_BPCC = b"bpcc"
T_COLR = b"colr"
T_JP2C = b"jp2c"
T_RES = b"res "
T_RESC = b"resc"
T_RESD = b"resd"
T_XML = b"xml "
T_UUID = b"uuid"

# colr enumerated colourspaces (I.5.3.3)
CS_SRGB = 16
CS_GREYSCALE = 17
CS_SYCC = 18
CS_CIELAB = 14


@dataclasses.dataclass
class JP2Header:
    width: int
    height: int
    numcomps: int
    bpc: int                      # ihdr BPC field (prec-1 | sign<<7), 255=varies
    bpc_per_comp: Optional[List[int]]  # from bpcc when bpc == 255
    colourspace: Optional[int]
    icc_profile: Optional[bytes]
    capture_resolution: Optional[Tuple[float, float]] = None  # px/m (x, y)
    display_resolution: Optional[Tuple[float, float]] = None
    xml: List[bytes] = dataclasses.field(default_factory=list)
    uuids: List[Tuple[bytes, bytes]] = dataclasses.field(
        default_factory=list)  # (16-byte id, payload)
    # cdef channel definitions: (channel, type, association); type 1 =
    # opacity (reference: jp2.cpp jp2_read_cdef:190).
    channel_defs: Optional[List[Tuple[int, int, int]]] = None
    # CIELab EP parameters from the colr box (enumcs 14): (variant, rL,
    # oL, ra, oa, rb, ob, illuminant) — absent fields default per the
    # standard Lab space (reference: color.cpp color_cielab_to_rgb:716).
    cielab: Optional[Tuple[int, ...]] = None
    # Palette (pclr) and component mapping (cmap) boxes (reference:
    # jp2.cpp jp2_read_pclr/jp2_read_cmap/jp2_apply_pclr:307):
    # palette: (entries int32[NE, NPC], depths, signs); cmap rows
    # (cmp, mtyp, pcol).
    palette: Optional[tuple] = None
    cmap: Optional[List[Tuple[int, int, int]]] = None


def _box(btype: bytes, payload: bytes) -> bytes:
    return struct.pack(">I", 8 + len(payload)) + btype + payload


def _find_cf(x: float) -> Tuple[int, int]:
    """Rationalize x as num/den with 16-bit terms via continued
    fractions (reference: jp2.cpp find_cf)."""
    import math
    eps = 1.0 / 65535.0
    p = [0, 1]
    q = [1, 0]
    for _ in range(2, 15):
        a = math.floor(x)
        pn = int(a) * p[-1] + p[-2]
        qn = int(a) * q[-1] + q[-2]
        if pn > 65535 or qn > 65535:
            break
        p.append(pn)
        q.append(qn)
        if abs(x - a) < eps:
            break
        x = 1.0 / (x - a)
    return p[-1], max(1, q[-1])


def _res_sub_box(btype: bytes, resx: float, resy: float) -> bytes:
    """resc/resd sub-box: VRnum VRden HRnum HRden VRexp HRexp, value =
    num/den * 10^exp in pixels/metre (reference: jp2_write_res_box)."""
    payload = b""
    for v in (resy, resx):
        num, den = _find_cf(v)
        payload += struct.pack(">HH", num, den)
    payload += struct.pack(">BB", 0, 0)  # exponents
    return _box(btype, payload)


def _parse_res_sub(p: bytes) -> Tuple[float, float]:
    vrn, vrd, hrn, hrd, vre, hre = struct.unpack(">HHHHbb", p[:10])
    ry = (vrn / max(1, vrd)) * (10.0 ** vre)
    rx = (hrn / max(1, hrd)) * (10.0 ** hre)
    return rx, ry


def wrap_codestream(codestream: bytes, width: int, height: int,
                    comps: List[Tuple[int, bool]],
                    colourspace: Optional[int] = None,
                    capture_resolution=None, display_resolution=None,
                    xml: Optional[bytes] = None,
                    icc_profile: Optional[bytes] = None,
                    channel_defs=None) -> bytes:
    """Wrap a raw J2K codestream in a JP2 file.

    `comps` is [(prec, signed), ...]; colourspace defaults to sRGB for 3+
    components, greyscale otherwise.
    """
    if colourspace is None:
        colourspace = CS_SRGB if len(comps) >= 3 else CS_GREYSCALE
    same = all(c == comps[0] for c in comps)
    if same:
        prec, signed = comps[0]
        bpc = (prec - 1) | (0x80 if signed else 0)
    else:
        bpc = 255
    ihdr = struct.pack(">IIHBBBB", height, width, len(comps), bpc,
                       7,  # compression type: jp2c codestream
                       0,  # colourspace unknown flag
                       0)  # no intellectual property
    jp2h = _box(T_IHDR, ihdr)
    if not same:
        jp2h += _box(T_BPCC, bytes((p - 1) | (0x80 if s else 0)
                                   for (p, s) in comps))
    if icc_profile:
        # meth=2: restricted ICC profile
        jp2h += _box(T_COLR, struct.pack(">BBB", 2, 0, 0) + icc_profile)
    else:
        jp2h += _box(T_COLR, struct.pack(">BBBI", 1, 0, 0, colourspace))
    if channel_defs:
        # cdef: (channel, type, association) triplets — type 1 marks
        # opacity (reference: jp2.cpp jp2_write_cdef:1026).
        payload = struct.pack(">H", len(channel_defs))
        for (cn, typ, asoc) in channel_defs:
            payload += struct.pack(">HHH", cn, typ, asoc)
        jp2h += _box(T_CDEF, payload)
    if capture_resolution or display_resolution:
        res = b""
        if capture_resolution:
            res += _res_sub_box(T_RESC, *capture_resolution)
        if display_resolution:
            res += _res_sub_box(T_RESD, *display_resolution)
        jp2h += _box(T_RES, res)
    out = bytearray()
    out += JP2_SIGNATURE
    out += _box(T_FTYP, b"jp2 " + struct.pack(">I", 0) + b"jp2 ")
    out += _box(T_JP2H, jp2h)
    if xml:
        out += _box(T_XML, xml)
    out += _box(T_JP2C, codestream)
    return bytes(out)


def _iter_boxes(data: bytes, pos: int, end: int):
    while pos + 8 <= end:
        length = struct.unpack(">I", data[pos:pos + 4])[0]
        btype = data[pos + 4:pos + 8]
        payload_start = pos + 8
        if length == 1:  # extended length
            if pos + 16 > end:
                return
            length = struct.unpack(">Q", data[pos + 8:pos + 16])[0]
            payload_start = pos + 16
        if length == 0:  # box runs to end of file
            yield btype, payload_start, end
            return
        box_end = pos + length
        if box_end > end:
            box_end = end
        yield btype, payload_start, box_end
        pos += length


def is_jp2(data: bytes) -> bool:
    return data[:12] == JP2_SIGNATURE


def read_jp2(data: bytes) -> Tuple[JP2Header, bytes]:
    """Parse a JP2 file: returns (header info, raw codestream bytes)."""
    if not is_jp2(data):
        raise ValueError("not a JP2 file (bad signature box)")
    hdr: Optional[JP2Header] = None
    codestream: Optional[bytes] = None
    xml_boxes: List[bytes] = []
    uuids: List[Tuple[bytes, bytes]] = []
    for btype, start, end in _iter_boxes(data, 12, len(data)):
        if btype == T_XML:
            xml_boxes.append(data[start:end])
        elif btype == T_UUID and end - start >= 16:
            uuids.append((data[start:start + 16], data[start + 16:end]))
        elif btype == T_JP2H:
            width = height = numcomps = bpc = 0
            bpcc = None
            colourspace = None
            icc = None
            capture_res = display_res = None
            cdefs = None
            cielab_p = None
            pclr = None
            cmap_rows = None
            for ib, istart, iend in _iter_boxes(data, start, end):
                p = data[istart:iend]
                if ib == T_IHDR and len(p) >= 14:
                    height, width, numcomps, bpc = struct.unpack(
                        ">IIHB", p[:11])
                elif ib == T_BPCC:
                    bpcc = list(p)
                elif ib == T_COLR and len(p) >= 3:
                    meth = p[0]
                    if meth == 1 and len(p) >= 7:
                        colourspace = struct.unpack(">I", p[3:7])[0]
                        if colourspace == CS_CIELAB and len(p) >= 11:
                            rest = p[7:]
                            vals = [struct.unpack(
                                ">I", rest[k:k + 4])[0]
                                for k in range(0, len(rest) - 3, 4)]
                            cielab_p = tuple(vals)
                    elif meth == 2:
                        icc = bytes(p[3:])
                elif ib == T_PCLR and len(p) >= 3:
                    import numpy as _np
                    ne = struct.unpack(">H", p[:2])[0]
                    npc = p[2]
                    depths = [(p[3 + k] & 0x7F) + 1 for k in range(npc)]
                    signs = [bool(p[3 + k] & 0x80) for k in range(npc)]
                    pos2 = 3 + npc
                    ent = _np.zeros((ne, npc), _np.int32)
                    ok = True
                    for e in range(ne):
                        for k in range(npc):
                            nb = (depths[k] + 7) // 8
                            if pos2 + nb > len(p):
                                ok = False
                                break
                            v = int.from_bytes(p[pos2:pos2 + nb], "big")
                            if signs[k] and v >= (1 << (depths[k] - 1)):
                                v -= 1 << depths[k]
                            ent[e, k] = v
                            pos2 += nb
                        if not ok:
                            break
                    if ok:
                        pclr = (ent, depths, signs)
                elif ib == T_CMAP and len(p) >= 4:
                    cmap_rows = []
                    for k in range(len(p) // 4):
                        cmp_, mtyp, pcol = struct.unpack(
                            ">HBB", p[k * 4:k * 4 + 4])
                        cmap_rows.append((cmp_, mtyp, pcol))
                elif ib == T_CDEF and len(p) >= 2:
                    ncd = struct.unpack(">H", p[:2])[0]
                    cdefs = []
                    for k in range(ncd):
                        off = 2 + k * 6
                        if off + 6 > len(p):
                            break
                        cdefs.append(struct.unpack(">HHH",
                                                   p[off:off + 6]))
                elif ib == T_RES:
                    for rb, rstart, rend in _iter_boxes(data, istart, iend):
                        rp = data[rstart:rend]
                        if len(rp) >= 10 and rb in (T_RESC, T_RESD):
                            val = _parse_res_sub(rp)
                            if rb == T_RESC:
                                capture_res = val
                            else:
                                display_res = val
            hdr = JP2Header(width=width, height=height, numcomps=numcomps,
                            bpc=bpc, bpc_per_comp=bpcc,
                            colourspace=colourspace, icc_profile=icc,
                            capture_resolution=capture_res,
                            display_resolution=display_res,
                            channel_defs=cdefs, cielab=cielab_p,
                            palette=pclr, cmap=cmap_rows)
        elif btype == T_JP2C:
            codestream = data[start:end]
            break
    if codestream is None:
        raise ValueError("JP2 file has no jp2c codestream box")
    if hdr is None:
        raise ValueError("JP2 file has no jp2h header box")
    hdr.xml = xml_boxes
    hdr.uuids = uuids
    return hdr, codestream


def apply_palette(image, hdr):
    """Expand pclr/cmap channels (reference: jp2_apply_pclr:307):
    mtyp 0 copies the source component, mtyp 1 looks indices up in the
    palette column `pcol` (indices clamped to the entry count)."""
    import dataclasses

    import numpy as np

    if hdr.palette is None:
        return image
    entries, depths, signs = hdr.palette
    cmap = hdr.cmap
    if cmap is None:
        # Default identity mapping: channel k <- comp 0 via column k.
        cmap = [(0, 1, k) for k in range(entries.shape[1])]
    comps = []
    for i, (cmp_, mtyp, pcol) in enumerate(cmap):
        if cmp_ >= len(image.components):
            return image
        src = image.components[cmp_]
        if mtyp == 0:
            comps.append(src)
            continue
        if pcol >= entries.shape[1]:
            return image
        idx = np.clip(src.data, 0, entries.shape[0] - 1)
        comps.append(dataclasses.replace(
            src, data=entries[idx, pcol].astype(np.int32),
            prec=depths[pcol], signed=signs[pcol]))
    return dataclasses.replace(image, components=comps)


def extract_codestream(data: bytes) -> bytes:
    return read_jp2(data)[1]
