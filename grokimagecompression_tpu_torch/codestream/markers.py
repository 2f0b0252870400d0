"""J2K codestream marker segments (ISO/IEC 15444-1 Annex A).

Writer/parser for the main- and tile-header markers. Analog of the marker
handler table in the reference state machine (reference:
src/lib/jp2/codestream/j2k.cpp:87-108, marker constants j2k.h:103-129),
restructured as pure functions over immutable info records.
"""

from __future__ import annotations

import dataclasses
import struct
from typing import List, Optional, Tuple

from ..core.params import Progression, QuantStyle, Transform

# Marker codes (Table A.2).
SOC = 0xFF4F
SIZ = 0xFF51
COD = 0xFF52
COC = 0xFF53
TLM = 0xFF55
PLM = 0xFF57
PLT = 0xFF58
QCD = 0xFF5C
QCC = 0xFF5D
RGN = 0xFF5E
POC = 0xFF5F
PPM = 0xFF60
PPT = 0xFF61
CRG = 0xFF63
COM = 0xFF64
CBD = 0xFF78
CAP = 0xFF50
SOT = 0xFF90
SOP = 0xFF91
EPH = 0xFF92
SOD = 0xFF93
EOC = 0xFFD9


@dataclasses.dataclass
class ComponentSiz:
    prec: int
    signed: bool
    dx: int
    dy: int


@dataclasses.dataclass
class SizInfo:
    xsiz: int
    ysiz: int
    xosiz: int
    yosiz: int
    xtsiz: int
    ytsiz: int
    xtosiz: int
    ytosiz: int
    comps: List[ComponentSiz]
    rsiz: int = 0


@dataclasses.dataclass
class CodInfo:
    """COD/COC contents."""

    progression: Progression = Progression.LRCP
    numlayers: int = 1
    mct: int = 0
    numresolutions: int = 6
    cblk_w_exp: int = 6   # actual exponent (codestream stores exp-2)
    cblk_h_exp: int = 6
    cblk_style: int = 0
    transform: Transform = Transform.DWT_53
    # Per-resolution (PPx, PPy), r = 0..NL; None = defaults (15,15).
    precincts: Optional[Tuple[Tuple[int, int], ...]] = None
    sop: bool = False
    eph: bool = False


@dataclasses.dataclass
class QcdInfo:
    style: QuantStyle = QuantStyle.NONE
    num_guard_bits: int = 2
    # style NONE: per-band exponents; SCALAR_*: (expn, mant) pairs.
    exponents: Tuple[int, ...] = ()
    steps: Tuple[Tuple[int, int], ...] = ()


@dataclasses.dataclass
class SotInfo:
    tile_index: int
    psot: int
    tpsot: int = 0
    tnsot: int = 1


def _seg(marker: int, payload: bytes) -> bytes:
    return struct.pack(">HH", marker, len(payload) + 2) + payload


def write_soc() -> bytes:
    return struct.pack(">H", SOC)


def write_siz(s: SizInfo) -> bytes:
    payload = struct.pack(
        ">HIIIIIIIIH",
        s.rsiz, s.xsiz, s.ysiz, s.xosiz, s.yosiz,
        s.xtsiz, s.ytsiz, s.xtosiz, s.ytosiz, len(s.comps),
    )
    for c in s.comps:
        ssiz = (c.prec - 1) | (0x80 if c.signed else 0)
        payload += struct.pack(">BBB", ssiz, c.dx, c.dy)
    return _seg(SIZ, payload)


def parse_siz(payload: bytes) -> SizInfo:
    (rsiz, xsiz, ysiz, xosiz, yosiz, xtsiz, ytsiz, xtosiz, ytosiz,
     ncomp) = struct.unpack(">HIIIIIIIIH", payload[:36])
    comps = []
    off = 36
    for _ in range(ncomp):
        ssiz, dx, dy = struct.unpack(">BBB", payload[off:off + 3])
        comps.append(ComponentSiz(prec=(ssiz & 0x7F) + 1,
                                  signed=bool(ssiz & 0x80), dx=dx, dy=dy))
        off += 3
    return SizInfo(xsiz, ysiz, xosiz, yosiz, xtsiz, ytsiz, xtosiz, ytosiz,
                   comps, rsiz)


def _spcod_tail(c: CodInfo) -> bytes:
    out = struct.pack(
        ">BBBBB",
        c.numresolutions - 1,
        c.cblk_w_exp - 2,
        c.cblk_h_exp - 2,
        c.cblk_style,
        int(c.transform),
    )
    if c.precincts is not None:
        for (ppx, ppy) in c.precincts:
            out += struct.pack(">B", (ppy << 4) | ppx)
    return out


def write_cod(c: CodInfo) -> bytes:
    scod = 0
    if c.precincts is not None:
        scod |= 0x01
    if c.sop:
        scod |= 0x02
    if c.eph:
        scod |= 0x04
    payload = struct.pack(">BBHB", scod, int(c.progression), c.numlayers,
                          c.mct)
    payload += _spcod_tail(c)
    return _seg(COD, payload)


def parse_cod(payload: bytes) -> CodInfo:
    scod, prog, layers, mct = struct.unpack(">BBHB", payload[:5])
    nl, cbw, cbh, cbsty, tr = struct.unpack(">BBBBB", payload[5:10])
    numres = nl + 1
    precincts = None
    if scod & 0x01:
        precincts = []
        for i in range(numres):
            b = payload[10 + i]
            precincts.append((b & 0x0F, b >> 4))
        precincts = tuple(precincts)
    return CodInfo(
        progression=Progression(prog),
        numlayers=layers,
        mct=mct,
        numresolutions=numres,
        cblk_w_exp=cbw + 2,
        cblk_h_exp=cbh + 2,
        cblk_style=cbsty,
        transform=Transform(tr),
        precincts=precincts,
        sop=bool(scod & 0x02),
        eph=bool(scod & 0x04),
    )


def write_qcd(q: QcdInfo) -> bytes:
    sqcd = int(q.style) | (q.num_guard_bits << 5)
    payload = struct.pack(">B", sqcd)
    if q.style == QuantStyle.NONE:
        for e in q.exponents:
            payload += struct.pack(">B", e << 3)
    else:
        for (expn, mant) in q.steps:
            payload += struct.pack(">H", (expn << 11) | mant)
    return _seg(QCD, payload)


def parse_qcd(payload: bytes) -> QcdInfo:
    sqcd = payload[0]
    style = QuantStyle(sqcd & 0x1F)
    guard = sqcd >> 5
    exponents: List[int] = []
    steps: List[Tuple[int, int]] = []
    body = payload[1:]
    if style == QuantStyle.NONE:
        exponents = [b >> 3 for b in body]
    else:
        for i in range(0, len(body), 2):
            v = struct.unpack(">H", body[i:i + 2])[0]
            steps.append((v >> 11, v & 0x7FF))
    return QcdInfo(style=style, num_guard_bits=guard,
                   exponents=tuple(exponents), steps=tuple(steps))


def write_com(text: str) -> bytes:
    return _seg(COM, struct.pack(">H", 1) + text.encode("latin-1"))


def write_sot(s: SotInfo) -> bytes:
    return struct.pack(">HHHIBB", SOT, 10, s.tile_index, s.psot, s.tpsot,
                       s.tnsot)


def parse_sot(payload: bytes) -> SotInfo:
    tile_index, psot, tpsot, tnsot = struct.unpack(">HIBB", payload[:8])
    return SotInfo(tile_index=tile_index, psot=psot, tpsot=tpsot, tnsot=tnsot)


def write_sod() -> bytes:
    return struct.pack(">H", SOD)


def write_eoc() -> bytes:
    return struct.pack(">H", EOC)


def write_cap(reversible: bool, max_Mb: int) -> bytes:
    """CAP marker for HTJ2K (Part 15): Pcap bit 15 set, Ccap15 per
    reference j2k_write_cap (reference: src/lib/jp2/codestream/
    j2k.cpp:3298): Bp derived from the maximum magnitude bits."""
    pcap = 0x00020000
    ccap = 0 if reversible else 0x0020
    b = max_Mb
    if b <= 8:
        bp = 0
    elif b < 28:
        bp = b - 8
    elif b < 48:
        bp = 13 + (b >> 2)
    else:
        bp = 31
    ccap |= bp
    payload = struct.pack(">IH", pcap, ccap)
    return struct.pack(">HH", CAP, 2 + len(payload)) + payload


JPH_RSIZ_FLAG = 0x4000


# ---------------------------------------------------------------------------
# COC / QCC (per-component overrides), POC, TLM
# ---------------------------------------------------------------------------

def write_coc(compno: int, c: CodInfo, ncomps: int) -> bytes:
    """COC marker: per-component coding style (A.6.2)."""
    payload = struct.pack(">H" if ncomps > 256 else ">B", compno)
    scoc = 0x01 if c.precincts is not None else 0
    payload += struct.pack(">B", scoc)
    payload += _spcod_tail(c)
    return _seg(COC, payload)


def parse_coc(payload: bytes, ncomps: int, base: CodInfo):
    """Returns (compno, CodInfo) using `base` for packet-level fields."""
    if ncomps > 256:
        compno = struct.unpack(">H", payload[:2])[0]
        off = 2
    else:
        compno = payload[0]
        off = 1
    scoc = payload[off]
    off += 1
    nl, cbw, cbh, cbsty, tr = struct.unpack(
        ">BBBBB", payload[off:off + 5])
    numres = nl + 1
    precincts = None
    if scoc & 0x01:
        precincts = tuple(
            (payload[off + 5 + i] & 0x0F, payload[off + 5 + i] >> 4)
            for i in range(numres))
    cod = dataclasses.replace(
        base, numresolutions=numres, cblk_w_exp=cbw + 2, cblk_h_exp=cbh + 2,
        cblk_style=cbsty, transform=Transform(tr), precincts=precincts)
    return compno, cod


def write_qcc(compno: int, q: QcdInfo, ncomps: int) -> bytes:
    payload = struct.pack(">H" if ncomps > 256 else ">B", compno)
    sq = int(q.style) | (q.num_guard_bits << 5)
    payload += struct.pack(">B", sq)
    if q.style == QuantStyle.NONE:
        for e in q.exponents:
            payload += struct.pack(">B", e << 3)
    else:
        for (expn, mant) in q.steps:
            payload += struct.pack(">H", (expn << 11) | mant)
    return _seg(QCC, payload)


def parse_qcc(payload: bytes, ncomps: int):
    if ncomps > 256:
        compno = struct.unpack(">H", payload[:2])[0]
        off = 2
    else:
        compno = payload[0]
        off = 1
    return compno, parse_qcd(payload[off:])


@dataclasses.dataclass
class PocEntry:
    """One progression-order-change volume (A.6.6)."""

    rs: int                 # RSpoc: first resolution
    cs: int                 # CSpoc: first component
    lye: int                # LYEpoc: layer bound (exclusive)
    re: int                 # REpoc: resolution bound (exclusive)
    ce: int                 # CEpoc: component bound (exclusive)
    prog: Progression


def write_poc(entries, ncomps: int) -> bytes:
    payload = b""
    wide = ncomps > 256
    for e in entries:
        payload += struct.pack(">B", e.rs)
        payload += struct.pack(">H" if wide else ">B", e.cs)
        payload += struct.pack(">HB", e.lye, e.re)
        payload += struct.pack(">H" if wide else ">B", e.ce)
        payload += struct.pack(">B", int(e.prog))
    return _seg(POC, payload)


def parse_poc(payload: bytes, ncomps: int):
    wide = ncomps > 256
    csz = 2 if wide else 1
    entry = 1 + csz + 2 + 1 + csz + 1
    out = []
    pos = 0
    while pos + entry <= len(payload):
        rs = payload[pos]
        pos += 1
        cs = struct.unpack(">H" if wide else ">B",
                           payload[pos:pos + csz])[0]
        pos += csz
        lye, re = struct.unpack(">HB", payload[pos:pos + 3])
        pos += 3
        ce = struct.unpack(">H" if wide else ">B",
                           payload[pos:pos + csz])[0]
        pos += csz
        prog = Progression(payload[pos])
        pos += 1
        out.append(PocEntry(rs=rs, cs=cs, lye=lye, re=re, ce=ce, prog=prog))
    return out


def write_tlm(tile_part_lengths) -> bytes:
    """TLM: tile-part lengths (A.7.1). `tile_part_lengths` is a list of
    (tile_index, length) in codestream order."""
    big_tiles = any(t > 255 for (t, _) in tile_part_lengths)
    st = 2 if big_tiles else 1
    stlm = (st << 4) | 0x40  # SP=1: 32-bit lengths
    payload = struct.pack(">BB", 0, stlm)
    for (t, ln) in tile_part_lengths:
        payload += struct.pack(">H" if st == 2 else ">B", t)
        payload += struct.pack(">I", ln)
    return _seg(TLM, payload)


def parse_tlm(payload: bytes):
    stlm = payload[1]
    st = (stlm >> 4) & 0x3
    sp = (stlm >> 6) & 0x1
    lsz = 4 if sp else 2
    out = []
    pos = 2
    i = 0
    while pos + st + lsz <= len(payload):
        if st == 0:
            t = i
        elif st == 1:
            t = payload[pos]
        else:
            t = struct.unpack(">H", payload[pos:pos + 2])[0]
        pos += st
        ln = struct.unpack(">I" if sp else ">H", payload[pos:pos + lsz])[0]
        pos += lsz
        out.append((t, ln))
        i += 1
    return out


def write_rgn(compno: int, shift: int, ncomps: int) -> bytes:
    """RGN marker (A.6.3): component ROI upshift, Srgn=0 (implicit)."""
    payload = struct.pack(">H" if ncomps > 256 else ">B", compno)
    payload += struct.pack(">BB", 0, shift)
    return _seg(RGN, payload)


def parse_rgn(payload: bytes, ncomps: int):
    if ncomps > 256:
        compno = struct.unpack(">H", payload[:2])[0]
        off = 2
    else:
        compno = payload[0]
        off = 1
    srgn = payload[off]
    shift = payload[off + 1]
    return compno, srgn, shift


# ---------------------------------------------------------------------------
# Packed packet headers (PPM/PPT), packet lengths (PLM/PLT), CRG
# ---------------------------------------------------------------------------

PLM = 0xFF57
PLT = 0xFF58
PPM = 0xFF60
PPT = 0xFF61
CRG = 0xFF63

_MAX_SEG = 65535 - 3  # payload capacity after the Z index byte


def write_ppt(headers: bytes) -> bytes:
    """Tile-part packed packet headers, chunked into PPT markers with
    sequential Zppt (reference: j2k.cpp j2k_read_ppt)."""
    out = bytearray()
    z = 0
    for off in range(0, max(1, len(headers)), _MAX_SEG):
        chunk = headers[off:off + _MAX_SEG]
        out += _seg(PPT, bytes([z]) + chunk)
        z += 1
    return bytes(out)


def write_ppm(tile_sections) -> bytes:
    """Main-header packed packet headers: one Nppm(4)-framed section per
    tile-part, concatenated then chunked into PPM markers
    (reference: j2k.cpp j2k_read_ppm / j2k_merge_ppm)."""
    blob = bytearray()
    for sec in tile_sections:
        blob += struct.pack(">I", len(sec)) + sec
    out = bytearray()
    z = 0
    for off in range(0, max(1, len(blob)), _MAX_SEG):
        out += _seg(PPM, bytes([z]) + bytes(blob[off:off + _MAX_SEG]))
        z += 1
    return bytes(out)


def merge_ppx(chunks) -> bytes:
    """Concatenate PPM/PPT payloads in Z order ((z, data) pairs)."""
    return b"".join(d for (_, d) in sorted(chunks, key=lambda c: c[0]))


def split_ppm_sections(blob: bytes):
    """Split merged PPM data into per-tile-part header sections."""
    out = []
    pos = 0
    while pos + 4 <= len(blob):
        n = struct.unpack(">I", blob[pos:pos + 4])[0]
        pos += 4
        out.append(blob[pos:pos + n])
        pos += n
    return out


def _plt_varlen(length: int) -> bytes:
    """7-bit big-endian varint with continuation in bit 7 (Iplt)."""
    if length == 0:
        return b"\x00"
    parts = []
    while length:
        parts.append(length & 0x7F)
        length >>= 7
    parts.reverse()
    return bytes([(p | 0x80) for p in parts[:-1]] + [parts[-1]])


def write_plt(packet_lengths) -> bytes:
    """Tile-part packet lengths (PLT), chunked with sequential Zplt
    (reference: j2k.cpp j2k_read_plt)."""
    blob = b"".join(_plt_varlen(ln) for ln in packet_lengths)
    out = bytearray()
    z = 0
    for off in range(0, max(1, len(blob)), _MAX_SEG):
        out += _seg(PLT, bytes([z]) + blob[off:off + _MAX_SEG])
        z += 1
    return bytes(out)


def parse_plt(payload: bytes):
    """Returns (zplt, lengths, leftover_partial_value)."""
    z = payload[0]
    lengths = []
    acc = 0
    for b in payload[1:]:
        acc = (acc << 7) | (b & 0x7F)
        if not (b & 0x80):
            lengths.append(acc)
            acc = 0
    return z, lengths, acc


def write_crg(offsets, ncomps: int) -> bytes:
    """Component registration: per-component (Xcrg, Ycrg) 16-bit offsets
    in units of 1/65536 of the sample grid (reference: j2k_read_crg)."""
    payload = b"".join(struct.pack(">HH", x & 0xFFFF, y & 0xFFFF)
                       for (x, y) in offsets)
    return _seg(CRG, payload)


def parse_crg(payload: bytes, ncomps: int):
    out = []
    for c in range(ncomps):
        x, y = struct.unpack(">HH", payload[c * 4:c * 4 + 4])
        out.append((x, y))
    return out


# ---------------------------------------------------------------------------
# Custom MCT (Part 2): MCT / MCC / MCO / CBD markers
# ---------------------------------------------------------------------------

MCT = 0xFF74
MCC = 0xFF75
MCO = 0xFF77

MCT_ARRAY_DEPENDENCY = 0
MCT_ARRAY_DECORRELATION = 1
MCT_ARRAY_OFFSET = 2
MCT_ELEM_FLOAT = 2


def write_mct_record(index: int, array_type: int, data) -> bytes:
    """One MCT marker holding a float32 array (reference:
    j2k.cpp j2k_write_mct_record)."""
    import numpy as np
    arr = np.asarray(data, dtype=">f4").ravel()
    tmp = (index & 0xFF) | (array_type << 8) | (MCT_ELEM_FLOAT << 10)
    payload = struct.pack(">HHH", 0, tmp, 0) + arr.tobytes()
    return _seg(MCT, payload)


def parse_mct_record(payload: bytes):
    """Returns (index, array_type, element_type, float32 array)."""
    import numpy as np
    zmct, tmp, ymct = struct.unpack(">HHH", payload[:6])
    index = tmp & 0xFF
    array_type = (tmp >> 8) & 0x3
    elem_type = (tmp >> 10) & 0x3
    data = np.frombuffer(payload[6:], dtype=">f4").astype(np.float32)
    return index, array_type, elem_type, data


def write_mcc(ncomps: int, deco_index: int, offset_index: int,
              irreversible: bool = True, index: int = 0) -> bytes:
    wide = ncomps > 255
    mask = 0x8000 if wide else 0
    fmt = ">H" if wide else ">B"
    payload = struct.pack(">HBH", 0, index, 0)       # Zmcc, Imcc, Ymcc
    payload += struct.pack(">H", 1)                   # Qmcc: 1 collection
    payload += struct.pack(">B", 0x1)                 # Xmcci: array-based
    payload += struct.pack(">H", ncomps | mask)
    for i in range(ncomps):
        payload += struct.pack(fmt, i)
    payload += struct.pack(">H", ncomps | mask)
    for i in range(ncomps):
        payload += struct.pack(fmt, i)
    tmcc = ((0 if irreversible else 1) << 16) | deco_index         | (offset_index << 8)
    payload += struct.pack(">I", tmcc)[1:]            # 24-bit
    return _seg(MCC, payload)


def parse_mcc(payload: bytes):
    """Returns (index, deco_index, offset_index, irreversible)."""
    zmcc, imcc, ymcc, qmcc = struct.unpack(">HBHH", payload[:7])
    pos = 7
    xmcci = payload[pos]
    pos += 1
    n_in = struct.unpack(">H", payload[pos:pos + 2])[0]
    wide = bool(n_in & 0x8000)
    n_in &= 0x7FFF
    pos += 2 + n_in * (2 if wide else 1)
    n_out = struct.unpack(">H", payload[pos:pos + 2])[0] & 0x7FFF
    pos += 2 + n_out * (2 if wide else 1)
    tmcc = struct.unpack(">I", b"\x00" + payload[pos:pos + 3])[0]
    deco = tmcc & 0xFF
    off = (tmcc >> 8) & 0xFF
    irreversible = ((tmcc >> 16) & 1) == 0
    return imcc, deco, off, irreversible


def write_mco(mcc_indices) -> bytes:
    payload = struct.pack(">B", len(mcc_indices))
    for i in mcc_indices:
        payload += struct.pack(">B", i)
    return _seg(MCO, payload)


def parse_mco(payload: bytes):
    n = payload[0]
    return [payload[1 + i] for i in range(n)]


def write_cbd(comps) -> bytes:
    """CBD: component bit-depth definitions (needed with Part-2 MCT)."""
    payload = struct.pack(">H", len(comps))
    for c in comps:
        payload += struct.pack(">B", ((1 if c.signed else 0) << 7)
                               | (c.prec - 1))
    return _seg(CBD, payload)
