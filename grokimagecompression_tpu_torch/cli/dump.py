"""grk_dump-compatible codestream inspector.

Prints the main-header structure and tile-part index of a J2K codestream
(reference: src/bin/jp2/grk_dump.cpp main:360, library dump
src/lib/jp2/codestream/j2k_dump.cpp:127). Run as
`python -m grokimagecompression_tpu_torch.cli.dump`.

A copy of `grokimagecompression_tpu/cli/dump.py` over the port's
`decoder.read_header`, `decoder.iter_tile_parts`, `markers.parse_sot`,
`tile.index_tile_packets` and `jp2.extract_codestream`; it does no
device work.
"""

from __future__ import annotations

import argparse
import struct
import sys

from ..core.params import Progression, QuantStyle, Transform
from ..codestream import decoder, markers


def dump_codestream(data: bytes, out=None) -> None:
    out = out if out is not None else sys.stdout
    hdr = decoder.read_header(data)
    siz, cod, qcd = hdr.siz, hdr.cod, hdr.qcd
    w = out.write
    w("Image info {\n")
    w(f"\t x0={siz.xosiz}, y0={siz.yosiz}\n")
    w(f"\t x1={siz.xsiz}, y1={siz.ysiz}\n")
    w(f"\t numcomps={len(siz.comps)}\n")
    for i, c in enumerate(siz.comps):
        w(f"\t component {i} {{ dx={c.dx}, dy={c.dy}, prec={c.prec},"
          f" sgnd={int(c.signed)} }}\n")
    w("}\n")
    w("Codestream info {\n")
    w(f"\t tx0={siz.xtosiz}, ty0={siz.ytosiz}\n")
    w(f"\t tdx={siz.xtsiz}, tdy={siz.ytsiz}\n")
    from ..core.geometry import tile_grid_size
    ntx, nty = tile_grid_size(siz.xsiz, siz.ysiz, siz.xosiz, siz.yosiz,
                              siz.xtsiz, siz.ytsiz, siz.xtosiz, siz.ytosiz)
    w(f"\t tw={ntx}, th={nty}\n")
    w("\t coding parameters {\n")
    w(f"\t\t prog={Progression(cod.progression).name}\n")
    w(f"\t\t numlayers={cod.numlayers}\n")
    w(f"\t\t mct={cod.mct}\n")
    w(f"\t\t numresolutions={cod.numresolutions}\n")
    w(f"\t\t cblkw=2^{cod.cblk_w_exp}, cblkh=2^{cod.cblk_h_exp}\n")
    w(f"\t\t cblksty={cod.cblk_style}\n")
    xform = "5-3 reversible" if cod.transform == Transform.DWT_53 \
        else "9-7 irreversible"
    w(f"\t\t qmfbid={xform}\n")
    if cod.precincts:
        pstr = " ".join(f"({px},{py})" for (px, py) in cod.precincts)
        w(f"\t\t precincts={pstr}\n")
    w(f"\t\t sop={int(cod.sop)}, eph={int(cod.eph)}\n")
    qs = {QuantStyle.NONE: "none (reversible)",
          QuantStyle.SCALAR_DERIVED: "scalar derived",
          QuantStyle.SCALAR_EXPOUNDED: "scalar expounded"}[qcd.style]
    w(f"\t\t quantization style={qs}, guard bits={qcd.num_guard_bits}\n")
    w("\t }\n")
    w("}\n")
    for com in hdr.comments:
        w(f"Comment: {com}\n")
    if hdr.tlm:
        w("TLM index {\n")
        for (t, ln) in hdr.tlm:
            w(f"\t tile {t}: {ln} bytes\n")
        w("}\n")
    w("Tile-part index {\n")
    pos = hdr.main_header_end
    i = 0
    for tp in decoder.iter_tile_parts(data, pos):
        w(f"\t tile-part {i}: tile={tp.tile_index},"
          f" body_bytes={len(tp.body)}\n")
        if tp.plt_lengths:
            w(f"\t\t PLT packet lengths: {tp.plt_lengths}\n")
        i += 1
    w("}\n")


_MARKER_NAMES = {
    0xFF4F: "SOC", 0xFF51: "SIZ", 0xFF50: "CAP", 0xFF52: "COD",
    0xFF53: "COC", 0xFF5C: "QCD", 0xFF5D: "QCC", 0xFF5E: "RGN",
    0xFF5F: "POC", 0xFF55: "TLM", 0xFF57: "PLM", 0xFF58: "PLT",
    0xFF60: "PPM", 0xFF61: "PPT", 0xFF63: "CRG", 0xFF64: "COM",
    0xFF74: "MCT", 0xFF75: "MCC", 0xFF77: "MCO", 0xFF78: "CBD",
    0xFF90: "SOT", 0xFF91: "SOP", 0xFF92: "EPH", 0xFF93: "SOD",
    0xFFD9: "EOC",
}


def dump_markers(data: bytes, out=None) -> None:
    """Low-level marker walk: every marker with offset and length."""
    out = out if out is not None else sys.stdout
    w = out.write
    w("Marker index {\n")
    pos = 0
    while pos + 2 <= len(data):
        m = struct.unpack(">H", data[pos:pos + 2])[0]
        name = _MARKER_NAMES.get(m, f"{m:04X}")
        if m in (0xFF4F, 0xFF92, 0xFFD9):   # SOC/EPH/EOC: no length
            w(f"\t {pos:#010x} {name}\n")
            pos += 2
            continue
        if m == 0xFF93:                     # SOD: body until next SOT/EOC
            w(f"\t {pos:#010x} SOD\n")
            # hop to the enclosing tile-part end via last SOT's Psot
            break
        if pos + 4 > len(data):
            break
        ln = struct.unpack(">H", data[pos + 2:pos + 4])[0]
        w(f"\t {pos:#010x} {name} len={ln}\n")
        if m == 0xFF90 and pos + 12 <= len(data):
            sot = markers.parse_sot(data[pos + 4:pos + 12])
            w(f"\t\t tile={sot.tile_index} psot={sot.psot}\n")
        pos += 2 + ln
    w("}\n")
    # walk tile-parts for their internal markers
    try:
        hdr = decoder.read_header(data)
    except ValueError:
        return
    w("Tile-part markers {\n")
    for pos2, ln2, t in _tilepart_spans(data, hdr.main_header_end):
        w(f"\t {pos2:#010x} SOT tile={t} psot={ln2}\n")
        hp = pos2 + 12
        end = pos2 + ln2
        while hp + 4 <= end:
            m = struct.unpack(">H", data[hp:hp + 2])[0]
            if m == 0xFF93:
                w(f"\t\t {hp:#010x} SOD body_bytes={end - hp - 2}\n")
                break
            mln = struct.unpack(">H", data[hp + 2:hp + 4])[0]
            w(f"\t\t {hp:#010x} {_MARKER_NAMES.get(m, hex(m))} "
              f"len={mln}\n")
            hp += 2 + mln
    w("}\n")


def _tilepart_spans(data: bytes, start: int):
    pos = start
    while pos + 12 <= len(data):
        m = struct.unpack(">H", data[pos:pos + 2])[0]
        if m != 0xFF90:
            break
        sot = markers.parse_sot(data[pos + 4:pos + 12])
        psot = sot.psot if sot.psot else len(data) - pos
        yield pos, psot, sot.tile_index
        pos += psot


def dump_packet_index(data: bytes, out=None) -> None:
    """Per-tile packet index: progression position and byte length of
    every packet (the grk_dump codestream-index analog, reference:
    j2k_dump.cpp j2k_dump_MH_index:176)."""
    out = out if out is not None else sys.stdout
    w = out.write
    from ..codestream.tile import index_tile_packets
    hdr = decoder.read_header(data)
    bodies = {}
    for tp in decoder.iter_tile_parts(data, hdr.main_header_end):
        bodies.setdefault(tp.tile_index, []).append(tp.body)
    w("Packet index {\n")
    for t in sorted(bodies):
        body = b"".join(bodies[t])
        try:
            pkts = index_tile_packets(body, hdr, t)
        except Exception as e:  # corrupt tiles: report, don't die
            w(f"\t tile {t}: <unparseable: {e}>\n")
            continue
        w(f"\t tile {t}: {len(pkts)} packets\n")
        for (l, r, c, p, off, ln) in pkts:
            w(f"\t\t layer={l} res={r} comp={c} prec={p} "
              f"offset={off} bytes={ln}\n")
    w("}\n")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="grk_dump",
        description="Dump JPEG 2000 codestream structure")
    p.add_argument("-i", "--in-file")
    p.add_argument("-y", "--img-dir", default=None,
                   help="dump every .j2k/.jp2 in this directory")
    p.add_argument("-o", "--out-file", default=None)
    p.add_argument("-m", "--markers", action="store_true",
                   help="dump the raw marker index")
    p.add_argument("-p", "--packets", action="store_true",
                   help="dump the per-tile packet index")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.img_dir:
        import os
        rc = 0
        base = list(argv if argv is not None else sys.argv[1:])
        filtered = []
        skip = False
        for a in base:
            if skip:
                skip = False
                continue
            if a in ("-y", "--img-dir"):
                skip = True
                continue
            filtered.append(a)
        for name in sorted(os.listdir(args.img_dir)):
            if not name.lower().endswith((".j2k", ".j2c", ".jp2", ".jph")):
                continue
            print(f"=== {name} ===")
            try:
                rc |= main(filtered + ["-i",
                                       os.path.join(args.img_dir, name)])
            except SystemExit:
                rc = 1
        return rc
    if not args.in_file:
        print("error: -i or -y required", file=sys.stderr)
        return 1
    with open(args.in_file, "rb") as f:
        data = f.read()
    if data[:4] == b"\x00\x00\x00\x0c":
        # JP2 container: locate the jp2c box.
        from ..codestream import jp2
        data = jp2.extract_codestream(data)
    def run(out):
        dump_codestream(data, out)
        if args.markers:
            dump_markers(data, out)
        if args.packets:
            dump_packet_index(data, out)

    if args.out_file:
        with open(args.out_file, "w") as f:
            run(f)
    else:
        run(sys.stdout)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
