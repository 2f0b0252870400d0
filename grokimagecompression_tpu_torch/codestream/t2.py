"""Tier-2: packet header/body coding (ISO/IEC 15444-1 B.9/B.10).

Analog of the reference T2 coder (reference: src/lib/jp2/t2/T2.cpp:
encode_packet:859, read_packet_header:314, read_packet_data:654,
init_seg:821), restructured around explicit per-precinct contexts instead
of a mutable codec tree.

A copy of `grokimagecompression_tpu/codestream/t2.py`, with `PassInfo`
and the code-block style bits it needs from that package's
`t1/t1_np.py`. The port parses and writes packets through the native T2
(`native/t2_native.py`); the Python coder here runs where the reference
runs it too (packed headers: `decode_packet_split` parses a tile whose
packet headers come from PPM or PPT markers; packet lengths) and holds
the native one to its semantics in the tests.

A packet = (layer, component, resolution, precinct). Its header codes, per
band and code-block: inclusion (tag tree on first inclusion, 1 bit after),
missing bit-planes (tag tree, first inclusion only), number of new passes,
Lblock increments, and one length per codeword-segment portion. The body
concatenates the corresponding pass bytes.
"""

from __future__ import annotations

import dataclasses
import struct
from typing import List, Optional, Tuple

from ..core.geometry import CodeBlock, Precinct
from .bitio import BitReader, BitWriter
from .tagtree import TagTree

SOP_MARKER = 0xFF91
EPH_MARKER = 0xFF92

CBLKSTY_LAZY = 0x01
CBLKSTY_TERMALL = 0x04


@dataclasses.dataclass
class PassInfo:
    """Per coding-pass record for rate allocation (PCRD)."""

    rate: int          # cumulative truncation length in bytes after this pass
    distortion: float  # cumulative distortion *decrease* (sum of err^2 drops)
    terminated: bool   # whether the arithmetic coder was flushed after it


def _floorlog2(n: int) -> int:
    return n.bit_length() - 1


def seg_maxpasses(seg_index: int, cblk_style: int) -> int:
    """Maximum passes per codeword segment (B.10.7.2 termination rules;
    Part 15 for HT blocks: each HT set is a 1-pass cleanup segment
    followed by a 2-pass SigProp+MagRef refinement segment)."""
    if cblk_style & 0x40:  # HT
        return 1 if seg_index % 2 == 0 else 2
    if cblk_style & CBLKSTY_TERMALL:
        return 1
    if cblk_style & CBLKSTY_LAZY:
        if seg_index == 0:
            return 10
        # After the first 10 passes: raw (SIG+REF) segments of 2 alternate
        # with MQ cleanup segments of 1.
        return 2 if seg_index % 2 == 1 else 1
    return 109


# --------------------------------------------------------------------------
# Encoder side
# --------------------------------------------------------------------------

@dataclasses.dataclass
class CblkEnc:
    """Per code-block encode state carried through Tier-2."""

    geom: CodeBlock
    data: bytes = b""
    numbps: int = 0          # actual coded bit-planes
    imsb: int = 0            # missing bit-planes signalled via tag tree
    numpasses: int = 0
    passes: List[PassInfo] = dataclasses.field(default_factory=list)
    layer_npasses: List[int] = dataclasses.field(default_factory=list)
    # T2 running state:
    included: bool = False
    lblock: int = 3
    passes_used: int = 0

    def first_contrib_layer(self) -> Optional[int]:
        for l, n in enumerate(self.layer_npasses):
            if n > 0:
                return l
        return None

    def pass_bytes(self, a: int, b: int) -> int:
        """Bytes covering passes [a, b)."""
        if b <= a:
            return 0
        lo = self.passes[a - 1].rate if a > 0 else 0
        return self.passes[b - 1].rate - lo

    def segments_for_layer(self, n: int, cblk_style: int) -> List[Tuple[int, int]]:
        """Split this layer's `n` passes into codeword-segment portions.

        Returns [(npasses, nbytes), ...]; portions align with segment
        boundaries (terminated passes) or the layer end.
        """
        out = []
        a = self.passes_used
        end = a + n
        i = a
        while i < end:
            j = i
            while j < end - 1 and not self.passes[j].terminated:
                j += 1
            out.append((j - i + 1, self.pass_bytes(i, j + 1)))
            i = j + 1
        return out


@dataclasses.dataclass
class PrecEnc:
    geom: Precinct
    cblks: List[CblkEnc]
    incltree: TagTree = None
    imsbtree: TagTree = None

    def init_trees(self):
        w = max(1, self.geom.cblk_grid_w)
        h = max(1, self.geom.cblk_grid_h)
        self.incltree = TagTree(w, h)
        self.imsbtree = TagTree(w, h)
        for cb in self.cblks:
            fl = cb.first_contrib_layer()
            self.incltree.set_value(cb.geom.cx, cb.geom.cy,
                                    fl if fl is not None else 999_999)
            self.imsbtree.set_value(cb.geom.cx, cb.geom.cy, cb.imsb)


def encode_packet(
    layer: int,
    precincts: List[PrecEnc],
    cblk_style: int,
    sop: bool = False,
    eph: bool = False,
    packet_index: int = 0,
    split: bool = False,
):
    """Encode one packet over the given band-precincts (one per band of the
    resolution, in band order).

    With `split=True` returns (header_bytes, body_bytes) for packed
    packet headers (PPM/PPT): the header (incl. EPH) goes to the PPM/PPT
    stream while SOP + packet bodies stay in the tile body
    (reference: j2k_read_ppm/ppt + T2 packed-header consumption).
    """
    out = bytearray()
    if sop:
        out += struct.pack(">HHH", SOP_MARKER, 4, packet_index & 0xFFFF)
    bw = BitWriter()
    nonempty = any(
        cb.layer_npasses[layer] > 0 for pr in precincts for cb in pr.cblks
    )
    body = bytearray()
    if not nonempty:
        bw.write_bit(0)
        hdr = bw.flush()
        if eph:
            hdr += struct.pack(">H", EPH_MARKER)
        if split:
            return bytes(hdr), bytes(out)
        return bytes(out) + hdr
    bw.write_bit(1)
    for pr in precincts:
        for cb in pr.cblks:
            n = cb.layer_npasses[layer]
            if not cb.included:
                pr.incltree.encode(bw, cb.geom.cx, cb.geom.cy, layer + 1)
            else:
                bw.write_bit(1 if n > 0 else 0)
            if n == 0:
                continue
            if not cb.included:
                # First inclusion: code missing bit-planes exactly.
                t = 1
                while True:
                    pr.imsbtree.encode(bw, cb.geom.cx, cb.geom.cy, t)
                    if cb.imsb < t:
                        break
                    t += 1
                cb.included = True
                cb.lblock = 3
            bw.write_numpasses(n)
            segs = cb.segments_for_layer(n, cblk_style)
            # One Lblock increment covering all segments of this layer.
            increment = 0
            for (sp, sb) in segs:
                bits_needed = max(1, sb.bit_length())
                have = cb.lblock + _floorlog2(sp)
                increment = max(increment, bits_needed - have)
            bw.write_commacode(increment)
            cb.lblock += increment
            for (sp, sb) in segs:
                bw.write_bits(sb, cb.lblock + _floorlog2(sp))
            # Append body bytes for this layer.
            start = cb.passes[cb.passes_used - 1].rate if cb.passes_used else 0
            total = sum(sb for (_, sb) in segs)
            body += cb.data[start:start + total]
            cb.passes_used += n
    hdr = bw.flush()
    if eph:
        hdr += struct.pack(">H", EPH_MARKER)
    if split:
        return bytes(hdr), bytes(out) + bytes(body)
    return bytes(out) + hdr + bytes(body)


# --------------------------------------------------------------------------
# Decoder side
# --------------------------------------------------------------------------

@dataclasses.dataclass
class SegDec:
    data: bytearray = dataclasses.field(default_factory=bytearray)
    numpasses: int = 0
    maxpasses: int = 0


@dataclasses.dataclass
class CblkDec:
    geom: CodeBlock
    numbps: int = 0
    imsb: int = 0
    lblock: int = 3
    numpasses: int = 0
    segs: List[SegDec] = dataclasses.field(default_factory=list)
    included: bool = False

    def data_and_seg_lengths(self) -> Tuple[bytes, Optional[List[int]]]:
        data = b"".join(bytes(s.data) for s in self.segs)
        if len(self.segs) <= 1:
            return data, None
        return data, [len(s.data) for s in self.segs]


@dataclasses.dataclass
class PrecDec:
    geom: Precinct
    cblks: List[CblkDec]
    incltree: TagTree = None
    imsbtree: TagTree = None

    def init_trees(self):
        w = max(1, self.geom.cblk_grid_w)
        h = max(1, self.geom.cblk_grid_h)
        self.incltree = TagTree(w, h)
        self.imsbtree = TagTree(w, h)


def decode_packet(
    data: bytes,
    pos: int,
    layer: int,
    precincts: List[PrecDec],
    kmax_per_band: List[int],
    cblk_style: int,
    sop: bool = False,
    eph: bool = False,
    discard: bool = False,
) -> int:
    """Parse one packet starting at `pos`; fills cblk segment data.
    Returns the new position. `discard=True` parses the packet (keeping
    tag-tree/lblock/segment state in sync) but drops its pass data — used
    for layer-truncated decode, where dropped layers are always a suffix
    of each code-block's packet sequence."""
    pos, _ = _decode_packet_impl(data, pos, data, pos, False, layer,
                                 precincts, kmax_per_band, cblk_style,
                                 eph, discard)
    return pos


def decode_packet_split(
    hdr: bytes,
    hpos: int,
    body: bytes,
    bpos: int,
    layer: int,
    precincts: List[PrecDec],
    kmax_per_band: List[int],
    cblk_style: int,
    eph: bool = False,
    discard: bool = False,
) -> Tuple[int, int]:
    """Packed-header variant (PPM/PPT): the packet header is read from
    `hdr` and the packet body (with any SOP marker) from `body`.
    Returns (new body pos, new hdr pos)."""
    return _decode_packet_impl(hdr, hpos, body, bpos, True, layer,
                               precincts, kmax_per_band, cblk_style,
                               eph, discard)


def _decode_packet_impl(hdr, hpos, body, bpos, split, layer, precincts,
                        kmax_per_band, cblk_style, eph, discard):
    data = body
    pos = bpos
    if pos + 6 <= len(data) and struct.unpack(">H", data[pos:pos + 2])[0] == SOP_MARKER:
        pos += 6
    if not split:
        hpos = pos  # header follows SOP in the combined stream
    br = BitReader(hdr, hpos)
    # (cblk, seg_idx, npasses, nbytes) in header order
    new_segs: List[Tuple[CblkDec, int, int, int]] = []
    if not br.read_bit():
        br.align()
        hpos = br.pos
        if eph and hpos + 2 <= len(hdr) and \
                struct.unpack(">H", hdr[hpos:hpos + 2])[0] == EPH_MARKER:
            hpos += 2
        if not split:
            pos = hpos
        return pos, hpos
    for bi, pr in enumerate(precincts):
        kmax = kmax_per_band[bi]
        for cb in pr.cblks:
            if not cb.included:
                if pr.incltree is None:
                    pr.init_trees()
                inc = pr.incltree.decode(br, cb.geom.cx, cb.geom.cy, layer + 1)
            else:
                inc = bool(br.read_bit())
            if not inc:
                continue
            if not cb.included:
                t = 1
                while not pr.imsbtree.decode(br, cb.geom.cx, cb.geom.cy, t):
                    t += 1
                cb.imsb = t - 1
                cb.numbps = kmax - cb.imsb
                cb.included = True
                cb.lblock = 3
            n = br.read_numpasses()
            increment = br.read_commacode()
            cb.lblock += increment
            # Distribute the n new passes over codeword segments.
            remaining = n
            while remaining > 0:
                if cb.segs and cb.segs[-1].numpasses < cb.segs[-1].maxpasses:
                    seg = cb.segs[-1]
                else:
                    seg = SegDec(maxpasses=seg_maxpasses(len(cb.segs),
                                                         cblk_style))
                    cb.segs.append(seg)
                take = min(remaining, seg.maxpasses - seg.numpasses)
                ln = br.read_bits(cb.lblock + _floorlog2(take))
                new_segs.append((cb, len(cb.segs) - 1, take, ln))
                seg.numpasses += take
                if not discard:
                    cb.numpasses += take
                remaining -= take
    br.align()
    hpos = br.pos
    if eph and hpos + 2 <= len(hdr) and \
            struct.unpack(">H", hdr[hpos:hpos + 2])[0] == EPH_MARKER:
        hpos += 2
    if not split:
        pos = hpos
    # Packet body: segment bytes in header order.
    for (cb, seg_idx, take, ln) in new_segs:
        if not discard:
            cb.segs[seg_idx].data += data[pos:pos + ln]
        pos += ln
    return pos, hpos
