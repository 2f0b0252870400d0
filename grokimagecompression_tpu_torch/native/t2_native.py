"""ctypes binding for the host library's Tier-2 coder (csrc/host/t2.cpp).

A copy of `grokimagecompression_tpu/native/t2_native.py` for the three
entry points the port runs: `TileEnc` (every precinct group of a tile
encoded in one native call; Python assembles the fragments in
progression order and prepends SOP markers, which carry the global
packet index), `TileSim` (the byte count of a tile's packets for the
rate control's search, one native call each) and `decode_tile_packets`
(a tile's whole packet sequence parsed in one native call). The library
is built on first use (`ops/_build.host_library`).
"""

from __future__ import annotations

import numpy as np

from ..codestream.t2 import SegDec
from ..ops import _build


# the parser's limits per code-block (csrc/host/t2.cpp T2D_MAX_CHUNKS):
# the (packet, codeword segment) pieces of its bytes it records
MAX_CHUNKS = 160
# pieces recorded a code-block where its style ends few codeword segments
CHUNKS = 12


def _chunk_cap(kmax: int, style: int) -> int:
    """Room for the pieces of one code-block's bytes: TERMALL and BYPASS
    (MQ) end a codeword segment every pass or two, and a piece holds a
    pass at least, so up to the 3 Kmax - 2 passes of the block."""
    if style & 0x40 or not style & 0x05:
        return CHUNKS
    return min(MAX_CHUNKS, max(CHUNKS, 3 * kmax - 2))


def decode_tile_packets(body: bytes, packets, groups, kmaxs_per_band,
                        styles_per_band, sop: bool, eph: bool,
                        nlayers: int = 0):
    """Parse a tile's whole packet sequence natively.

    packets: [(group_index, layer), ...] in progression order.
    groups: per group, a list of PrecDec (band-precincts); their CblkDec
    objects are filled (numbps, numpasses, segs).
    nlayers: keep the passes of the first `nlayers` layers only (all when
    0); later layers' packets are parsed to stay in sync and dropped, as
    `t2.decode_packet(..., discard=True)` drops them.
    Returns bytes consumed, or None if the native parser declined.
    """
    lib = _build.host_library()
    ngroups = len(groups)
    gband_off = np.zeros(ngroups + 1, dtype=np.int32)
    grids = []
    ncblks = []
    kmaxs = []
    styles = []
    cblks = []
    for g, precs in enumerate(groups):
        gband_off[g + 1] = gband_off[g] + len(precs)
        for (pr, kmax, style) in precs:
            grids.append((max(1, pr.geom.cblk_grid_w),
                          max(1, pr.geom.cblk_grid_h)))
            ncblks.append(len(pr.cblks))
            kmaxs.append(kmax)
            styles.append(style)
            cblks.extend(pr.cblks)
    n = len(cblks)
    grid_arr = np.asarray(grids, dtype=np.int32).reshape(-1)
    if grid_arr.size == 0:
        grid_arr = np.zeros(2, dtype=np.int32)
    ncblk_arr = np.asarray(ncblks or [0], dtype=np.int32)
    kmax_arr = np.asarray(kmaxs or [0], dtype=np.int32)
    style_arr = np.asarray(styles or [0], dtype=np.int32)
    meta = np.zeros(max(1, n * 3), dtype=np.int64)
    for i, cb in enumerate(cblks):
        meta[i * 3] = cb.geom.cx
        meta[i * 3 + 1] = cb.geom.cy
    pkt_group = np.asarray([p[0] for p in packets] or [0], dtype=np.int32)
    pkt_layer = np.asarray([p[1] for p in packets] or [0], dtype=np.int32)
    body_arr = np.frombuffer(body or b"\x00", dtype=np.uint8)
    out_meta = np.zeros(max(1, n * 4), dtype=np.int64)
    seg_cap = max(16, sum(nc * _chunk_cap(k, st)
                          for nc, k, st in zip(ncblks, kmaxs, styles)))
    seg_out = np.zeros(seg_cap * 3, dtype=np.int64)
    rc = lib.grok_t2_decode_tile(
        body_arr.ctypes.data, len(body), len(packets),
        pkt_group.ctypes.data, pkt_layer.ctypes.data, ngroups,
        gband_off.ctypes.data, grid_arr.ctypes.data, ncblk_arr.ctypes.data,
        kmax_arr.ctypes.data, style_arr.ctypes.data, meta.ctypes.data,
        1 if sop else 0, 1 if eph else 0,
        nlayers if nlayers > 0 else np.iinfo(np.int32).max,
        out_meta.ctypes.data,
        seg_out.ctypes.data, seg_cap)
    if rc < 0:
        return None
    for i, cb in enumerate(cblks):
        cb.numbps = int(out_meta[i * 4])
        cb.numpasses = int(out_meta[i * 4 + 1])
        nchunks = int(out_meta[i * 4 + 2])
        base = int(out_meta[i * 4 + 3])
        segs = {}
        order = []
        for k in range(nchunks):
            off = int(seg_out[(base + k) * 3])
            ln = int(seg_out[(base + k) * 3 + 1])
            si = int(seg_out[(base + k) * 3 + 2])
            if si not in segs:
                segs[si] = SegDec()
                order.append(si)
            segs[si].data += body[off:off + ln]
        cb.segs = [segs[si] for si in order]
    return int(rc)


class TileEnc:
    """Whole-tile packet emission: all precinct groups marshaled once
    (including the compressed block bytes) and encoded by one native
    call."""

    def __init__(self, groups, numlayers: int, cblk_style: int, eph: bool):
        """groups: list of (key, comp, [PrecEnc...]) in a fixed order."""
        self.numlayers = numlayers
        self.cblk_style = cblk_style
        self.eph = eph
        self.keys = [g[0] for g in groups]
        self.ngroups = len(groups)
        g_nbands = []
        grid = []
        ncblks = []
        cblks = []
        group_ncb = []
        for (_, _, precs) in groups:
            g_nbands.append(len(precs))
            ncb = 0
            for pr in precs:
                grid.append(max(1, pr.geom.cblk_grid_w))
                grid.append(max(1, pr.geom.cblk_grid_h))
                ncblks.append(len(pr.cblks))
                cblks.extend(pr.cblks)
                ncb += len(pr.cblks)
            group_ncb.append(ncb)
        self.order = cblks
        n = len(cblks)
        pass_stride = max([cb.numpasses for cb in cblks] + [1])
        self.g_nbands = np.asarray(g_nbands, np.int32)
        self.grid = np.asarray(grid, np.int32)
        self.ncblks = np.asarray(ncblks, np.int32)
        meta = np.zeros(max(1, n * 5), dtype=np.int64)
        rates = np.zeros(max(1, n * pass_stride), dtype=np.int32)
        term = np.zeros(max(1, n * pass_stride), dtype=np.uint8)
        datas = []
        off = 0
        group_body = [0] * self.ngroups
        gi = 0
        seen = 0
        for i, cb in enumerate(cblks):
            while gi < self.ngroups - 1 and i >= seen + group_ncb[gi]:
                seen += group_ncb[gi]
                gi += 1
            meta[i * 5] = cb.geom.cx
            meta[i * 5 + 1] = cb.geom.cy
            meta[i * 5 + 2] = cb.imsb
            meta[i * 5 + 3] = cb.numpasses
            meta[i * 5 + 4] = off
            for j, pss in enumerate(cb.passes):
                rates[i * pass_stride + j] = pss.rate
                term[i * pass_stride + j] = 1 if pss.terminated else 0
            datas.append(cb.data)
            group_body[gi] += len(cb.data)
            off += len(cb.data)
        self.meta = meta
        self.rates = rates
        self.term = term
        self.pass_stride = pass_stride
        self.data_flat = np.frombuffer(b"".join(datas) or b"\x00",
                                       dtype=np.uint8)
        self.layer_np = np.zeros(max(1, n * numlayers), dtype=np.int32)
        go = np.zeros(self.ngroups + 1, dtype=np.int64)
        for g in range(self.ngroups):
            go[g + 1] = go[g] + group_body[g] + 4096 * numlayers \
                + 64 * max(1, group_ncb[g])
        self.group_off = go
        self.out = np.empty(max(1, int(go[-1])), dtype=np.uint8)
        self.frag_off = np.zeros(self.ngroups * (numlayers + 1),
                                 dtype=np.int64)

    def encode_all(self, max_layer: int):
        """Encode layers 0..max_layer for every group. Returns
        {key: [layer fragments as memoryview]}."""
        nl = self.numlayers
        lp = self.layer_np
        for i, cb in enumerate(self.order):
            lp[i * nl:(i + 1) * nl] = cb.layer_npasses
        rc = _build.host_library().grok_t2_encode_tile(
            self.ngroups, nl, max_layer, 1 if self.eph else 0,
            self.g_nbands.ctypes.data, self.grid.ctypes.data,
            self.ncblks.ctypes.data, self.meta.ctypes.data,
            lp.ctypes.data, self.rates.ctypes.data, self.term.ctypes.data,
            self.pass_stride, self.data_flat.ctypes.data,
            self.out.ctypes.data, self.group_off.ctypes.data,
            self.frag_off.ctypes.data)
        if rc != 0:
            raise RuntimeError("native tile T2 encode overflow")
        mv = memoryview(self.out)
        frags = {}
        fo = self.frag_off
        for g, key in enumerate(self.keys):
            base = int(self.group_off[g])
            row = fo[g * (nl + 1):(g + 1) * (nl + 1)]
            frags[key] = [mv[base + int(row[l]):base + int(row[l + 1])]
                          for l in range(max_layer + 1)]
        return frags


class TileSim:
    """Whole-tile packet simulation state for PCRD: all precinct groups
    marshaled once; the allocator writes each layer's pass counts with
    write_rows, and each simulate() is a single native call. (The
    reference's copy also re-reads the counts from the CblkEnc objects
    when nothing wrote them; the port's only caller always writes.)"""

    def __init__(self, groups, numlayers: int, eph: bool):
        """groups: list of (key, comp, [PrecEnc...]) in a fixed order."""
        self.numlayers = numlayers
        self.eph = eph
        self.comps = [g[1] for g in groups]
        self.ngroups = len(groups)
        g_nbands = []
        grid = []
        ncblks = []
        cblks = []
        for (_, _, precs) in groups:
            g_nbands.append(len(precs))
            for pr in precs:
                grid.append(max(1, pr.geom.cblk_grid_w))
                grid.append(max(1, pr.geom.cblk_grid_h))
                ncblks.append(len(pr.cblks))
                cblks.extend(pr.cblks)
        self.order = cblks
        n = len(cblks)
        pass_stride = max([cb.numpasses for cb in cblks] + [1])
        self.g_nbands = np.asarray(g_nbands, np.int32)
        self.grid = np.asarray(grid, np.int32)
        self.ncblks = np.asarray(ncblks, np.int32)
        meta = np.zeros(max(1, n * 5), dtype=np.int64)
        rates = np.zeros(max(1, n * pass_stride), dtype=np.int32)
        term = np.zeros(max(1, n * pass_stride), dtype=np.uint8)
        for i, cb in enumerate(cblks):
            meta[i * 5] = cb.geom.cx
            meta[i * 5 + 1] = cb.geom.cy
            meta[i * 5 + 2] = cb.imsb
            meta[i * 5 + 3] = cb.numpasses
            for j, pss in enumerate(cb.passes):
                rates[i * pass_stride + j] = pss.rate
                term[i * pass_stride + j] = 1 if pss.terminated else 0
        self.meta = meta
        self.rates = rates
        self.term = term
        self.pass_stride = pass_stride
        self.layer_np = np.zeros((max(1, n), numlayers), dtype=np.int32)
        self.out_bytes = np.zeros(max(1, self.ngroups), dtype=np.int64)
        self._row_of = None

    def write_rows(self, layer: int, values, cblks) -> None:
        """Scatter one layer's pass counts for `cblks` into layer_np."""
        if self._row_of is None:
            self._row_of = {id(cb): i for i, cb in enumerate(self.order)}
        rows = np.fromiter((self._row_of[id(cb)] for cb in cblks),
                           np.int64, len(cblks))
        self.layer_np[rows, layer] = values

    def simulate(self, max_layer: int):
        """Returns (total_bytes, per_group int64 array) for layers
        0..max_layer of the pass counts written so far."""
        rc = _build.host_library().grok_t2_simulate_tile(
            self.ngroups, self.numlayers, max_layer,
            1 if self.eph else 0, self.g_nbands.ctypes.data,
            self.grid.ctypes.data, self.ncblks.ctypes.data,
            self.meta.ctypes.data, self.layer_np.ctypes.data,
            self.rates.ctypes.data, self.term.ctypes.data,
            self.pass_stride, self.out_bytes.ctypes.data)
        if rc != 0:
            raise RuntimeError("native tile simulate failed")
        return int(self.out_bytes[:self.ngroups].sum()), self.out_bytes
