"""Streaming codestream I/O on a torch device: a tile at a time.

A copy of `grokimagecompression_tpu/codestream/stream.py` (the analog of
the reference's BufferedStream / mem-mapped stream layer and its
single-tile APIs, grk_write_tile and grk_get_decoded_tile), over the
port's device encode and decode.

`StreamEncoder` writes a codestream tile by tile without holding the
whole image: each `write_tile` codes one tile on the device (the fused
transform and block coder of `models/fused_encode.py`, one call a tile)
and packetizes it with the port's T2 (`tile.encode_tile`; the MQ
code-block styles other than the default and HT refinement passes take
the transform on the device and the host Tier-1 coders,
`encoder.block_coder`); a TLM marker
reserved in the main header is patched on close so readers can seek.
Tiles of one plan share one fused encoder (interior tiles of a grid
do). `StreamDecoder` reads from a file handle (or memory
map), parses only the main header up front, builds a tile index (from
TLM when present, otherwise one SOT-hopping scan), and decodes single
tiles reading only their byte ranges, through `decoder.decode` on the
device. The files equal the reference's byte for byte, but for HT
refinement passes: the reference's `StreamEncoder` drops them (its
`write_tile` does not pass `ht_refined` to its `encode_tile`), and the
port's codes them, as the reference's host `encode` does (ROADMAP Queue
C).
"""

from __future__ import annotations

import dataclasses
import io
import mmap as _mmap
import struct
from typing import Dict, List, Optional

import numpy as np

from ..core.geometry import Rect, tile_grid_size, tile_rect
from ..core.image import Image
from ..core.params import DecoderParams, EncoderParams, QuantStyle
from ..models import fused_encode
from ..ops import _build
from ..utils.device import DeviceLike, resolve_device
from . import decoder as _decoder
from . import markers
from .encoder import (block_coder, build_cod, build_siz,
                      extract_tile_comps, plan_encoder)
from .markers import SotInfo
from .tile import default_qcd, encode_tile


class StreamEncoder:
    """Incremental tile-by-tile encoder writing to a seekable stream.

    `image_spec` supplies the image geometry (sizes, component
    precisions/subsampling); its component data is not read. Tiles must
    be written in raster order, like the reference's grk_write_tile.
    Each tile is coded on `device` (CUDA by default; "cpu" runs the
    kernels' plain versions)."""

    def __init__(self, f, image_spec: Image,
                 params: Optional[EncoderParams] = None,
                 device: DeviceLike = "cuda"):
        self.device = resolve_device(device)
        self.params = params or EncoderParams()
        p = self.params
        if p.rates or p.quality_psnr or p.ppm_markers or \
                p.custom_mct is not None:
            raise ValueError("streaming encode does not support whole-image "
                             "rate control, PPM, or custom MCT")
        _build.host_library()
        if isinstance(f, str):
            f = open(f, "wb")
            self._owns = True
        else:
            self._owns = False
        self.f = f
        self.is_ht = bool(p.cblk_style & 0x40)
        self.siz = build_siz(image_spec, p)
        self.cod = build_cod(image_spec, p)
        guard = 1 if self.is_ht else p.num_guard_bits
        self.qcd = default_qcd(self.siz, self.cod, guard, p.base_step)
        if self.is_ht:
            self.siz = dataclasses.replace(
                self.siz, rsiz=self.siz.rsiz | markers.JPH_RSIZ_FLAG)
        ntx, nty = tile_grid_size(self.siz.xsiz, self.siz.ysiz,
                                  self.siz.xosiz, self.siz.yosiz,
                                  self.siz.xtsiz, self.siz.ytsiz,
                                  self.siz.xtosiz, self.siz.ytosiz)
        self.numtiles = ntx * nty
        self._next_tile = 0
        self._tp_lengths: List[int] = [0] * self.numtiles
        self._closed = False
        self._encoders: Dict[fused_encode.FusedPlan, object] = {}

        out = bytearray()
        out += markers.write_soc()
        out += markers.write_siz(self.siz)
        if self.is_ht:
            reversible = self.qcd.style == QuantStyle.NONE
            if self.qcd.style == QuantStyle.NONE:
                max_mb = max(e + self.qcd.num_guard_bits - 1
                             for e in self.qcd.exponents)
            else:
                max_mb = max(e + self.qcd.num_guard_bits - 1
                             for (e, m) in self.qcd.steps)
            out += markers.write_cap(reversible, max_mb)
        out += markers.write_cod(self.cod)
        out += markers.write_qcd(self.qcd)
        if p.comment:
            out += markers.write_com(p.comment)
        self.f.write(bytes(out))
        # Always reserve a TLM segment (the codestream's seek index);
        # patched with real lengths on close (reference: j2k.cpp TLM
        # update at 2556/6649).
        self._tlm_offset = self.f.tell()
        self.f.write(markers.write_tlm(
            [(t, 0) for t in range(self.numtiles)]))

    def encoder_for(self, tr: Rect):
        """The fused encoder of the tile at `tr`: its plan built, the
        encoder shared by every tile of that plan (`encoder.plan_encoder`,
        as `encoder.encode` shares them)."""
        return plan_encoder(fused_encode.build_plan(
            self.siz, self.cod, self.qcd, tr, coder=block_coder(self.params)),
            self.device, self._encoders)

    def write_tile(self, tile_index: int,
                   comp_arrays: List[np.ndarray]) -> int:
        """Encode and append one tile; returns the tile-part length."""
        if self._closed:
            raise ValueError("stream is closed")
        if tile_index != self._next_tile:
            raise ValueError(
                f"tiles must be written in order (expected "
                f"{self._next_tile}, got {tile_index})")
        tr = tile_rect(tile_index, self.siz.xsiz, self.siz.ysiz,
                       self.siz.xosiz, self.siz.yosiz, self.siz.xtsiz,
                       self.siz.ytsiz, self.siz.xtosiz, self.siz.ytosiz)
        p = self.params
        (segs,) = fused_encode.encode_tile_collect(
            fused_encode.encode_tile_submit(comp_arrays, self.encoder_for(tr)))
        res = encode_tile(segs, self.siz, self.cod, self.qcd, tr,
                          split_headers=p.ppt_markers,
                          want_packet_lengths=p.plt_markers)
        tp_hdr = b""
        if p.ppt_markers:
            tp_hdr += markers.write_ppt(res.packet_headers or b"")
        if p.plt_markers and res.packet_lengths is not None:
            tp_hdr += markers.write_plt(res.packet_lengths)
        psot = 12 + len(tp_hdr) + 2 + len(res.body)
        self.f.write(markers.write_sot(SotInfo(tile_index=tile_index,
                                               psot=psot)))
        self.f.write(tp_hdr)
        self.f.write(markers.write_sod())
        self.f.write(res.body)
        self._tp_lengths[tile_index] = psot
        self._next_tile += 1
        return psot

    def write_image_tile(self, tile_index: int, image: Image) -> int:
        """Convenience: extract the tile's samples from a full Image."""
        comps = extract_tile_comps(image, self.siz, tile_index)
        return self.write_tile(tile_index, comps)

    def close(self) -> None:
        if self._closed:
            return
        if self._next_tile != self.numtiles:
            raise ValueError(
                f"only {self._next_tile} of {self.numtiles} tiles written")
        self.f.write(markers.write_eoc())
        if self._tlm_offset is not None:
            end = self.f.tell()
            self.f.seek(self._tlm_offset)
            self.f.write(markers.write_tlm(
                list(enumerate(self._tp_lengths))))
            self.f.seek(end)
        self.f.flush()
        if self._owns:
            self.f.close()
        self._closed = True

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        if exc[0] is None:
            self.close()
        return False


class StreamDecoder:
    """Random-access tile decoder over a file handle or memory map.

    Only the main header is read eagerly. Tile byte ranges come from the
    TLM marker when present, else from one cheap SOT-hopping scan (the
    cstr_index analog); decoding tile t reads just its bytes and decodes
    them on `device` (`decoder.decode`)."""

    def __init__(self, f, use_mmap: bool = True,
                 device: DeviceLike = "cuda"):
        self.device = resolve_device(device)
        if isinstance(f, str):
            self.f = open(f, "rb")
            self._owns = True
        else:
            self.f = f
            self._owns = False
        self._mm = None
        if use_mmap:
            try:
                self._mm = _mmap.mmap(self.f.fileno(), 0,
                                      access=_mmap.ACCESS_READ)
            except (ValueError, OSError, io.UnsupportedOperation):
                self._mm = None
        # Read enough for the main header (grow until it parses).
        size = 1 << 16
        while True:
            head = self._read(0, size)
            try:
                self.header = _decoder.read_header(bytes(head))
                break
            except (ValueError, struct.error, IndexError):
                if len(head) < size:
                    raise
                size *= 2
        siz = self.header.siz
        ntx, nty = tile_grid_size(siz.xsiz, siz.ysiz, siz.xosiz, siz.yosiz,
                                  siz.xtsiz, siz.ytsiz, siz.xtosiz,
                                  siz.ytosiz)
        self.numtiles = ntx * nty
        self._index: Dict[int, List[tuple]] = {}
        self._build_index()

    def _read(self, off: int, n: int) -> bytes:
        if self._mm is not None:
            return self._mm[off:off + n]
        self.f.seek(off)
        return self.f.read(n)

    def _file_size(self) -> int:
        if self._mm is not None:
            return len(self._mm)
        self.f.seek(0, 2)
        return self.f.tell()

    def _build_index(self) -> None:
        """Tile index: (offset, length) per tile-part, keyed by tile."""
        pos = self.header.main_header_end
        end = self._file_size()
        if self.header.tlm:
            for (t, ln) in self.header.tlm:
                if ln <= 0:
                    continue
                self._index.setdefault(t, []).append((pos, ln))
                pos += ln
            if self._index:
                return
        # Scan SOT chain reading only 12-byte SOT headers.
        while pos + 12 <= end:
            hdr = self._read(pos, 12)
            marker = struct.unpack(">H", hdr[0:2])[0]
            if marker == markers.EOC:
                break
            if marker != markers.SOT:
                ln = struct.unpack(">H", hdr[2:4])[0]
                pos += 2 + ln
                continue
            sot = markers.parse_sot(hdr[4:12])
            psot = sot.psot if sot.psot else end - pos
            self._index.setdefault(sot.tile_index, []).append((pos, psot))
            pos += psot

    def tile_parts(self, t: int) -> List[tuple]:
        return self._index.get(t, [])

    def decode_tile(self, t: int, params: Optional[DecoderParams] = None
                    ) -> Image:
        """Decode one tile, reading only its byte ranges. Returns an
        Image covering the tile's canvas area."""
        if t not in self._index:
            raise ValueError(f"tile {t} not present in codestream")
        params = params or DecoderParams()
        siz = self.header.siz
        tr = tile_rect(t, siz.xsiz, siz.ysiz, siz.xosiz, siz.yosiz,
                       siz.xtsiz, siz.ytsiz, siz.xtosiz, siz.ytosiz)
        win = params.window
        if win is None:
            win = (tr.x0, tr.y0, tr.x1, tr.y1)
        # Assemble a minimal codestream: main header + this tile's parts.
        mini = bytearray(self._read(0, self.header.main_header_end))
        for (off, ln) in self._index[t]:
            mini += self._read(off, ln)
        mini += markers.write_eoc()
        p = dataclasses.replace(params, tile_index=t, window=win)
        return _decoder.decode(bytes(mini), p, self.device)

    def decode(self, params: Optional[DecoderParams] = None) -> Image:
        """Decode the full image."""
        data = self._read(0, self._file_size())
        return _decoder.decode(bytes(data), params, self.device)

    def close(self) -> None:
        if self._mm is not None:
            self._mm.close()
            self._mm = None
        if self._owns:
            self.f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False
