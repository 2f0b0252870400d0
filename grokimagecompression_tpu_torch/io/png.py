"""PNG reader/writer, pure Python + zlib (no libpng), the analog of the
reference PNG codec (reference: src/bin/jp2/PNGFormat.cpp, which uses the
vendored libpng).

Supported: color types 0 (gray), 2 (RGB), 3 (palette), 4 (gray+alpha),
6 (RGBA); bit depths 1/2/4/8/16; all five scanline filters; Adam7
interlacing on read. Writer emits non-interlaced with a fixed filter
(Paeth by default) chosen via the native helper.

A copy of `grokimagecompression_tpu/io/png.py` whose scanline filters
run only in the port's host library (`native/imgio.py`, built from
`csrc/host/imgio.cpp`): where the reference falls back to a numpy
unfilter and to unfiltered rows (other bytes than the default Paeth
filter's) without its native library, the port raises.
"""

from __future__ import annotations

import struct
import zlib
from typing import List, Optional

import numpy as np

from ..core.image import Component, Image
from ..native import imgio

_SIG = b"\x89PNG\r\n\x1a\n"

# Adam7 pass geometry: (x_start, y_start, x_step, y_step)
_ADAM7 = [(0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
          (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2)]


def _chunk(tag: bytes, payload: bytes) -> bytes:
    return (struct.pack(">I", len(payload)) + tag + payload
            + struct.pack(">I", zlib.crc32(tag + payload) & 0xFFFFFFFF))


def _channels(color_type: int) -> int:
    return {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[color_type]


def _unfilter(raw: bytes, w: int, h: int, channels: int,
              bitdepth: int) -> np.ndarray:
    """Reconstruct h x rowbytes bytes from filtered scanlines."""
    bits_pp = channels * bitdepth
    rowbytes = (w * bits_pp + 7) // 8
    bpp = max(1, bits_pp // 8)
    expect = h * (rowbytes + 1)
    rows = np.frombuffer(raw, dtype=np.uint8)
    if len(rows) < expect:
        raise ValueError("PNG: truncated image data")
    return imgio.png_unfilter(rows[:expect], h, rowbytes, bpp)


def _unpack_bits(rowdata: np.ndarray, w: int, channels: int,
                 bitdepth: int) -> np.ndarray:
    """(h, rowbytes) bytes -> (h, w, channels) ints."""
    h = rowdata.shape[0]
    if bitdepth == 8:
        return rowdata[:, :w * channels].reshape(h, w, channels).astype(
            np.int32)
    if bitdepth == 16:
        a = rowdata[:, :w * channels * 2].reshape(h, w * channels, 2)
        v = (a[:, :, 0].astype(np.int32) << 8) | a[:, :, 1]
        return v.reshape(h, w, channels)
    # 1/2/4-bit packed, single channel only (gray / palette)
    per_byte = 8 // bitdepth
    shifts = np.arange(per_byte - 1, -1, -1) * bitdepth
    mask = (1 << bitdepth) - 1
    exp = (rowdata[:, :, None].astype(np.int32) >> shifts) & mask
    exp = exp.reshape(h, -1)[:, :w]
    return exp.reshape(h, w, 1)


def read_png(path: str) -> Image:
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != _SIG:
        raise ValueError("not a PNG file")
    pos = 8
    ihdr = None
    palette: Optional[np.ndarray] = None
    trns: Optional[bytes] = None
    idat: List[bytes] = []
    while pos + 8 <= len(data):
        ln, tag = struct.unpack(">I4s", data[pos:pos + 8])
        payload = data[pos + 8:pos + 8 + ln]
        pos += 12 + ln
        if tag == b"IHDR":
            ihdr = struct.unpack(">IIBBBBB", payload)
        elif tag == b"PLTE":
            palette = np.frombuffer(payload, np.uint8).reshape(-1, 3)
        elif tag == b"tRNS":
            trns = payload
        elif tag == b"IDAT":
            idat.append(payload)
        elif tag == b"IEND":
            break
    if ihdr is None:
        raise ValueError("PNG: missing IHDR")
    w, h, bitdepth, color_type, comp, filt, interlace = ihdr
    if comp != 0 or filt != 0:
        raise ValueError("PNG: unsupported compression/filter method")
    channels = _channels(color_type)
    raw = zlib.decompress(b"".join(idat))

    if interlace == 0:
        px = _unpack_bits(_unfilter(raw, w, h, channels, bitdepth), w,
                          channels, bitdepth)
    elif interlace == 1:
        px = np.zeros((h, w, channels), dtype=np.int32)
        off = 0
        for (x0, y0, dx, dy) in _ADAM7:
            pw = (w - x0 + dx - 1) // dx
            ph = (h - y0 + dy - 1) // dy
            if pw == 0 or ph == 0:
                continue
            bits_pp = channels * bitdepth
            prb = (pw * bits_pp + 7) // 8
            nbytes = ph * (prb + 1)
            sub = _unpack_bits(
                _unfilter(raw[off:off + nbytes], pw, ph, channels,
                          bitdepth), pw, channels, bitdepth)
            px[y0::dy, x0::dx] = sub
            off += nbytes
        raw = b""
    else:
        raise ValueError("PNG: unknown interlace method")

    prec = bitdepth
    if color_type == 3:
        if palette is None:
            raise ValueError("PNG: palette image without PLTE")
        idx = px[:, :, 0]
        rgb = palette[np.clip(idx, 0, len(palette) - 1)]
        comps = [Component(data=rgb[:, :, c].astype(np.int32), prec=8,
                           signed=False, dx=1, dy=1) for c in range(3)]
        if trns is not None:
            alpha_lut = np.full(len(palette), 255, np.int32)
            alpha_lut[:len(trns)] = np.frombuffer(trns, np.uint8)
            comps.append(Component(data=alpha_lut[np.clip(
                idx, 0, len(palette) - 1)].astype(np.int32), prec=8,
                signed=False, dx=1, dy=1, alpha=True))
        return Image(xsiz=w, ysiz=h, components=comps)
    has_alpha = color_type in (4, 6)
    comps = [Component(data=np.ascontiguousarray(px[:, :, c]), prec=prec,
                       signed=False, dx=1, dy=1,
                       alpha=has_alpha and c == channels - 1)
             for c in range(channels)]
    return Image(xsiz=w, ysiz=h, components=comps)


def write_png(path: str, image: Image, filter_type: int = 4,
              level: int = 6) -> None:
    n = len(image.components)
    prec = max(c.prec for c in image.components)
    if prec > 16:
        raise ValueError("PNG supports at most 16-bit samples")
    bitdepth = 16 if prec > 8 else 8
    color_type = {1: 0, 2: 4, 3: 2, 4: 6}.get(n)
    if color_type is None:
        raise ValueError("PNG supports 1-4 components")
    w, h = image.xsiz, image.ysiz
    planes = []
    for c in image.components:
        a = np.asarray(c.data)
        if c.signed:
            a = a + (1 << (c.prec - 1))
        if c.prec < bitdepth:  # scale up to container depth
            a = a << (bitdepth - c.prec)
        planes.append(a)
    stack = np.stack(planes, axis=-1)
    if bitdepth == 8:
        img_bytes = stack.astype(np.uint8)
    else:
        v = stack.astype(np.uint16)
        img_bytes = np.empty(stack.shape + (2,), np.uint8)
        img_bytes[..., 0] = v >> 8
        img_bytes[..., 1] = v & 0xFF
    flat = np.ascontiguousarray(img_bytes).reshape(h, -1)
    rowbytes = flat.shape[1]
    bpp = n * (bitdepth // 8)
    filtered = imgio.png_filter(flat, bpp, filter_type)
    out = bytearray(_SIG)
    out += _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, bitdepth,
                                       color_type, 0, 0, 0))
    out += _chunk(b"IDAT", zlib.compress(bytes(filtered), level))
    out += _chunk(b"IEND", b"")
    with open(path, "wb") as f:
        f.write(bytes(out))
