"""TGA reader/writer (reference: src/bin/jp2/TGAFormat.cpp).

Supported: type 2 (uncompressed true-color 24/32bpp), type 3
(uncompressed grayscale), and their RLE variants 10/11 on read.
Writer emits uncompressed type 2/3, bottom-up like the reference.

A copy of `grokimagecompression_tpu/io/tga.py`, as it is.
"""

from __future__ import annotations

import struct

import numpy as np

from ..core.image import Component, Image


def _rle_decode(data: bytes, npixels: int, bytespp: int) -> bytes:
    out = bytearray()
    pos = 0
    want = npixels * bytespp
    while len(out) < want and pos < len(data):
        hdr = data[pos]
        pos += 1
        count = (hdr & 0x7F) + 1
        if hdr & 0x80:  # run packet
            px = data[pos:pos + bytespp]
            pos += bytespp
            out += px * count
        else:           # raw packet
            out += data[pos:pos + count * bytespp]
            pos += count * bytespp
    return bytes(out[:want])


def read_tga(path: str) -> Image:
    with open(path, "rb") as f:
        data = f.read()
    if len(data) < 18:
        raise ValueError("not a TGA file")
    (id_len, cmap_type, img_type, _cmap_first, _cmap_len, _cmap_entry,
     _x0, _y0, w, h, bpp, desc) = struct.unpack("<BBBHHBHHHHBB", data[:18])
    if cmap_type != 0:
        raise ValueError("TGA color-mapped images not supported")
    if img_type not in (2, 3, 10, 11):
        raise ValueError(f"unsupported TGA image type {img_type}")
    pos = 18 + id_len
    bytespp = bpp // 8
    if img_type in (10, 11):
        px = _rle_decode(data[pos:], w * h, bytespp)
    else:
        px = data[pos:pos + w * h * bytespp]
    if len(px) < w * h * bytespp:
        raise ValueError("TGA: truncated pixel data")
    a = np.frombuffer(px, np.uint8).reshape(h, w, bytespp)
    if not (desc & 0x20):  # origin at bottom-left -> flip
        a = a[::-1]
    if img_type in (3, 11) or bytespp == 1:
        comps = [Component(data=a[:, :, 0].astype(np.int32), prec=8,
                           signed=False, dx=1, dy=1)]
    else:
        # BGR(A) order in the file
        order = [2, 1, 0] + ([3] if bytespp == 4 else [])
        comps = [Component(data=a[:, :, i].astype(np.int32), prec=8,
                           signed=False, dx=1, dy=1, alpha=i == 3)
                 for i in order]
    return Image(xsiz=w, ysiz=h, components=comps)


def write_tga(path: str, image: Image) -> None:
    n = len(image.components)
    w, h = image.xsiz, image.ysiz
    if any(c.prec > 8 for c in image.components):
        raise ValueError("TGA supports 8-bit samples")
    planes = [np.clip(np.asarray(c.data), 0, 255).astype(np.uint8)
              for c in image.components]
    if n == 1:
        img_type, bpp = 3, 8
        px = planes[0][::-1]  # bottom-up
        body = px.tobytes()
    elif n in (3, 4):
        img_type, bpp = 2, 8 * n
        order = [2, 1, 0] + ([3] if n == 4 else [])
        stack = np.stack([planes[i] for i in order], axis=-1)
        body = stack[::-1].tobytes()
    else:
        raise ValueError("TGA supports 1, 3 or 4 components")
    alpha_bits = 8 if n == 4 else 0
    hdr = struct.pack("<BBBHHBHHHHBB", 0, 0, img_type, 0, 0, 0, 0, 0,
                      w, h, bpp, alpha_bits)
    with open(path, "wb") as f:
        f.write(hdr + body)
