"""BMP reader/writer (uncompressed 8-bit grayscale / 24-bit BGR), analog of
the reference BMP codec (reference: src/bin/jp2/BMPFormat.cpp) for the
common cases.

A copy of `grokimagecompression_tpu/io/bmp.py`, as it is.
"""

from __future__ import annotations

import struct

import numpy as np

from ..core.image import Component, Image


def read_bmp(path: str) -> Image:
    with open(path, "rb") as f:
        data = f.read()
    if data[:2] != b"BM":
        raise ValueError("not a BMP file")
    data_offset = struct.unpack("<I", data[10:14])[0]
    hdr_size = struct.unpack("<I", data[14:18])[0]
    if hdr_size < 40:
        raise ValueError("unsupported BMP header")
    w, h = struct.unpack("<ii", data[18:26])
    planes, bpp = struct.unpack("<HH", data[26:30])
    compression = struct.unpack("<I", data[30:34])[0]
    if compression != 0:
        raise ValueError(f"unsupported BMP compression {compression}")
    flip = h > 0
    h = abs(h)
    row_bytes = (w * bpp // 8 + 3) & ~3
    px = data[data_offset:data_offset + row_bytes * h]
    rows = np.frombuffer(px, dtype=np.uint8).reshape(h, row_bytes)
    if flip:
        rows = rows[::-1]
    if bpp == 8:
        gray = rows[:, :w].astype(np.int32)
        return Image(xsiz=w, ysiz=h, components=[
            Component(data=gray, prec=8, signed=False, dx=1, dy=1)])
    if bpp == 24:
        bgr = rows[:, :w * 3].reshape(h, w, 3).astype(np.int32)
        comps = [
            Component(data=np.ascontiguousarray(bgr[:, :, 2 - c]),
                      prec=8, signed=False, dx=1, dy=1)
            for c in range(3)
        ]
        return Image(xsiz=w, ysiz=h, components=comps)
    raise ValueError(f"unsupported BMP bpp {bpp}")


def write_bmp(path: str, image: Image) -> None:
    ncomp = len(image.components)
    c0 = image.components[0].data
    h, w = c0.shape
    if ncomp >= 3:
        bpp = 24
        row_bytes = (w * 3 + 3) & ~3
        rows = np.zeros((h, row_bytes), dtype=np.uint8)
        for c in range(3):
            rows[:, c:w * 3:3] = np.clip(
                image.components[2 - c].data, 0, 255).astype(np.uint8)
    else:
        bpp = 8
        row_bytes = (w + 3) & ~3
        rows = np.zeros((h, row_bytes), dtype=np.uint8)
        rows[:, :w] = np.clip(c0, 0, 255).astype(np.uint8)
    palette = b""
    if bpp == 8:
        palette = b"".join(struct.pack("<BBBB", i, i, i, 0)
                           for i in range(256))
    data_offset = 14 + 40 + len(palette)
    img_bytes = rows[::-1].tobytes()  # bottom-up
    with open(path, "wb") as f:
        f.write(b"BM")
        f.write(struct.pack("<IHHI", data_offset + len(img_bytes), 0, 0,
                            data_offset))
        f.write(struct.pack("<IiiHHIIiiII", 40, w, h, 1, bpp, 0,
                            len(img_bytes), 2835, 2835,
                            256 if bpp == 8 else 0, 0))
        f.write(palette)
        f.write(img_bytes)
