"""PNM (PGM/PPM/PAM) image file I/O — analog of the reference PNMFormat
(reference: src/bin/jp2/PNMFormat.cpp). Binary (P5/P6) variants, 8- and
16-bit (big-endian per the PNM spec).

A copy of `grokimagecompression_tpu/io/pnm.py`, as it is.
"""

from __future__ import annotations

from typing import List

import numpy as np

from ..core.image import Component, Image, make_image


def _read_tokens(data: bytes, count: int, start: int):
    vals = []
    j = start
    while len(vals) < count:
        while j < len(data) and data[j:j + 1].isspace():
            j += 1
        if data[j:j + 1] == b"#":
            while j < len(data) and data[j:j + 1] != b"\n":
                j += 1
            continue
        k = j
        while k < len(data) and not data[k:k + 1].isspace():
            k += 1
        vals.append(int(data[j:k]))
        j = k
    return vals, j + 1  # skip single whitespace after header


def read_pnm(path: str) -> Image:
    with open(path, "rb") as f:
        data = f.read()
    magic = data[:2]
    if magic == b"P5":
        ncomp = 1
    elif magic == b"P6":
        ncomp = 3
    else:
        raise ValueError(f"unsupported PNM magic {magic!r}")
    (w, h, maxval), off = _read_tokens(data, 3, 2)
    prec = maxval.bit_length()
    if maxval > 255:
        raw = np.frombuffer(data[off:off + w * h * ncomp * 2], dtype=">u2")
    else:
        raw = np.frombuffer(data[off:off + w * h * ncomp], dtype=np.uint8)
    raw = raw.astype(np.int32).reshape(h, w, ncomp)
    comps = [raw[:, :, i] for i in range(ncomp)]
    return make_image(comps, prec=prec)


def write_pnm(path: str, image: Image) -> None:
    n = image.numcomps
    prec = image.components[0].prec
    maxval = (1 << prec) - 1
    h, w = image.components[0].data.shape
    if n == 1:
        header = f"P5\n{w} {h}\n{maxval}\n".encode()
    elif n == 3:
        header = f"P6\n{w} {h}\n{maxval}\n".encode()
    else:
        raise ValueError(f"PNM supports 1 or 3 components, got {n}")
    planes = np.stack([c.data for c in image.components], axis=-1)
    planes = np.clip(planes, 0, maxval)
    if maxval > 255:
        body = planes.astype(">u2").tobytes()
    else:
        body = planes.astype(np.uint8).tobytes()
    with open(path, "wb") as f:
        f.write(header)
        f.write(body)
