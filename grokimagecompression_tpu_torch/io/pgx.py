"""PGX image I/O — the JPEG 2000 conformance-test raw format
(analog of reference src/bin/jp2/PGXFormat.cpp).

Header line: "PG <endian ML|LM> [+|-]<prec> <width> <height>" followed by
raw samples (one component per file).

A copy of `grokimagecompression_tpu/io/pgx.py`, as it is.
"""

from __future__ import annotations

import re

import numpy as np

from ..core.image import Image, make_image


def read_pgx(path: str) -> Image:
    with open(path, "rb") as f:
        data = f.read()
    nl = data.index(b"\n")
    header = data[:nl].decode("latin-1").strip()
    m = re.match(r"PG\s+(ML|LM)\s*([+-]?)\s*(\d+)\s+(\d+)\s+(\d+)", header)
    if not m:
        raise ValueError(f"bad PGX header: {header!r}")
    endian, sign, prec, w, h = (m.group(1), m.group(2), int(m.group(3)),
                                int(m.group(4)), int(m.group(5)))
    signed = sign == "-"
    nbytes = 1 if prec <= 8 else (2 if prec <= 16 else 4)
    be = endian == "ML"
    if nbytes == 1:
        dt = np.int8 if signed else np.uint8
    elif nbytes == 2:
        dt = (">i2" if be else "<i2") if signed else (">u2" if be else "<u2")
    else:
        dt = (">i4" if be else "<i4") if signed else (">u4" if be else "<u4")
    raw = np.frombuffer(data[nl + 1:nl + 1 + w * h * nbytes], dtype=dt)
    arr = raw.astype(np.int32).reshape(h, w)
    return make_image([arr], prec=prec, signed=signed)


def write_pgx(path: str, image: Image, compno: int = 0) -> None:
    comp = image.components[compno]
    prec = comp.prec
    signed = comp.signed
    h, w = comp.data.shape
    header = f"PG ML {'-' if signed else '+'}{prec} {w} {h}\n".encode()
    nbytes = 1 if prec <= 8 else (2 if prec <= 16 else 4)
    if nbytes == 1:
        dt = np.int8 if signed else np.uint8
    elif nbytes == 2:
        dt = ">i2" if signed else ">u2"
    else:
        dt = ">i4" if signed else ">u4"
    with open(path, "wb") as f:
        f.write(header)
        f.write(comp.data.astype(dt).tobytes())
