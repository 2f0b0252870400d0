"""RAW planar reader/writer (reference: src/bin/jp2/RAWFormat.cpp).

Layout matches the reference: components stored planar in file order,
8-bit or 16-bit samples, signed or unsigned, `.raw` = big endian,
`.rawl` = little endian; per-component subsampling shrinks a plane to
ceil(w/dx) x ceil(h/dy) samples.

A copy of `grokimagecompression_tpu/io/raw.py`, as it is.
"""

from __future__ import annotations

import dataclasses
from typing import List

import numpy as np

from ..core.image import Component, Image


@dataclasses.dataclass
class RawDesc:
    """The -F image description: w,h,ncomps,prec,[s|u]@dxxdy,..."""
    width: int
    height: int
    ncomps: int
    prec: int
    signed: bool
    subsampling: List[tuple]  # per comp (dx, dy)

    @classmethod
    def parse(cls, s: str) -> "RawDesc":
        """Parse the reference -F syntax: `w,h,ncomp,prec,[s,u]` with
        optional `@dx1xdy1:...:dxNxdyN` subsampling suffix."""
        sub = None
        if "@" in s:
            s, subs = s.split("@", 1)
            sub = [tuple(int(v) for v in p.split("x"))
                   for p in subs.split(":")]
        parts = s.split(",")
        if len(parts) < 5:
            raise ValueError(
                "raw description must be w,h,ncomps,prec,[s|u][@dxxdy...]")
        w, h, n, prec = (int(v) for v in parts[:4])
        signed = parts[4].strip().lower() == "s"
        if sub is None:
            sub = [(1, 1)] * n
        if len(sub) < n:
            sub = sub + [sub[-1]] * (n - len(sub))
        return cls(width=w, height=h, ncomps=n, prec=prec, signed=signed,
                   subsampling=sub[:n])


def read_raw(path: str, desc: RawDesc, big_endian: bool = True) -> Image:
    if desc.prec <= 8:
        dt = np.dtype(np.int8 if desc.signed else np.uint8)
    elif desc.prec <= 16:
        base = np.int16 if desc.signed else np.uint16
        dt = np.dtype(base).newbyteorder(">" if big_endian else "<")
    else:
        raise ValueError("raw supports precision up to 16 bits")
    data = np.fromfile(path, dtype=dt)
    comps = []
    off = 0
    for c in range(desc.ncomps):
        dx, dy = desc.subsampling[c]
        cw = (desc.width + dx - 1) // dx
        ch = (desc.height + dy - 1) // dy
        nsamp = cw * ch
        if off + nsamp > data.size:
            raise ValueError("raw file too short for described image")
        plane = data[off:off + nsamp].astype(np.int32).reshape(ch, cw)
        off += nsamp
        comps.append(Component(data=plane, prec=desc.prec,
                               signed=desc.signed, dx=dx, dy=dy))
    return Image(xsiz=desc.width, ysiz=desc.height, components=comps)


def write_raw(path: str, image: Image, big_endian: bool = True) -> None:
    out = bytearray()
    for c in image.components:
        if c.prec <= 8:
            dt = np.dtype(np.int8 if c.signed else np.uint8)
        elif c.prec <= 16:
            base = np.int16 if c.signed else np.uint16
            dt = np.dtype(base).newbyteorder(">" if big_endian else "<")
        else:
            raise ValueError("raw supports precision up to 16 bits")
        out += np.ascontiguousarray(c.data).astype(dt).tobytes()
    with open(path, "wb") as f:
        f.write(bytes(out))
