"""TIFF reader/writer, pure Python (no libtiff), the analog of the
reference TIFF codec (reference: src/bin/jp2/TIFFFormat.cpp, which
vendors libtiff from thirdparty/libtiff).

Read: uncompressed (1), LZW (5) with the TIFF early-change variant,
deflate (8/32946), PackBits (32773); horizontal-differencing predictor
(tag 317, value 2); little/big endian; 8/16-bit (1-bit bilevel for
striped baseline); gray/RGB(A), chunky or planar; STRIPED or TILED
(tags 322-325) layouts. Write: uncompressed or deflate, chunky,
little-endian, one strip.

A copy of `grokimagecompression_tpu/io/tiff.py` with one repair: the
first LZW code after a CLEAR is checked against the table, so a corrupt
stream raises ValueError("corrupt LZW stream") there too (the reference
raises IndexError).
"""

from __future__ import annotations

import struct
from typing import Dict, List, Tuple

import numpy as np

from ..core.image import Component, Image

# tag ids
_W, _H = 256, 257
_BPS, _COMPRESSION, _PHOTO = 258, 259, 262
_STRIP_OFF, _SPP, _ROWS_PER_STRIP, _STRIP_CNT = 273, 277, 278, 279
_PLANAR, _SAMPLE_FMT = 284, 339
_PREDICTOR = 317
_TILE_W, _TILE_L, _TILE_OFF, _TILE_CNT = 322, 323, 324, 325

_TYPE_SIZE = {1: 1, 2: 1, 3: 2, 4: 4, 5: 8, 6: 1, 7: 1, 8: 2, 9: 4,
              10: 8, 11: 4, 12: 8}


def _read_ifd(data: bytes, off: int, e: str) -> Dict[int, List[int]]:
    count = struct.unpack(e + "H", data[off:off + 2])[0]
    tags: Dict[int, List[int]] = {}
    for i in range(count):
        p = off + 2 + i * 12
        tag, typ, n = struct.unpack(e + "HHI", data[p:p + 8])
        size = _TYPE_SIZE.get(typ, 1) * n
        if size <= 4:
            payload = data[p + 8:p + 8 + size]
        else:
            voff = struct.unpack(e + "I", data[p + 8:p + 12])[0]
            payload = data[voff:voff + size]
        if typ in (1, 6, 7, 2):
            vals = list(payload)
        elif typ in (3, 8):
            vals = list(struct.unpack(e + f"{n}H", payload[:2 * n]))
        elif typ in (4, 9):
            vals = list(struct.unpack(e + f"{n}I", payload[:4 * n]))
        elif typ == 5:
            raw = struct.unpack(e + f"{2 * n}I", payload[:8 * n])
            vals = [raw[2 * k] // max(1, raw[2 * k + 1]) for k in range(n)]
        else:
            vals = []
        tags[tag] = vals
    return tags


def _packbits(data: bytes, want: int) -> bytes:
    out = bytearray()
    pos = 0
    while len(out) < want and pos < len(data):
        nv = data[pos]
        n = nv - 256 if nv > 127 else nv
        pos += 1
        if n >= 0:
            out += data[pos:pos + n + 1]
            pos += n + 1
        elif n != -128:
            out += data[pos:pos + 1] * (1 - n)
            pos += 1
    return bytes(out[:want])


def _lzw_decode(data: bytes, want: int) -> bytes:
    """TIFF-variant LZW (MSB-first codes, early code-width change at
    table size 2^width - 1) — the compression libtiff calls
    COMPRESSION_LZW (reference TIFFFormat.cpp reads it via libtiff)."""
    out = bytearray()
    bitpos = 0
    nbits = len(data) * 8
    buf = data + b"\0\0\0\0"
    CLEAR, EOI = 256, 257
    table: List[bytes] = []
    width = 9
    prev = b""
    have_prev = False
    while len(out) < want and bitpos + width <= nbits:
        byte0 = bitpos >> 3
        val = int.from_bytes(buf[byte0:byte0 + 4], "big")
        code = (val >> (32 - (bitpos & 7) - width)) & ((1 << width) - 1)
        bitpos += width
        if code == EOI:
            break
        if code == CLEAR:
            table = [bytes([i]) for i in range(256)] + [b"", b""]
            width = 9
            have_prev = False
            continue
        if not table:
            raise ValueError("LZW stream missing initial clear code")
        if not have_prev:
            if code >= len(table):
                raise ValueError("corrupt LZW stream")
            entry = table[code]
        elif code < len(table):
            entry = table[code]
            table.append(prev + entry[:1])
        elif code == len(table):
            entry = prev + prev[:1]
            table.append(entry)
        else:
            raise ValueError("corrupt LZW stream")
        out += entry
        prev = entry
        have_prev = True
        if len(table) >= (1 << width) - 1 and width < 12:
            width += 1
    return bytes(out[:want])


def _decompress(chunk: bytes, compression: int, want: int) -> bytes:
    if compression in (8, 32946):
        import zlib
        return zlib.decompress(chunk)[:want]
    if compression == 5:
        return _lzw_decode(chunk, want)
    if compression == 32773:
        return _packbits(chunk, want)
    return chunk[:want]


def _undo_predictor(a: np.ndarray) -> np.ndarray:
    """Horizontal differencing (predictor 2): cumulative sum along the
    row axis per interleaved channel; a is (rows, cols, channels)."""
    return np.cumsum(a.astype(np.int64), axis=1).astype(a.dtype)


def read_tiff(path: str) -> Image:
    with open(path, "rb") as f:
        data = f.read()
    if data[:2] == b"II":
        e = "<"
    elif data[:2] == b"MM":
        e = ">"
    else:
        raise ValueError("not a TIFF file")
    magic, ifd_off = struct.unpack(e + "HI", data[2:8])
    if magic != 42:
        raise ValueError("not a TIFF file")
    tags = _read_ifd(data, ifd_off, e)
    w = tags[_W][0]
    h = tags[_H][0]
    spp = tags.get(_SPP, [1])[0]
    bps_list = tags.get(_BPS, [1])
    bps = bps_list[0]
    compression = tags.get(_COMPRESSION, [1])[0]
    planar = tags.get(_PLANAR, [1])[0]
    sample_fmt = tags.get(_SAMPLE_FMT, [1])[0]
    predictor = tags.get(_PREDICTOR, [1])[0]
    signed = sample_fmt == 2
    if compression not in (1, 5, 8, 32773, 32946):
        raise ValueError(f"unsupported TIFF compression {compression}")
    if predictor not in (1, 2):
        raise ValueError(f"unsupported TIFF predictor {predictor}")
    if bps not in (1, 8, 16):
        raise ValueError(f"unsupported TIFF bit depth {bps}")
    tiled = _TILE_OFF in tags

    if bps == 1:
        if tiled:
            raise ValueError("tiled bilevel TIFF unsupported")
        offs = tags[_STRIP_OFF]
        cnts = tags.get(_STRIP_CNT, [len(data) - offs[0]])
        rows_per_strip = tags.get(_ROWS_PER_STRIP, [h])[0] or h
        rowb = (w + 7) // 8
        buf = bytearray()
        for i, o in enumerate(offs):
            rows = min(rows_per_strip, h - i * rows_per_strip)
            buf += _decompress(data[o:o + cnts[i]], compression,
                               rowb * rows)
        bits = np.unpackbits(
            np.frombuffer(bytes(buf), np.uint8)[:h * rowb]
            .reshape(h, rowb), axis=1)[:, :w]
        photo = tags.get(_PHOTO, [1])[0]
        vals = (1 - bits) if photo == 0 else bits
        return Image(xsiz=w, ysiz=h, components=[
            Component(data=vals.astype(np.int32), prec=1, signed=False,
                      dx=1, dy=1)])

    if bps == 8:
        dt = np.dtype(np.int8 if signed else np.uint8)
    else:
        dt = np.dtype(np.int16 if signed else np.uint16).newbyteorder(e)
    nplanes = spp if planar == 2 else 1
    sppc = 1 if planar == 2 else spp         # samples/pixel per chunk
    out = np.zeros((spp, h, w), np.int32)

    def place(chunk_a: np.ndarray, py: int, px: int, plane0: int):
        """chunk_a (rows, cols, sppc) -> out planes at (py, px)."""
        rows = min(chunk_a.shape[0], h - py)
        cols = min(chunk_a.shape[1], w - px)
        for cc in range(sppc):
            out[plane0 + cc, py:py + rows, px:px + cols] = \
                chunk_a[:rows, :cols, cc]

    if tiled:
        tw, tl = tags[_TILE_W][0], tags[_TILE_L][0]
        offs = tags[_TILE_OFF]
        cnts = tags.get(_TILE_CNT, [0] * len(offs))
        ta = -(-w // tw)
        td = -(-h // tl)
        per_plane = ta * td
        want = tl * tw * sppc * dt.itemsize
        for idx, o in enumerate(offs):
            cnt = cnts[idx] or (len(data) - o)
            plane0 = (idx // per_plane) if planar == 2 else 0
            k = idx % per_plane
            py, px = (k // ta) * tl, (k % ta) * tw
            raw = _decompress(data[o:o + cnt], compression, want)
            a = np.frombuffer(raw.ljust(want, b"\0"), dt).reshape(
                tl, tw, sppc)
            if predictor == 2:
                a = _undo_predictor(a)
            place(a, py, px, plane0)
    else:
        offs = tags[_STRIP_OFF]
        cnts = tags.get(_STRIP_CNT, [len(data) - offs[0]])
        rows_per_strip = tags.get(_ROWS_PER_STRIP, [h])[0] or h
        strips_per_plane = -(-h // rows_per_strip)
        for idx, o in enumerate(offs):
            plane0 = (idx // strips_per_plane) if planar == 2 else 0
            si = idx % strips_per_plane
            py = si * rows_per_strip
            rows = min(rows_per_strip, h - py)
            want = rows * w * sppc * dt.itemsize
            raw = _decompress(data[o:o + cnts[idx]], compression, want)
            a = np.frombuffer(raw.ljust(want, b"\0"), dt).reshape(
                rows, w, sppc)
            if predictor == 2:
                a = _undo_predictor(a)
            place(a, py, 0, plane0)

    comps = [Component(data=out[c],
                       prec=bps_list[min(c, len(bps_list) - 1)],
                       signed=signed, dx=1, dy=1)
             for c in range(spp)]
    return Image(xsiz=w, ysiz=h, components=comps)


def _tag(e: str, tag: int, typ: int, vals: List[int],
         heap: bytearray, heap_base: int) -> bytes:
    n = len(vals)
    fmt = {3: "H", 4: "I", 1: "B"}[typ]
    payload = struct.pack(e + f"{n}{fmt}", *vals)
    if len(payload) <= 4:
        payload = payload + b"\0" * (4 - len(payload))
        return struct.pack(e + "HHI", tag, typ, n) + payload
    off = heap_base + len(heap)
    heap.extend(payload)
    if len(heap) % 2:
        heap.append(0)
    return struct.pack(e + "HHII", tag, typ, n, off)


def write_tiff(path: str, image: Image, compression: int = 1) -> None:
    """`compression`: 1 = none (default), 8 = zip/deflate (the reference's
    -c 8 COMPRESSION_ADOBE_DEFLATE output option)."""
    e = "<"
    n = len(image.components)
    w, h = image.xsiz, image.ysiz
    prec = max(c.prec for c in image.components)
    bps = 16 if prec > 8 else 8
    signed = any(c.signed for c in image.components)
    planes = []
    for c in image.components:
        a = np.asarray(c.data)
        planes.append(a)
    stack = np.stack(planes, axis=-1)
    if bps == 8:
        body = stack.astype(np.int8 if signed else np.uint8).tobytes()
    else:
        body = stack.astype(
            np.dtype(np.int16 if signed else np.uint16).newbyteorder(e)
        ).tobytes()
    if compression == 8:
        import zlib
        body = zlib.compress(body, 6)
    elif compression != 1:
        raise ValueError(f"unsupported TIFF write compression {compression}")
    photo = 2 if n >= 3 else 1
    ntags = 10
    ifd_off = 8
    strip_off = ifd_off + 2 + ntags * 12 + 4
    heap_base = strip_off  # heap sits right after the IFD, before pixels
    # two passes: first sizes the value heap, second emits the final
    # pixel-data offset
    def build(pixel_off: int) -> Tuple[bytes, bytearray]:
        hp = bytearray()
        ent = b""
        ent += _tag(e, _W, 4, [w], hp, heap_base)
        ent += _tag(e, _H, 4, [h], hp, heap_base)
        ent += _tag(e, _BPS, 3, [bps] * n, hp, heap_base)
        ent += _tag(e, _COMPRESSION, 3, [compression], hp, heap_base)
        ent += _tag(e, _PHOTO, 3, [photo], hp, heap_base)
        ent += _tag(e, _STRIP_OFF, 4, [pixel_off], hp, heap_base)
        ent += _tag(e, _SPP, 3, [n], hp, heap_base)
        ent += _tag(e, _ROWS_PER_STRIP, 4, [h], hp, heap_base)
        ent += _tag(e, _STRIP_CNT, 4, [len(body)], hp, heap_base)
        ent += _tag(e, _SAMPLE_FMT, 3, [2 if signed else 1] * n, hp,
                    heap_base)
        return ent, hp
    _, hp0 = build(0)
    pixel_off = heap_base + len(hp0)
    entries_b, hp = build(pixel_off)
    with open(path, "wb") as f:
        f.write(struct.pack(e + "2sHI", b"II", 42, ifd_off))
        f.write(struct.pack(e + "H", ntags))
        f.write(entries_b)
        f.write(struct.pack(e + "I", 0))  # next IFD
        f.write(bytes(hp))
        f.write(body)
