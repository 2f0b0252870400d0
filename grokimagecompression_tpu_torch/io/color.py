"""Post-decode color transforms — the app-layer color management of the
reference (reference: src/bin/common/color.cpp:384 color_sycc_to_rgb,
:881 color_cmyk_to_rgb, :936 color_esycc_to_rgb;
src/bin/jp2/grk_decompress.cpp:805 convert_gray_to_rgb, :891
upsample_image_components), vectorized with numpy.

All integer rounding matches the reference exactly: C's
``(int32_t)(double)`` truncates toward zero, reproduced with
``np.trunc``-style casts.

A copy of `grokimagecompression_tpu/io/color.py`, as it is: the
decode's colour policy runs in numpy on the host.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from ..core.image import Component, Image

# JP2 colr enumerated colourspaces (I.5.3.3)
CS_CMYK = 12
CS_SRGB = 16
CS_GREY = 17
CS_SYCC = 18
CS_EYCC = 24


def _trunc_i32(a: np.ndarray) -> np.ndarray:
    """C (int32_t) cast of a float: truncate toward zero."""
    return a.astype(np.int32)


def _sycc_combine(y: np.ndarray, cb: np.ndarray, cr: np.ndarray,
                  prec: int):
    """The per-sample sycc_to_rgb math (reference: color.cpp:131-160)."""
    offset = 1 << (prec - 1)
    upb = (1 << prec) - 1
    cb = cb.astype(np.int64) - offset
    cr = cr.astype(np.int64) - offset
    r = y + _trunc_i32(1.402 * cr)
    g = y - _trunc_i32(0.344 * cb + 0.714 * cr)
    b = y + _trunc_i32(1.772 * cb)
    clamp = lambda v: np.clip(v, 0, upb).astype(np.int32)
    return clamp(r), clamp(g), clamp(b)


def sycc_to_rgb(image: Image) -> Optional[Image]:
    """4:4:4 / 4:2:2 / 4:2:0 sYCC -> RGB. Returns a new Image or None if
    the subsampling pattern is unsupported (reference: color.cpp:384)."""
    if len(image.components) < 3:
        return None
    c0, c1, c2 = image.components[:3]
    dxs = (c0.dx, c1.dx, c2.dx)
    dys = (c0.dy, c1.dy, c2.dy)
    y = c0.data.astype(np.int64)
    h, w = y.shape
    prec = c0.prec
    offx = image.x0 & 1
    offy = image.y0 & 1

    if dxs == (1, 2, 2) and dys == (1, 2, 2):      # 4:2:0
        cb_s, cr_s = c1.data, c2.data
        xi = np.maximum(np.arange(w) - offx, 0) // 2
        yi = np.maximum(np.arange(h) - offy, 0) // 2
        xi = np.minimum(xi, cb_s.shape[1] - 1)
        yi = np.minimum(yi, cb_s.shape[0] - 1)
        cb = cb_s[yi][:, xi].astype(np.int64)
        cr = cr_s[yi][:, xi].astype(np.int64)
        # odd canvas origin: "first column/line shall use Cb/Cr = 0"
        # (raw zero, before the level-shift subtraction — color.cpp:246)
        if offx:
            cb[:, 0] = 0
            cr[:, 0] = 0
        if offy:
            cb[0, :] = 0
            cr[0, :] = 0
    elif dxs == (1, 2, 2) and dys == (1, 1, 1):    # 4:2:2
        cb_s, cr_s = c1.data, c2.data
        xi = np.maximum(np.arange(w) - offx, 0) // 2
        xi = np.minimum(xi, cb_s.shape[1] - 1)
        cb = cb_s[:, xi].astype(np.int64)
        cr = cr_s[:, xi].astype(np.int64)
        if offx:
            cb[:, 0] = 0
            cr[:, 0] = 0
    elif dxs == (1, 1, 1) and dys == (1, 1, 1):    # 4:4:4
        cb = c1.data.astype(np.int64)
        cr = c2.data.astype(np.int64)
    else:
        return None

    r, g, b = _sycc_combine(y, cb, cr, prec)
    comps = [Component(data=v, prec=prec, signed=False, dx=1, dy=1)
             for v in (r, g, b)]
    comps += image.components[3:]
    return Image(x0=image.x0, y0=image.y0, xsiz=image.xsiz,
                 ysiz=image.ysiz, components=comps)


def esycc_to_rgb(image: Image) -> Optional[Image]:
    """Extended sYCC -> RGB (reference: color.cpp:936; rounding +0.5
    then truncation)."""
    if len(image.components) < 3:
        return None
    c0, c1, c2 = image.components[:3]
    if not (c0.dx == c1.dx == c2.dx and c0.dy == c1.dy == c2.dy):
        return None
    prec = c0.prec
    flip = 1 << (prec - 1)
    maxv = (1 << prec) - 1
    y = c0.data.astype(np.float64)
    cb = c1.data.astype(np.float64) - (0 if c1.signed else flip)
    cr = c2.data.astype(np.float64) - (0 if c2.signed else flip)
    r = _trunc_i32(y - 0.0000368 * cb + 1.40199 * cr + 0.5)
    g = _trunc_i32(1.0003 * y - 0.344125 * cb - 0.7141128 * cr + 0.5)
    b = _trunc_i32(0.999823 * y + 1.77204 * cb - 0.000008 * cr + 0.5)
    clamp = lambda v: np.clip(v, 0, maxv).astype(np.int32)
    comps = [Component(data=clamp(v), prec=prec, signed=False,
                       dx=c0.dx, dy=c0.dy) for v in (r, g, b)]
    comps += image.components[3:]
    return Image(x0=image.x0, y0=image.y0, xsiz=image.xsiz,
                 ysiz=image.ysiz, components=comps)


def cmyk_to_rgb(image: Image) -> Optional[Image]:
    """CMYK -> 8-bit RGB, dropping the K plane (reference:
    color.cpp:881)."""
    if len(image.components) < 4:
        return None
    cs = image.components[:4]
    if not all(c.dx == cs[0].dx and c.dy == cs[0].dy for c in cs):
        return None
    scale = [1.0 / ((1 << c.prec) - 1) for c in cs]
    C = 1.0 - cs[0].data * scale[0]
    M = 1.0 - cs[1].data * scale[1]
    Y = 1.0 - cs[2].data * scale[2]
    K = 1.0 - cs[3].data * scale[3]
    r = _trunc_i32(255.0 * C * K)
    g = _trunc_i32(255.0 * M * K)
    b = _trunc_i32(255.0 * Y * K)
    comps = [Component(data=v, prec=8, signed=False, dx=cs[0].dx,
                       dy=cs[0].dy) for v in (r, g, b)]
    comps += image.components[4:]
    return Image(x0=image.x0, y0=image.y0, xsiz=image.xsiz,
                 ysiz=image.ysiz, components=comps)


def gray_to_rgb(image: Image) -> Image:
    """Duplicate the luma plane into R=G=B, keeping any extra components
    (reference: grk_decompress.cpp:805)."""
    c0 = image.components[0]
    comps = [Component(data=c0.data.copy(), prec=c0.prec, signed=c0.signed,
                       dx=c0.dx, dy=c0.dy) for _ in range(3)]
    comps += [image.components[i] for i in range(1, len(image.components))]
    return Image(x0=image.x0, y0=image.y0, xsiz=image.xsiz,
                 ysiz=image.ysiz, components=comps)


def upsample(image: Image) -> Image:
    """Replicate subsampled components onto the full reference grid
    (reference: grk_decompress.cpp:891)."""
    if all(c.dx == 1 and c.dy == 1 for c in image.components):
        return image
    out = []
    full_w = image.xsiz - image.x0
    full_h = image.ysiz - image.y0
    for c in image.components:
        if c.dx == 1 and c.dy == 1:
            out.append(c)
            continue
        a = np.repeat(np.repeat(c.data, c.dy, axis=0), c.dx, axis=1)
        a = a[:full_h, :full_w]
        # pad (replicating the last row/col) if the subsampled grid
        # undershoots the canvas
        if a.shape[0] < full_h:
            a = np.vstack([a, np.repeat(a[-1:], full_h - a.shape[0], 0)])
        if a.shape[1] < full_w:
            a = np.hstack([a, np.repeat(a[:, -1:], full_w - a.shape[1], 1)])
        out.append(Component(data=np.ascontiguousarray(a), prec=c.prec,
                             signed=c.signed, dx=1, dy=1))
    return Image(x0=image.x0, y0=image.y0, xsiz=image.xsiz,
                 ysiz=image.ysiz, components=out)


def apply_color(image: Image, colourspace: Optional[int] = None,
                force_rgb: bool = False) -> Image:
    """Post-decode color policy of the reference decompressor
    (reference: grk_decompress.cpp:1585-1622): infer sYCC from 3-comp
    chroma subsampling when unsignalled, then convert sYCC/eYCC/CMYK to
    RGB; with force_rgb, grayscale is expanded to R=G=B."""
    cs = colourspace
    comps = image.components
    if cs is None:
        if (len(comps) == 3 and comps[0].dx == comps[0].dy == 1
                and comps[1].dx != 1):
            cs = CS_SYCC
        elif len(comps) <= 2:
            cs = CS_GREY
    converted = None
    if cs == CS_SYCC and len(comps) == 3:
        converted = sycc_to_rgb(image)
    elif cs == CS_EYCC and len(comps) == 3:
        converted = esycc_to_rgb(image)
    elif cs == CS_CMYK:
        converted = cmyk_to_rgb(image)
    if converted is not None:
        image = converted
    if force_rgb and len(image.components) < 3:
        image = gray_to_rgb(image)
    return image


def cielab_to_rgb(image, params=None):
    """CIELab (JP2 colr enumcs 14) -> 16-bit sRGB.

    `params`: EP field u32s (variant, rL, oL, ra, oa, rb, ob,
    illuminant); None or short tuples fall back to the standard Lab
    space defaults, illuminant D50 (the reference defaults unknown
    illuminants to D50 too — color.cpp color_cielab_to_rgb:716).
    Numpy analog of the reference's lcms pipeline: scaled Lab ->
    XYZ(D50) -> Bradford D50->D65 -> linear sRGB -> gamma.
    """
    import dataclasses

    import numpy as np

    from ..core.image import Image
    from .icc import _BRADFORD_D50_D65, _XYZ_TO_SRGB, _srgb_encode

    if len(image.components) != 3:
        return image
    c0, c1, c2 = image.components[:3]
    pl, pa, pb = c0.prec, c1.prec, c2.prec
    default = not params or len(params) < 8 or params[0] != 0x00444546
    if default:
        r_l, o_l = 100.0, 0.0
        r_a, o_a = 170.0, float(1 << (pa - 1))
        r_b, o_b = 200.0, 3.0 * (1 << (pb - 3))
    else:
        r_l, o_l = float(params[1]), float(params[2])
        r_a, o_a = float(params[3]), float(params[4])
        r_b, o_b = float(params[5]), float(params[6])

    def scale(q, prec, rng, off):
        mn = -(rng * off) / ((1 << prec) - 1)
        return mn + q.astype(np.float64) * rng / ((1 << prec) - 1)

    L = scale(c0.data, pl, r_l, o_l)
    a = scale(c1.data, pa, r_a, o_a)
    b = scale(c2.data, pb, r_b, o_b)

    # Lab -> XYZ, D50 reference white
    fy = (L + 16.0) / 116.0
    fx = fy + a / 500.0
    fz = fy - b / 200.0
    d = 6.0 / 29.0

    def finv(t):
        return np.where(t > d, t ** 3, 3.0 * d * d * (t - 4.0 / 29.0))

    xn, yn, zn = 0.9642, 1.0, 0.8249   # D50
    xyz = np.stack([finv(fx) * xn, finv(fy) * yn, finv(fz) * zn], 0)
    sh = xyz.shape[1:]
    xyz = xyz.reshape(3, -1)
    lin = _XYZ_TO_SRGB @ (_BRADFORD_D50_D65 @ xyz)
    srgb = _srgb_encode(np.clip(lin, 0.0, 1.0))
    out16 = np.clip(srgb * 65535.0 + 0.5, 0, 65535).astype(np.int32)
    comps = [dataclasses.replace(c0, data=out16[i].reshape(sh), prec=16,
                                 signed=False)
             for i in range(3)]
    return dataclasses.replace(image, components=comps)
