"""Minimal ICC profile application — the lcms-free analog of the
reference's color_apply_icc_profile (reference: src/bin/common/
color.cpp:423, which hands embedded profiles to liblcms2).

Scope: matrix-shaper RGB (rXYZ/gXYZ/bXYZ columns + per-channel tone
curves) and gray (kTRC) profiles, plus LUT-based A2B0 profiles (mft1 /
mft2 / lutAtoB "mAB " tags) applied with tetrahedral CLUT interpolation
— the same interpolation class lcms uses, cross-checked against
littlecms in tests/test_icc.py. All paths convert to sRGB D65 with
Bradford chromatic adaptation from the PCS D50 (XYZ or Lab PCS).
Profiles outside these classes stay embedded for downstream tools.

A copy of `grokimagecompression_tpu/io/icc.py`, as it is (numpy on
the host).
"""

from __future__ import annotations

import struct
from typing import List, Optional

import numpy as np

from ..core.image import Component, Image

# sRGB D65 XYZ -> linear sRGB
_XYZ_TO_SRGB = np.array([
    [3.2406, -1.5372, -0.4986],
    [-0.9689, 1.8758, 0.0415],
    [0.0557, -0.2040, 1.0570]])

# Bradford adaptation D50 -> D65
_BRADFORD_D50_D65 = np.array([
    [0.9555766, -0.0230393, 0.0631636],
    [-0.0282895, 1.0099416, 0.0210077],
    [0.0122982, -0.0204830, 1.3299098]])


def _s15f16(b: bytes) -> float:
    v = struct.unpack(">i", b)[0]
    return v / 65536.0


def parse_profile(data: bytes) -> Optional[dict]:
    """Parse the tag table; returns dict with 'matrix' (3x3 RGB->XYZ) and
    'curves' (list of callables) for matrix-shaper profiles, or
    {'gray': curve} for monochrome, else None."""
    if len(data) < 132:
        return None
    ntags = struct.unpack(">I", data[128:132])[0]
    if ntags > 1024:
        return None
    tags = {}
    for i in range(ntags):
        off = 132 + i * 12
        if off + 12 > len(data):
            return None
        sig, toff, tsize = struct.unpack(">4sII", data[off:off + 12])
        tags[sig] = (toff, tsize)

    def read_xyz(sig):
        if sig not in tags:
            return None
        toff, tsize = tags[sig]
        if tsize < 20 or data[toff:toff + 4] != b"XYZ ":
            return None
        return [_s15f16(data[toff + 8 + 4 * k:toff + 12 + 4 * k])
                for k in range(3)]

    def read_curve(sig):
        if sig not in tags:
            return None
        toff, tsize = tags[sig]
        typ = data[toff:toff + 4]
        if typ == b"curv":
            n = struct.unpack(">I", data[toff + 8:toff + 12])[0]
            if n == 0:
                return lambda x: x           # identity
            if n == 1:
                g = struct.unpack(">H", data[toff + 12:toff + 14])[0] / 256.0
                return lambda x, g=g: np.power(np.clip(x, 0, 1), g)
            pts = np.frombuffer(data[toff + 12:toff + 12 + 2 * n],
                                dtype=">u2").astype(np.float64) / 65535.0
            return lambda x, pts=pts: np.interp(
                np.clip(x, 0, 1), np.linspace(0, 1, len(pts)), pts)
        if typ == b"para":
            fn = struct.unpack(">H", data[toff + 8:toff + 10])[0]
            nparam = {0: 1, 1: 3, 2: 4, 3: 5, 4: 7}.get(fn)
            if nparam is None:
                return None
            ps = [_s15f16(data[toff + 12 + 4 * k:toff + 16 + 4 * k])
                  for k in range(nparam)]

            def para(x, fn=fn, ps=ps):
                x = np.clip(x, 0, 1)
                g = ps[0]
                if fn == 0:
                    return np.power(x, g)
                if fn == 1:
                    a, b = ps[1], ps[2]
                    return np.where(x >= -b / a,
                                    np.power(np.maximum(a * x + b, 0), g), 0)
                if fn == 2:
                    a, b, c = ps[1], ps[2], ps[3]
                    return np.where(x >= -b / a,
                                    np.power(np.maximum(a * x + b, 0), g)
                                    + c, c)
                if fn == 3:
                    a, b, c, d = ps[1], ps[2], ps[3], ps[4]
                    return np.where(x >= d,
                                    np.power(np.maximum(a * x + b, 0), g),
                                    c * x)
                a, b, c, d, e, f = ps[1], ps[2], ps[3], ps[4], ps[5], ps[6]
                return np.where(x >= d,
                                np.power(np.maximum(a * x + b, 0), g) + e,
                                c * x + f)
            return para
        return None

    k_curve = read_curve(b"kTRC")
    if k_curve is not None:
        return {"gray": k_curve}
    cols = [read_xyz(b"rXYZ"), read_xyz(b"gXYZ"), read_xyz(b"bXYZ")]
    curves = [read_curve(b"rTRC"), read_curve(b"gTRC"), read_curve(b"bTRC")]
    if all(c is not None for c in cols) and \
            all(c is not None for c in curves):
        matrix = np.array(cols).T  # columns: RGB primaries in XYZ
        return {"matrix": matrix, "curves": curves}
    # LUT-based profiles: A2B0 (mft1/mft2/lutAtoB) with tetrahedral
    # CLUT interpolation (reference: color.cpp:423 hands these to lcms;
    # tests cross-check against littlecms directly).
    if b"A2B0" in tags:
        toff, tsize = tags[b"A2B0"]
        typ = data[toff:toff + 4]
        lut = None
        if typ in (b"mft1", b"mft2"):
            lut = _parse_mft(data, toff)
        elif typ == b"mAB ":
            lut = _parse_mab(data, toff)
        if lut is not None:
            return {"lut": lut, "pcs": data[20:24]}
    return None


def _curve_from(data: bytes, off: int):
    """Parse one curv/para element at `off`; returns (fn, padded size)
    or (None, 0)."""
    typ = data[off:off + 4]
    if typ == b"curv":
        n = struct.unpack(">I", data[off + 8:off + 12])[0]
        size = 12 + 2 * n
        size += (-size) % 4
        if n == 0:
            return (lambda x: x), size
        if n == 1:
            g = struct.unpack(">H", data[off + 12:off + 14])[0] / 256.0
            return (lambda x, g=g: np.power(np.clip(x, 0, 1), g)), size
        pts = np.frombuffer(data[off + 12:off + 12 + 2 * n],
                            dtype=">u2").astype(np.float64) / 65535.0
        return (lambda x, pts=pts: np.interp(
            np.clip(x, 0, 1), np.linspace(0, 1, len(pts)), pts)), size
    if typ == b"para":
        fn = struct.unpack(">H", data[off + 8:off + 10])[0]
        nparam = {0: 1, 1: 3, 2: 4, 3: 5, 4: 7}.get(fn)
        if nparam is None:
            return None, 0
        ps = [_s15f16(data[off + 12 + 4 * k:off + 16 + 4 * k])
              for k in range(nparam)]
        size = 12 + 4 * nparam
        size += (-size) % 4

        def para(x, fn=fn, ps=ps):
            x = np.clip(x, 0, 1)
            g = ps[0]
            if fn == 0:
                return np.power(x, g)
            if fn == 1:
                a, b = ps[1], ps[2]
                return np.where(x >= -b / a,
                                np.power(np.maximum(a * x + b, 0), g), 0)
            if fn == 2:
                a, b, c = ps[1], ps[2], ps[3]
                return np.where(x >= -b / a,
                                np.power(np.maximum(a * x + b, 0), g) + c,
                                c)
            if fn == 3:
                a, b, c, d = ps[1], ps[2], ps[3], ps[4]
                return np.where(x >= d,
                                np.power(np.maximum(a * x + b, 0), g),
                                c * x)
            a, b, c, d, e, f = ps[1], ps[2], ps[3], ps[4], ps[5], ps[6]
            return np.where(x >= d,
                            np.power(np.maximum(a * x + b, 0), g) + e,
                            c * x + f)
        return para, size
    return None, 0


def _parse_mft(data: bytes, toff: int) -> Optional[dict]:
    """mft1 (8-bit) / mft2 (16-bit) lut tag -> pipeline pieces."""
    typ = data[toff:toff + 4]
    wide = typ == b"mft2"
    inch, outch, grid = data[toff + 8], data[toff + 9], data[toff + 10]
    if inch not in (1, 3) or outch != 3 or grid < 2:
        return None
    if wide:
        n_in, n_out = struct.unpack(">HH", data[toff + 48:toff + 52])
        p = toff + 52
        scale, dt, step = 65535.0, ">u2", 2
    else:
        n_in = n_out = 256
        p = toff + 48
        scale, dt, step = 255.0, ">u1", 1
    intabs = []
    for c in range(inch):
        intabs.append(np.frombuffer(
            data[p:p + step * n_in], dtype=dt).astype(np.float64) / scale)
        p += step * n_in
    nclut = grid ** inch * outch
    clut = (np.frombuffer(data[p:p + step * nclut], dtype=dt)
            .astype(np.float64) / scale).reshape((grid,) * inch + (outch,))
    p += step * nclut
    outtabs = []
    for c in range(outch):
        outtabs.append(np.frombuffer(
            data[p:p + step * n_out], dtype=dt).astype(np.float64) / scale)
        p += step * n_out
    return {"inch": inch, "grid": grid, "intabs": intabs, "clut": clut,
            "outtabs": outtabs, "wide": wide, "mcurves": None,
            "matrix": None, "bcurves": None, "v4lab": False}


def _parse_mab(data: bytes, toff: int) -> Optional[dict]:
    """lutAtoBType ("mAB "): A curves -> CLUT -> M curves -> matrix ->
    B curves (absent elements are identity)."""
    inch, outch = data[toff + 8], data[toff + 9]
    if inch not in (1, 3) or outch != 3:
        return None
    offB, offMat, offM, offCLUT, offA = struct.unpack(
        ">IIIII", data[toff + 12:toff + 32])

    def curves_at(off, n):
        if off == 0:
            return None
        out = []
        p = toff + off
        for _ in range(n):
            fn, size = _curve_from(data, p)
            if fn is None:
                return "bad"
            out.append(fn)
            p += size
        return out

    acurves = curves_at(offA, inch)
    mcurves = curves_at(offM, outch)
    bcurves = curves_at(offB, outch)
    if "bad" in (acurves, mcurves, bcurves):
        return None
    matrix = None
    if offMat:
        p = toff + offMat
        vals = [_s15f16(data[p + 4 * k:p + 8 + 4 * k - 4])
                for k in range(12)]
        matrix = (np.array(vals[:9]).reshape(3, 3),
                  np.array(vals[9:12]))
    clut = None
    grid = 0
    if offCLUT:
        p = toff + offCLUT
        gridpts = [data[p + i] for i in range(inch)]
        if len(set(gridpts)) != 1:
            return None
        grid = gridpts[0]
        prec = data[p + 16]
        p += 20
        n = 1
        for g in gridpts:
            n *= g
        n *= outch
        if prec == 1:
            clut = (np.frombuffer(data[p:p + n], dtype=">u1")
                    .astype(np.float64) / 255.0)
        else:
            clut = (np.frombuffer(data[p:p + 2 * n], dtype=">u2")
                    .astype(np.float64) / 65535.0)
        clut = clut.reshape(tuple(gridpts) + (outch,))
    if clut is None or acurves is None:
        return None
    return {"inch": inch, "grid": grid, "intabs": acurves, "clut": clut,
            "outtabs": bcurves, "wide": True, "mcurves": mcurves,
            "matrix": matrix, "v4lab": True}


def _clut_eval(clut: np.ndarray, x: np.ndarray) -> np.ndarray:
    """Tetrahedral interpolation of a (g,..,g,outch) CLUT at x (inch, N)
    in [0,1] — the interpolation class lcms uses for 3-D tables."""
    inch = x.shape[0]
    g = clut.shape[0]
    xs = np.clip(x, 0.0, 1.0) * (g - 1)
    i = np.minimum(xs.astype(np.int64), g - 2)
    f = xs - i
    if inch == 1:
        c0 = clut[i[0]]
        c1 = clut[i[0] + 1]
        return (c0 + f[0][:, None] * (c1 - c0)).T
    r, gg, b = i
    fr, fg, fb = f
    c000 = clut[r, gg, b]
    c100 = clut[r + 1, gg, b]
    c010 = clut[r, gg + 1, b]
    c001 = clut[r, gg, b + 1]
    c110 = clut[r + 1, gg + 1, b]
    c101 = clut[r + 1, gg, b + 1]
    c011 = clut[r, gg + 1, b + 1]
    c111 = clut[r + 1, gg + 1, b + 1]
    fr_ = fr[:, None]
    fg_ = fg[:, None]
    fb_ = fb[:, None]
    out = np.empty_like(c000)
    m1 = (fr >= fg) & (fg >= fb)
    m2 = (fr >= fg) & ~m1 & (fr >= fb)
    m3 = (fr >= fg) & ~m1 & ~m2
    m4 = ~(fr >= fg) & (fb >= fg)
    m5 = ~(fr >= fg) & ~m4 & (fb >= fr)
    m6 = ~(fr >= fg) & ~m4 & ~m5
    cases = [
        (m1, c100 - c000, c110 - c100, c111 - c110),
        (m2, c100 - c000, c111 - c101, c101 - c100),
        (m3, c101 - c001, c111 - c101, c001 - c000),
        (m4, c111 - c011, c011 - c001, c001 - c000),
        (m5, c111 - c011, c010 - c000, c011 - c010),
        (m6, c110 - c010, c010 - c000, c111 - c110),
    ]
    out[:] = c000
    for m, dr, dg, db in cases:
        mm = m[:, None]
        out = np.where(mm, c000 + fr_ * dr + fg_ * dg + fb_ * db, out)
    return out.T


def _lab_to_xyz_d50(lab: np.ndarray) -> np.ndarray:
    """CIELAB (3, N) -> XYZ D50."""
    L, a, b = lab
    fy = (L + 16.0) / 116.0
    fx = fy + a / 500.0
    fz = fy - b / 200.0

    def finv(t):
        return np.where(t > 6.0 / 29.0, t ** 3,
                        3 * (6.0 / 29.0) ** 2 * (t - 4.0 / 29.0))
    wp = np.array([0.9642, 1.0, 0.8249])
    return np.stack([finv(fx) * wp[0], finv(fy) * wp[1],
                     finv(fz) * wp[2]], axis=0)


def _apply_lut(info: dict, dev: np.ndarray) -> np.ndarray:
    """Run the A2B pipeline on device values (inch, N) in [0,1];
    returns PCS XYZ D50 (3, N)."""
    lut = info["lut"]
    x = dev
    cur = []
    for c in range(lut["inch"]):
        t = lut["intabs"][c]
        if callable(t):
            cur.append(t(x[c]))
        else:
            cur.append(np.interp(np.clip(x[c], 0, 1),
                                 np.linspace(0, 1, len(t)), t))
    x = np.stack(cur, axis=0)
    y = _clut_eval(lut["clut"], x)
    if lut["mcurves"] is not None:
        y = np.stack([lut["mcurves"][c](y[c]) for c in range(3)], axis=0)
    if lut["matrix"] is not None:
        m, off = lut["matrix"]
        y = m @ y + off[:, None]
    cur = []
    for c in range(3):
        t = lut["outtabs"][c]
        if callable(t):
            cur.append(t(y[c]))
        else:
            cur.append(np.interp(np.clip(y[c], 0, 1),
                                 np.linspace(0, 1, len(t)), t))
    y = np.stack(cur, axis=0)
    if info["pcs"] == b"Lab ":
        if lut["v4lab"]:
            lab = np.stack([y[0] * 100.0,
                            y[1] * 255.0 - 128.0,
                            y[2] * 255.0 - 128.0], axis=0)
        elif lut["wide"]:
            # legacy v2 16-bit Lab encoding (0xFF00 == 100.0)
            lab = np.stack([y[0] * (65535.0 / 652.80),
                            y[1] * (65535.0 / 256.0) - 128.0,
                            y[2] * (65535.0 / 256.0) - 128.0], axis=0)
        else:
            lab = np.stack([y[0] * 100.0,
                            y[1] * 255.0 - 128.0,
                            y[2] * 255.0 - 128.0], axis=0)
        return _lab_to_xyz_d50(lab)
    # XYZ PCS: encoding max 0xFFFF == 1.99997
    return y * (65535.0 / 32768.0)


def _srgb_encode(lin: np.ndarray) -> np.ndarray:
    lin = np.clip(lin, 0.0, 1.0)
    return np.where(lin <= 0.0031308, 12.92 * lin,
                    1.055 * np.power(lin, 1 / 2.4) - 0.055)


def apply_icc(image: Image, profile: bytes) -> Optional[Image]:
    """Convert via an embedded matrix-shaper ICC profile to sRGB.
    Returns a new Image, or None when the profile class is unsupported
    (caller keeps the original samples + embedded profile)."""
    info = parse_profile(profile)
    if info is None:
        return None
    if "gray" in info:
        if len(image.components) < 1:
            return None
        c0 = image.components[0]
        mx = (1 << c0.prec) - 1
        lin = info["gray"](c0.data.astype(np.float64) / mx)
        out = np.clip(np.round(_srgb_encode(lin) * mx), 0,
                      mx).astype(np.int32)
        comps = [Component(data=out, prec=c0.prec, signed=False,
                           dx=c0.dx, dy=c0.dy)]
        comps += image.components[1:]
        return Image(x0=image.x0, y0=image.y0, xsiz=image.xsiz,
                     ysiz=image.ysiz, components=comps)
    if "lut" in info:
        # LUT (A2B) pipeline: handles both 3-channel and 1-channel (gray)
        # device spaces, so this must run before the 3-component guard.
        inch = info["lut"]["inch"]
        if len(image.components) < inch:
            return None
        cs = image.components[:inch]
        if not all(c.dx == cs[0].dx and c.dy == cs[0].dy for c in cs):
            return None
        mx = (1 << cs[0].prec) - 1
        dev = np.stack([cs[i].data.astype(np.float64) / mx
                        for i in range(inch)], axis=0)
        shape = dev.shape[1:]
        xyz_d50 = _apply_lut(info, dev.reshape(inch, -1))
        xyz_d65 = _BRADFORD_D50_D65 @ xyz_d50
        srgb_lin = _XYZ_TO_SRGB @ xyz_d65
        srgb = _srgb_encode(srgb_lin.reshape(3, *shape))
        comps = [Component(data=np.clip(np.round(srgb[i] * mx), 0,
                                        mx).astype(np.int32),
                           prec=cs[0].prec, signed=False, dx=cs[0].dx,
                           dy=cs[0].dy) for i in range(3)]
        comps += image.components[inch:]
        return Image(x0=image.x0, y0=image.y0, xsiz=image.xsiz,
                     ysiz=image.ysiz, components=comps)
    if len(image.components) < 3:
        return None
    cs = image.components[:3]
    if not all(c.dx == cs[0].dx and c.dy == cs[0].dy for c in cs):
        return None
    mx = (1 << cs[0].prec) - 1
    lin = np.stack([info["curves"][i](cs[i].data.astype(np.float64) / mx)
                    for i in range(3)], axis=0)
    shape = lin.shape[1:]
    xyz_d50 = info["matrix"] @ lin.reshape(3, -1)
    xyz_d65 = _BRADFORD_D50_D65 @ xyz_d50
    srgb_lin = _XYZ_TO_SRGB @ xyz_d65
    srgb = _srgb_encode(srgb_lin.reshape(3, *shape))
    comps = [Component(data=np.clip(np.round(srgb[i] * mx), 0,
                                    mx).astype(np.int32),
                       prec=cs[0].prec, signed=False, dx=cs[0].dx,
                       dy=cs[0].dy) for i in range(3)]
    comps += image.components[3:]
    return Image(x0=image.x0, y0=image.y0, xsiz=image.xsiz,
                 ysiz=image.ysiz, components=comps)
