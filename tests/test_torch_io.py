"""The port's image file readers and writers and the decode's colour
policy (`grokimagecompression_tpu_torch/io/`), held to the reference's.

Each port reader reads files that the reference's writers wrote from
seeded arrays (and files built here in the layouts only other writers
make: LZW, PackBits and multi-strip TIFF with and without the horizontal
predictor, big-endian TIFF, tiled TIFF, Adam7, palette and sub-byte PNG,
RLE TGA); its `Image` must equal the reference reader's in samples,
`prec`, `signed`, `dx` / `dy`, `alpha` and origin. Each port writer's
bytes must equal the reference writer's; PNG at every filter type, with
the reference's native filter library loaded (its fallback writes other
bytes). `color.py` and `icc.py` must equal the reference's exactly on
seeded images. The port's TIFF LZW decoder raises ValueError on a code
past the table right after a CLEAR, where the reference raises
IndexError.
"""

import os
import struct
import sys
import zlib

import numpy as np
import pytest
import torch

from grokimagecompression_tpu.core.image import Component as RefComponent
from grokimagecompression_tpu.core.image import Image as RefImage
from grokimagecompression_tpu.io import bmp as ref_bmp
from grokimagecompression_tpu.io import color as ref_color
from grokimagecompression_tpu.io import icc as ref_icc
from grokimagecompression_tpu.io import pgx as ref_pgx
from grokimagecompression_tpu.io import png as ref_png
from grokimagecompression_tpu.io import pnm as ref_pnm
from grokimagecompression_tpu.io import raw as ref_raw
from grokimagecompression_tpu.io import tga as ref_tga
from grokimagecompression_tpu.io import tiff as ref_tiff
from grokimagecompression_tpu_torch.core.image import Component, Image
from grokimagecompression_tpu_torch.io import (bmp, color, icc, pgx, png, pnm,
                                               raw, tga, tiff)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
import chip_smoke  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Torch on one thread: under pytest-xdist's workers torch's OpenMP
    threads oversubscribe the cores and spin."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pair(w, h, ncomps=1, prec=8, signed=False, seed=0, sub=(), alpha=()):
    """The same seeded image as the reference's and as the port's Image."""
    rng = np.random.default_rng(seed)
    lo, hi = (-(1 << (prec - 1)), 1 << (prec - 1)) if signed \
        else (0, 1 << prec)
    ref, port = [], []
    for c in range(ncomps):
        d = 2 if c in sub else 1
        a = rng.integers(lo, hi, (-(-h // d), -(-w // d))).astype(np.int32)
        kw = dict(prec=prec, signed=signed, dx=d, dy=d, alpha=c in alpha)
        ref.append(RefComponent(data=a, **kw))
        port.append(Component(data=a.copy(), **kw))
    return (RefImage(xsiz=w, ysiz=h, components=ref),
            Image(xsiz=w, ysiz=h, components=port))


def assert_same_image(got, want):
    """A port Image equal to a reference Image in every field."""
    assert (got.x0, got.y0, got.xsiz, got.ysiz) == \
        (want.x0, want.y0, want.xsiz, want.ysiz)
    assert len(got.components) == len(want.components)
    for g, w in zip(got.components, want.components):
        assert (g.prec, g.signed, g.dx, g.dy, g.alpha) == \
            (w.prec, w.signed, w.dx, w.dy, w.alpha)
        assert g.data.dtype == w.data.dtype
        np.testing.assert_array_equal(g.data, w.data)


def _read_both(path, port_read, ref_read):
    assert_same_image(port_read(path), ref_read(path))


def _write_both(tmp_path, name, port_write, ref_write, port_img, ref_img,
                **kw):
    """Both writers' bytes of the same image; returns the file's path."""
    p, r = str(tmp_path / f"port_{name}"), str(tmp_path / f"ref_{name}")
    port_write(p, port_img, **kw)
    ref_write(r, ref_img, **kw)
    with open(p, "rb") as f, open(r, "rb") as g:
        assert f.read() == g.read()
    return r


# ---------------------------------------------------------------- PNM / PGX

@pytest.mark.parametrize("ncomps,prec", [(1, 8), (3, 8), (1, 12), (3, 16)])
def test_pnm_equals_reference(tmp_path, ncomps, prec):
    ref, port = _pair(37, 21, ncomps, prec, seed=prec + ncomps)
    p = _write_both(tmp_path, "x.pnm", pnm.write_pnm, ref_pnm.write_pnm,
                    port, ref)
    _read_both(p, pnm.read_pnm, ref_pnm.read_pnm)


@pytest.mark.parametrize("prec,signed", [(8, False), (8, True), (12, True),
                                         (16, False), (20, True)])
def test_pgx_equals_reference(tmp_path, prec, signed):
    ref, port = _pair(23, 17, 1, prec, signed, seed=prec)
    p = _write_both(tmp_path, "x.pgx", pgx.write_pgx, ref_pgx.write_pgx,
                    port, ref)
    _read_both(p, pgx.read_pgx, ref_pgx.read_pgx)


# -------------------------------------------------------------------- raw

@pytest.mark.parametrize("prec,signed,be,sub", [
    (8, False, True, ()), (8, True, False, ()), (12, False, True, ()),
    (16, True, False, ()), (8, False, True, (1, 2)),
    (12, True, False, (1, 2))])
def test_raw_equals_reference(tmp_path, prec, signed, be, sub):
    ref, port = _pair(21, 13, 3, prec, signed, seed=prec, sub=sub)
    name = "x.raw" if be else "x.rawl"
    p = _write_both(tmp_path, name, raw.write_raw, ref_raw.write_raw, port,
                    ref, big_endian=be)
    desc = f"21,13,3,{prec},{'s' if signed else 'u'}" + (
        "@1x1:2x2:2x2" if sub else "")
    assert raw.RawDesc.parse(desc) == \
        raw.RawDesc(**vars(ref_raw.RawDesc.parse(desc)))
    assert_same_image(
        raw.read_raw(p, raw.RawDesc.parse(desc), big_endian=be),
        ref_raw.read_raw(p, ref_raw.RawDesc.parse(desc), big_endian=be))


# -------------------------------------------------------------- BMP / TGA

@pytest.mark.parametrize("ncomps", [1, 3])
def test_bmp_equals_reference(tmp_path, ncomps):
    ref, port = _pair(31, 19, ncomps, seed=ncomps)
    p = _write_both(tmp_path, "x.bmp", bmp.write_bmp, ref_bmp.write_bmp,
                    port, ref)
    _read_both(p, bmp.read_bmp, ref_bmp.read_bmp)


@pytest.mark.parametrize("ncomps", [1, 3, 4])
def test_tga_equals_reference(tmp_path, ncomps):
    ref, port = _pair(31, 19, ncomps, seed=ncomps, alpha=(3,))
    p = _write_both(tmp_path, "x.tga", tga.write_tga, ref_tga.write_tga,
                    port, ref)
    _read_both(p, tga.read_tga, ref_tga.read_tga)


def test_tga_rle_equals_reference(tmp_path):
    hdr = struct.pack("<BBBHHBHHHHBB", 0, 0, 11, 0, 0, 0, 0, 0, 6, 2, 8,
                      0x20)
    p = str(tmp_path / "r.tga")
    with open(p, "wb") as f:
        f.write(hdr + bytes([0x82, 200, 0x00, 50, 0x01, 7, 9, 0x85, 3]))
    _read_both(p, tga.read_tga, ref_tga.read_tga)


# -------------------------------------------------------------------- PNG

def test_reference_png_filter_is_native():
    """The reference writes filtered rows only through its native library
    (without it, unfiltered rows: other bytes), so the byte comparisons
    below need it loaded."""
    from grokimagecompression_tpu.native.t1_native import _lib
    assert hasattr(_lib, "grok_png_filter")


@pytest.mark.parametrize("filter_type", [0, 1, 2, 3, 4])
@pytest.mark.parametrize("ncomps,prec", [(1, 8), (2, 8), (3, 8), (4, 8),
                                         (1, 16), (2, 16), (3, 16), (4, 16),
                                         (3, 12)])
def test_png_equals_reference(tmp_path, filter_type, ncomps, prec):
    ref, port = _pair(29, 11, ncomps, prec, seed=prec + 7 * ncomps,
                      alpha=(ncomps - 1,) if ncomps in (2, 4) else ())
    p = _write_both(tmp_path, "x.png", png.write_png, ref_png.write_png,
                    port, ref, filter_type=filter_type)
    _read_both(p, png.read_png, ref_png.read_png)


def test_png_crafted_layouts_equal_reference(tmp_path):
    """Layouts the writers do not make: Adam7, 4-bit gray, palette with
    tRNS."""
    rng = np.random.default_rng(5)
    rows = rng.integers(0, 256, (11, 13)).astype(np.uint8)
    passes = []
    for (x0, y0, dx, dy) in ref_png._ADAM7:
        sub = rows[y0::dy, x0::dx]
        passes += [bytes([k % 5]) + bytes(r) for k, r in enumerate(sub)
                   if sub.shape[1]]
    # the filter bytes 1-4 above run the native unfilter on Adam7 passes
    idx = rng.integers(0, 4, (5, 9)).astype(np.uint8)
    packed = np.packbits(np.unpackbits(idx[:, :, None], axis=2)[:, :, 6:]
                         .reshape(5, -1), axis=1)
    files = {
        "adam7.png": (struct.pack(">IIBBBBB", 13, 11, 8, 0, 0, 0, 1),
                      b"".join(passes), []),
        "pal.png": (struct.pack(">IIBBBBB", 9, 5, 2, 3, 0, 0, 0),
                    b"".join(b"\x00" + bytes(r) for r in packed),
                    [(b"PLTE", bytes(range(12))), (b"tRNS", b"\x10\x80")]),
        "g4.png": (struct.pack(">IIBBBBB", 9, 5, 4, 0, 0, 0, 0),
                   b"".join(b"\x01" + bytes(r) for r in np.packbits(
                       np.unpackbits(idx[:, :, None], axis=2)[:, :, 4:]
                       .reshape(5, -1), axis=1)), []),
    }
    for name, (ihdr, body, extra) in files.items():
        out = b"\x89PNG\r\n\x1a\n" + ref_png._chunk(b"IHDR", ihdr)
        for tag, pay in extra:
            out += ref_png._chunk(tag, pay)
        out += ref_png._chunk(b"IDAT", zlib.compress(body)) \
            + ref_png._chunk(b"IEND", b"")
        p = str(tmp_path / name)
        with open(p, "wb") as f:
            f.write(out)
        _read_both(p, png.read_png, ref_png.read_png)


def test_png_bad_filter_raises(tmp_path):
    out = b"\x89PNG\r\n\x1a\n" + ref_png._chunk(
        b"IHDR", struct.pack(">IIBBBBB", 4, 2, 8, 0, 0, 0, 0)) \
        + ref_png._chunk(b"IDAT", zlib.compress(b"\x07" + bytes(4) * 2
                                                + b"\x00")) \
        + ref_png._chunk(b"IEND", b"")
    p = str(tmp_path / "bad.png")
    with open(p, "wb") as f:
        f.write(out)
    with pytest.raises(ValueError, match="bad filter type"):
        png.read_png(p)
    _, port = _pair(4, 2)
    with pytest.raises(ValueError, match="bad filter type"):
        png.write_png(str(tmp_path / "x.png"), port, filter_type=5)


# ------------------------------------------------------------------- TIFF

@pytest.mark.parametrize("compression", [1, 8])
@pytest.mark.parametrize("ncomps,prec,signed", [
    (1, 8, False), (3, 8, False), (1, 16, False), (3, 16, False),
    (1, 16, True), (4, 8, False), (2, 8, True)])
def test_tiff_writer_equals_reference(tmp_path, compression, ncomps, prec,
                                      signed):
    ref, port = _pair(29, 17, ncomps, prec, signed, seed=ncomps + prec)
    p = _write_both(tmp_path, "x.tif", tiff.write_tiff, ref_tiff.write_tiff,
                    port, ref, compression=compression)
    _read_both(p, tiff.read_tiff, ref_tiff.read_tiff)


@pytest.mark.parametrize("compression", [1, 5, 8, 32773, 32946])
@pytest.mark.parametrize("spp,bps,predictor,rows,big_endian", [
    (3, 8, 1, None, False), (3, 8, 2, 7, False), (1, 16, 1, 5, True),
    (1, 16, 2, None, False), (4, 8, 2, 16, True)])
def test_tiff_reader_equals_reference(tmp_path, compression, spp, bps,
                                      predictor, rows, big_endian):
    """Every compression the reference reads, in strips or one, with and
    without the horizontal predictor, in both byte orders
    (`chip_smoke.tiff_file`, whose LZW streams Pillow reads too:
    tests/test_torch_cli.py)."""
    rng = np.random.default_rng(spp + bps + compression)
    planes = [rng.integers(0, 1 << bps, (23, 41)) for _ in range(spp)]
    planes[0][5:9] = 3  # runs for PackBits and long LZW strings
    p = str(tmp_path / "x.tif")
    chip_smoke.tiff_file(p, planes, bps, compression, predictor=predictor,
                         rows_per_strip=rows, big_endian=big_endian)
    got = tiff.read_tiff(p)
    assert_same_image(got, ref_tiff.read_tiff(p))
    for g, want in zip(got.components, planes):
        np.testing.assert_array_equal(g.data, want)


@pytest.mark.parametrize("compression", [1, 8])
def test_tiled_tiff_equals_reference(tmp_path, compression):
    from test_formats import _write_tiled_tiff
    rng = np.random.default_rng(2)
    arr = rng.integers(0, 256, (50, 70, 3), dtype=np.uint8)
    p = str(tmp_path / "tiled.tif")
    _write_tiled_tiff(p, arr, 32, 16, compression=compression)
    _read_both(p, tiff.read_tiff, ref_tiff.read_tiff)


def test_tiff_lzw_code_past_table_after_clear(tmp_path, monkeypatch):
    """A code past the table right after a CLEAR: the port raises
    ValueError("corrupt LZW stream"), as on every other corrupt branch;
    the reference raises IndexError there."""
    # CLEAR (256), then 300, then EOI (257), 9 bits each, MSB first
    bits = "".join(format(c, "09b") for c in (256, 300, 257))
    data = int(bits + "0" * (-len(bits) % 8), 2).to_bytes(
        (len(bits) + 7) // 8, "big")
    with pytest.raises(ValueError, match="corrupt LZW stream"):
        tiff._lzw_decode(data, 16)
    with pytest.raises(IndexError):
        ref_tiff._lzw_decode(data, 16)
    # a well-formed stream still decodes as the reference decodes it
    body = bytes(range(256)) * 3 + b"\x05" * 700
    enc = chip_smoke.lzw_encode(body)
    assert tiff._lzw_decode(enc, len(body)) == \
        ref_tiff._lzw_decode(enc, len(body)) == body
    monkeypatch.setattr(chip_smoke, "lzw_encode", lambda body: data)
    p = str(tmp_path / "bad.tif")
    chip_smoke.tiff_file(p, [np.zeros((2, 8), np.int32)], 8, 5)
    with pytest.raises(ValueError, match="corrupt LZW stream"):
        tiff.read_tiff(p)


# ------------------------------------------------------------ colour policy

def _color_pair(ncomps, seed, sub=(), prec=8):
    return _pair(26, 18, ncomps, prec, seed=seed, sub=sub)


@pytest.mark.parametrize("name,args", [
    ("sycc_to_rgb", dict(ncomps=3, seed=1)),
    ("sycc_to_rgb", dict(ncomps=3, seed=2, sub=(1, 2))),
    ("sycc_to_rgb", dict(ncomps=3, seed=3, prec=12)),
    ("esycc_to_rgb", dict(ncomps=3, seed=4)),
    ("cmyk_to_rgb", dict(ncomps=4, seed=5)),
    ("gray_to_rgb", dict(ncomps=1, seed=6)),
    ("gray_to_rgb", dict(ncomps=2, seed=7)),
    ("upsample", dict(ncomps=3, seed=8, sub=(1, 2))),
    ("apply_color", dict(ncomps=3, seed=9, sub=(1, 2))),
    ("apply_color", dict(ncomps=1, seed=10)),
    ("cielab_to_rgb", dict(ncomps=3, seed=11)),
    ("cielab_to_rgb", dict(ncomps=3, seed=12, prec=16)),
])
def test_color_equals_reference(name, args):
    ref, port = _color_pair(**args)
    got = getattr(color, name)(port)
    want = getattr(ref_color, name)(ref)
    if want is None:
        assert got is None
    else:
        assert_same_image(got, want)


def test_color_policy_options_equal_reference():
    ref, port = _color_pair(1, 13)
    assert_same_image(color.apply_color(port, force_rgb=True),
                      ref_color.apply_color(ref, force_rgb=True))
    ref, port = _color_pair(3, 14)
    for cs in (color.CS_SYCC, color.CS_EYCC, color.CS_SRGB):
        assert_same_image(color.apply_color(port, colourspace=cs),
                          ref_color.apply_color(ref, colourspace=cs))
    ref, port = _color_pair(4, 15)
    assert_same_image(color.apply_color(port, colourspace=color.CS_CMYK),
                      ref_color.apply_color(ref, colourspace=ref_color.CS_CMYK))
    ref, port = _color_pair(3, 16)
    lab = (0, 100, 0, 255, 128, 255, 96, 0x00443635)
    assert_same_image(color.cielab_to_rgb(port, lab),
                      ref_color.cielab_to_rgb(ref, lab))


def _profiles():
    """A matrix-shaper RGB profile and the LUT-based ones of
    tests/test_icc.py (mft2, lutAtoB, gray mft2)."""
    test_icc = pytest.importorskip("test_icc")
    return {"matrix": chip_smoke.icc_profile(),
            "mft2": test_icc.make_mft2_profile(),
            "mab": test_icc.make_mab_profile(),
            "gray": test_icc.make_gray_lut_profile()}


@pytest.mark.parametrize("kind", ["matrix", "mft2", "mab", "gray"])
def test_icc_equals_reference(kind):
    prof = _profiles()[kind]
    ref, port = _color_pair(1 if kind == "gray" else 3, 17)
    assert icc.parse_profile(prof) is not None
    got, want = icc.apply_icc(port, prof), ref_icc.apply_icc(ref, prof)
    assert want is not None
    assert_same_image(got, want)
    # a profile of the other channel count passes the image through
    other = _color_pair(3 if kind == "gray" else 1, 18)
    assert (icc.apply_icc(other[1], prof) is None) == \
        (ref_icc.apply_icc(other[0], prof) is None)
