"""Shared CLI helpers: format dispatch by extension, logging.

Analog of the reference app common layer (reference: src/bin/common/,
src/bin/jp2/ImageFormat.cpp) with formats dispatched by file suffix.

A copy of `grokimagecompression_tpu/cli/common.py` over the port's
`io/` readers and writers. JPEG input and output need Pillow, as in the
reference, and exit with its message where Pillow is missing.
"""

from __future__ import annotations

import os
import sys

from ..core.image import Image
from ..io import pgx, pnm


def read_image(path: str, raw_desc: str = None,
               force_format: str = None) -> Image:
    """`force_format` (reference -K/-InFor) overrides the extension."""
    ext = ("." + force_format.lstrip(".").lower()) if force_format \
        else os.path.splitext(path)[1].lower()
    if ext in (".pgm", ".ppm", ".pnm"):
        return pnm.read_pnm(path)
    if ext == ".pgx":
        return pgx.read_pgx(path)
    if ext in (".bmp",):
        from ..io import bmp
        return bmp.read_bmp(path)
    if ext == ".png":
        from ..io import png
        return png.read_png(path)
    if ext in (".tif", ".tiff"):
        from ..io import tiff
        return tiff.read_tiff(path)
    if ext == ".tga":
        from ..io import tga
        return tga.read_tga(path)
    if ext in (".raw", ".rawl"):
        from ..io import raw as rawio
        if not raw_desc:
            raise SystemExit(
                f"raw input needs -F w,h,ncomps,prec,[s|u][@dxxdy]: {path}")
        return rawio.read_raw(path, rawio.RawDesc.parse(raw_desc),
                              big_endian=ext == ".raw")
    if ext in (".jpg", ".jpeg"):
        # JPEG input via the environment's Pillow (the analog of the
        # reference vendoring libjpeg for JPEGFormat.cpp).
        try:
            from PIL import Image as PILImage
        except ImportError:
            raise SystemExit("JPEG input requires Pillow")
        import numpy as np
        from ..core.image import Component, Image as _Image
        a = np.asarray(PILImage.open(path).convert("RGB"))
        comps = [Component(data=a[:, :, c].astype(np.int32), prec=8,
                           signed=False, dx=1, dy=1) for c in range(3)]
        return _Image(xsiz=a.shape[1], ysiz=a.shape[0], components=comps)
    raise SystemExit(f"unsupported input format: {path}")


def write_image(path: str, image: Image) -> None:
    ext = os.path.splitext(path)[1].lower()
    if ext in (".pgm", ".ppm", ".pnm"):
        pnm.write_pnm(path, image)
        return
    if ext == ".pgx":
        pgx.write_pgx(path, image)
        return
    if ext == ".bmp":
        from ..io import bmp
        bmp.write_bmp(path, image)
        return
    if ext == ".png":
        from ..io import png
        png.write_png(path, image)
        return
    if ext in (".tif", ".tiff"):
        from ..io import tiff
        tiff.write_tiff(path, image)
        return
    if ext == ".tga":
        from ..io import tga
        tga.write_tga(path, image)
        return
    if ext in (".raw", ".rawl"):
        from ..io import raw as rawio
        rawio.write_raw(path, image, big_endian=ext == ".raw")
        return
    if ext in (".jpg", ".jpeg"):
        # JPEG output via the environment's Pillow — the write half of
        # the bidirectional JPEG codec (reference:
        # src/bin/jp2/JPEGFormat.cpp encodes via vendored libjpeg).
        try:
            from PIL import Image as PILImage
        except ImportError:
            raise SystemExit("JPEG output requires Pillow")
        import numpy as np
        comps = image.components
        prec = max(c.prec for c in comps)
        if prec > 8:
            raise SystemExit("JPEG output supports <= 8-bit samples "
                             "(use -p to reduce precision)")
        planes = []
        for c in comps[:3]:
            a = np.asarray(c.data)
            if c.signed:
                a = a + (1 << (c.prec - 1))
            if c.prec < 8:
                a = a << (8 - c.prec)
            planes.append(np.clip(a, 0, 255).astype(np.uint8))
        if len(planes) >= 3:
            if any(p.shape != planes[0].shape for p in planes[1:]):
                raise SystemExit("JPEG output needs equal-size "
                                 "components (upsample first)")
            arr = np.stack(planes[:3], axis=-1)
            PILImage.fromarray(arr, "RGB").save(path, quality=90)
        else:
            PILImage.fromarray(planes[0], "L").save(path, quality=90)
        return
    raise SystemExit(f"unsupported output format: {path}")


def fail(msg: str) -> "SystemExit":
    print(f"error: {msg}", file=sys.stderr)
    raise SystemExit(1)
