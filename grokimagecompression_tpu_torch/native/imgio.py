"""ctypes binding for the host library's PNG scanline filters
(csrc/host/imgio.cpp).

A copy of the `grok_png_unfilter` / `grok_png_filter` bindings of
`grokimagecompression_tpu/native/t1_native.py`, which `io/png.py` calls.
The library is built on first use (`ops/_build.host_library`); a build
or load failure raises, and there is no numpy fallback.
"""

from __future__ import annotations

import numpy as np

from ..ops import _build


def png_unfilter(rows: np.ndarray, h: int, rowbytes: int,
                 bpp: int) -> np.ndarray:
    """Reconstruct (h, rowbytes) bytes from `rows`, h filtered scanlines of
    1 filter byte + rowbytes bytes each, packed contiguously."""
    rows = np.ascontiguousarray(rows, dtype=np.uint8)
    if rows.size < h * (rowbytes + 1):
        raise ValueError("png_unfilter: fewer than h * (rowbytes + 1) bytes")
    out = np.empty(h * rowbytes, dtype=np.uint8)
    rc = _build.host_library().grok_png_unfilter(
        rows.ctypes.data, h, rowbytes, bpp, out.ctypes.data)
    if rc != 0:
        raise ValueError("PNG: bad filter type")
    return out.reshape(h, rowbytes)


def png_filter(img: np.ndarray, bpp: int, filter_type: int) -> np.ndarray:
    """Filter the (h, rowbytes) bytes of `img` with one filter type (0-4)
    for every row: h * (rowbytes + 1) bytes, each row led by its filter
    byte."""
    img = np.ascontiguousarray(img, dtype=np.uint8)
    h, rowbytes = img.shape
    out = np.empty(h * (rowbytes + 1), dtype=np.uint8)
    rc = _build.host_library().grok_png_filter(
        img.ctypes.data, h, rowbytes, bpp, filter_type, out.ctypes.data)
    if rc != 0:
        raise ValueError("bad filter type")
    return out
