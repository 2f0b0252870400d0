"""High-level decode API of the port: the decode half of the reference's
`grokimagecompression_tpu/codec.py` (`to_image`, `from_image`,
`decompress`, `decompress_batch`), over the port's decoder on a torch
device (CUDA unless the caller names the CPU).

    from grokimagecompression_tpu_torch import codec

    thumb = codec.decompress(data, reduce=2, layers=1)
    region = codec.decompress(data, window=(x0, y0, x1, y1))

`compress`, `compress_batch` and `Codec` are not ported yet.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np

from .codestream import decoder as _decoder
from .codestream import jp2 as _jp2
from .core.image import Component, Image
from .core.params import DecoderParams
from .utils.device import DeviceLike


def to_image(array: np.ndarray, prec: int = 8, signed: bool = False) -> Image:
    """(H, W) or (H, W, C) array -> Image."""
    a = np.asarray(array)
    if a.ndim == 2:
        a = a[:, :, None]
    h, w, nc = a.shape
    comps = [
        Component(data=np.ascontiguousarray(a[:, :, c]).astype(np.int32),
                  prec=prec, signed=signed, dx=1, dy=1)
        for c in range(nc)
    ]
    return Image(xsiz=w, ysiz=h, components=comps)


def from_image(image: Image) -> np.ndarray:
    """Image -> (H, W) or (H, W, C) array."""
    planes = [c.data for c in image.components]
    if len(planes) == 1:
        return planes[0]
    return np.stack(planes, axis=-1)


def decompress(data: bytes, *, reduce: int = 0, layers: int = 0,
               window: Optional[Tuple[int, int, int, int]] = None,
               device: DeviceLike = "cuda") -> np.ndarray:
    """One-call decompression of a codestream or JP2 file to a numpy
    array: the whole image, or a `window` (canvas coords), at a
    resolution reduction `reduce`, of the first `layers` quality layers
    (all when 0)."""
    img = _decoder.decode(data, DecoderParams(reduce=reduce, layers=layers,
                                              window=window), device)
    return from_image(img)


def decompress_batch(streams: Sequence[bytes], *, reduce: int = 0,
                     layers: int = 0,
                     window: Optional[Tuple[int, int, int, int]] = None,
                     device: DeviceLike = "cuda") -> List[np.ndarray]:
    """Decompress a batch of streams, in order. Streams that share their
    coding parameters (SIZ, COD, QCD) decode together through
    `decoder.decode_batch`, the others apart."""
    streams = list(streams)
    params = DecoderParams(reduce=reduce, layers=layers, window=window)
    groups: List[Tuple[tuple, List[int]]] = []
    for i, d in enumerate(streams):
        h = _decoder.read_header(
            _jp2.extract_codestream(d) if _jp2.is_jp2(d) else d)
        key = (h.siz, h.cod, h.qcd)
        same = [idx for k, idx in groups if k == key]
        if same:
            same[0].append(i)
        else:
            groups.append((key, [i]))
    out: List[Optional[np.ndarray]] = [None] * len(streams)
    for _, idx in groups:
        imgs = _decoder.decode_batch([streams[i] for i in idx], params,
                                     device)
        for i, img in zip(idx, imgs):
            out[i] = from_image(img)
    return out  # type: ignore[return-value]
