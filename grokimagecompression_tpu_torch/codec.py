"""High-level codec API of the port: the reference's
`grokimagecompression_tpu/codec.py` (`PRESETS`, `Codec`, `to_image`,
`from_image`, `compress`, `compress_batch`, `decompress`,
`decompress_batch`) over the port's encoder and decoder on a torch
device (CUDA unless the caller names the CPU).

    from grokimagecompression_tpu_torch import codec

    data = codec.compress(image_array, lossless=True)
    out = codec.decompress(data)
    thumb = codec.decompress(data, reduce=2, layers=1)
    region = codec.decompress(data, window=(x0, y0, x1, y1))

    # or with full control:
    c = codec.Codec(preset="visually_lossless", container="jp2")
    data = c.compress_image(img)                 # core Image object
    img2 = c.decompress_image(data)

Every stream equals the reference's `compress` / `Codec` output byte for
byte. ROI and a custom MCT are coded and decoded on the device; the MQ
code-block styles other than 0 and HT refinement passes take the host
Tier-1 coders behind the device's transforms. What the port's encoder
and decoder do not cover raises NotImplementedError
(`codestream/encoder.py`, `codestream/decoder.py`): ROI on HT
code-blocks in a stream, and the host routes on a mesh of more than one
device.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple, Union

import numpy as np

from .codestream import decoder as _decoder
from .codestream import encoder as _encoder
from .codestream import jp2 as _jp2
from .core.image import Component, Image
from .core.params import (CBLKSTY_HT, DecoderParams, EncoderParams,
                          Progression, Transform)
from .utils.device import DeviceLike

PRESETS = {
    # name: EncoderParams factory
    "lossless": lambda: EncoderParams(),
    "lossless_fast": lambda: EncoderParams(cblk_style=CBLKSTY_HT),
    "visually_lossless": lambda: EncoderParams(
        transform=Transform.DWT_97, quality_psnr=(45.0,)),
    "web": lambda: EncoderParams(
        transform=Transform.DWT_97, rates=(20.0,),
        progression=Progression.RPCL),
    "archival": lambda: EncoderParams(
        numlayers=3, rates=(40.0, 10.0, 0.0)),
}


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


def _wrap(cs: bytes, image: Image, container: str) -> bytes:
    """The codestream, or with `container="jp2"` a JP2 file of it."""
    if container == "jp2":
        return _jp2.wrap_codestream(
            cs, image.xsiz, image.ysiz,
            [(c.prec, c.signed) for c in image.components])
    return cs


@dataclasses.dataclass
class Codec:
    """Reusable encoder/decoder configuration."""

    params: Optional[EncoderParams] = None
    preset: Optional[str] = None
    container: str = "j2k"          # "j2k" raw codestream | "jp2" boxed
    device: DeviceLike = "cuda"

    def _params(self) -> EncoderParams:
        if self.params is not None:
            return self.params
        if self.preset is not None:
            return PRESETS[self.preset]()
        return EncoderParams()

    def compress_image(self, image: Image) -> bytes:
        cs = _encoder.encode(image, self._params(), device=self.device)
        return _wrap(cs, image, self.container)

    def decompress_image(self, data: bytes,
                         params: Optional[DecoderParams] = None) -> Image:
        return _decoder.decode(data, params, self.device)


def _compress_params(lossless: bool = True, psnr: Optional[float] = None,
                     ratio: Optional[Union[float, Sequence[float]]] = None,
                     ht: bool = False,
                     tile_size: Optional[Tuple[int, int]] = None
                     ) -> EncoderParams:
    """The parameters of `compress`'s options, as the reference derives
    them."""
    kw = {}
    if tile_size:
        kw["tile_size"] = tile_size
    if ht:
        kw["cblk_style"] = CBLKSTY_HT
    if psnr is not None:
        return EncoderParams(transform=Transform.DWT_97,
                             quality_psnr=(psnr,), **kw)
    if ratio is not None:
        rates = tuple(ratio) if isinstance(ratio, (tuple, list)) \
            else (float(ratio),)
        return EncoderParams(transform=Transform.DWT_97, rates=rates,
                             numlayers=len(rates), **kw)
    if lossless:
        return EncoderParams(**kw)
    return EncoderParams(transform=Transform.DWT_97, **kw)


def compress(array: np.ndarray, *, lossless: bool = True,
             psnr: Optional[float] = None,
             ratio: Optional[Union[float, Sequence[float]]] = None,
             ht: bool = False,
             prec: int = 8,
             tile_size: Optional[Tuple[int, int]] = None,
             container: str = "j2k",
             device: DeviceLike = "cuda") -> bytes:
    """One-call compression of a numpy array: lossless 5/3 by default, a
    9/7 PSNR target (`psnr`), 9/7 byte targets (`ratio`, one compression
    ratio or one a layer), lossy 9/7 at the default step
    (`lossless=False`), the HT block coder (`ht`), tiles (`tile_size`),
    a JP2 file (`container="jp2"`)."""
    params = _compress_params(lossless, psnr, ratio, ht, tile_size)
    c = Codec(params=params, container=container, device=device)
    return c.compress_image(to_image(array, prec=prec))


def compress_batch(arrays: Sequence[np.ndarray], *, prec: int = 8,
                   container: str = "j2k", device: DeviceLike = "cuda",
                   workers: int = 0, **kwargs) -> List[bytes]:
    """Compress a batch of arrays, in order, with `compress`'s options;
    each stream equals `compress` of its array alone. Untiled arrays of
    one shape encode together through `encoder.encode_batch` (stacked on
    the device a chunk at a time); an array alone or in more than one
    tile goes through `encoder.encode`, which stacks the image's
    same-plan tiles (`encode_batch` would launch once a tile position).

    `workers` is accepted as the reference's is (its thread pool of
    per-image host encodes) and unused: the device codes a batch in one
    call, and the only host pools left (T2, the image-wide allocator's,
    which must admit every tile at once) size themselves."""
    arrays = list(arrays)
    params = _compress_params(**kwargs)
    groups: dict = {}
    for i, a in enumerate(arrays):
        groups.setdefault(np.shape(a), []).append(i)
    out: List[Optional[bytes]] = [None] * len(arrays)
    for idx in groups.values():
        imgs = [to_image(arrays[i], prec=prec) for i in idx]
        if len(imgs) > 1 and _encoder.tile_count(imgs[0], params) == 1:
            streams = _encoder.encode_batch(imgs, params, device=device)
        else:
            streams = [_encoder.encode(im, params, device=device)
                       for im in imgs]
        for i, img, cs in zip(idx, imgs, streams):
            out[i] = _wrap(cs, img, container)
    return out  # type: ignore[return-value]


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
                     device: DeviceLike = "cuda",
                     workers: int = 0) -> List[np.ndarray]:
    """Decompress a batch of streams, in order; each output equals
    `decompress` of its stream alone. Streams that `decoder.decode_batch`
    can take together (equal SIZ, COD and QCD, the same COC / QCC
    overrides and POC, and packed headers in all or none:
    `decoder.batch_key`) decode together, the others apart. `workers` is
    accepted as the reference's is and unused, as in `compress_batch`."""
    streams = list(streams)
    params = DecoderParams(reduce=reduce, layers=layers, window=window)
    groups: List[Tuple[tuple, List[int]]] = []
    for i, d in enumerate(streams):
        key = _decoder.batch_key(_decoder.read_header(
            _jp2.extract_codestream(d) if _jp2.is_jp2(d) else d))
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
