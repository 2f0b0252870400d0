"""Part-1 MQ group decoder: lane packing and the wrapper of the CUDA kernel.

Port of `grokimagecompression_tpu/ops/mq_dec_pallas.py`
(`decode_core_pallas`). `decode_group(data, off, nbps, npas, ori, w, h)`
decodes a lane group of w x h code-blocks of the default code-block
style from their raw codeword segments, laid out by `pack_lanes`: the
segments concatenated (`data`, uint8), lane b's at `off[b]:off[b + 1]`
(int64), with per lane the magnitude bit-planes `nbps`, the coding
passes `npas` and the band orientation `ori` (int32; 0, 0 and any
orientation for an idle lane). It returns (h*w, B) int32 samples
`sign << 31 | magnitude`, row-major, lanes last (and with
`with_stats=True` also (2, B) int32: decisions decoded and BYTEINs run
per lane).

A CUDA tensor launches the kernel of `csrc/mq_dec.cu` (and counts the
launch in `LAUNCHES`) or raises; a CPU tensor takes the plain version
`mq_dec_torch.decode_group_plain`. The kernel takes the lanes in the
order of `lane_order` (most passes first, then most segment bytes), so
that the lanes of a warp end together; it writes each lane's samples to
the lane's own column, so the output stays in lane order. The TPU kernel's host unstuffing into
field words, its power-of-two byte buckets and (S, 128) lane blocking
are gone: the kernel reads the raw bytes at their exact offsets.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

from . import _build
from .mq_dec_torch import decode_group_plain

LAUNCHES = {"mq_dec": 0}

# The sign rides in bit 31 of a sample, so magnitudes need <= 30 planes
# (the reference's `kmax <= 30` gate of its MQ kernel).
MAX_PLANES = 30
# Code-block area limit of the standard (xcb + ycb <= 12).
MAX_AREA = 4096


def pack_lanes(segs: Sequence[bytes], orients: Sequence[int],
               numbps: Sequence[int], numpasses: Sequence[int]
               ) -> Tuple[np.ndarray, ...]:
    """The kernel's lane arrays: (data uint8 (N,), off int64 (B + 1,),
    nbps, npas, ori int32 (B,))."""
    lens = np.fromiter((len(s) for s in segs), np.int64, len(segs))
    off = np.zeros(len(segs) + 1, np.int64)
    np.cumsum(lens, out=off[1:])
    data = np.frombuffer(b"".join(bytes(s) for s in segs), np.uint8).copy()
    return (data, off, np.asarray(numbps, np.int32).reshape(-1),
            np.asarray(numpasses, np.int32).reshape(-1),
            np.asarray(orients, np.int32).reshape(-1))


def _check(data, off, nbps, npas, ori, w: int, h: int) -> None:
    B = nbps.shape[0] if nbps.dim() == 1 else -1
    if data.dim() != 1 or data.dtype != torch.uint8:
        raise TypeError(f"data: expected a (N,) uint8 tensor, got "
                        f"{tuple(data.shape)} {data.dtype}")
    if off.dim() != 1 or off.dtype != torch.int64 or off.shape[0] != B + 1:
        raise ValueError(f"off: expected ({B + 1},) int64 offsets, got "
                         f"{tuple(off.shape)} {off.dtype}")
    for name, a in (("nbps", nbps), ("npas", npas), ("ori", ori)):
        if a.dim() != 1 or a.shape[0] != B or a.dtype != torch.int32:
            raise ValueError(f"{name}: expected ({B},) int32, got "
                             f"{tuple(a.shape)} {a.dtype}")
    for name, a in (("off", off), ("nbps", nbps), ("npas", npas),
                    ("ori", ori)):
        if a.device != data.device:
            raise ValueError(f"{name} on {a.device}, data on {data.device}")
        if not a.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if not data.is_contiguous():
        raise ValueError("data must be contiguous")
    if data.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {data.device}")
    if not (w >= 1 and h >= 1 and w * h <= MAX_AREA):
        raise ValueError(f"block {w}x{h}: expected 1 <= w, h and "
                         f"w*h <= {MAX_AREA}")
    if B == 0:
        return
    bad = ((nbps < 0) | (nbps > MAX_PLANES) | (npas < 0) | (ori < 0)
           | (ori > 3)).any() | (off[1:] < off[:-1]).any() \
        | (off[0] < 0) | (off[-1] > data.shape[0])
    if bool(bad):
        raise ValueError(f"lane arrays out of range: need 0 <= nbps <= "
                         f"{MAX_PLANES}, npas >= 0, 0 <= ori <= 3 and "
                         f"non-decreasing offsets inside the data")


def lane_order(off: torch.Tensor, nbps: torch.Tensor,
               npas: torch.Tensor) -> torch.Tensor:
    """(B,) int32: the lanes by work, descending: the passes the decoder
    walks (npas, at most 3 nbps - 2), then the segment bytes; ties keep
    lane order."""
    nb = nbps.to(torch.int64)
    passes = torch.where(nb > 0, torch.minimum(npas.to(torch.int64),
                                               3 * nb - 2), 0)
    key = (passes << 40) | (off[1:] - off[:-1])
    return torch.argsort(key, descending=True, stable=True).to(torch.int32)


def decode_group(data: torch.Tensor, off: torch.Tensor, nbps: torch.Tensor,
                 npas: torch.Tensor, ori: torch.Tensor, w: int, h: int,
                 with_stats: bool = False):
    """Decode a lane group of w x h MQ code-blocks (see the module
    docstring)."""
    _check(data, off, nbps, npas, ori, w, h)
    if data.device.type == "cpu":
        return decode_group_plain(data, off, nbps, npas, ori, w, h,
                                  with_stats)
    B = nbps.shape[0]
    dev = data.device
    out = torch.zeros((h * w, B), dtype=torch.int32, device=dev)
    stats = torch.empty((2, B), dtype=torch.int32, device=dev)
    if B:
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            order = lane_order(off, nbps, npas)
            rc = _build.load().mq_dec_group(
                data.data_ptr(), off.data_ptr(), nbps.data_ptr(),
                npas.data_ptr(), ori.data_ptr(), order.data_ptr(), B, w, h,
                out.data_ptr(), stats.data_ptr(), stream)
        if rc != 0:
            raise RuntimeError(f"mq_dec_group launch failed: CUDA error {rc}")
        LAUNCHES["mq_dec"] += 1
    return (out, stats) if with_stats else out
