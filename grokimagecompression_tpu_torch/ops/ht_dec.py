"""HT cleanup-pass group decoder: the wrapper of the CUDA kernel.

Port of `grokimagecompression_tpu/ops/ht_dec_pallas.py`
(`decode_group_pallas`) and of the host prepass that feeds it
(`ht_dec_jax.prepass_all`).

`decode_segments(data, off, lcup, scup, w, h, tables)` decodes a lane
group of w x h code-blocks from their raw HT cleanup segments, packed as
`mq_dec.pack_lanes` packs segments (`pack_segments`): `data` (N,) uint8,
lane b's segment at `data[off[b]:off[b + 1]]` (`off` (B + 1,) int64),
with its length `lcup` and MEL + VLC suffix length `scup` ((B,) int32,
2 <= scup <= lcup <= the segment's bytes). It returns (mags, signs),
(B, 2*ny, 4*nx) int32: magnitudes in the decoder's centred (v+2)>>1 form
and sign bits, on the padded sample grid of `ht_dec_torch.grid_dims`;
`tables` holds the decode LUTs (`tables["dec0"]`, `tables["dec1"]`,
(1024,) int32, from `ht_tables.device_dec_tables`).

A CUDA tensor launches the kernel of `csrc/ht_dec.cu`, which unstuffs
the three streams itself (and counts the launch in `LAUNCHES`), or
raises; a CPU tensor takes the plain version: the host prepass
(`native/ht_prepass.ht_dec_prepass`) into stream words, then
`decode_group`, the plain decoder of those words.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np
import torch

from ..native import ht_prepass
from . import _build
from .ht_dec_torch import decode_group_plain, grid_dims

LAUNCHES = {"dec": 0}


def pack_segments(segs: Sequence[bytes], scups: Sequence[int]
                  ) -> Tuple[np.ndarray, ...]:
    """The kernel's lane arrays of HT cleanup segments: (data uint8 (N,),
    off int64 (B + 1,), lcup, scup int32 (B,)), lcup each segment's
    length."""
    lens = np.fromiter((len(s) for s in segs), np.int64, len(segs))
    off = np.zeros(len(segs) + 1, np.int64)
    np.cumsum(lens, out=off[1:])
    data = np.frombuffer(b"".join(bytes(s) for s in segs), np.uint8).copy()
    return (data, off, lens.astype(np.int32),
            np.asarray(scups, np.int32).reshape(-1))


def _check_tables(tables, device) -> None:
    for k in ("dec0", "dec1"):
        t = tables[k]
        if t.shape != (1024,) or t.dtype != torch.int32 \
                or t.device != device or not t.is_contiguous():
            raise ValueError(f"table {k}: expected a contiguous (1024,) "
                             f"int32 tensor on {device}")
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {device}")


def _check(mel, vlc, ms, tables) -> None:
    B = mel.shape[-1]
    for name, a in (("mel", mel), ("vlc", vlc), ("ms", ms)):
        if a.dim() != 2 or a.shape[1] != B or a.shape[0] < 2:
            raise ValueError(f"{name}: expected (W >= 2, {B}) stream words, "
                             f"got {tuple(a.shape)}")
        if a.dtype != torch.int32:
            raise TypeError(f"{name}: expected int32, got {a.dtype}")
        if a.device != mel.device:
            raise ValueError(f"{name} on {a.device}, mel on {mel.device}")
        if not a.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    _check_tables(tables, mel.device)


def decode_group(mel: torch.Tensor, vlc: torch.Tensor, ms: torch.Tensor,
                 w: int, h: int, tables: Dict[str, torch.Tensor]
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain decoder of a lane group's three (W, B) int32 stream-word
    matrices (uint32 bit patterns of `native/ht_prepass.py`, lanes-last):
    `decode_segments`' plain version after its prepass. CPU tensors
    only: on the card `decode_segments` reads the raw segments."""
    _check(mel, vlc, ms, tables)
    if mel.device.type != "cpu":
        raise ValueError("decode_group decodes prepass words on the CPU; "
                         "decode_segments decodes raw segments on the card")
    return decode_group_plain(mel, vlc, ms, w, h, tables["dec0"],
                              tables["dec1"])


def _check_segments(data, off, lcup, scup, tables) -> None:
    B = lcup.shape[0] if lcup.dim() == 1 else -1
    if data.dim() != 1 or data.dtype != torch.uint8:
        raise TypeError(f"data: expected a (N,) uint8 tensor, got "
                        f"{tuple(data.shape)} {data.dtype}")
    if off.dim() != 1 or off.dtype != torch.int64 or off.shape[0] != B + 1:
        raise ValueError(f"off: expected ({B + 1},) int64 offsets, got "
                         f"{tuple(off.shape)} {off.dtype}")
    for name, a in (("lcup", lcup), ("scup", scup)):
        if a.dim() != 1 or a.shape[0] != B or a.dtype != torch.int32:
            raise ValueError(f"{name}: expected ({B},) int32, got "
                             f"{tuple(a.shape)} {a.dtype}")
    for name, a in (("data", data), ("off", off), ("lcup", lcup),
                    ("scup", scup)):
        if a.device != data.device:
            raise ValueError(f"{name} on {a.device}, data on {data.device}")
        if not a.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    _check_tables(tables, data.device)
    if B == 0:
        return
    bad = ((scup < 2) | (scup > lcup) | (lcup > off[1:] - off[:-1])).any() \
        | (off[0] < 0) | (off[-1] > data.shape[0])
    if bool(bad):
        raise ValueError("lane arrays out of range: need 2 <= scup <= lcup "
                         "<= each segment's bytes, offsets inside the data")


def lane_order(lcup: torch.Tensor) -> torch.Tensor:
    """(B,) int32: the lanes by segment length, descending; ties keep
    lane order."""
    return torch.argsort(lcup, descending=True, stable=True).to(torch.int32)


def decode_segments(data: torch.Tensor, off: torch.Tensor,
                    lcup: torch.Tensor, scup: torch.Tensor, w: int, h: int,
                    tables: Dict[str, torch.Tensor]
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Decode a lane group of w x h HT cleanup segments (see the module
    docstring)."""
    _check_segments(data, off, lcup, scup, tables)
    B = lcup.shape[0]
    nx, ny, _ = grid_dims(w, h)
    mags = torch.empty((B, 2 * ny, 4 * nx), dtype=torch.int32,
                       device=data.device)
    signs = torch.empty_like(mags)
    if B == 0:
        return mags, signs
    if data.device.type == "cpu":
        o = off.numpy()
        raw = data.numpy().tobytes()
        segs = [raw[o[i]:o[i + 1]] for i in range(B)]
        words = ht_prepass.prepass_group(segs, lcup.tolist(), scup.tolist())
        return decode_group(*(torch.from_numpy(a.view(np.int32))
                              for a in words), w, h, tables)
    lib = _build.load()
    with torch.cuda.device(data.device):
        stream = torch.cuda.current_stream(data.device).cuda_stream
        order = lane_order(lcup)
        rc = lib.ht_dec_group(
            data.data_ptr(), off.data_ptr(), lcup.data_ptr(),
            scup.data_ptr(), order.data_ptr(), B, w, h,
            tables["dec0"].data_ptr(), tables["dec1"].data_ptr(),
            mags.data_ptr(), signs.data_ptr(), None, stream)
    if rc != 0:
        raise RuntimeError(f"ht_dec_group launch failed: CUDA error {rc}")
    LAUNCHES["dec"] += 1
    return mags, signs
