"""HT cleanup-pass group decoder: the wrapper of the CUDA kernel.

Port of `grokimagecompression_tpu/ops/ht_dec_pallas.py`
(`decode_group_pallas`). `decode_group(mel, vlc, ms, w, h, tables)` takes
a lane group's three (W, B) int32 stream-word matrices (uint32 bit
patterns from `native/ht_prepass.py`, lanes-last) and the decode LUTs
(`tables["dec0"]`, `tables["dec1"]`, (1024,) int32, from
`ht_tables.device_dec_tables`), and returns (mags, signs), (B, 2*ny, 4*nx)
int32: magnitudes in the decoder's centred (v+2)>>1 form and sign
bits, on the padded sample grid of `ht_dec_torch.grid_dims`.

A CUDA tensor launches the kernel of `csrc/ht_dec.cu` (and counts the
launch in `LAUNCHES`) or raises; a CPU tensor takes the plain version
`ht_dec_torch.decode_group_plain`.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from . import _build
from .ht_dec_torch import decode_group_plain, grid_dims

LAUNCHES = {"dec": 0}


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
    for k in ("dec0", "dec1"):
        t = tables[k]
        if t.shape != (1024,) or t.dtype != torch.int32 \
                or t.device != mel.device or not t.is_contiguous():
            raise ValueError(f"table {k}: expected a contiguous (1024,) "
                             f"int32 tensor on {mel.device}")
    if mel.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {mel.device}")


def decode_group(mel: torch.Tensor, vlc: torch.Tensor, ms: torch.Tensor,
                 w: int, h: int, tables: Dict[str, torch.Tensor]
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Decode a lane group of w x h HT cleanup segments (see module
    docstring)."""
    _check(mel, vlc, ms, tables)
    if mel.device.type == "cpu":
        return decode_group_plain(mel, vlc, ms, w, h, tables["dec0"],
                                  tables["dec1"])
    B = mel.shape[1]
    nx, ny, _ = grid_dims(w, h)
    mags = torch.empty((B, 2 * ny, 4 * nx), dtype=torch.int32,
                       device=mel.device)
    signs = torch.empty_like(mags)
    if B == 0:
        return mags, signs
    lib = _build.load()
    with torch.cuda.device(mel.device):
        stream = torch.cuda.current_stream(mel.device).cuda_stream
        rc = lib.ht_dec_group(
            mel.data_ptr(), vlc.data_ptr(), ms.data_ptr(), mel.shape[0],
            vlc.shape[0], ms.shape[0], B, w, h, tables["dec0"].data_ptr(),
            tables["dec1"].data_ptr(), mags.data_ptr(), signs.data_ptr(),
            stream)
    if rc != 0:
        raise RuntimeError(f"ht_dec_group launch failed: CUDA error {rc}")
    LAUNCHES["dec"] += 1
    return mags, signs
