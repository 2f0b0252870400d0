"""The MQ coder over a slot stream: CUDA kernel and plain torch.

Port of `grokimagecompression_tpu/ops/mq_scan_pallas.py`
(`mq_scan_compact_blocked`) with the host FLUSH and splice of
`ops/mq_jax.py` folded in. Contract, shared by the kernel and the plain
version (`mq_torch.mq_scan_plain`):

    mq_scan(slots (T, B) int8) -> (data uint8 (N,), lens int32 (B,),
                                   state int32 (NSTATE, B))

`data` holds every lane's complete codeword segment (scan bytes, then
the FLUSH tail with the trailing 0xFF dropped), lane after lane, `lens`
their lengths, and `state` the coder state at the end of the scan before
the flush (A, C, CT, the delayed byte, the five packed context words).

A CUDA tensor launches `csrc/mq_scan.cu` (counted in `LAUNCHES`) or
raises; a CPU tensor takes the plain version. On the card the segments
are laid out by an exact per-lane bound from the lane's count E of
emitting slots (15 E / 7 + 3 bytes, see the kernel's source), written in
place by the kernel, and packed to their true lengths by one gather.
"""

from __future__ import annotations

from typing import Tuple

import torch

from . import _build, mq_torch
from .mq_tables import NSTATE

LAUNCHES = {"mq": 0}


def _check(slots: torch.Tensor) -> None:
    if slots.dim() != 2:
        raise ValueError(f"expected a (T, B) slot stream, got "
                         f"{tuple(slots.shape)}")
    if slots.dtype != torch.int8:
        raise TypeError(f"expected int8 slots, got {slots.dtype}")
    if slots.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {slots.device}")
    if not slots.is_contiguous():
        raise ValueError("the slot stream must be contiguous")


def segment_offsets(slots: torch.Tensor) -> Tuple[torch.Tensor, int]:
    """Byte offsets of the lanes' segment regions, (B + 1,) int64 on the
    slots' device, from each lane's bound 15 E / 7 + 3; and the buffer
    size (one synchronisation)."""
    emits = (slots & 1).sum(dim=0)
    bound = (15 * emits) // 7 + 3
    off = torch.zeros(slots.shape[1] + 1, dtype=torch.int64,
                      device=slots.device)
    torch.cumsum(bound, 0, out=off[1:])
    return off, int(off[-1])


def scan_into(slots: torch.Tensor, off: torch.Tensor, total: int):
    """Launch the kernel: lane b writes its segment from `out[off[b]]`.
    Returns (out (total,) uint8, lens (B,) int32, state (NSTATE, B))."""
    T, B = slots.shape
    dev = slots.device
    out = torch.empty(max(total, 1), dtype=torch.uint8, device=dev)
    lens = torch.empty(B, dtype=torch.int32, device=dev)
    state = torch.empty((NSTATE, B), dtype=torch.int32, device=dev)
    if B == 0:
        return out, lens, state
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = _build.load().mq_scan(slots.data_ptr(), T, B, off.data_ptr(),
                                   out.data_ptr(), lens.data_ptr(),
                                   state.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"mq_scan launch failed: CUDA error {rc}")
    LAUNCHES["mq"] += 1
    return out, lens, state


def pack_segments(out: torch.Tensor, off: torch.Tensor,
                  lens: torch.Tensor) -> torch.Tensor:
    """The lanes' segments, each `lens[b]` bytes from `out[off[b]]`,
    concatenated lane after lane (one synchronisation, one gather)."""
    lens = lens.to(torch.int64)
    ends = torch.cumsum(lens, 0)
    total = int(ends[-1]) if lens.numel() else 0
    pos = torch.arange(total, device=out.device)
    lane = torch.searchsorted(ends, pos, right=True)
    return out[off[lane] + pos - (ends - lens)[lane]]


def mq_scan(slots: torch.Tensor):
    """The MQ coder over every lane of a (T, B) int8 slot stream (see the
    module docstring for the contract)."""
    _check(slots)
    if slots.device.type == "cpu":
        return mq_torch.mq_scan_plain(slots)
    off, total = segment_offsets(slots)
    out, lens, state = scan_into(slots, off, total)
    return pack_segments(out, off, lens), lens, state
