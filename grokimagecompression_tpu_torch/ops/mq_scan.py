"""The MQ coder over a slot stream: CUDA kernel and plain torch.

Port of `grokimagecompression_tpu/ops/mq_scan_pallas.py`
(`mq_scan_compact_blocked`) with the host FLUSH and splice of
`ops/mq_jax.py` folded in. Contract, shared by the kernel and the plain
version (`mq_torch.mq_scan_plain`):

    mq_scan(slots (T, B) int8) -> (data uint8 (N,), lens int32 (B,),
                                   state int32 (NSTATE, B))
    mq_scan(slots, spans) -> (data, lens, state, cumbo int32 (3 T / tp, B))

`data` holds every lane's complete codeword segment (scan bytes, then
the FLUSH tail with the trailing 0xFF dropped), lane after lane, `lens`
their lengths, and `state` the coder state at the end of the scan before
the flush (A, C, CT, the delayed byte, the five packed context words).
With `spans` = (sa, sb, sc), the slot sections of one plane's SPP, MRP
and CLN passes (`mq_torch.pass_spans_padded`, tp = sa + sb + sc), the
scan also returns `cumbo`: each lane's byte-out count at the end of
every pass, plane after plane (the rate control's truncation lengths;
the reference's `pass_cum_byteouts` over its per-256-slot sums).

A CUDA tensor launches `csrc/mq_scan.cu` (counted in `LAUNCHES`) or
raises; a CPU tensor takes the plain version. On the card the segments
are laid out by an exact per-lane bound from the lane's count E of
emitting slots (15 E / 7 + 3 bytes, see the kernel's source), written in
place by the kernel, and packed to their true lengths by one gather.

`encode_blocks` is the whole block coder on a list of quantized blocks
(slot build, scan, R-D tables), the counterpart of
`mq_jax.mq_encode_blocks`.

`run_mq_scans` and `run_mq_scans_blocked` are the dense-output scan, the
counterparts of `mq_jax.run_mq_scans` / `run_mq_scans_blocked` (the
Pallas `mq_scan_pallas.mq_scan` / `mq_scan_blocked`): per step the word
completed, its chunk-local index and the byte-outs, and the reference's
11-word state (`mq_torch.mq_scan_dense_plain` gives the contract). A CUDA
tensor launches `csrc/mq_dense.cu`'s `mq_scan_dense` (counted in
`LAUNCHES["mq_dense"]`) or raises; a CPU tensor takes the plain version.
Both kernels share the coder of `csrc/mq_coder.cuh`.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from ..utils.device import DeviceLike, resolve_device
from . import _build, mq_torch
from .mq_tables import DENSE_CHUNK, DENSE_NSTATE, NSTATE

LAUNCHES = {"mq": 0, "mq_dense": 0}


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


# bytes of temporaries `lane_emits` may take at once
EMIT_BLOCK_BYTES = 1 << 28


def lane_emits(slots: torch.Tensor) -> torch.Tensor:
    """(B,) int64: each lane's count E of emitting slots. A reduction to
    int64 copies its int8 input to int64 first (8 bytes a slot: 7 GB for
    one config-2 frame), so the rows are summed in blocks of at most
    EMIT_BLOCK_BYTES of temporaries."""
    T, B = slots.shape
    emits = torch.zeros(B, dtype=torch.int64, device=slots.device)
    rows = max(1, EMIT_BLOCK_BYTES // (9 * max(B, 1)))
    for lo in range(0, T, rows):
        emits += (slots[lo:lo + rows] & 1).sum(dim=0)
    return emits


def segment_offsets(slots: torch.Tensor) -> Tuple[torch.Tensor, int]:
    """Byte offsets of the lanes' segment regions, (B + 1,) int64 on the
    slots' device, from each lane's bound 15 E / 7 + 3; and the buffer
    size (one synchronisation)."""
    emits = lane_emits(slots)
    bound = (15 * emits) // 7 + 3
    off = torch.zeros(slots.shape[1] + 1, dtype=torch.int64,
                      device=slots.device)
    torch.cumsum(bound, 0, out=off[1:])
    return off, int(off[-1])


def _pass_rows(T: int, spans) -> int:
    """Pass ends in a stream of T slots of whole planes of `spans`."""
    tp = sum(spans)
    if T % tp or any(s % 256 for s in spans):
        raise ValueError(f"a stream of {T} slots is not whole planes of "
                         f"256-slot-aligned passes {tuple(spans)}")
    return 3 * (T // tp)


def scan_into(slots: torch.Tensor, off: torch.Tensor, total: int,
              spans=None):
    """Launch the kernel: lane b writes its segment from `out[off[b]]`.
    Returns (out (total,) uint8, lens (B,) int32, state (NSTATE, B)), and
    cumbo (3 T / tp, B) int32 when `spans` is given."""
    T, B = slots.shape
    dev = slots.device
    out = torch.empty(max(total, 1), dtype=torch.uint8, device=dev)
    lens = torch.empty(B, dtype=torch.int32, device=dev)
    state = torch.empty((NSTATE, B), dtype=torch.int32, device=dev)
    cumbo = None
    sa = sb = tp = 0
    if spans is not None:
        cumbo = torch.empty((_pass_rows(T, spans), B), dtype=torch.int32,
                            device=dev)
        sa, sb, tp = spans[0], spans[1], sum(spans)
    res = (out, lens, state) if cumbo is None else (out, lens, state, cumbo)
    if B == 0:
        return res
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = _build.load().mq_scan(
            slots.data_ptr(), T, B, off.data_ptr(), out.data_ptr(),
            lens.data_ptr(), state.data_ptr(),
            None if cumbo is None else cumbo.data_ptr(), sa, sb, tp, stream)
    if rc != 0:
        raise RuntimeError(f"mq_scan launch failed: CUDA error {rc}")
    LAUNCHES["mq"] += 1
    return res


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


def mq_scan(slots: torch.Tensor, spans=None):
    """The MQ coder over every lane of a (T, B) int8 slot stream, with the
    pass-end byte-outs when `spans` is given (see the module docstring
    for the contract)."""
    _check(slots)
    if spans is not None:
        _pass_rows(slots.shape[0], spans)
    if slots.device.type == "cpu":
        return mq_torch.mq_scan_plain(slots, spans)
    off, total = segment_offsets(slots)
    out, lens, *rest = scan_into(slots, off, total, spans)
    return (pack_segments(out, off, lens), lens, *rest)


def scan_dense(slots: torch.Tensor, t_out: int = 0):
    """The dense scan over t_out >= T rows (T when 0): (words, m8, nbo,
    state) as `mq_torch.mq_scan_dense_plain` returns them."""
    _check(slots)
    T, B = slots.shape
    t_out = t_out or T
    if t_out < T:
        raise ValueError(f"t_out {t_out} is below the stream's {T} rows")
    if slots.device.type == "cpu":
        return mq_torch.mq_scan_dense_plain(slots, t_out)
    dev = slots.device
    words, m8, nbo = (torch.empty((t_out, B), dtype=torch.int32, device=dev)
                      for _ in range(3))
    state = torch.empty((DENSE_NSTATE, B), dtype=torch.int32, device=dev)
    if B == 0:
        return words, m8, nbo, state
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = _build.load().mq_scan_dense(
            slots.data_ptr(), T, t_out, B, words.data_ptr(), m8.data_ptr(),
            nbo.data_ptr(), state.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"mq_scan_dense launch failed: CUDA error {rc}")
    LAUNCHES["mq_dense"] += 1
    return words, m8, nbo, state


def run_mq_scans(slots: torch.Tensor):
    """Flat dense scan of a (T, B) int8 slot stream, any B: words (T, B)
    int32, mask (T, B) bool (a word completes at the step), nbo (T, B)
    int32 and the state (DENSE_NSTATE, B) int32, as the reference's
    `mq_jax.run_mq_scans` (which returns the state as a tuple of rows)."""
    words, m8, nbo, state = scan_dense(slots)
    return words, m8 >= 0, nbo, state


def run_mq_scans_blocked(slots: torch.Tensor):
    """Blocked dense scan of a (T, B) int8 slot stream with B % 128 == 0:
    words, m8, nbo as (t_pad, B // 128, 128) int32 views, t_pad = T
    rounded up to a multiple of DENSE_CHUNK (the rows past T code no-op
    slots), and the state as (DENSE_NSTATE, B // 128, 128), as the
    reference's `mq_jax.run_mq_scans_blocked`."""
    T, B = slots.shape
    if B % 128:
        raise ValueError(f"the blocked scan needs B % 128 == 0, got B={B}")
    t_pad = -(-T // DENSE_CHUNK) * DENSE_CHUNK
    words, m8, nbo, state = scan_dense(slots, t_pad)
    blocked = (t_pad, B // 128, 128)
    return (words.view(blocked), m8.view(blocked), nbo.view(blocked),
            state.view(DENSE_NSTATE, B // 128, 128))


def encode_blocks(blocks, want_rd: bool = False,
                  device: DeviceLike = "cuda") -> List[Tuple]:
    """The MQ block coder (default code-block style) on a list of
    quantized code-blocks, as `mq_jax.mq_encode_blocks`: `blocks` is
    [(mag (h, w), neg (h, w) 0/1, orient), ...] of numpy arrays; returns
    [(data, numbps, numpasses), ...], or with `want_rd`
    [(data, numbps, numpasses, passes), ...] with each block's R-D pass
    table (`codestream.t2.PassInfo` list). Blocks are grouped by shape;
    each group is one slot build and one scan on `device` (the card
    unless the CPU is asked for by name)."""
    device = resolve_device(device)
    groups: Dict[Tuple[int, int], List[int]] = {}
    for i, (mag, _, _) in enumerate(blocks):
        groups.setdefault(mag.shape, []).append(i)
    results: List = [None] * len(blocks)
    for (h, w), idx in sorted(groups.items()):
        def stack(k, dtype):
            return torch.from_numpy(np.stack(
                [np.asarray(blocks[i][k]) for i in idx]).astype(dtype)
            ).to(device)
        mag = stack(0, np.int32)
        orient = torch.tensor([int(blocks[i][2]) for i in idx],
                              device=device)
        nbps = mq_torch.bit_planes(mag)
        npl = max(int(nbps.max()), 1)
        built = mq_torch.build_slot_stream(mag, stack(1, np.int32), orient,
                                           nbps, npl, want_dist=want_rd)
        slots, dists = built if want_rd else (built, None)
        spans = mq_torch.pass_spans_padded(h, w) if want_rd else None
        data, lens, _, *cumbo = mq_scan(slots, spans)
        lens_np = lens.cpu().numpy()
        nbs = nbps.cpu().numpy()
        buf = data.cpu().numpy().tobytes()
        ends = np.cumsum(lens_np, dtype=np.int64)
        if want_rd:
            rates, dcum = mq_torch.batch_pass_tables(
                lens_np.astype(np.int64), nbs, npl, cumbo[0].cpu().numpy(),
                dists.reshape(3 * npl, -1).cpu().numpy())
        for k, i in enumerate(idx):
            nb = int(nbs[k])
            seg = buf[ends[k] - lens_np[k]:ends[k]] if nb else b""
            results[i] = (seg, nb, 3 * nb - 2 if nb else 0)
            if want_rd:
                results[i] += (mq_torch.passes_from_tables(
                    nb, npl, rates[:, k], dcum[:, k]),)
    return results
