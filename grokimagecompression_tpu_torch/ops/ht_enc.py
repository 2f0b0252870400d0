"""HT cleanup-pass encoder for a shape group of code-blocks: the CUDA
kernel's wrapper and its plain version.

Port of the HT encode of `grokimagecompression_tpu/ops/ht_jax.py`: the
Pallas scans of `ops/ht_scan_pallas.py` (`mel_scan`, and `vlc_scan` /
`ms_scan` through `_grid_scan_call`) with the op-stream build
(`_encode_streams`), the termination metrics (`_group_metrics`) and the
host splice (`assemble_segments_host`) folded in. Contract, shared by
the kernel and the plain version:

    encode_segments(coeffs int32 (B, 2 qh, 2 qw), mbs int32 (B,), tables)
        -> (data uint8 (N,), lens int32 (B,))

`coeffs` are one shape group's padded code-blocks (`FusedHTEncoder.
group_inputs`): the sign is the sign bit and the magnitude is read as
uint32 under the mask of the lane's Mb (its Mb + 1 low bits; all 32 from
Mb = 31 up, as in the reference); a block holds at most MAX_SAMPLES
samples. `data` holds every lane's finished HT cleanup
segment, lane after lane, and `lens` their lengths. `tables` is
`ht_tables.device_tables(device)` (or `ht_tables.tables_on`).

A CUDA tensor launches `csrc/ht_enc.cu` (counted in `LAUNCHES`) or
raises: each lane writes its segment in place into a region of
`lane_bounds` bytes (the bound is proved in the kernel's source), and a
second small kernel packs the regions to their lengths (`pack`);
`segment_lengths`, the step search of HT rate control, stops before
the pack. A CPU tensor takes the plain version, `encode_segments_plain`: the
torch op streams (`ht_torch.op_streams`), the plain scans of
`ops/ht_scan.py`, `ht_torch.group_metrics` and `place_words`, then
`ht_tables.assemble_segments_host`. The plain version runs on either
device (`chip_smoke.py` holds the kernel to it on the card); no route on
the card calls it.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from . import _build, ht_tables, ht_torch

LAUNCHES = {"enc": 0}

# samples a code-block may hold (ISO/IEC 15444-1: at most 4096)
MAX_SAMPLES = 4096
TABLE_WORDS = 2048 + 33

Segments = Tuple[torch.Tensor, torch.Tensor]


def _check(coeffs: torch.Tensor, mbs: torch.Tensor,
           tables: Dict[str, torch.Tensor]) -> None:
    if coeffs.dim() != 3 or coeffs.shape[1] < 2 or coeffs.shape[2] < 2 \
            or coeffs.shape[1] % 2 or coeffs.shape[2] % 2:
        raise ValueError(f"expected (B, 2 qh, 2 qw) code-blocks, got "
                         f"{tuple(coeffs.shape)}")
    if coeffs.shape[1] * coeffs.shape[2] > MAX_SAMPLES:
        raise ValueError(f"a code-block of {coeffs.shape[1]} x "
                         f"{coeffs.shape[2]} samples is above "
                         f"{MAX_SAMPLES}")
    if coeffs.dtype != torch.int32 or mbs.dtype != torch.int32:
        raise TypeError(f"expected int32 coefficients and Mb, got "
                        f"{coeffs.dtype} and {mbs.dtype}")
    if mbs.shape != coeffs.shape[:1]:
        raise ValueError(f"mbs: expected ({coeffs.shape[0]},), got "
                         f"{tuple(mbs.shape)}")
    if coeffs.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {coeffs.device}")
    packed = tables["enc_packed"]
    for name, a in (("mbs", mbs), ("enc_packed", packed)):
        if a.device != coeffs.device:
            raise ValueError(f"{name} on {a.device}, coefficients on "
                             f"{coeffs.device}")
    if packed.shape != (TABLE_WORDS,) or packed.dtype != torch.int32:
        raise ValueError(f"enc_packed: expected a ({TABLE_WORDS},) int32 "
                         f"table, got {tuple(packed.shape)} {packed.dtype}")
    if not (coeffs.is_contiguous() and mbs.is_contiguous()
            and packed.is_contiguous()):
        raise ValueError("inputs must be contiguous")


def _check_mb(lo: int) -> None:
    if lo < 0:
        raise ValueError(f"Mb must not be negative, got {lo}")


def lane_bounds(mbs: np.ndarray, qh: int, qw: int) -> np.ndarray:
    """(B,) int64: the most bytes each lane's segment can take, from its
    Mb: floor((4 nq m + 48 np + 5) / 7) + 4 with nq = qh qw quads, np =
    qh ceil(qw / 2) quad pairs and m = min(Mb + 2, 32) (see
    `csrc/ht_enc.cu` for the proof)."""
    m = np.minimum(mbs.astype(np.int64) + 2, 32)
    npairs = qh * ((qw + 1) // 2)
    return (4 * qh * qw * m + 48 * npairs + 5) // 7 + 4


def encode_segments_plain(coeffs: torch.Tensor, mbs: torch.Tensor,
                          tables: Dict[str, torch.Tensor]) -> Segments:
    """The plain version: the torch op streams and plain scans, the
    metrics, the exact word placement and the host splice. Runs on the
    device of `coeffs` up to the splice."""
    _check(coeffs, mbs, tables)
    dev = coeffs.device
    B = coeffs.shape[0]
    if B == 0:
        return (torch.empty(0, dtype=torch.uint8, device=dev),
                torch.empty(0, dtype=torch.int32, device=dev))
    lo, hi = int(mbs.min()), int(mbs.max())
    _check_mb(lo)
    mag = coeffs.to(torch.int64).abs()
    streams = ht_torch.encode_streams(mag, coeffs < 0, mbs, tables, hi)
    metrics = ht_torch.group_metrics(B, *streams)
    words = ht_torch.place_words([streams])
    segs = ht_tables.assemble_segments_host(words.cpu().numpy(),
                                            metrics.cpu().numpy())
    lens = np.fromiter((len(s) for s in segs), np.int32, B)
    data = np.frombuffer(b"".join(segs), np.uint8).copy()
    return torch.from_numpy(data).to(dev), torch.from_numpy(lens).to(dev)


def to_device(a: np.ndarray, dev: torch.device) -> torch.Tensor:
    """A host array on the card `dev` without waiting for the device: a
    pinned copy, sent asynchronously on the current stream."""
    return torch.from_numpy(np.ascontiguousarray(a)).pin_memory().to(
        dev, non_blocking=True)


def encode_into(coeffs: torch.Tensor, mbs: torch.Tensor,
                tables: Dict[str, torch.Tensor],
                mbs_host: Optional[np.ndarray] = None):
    """Launch the kernel on CUDA tensors (checked by the caller): lane b
    writes its segment from `out[off[b]]` into a region of
    `lane_bounds` bytes, laid out on the host from `mbs_host`, the lanes'
    Mb as the caller holds them, or else from one copy of `mbs` (a
    synchronisation). Returns (out (N,) uint8, off (B + 1,) int64,
    lens (B,) int32)."""
    dev = coeffs.device
    B, H, W = coeffs.shape
    qh, qw = H // 2, W // 2
    lens = torch.empty(B, dtype=torch.int32, device=dev)
    if B == 0:
        return (torch.empty(0, dtype=torch.uint8, device=dev),
                torch.zeros(1, dtype=torch.int64, device=dev), lens)
    mb = mbs.cpu().numpy() if mbs_host is None else np.asarray(mbs_host)
    if mb.shape != (B,):
        raise ValueError(f"mbs_host: expected ({B},), got {mb.shape}")
    _check_mb(int(mb.min()))
    off_np = np.zeros(B + 1, np.int64)
    np.cumsum(lane_bounds(mb, qh, qw), out=off_np[1:])
    off = to_device(off_np, dev)
    out = torch.empty(int(off_np[-1]), dtype=torch.uint8, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = _build.load().ht_enc_group(
            coeffs.data_ptr(), mbs.data_ptr(),
            tables["enc_packed"].data_ptr(), off.data_ptr(),
            out.data_ptr(), lens.data_ptr(), B, qh, qw,
            min(int(mb.max()) + 2, 32), stream)
    if rc != 0:
        raise RuntimeError(f"ht_enc_group launch failed: CUDA error {rc}")
    LAUNCHES["enc"] += 1
    return out, off, lens


def pack(out: torch.Tensor, off: torch.Tensor,
         lens: torch.Tensor) -> torch.Tensor:
    """The lanes' segments, each `lens[b]` bytes from `out[off[b]]`,
    packed lane after lane on the card (one synchronisation, for the
    total)."""
    B = lens.shape[0]
    ends = torch.cumsum(lens, 0, dtype=torch.int64)
    data = torch.empty(int(ends[-1]) if B else 0, dtype=torch.uint8,
                       device=out.device)
    if B == 0:
        return data
    with torch.cuda.device(out.device):
        rc = _build.load().ht_enc_pack(
            out.data_ptr(), off.data_ptr(), lens.data_ptr(),
            ends.data_ptr(), data.data_ptr(), B,
            torch.cuda.current_stream(out.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"ht_enc_pack launch failed: CUDA error {rc}")
    return data


def encode_segments(coeffs: torch.Tensor, mbs: torch.Tensor,
                    tables: Dict[str, torch.Tensor],
                    mbs_host: Optional[np.ndarray] = None) -> Segments:
    """Encode a shape group of code-blocks into HT cleanup segments (see
    the module docstring for the contract); `mbs_host`, the lanes' Mb on
    the host where the caller holds them, spares the kernel's wrapper its
    copy of `mbs`."""
    _check(coeffs, mbs, tables)
    if coeffs.device.type == "cpu":
        return encode_segments_plain(coeffs, mbs, tables)
    out, off, lens = encode_into(coeffs, mbs, tables, mbs_host)
    return pack(out, off, lens), lens


def segment_lengths(coeffs: torch.Tensor, mbs: torch.Tensor,
                    tables: Dict[str, torch.Tensor],
                    mbs_host: Optional[np.ndarray] = None) -> torch.Tensor:
    """The lanes' segment lengths, (B,) int32, alone: what HT rate
    control's step search reads. On the card one launch of the kernel,
    with nothing packed and nothing waited for (given `mbs_host`); on the
    CPU the plain version's lengths."""
    _check(coeffs, mbs, tables)
    if coeffs.device.type == "cpu":
        return encode_segments_plain(coeffs, mbs, tables)[1]
    return encode_into(coeffs, mbs, tables, mbs_host)[2]
