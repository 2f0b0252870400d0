"""ctypes binding for the host library's Tier-1 coders (csrc/host/t1.cpp,
csrc/host/ht.cpp).

A copy of entry points of `grokimagecompression_tpu/native/
t1_native.py`. The MQ coder: the per-block coder (`encode_cblk`,
`decode_cblk`), the block gather out of band planes (`extract_blocks`),
and the batch entries that code many blocks in one call on the
library's worker threads (`encode_cblk_batch`, `encode_cblk_batch_bands`,
`decode_cblk_batch`, `decode_cblk_batch_bands`); it codes every Part-1
code-block style. The HT coder: one block with refinement passes
(`ht_encode_cblk_refined`, `ht_decode_cblk_refined`), their batch forms
over band planes (`ht_encode_refined_batch_bands`,
`ht_decode_refined_batch_bands`, which the original does not have) and
the plain cleanup decode into band planes (`ht_decode_cblk_batch_bands`).
The port sends it only what its CUDA MQ and HT kernels do not code
(`t1/backend.py`). The library is built on first use
(`ops/_build.host_library`); a failed build raises, and there is no
Python coder behind it.
"""

from __future__ import annotations

import os
import threading
from typing import List, Optional, Sequence, Tuple

import numpy as np

from ..codestream.t2 import PassInfo
from ..ops import _build

MAX_PASSES = 3 * 32 - 2

# calls of the entry points below that code or gather blocks: none on the
# routes of the CUDA MQ and HT kernels; counted under a lock, as a mesh's
# shard threads call them at once
CALLS = {"t1": 0}
_calls_lock = threading.Lock()
_thread_override = threading.local()


def set_thread_override(n: Optional[int]) -> None:
    """Cap the batch entries' worker threads in the calling thread (None
    clears the cap), so that threads coding at once do not oversubscribe
    the cores (`parallel.sharding._code_shard`)."""
    _thread_override.value = n


def default_threads() -> int:
    """Worker threads of a batch call: the calling thread's cap
    (`set_thread_override`), else `GROK_TPU_THREADS`, else
    `os.cpu_count()`, as the reference's."""
    ov = getattr(_thread_override, "value", None)
    if ov:
        return max(1, int(ov))
    env = os.environ.get("GROK_TPU_THREADS")
    if env:
        return max(1, int(env))
    return os.cpu_count() or 1


def _lib():
    with _calls_lock:
        CALLS["t1"] += 1
    return _build.host_library()


def encode_cblk(mag: np.ndarray, neg: np.ndarray, orient: int,
                cblk_style: int = 0
                ) -> Tuple[bytes, int, int, List[PassInfo]]:
    """One code-block: (data, numbps, numpasses, per-pass table)."""
    h, w = mag.shape
    mag = np.ascontiguousarray(mag, dtype=np.uint32)
    neg = np.ascontiguousarray(neg, dtype=np.uint8)
    cap = max(4096, w * h * 6)
    out = np.empty(cap, dtype=np.uint8)
    meta = np.zeros(2, dtype=np.int32)
    rates = np.zeros(MAX_PASSES, dtype=np.int32)
    dist = np.zeros(MAX_PASSES, dtype=np.float64)
    term = np.zeros(MAX_PASSES, dtype=np.uint8)
    n = _lib().grok_t1_encode(
        mag.ctypes.data, neg.ctypes.data, w, h, orient, cblk_style,
        out.ctypes.data, cap, meta.ctypes.data, rates.ctypes.data,
        dist.ctypes.data, term.ctypes.data)
    if n < 0:
        raise RuntimeError("native T1 encode: output buffer overflow")
    numbps = int(meta[0])
    numpasses = int(meta[1])
    passes = [PassInfo(rate=int(rates[i]), distortion=float(dist[i]),
                       terminated=bool(term[i]))
              for i in range(numpasses)]
    return bytes(out[:n]), numbps, numpasses, passes


def decode_cblk(data: bytes, seg_lengths: Optional[List[int]], w: int, h: int,
                orient: int, numbps: int, numpasses: int,
                cblk_style: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    """One code-block's first `numpasses` passes: (mag, neg)."""
    mag = np.zeros((h, w), dtype=np.uint32)
    neg = np.zeros((h, w), dtype=np.uint8)
    buf = np.frombuffer(bytes(data), dtype=np.uint8) if data else \
        np.zeros(1, dtype=np.uint8)
    if seg_lengths:
        segs = np.asarray(seg_lengths, dtype=np.int32)
        nsegs = len(seg_lengths)
    else:
        segs = np.zeros(1, dtype=np.int32)
        nsegs = 0
    _lib().grok_t1_decode(
        buf.ctypes.data, len(data), segs.ctypes.data, nsegs, w, h, orient,
        numbps, numpasses, cblk_style, mag.ctypes.data, neg.ctypes.data)
    return mag, neg


def _band_meta(bands: Sequence[np.ndarray], stepsizes):
    ptrs = np.array([b.ctypes.data for b in bands], dtype=np.int64)
    strides = np.array([b.strides[0] // b.itemsize for b in bands],
                       dtype=np.int64)
    is_float = stepsizes is not None
    steps = np.asarray(stepsizes if is_float else [1.0] * len(bands),
                       np.float64)
    return ptrs, strides, steps, is_float


def extract_blocks(bands: Sequence[np.ndarray], descs: np.ndarray,
                   stepsizes=None, nthreads: Optional[int] = None
                   ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Gather code-blocks out of band planes natively.

    `bands`: 2-D arrays with unit column stride — int32 (reversible;
    abs/sign split) or, with `stepsizes` (one per band), float32 planes
    quantized with the deadzone quantizer during the gather. `descs`:
    (n, 5) int64 rows of (band_idx, x0, y0, w, h). Returns (mag_flat,
    neg_flat, offsets)."""
    n = len(descs)
    ptrs, strides, steps, is_float = _band_meta(bands, stepsizes)
    sizes = descs[:, 3] * descs[:, 4]
    offs = np.zeros(n, dtype=np.int64)
    np.cumsum(sizes[:-1], out=offs[1:])
    total = int(offs[-1] + sizes[-1]) if n else 0
    desc6 = np.ascontiguousarray(
        np.concatenate([descs, offs[:, None]], axis=1), dtype=np.int64)
    mag_flat = np.empty(max(1, total), dtype=np.uint32)
    neg_flat = np.empty(max(1, total), dtype=np.uint8)
    nt = nthreads if nthreads is not None else default_threads()
    if is_float:
        _lib().grok_extract_blocks_f32(
            n, ptrs.ctypes.data, strides.ctypes.data, steps.ctypes.data,
            desc6.ctypes.data, mag_flat.ctypes.data, neg_flat.ctypes.data,
            nt)
    else:
        _lib().grok_extract_blocks(
            n, ptrs.ctypes.data, strides.ctypes.data, desc6.ctypes.data,
            mag_flat.ctypes.data, neg_flat.ctypes.data, nt)
    return mag_flat, neg_flat, offs


def encode_cblk_batch(blocks: List[Tuple[np.ndarray, np.ndarray, int]],
                      cblk_style: int = 0, nthreads: Optional[int] = None
                      ) -> List[Tuple[bytes, int, int, List[PassInfo]]]:
    """Encode many code-blocks in one native call. `blocks` is a list of
    (mag, neg, orient); returns per block (data, numbps, numpasses,
    passes), as `encode_cblk`."""
    n = len(blocks)
    if n == 0:
        return []
    sizes = [b[0].size for b in blocks]
    offsets = np.zeros(n, dtype=np.int64)
    np.cumsum(sizes[:-1], out=offsets[1:])
    mag_flat = np.empty(int(sum(sizes)), dtype=np.uint32)
    neg_flat = np.empty(int(sum(sizes)), dtype=np.uint8)
    desc = np.empty((n, 4), dtype=np.int64)
    for i, (mag, neg, orient) in enumerate(blocks):
        h, w = mag.shape
        o = offsets[i]
        mag_flat[o:o + w * h] = mag.astype(np.uint32).ravel()
        neg_flat[o:o + w * h] = neg.astype(np.uint8).ravel()
        desc[i] = (o, w, h, orient)
    return _encode_flat(n, mag_flat, neg_flat, desc, cblk_style,
                        max(sizes), nthreads)


def _encode_flat(n, mag_flat, neg_flat, desc, cblk_style, max_wh, nthreads):
    out_stride = max(4096, max_wh * 6)
    out_flat = np.empty(n * out_stride, dtype=np.uint8)
    out_meta = np.zeros(n * 3, dtype=np.int32)
    rates = np.zeros(n * MAX_PASSES, dtype=np.int32)
    dist = np.zeros(n * MAX_PASSES, dtype=np.float64)
    term = np.zeros(n * MAX_PASSES, dtype=np.uint8)
    desc = np.ascontiguousarray(desc, dtype=np.int64)
    rc = _lib().grok_t1_encode_batch(
        n, mag_flat.ctypes.data, neg_flat.ctypes.data, desc.ctypes.data,
        cblk_style, out_flat.ctypes.data, out_stride, out_meta.ctypes.data,
        rates.ctypes.data, dist.ctypes.data, term.ctypes.data, MAX_PASSES,
        nthreads if nthreads is not None else default_threads())
    if rc != 0:
        raise RuntimeError("native T1 batch encode failed")
    meta = out_meta.reshape(n, 3).tolist()
    rates_l = rates.reshape(n, MAX_PASSES).tolist()
    dist_l = dist.reshape(n, MAX_PASSES).tolist()
    term_l = term.reshape(n, MAX_PASSES).tolist()
    buf = out_flat.tobytes()
    results = []
    for i, (ln, numbps, numpasses) in enumerate(meta):
        passes = [PassInfo(rate=rates_l[i][j], distortion=dist_l[i][j],
                           terminated=bool(term_l[i][j]))
                  for j in range(numpasses)]
        results.append((buf[i * out_stride:i * out_stride + ln], numbps,
                        numpasses, passes))
    return results


def encode_cblk_batch_bands(bands: Sequence[np.ndarray], descs: np.ndarray,
                            orients: np.ndarray, cblk_style: int = 0,
                            nthreads: Optional[int] = None,
                            stepsizes=None):
    """`encode_cblk_batch` of blocks gathered out of band planes natively
    (`extract_blocks`; with `stepsizes` the planes are float32 and
    quantized during the gather). `descs`: (n, 5) int64 (band_idx, x0,
    y0, w, h); `orients`: (n,)."""
    descs = np.asarray(descs, np.int64).reshape(-1, 5)
    n = len(descs)
    if n == 0:
        return []
    mag_flat, neg_flat, offs = extract_blocks(bands, descs, stepsizes,
                                              nthreads)
    desc = np.empty((n, 4), dtype=np.int64)
    desc[:, 0] = offs
    desc[:, 1] = descs[:, 3]
    desc[:, 2] = descs[:, 4]
    desc[:, 3] = orients
    return _encode_flat(n, mag_flat, neg_flat, desc, cblk_style,
                        int((descs[:, 3] * descs[:, 4]).max()), nthreads)


def _pack_jobs(blocks):
    """The data bytes, the flat segment lengths and per block (data
    offset, data length, segment offset, segment count) of decode jobs
    (data, seg_lengths, w, h, orient, numbps, numpasses[, ...])."""
    data_flat = np.frombuffer(b"".join(bytes(b[0]) for b in blocks)
                              or b"\x00", dtype=np.uint8)
    seg_rows: List[int] = []
    heads = []
    doff = 0
    for b in blocks:
        segs = b[1]
        nsegs = len(segs) if segs else 0
        heads.append((doff, len(b[0]), len(seg_rows), nsegs))
        if nsegs:
            seg_rows.extend(int(x) for x in segs)
        doff += len(b[0])
    return data_flat, np.asarray(seg_rows or [0], dtype=np.int32), heads


def decode_cblk_batch(blocks, cblk_style: int = 0,
                      nthreads: Optional[int] = None,
                      signed_out: bool = False):
    """Decode many code-blocks in one native call. `blocks` is a list of
    (data, seg_lengths, w, h, orient, numbps, numpasses); returns per
    block (mag, neg), or with `signed_out` the signed int32 array."""
    n = len(blocks)
    if n == 0:
        return []
    data_flat, segs_flat, heads = _pack_jobs(blocks)
    rows = []
    out_off = 0
    for (doff, ln, soff, nsegs), b in zip(heads, blocks):
        w, h, orient, numbps, numpasses = b[2:7]
        rows.append((doff, ln, soff, nsegs, w, h, orient, numbps, numpasses,
                     cblk_style, out_off))
        out_off += w * h
    desc = np.asarray(rows, dtype=np.int64).reshape(-1)
    mag_flat = np.zeros(max(1, out_off), dtype=np.uint32)
    neg_flat = np.zeros(max(1, out_off), dtype=np.uint8)
    _lib().grok_t1_decode_batch(
        n, data_flat.ctypes.data, segs_flat.ctypes.data, desc.ctypes.data,
        mag_flat.ctypes.data, neg_flat.ctypes.data,
        nthreads if nthreads is not None else default_threads(),
        1 if signed_out else 0)
    coef = mag_flat.view(np.int32)
    results = []
    for row in rows:
        w, h, off = row[4], row[5], row[10]
        if signed_out:
            results.append(coef[off:off + w * h].reshape(h, w))
        else:
            results.append((mag_flat[off:off + w * h].reshape(h, w).copy(),
                            neg_flat[off:off + w * h].reshape(h, w).copy()))
    return results


def decode_cblk_batch_bands(blocks, bands: Sequence[np.ndarray], placements,
                            cblk_style=0, stepsizes=None,
                            nthreads: Optional[int] = None,
                            pm_zero=None) -> None:
    """Decode blocks and scatter them into band planes in one native
    call: each nonzero magnitude takes its mid-point at the block's
    lowest decoded plane (plane 0 for the blocks that `pm_zero` marks)
    and, with `stepsizes` (float32 planes), its band's stepsize.

    blocks = [(data, seg_lengths, w, h, orient, numbps, numpasses), ...]
    (trailing fields ignored); placements = (band_idx, x0, y0) per block;
    `bands`: zeroed 2-D int32 or float32 planes with unit column stride.
    `cblk_style` is one style for every block, or one per block."""
    n = len(blocks)
    if n == 0:
        return
    data_flat, segs_flat, heads = _pack_jobs(blocks)
    ptrs, strides, steps, is_float = _band_meta(bands, stepsizes)
    styles = np.broadcast_to(np.asarray(cblk_style, np.int64), (n,))
    zero = np.zeros(n, np.int64) if pm_zero is None else \
        np.asarray(pm_zero, np.int64)
    rows = np.empty((n, 14), dtype=np.int64)
    for i, b in enumerate(blocks):
        rows[i] = (*heads[i], *b[2:7], styles[i], *placements[i][:3],
                   zero[i])
    desc = np.ascontiguousarray(rows.ravel())
    rc = _lib().grok_t1_decode_bands(
        n, data_flat.ctypes.data, segs_flat.ctypes.data, desc.ctypes.data,
        ptrs.ctypes.data, strides.ctypes.data, steps.ctypes.data,
        1 if is_float else 0,
        nthreads if nthreads is not None else default_threads())
    if rc != 0:
        raise RuntimeError("T1 band decode failed")


def ht_encode_cblk_refined(mag: np.ndarray, neg: np.ndarray, Mb: int,
                           passes: int = 3) -> Tuple[bytes, int, int]:
    """Encode one HT cleanup segment (at one plane up) plus a
    SigProp(/MagRef) refinement segment (Part 15 full mode).

    Returns (data, len_cleanup, len_refinement); data holds both
    segments back to back, as they appear in the codestream."""
    h, w = mag.shape
    mag = np.ascontiguousarray(mag, dtype=np.uint32)
    neg = np.ascontiguousarray(neg, dtype=np.uint8)
    cap = max(4096, w * h * 8)
    out = np.empty(cap, dtype=np.uint8)
    lens = np.zeros(2, dtype=np.int32)
    rc = _lib().grok_ht_encode_refined(
        mag.ctypes.data, neg.ctypes.data, w, h, Mb, passes,
        out.ctypes.data, cap, lens.ctypes.data, lens[1:].ctypes.data)
    if rc != 0:
        raise RuntimeError("HT refined encode failed")
    l1, l2 = int(lens[0]), int(lens[1])
    return bytes(out[:l1 + l2]), l1, l2


def ht_decode_cblk_refined(data: bytes, len1: int, len2: int, passes: int,
                           w: int, h: int, Mb: int
                           ) -> Tuple[np.ndarray, np.ndarray]:
    """Decode cleanup + refinement segments; returns (quarters, neg)
    with magnitudes in quarter units of the cleanup plane (see
    csrc/host/ht.cpp grok_ht_decode_refined for the exact mapping)."""
    quarters = np.zeros((h, w), dtype=np.uint32)
    neg = np.zeros((h, w), dtype=np.uint8)
    buf = np.frombuffer(bytes(data), dtype=np.uint8) if data else \
        np.zeros(1, dtype=np.uint8)
    rc = _lib().grok_ht_decode_refined(
        buf.ctypes.data, len1, len2, passes, w, h, Mb,
        quarters.ctypes.data, neg.ctypes.data)
    if rc != 0:
        raise RuntimeError("HT refined decode failed")
    return quarters, neg


def ht_encode_refined_batch_bands(bands: Sequence[np.ndarray],
                                  descs: np.ndarray, mbs, passes: int = 3,
                                  stepsizes=None,
                                  nthreads: Optional[int] = None
                                  ) -> List[Tuple[bytes, int, int]]:
    """`ht_encode_cblk_refined` of many blocks gathered out of band planes
    in one call on the library's worker threads (the gather quantizes
    float32 planes with `stepsizes`, as `extract_blocks`); a block whose
    band Mb (`mbs`) is below 2 gets one plain cleanup segment instead.
    `descs`: (n, 5) int64 (band_idx, x0, y0, w, h). Returns per block
    (data, len_cleanup, len_refinement), the last 0 for a plain block."""
    descs = np.ascontiguousarray(np.asarray(descs, np.int64).reshape(-1, 5))
    n = len(descs)
    if n == 0:
        return []
    ptrs, strides, steps, is_float = _band_meta(bands, stepsizes)
    mbs64 = np.ascontiguousarray(mbs, dtype=np.int64)
    out_stride = max(4096, int((descs[:, 3] * descs[:, 4]).max()) * 8)
    out_flat = np.empty(n * out_stride, dtype=np.uint8)
    len1 = np.zeros(n, dtype=np.int32)
    len2 = np.zeros(n, dtype=np.int32)
    rc = _lib().grok_ht_encode_refined_bands(
        n, ptrs.ctypes.data, strides.ctypes.data, steps.ctypes.data,
        1 if is_float else 0, descs.ctypes.data, mbs64.ctypes.data, passes,
        out_flat.ctypes.data, out_stride, len1.ctypes.data, len2.ctypes.data,
        nthreads if nthreads is not None else default_threads())
    if rc != 0:
        raise RuntimeError("HT refined band encode failed")
    buf = out_flat.tobytes()
    return [(buf[i * out_stride:i * out_stride + a + b], a, b)
            for i, (a, b) in enumerate(zip(len1.tolist(), len2.tolist()))]


def ht_decode_refined_batch_bands(blocks, bands: Sequence[np.ndarray],
                                  placements, stepsizes=None,
                                  nthreads: Optional[int] = None) -> None:
    """Decode refined blocks (data, len_cleanup, len_refinement, passes,
    w, h, Mb) and scatter them into band planes in one call: quarter
    magnitudes q >> 1 with the sign, int32, or float32 with the mid-point
    dequantizer and `stepsizes`, as `ht_decode_cblk_batch_bands`. A
    block whose cleanup does not decode stays zero. placements =
    (band_idx, x0, y0) per block; `bands`: zeroed planes with unit column
    stride."""
    n = len(blocks)
    if n == 0:
        return
    data_flat = np.frombuffer(b"".join(bytes(b[0]) for b in blocks)
                              or b"\x00", dtype=np.uint8)
    ptrs, strides, steps, is_float = _band_meta(bands, stepsizes)
    rows = np.empty((n, 10), dtype=np.int64)
    off = 0
    for i, (data, l1, l2, passes, w, h, mb) in enumerate(blocks):
        rows[i] = (off, l1, l2, passes, w, h, mb, *placements[i][:3])
        off += len(data)
    desc = np.ascontiguousarray(rows.ravel())
    _lib().grok_ht_decode_refined_bands(
        n, data_flat.ctypes.data, desc.ctypes.data, ptrs.ctypes.data,
        strides.ctypes.data, steps.ctypes.data, 1 if is_float else 0,
        nthreads if nthreads is not None else default_threads())


def ht_decode_cblk_batch_bands(blocks, bands: Sequence[np.ndarray],
                               placements, stepsizes=None,
                               nthreads: Optional[int] = None) -> None:
    """Plain HT cleanup decode + scatter into band planes in one call.

    blocks = [(data, w, h, missing_msbs), ...]; placements = (band_idx,
    x0, y0) per block; `bands` are zeroed planes with unit column stride,
    int32, or float32 with `stepsizes` (the mid-point dequantizer fused
    into the scatter)."""
    n = len(blocks)
    if n == 0:
        return
    data_flat = np.frombuffer(b"".join(bytes(b[0]) for b in blocks)
                              or b"\x00", dtype=np.uint8)
    ptrs, strides, steps, is_float = _band_meta(bands, stepsizes)
    rows = np.empty((n, 9), dtype=np.int64)
    off = 0
    for i, (data, w, h, miss) in enumerate(blocks):
        rows[i] = (off, len(data), w, h, miss, *placements[i][:3], 0)
        off += len(data)
    desc = np.ascontiguousarray(rows.ravel())
    _lib().grok_ht_decode_bands(
        n, data_flat.ctypes.data, desc.ctypes.data, ptrs.ctypes.data,
        strides.ctypes.data, steps.ctypes.data, 1 if is_float else 0,
        nthreads if nthreads is not None else default_threads())
