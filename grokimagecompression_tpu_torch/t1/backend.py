"""Tier-1 dispatch of the port's host block coder.

A copy of `grokimagecompression_tpu/t1/backend.py` for the routes the
port sends to its host: the Part-1 MQ code-block styles other than the
default (BYPASS, RESET, TERMALL, VSC, PTERM, SEGMARK), MQ bands deeper
than the CUDA MQ decoder's word, HT code-blocks with refinement passes
(Part 15 full mode: SigProp and MagRef after the cleanup) and HT bands
whose Mb + 3 exceeds the CUDA HT decoder's 32 bits. Every call goes to
the host library's coders (`native/t1_native.py`, worker threads
inside); there is no Python coder behind them, and a failed build
raises. The reference's switches to its Python coder and to its device
coders are not copied: the port's device MQ and HT routes are its fused
encoder and decoder (`models/fused_encode.py`,
`models/fused_decode.py`).
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from ..codestream.t2 import PassInfo
from ..native import t1_native

CBLKSTY_HT = 0x40
# the refinement passes after each refined block's cleanup: SigProp and
# MagRef
HT_REFINED_PASSES = 3


def native_threads() -> int:
    """Worker threads of the native batch entries."""
    return t1_native.default_threads()


def encode_cblk_batch_bands(bands, descs, orients, cblk_style: int = 0,
                            stepsizes=None, nthreads: Optional[int] = None,
                            kmaxs=None):
    """Batch encode straight from band planes.

    `bands`: 2-D arrays with unit column stride — int32 DWT coefficients
    (reversible), or float32 coefficients with `stepsizes` (one per band)
    for the irreversible path, where the deadzone quantization fuses into
    the native gather. `descs`: (n, 5) int64 rows (band_idx, x0, y0, w,
    h); `orients`: (n,). Returns per block (data, numbps, numpasses,
    passes), `passes` its per-pass rates, distortion decreases (not
    weighted) and terminations.

    The HT style (0x40) codes each block with refinement passes (the
    only HT route the host takes; `kmaxs`, each block's band Mb, is then
    required): the cleanup one plane up, then SigProp and MagRef for the
    plane it drops, 3 passes in 2 codeword segments with numbps 2; a
    block whose band has Mb < 2 gets the plain cleanup, 1 pass."""
    descs = np.asarray(descs, np.int64).reshape(-1, 5)
    if not cblk_style & CBLKSTY_HT:
        return t1_native.encode_cblk_batch_bands(
            bands, descs, np.asarray(orients, np.int64), cblk_style,
            nthreads=nthreads, stepsizes=stepsizes)
    out = []
    for (d, l1, l2), kmax in zip(t1_native.ht_encode_refined_batch_bands(
            bands, descs, kmaxs, HT_REFINED_PASSES, stepsizes, nthreads),
            kmaxs, strict=True):
        if kmax < 2:
            out.append((d, 1, 1, [PassInfo(rate=len(d), distortion=0.0,
                                           terminated=True)]))
        else:
            out.append((d, 2, 3, [
                PassInfo(rate=l1, distortion=0.0, terminated=True),
                PassInfo(rate=l1, distortion=0.0, terminated=False),
                PassInfo(rate=l1 + l2, distortion=0.0, terminated=True)]))
    return out


def _refined_lengths(data: bytes, seg_lengths):
    """The cleanup and refinement segment lengths of a refined block,
    clamped to the bytes present (a truncated stream decodes as far as
    its data allows, as the reference's `_decode_refined_block`)."""
    if seg_lengths and len(seg_lengths) >= 2:
        l1, l2 = int(seg_lengths[0]), int(seg_lengths[1])
    else:
        l1, l2 = len(data), 0
    l1 = min(l1, len(data))
    return l1, min(l2, max(0, len(data) - l1))


def decode_cblk_batch_bands(blocks, bands, placements, cblk_style=0,
                            stepsizes=None, pm_zero=None,
                            nthreads: Optional[int] = None) -> None:
    """Decode blocks (data, seg_lengths, w, h, orient, numbps,
    numpasses, kmax) straight into band planes at `placements`
    ((band_idx, x0, y0) each), with the mid-point reconstruction and,
    with `stepsizes`, the dequantization of float32 planes. `cblk_style`
    is one style or one per block. MQ blocks go to
    `t1_native.decode_cblk_batch_bands` (`pm_zero` marks those that
    reconstruct at plane 0); HT blocks of more than one pass to the
    refined decoder (`t1_native.ht_decode_refined_batch_bands`, their
    quarter magnitudes halved, as the reference's
    `_decode_refined_block`), the other HT blocks to the plain cleanup
    decoder at kmax - numbps missing planes
    (`t1_native.ht_decode_cblk_batch_bands`)."""
    n = len(blocks)
    styles = np.broadcast_to(np.asarray(cblk_style, np.int64), (n,))
    zero = [False] * n if pm_zero is None else pm_zero
    part: dict = {"mq": [], "refined": [], "ht": []}
    for i, b in enumerate(blocks):
        if not styles[i] & CBLKSTY_HT:
            part["mq"].append(i)
        else:
            part["refined" if b[6] > 1 else "ht"].append(i)
    if part["mq"]:
        mq = part["mq"]
        t1_native.decode_cblk_batch_bands(
            [blocks[i] for i in mq], bands, [placements[i] for i in mq],
            [int(styles[i]) for i in mq], stepsizes=stepsizes,
            nthreads=nthreads, pm_zero=[zero[i] for i in mq])
    if part["refined"]:
        jobs = []
        for i in part["refined"]:
            d, s, w, h, _, _, np_, kmax = blocks[i][:8]
            jobs.append((bytes(d), *_refined_lengths(bytes(d), s), np_, w,
                         h, kmax))
        t1_native.ht_decode_refined_batch_bands(
            jobs, bands, [placements[i] for i in part["refined"]],
            stepsizes=stepsizes, nthreads=nthreads)
    if part["ht"]:
        t1_native.ht_decode_cblk_batch_bands(
            [(bytes(blocks[i][0]), blocks[i][2], blocks[i][3],
              blocks[i][7] - blocks[i][5]) for i in part["ht"]], bands,
            [placements[i] for i in part["ht"]], stepsizes=stepsizes,
            nthreads=nthreads)


def decode_cblk_batch(blocks, cblk_style: int = 0, signed_out: bool = False,
                      nthreads: Optional[int] = None):
    """Batch decode: blocks = [(data, seg_lengths, w, h, orient, numbps,
    numpasses[, kmax]), ...] -> [(mag, neg), ...], or signed int32
    arrays with `signed_out`."""
    return t1_native.decode_cblk_batch([b[:7] for b in blocks], cblk_style,
                                       nthreads=nthreads,
                                       signed_out=signed_out)
