"""ctypes binding for the host library's HT decode prepass
(csrc/host/ht.cpp).

A copy of `ht_dec_prepass` from `grokimagecompression_tpu/native/
t1_native.py`: each HT cleanup segment's three streams (MEL forward, VLC
backward, MagSgn forward) are unstuffed into dense bit words on the host.
It is the first half of the plain version of the CUDA HT decoder
(`ops/ht_dec.decode_segments`), whose kernel unstuffs the raw segments
itself.
"""

from __future__ import annotations

import threading
from typing import List, Tuple

import numpy as np

from ..ops import _build

# calls of `ht_dec_prepass`: the CUDA decode route makes none (the kernel
# reads the raw segments), the CPU route one per lane group; counted under
# a lock, as a mesh's shard threads may call it at once
CALLS = {"prepass": 0}
_calls_lock = threading.Lock()


def ht_dec_prepass(segs: List[bytes], lcups, scups, wm_mel: int,
                   wm_vlc: int, wm_ms: int
                   ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Expand HT cleanup segments into the three dense unstuffed
    stream-word matrices ((wm, B) uint32, lanes-last) consumed by the
    device decoder. Lane i's stream bit p sits at word p // 32: MEL
    MSB-first (bit 31 - p % 32), VLC and MagSgn LSB-first (bit p % 32);
    past each stream's end MEL and MagSgn read 1-bits, VLC 0-bits."""
    with _calls_lock:
        CALLS["prepass"] += 1
    B = len(segs)
    data = np.frombuffer(b"".join(segs) or b"\x00", dtype=np.uint8)
    offs = np.zeros(B + 1, np.int64)
    np.cumsum([len(s) for s in segs], out=offs[1:])
    lc = np.asarray(lcups, np.int32)
    sc = np.asarray(scups, np.int32)
    out_mel = np.zeros((wm_mel, B), np.uint32)
    out_vlc = np.zeros((wm_vlc, B), np.uint32)
    out_ms = np.zeros((wm_ms, B), np.uint32)
    rc = _build.host_library().grok_ht_dec_prepass(
        data.ctypes.data, offs.ctypes.data, lc.ctypes.data, sc.ctypes.data,
        B, wm_mel, wm_vlc, wm_ms, out_mel.ctypes.data, out_vlc.ctypes.data,
        out_ms.ctypes.data)
    if rc != 0:
        raise RuntimeError("HT decode prepass failed")
    return out_mel, out_vlc, out_ms


def bucket_words(n: int) -> int:
    """Round a stream word count up to a power of two (at least 32), as
    `ht_dec_jax.bucket_words` does. Extra rows are pure pad: the prepass
    fills them with each stream's pad pattern and the decoder's fetches
    clamp into them."""
    b = 32
    while b < n:
        b *= 2
    return b


def prepass_group(segs: List[bytes], lcups, scups):
    """The word widths of `fused_decode` for one lane group, and the
    prepass at those widths: (mel, vlc, ms) word matrices."""
    wm_mel = bucket_words((8 * (max(scups) + 7)) // 32 + 4)
    wm_ms = bucket_words(
        (8 * (max(lc - sc for lc, sc in zip(lcups, scups)) + 8)) // 32 + 4)
    return ht_dec_prepass(segs, lcups, scups, wm_mel, wm_mel, wm_ms)
