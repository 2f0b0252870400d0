"""HTJ2K tables and host-side segment assembly, owned by the port.

Copies of the table and host parts of `grokimagecompression_tpu/ops/
ht_jax.py` (`_load_vlc_sources`, the CxtVLC encode and UVLC tables,
`MEL_EXP`, `assemble_segments_host`) and of
`ops/ht_dec_jax.py` (the CxtVLC decode LUTs, `_dec_tables`). The CxtVLC
septuples are read from the port's copy of the normative table source,
`csrc/host/ht_tables.inc`.

`_tables()` returns (enc0, enc1, upre, upre_len, usuf, usuf_len), the
order `tables_on` keys them in. `device_tables` / `device_dec_tables` are
the torch views the entry points and the device modules read, made once
per device.
"""

from __future__ import annotations

import functools
import os
import re
from typing import Dict, List, Tuple

import numpy as np
import torch

# ---------------------------------------------------------------------------
# Normative CxtVLC tables
# ---------------------------------------------------------------------------


def _load_vlc_sources() -> Tuple[np.ndarray, np.ndarray]:
    """Parse HT_VLC_SRC0/1 out of the port's copy of the reference's
    `native/src/ht_tables.inc` (the packed ISO/IEC 15444-15 CxtVLC
    septuples), `csrc/host/ht_tables.inc`."""
    path = os.path.join(os.path.dirname(__file__), "..", "csrc", "host",
                        "ht_tables.inc")
    text = open(path).read()
    out = []
    for name in ("HT_VLC_SRC0", "HT_VLC_SRC1"):
        m = re.search(name + r"\[\d+\] = \{(.*?)\};", text, re.S)
        words = [int(w, 16) for w in re.findall(r"0x[0-9a-fA-F]+",
                                                m.group(1))]
        out.append(np.asarray(words, np.uint32))
    return out[0], out[1]


def _build_enc_table(src: np.ndarray) -> np.ndarray:
    """Encode LUT: [(c_q<<8)|(rho<<4)|emb] -> (cwd<<8)|(len<<4)|e_k
    (same derivation as the native coder's build_tables)."""
    c_q = ((src >> 28) & 0xF).astype(np.int64)
    rho = ((src >> 24) & 0xF).astype(np.int64)
    u_off = ((src >> 23) & 1).astype(np.int64)
    e_k = ((src >> 19) & 0xF).astype(np.int64)
    e_1 = ((src >> 15) & 0xF).astype(np.int64)
    cwd = ((src >> 7) & 0xFF).astype(np.int64)
    ln = (src & 0x7F).astype(np.int64)
    ones = np.asarray([bin(int(v)).count("1") for v in e_k], np.int64)
    n = len(src)
    i = np.arange(2048)[:, None]                       # (2048, 1)
    cq_i = i >> 8
    rho_i = (i >> 4) & 0xF
    emb_i = i & 0xF
    valid_i = ((emb_i & rho_i) == emb_i) & ~((rho_i == 0) & (cq_i == 0))
    match = (c_q[None] == cq_i) & (rho[None] == rho_i)
    # emb != 0: best = matching (u_off==1, (emb & e_k) == e_1) entry with
    # the max popcount(e_k), ties broken by the LAST index (>= in the
    # scalar loop); emb == 0: FIRST matching entry with u_off == 0.
    m_emb = match & (u_off[None] == 1) & ((emb_i & e_k[None]) == e_1[None])
    score = np.where(m_emb, ones[None] * n + np.arange(n)[None], -1)
    best_emb = np.argmax(score, axis=1)
    has_emb = score.max(axis=1) >= 0
    m_z = match & (u_off[None] == 0)
    best_z = np.argmax(m_z, axis=1)                    # first True
    has_z = m_z.any(axis=1)
    use_emb = emb_i[:, 0] != 0
    best = np.where(use_emb, best_emb, best_z)
    has = valid_i[:, 0] & np.where(use_emb, has_emb, has_z)
    enc = np.where(has, (cwd[best] << 8) | (ln[best] << 4) | e_k[best], 0)
    return enc.astype(np.uint16)


def _build_uvlc() -> Tuple[np.ndarray, ...]:
    pre = np.zeros(33, np.int32)
    pre_len = np.zeros(33, np.int32)
    suf = np.zeros(33, np.int32)
    suf_len = np.zeros(33, np.int32)
    pre[:5] = [0, 1, 2, 4, 4]
    pre_len[:5] = [0, 1, 2, 3, 3]
    suf[:5] = [0, 0, 0, 0, 1]
    suf_len[:5] = [0, 0, 0, 1, 1]
    for i in range(5, 33):
        pre[i] = 0
        pre_len[i] = 3
        suf[i] = i - 5
        suf_len[i] = 5
    return pre, pre_len, suf, suf_len


@functools.lru_cache(maxsize=1)
def _tables():
    src0, src1 = _load_vlc_sources()
    enc0 = _build_enc_table(src0)
    enc1 = _build_enc_table(src1)
    return (enc0, enc1) + _build_uvlc()


MEL_EXP = np.asarray([0, 0, 0, 1, 1, 1, 2, 2, 2, 3, 3, 4, 5], np.int32)
POPCOUNT4 = (0, 1, 1, 2, 1, 2, 2, 3, 1, 2, 2, 3, 2, 3, 3, 4)
TABLE_KEYS = ("enc0", "enc1", "upre", "upre_len", "usuf", "usuf_len",
              "popcount4")


# ---------------------------------------------------------------------------
# Decode LUTs
# ---------------------------------------------------------------------------


def _build_dec_table(src: np.ndarray) -> np.ndarray:
    """Decode LUT: [(c_q<<7)|cwd7] -> (e_k<<12)|(e_1<<8)|(rho<<4)|
    (u_off<<3)|len (same derivation as native build_tables)."""
    c_q = ((src >> 28) & 0xF).astype(np.int64)
    rho = ((src >> 24) & 0xF).astype(np.int64)
    u_off = ((src >> 23) & 1).astype(np.int64)
    e_k = ((src >> 19) & 0xF).astype(np.int64)
    e_1 = ((src >> 15) & 0xF).astype(np.int64)
    cwd = ((src >> 7) & 0xFF).astype(np.int64)
    ln = (src & 0x7F).astype(np.int64)
    dec = np.zeros(1024, np.int64)
    idx = np.arange(1024)
    cwd_i = idx & 0x7F
    cq_i = idx >> 7
    for j in range(len(src)):
        m = (cq_i == c_q[j]) & ((cwd_i & ((1 << ln[j]) - 1)) == cwd[j])
        val = (e_k[j] << 12) | (e_1[j] << 8) | (rho[j] << 4) \
            | (u_off[j] << 3) | ln[j]
        dec = np.where(m, val, dec)
    return dec.astype(np.int32)


@functools.lru_cache(maxsize=1)
def _dec_tables() -> Tuple[np.ndarray, np.ndarray]:
    src0, src1 = _load_vlc_sources()
    return _build_dec_table(src0), _build_dec_table(src1)


# ---------------------------------------------------------------------------
# Torch views
# ---------------------------------------------------------------------------


def enc_packed(tables) -> np.ndarray:
    """Encode tables in `_tables()` order -> the (2081,) int32 table the
    CUDA encoder (`csrc/ht_enc.cu`) reads: enc0 | enc1 << 16 at each of
    the 2048 CxtVLC indices, then the UVLC table for u = 0..32, prefix |
    prefix length << 8 | suffix << 16 | suffix length << 24."""
    enc0, enc1, upre, upre_len, usuf, usuf_len = (
        np.asarray(a).astype(np.int64) for a in tables)
    uvlc = upre | (upre_len << 8) | (usuf << 16) | (usuf_len << 24)
    return np.concatenate([enc0 | (enc1 << 16), uvlc]).astype(
        np.uint32).view(np.int32)


def tables_on(tables, device: torch.device) -> Dict[str, torch.Tensor]:
    """Encode tables in `_tables()` order -> int64 tensors on `device`,
    keyed as `ops/ht_torch` reads them, plus the 4-bit popcount table and
    the CUDA encoder's packed int32 table (`enc_packed`)."""
    arrays = tuple(tables) + (np.asarray(POPCOUNT4),)
    out = {k: torch.as_tensor(np.asarray(a).astype(np.int64), device=device)
           for k, a in zip(TABLE_KEYS, arrays, strict=True)}
    out["enc_packed"] = torch.as_tensor(enc_packed(tables), device=device)
    return out


def dec_tables_on(dec_tables, device: torch.device
                  ) -> Dict[str, torch.Tensor]:
    """The two (1024,) CxtVLC decode LUTs (initial and other quad rows)
    -> {"dec0", "dec1"} int32 tensors on `device`, as
    `ops/ht_dec.decode_segments` reads them."""
    return {k: torch.as_tensor(np.asarray(a, np.int32), device=device)
            for k, a in zip(("dec0", "dec1"), dec_tables, strict=True)}


@functools.lru_cache(maxsize=None)
def device_tables(device: torch.device) -> Dict[str, torch.Tensor]:
    """`tables_on(_tables(), device)`, made once per device."""
    return tables_on(_tables(), device)


@functools.lru_cache(maxsize=None)
def device_dec_tables(device: torch.device) -> Dict[str, torch.Tensor]:
    """`dec_tables_on(_dec_tables(), device)`, made once per device."""
    return dec_tables_on(_dec_tables(), device)


# ---------------------------------------------------------------------------
# Host-side segment assembly (bytes from packed words + metrics)
# ---------------------------------------------------------------------------


def assemble_segments_host(words_np: np.ndarray,
                           metrics_np: np.ndarray) -> List[bytes]:
    """Rebuild final HT segments from the packed word buffer and the
    per-block metrics. Lane i's words live at [starts[i], starts[i] +
    wc[i]); byte semantics mirror the device scatter rules of the native
    coder (native/src/ht.cpp terminate/fuse; reference semantics:
    ojph_block_encoder.cpp ms/mel/vlc terminate)."""
    m = metrics_np
    n = m.shape[0]
    lens3 = m[:, 0:3]
    wc3 = lens3 >> 2
    rem3 = lens3 & 3
    wctot = wc3.sum(axis=1)
    starts = np.zeros(n, np.int64)
    np.cumsum(wctot[:-1], out=starts[1:])
    bytes_all = words_np.astype("<u4").view(np.uint8)
    partials = np.ascontiguousarray(
        m[:, 12:15].astype("<i4")).view(np.uint8).reshape(n, 3, 4)

    out: List[bytes] = []
    for i in range(n):
        p = int(starts[i]) * 4
        ms_w, mel_w, vlc_w = (int(v) * 4 for v in wc3[i])
        ms = bytearray(bytes_all[p:p + ms_w])
        ms += partials[i, 0, :rem3[i, 0]].tobytes()
        p += ms_w
        mel = bytearray(bytes_all[p:p + mel_w])
        mel += partials[i, 1, :rem3[i, 1]].tobytes()
        p += mel_w
        vlc = bytearray(bytes_all[p:p + vlc_w])
        vlc += partials[i, 2, :rem3[i, 2]].tobytes()

        (ms_tail, ms_append, ms_drop, mext, ext_byte, mel_tail_byte,
         nonzero, fuse_ok, vtmp) = (int(v) for v in m[i, 3:12])
        if ms_drop:
            del ms[-1]
        if ms_append:
            ms.append(ms_tail)
        if mext:
            mel.append(ext_byte)
        if nonzero:
            mel.append(mel_tail_byte)
        seg = ms + mel
        if nonzero and not fuse_ok:
            seg.append(vtmp)
        seg += vlc[::-1]
        seg.append(0xFF)
        scup = (len(mel) + 1 + len(vlc)
                + (1 if (nonzero and not fuse_ok) else 0))
        seg[-1] = scup >> 4
        seg[-2] = (seg[-2] & 0xF0) | (scup & 0xF)
        out.append(bytes(seg))
    return out
