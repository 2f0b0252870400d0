"""HTJ2K cleanup-pass encoder stages in torch: the plain version.

Port of the device half of `grokimagecompression_tpu/ops/ht_jax.py`.
Everything up to the three stream coders is elementwise work over the
(B, qh, qw) quad grid of a shape group of code-blocks: significance,
exponents, VLC contexts, kappa / u_q, CxtVLC + UVLC codewords and MagSgn
bit counts. The sequential part is the three stream scans
(`ops/ht_scan.py`), after which `group_metrics` derives the per-block
termination metrics that `ht_tables.assemble_segments_host` turns into
the final segment bytes. Together they are the plain version of the HT
encoder, `ht_enc.encode_segments_plain`; on the card the encoder is the
kernel of `csrc/ht_enc.cu`, which runs none of this.

Values the reference keeps in uint32 (and lets wrap) are int64 here,
masked with 0xFFFFFFFF where the wrap matters; torch has neither a
count-leading-zeros nor a popcount op, so bit lengths come from an exact
binary search and the popcount of the 4-bit rho from a table.

Word placement is exact (`place_words`): per lane the dense MS, MEL and
VLC word columns are concatenated and the valid words taken in lane-major
order. The reference's per-chunk compaction caps, its overflow column
and the host re-encode fallback exist only because XLA scatters element
by element, and are not ported: metrics column 15 is always 0.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import torch

from . import ht_scan

M32 = 0xFFFFFFFF


def bit_length(x: torch.Tensor) -> torch.Tensor:
    """Exact bit length of non-negative int64 values below 2^32
    (32 - clz for uint32)."""
    n = torch.zeros_like(x)
    for s in (16, 8, 4, 2, 1):
        hi = (x >> s) != 0
        n = n + hi.to(x.dtype) * s
        x = torch.where(hi, x >> s, x)
    return n + (x != 0).to(x.dtype)


def _quad_stage(mag, neg, mbs):
    """(B, 2qh, 2qw) magnitudes (int64, uint32 values) / signs -> per-quad
    dict of (B, qh, qw) tensors."""
    B, H, W = mag.shape
    qh, qw = H // 2, W // 2
    mbs = mbs.to(torch.int64)
    mask = torch.where(mbs >= 31, M32,
                       (1 << torch.clamp(mbs + 1, max=31)) - 1)
    v = ((mag & mask[:, None, None]) << 1) & M32
    sig = v != 0
    e = torch.where(sig, bit_length(torch.clamp(v - 1, min=0)), 0)
    s = (v - 2 + neg.to(torch.int64)) & M32

    def qview(a):
        a = a.reshape(B, qh, 2, qw, 2)
        return (a[:, :, 0, :, 0], a[:, :, 1, :, 0],
                a[:, :, 0, :, 1], a[:, :, 1, :, 1])

    s0, s1, s2, s3 = qview(s)
    e0, e1, e2, e3 = qview(e)
    g0, g1, g2, g3 = (g.to(torch.int64) for g in qview(sig))
    rho = g0 | (g1 << 1) | (g2 << 2) | (g3 << 3)
    emax = torch.maximum(torch.maximum(e0, e1), torch.maximum(e2, e3))
    eps = ((e0 == emax).to(torch.int64)
           | ((e1 == emax).to(torch.int64) << 1)
           | ((e2 == emax).to(torch.int64) << 2)
           | ((e3 == emax).to(torch.int64) << 3))
    return dict(rho=rho, emax=emax, eps=eps, e1=e1, e3=e3,
                s=(s0, s1, s2, s3))


def _shift_right(a, fill=0):
    """a[..., j] -> a[..., j-1] (left neighbour), `fill` at j = 0."""
    pad = torch.full(a.shape[:-1] + (1,), fill, dtype=a.dtype,
                     device=a.device)
    return torch.cat([pad, a[..., :-1]], dim=-1)


def _context_stage(q, popcount4):
    """c_q / kappa / U_q / u_q over the whole quad grid."""
    rho, emax, eps = q["rho"], q["emax"], q["eps"]
    e1p, e3p = q["e1"], q["e3"]
    B, qh, qw = rho.shape

    rho_l = _shift_right(rho)
    cq0 = (rho_l[:, 0] >> 1) | (rho_l[:, 0] & 1)

    # non-initial rows: line state from the previous quad row
    rp_e1 = e1p[:, :-1]
    rp_e3 = e3p[:, :-1]
    rp_rho = rho[:, :-1]
    ev = torch.maximum(_shift_right(rp_e3), rp_e1)          # (B, qh-1, qw)
    ev_full = torch.cat([ev, rp_e3[..., -1:]], dim=-1)      # j = 0..qw
    max_e = torch.maximum(ev_full[..., :-1], ev_full[..., 1:]) - 1
    cx = ((rp_rho >> 1) & 1) | ((_shift_right(rp_rho) >> 3) & 1)
    cx_full = torch.cat([cx, (rp_rho[..., -1:] >> 3) & 1], dim=-1)
    cq_rest = cx_full[..., :-1] | (cx_full[..., 1:] << 2)
    rho_l_rest = rho_l[:, 1:]
    left_bits = ((rho_l_rest >> 1) & 2) | ((rho_l_rest >> 2) & 2)
    left_bits[..., 0] = 0
    cq_rest = cq_rest | left_bits
    cq = torch.cat([cq0[:, None], cq_rest], dim=1)

    two_sig = popcount4[rho] >= 2
    kappa_rest = torch.where(two_sig[:, 1:], torch.clamp(max_e, min=1), 1)
    kappa = torch.cat([torch.ones((B, 1, qw), dtype=rho.dtype,
                                  device=rho.device), kappa_rest], dim=1)
    Uq = torch.maximum(emax, kappa)
    u = Uq - kappa
    eps_used = torch.where(u > 0, eps, 0)
    return cq, kappa, Uq, u, eps_used


def _pair_view(a):
    """Pad the quad axis to an even count; return (even, odd) columns."""
    if a.shape[-1] % 2:
        a = torch.cat([a, torch.zeros(a.shape[:-1] + (1,), dtype=a.dtype,
                                      device=a.device)], dim=-1)
    return a[..., 0::2], a[..., 1::2]


def _vlc_uvlc_stage(q, cq, Uq, u, eps_used, tables):
    """CxtVLC + UVLC codewords per quad pair -> (val, len) append ops and
    the MEL events."""
    rho = q["rho"]
    B, qh, qw = rho.shape
    npairs = (qw + 1) // 2
    upre, upre_len = tables["upre"], tables["upre_len"]
    usuf, usuf_len = tables["usuf"], tables["usuf_len"]

    idx = (cq << 8) | (rho << 4) | eps_used
    t = torch.cat([tables["enc0"][idx[:, :1]], tables["enc1"][idx[:, 1:]]],
                  dim=1)

    t0, t1 = _pair_view(t)
    u0, u1 = _pair_view(u)
    rho0, rho1 = _pair_view(rho)
    cq0, cq1 = _pair_view(cq)
    pair_col = torch.arange(npairs, device=rho.device)
    has_q1 = (pair_col * 2 + 1 < qw).expand(B, qh, npairs)
    u1 = torch.where(has_q1, u1, 0)
    t1 = torch.where(has_q1, t1, 0)

    v0 = (t0 >> 8) & 0xFF
    l0 = (t0 >> 4) & 7
    v1 = (t1 >> 8) & 0xFF
    l1 = torch.where(has_q1, (t1 >> 4) & 7, 0)

    init = (torch.arange(qh, device=rho.device) == 0)[None, :, None] \
        .expand(B, qh, npairs)
    both_gt2 = init & (u0 > 2) & (u1 > 2)
    special = init & (u0 > 2) & (u1 > 0) & ~both_gt2

    # default joint form (non-initial rows, and the initial "else" branch)
    p0, pl0, s0v, sl0 = upre[u0], upre_len[u0], usuf[u0], usuf_len[u0]
    p1, pl1, s1v, sl1 = upre[u1], upre_len[u1], usuf[u1], usuf_len[u1]
    w_def = (p0 | (p1 << pl0) | (s0v << (pl0 + pl1))
             | (s1v << (pl0 + pl1 + sl0)))
    l_def = pl0 + pl1 + sl0 + sl1

    # initial row, both u > 2: offset-by-2 joint form
    a0 = torch.clamp(u0 - 2, 0, 32)
    a1 = torch.clamp(u1 - 2, 0, 32)
    bp0, bpl0, bs0, bsl0 = upre[a0], upre_len[a0], usuf[a0], usuf_len[a0]
    bp1, bpl1, bs1, bsl1 = upre[a1], upre_len[a1], usuf[a1], usuf_len[a1]
    w_b = (bp0 | (bp1 << bpl0) | (bs0 << (bpl0 + bpl1))
           | (bs1 << (bpl0 + bpl1 + bsl0)))
    l_b = bpl0 + bpl1 + bsl0 + bsl1

    # initial row, u0 > 2 and u1 in {1, 2}: one-bit u1
    w_s = p0 | (torch.clamp(u1 - 1, 0, 1) << pl0) | (s0v << (pl0 + 1))
    l_s = pl0 + 1 + sl0

    uvlc_w = torch.where(both_gt2, w_b, torch.where(special, w_s, w_def))
    uvlc_l = torch.where(both_gt2, l_b, torch.where(special, l_s, l_def))

    pair_w = (v0 | (v1 << l0) | (uvlc_w << (l0 + l1))) & M32
    pair_l = l0 + l1 + uvlc_l

    # MEL event slots per pair: [q0-sig, q1-sig, u-event]
    mel_valid = torch.stack([
        cq0 == 0,
        has_q1 & (cq1 == 0),
        init & (u0 > 0) & (u1 > 0),
    ], dim=-1)
    mel_bit = torch.stack([
        rho0 != 0,
        rho1 != 0,
        torch.minimum(u0, u1) > 2,
    ], dim=-1)
    return pair_w, pair_l, mel_valid, mel_bit, t0, t1


def _magsgn_ops(q, Uq, t, qsel: int, halves: int):
    """MagSgn append ops for quad column parity `qsel` (0 even, 1 odd):
    (B, qh, npairs, 4, halves) value / length tensors. `halves == 1`
    when every m_n fits 16 bits (Mb <= 14)."""
    rho = q["rho"]
    B, qh, qw = rho.shape

    def sel(a):
        return _pair_view(a)[qsel]

    vals = []
    lens = []
    rho_s = sel(rho)
    Uq_s = sel(Uq)
    for n in range(4):
        s_n = sel(q["s"][n])
        sig_n = (rho_s >> n) & 1
        m_n = torch.where(sig_n == 1, Uq_s - ((t >> n) & 1), 0)
        mask = torch.where(m_n >= 32, M32,
                           (1 << torch.clamp(m_n, 0, 31)) - 1)
        val = s_n & mask
        if halves == 1:
            vals.append(val & 0xFFFF)
            lens.append(m_n)
        else:
            vals.append(val & 0xFFFF)
            lens.append(torch.clamp(m_n, max=16))
            vals.append(val >> 16)
            lens.append(torch.clamp(m_n - 16, min=0))
    v = torch.stack(vals, dim=-1).reshape(B, qh, -1, 4, halves)
    ln = torch.stack(lens, dim=-1).reshape(B, qh, -1, 4, halves)
    return v, ln


def _lanes_last(a: torch.Tensor, B: int) -> torch.Tensor:
    """(B, ...) -> contiguous (T, B) int32 op stream."""
    return a.reshape(B, -1).T.to(torch.int32).contiguous()


def op_streams(mag, neg, mbs, tables, mbb: int) -> Dict[str, torch.Tensor]:
    """Quad stage through the MEL / VLC / MagSgn op streams of one shape
    group: mel_valid / mel_bit (T_mel, B) with T_mel % 4 == 0, vlc_vals /
    vlc_lens (T_vlc, B), ms_vals / ms_lens (T_ms, B), all int32. `mbb`:
    the group's max Mb; <= 14 halves the MagSgn stream."""
    B = mag.shape[0]
    q = _quad_stage(mag.to(torch.int64), neg, mbs)
    cq, kappa, Uq, u, eps_used = _context_stage(q, tables["popcount4"])
    pair_w, pair_l, mel_valid, mel_bit, t0, t1 = _vlc_uvlc_stage(
        q, cq, Uq, u, eps_used, tables)

    mv = _lanes_last(mel_valid, B)
    mb = _lanes_last(mel_bit, B)
    if mv.shape[0] % 4:
        pad = 4 - mv.shape[0] % 4
        mv = torch.nn.functional.pad(mv, (0, 0, 0, pad))
        mb = torch.nn.functional.pad(mb, (0, 0, 0, pad))
    vv = torch.stack([pair_w & 0xFFFF, pair_w >> 16], dim=-1)
    vl = torch.stack([torch.clamp(pair_l, max=16),
                      torch.clamp(pair_l - 16, min=0)], dim=-1)
    halves = 1 if mbb <= 14 else 2
    v0, l0v = _magsgn_ops(q, Uq, t0, 0, halves)
    v1, l1v = _magsgn_ops(q, Uq, t1, 1, halves)
    return dict(
        mel_valid=mv.contiguous(), mel_bit=mb.contiguous(),
        vlc_vals=_lanes_last(vv, B), vlc_lens=_lanes_last(vl, B),
        ms_vals=_lanes_last(torch.stack([v0, v1], dim=3), B),
        ms_lens=_lanes_last(torch.stack([l0v, l1v], dim=3), B))


def encode_streams(mag, neg, mbs, tables, mbb: int = 32):
    """One shape group through the three plain stream scans, on the
    device of `mag`. Returns (mel, vlc, ms), each (words, mask, state) as
    `ops/ht_scan.py` describes."""
    ops = op_streams(mag, neg, mbs, tables, mbb)
    mel = ht_scan.mel_scan_plain(ops["mel_valid"], ops["mel_bit"])
    vlc = ht_scan.vlc_scan_plain(ops["vlc_vals"], ops["vlc_lens"])
    ms = ht_scan.ms_scan_plain(ops["ms_vals"], ops["ms_lens"])
    return mel, vlc, ms


def group_metrics(B: int, mel, vlc, ms) -> torch.Tensor:
    """Per-block termination metrics (B, NMETRICS) int32 from the scan
    outputs; the layout `ht_jax.assemble_segments_host` reads.

    Columns: 0 ms_len, 1 mel_len, 2 vlc_len (scan-emitted byte counts),
    3 ms_tail, 4 ms_append, 5 ms_drop, 6 mext, 7 ext_byte, 8
    mel_tail_byte, 9 nonzero, 10 fuse_ok, 11 vtmp, 12..14 partial-word
    accumulators (ms, mel, vlc), 15 always 0 (no compaction overflow)."""
    def wcount(mask):
        return mask.reshape(-1, B).sum(dim=0, dtype=torch.int64)

    mel_st = mel[2].to(torch.int64)
    vlc_st = vlc[2].to(torch.int64)
    ms_st = ms[2].to(torch.int64)
    ms_len = 4 * wcount(ms[1]) + ms_st[4]
    mel_len = 4 * wcount(mel[1]) + mel_st[6]
    vlc_len = 4 * wcount(vlc[1]) + vlc_st[4]

    # MagSgn termination (MsEnc::terminate)
    msq, msqb, msmaxb = ms_st[0], ms_st[1], ms_st[2]
    ms_tail = (msq | (0xFF << msqb)) & ((1 << msmaxb) - 1)
    ms_append = (msqb > 0) & (ms_tail != 0xFF)
    ms_drop = (msqb == 0) & (msmaxb == 7)

    # MEL tail: pending run bit + byte alignment
    mtmp, mnbits, mcap, mrun = mel_st[0], mel_st[1], mel_st[2], mel_st[3]
    has_run = mrun > 0
    t2 = torch.where(has_run, (mtmp << 1) | 1, mtmp)
    nb2 = mnbits + has_run.to(torch.int64)
    mext = nb2 >= mcap
    sh = torch.clamp(nb2 - mcap, min=0)
    ext_byte = torch.where(mext, t2 >> sh, 0)
    t3 = torch.where(mext, t2 & ((1 << sh) - 1), t2)
    nb3 = torch.where(mext, nb2 - mcap, nb2)
    cap3 = torch.where(mext, torch.where(ext_byte == 0xFF, 7, 8), mcap)
    remaining = cap3 - nb3
    mel_tmp = (t3 << remaining) & 0xFF
    mel_maskv = (0xFF << remaining) & 0xFF

    # VLC pending byte + fuse rule (terminate_mel_vlc)
    vtmp, vused = vlc_st[0], vlc_st[1]
    vlc_maskv = torch.where(vused > 0,
                            0xFF >> torch.clamp(8 - vused, min=0), 0)
    vlc_n = 1 + vlc_len
    nonzero = (mel_maskv | vlc_maskv) != 0
    fuse = mel_tmp | vtmp
    fuse_ok = nonzero & (((((fuse ^ mel_tmp) & mel_maskv)
                           | ((fuse ^ vtmp) & vlc_maskv)) == 0)
                         & (fuse != 0xFF) & (vlc_n > 1))
    mel_tail_byte = torch.where(fuse_ok, fuse, mel_tmp)

    cols = [ms_len, mel_len, vlc_len,
            ms_tail, ms_append, ms_drop, mext, ext_byte, mel_tail_byte,
            nonzero, fuse_ok, vtmp, ms_st[3], mel_st[5], vlc_st[3],
            torch.zeros_like(ms_len)]
    return torch.stack([c.to(torch.int64) for c in cols],
                       dim=-1).to(torch.int32)


def place_words(groups: Sequence[Tuple]) -> torch.Tensor:
    """Exact packed word buffer for the groups' scan outputs, in metrics
    row order: group by group, lane by lane, and per lane the MS, MEL and
    VLC words in emission order (the layout `assemble_segments_host`
    reads). `groups`: [(mel, vlc, ms), ...]."""
    parts: List[torch.Tensor] = []
    for mel, vlc, ms in groups:
        words = torch.cat([ms[0], mel[0], vlc[0]], dim=0).T
        mask = torch.cat([ms[1], mel[1], vlc[1]], dim=0).T
        parts.append(words[mask])
    return torch.cat(parts)
