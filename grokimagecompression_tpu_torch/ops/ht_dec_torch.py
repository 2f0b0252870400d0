"""HT cleanup-pass decoder for a group of same-size code-blocks: the plain
torch version of the CUDA kernel in `csrc/ht_dec.cu`.

Port of the step body of `grokimagecompression_tpu/ops/ht_dec_jax.py`
(`decode_group_core`), which the Pallas kernel `ht_dec_pallas.
decode_group_pallas` reproduces bit for bit. One code-block is one lane;
every lane walks the T = ceil(w/4) * ceil(h/2) steps of its block
row-pair-major, two quads a step, reading its three unstuffed stream-word
columns (`native/ht_prepass.py`) at per-lane bit offsets:

- `fetch_lsb` / `fetch_msb`: the next 32 stream bits at a bit offset,
  from two words at a word index clamped to W-2 (the last two words hold
  the stream's pad: 1-bits for MEL and MagSgn, 0-bits for VLC);
- `mel_get_run`: one MEL run (exponent ladder `MEL_EXP`);
- `uvlc_decode`: the UVLC prefix/suffix code of a quad pair;
- `decode_quad`: one quad's four MagSgn samples, magnitudes in the
  decoder's centred form (v+2)>>1;
- the (qw+4, B) line state: significance (bit 7) and exponent (bits
  0-6) of the row above.

Values the reference keeps in uint32 are int64 here and masked with
0xFFFFFFFF where the wrap matters. The Python loop issues ~300 torch
operations a step: this version is for the CPU and for holding the
kernel to it, not for speed.
"""

from __future__ import annotations

from typing import List, Tuple

import torch

from .ht_tables import MEL_EXP

M32 = 0xFFFFFFFF


def grid_dims(w: int, h: int) -> Tuple[int, int, int]:
    """(nx, ny, T) of a w x h block: steps of two quads (4 columns, 2
    rows); the output grid is (B, 2*ny, 4*nx)."""
    nx = (w + 3) // 4
    ny = (h + 1) // 2
    return nx, ny, nx * ny


def fetch_lsb(words, lanes, off):
    """Next 32 stream bits at bit offset `off`, LSB-aligned."""
    wi = torch.clamp(off >> 5, max=words.shape[0] - 2)
    sh = off & 31
    w0 = words[wi, lanes]
    w1 = words[wi + 1, lanes]
    hi = torch.where(sh > 0, (w1 << ((32 - sh) & 31)) & M32, 0)
    return (w0 >> sh) | hi


def fetch_msb(words, lanes, off):
    """Next 32 stream bits at bit offset `off`, MSB-aligned (MEL)."""
    wi = torch.clamp(off >> 5, max=words.shape[0] - 2)
    sh = off & 31
    w0 = words[wi, lanes]
    w1 = words[wi + 1, lanes]
    lo = torch.where(sh > 0, w1 >> ((32 - sh) & 31), 0)
    return ((w0 << sh) & M32) | lo


def mel_get_run(mel, lanes, off, k, mel_exp):
    """One MEL run decode: (run, off', k')."""
    win = fetch_msb(mel, lanes, off)
    e = mel_exp[k]
    full = ((win >> 31) & 1) == 1
    run_full = ((1 << e) - 1) << 1
    rest = ((win << 1) & M32) >> ((32 - e) & 31)
    rest = torch.where(e > 0, rest, 0)
    run = torch.where(full, run_full, (rest << 1) + 1)
    k2 = torch.where(full, torch.clamp(k + 1, max=12),
                     torch.clamp(k - 1, min=0))
    return run, off + torch.where(full, 1, e + 1), k2


def _cond_get_run(mel, lanes, need, run, off, k, mel_exp):
    r2, o2, k2 = mel_get_run(mel, lanes, off, k, mel_exp)
    return (torch.where(need, r2, run), torch.where(need, o2, off),
            torch.where(need, k2, k))


def _uvlc_classify(win):
    """(prefix length, suffix length, base) of the UVLC code at the
    window's low bits."""
    b0 = (win & 1) == 1
    b01 = (win & 3) == 2
    b02 = (win & 7) == 4
    pre = torch.where(b0, 1, torch.where(b01, 2, 3))
    suf = torch.where(b0 | b01, 0, torch.where(b02, 1, 5))
    base = torch.where(b0, 1, torch.where(b01, 2, torch.where(b02, 3, 5)))
    return pre, suf, base


def uvlc_decode(win, mode, initial: bool):
    """(u0, u1, consumed bits) of a quad pair's UVLC code; `mode` is the
    pair's u_off pattern (bit 0 quad 0, bit 1 quad 1; 4 in the initial
    row when a MEL event doubles both)."""
    p1, s1, b1 = _uvlc_classify(win)
    wa = win >> p1
    v_single = b1 + (wa & ((1 << s1) - 1))
    c_single = p1 + s1
    p2, s2, b2 = _uvlc_classify(wa)
    wb = wa >> p2
    u0_b = b1 + (wb & ((1 << s1) - 1))
    u1_b = b2 + ((wb >> s1) & ((1 << s2) - 1))
    c_b = p1 + p2 + s1 + s2
    if initial:
        # a long u0 prefix leaves one bit for u1 in {1, 2}
        long0 = p1 > 2
        u0_m3 = torch.where(long0, b1 + ((wa >> 1) & ((1 << s1) - 1)), u0_b)
        u1_m3 = torch.where(long0, (wa & 1) + 1, u1_b)
        c_m3 = torch.where(long0, p1 + 1 + s1, c_b)
        u0_m4, u1_m4, c_m4 = u0_b + 2, u1_b + 2, c_b
    else:
        u0_m3, u1_m3, c_m3 = u0_b, u1_b, c_b
        u0_m4, u1_m4, c_m4 = u0_b, u1_b, c_b
    u0 = torch.where(mode == 1, v_single,
                     torch.where(mode == 3, u0_m3,
                                 torch.where(mode >= 4, u0_m4, 0)))
    u1 = torch.where(mode == 2, v_single,
                     torch.where(mode == 3, u1_m3,
                                 torch.where(mode >= 4, u1_m4, 0)))
    c = torch.where((mode == 1) | (mode == 2), c_single,
                    torch.where(mode == 3, c_m3,
                                torch.where(mode >= 4, c_m4, 0)))
    return u0, u1, c


def bit_length(v):
    """Exact bit length of non-negative int64 values below 2^32."""
    n = torch.zeros_like(v)
    for s in (16, 8, 4, 2, 1):
        big = v >= (1 << s)
        n = n + torch.where(big, s, 0)
        v = torch.where(big, v >> s, v)
    return n + (v > 0).to(v.dtype)


def decode_quad(ms, lanes, qf, U_p, ms_off):
    """One quad's four samples (n = 2*col + row) for every lane: mags in
    (v+2)>>1 form, signs, ms_off', and the exponents and significance of
    the bottom-left (n=1) and bottom-right (n=3) samples."""
    mags, signs, exps, sigs = [], [], [], []
    for n in range(4):
        sig = ((qf >> (4 + n)) & 1) == 1
        win = fetch_lsb(ms, lanes, ms_off)
        m_n = U_p - ((qf >> (12 + n)) & 1)
        mask = torch.where(m_n < 32, (1 << (m_n & 31)) - 1, M32)
        v = ((win & mask) | ((((qf >> (8 + n)) & 1) << (m_n & 31)) & M32)
             | 1)
        v = torch.where(sig, v, 0)
        ms_off = ms_off + torch.where(sig, m_n, 0)
        mags.append(torch.where(sig, ((v + 2) & M32) >> 1, 0))
        signs.append(torch.where(sig, win & 1, 0))
        exps.append(bit_length(v))
        sigs.append(sig)
    return mags, signs, ms_off, exps[1], exps[3], sigs[1], sigs[3]


def decode_group_plain(mel: torch.Tensor, vlc: torch.Tensor,
                       ms: torch.Tensor, w: int, h: int,
                       dec0: torch.Tensor, dec1: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Decode a lane group of w x h HT cleanup segments. `mel`, `vlc`,
    `ms`: (W, B) int32 stream words (uint32 bit patterns, lanes-last);
    `dec0` / `dec1`: the (1024,) CxtVLC decode LUTs of the initial and
    the other quad rows. Returns (mags, signs), (B, 2*ny, 4*nx) int32."""
    dev = mel.device
    mel, vlc, ms = (a.to(torch.int64) & M32 for a in (mel, vlc, ms))
    dec0 = dec0.to(torch.int64)
    dec1 = dec1.to(torch.int64)
    mel_exp = torch.as_tensor(MEL_EXP, dtype=torch.int64, device=dev)
    B = mel.shape[1]
    nx, ny, T = grid_dims(w, h)
    qw = (w + 1) // 2
    lanes = torch.arange(B, device=dev)
    zero = torch.zeros(B, dtype=torch.int64, device=dev)

    mel_run, mel_off, mel_k = mel_get_run(mel, lanes, zero, zero, mel_exp)
    vlc_off = ms_off = c_p = ls0 = zero
    lstate = torch.zeros((qw + 4, B), dtype=torch.int64, device=dev)
    out_m: List[torch.Tensor] = []
    out_s: List[torch.Tensor] = []
    for t in range(T):
        x = (t % nx) * 4
        row0 = t // nx == 0
        has_q1 = x + 2 < w
        q = x >> 1
        ls_q1 = lstate[q + 1].clone()
        ls_q2 = lstate[q + 2].clone()
        if t % nx == 0:          # row start: snapshot entry 0, reset c_p
            ls0 = lstate[0].clone()
            lstate[0] = 0
            c_p = zero
        dec = dec0 if row0 else dec1

        # quad 0
        cq0 = c_p if row0 else c_p | (ls0 >> 7) | ((ls_q1 >> 5) & 4)
        win = fetch_lsb(vlc, lanes, vlc_off)
        qf0 = dec[(cq0 << 7) | (win & 0x7F)]
        azc0 = cq0 == 0
        mel_run = mel_run - torch.where(azc0, 2, 0)
        qf0 = torch.where(azc0 & (mel_run != -1), 0, qf0)
        mel_run, mel_off, mel_k = _cond_get_run(
            mel, lanes, azc0 & (mel_run < 0), mel_run, mel_off, mel_k,
            mel_exp)
        if row0:
            c_p = ((qf0 & 0x10) >> 4) | ((qf0 & 0xE0) >> 5)
        else:
            c_p = ((qf0 & 0x40) >> 5) | ((qf0 & 0x80) >> 6)
        vlc_off = vlc_off + (qf0 & 0x7)

        # quad 1
        if has_q1:
            cq1 = c_p if row0 else c_p | (ls_q1 >> 7) | ((ls_q2 >> 5) & 4)
            win = fetch_lsb(vlc, lanes, vlc_off)
            qf1 = dec[(cq1 << 7) | (win & 0x7F)]
            azc1 = cq1 == 0
            mel_run = mel_run - torch.where(azc1, 2, 0)
            qf1 = torch.where(azc1 & (mel_run != -1), 0, qf1)
            mel_run, mel_off, mel_k = _cond_get_run(
                mel, lanes, azc1 & (mel_run < 0), mel_run, mel_off, mel_k,
                mel_exp)
            if row0:
                c_p = ((qf1 & 0x10) >> 4) | ((qf1 & 0xE0) >> 5)
            else:
                c_p = ((qf1 & 0x40) >> 5) | ((qf1 & 0x80) >> 6)
            vlc_off = vlc_off + (qf1 & 0x7)
        else:
            qf1 = zero

        # u values
        mode = ((qf0 & 0x8) >> 3) | ((qf1 & 0x8) >> 2)
        if row0:
            m3 = mode == 3
            mel_run = mel_run - torch.where(m3, 2, 0)
            mode = mode + torch.where(m3 & (mel_run == -1), 1, 0)
            mel_run, mel_off, mel_k = _cond_get_run(
                mel, lanes, m3 & (mel_run < 0), mel_run, mel_off, mel_k,
                mel_exp)
        win = fetch_lsb(vlc, lanes, vlc_off)
        u0, u1, c_u = uvlc_decode(win, mode, row0)
        vlc_off = vlc_off + c_u
        U_p0 = u0 + 1
        U_p1 = u1 + 1
        if not row0:
            # exponent bonus for quads with 2+ significant samples
            s0 = qf0 & 0xF0
            s1 = qf1 & 0xF0
            e0 = torch.maximum(ls0 & 0x7F, ls_q1 & 0x7F) - 2
            e1 = torch.maximum(ls_q1 & 0x7F, ls_q2 & 0x7F) - 2
            U_p0 = U_p0 + torch.where((s0 & (s0 - 1)) != 0,
                                      torch.clamp(e0, min=0), 0)
            U_p1 = U_p1 + torch.where((s1 & (s1 - 1)) != 0,
                                      torch.clamp(e1, min=0), 0)
            ls0 = ls_q2
        lstate[q + 1] = 0
        lstate[q + 2] = 0

        # samples + line-state writes
        m0, sg0, ms_off, bl_e0, br_e0, bl_s0, br_s0 = decode_quad(
            ms, lanes, qf0, U_p0, ms_off)
        m1, sg1, ms_off, bl_e1, br_e1, bl_s1, br_s1 = decode_quad(
            ms, lanes, qf1, U_p1, ms_off)
        ent_q = lstate[q]
        lstate[q] = torch.where(
            bl_s0, (ent_q & 0x80) | 0x80 | torch.maximum(ent_q & 0x7F,
                                                          bl_e0), ent_q)
        e_q1 = torch.where(br_s0, 0x80 | br_e0, 0)
        lstate[q + 1] = torch.where(
            bl_s1, (e_q1 & 0x80) | 0x80 | torch.maximum(e_q1 & 0x7F, bl_e1),
            e_q1)
        if has_q1:
            lstate[q + 2] = torch.where(br_s1, 0x80 | br_e1, 0)
        out_m.append(torch.stack(m0 + m1))
        out_s.append(torch.stack(sg0 + sg1))

    def to_grid(steps):
        # (T, 8, B) -> (B, 2*ny, 4*nx); within a step: quad, col, row
        a = torch.stack(steps).reshape(ny, nx, 2, 2, 2, B)
        return a.permute(5, 0, 4, 1, 2, 3).reshape(B, 2 * ny, 4 * nx) \
            .to(torch.int32)

    return to_grid(out_m), to_grid(out_s)
