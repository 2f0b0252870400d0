"""Part-1 MQ block decoder in torch: the plain version and the block API.

Port of `grokimagecompression_tpu/ops/mq_dec_jax.py` for the default
code-block style (one codeword segment; no LAZY / RESET / TERMALL / VSC /
PTERM / SEGSYM). `decode_group_plain` decodes a lane group of same-shape
code-blocks with torch ops over (B,) lane vectors; it is the plain
version of the CUDA kernel `csrc/mq_dec.cu` (wrapper `ops/mq_dec.py`),
with the same contract:

    decode_group_plain(data uint8 (N,), off int64 (B + 1,), nbps, npas,
                       ori int32 (B,), w, h) -> packed int32 (h*w, B)

Lane b's segment is `data[off[b]:off[b + 1]]`; `nbps` its magnitude
bit-planes, `npas` its coding passes (0 and 0 for an idle lane) and `ori`
its band orientation. `packed` holds `sign << 31 | magnitude` per sample
(row-major), lanes last. With `with_stats=True` it also returns (2, B)
int32: per lane the decisions decoded and the BYTEIN procedures run
(INITDEC's included).

The walk is the column-triple schedule of `mq_dec_pallas._col_schedule`:
per pass, the 4-sample stripe columns in scan order, each column's
decisions back to back. Lane b's first pass is the cleanup of plane
nbps - 1, its global pass number g0 = 3 (npl - nbps) + 2 for the group's
npl = max nbps, and it codes passes g0 .. g0 + npas - 1. Only global
passes in which some lane is enabled are walked, and a column or a
decision with no enabled lane is skipped.

Block state: per sample a cell 0 (insignificant), 1 (positive) or 2
(negative) on an (h + 2, w + 2) grid whose border stays 0, so that
neighbours outside the block count as insignificant; the eight
neighbours' cells read as one base-3 code index the zero-coding, sign
and magnitude-context tables.
"""

from __future__ import annotations

import functools
from typing import List, Optional, Tuple

import numpy as np
import torch

from .mq_tables import CTX_MAG, CTX_RL, CTX_UNI, MQ_TABLE, _CTX_INIT
from .mq_torch import OFFS, _SC_LUT, _ZC_LUT

_M32 = 0xFFFFFFFF
_NCODES = 3 ** 8
# base-3 weight of each cell of a 3 x 3 neighbourhood (row-major), the
# centre excluded: neighbour OFFS[k] has weight 3**k
_P3 = tuple(0 if (dy, dx) == (0, 0) else 3 ** OFFS.index((dy, dx))
            for dy in (-1, 0, 1) for dx in (-1, 0, 1))


def _neighbour_tables():
    """(zc (4 * 6561,), sc (6561,), spb (6561,)) from the base-3 code of
    the eight neighbour cells: the zero-coding context per orientation
    (Table D.1), the sign context and prediction bit (Table D.3)."""
    codes = np.arange(_NCODES)
    cell = np.stack([(codes // 3 ** k) % 3 for k in range(8)])   # (8, N)
    sig = (cell != 0).astype(np.int64)
    contrib = np.where(cell == 0, 0, np.where(cell == 2, -1, 1))
    h = sig[OFFS.index((0, -1))] + sig[OFFS.index((0, 1))]
    v = sig[OFFS.index((-1, 0))] + sig[OFFS.index((1, 0))]
    d = sum(sig[OFFS.index(o)] for o in ((-1, -1), (-1, 1), (1, -1), (1, 1)))
    zc_lut = np.asarray(_ZC_LUT)
    zc = np.concatenate([zc_lut[((o * 3 + h) * 3 + v) * 5 + d]
                         for o in range(4)])
    hc = np.clip(contrib[OFFS.index((0, -1))] + contrib[OFFS.index((0, 1))],
                 -1, 1)
    vc = np.clip(contrib[OFFS.index((-1, 0))] + contrib[OFFS.index((1, 0))],
                 -1, 1)
    sc_idx = (hc + 1) * 3 + (vc + 1)
    sc = np.asarray([c for c, _ in _SC_LUT])[sc_idx]
    spb = np.asarray([s for _, s in _SC_LUT])[sc_idx]
    return zc, sc, spb


@functools.lru_cache(maxsize=None)
def _luts(device: torch.device):
    zc, sc, spb = _neighbour_tables()

    def t(a):
        return torch.as_tensor(np.asarray(a, np.int64), device=device)

    # per context state p = index << 1 | mps: its Qe, and the state after
    # a renormalising MPS or LPS decision (Table C.2)
    qe, nmps, nlps, sw = (np.asarray(c) for c in zip(*MQ_TABLE))
    mps = np.arange(2 * len(MQ_TABLE)) & 1
    idx = np.arange(2 * len(MQ_TABLE)) >> 1
    # RENORMD's shift count for A in [1, 0xFFFF]: 16 - bit length
    a = np.arange(1 << 16)
    shift = 16 - np.floor(np.log2(np.maximum(a, 1))).astype(np.int64) - 1
    return {"zc": t(zc), "sc": t(sc), "spb": t(spb), "p3": t(_P3),
            "ctx": t(_CTX_INIT), "qe": t(qe[idx]),
            "to_mps": t((nmps[idx] << 1) | mps),
            "to_lps": t((nlps[idx] << 1) | (mps ^ sw[idx])), "shift": t(shift)}


@functools.lru_cache(maxsize=256)
def _columns(h: int, w: int) -> Tuple[Tuple[int, int, int], ...]:
    """(y0, x, stripe height) of every stripe column, in scan order."""
    return tuple((y0, x, min(4, h - y0))
                 for y0 in range(0, h, 4) for x in range(w))


class _Coder:
    """The MQ decoder (C.3) of a lane vector: A, C, CT, the byte position
    and the 19 context states, int64 (B,) tensors; C is kept to 32 bits
    as the reference's uint32."""

    def __init__(self, data: torch.Tensor, off: torch.Tensor, luts):
        dev = data.device
        B = off.shape[0] - 1
        # two 0xFF pad bytes: every index below stays inside
        self.bytes = torch.cat([data.to(torch.int64),
                                torch.full((2,), 0xFF, dtype=torch.int64,
                                           device=dev)])
        self.last = self.bytes.shape[0] - 1
        self.base = off[:-1]
        self.end = off[1:] - off[:-1]
        self.luts = luts
        self.ctx = luts["ctx"].view(-1, 1).repeat(1, B)   # a copy
        zeros = torch.zeros(B, dtype=torch.int64, device=dev)
        self.ndec, self.nbytein = zeros.clone(), zeros.clone()
        # INITDEC (C.3.5)
        b0 = torch.where(self.end > 0,
                         self.bytes[self.base.clamp(max=self.last)], 0xFF)
        self.c, self.ct, self.pos = b0 << 16, zeros.clone(), zeros.clone()
        self._bytein(torch.ones(B, dtype=torch.bool, device=dev))
        self.c = (self.c << 7) & _M32
        self.ct = self.ct - 7
        self.a = torch.full((B,), 0x8000, dtype=torch.int64, device=dev)

    def _bytein(self, bi: torch.Tensor) -> None:
        """BYTEIN (C.3.4) where `bi`. Past the segment's end, and at a
        0xFF followed by a byte above 0x8F (a marker), C takes 0xFF00 and
        the position stays."""
        in_r = self.pos < self.end
        i = self.base + self.pos
        cur = self.bytes[i.clamp(max=self.last)]
        nxt = torch.where(self.pos + 1 < self.end,
                          self.bytes[(i + 1).clamp(max=self.last)], 0xFF)
        ff = in_r & (cur == 0xFF)
        marker = ff & (nxt > 0x8F)
        c_new = torch.where(marker | ~in_r, self.c + 0xFF00,
                            self.c + (nxt << torch.where(ff, 9, 8)))
        self.c = torch.where(bi, c_new & _M32, self.c)
        self.ct = torch.where(bi, torch.where(ff & ~marker, 7, 8), self.ct)
        self.pos = torch.where(bi & in_r & ~marker, self.pos + 1, self.pos)
        self.nbytein += bi

    def decode(self, cx: torch.Tensor, en: torch.Tensor) -> torch.Tensor:
        """DECODE (C.3.2) of one decision in context `cx` where `en`:
        the decisions, (B,) int64, 0 where not enabled."""
        if not bool(en.any()):
            return torch.zeros_like(self.a)
        luts = self.luts
        p = self.ctx.gather(0, cx.view(1, -1))[0]
        qe = luts["qe"][p]
        a1 = self.a - qe
        lps = (self.c >> 16) < qe          # the LPS sub-interval
        a_lt = a1 < qe
        renorm = lps | (a1 < 0x8000)
        # the decision is the LPS: on the LPS path unless A < Qe (the
        # conditional exchange), on the MPS path when A < Qe
        ex = torch.where(lps, ~a_lt, renorm & a_lt)
        upd = en & renorm                  # the state moves on a renorm
        self.ctx.scatter_(0, cx.view(1, -1), torch.where(
            upd, torch.where(ex, luts["to_lps"][p], luts["to_mps"][p]),
            p).view(1, -1))
        self.c = torch.where(en & ~lps, self.c - (qe << 16), self.c)
        a2 = torch.where(lps, qe, a1)
        # RENORMD: shift until bit 15 of A is set
        n = torch.where(upd, luts["shift"][a2], 0)
        self.a = torch.where(en, (a2 << n) & 0xFFFF, self.a)
        if bool((n > self.ct).any()):
            # BYTEINs on the way: at most 15 shifts and CT >= 7 after a
            # BYTEIN, so <= 3
            for _ in range(3):
                bi = (n > 0) & (self.ct == 0)
                if bool(bi.any()):
                    self._bytein(bi)
                s = torch.minimum(n, self.ct)
                self.c = (self.c << s) & _M32
                self.ct = self.ct - s
                n = n - s
        else:
            self.c = (self.c << n) & _M32
            self.ct = self.ct - n
        self.ndec += en
        return ((p & 1) ^ ex) & en


def _code(st: torch.Tensor, y: int, x: int, p3: torch.Tensor) -> torch.Tensor:
    """Base-3 code of the eight neighbour cells of sample (y, x)."""
    return (st[:, y:y + 3, x:x + 3].reshape(st.shape[0], 9) * p3).sum(1)


def decode_group_plain(data: torch.Tensor, off: torch.Tensor,
                       nbps: torch.Tensor, npas: torch.Tensor,
                       ori: torch.Tensor, w: int, h: int,
                       with_stats: bool = False):
    """Decode a lane group of w x h MQ code-blocks (see the module
    docstring for the contract)."""
    dev = data.device
    B = nbps.shape[0]
    luts = _luts(dev)
    p3 = luts["p3"]
    coder = _Coder(data, off.to(torch.int64), luts)
    st = torch.zeros((B, h + 2, w + 2), dtype=torch.int64, device=dev)
    mag = torch.zeros_like(st)
    vis = torch.zeros_like(st, dtype=torch.bool)
    nb = nbps.to(torch.int64)
    npl = int(nb.max()) if B else 0
    g0 = 3 * (npl - nb) + 2
    gend = g0 + npas.to(torch.int64)
    zc_base = ori.to(torch.int64) * _NCODES
    cols = _columns(h, w)

    def full(v):
        return torch.full((B,), v, dtype=torch.int64, device=dev)

    rl_cx, uni_cx = full(CTX_RL), full(CTX_UNI)

    def sign(y, x, code, new, bit):
        """Decode the sign of the samples that become significant."""
        d = coder.decode(luts["sc"][code], new)
        sgn = d ^ luts["spb"][code]
        st[:, y + 1, x + 1] = torch.where(new, 1 + sgn, st[:, y + 1, x + 1])
        mag[:, y + 1, x + 1] |= torch.where(new, bit, 0)

    def spp(en, bit):
        for (y0, x, sh) in cols:
            if not bool(st[:, y0:y0 + sh + 2, x:x + 3].any()):
                continue                   # no significance around
            for y in range(y0, y0 + sh):
                code = _code(st, y, x, p3)
                m = en & (st[:, y + 1, x + 1] == 0) & (code != 0)
                if not bool(m.any()):
                    continue
                d = coder.decode(luts["zc"][zc_base + code], m)
                vis[:, y + 1, x + 1] |= m
                new = d == 1
                if bool(new.any()):
                    sign(y, x, code, new, bit)

    def mrp(en, plane, bit):
        for (y0, x, sh) in cols:
            if not bool(st[:, y0 + 1:y0 + 1 + sh, x + 1].any()):
                continue                   # nothing significant
            for y in range(y0, y0 + sh):
                m = en & (st[:, y + 1, x + 1] != 0) & ~vis[:, y + 1, x + 1]
                if not bool(m.any()):
                    continue
                code = _code(st, y, x, p3)
                cur = mag[:, y + 1, x + 1]
                refined = (cur >> min(plane + 2, 31)) != 0
                cx = torch.where(refined, CTX_MAG + 2,
                                 CTX_MAG + (code != 0).to(torch.int64))
                d = coder.decode(cx, m)
                mag[:, y + 1, x + 1] = cur | (d << plane)

    def cln(en, bit):
        for (y0, x, sh) in cols:
            run = skip = r = None
            if sh == 4:
                # aggregation: nothing significant in the 6 x 3 box and
                # nothing visited in the column
                box = st[:, y0:y0 + 6, x:x + 3].reshape(B, 18)
                m_rl = (en & ~(box != 0).any(1)
                        & ~vis[:, y0 + 1:y0 + 5, x + 1].any(1))
                if bool(m_rl.any()):
                    d = coder.decode(rl_cx, m_rl)
                    run, skip = m_rl & (d == 1), m_rl & (d == 0)
                    r = 2 * coder.decode(uni_cx, run)
                    r = r + coder.decode(uni_cx, run)
            for k in range(sh):
                y = y0 + k
                m = en & (st[:, y + 1, x + 1] == 0) & ~vis[:, y + 1, x + 1]
                pend = None
                if run is not None:
                    # the run-interrupt sample k == r is significant
                    # without a zero-coding decision
                    m = m & ~skip & ~(run & (r >= k))
                    pend = run & (r == k)
                code = None
                if bool(m.any()):
                    code = _code(st, y, x, p3)
                    d = coder.decode(luts["zc"][zc_base + code], m)
                    pend = (d == 1) if pend is None else pend | (d == 1)
                if pend is not None and bool(pend.any()):
                    if code is None:
                        code = _code(st, y, x, p3)
                    sign(y, x, code, pend, bit)

    last_plane = None
    for g in range(3 * npl):
        en = (g >= g0) & (g < gend)
        if not bool(en.any()):
            continue
        plane = npl - 1 - g // 3
        if plane != last_plane:            # "visited" is per plane
            vis.zero_()
            last_plane = plane
        bit = 1 << plane
        (spp, lambda e, b: mrp(e, plane, b), cln)[g % 3](en, bit)

    mags = mag[:, 1:h + 1, 1:w + 1].reshape(B, h * w)
    neg = (st[:, 1:h + 1, 1:w + 1] == 2).reshape(B, h * w).to(torch.int64)
    packed = (mags - (neg << 31)).T.contiguous().to(torch.int32)
    if not with_stats:
        return packed
    return packed, torch.stack([coder.ndec, coder.nbytein]).to(torch.int32)


def unpack(packed: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Packed int32 samples -> (magnitudes uint32, sign bits uint8)."""
    u = packed.astype(np.int64) & _M32
    return ((u & 0x7FFFFFFF).astype(np.uint32),
            (u >> 31).astype(np.uint8))


def decode_blocks(blocks, device="cuda"
                  ) -> List[Optional[Tuple[np.ndarray, np.ndarray]]]:
    """blocks: [(data bytes, w, h, orient, numbps, numpasses), ...] ->
    [(mag (h, w) uint32, neg (h, w) uint8), ...] for the default
    code-block style. Blocks are grouped by shape, one group decode each
    (`ops/mq_dec.decode_group`: the kernel on a CUDA device, the plain
    version on the CPU); a block with no pass decodes to zeros."""
    from ..utils.device import resolve_device
    from . import mq_dec

    dev = resolve_device(device)
    out: List = [None] * len(blocks)
    groups = {}
    for bi, (data, w, h, orient, nb, npas) in enumerate(blocks):
        if nb <= 0 or npas <= 0:
            out[bi] = (np.zeros((h, w), np.uint32),
                       np.zeros((h, w), np.uint8))
            continue
        groups.setdefault((h, w), []).append(bi)
    for (h, w), idxs in sorted(groups.items()):
        arrays = mq_dec.pack_lanes([blocks[i][0] for i in idxs],
                                   [blocks[i][3] for i in idxs],
                                   [blocks[i][4] for i in idxs],
                                   [blocks[i][5] for i in idxs])
        packed = mq_dec.decode_group(
            *(torch.from_numpy(a).to(dev) for a in arrays), w, h)
        mags, negs = unpack(packed.cpu().numpy())
        for k, i in enumerate(idxs):
            out[i] = (mags[:, k].reshape(h, w), negs[:, k].reshape(h, w))
    return out
