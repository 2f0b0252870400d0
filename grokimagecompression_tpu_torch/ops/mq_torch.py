"""Part-1 MQ block coder in torch: the slot stream and the plain coder.

Port of the encoder half of `grokimagecompression_tpu/ops/mq_jax.py`
for the default code-block style (no LAZY / RESET / TERMALL / VSC /
PTERM / SEGSYM). The EBCOT decision stream of a code-block is a static
function of its magnitudes: a sample becomes significant in the plane
of its MSB, pass membership follows from neighbour significance, and
every context can be read with a "temporal" neighbour rule (a neighbour
earlier in scan order gives its post-pass state, a later one its
pre-pass state). So:

1. `build_slot_stream` analyses every (sample, plane) of a batch of
   same-shape blocks with tensor ops and writes one slot byte per
   decision position, in exact scan order: `emit | d << 1 | cx << 2`.
   Positions that code nothing are `emit = 0` slots, which leave the
   coder untouched. The one loop is the significance-propagation
   membership fixpoint (`_spp_members`). For rate control
   (`want_dist`) it also sums each pass's distortion decrease per lane.
2. The MQ coder walks each lane's slots. `ops/mq_scan.py` runs it as a
   CUDA kernel for CUDA tensors; `mq_scan_plain` here is its plain
   version: `mq_step` over the lanes' emitting slots, then `flush_tail`;
   for rate control it also records the byte-outs at every pass end.
3. `batch_pass_tables` and `passes_from_tables` turn those byte-outs and
   distortions into the host coder's per-pass R-D tables (numpy, on the
   host), as `mq_jax` does.

Layouts: blocks are (B, h, w) here (the reference's analysis runs on
(hp, w, B) for the TPU's lanes); the slot stream is (T, B) int8 with the
lanes last, as in the reference.

Left out, because they exist for the TPU only: the word accumulator and
the word compaction of the scan, the per-256-step byteout sums (the
scan records the pass-end counts they are summed into), the host splice.
The distortions are float64 sums here (float32 on the TPU): the host
coder's per-sample terms are multiples of 1/4, so float64 sums of them
are exact in any order and equal the host's.
"""

from __future__ import annotations

import functools
from typing import Dict, List, Tuple

import numpy as np
import torch

from ..codestream.t2 import PassInfo
from .mq_tables import (CTX_MAG, CTX_RL, CTX_SC, CTX_UNI, CTX_ZC,
                        DENSE_CHUNK,
                        NCTX_WORDS, NUM_CTXS, STATE_INIT, _CTX_INIT,
                        _TBL_PACKED)

OFFS = ((-1, -1), (-1, 0), (-1, 1), (0, -1), (0, 1), (1, -1), (1, 0),
        (1, 1))
_H = (OFFS.index((0, -1)), OFFS.index((0, 1)))
_V = (OFFS.index((-1, 0)), OFFS.index((1, 0)))
_D = tuple(OFFS.index(o) for o in ((-1, -1), (-1, 1), (1, -1), (1, 1)))

# ---------------------------------------------------------------------------
# Context rules as lookup tables
# ---------------------------------------------------------------------------


def _zc_rule(orient: int, h: int, v: int, d: int) -> int:
    """Table D.1: zero-coding context from the significant horizontal,
    vertical and diagonal neighbour counts (HL swaps h and v; HH is
    diagonal-major)."""
    if orient == 1:
        h, v = v, h
    if orient == 3:
        hv = h + v
        if d >= 3:
            return 8
        if d == 2:
            return 7 if hv >= 1 else 6
        if d == 1:
            return 5 if hv >= 2 else (4 if hv == 1 else 3)
        return 2 if hv >= 2 else (1 if hv == 1 else 0)
    if h == 2:
        return 8
    if h == 1:
        return 7 if v >= 1 else (6 if d >= 1 else 5)
    if v:
        return 2 + v
    return 2 if d >= 2 else d


def _sc_rule(hc: int, vc: int) -> Tuple[int, int]:
    """Table D.3: (sign context offset, prediction bit) from the clipped
    horizontal and vertical sign contributions."""
    spb = int(hc < 0 or (hc == 0 and vc < 0))
    if spb:
        hc, vc = -hc, -vc
    if hc == 1:
        return (4 if vc == 1 else 3 if vc == 0 else 2), spb
    return (1 if vc == 1 else 0), spb


# ZC_LUT[((orient * 3 + h) * 3 + v) * 5 + d] = CTX_ZC + context
_ZC_LUT = tuple(CTX_ZC + _zc_rule(o, h, v, d) for o in range(4)
                for h in range(3) for v in range(3) for d in range(5))
# SC_LUT[(hc + 1) * 3 + (vc + 1)] = (CTX_SC + offset, prediction bit)
_SC_LUT = tuple((CTX_SC + c, s) for (c, s) in (
    _sc_rule(hc, vc) for hc in (-1, 0, 1) for vc in (-1, 0, 1)))


@functools.lru_cache(maxsize=None)
def _luts(device: torch.device) -> Dict[str, torch.Tensor]:
    return {
        "zc": torch.tensor(_ZC_LUT, dtype=torch.int32, device=device),
        "sc_cx": torch.tensor([c for c, _ in _SC_LUT], dtype=torch.int32,
                              device=device),
        "sc_spb": torch.tensor([s for _, s in _SC_LUT], dtype=torch.int32,
                               device=device),
        "tbl": torch.tensor(_TBL_PACKED, dtype=torch.int64, device=device),
    }


# ---------------------------------------------------------------------------
# Static scan geometry
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=256)
def _geometry(h: int, w: int):
    """Static per-shape data for the padded (hp, w) grid, numpy, with o
    the scan-order index (stripes of 4 rows, column-major inside):
      alive (hp, w): sample is inside the true block
      earlier[k] (hp, w) per neighbour offset: the neighbour's o < own o
      earlier_col[k]: the neighbour's o < the o of the own column head
      agg_ok (hp, w): the sample's stripe may aggregate (all 4 rows real)
    """
    hp = -(-h // 4) * 4
    alive = np.zeros((hp, w), bool)
    alive[:h, :] = True
    o = np.zeros((hp, w), np.int64)
    idx = 0
    for y0 in range(0, hp, 4):
        for x in range(w):
            for yy in range(y0, y0 + 4):
                o[yy, x] = idx
                idx += 1
    colhead_o = o[(np.arange(hp) // 4) * 4]
    earlier = {}
    earlier_col = {}
    ys, xs = np.mgrid[0:hp, 0:w]
    for (dy, dx) in OFFS:
        ny, nx = ys + dy, xs + dx
        inb = (ny >= 0) & (ny < hp) & (nx >= 0) & (nx < w)
        no = o[np.clip(ny, 0, hp - 1), np.clip(nx, 0, w - 1)]
        earlier[(dy, dx)] = inb & (no < o)
        earlier_col[(dy, dx)] = inb & (no < colhead_o)
    agg_ok = np.zeros((hp, w), bool)
    for y0 in range(0, hp, 4):
        agg_ok[y0:y0 + 4, :] = (y0 + 4) <= h
    return dict(hp=hp, alive=alive, earlier=earlier,
                earlier_col=earlier_col, agg_ok=agg_ok)


@functools.lru_cache(maxsize=256)
def _geometry_on(h: int, w: int, device: torch.device):
    """`_geometry` as bool tensors on `device` (masks broadcast over the
    leading lane axis)."""
    g = _geometry(h, w)

    def t(a):
        return torch.as_tensor(a, device=device)

    return dict(
        hp=g["hp"], alive=t(g["alive"]),
        earlier=[t(g["earlier"][off]) for off in OFFS],
        earlier_col=[t(g["earlier_col"][off]) for off in OFFS],
        agg_ok=t(g["agg_ok"][0::4]),       # (ns, w), one row per stripe
        row_in_stripe=t(np.arange(g["hp"]) % 4).view(-1, 1))


def _pad256(n: int) -> int:
    return -(-n // 256) * 256


@functools.lru_cache(maxsize=256)
def pass_spans_padded(h: int, w: int) -> Tuple[int, int, int]:
    """(SPP, MRP, CLN) slot-section lengths per plane, each padded with
    no-op slots to a multiple of 256 (the reference pads so that pass
    boundaries land on its scan kernel's 256-step chunks; the port keeps
    the same stream)."""
    hp = -(-h // 4) * 4
    nsw = (hp // 4) * w
    return (_pad256(8 * nsw), _pad256(4 * nsw), _pad256(11 * nsw))


def slots_per_plane(h: int, w: int) -> int:
    return sum(pass_spans_padded(h, w))


# ---------------------------------------------------------------------------
# Analysis (tensor ops over (B, hp, w) lane batches)
# ---------------------------------------------------------------------------


def _shift(a: torch.Tensor, dy: int, dx: int) -> torch.Tensor:
    """result[..., y, x] = a[..., y + dy, x + dx], 0 outside."""
    H, W = a.shape[-2], a.shape[-1]
    out = torch.zeros_like(a)
    out[..., max(-dy, 0):H - max(dy, 0), max(-dx, 0):W - max(dx, 0)] = \
        a[..., max(dy, 0):H + min(dy, 0), max(dx, 0):W + min(dx, 0)]
    return out


def _any(planes) -> torch.Tensor:
    out = planes[0]
    for p in planes[1:]:
        out = out | p
    return out


def _temporal_neighbors(before, after, geo, col=False) -> List[torch.Tensor]:
    """Per offset (OFFS order), the neighbour's significance under the
    temporal rule: earlier in scan order -> `after`, else `before`."""
    masks = geo["earlier_col" if col else "earlier"]
    return [torch.where(e, _shift(after, *off), _shift(before, *off))
            for e, off in zip(masks, OFFS)]


def _count(nb, which) -> torch.Tensor:
    out = nb[which[0]].to(torch.int64)
    for k in which[1:]:
        out = out + nb[k]
    return out


def _zc_ctx(nb, orient, luts) -> torch.Tensor:
    """Zero-coding context (CTX_ZC + Table D.1) per sample; orient is
    (B, 1, 1) int64."""
    idx = ((orient * 3 + _count(nb, _H)) * 3 + _count(nb, _V)) * 5 \
        + _count(nb, _D)
    return luts["zc"][idx]


def _sc_ctx(nb, negsh, luts) -> Tuple[torch.Tensor, torch.Tensor]:
    """(sign context, prediction bit) per sample from the significance of
    the four h/v neighbours `nb` and their shifted sign planes `negsh`
    (dict offset index -> (B, hp, w) bool)."""
    def contrib(k):
        return torch.where(nb[k], 1 - 2 * negsh[k].to(torch.int64), 0)

    hc = torch.clamp(contrib(_H[0]) + contrib(_H[1]), -1, 1)
    vc = torch.clamp(contrib(_V[0]) + contrib(_V[1]), -1, 1)
    idx = (hc + 1) * 3 + (vc + 1)
    return luts["sc_cx"][idx], luts["sc_spb"][idx]


def _spp_members(sigS, bit, geo) -> torch.Tensor:
    """Significance-propagation membership: the least fixpoint of
    member = ~sigS & (some neighbour is significant before the pass, or
    is an earlier member that became significant). Iterated until
    nothing changes (the reference's lax.while_loop)."""
    base = _any([_shift(sigS, *off) for off in OFFS])
    member = ~sigS & base
    while True:
        mb = member & bit
        acc = base
        for e, off in zip(geo["earlier"], OFFS):
            acc = acc | (e & _shift(mb, *off))
        new = ~sigS & acc
        if torch.equal(new, member):
            return member
        member = new


def _pack_slot(emit, d, cx) -> torch.Tensor:
    """Slot byte emit | d << 1 | cx << 2 (int32)."""
    return emit.to(torch.int32) | (d.to(torch.int32) << 1) | (cx << 2)


def _plane_dists(mag, plane: int, sig_spp, ref_mrp, sig_cln):
    """(3, B) float64 distortion decreases of one plane's SPP, MRP and CLN
    passes, scaled by 4^-plane: for a sample becoming significant,
    sig_dist / 4^p = 3 v / 2^p - 2.25; for a refined one, ref_dist / 4^p =
    (r / 2^p - 1)^2 - (s / 2^p - 0.5)^2 with r = v mod 2^(p+1), s = v mod
    2^p (the host coder's terms, `t1.cpp` sig_dist / ref_dist, and the
    reference's `mq_jax._plane_slots`). Every term is exact in float64,
    and so is every sum of them."""
    inv = 2.0 ** -plane
    sig = 3.0 * (mag.to(torch.float64) * inv) - 2.25
    r = (mag & ((2 << plane) - 1)).to(torch.float64) * inv - 1.0
    sv = (mag & ((1 << plane) - 1)).to(torch.float64) * inv - 0.5
    ref = r * r - sv * sv
    zero = torch.zeros((), dtype=torch.float64, device=mag.device)
    return torch.stack([torch.where(m, t, zero).sum(dim=(1, 2))
                        for m, t in ((sig_spp, sig), (ref_mrp, ref),
                                     (sig_cln, sig))])


def _plane_slots(mag, neg, negsh, orient, nbps, plane: int, geo, luts,
                 want_dist: bool = False):
    """All slot bytes of one plane in exact scan order: (B, T_plane)
    int32 with T_plane = slots_per_plane(h, w); with `want_dist` also the
    plane's (3, B) pass distortions (`_plane_dists`).

    mag (B, hp, w) int32; neg (B, hp, w) int32 0/1; negsh the sign planes
    shifted to the four h/v neighbours; orient, nbps (B, 1, 1) int64."""
    B, hp, w = mag.shape
    ns = hp // 4
    alive = geo["alive"]

    bit_p = (mag >> plane) & 1
    bit_b = bit_p == 1
    sigS = (mag >> (plane + 1)) != 0
    sigE = (mag >> plane) != 0
    spp_valid = plane <= nbps - 2
    cln_valid = plane <= nbps - 1

    member = _spp_members(sigS, bit_b, geo) & spp_valid & alive
    sigM = sigS | (member & bit_b)

    # significance propagation
    nb_spp = _temporal_neighbors(sigS, sigM, geo)
    scc, spb = _sc_ctx(nb_spp, negsh, luts)
    spp_zc = _pack_slot(member, bit_p, _zc_ctx(nb_spp, orient, luts))
    spp_sc = _pack_slot(member & bit_b, neg ^ spb, scc)

    # magnitude refinement: members are significant before the plane; a
    # sample whose MSB plane q >= plane + 2 was refined before
    mrp_member = sigS & spp_valid & alive
    nb_any_m = _any([_shift(sigM, *off) for off in OFFS])
    refined = (mag >> min(plane + 2, 31)) != 0
    mag_ctx = torch.where(refined, CTX_MAG + 2,
                          CTX_MAG + nb_any_m.to(torch.int32))
    mrp = _pack_slot(mrp_member, bit_p, mag_ctx)

    # cleanup, with run-length aggregation decided at column start
    cln_member = ~sigM & ~member & cln_valid & alive
    blocks_agg = sigM | member | _any(
        _temporal_neighbors(sigM, sigE, geo, col=True))
    agg_head = (~blocks_agg.view(B, ns, 4, w).any(dim=2)
                & geo["agg_ok"] & cln_valid)                  # (B, ns, w)
    bits4 = bit_b.view(B, ns, 4, w)
    any4 = bits4.any(dim=2)
    rows = torch.arange(4, device=mag.device).view(1, 1, 4, 1)
    r4 = torch.where(bits4, rows, 4).amin(dim=2)              # first 1 row
    hit = any4 & agg_head

    def per_sample(x):
        return x.unsqueeze(2).expand(B, ns, 4, w).reshape(B, hp, w)

    agg, hit_s, r_s = per_sample(agg_head), per_sample(hit), per_sample(r4)
    row = geo["row_in_stripe"]
    normal = cln_member & torch.where(agg, hit_s & (row > r_s), True)
    is_r = agg & hit_s & (row == r_s)
    nb_cln = _temporal_neighbors(sigM, sigE, geo)
    scc_c, spb_c = _sc_ctx(nb_cln, negsh, luts)
    cln_zc = _pack_slot(normal, bit_p, _zc_ctx(nb_cln, orient, luts))
    cln_sc = _pack_slot((normal & bit_b) | is_r, neg ^ spb_c, scc_c)
    rl = _pack_slot(agg_head, any4, CTX_RL)
    uni1 = _pack_slot(hit, (r4 >> 1) & 1, CTX_UNI)
    uni2 = _pack_slot(hit, r4 & 1, CTX_UNI)

    # scan order: stripe, column, row; SPP codes (zc, sc) pairs, CLN
    # column heads (rl, uni, uni) then (zc, sc) pairs
    def pairs(a, b):
        return torch.stack([a, b], dim=-1).view(B, ns, 4, w, 2) \
            .permute(0, 1, 3, 2, 4)

    spp = pairs(spp_zc, spp_sc).reshape(B, -1)
    mrp = mrp.view(B, ns, 4, w).permute(0, 1, 3, 2).reshape(B, -1)
    cln = torch.cat([torch.stack([rl, uni1, uni2], dim=-1),
                     pairs(cln_zc, cln_sc).reshape(B, ns, w, 8)],
                    dim=-1).reshape(B, -1)
    out = torch.zeros((B, slots_per_plane(hp, w)), dtype=torch.int32,
                      device=mag.device)
    pos = 0
    for part, span in zip((spp, mrp, cln), pass_spans_padded(hp, w)):
        out[:, pos:pos + part.shape[1]] = part
        pos += span
    if not want_dist:
        return out
    return out, _plane_dists(mag, plane, member & bit_b, mrp_member,
                             (normal & bit_b) | is_r)


def build_slot_stream(mag: torch.Tensor, neg: torch.Tensor,
                      orient: torch.Tensor, nbps: torch.Tensor,
                      nplanes: int, want_dist: bool = False):
    """The slot stream of a batch of same-shape code-blocks over
    `nplanes` planes, MSB plane first.

    mag: (B, h, w) integer magnitudes < 2**30; neg: (B, h, w) sign bits
    (nonzero = negative); orient: (B,) band orientation 0..3; nbps: (B,)
    each block's magnitude bit-planes (0 for an all-zero block). Returns
    (nplanes * slots_per_plane(h, w), B) int8. Planes at or above the
    batch's largest nbps are all zero slots, as in the reference. With
    `want_dist` it returns (slots, dists): dists (nplanes, 3, B) float64,
    each (plane, pass)'s distortion decrease scaled by 4^-plane, planes
    MSB first (`mq_jax.build_slot_stream(want_dist=True)`)."""
    B, h, w = mag.shape
    dev = mag.device
    geo = _geometry_on(h, w, dev)
    luts = _luts(dev)
    hp = geo["hp"]
    tp = slots_per_plane(h, w)
    out = torch.zeros((nplanes * tp, B), dtype=torch.int8, device=dev)
    dists = torch.zeros((nplanes, 3, B), dtype=torch.float64, device=dev)
    maxnb = int(nbps.max()) if B else 0
    if maxnb == 0:
        return (out, dists) if want_dist else out
    mag = _pad_rows(mag.to(torch.int32), hp)
    neg = _pad_rows(neg != 0, hp)
    negsh = {k: _shift(neg, *OFFS[k]) for k in _H + _V}
    neg = neg.to(torch.int32)
    orient = orient.to(torch.int64).view(B, 1, 1)
    nbps = nbps.to(torch.int64).view(B, 1, 1)
    for q in range(nplanes):
        plane = nplanes - 1 - q
        if plane >= maxnb:
            continue
        s = _plane_slots(mag, neg, negsh, orient, nbps, plane, geo, luts,
                         want_dist)
        if want_dist:
            s, dists[q] = s
        out[q * tp:(q + 1) * tp] = s.T.to(torch.int8)
    return (out, dists) if want_dist else out


def _pad_rows(a: torch.Tensor, hp: int) -> torch.Tensor:
    """(B, h, w) -> (B, hp, w), zero rows appended."""
    h = a.shape[1]
    if h == hp:
        return a
    out = torch.zeros((a.shape[0], hp, a.shape[2]), dtype=a.dtype,
                      device=a.device)
    out[:, :h] = a
    return out


def bit_planes(mag: torch.Tensor) -> torch.Tensor:
    """(B, ...) magnitudes -> (B,) int32 bit length of each lane's largest
    magnitude (0 for an all-zero lane)."""
    mx = mag.reshape(mag.shape[0], -1).amax(dim=1).to(torch.int64)
    ks = torch.arange(31, device=mag.device)
    return ((mx[:, None] >> ks) != 0).sum(dim=1).to(torch.int32)


# ---------------------------------------------------------------------------
# The MQ coder (plain version of csrc/mq_scan.cu and csrc/mq_dense.cu)
# ---------------------------------------------------------------------------


def _byteout(c, ct, last, bo):
    """BYTEOUT (C.3.2) with the one-byte delay register `last` (-1 = no
    byte yet), where `bo`. Returns (c, ct, last, byte, valid): the byte
    written to the segment, where `valid`."""
    ff = last == 0xFF
    carry = c > 0x7FFFFFF
    lastc = torch.where(carry & (last >= 0), last + 1, last)
    path_ffc = ~ff & (lastc == 0xFF)        # became 0xFF through the carry
    byte = torch.where(ff, last, lastc)
    valid = bo & (last >= 0)
    c_low = torch.where(carry & ~ff, c & 0x7FFFFFF, c)
    stuffed = ff | path_ffc                 # the next byte carries 7 bits
    new_last = torch.where(stuffed, (c_low >> 20) & 0xFF,
                           (c_low >> 19) & 0xFF)
    new_c = torch.where(stuffed, c_low & 0xFFFFF, c_low & 0x7FFFF)
    new_ct = torch.where(stuffed, 7, 8)
    return (torch.where(bo, new_c, c), torch.where(bo, new_ct, ct),
            torch.where(bo, new_last, last), byte & 0xFF, valid)


def mq_step(state, slot, tbl):
    """One slot on lane vectors. state: (a, c, ct, last, ctx) with ctx
    the (NUM_CTXS, B) context states (idx << 1 | mps), all int64; slot
    (B,) int64; tbl the packed Table C.2 rows. A slot with emit = 0
    leaves the state as it is. Returns (state', bytes (3, B), valid
    (3, B)): the <= 3 bytes the step writes, in order."""
    a, c, ct, last, ctx = state
    emit = (slot & 1) == 1
    d = (slot >> 1) & 1
    cx = (slot >> 2).view(1, -1)
    p = ctx.gather(0, cx)[0]
    mps = p & 1
    row = tbl[p >> 1]
    qe = row >> 13
    a1 = a - qe
    mpspath = d == mps
    short = (mpspath & ((a1 & 0x8000) != 0)) | ~emit
    # long paths: the conditional exchange of C.2.4
    swap = mpspath ^ (a1 < qe)
    c2 = torch.where(short, torch.where(emit, c + qe, c),
                     torch.where(swap, c + qe, c))
    a2 = torch.where(short, torch.where(emit, a1, a),
                     torch.where(swap, a1, qe))
    wb = emit & ~short
    newp = (torch.where(mpspath, (row >> 7) & 63, (row >> 1) & 63) << 1) \
        | torch.where(mpspath | ((row & 1) == 0), mps, 1 - mps)
    ctx = ctx.scatter(0, cx, torch.where(wb, newp, p).view(1, -1))
    # RENORME: shift until bit 15 of A is set; a2 is in [1, 0xFFFF] on
    # the renormalising path, so its bit length is frexp's exponent
    n = torch.where(wb, 16 - torch.frexp(a2.to(torch.float64))[1], 0)
    a3 = torch.where(wb, (a2 << n) & 0xFFFF, a2)
    # at most 15 shifts, CT >= 7 after a byte-out: <= 3 byte-outs; once a
    # round has no byte-out in any lane, every shift is done
    cc, cct, clast, nrem = c2, ct, last, n
    outs = torch.zeros((3,) + c.shape, dtype=c.dtype, device=c.device)
    valids = torch.zeros((3,) + c.shape, dtype=torch.bool, device=c.device)
    for k in range(3):
        s = torch.minimum(nrem, cct)
        cc = cc << s
        cct = cct - s
        nrem = nrem - s
        bo = wb & (cct == 0)
        if not bool(bo.any()):
            break
        cc, cct, clast, outs[k], valids[k] = _byteout(cc, cct, clast, bo)
    return (a3, cc, cct, clast, ctx), outs, valids


def flush_tail(a, c, ct, last):
    """FLUSH (C.3.4) on lane vectors from the end-of-scan state: two
    byte-outs, then the delayed byte unless it is 0xFF (the trailing 0xFF
    is dropped). Returns (bytes (3, B), valid (3, B))."""
    tempc = c + a
    c = c | 0xFFFF
    c = torch.where(c >= tempc, c - 0x8000, c)
    every = torch.ones_like(c, dtype=torch.bool)
    outs, valids = [], []
    for _ in range(2):
        c, ct, last, byte, valid = _byteout(c << ct, ct, last, every)
        outs.append(byte)
        valids.append(valid)
    outs.append(last & 0xFF)
    valids.append((last >= 0) & (last != 0xFF))
    return torch.stack(outs), torch.stack(valids)


def init_state(B: int, device) -> Tuple[torch.Tensor, ...]:
    def full(v):
        return torch.full((B,), v, dtype=torch.int64, device=device)

    ctx = torch.tensor(_CTX_INIT, dtype=torch.int64, device=device) \
        .view(-1, 1).expand(NUM_CTXS, B).contiguous()
    return tuple(full(v) for v in STATE_INIT[:4]) + (ctx,)


def pack_contexts(ctx: torch.Tensor) -> torch.Tensor:
    """(NUM_CTXS, B) context states -> (NCTX_WORDS, B) packed words
    (contexts 4k..4k+3 in word k, 8 bits each)."""
    pad = torch.zeros((4 * NCTX_WORDS - NUM_CTXS, ctx.shape[1]),
                      dtype=ctx.dtype, device=ctx.device)
    c4 = torch.cat([ctx, pad]).view(NCTX_WORDS, 4, -1)
    shifts = (8 * torch.arange(4, device=ctx.device)).view(1, 4, 1)
    return (c4 << shifts).sum(dim=1)


def _emitting(slots: torch.Tensor):
    """(dense, rank, lane, t): `emitting_slots`, and for each emitting slot
    its lane, its row t in `slots` and its row rank in `dense`."""
    emit = (slots & 1) != 0
    counts = emit.sum(dim=0)
    B = slots.shape[1]
    E = int(counts.max()) if B else 0
    lane, t = emit.T.nonzero(as_tuple=True)       # lane-major, t ascending
    start = torch.cumsum(counts, 0) - counts
    rank = torch.arange(lane.shape[0], device=slots.device) - start[lane]
    dense = torch.zeros((E, B), dtype=torch.int64, device=slots.device)
    dense[rank, lane] = slots[t, lane].to(torch.int64)
    return dense, rank, lane, t


def emitting_slots(slots: torch.Tensor) -> torch.Tensor:
    """The lanes' emitting slots moved to the front of their columns:
    (E, B) int64, zero after a lane's own count, with E the largest
    count. Slots with emit = 0 leave the coder as it is, so coding the
    result gives the same bytes as coding `slots`."""
    return _emitting(slots)[0]


def pass_ends(T: int, spans) -> List[int]:
    """Slot positions where the passes of a stream of T slots end: plane
    q's SPP, MRP and CLN sections of `spans` = (sa, sb, sc) end at
    q tp + sa, q tp + sa + sb and (q + 1) tp."""
    sa, sb, sc = spans
    tp = sa + sb + sc
    return [q * tp + e for q in range(T // tp) for e in (sa, sa + sb, tp)]


def mq_scan_plain(slots: torch.Tensor, spans=None):
    """The MQ coder over a (T, B) int8 slot stream, lane by lane: returns
    (data uint8 (N,), lens int32 (B,), state int32 (NSTATE, B)). `data`
    holds each lane's complete segment (the bytes of the scan, then the
    FLUSH tail), lane after lane; `lens` their lengths; `state` the
    coder state at the end of the scan, before the flush (A, C, CT, the
    delayed byte, the packed contexts). With `spans` (see `pass_ends`)
    also cumbo (3 T / tp, B) int32: each lane's byte-outs at every pass
    end, the bytes written plus the one held in the delay register."""
    dev = slots.device
    B = slots.shape[1]
    dense = emitting_slots(slots)
    tbl = _luts(dev)["tbl"]
    state = init_state(B, dev)
    E = dense.shape[0]
    out = torch.zeros((E + 1, 3, B), dtype=torch.uint8, device=dev)
    valid = torch.zeros((E + 1, 3, B), dtype=torch.bool, device=dev)
    # byte-outs after each coding step; a lane's pass end at slot e is
    # after its step (emitting slots before e) - 1
    nbo = torch.zeros((E + 1, B), dtype=torch.int64, device=dev)
    written = torch.zeros(B, dtype=torch.int64, device=dev)
    for t in range(E):
        state, out[t], valid[t] = mq_step(state, dense[t], tbl)
        written += valid[t].sum(dim=0)
        nbo[t + 1] = written + (state[3] >= 0)
    a, c, ct, last, ctx = state
    out[E], valid[E] = flush_tail(a, c, ct, last)
    out = out.view(-1, B).T
    valid = valid.view(-1, B).T
    st = torch.cat([torch.stack([a, c, ct, last]), pack_contexts(ctx)])
    res = (out[valid], valid.sum(dim=1).to(torch.int32), st.to(torch.int32))
    if spans is None:
        return res
    ends = torch.tensor(pass_ends(slots.shape[0], spans), dtype=torch.int64,
                        device=dev)
    coded = torch.cumsum((slots & 1).to(torch.int64), dim=0)[ends - 1]
    return res + (nbo.gather(0, coded).to(torch.int32),)


def _int32(x: torch.Tensor) -> torch.Tensor:
    """int64 values in [-2^31, 2^32) -> int32 of the same low 32 bits."""
    return torch.where(x >= 1 << 31, x - (1 << 32), x).to(torch.int32)


def mq_scan_dense_plain(slots: torch.Tensor, t_out: int = 0):
    """The MQ coder over a (T, B) int8 slot stream with dense per-step
    outputs, the plain version of `csrc/mq_dense.cu`'s `mq_scan_dense`
    and of the reference's `mq_jax._mq_scan_w` / `mq_scan_pallas.
    mq_scan_blocked`. Returns, over t_out >= T rows (T when 0; rows past
    T are steps of no-op slots):
      words (t_out, B) int32: the 32-bit word completed at the step, its
        bytes in coding order from the least significant (0 where none);
      m8 (t_out, B) int32: that word's index among the lane's words of
        its DENSE_CHUNK-step chunk, -1 where none;
      nbo (t_out, B) int32: the step's byte-outs (0-3), the first one of
        a lane included, which writes no byte;
      state (DENSE_NSTATE, B) int32: A, C, CT, the delayed byte, the
        partial word `wacc` and its byte count `wcnt`, the five packed
        context words.
    At most 3 bytes a step, so at most one word completes a step. The
    coder runs over each lane's emitting slots only (`_emitting`)."""
    dev = slots.device
    T, B = slots.shape
    t_out = t_out or T
    if t_out < T:
        raise ValueError(f"t_out {t_out} is below the stream's {T} rows")
    dense, rank, lane, t = _emitting(slots)
    words, full, nbo, st = dense_steps(dense)
    out_w = torch.zeros((t_out, B), dtype=torch.int32, device=dev)
    out_full = torch.zeros((t_out, B), dtype=torch.bool, device=dev)
    out_nbo = torch.zeros((t_out, B), dtype=torch.int32, device=dev)
    out_w[t, lane] = _int32(words[rank, lane])
    out_full[t, lane] = full[rank, lane]
    out_nbo[t, lane] = nbo[rank, lane].to(torch.int32)
    nch = -(-t_out // DENSE_CHUNK)
    mc = torch.zeros((nch * DENSE_CHUNK, B), dtype=torch.int32, device=dev)
    mc[:t_out] = out_full.to(torch.int32)
    mc = mc.view(nch, DENSE_CHUNK, B)
    m8 = torch.where(mc > 0, torch.cumsum(mc, dim=1) - 1, -1) \
        .view(-1, B)[:t_out].to(torch.int32)
    return out_w, m8, out_nbo, st


def dense_steps(dense: torch.Tensor):
    """The dense coder's record of each lane's coding steps, in order, on
    the lanes' emitting slots `dense` (E, B) (`emitting_slots`): (words,
    full, nbo, state). Row k of the (E, B) int64 `words`, bool `full` and
    int64 `nbo` is the lane's k-th emitting slot: the word completed there
    (0 where none), whether one was, the step's byte-outs; `state` is
    `mq_scan_dense_plain`'s. The dense rows place the k-th record at the
    lane's k-th emitting row."""
    dev = dense.device
    E, B = dense.shape
    tbl = _luts(dev)["tbl"]
    state = init_state(B, dev)
    wacc = torch.zeros(B, dtype=torch.int64, device=dev)
    wcnt = torch.zeros(B, dtype=torch.int64, device=dev)
    words = torch.zeros((E, B), dtype=torch.int64, device=dev)
    full = torch.zeros((E, B), dtype=torch.bool, device=dev)
    nbo = torch.zeros((E, B), dtype=torch.int64, device=dev)
    for k in range(E):
        had_byte = state[3] >= 0
        state, outs, valids = mq_step(state, dense[k], tbl)
        # a byte-out writes the delayed byte, except the lane's first
        nbo[k] = valids.sum(dim=0) + (~had_byte & (state[3] >= 0))
        for j in range(3):
            wacc = torch.where(valids[j], wacc | (outs[j] << (8 * wcnt)),
                               wacc)
            wcnt = wcnt + valids[j]
            done = wcnt == 4
            words[k] = torch.where(done, wacc, words[k])
            full[k] |= done
            wacc = torch.where(done, 0, wacc)
            wcnt = torch.where(done, 0, wcnt)
    a, c, ct, last, ctx = state
    st = torch.cat([torch.stack([a, c, ct, last, wacc, wcnt]),
                    pack_contexts(ctx)])
    return words, full, nbo, _int32(st)


# ---------------------------------------------------------------------------
# R-D pass tables (host, numpy)
# ---------------------------------------------------------------------------


def batch_pass_tables(totals: np.ndarray, nbs: np.ndarray, npl: int,
                      cumbo: np.ndarray, dists: np.ndarray):
    """Vectorized PCRD pass tables for a lane batch (a copy of
    `mq_jax.batch_pass_tables`).

    totals (B,) segment byte lengths; nbs (B,) per-lane bitplane
    counts; cumbo/dists (3*npl, B) device cumulative byteouts /
    4^-plane-scaled distortion sums (rows: plane npl-1..0 x SPP, MRP,
    CLN). Returns (rates (3*npl, B) int64, dist_cum (3*npl, B)
    float64). Rates follow t1_np.encode_cblk exactly: non-terminated
    rate = bytes_so_far + 5 clamped monotone into [prev, total]; the
    final (terminated) pass is the exact segment length. A pure-numpy
    reformulation of the per-lane loop: the forward/backward clamp
    passes are running min/max scans along the pass axis."""
    nrows = 3 * npl
    planes = npl - 1 - (np.arange(nrows) // 3)
    dist_cum = np.cumsum(dists * np.power(4.0, planes)[:, None], axis=0)
    rates = np.minimum(cumbo.astype(np.int64) + 5, totals[None, :])
    rates[-1] = totals
    # backward min scan then forward max scan (the two clamp loops)
    rates = np.minimum.accumulate(rates[::-1], axis=0)[::-1]
    rates = np.maximum.accumulate(rates, axis=0)
    return rates, dist_cum


def passes_from_tables(nb: int, npl: int, rates: np.ndarray,
                       dcum: np.ndarray) -> List[PassInfo]:
    """PassInfo list for one lane from its batch_pass_tables columns (a
    copy of `mq_jax._passes_from_tables`). A lane with nb < npl
    bitplanes starts at the CLN of plane nb-1 (row 3*(npl-nb)+2); rows
    before it carry no distortion (its planes above nb are masked out),
    so the cumulative rows are aligned."""
    if nb <= 0:
        return []
    j0 = 3 * (npl - nb) + 2
    last = 3 * npl - 1
    return [PassInfo(rate=int(rates[j]), distortion=float(dcum[j]),
                     terminated=j == last)
            for j in range(j0, 3 * npl)]
