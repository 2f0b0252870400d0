"""Fused tile decode on the device: entropy-coded blocks in, samples out.

Port of `grokimagecompression_tpu/models/fused_decode.py`
(`decode_tiles_device_submit` / `_collect` and the program of
`_jitted_fused_dec_batch`), for both block coders. After the host has
parsed the packets (T2), one fused decoder per tile geometry runs, for a
chunk of same-geometry tiles, the group decoder of each block shape, then
band-plane assembly and the inverse DWT, inverse MCT and DC unshift
(`pipeline._inv_transform`). Only the sample planes come back.

- HT (`FusedHTDecoder`): the host packs each block's raw cleanup segment
  (`ops/ht_dec.pack_segments`); the CUDA HT decoder
  (`ops/ht_dec.decode_segments`) unstuffs and decodes them (on the CPU
  its plain version runs the host prepass first); a per-lane validity
  mask zeroes blocks that a frame leaves out or whose segment is
  structurally invalid (they decode a dummy two-byte segment).
- MQ (`FusedMQDecoder`, Part-1, default code-block style): the host packs
  each block's raw codeword segment (`ops/mq_dec.pack_lanes`); the CUDA MQ
  decoder (`ops/mq_dec.py`) decodes them; a block that a frame leaves out
  gets an idle lane (no pass) and stays zero. Nonzero magnitudes take a
  per-lane reversible mid-point addend at the block's lowest decoded
  plane (`_lane_halves`), so truncated blocks reconstruct like the host
  decoder.
- T1 (`FusedT1Decoder`): the Part-1 MQ code-block styles other than the
  default, MQ bands deeper than the CUDA MQ decoder's word, HT tiles
  whose code-blocks carry refinement passes, and HT bands whose Mb + 3
  exceeds the CUDA HT decoder's 32 bits. The host library's Tier-1
  decoders (MQ, HT refined, HT cleanup) decode the chunk's blocks
  straight into the band planes, with the mid-point reconstruction and
  the 9/7 dequantization, as the reference's host decode does
  (`t1/backend.decode_cblk_batch_bands`, one threaded call a chunk and
  decoder); the planes go to the device in one upload, and the inverse
  transforms run there.

The plan gives every code-block of the tile's geometry a lane, whether a
frame includes it or not, and each frame's jobs go to their lanes by
code-block position. Lanes are frame-major: frame f's blocks of a group
sit at lanes f*B .. f*B+B-1, so one plan serves any content. The plan is
built from each component's own plan, so components whose code-blocks
differ in size (COC) put their blocks in lane groups of their own shapes,
and each band keeps its own component's stepsize (QCC). A T1 plan's
lanes each take their component's code-block style (`FusedDecPlan.
styles`).

Band assembly is one `index_copy_` per shape group into a flat per-frame
buffer holding every band of every component, with plan-static
indices, in place of the reference's chain of per-block
`dynamic_update_slice` calls.

On the irreversible (9/7) path the coefficients are float32: a nonzero
magnitude takes its mid-point (0.5 for HT lanes; 0.5 * 2^pm at the lowest
decoded plane pm for MQ lanes, `_lane_halves`) and is scaled by its
band's stepsize (`FusedDecPlan.stepsizes`), each step rounded in float32
in the host dequantizer's order (`quant.reconstruct`); the inverse 9/7
DWT, inverse ICT and rounding follow in `pipeline._inv_transform`. Bands
in which no block is coded stay zero.

A tile whose components differ in transform, resolution count or block
coder (COC) gets one plan per group of components that share them
(`build_plan(comps=)`): each decodes and inverts its components' DWT
only (a `raw` transform config), and the caller runs the inverse MCT
and DC shift over the whole tile (`pipeline.inv_mct_dc`). A Part-2
custom MCT rides in the config (`pipeline.config_for_tile`). ROI
components keep their blocks' decoded magnitudes (the shift only raises
Kmax); their MQ lanes reconstruct at plane 0 where the reference's host
decoder does (`pm_zero`).

Two plan variants serve the per-image decode (`codestream/decoder.
decode`):
- reduced (`build_plan(..., max_res=)`): only the lanes and bands of
  resolutions up to `max_res`, inverted to that resolution. The
  reference decodes every block and then leaves the higher bands unread;
  the samples are the same, and the device does the reduced work only.
- windowed (`build_plan(..., window_slots=)`): lanes for the window's
  code-blocks only (`tile.decode_tile(window=)`), scattered into
  per-band bounding boxes over those blocks, zero elsewhere, as the
  reference's banded window store (its `_band_bb`). The decoder returns
  the dequantized boxes, not samples: the host fetches them and runs the
  windowed inverse (`ops/dwt_window.py`), as the reference does.

Scope: the HT decoder needs every band's Mb + 3 <= 32
(`ht_dec_pallas.supports`; `build_plan` sends a deeper HT plan to the T1
decoder, as the reference decodes such bands off its Pallas decoder);
the MQ decoder keeps the sign in bit 31, so Mb <= 30, and one codeword
segment per block (the default style); the T1 decoder takes any Part-1
style and depth, and HT blocks with or without refinement passes.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from ..core.geometry import Rect
from ..ops import ht_dec, ht_tables, mq_dec
from ..ops.quant import reconstruct, trunc_plane
from ..t1 import backend as t1_backend
from . import pipeline

DUMMY_SEGMENT = b"\x00\x00"


@dataclasses.dataclass(frozen=True)
class DecBlock:
    comp: int
    key: Tuple[int, int]
    y0: int                     # offset inside the band plane
    x0: int
    h: int
    w: int

    @property
    def slot(self) -> Tuple[int, Tuple[int, int], int, int]:
        """The code-block's identity within the tile: (comp, band key,
        y0, x0), as `jobs_by_block` keys a frame's jobs."""
        return (self.comp, self.key, self.y0, self.x0)


@dataclasses.dataclass(frozen=True)
class FusedDecPlan:
    """Static per-tile-geometry decode plan (hashable)."""
    cfg: pipeline.TileTransformConfig
    # (w, h, lanes) per shape group, sorted by (w, h)
    groups: Tuple[Tuple[int, int, Tuple[DecBlock, ...]], ...]
    band_shapes: Tuple[Tuple[int, int, int, int, int], ...]  # (c, r, o, h, w)
    # per band (band_shapes order): its stepsize, 1.0 when reversible
    stepsizes: Tuple[float, ...]
    coder: str = "ht"           # the block coder: "ht" or "mq"
    # the highest resolution decoded; None: all
    max_res: Optional[int] = None
    # a window plan: per band (band_shapes order) the (y0, x0) of its
    # bounding box in the band plane, band_shapes holding the box's
    # (h, w); the decoder returns the boxes. None: whole bands, inverted
    boxes: Optional[Tuple[Tuple[int, int], ...]] = None
    # the tile components the plan decodes, in output order (a group of
    # a tile whose components differ in transform, resolutions or coder;
    # `cfg.raw`); None: all of them
    comps: Optional[Tuple[int, ...]] = None
    # components whose MQ lanes reconstruct at plane 0 rather than at
    # their lowest decoded plane (ROI components decoded as the
    # reference's host decoder decodes a tile with COC overrides)
    pm_zero: Tuple[int, ...] = ()
    # T1: the code-block style of each component the plan decodes, in
    # `plan_comps` order
    styles: Tuple[int, ...] = ()


def plan_comps(plan: FusedDecPlan) -> Tuple[int, ...]:
    """The tile components a plan decodes, in its output order."""
    if plan.comps is not None:
        return plan.comps
    return tuple(range(len(plan.cfg.tc_rects)))


def build_plan(plans, siz, cod, tile: Rect, coder: str = "ht",
               max_res: Optional[int] = None, window_slots=None,
               comps: Optional[Tuple[int, ...]] = None, custom_mct=None,
               pm_zero: Tuple[int, ...] = (),
               styles: Tuple[int, ...] = ()) -> FusedDecPlan:
    """The decode plan of one tile from its components' plans
    (`codestream/tile.build_comp_plan`, each with its component's COC,
    QCC and ROI shift) for the block coder `coder` ("ht", "mq", or "t1":
    the host Tier-1 decoders, each component at its code-block style in
    `styles`, one per component decoded, in `comps` order): a lane
    for every code-block of the geometry, grouped by block (w, h), in the
    order of the tile's code-blocks within each group, and each band's
    stepsize (1.0 on the reversible path). The transform config comes
    from `cod` (with the custom MCT `custom_mct`, (matrix, offsets), where
    it signals mct 2): the tile's COD, or, with `comps`, the COD or COC
    that the components `comps` share, whose plan then decodes them alone
    and stops after their inverse DWT. `pm_zero` lists the components
    whose MQ lanes reconstruct at plane 0.

    `max_res` keeps only the bands of resolutions 0..max_res (a reduced
    decode). `window_slots`, the job slots of a windowed
    `tile.decode_tile`, keeps only their code-blocks and makes each band
    the bounding box of its kept blocks (a window plan; an empty box at
    the band's origin where none is kept). An "ht" plan with a band
    whose Mb + 3 exceeds the CUDA HT decoder's 32 bits becomes a "t1"
    plan. Raises NotImplementedError for an "mq" plan with a band whose
    Mb exceeds 30 (the MQ decoder's sign rides in bit 31)."""
    if coder not in ("ht", "mq", "t1"):
        raise ValueError(f"unknown block coder {coder!r}")
    if max_res is not None and max_res >= cod.numresolutions - 1:
        max_res = None
    top = cod.numresolutions - 1 if max_res is None else max_res
    cfg = pipeline.config_for_tile(siz, cod, tile, custom_mct, comps)
    ours = range(len(plans)) if comps is None else comps
    kmax = max(plans[c].bands[k].kmax for c in ours for k in plans[c].bands)
    if coder == "ht" and kmax + 3 > 32:
        coder, styles = "t1", styles or (0x40,) * len(ours)
    if coder == "mq" and kmax > mq_dec.MAX_PLANES:
        raise NotImplementedError(
            f"band Mb {kmax}: the MQ decoder needs Mb <= {mq_dec.MAX_PLANES}")
    keys = [k for k in pipeline._band_keys(cfg.numresolutions)
            if k[0] <= top]
    keep = None
    if window_slots is not None:
        keep = {_slot(plans, c, key, cb) for (c, key, cb) in window_slots}
    groups: Dict[Tuple[int, int], List[DecBlock]] = {}
    kept: Dict[Tuple[int, Tuple[int, int]], List[DecBlock]] = {}
    for c in ours:
        p = plans[c]
        for res in p.layout.resolutions:
            if res.r > top:
                continue
            for band in res.bands:
                for prc in band.precincts:
                    for cb in prc.cblks:
                        blk = DecBlock(comp=c, key=(res.r, band.orient),
                                       y0=cb.rect.y0 - band.rect.y0,
                                       x0=cb.rect.x0 - band.rect.x0,
                                       h=cb.rect.h, w=cb.rect.w)
                        if keep is not None:
                            if blk.slot not in keep:
                                continue
                            kept.setdefault((c, blk.key), []).append(blk)
                        groups.setdefault((blk.w, blk.h), []).append(blk)
    band_shapes = []
    stepsizes = []
    boxes = []
    for c in ours:
        p = plans[c]
        rects = {(res.r, band.orient): band.rect
                 for res in p.layout.resolutions for band in res.bands}
        for k in keys:
            if keep is None:
                band_shapes.append((c, k[0], k[1], rects[k].h, rects[k].w))
            else:
                blks = kept.get((c, k), [])
                y0 = min((b.y0 for b in blks), default=0)
                x0 = min((b.x0 for b in blks), default=0)
                band_shapes.append((
                    c, k[0], k[1],
                    max((b.y0 + b.h for b in blks), default=0) - y0,
                    max((b.x0 + b.w for b in blks), default=0) - x0))
                boxes.append((y0, x0))
            stepsizes.append(1.0 if cfg.reversible
                             else float(p.bands[k].stepsize))
    return FusedDecPlan(
        cfg=cfg,
        groups=tuple((w, h, tuple(groups[(w, h)]))
                     for (w, h) in sorted(groups)),
        band_shapes=tuple(band_shapes), coder=coder,
        stepsizes=tuple(stepsizes), max_res=max_res,
        boxes=None if keep is None else tuple(boxes),
        comps=None if comps is None else tuple(comps),
        pm_zero=tuple(c for c in ours if c in pm_zero),
        styles=tuple(styles) if coder == "t1" else ())


def _slot(plans, c: int, key, cb) -> tuple:
    """The `DecBlock.slot` of a parsed code-block (`t2.CblkDec`)."""
    brect = plans[c].bands[key].rect
    return (c, key, cb.geom.rect.y0 - brect.y0, cb.geom.rect.x0 - brect.x0)


def jobs_by_block(t1_jobs, t1_job_slots, plans,
                  max_res: Optional[int] = None,
                  comps: Optional[Tuple[int, ...]] = None
                  ) -> Dict[tuple, tuple]:
    """One frame's parsed jobs of a tile (`codestream/tile.decode_tile`)
    keyed by their code-block's `DecBlock.slot`; with `max_res`, only
    those of resolutions 0..max_res (a reduced plan's lanes); with
    `comps`, only those of these components (a group plan's lanes)."""
    return {_slot(plans, c, key, cb): job
            for job, (c, key, cb) in zip(t1_jobs, t1_job_slots, strict=True)
            if (max_res is None or key[0] <= max_res)
            and (comps is None or c in comps)}


def _scup(seg: bytes) -> int:
    return (seg[-1] << 4) + (seg[-2] & 0xF)


def _prepare_ht_group(jobs):
    """(data, off, lcup, scup, valid) of an HT lane group: the
    `ht_dec.pack_segments` arrays and the (F*B,) int32 validity."""
    segs: List[bytes] = []
    valid = np.zeros(len(jobs), np.int32)
    for j, job in enumerate(jobs):
        data = b"" if job is None else bytes(job[0])
        ok = len(data) >= 2 and 2 <= _scup(data) <= len(data)
        segs.append(data if ok else DUMMY_SEGMENT)
        valid[j] = ok
    scups = [_scup(s) if v else 2 for s, v in zip(segs, valid)]
    return ht_dec.pack_segments(segs, scups) + (valid,)


def _lane_halves(nbps, npas, rev: bool, zero=None) -> np.ndarray:
    """Per-lane mid-point reconstruction at the block's lowest decoded
    plane pm (`quant.trunc_plane`; 0 for the lanes that `zero` marks):
    reversible, the int32 addend 2^(pm - 1) (0 for a fully decoded
    block); irreversible, the float32 factor 0.5 * 2^pm, as the host's
    dequantizer (`quant.dequantize`)."""
    pms = [0 if zero is not None and z else trunc_plane(nb, n)
           for nb, n, z in zip(nbps, npas, zero or [False] * len(nbps))]
    if rev:
        return np.asarray([(1 << (pm - 1)) if pm > 0 else 0 for pm in pms],
                          np.int32)
    return np.asarray([0.5 * (1 << pm) for pm in pms], np.float32)


def _prepare_mq_group(jobs, rev: bool, zero=None):
    """(data, off, nbps, npas, ori, halves) of an MQ lane group: the
    `mq_dec.pack_lanes` arrays and the (F*B,) mid-point addends or
    factors (`_lane_halves`, plane 0 on the lanes `zero` marks). A block
    with no job or no pass gets an idle lane. Raises NotImplementedError
    for a block of several codeword segments."""
    segs: List[bytes] = []
    ori, nbps, npas = [], [], []
    for job in jobs:
        if job is not None and job[1] is not None and len(job[1]) > 1:
            raise NotImplementedError(
                "decode_batch on a torch device does not cover MQ blocks of "
                "several codeword segments yet")
        live = job is not None and job[5] > 0 and job[6] > 0
        segs.append(bytes(job[0]) if live else b"")
        ori.append(job[4] if live else 0)
        nbps.append(job[5] if live else 0)
        npas.append(job[6] if live else 0)
    return mq_dec.pack_lanes(segs, ori, nbps, npas) + (
        _lane_halves(nbps, npas, rev, zero),)


def _prepare_t1(plan: FusedDecPlan, frames: Sequence[Dict[tuple, tuple]]):
    """Host side of a T1 chunk: the host Tier-1 decoder decodes every
    job of every frame into the (F, total) band-plane buffer that
    `band_offsets` lays out (int32, or float32 dequantized on 9/7), in one
    threaded call (`t1/backend.decode_cblk_batch_bands`); blocks without a
    job stay zero. Returns [(buffer,)]."""
    offsets = band_offsets(plan)
    origin = dict(zip(offsets, plan.boxes or ()))
    keys = list(offsets)
    total = sum(bh * bw for (_, bh, bw) in offsets.values())
    flat = np.zeros((len(frames), total),
                    np.int32 if plan.cfg.reversible else np.float32)
    bands = [flat[f, off:off + bh * bw].reshape(bh, bw)
             for f in range(len(frames))
             for (off, bh, bw) in offsets.values()]
    bidx = {k: i for i, k in enumerate(keys)}
    style = dict(zip(plan_comps(plan), plan.styles))
    jobs, placements, styles, zero = [], [], [], []
    placed = [0] * len(frames)
    for f, frame in enumerate(frames):
        for (_, _, lanes) in plan.groups:
            for blk in lanes:
                job = frame.get(blk.slot)
                if job is None:
                    continue
                placed[f] += 1
                k = (blk.comp, blk.key)
                y0, x0 = origin.get(k, (0, 0))
                jobs.append(job)
                placements.append((f * len(keys) + bidx[k], blk.x0 - x0,
                                   blk.y0 - y0))
                styles.append(style[blk.comp])
                zero.append(blk.comp in plan.pm_zero)
    _check_placed(placed, frames)
    steps = None
    if not plan.cfg.reversible:
        steps = list(plan.stepsizes) * len(frames)
    t1_backend.decode_cblk_batch_bands(jobs, bands, placements, styles,
                                       stepsizes=steps, pm_zero=zero)
    return [(flat,)]


def prepare_chunk(plan: FusedDecPlan, frames: Sequence[Dict[tuple, tuple]]):
    """Host side of a chunk: `frames` holds each frame's jobs for the
    plan's tile, as `jobs_by_block` keys them. Returns per group the
    numpy arrays of `_prepare_ht_group` or `_prepare_mq_group`, lanes
    frame-major, or for a T1 plan the decoded band planes
    (`_prepare_t1`). Raises ValueError when a frame has a job for a
    code-block that the plan does not hold."""
    if plan.coder == "t1":
        return _prepare_t1(plan, frames)
    placed = [0] * len(frames)
    out = []
    for (_, _, lanes) in plan.groups:
        jobs = []
        for f, frame in enumerate(frames):
            for blk in lanes:
                job = frame.get(blk.slot)
                placed[f] += job is not None
                jobs.append(job)
        if plan.coder == "mq":
            zero = [blk.comp in plan.pm_zero for blk in lanes] * len(frames)
            out.append(_prepare_mq_group(jobs, plan.cfg.reversible,
                                         zero if any(zero) else None))
        else:
            out.append(_prepare_ht_group(jobs))
    _check_placed(placed, frames)
    return out


def _check_placed(placed, frames) -> None:
    """ValueError unless every job of each frame found its lane (`placed`
    counts them a frame)."""
    for f, frame in enumerate(frames):
        if placed[f] != len(frame):
            raise ValueError(f"frame {f} of the chunk has code-blocks "
                             f"outside the tile's decode plan")


def upload(arrays, device: torch.device):
    """Host arrays of `prepare_chunk` -> tensors on `device`."""
    return [tuple(torch.from_numpy(a).to(device, non_blocking=True)
                  for a in group) for group in arrays]


def band_offsets(plan: FusedDecPlan
                 ) -> Dict[Tuple[int, Tuple[int, int]], Tuple[int, int, int]]:
    """{(c, (r, orient)): (offset, h, w)} of each band (or a window
    plan's box) in the decoder's flat per-frame coefficient buffer."""
    out = {}
    off = 0
    for (c, r, o, bh, bw) in plan.band_shapes:
        out[(c, (r, o))] = (off, bh, bw)
        off += bh * bw
    return out


def window_boxes(plan: FusedDecPlan, flat: np.ndarray
                 ) -> List[Dict[Tuple[int, int], Tuple[int, int, np.ndarray]]]:
    """A window plan's fetched flat buffer of one frame -> per component
    {(r, orient): (y0, x0, box)}: each band's bounding box of dequantized
    coefficients and its origin in the band plane."""
    local = {c: i for i, c in enumerate(plan_comps(plan))}
    out: List[Dict] = [{} for _ in plan.cfg.tc_rects]
    for ((c, key), (off, bh, bw)), (y0, x0) in zip(
            band_offsets(plan).items(), plan.boxes, strict=True):
        out[local[c]][key] = (y0, x0,
                              flat[off:off + bh * bw].reshape(bh, bw))
    return out


class _FusedDecoder(nn.Module):
    """What the two fused decoders share: the plan's static band
    assembly indices (buffers) and the forward pass. A subclass gives
    `decode(groups)`, per shape group the group decoder's output, and
    `assemble(decoded, lasts, nframes)`, which turns them into signed
    coefficients and calls `_scatter`; `lasts` holds the last array of
    each group (validity for HT, mid-point addends for MQ)."""

    def __init__(self, plan: FusedDecPlan, device: torch.device, grid=None):
        """`grid(w, h)` is the (rows, columns) of one lane's coefficient
        grid as `assemble` hands it to `_scatter`; None for a decoder that
        gets its band planes whole (no scatter indices)."""
        super().__init__()
        self.plan = plan
        self.device = device
        # (c, key) -> (offset, h, w) in the flat buffer
        self._bands = band_offsets(plan)
        self._total = sum(bh * bw for (_, bh, bw) in self._bands.values())
        if grid is None:
            return
        origin = dict(zip(self._bands, plan.boxes or ()))
        steps = {(c, (r, o)): st for (c, r, o, _, _), st in zip(
            plan.band_shapes, plan.stepsizes, strict=True)}
        for gi, (w, h, lanes) in enumerate(plan.groups):
            self.register_buffer(f"step{gi}", torch.tensor(
                [steps[(b.comp, b.key)] for b in lanes], dtype=torch.float32,
                device=device))
            gh, gw = grid(w, h)
            yy, xx = np.mgrid[0:h, 0:w]
            src, dst = [], []
            for li, b in enumerate(lanes):
                boff, _, bw = self._bands[(b.comp, b.key)]
                by0, bx0 = origin.get((b.comp, b.key), (0, 0))
                src.append(li * gh * gw + yy * gw + xx)
                dst.append(boff + (b.y0 - by0 + yy) * bw + b.x0 - bx0 + xx)
            self.register_buffer(f"src{gi}", torch.as_tensor(
                np.concatenate([s.ravel() for s in src]), device=device))
            self.register_buffer(f"dst{gi}", torch.as_tensor(
                np.concatenate([d.ravel() for d in dst]), device=device))

    def _steps(self, gi: int, nframes: int) -> torch.Tensor:
        """(F*B,) float32 stepsizes of group gi's lanes, frame-major."""
        return getattr(self, f"step{gi}").repeat(nframes)

    def _scatter(self, coeffs, nframes: int) -> torch.Tensor:
        """Per group (F*B, rows, columns) coefficients (int32, or float32
        on the irreversible path) scattered into the band planes (or a
        window plan's boxes), zero where no block is coded: the (F,
        total) flat buffer that `band_offsets` lays out."""
        dtype = (torch.int32 if self.plan.cfg.reversible
                 else torch.float32)
        flat = torch.zeros((nframes, self._total), dtype=dtype,
                           device=self.device)
        for gi, coeff in enumerate(coeffs):
            vals = coeff.reshape(nframes, -1).index_select(
                1, getattr(self, f"src{gi}"))
            flat.index_copy_(1, getattr(self, f"dst{gi}"), vals)
        return flat

    def split_bands(self, flat: torch.Tensor
                    ) -> List[Dict[Tuple[int, int], torch.Tensor]]:
        """The flat buffer as one {(r, orient): (F, bh, bw)} dict of band
        views per component."""
        local = {c: i for i, c in enumerate(plan_comps(self.plan))}
        out: List[Dict[Tuple[int, int], torch.Tensor]] = [
            {} for _ in self.plan.cfg.tc_rects]
        for (c, key), (off, bh, bw) in self._bands.items():
            out[local[c]][key] = flat[:, off:off + bh * bw].reshape(
                flat.shape[0], bh, bw)
        return out

    def forward(self, nframes: int, *groups) -> Tuple[torch.Tensor, ...]:
        """Per shape group the tensors of `upload` for F = nframes frames
        -> one (F, h_c, w_c) int32 sample tensor per component, at the
        plan's `max_res` (for a group plan, one inverse-transformed plane
        per component of the group: int32 on 5/3, float32 on 9/7); for a
        window plan, the (F, total) flat buffer of its dequantized boxes
        (`window_boxes` splits it)."""
        decoded = self.decode(groups)
        flat = self.assemble(decoded, [g[-1] for g in groups], nframes)
        if self.plan.boxes is not None:
            return (flat,)
        return pipeline._inv_transform(self.plan.cfg, self.split_bands(flat),
                                       self.plan.max_res)


class FusedHTDecoder(_FusedDecoder):
    """The fused HT decode for one plan. Buffers: the decode LUTs
    (`ht_tables.device_dec_tables`) and the band assembly indices. A
    group's tensors are (data, off, lcup, scup, valid)."""

    def __init__(self, plan: FusedDecPlan, tables: Dict[str, torch.Tensor]):
        super().__init__(plan, tables["dec0"].device, lambda w, h: (
            2 * ht_dec.grid_dims(w, h)[1], 4 * ht_dec.grid_dims(w, h)[0]))
        self.register_buffer("dec0", tables["dec0"])
        self.register_buffer("dec1", tables["dec1"])

    def tables(self) -> Dict[str, torch.Tensor]:
        return {"dec0": self.dec0, "dec1": self.dec1}

    def decode(self, groups):
        """The group decoder per shape group: [(mags, signs)], each
        (F*B, 2*ny, 4*nx) int32."""
        return [ht_dec.decode_segments(*g[:4], w, h, self.tables())
                for (w, h, _), g in zip(self.plan.groups, groups)]

    def assemble(self, grids, valids, nframes: int) -> torch.Tensor:
        """Signed, validity-masked coefficients scattered into the band
        planes (`_scatter`). On the
        irreversible path nonzero magnitudes take the mid-point 0.5 and
        the band's stepsize (`quant.reconstruct`), as the reference's
        fused HT decode does."""
        if self.plan.cfg.reversible:
            return self._scatter(
                [torch.where(signs != 0, -mags, mags) * valid[:, None, None]
                 for (mags, signs), valid in zip(grids, valids)], nframes)
        return self._scatter(
            [torch.where(valid[:, None, None] != 0, reconstruct(
                mags, signs != 0, 0.5,
                self._steps(gi, nframes)[:, None, None]), 0.0)
             for gi, ((mags, signs), valid) in enumerate(zip(grids, valids))],
            nframes)


class FusedMQDecoder(_FusedDecoder):
    """The fused Part-1 MQ decode for one plan. A group's tensors are
    (data, off, nbps, npas, ori, halves): the `mq_dec.pack_lanes` arrays
    and the per-lane mid-point addends."""

    def __init__(self, plan: FusedDecPlan, device: torch.device):
        super().__init__(plan, device, lambda w, h: (h, w))

    def decode(self, groups):
        """The MQ decoder per shape group: [(h*w, F*B) int32 samples,
        sign << 31 | magnitude]."""
        return [mq_dec.decode_group(*g[:5], w, h)
                for (w, h, _), g in zip(self.plan.groups, groups)]

    def assemble(self, packed, halves, nframes: int) -> torch.Tensor:
        """Signed coefficients scattered into the band planes
        (`_scatter`): reversible,
        nonzero magnitudes plus their lane's mid-point addend;
        irreversible, (magnitude + the lane's mid-point factor) times the
        band's stepsize in float32 (`quant.reconstruct`)."""
        coeffs = []
        for gi, ((w, h, _), p, half) in enumerate(zip(self.plan.groups,
                                                      packed, halves)):
            mag = p & 0x7FFFFFFF
            if self.plan.cfg.reversible:
                mag = torch.where(mag != 0, mag + half, mag)
                v = torch.where(p < 0, -mag, mag)
            else:
                v = reconstruct(mag, p < 0, half, self._steps(gi, nframes))
            coeffs.append(v.T.reshape(-1, h, w))
        return self._scatter(coeffs, nframes)


class FusedT1Decoder(_FusedDecoder):
    """The device half of the T1 decode for one plan: the band planes
    that the host Tier-1 decoder filled (`_prepare_t1`), uploaded as one
    (F, total) tensor, go straight to the inverse transforms (or, for a
    window plan, back as the boxes)."""

    def decode(self, groups):
        return groups

    def assemble(self, groups, lasts, nframes: int) -> torch.Tensor:
        ((flat,),) = groups
        return flat


def _new_decoder(plan: FusedDecPlan, device: torch.device) -> _FusedDecoder:
    if plan.coder == "mq":
        return FusedMQDecoder(plan, device)
    if plan.coder == "t1":
        return FusedT1Decoder(plan, device)
    return FusedHTDecoder(plan, ht_tables.device_dec_tables(device))


_tile_decoders = functools.lru_cache(maxsize=64)(_new_decoder)
_window_decoders = functools.lru_cache(maxsize=16)(_new_decoder)


def decoder_for(plan: FusedDecPlan, device: torch.device) -> _FusedDecoder:
    """The fused decoder of a plan (`FusedHTDecoder` or `FusedMQDecoder`,
    by its coder) on a device, built once and kept for later batches of
    the same geometry. Window plans differ from request to request, so
    they are kept in a cache of their own and never evict the whole-tile
    decoders."""
    if plan.boxes is not None:
        return _window_decoders(plan, device)
    return _tile_decoders(plan, device)


def decode_tiles_submit(decoder: _FusedDecoder,
                        frames: Sequence[Dict[tuple, tuple]]):
    """Host side, upload and decode of a chunk of same-geometry tiles
    (each frame's jobs, as `jobs_by_block` keys them). Returns a handle
    for `decode_tiles_collect`; the samples stay on the device until
    then."""
    arrays = prepare_chunk(decoder.plan, frames)
    return decoder(len(frames), *upload(arrays, decoder.device))


def decode_tiles_collect(handle) -> List[List[np.ndarray]]:
    """Fetch a submitted chunk; per frame, one int32 sample array per
    component (tile-component layout)."""
    comps = [a.cpu().numpy() for a in handle]
    return [[a[f] for a in comps] for f in range(comps[0].shape[0])]
