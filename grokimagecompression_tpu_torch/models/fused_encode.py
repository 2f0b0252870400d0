"""Fused tile encode on the device: frames in, code-block segments out.

Port of `grokimagecompression_tpu/models/fused_encode.py`. For a stack
of tiles of one plan (one tile position of same-geometry frames, as
`encoder.encode_batch` stacks them, or the tiles of one image that share
a plan, as `encoder.encode` stacks them; "frame" below means one entry
of the stack) it runs DC shift -> MCT -> DWT (`ops/dwt.py`)
-> code-block gather on the device, then
- HT (`FusedHTEncoder`, 5/3 or 9/7): the 9/7 bands' deadzone
  quantization in float64 to signed coefficients
  (`ops/quant.signed_deadzone`), then the HT cleanup encoder
  (`ops/ht_enc.encode_segments`), which returns each shape group's
  finished segments packed lane after lane; the host only slices them
  (`assemble_collected_ht`). For HT rate control the transform and the
  gather run once a chunk (`transform`, `gather`) and the gathered
  blocks stay on the device while the step search probes them
  (`segment_totals`: the segment bytes at a candidate step, one launch
  a shape group, nothing packed);
- MQ (`FusedMQEncoder`, Part-1 default code-block style, 5/3 or 9/7):
  the 9/7 bands' deadzone quantization in float64 (the host encoder's
  rule, so the streams are the host's byte for byte) -> bit-plane count
  per block -> slot stream (`ops/mq_torch.build_slot_stream`) -> the MQ
  coder with its flush (`ops/mq_scan.mq_scan`), which returns the
  finished segments packed lane after lane. With `want_rd` (rate
  control) the slot build also sums each pass's distortion decrease and
  the coder records its byte-outs at every pass end, from which the host
  builds each block's R-D pass table (`assemble_collected_mq`).
The host then runs T2 (and the rate allocation) on the segments.

Block order in the outputs: group-major, then frame-major within a
group, then block order within the (group, frame), as in the reference;
`FusedPlan.order` maps it back to the t1-desc order of
`codestream/tile.py`.

Not ported: the reference's word-compaction caps, overflow flags, host
re-encode and size-hinted fetch, which segments written in place on the
device make unnecessary.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from ..codestream.tile import build_comp_plan
from ..core.geometry import Rect
from ..core.params import Transform
from ..ops import ht_enc, mq_scan, mq_torch, quant
from . import pipeline


@dataclasses.dataclass(frozen=True)
class BlockSpec:
    """Static description of one code-block inside a tile (hashable)."""
    comp: int
    key: Tuple[int, int]        # (resolution, orient) band key
    y0: int                     # offset inside the band plane
    x0: int
    h: int
    w: int
    kmax: int                   # band M_b (guard bits + expn - 1)
    step: float = 1.0           # band stepsize (irreversible quant)


@dataclasses.dataclass(frozen=True)
class FusedPlan:
    """Static per-tile-geometry encode plan."""
    cfg: pipeline.TileTransformConfig
    # (gh, gw, blocks) per shape group: quads for HT, samples for MQ
    groups: Tuple[Tuple[int, int, Tuple[BlockSpec, ...]], ...]
    nblocks: int
    # order[g][j] = global t1-desc index of group g's j-th block
    order: Tuple[Tuple[int, ...], ...]
    coder: str = "ht"           # "ht" or "mq"
    # emit per-pass R-D tables from the MQ encode (PCRD callers)
    want_rd: bool = False


def build_plan(siz, cod, qcd, tile: Rect, cod_comp=None, qcd_comp=None,
               coder: str = "ht", want_rd: bool = False
               ) -> Optional[FusedPlan]:
    """The plan for one tile and block coder ("ht" or "mq"), or None
    when out of scope (components with different transforms, an MCT
    other than none/RCT/ICT). `want_rd` (MQ
    only) makes the encode also return per-pass R-D tables for PCRD.

    The block order (comp -> resolution -> band -> precinct -> cblk)
    matches codestream/tile.py's t1 desc construction, so collected
    segments slot into T2 positionally. HT groups blocks by their shape
    in quads, MQ by their shape in samples, with each MQ group's blocks
    in descending Kmax order as in the reference (stable; `order`
    carries the mapping)."""
    ncomps = len(siz.comps)
    cods = [cod_comp[c] if cod_comp and cod_comp[c] else cod
            for c in range(ncomps)]
    qcds = [qcd_comp[c] if qcd_comp and qcd_comp[c] else qcd
            for c in range(ncomps)]
    if any(cc.transform != cods[0].transform for cc in cods):
        return None
    reversible = cods[0].transform == Transform.DWT_53
    if cod.mct not in (0, 1):
        return None
    groups: Dict[Tuple[int, int], List[Tuple[int, BlockSpec]]] = {}
    gi = 0
    for c in range(ncomps):
        plan = build_comp_plan(siz, cods[c], qcds[c], tile, c)
        for res in plan.layout.resolutions:
            for band in res.bands:
                bp = plan.bands[(res.r, band.orient)]
                for prc in band.precincts:
                    for cb in prc.cblks:
                        spec = BlockSpec(
                            comp=c, key=(res.r, band.orient),
                            y0=cb.rect.y0 - band.rect.y0,
                            x0=cb.rect.x0 - band.rect.x0,
                            h=cb.rect.h, w=cb.rect.w, kmax=bp.kmax,
                            step=1.0 if reversible else float(bp.stepsize))
                        gk = (((spec.h + 1) // 2, (spec.w + 1) // 2)
                              if coder == "ht" else (spec.h, spec.w))
                        groups.setdefault(gk, []).append((gi, spec))
                        gi += 1
    keys = sorted(groups)
    if coder == "mq":
        groups = {k: sorted(v, key=lambda e: -e[1].kmax)
                  for k, v in groups.items()}
    return FusedPlan(
        cfg=pipeline.config_for_tile(siz, cod, tile),
        groups=tuple((gh, gw, tuple(s for (_, s) in groups[(gh, gw)]))
                     for (gh, gw) in keys),
        nblocks=gi,
        order=tuple(tuple(i for (i, _) in groups[k]) for k in keys),
        coder=coder, want_rd=bool(want_rd and coder == "mq"))


# Device bytes of the MQ encode, read off the code (`FusedMQEncoder.forward`
# and what it calls), per unit named:
# - per tile sample: the transform's band planes, float32 or int32, held
#   through every group (`group_inputs`);
# - per sample of a group: its gathered coefficients (float32 or int32,
#   4), magnitudes (int64, 8) and signs (bool, 1), held through the
#   group's build and scan;
# - per slot and lane: the slot stream (int8), held through the scan;
# - per padded sample, one plane's slot build at its peak: the locals of
#   `mq_torch._plane_slots`, all alive until it returns (about 30 planes
#   of bool, int32 and int64: 106 B), the int64 context arithmetic of
#   `_zc_ctx` or `_sc_ctx` (40 B at a time) and `build_slot_stream`'s
#   padded inputs (12 B); with R-D tables `_plane_dists`' float64 terms
#   (56 B);
# - per slot of one plane and lane: the plane's slots as int32 and its
#   int8 transposed copy (5 B);
# - per lane, the scan: the segment buffer at the wrapper's bound,
#   15 E / 7 + 3 bytes with E the lane's emitting slots (taken at their
#   most, 2 a sample and 3 a stripe column a plane), its int64 offset,
#   and with R-D tables the pass-end byte-outs (int32) and distortions
#   (float64) of 3 passes a plane;
# - per chunk, not per frame: the counting of E (`mq_scan.lane_emits`),
#   at most `mq_scan.EMIT_BLOCK_BYTES` of temporaries.
# Left out: the transform's own temporaries, which are freed before the
# first group's slot build, and the packed segments and `pack_segments`'
# index arrays, which scale with the bytes the coder writes, not with the
# plan.
PLANE_ANALYSIS_BYTES = 106 + 40 + 12
PLANE_DIST_BYTES = 56
GATHER_BYTES = 4 + 8 + 1
# the share of the free device memory an encode chunk may plan to use: the
# rest is left for the caching allocator's fragmentation, the model's
# error and other work on the card
MEMORY_SHARE = 0.5


def mq_frame_bytes(plan: "FusedPlan") -> int:
    """Peak device bytes one frame of an MQ plan takes in
    `FusedMQEncoder.forward` (the terms above): the band planes, plus for
    the costliest shape group its gathered blocks and slot stream and the
    larger of one plane's slot build and the scan. Planes per group: its
    largest Kmax, the most the stream can hold."""
    if plan.coder != "mq":
        raise ValueError("mq_frame_bytes needs an MQ plan")
    bands = 4 * sum(r.w * r.h for r in plan.cfg.tc_rects)
    peak = 0
    for (h, w, blocks) in plan.groups:
        lanes = len(blocks)
        npl = max(b.kmax for b in blocks)
        hp = -(-h // 4) * 4
        tp = mq_torch.slots_per_plane(h, w)
        emits = npl * (2 * h * w + 3 * (hp // 4) * w)
        held = lanes * (GATHER_BYTES * h * w + npl * tp)
        build = lanes * (hp * w * (PLANE_ANALYSIS_BYTES + (
            PLANE_DIST_BYTES if plan.want_rd else 0)) + 5 * tp)
        scan = lanes * (15 * emits // 7 + 3 + 8 + (
            3 * npl * (4 + 8) if plan.want_rd else 0))
        peak = max(peak, held + max(build, scan))
    return bands + peak


# Device bytes of the HT encode (`FusedHTEncoder.encode_blocks` and
# `segment_totals` and what they call), per unit named:
# - per tile sample: the uploaded sample (`_upload_dtype`), held through
#   the encode;
# - per tile sample, the transform at its peak: with the ICT
#   (`mct_torch.ict_fwd`) each component's shifted int32 samples (4),
#   their float64 copy (8), the float32 result (4) and, one component at
#   a time, the fused multiply-add's float64 product, widened accumulator
#   and sum (24 B a pixel, 8 a sample): 24 B; without the ICT the int32
#   and shifted samples, then the DWT's input, output and scratch: at
#   most 12 B;
# - per tile sample: the transform's band planes, float32 or int32,
#   alive while `gather` copies the blocks out (4 B);
# - per padded sample of every group: the gathered blocks (4), held
#   through the encode, and under rate control through the chunk's whole
#   step search, when a probe also copies out the frames still searching
#   (4);
# - per padded sample of a group: 9/7's quantization at its peak
#   (`quant.signed_deadzone`: the float64 copy beside the float32 absolute
#   values, then the int32 magnitudes, their negation, the sign mask and
#   the result: 13 B), then the int32 coefficients, held through the
#   launch and the pack (4);
# - per lane: the kernel's output region (`ht_enc.lane_bounds` at the
#   group's largest Mb; under rate control at the most any step can
#   give, m = 32), its offset (int64), length and Mb (int32), the packed
#   segment (at most its region) and its end (int64);
# - per lane, after its group: the packed segment, held until `torch.cat`
#   copies every group's segments once more at the end;
# - per block of the plan, once a chunk: the encoder's float64 stepsizes
#   (`FusedHTEncoder.lanes`, 8 B).
# Left out: under rate control the stepsizes of each step searched, 8 B a
# block a step (at most ~100 steps a frame: 0.8 % of a config-2 frame's
# model).
HT_STEP_BYTES = 8
HT_TRANSFORM_BYTES = {True: 24, False: 12}       # with the ICT, without
HT_QUANT_BYTES = 13
HT_LANE_BYTES = 8 + 4 + 4 + 8


def ht_frame_bytes(plan: "FusedPlan", rate_control: bool = False) -> int:
    """Peak device bytes one frame of an HT plan takes in its encode (the
    terms above): the uploaded samples, and the largest of the
    transform's peak, the band planes beside the gathered blocks, the
    gathered blocks with the costliest group's quantization, launch and
    pack and the segments packed before it, and the gathered blocks with
    every group's segments twice at the concatenation. With
    `rate_control` the blocks stay resident through the search, a probe
    copies the searching frames' blocks, and a candidate step's Mb may
    be up to 30."""
    if plan.coder != "ht":
        raise ValueError("ht_frame_bytes needs an HT plan")
    cfg = plan.cfg
    samples = [r.w * r.h for r in cfg.tc_rects]
    ict = bool(cfg.mct) and len(samples) >= 3 and not cfg.reversible
    upload = sum(n * _upload_dtype(p, s).itemsize
                 for n, p, s in zip(samples, cfg.precs, cfg.signeds))
    transform = HT_TRANSFORM_BYTES[ict] * sum(samples)
    bands = 4 * sum(samples)
    held = 4 * sum(len(blocks) * 4 * qh * qw
                   for (qh, qw, blocks) in plan.groups)
    quant_b = 0 if cfg.reversible else HT_QUANT_BYTES
    peak, segs = 0, 0
    for (qh, qw, blocks) in plan.groups:
        mb = 30 if rate_control else max(b.kmax for b in blocks)
        bound = int(ht_enc.lane_bounds(np.asarray([mb]), qh, qw)[0])
        padded = 4 * qh * qw
        select = 4 * padded if rate_control else 0
        launch = 4 * padded + 2 * bound + HT_LANE_BYTES
        peak = max(peak, segs + len(blocks) * (
            select + max(quant_b * padded, launch)))
        segs += len(blocks) * bound
    return upload + max(transform, bands + held,
                        held + max(peak, 2 * segs))


def frame_bytes(plan: "FusedPlan", rate_control: bool = False) -> int:
    """`mq_frame_bytes` or `ht_frame_bytes` of the plan's coder."""
    if plan.coder == "mq":
        return mq_frame_bytes(plan)
    return ht_frame_bytes(plan, rate_control)


def chunk_cap(plan: "FusedPlan", free_bytes: int,
              rate_control: bool = False) -> int:
    """The most frames of `plan` one chunk may hold so that its encode
    (`frame_bytes` a frame, and once a chunk the MQ scan's counting
    temporaries or the HT encoder's stepsizes) fits in MEMORY_SHARE of
    `free_bytes`, and at least 1."""
    fixed = mq_scan.EMIT_BLOCK_BYTES if plan.coder == "mq" \
        else HT_STEP_BYTES * plan.nblocks
    room = int(MEMORY_SHARE * free_bytes) - fixed
    return max(1, room // frame_bytes(plan, rate_control))


def upload(a: np.ndarray, dev: torch.device) -> torch.Tensor:
    """A host array on `dev`; on a card without waiting for the device
    (`ht_enc.to_device`)."""
    if dev.type == "cuda":
        return ht_enc.to_device(a, dev)
    return torch.from_numpy(np.ascontiguousarray(a))


class FusedHTEncoder(nn.Module):
    """The fused HT encode for one plan (5/3, or 9/7 with its bands'
    deadzone quantization in float64). Buffers: the tables of
    `ht_tables.device_tables`. `forward(*frames)` takes one integer
    (N, h_c, w_c) tensor per component, on the module's device, and
    returns (lens (B_total,) int32, data (sum(lens),) uint8): each block's
    HT cleanup segment, packed block after block, with B_total = N *
    plan.nblocks. On the card each shape group is one launch of the HT
    encoder kernel; on the CPU its plain version.

    HT rate control takes the steps apart: `transform` and `gather` once
    a chunk, `lanes` once a candidate base step (the band steps and Mb of
    the plan at that step, a plan of this one's geometry), then the probe
    `segment_totals` and the encode `encode_blocks` on the resident
    blocks, each frame at its own step."""

    def __init__(self, plan: FusedPlan, tables: Dict[str, torch.Tensor]):
        super().__init__()
        self.plan = plan
        self._table_keys = tuple(tables)
        for k, v in tables.items():
            self.register_buffer(k, v)
        self._own = self.lanes(plan)

    @property
    def device(self) -> torch.device:
        return self.enc0.device

    def tables(self) -> Dict[str, torch.Tensor]:
        return {k: getattr(self, k) for k in self._table_keys}

    def lanes(self, plan: FusedPlan):
        """Per shape group of `plan`, its blocks' stepsizes ((nb,) float64
        on the device) and Mb ((nb,) int32 on the host). `plan` has this
        encoder's geometry, at any base step."""
        if [(qh, qw, len(b)) for (qh, qw, b) in plan.groups] != \
                [(qh, qw, len(b)) for (qh, qw, b) in self.plan.groups]:
            raise ValueError("a plan of another geometry")
        return [(upload(np.asarray([b.step for b in blocks], np.float64),
                        self.device),
                 np.asarray([b.kmax for b in blocks], np.int32))
                for (_, _, blocks) in plan.groups]

    def transform(self, *frames) -> List[Dict]:
        """The frames' band planes (`pipeline._fwd_transform`)."""
        return pipeline._fwd_transform(self.plan.cfg, frames)

    def gather(self, bands_list) -> List[torch.Tensor]:
        """Per shape group, the frames' code-blocks (N, nb, 2qh, 2qw),
        frame-major, zero-padded to the group's shape: float32 9/7
        coefficients or int32 5/3 ones."""
        out = []
        for (qh, qw, blocks) in self.plan.groups:
            mats = []
            for b in blocks:
                band = bands_list[b.comp][b.key]
                blk = band[..., b.y0:b.y0 + b.h, b.x0:b.x0 + b.w]
                if b.h != 2 * qh or b.w != 2 * qw:
                    blk = nn.functional.pad(
                        blk, (0, 2 * qw - b.w, 0, 2 * qh - b.h))
                mats.append(blk)
            out.append(torch.stack(mats, dim=1))
        return out

    def _select(self, v: torch.Tensor, frames) -> torch.Tensor:
        """The gathered blocks `v` of the frames numbered `frames` (all
        of them for None)."""
        if frames is None or list(frames) == list(range(v.shape[0])):
            return v
        return v.index_select(0, upload(np.asarray(frames, np.int64),
                                        v.device))

    def _inputs(self, g: int, v: torch.Tensor, lanes):
        """(coeffs (F nb, 2qh, 2qw) int32, mbs (F nb,) int32 on the
        device, the same Mb on the host) of shape group g's blocks `v`,
        (F, nb, 2qh, 2qw), frame i coded with `lanes[i]` (`lanes`)."""
        if self.plan.cfg.reversible:
            coeffs = v
        else:
            steps = torch.stack([ln[g][0] for ln in lanes])
            coeffs = quant.signed_deadzone(v, steps[:, :, None, None])
        mbs = np.concatenate([ln[g][1] for ln in lanes])
        return (coeffs.reshape(-1, *v.shape[2:]).to(torch.int32)
                .contiguous(), upload(mbs, v.device), mbs)

    def group_inputs(self, *frames):
        """Yield (coeffs, mbs) per shape group: the gathered, padded
        (N * nb, 2qh, 2qw) int32 code-blocks of the frames, frame-major
        (9/7 quantized, with their signs), and their (N * nb,) int32 Mb."""
        lanes = [self._own] * frames[0].shape[0]
        for g, v in enumerate(self.gather(self.transform(*frames))):
            yield self._inputs(g, v, lanes)[:2]

    def encode_blocks(self, blocks, frames=None, lanes=None):
        """`forward`'s (lens, data) from gathered blocks (`gather`): the
        frames numbered `frames` (all for None), frame i coded with
        `lanes[i]` (this plan's for None)."""
        tables = self.tables()
        lens, data = [], []
        for g, v in enumerate(blocks):
            v = self._select(v, frames)
            coeffs, mbs, mbs_host = self._inputs(
                g, v, lanes or [self._own] * v.shape[0])
            d, n = ht_enc.encode_segments(coeffs, mbs, tables, mbs_host)
            data.append(d)
            lens.append(n)
        return torch.cat(lens), torch.cat(data)

    def segment_totals(self, blocks, frames, lanes) -> torch.Tensor:
        """The probe of HT rate control: for each frame numbered in
        `frames` of the resident gathered `blocks`, coded with `lanes[i]`,
        the sum of its code-blocks' segment bytes, (F,) int64 on the
        module's device. On the card one kernel launch a shape group and
        nothing packed; nothing waits for the device until the caller
        reads the totals."""
        tables = self.tables()
        total = None
        for g, v in enumerate(blocks):
            v = self._select(v, frames)
            coeffs, mbs, mbs_host = self._inputs(g, v, lanes)
            n = ht_enc.segment_lengths(coeffs, mbs, tables, mbs_host)
            n = n.view(v.shape[0], -1).sum(1, dtype=torch.int64)
            total = n if total is None else total + n
        return total

    def forward(self, *frames):
        return self.encode_blocks(self.gather(self.transform(*frames)))


class FusedMQEncoder(nn.Module):
    """The fused MQ encode (Part-1 default code-block style) for one
    plan. `forward(*frames)` takes one integer (N, h_c, w_c) tensor per
    component, on `device`, and returns (nbps (B_total,) int32, lens
    (B_total,) int32, data (sum(lens),) uint8): each block's magnitude
    bit-planes and its codeword segment, packed block after block, with
    B_total = N * plan.nblocks. A block with nbps = 0 codes no passes;
    its bytes in `data` are an empty coder's flush and are not used.
    With `plan.want_rd` it also returns, per shape group, the (3 * npl,
    B) int32 pass-end byte-outs and the (3 * npl, B) float64 pass
    distortions (4^-plane scaled), npl the group's largest nbps."""

    def __init__(self, plan: FusedPlan, device: torch.device):
        super().__init__()
        self.plan = plan
        self.device = torch.device(device)
        self._orients = [torch.tensor([b.key[1] for b in blocks],
                                      dtype=torch.int64, device=self.device)
                         for (_, _, blocks) in plan.groups]
        self._steps = [torch.tensor([b.step for b in blocks],
                                    dtype=torch.float64,
                                    device=self.device).view(-1, 1, 1)
                       for (_, _, blocks) in plan.groups]

    def group_inputs(self, *frames):
        """Yield (mag, neg, orient) per shape group: the gathered
        (N * nb, h, w) code-blocks of the frames, frame-major (9/7 bands
        quantized), and their band orientations."""
        nframes = frames[0].shape[0]
        bands_list = pipeline._fwd_transform(self.plan.cfg, frames)
        for (h, w, blocks), orients, steps in zip(
                self.plan.groups, self._orients, self._steps):
            v = torch.stack([bands_list[b.comp][b.key][..., b.y0:b.y0 + h,
                                                       b.x0:b.x0 + w]
                             for b in blocks], dim=1)
            if self.plan.cfg.reversible:
                mag = v.abs()
            else:
                mag = quant.deadzone(v, steps)
            yield (mag.reshape(-1, h, w), (v < 0).reshape(-1, h, w),
                   orients.repeat(nframes))

    def group_slots(self, mag, neg, orient):
        """(nbps, slot stream) of one group, and with `plan.want_rd` its
        (npl, 3, B) pass distortions: the stream holds the group's
        largest nbps planes (the planes above it code nothing)."""
        nbps = mq_torch.bit_planes(mag)
        out = mq_torch.build_slot_stream(mag, neg, orient, nbps,
                                         int(nbps.max()), self.plan.want_rd)
        return (nbps, *out) if self.plan.want_rd else (nbps, out)

    def forward(self, *frames):
        nbps_l, lens_l, data_l, rd = [], [], [], []
        for (h, w, _), gin in zip(self.plan.groups,
                                  self.group_inputs(*frames)):
            nbps, slots, *dists = self.group_slots(*gin)
            if self.plan.want_rd:
                data, lens, _, cumbo = mq_scan.mq_scan(
                    slots, mq_torch.pass_spans_padded(h, w))
                rd += [cumbo, dists[0].reshape(-1, cumbo.shape[1])]
            else:
                data, lens, _ = mq_scan.mq_scan(slots)
            nbps_l.append(nbps)
            lens_l.append(lens)
            data_l.append(data)
        return (torch.cat(nbps_l), torch.cat(lens_l), torch.cat(data_l),
                *rd)


def _upload_dtype(prec: int, signed: bool) -> torch.dtype:
    """Narrowest torch dtype holding the component's samples (8-bit
    content uploads 4x fewer bytes than int32)."""
    if prec <= 8:
        return torch.int8 if signed else torch.uint8
    if prec <= 15 or (prec == 16 and signed):
        return torch.int16
    return torch.int32


def upload_tile(comps_data: List[np.ndarray], encoder) -> List[torch.Tensor]:
    """One tile's components for a batch of frames (each (N, h, w) or (h,
    w)) on the encoder's device, each in its narrowest dtype."""
    dev = encoder.device
    cfg = encoder.plan.cfg
    args = []
    for c, a in enumerate(comps_data):
        a = a if a.ndim == 3 else a[None]
        dt = _upload_dtype(cfg.precs[c], cfg.signeds[c])
        args.append(torch.from_numpy(np.ascontiguousarray(a)).to(dt)
                    .to(dev, non_blocking=True))
    return args


def encode_tile_submit(comps_data: List[np.ndarray], encoder):
    """Upload the components of a stack of N tiles of the encoder's plan
    (each (N, h, w), or (h, w) for one) and run the fused encode (a
    `FusedHTEncoder` or `FusedMQEncoder`). The stack holds one tile
    position of N frames or N tiles of one image: a plan fixes every
    shape and band step, so its tiles are interchangeable. Returns a
    handle for encode_tile_collect; the outputs stay on the device until
    then."""
    args = upload_tile(comps_data, encoder)
    return encoder.plan, args[0].shape[0], encoder(*args)


def encode_tile_collect(handle) -> List[List]:
    """Copy a submitted result to the host; returns a segment list in
    t1-desc order for each stacked tile, in stack order (N x nblocks): HT
    segment bytes, or MQ (data, numbps, numpasses) tuples, under rate
    control with each tile's own R-D pass tables."""
    plan, nframes, outs = handle
    outs = [t.cpu().numpy() for t in outs]
    if plan.coder == "mq":
        return assemble_collected_mq(plan, nframes, *outs)
    return assemble_collected_ht(plan, nframes, *outs)


def assemble_collected_ht(plan: FusedPlan, nframes: int, lens_np,
                          data_np) -> List[List[bytes]]:
    """Per-frame segment lists from a fetched HT result: each block's
    finished segment sliced out of the packed bytes."""
    ends = np.cumsum(lens_np, dtype=np.int64).tolist()
    buf = data_np.tobytes()
    res = [[b""] * plan.nblocks for _ in range(nframes)]
    pos = 0
    for gidx, (_, _, blocks) in enumerate(plan.groups):
        for f in range(nframes):
            for j in range(len(blocks)):
                res[f][plan.order[gidx][j]] = \
                    buf[ends[pos] - int(lens_np[pos]):ends[pos]]
                pos += 1
    return res


def assemble_collected_mq(plan: FusedPlan, nframes: int, nbps_np, lens_np,
                          data_np, *rd) -> List[List[Tuple]]:
    """Per-frame (data, numbps, numpasses) lists from a fetched MQ result
    (a block with numbps bit-planes codes 3 * numbps - 2 passes), or with
    `plan.want_rd` (data, numbps, numpasses, passes) lists whose
    `passes` are the blocks' R-D pass tables, built from each group's
    fetched byte-outs and distortions `rd` (`mq_torch.batch_pass_tables`,
    as the reference's `assemble_collected_mq`)."""
    ends = np.cumsum(lens_np, dtype=np.int64)
    buf = data_np.tobytes()
    res = [[None] * plan.nblocks for _ in range(nframes)]
    lane = 0
    for gidx, (_, _, blocks) in enumerate(plan.groups):
        B = nframes * len(blocks)
        npl = 0
        if plan.want_rd:
            cumbo, dists = rd[2 * gidx], rd[2 * gidx + 1]
            npl = cumbo.shape[0] // 3       # 0: every block of it is zero
        if npl:
            rates_t, dcum_t = mq_torch.batch_pass_tables(
                lens_np[lane:lane + B].astype(np.int64),
                nbps_np[lane:lane + B], npl, cumbo, dists)
        for f in range(nframes):
            for j in range(len(blocks)):
                nb = int(nbps_np[lane])
                data = buf[ends[lane] - lens_np[lane]:ends[lane]] \
                    if nb else b""
                entry = (data, nb, 3 * nb - 2 if nb else 0)
                if plan.want_rd:
                    k = f * len(blocks) + j
                    entry += (mq_torch.passes_from_tables(
                        nb, npl, rates_t[:, k], dcum_t[:, k])
                        if nb else [],)
                res[f][plan.order[gidx][j]] = entry
                lane += 1
    return res
