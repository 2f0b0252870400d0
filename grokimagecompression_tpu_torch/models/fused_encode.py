"""Fused HT tile encode on the device: frames in, packed stream words out.

Port of the HT half of `grokimagecompression_tpu/models/fused_encode.py`.
For a batch of same-geometry frames it runs DC shift -> MCT -> 5/3 DWT ->
code-block gather -> HT op streams -> the MEL / VLC / MagSgn scans ->
exact word placement on the device, and returns the per-block metrics
and the packed words; the host splices the final segment bytes
(`ht_tables.assemble_segments_host`) and runs T2.

Block order in the metrics rows and the packed words: group-major, then
frame-major within a group, then block order within the (group, frame),
as in the reference; `FusedPlan.order` maps it back to the t1-desc order
of `codestream/tile.py`.

Not ported (yet): the MQ coder half, the irreversible (9/7) fused path,
and the reference's word-compaction caps / size-hinted fetch, which the
exact placement makes unnecessary.
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
from ..ops import ht_tables, ht_torch
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


@dataclasses.dataclass(frozen=True)
class FusedPlan:
    """Static per-tile-geometry HT encode plan."""
    cfg: pipeline.TileTransformConfig
    # (qh, qw, blocks) per shape group, qh/qw in quads
    groups: Tuple[Tuple[int, int, Tuple[BlockSpec, ...]], ...]
    nblocks: int
    # order[g][j] = global t1-desc index of group g's j-th block
    order: Tuple[Tuple[int, ...], ...]


def build_plan(siz, cod, qcd, tile: Rect, cod_comp=None,
               qcd_comp=None) -> Optional[FusedPlan]:
    """The reversible HT plan for one tile, or None when out of scope
    (the 9/7 transform on any component, an MCT other than
    none/RCT).

    The block order (comp -> resolution -> band -> precinct -> cblk)
    matches codestream/tile.py's t1 desc construction, so collected
    segments slot into T2 positionally."""
    ncomps = len(siz.comps)
    cods = [cod_comp[c] if cod_comp and cod_comp[c] else cod
            for c in range(ncomps)]
    qcds = [qcd_comp[c] if qcd_comp and qcd_comp[c] else qcd
            for c in range(ncomps)]
    if any(cc.transform != Transform.DWT_53 for cc in cods):
        return None
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
                            h=cb.rect.h, w=cb.rect.w, kmax=bp.kmax)
                        gk = ((spec.h + 1) // 2, (spec.w + 1) // 2)
                        groups.setdefault(gk, []).append((gi, spec))
                        gi += 1
    keys = sorted(groups)
    return FusedPlan(
        cfg=pipeline.config_for_tile(siz, cod, tile),
        groups=tuple((qh, qw, tuple(s for (_, s) in groups[(qh, qw)]))
                     for (qh, qw) in keys),
        nblocks=gi,
        order=tuple(tuple(i for (i, _) in groups[k]) for k in keys))


class FusedHTEncoder(nn.Module):
    """The fused HT encode for one plan. Buffers: the tables of
    `ht_tables.device_tables`. `forward(*frames)` takes one integer
    (N, h_c, w_c) tensor per component, on the module's device, and
    returns (metrics (B_total, 16) int32, packed words (W,) int32) with
    B_total = N * plan.nblocks."""

    def __init__(self, plan: FusedPlan, tables: Dict[str, torch.Tensor]):
        super().__init__()
        self.plan = plan
        self._table_keys = tuple(tables)
        for k, v in tables.items():
            self.register_buffer(k, v)
        self._kmaxs = [np.asarray([b.kmax for b in blocks], np.int64)
                       for (_, _, blocks) in plan.groups]

    def tables(self) -> Dict[str, torch.Tensor]:
        return {k: getattr(self, k) for k in self._table_keys}

    def group_inputs(self, *frames):
        """Yield (mag, neg, mbs, mbb) per shape group: the gathered,
        padded (N * nb, 2qh, 2qw) code-blocks of the frames, frame-major."""
        nframes = frames[0].shape[0]
        bands_list = pipeline._fwd_transform(self.plan.cfg, frames)
        for (qh, qw, blocks), kmaxs in zip(self.plan.groups, self._kmaxs):
            mats = []
            for b in blocks:
                band = bands_list[b.comp][b.key]
                blk = band[..., b.y0:b.y0 + b.h, b.x0:b.x0 + b.w]
                if b.h != 2 * qh or b.w != 2 * qw:
                    blk = nn.functional.pad(
                        blk, (0, 2 * qw - b.w, 0, 2 * qh - b.h))
                mats.append(blk)
            v = torch.stack(mats, dim=1).reshape(-1, 2 * qh, 2 * qw)
            mbs = torch.as_tensor(np.tile(kmaxs, nframes), device=v.device)
            yield v.abs().to(torch.int64), v < 0, mbs, int(kmaxs.max())

    def forward(self, *frames):
        tables = self.tables()
        metrics = []
        streams = []
        for mag, neg, mbs, mbb in self.group_inputs(*frames):
            mel, vlc, ms = ht_torch.encode_streams(mag, neg, mbs, tables,
                                                   mbb)
            metrics.append(ht_torch.group_metrics(mag.shape[0], mel, vlc,
                                                  ms))
            streams.append((mel, vlc, ms))
        return torch.cat(metrics), ht_torch.place_words(streams)


def _upload_dtype(prec: int, signed: bool) -> torch.dtype:
    """Narrowest torch dtype holding the component's samples (8-bit
    content uploads 4x fewer bytes than int32)."""
    if prec <= 8:
        return torch.int8 if signed else torch.uint8
    if prec <= 15 or (prec == 16 and signed):
        return torch.int16
    return torch.int32


def encode_tile_submit(comps_data: List[np.ndarray], encoder: FusedHTEncoder):
    """Upload one tile's components for a batch of frames (each (N, h, w)
    or (h, w)) and run the fused encode. Returns a handle for
    encode_tile_collect; the outputs stay on the device until then."""
    dev = encoder.enc0.device
    cfg = encoder.plan.cfg
    args = []
    for c, a in enumerate(comps_data):
        a = a if a.ndim == 3 else a[None]
        dt = _upload_dtype(cfg.precs[c], cfg.signeds[c])
        args.append(torch.from_numpy(np.ascontiguousarray(a)).to(dt)
                    .to(dev, non_blocking=True))
    metrics, words = encoder(*args)
    return encoder.plan, args[0].shape[0], metrics, words


def encode_tile_collect(handle) -> List[List[bytes]]:
    """Copy a submitted result to the host; returns per-frame segment
    lists in t1-desc order (frames x nblocks)."""
    plan, nframes, metrics, words = handle
    return assemble_collected_ht(plan, nframes, metrics.cpu().numpy(),
                                 words.cpu().numpy())


def assemble_collected_ht(plan: FusedPlan, nframes: int, metrics_np,
                          words_np) -> List[List[bytes]]:
    """Host splice of a fetched HT result into per-frame segment lists."""
    segs = ht_tables.assemble_segments_host(words_np, metrics_np)
    res = [[b""] * plan.nblocks for _ in range(nframes)]
    pos = 0
    for gidx, (_, _, blocks) in enumerate(plan.groups):
        for f in range(nframes):
            for j in range(len(blocks)):
                res[f][plan.order[gidx][j]] = segs[pos]
                pos += 1
    return res
