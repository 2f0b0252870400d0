"""Fused HT tile decode on the device: stream words in, samples out.

Port of the HT half of `grokimagecompression_tpu/models/fused_decode.py`
(`decode_tiles_device_submit` / `_collect` and the program of
`_jitted_fused_dec_batch`). After the host has parsed the packets (T2)
and unstuffed each block's cleanup segment into dense stream words
(`native/ht_prepass.py`), one `FusedHTDecoder` per tile geometry runs,
for a chunk of same-geometry tiles: the CUDA group decoder
(`ops/ht_dec.py`) per block shape -> per-lane validity mask -> band-plane
assembly -> inverse DWT, inverse MCT and DC unshift
(`pipeline._inv_transform`). Only the sample planes come back.

The plan gives every code-block of the tile's geometry a lane, whether a
frame includes it or not, and each frame's jobs go to their lanes by
code-block position. Lanes are frame-major: frame f's blocks of a group
sit at lanes f*B .. f*B+B-1. A block that the frame does not include, or
whose segment is structurally invalid, decodes a dummy two-byte segment
in its lane and is masked to zero (`valid`), so one plan serves any
content.

Band assembly is one `index_copy_` per shape group into a flat per-frame
buffer holding every band of every component, with plan-static
indices, in place of the reference's chain of per-block
`dynamic_update_slice` calls.

Scope: the HT cleanup pass, reversible 5/3; the CUDA decoder needs every
band's Mb + 3 <= 32 (`ht_dec_pallas.supports`). Not ported: the MQ
groups, 9/7 dequantization and the single-tile `decode_tile_device`.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from ..core.geometry import Rect
from ..core.params import Transform
from ..native import ht_prepass
from ..ops import ht_dec, ht_tables
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
    """Static per-tile-geometry HT decode plan (hashable)."""
    cfg: pipeline.TileTransformConfig
    # (w, h, lanes) per shape group, sorted by (w, h)
    groups: Tuple[Tuple[int, int, Tuple[DecBlock, ...]], ...]
    band_shapes: Tuple[Tuple[int, int, int, int, int], ...]  # (c, r, o, h, w)


def build_plan(plans, siz, cod, tile: Rect) -> FusedDecPlan:
    """The decode plan of one tile from its components' plans
    (`codestream/tile.build_comp_plan`): a lane for every code-block of
    the geometry, grouped by block (w, h), in the order of the tile's
    code-blocks within each group. Raises NotImplementedError for the
    9/7 transform and when a band's Mb + 3 exceeds 32 bits."""
    if cod.transform != Transform.DWT_53:
        raise NotImplementedError(
            "the irreversible (9/7) fused decode is not ported")
    cfg = pipeline.config_for_tile(siz, cod, tile)
    kmax = max(p.bands[k].kmax for p in plans for k in p.bands)
    if kmax + 3 > 32:
        raise NotImplementedError(
            f"band Mb {kmax}: the HT decoder needs Mb + 3 <= 32")
    keys = pipeline._band_keys(cfg.numresolutions)
    band_shapes = []
    for c, p in enumerate(plans):
        rects = {(res.r, band.orient): band.rect
                 for res in p.layout.resolutions for band in res.bands}
        for k in keys:
            band_shapes.append((c, k[0], k[1], rects[k].h, rects[k].w))
    groups: Dict[Tuple[int, int], List[DecBlock]] = {}
    for c, p in enumerate(plans):
        for res in p.layout.resolutions:
            for band in res.bands:
                for prc in band.precincts:
                    for cb in prc.cblks:
                        blk = DecBlock(comp=c, key=(res.r, band.orient),
                                       y0=cb.rect.y0 - band.rect.y0,
                                       x0=cb.rect.x0 - band.rect.x0,
                                       h=cb.rect.h, w=cb.rect.w)
                        groups.setdefault((blk.w, blk.h), []).append(blk)
    return FusedDecPlan(
        cfg=cfg,
        groups=tuple((w, h, tuple(groups[(w, h)]))
                     for (w, h) in sorted(groups)),
        band_shapes=tuple(band_shapes))


def jobs_by_block(t1_jobs, t1_job_slots, plans) -> Dict[tuple, tuple]:
    """One frame's parsed jobs of a tile (`codestream/tile.decode_tile`)
    keyed by their code-block's `DecBlock.slot`."""
    out = {}
    for job, (c, key, cb) in zip(t1_jobs, t1_job_slots, strict=True):
        brect = plans[c].bands[key].rect
        out[(c, key, cb.geom.rect.y0 - brect.y0,
             cb.geom.rect.x0 - brect.x0)] = job
    return out


def _scup(seg: bytes) -> int:
    return (seg[-1] << 4) + (seg[-2] & 0xF)


def prepare_chunk(plan: FusedDecPlan, frames: Sequence[Dict[tuple, tuple]]):
    """Host prepass of a chunk: `frames` holds each frame's jobs for the
    plan's tile, as `jobs_by_block` keys them. Returns per group (mel,
    vlc, ms, valid) numpy arrays: (W, F*B) int32 stream words and (F*B,)
    int32 validity. Raises ValueError when a frame has a job for a
    code-block that the plan does not hold."""
    placed = [0] * len(frames)
    out = []
    for (_, _, lanes) in plan.groups:
        segs: List[bytes] = []
        valid = np.zeros(len(frames) * len(lanes), np.int32)
        for f, jobs in enumerate(frames):
            for j, blk in enumerate(lanes):
                job = jobs.get(blk.slot)
                data = b"" if job is None else bytes(job[0])
                placed[f] += job is not None
                ok = len(data) >= 2 and 2 <= _scup(data) <= len(data)
                segs.append(data if ok else DUMMY_SEGMENT)
                valid[f * len(lanes) + j] = ok
        lcups = [len(s) for s in segs]
        scups = [_scup(s) if v else 2 for s, v in zip(segs, valid)]
        mel, vlc, ms = ht_prepass.prepass_group(segs, lcups, scups)
        out.append((mel.view(np.int32), vlc.view(np.int32),
                    ms.view(np.int32), valid))
    for f, jobs in enumerate(frames):
        if placed[f] != len(jobs):
            raise ValueError(f"frame {f} of the chunk has code-blocks "
                             f"outside the tile's decode plan")
    return out


def upload(arrays, device: torch.device):
    """Host arrays of `prepare_chunk` -> tensors on `device`."""
    return [tuple(torch.from_numpy(a).to(device, non_blocking=True)
                  for a in group) for group in arrays]


class FusedHTDecoder(nn.Module):
    """The fused HT decode for one plan. Buffers: the decode LUTs
    (`ht_tables.device_dec_tables`) and the plan's static band
    assembly indices. `forward(nframes, *groups)` takes per shape group
    the (mel, vlc, ms, valid) tensors of `upload` for F = nframes frames
    and returns one (F, h_c, w_c) int32 sample tensor per component."""

    def __init__(self, plan: FusedDecPlan, tables: Dict[str, torch.Tensor]):
        super().__init__()
        self.plan = plan
        dev = tables["dec0"].device
        self.register_buffer("dec0", tables["dec0"])
        self.register_buffer("dec1", tables["dec1"])
        self._bands = {}    # (c, key) -> (offset, h, w) in the flat buffer
        off = 0
        for (c, r, o, bh, bw) in plan.band_shapes:
            self._bands[(c, (r, o))] = (off, bh, bw)
            off += bh * bw
        self._total = off
        for gi, (w, h, lanes) in enumerate(plan.groups):
            nx, ny, _ = ht_dec.grid_dims(w, h)
            yy, xx = np.mgrid[0:h, 0:w]
            src, dst = [], []
            for li, b in enumerate(lanes):
                boff, _, bw = self._bands[(b.comp, b.key)]
                src.append(li * (2 * ny) * (4 * nx) + yy * (4 * nx) + xx)
                dst.append(boff + (b.y0 + yy) * bw + b.x0 + xx)
            self.register_buffer(f"src{gi}", torch.as_tensor(
                np.concatenate([s.ravel() for s in src]), device=dev))
            self.register_buffer(f"dst{gi}", torch.as_tensor(
                np.concatenate([d.ravel() for d in dst]), device=dev))

    def tables(self) -> Dict[str, torch.Tensor]:
        return {"dec0": self.dec0, "dec1": self.dec1}

    def decode(self, groups):
        """The group decoder per shape group: [(mags, signs)], each
        (F*B, 2*ny, 4*nx) int32."""
        return [ht_dec.decode_group(mel, vlc, ms, w, h, self.tables())
                for (w, h, _), (mel, vlc, ms, _) in zip(self.plan.groups,
                                                        groups)]

    def assemble(self, grids, valids, nframes: int
                 ) -> List[Dict[Tuple[int, int], torch.Tensor]]:
        """Signed, validity-masked coefficients scattered into the band
        planes: one {(r, orient): (F, bh, bw)} dict per component."""
        flat = torch.zeros((nframes, self._total), dtype=torch.int32,
                           device=self.dec0.device)
        for gi, ((mags, signs), valid) in enumerate(zip(grids, valids)):
            coeff = torch.where(signs != 0, -mags, mags) \
                * valid[:, None, None]
            vals = coeff.reshape(nframes, -1).index_select(
                1, getattr(self, f"src{gi}"))
            flat.index_copy_(1, getattr(self, f"dst{gi}"), vals)
        ncomps = len(self.plan.cfg.tc_rects)
        out: List[Dict[Tuple[int, int], torch.Tensor]] = [
            {} for _ in range(ncomps)]
        for (c, key), (off, bh, bw) in self._bands.items():
            out[c][key] = flat[:, off:off + bh * bw].reshape(nframes, bh, bw)
        return out

    def forward(self, nframes: int, *groups) -> Tuple[torch.Tensor, ...]:
        grids = self.decode(groups)
        bands = self.assemble(grids, [g[3] for g in groups], nframes)
        return pipeline._inv_transform(self.plan.cfg, bands)


@functools.lru_cache(maxsize=64)
def decoder_for(plan: FusedDecPlan, device: torch.device) -> FusedHTDecoder:
    """The `FusedHTDecoder` of a plan on a device, built once and kept
    for later batches of the same geometry."""
    return FusedHTDecoder(plan, ht_tables.device_dec_tables(device))


def decode_tiles_submit(decoder: FusedHTDecoder,
                        frames: Sequence[Dict[tuple, tuple]]):
    """Prepass, upload and decode a chunk of same-geometry tiles (each
    frame's jobs, as `jobs_by_block` keys them). Returns a handle for
    `decode_tiles_collect`; the samples stay on the device until then."""
    arrays = prepare_chunk(decoder.plan, frames)
    return decoder(len(frames), *upload(arrays, decoder.dec0.device))


def decode_tiles_collect(handle) -> List[List[np.ndarray]]:
    """Fetch a submitted chunk; per frame, one int32 sample array per
    component (tile-component layout)."""
    comps = [a.cpu().numpy() for a in handle]
    return [[a[f] for a in comps] for f in range(comps[0].shape[0])]
