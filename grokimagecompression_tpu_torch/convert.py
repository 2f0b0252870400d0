"""The codec's "parameters": HT tables and static plans, and the
reference's types carried over to the port's.

The codec has no weights. What the device programs are built from is the
CxtVLC / UVLC encode tables and the CxtVLC decode LUTs
(`ops/ht_tables._tables()` / `_dec_tables()`, numpy, equal to the
reference's `ht_jax._tables()` / `ht_dec_jax._dec_tables()`) and the
static per-tile plans (`FusedPlan`, `FusedDecPlan`). The entry points
read the port's own tables through `ht_tables.device_tables` /
`device_dec_tables`. This module is for the parity tests:
`tables_from_reference` and `dec_tables_from_reference` put the
reference's tables on a torch device, and the other functions carry the
reference package's plans, images and parameters over to the port's own
types, so the tests run both packages on the same inputs. It imports
nothing of the reference: it reads its objects' fields.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import torch

from .codestream.markers import PocEntry
from .core.geometry import Rect
from .core.image import Component, Image
from .core.params import MCT, EncoderParams, Progression, Transform
from .models import fused_decode, pipeline
from .models.fused_encode import BlockSpec, FusedPlan
from .ops import ht_tables
from .utils.device import DeviceLike, resolve_device


def tables_from_reference(tables, device: DeviceLike = "cuda") -> Dict[str, torch.Tensor]:
    """The reference's `ht_jax._tables()` (enc0, enc1 uint16 CxtVLC
    encode tables and the four UVLC tables) -> the port's tensors on
    `device` (`ht_tables.tables_on`)."""
    return ht_tables.tables_on(tables, resolve_device(device))


def dec_tables_from_reference(dec_tables, device: DeviceLike = "cuda"
                              ) -> Dict[str, torch.Tensor]:
    """The reference's `ht_dec_jax._dec_tables()` -> the port's
    {"dec0", "dec1"} tensors on `device` (`ht_tables.dec_tables_on`)."""
    return ht_tables.dec_tables_on(dec_tables, resolve_device(device))


def _rect(r) -> Rect:
    return Rect(r.x0, r.y0, r.x1, r.y1)


def _cfg_from_reference(c) -> pipeline.TileTransformConfig:
    return pipeline.TileTransformConfig(
        tc_rects=tuple(_rect(r) for r in c.tc_rects), precs=tuple(c.precs),
        signeds=tuple(c.signeds), numresolutions=c.numresolutions,
        reversible=c.reversible, mct=c.mct)


def plan_from_reference(ref_plan) -> FusedPlan:
    """A reference `models.fused_encode.FusedPlan` (HT or MQ, on 5/3 or
    9/7, MQ with or without R-D tables) -> the port's `FusedPlan`, band
    steps, Mb and `want_rd` included. A tile with an ROI shift has the
    plan of the same tile without it on both sides: the shift raises only
    the Kmax that T2 signals (`tile.build_comp_plan(roishift=)`), and the
    code-blocks code as without it."""
    if ref_plan.coder not in ("ht", "mq"):
        raise NotImplementedError(
            f"unknown block coder {ref_plan.coder!r}")
    groups = tuple(
        (gh, gw, tuple(BlockSpec(comp=b.comp, key=tuple(b.key), y0=b.y0,
                                 x0=b.x0, h=b.h, w=b.w, kmax=b.kmax,
                                 step=b.step)
                       for b in blocks))
        for (gh, gw, blocks) in ref_plan.groups)
    return FusedPlan(cfg=_cfg_from_reference(ref_plan.cfg), groups=groups,
                     nblocks=ref_plan.nblocks,
                     order=tuple(tuple(o) for o in ref_plan.order),
                     coder=ref_plan.coder, want_rd=ref_plan.want_rd)


def dec_plan_from_reference(ref_plan, comps=None
                            ) -> fused_decode.FusedDecPlan:
    """A reference `models.fused_decode.FusedDecPlan` (HT or MQ, 5/3 or
    9/7) -> the port's `FusedDecPlan`, its coder and band stepsizes
    included. The reference plans a lane for each code-block that its
    plan's frame includes, in the order of the tile's geometry; it equals
    the port's plan, which gives every code-block a lane, when that frame
    includes them all.

    With `comps`, the plan keeps those components only, as the port's
    plan of a component group does (`build_plan(comps=)`: their lanes
    and bands, a `raw` config without MCT): the reference plans no tile
    whose components differ in transform, resolutions or coder, so a
    group's plan is held to its plan of the same components coded
    alike."""
    if ref_plan.coder not in ("ht", "mq"):
        raise NotImplementedError(
            f"unknown block coder {ref_plan.coder!r}")
    keep = set(range(len(ref_plan.cfg.tc_rects)) if comps is None
               else comps)
    groups = tuple(
        (w, h, blocks) for (w, h, blocks) in (
            (w, h, tuple(fused_decode.DecBlock(
                comp=b.comp, key=tuple(b.key), y0=b.y0, x0=b.x0, h=b.h,
                w=b.w) for b in lanes if b.comp in keep))
            for (w, h, lanes) in ref_plan.groups) if blocks)
    bands = [(tuple(s), float(st)) for s, st in zip(ref_plan.band_shapes,
                                                    ref_plan.stepsizes)
             if s[0] in keep]
    cfg = _cfg_from_reference(ref_plan.cfg)
    if comps is not None:
        cfg = dataclasses.replace(
            cfg, tc_rects=tuple(cfg.tc_rects[c] for c in comps),
            precs=tuple(cfg.precs[c] for c in comps),
            signeds=tuple(cfg.signeds[c] for c in comps), mct=False,
            raw=True)
    return fused_decode.FusedDecPlan(
        cfg=cfg, groups=groups, band_shapes=tuple(s for s, _ in bands),
        coder=ref_plan.coder, stepsizes=tuple(st for _, st in bands),
        comps=None if comps is None else tuple(comps))


def image_from_reference(img) -> Image:
    """A reference `core.image.Image` -> the port's `Image` (same
    sample arrays)."""
    return Image(components=[
        Component(data=c.data, dx=c.dx, dy=c.dy, prec=c.prec,
                  signed=c.signed, alpha=c.alpha) for c in img.components],
        x0=img.x0, y0=img.y0, xsiz=img.xsiz, ysiz=img.ysiz)


def params_from_reference(params) -> EncoderParams:
    """A reference `EncoderParams` -> the port's, every field carried over
    (`rates`, `numlayers` and the other rate-control fields included; the
    enum fields become the port's enums of the same values, and the POC
    entries the port's `markers.PocEntry`)."""
    fields = {f.name: getattr(params, f.name)
              for f in dataclasses.fields(EncoderParams)}
    fields["transform"] = Transform(fields["transform"])
    fields["progression"] = Progression(fields["progression"])
    if fields["mct"] is not None:
        fields["mct"] = MCT(fields["mct"])
    fields["pocs"] = tuple(
        PocEntry(rs=e.rs, cs=e.cs, lye=e.lye, re=e.re, ce=e.ce,
                 prog=Progression(e.prog)) for e in fields["pocs"])
    return EncoderParams(**fields)
