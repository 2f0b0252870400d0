"""Encode entry points on a torch device.

Port of `grokimagecompression_tpu/codestream/encoder.py` for the fused
slices: the HT block coder on 5/3 (lossless) or 9/7, on 9/7 with or
without one byte target (`rates=(r,)`: a search of the quantizer's base
step, `_encode_ht_rate_controlled`), and the Part-1 MQ coder with the
default code-block style on 5/3 or 9/7, with or without byte or PSNR
targets (`rates`, `quality_psnr`: PCRD rate control over quality
layers, per tile or image-wide with `rate_alloc="global"`) or an
explicit rate allocator (a profile's byte caps,
`profiles.encode_with_profile`; with the HT coder one pass a block, as
the reference hands its allocator HT blocks). Either coder takes a
Part-2 custom MCT
on 9/7 (the decoding matrix `custom_mct`; its coding matrix by LUP
inversion, `ops/linalg.py`, applied on the device before the DWT), and
the MQ coder an ROI upshift of one component (`roi_comp`, `roi_shift`:
the RGN marker and the Kmax T2 signals; the code-blocks code as
without it).

The MQ code-block styles other than the default (BYPASS, RESET,
TERMALL, VSC, PTERM, SEGMARK, alone or together) and HT refinement
passes (`ht_refinement`, Part 15 full mode: each code-block's cleanup one
plane up, then a SigProp and a MagRef pass for the plane it drops) take
the reference's route for them: the transform on the device
(`csrc/dwt.cu` on the card), one fetch of the band planes, and the host
library's Tier-1 coders (`models/fused_encode.FusedT1Encoder`,
`tile.encode_t1_blocks`), then the same T2 and rate allocation. The
route is chosen from the request before anything is launched
(`block_coder`): the default style goes to the CUDA MQ coder, the HT
style without refinement (or with it under an explicit rate allocator,
which drops it, as the reference does) to the CUDA HT coder, and neither
reaches the host coders. HT rate control with refinement searches the
step on the CUDA HT coder's cleanup totals and confirms it with refined
encodes, as the reference's search does.

- `encode(image, params)`: one image; its tiles are grouped by their
  fused plan and each group's tiles are stacked and coded together on
  the device (`models/fused_encode.py`), or with `mesh=` split over
  several devices (`parallel/sharding.py`), then every tile's T2 runs
  on a host pool (`write_codestream`).
- `encode_batch(images, params)`: same-geometry frames stacked and coded
  a chunk at a time; frames of different geometries go to `encode` one
  by one.
- `write_codestream`: the codestream of one image whose code-block
  segments were coded on the device (the reference host `encode`'s
  header and tile-part writing, with its rate allocator), or the T2 of
  some of its tiles and the codestream from finished tile results (the
  multi-process encode, `parallel/multihost.py`).

The codestream parameters (`build_siz`, `build_cod`), tile extraction,
the rate allocators' construction and the main-header and tile-part
writing of the reference's host `encode` are copied here, fed the
device's segments (with their R-D pass tables under rate control), and
packetize through the port's native T2. Every stream is byte-identical
to the reference host encoder's.

Requests outside the port raise NotImplementedError instead of falling
back to the host: a styled MQ or a refined HT request on a mesh of more
than one shard (the reference's transform-only mesh route). The HT
refinement flag on an MQ request changes nothing, as in the reference.
ROI with the HT coder, and a custom MCT off 9/7 or of the wrong size,
raise the reference's ValueError.
"""

from __future__ import annotations

import collections
import concurrent.futures
import dataclasses
import os
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..core.geometry import ceil_div, tile_grid_size, tile_rect
from ..core.image import Image
from ..core.params import MCT, EncoderParams, QuantStyle, Transform
from ..models import fused_encode
from ..ops import _build, ht_tables
from ..ops.linalg import lup_inverse
from ..utils.device import DeviceLike, resolve_device, resolve_mesh
from . import markers
from .markers import CodInfo, ComponentSiz, SizInfo, SotInfo
from .pcrd import GlobalPCRDAllocator, make_layer_alloc
from .tile import TileEncResult, default_qcd, encode_tile


def build_siz(image: Image, params: EncoderParams) -> SizInfo:
    # Default tile: one tile covering the whole image area from the tile
    # origin (Table A-10 requires XTOsiz + XTsiz > XOsiz; sizing from the
    # image offset would leave phantom tiles before the image origin).
    xt, yt = params.tile_size if params.tile_size else (
        image.xsiz - params.tile_offset[0],
        image.ysiz - params.tile_offset[1],
    )
    comps = [
        ComponentSiz(prec=c.prec, signed=c.signed, dx=c.dx, dy=c.dy)
        for c in image.components
    ]
    return SizInfo(
        xsiz=image.xsiz, ysiz=image.ysiz,
        xosiz=params.image_offset[0], yosiz=params.image_offset[1],
        xtsiz=xt, ytsiz=yt,
        xtosiz=params.tile_offset[0], ytosiz=params.tile_offset[1],
        comps=comps,
    )


def build_cod(image: Image, params: EncoderParams) -> CodInfo:
    """COD of the slice: mct 2 for a custom MCT, else the parameters' MCT
    or RCT / ICT over three equally sampled components."""
    mct = 2 if params.custom_mct is not None else params.mct
    if mct is None:
        same = (
            image.numcomps >= 3
            and all(image.components[i].dx == image.components[0].dx
                    and image.components[i].dy == image.components[0].dy
                    for i in range(3))
        )
        mct = MCT.RCT_OR_ICT if same else MCT.NONE
    precincts = None
    if params.precincts is not None:
        precincts = params.precinct_exps_for(params.numresolutions)
    return CodInfo(
        progression=params.progression,
        numlayers=params.numlayers,
        mct=int(mct),
        numresolutions=params.numresolutions,
        cblk_w_exp=params.cblk_w_exp,
        cblk_h_exp=params.cblk_h_exp,
        cblk_style=params.cblk_style,
        transform=params.transform,
        precincts=precincts,
        sop=params.sop_markers,
        eph=params.eph_markers,
    )


def extract_tile_comps(image: Image, siz: SizInfo, t: int) -> List[np.ndarray]:
    """Slice per-component tile data out of the full image planes."""
    tr = tile_rect(t, siz.xsiz, siz.ysiz, siz.xosiz, siz.yosiz,
                   siz.xtsiz, siz.ytsiz, siz.xtosiz, siz.ytosiz)
    out = []
    for comp in image.components:
        tcx0 = ceil_div(tr.x0, comp.dx)
        tcy0 = ceil_div(tr.y0, comp.dy)
        tcx1 = ceil_div(tr.x1, comp.dx)
        tcy1 = ceil_div(tr.y1, comp.dy)
        ox = ceil_div(image.x0, comp.dx)
        oy = ceil_div(image.y0, comp.dy)
        out.append(np.ascontiguousarray(
            comp.data[tcy0 - oy:tcy1 - oy, tcx0 - ox:tcx1 - ox]))
    return out


def _cod_comp(siz: SizInfo, cod: CodInfo, params: EncoderParams):
    """Per-component COD overrides (COC markers), or None."""
    if not params.comp_cblk_exps:
        return None
    cod_comp = [None] * len(siz.comps)
    for compno, (we, he) in params.comp_cblk_exps.items():
        cod_comp[compno] = dataclasses.replace(
            cod, cblk_w_exp=we, cblk_h_exp=he)
    return cod_comp


def _roishifts(siz: SizInfo, params: EncoderParams) -> Optional[List[int]]:
    """Each component's ROI shift, or None without ROI."""
    if params.roi_comp is None or params.roi_shift <= 0:
        return None
    shifts = [0] * len(siz.comps)
    shifts[params.roi_comp] = params.roi_shift
    return shifts


def _part2(params: EncoderParams, siz: SizInfo):
    """A custom MCT's coding matrix (the LUP inverse of the decoding
    matrix `params.custom_mct`) and its Part-2 marker segments (CBD, the
    decoding matrix and the DC offsets as MCT records, MCC, MCO), as the
    reference encoder writes them (reference: j2k_setup_mct_encoding); or
    (None, b"") without one. Raises the reference's ValueErrors: off the
    9/7 transform, or a matrix that is not ncomps x ncomps."""
    if params.custom_mct is None:
        return None, b""
    if params.transform != Transform.DWT_97:
        raise ValueError("custom MCT requires the 9/7 transform")
    decode_matrix = np.asarray(params.custom_mct, np.float32)
    n = len(siz.comps)
    if decode_matrix.shape != (n, n):
        raise ValueError("custom MCT matrix must be ncomps x ncomps")
    offsets = [0 if c.signed else (1 << (c.prec - 1)) for c in siz.comps]
    extra = markers.write_cbd(siz.comps)
    extra += markers.write_mct_record(
        1, markers.MCT_ARRAY_DECORRELATION, decode_matrix)
    extra += markers.write_mct_record(
        2, markers.MCT_ARRAY_OFFSET, np.asarray(offsets, np.float32))
    extra += markers.write_mcc(n, 1, 2)
    extra += markers.write_mco([0])
    return lup_inverse(decode_matrix), extra


def _guard_bits(params: EncoderParams) -> int:
    """HT (Part 15) streams use one guard bit, as the reference
    (j2k.cpp:1834); Part-1 streams the parameter's."""
    return 1 if params.cblk_style & 0x40 else params.num_guard_bits


def _needs_rc(params: EncoderParams) -> bool:
    return bool(params.rates and any(r > 0 for r in params.rates)) \
        or bool(params.quality_psnr)


def _image_bytes(image: Image) -> int:
    return sum(c.data.shape[0] * c.data.shape[1] * c.prec
               for c in image.components) // 8


def write_codestream(image: Image, params: EncoderParams,
                     t1_segments_by_tile: Optional[Dict[int, List]],
                     rsiz: int = 0, layer_alloc=None,
                     only_tiles: Optional[Sequence[int]] = None,
                     tile_results: Optional[Dict[int, TileEncResult]] = None):
    """Write the codestream of one image whose code-block segments were
    coded on the device: `t1_segments_by_tile[t]` in t1-desc order (HT
    segment bytes, MQ (data, numbps, numpasses) tuples, or under rate
    control MQ (data, numbps, numpasses, passes) tuples).

    The reference's host `encode(..., device=False,
    _t1_segments_by_tile=...)`: main header (SIZ, with `rsiz` ORed in
    (a profile's), the Part-15 flag and a CAP for HT, and the Part-2
    flags for a custom MCT, COD, COC, QCD, POC, RGN for ROI, the custom
    MCT's CBD / MCT / MCC / MCO, COM, PPM, TLM), the rate allocator
    `layer_alloc` where given (a
    profile's byte caps, `profiles.profile_allocator`), else, when the
    parameters set byte or PSNR targets, the image-wide allocator
    (`pcrd.GlobalPCRDAllocator`) with `rate_alloc="global"` and more
    than one tile, or the per-tile one (`pcrd.make_layer_alloc`), then
    each tile's T2 (`tile.encode_tile`) on a host thread pool, as one
    tile-part, or split at progression changes (`tp_flag`), with PPT/PLT
    where asked. Under the image-wide allocator the pool holds every
    tile at once: each tile waits at the allocator's barrier for all the
    others.

    The multi-process encode (`parallel.multihost.encode_multihost`)
    splits this in two, as the reference's `_only_tiles` /
    `_tile_results`. With `only_tiles` it runs the T2 of those tiles only
    and returns {tile: `tile.TileEncResult`}; with `rate_alloc="global"`
    and more than one tile in the image, their allocator is the
    process-reduce `GlobalPCRDAllocator`, whose sums run over every
    process of the `torch.distributed` group (a process that owns no
    tile still joins them, `participate_empty`). With `tile_results`
    ({tile: `TileEncResult`}) it assembles the codestream from them, the
    T2 of any other tile run here from `t1_segments_by_tile`; under the
    image-wide allocator they must be every tile, allocated already."""
    # Layer count follows the rate/quality vectors when they are longer
    _nl = max(params.numlayers, len(params.rates),
              len(params.quality_psnr))
    if _nl != params.numlayers:
        params = dataclasses.replace(params, numlayers=_nl)
    is_ht = bool(params.cblk_style & 0x40)
    siz = build_siz(image, params)
    if rsiz:
        siz = dataclasses.replace(siz, rsiz=siz.rsiz | rsiz)
    cod = build_cod(image, params)
    qcd = default_qcd(siz, cod, _guard_bits(params), params.base_step)
    if is_ht:
        # HT (Part 15): JPH rsiz flag, CAP marker after SIZ
        siz = dataclasses.replace(siz, rsiz=siz.rsiz | markers.JPH_RSIZ_FLAG)
    cod_comp = _cod_comp(siz, cod, params)
    coding_matrix, part2 = _part2(params, siz)
    if coding_matrix is not None:
        siz = dataclasses.replace(siz, rsiz=siz.rsiz | 0x8000 | 0x0100)
    roishifts = _roishifts(siz, params)

    out = bytearray()
    out += markers.write_soc()
    out += markers.write_siz(siz)
    if is_ht:
        reversible = cod.transform == Transform.DWT_53
        if qcd.style == QuantStyle.NONE:
            max_mb = max(e + qcd.num_guard_bits - 1 for e in qcd.exponents)
        else:
            max_mb = max(e + qcd.num_guard_bits - 1 for (e, m) in qcd.steps)
        out += markers.write_cap(reversible, max_mb)
    out += markers.write_cod(cod)
    if cod_comp:
        for compno, cc in enumerate(cod_comp):
            if cc is not None:
                out += markers.write_coc(compno, cc, len(siz.comps))
    out += markers.write_qcd(qcd)
    if params.pocs:
        out += markers.write_poc(params.pocs, len(siz.comps))
    if roishifts is not None:
        out += markers.write_rgn(params.roi_comp, params.roi_shift,
                                 len(siz.comps))
    out += part2
    if params.comment:
        out += markers.write_com(params.comment)

    ntx, nty = tile_grid_size(siz.xsiz, siz.ysiz, siz.xosiz, siz.yosiz,
                              siz.xtsiz, siz.ytsiz, siz.xtosiz, siz.ytosiz)
    tile_parts = bytearray()
    tp_lengths = []
    ppm_sections: list = []
    numtiles = ntx * nty
    split = params.ppt_markers or params.ppm_markers
    if only_tiles is not None:
        todo = sorted(only_tiles)
    else:
        todo = [t for t in range(numtiles)
                if tile_results is None or t not in tile_results]
    global_alloc = None
    if layer_alloc is None and _needs_rc(params):
        if params.rate_alloc == "global" and tile_results is not None:
            # every tile arrives with its layers allocated already
            if todo:
                raise NotImplementedError(
                    "rate_alloc='global' with partial tile_results")
        elif params.rate_alloc == "global" and numtiles > 1:
            layer_alloc = global_alloc = GlobalPCRDAllocator(
                rates=params.rates, quality_psnr=params.quality_psnr,
                image_bytes=_image_bytes(image), numtiles=max(len(todo), 1),
                **({} if only_tiles is None else dict(
                    process_reduce=True, global_numtiles=numtiles,
                    numlayers=cod.numlayers)))
            if not todo:
                global_alloc.participate_empty()
        else:
            layer_alloc = make_layer_alloc(image, params)

    def tile_t2(t: int):
        tr = tile_rect(t, siz.xsiz, siz.ysiz, siz.xosiz, siz.yosiz,
                       siz.xtsiz, siz.ytsiz, siz.xtosiz, siz.ytosiz)
        try:
            return encode_tile(
                t1_segments_by_tile[t], siz, cod, qcd, tr,
                layer_alloc=layer_alloc, cod_comp=cod_comp,
                pocs=params.pocs or None, roishifts=roishifts,
                split_headers=split,
                want_packet_lengths=params.plt_markers
                or params.tp_flag is not None, tile_index=t)
        except BaseException as e:
            if global_alloc is not None:
                global_alloc.fail(e)
            raise

    workers = len(todo) if global_alloc is not None else \
        min(len(todo), os.cpu_count() or 1)
    if workers > 1:
        with concurrent.futures.ThreadPoolExecutor(
                max_workers=workers) as pool:
            done = dict(zip(todo, pool.map(tile_t2, todo)))
    else:
        done = {t: tile_t2(t) for t in todo}
    if only_tiles is not None:
        return done
    results = [done[t] if t in done else tile_results[t]
               for t in range(numtiles)]

    axis_idx = {"L": 0, "R": 1, "C": 2}
    for t in range(numtiles):
        res = results[t]
        if params.tp_flag is not None:
            # Tile-part generation (reference tp_on/tp_flag): split the
            # packet sequence at changes of the chosen progression
            # coordinate; each run becomes its own SOT..SOD tile-part.
            if params.ppt_markers or params.ppm_markers:
                raise ValueError("tp_flag cannot combine with packed "
                                 "packet headers")
            ai = axis_idx[params.tp_flag.upper()]
            runs = []  # (start_byte, end_byte)
            pos = 0
            cur = None
            start = 0
            for pid, ln in zip(res.packet_ids, res.packet_lengths):
                v = pid[ai]
                if cur is None:
                    cur = v
                elif v != cur:
                    runs.append((start, pos))
                    start = pos
                    cur = v
                pos += ln
            runs.append((start, pos))
            tnsot = len(runs)
            for k, (b0, b1) in enumerate(runs):
                frag = res.body[b0:b1]
                tp_hdr = b""
                if params.plt_markers and k == 0:
                    tp_hdr += markers.write_plt(res.packet_lengths)
                psot = 12 + len(tp_hdr) + 2 + len(frag)
                tile_parts += markers.write_sot(SotInfo(
                    tile_index=t, psot=psot, tpsot=k, tnsot=tnsot))
                tile_parts += tp_hdr
                tile_parts += markers.write_sod()
                tile_parts += frag
                tp_lengths.append((t, psot))
            continue
        tp_hdr = b""
        if params.ppt_markers:
            tp_hdr += markers.write_ppt(res.packet_headers or b"")
        elif params.ppm_markers:
            ppm_sections.append(res.packet_headers or b"")
        if params.plt_markers and res.packet_lengths is not None:
            tp_hdr += markers.write_plt(res.packet_lengths)
        psot = 12 + len(tp_hdr) + 2 + len(res.body)
        tile_parts += markers.write_sot(SotInfo(tile_index=t, psot=psot))
        tile_parts += tp_hdr
        tile_parts += markers.write_sod()
        tile_parts += res.body
        tp_lengths.append((t, psot))
    if params.ppm_markers:
        out += markers.write_ppm(ppm_sections)
    if params.tlm_markers:
        out += markers.write_tlm(tp_lengths)
    out += tile_parts
    out += markers.write_eoc()
    return bytes(out)


def _geom(img: Image):
    return tuple((c.data.shape, c.prec, c.signed, c.dx, c.dy)
                 for c in img.components) + (img.xsiz, img.ysiz)


def tile_count(image: Image, params: EncoderParams) -> int:
    """The number of tiles `params` cut `image` into."""
    s = build_siz(image, params)
    ntx, nty = tile_grid_size(s.xsiz, s.ysiz, s.xosiz, s.yosiz, s.xtsiz,
                              s.ytsiz, s.xtosiz, s.ytosiz)
    return ntx * nty


def block_coder(params: EncoderParams, layer_alloc=None) -> str:
    """The block coder route of a request, from its code-block style:
    "ht" (the HT style bit, the CUDA HT coder), "mq" (the default MQ
    style 0, the CUDA MQ coder) or "t1" (any other MQ style, or HT with
    refinement passes: the host library's Tier-1 coders behind the
    device transform). An explicit rate allocator `layer_alloc` drops
    the refinement, as the reference's `encode_tile` does: its HT
    blocks go to the allocator as one pass each."""
    if params.cblk_style & 0x40:
        return "t1" if params.ht_refinement and layer_alloc is None \
            else "ht"
    return "t1" if params.cblk_style else "mq"


def _out_of_slice(params: EncoderParams, layer_alloc=None,
                  shards: int = 1) -> Optional[str]:
    """Why a request is outside the ported slices, or None."""
    if shards > 1 and block_coder(params, layer_alloc) == "t1":
        what = "HT refinement passes" if params.cblk_style & 0x40 else \
            f"the MQ code-block style {params.cblk_style:#x}"
        return (f"{what} on a mesh of {shards} shards (the transform-only "
                f"mesh route)")
    return None


def free_device_bytes(dev: torch.device) -> Optional[int]:
    """Free bytes of a CUDA device (`torch.cuda.mem_get_info`); None for
    the CPU, where `encode_batch` does not cap its chunk."""
    if dev.type != "cuda":
        return None
    return torch.cuda.mem_get_info(dev)[0]


def _capped_chunk(chunk: int, encoders, dev: torch.device,
                  rate_control: bool = False, shares: int = 1) -> int:
    """`chunk`, lowered for each plan to the frames whose encode (under
    HT rate control: with the blocks resident through the search) fits in
    half the device's free memory, split evenly among the `shares` mesh
    shards that code on it at once (`fused_encode.chunk_cap`); as it is
    on the CPU."""
    free = free_device_bytes(dev)
    for plan in encoders:
        if free is not None:
            chunk = min(chunk, fused_encode.chunk_cap(plan, free // shares,
                                                      rate_control))
    return chunk


def _ht_rc_check(params: EncoderParams) -> None:
    """The reference's ValueErrors for an HT request with targets: PSNR
    targets (its `encode`), and rates on 5/3, with more than one layer or
    ratio, or at a ratio not above 0 (its `_encode_ht_rate_controlled`)."""
    if params.quality_psnr:
        raise ValueError("PSNR targets are not available with the HT "
                         "block coder (single cleanup pass)")
    if not params.rates:
        return
    if params.transform != Transform.DWT_97:
        raise ValueError("HT rate control requires the 9/7 transform "
                         "(reversible HT has no quantizer to adjust)")
    if len(params.rates) != 1 or max(params.numlayers,
                                     len(params.rates)) != 1:
        raise ValueError("HT rate control supports a single layer/ratio")
    if float(params.rates[0]) <= 0:
        raise ValueError("HT rate control needs a positive ratio")


def _encode_ht_rate_controlled(image: Image, params: EncoderParams):
    """HT + byte-rate targeting, the reference's search and confirm loop,
    as a generator so that `encode_batch` can drive a chunk's frames in
    lockstep. HT has no truncation points, so rate control adjusts the
    9/7 base quantization step: the step search reads exact segment byte
    totals of the device HT coder on the resident bands (it yields
    ("probe", step) and is sent the total), and full encodes at a chosen
    step confirm it and calibrate the header and T2 overhead (it yields
    ("encode", step) and is sent the stream). Returns the stream.
    `params` passed `_ht_rc_check`."""
    target = max(256, int(_image_bytes(image) / float(params.rates[0])))
    seg_cache: dict = {}

    def seg(step: float):
        if step not in seg_cache:
            seg_cache[step] = yield ("probe", step)
        return seg_cache[step]

    def search(ov: int):
        """Smallest step whose simulated total fits the target."""
        lo, hi = 0.25, 1.0
        while (yield from seg(hi)) + ov > target and hi < 4096:
            lo, hi = hi, hi * 4.0
        if (yield from seg(hi)) + ov > target:
            return hi           # floor: even huge steps overshoot
        while (yield from seg(lo)) + ov <= target and lo > 1e-4:
            hi, lo = lo, lo / 4.0
        if (yield from seg(lo)) + ov <= target:
            return lo
        for _ in range(10):     # log bisection on the simulator
            mid = (lo * hi) ** 0.5
            if (yield from seg(mid)) + ov <= target:
                hi = mid
            else:
                lo = mid
            if lo / hi > 0.995:
                break
        return hi

    # Initial overhead guess; calibrated exactly after the first confirm.
    ov = max(200, target // 50)
    best = None
    for _ in range(4):
        step = yield from search(ov)
        cs = yield ("encode", step)
        if len(cs) <= target:
            best = cs
            true_ov = len(cs) - (yield from seg(step))
            if true_ov >= ov - max(32, target // 500):
                return cs       # overhead was right: step is optimal
            ov = max(0, true_ov)        # margin was too big: retry finer
            refined = yield from search(ov)
            if refined >= step * 0.995:
                return cs
            cs2 = yield ("encode", refined)
            return cs2 if len(cs2) <= target else cs
        ov = len(cs) - (yield from seg(step)) + max(32, target // 500)
    return best if best is not None else cs


def _ht_rc_bisect(image: Image, params: EncoderParams,
                  devs: List[torch.device], rsiz: int) -> bytes:
    """HT + byte-rate targeting with a custom MCT: the reference's
    bisection of the base step by whole encodes (its `_ht_rc_bisect`, the
    route its `_encode_ht_rate_controlled` takes for a custom MCT), each
    encode `encode` on the devices `devs` (a mesh). `params` passed
    `_ht_rc_check`."""
    target = max(256, int(_image_bytes(image) / float(params.rates[0])))

    def attempt(step: float) -> bytes:
        return encode(image, dataclasses.replace(params, rates=(),
                                                 base_step=step), mesh=devs,
                      rsiz=rsiz)

    lo, hi = 0.25, 1.0          # step bracket (bytes(lo) >= bytes(hi))
    cs_hi = attempt(hi)
    while len(cs_hi) > target and hi < 4096:
        lo, hi = hi, hi * 4.0
        cs_hi = attempt(hi)
    if len(cs_hi) > target:
        return cs_hi            # floor: even huge steps overshoot
    best = cs_hi
    cs_lo = attempt(lo)
    while len(cs_lo) <= target and lo > 1e-4:
        hi, best = lo, cs_lo
        lo = lo / 4.0
        cs_lo = attempt(lo)
    if len(cs_lo) <= target:
        return cs_lo
    for _ in range(8):          # bisect in log space
        mid = (lo * hi) ** 0.5
        cs = attempt(mid)
        if len(cs) <= target:
            hi, best = mid, cs
        else:
            lo = mid
        if abs(len(cs) - target) <= max(64, target // 200):
            if len(cs) <= target:
                return cs
    return best


class _HTRateSearch:
    """The device side of one chunk's HT rate control: each tile's
    code-blocks, transformed (DC shift, MCT, 9/7 DWT) and gathered once
    and resident through the chunk's search, and each candidate base
    step's lanes, made once a step: `FusedHTEncoder.lanes` of the tile
    plans at `default_qcd(siz, cod, 1, step)`, which sets both the band
    steps and Mb."""

    def __init__(self, images: List[Image], siz: SizInfo, cod: CodInfo,
                 cod_comp, tile_enc: List):
        self.siz, self.cod, self.cod_comp = siz, cod, cod_comp
        s = siz
        self.trs = [tile_rect(t, s.xsiz, s.ysiz, s.xosiz, s.yosiz, s.xtsiz,
                              s.ytsiz, s.xtosiz, s.ytosiz)
                    for t in range(len(tile_enc))]
        self.tile_enc = tile_enc
        self.blocks = []
        for t, enc in enumerate(tile_enc):
            stacks = zip(*(extract_tile_comps(im, s, t) for im in images))
            args = fused_encode.upload_tile([np.stack(c) for c in stacks],
                                            enc)
            self.blocks.append(enc.gather(enc.transform(*args)))
        self._lanes: Dict[float, List] = {}

    def lanes(self, step: float) -> List:
        """Per tile, the lanes of the plan at base step `step`."""
        if step not in self._lanes:
            qcd = default_qcd(self.siz, self.cod, 1, step)
            self._lanes[step] = [
                enc.lanes(fused_encode.build_plan(
                    self.siz, self.cod, qcd, tr, cod_comp=self.cod_comp))
                for tr, enc in zip(self.trs, self.tile_enc)]
        return self._lanes[step]


def _ht_rc_segment_bytes(search: _HTRateSearch, frames: List[int],
                         steps: List[float]) -> List[int]:
    """Exact total HT segment bytes of the chunk's frames numbered
    `frames`, each at its base step in `steps`, from the resident
    blocks: the device's quantization and HT coder, nothing else (one
    `FusedHTEncoder.segment_totals` a tile, one fetch of the totals a
    device)."""
    totals: Dict[torch.device, torch.Tensor] = {}
    for t, enc in enumerate(search.tile_enc):
        n = enc.segment_totals(search.blocks[t], frames,
                               [search.lanes(s)[t] for s in steps])
        totals[n.device] = n + totals[n.device] if n.device in totals else n
    return sum(n.cpu() for n in totals.values()).tolist()


def _ht_rc_segments(search: _HTRateSearch, frames: List[int],
                    steps: List[float]) -> List[Dict[int, List]]:
    """The fused encode of the chunk's frames numbered `frames`, each at
    its base step, from the resident blocks: per frame its segments by
    tile, for the host T2 of `encode`."""
    out: List[Dict[int, List]] = [{} for _ in frames]
    for t, enc in enumerate(search.tile_enc):
        lens, data = enc.encode_blocks(search.blocks[t], frames,
                                       [search.lanes(s)[t] for s in steps])
        segs = fused_encode.assemble_collected_ht(
            enc.plan, len(frames), lens.cpu().numpy(), data.cpu().numpy())
        for i, sg in enumerate(segs):
            out[i][t] = sg
    return out


def _encode_ht_rc_chunk(images: List[Image], params: EncoderParams,
                        search: _HTRateSearch, t2_pool,
                        devs: List[torch.device],
                        rsiz: int = 0) -> List[bytes]:
    """The streams of a chunk's frames under HT rate control: every
    frame's search (`_encode_ht_rate_controlled`) driven in lockstep, a
    round being one probe for every frame that asks for a total, and one
    fused encode for every frame that asks for a stream, whose host T2
    runs on `t2_pool` (`encode` at the step, as the reference's confirm
    encodes). With HT refinement the probes stay the cleanup totals of
    the CUDA HT coder, and each confirm is `encode` at the step on the
    mesh `devs`: the refined route, as the reference's confirm encodes
    code its refinement and its probes do not."""
    gens = [_encode_ht_rate_controlled(im, params) for im in images]
    asks = {f: next(g) for f, g in enumerate(gens)}
    done: Dict[int, bytes] = {}
    while asks:
        probes = [f for f in sorted(asks) if asks[f][0] == "probe"]
        confirms = [f for f in sorted(asks) if asks[f][0] == "encode"]
        futures = []
        answers = {}
        if confirms and params.ht_refinement:
            answers.update((f, _encode(images[f], dataclasses.replace(
                params, rates=(), base_step=asks[f][1]), None, devs, rsiz))
                for f in confirms)
        elif confirms:
            segs = _ht_rc_segments(search, confirms,
                                   [asks[f][1] for f in confirms])
            futures = [(f, t2_pool.submit(write_codestream, images[f],
                                          dataclasses.replace(
                                              params, rates=(),
                                              base_step=asks[f][1]), sg,
                                          rsiz))
                       for f, sg in zip(confirms, segs)]
        if probes:
            answers.update(zip(probes, _ht_rc_segment_bytes(
                search, probes, [asks[f][1] for f in probes])))
        answers.update((f, fut.result()) for f, fut in futures)
        for f in sorted(answers):
            try:
                asks[f] = gens[f].send(answers[f])
            except StopIteration as stop:
                done[f] = stop.value
                del asks[f]
    return [done[f] for f in range(len(images))]


def _check(params: EncoderParams, layer_alloc, what: str,
           shards: int = 1) -> None:
    """The reference's ValueErrors of an HT request with targets or with
    ROI, then NotImplementedError for a request outside the ported
    slices on a mesh of `shards` shards."""
    if params.cblk_style & 0x40:
        _ht_rc_check(params)
        if params.roi_comp is not None and params.roi_shift > 0:
            raise ValueError("ROI upshift is not supported with the HT "
                             "block coder")
    why = _out_of_slice(params, layer_alloc, shards)
    if why is not None:
        raise NotImplementedError(
            f"{what} on a torch device does not cover {why} yet")


def _coding(image: Image, params: EncoderParams):
    """The reference's parameter derivation of `encode` / `encode_batch`:
    (params with the layer count of its targets, SIZ, COD, QCD, COC
    overrides, the tile rects)."""
    nl = max(params.numlayers, len(params.rates), len(params.quality_psnr))
    p = params if nl == params.numlayers else dataclasses.replace(
        params, numlayers=nl)
    siz = build_siz(image, p)
    cod = build_cod(image, p)
    qcd = default_qcd(siz, cod, _guard_bits(p), p.base_step)
    cod_comp = _cod_comp(siz, cod, p)
    ntx, nty = tile_grid_size(siz.xsiz, siz.ysiz, siz.xosiz, siz.yosiz,
                              siz.xtsiz, siz.ytsiz, siz.xtosiz, siz.ytosiz)
    trs = [tile_rect(t, siz.xsiz, siz.ysiz, siz.xosiz, siz.yosiz,
                     siz.xtsiz, siz.ytsiz, siz.xtosiz, siz.ytosiz)
           for t in range(ntx * nty)]
    return p, siz, cod, qcd, cod_comp, trs


def plan_encoder(plan: Optional[fused_encode.FusedPlan], dev: torch.device,
                 encoders: Dict) -> object:
    """The fused encoder of a tile's plan (`fused_encode.FusedHTEncoder`,
    `FusedMQEncoder` or `FusedT1Encoder`, by the plan's coder) on `dev`,
    kept in `encoders` by plan and device so that every tile of one plan
    on one device shares one (the interior tiles of a grid do)."""
    if plan is None:
        raise NotImplementedError("the tile is outside the fused plan's "
                                  "scope")
    if (plan, dev) not in encoders:
        if plan.coder == "ht":
            enc = fused_encode.FusedHTEncoder(plan,
                                              ht_tables.device_tables(dev))
        elif plan.coder == "t1":
            enc = fused_encode.FusedT1Encoder(plan, dev)
        else:
            enc = fused_encode.FusedMQEncoder(plan, dev)
        encoders[plan, dev] = enc
    return encoders[plan, dev]


def tile_plans(siz: SizInfo, cod: CodInfo, qcd, trs, coder: str,
               cod_comp=None, want_rd: bool = False,
               custom_mct=None) -> List[fused_encode.FusedPlan]:
    """The fused plan of each tile rect in `trs` (a custom MCT's coding
    matrix is part of the plan). Raises NotImplementedError for a tile
    outside the fused plan's scope."""
    plans = [fused_encode.build_plan(siz, cod, qcd, tr, cod_comp=cod_comp,
                                     coder=coder, want_rd=want_rd,
                                     custom_mct=custom_mct) for tr in trs]
    if any(plan is None for plan in plans):
        raise NotImplementedError("a tile is outside the fused plan's "
                                  "scope")
    return plans


def _tile_encoders(p: EncoderParams, siz: SizInfo, cod: CodInfo, qcd,
                   cod_comp, trs, dev, want_rd: bool,
                   coder: Optional[str] = None) -> List:
    """Each tile's fused encoder (`plan_encoder`) for the block coder
    `coder` (by default `block_coder(p)`) on `dev`, or on a mesh (a list
    of devices) each plan's tiles split over it as `sharding.plan_shards`
    splits them."""
    from ..parallel.sharding import plan_shards
    devs = dev if isinstance(dev, list) else [dev]
    plans = tile_plans(siz, cod, qcd, trs, coder or block_coder(p),
                       cod_comp, want_rd, _part2(p, siz)[0])
    on = {t: devs[di] for _, di, part in plan_shards(
        range(len(plans)), plans, len(devs)) for t in part}
    encoders: Dict = {}
    return [plan_encoder(plan, on[t], encoders)
            for t, plan in enumerate(plans)]


def encode(image: Image, params: Optional[EncoderParams] = None,
           layer_alloc=None, device: DeviceLike = "cuda",
           rsiz: int = 0, mesh: Optional[Sequence[DeviceLike]] = None
           ) -> bytes:
    """Encode one image to a raw J2K codestream on a torch device: the
    slices of `encode_batch`, byte-identical to the reference's host
    `encode(image, params, layer_alloc, device=False, rsiz=rsiz)`.

    The image's tiles are grouped by their fused plan (the interior
    tiles of a grid share one; edge tiles have their own), and each
    group's tiles are stacked on the leading axis and coded together on
    the device (`fused_encode.encode_tile_submit` on the plan's encoder),
    as many a call as fit in half the device memory free at the start
    (`_capped_chunk`: a tile costs what a frame of its plan costs). Each
    chunk is collected once the next is submitted, so the device codes
    one while the host fetches the other and at most two chunks' outputs
    are on the device; then each tile's T2, with the rate allocation,
    runs on a host thread pool (`write_codestream`). HT with a byte
    target runs the reference's search of the quantizer step on the
    device coder (`encode_batch` of the one image); with a custom MCT its
    bisection by whole encodes (`_ht_rc_bisect`).

    `mesh` (a sequence of devices, one shard each; it replaces `device`)
    splits each plan group's tiles over the mesh and codes the shards
    together (`parallel.sharding.fused_entropy_tiles_on_mesh`; under HT
    rate control each plan's tiles are split the same way); every other
    stage is this same code path, so the stream equals the one-device
    encode's."""
    return _encode(image, params or EncoderParams(), layer_alloc,
                   resolve_mesh(mesh, device), rsiz)


def _encode(image: Image, params: EncoderParams, layer_alloc,
            devs: List[torch.device], rsiz: int,
            only_tiles: Optional[Sequence[int]] = None):
    """`encode` on the mesh `devs`; with `only_tiles`, the coding and T2
    of those tiles only: {tile: `tile.TileEncResult`}
    (`write_codestream(only_tiles=)`)."""
    from ..parallel.sharding import fused_entropy_tiles_on_mesh
    _check(params, layer_alloc, "encode", len(devs))
    if params.cblk_style & 0x40 and params.rates:
        if only_tiles is not None:
            raise NotImplementedError(
                "HT rate control searches the base step over the whole "
                "image; it does not code a part of the tiles")
        return _encode_batch([image], params, devs, rsiz=rsiz)[0]
    _build.host_library()
    p, siz, cod, qcd, cod_comp, trs = _coding(image, params)
    want_rd = not p.cblk_style & 0x40 and (layer_alloc is not None
                                           or _needs_rc(p))
    segs = fused_entropy_tiles_on_mesh(
        image, siz, cod, qcd, devs, block_coder(p, layer_alloc),
        cod_comp=cod_comp, want_rd=want_rd, custom_mct=_part2(p, siz)[0],
        tiles=only_tiles)
    return write_codestream(image, params, segs, rsiz, layer_alloc,
                            only_tiles=only_tiles)


def encode_batch(images: List[Image], params: Optional[EncoderParams] = None,
                 device: DeviceLike = "cuda", chunk: int = 32, rsiz: int = 0,
                 layer_alloc=None) -> List[bytes]:
    """Encode same-geometry frames with the HT block coder (`cblk_style`
    0x40; 5/3, lossless, or 9/7, at the default or a given base step, or
    at one byte target `rates=(r,)`) or the Part-1 MQ coder (`cblk_style`
    0, or any other MQ code-block style on the host Tier-1 route,
    `block_coder`; 5/3 or 9/7, one layer or quality layers at the byte
    targets `rates` or the PSNR targets `quality_psnr`, per tile or
    image-wide with `rate_alloc="global"`).

    Frames of different geometries go to `encode` one at a time, as the
    reference routes them. Same-geometry frames are coded `chunk` at a
    time: each chunk is one upload and one
    fused device encode per tile, and the host T2 (with the rate
    allocation) of a chunk runs on a thread pool while the device codes
    the next. HT with a byte target searches each frame's base step on
    the chunk's resident code-blocks, the chunk's frames in lockstep
    (`_encode_ht_rc_chunk`). On a CUDA device a chunk is capped to the
    frames whose encode fits in half the free device memory
    (`_capped_chunk`), at least one. The streams are byte-identical to
    the reference host encoder's, whatever the chunk; with
    `rate_alloc="global"` each frame's T2 runs one image-wide allocator
    (`write_codestream`).

    `rsiz` is ORed into each stream's SIZ (a profile's code), and
    `layer_alloc` (a `pcrd.PCRDAllocator`, which keeps no state between
    tiles, so one serves every frame) replaces the allocator the
    parameters' targets would make: with it the MQ encode also returns
    the per-pass R-D tables the allocator needs, as with targets, and
    the HT encode gives it each block's cleanup as one pass (refinement
    dropped, as the reference's). A profile's encode
    (`profiles.encode_with_profile`) passes both.

    HT with refinement passes (`ht_refinement`) takes the host coders'
    route (`block_coder`) for every frame, as the reference's host
    encoder does; the reference's device `encode_batch` drops the
    refinement for a batch of two or more same-geometry frames (ROADMAP
    Queue C)."""
    return _encode_batch(images, params or EncoderParams(),
                         [resolve_device(device)], chunk, rsiz, layer_alloc)


def _encode_batch(images: List[Image], params: EncoderParams,
                  devs: List[torch.device], chunk: int = 32, rsiz: int = 0,
                  layer_alloc=None) -> List[bytes]:
    """`encode_batch` on the mesh `devs`: each plan's tiles split over it
    (`_tile_encoders`), a chunk capped on every device by the plans coded
    there and the mesh's shards on it."""
    if not images:
        return []
    _check(params, layer_alloc, "encode_batch", len(devs))
    if any(_geom(im) != _geom(images[0]) for im in images):
        return [encode(im, params, layer_alloc, rsiz=rsiz, mesh=devs)
                for im in images]
    _build.host_library()

    p, siz, cod, qcd, cod_comp, trs = _coding(images[0], params)
    numtiles = len(trs)
    rate_control = bool(p.cblk_style & 0x40 and p.rates)
    if rate_control and p.custom_mct is not None:
        return [_ht_rc_bisect(im, p, devs, rsiz) for im in images]
    want_rd = not p.cblk_style & 0x40 and (layer_alloc is not None
                                           or _needs_rc(p))
    tile_enc = _tile_encoders(p, siz, cod, qcd, cod_comp, trs, devs,
                              want_rd, "ht" if rate_control
                              else block_coder(p, layer_alloc))

    n = len(images)
    shares = collections.Counter(devs)
    for d in shares:
        encoders = {enc.plan: enc for enc in tile_enc if enc.device == d}
        chunk = _capped_chunk(chunk, encoders, d, rate_control, shares[d])
    chunk = max(1, min(chunk, n))
    results: List[Optional[bytes]] = [None] * n
    futures = []
    with concurrent.futures.ThreadPoolExecutor(
            max_workers=min(4, os.cpu_count() or 1)) as t2_pool:
        for lo in range(0, n, chunk):
            hi = min(lo + chunk, n)
            if rate_control:
                search = _HTRateSearch(images[lo:hi], siz, cod, cod_comp,
                                       tile_enc)
                results[lo:hi] = _encode_ht_rc_chunk(images[lo:hi], p,
                                                     search, t2_pool, devs,
                                                     rsiz)
                del search
                continue
            handles = []
            for t in range(numtiles):
                stacks = list(zip(*(extract_tile_comps(images[f], siz, t)
                                    for f in range(lo, hi))))
                batched = [np.stack(s) for s in stacks]
                handles.append(fused_encode.encode_tile_submit(
                    batched, tile_enc[t]))
            segs = [fused_encode.encode_tile_collect(h) for h in handles]
            for f in range(lo, hi):
                by_tile = {t: segs[t][f - lo] for t in range(numtiles)}
                futures.append((f, t2_pool.submit(
                    write_codestream, images[f], params, by_tile, rsiz,
                    layer_alloc)))
        for f, fut in futures:
            results[f] = fut.result()
    return results  # type: ignore[return-value]
