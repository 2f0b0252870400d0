"""Profile enforcement: Digital Cinema, Broadcast, IMF.

Analog of the reference profile layer (reference:
src/lib/jp2/codestream/j2kprofile.cpp set_cinema_parameters:941,
set_broadcast_parameters:644, set_imf_parameters:121): a profile REWRITES
the encoder parameter set (tiling, code-block size, precincts,
progression, transform, layers) and imposes hard codestream byte caps.

A copy of `grokimagecompression_tpu/codestream/profiles.py` (the
constants, `apply_cinema` / `apply_broadcast` / `apply_imf`, the
compliance validators and `ProfiledParams`, as they are), but for
`encode_with_profile`, which encodes the frame through the port's
`encoder.encode_batch` on a torch device with the same allocator and
rsiz. `tests/test_torch_profiles.py` holds the copy to the original.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

from ..core.params import EncoderParams, Progression, Transform

# Rsiz profile codes (ISO/IEC 15444-1 and AMDs; same values as the
# reference, grok.h:157-168).
PROFILE_NONE = 0x0000
PROFILE_0 = 0x0001
PROFILE_1 = 0x0002
PROFILE_CINEMA_2K = 0x0003
PROFILE_CINEMA_4K = 0x0004
PROFILE_BC_SINGLE = 0x0100
PROFILE_BC_MULTI = 0x0200
PROFILE_BC_MULTI_R = 0x0300
PROFILE_IMF_2K = 0x0400
PROFILE_IMF_4K = 0x0500
PROFILE_IMF_8K = 0x0600
PROFILE_IMF_2K_R = 0x0700
PROFILE_IMF_4K_R = 0x0800
PROFILE_IMF_8K_R = 0x0900

# Cinema rate ceilings in codestream bytes per frame (grok.h:316-319).
CINEMA_24_CS = 1_302_083
CINEMA_48_CS = 651_041
CINEMA_24_COMP = 1_041_666
CINEMA_48_COMP = 520_833

# Broadcast / IMF per-level throughput ceilings (reference:
# grok.h:254-310; Mbit/s = compressed bit rate, Msamples/s = component
# sampling rate).
BROADCAST_MBITS_SEC = (0, 200, 200, 200, 400, 800, 1600, 3200, 6400,
                       12800, 25600, 51200)
BROADCAST_MSAMPLES_SEC = (0, 64, 130, 195, 260, 520, 1200, 2400, 4800,
                          9600, 19200, 38400)
IMF_MAIN_MSAMPLES_SEC = (0, 65, 130, 195, 260, 520, 1200, 2400, 4800,
                         9600, 19200, 38400)
IMF_SUB_MBITS_SEC = (0, 200, 400, 800, 1600, 3200, 6400, 12800, 25600,
                     51200)
# ISO 15444-1 Table A.53: max sublevel per mainlevel (reference:
# j2kprofile.cpp:68).
MAX_SUBLEVEL_FROM_MAINLEVEL = (15, 1, 1, 1, 2, 3, 4, 5, 6, 7, 8, 9)
LEVEL_MAX = 11


def get_profile(rsiz: int) -> int:
    return rsiz & 0x0F00


def get_level(rsiz: int) -> int:
    return rsiz & 0xF


def get_imf_sublevel(rsiz: int) -> int:
    return (rsiz >> 4) & 0xF


def broadcast_max_cs_bytes(mainlevel: int, framerate: int) -> int:
    """Frame byte cap from the broadcast level Mbit/s ceiling
    (reference: grk_compress.cpp:1219-1236)."""
    if framerate <= 0 or not (1 <= mainlevel <= LEVEL_MAX):
        return 0
    return int(BROADCAST_MBITS_SEC[mainlevel] * (1000.0 * 1000 / 8)
               / framerate)


def imf_max_cs_bytes(sublevel: int, framerate: int) -> int:
    """Frame byte cap from the IMF sublevel Mbit/s ceiling (reference:
    grk_compress.cpp:1315-1333)."""
    if framerate <= 0 or not (1 <= sublevel <= 9):
        return 0
    return int(IMF_SUB_MBITS_SEC[sublevel] * (1000.0 * 1000 / 8)
               / framerate)


def _msamples_per_sec(image, framerate: int) -> float:
    """Component sampling rate (reference: grk_compress.cpp:2020-2046;
    4:2:0 3-component counts as 2 average components)."""
    avg = len(image.components)
    if avg == 3 and image.components[1].dx == 2 \
            and image.components[1].dy == 2:
        avg = 2
    return image.xsiz * image.ysiz * avg * framerate / 1e6


def _imf_max_nl(profile: int, xtsiz: int) -> int:
    """Max decomposition levels per IMF profile and tile width
    (reference: j2kprofile.cpp get_imf_max_NL:71)."""
    if profile == PROFILE_IMF_2K:
        return 5
    if profile == PROFILE_IMF_4K:
        return 6
    if profile == PROFILE_IMF_8K:
        return 7
    if profile == PROFILE_IMF_2K_R:
        return 5 if xtsiz >= 2048 else (4 if xtsiz >= 1024 else -1)
    if profile == PROFILE_IMF_4K_R:
        if xtsiz >= 4096:
            return 6
        return 5 if xtsiz >= 2048 else (4 if xtsiz >= 1024 else -1)
    if profile == PROFILE_IMF_8K_R:
        if xtsiz >= 8192:
            return 7
        if xtsiz >= 4096:
            return 6
        return 5 if xtsiz >= 2048 else (4 if xtsiz >= 1024 else -1)
    return -1


def is_broadcast_compliant(params: EncoderParams, image, rsiz: int,
                           framerate: int = 0) -> Tuple[bool, Tuple[str, ...]]:
    """Validate broadcast constraints (reference:
    j2kprofile.cpp is_broadcast_compliant:685). Returns
    (compliant, warnings); a non-compliant parameter set still encodes,
    but with rsiz stripped to PROFILE_NONE like the reference."""
    w = []
    profile = get_profile(rsiz)
    mainlevel = get_level(rsiz)
    nl = params.numresolutions - 1
    if mainlevel > LEVEL_MAX:
        w.append(f"broadcast: mainlevel {mainlevel} > {LEVEL_MAX}")
    ncomps = len(image.components)
    if ncomps > 4:
        w.append(f"broadcast: at most 4 components (got {ncomps})")
    if params.image_offset != (0, 0) or params.tile_offset != (0, 0):
        w.append("broadcast: image/tile origin must be 0,0")
    if params.tile_size is not None:
        tx = -(-image.xsiz // params.tile_size[0])
        ty = -(-image.ysiz // params.tile_size[1])
        if (tx, ty) not in ((1, 1), (2, 2), (1, 4)):
            w.append(f"broadcast: tile layout {tx}x{ty} not in "
                     "{1x1, 2x2, 1x4}")
        if profile == PROFILE_BC_SINGLE and (tx, ty) != (1, 1):
            w.append("broadcast SINGLE: requires 1x1 tile layout")
    for i, c in enumerate(image.components):
        if not (8 <= c.prec <= 12) or c.signed:
            w.append(f"broadcast: component {i} must be 8-12 bit "
                     f"unsigned (got {c.prec}{'s' if c.signed else 'u'})")
    if ncomps >= 3:
        if image.components[1].dx != image.components[2].dx or \
                image.components[1].dy != image.components[2].dy:
            w.append("broadcast: components 1 and 2 must share "
                     "subsampling")
    for i, c in enumerate(image.components[:4]):
        if i in (0, 3):
            if c.dx != 1 or c.dy != 1:
                w.append(f"broadcast: component {i} must not subsample")
        elif c.dx > 2 or c.dy > 2:
            w.append(f"broadcast: component {i} subsampling must be <= 2")
    if (params.cblk_w_exp, params.cblk_h_exp) not in \
            ((5, 5), (6, 6), (7, 7)):
        w.append("broadcast: code-block must be 32x32, 64x64 or 128x128")
    if params.progression != Progression.CPRL:
        w.append("broadcast: progression must be CPRL")
    if params.pocs:
        w.append("broadcast: POC markers forbidden")
    if params.cblk_style != 0:
        w.append("broadcast: code-block mode switches forbidden")
    if profile in (PROFILE_BC_SINGLE, PROFILE_BC_MULTI):
        if params.transform != Transform.DWT_97:
            w.append("broadcast single/multi: requires the 9/7 transform")
    elif params.transform != Transform.DWT_53:
        w.append("broadcast multi_r: requires the 5/3 transform")
    if params.numlayers != 1:
        w.append("broadcast: exactly 1 quality layer")
    if not (1 <= nl <= 5):
        w.append(f"broadcast: requires 1 <= NL <= 5 (got {nl})")
    if params.precincts is None:
        w.append("broadcast: precincts (128 LL else 256) required")
    else:
        exps = params.precinct_exps_for(params.numresolutions)
        if any(p != (8, 8) for p in exps[1:]) or \
                exps[0] not in ((7, 7), (8, 8)):
            w.append("broadcast: precincts must be 256x256 (128 for NLLL)")
    if framerate > 0 and 1 <= mainlevel <= LEVEL_MAX:
        ms = _msamples_per_sec(image, framerate)
        if ms > BROADCAST_MSAMPLES_SEC[mainlevel]:
            w.append(f"broadcast: {ms:.1f} Msamples/s exceeds level "
                     f"{mainlevel} ceiling "
                     f"{BROADCAST_MSAMPLES_SEC[mainlevel]}")
    return (not w), tuple(w)


def is_imf_compliant(params: EncoderParams, image, rsiz: int,
                     framerate: int = 0) -> Tuple[bool, Tuple[str, ...]]:
    """Validate IMF constraints (reference:
    j2kprofile.cpp is_imf_compliant:190)."""
    w = []
    profile = get_profile(rsiz)
    mainlevel = get_level(rsiz)
    sublevel = get_imf_sublevel(rsiz)
    nl = params.numresolutions - 1
    xtsiz = params.tile_size[0] if params.tile_size else image.xsiz
    if mainlevel > LEVEL_MAX:
        w.append(f"imf: mainlevel {mainlevel} > {LEVEL_MAX}")
    elif sublevel > MAX_SUBLEVEL_FROM_MAINLEVEL[mainlevel]:
        w.append(f"imf: sublevel {sublevel} > max "
                 f"{MAX_SUBLEVEL_FROM_MAINLEVEL[mainlevel]} for "
                 f"mainlevel {mainlevel}")
    if sublevel > max(mainlevel - 2, 1):
        w.append(f"imf: invalid sublevel {sublevel}")
    ncomps = len(image.components)
    if ncomps > 3:
        w.append(f"imf: at most 3 components (got {ncomps})")
    if params.image_offset != (0, 0) or params.tile_offset != (0, 0):
        w.append("imf: image/tile origin must be 0,0")
    if params.tile_size is not None:
        tdx, tdy = params.tile_size
        if profile in (PROFILE_IMF_2K, PROFILE_IMF_4K, PROFILE_IMF_8K):
            if tdx < image.xsiz or tdy < image.ysiz:
                w.append("imf 2K/4K/8K: tile must cover the image")
        else:
            ok = (tdx >= image.xsiz and tdy >= image.ysiz) \
                or (tdx, tdy) == (1024, 1024) \
                or ((tdx, tdy) == (2048, 2048)
                    and profile in (PROFILE_IMF_4K_R, PROFILE_IMF_8K_R)) \
                or ((tdx, tdy) == (4096, 4096)
                    and profile == PROFILE_IMF_8K_R)
            if not ok:
                w.append("imf _R: tile must cover the image or be "
                         "1024/2048/4096 square per profile")
    for i, c in enumerate(image.components):
        if not (8 <= c.prec <= 16) or c.signed:
            w.append(f"imf: component {i} must be 8-16 bit unsigned")
        if i == 0 and c.dx != 1:
            w.append("imf: XRSiz1 must be 1")
        if i == 1 and c.dx not in (1, 2):
            w.append("imf: XRSiz2 must be 1 or 2")
        if i > 1 and c.dx != image.components[i - 1].dx:
            w.append(f"imf: XRSiz{i + 1} must match XRSiz2")
        if c.dy != 1:
            w.append(f"imf: YRSiz must be 1 (component {i})")
    size_caps = {
        PROFILE_IMF_2K: (2048, 1556), PROFILE_IMF_2K_R: (2048, 1556),
        PROFILE_IMF_4K: (4096, 3112), PROFILE_IMF_4K_R: (4096, 3112),
        PROFILE_IMF_8K: (8192, 6224), PROFILE_IMF_8K_R: (8192, 6224),
    }
    cap = size_caps.get(profile)
    if cap and (image.xsiz > cap[0] or image.ysiz > cap[1]):
        w.append(f"imf: image {image.xsiz}x{image.ysiz} exceeds "
                 f"{cap[0]}x{cap[1]}")
    if params.roi_comp is not None:
        w.append("imf: RGN / region of interest forbidden")
    if (params.cblk_w_exp, params.cblk_h_exp) != (5, 5):
        w.append("imf: code-block must be 32x32")
    if params.progression != Progression.CPRL:
        w.append("imf: progression must be CPRL")
    if params.pocs:
        w.append("imf: POC markers forbidden")
    if params.cblk_style != 0:
        w.append("imf: code-block mode switches forbidden")
    if profile in (PROFILE_IMF_2K, PROFILE_IMF_4K, PROFILE_IMF_8K):
        if params.transform != Transform.DWT_97:
            w.append("imf 2K/4K/8K: requires the 9/7 transform")
    elif params.transform != Transform.DWT_53:
        w.append("imf _R: requires the 5/3 transform")
    if params.numlayers != 1:
        w.append("imf: exactly 1 quality layer")
    max_nl = _imf_max_nl(profile, xtsiz)
    if max_nl >= 0 and not (1 <= nl <= max_nl):
        w.append(f"imf: requires 1 <= NL <= {max_nl} (got {nl})")
    if params.precincts is None:
        w.append("imf: precincts (128 LL else 256) required")
    else:
        exps = params.precinct_exps_for(params.numresolutions)
        if any(p != (8, 8) for p in exps[1:]) or \
                exps[0] not in ((7, 7), (8, 8)):
            w.append("imf: precincts must be 256x256 (128 for NLLL)")
    if framerate > 0 and 1 <= mainlevel <= LEVEL_MAX:
        ms = _msamples_per_sec(image, framerate)
        if ms > IMF_MAIN_MSAMPLES_SEC[mainlevel]:
            w.append(f"imf: {ms:.1f} Msamples/s exceeds mainlevel "
                     f"{mainlevel} ceiling "
                     f"{IMF_MAIN_MSAMPLES_SEC[mainlevel]}")
    return (not w), tuple(w)


@dataclasses.dataclass
class ProfiledParams:
    params: EncoderParams
    rsiz: int
    max_cs_bytes: int = 0       # 0 = no cap
    max_comp_bytes: int = 0
    warnings: Tuple[str, ...] = ()


def apply_cinema(params: EncoderParams, image, fps: int = 24,
                 four_k: bool = False) -> ProfiledParams:
    """Force Digital Cinema 2K/4K constraints (single tile, 32x32
    code-blocks, 9/7, CPRL, 256 precincts, one layer, frame byte cap)."""
    warnings = []
    numres = params.numresolutions
    if four_k:
        numres = min(max(numres, 2), 7)
    elif numres > 6:
        warnings.append("cinema 2K: resolutions clamped to 6")
        numres = 6
    if params.numlayers > 1:
        warnings.append("cinema: layers forced to 1")
    pocs = ()
    if four_k:
        # 4K: two POC volumes — all but the top resolution, then the top
        # (reference: j2kprofile.cpp initialise_4K_poc).
        from .markers import PocEntry
        pocs = (
            PocEntry(rs=0, cs=0, lye=1, re=numres - 1, ce=3,
                     prog=Progression.CPRL),
            PocEntry(rs=numres - 1, cs=0, lye=1, re=numres, ce=3,
                     prog=Progression.CPRL),
        )
    new = dataclasses.replace(
        params,
        tile_size=None,
        tile_offset=(0, 0),
        image_offset=(0, 0),
        cblk_w_exp=5, cblk_h_exp=5,           # 32x32
        cblk_style=0,
        transform=Transform.DWT_97,
        numresolutions=numres,
        numlayers=1,
        rates=(),
        quality_psnr=(),
        progression=Progression.CPRL,
        precincts=tuple((8, 8) for _ in range(numres)),  # 256x256
        pocs=pocs,
        tlm_markers=True,
    )
    cap = CINEMA_24_CS if fps <= 24 else CINEMA_48_CS
    comp_cap = CINEMA_24_COMP if fps <= 24 else CINEMA_48_COMP
    return ProfiledParams(
        params=new,
        rsiz=PROFILE_CINEMA_4K if four_k else PROFILE_CINEMA_2K,
        max_cs_bytes=cap,
        max_comp_bytes=comp_cap,
        warnings=tuple(warnings),
    )


def apply_broadcast(params: EncoderParams, image, level: int = 1,
                    multi: bool = False, reversible_multi: bool = False,
                    framerate: int = 0) -> ProfiledParams:
    """Broadcast profile (reference: j2kprofile.cpp
    set_broadcast_parameters:644 + is_broadcast_compliant:685): forces
    CPRL, per-component tile-parts, precincts, the profile's transform
    and a framerate-derived frame byte cap; then VALIDATES — a
    non-compliant combination still encodes, with rsiz stripped to
    PROFILE_NONE and warnings, matching the reference."""
    if reversible_multi:
        base = PROFILE_BC_MULTI_R
        transform = Transform.DWT_53
    else:
        base = PROFILE_BC_MULTI if multi else PROFILE_BC_SINGLE
        transform = Transform.DWT_97
    numres = min(max(params.numresolutions, 2), 6)
    new = dataclasses.replace(
        params,
        cblk_w_exp=5, cblk_h_exp=5,
        cblk_style=0,
        numresolutions=numres,
        numlayers=1,
        rates=params.rates[:1],
        quality_psnr=(),
        progression=Progression.CPRL,
        transform=transform,
        tp_flag="C",
        tile_offset=(0, 0),
        image_offset=(0, 0),
        precincts=tuple((8, 8) for _ in range(numres)),
        pocs=(),
    )
    rsiz = base | (level & 0xF)
    ok, warnings = is_broadcast_compliant(new, image, rsiz, framerate)
    if not ok:
        rsiz = PROFILE_NONE
        warnings = warnings + (
            "non-compliant: Non-broadcast codestream will be generated",)
    return ProfiledParams(
        params=new, rsiz=rsiz,
        max_cs_bytes=broadcast_max_cs_bytes(level, framerate),
        warnings=warnings)


def apply_imf(params: EncoderParams, image, variant: str = "2k",
              mainlevel: int = 1, sublevel: int = 1,
              framerate: int = 0) -> ProfiledParams:
    """IMF profile (reference: j2kprofile.cpp set_imf_parameters:121 +
    is_imf_compliant:190): single tile (or _R tile grid), 32x32 blocks,
    CPRL, precincts, the profile's transform and a sublevel/framerate
    frame byte cap; then VALIDATES like the reference (warn + strip rsiz
    on non-compliance). variant: 2k/4k/8k[_r]."""
    v = variant.lower()
    base = {"2k": PROFILE_IMF_2K, "4k": PROFILE_IMF_4K,
            "8k": PROFILE_IMF_8K, "2k_r": PROFILE_IMF_2K_R,
            "4k_r": PROFILE_IMF_4K_R, "8k_r": PROFILE_IMF_8K_R}[v]
    xtsiz = params.tile_size[0] if params.tile_size else image.xsiz
    max_nl = _imf_max_nl(base, xtsiz)
    numres = params.numresolutions
    if max_nl >= 0:
        numres = min(numres, max_nl + 1)
    reversible = v.endswith("_r")
    new = dataclasses.replace(
        params,
        tile_size=params.tile_size if reversible else None,
        tile_offset=(0, 0),
        image_offset=(0, 0),
        cblk_w_exp=5, cblk_h_exp=5,
        cblk_style=0,
        numresolutions=numres,
        numlayers=1,
        quality_psnr=(),
        progression=Progression.CPRL,
        transform=Transform.DWT_53 if reversible else Transform.DWT_97,
        tp_flag="C",
        precincts=tuple((8, 8) for _ in range(numres)),
        pocs=(),
    )
    rsiz = base | (mainlevel & 0xF) | ((sublevel & 0xF) << 4)
    ok, warnings = is_imf_compliant(new, image, rsiz, framerate)
    if not ok:
        rsiz = PROFILE_NONE
        warnings = warnings + (
            "non-compliant: Non-IMF codestream will be generated",)
    return ProfiledParams(
        params=new, rsiz=rsiz,
        max_cs_bytes=imf_max_cs_bytes(sublevel, framerate),
        warnings=warnings)


def profile_allocator(profiled: ProfiledParams):
    """The PCRD allocator of the profile's byte caps, or None without a
    frame cap: the codestream budget less a conservative 1 KiB for the
    headers, and the per-component packet cap (cinema)."""
    from .pcrd import PCRDAllocator

    if not profiled.max_cs_bytes:
        return None
    budget = max(1, profiled.max_cs_bytes - 1024)
    return PCRDAllocator(
        rates=(1.0,), image_bytes=budget,
        max_abs_bytes=budget,
        max_comp_bytes=profiled.max_comp_bytes)


def encode_with_profile(image, profiled: ProfiledParams,
                        device="cuda") -> bytes:
    """Encode one frame applying the profile's rsiz and byte caps, through
    the fused batch encode on `device` (`encoder.encode_batch`): the
    transform, quantization, MQ coding and per-pass R-D tables on the
    device, the profile's PCRD caps (`profile_allocator`) enforced by the
    host allocator, as the reference's `encode_with_profile(...,
    device=True)`."""
    from . import encoder as enc_mod

    return enc_mod.encode_batch(
        [image], profiled.params, device=device, rsiz=profiled.rsiz,
        layer_alloc=profile_allocator(profiled))[0]
