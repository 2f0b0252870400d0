"""Coding parameters — the TPU-native analog of ``grk_cparameters`` /
``grk_dparameters`` (reference: src/lib/jp2/grok.h:447-570, 694-735) and the
per-tile/per-component coding style records (tcp/tccp).

Defaults mirror ``grk_set_default_encoder_parameters``
(reference: src/lib/jp2/grok.h:1488 semantics): lossless 5/3, single tile,
64x64 code-blocks, 6 resolutions, LRCP, maximal precincts, 1 layer.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Optional, Sequence, Tuple


class Progression(enum.IntEnum):
    """Progression orders, wire values per COD SGcod (Table A.16)."""

    LRCP = 0
    RLCP = 1
    RPCL = 2
    PCRL = 3
    CPRL = 4


class Transform(enum.IntEnum):
    """SPcod transform field: 0 = irreversible 9/7, 1 = reversible 5/3."""

    DWT_97 = 0
    DWT_53 = 1


class QuantStyle(enum.IntEnum):
    """Sqcd/Sqcc quantization style (Table A.28)."""

    NONE = 0  # reversible: exponents only
    SCALAR_DERIVED = 1
    SCALAR_EXPOUNDED = 2


class MCT(enum.IntEnum):
    """SGcod multiple-component-transform field."""

    NONE = 0
    RCT_OR_ICT = 1  # RCT when 5/3, ICT when 9/7


# Code-block style bits (SPcod, Table A.19); values match the codestream.
CBLKSTY_LAZY = 0x01      # selective arithmetic-coding bypass
CBLKSTY_RESET = 0x02     # reset context probabilities between passes
CBLKSTY_TERMALL = 0x04   # terminate after every pass
CBLKSTY_VSC = 0x08       # vertically stripe-causal context formation
CBLKSTY_PTERM = 0x10     # predictable termination
CBLKSTY_SEGSYM = 0x20    # segmentation symbols
CBLKSTY_HT = 0x40        # Part-15 high-throughput block coder


@dataclasses.dataclass
class EncoderParams:
    """Encode-side parameters (subset of grk_cparameters, growing per round)."""

    # Tile grid: None => single tile covering the image.
    tile_size: Optional[Tuple[int, int]] = None  # (XTsiz, YTsiz)
    tile_offset: Tuple[int, int] = (0, 0)        # (XTOsiz, YTOsiz)
    image_offset: Tuple[int, int] = (0, 0)       # (XOsiz, YOsiz)

    numresolutions: int = 6
    cblk_w_exp: int = 6  # 64
    cblk_h_exp: int = 6  # 64
    cblk_style: int = 0
    transform: Transform = Transform.DWT_53
    mct: Optional[MCT] = None  # None = auto (RCT/ICT if 3+ components)
    progression: Progression = Progression.LRCP
    numlayers: int = 1
    # Per-layer target rates as compression ratios (like -r); 0 = lossless /
    # no constraint for that layer. Mutually exclusive with `quality_psnr`.
    rates: Tuple[float, ...] = ()
    # Per-layer target PSNR in dB (like -q); 0 on the last layer = lossless.
    quality_psnr: Tuple[float, ...] = ()
    # Precinct exponents (PPx, PPy) listed from *highest* resolution down,
    # like the -c CLI flag; None = maximal (15,15) everywhere.
    precincts: Optional[Sequence[Tuple[int, int]]] = None
    num_guard_bits: int = 2
    sop_markers: bool = False
    eph_markers: bool = False
    # Base quantization step for 9/7 (scalar expounded derivation).
    base_step: float = 0.0  # 0 => derived from bit depth
    comment: Optional[str] = "grokimagecompression_tpu"
    # Progression order changes: tuple of markers.PocEntry.
    pocs: Tuple = ()
    # Write a TLM (tile-part lengths) marker in the main header.
    tlm_markers: bool = False
    # Per-component code-block exponent overrides {compno: (wexp, hexp)}
    # signalled via COC markers.
    comp_cblk_exps: Optional[dict] = None
    # ROI: upshift this component's quantization indices (RGN marker,
    # maxshift-style 'component of interest' like the reference -R flag).
    roi_comp: Optional[int] = None
    roi_shift: int = 0
    # Packed packet headers: PPT (tile-part) or PPM (main header); PLT
    # writes per-tile packet-length markers for fast seeking.
    ppt_markers: bool = False
    ppm_markers: bool = False
    plt_markers: bool = False
    # HT refinement passes (Part 15 full mode): code the cleanup one
    # plane up and carry SigProp+MagRef for the dropped plane in a
    # second codeword segment (3 passes per block on the wire).  A
    # quality-scalability tool: NOT guaranteed lossless even with the
    # 5/3 transform (an isolated magnitude-1 coefficient has no SigProp
    # candidate slot; the reference's own full decoder drops it the
    # same way).  Requires cblk_style 0x40 and no rate control.
    ht_refinement: bool = False
    # Tile-part generation: split each tile into tile-parts at changes of
    # the given progression coordinate ("R" resolution, "L" layer,
    # "C" component) — the reference's tp_on/tp_flag (grok.h:532-534).
    tp_flag: Optional[str] = None
    # Part-2 custom MCT: the DECODING matrix (ncomps x ncomps) — what the
    # codestream MCT record carries; the encoder applies its inverse.
    # (The reference -m file instead holds the CODING matrix and derives
    # the decode matrix by LUP inversion, j2k.cpp:1931.) 9/7 only.
    custom_mct: Optional[object] = None
    # Rate allocation scope: "tile" splits each byte/PSNR target
    # proportionally per tile (the reference's per-tile PCRD,
    # TileProcessor.cpp:371); "global" bisects ONE image-wide slope
    # threshold across all tiles (textbook PCRD-opt — better R-D when
    # tile complexity varies; with a mesh the byte totals reduce via a
    # psum collective, the multi-host allocation form).
    rate_alloc: str = "tile"

    def precinct_exps_for(self, numresolutions: int) -> Tuple[Tuple[int, int], ...]:
        """Resolve per-resolution (PPx, PPy), indexed by r = 0..NL.

        The user list is given from the highest resolution downward (CLI -c
        convention); the last entry repeats for any remaining lower
        resolutions.
        """
        if self.precincts is None:
            return tuple((15, 15) for _ in range(numresolutions))
        user = list(self.precincts)
        out = []
        for r in range(numresolutions):
            # r runs low->high; user list runs high->low.
            idx = numresolutions - 1 - r
            if idx < len(user):
                out.append(tuple(user[idx]))
            else:
                out.append(tuple(user[-1]))
        return tuple(out)


@dataclasses.dataclass
class DecoderParams:
    """Decode-side parameters (subset of grk_dparameters)."""

    reduce: int = 0          # discard this many highest resolution levels
    layers: int = 0          # 0 = all layers
    # Decode window in canvas coordinates; None = full image.
    window: Optional[Tuple[int, int, int, int]] = None
    tile_index: Optional[int] = None
