"""grk_decompress-compatible decoder CLI.

Mirrors the reference decoder CLI's core options (reference:
src/bin/jp2/grk_decompress.cpp main:1122): -i/-o, -r reduce, -l layers,
-d decode window, -t tile index. Run as
`python -m grokimagecompression_tpu_torch.cli.decompress`.

A copy of `grokimagecompression_tpu/cli/decompress.py` over the port's
`decoder.decode`, which runs on the CUDA card by default
(`--torch-device` names another torch device; the CPU runs the kernels'
plain versions), and the port's `io/color.py` and `io/icc.py` for the
colour policy (host numpy, as in the reference). `-H` is accepted and
unused. Streams with tile-part header overrides, ROI, a custom MCT or
COCs that change a component's transform, resolutions or block coder
decode on the card like any other; MQ styles other than 0, HT
refinement passes and HT bands whose Mb + 3 exceeds 32 decode on the
host library's Tier-1 decoders behind the card's inverse transforms. A
stream the port does not decode (ROI on HT code-blocks) ends through
`common.fail` with the reason and writes no file.
"""

from __future__ import annotations

import argparse
import sys
import time

from ..core.params import DecoderParams
from ..codestream import decoder
from ..utils.device import resolve_device
from . import common


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="grk_decompress",
        description="JPEG 2000 decoder on a CUDA card (Grok-compatible "
                    "CLI)")
    p.add_argument("-i", "--in-file")
    p.add_argument("-o", "--out-file")
    p.add_argument("-y", "--img-dir", default=None,
                   help="decode every .j2k/.jp2 in this directory")
    p.add_argument("-a", "--out-dir", default=None,
                   help="output directory (with -y)")
    p.add_argument("-O", "--out-format", default="ppm",
                   help="output extension for -y directory mode")
    p.add_argument("-r", "--reduce", type=int, default=0,
                   help="discard this many highest resolution levels")
    p.add_argument("-l", "--layers", type=int, default=0,
                   help="decode only the first N quality layers (0 = all)")
    p.add_argument("-d", "--decode-window",
                   help="window x0,y0,x1,y1 in canvas coordinates")
    p.add_argument("-t", "--tile", type=int, default=None,
                   help="decode a single tile by index")
    p.add_argument("--force-rgb", action="store_true",
                   help="convert grayscale output to RGB")
    p.add_argument("--upsample", action="store_true",
                   help="replicate subsampled components to the full grid")
    p.add_argument("--no-color", action="store_true",
                   help="skip automatic sYCC/eYCC/CMYK -> RGB conversion")
    p.add_argument("--split-pnm", action="store_true",
                   help="write each component to its own PGM file "
                        "(out_0.pgm, out_1.pgm, ...)")
    p.add_argument("-p", "--precision", default=None,
                   help="force component precisions, e.g. 8C,10S "
                        "(C = clip, S = scale; last value repeats)")
    p.add_argument("-H", "--num-workers", type=int, default=0,
                   help="accepted for the reference's command lines; "
                        "unused (no host T1)")
    p.add_argument("-c", "--compression", type=int, default=0,
                   help="output compression: 8 = zip for TIFF output")
    p.add_argument("-X", "--xml", action="store_true",
                   help="write JP2 XML metadata next to the output file")
    p.add_argument("--torch-device", default="cuda",
                   help="torch device of the decode (default cuda; cpu "
                        "runs the kernels' plain versions)")
    p.add_argument("-v", "--verbose", action="store_true")
    return p


def _parse_precision(spec: str):
    out = []
    for tok in spec.split(","):
        tok = tok.strip()
        mode = "C"
        if tok and tok[-1] in "CScs":
            mode = tok[-1].upper()
            tok = tok[:-1]
        out.append((int(tok), mode))
    return out


def _force_precision(image, spec):
    """Clip or scale components to the requested bit depths (reference:
    grk_decompress.cpp precision option)."""
    import dataclasses
    import numpy as np
    plist = _parse_precision(spec)
    comps = []
    for ci, comp in enumerate(image.components):
        prec, mode = plist[min(ci, len(plist) - 1)]
        if prec == 0 or prec == comp.prec:
            comps.append(comp)
            continue
        a = comp.data.astype(np.int64)
        if mode == "S":
            if prec > comp.prec:
                a = a << (prec - comp.prec)
            else:
                a = a >> (comp.prec - prec)
        if comp.signed:
            lo, hi = -(1 << (prec - 1)), (1 << (prec - 1)) - 1
        else:
            lo, hi = 0, (1 << prec) - 1
        a = np.clip(a, lo, hi).astype(np.int32)
        comps.append(dataclasses.replace(comp, data=a, prec=prec))
    return dataclasses.replace(image, components=comps)


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    import os as _os
    if args.img_dir:
        out_dir = args.out_dir or args.img_dir
        _os.makedirs(out_dir, exist_ok=True)
        rc = 0
        base_argv = list(argv if argv is not None else sys.argv[1:])
        filtered = []
        skip = False
        for a in base_argv:
            if skip:
                skip = False
                continue
            if a in ("-y", "--img-dir", "-a", "--out-dir", "-O",
                     "--out-format"):
                skip = True
                continue
            filtered.append(a)
        for name in sorted(_os.listdir(args.img_dir)):
            if not name.lower().endswith((".j2k", ".j2c", ".jp2", ".jph")):
                continue
            src = _os.path.join(args.img_dir, name)
            dst = _os.path.join(out_dir, _os.path.splitext(name)[0]
                                + "." + args.out_format.lstrip("."))
            try:
                rc |= main(filtered + ["-i", src, "-o", dst])
            except SystemExit as e:
                print(f"error decoding {src}: {e}", file=sys.stderr)
                rc = 1
        return rc
    if not args.in_file or not args.out_file:
        common.fail("-i and -o are required (or use -y directory mode)")
    try:
        dev = resolve_device(args.torch_device)
    except (RuntimeError, ValueError) as e:
        common.fail(str(e))
    with open(args.in_file, "rb") as f:
        data = f.read()
    window = None
    if args.decode_window:
        parts = [int(v) for v in args.decode_window.split(",")]
        if len(parts) != 4:
            common.fail("-d expects x0,y0,x1,y1")
        window = tuple(parts)
    params = DecoderParams(reduce=args.reduce, layers=args.layers,
                           window=window, tile_index=args.tile)
    t0 = time.perf_counter()
    try:
        image = decoder.decode(data, params, device=dev)
    except NotImplementedError as e:
        common.fail(str(e))
    dt = time.perf_counter() - t0
    # Post-decode color policy (reference: grk_decompress.cpp:1585-1622).
    from ..codestream import jp2 as _jp2
    from ..io import color as _color
    cs = None
    icc_profile = None
    if _jp2.is_jp2(data):
        hdr, _ = _jp2.read_jp2(data)
        cs = hdr.colourspace
        icc_profile = hdr.icc_profile
        if hdr.palette is not None and not args.no_color:
            image = _jp2.apply_palette(image, hdr)
        if hdr.channel_defs:
            import dataclasses as _dc
            comps = list(image.components)
            for (cn, typ, asoc) in hdr.channel_defs:
                if typ == 1 and cn < len(comps):
                    comps[cn] = _dc.replace(comps[cn], alpha=True)
            image = _dc.replace(image, components=comps)
    if icc_profile and not args.no_color:
        # Embedded ICC (JP2 colr meth=2): matrix-shaper profiles convert
        # to sRGB here (reference: color_apply_icc_profile via lcms);
        # LUT-based profiles pass through untouched.
        from ..io import icc as _icc
        converted = _icc.apply_icc(image, icc_profile)
        if converted is not None:
            image = converted
    if args.upsample:
        image = _color.upsample(image)
    if cs == 14 and not args.no_color:
        # CIELab (JP2 enumcs 14) -> sRGB
        hdr3, _ = _jp2.read_jp2(data)
        image = _color.cielab_to_rgb(image, hdr3.cielab)
    elif not args.no_color:
        image = _color.apply_color(image, colourspace=cs,
                                   force_rgb=args.force_rgb)
    elif args.force_rgb and len(image.components) < 3:
        image = _color.gray_to_rgb(image)
    if args.precision:
        image = _force_precision(image, args.precision)
    if args.xml and _jp2.is_jp2(data):
        hdr2, _ = _jp2.read_jp2(data)
        if getattr(hdr2, "xml", None):
            with open(args.out_file + ".xml", "wb") as xf:
                xf.write(b"".join(hdr2.xml))
    if args.split_pnm:
        import os as _os
        from ..core.image import Image as _Image
        base, ext = _os.path.splitext(args.out_file)
        for ci, comp in enumerate(image.components):
            common.write_image(
                f"{base}_{ci}.pgm",
                _Image(x0=image.x0, y0=image.y0, xsiz=image.xsiz,
                       ysiz=image.ysiz, components=[comp]))
    elif args.compression == 8 and args.out_file.lower().endswith(
            (".tif", ".tiff")):
        from ..io import tiff as _tiff
        _tiff.write_tiff(args.out_file, image, compression=8)
    else:
        common.write_image(args.out_file, image)
    if args.verbose:
        c0 = image.components[0].data
        print(f"decoded {len(data)} bytes -> {c0.shape[1]}x{c0.shape[0]}"
              f"x{len(image.components)} in {dt*1000:.1f} ms", file=sys.stderr)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
