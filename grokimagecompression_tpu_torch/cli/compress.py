"""grk_compress-compatible encoder CLI.

Flag set mirrors the reference CLI's core options (reference:
src/bin/jp2/grk_compress.cpp main:1702): -i/-o, -r rates, -q PSNR layers,
-n resolutions, -b code-block size, -c precincts, -t tiles, -p progression,
-I irreversible 9/7, -S/-E SOP/EPH, -M mode switches, -H threads, -d/-T
offsets. Run as `python -m grokimagecompression_tpu_torch.cli.compress`.

A copy of `grokimagecompression_tpu/cli/compress.py` over the port's
`encoder.encode` and `profiles.encode_with_profile`, which run on the
CUDA card by default (`--torch-device` names another torch device; the
CPU runs the kernels' plain versions). `-D` is accepted and changes
nothing. `-H` is accepted and unused (the host Tier-1 coders take
`os.cpu_count()` worker threads). `-R` (ROI, MQ) and `-m` / `-Y 2` (a
custom MCT) code on the card like any other request; an MQ `-M` other
than 0 and `--ht-refinement` (with `-M 64`) code on the host library's
Tier-1 coders behind the card's transform, as the reference codes them
on its host. A request the port does not code would end through
`common.fail` with the reason and write no file; `-R` with the HT coder
ends with the reference's error.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

from ..core.params import EncoderParams, Progression, Transform
from ..codestream import encoder
from ..utils.device import resolve_device
from . import common


def _parse_pair(s: str, flag: str):
    parts = s.replace("x", ",").split(",")
    if len(parts) != 2:
        common.fail(f"{flag} expects two comma-separated integers, got {s!r}")
    return int(parts[0]), int(parts[1])


def _parse_precincts(s: str):
    # "[256,256],[128,128]" or "256,256" — highest resolution first.
    out = []
    for chunk in s.replace("][", "|").strip("[]").split("|"):
        w, h = _parse_pair(chunk.strip("[]"), "-c")
        out.append((w.bit_length() - 1, h.bit_length() - 1))
    return out


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="grk_compress",
        description="JPEG 2000 encoder on a CUDA card (Grok-compatible "
                    "CLI)")
    p.add_argument("-i", "--in-file")
    p.add_argument("-o", "--out-file")
    p.add_argument("-y", "--img-dir", default=None,
                   help="encode every image in this directory (-O required)")
    p.add_argument("-O", "--out-format", default=None,
                   choices=["J2K", "J2C", "JP2", "j2k", "j2c", "jp2"],
                   help="output format for -y directory mode")
    p.add_argument("-a", "--out-dir", default=None,
                   help="output directory (with -y)")
    p.add_argument("-K", "--in-format", default=None,
                   help="input format override (extension without dot)")
    p.add_argument("-r", "--compression-ratios",
                   help="layer compression ratios, e.g. 20,10,1")
    p.add_argument("-q", "--quality", help="layer PSNR targets in dB")
    p.add_argument("-n", "--resolutions", type=int, default=6)
    p.add_argument("-b", "--code-block-dims", default="64,64")
    p.add_argument("-c", "--precinct-dims",
                   help="precinct sizes, e.g. [256,256],[128,128]")
    p.add_argument("-t", "--tile-dims", help="tile size WxH, e.g. 512,512")
    p.add_argument("-p", "--progression-order", default="LRCP",
                   choices=[p.name for p in Progression])
    p.add_argument("-I", "--irreversible", action="store_true",
                   help="9/7 irreversible transform (default 5/3 lossless)")
    p.add_argument("-S", "--sop", action="store_true", help="SOP markers")
    p.add_argument("-E", "--eph", action="store_true", help="EPH markers")
    p.add_argument("-M", "--mode", type=int, default=0,
                   help="code-block style switches (1=LAZY 2=RESET 4=TERMALL"
                        " 8=VSC 16=PTERM 32=SEGSYM 64=HT)")
    p.add_argument("--ht-refinement", action="store_true",
                   help="HT full mode: code SigProp+MagRef refinement "
                        "passes in a second codeword segment (requires "
                        "-M 64, no rate control)")
    p.add_argument("-d", "--image-offset", help="image origin x,y")
    p.add_argument("-T", "--tile-offset", help="tile grid origin x,y")
    p.add_argument("-G", "--guard-bits", type=int, default=2)
    p.add_argument("-H", "--num-workers", type=int, default=0,
                   help="accepted for the reference's command lines; "
                        "unused (no host T1)")
    p.add_argument("-C", "--comment", default=None)
    p.add_argument("-D", "--device", action="store_true",
                   help="accepted for the reference's command lines; the "
                        "encode runs on --torch-device already")
    p.add_argument("--torch-device", default="cuda",
                   help="torch device of the encode (default cuda; cpu "
                        "runs the kernels' plain versions)")
    p.add_argument("--rate-alloc", choices=["tile", "global"],
                   default="tile",
                   help="PCRD scope: 'tile' splits -r/-q targets "
                        "proportionally per tile (reference semantics); "
                        "'global' bisects one image-wide slope threshold "
                        "(better R-D when tile complexity varies)")
    p.add_argument("--cinema2k", type=int, choices=[24, 48], default=None,
                   help="Digital Cinema 2K profile at the given fps")
    p.add_argument("--cinema4k", action="store_true",
                   help="Digital Cinema 4K profile (24 fps)")
    p.add_argument("--imf", default=None, metavar="SPEC",
                   help="IMF profile: 2k/4k/8k/2k_r/4k_r/8k_r"
                        "[,mainlevel=X][,sublevel=Y][,framerate=FPS] "
                        "(reference -z)")
    p.add_argument("--broadcast", default=None, metavar="SPEC",
                   help="Broadcast profile: LEVEL[,multi|,multi_r]"
                        "[,framerate=FPS] (reference -U)")
    p.add_argument("-Q", "--capture-res", default=None, metavar="X,Y",
                   help="capture resolution in pixels/metre (JP2 resc)")
    p.add_argument("--display-res", default=None, metavar="X,Y",
                   help="display resolution in pixels/metre (JP2 resd)")
    p.add_argument("-F", "--raw", default=None, metavar="DESC",
                   help="raw image description w,h,ncomps,prec,[s|u]"
                        "[@dxxdy:...] (reference -F)")
    p.add_argument("-P", "--poc", default=None,
                   help="progression order changes, e.g. "
                        "T1=0,0,1,5,3,CPRL/T1=5,0,1,6,3,CPRL")
    p.add_argument("-u", "--tp", default=None, choices=["R", "L", "C"],
                   help="divide each tile into tile-parts by resolution, "
                        "layer, or component")
    p.add_argument("-R", "--roi", default=None, metavar="c=N,U=S",
                   help="component-of-interest upshift (RGN marker)")
    p.add_argument("-Y", "--mct", type=int, default=None, choices=[0, 1, 2],
                   help="0: no MCT; 1: RGB->YCC; 2: custom (needs -m)")
    p.add_argument("-m", "--custom-mct", default=None, metavar="FILE",
                   help="file of comma-separated decode-matrix values "
                        "(ncomps x ncomps); implies -Y 2")
    p.add_argument("-Z", "--rsiz", type=lambda v: int(v, 0), default=0,
                   help="explicit Rsiz profile/capability value")
    p.add_argument("-A", "--rate-control-algorithm", type=int, default=1,
                   choices=[0, 1],
                   help="rate control: both map to feasible-truncation "
                        "bisection on the convex hull")
    p.add_argument("-W", "--logfile", default=None,
                   help="append warnings/errors to this file")
    p.add_argument("-e", "--repetitions", type=int, default=1,
                   help="encode this many times (0 = unlimited; for "
                        "throughput measurement, like the reference -e)")
    p.add_argument("-v", "--verbose", action="store_true")
    return p


def _parse_poc(spec: str, default_layers: int):
    from ..codestream.markers import PocEntry
    out = []
    for part in spec.split("/"):
        part = part.strip()
        if "=" in part:
            part = part.split("=", 1)[1]   # strip T<tile>= prefix
        f = part.split(",")
        if len(f) != 6:
            common.fail(f"-P entry needs 6 fields, got {part!r}")
        out.append(PocEntry(rs=int(f[0]), cs=int(f[1]), lye=int(f[2]),
                            re=int(f[3]), ce=int(f[4]),
                            prog=Progression[f[5]]))
    return tuple(out)


def _parse_roi(spec: str):
    comp = shift = None
    for kv in spec.split(","):
        k, _, v = kv.partition("=")
        if k.strip().lower() == "c":
            comp = int(v)
        elif k.strip().upper() == "U":
            shift = int(v)
    if comp is None or shift is None:
        common.fail(f"-R expects c=<comp>,U=<shift>, got {spec!r}")
    return comp, shift


def _read_mct_file(path: str):
    txt = open(path).read().replace("\n", ",")
    vals = [float(v) for v in txt.split(",") if v.strip()]
    import math
    n = int(math.isqrt(len(vals)))
    if n * n != len(vals):
        common.fail(f"-m file must hold a square matrix, got {len(vals)} "
                    "values")
    return [vals[i * n:(i + 1) * n] for i in range(n)]


def main(argv=None) -> int:
    try:
        return _main(argv)
    except NotImplementedError as e:
        common.fail(str(e))


def _main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    if args.img_dir:
        # Directory batch mode (reference -ImgDir/-OutFor/-OutDir).
        if not args.out_format:
            common.fail("-y/--img-dir requires -O/--out-format")
        out_dir = args.out_dir or args.img_dir
        os.makedirs(out_dir, exist_ok=True)
        ext = "." + args.out_format.lower().replace("j2c", "j2k")
        rc = 0
        for name in sorted(os.listdir(args.img_dir)):
            src = os.path.join(args.img_dir, name)
            if not os.path.isfile(src):
                continue
            stem, sfx = os.path.splitext(name)
            if args.in_format and sfx.lstrip(".").lower() \
                    != args.in_format.lower():
                continue
            dst = os.path.join(out_dir, stem + ext)
            sub = [a for a in (argv if argv is not None else sys.argv[1:])]
            # Re-run single-file mode with -i/-o substituted.
            filtered = []
            skip = False
            for i, a in enumerate(sub):
                if skip:
                    skip = False
                    continue
                if a in ("-y", "--img-dir", "-O", "--out-format", "-a",
                         "--out-dir", "-K", "--in-format"):
                    skip = True
                    continue
                filtered.append(a)
            try:
                rc |= main(filtered + ["-i", src, "-o", dst])
            except SystemExit as e:
                print(f"error encoding {src}: {e}", file=sys.stderr)
                rc = 1
        return rc

    if not args.in_file or not args.out_file:
        common.fail("-i and -o are required (or use -y directory mode)")
    try:
        dev = resolve_device(args.torch_device)
    except (RuntimeError, ValueError) as e:
        common.fail(str(e))
    image = common.read_image(args.in_file, raw_desc=args.raw,
                              force_format=args.in_format)

    rates = tuple(float(r) for r in args.compression_ratios.split(",")) \
        if args.compression_ratios else ()
    quality = tuple(float(q) for q in args.quality.split(",")) \
        if args.quality else ()
    cb_w, cb_h = _parse_pair(args.code_block_dims, "-b")
    params = EncoderParams(
        numresolutions=args.resolutions,
        cblk_w_exp=cb_w.bit_length() - 1,
        cblk_h_exp=cb_h.bit_length() - 1,
        cblk_style=args.mode,
        ht_refinement=args.ht_refinement,
        transform=Transform.DWT_97 if args.irreversible else Transform.DWT_53,
        progression=Progression[args.progression_order],
        numlayers=max(1, len(rates), len(quality)),
        rates=rates,
        quality_psnr=quality,
        rate_alloc=args.rate_alloc,
        precincts=_parse_precincts(args.precinct_dims)
        if args.precinct_dims else None,
        tile_size=_parse_pair(args.tile_dims, "-t") if args.tile_dims else None,
        image_offset=_parse_pair(args.image_offset, "-d")
        if args.image_offset else (0, 0),
        tile_offset=_parse_pair(args.tile_offset, "-T")
        if args.tile_offset else (0, 0),
        num_guard_bits=args.guard_bits,
        sop_markers=args.sop,
        eph_markers=args.eph,
        comment=args.comment,
        pocs=_parse_poc(args.poc, max(1, len(rates), len(quality)))
        if args.poc else (),
        tp_flag=args.tp,
        roi_comp=_parse_roi(args.roi)[0] if args.roi else None,
        roi_shift=_parse_roi(args.roi)[1] if args.roi else 0,
    )
    if args.custom_mct:
        import dataclasses as _dc
        params = _dc.replace(params, custom_mct=_read_mct_file(
            args.custom_mct), transform=Transform.DWT_97)
    elif args.mct is not None:
        if args.mct == 2:
            common.fail("-Y 2 (custom MCT) requires -m <matrix file>")
        import dataclasses as _dc
        from ..core.params import MCT as _MCT
        params = _dc.replace(params, mct=_MCT(args.mct))
    if args.logfile:
        class _Tee:
            def __init__(self, path, orig):
                self.f = open(path, "a")
                self.orig = orig
            def write(self, t):
                self.f.write(t)
                self.orig.write(t)
            def flush(self):
                self.f.flush()
                self.orig.flush()
        sys.stderr = _Tee(args.logfile, sys.stderr)
    reps = args.repetitions if args.repetitions > 0 else (1 << 30)
    t0 = time.perf_counter()
    for _rep in range(max(1, reps) - 1):
        # extra repetitions: timing only, result discarded
        if args.cinema2k or args.cinema4k or args.imf or args.broadcast:
            break
        encoder.encode(image, params, device=dev, rsiz=args.rsiz)
        if time.perf_counter() - t0 > 3600:
            break
    if args.cinema2k or args.cinema4k or args.imf or args.broadcast:
        from ..codestream import profiles
        if args.cinema2k or args.cinema4k:
            prof = profiles.apply_cinema(params, image,
                                         fps=args.cinema2k or 24,
                                         four_k=args.cinema4k)
        elif args.imf:
            parts = args.imf.split(",")
            kw = {"variant": parts[0]}
            for t in parts[1:]:
                k, _, v = t.partition("=")
                if k in ("mainlevel", "sublevel", "framerate"):
                    kw[k] = int(v)
            prof = profiles.apply_imf(params, image, **kw)
        else:
            parts = str(args.broadcast).split(",")
            kw = {"level": int(parts[0])}
            for t in parts[1:]:
                if t == "multi":
                    kw["multi"] = True
                elif t == "multi_r":
                    kw["reversible_multi"] = True
                elif t.startswith("framerate="):
                    kw["framerate"] = int(t.split("=")[1])
            prof = profiles.apply_broadcast(params, image, **kw)
        for w in prof.warnings:
            print(f"warning: {w}", file=sys.stderr)
        cs = profiles.encode_with_profile(image, prof, device=dev)
    else:
        cs = encoder.encode(image, params, device=dev, rsiz=args.rsiz)
    dt = time.perf_counter() - t0
    if args.out_file.lower().endswith(".jp2"):
        from ..codestream import jp2

        def _parse_res(v):
            if not v:
                return None
            x, y = (float(t) for t in v.split(","))
            return (x, y)

        cdefs = None
        if any(getattr(c, "alpha", False) for c in image.components):
            ncolor = sum(1 for c in image.components
                         if not getattr(c, "alpha", False))
            cdefs = []
            ci = 0
            for i, c in enumerate(image.components):
                if getattr(c, "alpha", False):
                    cdefs.append((i, 1, 0))      # opacity, whole image
                else:
                    ci += 1
                    cdefs.append((i, 0, ci))     # color, 1-based assoc
        cs = jp2.wrap_codestream(
            cs, image.xsiz, image.ysiz,
            [(c.prec, c.signed) for c in image.components],
            capture_resolution=_parse_res(args.capture_res),
            display_resolution=_parse_res(args.display_res),
            channel_defs=cdefs)
    with open(args.out_file, "wb") as f:
        f.write(cs)
    if args.verbose:
        px = image.xsiz * image.ysiz
        print(f"encoded {px} px -> {len(cs)} bytes in {dt*1000:.1f} ms "
              f"({px/dt/1e6:.2f} MP/s)", file=sys.stderr)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
