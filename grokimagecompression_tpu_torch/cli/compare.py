"""Image comparison tool — the analog of the reference's conformance
checker (reference: tests/compare_images.cpp): per-component PEAK (max
absolute error) and MSE against tolerances, as used by the ISO class-0/1
conformance suites (Table C.1 style limits).

Exit code 0 when every component is within tolerance, 1 otherwise.

    python -m grokimagecompression_tpu_torch.cli.compare -b base.ppm \
        -t test.ppm -p 33 -m 55.8

A copy of `grokimagecompression_tpu/cli/compare.py` over the port's
readers; it does no device work.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from . import common


def compare(base, test, peaks=None, mses=None, out=sys.stderr):
    """Returns True when within tolerance; prints per-component stats."""
    if len(base.components) != len(test.components):
        print(f"component count differs: {len(base.components)} vs "
              f"{len(test.components)}", file=out)
        return False
    ok = True
    for c, (cb, ct) in enumerate(zip(base.components, test.components)):
        if cb.data.shape != ct.data.shape:
            print(f"comp {c}: shape differs {cb.data.shape} vs "
                  f"{ct.data.shape}", file=out)
            ok = False
            continue
        diff = ct.data.astype(np.float64) - cb.data.astype(np.float64)
        peak = float(np.abs(diff).max()) if diff.size else 0.0
        mse = float((diff ** 2).mean()) if diff.size else 0.0
        plim = peaks[c] if peaks and c < len(peaks) else \
            (peaks[-1] if peaks else 0.0)
        mlim = mses[c] if mses and c < len(mses) else \
            (mses[-1] if mses else 0.0)
        status = "OK"
        if peak > plim or mse > mlim:
            status = "FAIL"
            ok = False
        print(f"comp {c}: PEAK={peak:.4g} (limit {plim:.4g}) "
              f"MSE={mse:.4g} (limit {mlim:.4g}) {status}", file=out)
    return ok


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="grk_compare_images",
        description="Compare two images with PEAK/MSE tolerances")
    p.add_argument("-b", "--base", required=True, help="reference image")
    p.add_argument("-t", "--test", required=True, help="image under test")
    p.add_argument("-p", "--peak", default="0",
                   help="PEAK limits per component (comma-separated; "
                        "last repeats)")
    p.add_argument("-m", "--mse", default="0",
                   help="MSE limits per component")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    base = common.read_image(args.base)
    test = common.read_image(args.test)
    peaks = [float(v) for v in args.peak.split(",")]
    mses = [float(v) for v in args.mse.split(",")]
    return 0 if compare(base, test, peaks, mses) else 1


if __name__ == "__main__":
    raise SystemExit(main())
