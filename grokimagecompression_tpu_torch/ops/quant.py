"""Quantization helpers the port's decode needs.

A copy of `trunc_plane` from `grokimagecompression_tpu/ops/quant.py`;
`tests/test_torch_host_copies.py` holds it equal to the original.
"""

from __future__ import annotations


def trunc_plane(numbps: int, numpasses: int) -> int:
    """Lowest bit-plane reached by `numpasses` decoded passes of a block
    with `numbps` magnitude planes: pass 0 is the MSB cleanup, then
    (sig, ref, cln) triplets per plane (Annex D pass schedule). The
    mid-point reconstruction offset belongs at THIS plane, not plane 0
    — the reference decoder embeds the half at each sample's
    last-touched plane (reference: t1.cpp oneplushalf/poshalf decode
    updates, scaled out in T1Part1.cpp post_decode), so a truncated
    block reconstructs at the center of its actual decision interval.
    """
    if numbps <= 0 or numpasses <= 0:
        return 0
    return max(0, numbps - 1 - ((numpasses + 1) // 3))
