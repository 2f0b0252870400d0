#!/usr/bin/env python3
"""Phases 23 and 26 of chip_smoke.py alone: multi-device coding on every
card.

Builds the kernels and the host library, makes on cuda:0 the inputs
phase 23 takes from phases 19 and 20 (S1's `encode_batch([img])` stream
and the digests of its whole and W1 decodes, S2's stream at
`rate_alloc="global"`), then runs `chip_smoke.mesh_phase` (with phase
26 (d)'s multi-process encodes in its worker processes) and
`chip_smoke.mesh_t1_phase` (styled MQ and refined HT requests on the
transform-only mesh route): on one card the mesh [cuda:0, cuda:0] and
two processes on cuda:0; on n > 1 cards [cuda:1, cuda:2] and all n
cards and n processes, a card each. Every stream and decode must equal
the one-card one. Exits non-zero on any failure or without CUDA.

Run from the repository root: python3 tools/mesh_check.py
"""

import dataclasses
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("mesh_check: torch.cuda.is_available() is False; this needs "
              "a CUDA card", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from grokimagecompression_tpu_torch.codestream import decoder, encoder
    from grokimagecompression_tpu_torch.core.params import DecoderParams
    from grokimagecompression_tpu_torch.ops import _build
    t_all = time.perf_counter()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True,
                         capture_output=True, text=True).stdout.strip()
    print(smi)
    card = smi.splitlines()[0].strip()
    _build.build()
    _build.load()
    _build.build_host()
    _build.host_library()
    print(f"built in {time.perf_counter() - t_all:.1f} s", flush=True)
    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    s1 = cs.s1_frame()
    (s1_cs,) = encoder.encode_batch([s1], cs.full_params("S1"), device=dev)
    del s1
    refs = {"full": cs.plane_md5(decoder.decode(s1_cs, device=dev)),
            "W1": cs.plane_md5(decoder.decode(s1_cs, DecoderParams(
                window=cs.FULL_CASES[0][3]), device=dev))}
    s2 = cs.s2_frame()
    s2_global = encoder.encode(s2, dataclasses.replace(
        cs.full_params("S2"), rate_alloc="global"), device=dev)
    del s2
    torch.cuda.synchronize()
    print(f"one-card inputs in {time.perf_counter() - t0:.1f} s",
          flush=True)
    _, t1_workers = cs.mesh_phase(s1_cs, refs, s2_global, dev, card)
    del s1_cs, s2_global
    cs.mesh_t1_phase(cs.config2_frames(1)[0], dev, card,
                     cs.card_meshes(dev), t1_workers)
    print(f"mesh_check: every check passed in "
          f"{time.perf_counter() - t_all:.1f} s on {card}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
