#!/usr/bin/env python3
"""Smoke test of the torch port on one CUDA GPU: build, check, run, time.

Drives the port's four paths at BASELINE config 1 (512x512 8-bit gray,
5/3, 6 resolutions, 64x64 code-blocks, 64 frames in 32-frame chunks): the
fused HT lossless encode through
`grokimagecompression_tpu_torch.codestream.encoder.encode_batch`, its
decode mirror through `codestream.decoder.decode_batch`, the Part-1 MQ
lossless encode (default code-block style 0) through `encode_batch`, and
its decode mirror through `decode_batch`; and checks every CUDA kernel on
those paths against its plain PyTorch version. It imports only the port,
torch, numpy and the standard library.

Phases, each fatal on failure:
  1. the card (nvidia-smi name and power limit) and the software versions;
  2. building the CUDA kernels from csrc/*.cu with nvcc (one process per
     source, all started together) and the port's host library from
     csrc/host/*.cpp with g++;
  3. the kernels at the config-1 shapes, each equal to its plain version
     on every lane and both timed with CUDA events: the three encode scans
     on the three shape groups of one chunk, the HT decoder on the three
     lane groups of one chunk of the encoded streams, the MQ coder on
     the slot streams of the three MQ shape groups of one chunk (the plain
     version steps over each lane's coding slots only: the others leave
     its coder as it is), and the MQ decoder on the three lane groups of
     one chunk of MQ streams (16x16 and 32x32 at full depth; 64x64 at full
     depth when the plain version's time, estimated from the 32x32 group,
     is at most 90 s, else every lane cut to its first 3 passes for the
     comparison; the kernel is timed at full depth);
  4. the encode slice: the 64 frames and the 64 streams of
     encode_batch(device="cuda") against the SHA-256 digests of
     grokimagecompression_tpu_torch/data/config1_ht_lossless.json (the
     frames, and the reference host encoder's streams), every scan kernel
     launched by that run; MP/s (best of 3) and one chunk's time by stage;
  5. the decode slice: the 64 streams through decode_batch(device="cuda"),
     every frame equal to its source, the decode kernel launched by that
     run; MP/s (best of 3) and one chunk's time by stage;
  6. the MQ encode slice: the 64 frames through encode_batch(device=
     "cuda") with cblk_style 0, every stream against
     grokimagecompression_tpu_torch/data/config1_mq_lossless.json (the
     reference host encoder's), the MQ kernel launched by that run; MP/s
     (best of 3) and one chunk's time by stage;
  7. the MQ decode slice: the 64 MQ streams of phase 6 through
     decode_batch(device="cuda"), every frame equal to its source, the MQ
     decoder launched by that run; MP/s (best of 3) and one chunk's time
     by stage.
The line before the last is a JSON object with one entry per kernel; the
last line is {"ok": true, "device": {...}}.

Run from the repository root: python3 chip_smoke.py (needs one CUDA card;
exits non-zero without one).
"""

from __future__ import annotations

import hashlib
import json
import os
import subprocess
import sys
import time

FRAMES = 64
CHUNK = 32
SIZE = 512
DIGESTS = os.path.join("grokimagecompression_tpu_torch", "data",
                       "config1_ht_lossless.json")
MQ_DIGESTS = os.path.join("grokimagecompression_tpu_torch", "data",
                          "config1_mq_lossless.json")
# (name, LAUNCHES key, plain-version name, TPU kernel it replaces, source)
SCANS = tuple(
    (f"{k}_scan", k, f"{k}_scan_plain",
     f"grokimagecompression_tpu/ops/ht_scan_pallas.py:{line}",
     "grokimagecompression_tpu_torch/csrc/ht_scan.cu")
    for k, line in (("mel", 214), ("vlc", 282), ("ms", 308)))
DEC = ("ht_dec_group", "dec", "decode_group_plain",
       "grokimagecompression_tpu/ops/ht_dec_pallas.py:534",
       "grokimagecompression_tpu_torch/csrc/ht_dec.cu")
MQ = ("mq_scan", "mq", "mq_scan_plain",
      "grokimagecompression_tpu/ops/mq_scan_pallas.py:61",
      "grokimagecompression_tpu_torch/csrc/mq_scan.cu")
MQ_DEC = ("mq_dec_group", "mq_dec", "decode_group_plain",
          "grokimagecompression_tpu/ops/mq_dec_pallas.py:594",
          "grokimagecompression_tpu_torch/csrc/mq_dec.cu")
# the plain MQ decoder's longest run allowed at full depth on the 64x64
# group (seconds, estimated from the 32x32 group's run)
PLAIN_MQ_DEC_S = 90
STREAMS = {"mel": ("mel_valid", "mel_bit"), "vlc": ("vlc_vals", "vlc_lens"),
           "ms": ("ms_vals", "ms_lens")}
# Bounds. H100 SXM peak rates: 3.35 TB/s of device memory; integer
# operations at 16.7 TOP/s (132 SMs x 64 INT32 lanes x 1.98 GHz: half the
# FP32 lanes behind the card's 67 TFLOP/s FP32 peak, no FMA doubling).
# The operation counts per lane are estimates read off the kernels'
# sources, not instruction counts: a MEL event ~25, a VLC or MagSgn append
# ~30 (an append's bytes pushed one by one), a decode step ~200 plus ~25
# per significant sample. The MQ coder is charged what the encode
# procedure (Annex C.2) needs at least, on this run's data: 10 per coded
# decision, the cost of its shortest path (MPS, no renormalisation: take
# d and cx from the slot, load the context, take its MPS, load Qe, A -=
# Qe, compare d with the MPS, test bit 15 of A, C += Qe), and 10 per byte
# written (shift C by CT, test the delayed byte for 0xFF and C for a
# carry, store, take the next delayed byte, mask C, set CT). Reading the
# slots, emitting or not, is in the byte term; a renormalisation is
# charged only through its byte-outs. The MQ decoder (an estimate, on
# this run's data): 10 per decoded decision (C.3.2's shortest path), 10
# per byte taken in (BYTEIN), and 2 per sample visit per pass (the
# membership test).
HBM_BYTES_S = 3.35e12
INT_OPS_S = 132 * 64 * 1.98e9
OPS = {"mel": 25, "vlc": 30, "ms": 30, "dec_step": 200, "dec_sample": 25,
       "mq_decision": 10, "mq_byte": 10, "mqd_decision": 10, "mqd_byte": 10,
       "mqd_visit": 2}


def config1_frames(n, seed=42, size=SIZE):
    """BASELINE config-1 frames: smooth gradient + noise, frame i shifted
    by i (mod 256), as the repository's bench generates them."""
    import numpy as np
    from grokimagecompression_tpu_torch.core.image import Component, Image

    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:size, 0:size]
    base = (128 + 60 * np.sin(yy / 37.0) * np.cos(xx / 29.0)
            + rng.normal(0, 12, (size, size))).clip(0, 255).astype(np.int32)
    return [Image(xsiz=size, ysiz=size, components=[Component(
        data=(base + i) % 256, prec=8, signed=False, dx=1, dy=1)])
        for i in range(n)]


def frame_digest(img) -> str:
    """SHA-256 of an image's samples, component by component, as
    little-endian int32."""
    import numpy as np
    h = hashlib.sha256()
    for c in img.components:
        h.update(np.ascontiguousarray(c.data, dtype="<i4").tobytes())
    return h.hexdigest()


def cuda_ms(fn, iters):
    """Mean device milliseconds of fn() over `iters` calls (CUDA events)."""
    import torch
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def bound(nbytes_moved: int, ops: float):
    """(bound in ms, what sets it, "bytes a ms, operations b ms")."""
    t_bytes = nbytes_moved / HBM_BYTES_S
    t_ops = ops / INT_OPS_S
    return (1e3 * max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations",
            f"bytes {1e3 * t_bytes:.4f} ms, operations {1e3 * t_ops:.4f} ms")


def time_kernel(kernel, plain, args):
    """(kernel ms: mean of 20 launches after 3 warm-up launches, plain
    ms: one run), both between CUDA events."""
    for _ in range(3):
        kernel(*args)
    ms = cuda_ms(lambda: kernel(*args), 20)
    return ms, cuda_ms(lambda: plain(*args), 1)


def check_scans(enc, plan, chunk, results):
    """Phase 3, encode side: the three scans on each shape group."""
    import torch

    from grokimagecompression_tpu_torch.ops import ht_scan, ht_torch
    for gi, (mag, neg, mbs, mbb) in enumerate(enc.group_inputs(chunk)):
        ops = ht_torch.op_streams(mag, neg, mbs, enc.tables(), mbb)
        qh, qw, _ = plan.groups[gi]
        biggest = gi == len(plan.groups) - 1
        for name, key, plain_name, _, _ in SCANS:
            a, b = (ops[k] for k in STREAMS[key])
            kernel = getattr(ht_scan, name)
            plain = getattr(ht_scan, plain_name)
            got = kernel(a, b)
            want = plain(a, b)
            torch.cuda.synchronize()
            err = max(int((w.to(torch.int64) - g.to(torch.int64))
                          .abs().max()) if w.numel() else 0
                      for w, g in zip(want, got))
            for part, w, g in zip(("words", "mask", "state"), want, got):
                if not torch.equal(w, g):
                    raise AssertionError(
                        f"{name} {part} differs from the plain version "
                        f"(group {qh}x{qw} quads, B={a.shape[1]})")
            line = (f"kernel {name}: group {qh}x{qw} quads, ops "
                    f"{tuple(a.shape)} -> words {tuple(got[0].shape)}: "
                    f"bit-exact with plain")
            if biggest:
                ms, plain_ms = time_kernel(kernel, plain, (a, b))
                events = int((a != 0).sum()) if key == "mel" \
                    else int((b > 0).sum())
                b_ms, b_by, b_terms = bound(nbytes(a, b, *got),
                                            OPS[key] * events)
                results[name] = dict(ms=ms, plain_ms=plain_ms,
                                     max_abs_err=err, bound_ms=b_ms,
                                     bound_by=b_by)
                line += (f"; {ms:.3f} ms (plain {plain_ms:.1f} ms, bound "
                         f"{b_ms:.4f} ms by {b_by}: {b_terms})")
            print(line)


def check_decoder(streams, dev, results):
    """Phase 3, decode side: the HT decoder on the lane groups of one
    chunk of streams."""
    import torch

    from grokimagecompression_tpu_torch.codestream import decoder
    from grokimagecompression_tpu_torch.models import fused_decode
    from grokimagecompression_tpu_torch.ops import ht_dec, ht_tables

    hdr, trs, parsed = decoder.parse_batch(streams)
    plan = fused_decode.build_plan(parsed[0][0][0][2], hdr.siz, hdr.cod,
                                   trs[0])
    tables = ht_tables.device_dec_tables(dev)
    arrays = fused_decode.upload(fused_decode.prepare_chunk(
        plan, [fused_decode.jobs_by_block(*p[0][0][:3]) for p in parsed]),
        dev)
    name, key, _, _, _ = DEC
    for (w, h, lanes), (mel, vlc, ms, _) in zip(plan.groups, arrays):
        args = (mel, vlc, ms, w, h, tables)
        got = ht_dec.decode_group(*args)
        want = ht_dec.decode_group_plain(mel, vlc, ms, w, h,
                                         tables["dec0"], tables["dec1"])
        torch.cuda.synchronize()
        err = max(int((wv.to(torch.int64) - g.to(torch.int64)).abs().max())
                  for wv, g in zip(want, got))
        for part, wv, g in zip(("mags", "signs"), want, got):
            if not torch.equal(wv, g):
                raise AssertionError(
                    f"{name} {part} differ from the plain version "
                    f"({w}x{h} blocks, B={mel.shape[1]})")
        line = (f"kernel {name}: {w}x{h} blocks, B={mel.shape[1]}, words "
                f"{mel.shape[0]}/{vlc.shape[0]}/{ms.shape[0]} -> "
                f"{tuple(got[0].shape)}: bit-exact with plain")
        if (w, h) == (64, 64):
            ms_k, plain_ms = time_kernel(
                ht_dec.decode_group,
                lambda *a: ht_dec.decode_group_plain(
                    *a[:5], a[5]["dec0"], a[5]["dec1"]), args)
            steps = ht_dec.grid_dims(w, h)[2] * mel.shape[1]
            nsig = int((got[0] != 0).sum())
            b_ms, b_by, b_terms = bound(
                nbytes(mel, vlc, ms, tables["dec0"], tables["dec1"], *got),
                OPS["dec_step"] * steps + OPS["dec_sample"] * nsig)
            results[name] = dict(ms=ms_k, plain_ms=plain_ms,
                                 max_abs_err=err, bound_ms=b_ms,
                                 bound_by=b_by)
            line += (f"; {ms_k:.3f} ms (plain {plain_ms:.1f} ms, bound "
                     f"{b_ms:.4f} ms by {b_by}: {b_terms})")
        print(line)


def encode_stages(enc, chunk):
    """Device time of one 32-frame encode chunk by stage (host clock,
    synchronised)."""
    import torch

    from grokimagecompression_tpu_torch.ops import ht_scan, ht_torch
    stages = {}
    tt = time.perf_counter
    torch.cuda.synchronize()
    t = tt()
    gin = list(enc.group_inputs(chunk))
    torch.cuda.synchronize()
    stages["transform+gather"] = tt() - t
    t = tt()
    ops = [ht_torch.op_streams(m, n, s, enc.tables(), mb)
           for (m, n, s, mb) in gin]
    torch.cuda.synchronize()
    stages["op streams"] = tt() - t
    t = tt()
    groups = [(ht_scan.mel_scan(o["mel_valid"], o["mel_bit"]),
               ht_scan.vlc_scan(o["vlc_vals"], o["vlc_lens"]),
               ht_scan.ms_scan(o["ms_vals"], o["ms_lens"])) for o in ops]
    torch.cuda.synchronize()
    stages["scans"] = tt() - t
    t = tt()
    torch.cat([ht_torch.group_metrics(g[0][2].shape[1], *g)
               for g in groups]).cpu()
    ht_torch.place_words(groups).cpu()
    torch.cuda.synchronize()
    stages["metrics+placement+fetch"] = tt() - t
    return stages


def decode_stages(streams, dev, host_stage):
    """Time of one 32-frame decode chunk by stage (host clock,
    synchronised); `host_stage` names the host work between T2 and the
    upload (the HT prepass, the MQ lane packing)."""
    import torch

    from grokimagecompression_tpu_torch.codestream import decoder
    from grokimagecompression_tpu_torch.models import fused_decode, pipeline

    stages = {}
    tt = time.perf_counter
    t = tt()
    hdr, trs, parsed = decoder.parse_batch(streams)
    stages["T2 (host)"] = tt() - t
    (plan,) = decoder.tile_groups(hdr, trs, parsed)
    dec = fused_decode.decoder_for(plan, dev)
    t = tt()
    arrays = fused_decode.prepare_chunk(dec.plan, [
        fused_decode.jobs_by_block(*p[0][0][:3]) for p in parsed])
    stages[host_stage] = tt() - t
    torch.cuda.synchronize()
    t = tt()
    groups = fused_decode.upload(arrays, dev)
    torch.cuda.synchronize()
    stages["upload"] = tt() - t
    t = tt()
    grids = dec.decode(groups)
    torch.cuda.synchronize()
    stages["decode kernel"] = tt() - t
    t = tt()
    bands = dec.assemble(grids, [g[-1] for g in groups], len(streams))
    torch.cuda.synchronize()
    stages["band assembly"] = tt() - t
    t = tt()
    comps = pipeline._inv_transform(dec.plan.cfg, bands)
    torch.cuda.synchronize()
    stages["inverse DWT + DC unshift"] = tt() - t
    t = tt()
    [c.cpu() for c in comps]
    stages["fetch"] = tt() - t
    return stages


def check_mq_scan(mq_enc, chunk, results):
    """Phase 3, MQ: the MQ coder on the slot streams of each shape group
    of one chunk, every lane against the plain version."""
    import torch

    from grokimagecompression_tpu_torch.ops import mq_scan, mq_torch
    name = MQ[0]
    for mag, neg, orient in mq_enc.group_inputs(chunk):
        _, slots = mq_enc.group_slots(mag, neg, orient)
        T, B = slots.shape
        h, w = mag.shape[1:]
        got = mq_scan.mq_scan(slots)
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        want = mq_torch.mq_scan_plain(slots)
        stop.record()
        torch.cuda.synchronize()
        plain_ms = start.elapsed_time(stop)
        for part, wv, g in zip(("segments", "lengths", "state"), want, got):
            if not torch.equal(wv, g):
                raise AssertionError(
                    f"{name} {part} differ from the plain version "
                    f"({h}x{w} blocks, T={T}, B={B})")
        err = max(int((wv.to(torch.int64) - g.to(torch.int64)).abs().max())
                  if wv.numel() else 0 for wv, g in zip(want, got))
        emits = int((slots & 1).sum())
        line = (f"kernel {name}: {h}x{w} blocks, slots ({T}, {B}), "
                f"{emits} coding ({100 * emits / (T * B):.1f} %) -> "
                f"{got[0].numel()} segment bytes: bit-exact with plain "
                f"(plain {plain_ms:.1f} ms)")
        if (h, w) == (64, 64):
            off, total = mq_scan.segment_offsets(slots)
            for _ in range(3):
                mq_scan.scan_into(slots, off, total)
            ms = cuda_ms(lambda: mq_scan.scan_into(slots, off, total), 20)
            b_ms, b_by, b_terms = bound(
                nbytes(slots, *got),
                OPS["mq_decision"] * emits + OPS["mq_byte"] * got[0].numel())
            results[name] = dict(ms=ms, plain_ms=plain_ms, max_abs_err=err,
                                 bound_ms=b_ms, bound_by=b_by)
            line += (f"; kernel {ms:.3f} ms (bound {b_ms:.4f} ms by {b_by}: "
                     f"{b_terms})")
        print(line)


def check_mq_decoder(streams, dev, results):
    """Phase 3, MQ decode: the MQ decoder on the lane groups of one chunk
    of MQ streams, every lane against the plain version."""
    import torch

    from grokimagecompression_tpu_torch.codestream import decoder
    from grokimagecompression_tpu_torch.models import fused_decode
    from grokimagecompression_tpu_torch.ops import mq_dec, mq_dec_torch

    hdr, trs, parsed = decoder.parse_batch(streams)
    (plan,) = decoder.tile_groups(hdr, trs, parsed)
    arrays = fused_decode.upload(fused_decode.prepare_chunk(
        plan, [fused_decode.jobs_by_block(*p[0][0][:3]) for p in parsed]),
        dev)
    name = MQ_DEC[0]
    rate = None   # plain seconds per sample-pass, from the 32x32 group
    for (w, h, _), group in zip(plan.groups, arrays):
        data, off, nbps, npas_full, ori = group[:5]
        npas = npas_full
        B = nbps.shape[0]
        work = w * h * int(npas.max())
        note = ""
        if (w, h) == (64, 64):
            est = rate * work
            if est > PLAIN_MQ_DEC_S:
                npas = torch.clamp(npas, max=3)
                note = (f"; every lane cut to its first 3 passes for the "
                        f"comparison (the plain version at full depth: "
                        f"~{est:.0f} s, estimated from the 32x32 group)")
            else:
                note = (f"; full depth (the plain version: ~{est:.0f} s, "
                        f"estimated from the 32x32 group)")
        args = (data, off, nbps, npas, ori, w, h)
        got = mq_dec.decode_group(*args, with_stats=True)
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        want = mq_dec_torch.decode_group_plain(*args, with_stats=True)
        stop.record()
        torch.cuda.synchronize()
        plain_ms = start.elapsed_time(stop)
        if (w, h) == (32, 32):
            rate = plain_ms / 1e3 / work
        for part, wv, g in zip(("samples", "statistics"), want, got):
            if not torch.equal(wv, g):
                raise AssertionError(
                    f"{name} {part} differ from the plain version "
                    f"({w}x{h} blocks, B={B})")
        err = max(int((wv.to(torch.int64) - g.to(torch.int64)).abs().max())
                  for wv, g in zip(want, got))
        line = (f"kernel {name}: {w}x{h} blocks, B={B}, {data.numel()} "
                f"segment bytes, up to {int(npas.max())} passes -> "
                f"{tuple(got[0].shape)}: bit-exact with plain on every "
                f"lane (plain {plain_ms:.1f} ms){note}")
        if (w, h) == (64, 64):
            full = (data, off, nbps, npas_full, ori, w, h)
            for _ in range(3):
                mq_dec.decode_group(*full)
            ms = cuda_ms(lambda: mq_dec.decode_group(*full), 20)
            packed, stats = mq_dec.decode_group(*full, with_stats=True)
            nb = nbps.to(torch.int64)
            visits = w * h * int(torch.minimum(
                npas_full.to(torch.int64), (3 * nb - 2).clamp(min=0)).sum())
            ndec, nbyte = (int(v) for v in stats.to(torch.int64).sum(1))
            b_ms, b_by, b_terms = bound(
                nbytes(data, off, nbps, npas_full, ori, packed, stats),
                OPS["mqd_decision"] * ndec + OPS["mqd_byte"] * nbyte
                + OPS["mqd_visit"] * visits)
            results[name] = dict(ms=ms, plain_ms=plain_ms, max_abs_err=err,
                                 bound_ms=b_ms, bound_by=b_by)
            line += (f"; kernel {ms:.3f} ms at full depth: {ndec} "
                     f"decisions, {nbyte} BYTEINs, {visits} sample visits "
                     f"(bound {b_ms:.4f} ms by {b_by}: {b_terms}; the "
                     f"operation term an estimate)")
        print(line)


def mq_encode_stages(mq_enc, chunk, imgs, params):
    """Time of one 32-frame MQ encode chunk by stage (host clock,
    synchronised); the host T2 runs on encode_batch's 4-thread pool."""
    import concurrent.futures

    import torch

    from grokimagecompression_tpu_torch.codestream import encoder
    from grokimagecompression_tpu_torch.models import fused_encode
    from grokimagecompression_tpu_torch.ops import mq_scan
    stages = {}
    tt = time.perf_counter
    torch.cuda.synchronize()
    t = tt()
    gin = list(mq_enc.group_inputs(chunk))
    torch.cuda.synchronize()
    stages["transform+gather"] = tt() - t
    t = tt()
    slots = [mq_enc.group_slots(*g) for g in gin]
    torch.cuda.synchronize()
    stages["slot build"] = tt() - t
    t = tt()
    scans = [mq_scan.mq_scan(s) for _, s in slots]
    torch.cuda.synchronize()
    stages["scan"] = tt() - t
    t = tt()
    outs = [torch.cat([n for n, _ in slots]).cpu().numpy()] + [
        torch.cat([sc[k] for sc in scans]).cpu().numpy() for k in (1, 0)]
    segs = fused_encode.assemble_collected_mq(mq_enc.plan, chunk.shape[0],
                                              *outs)
    stages["placement+fetch"] = tt() - t
    t = tt()
    with concurrent.futures.ThreadPoolExecutor(max_workers=4) as pool:
        list(pool.map(lambda f: encoder.encode(imgs[f], params,
                                               {0: segs[f]}),
                      range(chunk.shape[0])))
    stages["host T2"] = tt() - t
    return stages


def best_of(n, fn):
    import torch
    best = float("inf")
    for _ in range(n):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        best = min(best, time.perf_counter() - t0)
    return best


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this needs "
              "a CUDA card", file=sys.stderr)
        return 1
    root = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, root)
    import numpy as np

    from grokimagecompression_tpu_torch.codestream import decoder, encoder
    from grokimagecompression_tpu_torch.codestream.tile import default_qcd
    from grokimagecompression_tpu_torch.core.geometry import tile_rect
    from grokimagecompression_tpu_torch.core.params import EncoderParams
    from grokimagecompression_tpu_torch.models import fused_encode
    from grokimagecompression_tpu_torch.ops import (_build, ht_dec, ht_scan,
                                                    ht_tables, mq_dec,
                                                    mq_scan)

    # 1. the card
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()
    card = smi.splitlines()[0].strip()
    print(card)
    dev = torch.device("cuda", 0)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"python {sys.version.split()[0]}, numpy {np.__version__}, "
          f"device {torch.cuda.get_device_name(0)}")

    # 2. builds
    t0 = time.perf_counter()
    so, log = _build.build()
    _build.load()
    print(f"built {os.path.relpath(so)} from {', '.join(_build.SOURCES)} "
          f"with nvcc {' '.join(_build.ARCH_FLAGS)} in "
          f"{time.perf_counter() - t0:.1f} s")
    for line in log.splitlines():
        if "registers" in line or "Compiling entry" in line \
                or "spill" in line:
            print("  ptxas:", line.strip())
    t0 = time.perf_counter()
    host_so, _ = _build.build_host()
    _build.host_library()
    print(f"built {os.path.relpath(host_so)} with g++ "
          f"{' '.join(_build.HOST_FLAGS)} in {time.perf_counter() - t0:.1f} s")

    params = EncoderParams(numresolutions=6, cblk_style=0x40)
    imgs = config1_frames(FRAMES)
    siz = encoder.build_siz(imgs[0], params)
    cod = encoder.build_cod(imgs[0], params)
    qcd = default_qcd(siz, cod, 1, params.base_step)
    tr = tile_rect(0, siz.xsiz, siz.ysiz, siz.xosiz, siz.yosiz,
                   siz.xtsiz, siz.ytsiz, siz.xtosiz, siz.ytosiz)
    plan = fused_encode.build_plan(siz, cod, qcd, tr)
    enc = fused_encode.FusedHTEncoder(plan, ht_tables.device_tables(dev))
    chunk = torch.from_numpy(np.stack(
        [im.components[0].data for im in imgs[:CHUNK]]).astype(np.uint8)
    ).to(dev)
    mq_params = EncoderParams(numresolutions=6, cblk_style=0)
    mq_cod = encoder.build_cod(imgs[0], mq_params)
    mq_qcd = default_qcd(siz, mq_cod, mq_params.num_guard_bits,
                         mq_params.base_step)
    mq_enc = fused_encode.FusedMQEncoder(
        fused_encode.build_plan(siz, mq_cod, mq_qcd, tr, coder="mq"), dev)

    # 3. kernels against their plain versions, at one chunk's shapes
    results = {}
    check_scans(enc, plan, chunk, results)
    first = encoder.encode_batch(imgs[:CHUNK], params, device="cuda",
                                 chunk=CHUNK)
    check_decoder(first, dev, results)
    check_mq_scan(mq_enc, chunk, results)
    check_mq_decoder(encoder.encode_batch(imgs[:CHUNK], mq_params,
                                          device="cuda", chunk=CHUNK),
                     dev, results)

    # 4. the encode slice, through the user entry point
    with open(os.path.join(root, DIGESTS)) as f:
        digests = json.load(f)
    got = [frame_digest(im) for im in imgs]
    if got != digests["frames"]:
        bad = [i for i, (g, w) in enumerate(zip(got, digests["frames"]))
               if g != w]
        raise AssertionError(f"config-1 frames {bad[:8]} differ from the "
                             f"digest file: numpy makes other frames here")
    mpix = FRAMES * SIZE * SIZE / 1e6
    launches = {}
    for k in ht_scan.LAUNCHES:
        ht_scan.LAUNCHES[k] = 0
    out = encoder.encode_batch(imgs, params, device="cuda", chunk=CHUNK)
    torch.cuda.synchronize()
    launches.update(ht_scan.LAUNCHES)
    print(f"encode slice launches: {dict(ht_scan.LAUNCHES)}")
    for name, key, _, _, _ in SCANS:
        if launches[key] < 1:
            raise AssertionError(f"{name} was not launched by the slice")
    if len(out) != FRAMES:
        raise AssertionError(f"{len(out)} streams for {FRAMES} frames")
    for i, cs in enumerate(out):
        if hashlib.sha256(cs).hexdigest() != digests["streams"][i]:
            raise AssertionError(f"frame {i}: stream differs from the host "
                                 f"encoder's ({len(cs)} B)")
    nb = sum(len(cs) for cs in out)
    print(f"encode slice: {FRAMES} streams match the host encoder's "
          f"digests ({nb} B, {8 * nb / (mpix * 1e6):.3f} bpp)")
    best = best_of(3, lambda: encoder.encode_batch(
        imgs, params, device="cuda", chunk=CHUNK))
    print(f"encode_batch: {mpix / best:.2f} MP/s (best of 3, "
          f"{best:.3f} s for {FRAMES} frames) on {card}")
    encode_stages(enc, chunk)
    stages = encode_stages(enc, chunk)
    fwd_ms = cuda_ms(lambda: enc(chunk), 3)
    print(f"one {CHUNK}-frame encode chunk, FusedHTEncoder.forward: "
          f"{fwd_ms:.1f} ms; by stage (host clock, synchronised): "
          + ", ".join(f"{k} {v * 1e3:.1f} ms" for k, v in stages.items()))

    # 5. the decode slice, through the user entry point
    ht_dec.LAUNCHES["dec"] = 0
    dec = decoder.decode_batch(out, device="cuda", chunk=CHUNK)
    torch.cuda.synchronize()
    launches["dec"] = ht_dec.LAUNCHES["dec"]
    print(f"decode slice launches: {dict(ht_dec.LAUNCHES)}")
    if launches["dec"] < 1:
        raise AssertionError("ht_dec_group was not launched by the slice")
    if len(dec) != FRAMES:
        raise AssertionError(f"{len(dec)} images for {FRAMES} streams")
    for i, (d, im) in enumerate(zip(dec, imgs)):
        if not np.array_equal(d.components[0].data, im.components[0].data):
            raise AssertionError(f"frame {i}: decode is not lossless")
    print(f"decode slice: {FRAMES} frames decode to their sources exactly")
    best = best_of(3, lambda: decoder.decode_batch(out, device="cuda",
                                                   chunk=CHUNK))
    print(f"decode_batch: {mpix / best:.2f} MP/s (best of 3, "
          f"{best:.3f} s for {FRAMES} frames) on {card}")
    decode_stages(out[:CHUNK], dev, "prepass (host)")
    stages = decode_stages(out[:CHUNK], dev, "prepass (host)")
    print(f"one {CHUNK}-frame decode chunk by stage (host clock, "
          "synchronised): "
          + ", ".join(f"{k} {v * 1e3:.1f} ms" for k, v in stages.items()))

    # 6. the MQ encode slice, through the user entry point
    with open(os.path.join(root, MQ_DIGESTS)) as f:
        mq_digests = json.load(f)
    if mq_digests["frames"] != digests["frames"]:
        raise AssertionError("the two digest files hold other frames")
    mq_scan.LAUNCHES["mq"] = 0
    out = encoder.encode_batch(imgs, mq_params, device="cuda", chunk=CHUNK)
    torch.cuda.synchronize()
    launches["mq"] = mq_scan.LAUNCHES["mq"]
    print(f"MQ encode slice launches: {dict(mq_scan.LAUNCHES)}")
    if launches["mq"] < 1:
        raise AssertionError("mq_scan was not launched by the MQ slice")
    if len(out) != FRAMES:
        raise AssertionError(f"{len(out)} MQ streams for {FRAMES} frames")
    for i, cs in enumerate(out):
        if hashlib.sha256(cs).hexdigest() != mq_digests["streams"][i]:
            raise AssertionError(f"frame {i}: MQ stream differs from the "
                                 f"host encoder's ({len(cs)} B)")
    nb = sum(len(cs) for cs in out)
    print(f"MQ encode slice: {FRAMES} streams match the host encoder's "
          f"digests ({nb} B, {8 * nb / (mpix * 1e6):.3f} bpp)")
    best = best_of(3, lambda: encoder.encode_batch(
        imgs, mq_params, device="cuda", chunk=CHUNK))
    print(f"encode_batch (MQ): {mpix / best:.2f} MP/s (best of 3, "
          f"{best:.3f} s for {FRAMES} frames) on {card}")
    mq_encode_stages(mq_enc, chunk, imgs, mq_params)
    stages = mq_encode_stages(mq_enc, chunk, imgs, mq_params)
    print(f"one {CHUNK}-frame MQ encode chunk by stage (host clock, "
          "synchronised): "
          + ", ".join(f"{k} {v * 1e3:.1f} ms" for k, v in stages.items()))

    # 7. the MQ decode slice, through the user entry point
    mq_dec.LAUNCHES["mq_dec"] = 0
    dec = decoder.decode_batch(out, device="cuda", chunk=CHUNK)
    torch.cuda.synchronize()
    launches["mq_dec"] = mq_dec.LAUNCHES["mq_dec"]
    print(f"MQ decode slice launches: {dict(mq_dec.LAUNCHES)}")
    if launches["mq_dec"] < 1:
        raise AssertionError("mq_dec_group was not launched by the slice")
    if len(dec) != FRAMES:
        raise AssertionError(f"{len(dec)} images for {FRAMES} MQ streams")
    for i, (d, im) in enumerate(zip(dec, imgs)):
        if not np.array_equal(d.components[0].data, im.components[0].data):
            raise AssertionError(f"frame {i}: MQ decode is not lossless")
    print(f"MQ decode slice: {FRAMES} frames decode to their sources exactly")
    best = best_of(3, lambda: decoder.decode_batch(out, device="cuda",
                                                   chunk=CHUNK))
    print(f"decode_batch (MQ): {mpix / best:.2f} MP/s (best of 3, "
          f"{best:.3f} s for {FRAMES} frames) on {card}")
    decode_stages(out[:CHUNK], dev, "lane packing (host)")
    stages = decode_stages(out[:CHUNK], dev, "lane packing (host)")
    print(f"one {CHUNK}-frame MQ decode chunk by stage (host clock, "
          "synchronised): "
          + ", ".join(f"{k} {v * 1e3:.1f} ms" for k, v in stages.items()))

    print(json.dumps({"kernels": [
        dict(name=name, route="cuda", source=source, replaces=replaces,
             launches=launches[key],
             max_abs_err=results[name]["max_abs_err"],
             ms=results[name]["ms"], plain_ms=results[name]["plain_ms"],
             bound_ms=results[name]["bound_ms"],
             bound_by=results[name]["bound_by"], library_ms=None)
        for name, key, _, replaces, source in SCANS + (DEC, MQ,
                                                       MQ_DEC)]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
