#!/usr/bin/env python3
"""Smoke test of the torch port on one CUDA GPU: build, check, run, time.

Drives the port's paths: at BASELINE config 1 (512x512 8-bit gray, 5/3,
6 resolutions, 64x64 code-blocks, 64 frames in 32-frame chunks) the
fused HT lossless encode through
`grokimagecompression_tpu_torch.codestream.encoder.encode_batch`, its
decode mirror through `codestream.decoder.decode_batch`, the Part-1 MQ
lossless encode (default code-block style 0) through `encode_batch`, its
decode mirror through `decode_batch`, and the dense MQ scan through its
entry point `ops/mq_scan.run_mq_scans`; at BASELINE config 2 (2048x2048
8-bit RGB, ICT + 9/7, 6 resolutions, three quality layers at compression
ratios 24, 48 and 96, PCRD rate control; 4 frames) the rate-controlled
MQ encode through `encode_batch` (2-frame chunks, then the default
chunk), its decode through `decode_batch`, and a layer-limited decode;
and at config 2 with the HT block coder on 9/7 the encode at the default
base step, its decode, and the encode at ratio 24 (1 bpp) by the search
of each frame's quantizer step; and the rest of the batch decode's gate
through `decode_batch`: the config-2 HT 9/7 frames with COC, POC and PPM
as JP2 files, the config-1 frames with a POC and PPT as JP2 (HT) and with
COC and PPM (MQ), and the tests/corpus streams; and the profile encodes
(digital cinema 2K and 4K at 12 bits with their frame and per-component
byte caps, broadcast, IMF) through `codestream.profiles` and
`encode_batch(..., rsiz=, layer_alloc=)`, and the decode of the cinema
streams; and the per-image decode of windows, reduced resolutions,
single tiles and layer limits through `codestream.decoder.decode` and
`codec.decompress` on a 10980^2 12-bit HT mosaic and a 4096^2 RGB MQ
image; and the per-image encode through `codestream.encoder.encode`
(same-plan tiles coded together), image-wide PCRD (`rate_alloc=
"global"`) and the codec's encode API (`codec.compress`,
`compress_batch`, `Codec`) on the same images and at BASELINE widths;
and the MQ code-block styles other than the default (the transform on
the card, the host Tier-1 coder) through `encode_batch`, `decode_batch`,
the tools and `StreamEncoder` at config 1 and config 2.
It checks every CUDA kernel on those paths against its plain PyTorch
version, and imports only the port, torch, numpy and the standard
library.

Phases, each fatal on failure:
  1. the card (nvidia-smi name and power limit) and the software versions;
  2. building the CUDA kernels from csrc/*.cu with nvcc (one process per
     source, all started together) and the port's host library from
     csrc/host/*.cpp with g++;
  3. the kernels at the main paths' shapes, each equal to its plain
     version and both timed with CUDA events (the HT encoder, the HT
     decoder and the MQ decoder held to it on `plain_lanes` of a group
     past 128 lanes: its 64 deepest lanes and 64 spread ones): the HT
     cleanup encoder on the three shape groups of one chunk (the plain
     version: torch op streams, plain scans, metrics, word placement and
     the host splice; on the 64x64 group its device time by
     torch.profiler, the lane with the most MagSgn bytes timed alone, the
     cycles of its stages (clock64 in an instrumented build) on that lane
     and on a block of the whole group, and the trial of its code-blocks a
     CTA and coder placement, also on a
     config-2 HT 9/7 group of 6144 lanes, where 256 lanes are held to the
     plain version), the HT decoder on
     the raw segments of the three lane groups of one chunk of the encoded
     streams (against the host prepass and the plain decoder; the lane with
     the most MagSgn bytes timed alone; the threads trial of its lanes a
     block and threads a lane on each group and on a config-2 HT 9/7 group
     of 6144 lanes), the MQ coder
     on the slot streams of the three MQ shape groups of one chunk (the
     plain version steps over each lane's coding slots only: the others
     leave its coder as it is), the MQ decoder on the three lane groups of
     one chunk of MQ streams (16x16 and 32x32 at full depth; 64x64 at full
     depth when the plain version's time, estimated from the 32x32 group,
     is at most 90 s, else every lane cut to its first 3 passes for the
     comparison; the kernel is timed at full depth, beside its time
     before its redesign),
     the lanes-per-block trials of both MQ kernels on the 64x64 group,
     and of the coder on a config-2 2-frame group (each source built with
     every lane count of LANE_TRIALS, each build bit-exact with the
     shipped kernel, all timed in turns), the DWT forward and
     inverse, 5/3 and 9/7, at the config-1 chunk shape, the config-2 frame
     shape, an odd-origin rect, a rect with single-sample levels and one a
     sample wider and higher than the kernel's tile (one launch per level
     and direction; both main shapes timed forward and inverse), and
     the MQ coder's pass-end byte-outs on 64 lanes of the config-2 group
     (cut to the planes whose coding the plain version does in ~30 s),
     and the dense MQ scan (flat and blocked) on 128 lanes of the config-1
     64x64 group cut to its leading planes, with 256 no-op rows past the
     stream; then `run_mq_scans` on the whole group (188,416 x 2016
     slots), every lane's words and partial word equal to the compact
     kernel's segment before its flush tail, its call and device time,
     the lane with the most coding slots alone, block 0's stage clocks (an
     instrumented build) and the trial of its lanes a warp x warps a
     block, also on the config-2 2-frame group (whose words are held to
     the compact kernel's segments too);
  4. the encode slice: the 64 frames and the 64 streams of
     encode_batch(device="cuda") against the SHA-256 digests of
     grokimagecompression_tpu_torch/data/config1_ht_lossless.json (the
     frames, and the reference host encoder's streams), the HT encoder
     kernel launched on every shape group and the DWT launched by that
     run, and the torch op streams (`ht_torch.op_streams`) and the host
     splice (`ht_tables.assemble_segments_host`) called by none of it;
     MP/s (best of 3) and one chunk's time by stage;
  5. the decode slice: the 64 streams through decode_batch(device="cuda"),
     every frame equal to its source, the decode kernel and the DWT
     launched by that run and the host prepass called by none of it; MP/s
     (best of 3) and one chunk's time by stage;
  6. the MQ encode slice: the 64 frames through encode_batch(device=
     "cuda") with cblk_style 0, every stream against
     grokimagecompression_tpu_torch/data/config1_mq_lossless.json (the
     reference host encoder's), the MQ kernel and the DWT launched by that
     run; MP/s (best of 3) and one chunk's time by stage;
  7. the MQ decode slice: the 64 MQ streams of phase 6 through
     decode_batch(device="cuda"), every frame equal to its source, the MQ
     decoder and the DWT launched by that run; MP/s (best of 3) and one
     chunk's time by stage;
  8. the config-2 encode slice: the 4 frames through encode_batch(device=
     "cuda", chunk=2), every stream against
     grokimagecompression_tpu_torch/data/config2_pcrd_97.json (the
     reference host encoder's, run with its numpy DWT), the DWT and the MQ
     kernel launched by that run; each layer's bytes, MP/s (best of 3),
     one chunk's time by stage and the peak device memory;
  9. the config-2 decode: the 4 streams through decode_batch(device=
     "cuda"), every frame's pixels against the host decoder's digests in
     grokimagecompression_tpu_torch/data/config2_decode_97.json (numpy
     DWT), the MQ decoder and the DWT launched; MP/s (best of 3), peak
     device memory and the chunk's time by stage;
 10. frame 0 encoded with rates (96, 48, 24), so that every layer carries
     data, against that file's stream digest, and decoded at layers 1, 2
     and all: the host decoder's pixels each time, three different MSEs;
 11. the 4 frames through encode_batch at its default chunk, which the
     plan's bytes a frame (`fused_encode.mq_frame_bytes`) and the free
     device memory cap: the streams against the digests, and the peak
     device memory measured beside the model's prediction;
 12. (a) the config-2 HT 9/7 encode: the 4 frames through encode_batch(
     device="cuda") with cblk_style 0x40 at the default base step and
     chunk, every stream against grokimagecompression_tpu_torch/data/
     config2_ht_97.json (the reference host encoder's, numpy DWT), the
     DWT and the HT encoder launched and the plain HT encoder, the torch
     op streams and the host splice called by none of it; MP/s (best of
     3), one chunk's time by stage and the peak device memory beside
     `fused_encode.ht_frame_bytes`;
 13. (b) those streams through decode_batch(device="cuda"): every frame's
     pixels against the host decoder's digests in the same file, the HT
     decoder and the DWT launched, the host prepass not called; MP/s
     (best of 3) and the chunk's time by stage;
 14. (c) the 4 frames at rates=(24.0,) (1 bpp), HT rate control: every
     stream against the file's digests and within its target, every
     probe launching the HT encoder, none of the plain versions called;
     per frame its search calls, probe launches and confirm encodes;
     MP/s (best of 3) and the time split into transform + gather, probes
     (with their device span), confirm encodes and host T2;
 15. the 4 config-2 frames of phase 12 (HT 9/7, default base step)
     encoded with 32x32 blocks in the chroma components (COC), a POC
     (RLCP over resolutions 0-2, then CPRL) and PPM markers, wrapped as JP2
     files, through decode_batch(device="cuda"): the pixels of the host
     decoder's digests in config2_ht_97.json (one HT cleanup pass at a
     fixed step codes every quantized coefficient whatever the blocks,
     order, packed headers or container), the HT decoder launched on both
     block shapes and the DWT, the plain decoders and the host prepass
     called by none of it; MP/s (best of 3) and the stages (unwrap, T2,
     which is the Python packed-header parse here, lane packing, kernel,
     inverse DWT, fetch), beside the same for phase 13's streams;
 16. the 64 config-1 frames through decode_batch(device="cuda") as HT
     streams with a POC and PPT markers wrapped as JP2, and as MQ streams
     with 32x32 blocks by COC and PPM markers: every frame equal to its
     source, the HT decoder, the MQ decoder and the DWT launched, no plain
     decoder or host prepass called; MP/s (best of 3) each;
 17. every tests/corpus stream (60 of 60: a custom MCT, ROI and the MQ
     code-block styles other than 0 among them), on the card alone and as
     a batch of two copies, against the host decoder's planes in
     grokimagecompression_tpu_torch/data/corpus_decode.json; a 9/7 HT
     stream with a QCC for component 1 decodes on the card as on the
     CPU;
 18. the profile encodes at full size, frames made as the reference's
     bench_chip_cinema makes them (12-bit RGB ramps plus texture): cinema
     2K (2048x1080) at 24 and 48 fps, 4 frames through encode_batch(
     device="cuda", rsiz=, layer_alloc=) with the profile's allocator
     (`profiles.profile_allocator`; frame 0 also through
     `profiles.encode_with_profile`), cinema 4K (4096x2160, two POC
     volumes) at 24 fps, 2 frames, and one frame each of broadcast single
     (1920x1080) and IMF 2K and 2K_R through encode_with_profile: every
     stream against grokimagecompression_tpu_torch/data/
     cinema_profiles.json (the reference host encoder's
     encode_with_profile, numpy DWT), within the profile's frame cap and
     every component's packet bytes (the port's `tile.index_tile_packets`)
     within its component cap, with the profile's rsiz and, for cinema, a
     TLM marker; the MQ coder and the DWT launched by each encode and no
     plain version called; the cinema streams through decode_batch(
     device="cuda") to the host decoder's pixel digests in the same file,
     the MQ decoder and the DWT launched, no plain decoder called; MP/s
     (best of 3) of each cinema encode and decode beside the 53.08 MP/s of
     2K at 24 fps, one 2K chunk's encode and decode stages (with the rate
     control's simulator calls, total and per-component), the peak device
     memory beside `mq_frame_bytes`, and the MQ coder (every shape group,
     64 lanes at their leading planes), the MQ decoder (every lane group of
     frame 0, the first 3 passes, on `plain_lanes` of each group) and the
     DWT (2K and 4K frames, 5/3 and
     9/7) against their plain versions at the cinema shapes, with the
     whole 32x32 group's and the frames' call ms beside their bounds;
 19. the per-image decode (`decoder.decode`, `codec.decompress`): at
     small size (WIN_CODINGS: 300x260 RGB in 96x96 tiles at an odd image
     offset, 5/3 HT and 9/7 MQ in three layers, encoded on the card to
     the host encoder's streams) every request of `window_requests`
     through decode and decode_batch against the reference host
     decoder's pixel digests in grokimagecompression_tpu_torch/data/
     window_decode.json; the CUDA inverse DWT at every max_res of S1's
     and S2's tile shapes against its plain version; then at full size S1
     (10980^2 gray 12-bit, 1024^2 tiles, HT 5/3, lossless) and S2 (4096^2
     RGB, 512^2 tiles, config 2's 9/7 MQ coding) encoded through
     encode_batch (peak device memory beside the plans' model), and the
     whole image, a 600^2 window across four tiles, a 2048^2 window at
     reduce 2, a window clipped by the corner, reduce 1, 3 and 5 (on S2
     also the first layer at reduce 5), an interior and the corner tile
     through decoder.decode, each with its launches (the HT or MQ
     decoder, and the DWT where whole tiles are inverted), best of 3 ms,
     output MP/s and stages, and 16 seeded 600^2 windows through
     codec.decompress: S1's whole decode equals the source, every window
     and tile the crop of the whole decode at its reduction, S1's
     reductions the LL of each tile's forward DWT;
 20. the per-image encode, image-wide PCRD and the codec's encode API:
     (a) at small size (IMG_ENC_CASES: 72x56 gray and RGB at an odd
     image offset in 32^2 or 16^2 tiles, HT and MQ, 5/3 and 9/7, POC,
     byte and PSNR targets with per-tile and global allocation, HT at
     ratio 24, tile-parts with PLT and TLM, PPT, PPM, COC) every case
     through encoder.encode and Codec(params=), every IMG_COMPRESS route
     through codec.compress and every preset in both containers through
     Codec(preset=, container=) against the reference host encoder's
     digests in grokimagecompression_tpu_torch/data/image_encode.json,
     and codec.decompress_batch of phase 15's COC + POC + PPM JP2 files
     between plain streams, each equal to its lone decode; (b) S1 and (c)
     S2 through encoder.encode, each stream equal to phase 19's
     encode_batch([img]), the coder launched at most (shape groups x
     chunks) a plan, seconds and MP/s (best of 2), stages, peak device
     memory beside the plans' model x tiles a chunk; the MQ coder on
     S2's stacked 64-tile group timed beside its bound; S2 with
     rate_alloc="global": every layer within its target plus 600 B or
     empty, its decode's MSE at most 1.001 x the per-tile allocation's,
     the allocator's time and simulator calls; (d) codec.compress and
     compress_batch of the config-2 frames at ratios 24 / 48 / 96 and
     compress_batch of the config-1 frames with and without ht against
     their digest files, MP/s (best of 3) beside encode_batch's, and
     every preset's JP2 of config-2 frame 0 decoded on the card through
     Codec.decompress_image. No plain version runs in any of its encodes
     or decodes;
 21. the command-line tools (`cli_phase`), in-process on the card;
 22. the streaming API and the requests the reference codes on its host
     tile path (`route_phase`): (a) S1 through stream.StreamEncoder tile
     by tile into a file, every tile-part equal to encoder.encode's (TLM
     markers on), W1's four tiles and the corner tile through
     StreamDecoder.decode_tile equal to the source's crops and the whole
     StreamDecoder.decode lossless, with seconds a tile, launches and
     peak device memory beside encode's; (b) config-2 frame 0 with ROI on
     component 0 at shift 6 and at the largest shift within the MQ
     decoder's 30 planes (`roi_max_shift`), and (c) with the custom MCT
     of CUSTOM_MCT, MQ at ratios 24 / 48 / 96 and HT at the default step,
     through encoder.encode against the reference host encoder's streams
     in grokimagecompression_tpu_torch/data/host_routes.json and through
     decode_batch against its host decoder's pixels, the MQ coder and
     decoder against their plain versions on the ROI frame's 64x64 group;
     (d) the small override and COC streams (`override_stream`,
     `coc_stream` on `route_small_frame`) against the same file's streams
     and pixels, S2 with a tile-part COD (32x32 blocks, RPCL) and QCD (base
     step 2) in every fourth tile decoded tile by tile to the decodes of
     the two codings it was spliced from, and config-2 frame 0 with
     component 1 on 5/3 at 5 resolutions (COC, QCC) decoded in two
     component groups, component 1 lossless and 0 and 2 equal to the
     coding without the COC. Every run launches its kernels and no plain
     version;
 23. multi-device coding (`mesh_phase`), with the machine's device count
     (on one card; `tools/mesh_check.py` runs this phase alone, on every
     card there is): (a) S1 through parallel.sharding.encode_sharded on
     [cuda:0] and on [cuda:0, cuda:0] beside encoder.encode, each stream
     equal to phase 20's, and S2 at rate_alloc="global" on two shards
     equal to phase 20's global stream, seconds (first, second run) and
     each shard's tiles, stacked calls, coder launches and seconds; (b)
     sharding.decode_sharded of S1 whole and of W1 on two shards equal to
     phase 19's decodes; (c) parallel.multihost.encode_multihost in two
     processes of a gloo group (this script with --multihost-worker), both
     on cuda:0, of config-2 frame 0 in 512^2 tiles at ratios 24 / 48 / 96
     with image-wide PCRD and of S1, every rank's stream equal to the
     one-process encode's, each rank's seconds and its seconds in
     collectives. On n > 1 cards the meshes are [cuda:1, cuda:2] and all
     n cards, and n processes take a card each. Every run launches its
     kernels and no plain version;
 24. the MQ code-block styles other than the default on the host Tier-1
     route (`t1_phase`): (a) config 1's 64 frames at style 0x01 (BYPASS)
     through encode_batch against grokimagecompression_tpu_torch/data/
     config1_mq_styles.json (the reference host encoder's streams) and
     back through decode_batch to the sources, MP/s (best of 3) beside
     phases 6 and 7, one chunk's stages (the transform on the card, the
     fetch, the host T1, T2); (b) config-2 frame 0 at 0x3F (all six
     Part-1 styles) and at 0x14 (TERMALL | PTERM), ratios 24 / 48 / 96,
     and at 0x3F with ratios 96 / 48 / 24, streams and pixels (whole and
     at layers=1) against config2_mq_styles.json, with stages and peak
     device memory; (c) the 10 corpus streams of those styles through
     decode_batch; (d) the tools' MQ-style cases of CLI_CASES; (e)
     config-2 frame 0 in 512^2 tiles through StreamEncoder at 0x01, its
     tile-parts equal to encode's. Every run calls the host coder and
     launches the DWT and no MQ kernel; phases 4-7 (the default MQ style
     and HT) call the host coder not at all;
 25. HT refinement passes, HT under an explicit rate allocator and deep
     HT bands (`refine_phase`), against grokimagecompression_tpu_torch/
     data/ht_refine.json (the reference host codec's streams and pixels):
     (a) config 1's first 8 frames with refinement through encode_batch
     and back through decode_batch to the sources, MP/s (best of 3) and
     one chunk's stages (transform on the card, fetch, host T1, T2; T2,
     host T1 into band planes, upload, inverse on the card, fetch); (b)
     config-2 frame 0 (ICT + 9/7) with refinement through encode and
     decode, whole, at reduce 1 and in a window, with stages; (c) the same
     frame at three layers under a PCRD allocator at 24 / 48 / 96 (the
     refinement dropped, as the reference drops it: the HT encoder
     kernel's route, the host coder not called), decoded whole and at
     layers=1; (d) a 512^2 28-bit 5/3 frame (`deep_frame`: HH bands of
     Mb 30) through encode (the HT encoder kernel) and decode (the host
     cleanup decoder: Mb + 3 > 32) back to the source; (e) the tools at
     REFINE_CLI_CASES (grk_compress --ht-refinement, grk_decompress).
     The refined and deep routes call the host coder, launch the DWT and
     launch no HT encoder or decoder;
Phase 3 also times the 9/7 forward DWT at the config-2 shape in a child
process that loads only the shipped kernel library (the profiler's
launch-count check holds there). The line before the last is a JSON
object with one entry per kernel,
whose `launches` counts the calls of what its `ms` times on the kernel's
path (a whole DWT; a group kernel on the timed 64x64 group) plus, for the
MQ coder, the MQ decoder and the DWT, their launches in phase 18's
encodes and decodes, for both decoders and the DWT their launches in
phase 19's full-size requests, and for every kernel but the dense scan
its launches in phase 20's encodes and decodes, phase 21's tool runs,
phase 22's streams and requests and phase 23's sharded and
multi-process runs (the worker processes' launches included), and for
the DWT its launches in phase 24, and for the DWT, the HT encoder and
the HT decoder their launches in phase 25; the last
line is {"ok": true,
"device": {...}}.

Run from the repository root: python3 chip_smoke.py (needs one CUDA card;
exits non-zero without one).
"""

from __future__ import annotations

import contextlib
import dataclasses
import hashlib
import inspect
import io
import json
import os
import re
import subprocess
import sys
import time
import warnings

FRAMES = 64
CHUNK = 32
SIZE = 512
DIGESTS = os.path.join("grokimagecompression_tpu_torch", "data",
                       "config1_ht_lossless.json")
MQ_DIGESTS = os.path.join("grokimagecompression_tpu_torch", "data",
                          "config1_mq_lossless.json")
# (name, LAUNCHES key, plain-version name, TPU kernel it replaces, source)
ENC = ("ht_encode", "enc", "encode_segments_plain",
       "grokimagecompression_tpu/ops/ht_scan_pallas.py:175 and :257",
       "grokimagecompression_tpu_torch/csrc/ht_enc.cu")
DEC = ("ht_dec_group", "dec", "decode_group_plain",
       "grokimagecompression_tpu/ops/ht_dec_pallas.py:534",
       "grokimagecompression_tpu_torch/csrc/ht_dec.cu")
MQ = ("mq_scan", "mq", "mq_scan_plain",
      "grokimagecompression_tpu/ops/mq_scan_pallas.py:61",
      "grokimagecompression_tpu_torch/csrc/mq_scan.cu")
MQ_DEC = ("mq_dec_group", "mq_dec", "decode_group_plain",
          "grokimagecompression_tpu/ops/mq_dec_pallas.py:594",
          "grokimagecompression_tpu_torch/csrc/mq_dec.cu")
DWT = ("dwt", "dwt", "dwt_torch",
       "grokimagecompression_tpu/ops/dwt_pallas.py:254 and :307",
       "grokimagecompression_tpu_torch/csrc/dwt.cu")
MQ_DENSE = ("mq_scan_dense", "mq_dense", "mq_scan_dense_plain",
            "grokimagecompression_tpu/ops/mq_scan_pallas.py:203",
            "grokimagecompression_tpu_torch/csrc/mq_dense.cu")
# BASELINE config 2: 2048x2048 8-bit RGB, ICT + 9/7, three layers at
# compression ratios 24 / 48 / 96 (the reference's bench_chip_pcrd2k)
C2_FRAMES = 4
C2_CHUNK = 2
C2_SIZE = 2048
C2_DIGESTS = os.path.join("grokimagecompression_tpu_torch", "data",
                          "config2_pcrd_97.json")
C2_DEC_DIGESTS = os.path.join("grokimagecompression_tpu_torch", "data",
                              "config2_decode_97.json")
C2_HT_DIGESTS = os.path.join("grokimagecompression_tpu_torch", "data",
                             "config2_ht_97.json")
# the profile encodes (ROADMAP Queue A 4): digital-cinema 2K frames
# (2048x1080 12-bit RGB, as the reference's bench_chip_cinema makes them)
# at 24 and 48 fps, 4K frames (4096x2160) at 24 fps, and one frame each for
# the broadcast and IMF profiles at the settings of tests/test_profiles.py;
# per case (name, frame set, profile function, EncoderParams arguments,
# profile arguments). Frame set "2k0" is frame 0 of "2k".
CIN_FRAMES = {"2k": (4, 2048, 1080), "4k": (2, 4096, 2160),
              "bc": (1, 1920, 1080)}
CIN_CASES = (
    ("cinema2k_24", "2k", "apply_cinema", {}, {"fps": 24}),
    ("cinema2k_48", "2k", "apply_cinema", {}, {"fps": 48}),
    ("cinema4k_24", "4k", "apply_cinema", {"numresolutions": 7},
     {"four_k": True}),
    ("broadcast", "bc", "apply_broadcast", {"numresolutions": 7},
     {"level": 3}),
    ("imf2k", "2k0", "apply_imf", {"numresolutions": 9},
     {"variant": "2k", "mainlevel": 2, "sublevel": 1}),
    ("imf2k_r", "2k0", "apply_imf", {"numresolutions": 9},
     {"variant": "2k_r", "mainlevel": 2, "sublevel": 1}),
)
CIN_DIGESTS = os.path.join("grokimagecompression_tpu_torch", "data",
                           "cinema_profiles.json")
# the real-time rate of 2K digital cinema at 24 fps (2048 x 1080 x 24
# samples a second a component): a property of the format
CIN_REALTIME_MPS = 2048 * 1080 * 24 / 1e6
# the reference host decoder's planes of the tests/corpus streams that
# decode_batch takes, and the names of those it refuses
CORPUS = os.path.join("tests", "corpus")
CORPUS_DIGESTS = os.path.join("grokimagecompression_tpu_torch", "data",
                              "corpus_decode.json")
# the per-image decode's requests at small size (phase 19, and
# tests/test_torch_window_decode.py on the CPU): two 300x260 RGB 8-bit
# frames (`window_frames`) at an odd image offset in 96x96 tiles (12
# tiles, of 12 geometries), coded 5/3 HT on 4 resolutions and 9/7 MQ on 3
# with three layers, 8x8 code-blocks (the CPU test's plain decoders take
# one torch step a quad pair or decision of a lane group's deepest lane);
# each request decoded to the reference host decoder's pixel digests in
# WIN_DIGESTS
WIN_DIGESTS = os.path.join("grokimagecompression_tpu_torch", "data",
                           "window_decode.json")
WIN_SIZE = (300, 260)
WIN_CODINGS = {
    "ht53": dict(numresolutions=4, cblk_style=0x40, tile_size=(96, 96),
                 image_offset=(5, 3), cblk_w_exp=3, cblk_h_exp=3),
    "mq97": dict(numresolutions=3, transform="DWT_97", numlayers=3,
                 rates=(192.0, 96.0, 48.0), tile_size=(96, 96),
                 image_offset=(5, 3), cblk_w_exp=3, cblk_h_exp=3),
}
# DecoderParams arguments: the whole image, each reduction (5: more than
# the levels), windows across four tiles alone, reduced and
# layer-limited, one clipped by the image's bottom-right corner, an
# interior and the corner tile, layer limits (MQ only: HT has one layer)
WIN_REQUESTS = (
    {}, {"reduce": 1}, {"reduce": 2}, {"reduce": 3}, {"reduce": 5},
    {"window": (40, 30, 170, 150)},
    {"window": (40, 30, 170, 150), "reduce": 1},
    {"window": (101, 97, 190, 200), "reduce": 2},
    {"window": (250, 200, 400, 400)},
    {"window": (40, 30, 170, 150), "layers": 1},
    {"tile_index": 5}, {"tile_index": 11}, {"tile_index": 11, "reduce": 1},
    {"layers": 1}, {"layers": 2, "reduce": 2},
)
# the per-image encode and the codec's encode API at small size (phase 20
# (a), and tests/test_torch_image_encode.py on the CPU): a gray and an RGB
# 8-bit frame (`image_encode_frames`) at an odd image offset in 32x32 or
# 16x16 tiles (several plans, interior tiles sharing one), 3
# resolutions, 8x8 code-blocks; each IMG_ENC_CASES entry (frame, then
# EncoderParams arguments over IMG_ENC_BASE) through `encoder.encode`,
# each IMG_COMPRESS entry (`codec.compress` options) on a crop of the RGB
# frame, and each `codec.PRESETS` entry in both containers through
# `codec.Codec(...).compress_image` of a gray crop, against the
# reference host encoder's stream digests in IMG_ENC_DIGESTS
IMG_ENC_DIGESTS = os.path.join("grokimagecompression_tpu_torch", "data",
                               "image_encode.json")
IMG_ENC_SIZE = (72, 56)
IMG_ENC_BASE = dict(numresolutions=3, tile_size=(32, 32),
                    image_offset=(5, 3), cblk_w_exp=3, cblk_h_exp=3)
# POC volumes (rs, cs, lye, re, ce, progression)
IMG_ENC_POCS = ((0, 0, 1, 2, 3, "RLCP"), (2, 0, 1, 3, 3, "CPRL"))
IMG_ENC_CASES = {
    "ht53": ("rgb", dict(cblk_style=0x40, tile_size=(16, 16))),
    "mq53_poc": ("rgb", dict(pocs=IMG_ENC_POCS)),
    "mq97_layers": ("gray", dict(transform="DWT_97", numlayers=3,
                                 rates=(12.0, 6.0, 3.0))),
    "mq97_layers_global": ("gray", dict(transform="DWT_97", numlayers=3,
                                        rates=(12.0, 6.0, 3.0),
                                        rate_alloc="global")),
    "mq97_psnr_global": ("gray", dict(transform="DWT_97",
                                      quality_psnr=(30.0, 36.0),
                                      tile_size=(16, 16),
                                      rate_alloc="global")),
    # HT's search of the quantizer step reaches ratio 24 at this size only
    # on a smooth frame in one tile with 16x16 blocks: the tiles' and
    # blocks' overhead of the others outgrows the target, and the
    # reference's QCD fails on the steps past it
    "ht97_rate": ("c2", dict(cblk_style=0x40, transform="DWT_97",
                             rates=(24.0,), tile_size=(64, 64),
                             cblk_w_exp=4, cblk_h_exp=4)),
    "tp_r_plt_tlm": ("rgb", dict(cblk_style=0x40, tp_flag="R",
                                 plt_markers=True, tlm_markers=True)),
    "ppt": ("gray", dict(cblk_style=0x40, ppt_markers=True)),
    "ppm": ("rgb", dict(cblk_style=0x40, ppm_markers=True)),
    "coc": ("rgb", dict(cblk_style=0x40, comp_cblk_exps={1: (4, 4)})),
}
IMG_COMPRESS = {
    "lossless": {}, "ht": {"ht": True}, "ratio": {"ratio": [16.0, 8.0]},
    "psnr": {"psnr": 34.0}, "prec12": {"prec": 12},
    "tile_size": {"tile_size": (32, 32)},
}
# the command-line tools at small size (phase 21 (a)): the seeded inputs
# of `cli_inputs` in every format the tools read (64 x 48; "@name" is a
# path in the cases' directory), and the tool runs on them in order, each
# (name, tool, arguments): grk_compress, grk_decompress and grk_dump, and
# the files made between runs ("palette", "icc", "cielab": a JP2 file of
# the stream named around a pclr / cmap box, an ICC colr box or the
# CIELab colour space; "plt": the
# library's stream of gray.pgm with PLT and TLM markers). Their outputs'
# SHA-256, as the reference's tools write them, are in CLI_DIGESTS.
CLI_DIGESTS = os.path.join("grokimagecompression_tpu_torch", "data",
                           "cli.json")
CLI_SIZE = (64, 48)
CLI_RAW = {"g12.raw": "64,48,1,12,u", "sub.rawl": "64,48,3,8,u@1x1:2x2:2x2"}
CLI_CASES = (
    # grk_compress: the flag lines
    ("lossless MQ", "compress", ["-i", "@gray.pgm", "-o", "@gray.j2k",
                                 "-n", "4"]),
    ("HT", "compress", ["-i", "@rgb.ppm", "-o", "@rgb_ht.j2k", "-n", "4",
                        "-M", "64"]),
    ("9/7 rates", "compress", ["-i", "@rgb.ppm", "-o", "@rgb_r.j2k", "-n",
                               "4", "-I", "-r", "20,10"]),
    ("PSNR layers", "compress", ["-i", "@gray.pgm", "-o", "@gray_q.j2k",
                                 "-n", "4", "-I", "-q", "30,40"]),
    ("tiles and offsets", "compress", ["-i", "@rgb.ppm", "-o", "@rgb_t.j2k",
                                       "-n", "3", "-t", "32,32", "-d", "5,3",
                                       "-T", "2,1"]),
    ("RPCL", "compress", ["-i", "@gray.pgm", "-o", "@gray_rpcl.j2k", "-n",
                          "4", "-p", "RPCL"]),
    ("SOP EPH", "compress", ["-i", "@gray.pgm", "-o", "@gray_se.j2k", "-n",
                             "4", "-S", "-E"]),
    ("tile-parts R", "compress", ["-i", "@rgb.ppm", "-o", "@rgb_tp.j2k",
                                  "-n", "3", "-t", "32,32", "-u", "R"]),
    ("POC", "compress", ["-i", "@rgb.ppm", "-o", "@rgb_poc.j2k", "-n", "4",
                         "-P", "T0=0,0,1,3,3,CPRL/T0=3,0,1,4,3,LRCP"]),
    ("precincts", "compress", ["-i", "@gray.pgm", "-o", "@gray_c.j2k", "-n",
                               "4", "-c", "[32,32][16,16]"]),
    ("blocks 32", "compress", ["-i", "@gray.pgm", "-o", "@gray_b.j2k", "-n",
                               "4", "-b", "32,32"]),
    ("global PCRD", "compress", ["-i", "@rgb.ppm", "-o", "@rgb_g.j2k", "-n",
                                 "3", "-I", "-r", "20", "-t", "32,32",
                                 "--rate-alloc", "global"]),
    ("JP2 resolutions", "compress", ["-i", "@rgb.ppm", "-o", "@rgb.jp2",
                                     "-n", "4", "-Q", "2835,2835",
                                     "--display-res", "3780,3780"]),
    ("directory", "compress", ["-y", "@dir", "-O", "J2K", "-a", "@dir_j2k",
                               "-n", "4", "-M", "64"]),
    ("ROI", "compress", ["-i", "@rgb.ppm", "-o", "@rgb_roi.j2k", "-n", "4",
                         "-R", "c=0,U=4"]),
    ("custom MCT", "compress", ["-i", "@rgb.ppm", "-o", "@rgb_mct.j2k",
                                "-n", "4", "-m", "@mct.txt"]),
    ("MQ styles lazy", "compress", ["-i", "@rgb.ppm", "-o", "@rgb_lazy.j2k",
                                    "-n", "4", "-M", "1"]),
    ("MQ styles all", "compress", ["-i", "@gray.pgm", "-o", "@gray_sty.j2k",
                                   "-n", "4", "-I", "-r", "20,10", "-M",
                                   "63"]),
    # grk_compress: every input format
    ("in PGM 12-bit", "compress", ["-i", "@g12.pgm", "-o", "@g12.j2k", "-n",
                                   "4", "-M", "64"]),
    ("in PGX signed", "compress", ["-i", "@s12.pgx", "-o", "@s12.j2k", "-n",
                                   "4"]),
    ("in BMP", "compress", ["-i", "@rgb.bmp", "-o", "@bmp.j2k", "-n", "4"]),
    ("in TGA", "compress", ["-i", "@rgb.tga", "-o", "@tga.j2k", "-n", "4",
                            "-M", "64"]),
    ("in PNG RGBA", "compress", ["-i", "@rgba.png", "-o", "@rgba.jp2", "-n",
                                 "4"]),
    ("in PNG 16", "compress", ["-i", "@rgb16.png", "-o", "@rgb16.j2k", "-n",
                               "4", "-M", "64"]),
    ("in TIFF LZW", "compress", ["-i", "@rgb_lzw.tif", "-o", "@lzw.j2k",
                                 "-n", "4"]),
    ("in TIFF LZW 16", "compress", ["-i", "@g16_lzw.tif", "-o",
                                    "@lzw16.j2k", "-n", "4", "-M", "64"]),
    ("in TIFF deflate", "compress", ["-i", "@rgb_zip.tif", "-o", "@zip.j2k",
                                     "-n", "4", "-M", "64"]),
    ("in TIFF deflate 16", "compress", ["-i", "@g16_zip.tif", "-o",
                                        "@zip16.j2k", "-n", "4"]),
    ("in raw", "compress", ["-i", "@g12.raw", "-o", "@raw.j2k", "-n", "4",
                            "-F", CLI_RAW["g12.raw"]]),
    ("in raw subsampled", "compress", ["-i", "@sub.rawl", "-o", "@sub.j2k",
                                       "-n", "3", "-F", CLI_RAW["sub.rawl"]]),
    ("in palette indices", "compress", ["-i", "@idx.pgm", "-o", "@idx.j2k",
                                        "-n", "3"]),
    ("palette JP2", "palette", ["@idx.j2k", "@pal.jp2"]),
    ("ICC JP2", "icc", ["@rgb_ht.j2k", "@icc.jp2"]),
    ("CIELab JP2", "cielab", ["@rgb_ht.j2k", "@lab.jp2"]),
    ("PLT TLM stream", "plt", ["@gray.pgm", "@plt.j2k"]),
    # grk_decompress: every output format, then the options
    ("out PGM", "decompress", ["-i", "@gray.j2k", "-o", "@gray_o.pgm"]),
    ("out PPM", "decompress", ["-i", "@rgb_ht.j2k", "-o", "@rgb_o.ppm"]),
    ("out PGX", "decompress", ["-i", "@s12.j2k", "-o", "@s12_o.pgx"]),
    ("out BMP", "decompress", ["-i", "@rgb_ht.j2k", "-o", "@rgb_o.bmp"]),
    ("out TGA", "decompress", ["-i", "@rgb_ht.j2k", "-o", "@rgb_o.tga"]),
    ("out PNG", "decompress", ["-i", "@rgb16.j2k", "-o", "@rgb16_o.png"]),
    ("out TIFF", "decompress", ["-i", "@rgb_ht.j2k", "-o", "@rgb_o.tif"]),
    ("out TIFF deflate", "decompress", ["-i", "@lzw16.j2k", "-o",
                                        "@g16_o.tif", "-c", "8"]),
    ("out raw", "decompress", ["-i", "@raw.j2k", "-o", "@g12_o.raw"]),
    ("out raw subsampled", "decompress", ["-i", "@sub.j2k", "-o",
                                          "@sub_o.rawl"]),
    ("reduce", "decompress", ["-i", "@gray.j2k", "-o", "@r1.pgm", "-r",
                              "1"]),
    ("layers", "decompress", ["-i", "@rgb_r.j2k", "-o", "@l1.ppm", "-l",
                              "1"]),
    ("window", "decompress", ["-i", "@rgb_t.j2k", "-o", "@win.ppm", "-d",
                              "10,8,50,40"]),
    ("tile", "decompress", ["-i", "@rgb_t.j2k", "-o", "@t1.ppm", "-t",
                            "1"]),
    ("force RGB", "decompress", ["-i", "@gray.j2k", "-o", "@frgb.ppm",
                                 "--force-rgb"]),
    ("split PNM", "decompress", ["-i", "@rgb_poc.j2k", "-o", "@split.ppm",
                                 "--split-pnm"]),
    ("precision scale", "decompress", ["-i", "@gray_rpcl.j2k", "-o",
                                       "@p10.pgm", "-p", "10S"]),
    ("precision clip", "decompress", ["-i", "@gray_se.j2k", "-o",
                                      "@p6.pgm", "-p", "6C"]),
    ("upsample", "decompress", ["-i", "@sub.j2k", "-o", "@up.ppm",
                                "--upsample"]),
    ("palette", "decompress", ["-i", "@pal.jp2", "-o", "@pal_o.ppm"]),
    ("cdef alpha", "decompress", ["-i", "@rgba.jp2", "-o", "@rgba_o.png"]),
    ("ICC", "decompress", ["-i", "@icc.jp2", "-o", "@icc_o.ppm"]),
    ("CIELab", "decompress", ["-i", "@lab.jp2", "-o", "@lab_o.ppm"]),
    ("9/7 tiles", "decompress", ["-i", "@rgb_g.j2k", "-o", "@g_o.ppm"]),
    ("out ROI", "decompress", ["-i", "@rgb_roi.j2k", "-o", "@roi_o.ppm"]),
    ("out custom MCT", "decompress", ["-i", "@rgb_mct.j2k", "-o",
                                      "@mct_o.ppm"]),
    ("MQ styles out lazy", "decompress", ["-i", "@rgb_lazy.j2k", "-o",
                                          "@lazy_o.ppm"]),
    ("MQ styles out all", "decompress", ["-i", "@gray_sty.j2k", "-o",
                                         "@sty_o.pgm", "-l", "1"]),
    ("directory decode", "decompress", ["-y", "@dir_j2k", "-a", "@dir_dec",
                                        "-O", "pgm"]),
    # grk_dump
    ("dump", "dump", ["-i", "@plt.j2k", "-o", "@plt_dump.txt", "-m", "-p"]),
    ("dump JP2", "dump", ["-i", "@rgb.jp2", "-o", "@jp2_dump.txt"]),
)
# Phase 22, the streaming API and the requests the reference codes on its
# host tile path, whose code-blocks the port's kernels code (ROI, a custom
# MCT, tile-part header overrides, a COC that changes a component's
# transform and resolutions). ROUTE_DIGESTS holds the reference host
# encoder's streams and host decoder's pixel digests of the config-2 frame
# 0 (`config2_frames`) at each ROUTE_CASES entry (EncoderParams arguments;
# "roi_max": the largest shift whose Kmax stays within the MQ decoder's
# 30 planes, `roi_max_shift`), and the reference host decoder's pixels of
# the small override and COC streams (ROUTE_SMALL: `override_stream`,
# `coc_stream`), which the port builds; tests/test_torch_host_copies.py
# writes it.
ROUTE_DIGESTS = os.path.join("grokimagecompression_tpu_torch", "data",
                             "host_routes.json")
# the decoding matrix of the reference's custom-MCT round trip
# (its tests/test_markers_ext.py)
CUSTOM_MCT = ((1.0, 0.2, 1.5), (1.0, -0.3, -0.6), (1.0, 1.9, 0.1))
ROUTE_C2 = dict(numresolutions=6, transform="DWT_97", numlayers=3,
                rates=(24.0, 48.0, 96.0))
ROUTE_CASES = {
    "roi6": dict(ROUTE_C2, roi_comp=0, roi_shift=6),
    "roi_max": dict(ROUTE_C2, roi_comp=0, roi_shift="max"),
    "mct_mq": dict(ROUTE_C2, custom_mct=CUSTOM_MCT),
    "mct_ht": dict(numresolutions=6, transform="DWT_97", cblk_style=0x40,
                   custom_mct=CUSTOM_MCT),
}
# the override and COC streams: every OVERRIDE_EVERY-th tile (0, 4, ...)
# of the base coding carries a tile-part COD and QCD (other code-block
# size and progression, another base step) and is coded with them; the
# COC gives COC_COMP its COC_CHANGE and that COD's default QCD (QCC), the
# MCT off. At full size the base coding is S2's at a fixed step
# (`full_params("S2")` without rates) on S2 and config 2's without MCT
# on config-2 frame 0; at small size (ROUTE_SMALL on `route_small_frame`)
# the same at 3 resolutions in 16x20 tiles with 8x8 blocks (the
# override's 32x32 blocks then cover each band whole, as they split S2's
# 64x64 ones)
OVERRIDE_EVERY = 4
OVERRIDE_TILE = dict(cblk_w_exp=5, cblk_h_exp=5, progression="RPCL",
                     base_step=2.0)
COC_COMP = 1
COC_CHANGE = dict(transform="DWT_53", numresolutions=-1)
ROUTE_SMALL = dict(numresolutions=3, transform="DWT_97",
                   tile_size=(16, 20), cblk_w_exp=3, cblk_h_exp=3)
# DecoderParams arguments of the small streams' digests: the whole image,
# and a window across an overridden and a plain tile at reduce 1
ROUTE_SMALL_REQUESTS = ({}, {"window": (5, 2, 30, 36), "reduce": 1})


# Phase 24, the MQ code-block styles other than the default on the host
# Tier-1 route (the transform on the card, the host library's Tier-1
# coder): config 1's 64 frames at T1_C1_STYLE through encode_batch and
# decode_batch; config-2 frame 0 at each of T1_C2_STYLES (all six Part-1
# styles, and TERMALL | PTERM) and at T1_C2_LAYERED's style and rates
# (whose first layer carries data) decoded whole and at layers=1; the
# config-2 frame in T1_STREAM_TILE tiles through StreamEncoder at
# T1_C1_STYLE. T1_C1_DIGESTS and T1_C2_DIGESTS hold the reference host
# encoder's streams and host decoder's pixels; tests/test_torch_t1_styles.py
# writes them.
T1_C1_STYLE = 0x01
T1_C2_STYLES = (0x3F, 0x14)
T1_C2_LAYERED = (0x3F, (96.0, 48.0, 24.0))
T1_STREAM_TILE = (512, 512)
T1_C1_DIGESTS = os.path.join("grokimagecompression_tpu_torch", "data",
                             "config1_mq_styles.json")
T1_C2_DIGESTS = os.path.join("grokimagecompression_tpu_torch", "data",
                             "config2_mq_styles.json")

# Phase 25, HT refinement passes (Part 15 full mode), HT under an explicit
# rate allocator and HT bands deeper than the CUDA HT decoder's word, on
# the host route where the reference takes it (the transform on the card,
# the host library's HT coder): REFINE_C1_FRAMES config-1 frames with
# refinement through encode_batch and decode_batch; config-2 frame 0 with
# refinement through encode and decode (whole, at reduce 1 and in
# REFINE_WINDOW) and at REFINE_ALLOC_RATES' allocator (three layers, the
# refinement dropped, on the CUDA HT coder), decoded whole and at layers 1;
# `deep_frame` (REFINE_DEEP_PREC bits, 5/3 HT: its HH bands have Mb 30,
# Mb + 3 > 32) through encode and decode; the tools at REFINE_CLI_CASES.
# HT_REFINE_DIGESTS holds the reference host codec's outputs of each, and
# the small case of tests/test_torch_ht_refine.py's `gpu` test; that file
# writes it.
HT_REFINE_DIGESTS = os.path.join("grokimagecompression_tpu_torch", "data",
                                 "ht_refine.json")
REFINE_C1_FRAMES = 8
REFINE_ALLOC_RATES = (24.0, 48.0, 96.0)
REFINE_WINDOW = (600, 400, 1400, 1000)
REFINE_DEEP_SIZE = 512
REFINE_DEEP_PREC = 28
REFINE_CLI_CASES = (
    ("HT refinement", "compress", ["-i", "@rgb.ppm", "-o", "@rgb_hr.j2k",
                                   "-n", "4", "-M", "64",
                                   "--ht-refinement"]),
    ("HT refinement 9/7", "compress", ["-i", "@gray.pgm", "-o",
                                       "@gray_hr.j2k", "-n", "4", "-I",
                                       "-M", "65", "--ht-refinement"]),
    ("decompress HT refinement", "decompress", ["-i", "@rgb_hr.j2k", "-o",
                                                "@rgb_hr.ppm"]),
    ("decompress HT refinement 9/7 at reduce 1", "decompress", [
        "-i", "@gray_hr.j2k", "-o", "@gray_hr.pgm", "-r", "1"]),
)


def route_small_frame():
    """The small frame of the override and COC streams: the top-left
    64 x 40 samples of `image_encode_frames`' RGB frame (8 tiles of
    ROUTE_SMALL)."""
    rgb = image_encode_frames()["rgb"]
    return dataclasses.replace(rgb, xsiz=64, ysiz=40, components=[
        dataclasses.replace(c, data=c.data[:40, :64].copy())
        for c in rgb.components])


def roi_max_shift():
    """The largest ROI shift of config 2's coding whose bands' Kmax (guard
    bits + exponent - 1 + shift) stays within the MQ decoder's 30 planes."""
    from grokimagecompression_tpu_torch.codestream import encoder
    from grokimagecompression_tpu_torch.codestream.tile import default_qcd
    from grokimagecompression_tpu_torch.core.params import (EncoderParams,
                                                            Transform)
    img = config2_frames(1, size=64)[0]
    p = EncoderParams(numresolutions=6, transform=Transform.DWT_97)
    siz, cod = encoder.build_siz(img, p), encoder.build_cod(img, p)
    qcd = default_qcd(siz, cod, p.num_guard_bits)
    return 30 - (qcd.num_guard_bits + max(e for e, _ in qcd.steps) - 1)


def route_params(params_mod, name):
    """The EncoderParams of a ROUTE_CASES entry, made with `params_mod`'s
    EncoderParams and Transform (the port's, or in the tests the
    reference's)."""
    import numpy as np
    kw = dict(ROUTE_CASES[name])
    kw["transform"] = getattr(params_mod.Transform, kw["transform"])
    if kw.get("roi_shift") == "max":
        kw["roi_shift"] = roi_max_shift()
    if "custom_mct" in kw:
        kw["custom_mct"] = np.asarray(kw["custom_mct"], np.float32)
    return params_mod.EncoderParams(**kw)


def override_params(params_mod, base):
    """(base, override) EncoderParams of an override stream: `base`
    (EncoderParams arguments, its transform by name), and `base` with
    OVERRIDE_TILE, made with `params_mod`'s classes."""
    kw = dict(base)
    kw["transform"] = getattr(params_mod.Transform, kw["transform"])
    over = dict(kw, **OVERRIDE_TILE)
    over["progression"] = getattr(params_mod.Progression,
                                  over["progression"])
    return params_mod.EncoderParams(**kw), params_mod.EncoderParams(**over)


def override_stream(base_cs, over_cs, every=OVERRIDE_EVERY):
    """A codestream with tile-part header overrides: `base_cs`'s main
    header and tile-parts, but every `every`-th tile's tile-part taken
    from `over_cs` (the same image and tiles coded with another COD and
    QCD) behind a tile-part COD and QCD of `over_cs`'s main header, its
    Psot grown to match (the port's tile-part walk and marker writers)."""
    from grokimagecompression_tpu_torch.codestream import decoder, markers
    from grokimagecompression_tpu_torch.codestream.markers import SotInfo
    ha, hb = decoder.read_header(base_cs), decoder.read_header(over_cs)
    parts = [{tp.tile_index: tp.body for tp in decoder.iter_tile_parts(
        cs, h.main_header_end)} for cs, h in ((base_cs, ha), (over_cs, hb))]
    out = bytearray(base_cs[:ha.main_header_end])
    for t in sorted(parts[0]):
        seg, body = b"", parts[0][t]
        if t % every == 0:
            seg = markers.write_cod(hb.cod) + markers.write_qcd(hb.qcd)
            body = parts[1][t]
        psot = 12 + len(seg) + 2 + len(body)
        out += markers.write_sot(SotInfo(tile_index=t, psot=psot))
        out += seg + markers.write_sod() + body
    out += markers.write_eoc()
    return bytes(out)


def coc_stream(img, params, device, comp=COC_COMP, change=None):
    """A codestream of `img` (MQ, one layer, MCT off) whose COC and QCC
    give component `comp` the COD with `change` applied (COC_CHANGE: the
    5/3 transform and, negative, fewer resolutions) and that COD's
    default QCD: each tile's components coded by their COD's group, each
    group through the port's fused encode over its components' SIZ
    entries (`fused_encode.build_plan`, `encode_tile_submit`), then the
    tile's T2 with the overrides (`tile.encode_tile(cod_comp=,
    qcd_comp=)`) and the port's marker writers."""
    from grokimagecompression_tpu_torch.codestream import encoder, markers
    from grokimagecompression_tpu_torch.codestream.markers import SotInfo
    from grokimagecompression_tpu_torch.codestream.tile import (default_qcd,
                                                                encode_tile)
    from grokimagecompression_tpu_torch.core.params import Transform
    from grokimagecompression_tpu_torch.models import fused_encode
    from grokimagecompression_tpu_torch.utils.device import resolve_device
    dev = resolve_device(device)
    change = dict(COC_CHANGE if change is None else change)
    p, siz, cod, qcd, _, trs = encoder._coding(img, params)
    if cod.cblk_style or cod.mct or p.rates:
        raise ValueError("coc_stream takes one-layer MQ codings without MCT")
    change["transform"] = Transform[change["transform"]]
    if change.get("numresolutions", 0) < 0:
        change["numresolutions"] += cod.numresolutions
    ccod = dataclasses.replace(cod, **change)
    cqcd = default_qcd(siz, ccod, encoder._guard_bits(p), p.base_step)
    n = len(siz.comps)
    groups = [(tuple(c for c in range(n) if c != comp), cod, qcd),
              ((comp,), ccod, cqcd)]
    out = bytearray(markers.write_soc() + markers.write_siz(siz)
                    + markers.write_cod(cod)
                    + markers.write_coc(comp, ccod, n)
                    + markers.write_qcd(qcd)
                    + markers.write_qcc(comp, cqcd, n))
    encoders = {}
    for t, tr in enumerate(trs):
        comps = encoder.extract_tile_comps(img, siz, t)
        segs = {}
        for cs, gcod, gqcd in groups:
            sub = dataclasses.replace(siz, comps=[siz.comps[c] for c in cs])
            plan = fused_encode.build_plan(sub, gcod, gqcd, tr, coder="mq")
            if plan not in encoders:
                encoders[plan] = fused_encode.FusedMQEncoder(plan, dev)
            (got,) = fused_encode.encode_tile_collect(
                fused_encode.encode_tile_submit([comps[c] for c in cs],
                                                encoders[plan]))
            counts = [sum(b.comp == i for (_, _, blocks) in plan.groups
                          for b in blocks) for i in range(len(cs))]
            pos = 0
            for c, k in zip(cs, counts):
                segs[c] = got[pos:pos + k]
                pos += k
        res = encode_tile([s for c in range(n) for s in segs[c]], siz, cod,
                          qcd, tr, cod_comp=[ccod if c == comp else None
                                             for c in range(n)],
                          qcd_comp=[cqcd if c == comp else None
                                    for c in range(n)])
        psot = 12 + 2 + len(res.body)
        out += markers.write_sot(SotInfo(tile_index=t, psot=psot))
        out += markers.write_sod() + res.body
    out += markers.write_eoc()
    return bytes(out)


# the plain MQ coder's decisions allowed in the config-2 byte-out check
# (~1.5 ms a decision on the card), and in the dense scan's check (which
# also packs words each step)
PLAIN_MQ_DECISIONS = 20000
PLAIN_DENSE_DECISIONS = 8000
# the plain MQ coder's decisions allowed in the deepest lane of each cinema
# shape group's check (phase 18)
CIN_PLAIN_MQ_DECISIONS = 2000
# the plain MQ decoder's longest run allowed at full depth on the 64x64
# group (seconds, estimated from the 32x32 group's run)
PLAIN_MQ_DEC_S = 90
# the lanes of a phase-3 shape group held to the plain HT encoder, HT
# decoder and MQ decoder: half the deepest lanes, half spread over the
# rest (a group of fewer lanes whole); the kernel runs on every lane
PLAIN_LANES = 128
# lanes a block tried for the MQ decoder, the MQ coder and the HT decoder
# (each source's kLanes; the coder's staged rows hold at most 8 lanes),
# lanes a warp for the dense MQ scan (its kLanes), and code-blocks a CTA
# for the HT encoder (its kBlocks); the HT decoder also with two threads a
# lane (its kSplit), the HT encoder with its three coders in three warps
# or in one (its kWarpCoders), the dense scan with 1, 4 or 8 warps a block
# (its kWarps). A bool trial constant is a `constexpr bool` line, an int
# one a `constexpr int` line.
LANE_TRIALS = {"mq_dec.cu": (16, 8, 4, 2, 1), "mq_scan.cu": (8, 4, 2, 1),
               "mq_dense.cu": (1, 2, 4, 8), "ht_dec.cu": (32, 16, 8),
               "ht_enc.cu": (1, 2, 4)}
SPLIT_TRIALS = {"ht_dec.cu": (False, True), "ht_enc.cu": (True, False),
                "mq_dense.cu": (1, 4, 8)}
LANE_NAMES = {"ht_enc.cu": "kBlocks"}
SPLIT_NAMES = {"ht_dec.cu": "kSplit", "ht_enc.cu": "kWarpCoders",
               "mq_dense.cu": "kWarps"}
# times before a kernel's redesign (this script's run of the earlier
# design, on an NVIDIA H100 80GB HBM3 at 700.00 W), printed beside the
# new ones: the MQ kernels' one-thread-a-lane designs, the HT decoder on
# prepass words, the DWT of two launches a level, and the HT encode's
# three scans on the 64x64 group's op streams (MagSgn 0.756, VLC 0.526,
# MEL 0.312 ms; the op-stream build, metrics and host splice not counted)
BEFORE_MS = {"mq_dec_group": 49.524, "mq_scan": 29.226,
             "mq_scan_dense": 42.143, "ht_dec_group": 1.910,
             "dwt forward": 1.832, "dwt inverse": 1.972,
             "ht_encode": 0.756 + 0.526 + 0.312}
BEFORE_CARD = "NVIDIA H100 80GB HBM3, 700.00 W"
# Bounds. H100 SXM peak rates: 3.35 TB/s of device memory; integer
# operations at 16.7 TOP/s (132 SMs x 64 INT32 lanes x 1.98 GHz: half the
# FP32 lanes behind the card's 67 TFLOP/s FP32 peak, no FMA doubling).
# The operation counts per lane are estimates read off the kernels'
# sources, not instruction counts: the HT encoder ~40 a sample for the
# per-quad stages (significance, exponents, context, codeword, MEL events
# and MagSgn lengths, spread over the samples), ~10 a significant sample
# (its MagSgn append) and ~8 a segment byte (emitted, then written), on
# this run's data; a decode step ~200 plus ~25 per significant sample. The MQ coder is charged what the encode
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
# The DWT (on this run's shapes): 9/7 a lifting step is an add, a multiply
# and an add on half of a line's samples, four steps and a scaling multiply
# a pass: 7 float32 operations a sample and pass, two passes a level; 5/3
# predict (add, shift, subtract) and update (two adds, shift, add) on
# halves: 3.5 integer operations a sample and pass. Float32 at the card's
# 67 TFLOP/s (its published non-tensor peak).
HBM_BYTES_S = 3.35e12
INT_OPS_S = 132 * 64 * 1.98e9
F32_OPS_S = 67e12
OPS = {"enc_sample": 40, "enc_sig": 10, "enc_byte": 8,
       "dec_step": 200, "dec_sample": 25,
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


def config2_frames(n, size=C2_SIZE):
    """BASELINE config-2 frames as the repository's bench makes them
    (`bench_chip_pcrd2k`): per component c a smooth wave 128 + 60
    sin(y / 37 + shift) cos(x / (29 + c)) plus uniform texture in [0, 24),
    frames shift = 0, 1, ... drawn from one generator seeded 3. The wave is
    evaluated on broadcast row and column vectors: the same float64
    operations on each sample as the bench's full coordinate grids."""
    import numpy as np
    from grokimagecompression_tpu_torch.core.image import Component, Image

    rng = np.random.default_rng(3)
    y = np.arange(size)[:, None]
    x = np.arange(size)[None, :]
    frames = []
    for shift in range(n):
        comps = []
        for c in range(3):
            base = (128 + 60 * np.sin(y / 37.0 + shift)
                    * np.cos(x / (29.0 + c))).astype(np.int32)
            tex = rng.integers(0, 24, (size, size))
            comps.append(Component(
                data=np.clip(base + tex, 0, 255).astype(np.int32), prec=8,
                signed=False, dx=1, dy=1))
        frames.append(Image(xsiz=size, ysiz=size, components=comps))
    return frames


def deep_frame(size=REFINE_DEEP_SIZE, prec=REFINE_DEEP_PREC):
    """A gray frame of `prec` bits (phase 25 (d)): config 1's wave in the
    top bits and uniform noise in the 20 below, seeded 7. Coded 5/3 with
    the HT coder (one guard bit) its bands' Mb is `prec` plus the band's
    gain: 30 in the HH bands at 28 bits, the deepest the reference's
    native HT coder defines."""
    import numpy as np
    from grokimagecompression_tpu_torch.core.image import Component, Image

    rng = np.random.default_rng(7)
    y = np.arange(size)[:, None]
    x = np.arange(size)[None, :]
    wave = (128 + 60 * np.sin(y / 37.0) * np.cos(x / 29.0)).astype(np.int64)
    data = (wave << (prec - 8)) + rng.integers(0, 1 << 20, (size, size))
    return Image(xsiz=size, ysiz=size, components=[Component(
        data=data.astype(np.int32), prec=prec, signed=False, dx=1, dy=1)])


def refine_params(params_cls, transform_cls, case):
    """The EncoderParams (of the port's or the reference's `params_cls`
    and `transform_cls`) of a phase-25 case: "c1" (config 1 with
    refinement), "c2" (config 2 with refinement), "alloc" (config 2's
    coding in three layers, for REFINE_ALLOC_RATES' allocator, which
    drops the refinement), "deep" (`deep_frame`'s plain HT coding)."""
    kw = dict(numresolutions=6, cblk_style=0x40)
    if case in ("c2", "alloc"):
        kw["transform"] = transform_cls.DWT_97
    if case == "alloc":
        kw["numlayers"] = len(REFINE_ALLOC_RATES)
    return params_cls(ht_refinement=case != "deep", **kw)


def cinema_frames(n, w=2048, h=1080):
    """Digital-cinema frames as the reference's bench makes them
    (`bench_chip_cinema`): 12-bit unsigned RGB, per component c the ramp
    ((x (c + 2) + 3 y + 17 shift) // 2) mod 3000 plus uniform texture in
    [0, 300), frames shift = 0, 1, ... drawn from one generator seeded 3.
    The ramp is evaluated on broadcast row and column vectors: the same
    integer operations on each sample as the bench's coordinate grids."""
    import numpy as np
    from grokimagecompression_tpu_torch.core.image import Component, Image

    rng = np.random.default_rng(3)
    y = np.arange(h, dtype=np.int64)[:, None]
    x = np.arange(w, dtype=np.int64)[None, :]
    frames = []
    for shift in range(n):
        comps = []
        for c in range(3):
            base = ((x * (c + 2) + y * 3 + shift * 17) // 2) % 3000
            tex = rng.integers(0, 300, (h, w))
            comps.append(Component(data=(base + tex).astype(np.int32),
                                   prec=12, signed=False, dx=1, dy=1))
        frames.append(Image(xsiz=w, ysiz=h, components=comps))
    return frames


def window_frames(n=2, w=WIN_SIZE[0], h=WIN_SIZE[1]):
    """The small window-decode frames: RGB 8-bit, per component c a smooth
    wave 128 + 64 sin(y / (13 + 3c)) cos(x / 11) plus normal noise of
    sigma 8, clipped; frame i from a generator seeded 40 + i."""
    import numpy as np
    from grokimagecompression_tpu_torch.core.image import Component, Image

    y = np.arange(h)[:, None]
    x = np.arange(w)[None, :]
    frames = []
    for i in range(n):
        rng = np.random.default_rng(40 + i)
        comps = [Component(data=(128 + 64 * np.sin(y / (13.0 + 3 * c))
                                 * np.cos(x / 11.0)
                                 + rng.normal(0, 8.0, (h, w))).clip(
                                     0, 255).astype(np.int32),
                           prec=8, signed=False, dx=1, dy=1)
                 for c in range(3)]
        frames.append(Image(xsiz=w, ysiz=h, components=comps))
    return frames


def window_params(params_cls, transform_cls, coding):
    """The EncoderParams of a WIN_CODINGS entry, made with the given
    EncoderParams and Transform classes (the port's, or in the tests the
    reference's)."""
    kw = dict(WIN_CODINGS[coding])
    if "transform" in kw:
        kw["transform"] = getattr(transform_cls, kw["transform"])
    return params_cls(**kw)


def window_requests(coding):
    """The WIN_REQUESTS that apply to a WIN_CODINGS entry: a layer limit
    only where there are layers, and of the reductions past the levels
    only 5."""
    layered = WIN_CODINGS[coding].get("numlayers", 1) > 1
    levels = WIN_CODINGS[coding]["numresolutions"] - 1
    return tuple(kw for kw in WIN_REQUESTS
                 if (layered or "layers" not in kw)
                 and not levels < kw.get("reduce", 0) < 5)


def request_name(kw) -> str:
    """A WIN_REQUESTS entry as text, e.g. "window=(40, 30, 170, 150),
    reduce=1"; "full" for the whole image."""
    return ", ".join(f"{k}={v}" for k, v in kw.items()) or "full"


def image_encode_frames():
    """The small per-image encode frames ("gray", "rgb"): 8-bit, per
    component c a smooth wave 128 + 64 sin(y / (13 + 3c)) cos(x / 11)
    plus normal noise of sigma 8, clipped; from generators seeded 60 and
    61; "small", the gray frame's top-left 40 x 32 samples; and "c2", a
    64 x 64 RGB frame as `config2_frames` makes them."""
    import numpy as np
    from grokimagecompression_tpu_torch.core.image import Component, Image

    w, h = IMG_ENC_SIZE
    y = np.arange(h)[:, None]
    x = np.arange(w)[None, :]
    frames = {}
    for i, (name, nc) in enumerate((("gray", 1), ("rgb", 3))):
        rng = np.random.default_rng(60 + i)
        frames[name] = Image(xsiz=w, ysiz=h, components=[
            Component(data=(128 + 64 * np.sin(y / (13.0 + 3 * c))
                            * np.cos(x / 11.0)
                            + rng.normal(0, 8.0, (h, w))).clip(
                                0, 255).astype(np.int32),
                      prec=8, signed=False, dx=1, dy=1)
            for c in range(nc)])
    frames["small"] = Image(xsiz=40, ysiz=32, components=[dataclasses.replace(
        frames["gray"].components[0],
        data=frames["gray"].components[0].data[:32, :40].copy())])
    frames["c2"] = config2_frames(1, size=64)[0]
    return frames


def image_encode_params(params_mod, poc_cls, case):
    """The EncoderParams of an IMG_ENC_CASES entry, made with the
    EncoderParams, Transform and Progression of `params_mod` and the POC
    entries of `poc_cls` (the port's, or in the tests the reference's)."""
    kw = dict(IMG_ENC_BASE)
    kw.update(IMG_ENC_CASES[case][1])
    if "transform" in kw:
        kw["transform"] = getattr(params_mod.Transform, kw["transform"])
    if "pocs" in kw:
        kw["pocs"] = tuple(
            poc_cls(rs=rs, cs=cs, lye=lye, re=re, ce=ce,
                    prog=getattr(params_mod.Progression, prog))
            for rs, cs, lye, re, ce, prog in kw["pocs"])
    return params_mod.EncoderParams(**kw)


def compress_array(frames, route):
    """The array `codec.compress` codes at an IMG_COMPRESS route: the RGB
    frame's top-left 40 x 32 (W x H) samples, (32, 40, 3), shifted up 4
    bits at 12-bit precision."""
    import numpy as np
    a = np.stack([c.data[:32, :40] for c in frames["rgb"].components],
                 axis=-1)
    return a << 4 if IMG_COMPRESS[route].get("prec") == 12 else a


def cli_inputs(d):
    """Write the seeded inputs of CLI_CASES into directory `d` with the
    port's writers: 64 x 48 images, per component c a smooth wave (0.5 +
    0.25 sin(y / (7 + 2c)) cos(x / 9)) x (2^prec - 1) plus normal noise
    of sigma (2^prec - 1) / 64, clipped, from generators seeded 70-77:
    gray.pgm, rgb.ppm, g12.pgm (12-bit), s12.pgx (signed 12-bit),
    rgb.bmp, rgb.tga, rgba.png, rgb16.png, TIFF RGB 8-bit and gray 16-bit
    in LZW (rgb_lzw.tif with the horizontal predictor) and deflate,
    g12.raw (big endian), sub.rawl (4:2:0, little endian), idx.pgm
    (palette indices 0-3), dir/a.pgm, dir/b.pgm and mct.txt (the
    CUSTOM_MCT decoding matrix for `-m`)."""
    import numpy as np

    from grokimagecompression_tpu_torch.core.image import Component, Image
    from grokimagecompression_tpu_torch.io import (bmp, pgx, png, pnm, raw,
                                                   tga, tiff)
    w, h = CLI_SIZE
    y = np.arange(h)[:, None]
    x = np.arange(w)[None, :]

    def image(seed, ncomps, prec=8, signed=False, alpha=False, sub=()):
        rng = np.random.default_rng(seed)
        top = (1 << prec) - 1
        comps = []
        for c in range(ncomps):
            d = 2 if c in sub else 1
            a = top * (0.5 + 0.25 * np.sin(y[::d] / (7.0 + 2 * c))
                       * np.cos(x[:, ::d] / 9.0)) \
                + rng.normal(0, top / 64.0, (-(-h // d), -(-w // d)))
            a = a.clip(0, top).astype(np.int32)
            comps.append(Component(
                data=a - (1 << (prec - 1)) if signed else a, prec=prec,
                signed=signed, dx=d, dy=d,
                alpha=alpha and c == ncomps - 1))
        return Image(xsiz=w, ysiz=h, components=comps)

    def path(name):
        return os.path.join(d, name)

    os.makedirs(path("dir"), exist_ok=True)
    gray, rgb = image(70, 1), image(71, 3)
    pnm.write_pnm(path("gray.pgm"), gray)
    pnm.write_pnm(path("rgb.ppm"), rgb)
    pnm.write_pnm(path("g12.pgm"), image(72, 1, 12))
    pgx.write_pgx(path("s12.pgx"), image(73, 1, 12, signed=True))
    bmp.write_bmp(path("rgb.bmp"), rgb)
    tga.write_tga(path("rgb.tga"), image(74, 3))
    png.write_png(path("rgba.png"), image(75, 4, alpha=True))
    png.write_png(path("rgb16.png"), image(76, 3, 16))
    g16 = image(77, 1, 16)
    tiff_file(path("rgb_lzw.tif"), [c.data for c in rgb.components], 8, 5,
              predictor=2, rows_per_strip=16)
    tiff_file(path("g16_lzw.tif"), [g16.components[0].data], 16, 5)
    tiff.write_tiff(path("rgb_zip.tif"), rgb, compression=8)
    tiff.write_tiff(path("g16_zip.tif"), g16, compression=8)
    raw.write_raw(path("g12.raw"), image(72, 1, 12), big_endian=True)
    raw.write_raw(path("sub.rawl"), image(78, 3, sub=(1, 2)),
                  big_endian=False)
    idx = np.random.default_rng(79).integers(0, 4, (h, w)).astype(np.int32)
    pnm.write_pnm(path("idx.pgm"), Image(xsiz=w, ysiz=h, components=[
        Component(data=idx, prec=8, signed=False, dx=1, dy=1)]))
    pnm.write_pnm(path("dir/a.pgm"), gray)
    with open(path("mct.txt"), "w") as f:
        f.write("".join(",".join(repr(v) for v in row) + "\n"
                        for row in CUSTOM_MCT))
    pnm.write_pnm(path("dir/b.pgm"), Image(xsiz=w, ysiz=h, components=[
        dataclasses.replace(gray.components[0],
                            data=gray.components[0].data[::-1].copy())]))


def lzw_encode(data: bytes) -> bytes:
    """TIFF LZW (MSB-first codes from 9 to 12 bits, the early code-width
    change): CLEAR, the codes, a CLEAR each time the table fills, EOI."""
    out = bytearray()
    acc = nacc = 0

    def emit(code, width):
        nonlocal acc, nacc
        acc = (acc << width) | code
        nacc += width
        while nacc >= 8:
            nacc -= 8
            out.append((acc >> nacc) & 0xFF)
        acc &= (1 << nacc) - 1

    def reset():
        return {bytes([i]): i for i in range(256)}, 258, 9

    # after the k-th code since a CLEAR the reader's table holds 257 + k
    # entries (it adds one from its second code on), which is `nxt` before
    # the writer adds the k-th entry; it widens its codes once its table
    # holds 2^width - 1
    table, nxt, width = reset()
    emit(256, 9)
    w = b""
    for c in data:
        wc = w + bytes([c])
        if wc in table:
            w = wc
            continue
        emit(table[w], width)
        if nxt >= (1 << width) - 1 and width < 12:
            width += 1
        table[wc] = nxt
        nxt += 1
        w = bytes([c])
        if nxt >= 4093:
            emit(256, width)
            table, nxt, width = reset()
    if w:
        emit(table[w], width)
        if nxt >= (1 << width) - 1 and width < 12:
            width += 1
    emit(257, width)
    if nacc:
        out.append((acc << (8 - nacc)) & 0xFF)
    return bytes(out)


def packbits_encode(data: bytes) -> bytes:
    """PackBits: runs of 3-128 equal bytes as a repeat, the rest as
    literal runs of up to 128 bytes."""
    out = bytearray()
    i, n = 0, len(data)
    lit = bytearray()

    def flush():
        for k in range(0, len(lit), 128):
            part = lit[k:k + 128]
            out.append(len(part) - 1)
            out.extend(part)
        lit.clear()

    while i < n:
        j = i
        while j < n and j - i < 128 and data[j] == data[i]:
            j += 1
        if j - i >= 3:
            flush()
            out += bytes([257 - (j - i), data[i]])
            i = j
        else:
            lit.append(data[i])
            i += 1
    flush()
    return bytes(out)


def tiff_file(path, planes, bps, compression, predictor=1,
              rows_per_strip=None, big_endian=False):
    """Write a chunky striped TIFF of `planes` (arrays of one shape) at 8
    or 16 bits: uncompressed (1), LZW (5), deflate (8, 32946) or
    PackBits (32773), with the horizontal predictor (2) or none (1)."""
    import struct
    import zlib

    import numpy as np
    e = ">" if big_endian else "<"
    a = np.stack(planes, axis=-1).astype(
        np.dtype(np.uint16).newbyteorder(e) if bps == 16 else np.uint8)
    if predictor == 2:
        a = a.copy()
        a[:, 1:] = a[:, 1:] - a[:, :-1]
    h, w, spp = a.shape
    rps = rows_per_strip or h
    code = {1: bytes, 5: lzw_encode, 8: zlib.compress, 32946: zlib.compress,
            32773: packbits_encode}[compression]
    strips = [code(a[y:y + rps].tobytes()) for y in range(0, h, rps)]
    tags = [(256, 4, [w]), (257, 4, [h]), (258, 3, [bps] * spp),
            (259, 3, [compression]), (262, 3, [2 if spp >= 3 else 1]),
            (273, 4, [0] * len(strips)), (277, 3, [spp]), (278, 4, [rps]),
            (279, 4, [len(s) for s in strips]), (317, 3, [predictor])]
    heap_base = 8 + 2 + 12 * len(tags) + 4

    def ifd(offsets):
        ents, heap = b"", bytearray()
        for tag, typ, vals in tags:
            vals = offsets if tag == 273 else vals
            pay = struct.pack(e + f"{len(vals)}{'H' if typ == 3 else 'I'}",
                              *vals)
            if len(pay) <= 4:
                ents += struct.pack(e + "HHI", tag, typ, len(vals)) \
                    + pay.ljust(4, b"\0")
            else:
                ents += struct.pack(e + "HHII", tag, typ, len(vals),
                                    heap_base + len(heap))
                heap += pay
        return ents, heap

    _, heap = ifd([0] * len(strips))
    offs, pos = [], heap_base + len(heap)
    for st in strips:
        offs.append(pos)
        pos += len(st)
    ents, heap = ifd(offs)
    with open(path, "wb") as f:
        f.write((b"MM" if big_endian else b"II")
                + struct.pack(e + "HIH", 42, 8, len(tags)) + ents
                + struct.pack(e + "I", 0) + bytes(heap) + b"".join(strips))


def icc_profile() -> bytes:
    """A matrix-shaper RGB ICC profile (D50 primaries of sRGB, gamma 2.2
    tone curves), as `tests/test_icc.make_profile` builds one."""
    import struct

    def xyz(v):
        return b"XYZ " + b"\0" * 4 + b"".join(
            struct.pack(">i", int(round(t * 65536))) for t in v)
    curv = b"curv" + b"\0" * 4 + struct.pack(">IH", 1, int(round(2.2 * 256)))
    tags = [(b"wtpt", xyz((0.9642, 1.0, 0.8249))),
            (b"rXYZ", xyz((0.4361, 0.2225, 0.0139))),
            (b"gXYZ", xyz((0.3851, 0.7169, 0.0971))),
            (b"bXYZ", xyz((0.1431, 0.0606, 0.7141))),
            (b"rTRC", curv), (b"gTRC", curv), (b"bTRC", curv)]
    off = 128 + 4 + 12 * len(tags)
    table, body = struct.pack(">I", len(tags)), b""
    for sig, pay in tags:
        table += struct.pack(">4sII", sig, off + len(body), len(pay))
        body += pay + b"\0" * (-len(pay) % 4)
    hdr = struct.pack(">I", 128 + len(table) + len(body)) + b"lcms" \
        + struct.pack(">I", 0x02400000) + b"mntrRGB XYZ " \
        + struct.pack(">6H", 2024, 1, 1, 0, 0, 0) + b"acsp"
    hdr += b"\0" * (68 - len(hdr)) + xyz((0.9642, 1.0, 0.8249))[8:]
    return hdr.ljust(128, b"\0") + table + body


def cli_jp2(kind, cs: bytes, w: int, h: int, ncomps: int) -> bytes:
    """A JP2 file of the 8-bit codestream `cs` whose colour is told by
    `kind`: "palette" (a 4-entry RGB pclr and its cmap over component 0),
    "icc" (an ICC colr box, `icc_profile`) or "cielab" (enumerated
    colour space 14 with its default parameters)."""
    import struct

    def box(t, payload):
        return struct.pack(">I", 8 + len(payload)) + t + payload
    hdr = box(b"ihdr", struct.pack(">IIHBBBB", h, w, ncomps, 7, 7, 0, 0))
    if kind == "palette":
        pal = ((255, 0, 0), (0, 255, 0), (0, 0, 255), (255, 255, 0))
        hdr += box(b"colr", struct.pack(">BBBI", 1, 0, 0, 16))
        hdr += box(b"pclr", struct.pack(">HB", 4, 3) + bytes([7, 7, 7])
                   + bytes(v for e in pal for v in e))
        hdr += box(b"cmap", b"".join(struct.pack(">HBB", 0, 1, k)
                                     for k in range(3)))
    elif kind == "icc":
        hdr += box(b"colr", struct.pack(">BBB", 2, 0, 0) + icc_profile())
    else:
        hdr += box(b"colr", struct.pack(">BBBI", 1, 0, 0, 14))
    return (b"\x00\x00\x00\x0cjP  \r\n\x87\n"
            + box(b"ftyp", b"jp2 " + struct.pack(">I", 0) + b"jp2 ")
            + box(b"jp2h", hdr) + box(b"jp2c", cs))


def run_cli_cases(d, tools, extra=(), plt_stream=None, cases=CLI_CASES):
    """Run `cases` (CLI_CASES entries) in directory `d` (its inputs
    written by `cli_inputs`) with `tools`, a dict of the "compress",
    "decompress" and "dump" modules (the port's, or in the tests the
    reference's), `extra` arguments appended to compress and decompress
    runs (the port's --torch-device), and `plt_stream(path)`, the
    library's stream of a PGM file with PLT and TLM markers. Each run must
    exit 0. Returns {case: {file made by the run: SHA-256}}."""
    def files():
        return {os.path.relpath(os.path.join(r, f), d)
                for r, _, fs in os.walk(d) for f in fs}

    def path(a):
        return os.path.join(d, a[1:]) if a.startswith("@") else a

    out = {}
    for name, tool, argv in cases:
        before = files()
        args = [path(a) for a in argv]
        if tool in ("palette", "icc", "cielab"):
            with open(args[0], "rb") as f:
                cs = f.read()
            w, h = CLI_SIZE
            with open(args[1], "wb") as f:
                f.write(cli_jp2(tool, cs, w, h, 1 if tool == "palette"
                                else 3))
        elif tool == "plt":
            with open(args[1], "wb") as f:
                f.write(plt_stream(args[0]))
        else:
            rc = tools[tool].main(args + (list(extra) if tool != "dump"
                                          else []))
            if rc != 0:
                raise AssertionError(f"CLI case {name!r}: exit code {rc}")
        made = sorted(files() - before)
        if not made:
            raise AssertionError(f"CLI case {name!r} wrote no file")
        out[name] = {}
        for rel in made:
            with open(os.path.join(d, rel), "rb") as f:
                out[name][rel] = hashlib.sha256(f.read()).hexdigest()
    return out


def cinema_sets():
    """The frame sets of CIN_CASES by name."""
    sets = {k: cinema_frames(*v) for k, v in CIN_FRAMES.items()}
    sets["2k0"] = sets["2k"][:1]
    return sets


def cinema_profile(profiles, params_cls, case, img):
    """The ProfiledParams of a CIN_CASES entry for `img`, made with the
    given profiles module and EncoderParams class (the port's, or in the
    tests the reference's)."""
    _, _, fn, params_kw, profile_kw = case
    return getattr(profiles, fn)(params_cls(**params_kw), img, **profile_kw)


def frame_digest(img) -> str:
    """SHA-256 of an image's samples, component by component, as
    little-endian int32."""
    import numpy as np
    h = hashlib.sha256()
    for c in img.components:
        h.update(np.ascontiguousarray(c.data, dtype="<i4").tobytes())
    return h.hexdigest()


def plane_md5(img) -> str:
    """MD5 of an image's planes, component by component, in the dtype the
    decoder returns (int32): the digest of the corpus goldens
    (`tests/test_goldens._plane_md5`) and of `CORPUS_DIGESTS`."""
    import numpy as np
    h = hashlib.md5()
    for c in img.components:
        h.update(np.ascontiguousarray(c.data).tobytes())
    return h.hexdigest()


def frame_mse(img, ref) -> float:
    """Mean squared error of an image's samples against a reference
    image's, over every component, in float64."""
    import numpy as np
    err = sum(float(((a.data.astype(np.float64) - b.data) ** 2).sum())
              for a, b in zip(img.components, ref.components))
    return err / sum(c.data.size for c in img.components)


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


def device_ms(fn, iters, kernel, launched):
    """Mean device milliseconds a call of fn() spends in the kernels whose
    name holds `kernel` (torch.profiler's CUDA activity over `iters`
    calls), or None when the profiler records no device time or fewer
    kernels than `launched()` (the wrapper's launch count) grew by: the
    kernels' own time, without the wrapper's host work around them. Once
    more kernel libraries are loaded, a window that ends in this port's
    kernel loses its last records (on torch 2.11 + CUDA 12.8, measured:
    2 of 4 dense scans recorded, none of one), so the window ends in a
    few small torch kernels."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    pad = torch.zeros(1, device="cuda")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            before = launched()
            for _ in range(iters):
                fn()
            n = launched() - before
            torch.cuda.synchronize()
            for _ in range(8):
                pad.add_(1)
            torch.cuda.synchronize()
    total, count = 0.0, 0
    for e in prof.key_averages():
        if kernel in e.key:
            total += getattr(e, "self_device_time_total",
                             getattr(e, "self_cuda_time_total", 0.0))
            count += e.count
    return total / 1e3 / iters if total > 0 and count == n else None


def fmt_ms(ms) -> str:
    return "not measured" if ms is None else f"{ms:.3f} ms"


def plain_lanes(depth):
    """The lanes of a shape group that phase 3 holds to a plain version,
    ascending: every lane when there are at most PLAIN_LANES; else the
    PLAIN_LANES // 2 lanes with the largest `depth` (a (B,) tensor:
    segment bytes or passes, the work that sets a lane's chain) and
    PLAIN_LANES // 2 more spread evenly over the others."""
    import torch
    B = depth.shape[0]
    if B <= PLAIN_LANES:
        return torch.arange(B, device=depth.device)
    deep = torch.argsort(depth.to(torch.int64), descending=True,
                         stable=True)[:PLAIN_LANES // 2]
    rest = torch.ones(B, dtype=torch.bool, device=depth.device)
    rest[deep] = False
    others = rest.nonzero().flatten()
    step = others.shape[0] / (PLAIN_LANES - deep.shape[0])
    spread = others[(torch.arange(PLAIN_LANES - deep.shape[0])
                     * step).long()]
    return torch.sort(torch.cat([deep, spread])).values


def lane_subset(data, off, idx):
    """The packed segments `data` (lane k's at off[k]:off[k + 1]) of the
    lanes `idx`, packed again: (data, off) on the same device."""
    import torch
    lo, hi = off[idx].tolist(), off[idx + 1].tolist()
    sub = torch.cat([data[a:b] for a, b in zip(lo, hi)]) if lo else data[:0]
    lens = torch.tensor([b - a for a, b in zip(lo, hi)], dtype=off.dtype)
    return sub.contiguous(), torch.cat([
        torch.zeros(1, dtype=off.dtype), torch.cumsum(lens, 0)]).to(
            off.device)


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def bound(nbytes_moved: int, ops: float, ops_s: float = INT_OPS_S):
    """(bound in ms, what sets it, "bytes a ms, operations b ms"), the
    operations at `ops_s` a second."""
    t_bytes = nbytes_moved / HBM_BYTES_S
    t_ops = ops / ops_s
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


class Calls:
    """Counts, inside a `with` block, the calls of `module.name` whose
    arguments satisfy `pred`: the calls of what a kernel's `ms` times on
    its path (the wrappers' LAUNCHES still show that the kernel ran)."""

    def __init__(self, module, name, pred):
        self.module, self.name, self.pred = module, name, pred
        self.n = 0

    def __enter__(self):
        orig = self.orig = getattr(self.module, self.name)

        def counted(*args, **kwargs):
            self.n += bool(self.pred(*args, **kwargs))
            return orig(*args, **kwargs)
        setattr(self.module, self.name, counted)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.orig)


def start_lane_trials():
    """One nvcc per source and lane count of LANE_TRIALS (and, for the
    sources of SPLIT_TRIALS, per value of their second constant): the
    source with its kLanes (LANE_NAMES: another name) line and its
    SPLIT_NAMES line changed, into build/torch_kernels/. Returns [(source,
    key, library path, cmd, process)], the key the lane count, or (lanes,
    split) for a source of SPLIT_TRIALS."""
    from grokimagecompression_tpu_torch.ops import _build
    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    trials = []
    for source, counts in LANE_TRIALS.items():
        lanes = LANE_NAMES.get(source, "kLanes")
        pat = rf"constexpr int {lanes} = \d+;"
        split_name = SPLIT_NAMES.get(source)
        splits = SPLIT_TRIALS.get(source)
        kind = "bool" if splits and isinstance(splits[0], bool) else "int"
        split_pat = rf"constexpr {kind} {split_name} = \w+;"
        with open(os.path.join(_build.CSRC, source)) as f:
            src = f.read()
        if len(re.findall(pat, src)) != 1:
            raise AssertionError(f"{source} has no single {lanes} line")
        if splits and len(re.findall(split_pat, src)) != 1:
            raise AssertionError(f"{source} has no single {split_name} "
                                 f"line")
        for n, split in ((n, sp) for n in counts for sp in splits or (None,)):
            key = n if split is None else (n, split)
            text = re.sub(pat, f"constexpr int {lanes} = {n};", src)
            if split is not None:
                value = (("true" if split else "false") if kind == "bool"
                         else str(split))
                text = re.sub(split_pat, f"constexpr {kind} {split_name} = "
                              f"{value};", text)
            tag = (str(n) if split is None else f"{n}{'s' if split else ''}"
                   if kind == "bool" else f"{n}x{split}")
            cu = os.path.join(_build.BUILD_DIR, f"trial_{tag}_{source}")
            with open(cu, "w") as f:
                f.write(text)
            so = cu[:-3] + ".so"
            cmd = [_build._nvcc(), *_build.ARCH_FLAGS, "-std=c++17", "-O3",
                   "-Xcompiler", "-fPIC", "-shared", "-I", _build.CSRC,
                   "-o", so, cu]
            trials.append((source, key, so, cmd, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
    return trials


def start_clock_build():
    """One nvcc of an instrumented copy of csrc/ht_enc.cu that records, for
    block 0, clock64() after each barrier of the kernel and at the end of
    each coder (MagSgn, VLC, MEL), read back by `ht_enc_clocks`. Returns
    (library path, cmd, process)."""
    from grokimagecompression_tpu_torch.ops import _build
    with open(os.path.join(_build.CSRC, "ht_enc.cu")) as f:
        src = f.read()
    src = src.replace("namespace {", "namespace {\n__device__ long long "
                      "g_clk[32];\n#define CLK(n) if (threadIdx.x == 0 && "
                      "blockIdx.x == 0) g_clk[n] = clock64();", 1)
    k0 = src.index("ht_enc_kernel(const int32_t*")
    body = src[k0:]
    marks = iter(range(1, 32))
    body = re.sub(r"__syncthreads\(\);",
                  lambda m: f"__syncthreads(); CLK({next(marks)})", body)
    body = body.replace("uint32_t smem_raw[];", "uint32_t smem_raw[];\n"
                        "  CLK(0)", 1)
    for i, name in enumerate(("ms_coder_warp", "vlc_coder_warp",
                              "mel_coder")):
        body, n = re.subn(rf"({name}\([^;]*\);)", rf"{{ \1 if (blockIdx.x "
                          rf"== 0) g_clk[{20 + i}] = clock64(); }}", body,
                          count=1)
        if n != 1:
            raise AssertionError(f"ht_enc.cu's kernel calls no {name}")
    src = src[:k0] + body + (
        '\nextern "C" int ht_enc_clocks(long long* h) { return (int)'
        'cudaMemcpyFromSymbol(h, g_clk, sizeof(long long) * 32); }\n')
    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    cu = os.path.join(_build.BUILD_DIR, "clocks_ht_enc.cu")
    with open(cu, "w") as f:
        f.write(src)
    so = cu[:-3] + ".so"
    cmd = [_build._nvcc(), *_build.ARCH_FLAGS, "-std=c++17", "-O3",
           "-Xcompiler", "-fPIC", "-shared", "-o", so, cu]
    return so, cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True)


def finish_clock_build(build):
    """Wait for `start_clock_build`'s nvcc; the loaded library."""
    import ctypes
    so, cmd, proc = build
    out, _ = proc.communicate()
    if proc.returncode != 0:
        raise AssertionError(f"nvcc failed on the instrumented ht_enc.cu:\n"
                             f"{' '.join(cmd)}\n{out}")
    lib = ctypes.CDLL(so)
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.ht_enc_group.argtypes = [P] * 6 + [I] * 4 + [P]
    lib.ht_enc_group.restype = I
    lib.ht_enc_clocks.argtypes = [P]
    lib.ht_enc_clocks.restype = I
    return lib


def start_dense_clock_build():
    """One nvcc of an instrumented copy of csrc/mq_dense.cu: thread 0 of
    block 0 adds the clock64() cycles since its last mark to a counter at
    each barrier of the kernel and at the end of each tile's expansion, so
    that over the whole stream they split into waiting for the staged
    tile, compaction, coding (the block's slowest coder) and expansion;
    read back by `mq_dense_clocks`. Returns (library path, cmd,
    process)."""
    from grokimagecompression_tpu_torch.ops import _build
    with open(os.path.join(_build.CSRC, "mq_dense.cu")) as f:
        src = f.read()
    src = src.replace("namespace {", "namespace {\n__device__ long long "
                      "g_clk[8];\n#define CLK(n) if (threadIdx.x == 0 && "
                      "blockIdx.x == 0) { const long long now = clock64(); "
                      "g_clk[n] += now - clk_last; clk_last = now; }", 1)
    k0 = src.index("mq_dense_kernel(const uint8_t*")
    body = src[k0:]
    body = body.replace("Smem& s = *reinterpret_cast<Smem*>(smem_raw);",
                        "Smem& s = *reinterpret_cast<Smem*>(smem_raw);\n"
                        "  long long clk_last = clock64();", 1)
    marks = iter(range(1, 5))
    body, n = re.subn(r"__syncthreads\(\);",
                      lambda m: f"__syncthreads(); CLK({next(marks)})", body)
    body, m = re.subn(r"(nbo\[o\] = n;\n    \})", r"\1\n    CLK(5)", body)
    if (n, m) != (4, 1):
        raise AssertionError(f"mq_dense.cu's kernel has {n} barriers and "
                             f"{m} expansion loops, not 4 and 1")
    src = src[:k0] + body + (
        '\nextern "C" int mq_dense_clocks(long long* h, int reset) {\n'
        '  if (reset) { static const long long z[8] = {0}; return (int)'
        'cudaMemcpyToSymbol(g_clk, z, sizeof(z)); }\n  return (int)'
        'cudaMemcpyFromSymbol(h, g_clk, sizeof(long long) * 8); }\n')
    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    cu = os.path.join(_build.BUILD_DIR, "clocks_mq_dense.cu")
    with open(cu, "w") as f:
        f.write(src)
    so = cu[:-3] + ".so"
    cmd = [_build._nvcc(), *_build.ARCH_FLAGS, "-std=c++17", "-O3",
           "-Xcompiler", "-fPIC", "-shared", "-I", _build.CSRC, "-o", so, cu]
    return so, cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True)


def finish_dense_clock_build(build):
    """Wait for `start_dense_clock_build`'s nvcc; the loaded library."""
    import ctypes
    so, cmd, proc = build
    out, _ = proc.communicate()
    if proc.returncode != 0:
        raise AssertionError(f"nvcc failed on the instrumented mq_dense.cu:"
                             f"\n{' '.join(cmd)}\n{out}")
    lib = ctypes.CDLL(so)
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.mq_scan_dense.argtypes = [P, I, I, I] + [P] * 5
    lib.mq_scan_dense.restype = I
    lib.mq_dense_clocks.argtypes = [P, I]
    lib.mq_dense_clocks.restype = I
    return lib


def dense_stage_clocks(lib, slots):
    """Block 0's cycles (thread 0, summed over the tiles of one launch on
    `slots`, after a warm launch) by stage: {stage: cycles}."""
    import ctypes
    import torch

    from grokimagecompression_tpu_torch.ops.mq_tables import DENSE_NSTATE
    T, B = slots.shape
    outs = [torch.empty((T, B), dtype=torch.int32, device=slots.device)
            for _ in range(3)]
    state = torch.empty((DENSE_NSTATE, B), dtype=torch.int32,
                        device=slots.device)
    clk = (ctypes.c_longlong * 8)()
    for _ in range(2):
        if lib.mq_dense_clocks(clk, 1) != 0:
            raise AssertionError("resetting the stage clocks failed")
        rc = lib.mq_scan_dense(slots.data_ptr(), T, T, B,
                               *(o.data_ptr() for o in outs),
                               state.data_ptr(),
                               torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise AssertionError(f"instrumented launch failed: CUDA error "
                                 f"{rc}")
        torch.cuda.synchronize()
    if lib.mq_dense_clocks(clk, 0) != 0:
        raise AssertionError("reading the stage clocks failed")
    return {"set-up": clk[1], "waiting for the staged tile": clk[2],
            "compaction": clk[3], "staging + coding (slowest coder)": clk[4],
            "expansion": clk[5]}


def enc_stage_clocks(lib, coeffs, mbs, tables):
    """Block 0's cycles from the kernel's start to each barrier (load,
    stage A, stages B+C, the scan and bit packing, the coders, the
    fuse rule) and to each coder's end, in the instrumented build, after
    two warm launches: ([6 barrier marks], [MagSgn, VLC, MEL ends])."""
    import ctypes
    import torch

    from grokimagecompression_tpu_torch.ops import ht_enc
    out, off, lens = ht_enc.encode_into(coeffs, mbs, tables)
    B, H, W = coeffs.shape
    for _ in range(3):
        rc = lib.ht_enc_group(
            coeffs.data_ptr(), mbs.data_ptr(),
            tables["enc_packed"].data_ptr(), off.data_ptr(), out.data_ptr(),
            lens.data_ptr(), B, H // 2, W // 2,
            min(int(mbs.max()) + 2, 32),
            torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise AssertionError(f"instrumented launch failed: CUDA error "
                                 f"{rc}")
    torch.cuda.synchronize()
    clk = (ctypes.c_longlong * 32)()
    if lib.ht_enc_clocks(clk) != 0:
        raise AssertionError("reading the stage clocks failed")
    return ([clk[i] - clk[0] for i in range(1, 7)],
            [clk[20 + i] - clk[0] for i in range(3)])


def finish_lane_trials(trials):
    """Wait for the trial builds; {source: {lanes: loaded library}}."""
    import ctypes
    libs = {source: {} for source in LANE_TRIALS}
    P, I = ctypes.c_void_p, ctypes.c_int
    for source, n, so, cmd, proc in trials:
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise AssertionError(f"nvcc failed on the {n}-lane trial of "
                                 f"{source}:\n{' '.join(cmd)}\n{out}")
        lib = ctypes.CDLL(so)
        if source == "mq_dec.cu":
            lib.mq_dec_group.argtypes = [P] * 6 + [I] * 3 + [P] * 3
            lib.mq_dec_group.restype = I
        elif source == "ht_dec.cu":
            lib.ht_dec_group.argtypes = [P] * 5 + [I] * 3 + [P] * 6
            lib.ht_dec_group.restype = I
        elif source == "ht_enc.cu":
            lib.ht_enc_group.argtypes = [P] * 6 + [I] * 4 + [P]
            lib.ht_enc_group.restype = I
        elif source == "mq_dense.cu":
            lib.mq_scan_dense.argtypes = [P, I, I, I] + [P] * 5
            lib.mq_scan_dense.restype = I
        else:
            lib.mq_scan.argtypes = [P, I, I] + [P] * 5 + [I] * 3 + [P]
            lib.mq_scan.restype = I
        libs[source][n] = lib
    return libs


def trial_label(key, warps=False) -> str:
    """A trial build's name: its lanes (code-blocks) a block, and "x2"
    for two threads a lane; with `warps` (the HT encoder) "w" for its
    coders in three warps, "t" for them in one; the dense MQ scan's
    lanes a warp x warps a block."""
    if isinstance(key, tuple) and not isinstance(key[1], bool):
        return f"{key[0]}x{key[1]}"
    if isinstance(key, tuple):
        if warps:
            return f"{key[0]}{'w' if key[1] else 't'}"
        return f"{key[0]}{' x2' if key[1] else ''}"
    return str(key)


def in_turns(runs, want, label, post=None):
    """Each trial `runs[n]()` (a launch as the wrapper makes it; its
    outputs through `post` when given) equal to `want`, then timed in
    turns (in the order of `runs`, then back), 10 launches a turn.
    {trial key: mean ms}."""
    import torch
    for n, run in runs.items():
        got = run()
        if post is not None:
            got = post(got)
        torch.cuda.synchronize()
        if not all(torch.equal(g, w) for g, w in zip(got, want)):
            raise AssertionError(f"the {trial_label(n)} trial of {label} "
                                 f"differs from the shipped kernel")
    times = {n: [] for n in runs}
    for n in list(runs) + list(runs)[::-1]:
        times[n].append(cuda_ms(runs[n], 10))
    return {n: sum(t) / len(t) for n, t in times.items()}


def dec_lane_trial(libs, args, want):
    """The MQ decoder built with each trial's lanes a block, launched as
    the wrapper launches it (zeroed output, lane order) on `args` = (data,
    off, nbps, npas, ori, w, h), against the shipped kernel's samples and
    statistics `want`."""
    import torch

    from grokimagecompression_tpu_torch.ops import mq_dec
    data, off, nbps, npas, ori, w, h = args
    B = nbps.shape[0]

    def launcher(lib):
        def run():
            out = torch.zeros((h * w, B), dtype=torch.int32,
                              device=data.device)
            stats = torch.empty((2, B), dtype=torch.int32,
                                device=data.device)
            order = mq_dec.lane_order(off, nbps, npas)
            rc = lib.mq_dec_group(
                data.data_ptr(), off.data_ptr(), nbps.data_ptr(),
                npas.data_ptr(), ori.data_ptr(), order.data_ptr(), B, w, h,
                out.data_ptr(), stats.data_ptr(),
                torch.cuda.current_stream().cuda_stream)
            if rc != 0:
                raise AssertionError(f"trial launch failed: CUDA error {rc}")
            return out, stats
        return run
    return in_turns({n: launcher(lib) for n, lib in libs.items()}, want,
                    "mq_dec_group")


def scan_lane_trial(libs, slots, want):
    """The MQ coder built with each trial's lanes a block, launched as
    `mq_scan.scan_into` launches it, on `slots`, against the shipped
    kernel's segments, lengths and state `want`."""
    import torch

    from grokimagecompression_tpu_torch.ops import mq_scan
    from grokimagecompression_tpu_torch.ops.mq_tables import NSTATE
    T, B = slots.shape
    off, total = mq_scan.segment_offsets(slots)
    out = torch.empty(max(total, 1), dtype=torch.uint8, device=slots.device)
    lens = torch.empty(B, dtype=torch.int32, device=slots.device)
    state = torch.empty((NSTATE, B), dtype=torch.int32, device=slots.device)

    def launcher(lib):
        def run():
            rc = lib.mq_scan(slots.data_ptr(), T, B, off.data_ptr(),
                             out.data_ptr(), lens.data_ptr(),
                             state.data_ptr(), None, 0, 0, 0,
                             torch.cuda.current_stream().cuda_stream)
            if rc != 0:
                raise AssertionError(f"trial launch failed: CUDA error {rc}")
            return mq_scan.pack_segments(out, off, lens), lens, state
        return run
    return in_turns({n: launcher(lib) for n, lib in libs.items()}, want,
                    "mq_scan")


def dense_lane_trial(libs, slots, want):
    """The dense MQ scan built with each trial's lanes a warp and warps a
    block, launched as `mq_scan.scan_dense` launches it on `slots` (t_out =
    T) into one set of outputs (filled with -7 before a build's first
    launch), against the shipped kernel's words, m8, nbo and state
    `want`."""
    import torch
    T, B = slots.shape
    outs = [torch.empty_like(w) for w in want]

    def launcher(lib):
        first = [True]

        def run():
            if first[0]:
                for o in outs:
                    o.fill_(-7)
                first[0] = False
            rc = lib.mq_scan_dense(slots.data_ptr(), T, T, B,
                                   *(o.data_ptr() for o in outs),
                                   torch.cuda.current_stream().cuda_stream)
            if rc != 0:
                raise AssertionError(f"trial launch failed: CUDA error {rc}")
            return outs
        return run
    return in_turns({n: launcher(lib) for n, lib in libs.items()}, want,
                    "mq_scan_dense")


def ht_lane_trial(libs, args, want):
    """The HT decoder built with each trial's lanes a block and threads a
    lane, launched as `ht_dec.decode_segments` launches it on `args` =
    (data, off, lcup, scup, w, h, tables), against the shipped kernel's
    magnitudes and signs `want`; a build whose two-thread ring stalled
    differs (its stall count is compared with 0)."""
    import torch

    from grokimagecompression_tpu_torch.ops import ht_dec
    data, off, lcup, scup, w, h, tables = args
    B = lcup.shape[0]
    order = ht_dec.lane_order(lcup)
    stalled = torch.zeros(1, dtype=torch.int32, device=data.device)

    def launcher(lib):
        def run():
            mags = torch.empty_like(want[0])
            signs = torch.empty_like(want[1])
            rc = lib.ht_dec_group(
                data.data_ptr(), off.data_ptr(), lcup.data_ptr(),
                scup.data_ptr(), order.data_ptr(), B, w, h,
                tables["dec0"].data_ptr(), tables["dec1"].data_ptr(),
                mags.data_ptr(), signs.data_ptr(), stalled.data_ptr(),
                torch.cuda.current_stream().cuda_stream)
            if rc != 0:
                raise AssertionError(f"trial launch failed: CUDA error {rc}")
            return mags, signs, stalled
        return run
    return in_turns({n: launcher(lib) for n, lib in libs.items()},
                    tuple(want) + (torch.zeros_like(stalled),),
                    "ht_dec_group")


def print_trial(name, what, trial, warps=False, legend=None):
    best = min(trial, key=trial.get)
    legend = legend or (
        "code-blocks a CTA, w: the three coders in three warps, t: in one "
        "warp" if warps else "lanes a block, x2: two threads a lane")
    print(f"kernel {name} trial on {what} (trial builds, in turns, "
          f"bit-exact; {legend}): "
          + ", ".join(f"{trial_label(n, warps)} {t:.3f} ms"
                      for n, t in trial.items())
          + f"; fastest {trial_label(best, warps)}")


def enc_lane_trial(libs, args, want):
    """The HT encoder built with each trial's code-blocks a CTA and coder
    placement, launched as `ht_enc.encode_into` launches it on `args` =
    (coeffs, mbs, tables), against the shipped kernel's packed segments
    and lengths `want`; the launches alone are timed."""
    import torch

    from grokimagecompression_tpu_torch.ops import ht_enc
    coeffs, mbs, tables = args
    B, H, W = coeffs.shape
    out, off, lens = ht_enc.encode_into(*args)
    m_max = min(int(mbs.max()) + 2, 32)

    def launcher(lib):
        def run():
            rc = lib.ht_enc_group(
                coeffs.data_ptr(), mbs.data_ptr(),
                tables["enc_packed"].data_ptr(), off.data_ptr(),
                out.data_ptr(), lens.data_ptr(), B, H // 2, W // 2, m_max,
                torch.cuda.current_stream().cuda_stream)
            if rc != 0:
                raise AssertionError(f"trial launch failed: CUDA error {rc}")
            return out, lens
        return run
    return in_turns({n: launcher(lib) for n, lib in libs.items()}, want,
                    "ht_encode", post=lambda r: (
                        ht_enc.pack(r[0], off, r[1]), r[1]))


def split_segments(data, lens):
    """Packed segments -> a list of bytes objects, lane after lane."""
    import numpy as np
    buf = data.cpu().numpy().tobytes()
    ends = np.cumsum(lens.cpu().numpy(), dtype=np.int64)
    return [buf[e - n:e] for e, n in zip(ends, lens.tolist())]


def ms_bytes(data, lens):
    """(B,) int64: each packed HT segment's MagSgn bytes, its length less
    the scup of its last two bytes."""
    import torch
    ends = torch.cumsum(lens.to(torch.int64), 0)
    last = data[ends - 1].to(torch.int64)
    scup = (last << 4) | (data[ends - 2].to(torch.int64) & 0xF)
    return lens.to(torch.int64) - scup


def check_encoder(enc, plan, chunk, results, trial_libs, clock_lib):
    """Phase 3, encode side: the HT encoder on each shape group of one
    chunk, the segments of the group's `plain_lanes` (by segment bytes)
    against the plain version on the card on those lanes;
    on the 64x64 group the kernel's call and device time, the lane with
    the most MagSgn bytes alone, its stage clocks (`enc_stage_clocks`)
    and the trial (`enc_lane_trial`)."""
    import torch

    from grokimagecompression_tpu_torch.ops import ht_enc
    name = ENC[0]
    for gi, (coeffs, mbs) in enumerate(enc.group_inputs(chunk)):
        tables = enc.tables()
        args = (coeffs, mbs, tables)
        got = ht_enc.encode_segments(*args)
        idx = plain_lanes(got[1])
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        want = ht_enc.encode_segments_plain(coeffs[idx].contiguous(),
                                            mbs[idx].contiguous(), tables)
        stop.record()
        torch.cuda.synchronize()
        plain_ms = start.elapsed_time(stop)
        qh, qw, _ = plan.groups[gi]
        B = coeffs.shape[0]
        segs = split_segments(*got)
        if split_segments(*want) != [segs[i] for i in idx.tolist()]:
            raise AssertionError(
                f"{name} segments differ from the plain version (group "
                f"{qh}x{qw} quads, B={B})")
        line = (f"kernel {name}: group {qh}x{qw} quads, B={B}, "
                f"{got[0].numel()} segment bytes: bit-exact with plain "
                f"(op streams, plain scans, metrics, placement, host "
                f"splice: {plain_ms:.1f} ms) on {idx.shape[0]} lanes "
                f"(`plain_lanes`)")
        if gi == len(plan.groups) - 1:
            for _ in range(3):
                ht_enc.encode_segments(*args)
            ms_k = cuda_ms(lambda: ht_enc.encode_segments(*args), 20)
            dev_k = device_ms(lambda: ht_enc.encode_segments(*args), 10,
                              "ht_enc_kernel", lambda: ht_enc.LAUNCHES["enc"])
            nsig = int((coeffs != 0).sum())
            b_ms, b_by, b_terms = bound(
                nbytes(coeffs, mbs, tables["enc_packed"], *got),
                OPS["enc_sample"] * coeffs.numel() + OPS["enc_sig"] * nsig
                + OPS["enc_byte"] * got[0].numel())
            msb = ms_bytes(*got)
            k = int(msb.argmax())
            one = (coeffs[k:k + 1], mbs[k:k + 1], tables)
            ht_enc.encode_segments(*one)
            alone = cuda_ms(lambda: ht_enc.encode_segments(*one), 10)
            alone_dev = device_ms(lambda: ht_enc.encode_segments(*one), 10,
                                  "ht_enc_kernel",
                                  lambda: ht_enc.LAUNCHES["enc"])
            trial = enc_lane_trial(trial_libs, args, got)
            results[name] = dict(
                ms=ms_k, device_ms=dev_k, plain_ms=plain_ms, max_abs_err=0,
                bound_ms=b_ms, bound_by=b_by, alone_ms=alone,
                shape=tuple(coeffs.shape),
                trial={f"config 1, {2 * qw}x{2 * qh}, B={B}": trial})
            line += (f"; {ms_k:.3f} ms, of it {fmt_ms(dev_k)} in the "
                     f"kernel (profiler) (before the redesign, the three "
                     f"scans alone: {BEFORE_MS[name]:.3f} ms on "
                     f"{BEFORE_CARD}; bound {b_ms:.4f} ms by {b_by}: "
                     f"{b_terms}); the lane with the most MagSgn bytes "
                     f"({int(msb[k])} of {int(got[1][k])}) alone "
                     f"{alone:.3f} ms, of it {fmt_ms(alone_dev)} in the "
                     f"kernel")
            print(line)
            print_trial(name, f"the config-1 {2 * qw}x{2 * qh} group, B={B}",
                        trial, warps=True)
            for what, a in (("the lane with the most MagSgn bytes alone",
                             one[:2]), ("block 0 of the whole group",
                                        args[:2])):
                marks, ends = enc_stage_clocks(clock_lib, *a, tables)
                print(f"kernel {name} stage clocks on {what} (an "
                      f"instrumented build, clock64, cycles from the "
                      f"kernel's start): load {marks[0]}, stage A "
                      f"{marks[1]}, stages B+C {marks[2]}, scan and bit "
                      f"packing {marks[3]}, coders {marks[4]} (MagSgn, VLC, "
                      f"MEL end at {ends[0]}, {ends[1]}, {ends[2]}), fuse "
                      f"rule {marks[5]}")
        else:
            print(line)


def check_decoder(streams, dev, results, trial_libs):
    """Phase 3, decode side: the HT decoder on the raw segments of every
    lane group of one chunk of streams, every lane against the plain
    version (the host prepass, then the plain decoder on the card); on
    each group the threads trial (`ht_lane_trial`); on the 64x64 group
    the kernel's time and the lane with the most MagSgn bytes alone. The
    plain version decodes the group's `plain_lanes` (by segment
    length)."""
    import numpy as np
    import torch

    from grokimagecompression_tpu_torch.codestream import decoder
    from grokimagecompression_tpu_torch.models import fused_decode
    from grokimagecompression_tpu_torch.native import ht_prepass
    from grokimagecompression_tpu_torch.ops import ht_dec, ht_tables

    hdr, trs, parsed = decoder.parse_batch(streams)
    plan = fused_decode.build_plan(parsed[0][0][0][2], hdr.siz, hdr.cod,
                                   trs[0])
    tables = ht_tables.device_dec_tables(dev)
    host = fused_decode.prepare_chunk(
        plan, [fused_decode.jobs_by_block(*p[0][0][:3]) for p in parsed])
    name = DEC[0]
    trials = {}
    for (w, h, _), arrs, group in zip(plan.groups, host,
                                          fused_decode.upload(host, dev)):
        data, off, lcup, scup = group[:4]
        B = lcup.shape[0]
        args = (data, off, lcup, scup, w, h, tables)
        got = ht_dec.decode_segments(*args)
        idx = plain_lanes(lcup)
        lanes = idx.tolist()
        raw, o = arrs[0].tobytes(), arrs[1]
        segs = [raw[o[i]:o[i + 1]] for i in lanes]
        words = [torch.from_numpy(a.view(np.int32)).to(dev)
                 for a in ht_prepass.prepass_group(
                     segs, arrs[2][lanes].tolist(), arrs[3][lanes].tolist())]
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        want = ht_dec.decode_group_plain(*words, w, h, tables["dec0"],
                                         tables["dec1"])
        stop.record()
        torch.cuda.synchronize()
        plain_ms = start.elapsed_time(stop)
        err = max(int((wv.to(torch.int64) - g[idx].to(torch.int64))
                      .abs().max()) for wv, g in zip(want, got))
        for part, wv, g in zip(("mags", "signs"), want, got):
            if not torch.equal(wv, g[idx]):
                raise AssertionError(
                    f"{name} {part} differ from the plain version "
                    f"({w}x{h} blocks, B={B})")
        trial = ht_lane_trial(trial_libs, args, got)
        trials[f"config 1, {w}x{h}, B={B}"] = trial
        line = (f"kernel {name}: {w}x{h} blocks, B={B}, {data.numel()} "
                f"segment bytes -> {tuple(got[0].shape)}: bit-exact with "
                f"plain (host prepass + decode_group_plain) on "
                f"{len(lanes)} lanes (`plain_lanes`) (plain "
                f"{plain_ms:.1f} ms)")
        if (w, h) == (64, 64):
            for _ in range(3):
                ht_dec.decode_segments(*args)
            ms_k = cuda_ms(lambda: ht_dec.decode_segments(*args), 20)
            dev_k = device_ms(lambda: ht_dec.decode_segments(*args), 10,
                              "ht_dec_kernel", lambda: ht_dec.LAUNCHES["dec"])
            steps = ht_dec.grid_dims(w, h)[2] * B
            nsig = int((got[0] != 0).sum())
            b_ms, b_by, b_terms = bound(
                nbytes(data, off, lcup, scup, tables["dec0"],
                       tables["dec1"], *got),
                OPS["dec_step"] * steps + OPS["dec_sample"] * nsig)
            # the chain that bounds the kernel from below: the lane with
            # the most MagSgn bytes, alone
            k = int((lcup - scup).argmax())
            lo, hi = int(off[k]), int(off[k + 1])
            one = (data[lo:hi].contiguous(), (off[k:k + 2] - lo).contiguous(),
                   lcup[k:k + 1], scup[k:k + 1], w, h, tables)
            ht_dec.decode_segments(*one)
            alone = cuda_ms(lambda: ht_dec.decode_segments(*one), 10)
            alone_dev = device_ms(lambda: ht_dec.decode_segments(*one), 10,
                                  "ht_dec_kernel",
                                  lambda: ht_dec.LAUNCHES["dec"])
            results[name] = dict(ms=ms_k, plain_ms=plain_ms,
                                 max_abs_err=err, bound_ms=b_ms,
                                 bound_by=b_by, alone_ms=alone)
            line += (f"; {ms_k:.3f} ms, of it {fmt_ms(dev_k)} in the "
                     f"kernel (profiler) (on prepass words before the "
                     f"redesign: {BEFORE_MS[name]:.3f} ms on {BEFORE_CARD}; "
                     f"bound {b_ms:.4f} ms by {b_by}: {b_terms}); the lane "
                     f"with the most MagSgn bytes "
                     f"({int(lcup[k] - scup[k])} of {int(lcup[k])}) alone "
                     f"{alone:.3f} ms, of it {fmt_ms(alone_dev)} in the "
                     f"kernel")
        print(line)
        print_trial(name, f"the config-1 {w}x{h} group, B={B}", trial)
    results[name]["trial"] = trials


def c2_ht_trial(enc, chunk, results, trial_libs, enc_libs):
    """Phase 3 on the lane group of a config-2 HT 9/7 decode: the
    quantized 9/7 code-blocks of a config-2 chunk (2 frames, 6144 64x64
    lanes) HT-coded by the port's HT encoder, each lane's Mb its own
    magnitudes' bit length. The encoder is held to its
    plain version on 256 of the lanes and its trial builds to the shipped
    kernel; then the HT decoder's threads trial on the segments, the
    decoder held to its plain version on 256 lanes."""
    import numpy as np
    import torch

    from grokimagecompression_tpu_torch.native import ht_prepass
    from grokimagecompression_tpu_torch.ops import ht_dec, ht_enc, ht_tables
    dev = chunk[0].device
    ((mag, neg, _),) = list(enc.group_inputs(*chunk))
    h, w = mag.shape[1:]
    mag = mag.to(torch.int64)
    top = mag.amax(dim=(1, 2))
    mbs = sum((top >> b) > 0 for b in range(32)).clamp(min=1).to(torch.int32)
    coeffs = torch.where(neg, -mag, mag).to(torch.int32)
    del mag, neg
    tables = ht_tables.device_tables(dev)
    got_enc = ht_enc.encode_segments(coeffs, mbs, tables)
    B = coeffs.shape[0]
    pick = np.linspace(0, B - 1, 256).round().astype(int)
    idx = torch.as_tensor(pick, device=dev)
    want_enc = ht_enc.encode_segments_plain(coeffs[idx].contiguous(),
                                            mbs[idx].contiguous(), tables)
    segs = split_segments(*got_enc)
    if [segs[i] for i in pick] != split_segments(*want_enc):
        raise AssertionError(f"{ENC[0]} differs from the plain version on "
                             f"the config-2 HT lanes")
    enc_trial = enc_lane_trial(enc_libs, (coeffs, mbs, tables), got_enc)
    results[ENC[0]]["trial"][f"config 2 HT 9/7, {w}x{h}, B={B}"] = \
        enc_trial
    print(f"kernel {ENC[0]}: config-2 HT 9/7 group of {chunk[0].shape[0]} "
          f"frames, {w}x{h} blocks, B={B}, Mb up to {int(mbs.max())}, "
          f"{got_enc[0].numel()} segment bytes: bit-exact with plain on 256 "
          f"lanes spread over the group")
    print_trial(ENC[0], f"the config-2 HT 9/7 group, B={B}", enc_trial,
                warps=True)
    del coeffs, got_enc
    scups = [(s[-1] << 4) + (s[-2] & 0xF) for s in segs]
    tables = ht_tables.device_dec_tables(dev)
    data, off, lcup, scup = (torch.from_numpy(a).to(dev) for a in
                             ht_dec.pack_segments(segs, scups))
    args = (data, off, lcup, scup, w, h, tables)
    got = ht_dec.decode_segments(*args)
    sub = [segs[i] for i in pick]
    sub_words = [torch.from_numpy(a.view(np.int32)).to(dev)
                 for a in ht_prepass.prepass_group(
                     sub, [len(x) for x in sub], [scups[i] for i in pick])]
    want = ht_dec.decode_group_plain(*sub_words, w, h, tables["dec0"],
                                     tables["dec1"])
    for part, wv, g in zip(("mags", "signs"), want, got):
        if not torch.equal(wv, g[idx]):
            raise AssertionError(f"{DEC[0]} {part} differ from the plain "
                                 f"version on the config-2 HT lanes")
    trial = ht_lane_trial(trial_libs, args, got)
    results[DEC[0]]["trial"][f"config 2, {w}x{h}, B={B}"] = trial
    print(f"kernel {DEC[0]}: config-2 HT 9/7 group of {chunk[0].shape[0]} "
          f"frames, {w}x{h} blocks, B={B}, {data.numel()} segment bytes: "
          f"bit-exact with plain on 256 lanes spread over the group")
    print_trial(DEC[0], f"the config-2 HT 9/7 group, B={B}", trial)
    torch.cuda.empty_cache()


def encode_stages(enc, chunk):
    """Time of one 32-frame encode chunk by stage (host clock,
    synchronised), as `FusedHTEncoder.forward` and
    `encode_tile_collect` run it."""
    import torch

    from grokimagecompression_tpu_torch.models import fused_encode
    from grokimagecompression_tpu_torch.ops import ht_enc
    stages = {}
    tt = time.perf_counter
    torch.cuda.synchronize()
    t = tt()
    gin = list(enc.group_inputs(chunk))
    torch.cuda.synchronize()
    stages["transform+gather"] = tt() - t
    t = tt()
    outs = [ht_enc.encode_into(co, mbs, enc.tables()) for co, mbs in gin]
    torch.cuda.synchronize()
    stages["HT encode kernel"] = tt() - t
    t = tt()
    lens = torch.cat([o[2] for o in outs]).cpu().numpy()
    data = torch.cat([ht_enc.pack(*o) for o in outs]).cpu().numpy()
    stages["pack+fetch"] = tt() - t
    t = tt()
    fused_encode.assemble_collected_ht(enc.plan, chunk.shape[0], lens, data)
    stages["host slice"] = tt() - t
    return stages


def decode_stages(streams, dev, host_stage):
    """Time of one 32-frame decode chunk by stage (host clock,
    synchronised); `host_stage` names the host work between T2 and the
    upload (the lane packing)."""
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
    bands = dec.split_bands(dec.assemble(
        grids, [g[-1] for g in groups], len(streams)))
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


def check_mq_scan(mq_enc, chunk, results, trial_libs):
    """Phase 3, MQ: the MQ coder on the slot streams of each shape group
    of one chunk, every lane against the plain version; on the 64x64
    group the lanes-per-block trial (`scan_lane_trial`)."""
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
            # one launch a scan: what the kernel's ms covers
            ms = cuda_ms(lambda: mq_scan.scan_into(slots, off, total), 20)
            b_ms, b_by, b_terms = bound(
                nbytes(slots, *got),
                OPS["mq_decision"] * emits + OPS["mq_byte"] * got[0].numel())
            results[name] = dict(ms=ms, plain_ms=plain_ms, max_abs_err=err,
                                 bound_ms=b_ms, bound_by=b_by,
                                 shape=tuple(slots.shape))
            per_lane = mq_scan.lane_emits(slots)
            # the chain that sets the time from below: the lane with the
            # most coding slots, alone
            deep = slots[:, int(per_lane.argmax())].contiguous().view(T, 1)
            d_off, d_total = mq_scan.segment_offsets(deep)
            mq_scan.scan_into(deep, d_off, d_total)
            alone = cuda_ms(lambda: mq_scan.scan_into(deep, d_off, d_total),
                            10)
            results[name]["alone_ms"] = alone
            trial = scan_lane_trial(trial_libs, slots, got)
            results[name]["trial"] = trial
            line += (f"; kernel {ms:.3f} ms (before the redesign: "
                     f"{BEFORE_MS[name]:.3f} ms on {BEFORE_CARD}; bound "
                     f"{b_ms:.4f} ms by {b_by}: "
                     f"{b_terms}); the longest lane codes "
                     f"{int(per_lane.max())} slots (mean "
                     f"{float(per_lane.double().mean()):.0f}), alone "
                     f"{alone:.3f} ms; lanes a "
                     f"block (trial builds, in turns, bit-exact): "
                     + ", ".join(f"{n} {t:.3f} ms" for n, t in trial.items()))
        print(line)


def check_dense_words(slots, words, mask, state, what):
    """Per lane: its dense words' bytes (little-endian, step order), then
    wcnt bytes of its partial word, against its segment's first bytes from
    the compact kernel (`mq_scan.mq_scan`) on the same slots: the segment
    before the flush tail. Returns (the lanes' total segment bytes, the
    number of words)."""
    import torch

    from grokimagecompression_tpu_torch.ops import mq_scan
    B = slots.shape[1]
    dev = slots.device
    data, lens, _ = mq_scan.mq_scan(slots)
    lens = lens.to(torch.int64)
    seg0 = torch.cumsum(lens, 0) - lens
    nw = mask.sum(dim=0)
    wbytes = words.T[mask.T].contiguous().view(torch.uint8)
    k = torch.arange(wbytes.numel(), device=dev)
    wlane = torch.repeat_interleave(torch.arange(B, device=dev), nw)
    wstart = torch.cumsum(nw, 0) - nw
    wi = k // 4
    pos = seg0[wlane[wi]] + 4 * (wi - wstart[wlane[wi]]) + k % 4
    wcnt = state[5].to(torch.int64)
    if bool((4 * nw + wcnt > lens).any()) or \
            not torch.equal(data[pos], wbytes):
        raise AssertionError(f"mq_scan_dense words differ from the compact "
                             f"kernel's segments ({what})")
    j = torch.arange(4, device=dev)
    part = j[None, :] < wcnt[:, None]
    ppos = (seg0 + 4 * nw)[:, None] + j[None, :]
    pbytes = (state[4].to(torch.int64)[:, None] >> (8 * j[None, :])) & 0xFF
    if not torch.equal(data[ppos[part]].to(torch.int64), pbytes[part]):
        raise AssertionError(f"mq_scan_dense partial words differ from the "
                             f"compact kernel's segments ({what})")
    return int(lens.sum()), int(nw.sum())


def dense_device_ms(slots, deep):
    """The dense scan's device time a call by torch.profiler (`device_ms`)
    on `slots` and on `deep`, in a child process that loads only the
    shipped kernel library: in this process, with the trial and
    instrumented builds loaded, the profiler records only some of the
    dense kernel's launches (measured on torch 2.11 + CUDA 12.8: 2 of 4,
    none of one), and `device_ms` rejects such a count."""
    import torch

    from grokimagecompression_tpu_torch.ops import _build
    path = os.path.join(_build.BUILD_DIR, "dense_slots.pt")
    torch.save({"slots": slots.cpu(), "deep": deep.cpu()}, path)
    code = (
        "import json, sys, torch\n"
        "sys.path.insert(0, sys.argv[2])\n"
        "import chip_smoke as cs\n"
        "from grokimagecompression_tpu_torch.ops import mq_scan\n"
        "d = torch.load(sys.argv[1])\n"
        "n = lambda: mq_scan.LAUNCHES['mq_dense']\n"
        "print(json.dumps([cs.device_ms(\n"
        "    lambda s=d[k].cuda(): mq_scan.scan_dense(s), 3,\n"
        "    'mq_dense_kernel', n) for k in ('slots', 'deep')]))\n")
    torch.cuda.empty_cache()
    root = os.path.dirname(os.path.abspath(__file__))
    try:
        proc = subprocess.run([sys.executable, "-c", code, path, root],
                              capture_output=True, text=True, timeout=600)
    finally:
        os.unlink(path)
    if proc.returncode != 0:
        raise AssertionError(f"the profiler's child process failed "
                             f"({proc.returncode}):\n{proc.stderr[-3000:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def check_mq_dense(mq_enc, chunk, results, launches, trial_libs, clock_lib):
    """Phase 3, the dense MQ scan: on 128 lanes of the config-1 64x64
    group cut to the leading planes in which no lane codes more than
    PLAIN_DENSE_DECISIONS decisions (and 256 no-op rows past the end),
    every output (flat and blocked) bit-exact with the plain version; then
    the reference's entry point `run_mq_scans` on the full group, the
    path whose launches are counted, its words' bytes in order with each
    lane's partial word equal to the compact kernel's segment before the
    flush tail; the kernel's call and device time, the lane with the most
    coding slots alone, the stage clocks of block 0
    (`dense_stage_clocks`) and the lanes-a-warp x warps-a-block trial
    (`dense_lane_trial`)."""
    import torch

    from grokimagecompression_tpu_torch.ops import mq_scan, mq_torch
    gin = list(mq_enc.group_inputs(chunk))
    mag, neg, orient = gin[-1]
    _, slots = mq_enc.group_slots(mag, neg, orient)
    del gin, mag, neg, orient
    h, w = mq_enc.plan.groups[-1][:2]
    T, B = slots.shape
    tp = mq_torch.slots_per_plane(h, w)
    npl = T // tp
    lanes = torch.linspace(0, B - 1, 128, device=slots.device).round().long()
    sub = slots[:, lanes]
    coded = (sub.view(npl, tp, 128) & 1).sum(dim=1).cumsum(0).amax(dim=1)
    keep = max(1, int((coded <= PLAIN_DENSE_DECISIONS).sum()))
    sub = sub[:keep * tp].contiguous()
    got = mq_scan.scan_dense(sub, keep * tp + 256)
    blocked = mq_scan.run_mq_scans_blocked(sub)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    want = mq_torch.mq_scan_dense_plain(sub, keep * tp + 256)
    stop.record()
    torch.cuda.synchronize()
    plain_ms = start.elapsed_time(stop)
    for part, wv, g in zip(("words", "m8", "nbo", "state"), want, got):
        if not torch.equal(wv, g):
            raise AssertionError(f"mq_scan_dense {part} differ from the "
                                 f"plain version ({keep} planes, 128 lanes)")
    for part, wv, g in zip(("words", "m8", "nbo", "state"), want, blocked):
        rows = wv if part == "state" else wv[:g.shape[0]]
        if not torch.equal(rows.reshape(g.shape), g):
            raise AssertionError(f"run_mq_scans_blocked {part} differ from "
                                 f"the plain version")
    err = max(int((wv.to(torch.int64) - g.to(torch.int64)).abs().max())
              for wv, g in zip(want, got))
    print(f"kernel mq_scan_dense: config-1 group {h}x{w}, 128 of {B} lanes, "
          f"{keep} of {npl} planes (T={sub.shape[0]}, {int(coded[keep - 1])} "
          f"decisions in the deepest lane, 256 no-op rows past T), flat and "
          f"blocked: bit-exact with plain (plain {plain_ms:.1f} ms)")
    del got, blocked, want

    mq_scan.LAUNCHES["mq_dense"] = 0
    words, mask, nbo, state = mq_scan.run_mq_scans(slots)
    torch.cuda.synchronize()
    launches["mq_dense"] = mq_scan.LAUNCHES["mq_dense"]
    if launches["mq_dense"] < 1:
        raise AssertionError("mq_scan_dense was not launched by "
                             "run_mq_scans")
    seg_bytes, nwords = check_dense_words(slots, words, mask, state,
                                          "config-1 group")
    del words, mask, nbo, state
    for _ in range(2):
        mq_scan.scan_dense(slots)
    ms = cuda_ms(lambda: mq_scan.scan_dense(slots), 5)
    emits = int((slots & 1).sum())
    out_bytes = 3 * 4 * T * B + 4 * 11 * B
    b_ms, b_by, b_terms = bound(
        nbytes(slots) + out_bytes,
        OPS["mq_decision"] * emits + OPS["mq_byte"] * seg_bytes)
    # the chain that sets the time from below: the lane with the most
    # coding slots, alone
    per_lane = mq_scan.lane_emits(slots)
    deep = slots[:, int(per_lane.argmax())].contiguous().view(T, 1)
    mq_scan.scan_dense(deep)
    alone = cuda_ms(lambda: mq_scan.scan_dense(deep), 5)
    dev_ms, alone_dev = dense_device_ms(slots, deep)
    clocks = dense_stage_clocks(clock_lib, slots)
    want = mq_scan.scan_dense(slots)
    trial = dense_lane_trial(trial_libs, slots, want)
    del want
    torch.cuda.empty_cache()
    results[MQ_DENSE[0]] = dict(ms=ms, device_ms=dev_ms, plain_ms=plain_ms,
                                max_abs_err=err, bound_ms=b_ms,
                                bound_by=b_by, alone_ms=alone,
                                trial={f"config 1, {w}x{h}, B={B}": trial})
    print(f"mq_scan_dense through run_mq_scans on the full group: slots "
          f"({T}, {B}), {emits} coding, {nwords} words: every lane's "
          f"words and partial word are its compact segment before the flush "
          f"tail; launches {launches['mq_dense']}; {ms:.3f} ms a call, of "
          f"it {fmt_ms(dev_ms)} in the kernel (profiler, in a child "
          f"process) (one thread a lane "
          f"before the redesign: {BEFORE_MS['mq_scan_dense']:.3f} ms on "
          f"{BEFORE_CARD}; bound {b_ms:.4f} ms by {b_by}: {b_terms}); the "
          f"lane with the most coding slots ({int(per_lane.max())}, mean "
          f"{float(per_lane.double().mean()):.0f}) alone {alone:.3f} ms, of "
          f"it {fmt_ms(alone_dev)} in the kernel")
    total = sum(clocks.values())
    print("kernel mq_scan_dense stage clocks on block 0 of the full group "
          "(an instrumented build, clock64, thread 0, cycles summed over "
          "the tiles): " + ", ".join(
              f"{k} {v} ({100 * v / max(total, 1):.1f} %)"
              for k, v in clocks.items()))
    print_trial(MQ_DENSE[0], f"the config-1 {w}x{h} group, B={B}", trial,
                legend="lanes a warp x warps a block")


def check_mq_decoder(streams, dev, results, trial_libs):
    """Phase 3, MQ decode: the MQ decoder on the lane groups of one chunk
    of MQ streams, the group's `plain_lanes` (by passes, then segment
    bytes) against the plain version on those lanes; on the 64x64 group
    the lanes-per-block trial (`lane_trial`)."""
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
        seg_bytes = (off[1:] - off[:-1]).to(torch.int64)
        idx = plain_lanes(npas.to(torch.int64) * (1 << 32) + seg_bytes)
        sub = lane_subset(data, off, idx) + (nbps[idx], npas[idx], ori[idx],
                                             w, h)
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        want = mq_dec_torch.decode_group_plain(*sub, with_stats=True)
        stop.record()
        torch.cuda.synchronize()
        plain_ms = start.elapsed_time(stop)
        if (w, h) == (32, 32):
            rate = plain_ms / 1e3 / work
        for part, wv, g in zip(("samples", "statistics"), want, got):
            if not torch.equal(wv, g[:, idx]):
                raise AssertionError(
                    f"{name} {part} differ from the plain version "
                    f"({w}x{h} blocks, B={B})")
        err = max(int((wv.to(torch.int64) - g[:, idx].to(torch.int64))
                      .abs().max()) for wv, g in zip(want, got))
        line = (f"kernel {name}: {w}x{h} blocks, B={B}, {data.numel()} "
                f"segment bytes, up to {int(npas.max())} passes -> "
                f"{tuple(got[0].shape)}: bit-exact with plain on "
                f"{idx.shape[0]} lanes (`plain_lanes`) (plain "
                f"{plain_ms:.1f} ms){note}")
        if (w, h) == (64, 64):
            full = (data, off, nbps, npas_full, ori, w, h)
            for _ in range(3):
                mq_dec.decode_group(*full)
            ms = cuda_ms(lambda: mq_dec.decode_group(*full), 20)
            packed, stats = mq_dec.decode_group(*full, with_stats=True)
            nb = nbps.to(torch.int64)
            passes = torch.minimum(npas_full.to(torch.int64),
                                   (3 * nb - 2).clamp(min=0))
            visits = w * h * int(passes.sum())
            ndec, nbyte = (int(v) for v in stats.to(torch.int64).sum(1))
            b_ms, b_by, b_terms = bound(
                nbytes(data, off, nbps, npas_full, ori, packed, stats),
                OPS["mqd_decision"] * ndec + OPS["mqd_byte"] * nbyte
                + OPS["mqd_visit"] * visits)
            trial = dec_lane_trial(trial_libs, full, (packed, stats))
            # the chain that sets the time from below: the lane with the
            # most decisions, alone
            k = int(stats[0].argmax())
            lo, hi = int(off[k]), int(off[k + 1])
            one = (data[lo:hi].contiguous(), (off[k:k + 2] - lo).contiguous(),
                   nbps[k:k + 1], npas_full[k:k + 1], ori[k:k + 1], w, h)
            mq_dec.decode_group(*one)
            alone = cuda_ms(lambda: mq_dec.decode_group(*one), 10)
            results[name] = dict(ms=ms, plain_ms=plain_ms, max_abs_err=err,
                                 bound_ms=b_ms, bound_by=b_by, trial=trial)
            line += (f"; kernel {ms:.3f} ms at full depth (before the "
                     f"redesign: {BEFORE_MS[name]:.3f} ms on {BEFORE_CARD}): "
                     f"{ndec} "
                     f"decisions, {nbyte} BYTEINs, {visits} sample visits "
                     f"(bound {b_ms:.4f} ms by {b_by}: {b_terms}; the "
                     f"operation term an estimate); per lane at most "
                     f"{int(stats[0].max())} decisions, "
                     f"{w * h * int(passes.max())} sample visits and "
                     f"{-(-h // 4) * w * int(passes.max())} stripe-column "
                     f"visits in {int(passes.max())} passes; the lane with "
                     f"the most decisions alone {alone:.3f} ms; lanes a block "
                     f"(trial builds, in turns, bit-exact): " + ", ".join(
                         f"{n} {t:.3f} ms" for n, t in trial.items()))
        print(line)


def dwt_work(shape, rect, nres, reversible):
    """(bytes a transform moves at least: its input read and its output
    written once; its operations: per level region sample two passes of
    7 float32 (9/7) or 3.5 integer (5/3) operations)."""
    import math

    from grokimagecompression_tpu_torch.core.geometry import resolution_rect
    n = math.prod(shape[:-2])
    area = sum(resolution_rect(rect, nres, nres - 1 - lev).h
               * resolution_rect(rect, nres, nres - 1 - lev).w
               for lev in range(nres - 1))
    return 2 * 4 * math.prod(shape), n * area * 2 * (3.5 if reversible
                                                      else 7)


def dwt_device_ms(shape, rect, nres):
    """The 9/7 forward DWT's device time a call by torch.profiler
    (`device_ms`, with its launch-count check) on random float32 planes of
    `shape`, in a child process that loads only the shipped kernel
    library: in this process, with the trial and instrumented builds
    loaded, the profiler drops records (see `dense_device_ms`)."""
    code = (
        "import json, sys, torch\n"
        "sys.path.insert(0, sys.argv[1])\n"
        "import chip_smoke as cs\n"
        "from grokimagecompression_tpu_torch.core.geometry import Rect\n"
        "from grokimagecompression_tpu_torch.ops import dwt\n"
        "shape, r, nres = json.loads(sys.argv[2])\n"
        "g = torch.Generator().manual_seed(0)\n"
        "x = (torch.rand(shape, generator=g) * 255 - 128).cuda()\n"
        "rect = Rect(*r)\n"
        "print(json.dumps(cs.device_ms(\n"
        "    lambda: dwt.fwd_dwt_2d(x, rect, nres, False), 10,\n"
        "    'fwd_kernel', lambda: dwt.LAUNCHES['dwt'])))\n")
    root = os.path.dirname(os.path.abspath(__file__))
    arg = json.dumps([list(shape), [rect.x0, rect.y0, rect.x1, rect.y1],
                      nres])
    proc = subprocess.run([sys.executable, "-c", code, root, arg],
                          capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        raise AssertionError(f"the DWT profiler's child process failed "
                             f"({proc.returncode}):\n{proc.stderr[-3000:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def check_dwt(dev, results, cases=None, key="times"):
    """Phase 3, DWT: forward and inverse, 5/3 and 9/7, at the config-1
    chunk, the config-2 frame, an odd-origin rect, a rect with
    single-sample levels and a rect one sample wider and higher than the
    kernel's tile there (or at `cases`: (label, shape, rect, resolutions,
    which filter is timed: True 5/3, False 9/7, None neither)), each
    bit-exact with the plain version and each transform at most one
    launch per level (none for a level of no samples); the main shapes
    timed, forward and inverse, beside their bounds, into
    `results["dwt"][key]`."""
    import torch

    from grokimagecompression_tpu_torch.core.geometry import Rect
    from grokimagecompression_tpu_torch.ops import dwt, dwt_torch
    over = dwt.TILES[0] + 1
    if cases is None:
        cases = (("config-1 chunk", (CHUNK, SIZE, SIZE),
                  Rect(0, 0, SIZE, SIZE), 6, True),
                 ("config-2 frame", (3, C2_SIZE, C2_SIZE),
                  Rect(0, 0, C2_SIZE, C2_SIZE), 6, False),
                 ("odd origin", (2, 67, 93), Rect(1, 3, 94, 70), 4, None),
                 ("single-sample levels", (2, 17, 1), Rect(5, 2, 6, 19), 3,
                  None),
                 ("a tile + 1", (40, over, over),
                  Rect(1, 1, over + 1, over + 1), 3, None))
        if dwt.tile_for(40, over, over) != dwt.TILES[0]:
            raise AssertionError("the tile + 1 case does not take the "
                                 "largest tile")
    gen = torch.Generator().manual_seed(0)
    times = {}
    for label, shape, rect, nres, timed in cases:
        for rev in (True, False):
            x = torch.randint(-128, 128, shape, generator=gen,
                              dtype=torch.int32)
            if not rev:
                x = x + torch.rand(shape, generator=gen)
            x = x.to(dev)
            before = dwt.LAUNCHES["dwt"]
            got = dwt.fwd_dwt_2d(x, rect, nres, rev)
            back = dwt.inv_dwt_2d(got, rect, nres, rev)
            made = dwt.LAUNCHES["dwt"] - before
            if not 1 <= made <= 2 * (nres - 1):
                raise AssertionError(f"dwt made {made} launches for "
                                     f"{nres - 1} levels, forward and "
                                     f"inverse ({label})")
            want = dwt_torch.fwd_dwt_2d(x, rect, nres, rev)
            back_want = dwt_torch.inv_dwt_2d(want, rect, nres, rev)
            torch.cuda.synchronize()
            err = 0.0
            for k in want:
                if not torch.equal(got[k], want[k]):
                    raise AssertionError(f"dwt forward band {k} differs from "
                                         f"the plain version ({label}, "
                                         f"{'5/3' if rev else '9/7'})")
            if not torch.equal(back, back_want):
                raise AssertionError(f"dwt inverse differs from the plain "
                                     f"version ({label}, "
                                     f"{'5/3' if rev else '9/7'})")
            line = (f"kernel dwt: {label} {tuple(shape)} at "
                    f"({rect.x0}, {rect.y0}), {nres} resolutions, "
                    f"{'5/3 int32' if rev else '9/7 float32'}: forward and "
                    f"inverse bit-exact with plain in {made} launches")
            if timed is rev:
                nb, ops = dwt_work(shape, rect, nres, rev)
                b_ms, b_by, b_terms = bound(nb, ops,
                                            INT_OPS_S if rev else F32_OPS_S)
                for name, kern, plain, arg in (
                        ("forward", dwt.fwd_dwt_2d, dwt_torch.fwd_dwt_2d, x),
                        ("inverse", dwt.inv_dwt_2d, dwt_torch.inv_dwt_2d,
                         got)):
                    ms, plain_ms = time_kernel(
                        lambda a, k=kern: k(a, rect, nres, rev),
                        lambda a, p=plain: p(a, rect, nres, rev), (arg,))
                    dev_ms = device_ms(
                        lambda a=arg, k=kern: k(a, rect, nres, rev), 10,
                        "fwd_kernel" if name == "forward" else "inv_kernel",
                        lambda: dwt.LAUNCHES["dwt"])
                    times[f"{label} {name}"] = dict(ms=ms, plain_ms=plain_ms,
                                                    bound_ms=b_ms,
                                                    device_ms=dev_ms)
                    line += (f"; {name} {ms:.3f} ms, of it "
                             f"{fmt_ms(dev_ms)} in the kernel's launches "
                             f"(profiler) (plain {plain_ms:.1f} ms, bound "
                             f"{b_ms:.4f} ms by {b_by}: {b_terms})")
                    if label == "config-2 frame":
                        line += (f" [before the redesign: "
                                 f"{BEFORE_MS['dwt ' + name]:.3f} ms on "
                                 f"{BEFORE_CARD}]")
                    if label == "config-2 frame" and name == "forward":
                        alone = dwt_device_ms(shape, rect, nres)
                        times[f"{label} {name}"]["device_ms_alone"] = alone
                        line += (f", {fmt_ms(alone)} in the kernel's "
                                 f"launches in a process that loads only "
                                 f"the shipped library (profiler)")
                        results["dwt"] = dict(ms=ms, plain_ms=plain_ms,
                                              max_abs_err=err, bound_ms=b_ms,
                                              bound_by=b_by)
            print(line)
    results.setdefault("dwt", {})[key] = times


def check_mq_cumbo(enc, chunk):
    """Phase 3, MQ byte-outs: the MQ coder's pass-end byte-outs, with its
    segments, lengths and state, on 64 lanes spread over the config-2
    group of one frame, against the plain version; cut to the leading
    planes in which no lane codes more than PLAIN_MQ_DECISIONS
    decisions."""
    import torch

    from grokimagecompression_tpu_torch.ops import mq_scan, mq_torch
    ((mag, neg, orient),) = list(enc.group_inputs(*chunk))
    _, slots, _ = enc.group_slots(mag, neg, orient)
    h, w = mag.shape[1:]
    spans = mq_torch.pass_spans_padded(h, w)
    tp = sum(spans)
    npl = slots.shape[0] // tp
    lanes = torch.linspace(0, slots.shape[1] - 1, 64,
                           device=slots.device).round().long()
    sub = slots[:, lanes]
    coded = (sub.view(npl, tp, 64) & 1).sum(dim=1).cumsum(0).amax(dim=1)
    keep = max(1, int((coded <= PLAIN_MQ_DECISIONS).sum()))
    sub = sub[:keep * tp].contiguous()
    got = mq_scan.mq_scan(sub, spans)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    want = mq_torch.mq_scan_plain(sub, spans)
    stop.record()
    torch.cuda.synchronize()
    for part, wv, g in zip(("segments", "lengths", "state", "byte-outs"),
                           want, got):
        if not torch.equal(wv, g):
            raise AssertionError(f"mq_scan {part} differ from the plain "
                                 f"version (config-2 lanes, {keep} planes)")
    print(f"kernel mq_scan with pass-end byte-outs: config-2 group "
          f"{h}x{w}, 64 of {slots.shape[1]} lanes, {keep} of {npl} planes "
          f"(T={sub.shape[0]}), {int(coded[keep - 1])} decisions in the "
          f"deepest lane -> cumbo {tuple(got[3].shape)}: bit-exact with "
          f"plain (plain {start.elapsed_time(stop):.1f} ms)")


def c2_scan_trial(enc, chunk, results, trial_libs, dense_libs):
    """Phase 3, the MQ coder's lanes-per-block trial on a config-2 chunk's
    group (2 frames: 6144 lanes, ~4x the config-1 group's coding slots):
    where the lanes outnumber the SMs' resident warps, a trial's lanes a
    block trade the warp's divergence against its share of the staging
    and compaction. Then the dense scan on the same group: every lane's
    words and partial word against the compact kernel's segment, its call
    time and its lanes-a-warp x warps-a-block trial (the shipped kernel's
    outputs, 20.8 GB, and one trial set held at once)."""
    import torch

    from grokimagecompression_tpu_torch.ops import mq_scan, mq_torch
    ((mag, neg, orient),) = list(enc.group_inputs(*chunk))
    _, slots, _ = enc.group_slots(mag, neg, orient)
    del mag, neg, orient
    h, w = enc.plan.groups[0][:2]
    want = mq_scan.mq_scan(slots, mq_torch.pass_spans_padded(h, w))[:3]
    trial = scan_lane_trial(trial_libs, slots, want)
    results[MQ[0]]["trial_c2"] = trial
    print(f"kernel mq_scan lanes-a-block trial on the config-2 group of "
          f"{chunk[0].shape[0]} frames, slots {tuple(slots.shape)} "
          f"(trial builds, in turns, bit-exact): "
          + ", ".join(f"{n} {t:.3f} ms" for n, t in trial.items()))
    del want
    words, mask, nbo, state = mq_scan.run_mq_scans(slots)
    _, nwords = check_dense_words(slots, words, mask, state,
                                  "config-2 group")
    del words, mask, nbo, state
    torch.cuda.empty_cache()
    mq_scan.scan_dense(slots)
    ms = cuda_ms(lambda: mq_scan.scan_dense(slots), 3)
    want = mq_scan.scan_dense(slots)
    dense = dense_lane_trial(dense_libs, slots, want)
    del want
    key = f"config 2, {w}x{h}, B={slots.shape[1]}"
    results[MQ_DENSE[0]]["trial"][key] = dense
    results[MQ_DENSE[0]]["c2_ms"] = ms
    print(f"mq_scan_dense through run_mq_scans on the config-2 group, slots "
          f"{tuple(slots.shape)}, {nwords} words: every lane's words and "
          f"partial word are its compact segment before the flush tail; "
          f"{ms:.3f} ms a call")
    print_trial(MQ_DENSE[0], f"the config-2 group, B={slots.shape[1]}",
                dense, legend="lanes a warp x warps a block")
    del slots
    torch.cuda.empty_cache()


def c2_encode_stages(enc, chunk, imgs, params, siz, cod, qcd, tr,
                     layer_alloc=None):
    """Time of one config-2 chunk by stage (host clock, synchronised; the
    host stages serial, one frame after another) and each frame's bytes
    by layer. `chunk` is the chunk's frames on the device, or per
    component their host stacks (then the upload is a stage of its own);
    with `layer_alloc` (a profile's allocator) every frame's PCRD runs it
    instead of the allocator of the parameters' targets, and the stages
    also count the rate control's simulator calls, total and
    per-component."""
    import torch

    from grokimagecompression_tpu_torch.codestream import pcrd, tile
    from grokimagecompression_tpu_torch.models import fused_encode, pipeline
    from grokimagecompression_tpu_torch.ops import mq_scan, mq_torch
    stages = {}
    tt = time.perf_counter
    torch.cuda.synchronize()
    if not isinstance(chunk[0], torch.Tensor):
        t = tt()
        chunk = fused_encode.upload_tile(chunk, enc)
        torch.cuda.synchronize()
        stages["upload"] = tt() - t
    t = tt()
    pipeline._fwd_transform(enc.plan.cfg, chunk)
    torch.cuda.synchronize()
    stages["transform (DWT kernel)"] = tt() - t
    t = tt()
    gin = list(enc.group_inputs(*chunk))
    torch.cuda.synchronize()
    stages["quantize + gather"] = tt() - t - stages["transform (DWT kernel)"]
    t = tt()
    built = [enc.group_slots(*g) for g in gin]
    torch.cuda.synchronize()
    stages["slot build + distortions"] = tt() - t
    t = tt()
    scans = [mq_scan.mq_scan(slots, mq_torch.pass_spans_padded(h, w))
             for (h, w, _), (_, slots, _) in zip(enc.plan.groups, built)]
    torch.cuda.synchronize()
    stages["mq_scan"] = tt() - t
    t = tt()
    outs = [torch.cat([b[0] for b in built]), torch.cat([s[1] for s in scans]),
            torch.cat([s[0] for s in scans])]
    for sc, b in zip(scans, built):
        outs += [sc[3], b[2].reshape(-1, sc[3].shape[1])]
    outs = [o.cpu().numpy() for o in outs]
    stages["fetch"] = tt() - t
    t = tt()
    segs = fused_encode.assemble_collected_mq(enc.plan, chunk[0].shape[0],
                                              *outs)
    stages["R-D tables (host)"] = tt() - t
    pcrd_s = [0.0]
    layers = []
    sims = {"simulate_upto": 0, "simulate_comp_upto": 0}

    def counted(fn, key):
        def run(max_layer):
            sims[key] += 1
            return fn(max_layer)
        return run

    def timed(alloc):
        def run(ctx):
            for key in sims:
                if getattr(ctx, key) is not None:
                    setattr(ctx, key, counted(getattr(ctx, key), key))
            t0 = tt()
            alloc(ctx)
            pcrd_s[0] += tt() - t0
            cum = [ctx.simulate_upto(l) for l in range(ctx.numlayers)]
            layers.append([b - a for a, b in zip([0] + cum, cum)])
        return run

    t = tt()
    for f in range(chunk[0].shape[0]):
        alloc = layer_alloc or pcrd.make_layer_alloc(imgs[f], params)
        tile.encode_tile(segs[f], siz, cod, qcd, tr, layer_alloc=timed(alloc),
                         pocs=params.pocs or None, tile_index=0)
    stages["host PCRD"] = pcrd_s[0]
    stages["host T2"] = tt() - t - pcrd_s[0]
    if layer_alloc is not None:
        stages["simulator calls"] = sims
    return stages, layers


def c2_decode_stages(streams, dev, coder="MQ", kernel="mq_dec_group"):
    """Time of one config-2 decode chunk (the 4 streams or JP2 files) by
    stage (host clock, synchronised); `coder` and `kernel` name the lane
    packing and the decode kernel stages. T2 is the native parser, or the
    Python one where the streams carry packed headers (PPM / PPT)."""
    import torch

    from grokimagecompression_tpu_torch.codestream import decoder, jp2
    from grokimagecompression_tpu_torch.models import fused_decode
    from grokimagecompression_tpu_torch.ops import dwt, mct_torch

    stages = {}
    tt = time.perf_counter
    t = tt()
    streams = [jp2.extract_codestream(d) if jp2.is_jp2(d) else d
               for d in streams]
    stages["unwrap (JP2)"] = tt() - t
    t = tt()
    hdr, trs, parsed = decoder.parse_batch(streams)
    stages["T2 (host)"] = tt() - t
    (plan,) = decoder.tile_groups(hdr, trs, parsed)
    dec = fused_decode.decoder_for(plan, dev)
    t = tt()
    arrays = fused_decode.prepare_chunk(dec.plan, [
        fused_decode.jobs_by_block(*p[0][0][:3]) for p in parsed])
    stages[f"{coder} lane packing (host)"] = tt() - t
    torch.cuda.synchronize()
    t = tt()
    groups = fused_decode.upload(arrays, dev)
    torch.cuda.synchronize()
    stages["upload"] = tt() - t
    t = tt()
    packed = dec.decode(groups)
    torch.cuda.synchronize()
    stages[kernel] = tt() - t
    t = tt()
    bands = dec.split_bands(dec.assemble(
        packed, [g[-1] for g in groups], len(streams)))
    torch.cuda.synchronize()
    stages["dequantization + band placement"] = tt() - t
    cfg = dec.plan.cfg
    t = tt()
    comps = [dwt.inv_dwt_2d(bands[c], cfg.tc_rects[c], cfg.numresolutions,
                            cfg.reversible) for c in range(len(bands))]
    torch.cuda.synchronize()
    stages["inverse 9/7 DWT kernel"] = tt() - t
    t = tt()
    comps[0], comps[1], comps[2] = mct_torch.ict_inv(*comps[:3])
    comps = [mct_torch.dc_shift_inv(torch.round(a).to(torch.int32),
                                    cfg.precs[c], cfg.signeds[c])
             for c, a in enumerate(comps)]
    torch.cuda.synchronize()
    stages["inverse ICT + rounding + DC unshift"] = tt() - t
    t = tt()
    [c.cpu() for c in comps]
    stages["fetch"] = tt() - t
    return stages


def c2_memory_stages(enc, chunk):
    """Peak device bytes of a config-2 encode chunk by stage, each above
    what was allocated when the stage began: transform + quantize +
    gather, the slot build with distortions, the MQ scan with byte-outs."""
    import torch

    from grokimagecompression_tpu_torch.ops import mq_scan, mq_torch

    def peak(fn):
        torch.cuda.synchronize()
        a0 = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        out = fn()
        torch.cuda.synchronize()
        return out, torch.cuda.max_memory_allocated() - a0

    gin, p_gather = peak(lambda: list(enc.group_inputs(*chunk)))
    built, p_build = peak(lambda: [enc.group_slots(*g) for g in gin])
    _, p_scan = peak(lambda: [
        mq_scan.mq_scan(b[1], mq_torch.pass_spans_padded(h, w))
        for (h, w, _), b in zip(enc.plan.groups, built)])
    return {"transform + quantize + gather": p_gather,
            "slot build + distortions": p_build, "mq_scan": p_scan}


def c2_ht_encode_stages(enc, chunk, imgs, params):
    """Time of one config-2 HT 9/7 encode chunk by stage (host clock,
    synchronised), as `FusedHTEncoder.forward`, `encode_tile_collect` and
    `encode_batch`'s host T2 on its 4-thread pool run it."""
    import concurrent.futures

    import torch

    from grokimagecompression_tpu_torch.codestream import encoder
    from grokimagecompression_tpu_torch.models import fused_encode
    from grokimagecompression_tpu_torch.ops import ht_enc
    stages = {}
    tt = time.perf_counter
    torch.cuda.synchronize()
    t = tt()
    enc.transform(*chunk)
    torch.cuda.synchronize()
    stages["transform (DWT kernel)"] = tt() - t
    t = tt()
    gin = list(enc.group_inputs(*chunk))
    torch.cuda.synchronize()
    stages["quantize + gather"] = tt() - t - stages["transform (DWT kernel)"]
    t = tt()
    outs = [ht_enc.encode_into(co, mbs, enc.tables()) for co, mbs in gin]
    torch.cuda.synchronize()
    stages["HT encode kernel"] = tt() - t
    t = tt()
    lens = torch.cat([o[2] for o in outs]).cpu().numpy()
    data = torch.cat([ht_enc.pack(*o) for o in outs]).cpu().numpy()
    stages["pack + fetch"] = tt() - t
    t = tt()
    segs = fused_encode.assemble_collected_ht(enc.plan, chunk[0].shape[0],
                                              lens, data)
    stages["host slice"] = tt() - t
    t = tt()
    with concurrent.futures.ThreadPoolExecutor(max_workers=4) as pool:
        list(pool.map(lambda f: encoder.write_codestream(
            imgs[f], params, {0: segs[f]}),
                      range(len(segs))))
    stages["host T2"] = tt() - t
    return stages


class Timed:
    """Inside a `with` block, wraps `module.name` to record each call's
    arguments, its host seconds (ending in a device synchronisation when
    `sync`), the milliseconds between CUDA events recorded before and
    after it (device work, and the device's wait for the host between),
    and the HT encoder's launches during it."""

    def __init__(self, module, name, sync=True):
        self.module, self.name, self.sync = module, name, sync
        self.calls = []

    def __enter__(self):
        import torch

        from grokimagecompression_tpu_torch.ops import ht_enc
        orig = self.orig = getattr(self.module, self.name)

        def timed(*args, **kwargs):
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            n0 = ht_enc.LAUNCHES["enc"]
            t0 = time.perf_counter()
            start.record()
            out = orig(*args, **kwargs)
            stop.record()
            if self.sync:
                torch.cuda.synchronize()
            t1 = time.perf_counter()
            self.calls.append(dict(
                args=args, s=t1 - t0, t0=t0, t1=t1,
                device_ms=start.elapsed_time(stop) if self.sync else None,
                launches=ht_enc.LAUNCHES["enc"] - n0))
            return out
        setattr(self.module, self.name, timed)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.orig)

    def total(self, key="s"):
        return sum(c[key] or 0.0 for c in self.calls)

    def span(self):
        """Seconds from the first call's start to the last call's end."""
        return (max(c["t1"] for c in self.calls)
                - min(c["t0"] for c in self.calls)) if self.calls else 0.0


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
        list(pool.map(lambda f: encoder.write_codestream(
            imgs[f], params, {0: segs[f]}),
                      range(chunk.shape[0])))
    stages["host T2"] = tt() - t
    return stages


def ht_model(plan, chunk, rate_control=False):
    """`fused_encode`'s HT memory model of a chunk: `ht_frame_bytes` a
    frame and the encoder's stepsizes once (as `chunk_cap` counts)."""
    from grokimagecompression_tpu_torch.models import fused_encode
    return (chunk * fused_encode.ht_frame_bytes(plan, rate_control)
            + fused_encode.HT_STEP_BYTES * plan.nblocks)


def c2_ht_phases(c2_imgs, frame_digests, c2_siz, c2_tr, c2_chunk, dev,
                 card):
    """Phases 12-14: BASELINE config 2 with the HT block coder on 9/7, at
    the default base step (a), its decode (b), and at ratio 24 (c).
    Returns the streams of (a)."""
    import torch

    from grokimagecompression_tpu_torch.codestream import decoder, encoder
    from grokimagecompression_tpu_torch.codestream.tile import default_qcd
    from grokimagecompression_tpu_torch.core.params import (EncoderParams,
                                                            Transform)
    from grokimagecompression_tpu_torch.models import fused_encode
    from grokimagecompression_tpu_torch.native import ht_prepass
    from grokimagecompression_tpu_torch.ops import (dwt, ht_dec, ht_enc,
                                                    ht_tables, ht_torch)
    root = os.path.dirname(os.path.abspath(__file__))
    c2_mpix = C2_FRAMES * C2_SIZE * C2_SIZE / 1e6
    # 12. (a) the config-2 HT 9/7 encode at the default base step
    with open(os.path.join(root, C2_HT_DIGESTS)) as f:
        ht_digests = json.load(f)
    if ht_digests["frames"] != frame_digests:
        raise AssertionError("the config-2 digest files hold other frames")
    ht_params = EncoderParams(numresolutions=6, transform=Transform.DWT_97,
                              cblk_style=0x40)
    ht_cod = encoder.build_cod(c2_imgs[0], ht_params)
    ht_plan = fused_encode.build_plan(
        c2_siz, ht_cod, default_qcd(c2_siz, ht_cod, 1, 0.0), c2_tr)
    ht_enc97 = fused_encode.FusedHTEncoder(ht_plan,
                                           ht_tables.device_tables(dev))
    plain = [Calls(ht_enc, "encode_segments_plain", lambda *a: True),
             Calls(ht_torch, "op_streams", lambda *a: True),
             Calls(ht_tables, "assemble_segments_host", lambda *a: True)]
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    free = encoder.free_device_bytes(dev)
    torch.cuda.reset_peak_memory_stats()
    ht_enc.LAUNCHES["enc"] = 0
    dwt.LAUNCHES["dwt"] = 0
    with contextlib.ExitStack() as counting:
        for c in plain:
            counting.enter_context(c)
        out = encoder.encode_batch(c2_imgs, ht_params, device="cuda")
        torch.cuda.synchronize()
    ht_peak = torch.cuda.max_memory_allocated() - base
    print(f"config-2 HT 9/7 encode launches: {dict(ht_enc.LAUNCHES)}, "
          f"{dict(dwt.LAUNCHES)}; plain encoder calls, op stream builds, "
          f"host splices: {[c.n for c in plain]}")
    if ht_enc.LAUNCHES["enc"] < 1 or dwt.LAUNCHES["dwt"] < 1:
        raise AssertionError("the HT encoder or the DWT kernel was not "
                             "launched by the config-2 HT encode")
    if any(c.n for c in plain):
        raise AssertionError("the CUDA HT 9/7 encode route ran the plain "
                             "encoder or its op streams")
    if [hashlib.sha256(cs).hexdigest() for cs in out] != \
            ht_digests["fixed"]["streams"]:
        raise AssertionError("config-2 HT 9/7 streams differ from the host "
                             "encoder's")
    ht_chunk = max(1, min(inspect.signature(encoder.encode_batch)
                          .parameters["chunk"].default,
                          fused_encode.chunk_cap(ht_plan, free), C2_FRAMES))
    print(f"config-2 HT 9/7 encode (default base step): {C2_FRAMES} streams "
          f"match the host encoder's digests ({[len(cs) for cs in out]} B)")
    best = best_of(3, lambda: encoder.encode_batch(c2_imgs, ht_params,
                                                   device="cuda"))
    print(f"encode_batch (config 2, HT 9/7): {c2_mpix / best:.2f} MP/s "
          f"(best of 3, {best:.3f} s for {C2_FRAMES} frames, chunk "
          f"{ht_chunk}) on {card}")
    print(f"config-2 HT 9/7 encode peak device memory at chunk {ht_chunk}: "
          f"{ht_peak / 1e9:.4f} GB measured above the {base / 1e9:.4f} GB "
          f"held before, "
          f"{ht_model(ht_plan, ht_chunk) / 1e9:.4f} GB predicted "
          f"(ht_frame_bytes x {ht_chunk} + the stepsizes; {ht_peak} B "
          f"against {ht_model(ht_plan, ht_chunk)} B) on {card}")
    chunk4 = c2_chunk(0, C2_FRAMES)
    c2_ht_encode_stages(ht_enc97, chunk4, c2_imgs, ht_params)
    stages = c2_ht_encode_stages(ht_enc97, chunk4, c2_imgs, ht_params)
    print(f"one {C2_FRAMES}-frame config-2 HT 9/7 encode chunk by stage "
          "(host clock, synchronised): "
          + ", ".join(f"{k} {v * 1e3:.1f} ms" for k, v in stages.items()))
    ((coeffs, mbs),) = list(ht_enc97.group_inputs(*chunk4))
    del chunk4, stages
    tables = ht_enc97.tables()
    got = ht_enc.encode_segments(coeffs, mbs, tables)
    for _ in range(3):
        ht_enc.encode_segments(coeffs, mbs, tables)
    ms = cuda_ms(lambda: ht_enc.encode_segments(coeffs, mbs, tables), 20)
    dev_ms = device_ms(lambda: ht_enc.encode_segments(coeffs, mbs, tables),
                       10, "ht_enc_kernel", lambda: ht_enc.LAUNCHES["enc"])
    b_ms, b_by, b_terms = bound(
        nbytes(coeffs, mbs, tables["enc_packed"], *got),
        OPS["enc_sample"] * coeffs.numel()
        + OPS["enc_sig"] * int((coeffs != 0).sum())
        + OPS["enc_byte"] * got[0].numel())
    print(f"kernel {ENC[0]} on the config-2 HT 9/7 group of {C2_FRAMES} "
          f"frames (B={coeffs.shape[0]}, Mb up to {int(mbs.max())}, "
          f"{got[0].numel()} segment bytes): {ms:.3f} ms a call, "
          f"{fmt_ms(dev_ms)} in the kernel's launches (profiler); bound "
          f"{b_ms:.4f} ms by {b_by} ({b_terms}) on {card}")
    del coeffs, mbs, got

    # 13. (b) their decode
    torch.cuda.empty_cache()
    ht_dec.LAUNCHES["dec"] = 0
    dwt.LAUNCHES["dwt"] = 0
    ht_prepass.CALLS["prepass"] = 0
    dec = decoder.decode_batch(out, device="cuda")
    torch.cuda.synchronize()
    print(f"config-2 HT 9/7 decode launches: {dict(ht_dec.LAUNCHES)}, "
          f"{dict(dwt.LAUNCHES)}; host prepass calls: "
          f"{ht_prepass.CALLS['prepass']}")
    if ht_dec.LAUNCHES["dec"] < 1 or dwt.LAUNCHES["dwt"] < 1 or \
            ht_prepass.CALLS["prepass"]:
        raise AssertionError("the HT decoder or the DWT kernel was not "
                             "launched by the config-2 HT decode, or it "
                             "called the host prepass")
    if [frame_digest(d) for d in dec] != ht_digests["fixed"]["decoded"]:
        raise AssertionError("config-2 HT 9/7 decode: pixels differ from "
                             "the host decoder's")
    print(f"config-2 HT 9/7 decode: {C2_FRAMES} frames equal the host "
          f"decoder's pixels (digests); MSE against the sources "
          + ", ".join(f"{frame_mse(d, im):.4f}"
                      for d, im in zip(dec, c2_imgs)))
    del dec
    best = best_of(3, lambda: decoder.decode_batch(out, device="cuda"))
    print(f"decode_batch (config 2, HT 9/7): {c2_mpix / best:.2f} MP/s "
          f"(best of 3, {best:.3f} s for {C2_FRAMES} frames) on {card}")
    c2_decode_stages(out, dev, "HT", "ht_dec_group")
    stages = c2_decode_stages(out, dev, "HT", "ht_dec_group")
    print(f"one {C2_FRAMES}-frame config-2 HT 9/7 decode chunk by stage "
          "(host clock, synchronised): "
          + ", ".join(f"{k} {v * 1e3:.1f} ms" for k, v in stages.items()))
    fixed = out
    del out, stages

    # 14. (c) the config-2 HT 9/7 encode at ratio 24 (1 bpp): the search
    # of each frame's base step on the chunk's resident blocks
    rc_params = dataclasses.replace(ht_params, rates=(24.0,))
    rc = ht_digests["ratio24"]
    torch.cuda.empty_cache()
    ht_enc.LAUNCHES["enc"] = 0
    dwt.LAUNCHES["dwt"] = 0
    timers = {"transform + gather": Timed(encoder, "_HTRateSearch"),
              "step plans": Timed(encoder._HTRateSearch, "lanes",
                                  sync=False),
              "probes": Timed(encoder, "_ht_rc_segment_bytes"),
              "confirm encodes": Timed(encoder, "_ht_rc_segments"),
              "host T2": Timed(encoder, "encode", sync=False)}
    with contextlib.ExitStack() as counting:
        for c in plain + list(timers.values()):
            counting.enter_context(c)
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        out = encoder.encode_batch(c2_imgs, rc_params, device="cuda")
        torch.cuda.synchronize()
        rc_s = time.perf_counter() - t0
        rc_peak = torch.cuda.max_memory_allocated() - base
    print(f"config-2 HT 9/7 ratio-24 encode launches: "
          f"{dict(ht_enc.LAUNCHES)}, {dict(dwt.LAUNCHES)}; plain encoder "
          f"calls, op stream builds, host splices: {[c.n for c in plain]}")
    probes = timers["probes"].calls
    if ht_enc.LAUNCHES["enc"] < 1 or dwt.LAUNCHES["dwt"] < 1 or \
            any(c["launches"] < 1 for c in probes):
        raise AssertionError("the HT encoder or the DWT kernel was not "
                             "launched by the rate-controlled encode, or a "
                             "probe launched no kernel")
    if any(c.n for c in plain):
        raise AssertionError("the CUDA HT rate control ran the plain "
                             "encoder or its op streams")
    if [hashlib.sha256(cs).hexdigest() for cs in out] != rc["streams"]:
        raise AssertionError("config-2 HT 9/7 ratio-24 streams differ from "
                             "the host encoder's")
    if any(len(cs) > t for cs, t in zip(out, rc["targets"])):
        raise AssertionError("a ratio-24 stream is above its target")
    for f in range(C2_FRAMES):
        mine = [c for c in probes if f in c["args"][1]]
        confirms = sum(f in c["args"][1]
                       for c in timers["confirm encodes"].calls)
        print(f"config-2 HT 9/7 ratio 24, frame {f}: {len(out[f])} B (target "
              f"{rc['targets'][f]}), {len(mine)} search calls ("
              f"{sum(c['launches'] for c in mine)} probe launches, shared "
              f"with the frames searching beside it), {confirms} confirm "
              f"encodes; equal to the host encoder's stream")
    split = {k: tm.total() for k, tm in timers.items()}
    print(f"config-2 HT 9/7 ratio-24 encode of {C2_FRAMES} frames in one "
          f"chunk: {rc_s:.3f} s; transform + gather "
          f"{split['transform + gather'] * 1e3:.1f} ms, {len(probes)} probe "
          f"rounds {split['probes'] * 1e3:.1f} ms (between CUDA events "
          f"{timers['probes'].total('device_ms'):.1f} ms, one "
          f"synchronisation each; of it the host's plans of "
          f"{len(timers['step plans'].calls)} lane lookups, new steps "
          f"planned once, {split['step plans'] * 1e3:.1f} ms), "
          f"{len(timers['confirm encodes'].calls)} confirm rounds "
          f"{split['confirm encodes'] * 1e3:.1f} ms (device encode and "
          f"fetch), host T2 {timers['host T2'].span() * 1e3:.1f} ms from "
          f"the first stream's start to the last's end "
          f"({split['host T2'] * 1e3:.1f} ms summed over "
          f"{len(timers['host T2'].calls)} streams on the 4-thread pool)")
    print(f"config-2 HT 9/7 ratio-24 encode peak device memory at chunk "
          f"{ht_chunk}: {rc_peak / 1e9:.4f} GB measured above the "
          f"{base / 1e9:.4f} GB held before, "
          f"{ht_model(ht_plan, ht_chunk, True) / 1e9:.4f} GB predicted "
          f"(ht_frame_bytes(rate_control=True) x {ht_chunk} + the "
          f"stepsizes; {rc_peak} B against "
          f"{ht_model(ht_plan, ht_chunk, True)} B) on {card}")
    best = best_of(3, lambda: encoder.encode_batch(c2_imgs, rc_params,
                                                   device="cuda"))
    print(f"encode_batch (config 2, HT 9/7, ratio 24): {c2_mpix / best:.2f} "
          f"MP/s (best of 3, {best:.3f} s for {C2_FRAMES} frames) on {card}")
    del out
    # a probe round alone, its steps planned before: what the search costs
    # without the host's plans
    search = encoder._HTRateSearch(c2_imgs, c2_siz, ht_cod, None,
                                   [ht_enc97])
    frames = list(range(C2_FRAMES))
    steps = [2.0 + f for f in frames]
    for _ in range(2):
        encoder._ht_rc_segment_bytes(search, frames, steps)
    t0 = time.perf_counter()
    for _ in range(10):
        encoder._ht_rc_segment_bytes(search, frames, steps)
    host_ms = (time.perf_counter() - t0) * 100
    lanes = [search.lanes(s)[0] for s in steps]
    dev_ms = cuda_ms(lambda: ht_enc97.segment_totals(search.blocks[0], frames,
                                                     lanes), 10)
    print(f"a probe round of the {C2_FRAMES} frames, steps planned: "
          f"{host_ms:.3f} ms (host clock, one synchronisation), "
          f"{dev_ms:.3f} ms between CUDA events over 10 without "
          f"synchronising (quantization, one HT-encoder launch, the sums) "
          f"on {card}")
    del search
    torch.cuda.empty_cache()
    return fixed



@contextlib.contextmanager
def decode_counts(extra=()):
    """Every decode kernel's launch count and the host prepass's calls set
    to 0, the plain block decoders (the CPU routes of
    `ht_dec.decode_segments` and `mq_dec.decode_group`) and the `Calls` of
    `extra` counted, inside a `with` block; yields the plain decoders'
    counters."""
    from grokimagecompression_tpu_torch.native import ht_prepass
    from grokimagecompression_tpu_torch.ops import dwt, ht_dec, mq_dec
    ht_dec.LAUNCHES["dec"] = 0
    mq_dec.LAUNCHES["mq_dec"] = 0
    dwt.LAUNCHES["dwt"] = 0
    ht_prepass.CALLS["prepass"] = 0
    plain = [Calls(ht_dec, "decode_group_plain", lambda *a: True),
             Calls(mq_dec, "decode_group_plain", lambda *a: True)]
    with contextlib.ExitStack() as counting:
        for c in plain + list(extra):
            counting.enter_context(c)
        yield plain


def check_decode_counts(plain, what, want):
    """Fail unless every kernel in `want` ("dec", "mq_dec", "dwt") was
    launched, the host prepass was not called and the plain decoders
    were not called; prints the counts."""
    from grokimagecompression_tpu_torch.native import ht_prepass
    from grokimagecompression_tpu_torch.ops import dwt, ht_dec, mq_dec
    counts = {"dec": ht_dec.LAUNCHES["dec"],
              "mq_dec": mq_dec.LAUNCHES["mq_dec"],
              "dwt": dwt.LAUNCHES["dwt"]}
    print(f"{what} launches: {counts}; host prepass calls: "
          f"{ht_prepass.CALLS['prepass']}; plain HT / MQ decoder calls: "
          f"{[c.n for c in plain]}")
    if any(counts[k] < 1 for k in want):
        raise AssertionError(f"{what}: a kernel of {want} was not launched")
    if ht_prepass.CALLS["prepass"] or any(c.n for c in plain):
        raise AssertionError(f"{what}: the CUDA route called the host "
                             f"prepass or a plain decoder")


def gate_c2_phase(c2_imgs, fixed, dev, card):
    """Phase 15: the 4 config-2 frames with the HT block coder on 9/7 at
    the default base step, coded with 32x32 blocks in the chroma
    components (COC), a two-entry POC (RLCP over resolutions 0-2, then
    CPRL), packed headers in the main header (PPM) and wrapped as JP2,
    through decode_batch on the card: the pixels of the plain streams
    (`fixed`, phase 12), whose host-decoder digests config2_ht_97.json
    holds. At a fixed step one HT cleanup pass codes every quantized
    coefficient whatever the block size, packet order, packed headers or
    container, so the decoded pixels are the same."""
    import torch

    from grokimagecompression_tpu_torch.codestream import (decoder, encoder,
                                                           jp2)
    from grokimagecompression_tpu_torch.codestream.markers import PocEntry
    from grokimagecompression_tpu_torch.core.params import (EncoderParams,
                                                            Progression,
                                                            Transform)
    from grokimagecompression_tpu_torch.ops import ht_dec
    root = os.path.dirname(os.path.abspath(__file__))
    with open(os.path.join(root, C2_HT_DIGESTS)) as f:
        want = json.load(f)["fixed"]["decoded"]
    c2_mpix = C2_FRAMES * C2_SIZE * C2_SIZE / 1e6
    params = EncoderParams(
        numresolutions=6, transform=Transform.DWT_97, cblk_style=0x40,
        comp_cblk_exps={1: (5, 5), 2: (5, 5)},
        pocs=(PocEntry(rs=0, cs=0, lye=1, re=3, ce=3, prog=Progression.RLCP),
              PocEntry(rs=3, cs=0, lye=1, re=6, ce=3,
                       prog=Progression.CPRL)),
        ppm_markers=True)
    t0 = time.perf_counter()
    streams = encoder.encode_batch(c2_imgs, params, device="cuda")
    enc_s = time.perf_counter() - t0
    hdr = decoder.read_header(streams[0])
    if not (hdr.cod_comp and hdr.pocs and hdr.ppm_sections is not None):
        raise AssertionError("the phase-15 streams lack their COC, POC or "
                             "PPM markers")
    files = [jp2.wrap_codestream(cs, C2_SIZE, C2_SIZE, [(8, False)] * 3)
             for cs in streams]
    shapes = ((64, 64), (32, 32))
    per_shape = [Calls(ht_dec, "decode_segments",
                       lambda *a, s=s: (a[4], a[5]) == s) for s in shapes]
    torch.cuda.empty_cache()
    with decode_counts(per_shape) as plain:
        dec = decoder.decode_batch(files, device="cuda")
        torch.cuda.synchronize()
    check_decode_counts(plain, "config-2 HT 9/7 COC + POC + PPM JP2 decode",
                        ("dec", "dwt"))
    print(f"HT decoder calls by block shape {shapes}: "
          f"{[c.n for c in per_shape]}")
    if any(c.n < 1 for c in per_shape):
        raise AssertionError("ht_dec_group was not launched on both block "
                             "shapes of the COC streams")
    if [frame_digest(d) for d in dec] != want:
        raise AssertionError("config-2 HT 9/7 COC + POC + PPM JP2 decode: "
                             "pixels differ from the host decoder's")
    hdr0, trs, parsed = decoder.parse_batch(files[:1])
    (plan,) = decoder.tile_groups(hdr0, trs, parsed)
    lanes = C2_FRAMES * sum(len(b) for _, _, b in plan.groups)
    print(f"config-2 HT 9/7 with COC (32x32 chroma blocks), POC (RLCP r0-2, "
          f"CPRL r3-5), PPM, as JP2: {C2_FRAMES} files "
          f"({[len(f) for f in files]} B; encode_batch {enc_s:.3f} s) decode "
          f"to the host decoder's pixels of the plain streams (digests), "
          f"{lanes} HT lanes in groups "
          f"{[(w, h, C2_FRAMES * len(b)) for w, h, b in plan.groups]}")
    del dec
    for name, batch in (("plain markers (phase 13)", fixed),
                        ("COC + POC + PPM, JP2", files)):
        best = best_of(3, lambda: decoder.decode_batch(batch, device="cuda"))
        print(f"decode_batch (config 2, HT 9/7, {name}): "
              f"{c2_mpix / best:.2f} MP/s (best of 3, {best:.3f} s for "
              f"{C2_FRAMES} frames) on {card}")
    for name, batch in (("plain markers (phase 13)", fixed),
                        ("COC + POC + PPM, JP2", files)):
        c2_decode_stages(batch, dev, "HT", "ht_dec_group")
        stages = c2_decode_stages(batch, dev, "HT", "ht_dec_group")
        print(f"one {C2_FRAMES}-frame config-2 HT 9/7 decode chunk, {name}, "
              "by stage (host clock, synchronised): "
              + ", ".join(f"{k} {v * 1e3:.1f} ms" for k, v in stages.items()))
    torch.cuda.empty_cache()
    return files


def gate_c1_phase(imgs, dev, card):
    """Phase 16: the 64 config-1 frames, lossless, through decode_batch on
    the card: HT with a POC and PPT markers, wrapped as JP2, and MQ
    (style 0) with 32x32 blocks by COC and PPM markers; each frame equal
    to its source."""
    import numpy as np
    import torch

    from grokimagecompression_tpu_torch.codestream import (decoder, encoder,
                                                           jp2)
    from grokimagecompression_tpu_torch.codestream.markers import PocEntry
    from grokimagecompression_tpu_torch.core.params import (EncoderParams,
                                                            Progression)
    mpix = FRAMES * SIZE * SIZE / 1e6
    runs = [
        ("HT, POC + PPT, JP2", EncoderParams(
            numresolutions=6, cblk_style=0x40, ppt_markers=True,
            pocs=(PocEntry(rs=0, cs=0, lye=1, re=3, ce=1,
                           prog=Progression.RLCP),
                  PocEntry(rs=3, cs=0, lye=1, re=6, ce=1,
                           prog=Progression.CPRL))), True, ("dec", "dwt")),
        ("MQ, COC (32x32) + PPM", EncoderParams(
            numresolutions=6, cblk_style=0, comp_cblk_exps={0: (5, 5)},
            ppm_markers=True), False, ("mq_dec", "dwt")),
    ]
    for name, params, wrap, kernels in runs:
        streams = encoder.encode_batch(imgs, params, device="cuda",
                                       chunk=CHUNK)
        if wrap:
            streams = [jp2.wrap_codestream(cs, SIZE, SIZE, [(8, False)])
                       for cs in streams]
        torch.cuda.empty_cache()
        with decode_counts() as plain:
            dec = decoder.decode_batch(streams, device="cuda", chunk=CHUNK)
            torch.cuda.synchronize()
        check_decode_counts(plain, f"config-1 decode ({name})", kernels)
        for i, (d, im) in enumerate(zip(dec, imgs)):
            if not np.array_equal(d.components[0].data,
                                  im.components[0].data):
                raise AssertionError(f"config-1 {name}, frame {i}: the "
                                     f"decode is not lossless")
        best = best_of(3, lambda: decoder.decode_batch(
            streams, device="cuda", chunk=CHUNK))
        print(f"config-1 {name}: {FRAMES} frames "
              f"({sum(len(cs) for cs in streams)} B) decode to their sources "
              f"exactly; decode_batch {mpix / best:.2f} MP/s (best of 3, "
              f"{best:.3f} s) on {card}")
        del dec, streams


def corpus_phase(c2_img, dev, card):
    """Phase 17: every tests/corpus stream that decode_batch takes, on the
    card alone and as a batch of two copies, against the host decoder's
    planes in CORPUS_DIGESTS; each stream it refuses raises
    NotImplementedError; and a 9/7 HT stream with a QCC spliced in
    (component 1's mantissas changed) decodes on the card as on the
    CPU."""
    import numpy as np
    import torch

    from grokimagecompression_tpu_torch.codestream import (decoder, encoder,
                                                           markers)
    from grokimagecompression_tpu_torch.core.image import Component, Image
    from grokimagecompression_tpu_torch.core.params import (EncoderParams,
                                                            Transform)
    root = os.path.dirname(os.path.abspath(__file__))
    with open(os.path.join(root, CORPUS_DIGESTS)) as f:
        want = json.load(f)
    folder = os.path.join(root, CORPUS)
    names = sorted(n for n in os.listdir(folder)
                   if n.endswith((".j2k", ".jp2")))
    if sorted(list(want["decoded"]) + want["refused"]) != names:
        raise AssertionError("the corpus differs from the digest file's")

    def read(name):
        with open(os.path.join(folder, name), "rb") as f:
            return f.read()

    t0 = time.perf_counter()
    with decode_counts() as plain:
        for name, digest in want["decoded"].items():
            data = read(name)
            (one,) = decoder.decode_batch([data], device="cuda")
            two = decoder.decode_batch([data, data], device="cuda")
            got = [plane_md5(im) for im in [one] + two]
            if got != [digest] * 3:
                raise AssertionError(f"corpus {name}: planes differ from the "
                                     f"host decoder's ({got})")
        torch.cuda.synchronize()
    check_decode_counts(plain, "corpus decode", ("dec", "mq_dec", "dwt"))
    decode_s = time.perf_counter() - t0
    for name in want["refused"]:
        try:
            decoder.decode_batch([read(name)], device="cuda")
        except NotImplementedError:
            continue
        raise AssertionError(f"corpus {name}: decode_batch took a stream "
                             f"outside its gate")
    print(f"corpus: {len(want['decoded'])} of {len(names)} streams decode on "
          f"the card to the host decoder's planes, alone and as a batch of "
          f"two ({decode_s:.1f} s); {len(want['refused'])} raise "
          f"NotImplementedError ({', '.join(want['refused'])})")
    # a QCC of other mantissas for component 1 on a 9/7 stream
    comps = [Component(data=np.ascontiguousarray(c.data[:128, :192]),
                       prec=8, signed=False, dx=1, dy=1)
             for c in c2_img.components]
    img = Image(xsiz=comps[0].data.shape[1], ysiz=comps[0].data.shape[0],
                components=comps)
    (cs,) = encoder.encode_batch([img], EncoderParams(
        numresolutions=4, transform=Transform.DWT_97, cblk_style=0x40,
        cblk_w_exp=5, cblk_h_exp=5), device="cuda")
    hdr = decoder.read_header(cs)
    qcc = markers.write_qcc(1, dataclasses.replace(hdr.qcd, steps=tuple(
        (e, (m + 517) % 2048) for e, m in hdr.qcd.steps)), 3)
    cs = cs[:hdr.main_header_end] + qcc + cs[hdr.main_header_end:]
    with decode_counts() as plain:
        (gpu,) = decoder.decode_batch([cs], device="cuda")
        torch.cuda.synchronize()
    check_decode_counts(plain, "9/7 QCC decode", ("dec", "dwt"))
    (cpu,) = decoder.decode_batch([cs], device="cpu")
    if frame_digest(gpu) != frame_digest(cpu):
        raise AssertionError("the 9/7 QCC stream decodes otherwise on the "
                             "card than on the CPU")
    print(f"9/7 HT stream with a QCC for component 1 ({img.xsiz}x{img.ysiz} "
          f"RGB, {len(cs)} B): the card's decode equals the CPU's")


def cinema_streams_check(name, streams, want, prof):
    """Phase 18: a profile case's streams against CIN_DIGESTS (SHA-256,
    length, per-component packet bytes by the port's packet index), each
    within the profile's frame cap and every component's packet bytes
    within its component cap, with the profile's rsiz, and a TLM marker
    where the profile asks for one."""
    from grokimagecompression_tpu_torch.codestream import decoder, tile
    if [hashlib.sha256(cs).hexdigest() for cs in streams] != \
            want["streams"]:
        raise AssertionError(f"{name}: streams differ from the host "
                             f"encoder's ({[len(cs) for cs in streams]} B)")
    comp_bytes = []
    for cs in streams:
        hdr = decoder.read_header(cs)
        bodies = {}
        for tp in decoder.iter_tile_parts(cs, hdr.main_header_end):
            bodies[tp.tile_index] = bodies.get(tp.tile_index, b"") + tp.body
        comp = [0] * len(hdr.siz.comps)
        for t, body in bodies.items():
            for (*_, c, _p, _o, ln) in tile.index_tile_packets(body, hdr, t):
                comp[c] += ln
        comp_bytes.append(comp)
        if prof.max_cs_bytes and len(cs) > prof.max_cs_bytes:
            raise AssertionError(f"{name}: {len(cs)} B above the frame cap "
                                 f"{prof.max_cs_bytes}")
        if prof.max_comp_bytes and max(comp) > prof.max_comp_bytes:
            raise AssertionError(f"{name}: component packet bytes {comp} "
                                 f"above the cap {prof.max_comp_bytes}")
        if hdr.siz.rsiz != prof.rsiz or hdr.siz.rsiz != want["rsiz"]:
            raise AssertionError(f"{name}: rsiz {hdr.siz.rsiz:#06x}, the "
                                 f"profile's {prof.rsiz:#06x}")
        if prof.params.tlm_markers and hdr.tlm is None:
            raise AssertionError(f"{name}: no TLM marker")
    if comp_bytes != want["comp_bytes"]:
        raise AssertionError(f"{name}: per-component packet bytes "
                             f"{comp_bytes} differ from the host's")
    caps = (f"frame cap {prof.max_cs_bytes} B, component cap "
            f"{prof.max_comp_bytes} B" if prof.max_cs_bytes else "no cap")
    print(f"{name}: {len(streams)} streams equal the host encoder's "
          f"(digests), {[len(cs) for cs in streams]} B, component packet "
          f"bytes {comp_bytes} ({caps}), rsiz {prof.rsiz:#06x}"
          + (", TLM" if prof.params.tlm_markers else ""))


def cinema_plan(img, prof):
    """The MQ plan encode_batch builds for a profile's frames (R-D tables
    on: the profile's allocator needs them)."""
    from grokimagecompression_tpu_torch.codestream import encoder
    from grokimagecompression_tpu_torch.codestream.tile import default_qcd
    from grokimagecompression_tpu_torch.core.geometry import tile_rect
    from grokimagecompression_tpu_torch.models import fused_encode
    p = prof.params
    siz = encoder.build_siz(img, p)
    cod = encoder.build_cod(img, p)
    qcd = default_qcd(siz, cod, encoder._guard_bits(p), p.base_step)
    tr = tile_rect(0, siz.xsiz, siz.ysiz, siz.xosiz, siz.yosiz, siz.xtsiz,
                   siz.ytsiz, siz.xtosiz, siz.ytosiz)
    plan = fused_encode.build_plan(siz, cod, qcd, tr, coder="mq",
                                   want_rd=True)
    return plan, siz, cod, qcd, tr


def cinema_mq_scan_check(enc, chunk):
    """Phase 18, the MQ coder at the cinema shapes: on each shape group of
    one chunk, 64 lanes spread over it, cut to the leading planes in which
    no lane codes more than CIN_PLAIN_MQ_DECISIONS decisions, against the
    plain version (segments, lengths, state, pass-end byte-outs); then the
    whole 32x32 group's scan timed (call ms, 20 after 3 warm-up) beside
    its bound. Returns (largest difference, ms, plain ms, bound ms, bound
    by)."""
    import torch

    from grokimagecompression_tpu_torch.ops import mq_scan, mq_torch
    res = None
    for (h, w, _), gin in zip(enc.plan.groups, enc.group_inputs(*chunk)):
        _, slots, _ = enc.group_slots(*gin)
        spans = mq_torch.pass_spans_padded(h, w)
        tp = sum(spans)
        npl = slots.shape[0] // tp
        B = slots.shape[1]
        lanes = torch.linspace(0, B - 1, min(64, B),
                               device=slots.device).round().long()
        sub = slots[:, lanes]
        coded = (sub.view(npl, tp, -1) & 1).sum(dim=1).cumsum(0).amax(dim=1)
        keep = max(1, int((coded <= CIN_PLAIN_MQ_DECISIONS).sum()))
        sub = sub[:keep * tp].contiguous()
        got = mq_scan.mq_scan(sub, spans)
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        want = mq_torch.mq_scan_plain(sub, spans)
        stop.record()
        torch.cuda.synchronize()
        plain_ms = start.elapsed_time(stop)
        for part, wv, g in zip(("segments", "lengths", "state",
                                "byte-outs"), want, got):
            if not torch.equal(wv, g):
                raise AssertionError(f"mq_scan {part} differ from the plain "
                                     f"version (cinema {h}x{w} lanes, "
                                     f"{keep} planes)")
        err = max(int((wv.to(torch.int64) - g.to(torch.int64)).abs().max())
                  if wv.numel() else 0 for wv, g in zip(want, got))
        line = (f"kernel mq_scan at the cinema shapes: {h}x{w} group, "
                f"{lanes.numel()} of {B} lanes, {keep} of {npl} planes "
                f"(T={sub.shape[0]}), {int(coded[keep - 1])} decisions in the "
                f"deepest lane: bit-exact with plain, pass-end byte-outs "
                f"included (plain {plain_ms:.1f} ms)")
        if (h, w) == (32, 32):
            full = mq_scan.mq_scan(slots, spans)
            for _ in range(3):
                mq_scan.mq_scan(slots, spans)
            ms = cuda_ms(lambda: mq_scan.mq_scan(slots, spans), 20)
            emits = int((slots & 1).sum())
            b_ms, b_by, b_terms = bound(
                nbytes(slots, *full),
                OPS["mq_decision"] * emits + OPS["mq_byte"] * full[0].numel())
            res = (err, ms, plain_ms, b_ms, b_by)
            line += (f"; the whole group, slots ({slots.shape[0]}, {B}), "
                     f"{emits} coding: {ms:.3f} ms a call (bound {b_ms:.4f} "
                     f"ms by {b_by}: {b_terms})")
            del full
        print(line)
        del slots, sub, got, want
    torch.cuda.empty_cache()
    return res


def cinema_mq_dec_check(streams, dev):
    """Phase 18, the MQ decoder at the cinema shapes: every lane group of
    the first stream's decode, every lane cut to its first 3 passes,
    against the plain version on `plain_lanes` of the group (its deepest
    lanes by passes and bytes, and lanes spread over the rest); then the
    whole 32x32 group of the streams'
    decode chunk at full depth timed (call ms, 20 after 3 warm-up) beside
    its bound. Returns (largest difference, ms, plain ms, bound ms, bound
    by)."""
    import torch

    from grokimagecompression_tpu_torch.codestream import decoder
    from grokimagecompression_tpu_torch.models import fused_decode
    from grokimagecompression_tpu_torch.ops import mq_dec, mq_dec_torch

    def lane_groups(batch):
        hdr, trs, parsed = decoder.parse_batch(batch)
        (plan,) = decoder.tile_groups(hdr, trs, parsed)
        return plan, fused_decode.upload(fused_decode.prepare_chunk(
            plan, [fused_decode.jobs_by_block(*p[0][0][:3])
                   for p in parsed]), dev)

    plan, arrays = lane_groups(streams[:1])
    err, plain_total = 0, 0.0
    for (w, h, _), group in zip(plan.groups, arrays):
        data, off, nbps, npas_full, ori = group[:5]
        npas = torch.clamp(npas_full, max=3)
        args = (data, off, nbps, npas, ori, w, h)
        got = mq_dec.decode_group(*args, with_stats=True)
        seg_bytes = (off[1:] - off[:-1]).to(torch.int64)
        idx = plain_lanes(npas.to(torch.int64) * (1 << 32) + seg_bytes)
        sub = lane_subset(data, off, idx) + (nbps[idx], npas[idx], ori[idx],
                                             w, h)
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        want = mq_dec_torch.decode_group_plain(*sub, with_stats=True)
        stop.record()
        torch.cuda.synchronize()
        plain_ms = start.elapsed_time(stop)
        for part, wv, g in zip(("samples", "statistics"), want, got):
            if not torch.equal(wv, g[:, idx]):
                raise AssertionError(f"mq_dec_group {part} differ from the "
                                     f"plain version (cinema {w}x{h} "
                                     f"blocks)")
        err = max([err] + [int((wv.to(torch.int64)
                                - g[:, idx].to(torch.int64)).abs().max())
                           for wv, g in zip(want, got)])
        if (w, h) == (32, 32):
            plain_total = plain_ms
        print(f"kernel mq_dec_group at the cinema shapes: {w}x{h} blocks of "
              f"frame 0, B={nbps.shape[0]}, {data.numel()} segment bytes, "
              f"every lane cut to its first 3 passes (of up to "
              f"{int(npas_full.max())}): bit-exact with plain on "
              f"{idx.shape[0]} lanes (`plain_lanes`) (plain "
              f"{plain_ms:.1f} ms)")
    plan, arrays = lane_groups(streams)
    ((w, h, _), group), = [(g, a) for g, a in zip(plan.groups, arrays)
                           if g[:2] == (32, 32)]
    full = tuple(group[:5]) + (w, h)
    data, off, nbps, npas_full, ori = group[:5]
    for _ in range(3):
        mq_dec.decode_group(*full)
    ms = cuda_ms(lambda: mq_dec.decode_group(*full), 20)
    packed, stats = mq_dec.decode_group(*full, with_stats=True)
    nb = nbps.to(torch.int64)
    passes = torch.minimum(npas_full.to(torch.int64),
                           (3 * nb - 2).clamp(min=0))
    visits = w * h * int(passes.sum())
    ndec, nbyte = (int(v) for v in stats.to(torch.int64).sum(1))
    b_ms, b_by, b_terms = bound(
        nbytes(data, off, nbps, npas_full, ori, packed, stats),
        OPS["mqd_decision"] * ndec + OPS["mqd_byte"] * nbyte
        + OPS["mqd_visit"] * visits)
    print(f"kernel mq_dec_group on the {len(streams)}-stream decode chunk's "
          f"32x32 group at full depth (B={nbps.shape[0]}, {data.numel()} "
          f"segment bytes, up to {int(npas_full.max())} passes): {ms:.3f} ms "
          f"a call, {ndec} decisions, {nbyte} BYTEINs, {visits} sample "
          f"visits (bound {b_ms:.4f} ms by {b_by}: {b_terms})")
    del arrays, packed, stats
    torch.cuda.empty_cache()
    return err, ms, plain_total, b_ms, b_by


def cinema_phase(dev, card, results):
    """Phase 18: the profile encodes (CIN_CASES) at full size through the
    profile entry points, and the decode of the cinema streams: cinema 2K
    at 24 and 48 fps (4 frames through encode_batch with the profile's
    rsiz and allocator; frame 0 also through encode_with_profile), 4K at
    24 fps (2 frames), broadcast and IMF 2K / 2K_R (one frame each through
    encode_with_profile), every stream against CIN_DIGESTS and its
    profile's caps; the MQ coder and the DWT launched by the encodes, the
    MQ decoder and the DWT by the decodes, no plain version called; the
    decoded pixels against the host decoder's digests. Prints MP/s (best
    of 3) beside the real-time rate, the stages of one 2K chunk, the peak
    device memory beside `mq_frame_bytes`, and the kernels held against
    their plain versions at the cinema shapes with their call ms and
    bounds (into `results`, keys "cinema mq_scan", "cinema
    mq_dec_group", and results["dwt"]["cinema"]). Returns each kernel's
    launches in the phase's runs by LAUNCHES key."""
    import numpy as np
    import torch

    from grokimagecompression_tpu_torch.codestream import (decoder, encoder,
                                                           profiles)
    from grokimagecompression_tpu_torch.core.geometry import Rect
    from grokimagecompression_tpu_torch.core.params import EncoderParams
    from grokimagecompression_tpu_torch.models import fused_encode
    from grokimagecompression_tpu_torch.ops import (dwt, dwt_torch, mq_dec,
                                                    mq_scan, mq_torch)
    root = os.path.dirname(os.path.abspath(__file__))
    with open(os.path.join(root, CIN_DIGESTS)) as f:
        want = json.load(f)
    sets = cinema_sets()
    for k, digests in want["frames"].items():
        if [frame_digest(im) for im in sets[k]] != digests:
            raise AssertionError(f"cinema frames {k} differ from the digest "
                                 f"file: numpy makes other frames here")
    launches = {"mq": 0, "dwt": 0, "mq_dec": 0}
    streams = {}
    for case in CIN_CASES:
        name, fset = case[:2]
        imgs = sets[fset]
        prof = cinema_profile(profiles, EncoderParams, case, imgs[0])
        alloc = profiles.profile_allocator(prof)
        cinema = case[2] == "apply_cinema"

        def run(imgs=imgs, prof=prof, alloc=alloc, cinema=cinema):
            if not cinema:
                return [profiles.encode_with_profile(imgs[0], prof)]
            return encoder.encode_batch(imgs, prof.params, device="cuda",
                                        rsiz=prof.rsiz, layer_alloc=alloc)

        torch.cuda.empty_cache()
        if cinema:
            plan, siz, cod, qcd, tr = cinema_plan(imgs[0], prof)
            per_frame = fused_encode.mq_frame_bytes(plan)
            chunk = max(1, min(32, fused_encode.chunk_cap(
                plan, encoder.free_device_bytes(dev)), len(imgs)))
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        mq_scan.LAUNCHES["mq"] = 0
        dwt.LAUNCHES["dwt"] = 0
        plain = [Calls(mq_torch, "mq_scan_plain", lambda *a: True),
                 Calls(dwt_torch, "fwd_dwt_2d", lambda *a: True)]
        with contextlib.ExitStack() as counting:
            for c in plain:
                counting.enter_context(c)
            out = run()
            torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - base
        made = {"mq": mq_scan.LAUNCHES["mq"], "dwt": dwt.LAUNCHES["dwt"]}
        print(f"{name} encode launches: {made}; plain coder / DWT calls: "
              f"{[c.n for c in plain]}")
        if min(made.values()) < 1 or any(c.n for c in plain):
            raise AssertionError(f"{name}: mq_scan or the DWT was not "
                                 f"launched, or a plain version ran")
        for k, v in made.items():
            launches[k] += v
        cinema_streams_check(name, out, want["cases"][name], prof)
        streams[name] = out
        if not cinema:
            continue
        n = len(imgs)
        print(f"{name}: plan of {plan.nblocks} code-blocks a frame in "
              f"{len(plan.groups)} shape groups "
              f"{[(h, w, len(b)) for (h, w, b) in plan.groups]}; peak "
              f"device memory {peak / 1e9:.3f} GB above the "
              f"{base / 1e9:.3f} GB held before, "
              f"{(chunk * per_frame + mq_scan.EMIT_BLOCK_BYTES) / 1e9:.3f} "
              f"GB predicted (mq_frame_bytes {per_frame / 1e9:.3f} GB x "
              f"chunk {chunk} + the counting temporaries) on {card}")
        if name == "cinema2k_24":
            if profiles.encode_with_profile(imgs[0], prof) != out[0]:
                raise AssertionError("encode_with_profile differs from "
                                     "encode_batch on frame 0")
            print(f"{name}: encode_with_profile of frame 0 equals its "
                  f"encode_batch stream")
            enc = fused_encode.FusedMQEncoder(plan, dev)
            host = [np.stack([im.components[c].data for im in imgs])
                    for c in range(3)]
            c2_encode_stages(enc, host, imgs, prof.params, siz, cod, qcd, tr,
                             layer_alloc=alloc)
            stages, _ = c2_encode_stages(enc, host, imgs, prof.params, siz,
                                         cod, qcd, tr, layer_alloc=alloc)
            sims = stages.pop("simulator calls")
            print(f"one {n}-frame {name} encode chunk by stage (host clock, "
                  f"synchronised; PCRD and T2 serial, frame after frame): "
                  + ", ".join(f"{k} {v * 1e3:.1f} ms"
                              for k, v in stages.items())
                  + f"; the rate control's simulator calls: {sims}")
            res = cinema_mq_scan_check(enc, fused_encode.upload_tile(host,
                                                                     enc))
            results["cinema mq_scan"] = res
            del enc, host
            torch.cuda.empty_cache()
        mpix = n * imgs[0].xsiz * imgs[0].ysiz / 1e6
        best = best_of(3, run)
        print(f"encode {name}: {mpix / best:.2f} MP/s (best of 3, "
              f"{best:.3f} s for {n} frames of {imgs[0].xsiz}x"
              f"{imgs[0].ysiz}; real time at 24 fps: "
              f"{CIN_REALTIME_MPS:.2f} MP/s for 2K) on {card}")
    # (e) the decode of the cinema streams
    for case in CIN_CASES:
        name = case[0]
        if case[2] != "apply_cinema":
            continue
        out = streams[name]
        n = len(out)
        img0 = sets[case[1]][0]
        with decode_counts(extra=[Calls(dwt_torch, "inv_dwt_2d",
                                        lambda *a, **k: True)]) as plain:
            dec = decoder.decode_batch(out, device="cuda")
            torch.cuda.synchronize()
        check_decode_counts(plain, f"{name} decode", ("mq_dec", "dwt"))
        launches["mq_dec"] += mq_dec.LAUNCHES["mq_dec"]
        launches["dwt"] += dwt.LAUNCHES["dwt"]
        got = [frame_digest(d) for d in dec]
        if got != want["cases"][name]["decoded"]:
            raise AssertionError(f"{name} decode: pixels differ from the "
                                 f"host decoder's")
        mse = [frame_mse(d, im) for d, im in zip(dec, sets[case[1]])]
        del dec
        mpix = n * img0.xsiz * img0.ysiz / 1e6
        best = best_of(3, lambda: decoder.decode_batch(out, device="cuda"))
        print(f"decode {name}: {n} frames equal the host decoder's pixels "
              f"(MSE against the sources "
              + ", ".join(f"{m:.2f}" for m in mse)
              + f"); {mpix / best:.2f} MP/s (best of 3, {best:.3f} s) on "
              f"{card}")
        if name == "cinema2k_24":
            c2_decode_stages(out, dev)
            stages = c2_decode_stages(out, dev)
            print(f"one {n}-frame {name} decode chunk by stage (host clock, "
                  f"synchronised): " + ", ".join(
                      f"{k} {v * 1e3:.1f} ms" for k, v in stages.items()))
            results["cinema mq_dec_group"] = cinema_mq_dec_check(out, dev)
    check_dwt(dev, results, cases=(
        ("cinema 2K frame", (3, 1080, 2048), Rect(0, 0, 2048, 1080), 6,
         False),
        ("cinema 4K frame", (3, 2160, 4096), Rect(0, 0, 4096, 2160), 7,
         False)), key="cinema")
    print(f"cinema phase launches (encodes and decodes): {launches}")
    return launches


def window_small_check(dev):
    """Phase 19 (a): the small window-decode frames encoded on the card
    with each WIN_CODINGS entry, the streams against WIN_DIGESTS (the
    reference host encoder's), and every request of the coding decoded
    on the card, frame by frame through `decoder.decode` and both frames
    through `decode_batch`, against the reference host decoder's pixel
    digests there."""
    import torch

    from grokimagecompression_tpu_torch.codestream import decoder, encoder
    from grokimagecompression_tpu_torch.core.params import (DecoderParams,
                                                            EncoderParams,
                                                            Transform)
    root = os.path.dirname(os.path.abspath(__file__))
    with open(os.path.join(root, WIN_DIGESTS)) as f:
        want = json.load(f)
    frames = window_frames()
    if [frame_digest(im) for im in frames] != want["frames"]:
        raise AssertionError("the window-decode frames differ from the "
                             "digest file's: numpy makes other frames here")
    n = 0
    with decode_counts() as plain:
        for coding, entry in want["codings"].items():
            streams = encoder.encode_batch(frames, window_params(
                EncoderParams, Transform, coding), device="cuda")
            if [hashlib.sha256(cs).hexdigest() for cs in streams] != \
                    entry["streams"]:
                raise AssertionError(f"window-decode {coding}: streams "
                                     f"differ from the host encoder's")
            for kw in window_requests(coding):
                digests = entry["requests"][request_name(kw)]
                params = DecoderParams(**kw)
                one = [decoder.decode(cs, params, device="cuda")
                       for cs in streams]
                both = decoder.decode_batch(streams, params, device="cuda")
                if [frame_digest(im) for im in one + both] != digests * 2:
                    raise AssertionError(
                        f"window-decode {coding}, {request_name(kw)}: "
                        f"pixels differ from the host decoder's")
                n += 1
        torch.cuda.synchronize()
    check_decode_counts(plain, "small window-decode requests",
                        ("dec", "mq_dec", "dwt"))
    print(f"window-decode requests at small size ({WIN_SIZE[0]}x"
          f"{WIN_SIZE[1]} RGB, 96x96 tiles at an odd image offset; "
          f"{', '.join(want['codings'])}): both streams of each coding equal "
          f"the host encoder's, and {n} requests decode on the card, "
          f"through decode and decode_batch, to the host decoder's pixels")


# the per-image decode at full size (phase 19): S1, a lossless 12-bit gray
# mosaic the size of a Sentinel-2 10 m granule in 1024^2 tiles (HT, 5/3);
# S2, an 8-bit RGB orthophoto or slide pyramid base in 512^2 tiles at
# config 2's coding (9/7, ICT, three layers at ratios 24 / 48 / 96, MQ)
S1_SIZE, S1_TILE = 10980, 1024
S2_SIZE, S2_TILE = 4096, 512
# (name, width, tile, 600 x 600 window W1 across four tiles, 2048 x 2048
# window W2 decoded at reduce 2, window W3 clipped by the image's
# bottom-right corner, an interior tile, the corner tile)
FULL_CASES = (
    ("S1", S1_SIZE, S1_TILE, (4820, 4820, 5420, 5420),
     (2501, 3103, 4549, 5151), (10600, 10700, 11200, 11300), 60, 120),
    ("S2", S2_SIZE, S2_TILE, (1748, 1748, 2348, 2348),
     (1001, 1003, 3049, 3051), (3900, 3800, 4400, 4400), 27, 63),
)
# W1-sized windows (W1_SIDE^2) through codec.decompress, at positions from
# a seeded generator: the traffic of a tile server
TILE_SERVER_WINDOWS = 16
W1_SIDE = 600


def s1_frame():
    """S1: 10980 x 10980 gray 12-bit: 2048 plus separable waves of
    amplitude 600 and 500 and uniform texture in [0, 64), from a generator
    seeded 5; made in int32 on broadcast row and column vectors."""
    import numpy as np
    from grokimagecompression_tpu_torch.core.image import Component, Image

    rng = np.random.default_rng(5)
    n = S1_SIZE
    rows = (600 * np.sin(np.arange(n) / 151.0)).astype(np.int32)[:, None]
    cols = (500 * np.cos(np.arange(n) / 97.0)).astype(np.int32)[None, :]
    data = rng.integers(0, 64, (n, n), dtype=np.int32)
    data += rows
    data += cols + 2048
    return Image(xsiz=n, ysiz=n, components=[Component(
        data=data, prec=12, signed=False, dx=1, dy=1)])


def s2_frame():
    """S2: 4096 x 4096 RGB 8-bit as `config2_frames` makes a frame (smooth
    waves plus uniform texture in [0, 24), seeded 3) at 4096."""
    return config2_frames(1, size=S2_SIZE)[0]


def full_requests(case):
    """(label, DecoderParams arguments) of a FULL_CASES entry: the whole
    image, W1, W2 at reduce 2, W3, reduce 1, 3 and 5, on S2 also the
    first layer at reduce 5 (a thumbnail), an interior and the corner
    tile."""
    name, _, _, w1, w2, w3, inner, corner = case
    reqs = [("full", {}), ("W1", {"window": w1}),
            ("W2 at reduce 2", {"window": w2, "reduce": 2}),
            ("W3 (clipped)", {"window": w3})]
    reqs += [(f"reduce {r}", {"reduce": r}) for r in (1, 3, 5)]
    if name == "S2":
        reqs.append(("thumbnail: layers 1, reduce 5",
                     {"layers": 1, "reduce": 5}))
    reqs += [(f"tile {inner} (interior)", {"tile_index": inner}),
             (f"tile {corner} (corner)", {"tile_index": corner})]
    return reqs


def request_stages(data, kw, dev):
    """One decode of `data` at request `kw` through `decoder.decode`, by
    stage (host clock, each device stage synchronised): T2 (host), lane
    packing (host), upload, device decode (the block decoders and
    dequantization, and for whole tiles the inverse DWT, MCT and DC
    shift), fetch, the windowed inverse DWT (host numpy, windows only),
    and the rest (host: plans, canvas, a window's inverse MCT and DC
    shift, paste)."""
    import torch

    from grokimagecompression_tpu_torch.codestream import decoder
    from grokimagecompression_tpu_torch.core.params import DecoderParams
    from grokimagecompression_tpu_torch.models import fused_decode
    from grokimagecompression_tpu_torch.ops import dwt_window
    timers = {"T2 (host)": Timed(decoder, "_parse_frame", sync=False),
              "lane packing (host)": Timed(fused_decode, "prepare_chunk",
                                           sync=False),
              "upload": Timed(fused_decode, "upload"),
              "device decode": Timed(fused_decode._FusedDecoder, "forward"),
              "fetch": Timed(fused_decode, "decode_tiles_collect",
                             sync=False),
              "windowed inverse DWT (host)": Timed(
                  dwt_window, "inv_dwt_2d_window", sync=False)}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with contextlib.ExitStack() as stack:
        for t in timers.values():
            stack.enter_context(t)
        decoder.decode(data, DecoderParams(**kw), device=dev)
    wall = time.perf_counter() - t0
    stages = {k: t.total() for k, t in timers.items()
              if t.calls or "windowed" not in k}
    stages["rest (host)"] = wall - sum(stages.values())
    return stages


def full_case(case, img, params, dev, card):
    """Phase 19 (b): one FULL_CASES image encoded through encode_batch
    (its peak device memory beside the plan's model), then each of
    `full_requests` through `decoder.decode`: launches, best of 3 warm,
    output MP/s and stages; the tile-server windows through
    `codec.decompress`. Checks: every window equals the crop of the whole
    image's decode at the same reduction, every tile the tile's crop, and
    on S1 the whole decode equals the source and each reduced decode the
    LL of the port's forward DWT of each tile. Returns the launches of
    the requests' first runs by LAUNCHES key, the stream, and the
    `plane_md5` of the whole decode, of reduce 2 and of W1 (phase 21's
    checks)."""
    import numpy as np
    import torch

    from grokimagecompression_tpu_torch import codec
    from grokimagecompression_tpu_torch.codestream import decoder, encoder
    from grokimagecompression_tpu_torch.core.geometry import ceil_div
    from grokimagecompression_tpu_torch.core.params import DecoderParams
    from grokimagecompression_tpu_torch.models import fused_encode
    from grokimagecompression_tpu_torch.ops import (dwt, ht_dec, mct_torch,
                                                    mq_dec)
    name, size, tile = case[:3]
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    (cs,) = encoder.encode_batch([img], params, device="cuda")
    torch.cuda.synchronize()
    enc_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() - base
    siz = encoder.build_siz(img, params)
    cod = encoder.build_cod(img, params)
    hdr = decoder.read_header(cs)
    trs = decoder._tile_rects(hdr.siz)
    coder = "ht" if params.cblk_style & 0x40 else "mq"
    plans = {}
    for tr in trs:
        plan = fused_encode.build_plan(
            siz, cod, hdr.qcd, tr, coder=coder,
            want_rd=coder == "mq" and bool(params.rates))
        plans[plan] = plans.get(plan, 0) + 1
    model = fused_encode.ht_frame_bytes if coder == "ht" else \
        fused_encode.mq_frame_bytes
    per_tile = {p: model(p) for p in plans}
    kind = "gray 12-bit" if coder == "ht" else "RGB 8-bit"
    print(f"{name}: {size}x{size} {kind}, {len(trs)} tiles of {tile}^2 in "
          f"{len(plans)} plans, "
          f"{coder.upper()}: encode_batch {enc_s:.3f} s (one frame), "
          f"{len(cs)} B; peak device memory {peak / 1e9:.3f} GB above the "
          f"{base / 1e9:.3f} GB held before, the plans' model "
          f"({'ht' if coder == 'ht' else 'mq'}_frame_bytes) "
          f"{max(per_tile.values()) / 1e9:.3f} GB for the largest tile, "
          f"{sum(n * per_tile[p] for p, n in plans.items()) / 1e9:.3f} GB for "
          f"every tile of the frame (encode_batch submits every tile of a "
          f"chunk before it collects any) on {card}")

    out = {}
    launches = {"dec": 0, "mq_dec": 0, "dwt": 0}
    for label, kw in full_requests(case):
        with decode_counts() as plain:
            img_out = decoder.decode(cs, DecoderParams(**kw), device="cuda")
            torch.cuda.synchronize()
        counts = {"dec": ht_dec.LAUNCHES["dec"],
                  "mq_dec": mq_dec.LAUNCHES["mq_dec"],
                  "dwt": dwt.LAUNCHES["dwt"]}
        # the inverse DWT runs on the card for whole tiles with a level
        # left to invert; a window's inverse is host numpy
        inverts = "window" not in kw and kw.get("reduce", 0) < 5
        check_decode_counts(plain, f"{name} {label}",
                            ("dec" if coder == "ht" else "mq_dec",)
                            + (("dwt",) if inverts else ()))
        for k, v in counts.items():
            launches[k] += v
        out[label] = img_out
        best = best_of(3, lambda: decoder.decode(cs, DecoderParams(**kw),
                                                 device="cuda"))
        c0 = img_out.components[0].data
        stages = request_stages(cs, kw, dev)
        print(f"{name} {label}: {c0.shape[1]}x{c0.shape[0]} out, "
              f"{1e3 * best:.1f} ms a request (best of 3), "
              f"{c0.size / 1e6 / best:.2f} MP/s out, launches {counts}; "
              f"stages " + ", ".join(f"{k} {1e3 * v:.1f} ms"
                                     for k, v in stages.items())
              + f" on {card}")

    def plane(im):
        return [c.data for c in im.components]

    whole = {0: plane(out["full"])}
    whole[2] = plane(decoder.decode(cs, DecoderParams(reduce=2),
                                    device="cuda"))
    for r in (1, 3, 5):
        whole[r] = plane(out[f"reduce {r}"])

    def crop(im, r):
        """`im` against the crop of the whole decode at reduce r."""
        for c, (a, w) in enumerate(zip(plane(im), whole[r])):
            y0 = ceil_div(im.y0, 1 << r) - ceil_div(hdr.siz.yosiz, 1 << r)
            x0 = ceil_div(im.x0, 1 << r) - ceil_div(hdr.siz.xosiz, 1 << r)
            if not a.size or not np.array_equal(
                    a, w[y0:y0 + a.shape[0], x0:x0 + a.shape[1]]):
                return False
        return True

    for label, kw in full_requests(case):
        if ("window" in kw or "tile_index" in kw) and \
                not crop(out[label], kw.get("reduce", 0)):
            raise AssertionError(f"{name} {label}: differs from the crop of "
                                 f"the whole image's decode")
        if "tile_index" in kw:
            tr = trs[kw["tile_index"]]
            if (out[label].x0, out[label].y0, out[label].xsiz,
                    out[label].ysiz) != (tr.x0, tr.y0, tr.x1, tr.y1):
                raise AssertionError(f"{name} {label}: not the tile's area")
    if name == "S1":
        if not np.array_equal(whole[0][0], img.components[0].data):
            raise AssertionError("S1: the whole decode is not lossless")
        src = img.components[0].data
        for r in (1, 3, 5):
            want = np.zeros_like(whole[r][0])
            for tr in trs:
                a = torch.from_numpy(np.ascontiguousarray(
                    src[tr.y0:tr.y1, tr.x0:tr.x1])).to(dev)
                ll = dwt.fwd_dwt_2d(mct_torch.dc_shift_fwd(a, 12, False), tr,
                                    r + 1, True)[(0, 0)]
                ll = mct_torch.dc_shift_inv(ll, 12, False).cpu().numpy()
                y, x = ceil_div(tr.y0, 1 << r), ceil_div(tr.x0, 1 << r)
                want[y:y + ll.shape[0], x:x + ll.shape[1]] = ll
            if not np.array_equal(whole[r][0], want):
                raise AssertionError(f"S1 reduce {r}: differs from the LL "
                                     f"of the tiles' forward DWT")
        print("S1: the whole decode equals the source; reduce 1, 3 and 5 "
              "equal the LL of each tile's forward 5/3 DWT (port, on the "
              "card) at 1, 3 and 5 levels, DC-shifted back")
    print(f"{name}: every window equals the crop of the whole image's "
          f"decode at its reduction, every tile the tile's crop")

    side = W1_SIDE
    rng = np.random.default_rng(7)
    wins = [(int(x), int(y), int(x) + side, int(y) + side)
            for x, y in rng.integers(0, size - side, (TILE_SERVER_WINDOWS, 2))]
    with decode_counts() as plain:
        arrays = [codec.decompress(cs, window=w, device="cuda")
                  for w in wins]
        torch.cuda.synchronize()
    check_decode_counts(plain, f"{name} tile-server windows",
                        ("dec" if coder == "ht" else "mq_dec",))
    for w, a in zip(wins, arrays):
        ox, oy = w[0] - hdr.siz.xosiz, w[1] - hdr.siz.yosiz
        want = [p[oy:oy + side, ox:ox + side] for p in whole[0]]
        want = np.stack(want, axis=-1) if len(want) > 1 else want[0]
        if not np.array_equal(a, want):
            raise AssertionError(f"{name} tile-server window {w}: differs "
                                 f"from the crop of the whole decode")
    best = best_of(3, lambda: [codec.decompress(cs, window=w, device="cuda")
                               for w in wins])
    print(f"{name}: {TILE_SERVER_WINDOWS} {side}x{side} windows at seeded "
          f"positions through codec.decompress equal the crops of the "
          f"whole decode; {1e3 * best / len(wins):.1f} ms a request (best "
          f"of 3 of the set), {len(wins) * side * side / 1e6 / best:.2f} "
          f"MP/s out on {card}")
    refs = {"full": plane_md5(out["full"]), "W1": plane_md5(out["W1"]),
            "reduce 2": hashlib.md5(b"".join(
                np.ascontiguousarray(a).tobytes() for a in whole[2]))
            .hexdigest()}
    return launches, cs, refs


def reduced_dwt_check(dev, results):
    """Phase 19 (c): the CUDA inverse DWT at every max_res of S1's interior
    and corner tiles (5/3, 6 resolutions) and of an S2 tile (3 x 512^2,
    9/7), bit-exact with `dwt_torch` on the same bands on the card; the
    inverse of S1's reduce-1 decode chunk (32 interior tiles to max_res
    4) timed beside its bound."""
    import torch

    from grokimagecompression_tpu_torch.core.geometry import (Rect,
                                                              resolution_rect)
    from grokimagecompression_tpu_torch.ops import dwt, dwt_torch
    gen = torch.Generator().manual_seed(1)
    last = (S1_SIZE // S1_TILE) * S1_TILE
    cases = (("S1 interior tile", (1, S1_TILE, S1_TILE),
              Rect(5 * S1_TILE, 5 * S1_TILE, 6 * S1_TILE, 6 * S1_TILE),
              True),
             ("S1 corner tile", (1, S1_SIZE - last, S1_SIZE - last),
              Rect(last, last, S1_SIZE, S1_SIZE), True),
             ("S2 tile", (3, S2_TILE, S2_TILE),
              Rect(3 * S2_TILE, 3 * S2_TILE, 4 * S2_TILE, 4 * S2_TILE),
              False))
    for label, shape, rect, rev in cases:
        x = torch.randint(-2048, 2048, shape, generator=gen,
                          dtype=torch.int32)
        if not rev:
            x = x + torch.rand(shape, generator=gen)
        bands = dwt_torch.fwd_dwt_2d(x.to(dev), rect, 6, rev)
        for max_res in range(6):
            before = dwt.LAUNCHES["dwt"]
            got = dwt.inv_dwt_2d(bands, rect, 6, rev, max_res)
            made = dwt.LAUNCHES["dwt"] - before
            want = dwt_torch.inv_dwt_2d(bands, rect, 6, rev, max_res)
            torch.cuda.synchronize()
            if made != max_res or not torch.equal(got, want):
                raise AssertionError(f"dwt inverse to max_res {max_res} "
                                     f"({label}): {made} launches, or it "
                                     f"differs from the plain version")
        print(f"kernel dwt: {label} {shape} at ({rect.x0}, {rect.y0}), "
              f"{'5/3' if rev else '9/7'}: the inverse to every max_res "
              f"0-5 bit-exact with plain, one launch a level")
    # timed: S1's reduce-1 decode chunk, 32 interior tiles inverted to
    # max_res 4
    _, (_, h, w), rect, rev = cases[0]
    shape, max_res = (32, h, w), 4
    x = torch.randint(-2048, 2048, shape, generator=gen,
                      dtype=torch.int32).to(dev)
    kept = {k: v for k, v in dwt.fwd_dwt_2d(x, rect, 6, rev).items()
            if k[0] <= max_res}
    out = dwt.inv_dwt_2d(kept, rect, 6, rev, max_res)
    # each kept band read and the output written once; two passes of 3.5
    # integer operations a sample of each level's region
    nb = 4 * (sum(v.numel() for v in kept.values()) + out.numel())
    ops = shape[0] * sum(resolution_rect(rect, 6, r).h
                         * resolution_rect(rect, 6, r).w
                         for r in range(1, max_res + 1)) * 2 * 3.5
    b_ms, b_by, b_terms = bound(nb, ops)
    ms, plain_ms = time_kernel(
        lambda b: dwt.inv_dwt_2d(b, rect, 6, rev, max_res),
        lambda b: dwt_torch.inv_dwt_2d(b, rect, 6, rev, max_res), (kept,))
    results.setdefault("dwt", {})["reduced"] = dict(
        ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by)
    print(f"kernel dwt: S1's reduce-1 decode chunk {shape} inverted to "
          f"max_res {max_res} ({tuple(out.shape)} out, {max_res} launches):"
          f" {ms:.4f} ms (plain {plain_ms:.3f} ms, bound {b_ms:.4f} ms by "
          f"{b_by}: {b_terms})")


def window_phase(dev, card, results):
    """Phase 19: the per-image decode (`decoder.decode`, `codec.decompress`)
    of windows, reduced resolutions, single tiles and layer limits: the
    small-size requests against WIN_DIGESTS, S1 and S2 at full size, and
    the reduced inverse DWT against its plain version. Returns the
    launches of the full-size requests' first runs by LAUNCHES key,
    S1's and S2's `encode_batch([img])` streams by name, and the digests
    of S1's whole, reduce-2 and W1 decodes (`full_case`)."""
    window_small_check(dev)
    s1, s2 = s1_frame(), s2_frame()
    reduced_dwt_check(dev, results)
    launches, s1_cs, s1_refs = full_case(FULL_CASES[0], s1,
                                         full_params("S1"), dev, card)
    del s1
    more, s2_cs, _ = full_case(FULL_CASES[1], s2, full_params("S2"), dev,
                               card)
    return ({k: launches[k] + more[k] for k in launches},
            {"S1": s1_cs, "S2": s2_cs}, s1_refs)


@contextlib.contextmanager
def encode_counts(extra=()):
    """Every encode kernel's launch count set to 0, the plain versions on
    the encode routes (the HT cleanup encoder, its torch op streams and
    host splice, the MQ coder, the forward DWT) and the `Calls` of
    `extra` counted, inside a `with` block; yields the plain versions'
    counters."""
    from grokimagecompression_tpu_torch.ops import (dwt, dwt_torch, ht_enc,
                                                    ht_tables, ht_torch,
                                                    mq_scan, mq_torch)
    ht_enc.LAUNCHES["enc"] = 0
    mq_scan.LAUNCHES["mq"] = 0
    dwt.LAUNCHES["dwt"] = 0
    plain = [Calls(ht_enc, "encode_segments_plain", lambda *a: True),
             Calls(ht_torch, "op_streams", lambda *a: True),
             Calls(ht_tables, "assemble_segments_host", lambda *a: True),
             Calls(mq_torch, "mq_scan_plain", lambda *a: True),
             Calls(dwt_torch, "fwd_dwt_2d", lambda *a: True)]
    with contextlib.ExitStack() as counting:
        for c in plain + list(extra):
            counting.enter_context(c)
        yield plain


def check_encode_counts(plain, what, want):
    """Fail unless every kernel in `want` ("enc", "mq", "dwt") was
    launched and no plain version ran; returns the launches by key."""
    from grokimagecompression_tpu_torch.ops import dwt, ht_enc, mq_scan
    counts = {"enc": ht_enc.LAUNCHES["enc"], "mq": mq_scan.LAUNCHES["mq"],
              "dwt": dwt.LAUNCHES["dwt"]}
    if any(counts[k] < 1 for k in want):
        raise AssertionError(f"{what}: a kernel of {want} was not launched "
                             f"({counts})")
    if any(c.n for c in plain):
        raise AssertionError(f"{what}: a plain version ran "
                             f"({[c.n for c in plain]})")
    return counts


def image_encode_small_check(mixed, dev):
    """Phase 20 (a): each IMG_ENC_CASES entry through `encoder.encode` and
    `codec.Codec(params=).compress_image`, each IMG_COMPRESS route through
    `codec.compress` and each preset in both containers through
    `codec.Codec(preset=, container=).compress_image`, on the card,
    against the reference host encoder's digests in IMG_ENC_DIGESTS; the
    encode kernels launched and no plain version run. Then
    `codec.decompress_batch` of `mixed` (phase 15's COC + POC + PPM JP2
    files between plain streams, which `decode_batch` cannot take
    together): each output equal to the stream's lone
    `codec.decompress`. Returns the launches by LAUNCHES key."""
    import numpy as np
    import torch

    from grokimagecompression_tpu_torch import codec
    from grokimagecompression_tpu_torch.codestream import encoder, markers
    from grokimagecompression_tpu_torch.core import params as params_mod
    from grokimagecompression_tpu_torch.ops import dwt, ht_dec
    root = os.path.dirname(os.path.abspath(__file__))
    with open(os.path.join(root, IMG_ENC_DIGESTS)) as f:
        want = json.load(f)
    frames = image_encode_frames()
    if {k: frame_digest(im) for k, im in frames.items()} != want["frames"]:
        raise AssertionError("the image-encode frames differ from the "
                             "digest file's: numpy makes other frames here")

    def sha(cs):
        return hashlib.sha256(cs).hexdigest()

    bad = []
    with encode_counts() as plain:
        for case, (frame, _) in IMG_ENC_CASES.items():
            p = image_encode_params(params_mod, markers.PocEntry, case)
            one = encoder.encode(frames[frame], p, device="cuda")
            via = codec.Codec(params=p).compress_image(frames[frame])
            if {sha(one), sha(via)} != {want["encode"][case]}:
                bad.append(f"encode {case}")
        for route, opts in IMG_COMPRESS.items():
            cs = codec.compress(compress_array(frames, route), **opts)
            if sha(cs) != want["compress"][route]:
                bad.append(f"compress {route}")
        for key, digest in want["presets"].items():
            preset, container = key.split("/")
            cs = codec.Codec(preset=preset, container=container
                             ).compress_image(frames["small"])
            if sha(cs) != digest:
                bad.append(f"Codec {key}")
        torch.cuda.synchronize()
    counts = check_encode_counts(plain, "small image encodes",
                                 ("enc", "mq", "dwt"))
    if bad:
        raise AssertionError(f"streams differ from the host encoder's: "
                             f"{bad}")
    print(f"image encode at small size ({IMG_ENC_SIZE[0]}x{IMG_ENC_SIZE[1]} "
          f"gray and RGB at image offset (5, 3) in 32^2 / 16^2 tiles, a "
          f"64^2 RGB frame for HT rate control): {len(IMG_ENC_CASES)} cases "
          f"through encoder.encode and Codec(params=), "
          f"{len(IMG_COMPRESS)} codec.compress routes and "
          f"{len(want['presets'])} Codec presets x containers equal the "
          f"host encoder's streams; launches {counts}")
    with decode_counts() as dplain:
        got = codec.decompress_batch(mixed)
        alone = [codec.decompress(d) for d in mixed]
        torch.cuda.synchronize()
    check_decode_counts(dplain, "mixed decompress_batch", ("dec", "dwt"))
    counts["dec"] = ht_dec.LAUNCHES["dec"]
    counts["dwt"] += dwt.LAUNCHES["dwt"]
    if not all(np.array_equal(a, b) for a, b in zip(got, alone)):
        raise AssertionError("decompress_batch of the mixed batch differs "
                             "from the streams' lone decodes")
    print(f"codec.decompress_batch of {len(mixed)} config-2 HT 9/7 streams, "
          f"COC + POC + PPM JP2 files between plain ones: each equals its "
          f"lone codec.decompress")
    return counts


def layer_bytes(cs):
    """Each layer's cumulative packet bytes (layers 0..l, every tile), by
    the port's packet index: what the PCRD allocators hold to the
    targets; and whether each layer's packets are all empty (1 B)."""
    from grokimagecompression_tpu_torch.codestream import decoder, tile
    hdr = decoder.read_header(cs)
    bodies = {}
    for tp in decoder.iter_tile_parts(cs, hdr.main_header_end):
        bodies[tp.tile_index] = bodies.get(tp.tile_index, b"") + tp.body
    nl = hdr.cod.numlayers
    per, empty = [0] * nl, [True] * nl
    for t, body in bodies.items():
        for (layer, *_, ln) in tile.index_tile_packets(body, hdr, t):
            per[layer] += ln
            empty[layer] &= ln <= 1
    cum = [sum(per[:layer + 1]) for layer in range(nl)]
    return cum, empty


def image_encode_stages(img, params, dev):
    """One `encoder.encode` by stage (host clock; each plan group's
    submit synchronised): per plan its stacked tiles' upload, transform
    and coding, the fetch and slice of the segments, the T2 pool (the
    span from the first tile's T2 to the last's), the main header and
    tile-part writing, and the rest (plans, encoders, tile extraction)."""
    import torch

    from grokimagecompression_tpu_torch.codestream import encoder
    from grokimagecompression_tpu_torch.models import fused_encode
    timers = {"submit": Timed(fused_encode, "encode_tile_submit"),
              "fetch": Timed(fused_encode, "encode_tile_collect",
                             sync=False),
              "T2": Timed(encoder, "encode_tile", sync=False),
              "write": Timed(encoder, "write_codestream", sync=False)}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with contextlib.ExitStack() as stack:
        for t in timers.values():
            stack.enter_context(t)
        encoder.encode(img, params, device=dev)
    wall = time.perf_counter() - t0
    stages = {}
    for i, c in enumerate(timers["submit"].calls):
        comps, enc = c["args"]
        stages[f"plan {i} ({comps[0].shape[0]} x "
               f"{'x'.join(map(str, comps[0].shape[1:]))}: upload, "
               f"transform, coding)"] = c["s"]
    stages["fetch + slice (host)"] = timers["fetch"].total()
    stages["T2 pool (host, span)"] = timers["T2"].span()
    stages["header and tile-parts (host)"] = \
        timers["write"].total() - timers["T2"].span()
    stages["rest (host)"] = wall - sum(stages.values())
    return wall, stages


def image_encode_case(name, img, params, batch_cs, dev, card, kernel):
    """Phase 20 (b), (c): a FULL_CASES image through `encoder.encode` on
    the card: its stream equal to `batch_cs` (phase 19's `encode_batch
    ([img])`), the coder launched at most (shape groups x chunks) a plan
    and not a tile a time, no plain version run; seconds and MP/s (best
    of 2), launches, stages, peak device memory beside the plans' model x
    tiles a chunk. Returns (launches by key, the stream)."""
    import torch

    from grokimagecompression_tpu_torch.codestream import encoder
    from grokimagecompression_tpu_torch.models import fused_encode
    p, siz, cod, qcd, cod_comp, trs = encoder._coding(img, params)
    want_rd = not p.cblk_style & 0x40 and encoder._needs_rc(p)
    plans = {}
    for tr in trs:
        plan = fused_encode.build_plan(siz, cod, qcd, tr, cod_comp=cod_comp,
                                       coder="ht" if p.cblk_style & 0x40
                                       else "mq", want_rd=want_rd)
        plans[plan] = plans.get(plan, 0) + 1
    torch.cuda.empty_cache()
    free = encoder.free_device_bytes(dev)
    chunks = {pl: max(1, min(fused_encode.chunk_cap(pl, free), n))
              for pl, n in plans.items()}
    most = sum(len(pl.groups) * -(-n // chunks[pl])
               for pl, n in plans.items())
    per_tile = sum(len(pl.groups) * n for pl, n in plans.items())
    model = max(chunks[pl] * fused_encode.frame_bytes(pl) for pl in plans)
    foot = [min(chunks[pl], n - lo) * fused_encode.frame_bytes(pl)
            for pl, n in plans.items() for lo in range(0, n, chunks[pl])]
    pair = max([a + b for a, b in zip(foot, foot[1:])] or foot)
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    with encode_counts() as plain:
        t0 = time.perf_counter()
        cs = encoder.encode(img, params, device="cuda")
        torch.cuda.synchronize()
        first = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() - base
    counts = check_encode_counts(plain, f"{name} encode", (kernel, "dwt"))
    if cs != batch_cs:
        raise AssertionError(f"{name}: encode's stream differs from "
                             f"encode_batch([img])'s ({len(cs)} B, "
                             f"{len(batch_cs)} B)")
    if counts[kernel] > most:
        raise AssertionError(f"{name}: {counts[kernel]} coder launches, "
                             f"above {most} (shape groups x chunks a plan)")
    best = best_of(2, lambda: encoder.encode(img, params, device="cuda"))
    mpix = img.xsiz * img.ysiz / 1e6
    wall, stages = image_encode_stages(img, params, dev)
    print(f"{name} through encoder.encode: {len(trs)} tiles in "
          f"{len(plans)} plans (tiles a plan {sorted(plans.values())}, "
          f"chunks {[-(-n // chunks[pl]) for pl, n in plans.items()]}); "
          f"stream equal to encode_batch([img])'s ({len(cs)} B); "
          f"launches {counts} ({kernel}: at most {most} by shape groups x "
          f"chunks, {per_tile} at a launch a tile and group); first "
          f"{first:.3f} s, best of 2 {best:.3f} s, {mpix / best:.2f} MP/s "
          f"on {card}")
    print(f"{name} encode stages (one more run, {wall:.3f} s): "
          + ", ".join(f"{k} {1e3 * v:.1f} ms" for k, v in stages.items()))
    print(f"{name} encode peak device memory {peak / 1e9:.3f} GB above the "
          f"{base / 1e9:.3f} GB held before; the model x tiles a chunk "
          f"{model / 1e9:.3f} GB for the largest plan chunk, "
          f"{pair / 1e9:.3f} GB for the largest two chunks in a row (a "
          f"chunk is collected once the next is submitted) on {card}")
    return counts, cs


def stacked_scan_check(img, params, dev, card):
    """Phase 20 (c): the MQ coder on the largest shape group of S2's
    stacked plan (every tile of the image in one call, the group larger
    than any earlier phase gives it): the kernel's call (`scan_into` with
    the pass-end byte-outs, as the rate-controlled path launches it) in
    ms, CUDA events, mean of 5 after 1 warm-up, beside its bound; the
    segments equal those of the same lanes coded one tile at a time.
    Returns (slots' shape, ms, bound ms, what bounds it)."""
    import numpy as np
    import torch

    from grokimagecompression_tpu_torch.codestream import encoder
    from grokimagecompression_tpu_torch.models import fused_encode
    from grokimagecompression_tpu_torch.ops import mq_scan, mq_torch
    p, siz, cod, qcd, cod_comp, trs = encoder._coding(img, params)
    enc = encoder._tile_encoders(p, siz, cod, qcd, cod_comp, trs[:1], dev,
                                 True)[0]
    tiles = [t for t, tr in enumerate(trs)
             if fused_encode.build_plan(siz, cod, qcd, tr, coder="mq",
                                        want_rd=True) == enc.plan]
    stacks = zip(*(encoder.extract_tile_comps(img, siz, t) for t in tiles))
    args = fused_encode.upload_tile([np.stack(a) for a in stacks], enc)
    g = max(range(len(enc.plan.groups)),
            key=lambda i: len(enc.plan.groups[i][2]))
    h, w, blocks = enc.plan.groups[g]
    mag, neg, orient = list(enc.group_inputs(*args))[g]
    del args
    _, slots, _ = enc.group_slots(mag, neg, orient)
    spans = mq_torch.pass_spans_padded(h, w)
    off, total = mq_scan.segment_offsets(slots)
    got = mq_scan.scan_into(slots, off, total, spans)
    torch.cuda.synchronize()
    ms = cuda_ms(lambda: mq_scan.scan_into(slots, off, total, spans), 5)
    # the first tile's lanes, coded alone, against the stacked call's
    nb = len(blocks)
    one = mq_scan.mq_scan(slots[:, :nb].contiguous(), spans)
    lens = got[1][:nb]
    ends = off[:nb] + lens.to(off.dtype)
    seg = torch.cat([got[0][int(a):int(b)] for a, b in
                     zip(off[:nb].tolist(), ends.tolist())])
    if not (torch.equal(one[1], lens) and torch.equal(one[0], seg)
            and torch.equal(one[3], got[3][:, :nb])):
        raise AssertionError("mq_scan on the stacked S2 group differs from "
                             "the first tile's lanes coded alone")
    emits = int((slots & 1).sum())
    nbytes_out = int(got[1].sum())
    b_ms, b_by, b_terms = bound(
        nbytes(slots, got[1], got[2], got[3]) + nbytes_out,
        OPS["mq_decision"] * emits + OPS["mq_byte"] * nbytes_out)
    print(f"kernel mq_scan on S2's stacked {h}x{w} group ({len(tiles)} tiles "
          f"x {nb} blocks; slots {tuple(slots.shape)}, {emits} coding, "
          f"{nbytes_out} segment bytes, pass-end byte-outs): {ms:.3f} ms a "
          f"call (CUDA events, mean of 5), bound {b_ms:.4f} ms by {b_by} "
          f"({b_terms}); the first tile's lanes alone equal the stacked "
          f"call's, on {card}")
    return tuple(slots.shape), ms, b_ms, b_by


def s2_global_check(img, params, tile_cs, dev, card):
    """Phase 20 (c): S2 with `rate_alloc="global"` through
    `encoder.encode`: every layer's cumulative packet bytes within its
    target plus 600 B of header slack (tests/test_pcrd.py's) or, where
    an earlier layer already holds more than the target, empty; the
    decode on the card no further from the source (MSE) than 1.001 x the
    per-tile allocation's; the simulator calls and the allocator's time.
    Returns (the launches by key, the global stream)."""
    import torch

    from grokimagecompression_tpu_torch.codestream import decoder, encoder
    from grokimagecompression_tpu_torch.codestream import pcrd
    from grokimagecompression_tpu_torch.native import t2_native
    from grokimagecompression_tpu_torch.ops import dwt, mq_dec
    gparams = dataclasses.replace(params, rate_alloc="global")
    alloc = Timed(pcrd.GlobalPCRDAllocator, "_allocate", sync=False)
    sims = Calls(t2_native.TileSim, "simulate", lambda *a: True)
    with encode_counts([alloc, sims]) as plain:
        t0 = time.perf_counter()
        cs = encoder.encode(img, gparams, device="cuda")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    counts = check_encode_counts(plain, "S2 global encode", ("mq", "dwt"))
    image_bytes = sum(c.data.size * c.prec for c in img.components) // 8
    targets = [int(image_bytes / r) for r in params.rates]
    res = {}
    for label, stream in (("tile", tile_cs), ("global", cs)):
        cum, empty = layer_bytes(stream)
        for layer, (b, t, e) in enumerate(zip(cum, targets, empty)):
            if b > t + 600 and not (layer and e):
                raise AssertionError(f"S2 {label}: layer {layer} holds {b} "
                                     f"B against its target {t}")
        with decode_counts() as dplain:
            out = decoder.decode(stream, device="cuda")
            torch.cuda.synchronize()
        check_decode_counts(dplain, f"S2 {label} decode", ("mq_dec", "dwt"))
        counts["mq_dec"] = counts.get("mq_dec", 0) + mq_dec.LAUNCHES["mq_dec"]
        counts["dwt"] += dwt.LAUNCHES["dwt"]
        res[label] = (len(stream), cum, empty, frame_mse(out, img))
    if res["global"][3] > 1.001 * res["tile"][3]:
        raise AssertionError(f"S2: the global allocation's MSE "
                             f"{res['global'][3]:.4f} is above 1.001 x the "
                             f"per-tile one's {res['tile'][3]:.4f}")
    print(f"S2 at ratios {params.rates} (targets {targets} B of packets), "
          + "; ".join(f"rate_alloc={k!r}: {n} B, cumulative packet bytes by "
                      f"layer {cum} (empty layers {e}), MSE {mse:.4f}"
                      for k, (n, cum, e, mse) in res.items())
          + f"; the global allocation {wall:.3f} s (encode), its "
          f"allocation {alloc.total():.3f} s on one thread, "
          f"{sims.n} simulator calls, on {card}")
    return counts, cs


def codec_baseline_check(c1_imgs, c2_imgs, dev, card):
    """Phase 20 (d): the codec at BASELINE widths on the card:
    `codec.compress` of each config-2 frame and `compress_batch` of the
    four at `ratio=(24, 48, 96)` against config2_pcrd_97.json (the
    defaults give its 6 resolutions and 64x64 blocks), `compress_batch`
    of the 64 config-1 frames with `ht=True` and without against
    config1_ht_lossless.json and config1_mq_lossless.json; MP/s (best of
    3) of `compress_batch` beside `encode_batch`'s; each preset's
    `Codec(preset=, container="jp2")` on config-2 frame 0 decoded through
    `decompress_image` on the card (the lossless presets to the source).
    Returns the launches by key."""
    import numpy as np
    import torch

    from grokimagecompression_tpu_torch import codec
    from grokimagecompression_tpu_torch.codestream import encoder
    from grokimagecompression_tpu_torch.core.params import (EncoderParams,
                                                            Transform)
    from grokimagecompression_tpu_torch.ops import dwt, ht_dec, mq_dec
    root = os.path.dirname(os.path.abspath(__file__))
    want = {}
    for key, path in (("c2", C2_DIGESTS), ("ht", DIGESTS),
                      ("mq", MQ_DIGESTS)):
        with open(os.path.join(root, path)) as f:
            want[key] = json.load(f)["streams"]
    ratio = (24.0, 48.0, 96.0)
    a2 = [codec.from_image(im) for im in c2_imgs]
    a1 = [codec.from_image(im) for im in c1_imgs]

    def sha(streams):
        return [hashlib.sha256(cs).hexdigest() for cs in streams]

    with encode_counts() as plain:
        got = {"compress (config 2)": ([codec.compress(a, ratio=ratio)
                                        for a in a2], "c2"),
               "compress_batch (config 2)": (codec.compress_batch(
                   a2, ratio=ratio), "c2"),
               "compress_batch (config 1, ht=True)": (codec.compress_batch(
                   a1, ht=True), "ht"),
               "compress_batch (config 1)": (codec.compress_batch(a1), "mq")}
        torch.cuda.synchronize()
    counts = check_encode_counts(plain, "codec at BASELINE widths",
                                 ("enc", "mq", "dwt"))
    for label, (streams, key) in got.items():
        if sha(streams) != want[key]:
            raise AssertionError(f"{label}: streams differ from the host "
                                 f"encoder's")
    print(f"codec at BASELINE widths: {', '.join(got)} equal the host "
          f"encoder's streams; launches {counts}")
    runs = (("config 2, ratios 24 / 48 / 96", c2_imgs,
             lambda: codec.compress_batch(a2, ratio=ratio),
             lambda: encoder.encode_batch(c2_imgs, EncoderParams(
                 numresolutions=6, transform=Transform.DWT_97, numlayers=3,
                 rates=ratio), device="cuda")),
            ("config 1, HT", c1_imgs,
             lambda: codec.compress_batch(a1, ht=True),
             lambda: encoder.encode_batch(c1_imgs, EncoderParams(
                 numresolutions=6, cblk_style=0x40), device="cuda")))
    for label, imgs, api, batch in runs:
        mpix = len(imgs) * imgs[0].xsiz * imgs[0].ysiz / 1e6
        t_api = best_of(3, api)
        t_batch = best_of(3, batch)
        print(f"{label}: codec.compress_batch {mpix / t_api:.2f} MP/s, "
              f"encoder.encode_batch {mpix / t_batch:.2f} MP/s (best of 3 "
              f"each, {len(imgs)} frames) on {card}")
    img = c2_imgs[0]
    src = codec.from_image(img)
    with decode_counts() as dplain:
        notes = []
        for preset in codec.PRESETS:
            c = codec.Codec(preset=preset, container="jp2")
            data = c.compress_image(img)
            out = codec.from_image(c.decompress_image(data))
            if out.shape != src.shape or (preset.startswith("lossless")
                                          and not np.array_equal(out, src)):
                raise AssertionError(f"preset {preset}: the JP2 file does "
                                     f"not decode to the source's shape, "
                                     f"or a lossless one not to the source")
            notes.append(f"{preset} {len(data)} B, MSE "
                         f"{float(((out - src) ** 2.0).mean()):.4f}")
        torch.cuda.synchronize()
    check_decode_counts(dplain, "preset JP2 decodes",
                        ("dec", "mq_dec", "dwt"))
    counts["dec"] = ht_dec.LAUNCHES["dec"]
    counts["mq_dec"] = mq_dec.LAUNCHES["mq_dec"]
    counts["dwt"] += dwt.LAUNCHES["dwt"]
    print("Codec(preset=, container='jp2') on config-2 frame 0, decoded "
          "through decompress_image on the card: " + "; ".join(notes))
    return counts


def full_params(name):
    """The EncoderParams of a FULL_CASES image: S1 5/3 HT lossless in
    1024^2 tiles, S2 config 2's MQ 9/7 coding in 512^2 tiles."""
    from grokimagecompression_tpu_torch.core.params import (EncoderParams,
                                                            Transform)
    if name == "S1":
        return EncoderParams(numresolutions=6, cblk_style=0x40,
                             tile_size=(S1_TILE, S1_TILE))
    return EncoderParams(numresolutions=6, transform=Transform.DWT_97,
                         numlayers=3, rates=(24.0, 48.0, 96.0),
                         tile_size=(S2_TILE, S2_TILE))


def image_encode_phase(mixed, batch_streams, c1_imgs, c2_imgs, dev, card):
    """Phase 20: the per-image encode (`encoder.encode`, same-plan tiles
    coded together), image-wide PCRD and the codec's encode API: (a) the
    small cases and the mixed `decompress_batch`, (b) S1 and (c) S2
    against phase 19's `encode_batch([img])` streams (`batch_streams`),
    S2 with `rate_alloc="global"`, (d) the codec at BASELINE widths.
    Returns the launches of its encodes and decodes by LAUNCHES key and
    S2's global stream (phase 23's)."""
    t0 = time.perf_counter()
    launches = {"enc": 0, "mq": 0, "dwt": 0, "dec": 0, "mq_dec": 0}

    def add(counts):
        for k, v in counts.items():
            launches[k] += v

    add(image_encode_small_check(mixed, dev))
    s1 = s1_frame()
    counts, _ = image_encode_case("S1", s1, full_params("S1"),
                                  batch_streams["S1"], dev, card, "enc")
    add(counts)
    del s1
    s2 = s2_frame()
    counts, s2_cs = image_encode_case("S2", s2, full_params("S2"),
                                      batch_streams["S2"], dev, card, "mq")
    add(counts)
    stacked_scan_check(s2, full_params("S2"), dev, card)
    counts, s2_global_cs = s2_global_check(s2, full_params("S2"), s2_cs, dev,
                                           card)
    add(counts)
    del s2
    add(codec_baseline_check(c1_imgs, c2_imgs, dev, card))
    print(f"phase 20 (per-image encode, global PCRD, codec): "
          f"{time.perf_counter() - t0:.1f} s on {card}; launches {launches}")
    return launches, s2_global_cs


@contextlib.contextmanager
def cli_counts(launches, what, want):
    """Inside a `with` block every kernel's launch count set to 0 and the
    plain versions of the encode and decode routes counted
    (`encode_counts`, `decode_counts`); after it, fail unless every kernel
    of `want` was launched, no plain version ran and the host prepass was
    not called, and add the launches to `launches` by LAUNCHES key."""
    from grokimagecompression_tpu_torch.native import ht_prepass
    from grokimagecompression_tpu_torch.ops import (dwt, ht_dec, ht_enc,
                                                    mq_dec, mq_scan)
    with encode_counts() as enc_plain, decode_counts() as dec_plain:
        yield
    counts = {"enc": ht_enc.LAUNCHES["enc"], "mq": mq_scan.LAUNCHES["mq"],
              "dwt": dwt.LAUNCHES["dwt"], "dec": ht_dec.LAUNCHES["dec"],
              "mq_dec": mq_dec.LAUNCHES["mq_dec"]}
    if any(c.n for c in enc_plain + dec_plain) or ht_prepass.CALLS["prepass"]:
        raise AssertionError(f"{what}: a plain version ran or the host "
                             f"prepass was called")
    if any(counts[k] < 1 for k in want):
        raise AssertionError(f"{what}: a kernel of {want} was not launched "
                             f"({counts})")
    for k, v in counts.items():
        launches[k] += v


def tool_run(tool, argv, timers):
    """One run of a CLI tool's `main(argv)` with `timers` = (stages,
    inner), each {name: Timed (sync off)}: the stages of the run and the
    stages inside its library call. Returns (seconds, {stage: seconds},
    {inner stage: seconds}), the stages' "rest" the seconds outside them
    (argument parsing, the stream's file write or read, the colour
    policy). Fails unless it exits 0."""
    import torch
    outer, inner = timers
    for t in list(outer.values()) + list(inner.values()):
        t.calls.clear()
    t0 = time.perf_counter()
    with contextlib.ExitStack() as stack:
        for t in list(outer.values()) + list(inner.values()):
            stack.enter_context(t)
        rc = tool.main(list(argv))
    torch.cuda.synchronize()
    sec = time.perf_counter() - t0
    if rc != 0:
        raise AssertionError(f"{tool.__name__} {argv}: exit code {rc}")
    stages = {k: t.total() for k, t in outer.items()}
    stages["rest"] = sec - sum(stages.values())
    inner_s = {k: t.total() for k, t in inner.items()}
    for t in list(outer.values()) + list(inner.values()):
        t.calls.clear()
    return sec, stages, inner_s


def fmt_stages(stages, inner):
    """The stages of `tool_run`, the library call's inside parentheses."""
    return ", ".join(f"{k} {v:.3f} s" for k, v in stages.items()) + \
        " (the library call: " + ", ".join(
            f"{k} {v:.3f} s" for k, v in inner.items()) + ")"


def cli_phase(c1_imgs, c2_imgs, s1_cs, s1_refs, bench, dev, card):
    """Phase 21: the command-line tools (`cli.compress`, `cli.decompress`,
    `cli.dump`, run in this process through their `main`) on the card,
    every file in a temporary directory removed afterwards: (a) every
    CLI_CASES entry on `cli_inputs` against CLI_DIGESTS (--ht-refinement,
    which the port codes now, is phase 25 (e)); (b) config 1's
    64 frames as PGM files through directory mode with HT and with MQ,
    each stream against its digest file, decoded back to the sources, and
    config 2's 4 frames as PPM files at ratios 24 / 48 / 96 against
    config2_pcrd_97.json, decoded to the host decoder's pixels, frame 0
    also to PNG and to a deflate TIFF read back equal; seconds, MP/s and
    stages beside `bench` (encode_batch / decode_batch MP/s of phases 4-9
    on the same frames); (c) S1 as a 16-bit PGM through grk_compress,
    equal to `s1_cs` (phase 19's stream, which phase 20's `encode` equals),
    and its whole, reduce-2 and W1 decodes through grk_decompress equal
    to `s1_refs` (phase 19's outputs), each step's file I/O and library
    call timed. No plain version runs. Returns the launches by LAUNCHES
    key."""
    import shutil
    import tempfile

    import numpy as np

    from grokimagecompression_tpu_torch.cli import (common, compress,
                                                    decompress, dump)
    from grokimagecompression_tpu_torch.codestream import decoder, encoder
    from grokimagecompression_tpu_torch.core.params import EncoderParams
    from grokimagecompression_tpu_torch.io import png, pnm, tiff
    from grokimagecompression_tpu_torch.models import fused_decode, fused_encode
    t_phase = time.perf_counter()
    launches = {"enc": 0, "mq": 0, "dwt": 0, "dec": 0, "mq_dec": 0}
    on_card = ["--torch-device", str(dev)]
    enc_timers = (
        {"file read": Timed(common, "read_image", sync=False),
         "encoder.encode": Timed(encoder, "encode", sync=False)},
        {"plans and coders": Timed(encoder, "_tile_encoders", sync=False),
         "upload and device submit": Timed(fused_encode,
                                           "encode_tile_submit", sync=False),
         "fetch and host slice": Timed(fused_encode, "encode_tile_collect",
                                       sync=False),
         "T2 and stream": Timed(encoder, "write_codestream", sync=False)})
    dec_timers = (
        {"decoder.decode": Timed(decoder, "decode", sync=False),
         "file write": Timed(common, "write_image", sync=False)},
        {"T2": Timed(decoder, "_parse_frame", sync=False),
         "lane packing": Timed(fused_decode, "prepare_chunk", sync=False),
         "upload": Timed(fused_decode, "upload", sync=False),
         "device decode": Timed(fused_decode._FusedDecoder, "forward",
                                sync=False),
         "fetch": Timed(fused_decode, "decode_tiles_collect", sync=False)})
    tmp = tempfile.mkdtemp(prefix="chip_smoke_cli_")
    try:
        # (a) the small cases, bytes only
        d = os.path.join(tmp, "small")
        os.makedirs(d)
        cli_inputs(d)
        with open(CLI_DIGESTS) as f:
            want = json.load(f)
        got = {}
        for r, _, fs in os.walk(d):
            for name in fs:
                with open(os.path.join(r, name), "rb") as f:
                    got[os.path.relpath(os.path.join(r, name), d)] = \
                        hashlib.sha256(f.read()).hexdigest()
        if got != want["inputs"]:
            raise AssertionError("the CLI inputs differ from the digest "
                                 "file's: numpy makes other inputs here")

        def plt_stream(path):
            return encoder.encode(pnm.read_pnm(path), EncoderParams(
                numresolutions=3, tile_size=(32, 32), plt_markers=True,
                tlm_markers=True), device=dev)
        t0 = time.perf_counter()
        with cli_counts(launches, "phase 21 (a)",
                        ("enc", "mq", "dwt", "dec", "mq_dec")):
            got = run_cli_cases(d, {"compress": compress,
                                    "decompress": decompress,
                                    "dump": dump}, extra=on_card,
                                plt_stream=plt_stream)
        bad = sorted(k for k in set(got) | set(want["cases"])
                     if got.get(k) != want["cases"].get(k))
        if bad:
            raise AssertionError(f"CLI cases {bad} differ from the reference "
                                 f"tools' outputs")
        print(f"phase 21 (a): {len(got)} tool runs on {len(want['inputs'])} "
              f"seeded inputs equal the reference tools' outputs "
              f"({sum(len(v) for v in got.values())} files) in "
              f"{time.perf_counter() - t0:.1f} s; launches {launches} on "
              f"{card}")

        # (b) the BASELINE frames through directory mode
        c1_in = os.path.join(tmp, "c1")
        os.makedirs(c1_in)
        for i, im in enumerate(c1_imgs):
            pnm.write_pnm(os.path.join(c1_in, f"f{i:02d}.pgm"), im)
        mpix = len(c1_imgs) * SIZE * SIZE / 1e6
        for label, flags, path, kernel, dkernel in (
                ("HT", ["-M", "64"], DIGESTS, "enc", "dec"),
                ("MQ", [], MQ_DIGESTS, "mq", "mq_dec")):
            with open(path) as f:
                streams = json.load(f)["streams"]
            out = os.path.join(tmp, f"c1_{label}")
            with cli_counts(launches, f"phase 21 config-1 {label} compress",
                            (kernel, "dwt")):
                sec, stages, inner = tool_run(compress, [
                    "-y", c1_in, "-O", "J2K", "-a", out, "-n", "6", "-C",
                    "grokimagecompression_tpu"] + flags + on_card,
                    enc_timers)
            for i in range(len(c1_imgs)):
                with open(os.path.join(out, f"f{i:02d}.j2k"), "rb") as f:
                    if hashlib.sha256(f.read()).hexdigest() != streams[i]:
                        raise AssertionError(f"grk_compress config-1 "
                                             f"{label} frame {i}: stream "
                                             f"differs from the digest file")
            print(f"grk_compress -y (config 1, {label}, "
                  f"{len(c1_imgs)} frames): streams equal {path}; "
                  f"{sec:.3f} s, {mpix / sec:.2f} MP/s beside encode_batch's "
                  f"{bench[f'config-1 {label} encode_batch']:.2f}; stages "
                  f"{fmt_stages(stages, inner)} on {card}")
            dec = os.path.join(tmp, f"c1_{label}_dec")
            with cli_counts(launches, f"phase 21 config-1 {label} "
                            f"decompress", (dkernel, "dwt")):
                sec, stages, inner = tool_run(decompress, [
                    "-y", out, "-a", dec, "-O", "pgm"] + on_card, dec_timers)
            for i, im in enumerate(c1_imgs):
                back = pnm.read_pnm(os.path.join(dec, f"f{i:02d}.pgm"))
                if not np.array_equal(back.components[0].data,
                                      im.components[0].data):
                    raise AssertionError(f"grk_decompress config-1 {label} "
                                         f"frame {i}: not the source")
            print(f"grk_decompress -y (config 1, {label}): the sources; "
                  f"{sec:.3f} s, {mpix / sec:.2f} MP/s beside decode_batch's "
                  f"{bench[f'config-1 {label} decode_batch']:.2f}; stages "
                  f"{fmt_stages(stages, inner)} on {card}")
            shutil.rmtree(out)
            shutil.rmtree(dec)
        shutil.rmtree(c1_in)

        c2_in = os.path.join(tmp, "c2")
        os.makedirs(c2_in)
        for i, im in enumerate(c2_imgs):
            pnm.write_pnm(os.path.join(c2_in, f"f{i}.ppm"), im)
        c2_mpix = len(c2_imgs) * C2_SIZE * C2_SIZE / 1e6
        with open(C2_DIGESTS) as f:
            streams = json.load(f)["streams"]
        with open(C2_DEC_DIGESTS) as f:
            decoded = json.load(f)["decoded"]
        out = os.path.join(tmp, "c2_j2k")
        with cli_counts(launches, "phase 21 config-2 compress",
                        ("mq", "dwt")):
            sec, stages, inner = tool_run(compress, [
                "-y", c2_in, "-O", "J2K", "-a", out, "-n", "6", "-I", "-r",
                "24,48,96", "-C", "grokimagecompression_tpu"] + on_card,
                enc_timers)
        for i in range(len(c2_imgs)):
            with open(os.path.join(out, f"f{i}.j2k"), "rb") as f:
                if hashlib.sha256(f.read()).hexdigest() != streams[i]:
                    raise AssertionError(f"grk_compress config-2 frame {i}: "
                                         f"stream differs from the digest "
                                         f"file")
        print(f"grk_compress -y (config 2, -I -r 24,48,96, {len(c2_imgs)} "
              f"frames): streams equal {C2_DIGESTS}; {sec:.3f} s, "
              f"{c2_mpix / sec:.2f} MP/s beside encode_batch's "
              f"{bench['config-2 encode_batch']:.2f} (2-frame chunks); "
              f"stages {fmt_stages(stages, inner)} on {card}")
        dec = os.path.join(tmp, "c2_dec")
        with cli_counts(launches, "phase 21 config-2 decompress",
                        ("mq_dec", "dwt")):
            sec, stages, inner = tool_run(decompress, [
                "-y", out, "-a", dec, "-O", "ppm"] + on_card, dec_timers)
        for i in range(len(c2_imgs)):
            back = pnm.read_pnm(os.path.join(dec, f"f{i}.ppm"))
            if frame_digest(back) != decoded[i]:
                raise AssertionError(f"grk_decompress config-2 frame {i}: "
                                     f"not the host decoder's pixels")
            if i == 0:
                frame0 = back
        print(f"grk_decompress -y (config 2): the host decoder's pixels; "
              f"{sec:.3f} s, {c2_mpix / sec:.2f} MP/s beside decode_batch's "
              f"{bench['config-2 decode_batch']:.2f}; stages "
              f"{fmt_stages(stages, inner)} on {card}")
        for name, extra, read in (("f0.png", [], png.read_png),
                                  ("f0.tif", ["-c", "8"], tiff.read_tiff)):
            dst = os.path.join(tmp, name)
            with cli_counts(launches, f"phase 21 config-2 {name}",
                            ("mq_dec", "dwt")):
                sec, stages, inner = tool_run(decompress, [
                    "-i", os.path.join(out, "f0.j2k"), "-o", dst] + extra
                    + on_card, dec_timers)
            back = read(dst)
            if frame_digest(back) != frame_digest(frame0):
                raise AssertionError(f"grk_decompress config-2 frame 0 to "
                                     f"{name}: read back differs")
            print(f"grk_decompress config-2 frame 0 to {name} "
                  f"{' '.join(extra)}: read back equal; {sec:.3f} s, stages "
                  f"{fmt_stages(stages, inner)}")
        shutil.rmtree(c2_in)
        del frame0

        # (c) S1 through the tools
        s1 = s1_frame()
        src = os.path.join(tmp, "s1.pgm")
        t0 = time.perf_counter()
        pnm.write_pnm(src, s1)
        write_s = time.perf_counter() - t0
        j2k = os.path.join(tmp, "s1.j2k")
        with cli_counts(launches, "phase 21 S1 compress", ("enc", "dwt")):
            sec, stages, inner = tool_run(compress, [
                "-i", src, "-o", j2k, "-n", "6", "-M", "64", "-t",
                f"{S1_TILE},{S1_TILE}", "-C", "grokimagecompression_tpu"]
                + on_card, enc_timers)
        with open(j2k, "rb") as f:
            if f.read() != s1_cs:
                raise AssertionError("grk_compress of S1 differs from phase "
                                     "19's and 20's stream")
        mp = S1_SIZE * S1_SIZE / 1e6
        print(f"S1 ({S1_SIZE}^2 12-bit, {os.path.getsize(src)} B PGM written "
              f"in {write_s:.3f} s): grk_compress -n 6 -M 64 -t "
              f"{S1_TILE},{S1_TILE} equals phase 19's and 20's stream "
              f"({len(s1_cs)} B); {sec:.3f} s, {mp / sec:.2f} MP/s; stages "
              f"{fmt_stages(stages, inner)} on {card}")
        w1 = FULL_CASES[0][3]
        for label, extra in (("full", []), ("reduce 2", ["-r", "2"]),
                             ("W1", ["-d", ",".join(map(str, w1))])):
            dst = os.path.join(tmp, "s1_out.pgm")
            with cli_counts(launches, f"phase 21 S1 decompress {label}",
                            ("dec",) + (("dwt",) if label != "W1" else ())):
                sec, stages, inner = tool_run(decompress, [
                    "-i", j2k, "-o", dst] + extra + on_card, dec_timers)
            t0 = time.perf_counter()
            back = pnm.read_pnm(dst)
            read_s = time.perf_counter() - t0
            if plane_md5(back) != s1_refs[label]:
                raise AssertionError(f"grk_decompress of S1 ({label}) "
                                     f"differs from phase 19's output")
            if label == "full" and not np.array_equal(
                    back.components[0].data, s1.components[0].data):
                raise AssertionError("grk_decompress of S1 is not the "
                                     "source")
            c0 = back.components[0].data
            print(f"S1 grk_decompress {label} ({c0.shape[1]}x{c0.shape[0]} "
                  f"out): equals phase 19's output"
                  f"{' and the source' if label == 'full' else ''}; "
                  f"{sec:.3f} s; stages {fmt_stages(stages, inner)}; read back "
                  f"{read_s:.3f} s on {card}")
            os.unlink(dst)
            del back
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"phase 21 (the command-line tools): "
          f"{time.perf_counter() - t_phase:.1f} s on {card}; launches "
          f"{launches}")
    return launches


def tile_crop(img, tr):
    """The samples of `img` (origin 0) inside the canvas rect `tr`, by
    component (no subsampling)."""
    return [c.data[tr.y0:tr.y1, tr.x0:tr.x1] for c in img.components]


def stream_check(dev, card, launches):
    """Phase 22 (a): S1 through `stream.StreamEncoder` tile by tile into a
    file, every tile-part equal to `encoder.encode`'s with TLM markers,
    W1's four tiles and the corner tile through `StreamDecoder.
    decode_tile` equal to crops of the source, the whole `decode`
    lossless; seconds a tile, launches and peak device memory beside
    `encode`'s."""
    import tempfile

    import numpy as np
    import torch

    from grokimagecompression_tpu_torch.codestream import (decoder, encoder,
                                                           stream)
    from grokimagecompression_tpu_torch.core.geometry import tile_rect
    s1 = s1_frame()
    params = full_params("S1")
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "s1.j2k")
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        counts = {k: 0 for k in launches}
        with cli_counts(counts, "S1 StreamEncoder", ("enc", "dwt")):
            t0 = time.perf_counter()
            with stream.StreamEncoder(path, s1, params, device=dev) as se:
                for t in range(se.numtiles):
                    se.write_image_tile(t, s1)
            torch.cuda.synchronize()
            sec = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() - base
        for k, v in counts.items():
            launches[k] += v
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        enc_counts = {k: 0 for k in counts}
        with cli_counts(enc_counts, "S1 encode", ("enc", "dwt")):
            t0 = time.perf_counter()
            want = encoder.encode(s1, dataclasses.replace(
                params, tlm_markers=True), device=dev)
            torch.cuda.synchronize()
            enc_sec = time.perf_counter() - t0
        enc_peak = torch.cuda.max_memory_allocated() - base
        for k, v in enc_counts.items():
            launches[k] += v
        with open(path, "rb") as f:
            data = f.read()
        parts = [[(tp.tile_index, tp.body) for tp in decoder.iter_tile_parts(
            cs, decoder.read_header(cs).main_header_end)]
            for cs in (data, want)]
        if parts[0] != parts[1] or len(parts[0]) != se.numtiles:
            raise AssertionError("S1 StreamEncoder: tile-parts differ from "
                                 "encoder.encode's")
        print(f"S1 StreamEncoder: {se.numtiles} tiles in {sec:.3f} s "
              f"({1e3 * sec / se.numtiles:.1f} ms a tile, "
              f"{S1_SIZE * S1_SIZE / 1e6 / sec:.2f} MP/s), "
              f"{len(se._encoders)} plans, launches {counts}, peak device "
              f"memory "
              f"{peak / 1e9:.3f} GB; encoder.encode: {enc_sec:.3f} s, "
              f"launches {enc_counts}, peak {enc_peak / 1e9:.3f} GB; every "
              f"tile-part equal, the files "
              f"{'equal' if data == want else 'differ in the main header'}"
              f" ({len(data)} B)")
        s = decoder.read_header(data).siz
        trs = [tile_rect(t, s.xsiz, s.ysiz, s.xosiz, s.yosiz, s.xtsiz,
                         s.ytsiz, s.xtosiz, s.ytosiz)
               for t in range(se.numtiles)]
        w1 = FULL_CASES[0][3]
        tiles = [t for t, tr in enumerate(trs)
                 if tr.x0 < w1[2] and tr.x1 > w1[0] and tr.y0 < w1[3]
                 and tr.y1 > w1[1]] + [len(trs) - 1]
        dec_counts = {k: 0 for k in counts}
        with cli_counts(dec_counts, "S1 StreamDecoder", ("dec", "dwt")):
            with stream.StreamDecoder(path, device=dev) as sd:
                t0 = time.perf_counter()
                for t in tiles:
                    got = sd.decode_tile(t)
                    for g, w in zip(got.components, tile_crop(s1, trs[t])):
                        if not np.array_equal(g.data, w):
                            raise AssertionError(f"S1 StreamDecoder tile {t} "
                                                 f"differs from the source")
                torch.cuda.synchronize()
                tile_sec = time.perf_counter() - t0
                t0 = time.perf_counter()
                whole = sd.decode()
                torch.cuda.synchronize()
                whole_sec = time.perf_counter() - t0
        if not np.array_equal(whole.components[0].data,
                              s1.components[0].data):
            raise AssertionError("S1 StreamDecoder.decode is not lossless")
        for k, v in dec_counts.items():
            launches[k] += v
    print(f"S1 StreamDecoder: tiles {tiles} (W1's four and the corner) "
          f"equal the source crops in {tile_sec:.3f} s, the whole image "
          f"lossless in {whole_sec:.3f} s; launches {dec_counts} on {card}")


def deepest_lanes(group, n, dev):
    """The `n` lanes with the most bit-planes of an MQ lane group's host
    arrays (`mq_dec.pack_lanes`: data, off, nbps, npas, ori), in lane
    order, repacked, on `dev`. Lanes of one plane count start at one
    global pass, so the plain decoder runs few passes for them."""
    import numpy as np
    import torch

    from grokimagecompression_tpu_torch.ops import mq_dec
    data, off, nbps, npas, ori = group[:5]
    idx = np.sort(np.argsort(-nbps.astype(np.int64), kind="stable")[:n])
    sub = mq_dec.pack_lanes([data[off[i]:off[i + 1]].tobytes() for i in idx],
                            ori[idx], nbps[idx], npas[idx])
    return tuple(torch.from_numpy(a).to(dev) for a in sub)


def roi_kernel_check(enc, frame, cs, dev):
    """Phase 22 (b): the MQ coder on 64 lanes of an ROI frame's 64x64 slot
    stream cut to its leading planes (CIN_PLAIN_MQ_DECISIONS decisions in
    the deepest lane), and the MQ decoder on the 64 lanes of the ROI
    stream's 64x64 lane group with the most bit-planes (Kmax + shift on
    component 0), cut to their first 2 passes, each against its plain
    version."""
    import torch

    from grokimagecompression_tpu_torch.codestream import decoder
    from grokimagecompression_tpu_torch.models import (fused_decode,
                                                       fused_encode)
    from grokimagecompression_tpu_torch.ops import (mq_dec, mq_dec_torch,
                                                    mq_scan, mq_torch)
    args = fused_encode.upload_tile([c.data for c in frame.components], enc)
    for (h, w, _), gin in zip(enc.plan.groups, enc.group_inputs(*args)):
        if (h, w) != (64, 64):
            continue
        _, slots, *_ = enc.group_slots(*gin)
        spans = mq_torch.pass_spans_padded(h, w)
        tp = sum(spans)
        npl = slots.shape[0] // tp
        lanes = torch.linspace(0, slots.shape[1] - 1, 64,
                               device=slots.device).round().long()
        sub = slots[:, lanes]
        coded = (sub.view(npl, tp, -1) & 1).sum(dim=1).cumsum(0).amax(dim=1)
        keep = max(1, int((coded <= CIN_PLAIN_MQ_DECISIONS).sum()))
        sub = sub[:keep * tp].contiguous()
        got = mq_scan.mq_scan(sub, spans)
        t0 = time.perf_counter()
        want = mq_torch.mq_scan_plain(sub, spans)
        torch.cuda.synchronize()
        plain_s = time.perf_counter() - t0
        if not all(torch.equal(g, wv) for g, wv in zip(got, want)):
            raise AssertionError("mq_scan differs from the plain version on "
                                 "the ROI frame's 64x64 group")
        print(f"kernel mq_scan on the ROI frame's 64x64 group (64 of "
              f"{slots.shape[1]} lanes, {keep} of {npl} planes): bit-exact "
              f"with plain (plain {plain_s:.3f} s)")
        del slots, sub
    hdr, trs, parsed = decoder.parse_batch([cs])
    (plan,) = decoder.tile_groups(hdr, trs, parsed)
    arrays = fused_decode.prepare_chunk(
        plan, [fused_decode.jobs_by_block(*parsed[0][0][0][:3])])
    for (w, h, _), group in zip(plan.groups, arrays):
        if (w, h) != (64, 64):
            continue
        data, off, nbps, npas, ori = deepest_lanes(group, 64, dev)
        a = (data, off, nbps, torch.clamp(npas, max=2), ori, w, h)
        got = mq_dec.decode_group(*a, with_stats=True)
        t0 = time.perf_counter()
        want = mq_dec_torch.decode_group_plain(*a, with_stats=True)
        torch.cuda.synchronize()
        plain_s = time.perf_counter() - t0
        if not all(torch.equal(g, wv) for g, wv in zip(got, want)):
            raise AssertionError("mq_dec_group differs from the plain "
                                 "version on the ROI stream's 64x64 group")
        kmax = max(j[7] for j in parsed[0][0][0][0])
        print(f"kernel mq_dec_group on the ROI stream's 64x64 group (the 64 "
              f"of {group[2].shape[0]} lanes with the most bit-planes, "
              f"{int(nbps.min())}-{int(nbps.max())}; Kmax up to {kmax} with "
              f"the shift; the first 2 passes): bit-exact with plain (plain "
              f"{plain_s:.3f} s)")
    torch.cuda.empty_cache()


def route_cases_check(frame, want, dev, card, launches):
    """Phase 22 (b, c): config-2 frame 0 at each ROUTE_CASES entry (ROI at
    shift 6 and at the largest shift within 30 planes, a custom MCT with
    MQ at ratios 24 / 48 / 96 and with HT) through `encoder.encode`, each
    stream against ROUTE_DIGESTS, its decode through `decode_batch`
    against the host decoder's pixel digests; the MQ kernels against
    their plain versions on the ROI frame."""
    import torch

    from grokimagecompression_tpu_torch.codestream import decoder, encoder
    from grokimagecompression_tpu_torch.core import params as port_params
    if frame_digest(frame) != want["frame"]:
        raise AssertionError("config-2 frame 0 differs from ROUTE_DIGESTS'")
    for name, case in ROUTE_CASES.items():
        p = route_params(port_params, name)
        ht = bool(p.cblk_style & 0x40)
        coder = ("enc",) if ht else ("mq",)
        counts = {k: 0 for k in launches}
        with cli_counts(counts, f"{name} encode", coder + ("dwt",)):
            t0 = time.perf_counter()
            cs = encoder.encode(frame, p, device=dev)
            torch.cuda.synchronize()
            enc_sec = time.perf_counter() - t0
        if hashlib.sha256(cs).hexdigest() != want["cases"][name]["stream"]:
            raise AssertionError(f"{name}: stream differs from the host "
                                 f"encoder's ({len(cs)} B)")
        with cli_counts(counts, f"{name} decode",
                          ("dec" if ht else "mq_dec", "dwt")):
            t0 = time.perf_counter()
            (out,) = decoder.decode_batch([cs], device=dev)
            torch.cuda.synchronize()
            dec_sec = time.perf_counter() - t0
        if frame_digest(out) != want["cases"][name]["pixels"]:
            raise AssertionError(f"{name}: decode differs from the host "
                                 f"decoder's pixels")
        for k, v in counts.items():
            launches[k] += v
        what = (f"ROI comp 0 U={p.roi_shift}" if p.roi_shift
                else "custom MCT")
        print(f"{name} ({what}, {'HT' if ht else 'MQ'}): {len(cs)} B equal "
              f"to the host "
              f"encoder's, encode {enc_sec:.3f} s, decode {dec_sec:.3f} s to "
              f"the host decoder's pixels (MSE {frame_mse(out, frame):.4f}); "
              f"launches {counts} on {card}")
        if name == "roi6":
            p_, siz, cod, qcd, cod_comp, trs = encoder._coding(frame, p)
            (enc,) = encoder._tile_encoders(p_, siz, cod, qcd, cod_comp,
                                            trs, dev, True)
            roi_kernel_check(enc, frame, cs, dev)
            del enc
        del cs, out
        torch.cuda.empty_cache()


def override_check(want, dev, card, launches):
    """Phase 22 (d): the override streams. At small size
    (`route_small_frame`) the port's `override_stream` and `coc_stream`
    made on the card against ROUTE_DIGESTS' streams, and their decodes
    at ROUTE_SMALL_REQUESTS against the host decoder's pixel digests. At
    full size S2 (4096^2 RGB, 512^2 tiles, config 2's MQ 9/7 coding at a
    fixed step) with a tile-part COD (32x32 blocks, RPCL) and QCD (base
    step 2) in every fourth tile: the decode on the card equals, tile by
    tile, the card's decodes of the two streams it was spliced from; and
    config-2 frame 0 with component 1 on 5/3 at 5 resolutions (COC, QCC):
    component 1 lossless, components 0 and 2 equal to the decode of the
    same coding without the COC."""
    import numpy as np
    import torch

    from grokimagecompression_tpu_torch.codestream import decoder, encoder
    from grokimagecompression_tpu_torch.core import params as port_params
    from grokimagecompression_tpu_torch.core.geometry import tile_rect
    from grokimagecompression_tpu_torch.core.params import DecoderParams
    small = route_small_frame()
    if frame_digest(small) != want["small_frame"]:
        raise AssertionError("the small route frame differs from "
                             "ROUTE_DIGESTS'")
    base, over = override_params(port_params, ROUTE_SMALL)
    noroute = port_params.EncoderParams(mct=port_params.MCT.NONE, **dict(
        ROUTE_SMALL, transform=port_params.Transform.DWT_97))
    counts = {k: 0 for k in launches}
    with cli_counts(counts, "small override and COC streams",
                      ("mq", "dwt", "mq_dec")):
        made = {"override": override_stream(
            encoder.encode(small, base, device=dev),
            encoder.encode(small, over, device=dev)),
            "coc": coc_stream(small, noroute, dev)}
        for name, cs in made.items():
            w = want["small"][name]
            if hashlib.sha256(cs).hexdigest() != w["stream"]:
                raise AssertionError(f"small {name} stream differs from "
                                     f"ROUTE_DIGESTS'")
            for kw in ROUTE_SMALL_REQUESTS:
                got = decoder.decode(cs, DecoderParams(**kw), device=dev)
                if frame_digest(got) != w["pixels"][request_name(kw)]:
                    raise AssertionError(f"small {name} stream at "
                                         f"{request_name(kw)}: pixels differ "
                                         f"from the host decoder's")
    for k, v in counts.items():
        launches[k] += v
    print(f"small override and COC streams ({small.xsiz}x{small.ysiz} RGB): "
          f"equal to the digests' streams, decoded whole and at "
          f"{request_name(ROUTE_SMALL_REQUESTS[1])} to the host decoder's "
          f"pixels; launches {counts}")

    s2 = s2_frame()
    base, over = override_params(port_params, dict(
        numresolutions=6, transform="DWT_97", tile_size=(S2_TILE, S2_TILE)))
    counts = {k: 0 for k in launches}
    with cli_counts(counts, "S2 override streams",
                      ("mq", "dwt", "mq_dec")):
        t0 = time.perf_counter()
        a = encoder.encode(s2, base, device=dev)
        b = encoder.encode(s2, over, device=dev)
        torch.cuda.synchronize()
        enc_sec = time.perf_counter() - t0
        cs = override_stream(a, b)
        t0 = time.perf_counter()
        (got,) = decoder.decode_batch([cs], device=dev)
        torch.cuda.synchronize()
        dec_sec = time.perf_counter() - t0
        plain = [decoder.decode_batch([x], device=dev)[0] for x in (a, b)]
    s = decoder.read_header(cs).siz
    ntiles = (S2_SIZE // S2_TILE) ** 2
    nover = 0
    for t in range(ntiles):
        tr = tile_rect(t, s.xsiz, s.ysiz, s.xosiz, s.yosiz, s.xtsiz, s.ytsiz,
                       s.xtosiz, s.ytosiz)
        src = plain[1 if t % OVERRIDE_EVERY == 0 else 0]
        nover += t % OVERRIDE_EVERY == 0
        for g, w in zip(tile_crop(got, tr), tile_crop(src, tr)):
            if not np.array_equal(g, w):
                raise AssertionError(f"S2 override stream tile {t} differs "
                                     f"from its source stream's decode")
    for k, v in counts.items():
        launches[k] += v
    print(f"S2 with a tile-part COD and QCD in {nover} of {ntiles} tiles "
          f"({len(cs)} B): the two codings {enc_sec:.3f} s, the spliced "
          f"stream's decode {dec_sec:.3f} s, every tile equal to its "
          f"coding's decode; launches {counts} on {card}")
    del s2, a, b, cs, got, plain

    frame = config2_frames(1)[0]
    params = port_params.EncoderParams(
        numresolutions=6, transform=port_params.Transform.DWT_97,
        mct=port_params.MCT.NONE)
    counts = {k: 0 for k in launches}
    with cli_counts(counts, "config-2 COC stream", ("mq", "dwt", "mq_dec")):
        t0 = time.perf_counter()
        cs = coc_stream(frame, params, dev)
        torch.cuda.synchronize()
        enc_sec = time.perf_counter() - t0
        t0 = time.perf_counter()
        (got,) = decoder.decode_batch([cs], device=dev)
        torch.cuda.synchronize()
        dec_sec = time.perf_counter() - t0
        (ref,) = decoder.decode_batch([encoder.encode(frame, params,
                                                      device=dev)],
                                      device=dev)
    if not np.array_equal(got.components[COC_COMP].data,
                          frame.components[COC_COMP].data):
        raise AssertionError("config-2 COC stream: component 1 (5/3) is not "
                             "lossless")
    for c in range(3):
        if c != COC_COMP and not np.array_equal(got.components[c].data,
                                                ref.components[c].data):
            raise AssertionError(f"config-2 COC stream: component {c} "
                                 f"differs from the coding without the COC")
    for k, v in counts.items():
        launches[k] += v
    print(f"config-2 frame 0 with component 1 on 5/3 at 5 resolutions (COC, "
          f"QCC; {len(cs)} B): coded in {enc_sec:.3f} s, decoded in "
          f"{dec_sec:.3f} s in two component groups, component 1 lossless, "
          f"0 and 2 equal to the coding without the COC; launches {counts} "
          f"on {card}")


def route_phase(dev, card):
    """Phase 22: the streaming API (a) and the requests the reference
    codes on its host tile path, on the port's kernels: ROI and a custom
    MCT (b, c), tile-part overrides and a per-component COC (d). Returns
    the launches of its main-path runs by LAUNCHES key."""
    t0 = time.perf_counter()
    launches = {"enc": 0, "mq": 0, "dwt": 0, "dec": 0, "mq_dec": 0}
    with open(ROUTE_DIGESTS) as f:
        want = json.load(f)
    parts = []
    for label, check in (
            ("(a)", lambda: stream_check(dev, card, launches)),
            ("(b, c)", lambda: route_cases_check(
                config2_frames(1)[0], want, dev, card, launches)),
            ("(d)", lambda: override_check(want, dev, card, launches))):
        t = time.perf_counter()
        check()
        parts.append(f"{label} {time.perf_counter() - t:.1f} s")
    print(f"phase 22 (stream API, ROI, custom MCT, overrides, COC): "
          f"{time.perf_counter() - t0:.1f} s ({', '.join(parts)}) on {card}; "
          f"launches {launches}")
    return launches


# multi-device coding (phase 23): the group's timeout (a collective that
# waits longer raises), and each worker process's limit
MH_GROUP_TIMEOUT_S = 120
MH_WORKER_S = 300


def mh_cases():
    """Phase 23 (c)'s images and EncoderParams by name: config-2 frame 0 in
    512^2 tiles, MQ 9/7 at ratios 24 / 48 / 96 with image-wide PCRD, and
    S1 (HT lossless)."""
    from grokimagecompression_tpu_torch.core.params import (EncoderParams,
                                                            Transform)
    return (("config-2 frame 0, global PCRD", lambda: config2_frames(1)[0],
             EncoderParams(numresolutions=6, transform=Transform.DWT_97,
                           numlayers=3, rates=(24.0, 48.0, 96.0),
                           tile_size=(S2_TILE, S2_TILE),
                           rate_alloc="global"), ("mq", "dwt")),
            ("S1", s1_frame, full_params("S1"), ("enc", "dwt")))


def multihost_worker(argv) -> int:
    """Phase 23 (c)'s worker process (`chip_smoke.py --multihost-worker
    rank world host:port out.json`): joins the gloo group, then each
    `mh_cases` image through `multihost.encode_multihost` on
    `cuda:{rank % cards}`, the processes starting together (a barrier);
    writes per case the stream's SHA-256 and size, the seconds, the
    seconds and calls of its collectives (`all_gather`) and the kernels'
    launches (no plain version may run) to out.json."""
    import torch
    import torch.distributed as dist

    root = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, root)
    from grokimagecompression_tpu_torch.parallel import multihost
    rank, world, coord, out = int(argv[0]), int(argv[1]), argv[2], argv[3]
    multihost.init_distributed(coord, world, rank,
                               timeout_s=MH_GROUP_TIMEOUT_S)
    spent = {"s": 0.0, "n": 0}
    gather = dist.all_gather

    def timed_gather(*args, **kwargs):
        t0 = time.perf_counter()
        try:
            return gather(*args, **kwargs)
        finally:
            spent["s"] += time.perf_counter() - t0
            spent["n"] += 1
    dist.all_gather = timed_gather
    res = {}
    for name, make, params, kernels in mh_cases():
        img = make()
        dist.barrier()
        spent.update(s=0.0, n=0)
        with encode_counts() as plain:
            t0 = time.perf_counter()
            cs = multihost.encode_multihost(img, params)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
        counts = check_encode_counts(plain, f"rank {rank} {name}", kernels)
        res[name] = dict(sha=hashlib.sha256(cs).hexdigest(), bytes=len(cs),
                         s=secs, collective_s=spent["s"],
                         collectives=spent["n"], launches=counts,
                         device=f"cuda:{rank % torch.cuda.device_count()}")
        del img, cs
    dist.destroy_process_group()
    with open(out, "w") as f:
        json.dump(res, f)
    return 0


def mesh_encode_check(s1_cs, s2_global_cs, dev, card, launches, meshes):
    """Phase 23 (a): S1 through `sharding.encode_sharded` on each of
    `meshes` ((label, devices)) beside `encoder.encode` on `dev`, each
    stream equal to phase
    20's (`s1_cs`, equal to phase 19's), first and second run; S2 at
    `rate_alloc="global"` on the last mesh equal to phase 20's global
    stream (`s2_global_cs`). Each shard's tiles, stacked
    calls, coder launches and seconds (from its start to the card's idle
    after it)."""
    import torch

    from grokimagecompression_tpu_torch.codestream import encoder
    from grokimagecompression_tpu_torch.parallel import sharding

    def shards_of(rec):
        return "shards in the order they finished: " + "; ".join(
            f"{c['tiles']} tiles on {c['dev']} in {c['calls']} stacked "
            f"calls, {c['launches']} coder launches, {c['s']:.3f} s"
            for c in rec)

    def run(name, img, params, mesh, want, kernels):
        rec = []
        code = sharding._code_shard

        def recorded(image, siz, work, chunks):
            t0 = time.perf_counter()
            out = code(image, siz, work, chunks)
            torch.cuda.synchronize()
            rec.append(dict(
                dev=str(work[0][0].device),
                tiles=sum(len(part) for _, part in work),
                calls=sum(-(-len(part) // n)
                          for (_, part), n in zip(work, chunks)),
                launches=sum(-(-len(part) // n) * len(enc.plan.groups)
                             for (enc, part), n in zip(work, chunks)),
                s=time.perf_counter() - t0))
            return out
        sharding._code_shard = recorded
        try:
            with encode_counts() as plain:
                t0 = time.perf_counter()
                cs = sharding.encode_sharded(img, params, mesh=mesh)
                torch.cuda.synchronize()
                first = time.perf_counter() - t0
            counts = check_encode_counts(plain, name, kernels)
        finally:
            sharding._code_shard = code
        for k, v in counts.items():
            launches[k] += v
        if cs != want:
            raise AssertionError(f"{name}: the sharded stream differs from "
                                 f"phase 20's ({len(cs)} B, {len(want)} B)")
        again = best_of(1, lambda: sharding.encode_sharded(img, params,
                                                           mesh=mesh))
        print(f"{name}: stream equal to phase 20's ({len(cs)} B); first "
              f"{first:.3f} s, second {again:.3f} s; launches {counts}; "
              f"{shards_of(rec)} on {card}")

    s1 = s1_frame()
    p1 = full_params("S1")
    one = best_of(2, lambda: encoder.encode(s1, p1, device=dev))
    print(f"S1 through encoder.encode on {dev}: best of 2 {one:.3f} s on "
          f"{card}")
    for label, mesh in meshes:
        run(f"S1 through encode_sharded on {label}", s1, p1, mesh, s1_cs,
            ("enc", "dwt"))
    del s1
    s2 = s2_frame()
    label, mesh = meshes[-1]
    run(f"S2 at rate_alloc='global' through encode_sharded on {label}", s2,
        dataclasses.replace(full_params("S2"), rate_alloc="global"), mesh,
        s2_global_cs, ("mq", "dwt"))


def mesh_decode_check(s1_cs, s1_refs, dev, card, launches, mesh, label):
    """Phase 23 (b): `sharding.decode_sharded` of S1 whole and of W1 on
    `mesh` (named `label`), each equal to phase 19's decode (`s1_refs`),
    first and second run."""
    import torch

    from grokimagecompression_tpu_torch.core.params import DecoderParams
    from grokimagecompression_tpu_torch.ops import dwt, ht_dec
    from grokimagecompression_tpu_torch.parallel import sharding
    for what, kw, kernels in (("whole", {}, ("dec", "dwt")),
                              ("W1", {"window": FULL_CASES[0][3]},
                               ("dec",))):
        with decode_counts() as plain:
            t0 = time.perf_counter()
            img = sharding.decode_sharded(s1_cs, DecoderParams(**kw),
                                          mesh=mesh)
            torch.cuda.synchronize()
            first = time.perf_counter() - t0
        check_decode_counts(plain, f"S1 {what} through decode_sharded",
                            kernels)
        launches["dec"] += ht_dec.LAUNCHES["dec"]
        launches["dwt"] += dwt.LAUNCHES["dwt"]
        if plane_md5(img) != s1_refs["full" if not kw else "W1"]:
            raise AssertionError(f"S1 {what} through decode_sharded "
                                 f"differs from phase 19's decode")
        again = best_of(1, lambda: sharding.decode_sharded(
            s1_cs, DecoderParams(**kw), mesh=mesh))
        print(f"S1 {what} through decode_sharded on {label}: equal to "
              f"phase 19's decode; first {first:.3f} s, second {again:.3f} "
              f"s on {card}")


def multihost_check(s1_cs, dev, card, launches, world):
    """Phase 23 (c): `multihost.encode_multihost` in `world` processes on
    a gloo group at 127.0.0.1 (rank r on cuda:{r % the card count}: both
    on cuda:0 on one card) for each `mh_cases` image,
    every rank's stream equal to the one-process `encoder.encode`'s
    (S1: phase 20's stream; config-2 frame 0 at global PCRD: encoded here
    first, and timed); each rank's seconds and its seconds in
    collectives."""
    import socket

    import torch

    from grokimagecompression_tpu_torch.codestream import encoder
    want = {}
    for name, make, params, kernels in mh_cases():
        if name == "S1":
            want[name] = hashlib.sha256(s1_cs).hexdigest()
            continue
        img = make()
        with encode_counts() as plain:
            t0 = time.perf_counter()
            cs = encoder.encode(img, params, device=dev)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
        for k, v in check_encode_counts(plain, f"one-process {name}",
                                        kernels).items():
            launches[k] += v
        want[name] = hashlib.sha256(cs).hexdigest()
        print(f"{name} through encoder.encode in one process: {len(cs)} B, "
              f"{secs:.3f} s on {card}")
    torch.cuda.empty_cache()
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    out_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "build", "multihost")
    os.makedirs(out_dir, exist_ok=True)
    outs = [os.path.join(out_dir, f"rank{r}.json") for r in range(world)]
    logs = [open(os.path.join(out_dir, f"rank{r}.log"), "w+")
            for r in range(world)]
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--multihost-worker",
         str(r), str(world), f"127.0.0.1:{port}", outs[r]], stdout=logs[r],
        stderr=subprocess.STDOUT) for r in range(world)]
    try:
        for p in procs:
            p.wait(timeout=max(1.0, MH_WORKER_S
                               - (time.perf_counter() - t0)))
    except subprocess.TimeoutExpired:
        pass
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    wall = time.perf_counter() - t0
    for r, (p, log) in enumerate(zip(procs, logs)):
        log.seek(0)
        text = log.read()
        log.close()
        if p.returncode != 0:
            raise AssertionError(f"multi-process rank {r} failed "
                                 f"({p.returncode}):\n{text[-3000:]}")
    res = []
    for path in outs:
        with open(path) as f:
            res.append(json.load(f))
    for name in want:
        for r, got in enumerate(res):
            if got[name]["sha"] != want[name]:
                raise AssertionError(f"{name}: rank {r}'s stream differs "
                                     f"from the one-process encode's")
            for k, v in got[name]["launches"].items():
                launches[k] += v
        print(f"{name} through encode_multihost in {world} processes on "
              + ", ".join(got[name]["device"] for got in res)
              + f" (gloo): every rank's stream equals "
              f"the one-process encode's ({res[0][name]['bytes']} B); "
              + "; ".join(f"rank {r} {got[name]['s']:.3f} s, of it "
                          f"{got[name]['collective_s']:.3f} s in "
                          f"{got[name]['collectives']} all_gathers, "
                          f"launches {got[name]['launches']}"
                          for r, got in enumerate(res))
              + f" on {card}")
    print(f"phase 23 (c): the {world} processes took {wall:.1f} s from "
          f"start to exit (start-up, the frames, both encodes)")


def mesh_phase(s1_cs, s1_refs, s2_global_cs, dev, card):
    """Phase 23: multi-device coding on the machine's cards: (a) the
    sharded encode, (b) the sharded decode, (c) the multi-process encode.
    On one card the meshes are [cuda:0] and two shards on cuda:0, and two
    processes share cuda:0; on n > 1 cards they are [cuda:1, cuda:2]
    (n >= 3) and all n cards, and n processes take a card each. The
    device count is printed. Returns the launches of its runs by
    LAUNCHES key."""
    import torch
    t0 = time.perf_counter()
    n = torch.cuda.device_count()
    print(f"phase 23: {n} CUDA device(s)")
    if n == 1:
        meshes = (("[cuda:0]", [dev]), ("[cuda:0, cuda:0]", [dev, dev]))
    else:
        cards = [torch.device("cuda", i) for i in range(n)]
        meshes = ((("[cuda:1, cuda:2]", cards[1:3]),) if n >= 3 else ()) \
            + ((f"[cuda:0 .. cuda:{n - 1}]", cards),)
    launches = {"enc": 0, "mq": 0, "dwt": 0, "dec": 0, "mq_dec": 0}
    parts = []
    for label, check in (
            ("(a)", lambda: mesh_encode_check(s1_cs, s2_global_cs, dev,
                                              card, launches, meshes)),
            ("(b)", lambda: mesh_decode_check(s1_cs, s1_refs, dev, card,
                                              launches, *meshes[-1][::-1])),
            ("(c)", lambda: multihost_check(s1_cs, dev, card, launches,
                                            max(2, n)))):
        t = time.perf_counter()
        check()
        parts.append(f"{label} {time.perf_counter() - t:.1f} s")
    print(f"phase 23 (sharded encode and decode, multi-process encode): "
          f"{time.perf_counter() - t0:.1f} s ({', '.join(parts)}) on {card}; "
          f"launches {launches}")
    return launches


@contextlib.contextmanager
def t1_counts():
    """The host Tier-1 coder's calls and every kernel's launches set to 0
    and the plain versions counted, inside a `with` block (`cli_counts`
    into the dict it yields, {"dwt", "mq", "mq_dec", ...}); after it,
    fail unless the host coder was called and the DWT kernel launched,
    and unless no MQ kernel ran: a styled request never reaches them."""
    from grokimagecompression_tpu_torch.native import t1_native
    launches = {"enc": 0, "mq": 0, "dwt": 0, "dec": 0, "mq_dec": 0}
    t1_native.CALLS["t1"] = 0
    with cli_counts(launches, "the host Tier-1 route", ("dwt",)):
        yield launches
    launches["t1"] = t1_native.CALLS["t1"]
    if launches["t1"] < 1:
        raise AssertionError("the host Tier-1 coder was not called")
    if launches["mq"] or launches["mq_dec"]:
        raise AssertionError(f"a styled request launched an MQ kernel "
                             f"({launches})")


def no_t1_calls(what):
    """Fail if the host Tier-1 coder was called since its count was last
    set to 0 (the default MQ style and HT never reach it)."""
    from grokimagecompression_tpu_torch.native import t1_native
    if t1_native.CALLS["t1"]:
        raise AssertionError(f"{what} called the host Tier-1 coder "
                             f"{t1_native.CALLS['t1']} times")


def t1_encode_stages(imgs, params, dev):
    """One chunk of a styled encode by stage (host clock, synchronised),
    as `encoder.encode_batch` runs it: the upload and the transform on
    the card (`FusedT1Encoder.forward`), the fetch of the band planes, the
    host Tier-1 coder (`fused_encode.assemble_collected_t1`) and each
    frame's T2 (`encoder.write_codestream`, one after another here)."""
    import numpy as np
    import torch

    from grokimagecompression_tpu_torch.codestream import encoder
    from grokimagecompression_tpu_torch.models import fused_encode
    p, siz, cod, qcd, cod_comp, trs = encoder._coding(imgs[0], params)
    (enc,) = encoder._tile_encoders(p, siz, cod, qcd, cod_comp, trs, dev,
                                    False)
    tt = time.perf_counter
    stages = {}
    torch.cuda.synchronize()
    t = tt()
    args = fused_encode.upload_tile(
        [np.stack([im.components[c].data for im in imgs])
         for c in range(len(imgs[0].components))], enc)
    (flat,) = enc(*args)
    torch.cuda.synchronize()
    stages["upload + transform (card)"] = tt() - t
    t = tt()
    host = flat.cpu().numpy()
    stages["fetch"] = tt() - t
    t = tt()
    segs = fused_encode.assemble_collected_t1(enc.plan, host)
    stages["host T1"] = tt() - t
    t = tt()
    for im, sg in zip(imgs, segs):
        encoder.write_codestream(im, params, {0: sg})
    stages["T2"] = tt() - t
    return stages


def t1_decode_stages(streams, dev):
    """One chunk of a styled decode by stage (host clock, synchronised):
    T2, the host Tier-1 decoder into the band planes
    (`fused_decode.prepare_chunk` of a T1 plan), their upload, the
    inverse transforms on the card and the fetch."""
    import torch

    from grokimagecompression_tpu_torch.codestream import decoder
    from grokimagecompression_tpu_torch.models import fused_decode, pipeline
    tt = time.perf_counter
    stages = {}
    t = tt()
    hdr, trs, parsed = decoder.parse_batch(streams)
    stages["T2"] = tt() - t
    (plan,) = decoder.tile_groups(hdr, trs, parsed)
    dec = fused_decode.decoder_for(plan, dev)
    t = tt()
    arrays = fused_decode.prepare_chunk(plan, [
        fused_decode.jobs_by_block(*p[0][0][:3]) for p in parsed])
    stages["host T1 into band planes"] = tt() - t
    torch.cuda.synchronize()
    t = tt()
    ((flat,),) = fused_decode.upload(arrays, dev)
    torch.cuda.synchronize()
    stages["upload"] = tt() - t
    t = tt()
    comps = pipeline._inv_transform(plan.cfg, dec.split_bands(flat))
    torch.cuda.synchronize()
    stages["inverse DWT + MCT + DC unshift (card)"] = tt() - t
    t = tt()
    [c.cpu() for c in comps]
    stages["fetch"] = tt() - t
    return stages


def fmt_s(stages):
    return ", ".join(f"{k} {v * 1e3:.1f} ms" for k, v in stages.items())


def t1_phase(c1_imgs, c2_img, bench, dev, card):
    """Phase 24: the MQ code-block styles other than the default on the
    host Tier-1 route, through the user entry points, every run holding
    the route's counts (`t1_counts`: the host coder called, the DWT kernel
    launched, no MQ kernel):
    (a) config 1's 64 frames at T1_C1_STYLE through `encode_batch`, the
        streams against T1_C1_DIGESTS, and back through `decode_batch` to
        the sources; MP/s beside phase 6 / 7's default-style MQ, and one
        chunk's stages;
    (b) config-2 frame 0 at each T1_C2_STYLES entry (ratios 24 / 48 / 96)
        and at T1_C2_LAYERED, streams and pixels (whole, and at layers=1)
        against T1_C2_DIGESTS, with stages and peak device memory;
    (c) the corpus streams of the MQ styles through `decode_batch` against
        CORPUS_DIGESTS;
    (d) the CLI_CASES entries of the MQ styles through the tools against
        CLI_DIGESTS;
    (e) the config-2 frame in T1_STREAM_TILE tiles through `StreamEncoder`
        at T1_C1_STYLE (9/7), its tile-parts equal to `encode`'s.
    Returns the launches by LAUNCHES key."""
    import shutil
    import tempfile

    import numpy as np
    import torch

    from grokimagecompression_tpu_torch.cli import compress, decompress, dump
    from grokimagecompression_tpu_torch.codestream import (decoder, encoder,
                                                           stream)
    from grokimagecompression_tpu_torch.core.params import (DecoderParams,
                                                            EncoderParams,
                                                            Transform)
    t_phase = time.perf_counter()
    root = os.path.dirname(os.path.abspath(__file__))
    total = {"dwt": 0}

    def add(launches):
        total["dwt"] += launches["dwt"]

    # (a) config 1
    with open(os.path.join(root, T1_C1_DIGESTS)) as f:
        want = json.load(f)
    if want["frames"] != [frame_digest(im) for im in c1_imgs]:
        raise AssertionError("the config-1 frames differ from "
                             "T1_C1_DIGESTS'")
    params = EncoderParams(numresolutions=6, cblk_style=T1_C1_STYLE)
    mpix = len(c1_imgs) * SIZE * SIZE / 1e6
    with t1_counts() as launches:
        out = encoder.encode_batch(c1_imgs, params, device=dev, chunk=CHUNK)
        torch.cuda.synchronize()
    add(launches)
    if [hashlib.sha256(cs).hexdigest() for cs in out] != want["streams"]:
        raise AssertionError("phase 24 (a): config-1 streams at style "
                             f"{T1_C1_STYLE:#x} differ from the host "
                             "encoder's")
    best = best_of(3, lambda: encoder.encode_batch(c1_imgs, params,
                                                   device=dev, chunk=CHUNK))
    nb = sum(len(cs) for cs in out)
    print(f"phase 24 (a): config 1 at MQ style {T1_C1_STYLE:#x}: "
          f"{len(out)} streams equal the host encoder's ({nb} B); "
          f"encode_batch {mpix / best:.2f} MP/s (best of 3, {best:.3f} s) "
          f"beside {bench['config-1 MQ encode_batch']:.2f} at style 0 "
          f"(phase 6); counts {launches} on {card}")
    t1_encode_stages(c1_imgs[:CHUNK], params, dev)
    print(f"phase 24 (a): one {CHUNK}-frame styled encode chunk by stage "
          f"(host clock, synchronised): "
          f"{fmt_s(t1_encode_stages(c1_imgs[:CHUNK], params, dev))}")
    with t1_counts() as launches:
        dec = decoder.decode_batch(out, device=dev, chunk=CHUNK)
        torch.cuda.synchronize()
    add(launches)
    for i, (d, im) in enumerate(zip(dec, c1_imgs)):
        if not np.array_equal(d.components[0].data, im.components[0].data):
            raise AssertionError(f"phase 24 (a): frame {i} does not decode "
                                 f"to its source")
    best = best_of(3, lambda: decoder.decode_batch(out, device=dev,
                                                   chunk=CHUNK))
    t1_decode_stages(out[:CHUNK], dev)
    print(f"phase 24 (a): decode_batch back to the sources exactly, "
          f"{mpix / best:.2f} MP/s (best of 3, {best:.3f} s) beside "
          f"{bench['config-1 MQ decode_batch']:.2f} at style 0 (phase 7); "
          f"counts {launches}; one {CHUNK}-frame chunk by stage: "
          f"{fmt_s(t1_decode_stages(out[:CHUNK], dev))} on {card}")
    del out, dec

    # (b) config-2 frame 0
    with open(os.path.join(root, T1_C2_DIGESTS)) as f:
        want = json.load(f)
    if want["frame"] != frame_digest(c2_img):
        raise AssertionError("the config-2 frame differs from "
                             "T1_C2_DIGESTS'")
    lay_style, lay_rates = T1_C2_LAYERED
    c2_mpix = C2_SIZE * C2_SIZE / 1e6
    for style, rates, got_want in (
            [(s, (24.0, 48.0, 96.0), want["styles"][f"{s:#x}"])
             for s in T1_C2_STYLES]
            + [(lay_style, lay_rates, want["layered"])]):
        p = EncoderParams(numresolutions=6, transform=Transform.DWT_97,
                          numlayers=3, rates=rates, cblk_style=style)
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        with t1_counts() as enc_launches:
            (cs,) = encoder.encode_batch([c2_img], p, device=dev)
            torch.cuda.synchronize()
        enc_s = time.perf_counter() - t0
        enc_peak = torch.cuda.max_memory_allocated() - base
        add(enc_launches)
        if hashlib.sha256(cs).hexdigest() != got_want["stream"]:
            raise AssertionError(f"phase 24 (b): config-2 stream at style "
                                 f"{style:#x}, ratios {rates} differs from "
                                 f"the host encoder's")
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        with t1_counts() as dec_launches:
            decoded = {k: decoder.decode_batch([cs], DecoderParams(
                layers=layers), device=dev)[0]
                for k, layers in (("pixels", 0), ("layers1", 1))
                if k in got_want}
            torch.cuda.synchronize()
        dec_s = time.perf_counter() - t0
        dec_peak = torch.cuda.max_memory_allocated() - base
        add(dec_launches)
        for k, img in decoded.items():
            if frame_digest(img) != got_want[k]:
                raise AssertionError(f"phase 24 (b): style {style:#x}, "
                                     f"ratios {rates}, {k}: pixels differ "
                                     f"from the host decoder's")
        print(f"phase 24 (b): config-2 frame 0 at style {style:#x}, ratios "
              f"{rates}: stream ({len(cs)} B) and pixels "
              f"({', '.join(decoded)}) equal the host codec's; encode "
              f"{enc_s:.3f} s ({c2_mpix / enc_s:.2f} MP/s), peak device "
              f"memory {enc_peak / 1e9:.3f} GB; decodes {dec_s:.3f} s, peak "
              f"{dec_peak / 1e9:.3f} GB; counts {enc_launches} / "
              f"{dec_launches} on {card}")
        if style == T1_C2_STYLES[0] and rates == (24.0, 48.0, 96.0):
            print(f"phase 24 (b): one config-2 frame at style {style:#x} by "
                  f"stage (host clock, synchronised): encode "
                  f"{fmt_s(t1_encode_stages([c2_img], p, dev))}; decode "
                  f"{fmt_s(t1_decode_stages([cs], dev))}")

    # (c) the corpus streams of the MQ styles
    with open(os.path.join(root, CORPUS_DIGESTS)) as f:
        corpus = json.load(f)
    names = [n for n in sorted(corpus["decoded"])
             if n.startswith(("sty_", "styles_"))
             and n not in ("sty_default.j2k", "sty_ht.j2k")]
    with t1_counts() as launches:
        for name in names:
            with open(os.path.join(root, CORPUS, name), "rb") as f:
                (img,) = decoder.decode_batch([f.read()], device=dev)
            if plane_md5(img) != corpus["decoded"][name]:
                raise AssertionError(f"phase 24 (c): corpus {name} differs "
                                     f"from the host decoder's planes")
        torch.cuda.synchronize()
    add(launches)
    print(f"phase 24 (c): the {len(names)} corpus streams of the MQ styles "
          f"({', '.join(names)}) decode on the card to the host decoder's "
          f"planes; {len(corpus['decoded'])} of "
          f"{len(corpus['decoded']) + len(corpus['refused'])} corpus streams "
          f"admitted; counts {launches}")

    # (d) the tools at the MQ styles
    with open(os.path.join(root, CLI_DIGESTS)) as f:
        cli = json.load(f)
    cases = [c for c in CLI_CASES if c[0].startswith("MQ styles")]
    tmp = tempfile.mkdtemp(prefix="chip_smoke_t1_")
    try:
        cli_inputs(tmp)
        with t1_counts() as launches:
            got = run_cli_cases(tmp, {"compress": compress,
                                      "decompress": decompress,
                                      "dump": dump},
                                extra=["--torch-device", str(dev)],
                                cases=cases)
        add(launches)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    bad = [k for k in got if got[k] != cli["cases"][k]]
    if bad or len(got) != len(cases):
        raise AssertionError(f"phase 24 (d): CLI cases {bad} differ from the "
                             f"reference tools' outputs")
    print(f"phase 24 (d): {', '.join(got)}: files equal the reference "
          f"tools'; counts {launches}")

    # (e) StreamEncoder
    p = EncoderParams(numresolutions=6, transform=Transform.DWT_97,
                      cblk_style=T1_C1_STYLE, tile_size=T1_STREAM_TILE)
    buf = io.BytesIO()
    t0 = time.perf_counter()
    with t1_counts() as launches:
        with stream.StreamEncoder(buf, c2_img, p, device=dev) as se:
            for t in range(se.numtiles):
                se.write_image_tile(t, c2_img)
        torch.cuda.synchronize()
    stream_s = time.perf_counter() - t0
    add(launches)
    whole = encoder.encode(c2_img, dataclasses.replace(p, tlm_markers=True),
                           device=dev)
    got = buf.getvalue()
    if got[decoder.read_header(got).main_header_end:] != \
            whole[decoder.read_header(whole).main_header_end:]:
        raise AssertionError("phase 24 (e): the StreamEncoder's tile-parts "
                             "differ from encode's")
    print(f"phase 24 (e): config-2 frame 0 in {T1_STREAM_TILE} tiles at style "
          f"{T1_C1_STYLE:#x} through StreamEncoder ({se.numtiles} tiles, "
          f"{len(got)} B, {stream_s / se.numtiles * 1e3:.1f} ms a tile): "
          f"tile-parts equal encode's; counts {launches}")
    print(f"phase 24 (the MQ code-block styles on the host Tier-1 route): "
          f"{time.perf_counter() - t_phase:.1f} s on {card}; DWT launches "
          f"{total['dwt']}")
    return total


@contextlib.contextmanager
def refine_counts(what, host: bool, want=("dwt",)):
    """Every kernel's launches and the host Tier-1 coder's calls set to 0
    inside a `with` block (`cli_counts` into the dict it yields, which
    gains "t1"); after it, fail unless the kernels of `want` were
    launched and, with `host` (the refined and deep routes), the host
    coder was called and no HT encoder or decoder and no MQ kernel was
    launched, or without it (the allocator's route), the host coder was
    not called."""
    from grokimagecompression_tpu_torch.native import t1_native
    launches = {"enc": 0, "mq": 0, "dwt": 0, "dec": 0, "mq_dec": 0}
    t1_native.CALLS["t1"] = 0
    with cli_counts(launches, what, want):
        yield launches
    launches["t1"] = t1_native.CALLS["t1"]
    if host and (launches["t1"] < 1 or launches["enc"] or launches["dec"]
                 or launches["mq"] or launches["mq_dec"]):
        raise AssertionError(f"{what}: the host route's counts are wrong "
                             f"({launches})")
    if not host and launches["t1"]:
        raise AssertionError(f"{what}: the host coder was called "
                             f"({launches})")


def refine_phase(c1_imgs, c2_img, dev, card):
    """Phase 25: HT refinement passes, HT under an explicit rate
    allocator and deep HT bands, through the user entry points, each
    against HT_REFINE_DIGESTS (the module docstring lists (a)-(e)).
    Returns the DWT, HT encoder and HT decoder launches by LAUNCHES
    key."""
    import shutil
    import tempfile

    import numpy as np
    import torch

    from grokimagecompression_tpu_torch.cli import compress, decompress, dump
    from grokimagecompression_tpu_torch.codestream import (decoder, encoder,
                                                           pcrd)
    from grokimagecompression_tpu_torch.core.params import (DecoderParams,
                                                            EncoderParams,
                                                            Transform)
    t_phase = time.perf_counter()
    root = os.path.dirname(os.path.abspath(__file__))
    with open(os.path.join(root, HT_REFINE_DIGESTS)) as f:
        want = json.load(f)
    total = {"dwt": 0, "enc": 0, "dec": 0}

    def add(launches):
        for k in total:
            total[k] += launches[k]

    def sha(cs):
        return hashlib.sha256(cs).hexdigest()

    def params(case):
        return refine_params(EncoderParams, Transform, case)

    # (a) config 1, refined
    imgs = c1_imgs[:REFINE_C1_FRAMES]
    if want["c1"]["frames"] != [frame_digest(im) for im in imgs]:
        raise AssertionError("the config-1 frames differ from "
                             "HT_REFINE_DIGESTS'")
    p = params("c1")
    mpix = len(imgs) * SIZE * SIZE / 1e6
    with refine_counts("phase 25 (a) encode", True) as launches:
        out = encoder.encode_batch(imgs, p, device=dev, chunk=CHUNK)
        torch.cuda.synchronize()
    add(launches)
    if [sha(cs) for cs in out] != want["c1"]["streams"]:
        raise AssertionError("phase 25 (a): refined config-1 streams differ "
                             "from the host encoder's")
    enc_best = best_of(3, lambda: encoder.encode_batch(imgs, p, device=dev,
                                                       chunk=CHUNK))
    with refine_counts("phase 25 (a) decode", True) as dec_launches:
        dec = decoder.decode_batch(out, device=dev, chunk=CHUNK)
        torch.cuda.synchronize()
    add(dec_launches)
    for i, (d, im) in enumerate(zip(dec, imgs)):
        if not np.array_equal(d.components[0].data, im.components[0].data):
            raise AssertionError(f"phase 25 (a): frame {i} does not decode "
                                 f"to its source")
    dec_best = best_of(3, lambda: decoder.decode_batch(out, device=dev,
                                                       chunk=CHUNK))
    print(f"phase 25 (a): config 1 with HT refinement, {len(out)} frames: "
          f"streams equal the host encoder's ({sum(map(len, out))} B), "
          f"decoded back to the sources; encode_batch "
          f"{mpix / enc_best:.2f} MP/s ({enc_best:.3f} s), decode_batch "
          f"{mpix / dec_best:.2f} MP/s ({dec_best:.3f} s), best of 3; "
          f"counts {launches} / {dec_launches} on {card}")
    t1_encode_stages(imgs, p, dev)
    print(f"phase 25 (a): {len(imgs)} refined config-1 frames by stage "
          f"(host clock, synchronised): encode "
          f"{fmt_s(t1_encode_stages(imgs, p, dev))}; decode "
          f"{fmt_s(t1_decode_stages(out, dev))}")
    del out, dec

    # (b) config-2 frame 0, refined
    if want["c2"]["frame"] != frame_digest(c2_img):
        raise AssertionError("the config-2 frame differs from "
                             "HT_REFINE_DIGESTS'")
    c2_mpix = C2_SIZE * C2_SIZE / 1e6
    p = params("c2")
    t0 = time.perf_counter()
    with refine_counts("phase 25 (b) encode", True) as launches:
        cs = encoder.encode(c2_img, p, device=dev)
        torch.cuda.synchronize()
    enc_s = time.perf_counter() - t0
    add(launches)
    if sha(cs) != want["c2"]["stream"]:
        raise AssertionError("phase 25 (b): the refined config-2 stream "
                             "differs from the host encoder's")
    t0 = time.perf_counter()
    with refine_counts("phase 25 (b) decode", True) as dec_launches:
        decoded = {k: decoder.decode(cs, DecoderParams(**kw), device=dev)
                   for k, kw in (("pixels", {}), ("reduce1", {"reduce": 1}),
                                 ("window", {"window": REFINE_WINDOW}))}
        torch.cuda.synchronize()
    dec_s = time.perf_counter() - t0
    add(dec_launches)
    for k, img in decoded.items():
        if frame_digest(img) != want["c2"][k]:
            raise AssertionError(f"phase 25 (b): {k}: pixels differ from "
                                 f"the host decoder's")
    print(f"phase 25 (b): config-2 frame 0 with HT refinement: stream "
          f"({len(cs)} B) and pixels (whole, reduce 1, window "
          f"{REFINE_WINDOW}) equal the host codec's; encode {enc_s:.3f} s "
          f"({c2_mpix / enc_s:.2f} MP/s), the three decodes {dec_s:.3f} s; "
          f"counts {launches} / {dec_launches}; by stage (host clock, "
          f"synchronised): encode "
          f"{fmt_s(t1_encode_stages([c2_img], p, dev))}; decode "
          f"{fmt_s(t1_decode_stages([cs], dev))}")

    # (c) config-2 frame 0 under an allocator
    p = params("alloc")
    alloc = pcrd.make_layer_alloc(c2_img, dataclasses.replace(
        p, rates=REFINE_ALLOC_RATES))
    t0 = time.perf_counter()
    with refine_counts("phase 25 (c) encode", False,
                       ("enc", "dwt")) as launches:
        cs = encoder.encode(c2_img, p, layer_alloc=alloc, device=dev)
        torch.cuda.synchronize()
    enc_s = time.perf_counter() - t0
    add(launches)
    if sha(cs) != want["alloc"]["stream"]:
        raise AssertionError("phase 25 (c): the config-2 stream under the "
                             "allocator differs from the host encoder's")
    with refine_counts("phase 25 (c) decode", False,
                       ("dec", "dwt")) as dec_launches:
        decoded = {k: decoder.decode(cs, DecoderParams(layers=layers),
                                     device=dev)
                   for k, layers in (("pixels", 0), ("layers1", 1))}
        torch.cuda.synchronize()
    add(dec_launches)
    for k, img in decoded.items():
        if frame_digest(img) != want["alloc"][k]:
            raise AssertionError(f"phase 25 (c): {k}: pixels differ from "
                                 f"the host decoder's")
    print(f"phase 25 (c): config-2 frame 0, 3 layers under a PCRD allocator "
          f"at {REFINE_ALLOC_RATES} with refinement asked for (dropped): "
          f"stream ({len(cs)} B) and pixels (whole, layers=1) equal the "
          f"host codec's; encode {enc_s:.3f} s; counts {launches} / "
          f"{dec_launches}")
    del cs, decoded

    # (d) the deep frame
    deep = deep_frame()
    if want["deep"]["frame"] != frame_digest(deep):
        raise AssertionError("the deep frame differs from "
                             "HT_REFINE_DIGESTS'")
    p = params("deep")
    with refine_counts("phase 25 (d) encode", False,
                       ("enc", "dwt")) as launches:
        cs = encoder.encode(deep, p, device=dev)
        torch.cuda.synchronize()
    add(launches)
    if sha(cs) != want["deep"]["stream"]:
        raise AssertionError("phase 25 (d): the deep stream differs from "
                             "the host encoder's")
    t0 = time.perf_counter()
    with refine_counts("phase 25 (d) decode", True) as dec_launches:
        got = decoder.decode(cs, device=dev)
        torch.cuda.synchronize()
    dec_s = time.perf_counter() - t0
    add(dec_launches)
    if not np.array_equal(got.components[0].data, deep.components[0].data):
        raise AssertionError("phase 25 (d): the deep stream does not decode "
                             "to its source")
    print(f"phase 25 (d): a {REFINE_DEEP_SIZE}^2 {REFINE_DEEP_PREC}-bit 5/3 "
          f"HT frame (HH Mb 30): stream ({len(cs)} B) equal to the host "
          f"encoder's, decoded to its source on the host cleanup decoder "
          f"in {dec_s:.3f} s; counts {launches} / {dec_launches}")

    # (e) the tools
    tmp = tempfile.mkdtemp(prefix="chip_smoke_refine_")
    try:
        cli_inputs(tmp)
        with refine_counts("phase 25 (e)", True) as launches:
            got = run_cli_cases(tmp, {"compress": compress,
                                      "decompress": decompress,
                                      "dump": dump},
                                extra=["--torch-device", str(dev)],
                                cases=REFINE_CLI_CASES)
        add(launches)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    if got != want["cli"]:
        raise AssertionError(f"phase 25 (e): {sorted(got)} differ from the "
                             f"reference tools' outputs")
    print(f"phase 25 (e): {', '.join(got)}: files equal the reference "
          f"tools'; counts {launches}")
    print(f"phase 25 (HT refinement, HT under an allocator, deep HT bands): "
          f"{time.perf_counter() - t_phase:.1f} s on {card}; launches "
          f"{total}")
    return total


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
    t_main = time.perf_counter()
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
    from grokimagecompression_tpu_torch.core.params import (DecoderParams,
                                                            EncoderParams,
                                                            Transform)
    from grokimagecompression_tpu_torch.models import fused_encode
    from grokimagecompression_tpu_torch.native import ht_prepass, t1_native
    from grokimagecompression_tpu_torch.ops import (_build, dwt, ht_dec,
                                                    ht_enc, ht_tables,
                                                    ht_torch, mq_dec,
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

    # 2. builds (the MQ decoder's lanes-per-block trials alongside)
    t0 = time.perf_counter()
    trials = start_lane_trials()
    clock_build = start_clock_build()
    dense_clock_build = start_dense_clock_build()
    so, log = _build.build()
    _build.load()
    trial_libs = finish_lane_trials(trials)
    clock_lib = finish_clock_build(clock_build)
    dense_clock_lib = finish_dense_clock_build(dense_clock_build)
    print(f"built {os.path.relpath(so)} from {', '.join(_build.SOURCES)} "
          f"with nvcc {' '.join(_build.ARCH_FLAGS)}, the lanes-per-"
          f"block trials {LANE_TRIALS} x {SPLIT_TRIALS} and two "
          f"instrumented builds, in {time.perf_counter() - t0:.1f} s")
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
    c2_params = EncoderParams(numresolutions=6, transform=Transform.DWT_97,
                              numlayers=3, rates=(24.0, 48.0, 96.0))
    c2_imgs = config2_frames(C2_FRAMES)
    c2_siz = encoder.build_siz(c2_imgs[0], c2_params)
    c2_cod = encoder.build_cod(c2_imgs[0], c2_params)
    c2_qcd = default_qcd(c2_siz, c2_cod, c2_params.num_guard_bits,
                         c2_params.base_step)
    c2_tr = tile_rect(0, c2_siz.xsiz, c2_siz.ysiz, c2_siz.xosiz,
                      c2_siz.yosiz, c2_siz.xtsiz, c2_siz.ytsiz,
                      c2_siz.xtosiz, c2_siz.ytosiz)
    c2_enc = fused_encode.FusedMQEncoder(fused_encode.build_plan(
        c2_siz, c2_cod, c2_qcd, c2_tr, coder="mq", want_rd=True), dev)

    def c2_chunk(lo, hi):
        return [torch.from_numpy(np.stack(
            [im.components[c].data for im in c2_imgs[lo:hi]]).astype(
                np.uint8)).to(dev) for c in range(3)]

    # 3. kernels against their plain versions, at one chunk's shapes
    t3 = time.perf_counter()
    results = {}
    launches = {}
    check_encoder(enc, plan, chunk, results, trial_libs["ht_enc.cu"],
                  clock_lib)
    first = encoder.encode_batch(imgs[:CHUNK], params, device="cuda",
                                 chunk=CHUNK)
    check_decoder(first, dev, results, trial_libs["ht_dec.cu"])
    check_mq_scan(mq_enc, chunk, results, trial_libs["mq_scan.cu"])
    check_mq_dense(mq_enc, chunk, results, launches,
                   trial_libs["mq_dense.cu"], dense_clock_lib)
    torch.cuda.empty_cache()
    check_mq_decoder(encoder.encode_batch(imgs[:CHUNK], mq_params,
                                          device="cuda", chunk=CHUNK),
                     dev, results, trial_libs["mq_dec.cu"])
    check_dwt(dev, results)
    check_mq_cumbo(c2_enc, c2_chunk(0, 1))
    torch.cuda.empty_cache()
    c2_scan_trial(c2_enc, c2_chunk(0, C2_CHUNK), results,
                  trial_libs["mq_scan.cu"], trial_libs["mq_dense.cu"])
    c2_ht_trial(c2_enc, c2_chunk(0, C2_CHUNK), results,
                trial_libs["ht_dec.cu"], trial_libs["ht_enc.cu"])

    print(f"phase 3 (every kernel against its plain version, the trials): "
          f"{time.perf_counter() - t3:.1f} s on {card}")

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
    ht_enc.LAUNCHES["enc"] = 0
    dwt.LAUNCHES["dwt"] = 0
    t1_native.CALLS["t1"] = 0
    per_group = [Calls(ht_enc, "encode_segments",
                       lambda a, *_, s=(2 * qh, 2 * qw): tuple(a.shape[1:])
                       == s) for (qh, qw, _) in plan.groups]
    plain_calls = [Calls(ht_torch, "op_streams", lambda *a: True),
                   Calls(ht_tables, "assemble_segments_host",
                         lambda *a: True)]
    with contextlib.ExitStack() as counting:
        for c in per_group + plain_calls:
            counting.enter_context(c)
        out = encoder.encode_batch(imgs, params, device="cuda", chunk=CHUNK)
        torch.cuda.synchronize()
    calls = {ENC[1]: per_group[-1].n}
    launches["enc"] = ht_enc.LAUNCHES["enc"]
    print(f"encode slice launches: {dict(ht_enc.LAUNCHES)} (calls by "
          f"group: {[c.n for c in per_group]}), {dict(dwt.LAUNCHES)}; "
          f"op stream builds: {plain_calls[0].n}, host splices: "
          f"{plain_calls[1].n}")
    if any(c.n for c in plain_calls):
        raise AssertionError("the CUDA encode route built op streams or "
                             "spliced segments on the host")
    no_t1_calls("the HT encode slice")
    if any(c.n < 1 for c in per_group) or \
            launches["enc"] != sum(c.n for c in per_group):
        raise AssertionError("ht_encode was not launched by the slice on "
                             "every shape group")
    if dwt.LAUNCHES["dwt"] < 1:
        raise AssertionError("the DWT kernel was not launched by the slice")
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
    bench = {"config-1 HT encode_batch": mpix / best}
    encode_stages(enc, chunk)
    stages = encode_stages(enc, chunk)
    fwd_ms = cuda_ms(lambda: enc(chunk), 3)
    print(f"one {CHUNK}-frame encode chunk, FusedHTEncoder.forward: "
          f"{fwd_ms:.1f} ms; by stage (host clock, synchronised): "
          + ", ".join(f"{k} {v * 1e3:.1f} ms" for k, v in stages.items()))

    # 5. the decode slice, through the user entry point
    ht_dec.LAUNCHES["dec"] = 0
    dwt.LAUNCHES["dwt"] = 0
    ht_prepass.CALLS["prepass"] = 0
    t1_native.CALLS["t1"] = 0
    with Calls(ht_dec, "decode_segments",
               lambda *a: (a[4], a[5]) == (64, 64)) as counter:
        dec = decoder.decode_batch(out, device="cuda", chunk=CHUNK)
        torch.cuda.synchronize()
    calls["dec"] = counter.n
    launches["dec"] = ht_dec.LAUNCHES["dec"]
    print(f"decode slice launches: {dict(ht_dec.LAUNCHES)}, "
          f"{dict(dwt.LAUNCHES)}; host prepass calls: "
          f"{ht_prepass.CALLS['prepass']}")
    if ht_prepass.CALLS["prepass"] != 0:
        raise AssertionError("the CUDA decode route called the host "
                             "prepass")
    no_t1_calls("the HT decode slice")
    if launches["dec"] < 1 or not 1 <= calls["dec"] <= launches["dec"]:
        raise AssertionError("ht_dec_group was not launched by the slice "
                             "on the 64x64 group")
    if dwt.LAUNCHES["dwt"] < 1:
        raise AssertionError("the DWT kernel was not launched by the "
                             "decode slice")
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
    bench["config-1 HT decode_batch"] = mpix / best
    decode_stages(out[:CHUNK], dev, "lane packing (host)")
    stages = decode_stages(out[:CHUNK], dev, "lane packing (host)")
    print(f"one {CHUNK}-frame decode chunk by stage (host clock, "
          "synchronised): "
          + ", ".join(f"{k} {v * 1e3:.1f} ms" for k, v in stages.items()))

    # 6. the MQ encode slice, through the user entry point
    with open(os.path.join(root, MQ_DIGESTS)) as f:
        mq_digests = json.load(f)
    if mq_digests["frames"] != digests["frames"]:
        raise AssertionError("the two digest files hold other frames")
    mq_scan.LAUNCHES["mq"] = 0
    dwt.LAUNCHES["dwt"] = 0
    t1_native.CALLS["t1"] = 0
    with Calls(mq_scan, "scan_into", lambda a, *_: a.shape[1]
               == results[MQ[0]]["shape"][1]) as counter:
        out = encoder.encode_batch(imgs, mq_params, device="cuda",
                                   chunk=CHUNK)
        torch.cuda.synchronize()
    calls["mq"] = counter.n
    launches["mq"] = mq_scan.LAUNCHES["mq"]
    print(f"MQ encode slice launches: {dict(mq_scan.LAUNCHES)}, "
          f"{dict(dwt.LAUNCHES)}")
    if launches["mq"] < 1 or not 1 <= calls["mq"] <= launches["mq"]:
        raise AssertionError("mq_scan was not launched by the MQ slice on "
                             "the 64x64 group")
    if dwt.LAUNCHES["dwt"] < 1:
        raise AssertionError("the DWT kernel was not launched by the MQ "
                             "slice")
    no_t1_calls("the MQ encode slice (style 0)")
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
    bench["config-1 MQ encode_batch"] = mpix / best
    mq_encode_stages(mq_enc, chunk, imgs, mq_params)
    stages = mq_encode_stages(mq_enc, chunk, imgs, mq_params)
    print(f"one {CHUNK}-frame MQ encode chunk by stage (host clock, "
          "synchronised): "
          + ", ".join(f"{k} {v * 1e3:.1f} ms" for k, v in stages.items()))

    # 7. the MQ decode slice, through the user entry point
    mq_dec.LAUNCHES["mq_dec"] = 0
    dwt.LAUNCHES["dwt"] = 0
    t1_native.CALLS["t1"] = 0
    with Calls(mq_dec, "decode_group",
               lambda *a, **_: (a[5], a[6]) == (64, 64)) as counter:
        dec = decoder.decode_batch(out, device="cuda", chunk=CHUNK)
        torch.cuda.synchronize()
    calls["mq_dec"] = counter.n
    launches["mq_dec"] = mq_dec.LAUNCHES["mq_dec"]
    print(f"MQ decode slice launches: {dict(mq_dec.LAUNCHES)}, "
          f"{dict(dwt.LAUNCHES)}")
    if launches["mq_dec"] < 1 or not 1 <= calls["mq_dec"] <= \
            launches["mq_dec"]:
        raise AssertionError("mq_dec_group was not launched by the slice "
                             "on the 64x64 group")
    if dwt.LAUNCHES["dwt"] < 1:
        raise AssertionError("the DWT kernel was not launched by the MQ "
                             "decode slice")
    no_t1_calls("the MQ decode slice (style 0)")
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
    bench["config-1 MQ decode_batch"] = mpix / best
    decode_stages(out[:CHUNK], dev, "lane packing (host)")
    stages = decode_stages(out[:CHUNK], dev, "lane packing (host)")
    print(f"one {CHUNK}-frame MQ decode chunk by stage (host clock, "
          "synchronised): "
          + ", ".join(f"{k} {v * 1e3:.1f} ms" for k, v in stages.items()))

    # 8. the config-2 rate-controlled encode, through the user entry point
    with open(os.path.join(root, C2_DIGESTS)) as f:
        c2_digests = json.load(f)
    got = [frame_digest(im) for im in c2_imgs]
    if got != c2_digests["frames"]:
        bad = [i for i, (g, w) in enumerate(zip(got, c2_digests["frames"]))
               if g != w]
        raise AssertionError(f"config-2 frames {bad} differ from the digest "
                             f"file: numpy makes other frames here")
    c2_mpix = C2_FRAMES * C2_SIZE * C2_SIZE / 1e6
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    dwt.LAUNCHES["dwt"] = 0
    mq_scan.LAUNCHES["mq"] = 0
    with Calls(dwt, "fwd_dwt_2d", lambda a, *_: tuple(a.shape[-2:])
               == (C2_SIZE, C2_SIZE)) as counter:
        out = encoder.encode_batch(c2_imgs, c2_params, device="cuda",
                                   chunk=C2_CHUNK)
        torch.cuda.synchronize()
    calls["dwt"] = counter.n
    c2_peak = {C2_CHUNK: torch.cuda.max_memory_allocated() - base}
    launches["dwt"] = dwt.LAUNCHES["dwt"]
    print(f"config-2 encode slice launches: {dict(dwt.LAUNCHES)}, "
          f"{dict(mq_scan.LAUNCHES)}")
    if launches["dwt"] < 1 or mq_scan.LAUNCHES["mq"] < 1 or \
            calls["dwt"] < 1:
        raise AssertionError("the DWT or the MQ kernel was not launched by "
                             "the config-2 slice")
    if len(out) != C2_FRAMES:
        raise AssertionError(f"{len(out)} streams for {C2_FRAMES} frames")
    for i, cs in enumerate(out):
        if hashlib.sha256(cs).hexdigest() != c2_digests["streams"][i]:
            raise AssertionError(f"config-2 frame {i}: stream differs from "
                                 f"the host encoder's ({len(cs)} B)")
    print(f"config-2 encode slice: {C2_FRAMES} streams match the host "
          f"encoder's digests ({[len(cs) for cs in out]} B)")
    best = best_of(3, lambda: encoder.encode_batch(
        c2_imgs, c2_params, device="cuda", chunk=C2_CHUNK))
    print(f"encode_batch (config 2): {c2_mpix / best:.2f} MP/s (best of 3, "
          f"{best:.3f} s for {C2_FRAMES} frames) on {card}")
    bench["config-2 encode_batch"] = c2_mpix / best
    chunk2 = c2_chunk(0, C2_CHUNK)
    c2_encode_stages(c2_enc, chunk2, c2_imgs, c2_params, c2_siz, c2_cod,
                     c2_qcd, c2_tr)
    stages, layers = c2_encode_stages(c2_enc, chunk2, c2_imgs, c2_params,
                                      c2_siz, c2_cod, c2_qcd, c2_tr)
    print(f"config-2 bytes by layer (ratios {c2_params.rates}; packets "
          f"only): " + "; ".join(f"frame {f}: {b}"
                                 for f, b in enumerate(layers)))
    print(f"one {C2_CHUNK}-frame config-2 encode chunk by stage (host "
          "clock, synchronised): "
          + ", ".join(f"{k} {v * 1e3:.1f} ms" for k, v in stages.items()))
    del chunk2, stages

    # 9. the config-2 decode, through the user entry point
    with open(os.path.join(root, C2_DEC_DIGESTS)) as f:
        c2_dec = json.load(f)
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    mq_dec.LAUNCHES["mq_dec"] = 0
    dwt.LAUNCHES["dwt"] = 0
    dec = decoder.decode_batch(out, device="cuda")
    torch.cuda.synchronize()
    dec_peak = torch.cuda.max_memory_allocated() - base
    print(f"config-2 decode slice launches: {dict(mq_dec.LAUNCHES)}, "
          f"{dict(dwt.LAUNCHES)}")
    if mq_dec.LAUNCHES["mq_dec"] < 1 or dwt.LAUNCHES["dwt"] < 1:
        raise AssertionError("mq_dec_group or the DWT kernel was not "
                             "launched by the config-2 decode")
    got = [frame_digest(d) for d in dec]
    if got != c2_dec["decoded"]:
        bad = [i for i, (g, w) in enumerate(zip(got, c2_dec["decoded"]))
               if g != w]
        raise AssertionError(f"config-2 decode: frames {bad} differ from the "
                             f"host decoder's pixels")
    print(f"config-2 decode slice: {C2_FRAMES} frames equal the host "
          f"decoder's pixels (digests); MSE against the sources "
          + ", ".join(f"{frame_mse(d, im):.4f}"
                      for d, im in zip(dec, c2_imgs)))
    best = best_of(3, lambda: decoder.decode_batch(out, device="cuda"))
    print(f"decode_batch (config 2): {c2_mpix / best:.2f} MP/s (best of 3, "
          f"{best:.3f} s for {C2_FRAMES} frames) on {card}; peak device "
          f"memory {dec_peak / 1e9:.3f} GB above the {base / 1e9:.3f} GB held "
          f"before")
    bench["config-2 decode_batch"] = c2_mpix / best
    c2_decode_stages(out, dev)
    stages = c2_decode_stages(out, dev)
    print(f"one {C2_FRAMES}-frame config-2 decode chunk by stage (host "
          "clock, synchronised): "
          + ", ".join(f"{k} {v * 1e3:.1f} ms" for k, v in stages.items()))
    del dec

    # 10. a layer-limited decode of a config-2 frame whose layers carry data
    lay = c2_dec["layered"]
    lay_params = EncoderParams(numresolutions=6, transform=Transform.DWT_97,
                               numlayers=3, rates=tuple(lay["rates"]))
    (lay_cs,) = encoder.encode_batch(c2_imgs[:1], lay_params, device="cuda")
    if hashlib.sha256(lay_cs).hexdigest() != lay["stream"]:
        raise AssertionError("the rates (96, 48, 24) stream differs from the "
                             "host encoder's")
    mses = {}
    for layers in ("1", "2", "0"):
        mq_dec.LAUNCHES["mq_dec"] = 0
        (img,) = decoder.decode_batch([lay_cs], DecoderParams(
            layers=int(layers)), device="cuda")
        if mq_dec.LAUNCHES["mq_dec"] < 1:
            raise AssertionError("mq_dec_group was not launched by the "
                                 "layer-limited decode")
        if frame_digest(img) != lay["layers"][layers]["pixels"]:
            raise AssertionError(f"layers={layers}: pixels differ from the "
                                 f"host decoder's")
        mses[layers] = frame_mse(img, c2_imgs[0])
    if len(set(mses.values())) != 3:
        raise AssertionError(f"the layer limit does not act: MSE {mses}")
    print(f"config-2 frame 0 at rates {tuple(lay['rates'])} "
          f"({len(lay_cs)} B, equal to the host encoder's): decoded at "
          f"layers 1, 2 and all equal to the host decoder's pixels; MSE "
          + ", ".join(f"{mses[k]:.4f}" for k in ("1", "2", "0")))

    # 11. the config-2 encode at encode_batch's default chunk
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    free = encoder.free_device_bytes(dev)
    c2_plan = c2_enc.plan
    per_frame = fused_encode.mq_frame_bytes(c2_plan)
    cap = fused_encode.chunk_cap(c2_plan, free)
    default_chunk = inspect.signature(
        encoder.encode_batch).parameters["chunk"].default
    chosen = max(1, min(default_chunk, cap, C2_FRAMES))
    torch.cuda.reset_peak_memory_stats()
    out2 = encoder.encode_batch(c2_imgs, c2_params, device="cuda")
    torch.cuda.synchronize()
    c2_peak[chosen] = torch.cuda.max_memory_allocated() - base
    if [hashlib.sha256(cs).hexdigest() for cs in out2] != \
            c2_digests["streams"]:
        raise AssertionError("config-2 streams at the default chunk differ "
                             "from the host encoder's")
    print(f"config-2 encode at the default chunk {default_chunk}: "
          f"{free / 1e9:.2f} GB free, the plan's model "
          f"{per_frame / 1e9:.3f} GB a frame caps a chunk at {cap} frames, "
          f"so {chosen} (all {C2_FRAMES} frames); streams equal the host "
          f"encoder's")
    fixed = mq_scan.EMIT_BLOCK_BYTES
    for n, peak in sorted(c2_peak.items()):
        print(f"config-2 encode peak device memory at chunk {n}: "
              f"{peak / 1e9:.3f} GB measured above the {base / 1e9:.3f} GB "
              f"held before, {(n * per_frame + fixed) / 1e9:.3f} GB "
              f"predicted (mq_frame_bytes x {n} + the counting "
              f"temporaries) on {card}")
    del out2
    mem = c2_memory_stages(c2_enc, c2_chunk(0, 1))
    print("one config-2 frame's encode, peak device memory by stage above "
          "the stage's start: " + ", ".join(
              f"{k} {v / 1e9:.3f} GB" for k, v in mem.items()))

    fixed = c2_ht_phases(c2_imgs, c2_digests["frames"], c2_siz, c2_tr,
                         c2_chunk, dev, card)
    files = gate_c2_phase(c2_imgs, fixed, dev, card)
    # phase 15's COC + POC + PPM JP2 files between plain streams, for
    # phase 20's decompress_batch
    mixed = [files[0], fixed[0], files[1], fixed[1]]
    del fixed, files
    gate_c1_phase(imgs, dev, card)
    corpus_phase(c2_imgs[0], dev, card)
    cinema = cinema_phase(dev, card, results)
    windows, full_streams, s1_refs = window_phase(dev, card, results)
    image_enc, s2_global_cs = image_encode_phase(mixed, full_streams, imgs,
                                                 c2_imgs, dev, card)
    s1_cs = full_streams["S1"]
    del mixed, full_streams
    tools = cli_phase(imgs, c2_imgs, s1_cs, s1_refs, bench, dev, card)
    routes = route_phase(dev, card)
    meshes = mesh_phase(s1_cs, s1_refs, s2_global_cs, dev, card)
    del s1_cs, s2_global_cs
    styles = t1_phase(imgs, c2_imgs[0], bench, dev, card)
    refine = refine_phase(imgs, c2_imgs[0], dev, card)

    calls["mq_dense"] = launches["mq_dense"]
    for key, n in (list(cinema.items()) + list(windows.items())
                   + list(image_enc.items()) + list(tools.items())
                   + list(routes.items()) + list(meshes.items())
                   + list(styles.items()) + list(refine.items())):
        calls[key] += n
    print(f"launches in the kernels line, the calls of what each kernel's ms "
          f"times on its path (a group kernel on the 64x64 group, the DWT "
          f"whole config-2 forward transforms) plus the launches of phase "
          f"18's cinema encodes and decodes ({cinema}), of phase 19's "
          f"full-size requests ({windows}), of phase 20's encodes and "
          f"decodes ({image_enc}), of phase 21's tool runs ({tools}), "
          f"of phase 22's streams and host-route requests ({routes}), "
          f"of phase 23's sharded and multi-process runs ({meshes}), of "
          f"phase 24's MQ code-block styles ({styles}) and of phase 25's "
          f"HT refinement, allocator and deep-band runs ({refine}): "
          f"{calls}; all launches of the config-1 and config-2 runs: "
          f"{launches}")
    print(f"the whole run: {time.perf_counter() - t_main:.1f} s on {card}")
    print(json.dumps({"kernels": [
        dict(name=name, route="cuda", source=source, replaces=replaces,
             launches=calls[key],
             max_abs_err=results[name]["max_abs_err"],
             ms=results[name]["ms"], plain_ms=results[name]["plain_ms"],
             bound_ms=results[name]["bound_ms"],
             bound_by=results[name]["bound_by"], library_ms=None)
        for name, key, _, replaces, source in (ENC, DEC, MQ, MQ_DEC, DWT,
                                               MQ_DENSE)]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--multihost-worker"]:
        sys.exit(multihost_worker(sys.argv[2:]))
    sys.exit(main())
