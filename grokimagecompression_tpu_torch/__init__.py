"""grokimagecompression_tpu_torch: the codec's device layer on PyTorch + CUDA.

A port of `grokimagecompression_tpu`'s device layer (JAX/Pallas on a TPU)
to PyTorch, with the Pallas kernels rewritten as hand-written CUDA for
Hopper (`csrc/*.cu`). The port stands alone: it never imports JAX nor
the reference package, and owns copies of the host layers its slices run,
under the reference's names (`core/`, `codestream/` markers, header walk,
packet iterator, tag trees, bit I/O, tile plans and T2, `ops/ht_tables`),
with the native T2 and HT decode prepass built from `csrc/host/*.cpp`.

Slices ported so far, HT lossless (5/3), BASELINE config 1 and alike:
- encode, `codestream.encoder.encode_batch`: DC shift -> MCT -> 5/3 DWT ->
  code-block gather -> HT op streams -> the MEL/VLC/MagSgn stream-scan
  kernels -> exact word placement, then host segment assembly and T2;
- decode, `codestream.decoder.decode_batch`: host T2 and stream prepass
  -> the HT group-decoder kernel -> band assembly -> inverse DWT, MCT and
  DC shift.

Later slices add the MQ coder, 9/7, rate control (per tile and
image-wide), the decode gate and the profile encodes to those entry
points, the per-image decode `codestream.decoder.decode` (windows,
reduced resolutions, single tiles, layer limits), the per-image encode
`codestream.encoder.encode` (the tiles of one plan coded together), and
the codec API `codec` (`compress`, `compress_batch`, `Codec`, `PRESETS`,
`decompress`, `decompress_batch`).
"""

__all__ = ["codec"]
