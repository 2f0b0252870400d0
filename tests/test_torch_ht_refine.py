"""HT refinement passes, HT under an explicit rate allocator and deep HT
bands, held to the reference's host codec on the CPU.

The port codes what the reference codes on its host for the HT block
coder on the reference's own route: the transform on the device, then
the host library's HT coder (`csrc/host/ht.cpp`, a copy of the
reference's `native/src/ht.cpp` with batch entries over band planes;
`native/t1_native.py`, `t1/backend.py`), then the port's T2. A refined
block is its cleanup one plane up plus a SigProp and a MagRef pass for
the plane it drops (3 passes in 2 codeword segments, numbps 2; plain
cleanup where its band's Mb < 2); an explicit allocator drops the
refinement and gets each block's cleanup from the CUDA HT coder as one
pass; a band whose Mb + 3 exceeds the CUDA HT decoder's 32 bits decodes
on the host's cleanup decoder. Held here:

- the host coder against the reference's native coder: refined encode
  bytes and decoded quarter magnitudes of seeded blocks at odd and full
  sizes, Mb 2-30, 2 and 3 passes, cut and corrupt refinement segments;
  the batch entries over int32 and float32 band planes at 1 and 4
  threads against the reference's per-block coder and its
  `decode_cblk_batch_bands`;
- `encode`, `encode_batch`, `Codec` and the decodes (whole, reduced,
  windowed, a tile) against the reference host encoder and decoder (numpy
  DWT) on 5/3 gray, 9/7 RGB in tiles and a 1-bit frame (its LL band has
  Mb 1: plain cleanup), with the host coder called and no HT kernel;
- HT rate control with refinement (the step searched on the CUDA HT
  coder's cleanup totals, confirmed by refined encodes, as the
  reference's search does);
- HT with `layer_alloc=`, refinement asked for or not, on the CUDA HT
  coder's route: the reference's stream; the host coder not called;
- the Mb-30 stream (a 28-bit 5/3 frame: its HH bands' Mb is 30) through
  the port's encode and decode; Mb 29 stays on the HT decoder's route;
- refined codestreams cut short decode as the reference's do;
- the reference's device `encode_batch` drops the refinement for a batch
  of two frames (ROADMAP Queue C), which the port does not copy;
- `data/ht_refine.json`: its small case and tool cases are current (the
  whole file, `chip_smoke.py` phase 25's digests at full size too, is
  rewritten by `PYTHONPATH=.:tests python tests/test_torch_ht_refine.py`,
  a few minutes).

The `gpu` case runs on the card with `GROK_TPU_TESTS=1 python -m pytest
tests/test_torch_ht_refine.py -m gpu` (this file imports only the
reference's host codec at module level, which imports no JAX).
"""

import dataclasses
import hashlib
import json
import os
import sys

import numpy as np
import pytest
import torch

from grokimagecompression_tpu.codestream import decoder as ref_decoder
from grokimagecompression_tpu.codestream import encoder as ref_encoder
from grokimagecompression_tpu.core.image import Component, Image
from grokimagecompression_tpu.core.params import EncoderParams, Transform
from grokimagecompression_tpu_torch import codec, convert
from grokimagecompression_tpu_torch.codestream import decoder, encoder, pcrd
from grokimagecompression_tpu_torch.core.params import DecoderParams
from grokimagecompression_tpu_torch.native import t1_native
from grokimagecompression_tpu_torch.ops import ht_dec, ht_enc
from grokimagecompression_tpu_torch.t1 import backend

from conftest import natural_image
from test_torch_t1_styles import (_numpy_dwt, _ref_decode, _ref_encode,
                                  _ref_image, _same_pixels)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
import chip_smoke  # noqa: E402

HT = 0x40
# (h, w) of the coder's blocks: one sample, one row, one column, odd
# sides, a full 64 x 64 block and the longest one
SHAPES = ((1, 1), (1, 64), (64, 1), (7, 13), (33, 17), (64, 64), (4, 1024))


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Torch on one thread: under pytest-xdist's workers torch's OpenMP
    threads oversubscribe the cores and spin."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def no_ht_kernel(monkeypatch):
    """Fail if the HT encoder or decoder (their plain versions on the CPU)
    runs: the refined and deep routes never reach them."""
    def refuse(*args, **kwargs):
        raise AssertionError("an HT kernel's route ran")
    monkeypatch.setattr(ht_enc, "encode_segments", refuse)
    monkeypatch.setattr(ht_dec, "decode_segments", refuse)


# ---- the host coder against the reference's native coder

def _block(rng, h, w, mb):
    """Magnitudes below 2^mb, half of them zero, and random signs."""
    mag = (rng.integers(0, 1 << mb, (h, w), dtype=np.int64)
           >> rng.integers(0, mb, (h, w)))
    mag[rng.random((h, w)) < 0.5] = 0
    return mag.astype(np.uint32), rng.integers(0, 2, (h, w)).astype(np.uint8)


@pytest.mark.parametrize("passes", [2, 3])
def test_host_coder_equals_reference_coder(passes):
    """Per block, `ht_encode_cblk_refined` equals the reference's bytes
    and segment lengths, and `ht_decode_cblk_refined` its quarter
    magnitudes and signs, whole, with the refinement segment cut and with
    a byte of it flipped; `ht_encode_refined_batch_bands` over int32 and
    float32 planes (Mb 0 and 1 blocks among them: plain cleanup) equals
    the reference's per-block coders at 1 and 4 threads, and the port's
    `backend.decode_cblk_batch_bands` equals the reference's (refined,
    cut and plain cleanup jobs, int32 and float32 planes)."""
    from grokimagecompression_tpu.native import t1_native as ref_native
    from grokimagecompression_tpu.t1 import backend as ref_backend
    rng = np.random.default_rng(passes)
    blocks = []
    for i, (h, w) in enumerate(SHAPES * 2):
        mb = int(rng.integers(2, 31)) if i < len(SHAPES) else 30 - i % 3
        mag, neg = _block(rng, h, w, mb)
        got = t1_native.ht_encode_cblk_refined(mag, neg, mb, passes)
        assert got == ref_native.ht_encode_cblk_refined(mag, neg, mb,
                                                        passes), (h, w, mb)
        data, l1, l2 = got
        cut = data[:l1 + l2 // 2]
        flipped = bytearray(data)
        if l2:
            flipped[l1 + int(rng.integers(0, l2))] ^= 0x5A
        for args in ((data, l1, l2), (cut, l1, l2 // 2),
                     (bytes(flipped), l1, l2), (data[:l1], l1, 0)):
            q = t1_native.ht_decode_cblk_refined(*args, passes, w, h, mb)
            want = ref_native.ht_decode_cblk_refined(*args, passes, w, h, mb)
            np.testing.assert_array_equal(q[0], want[0])
            np.testing.assert_array_equal(q[1], want[1])
        blocks.append((mag, neg, mb, data, l1, l2))
    # the batch encode over band planes, one block a plane
    signed = [np.where(n > 0, -m.astype(np.int64), m).astype(np.int32)
              for (m, n, *_r) in blocks]
    # float32 planes: each sample the signed value (cut to 20 bits, which
    # float32 holds) plus up to 0.4 of a step either way, times its step
    steps = [0.5 + 0.25 * i for i in range(len(blocks))]
    floats = [((s >> max(0, mb - 20)) + rng.uniform(-0.4, 0.4, s.shape))
              .astype(np.float32) * np.float32(st)
              for s, st, mb in zip(signed, steps, (b[2] for b in blocks))]
    descs = [(i, 0, 0, m.shape[1], m.shape[0])
             for i, (m, *_r) in enumerate(blocks)]
    mbs = [b[2] for b in blocks]
    mbs[0], mbs[1] = 0, 1
    for planes, st in ((signed, None), (floats, steps)):
        want = []
        for i, p in enumerate(planes):
            if st is None:
                m, n = np.abs(p.astype(np.int64)), p < 0
            else:
                m = np.floor(np.abs(p.astype(np.float64)) / st[i])
                n = p < 0
            m, n = m.astype(np.uint32), n.astype(np.uint8)
            want.append((ref_native.ht_encode_cblk(m, n, mbs[i]),) if
                        mbs[i] < 2 else
                        ref_native.ht_encode_cblk_refined(m, n, mbs[i],
                                                          passes))
        for nt in (1, 4):
            got = t1_native.ht_encode_refined_batch_bands(
                planes, descs, mbs, passes, stepsizes=st, nthreads=nt)
            assert [g[0] for g in got] == [w[0] for w in want]
            assert [g[1:] for g, w in zip(got, want) if len(w) == 3] == \
                [w[1:] for w in want if len(w) == 3]
    # the band decode: refined jobs whole and cut, plain cleanup jobs
    jobs = []
    for (mag, neg, mb, data, l1, l2) in blocks:
        h, w = mag.shape
        jobs.append((data, [l1, l2], w, h, 0, 2, passes, mb))
        jobs.append((data[:l1 + l2 // 3], [l1, l2], w, h, 0, 2, passes, mb))
        plain = ref_native.ht_encode_cblk(mag, neg, mb)
        jobs.append((plain, [len(plain)], w, h, 0, 1, 1, mb))
    places = [(i, 0, 0) for i in range(len(jobs))]
    for dtype, st in ((np.int32, None),
                      (np.float32, [0.25 + 0.5 * i for i in range(len(jobs))])):
        want = [np.zeros((j[3], j[2]), dtype) for j in jobs]
        assert ref_backend.decode_cblk_batch_bands(jobs, want, places, HT,
                                                   stepsizes=st)
        for nt in (1, 4):
            got = [np.zeros_like(b) for b in want]
            backend.decode_cblk_batch_bands(jobs, got, places, HT,
                                            stepsizes=st, nthreads=nt)
            for g, w in zip(got, want):
                np.testing.assert_array_equal(g, w)


# ---- the routes against the reference host codec

def _binary_frame(w, h, seed):
    """A 1-bit frame: its 5/3 LL band has Mb 1 (plain cleanup blocks
    beside refined ones)."""
    d = natural_image(w, h, ncomp=1, seed=seed).components[0].data
    return Image(xsiz=w, ysiz=h, components=[Component(
        data=(d > 128).astype(np.int32), prec=1, signed=False, dx=1, dy=1)])


CASES = {
    "53_gray": (lambda s: natural_image(40, 33, ncomp=1, seed=s),
                dict(numresolutions=3, cblk_w_exp=4, cblk_h_exp=4)),
    "97_rgb_tiles": (lambda s: natural_image(40, 33, ncomp=3, seed=s),
                     dict(numresolutions=3, transform=Transform.DWT_97,
                          tile_size=(24, 20), cblk_w_exp=3, cblk_h_exp=3)),
    "binary": (lambda s: _binary_frame(36, 28, s),
               dict(numresolutions=3, cblk_w_exp=4, cblk_h_exp=4)),
}
REQUESTS = ({"reduce": 1}, {"window": (5, 3, 30, 25)},
            {"window": (5, 3, 30, 25), "reduce": 1}, {"tile_index": 1})


@pytest.mark.parametrize("name", list(CASES))
def test_refined_routes_equal_reference(name, no_ht_kernel):
    """`encode`, `encode_batch` (two frames) and `Codec` (JP2) code HT
    refinement passes to the reference host encoder's streams, on the
    host coder; `decode_batch` and `decode` (reduced, windowed, a tile)
    give the reference host decoder's pixels."""
    make, kw = CASES[name]
    imgs = [make(s) for s in (3, 4)]
    params = EncoderParams(cblk_style=HT, ht_refinement=True, **kw)
    want = [_ref_encode(im, params) for im in imgs]
    plain = _ref_encode(imgs[0], dataclasses.replace(params,
                                                     ht_refinement=False))
    assert plain != want[0]
    p = convert.params_from_reference(params)
    pimgs = [convert.image_from_reference(im) for im in imgs]
    t1_native.CALLS["t1"] = 0
    assert encoder.encode(pimgs[0], p, device="cpu") == want[0]
    assert t1_native.CALLS["t1"] > 0
    assert encoder.encode_batch(pimgs, p, device="cpu") == want
    if name == "97_rgb_tiles":
        from grokimagecompression_tpu import codec as ref_codec
        with _numpy_dwt():
            ref = ref_codec.Codec(params=params, container="jp2",
                                  device=False).compress_image(imgs[1])
        assert codec.Codec(params=p, container="jp2",
                           device="cpu").compress_image(pimgs[1]) == ref
    for g, cs in zip(decoder.decode_batch(want, device="cpu"), want):
        _same_pixels(g, _ref_decode(cs))
    ntiles = len(decoder._tile_rects(decoder.read_header(want[0]).siz))
    for kw in REQUESTS:
        if kw.get("tile_index", 0) < ntiles:
            _same_pixels(decoder.decode(want[0], DecoderParams(**kw),
                                        device="cpu"),
                         _ref_decode(want[0], **kw))


def test_rate_control_with_refinement():
    """HT 9/7 at a byte target with refinement passes: the port's stream
    equals the reference's. Its step search probes the CUDA HT coder's
    cleanup totals and confirms each step with a refined encode on the
    host coder, as the reference's search does."""
    img = natural_image(32, 32, ncomp=1, seed=3)
    params = EncoderParams(numresolutions=3, transform=Transform.DWT_97,
                           cblk_style=HT, ht_refinement=True, rates=(12.0,))
    want = _ref_encode(img, params)
    assert want != _ref_encode(img, dataclasses.replace(
        params, ht_refinement=False))
    t1_native.CALLS["t1"] = 0
    assert encoder.encode(convert.image_from_reference(img),
                          convert.params_from_reference(params),
                          device="cpu") == want
    assert t1_native.CALLS["t1"] > 0


@pytest.mark.parametrize("refine", [False, True])
def test_layer_alloc_equals_reference(refine):
    """HT with an explicit rate allocator (two layers): each block's
    cleanup goes to the allocator as one pass, refinement asked for or
    not (the allocator drops it, as the reference's `encode_tile` does):
    the reference host encoder's stream through `encode` and
    `encode_batch`, coded on the CUDA HT coder's route (the host coder
    not called), decoded at each layer to the host decoder's pixels."""
    img = natural_image(40, 33, ncomp=3, seed=5)
    params = EncoderParams(numresolutions=3, cblk_style=HT, numlayers=2,
                           ht_refinement=refine, cblk_w_exp=4, cblk_h_exp=4)
    from grokimagecompression_tpu.codestream import pcrd as ref_pcrd
    rates = dict(rates=(20.0, 10.0))
    with _numpy_dwt():
        want = ref_encoder.encode(img, params, layer_alloc=ref_pcrd
                                  .make_layer_alloc(img, dataclasses.replace(
                                      params, **rates)), device=False)
    pimg = convert.image_from_reference(img)
    p = convert.params_from_reference(params)
    alloc = pcrd.make_layer_alloc(pimg, dataclasses.replace(p, **rates))
    t1_native.CALLS["t1"] = 0
    assert encoder.encode(pimg, p, layer_alloc=alloc, device="cpu") == want
    assert encoder.encode_batch([pimg, pimg], p, layer_alloc=alloc,
                                device="cpu") == [want, want]
    for layers in (1, 0):
        _same_pixels(decoder.decode(want, DecoderParams(layers=layers),
                                    device="cpu"),
                     _ref_decode(want, layers=layers))
    assert t1_native.CALLS["t1"] == 0


def _deep_image(prec, w=24, h=20):
    """`chip_smoke.deep_frame` at `prec` bits, cut to w x h, as the
    reference's Image."""
    d = chip_smoke.deep_frame(w, prec=prec).components[0].data[:h, :w]
    return Image(xsiz=w, ysiz=h, components=[Component(
        data=d.copy(), prec=prec, signed=False, dx=1, dy=1)])


def test_deep_bands_take_the_host_decoder():
    """At 28 bits (5/3, one guard bit) the HH bands' Mb is 30: the port's
    encode (the CUDA HT coder's route) equals the reference's stream, and
    its decode runs on the host cleanup decoder (the plan's coder is
    "t1", no HT decoder) to the host decoder's pixels, whole, reduced and
    windowed; at 27 bits (Mb 29, Mb + 3 = 32) it stays on the HT
    decoder's route."""
    for prec, coder in ((28, "t1"), (27, "ht")):
        img = _deep_image(prec)
        params = EncoderParams(numresolutions=3, cblk_style=HT,
                               tile_size=(16, 12))
        want = _ref_encode(img, params)
        assert encoder.encode(convert.image_from_reference(img),
                              convert.params_from_reference(params),
                              device="cpu") == want
        hdr, trs, parsed = decoder.parse_batch([want])
        kmax = max(bp.kmax for tj in parsed[0][0] for bp in
                   tj.plans[0].bands.values())
        assert kmax == prec + 2
        plans = decoder.tile_groups(hdr, trs, parsed)
        assert {p.coder for p in plans} == {coder}
        t1_native.CALLS["t1"] = 0
        for kw in ({}, {"reduce": 1}, {"window": (3, 2, 20, 17)}):
            got = decoder.decode(want, DecoderParams(**kw), device="cpu")
            _same_pixels(got, _ref_decode(want, **kw))
            if not kw:
                np.testing.assert_array_equal(got.components[0].data,
                                              img.components[0].data)
        assert (t1_native.CALLS["t1"] > 0) == (coder == "t1")


def test_truncated_refined_streams_decode_like_reference():
    """A refined codestream cut at 95 % down to 40 % of its length decodes
    to the reference host decoder's pixels (its decoders clamp the
    segment lengths to the bytes present), or both raise the same error."""
    img = natural_image(48, 40, ncomp=1, seed=9)
    cs = _ref_encode(img, EncoderParams(numresolutions=3, cblk_style=HT,
                                        ht_refinement=True, cblk_w_exp=4,
                                        cblk_h_exp=4))
    for frac in (0.95, 0.8, 0.6, 0.4):
        cut = cs[:int(len(cs) * frac)]
        try:
            want = _ref_decode(cut)
        except Exception as e:      # the reference's own error
            with pytest.raises(type(e)):
                decoder.decode(cut, device="cpu")
            continue
        _same_pixels(decoder.decode(cut, device="cpu"), want)


def test_refined_passes_across_layers_parse_natively():
    """A refined stream whose blocks put one pass in each of three layers
    (an allocator that the encoder never runs with refinement, written
    here through `write_codestream`): the port's native T2 parser takes
    the HT sets as [cleanup][SigProp + MagRef] across layers (three pieces
    a block, within `t2_native.CHUNKS`), and the decodes at layers 1, 2
    and 3 give the reference host decoder's pixels."""
    from grokimagecompression_tpu_torch.models import fused_encode
    from grokimagecompression_tpu_torch.native import t2_native
    img = natural_image(40, 33, ncomp=1, seed=6)
    p = convert.params_from_reference(EncoderParams(
        numresolutions=3, cblk_style=HT, ht_refinement=True, numlayers=3,
        cblk_w_exp=4, cblk_h_exp=4))
    pimg = convert.image_from_reference(img)
    _, siz, cod, qcd, cod_comp, trs = encoder._coding(pimg, p)
    (enc,) = encoder._tile_encoders(p, siz, cod, qcd, cod_comp, trs,
                                    torch.device("cpu"), False)
    (segs,) = fused_encode.encode_tile_collect(fused_encode.encode_tile_submit(
        [c.data for c in pimg.components], enc))
    assert {s[2] for s in segs} == {3}

    def one_pass_a_layer(ctx):
        for cb in ctx.cblks:
            cb.layer_npasses = [1] * cb.numpasses

    cs = encoder.write_codestream(pimg, p, {0: segs},
                                  layer_alloc=one_pass_a_layer)
    assert t2_native._chunk_cap(30, HT) == t2_native.CHUNKS >= 3
    for layers in (1, 2, 3):
        _same_pixels(decoder.decode(cs, DecoderParams(layers=layers),
                                    device="cpu"),
                     _ref_decode(cs, layers=layers))


def test_reference_device_batch_drops_refinement():
    """The reference's device `encode_batch` of two same-geometry frames
    writes plain cleanup streams with `ht_refinement=True` (its `fusable`
    never reads the flag); its host `encode` codes the refinement, and so
    does every entry point of the port (ROADMAP Queue C)."""
    import jax
    jax.config.update("jax_platforms", "cpu")
    imgs = [natural_image(16, 16, ncomp=1, seed=s) for s in (1, 2)]
    params = EncoderParams(numresolutions=2, cblk_style=HT,
                           ht_refinement=True)
    with _numpy_dwt():
        device = ref_encoder.encode_batch(imgs, params, device=True)
    plain = [_ref_encode(im, dataclasses.replace(params, ht_refinement=False))
             for im in imgs]
    host = [_ref_encode(im, params) for im in imgs]
    assert device == plain != host
    assert encoder.encode_batch([convert.image_from_reference(im)
                                 for im in imgs],
                                convert.params_from_reference(params),
                                device="cpu") == host


# ---- the digest file of chip_smoke.py phase 25 and of the gpu case

SMALL = dict(numresolutions=4, transform=Transform.DWT_97, cblk_style=HT,
             ht_refinement=True, cblk_w_exp=5, cblk_h_exp=5)


def _small_image():
    return natural_image(96, 80, ncomp=3, seed=9)


def small_digests():
    """The gpu case's frame, the reference host encoder's stream of it
    (SMALL) and the host decoder's pixels. Numpy DWT."""
    img = _small_image()
    cs = _ref_encode(img, EncoderParams(**SMALL))
    return {"frame": chip_smoke.frame_digest(img),
            "stream": hashlib.sha256(cs).hexdigest(),
            "pixels": chip_smoke.frame_digest(_ref_decode(cs))}


def cli_digests(d):
    """The reference tools' outputs of `chip_smoke.REFINE_CLI_CASES` on
    `chip_smoke.cli_inputs`, by case and file (SHA-256)."""
    from grokimagecompression_tpu.cli import compress, decompress, dump
    chip_smoke.cli_inputs(d)
    with _numpy_dwt():
        return chip_smoke.run_cli_cases(
            d, {"compress": compress, "decompress": decompress,
                "dump": dump}, cases=chip_smoke.REFINE_CLI_CASES)


def full_digests():
    """`chip_smoke.py` phase 25's digests: the reference host codec on
    config 1's first REFINE_C1_FRAMES frames (`refine_params` "c1"),
    config-2 frame 0 ("c2": whole, reduce 1, REFINE_WINDOW; "alloc": the
    allocator of REFINE_ALLOC_RATES, whole and at layers 1) and
    `deep_frame` ("deep"). Numpy DWT."""
    from grokimagecompression_tpu.codestream import pcrd as ref_pcrd
    from grokimagecompression_tpu.core.params import DecoderParams as RefD

    def params(case):
        return chip_smoke.refine_params(EncoderParams, Transform, case)

    c1 = [_ref_image(im) for im in
          chip_smoke.config1_frames(chip_smoke.REFINE_C1_FRAMES)]
    c1_streams = [_ref_encode(im, params("c1")) for im in c1]
    for cs, im in zip(c1_streams, c1):
        np.testing.assert_array_equal(_ref_decode(cs).components[0].data,
                                      im.components[0].data)
    (c2,) = [_ref_image(im) for im in chip_smoke.config2_frames(1)]
    refined = _ref_encode(c2, params("c2"))
    alloc_params = params("alloc")
    with _numpy_dwt():
        alloc = ref_encoder.encode(c2, alloc_params, layer_alloc=ref_pcrd
                                   .make_layer_alloc(c2, dataclasses.replace(
                                       alloc_params,
                                       rates=chip_smoke.REFINE_ALLOC_RATES)),
                                   device=False)
    deep = _ref_image(chip_smoke.deep_frame())
    deep_cs = _ref_encode(deep, params("deep"))
    with _numpy_dwt():
        deep_px = ref_decoder.decode(deep_cs, RefD(), device=False)
    np.testing.assert_array_equal(deep_px.components[0].data,
                                  deep.components[0].data)

    def sha(cs):
        return hashlib.sha256(cs).hexdigest()

    def px(cs, **kw):
        return chip_smoke.frame_digest(_ref_decode(cs, **kw))
    return {
        "c1": {"frames": [chip_smoke.frame_digest(im) for im in c1],
               "streams": [sha(cs) for cs in c1_streams]},
        "c2": {"frame": chip_smoke.frame_digest(c2), "stream": sha(refined),
               "pixels": px(refined), "reduce1": px(refined, reduce=1),
               "window": px(refined, window=chip_smoke.REFINE_WINDOW)},
        "alloc": {"stream": sha(alloc), "pixels": px(alloc),
                  "layers1": px(alloc, layers=1)},
        "deep": {"frame": chip_smoke.frame_digest(deep),
                 "stream": sha(deep_cs)},
    }


WHAT = ("HT refinement passes, HT under an explicit allocator and deep HT "
        "bands (chip_smoke.py phase 25 and tests/test_torch_ht_refine.py's "
        "gpu case): the grokimagecompression_tpu host encoder's streams "
        "(SHA-256) and host decoder's pixels (chip_smoke.frame_digest), "
        "numpy DWT. 'small': natural_image(96, 80, ncomp=3, seed=9) at "
        "test_torch_ht_refine.SMALL; 'cli': the reference tools at "
        "chip_smoke.REFINE_CLI_CASES; 'c1', 'c2', 'alloc', 'deep': "
        "chip_smoke.refine_params' cases on config1_frames(8), "
        "config2_frames(1) (reduce 1 and REFINE_WINDOW too; 'alloc' under "
        "pcrd.make_layer_alloc at REFINE_ALLOC_RATES, layers 1 too) and "
        "deep_frame(); tests/test_torch_ht_refine.py writes it")


def test_digest_file_small_cases_are_current(tmp_path):
    """`data/ht_refine.json`'s small case and tool cases equal the
    reference's outputs now, and the port's tools on the CPU make the
    same files."""
    from grokimagecompression_tpu_torch.cli import compress, decompress, dump
    with open(os.path.join(REPO, chip_smoke.HT_REFINE_DIGESTS)) as f:
        want = json.load(f)
    assert want["what"] == WHAT
    assert want["small"] == small_digests()
    ref_dir, port_dir = tmp_path / "ref", tmp_path / "port"
    ref_dir.mkdir()
    port_dir.mkdir()
    assert want["cli"] == cli_digests(str(ref_dir))
    chip_smoke.cli_inputs(str(port_dir))
    t1_native.CALLS["t1"] = 0
    assert chip_smoke.run_cli_cases(
        str(port_dir), {"compress": compress, "decompress": decompress,
                        "dump": dump}, extra=["--torch-device", "cpu"],
        cases=chip_smoke.REFINE_CLI_CASES) == want["cli"]
    assert t1_native.CALLS["t1"] >= len(chip_smoke.REFINE_CLI_CASES)


def test_refined_request_on_a_mesh_raises():
    """A refined request on a mesh of two shards raises the transform-only
    mesh route's NotImplementedError, encode and decode; a deep HT stream
    too."""
    img = natural_image(32, 24, ncomp=1, seed=8)
    params = EncoderParams(numresolutions=2, cblk_style=HT,
                           ht_refinement=True, tile_size=(16, 12))
    mesh = ["cpu", "cpu"]
    with pytest.raises(NotImplementedError, match="HT refinement passes "
                       "on a mesh of 2 shards"):
        encoder.encode(convert.image_from_reference(img),
                       convert.params_from_reference(params), mesh=mesh)
    for cs in (_ref_encode(img, params),
               _ref_encode(_deep_image(28), EncoderParams(
                   numresolutions=2, cblk_style=HT))):
        with pytest.raises(NotImplementedError, match="mesh of 2 shards"):
            decoder.decode_batch([cs], mesh=mesh)


# ---- on the card

@pytest.mark.gpu
def test_cuda_refined_encode_and_decode_equal_digests():
    """On the card a refined 9/7 RGB encode launches the DWT kernel, calls
    the host coder and launches no HT encoder, and its stream is the
    reference host encoder's (`data/ht_refine.json` 'small'); its decode
    launches the DWT and no HT decoder and gives the host decoder's
    pixels."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from grokimagecompression_tpu_torch.ops import dwt
    with open(os.path.join(REPO, chip_smoke.HT_REFINE_DIGESTS)) as f:
        want = json.load(f)["small"]
    img = convert.image_from_reference(_small_image())
    assert chip_smoke.frame_digest(img) == want["frame"]
    params = convert.params_from_reference(EncoderParams(**SMALL))
    dwt.LAUNCHES["dwt"] = ht_enc.LAUNCHES["enc"] = 0
    t1_native.CALLS["t1"] = 0
    cs = encoder.encode(img, params, device="cuda")
    assert hashlib.sha256(cs).hexdigest() == want["stream"]
    assert dwt.LAUNCHES["dwt"] >= 1 and t1_native.CALLS["t1"] >= 1
    assert ht_enc.LAUNCHES["enc"] == 0
    dwt.LAUNCHES["dwt"] = ht_dec.LAUNCHES["dec"] = 0
    got = decoder.decode(cs, device="cuda")
    assert chip_smoke.frame_digest(got) == want["pixels"]
    assert dwt.LAUNCHES["dwt"] >= 1 and ht_dec.LAUNCHES["dec"] == 0


if __name__ == "__main__":
    import tempfile
    with tempfile.TemporaryDirectory() as d:
        out = {"what": WHAT, "small": small_digests(),
               "cli": cli_digests(d), **full_digests()}
    with open(os.path.join(REPO, chip_smoke.HT_REFINE_DIGESTS), "w") as f:
        json.dump(out, f, indent=1)
        f.write("\n")
