"""The MQ code-block styles other than the default, on the host Tier-1 route.

The port codes the Part-1 MQ code-block styles BYPASS (0x01), RESET
(0x02), TERMALL (0x04), VSC (0x08), PTERM (0x10) and SEGMARK (0x20), alone
or together, as the reference does with its device: the transform on the
device, then the host library's Tier-1 coder (`csrc/host/t1.cpp`, a copy
of the reference's `native/src/t1.cpp`; `native/t1_native.py`,
`t1/backend.py`), then the port's T2 and rate allocation; the decode runs
that coder into band planes and inverts them on the device. Held here:

- the host coder against the reference's native coder and its Python
  coder (`t1_np`) at every style and shape, truncated segments included,
  and its batch entries at 1 and 4 threads;
- `encode`, `encode_batch`, `Codec` and `StreamEncoder` byte-equal to
  the reference host encoder (numpy DWT), 5/3 and 9/7, rates, PSNR,
  image-wide PCRD, COC;
- `decode_batch` and `decode` (windows, reductions, tiles, layers)
  pixel-equal to the reference host decoder, with COC styles, ROI and
  bands deeper than the CUDA MQ decoder's word;
- the routing: the default MQ style and the HT style never reach the
  host coder (`t1_native.CALLS`), and what is left raises;
- the digest files of `chip_smoke.py` phase 24
  (`data/config1_mq_styles.json`, `data/config2_mq_styles.json`).

Rewrite the digest files with `PYTHONPATH=.:tests python
tests/test_torch_t1_styles.py` from the repository root. The `gpu` case
runs on the card with `GROK_TPU_TESTS=1 python -m pytest
tests/test_torch_t1_styles.py -m gpu` (this file imports only the
reference's host codec at module level, which imports no JAX).
"""

import contextlib
import dataclasses
import functools
import hashlib
import io
import json
import os
import sys

import numpy as np
import pytest
import torch

from grokimagecompression_tpu.codestream import decoder as ref_decoder
from grokimagecompression_tpu.codestream import encoder as ref_encoder
from grokimagecompression_tpu.codestream import markers as ref_markers
from grokimagecompression_tpu.core.image import Component, Image
from grokimagecompression_tpu.core.params import DecoderParams as RefDParams
from grokimagecompression_tpu.core.params import EncoderParams, Transform
from grokimagecompression_tpu_torch import codec, convert
from grokimagecompression_tpu_torch.codestream import decoder, encoder, stream
from grokimagecompression_tpu_torch.core.params import DecoderParams
from grokimagecompression_tpu_torch.native import t1_native
from grokimagecompression_tpu_torch.t1 import backend

from conftest import natural_image

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
import chip_smoke  # noqa: E402

HT = 0x40
STYLES = (0x01, 0x02, 0x04, 0x08, 0x10, 0x20, 0x14, 0x3F)
SHAPES = ((1, 1), (1, 64), (64, 1), (7, 13), (4, 1024), (64, 64))


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Torch on one thread: the plain versions run many small CPU ops, and
    under pytest-xdist's workers torch's OpenMP threads oversubscribe the
    cores and spin (a case of 2.4 s alone took 43 s among six workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@contextlib.contextmanager
def _numpy_dwt():
    """The reference host codec with its numpy DWT only (`dwt_host`'s
    dispatch, the decoder's packed native inverse and its windowed one),
    which the port's DWT equals bit for bit."""
    from grokimagecompression_tpu.ops import dwt_host, dwt_window
    native, env = dwt_host._get_native, os.environ.get("GROK_TPU_DWT")
    checked = (dwt_window._NAT, dwt_window._NAT_CHECKED)
    dwt_host._get_native = lambda: None
    os.environ["GROK_TPU_DWT"] = "python"
    dwt_window._NAT, dwt_window._NAT_CHECKED = None, False
    try:
        yield
    finally:
        dwt_host._get_native = native
        dwt_window._NAT, dwt_window._NAT_CHECKED = checked
        if env is None:
            del os.environ["GROK_TPU_DWT"]
        else:
            os.environ["GROK_TPU_DWT"] = env


def _ref_encode(img, params):
    with _numpy_dwt():
        return ref_encoder.encode(img, params, device=False)


def _ref_decode(cs, **kw):
    with _numpy_dwt():
        return ref_decoder.decode(cs, RefDParams(**kw), device=False)


def _same_pixels(got, want):
    assert (got.x0, got.y0, got.xsiz, got.ysiz) == \
        (want.x0, want.y0, want.xsiz, want.ysiz)
    assert len(got.components) == len(want.components)
    for c, (g, w) in enumerate(zip(got.components, want.components)):
        np.testing.assert_array_equal(g.data, w.data, err_msg=f"comp {c}")


# ---- the host coder against the reference's coders

def _block(rng, h, w, planes):
    mag = (rng.integers(0, 1 << planes, (h, w))
           * (rng.random((h, w)) < 0.6)).astype(np.uint32)
    return mag, rng.integers(0, 2, (h, w)).astype(np.uint8)


def _passes(passes):
    return [(p.rate, p.distortion, p.terminated) for p in passes]


def _segments(passes, k):
    """The codeword segment lengths of the first `k` passes and the bytes
    they take (T2's reading of the pass table)."""
    segs, start = [], 0
    for i, p in enumerate(passes[:k]):
        if p.terminated or i == k - 1:
            segs.append(p.rate - start)
            start = p.rate
    return segs, start


@pytest.mark.parametrize("style", STYLES, ids=[f"{s:#04x}" for s in STYLES])
def test_host_coder_equals_reference_coders(style):
    """Per block, `t1_native.encode_cblk` / `decode_cblk` equal the
    reference's native coder and its Python coder (segments, numbps, the
    pass tables' rates, distortions and terminations; magnitudes and
    signs) at every shape, whole and cut to half its passes; the batch
    entries equal them at 1 and 4 threads, `decode_cblk_batch_bands` the
    reference's on float32 planes with steps."""
    from grokimagecompression_tpu.native import t1_native as ref_native
    from grokimagecompression_tpu.t1 import t1_np
    rng = np.random.default_rng(style)
    blocks = []
    for i, (h, w) in enumerate(SHAPES):
        mag, neg = _block(rng, h, w, 9 if h * w > 64 else 5)
        orient = i % 4
        got = t1_native.encode_cblk(mag, neg, orient, style)
        for want in (ref_native.encode_cblk(mag, neg, orient, style),
                     t1_np.encode_cblk(mag, neg, orient, style)):
            assert got[:3] == want[:3], (h, w)
            assert _passes(got[3]) == _passes(want[3]), (h, w)
        data, nb, npas, passes = got
        for k in (npas, max(1, npas // 2)):
            segs, n = _segments(passes, k)
            args = (data[:n], segs, w, h, orient, nb, k, style)
            out = t1_native.decode_cblk(*args)
            for want in (ref_native.decode_cblk(*args),
                         t1_np.decode_cblk(*args)):
                np.testing.assert_array_equal(out[0], want[0])
                np.testing.assert_array_equal(out[1], want[1])
            if k == npas:
                np.testing.assert_array_equal(out[0], mag)
                np.testing.assert_array_equal(out[1] & (mag != 0),
                                              neg & (mag != 0))
            blocks.append((args, mag, neg))
    per_block = [t1_native.encode_cblk(m, n, i % 4, style)
                 for i, ((_, _, w, h, *_), m, n) in enumerate(blocks)]
    for nt in (1, 4):
        got = t1_native.encode_cblk_batch(
            [(m, n, i % 4) for i, (_, m, n) in enumerate(blocks)], style,
            nthreads=nt)
        assert [g[:3] for g in got] == [p[:3] for p in per_block]
        assert [_passes(g[3]) for g in got] == \
            [_passes(p[3]) for p in per_block]
        dec = backend.decode_cblk_batch([a[:7] for a, _, _ in blocks],
                                        style, signed_out=True, nthreads=nt)
        for (a, _, _), d in zip(blocks, dec):
            mag, neg = t1_native.decode_cblk(*a)
            np.testing.assert_array_equal(
                d, np.where(neg > 0, -mag.astype(np.int64), mag))
    # the band decode: every block into its own float32 plane, with steps
    steps = [0.5 + 0.25 * i for i in range(len(blocks))]
    jobs = [a[:7] for a, _, _ in blocks]
    places = [(i, 0, 0) for i in range(len(blocks))]
    want = [np.zeros((a[3], a[2]), np.float32) for a in jobs]
    ref_native.decode_cblk_batch_bands(jobs, want, places, style,
                                       stepsizes=steps)
    for nt in (1, 4):
        got = [np.zeros_like(b) for b in want]
        backend.decode_cblk_batch_bands(jobs, got, places, style,
                                        stepsizes=steps, nthreads=nt)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)


# ---- the encode routes against the reference host encoder

ENCODES = {
    "53_lazy": dict(numresolutions=3, cblk_style=0x01, cblk_w_exp=4,
                    cblk_h_exp=4),
    "97_rates_all": dict(numresolutions=3, transform=Transform.DWT_97,
                         cblk_style=0x3F, numlayers=3,
                         rates=(8.0, 4.0, 2.0), cblk_w_exp=4, cblk_h_exp=4),
    "97_psnr_termall_pterm": dict(numresolutions=3, cblk_style=0x14,
                                  transform=Transform.DWT_97,
                                  quality_psnr=(30.0, 40.0),
                                  tile_size=(16, 16), cblk_w_exp=3,
                                  cblk_h_exp=3),
    "global_reset_vsc": dict(numresolutions=3, cblk_style=0x0A,
                             tile_size=(24, 24), rates=(6.0,),
                             rate_alloc="global", cblk_w_exp=3,
                             cblk_h_exp=3),
    "coc_segmark": dict(numresolutions=3, cblk_style=0x20,
                        comp_cblk_exps={1: (3, 3)}, cblk_w_exp=4,
                        cblk_h_exp=4),
}


@functools.lru_cache(maxsize=None)
def _encode_case(name):
    """Two frames, the case's parameters, and the reference host
    encoder's streams of them."""
    imgs = [natural_image(40, 33, ncomp=3, seed=s) for s in (3, 4)]
    params = EncoderParams(**ENCODES[name])
    return imgs, params, [_ref_encode(im, params) for im in imgs]


@pytest.mark.parametrize("name", list(ENCODES))
def test_encode_routes_equal_reference(name):
    """`encode`, `encode_batch` and `Codec` (JP2) code the styles on the
    host Tier-1 route to the reference host encoder's streams."""
    imgs, params, want = _encode_case(name)
    p = convert.params_from_reference(params)
    pimgs = [convert.image_from_reference(im) for im in imgs]
    t1_native.CALLS["t1"] = 0
    assert encoder.encode(pimgs[0], p, device="cpu") == want[0]
    assert t1_native.CALLS["t1"] > 0
    assert encoder.encode_batch(pimgs, p, device="cpu") == want
    if name == "53_lazy":
        from grokimagecompression_tpu import codec as ref_codec
        with _numpy_dwt():
            ref = ref_codec.Codec(params=params, container="jp2",
                                  device=False).compress_image(imgs[1])
        got = codec.Codec(params=p, container="jp2",
                          device="cpu").compress_image(pimgs[1])
        assert got == ref


@pytest.mark.parametrize("style", [0x01, 0x3F])
def test_stream_encoder_equals_reference(style):
    """`StreamEncoder` codes a styled tile on the host Tier-1 route; its
    file equals the reference `StreamEncoder`'s, and its tile-parts
    `encode`'s with TLM."""
    from grokimagecompression_tpu.codestream import stream as ref_stream
    img = natural_image(40, 33, ncomp=3, seed=5)
    params = EncoderParams(numresolutions=3, cblk_style=style,
                           tile_size=(16, 16), cblk_w_exp=3, cblk_h_exp=3)
    buf = io.BytesIO()
    with _numpy_dwt():
        se = ref_stream.StreamEncoder(buf, img, params)
        for t in range(se.numtiles):
            se.write_image_tile(t, img)
        se.close()
    got = io.BytesIO()
    pimg = convert.image_from_reference(img)
    with stream.StreamEncoder(got, pimg, convert.params_from_reference(
            params), device="cpu") as pse:
        for t in range(pse.numtiles):
            pse.write_image_tile(t, pimg)
    assert got.getvalue() == buf.getvalue()
    whole = encoder.encode(pimg, convert.params_from_reference(
        dataclasses.replace(params, tlm_markers=True)), device="cpu")
    hdr = decoder.read_header(whole)
    assert got.getvalue()[decoder.read_header(got.getvalue())
                          .main_header_end:] == whole[hdr.main_header_end:]


# ---- the decode routes against the reference host decoder

REQUESTS = ({}, {"layers": 1}, {"reduce": 1}, {"window": (5, 3, 30, 25)},
            {"window": (5, 3, 30, 25), "reduce": 1, "layers": 2})


def _splice_main(cs, segment):
    end = ref_decoder.read_header(cs).main_header_end
    return cs[:end] + segment + cs[end:]


def _decode_cases():
    """(name, stream) of the decode cases: the encode cases' first
    streams, a 9/7 stream in tiles, and COC streams: a COC that gives
    component 1 more styles of the same segmentation (a T1 group of two
    styles) and ROI with COC on a styled 9/7 stream whose blocks are
    truncated (plane-0 reconstruction)."""
    img = natural_image(40, 33, ncomp=3, seed=3)
    out = [(n, _encode_case(n)[2][0]) for n in ("53_lazy", "97_rates_all")]
    tiled = _ref_encode(img, EncoderParams(
        numresolutions=3, transform=Transform.DWT_97, cblk_style=0x14,
        numlayers=2, rates=(6.0, 3.0), tile_size=(24, 20), cblk_w_exp=3,
        cblk_h_exp=3))
    out.append(("97_tiles", tiled))
    lazy = out[0][1]
    cod = ref_decoder.read_header(lazy).cod
    out.append(("coc_styles", _splice_main(lazy, ref_markers.write_coc(
        1, dataclasses.replace(cod, cblk_style=0x0B), 3))))
    out.append(("roi_coc", _ref_encode(img, EncoderParams(
        numresolutions=3, transform=Transform.DWT_97, cblk_style=0x01,
        roi_comp=0, roi_shift=3, comp_cblk_exps={1: (3, 3)}, numlayers=2,
        rates=(8.0, 4.0), cblk_w_exp=4, cblk_h_exp=4))))
    return out


def test_decode_routes_equal_reference():
    """`decode_batch` (two streams of each case as one batch) and
    `decode` at every request (layers, a reduction, a window, all three,
    and each tile of a tiled stream) equal the reference host decoder's
    pixels, on the host Tier-1 route."""
    for name, cs in _decode_cases():
        t1_native.CALLS["t1"] = 0
        got = decoder.decode_batch([cs, cs], device="cpu")
        assert t1_native.CALLS["t1"] > 0, name
        want = _ref_decode(cs)
        for g in got:
            _same_pixels(g, want)
        ntiles = len(decoder._tile_rects(decoder.read_header(cs).siz))
        for kw in REQUESTS + tuple({"tile_index": t} for t in range(ntiles)
                                   if ntiles > 1):
            _same_pixels(decoder.decode(cs, DecoderParams(**kw),
                                        device="cpu"), _ref_decode(cs, **kw))


def test_deep_mq_bands_take_the_host_decoder():
    """An MQ stream of the default style whose ROI shift takes a band's
    Kmax past the CUDA MQ decoder's 30 planes decodes on the host Tier-1
    route (its plan's coder is "t1") to the host decoder's pixels; at
    Kmax 30 it stays on the MQ decoder's route. (8-bit 5/3 with two guard
    bits: the HH bands' Kmax is 11 before the shift.)"""
    img = natural_image(24, 20, ncomp=1, seed=6)
    for shift, coder in ((19, "mq"), (20, "t1")):
        cs = _ref_encode(img, EncoderParams(numresolutions=2, roi_comp=0,
                                            roi_shift=shift))
        hdr, trs, parsed = decoder.parse_batch([cs])
        (plan,) = decoder.tile_plans(hdr, trs[0], parsed[0][0][0])
        assert max(b.kmax for b in parsed[0][0][0].plans[0].bands.values()) \
            == 11 + shift
        assert plan.coder == coder
        if coder == "t1":
            _same_pixels(decoder.decode(cs, device="cpu"), _ref_decode(cs))


def test_tools_at_mq_styles_equal_reference(tmp_path):
    """`grk_compress -M 1` and `-M 63` (9/7 at two ratios) and
    `grk_decompress` of their files (the second at layer 1) through the
    port's tools on the CPU equal the reference tools' files
    (`chip_smoke.CLI_CASES`' MQ-style cases in `data/cli.json`)."""
    from grokimagecompression_tpu_torch.cli import compress, decompress, dump
    with open(os.path.join(REPO, chip_smoke.CLI_DIGESTS)) as f:
        want = json.load(f)["cases"]
    cases = [c for c in chip_smoke.CLI_CASES if c[0].startswith("MQ styles")]
    assert len(cases) == 4
    chip_smoke.cli_inputs(str(tmp_path))
    t1_native.CALLS["t1"] = 0
    got = chip_smoke.run_cli_cases(
        str(tmp_path), {"compress": compress, "decompress": decompress,
                        "dump": dump}, extra=["--torch-device", "cpu"],
        cases=cases)
    assert got == {c[0]: want[c[0]] for c in cases}
    assert t1_native.CALLS["t1"] > 0


# ---- routing and refusals

def test_default_style_and_ht_never_reach_the_host_coder():
    """The default MQ style and the HT style code and decode on their
    kernels' routes: no call of the host coder. The HT refinement flag
    on an MQ request changes nothing (the reference codes the plain MQ
    stream), and a styled request calls the host coder."""
    img = natural_image(16, 12, ncomp=1, seed=7)
    pimg = convert.image_from_reference(img)
    for params in (EncoderParams(numresolutions=2, cblk_style=0),
                   EncoderParams(numresolutions=2, cblk_style=HT),
                   EncoderParams(numresolutions=2, cblk_style=0,
                                 ht_refinement=True)):
        t1_native.CALLS["t1"] = 0
        cs = encoder.encode(pimg, convert.params_from_reference(params),
                            device="cpu")
        assert cs == _ref_encode(img, params)
        _same_pixels(decoder.decode(cs, device="cpu"), _ref_decode(cs))
        assert t1_native.CALLS["t1"] == 0
    t1_native.CALLS["t1"] = 0
    encoder.encode(pimg, convert.params_from_reference(EncoderParams(
        numresolutions=2, cblk_style=0x08)), device="cpu")
    assert t1_native.CALLS["t1"] > 0


def test_refusals_left():
    """ROI on HT code-blocks raises NotImplementedError, and so do a
    styled request and a refined HT request on a mesh of two shards (the
    reference's transform-only mesh route), encode and decode. (HT
    refinement passes, HT bands with Mb + 3 > 32 and an explicit
    allocator with the HT coder are coded now:
    tests/test_torch_ht_refine.py.)"""
    img = natural_image(32, 24, ncomp=1, seed=8)
    pimg = convert.image_from_reference(img)
    ht = _ref_encode(img, EncoderParams(numresolutions=2, cblk_style=HT))
    with pytest.raises(NotImplementedError, match="ROI shifts on HT"):
        decoder.decode_batch([_splice_main(ht, ref_markers.write_rgn(
            0, 3, 1))], device="cpu")
    mesh = ["cpu", "cpu"]
    for styled in (EncoderParams(numresolutions=2, cblk_style=0x01,
                                 tile_size=(16, 12)),
                   EncoderParams(numresolutions=2, cblk_style=HT,
                                 ht_refinement=True, tile_size=(16, 12))):
        with pytest.raises(NotImplementedError, match="mesh of 2 shards"):
            encoder.encode(pimg, convert.params_from_reference(styled),
                           mesh=mesh)
        cs = _ref_encode(img, styled)
        for fn in (decoder.decode, lambda c, mesh: decoder.decode(
                c, DecoderParams(window=(2, 2, 20, 20)), mesh=mesh),
                   lambda c, mesh: decoder.decode_batch([c], mesh=mesh)):
            with pytest.raises(NotImplementedError,
                               match="mesh of 2 shards"):
                fn(cs, mesh=mesh)


# ---- the digest files of chip_smoke.py phase 24

def _c1_params(style):
    return EncoderParams(numresolutions=6, cblk_style=style)


def _c2_params(style, rates=(24.0, 48.0, 96.0)):
    return EncoderParams(numresolutions=6, transform=Transform.DWT_97,
                         numlayers=3, rates=rates, cblk_style=style)


def _ref_image(im):
    return Image(xsiz=im.xsiz, ysiz=im.ysiz, components=[Component(
        data=c.data, prec=c.prec, signed=c.signed, dx=c.dx, dy=c.dy)
        for c in im.components])


def config1_styles_digests():
    """SHA-256 of the 64 config-1 frames (`chip_smoke.config1_frames`) and
    of the reference host encoder's streams of them at
    `chip_smoke.T1_C1_STYLE` (5/3 lossless, 6 resolutions, 64x64 blocks),
    numpy DWT."""
    imgs = chip_smoke.config1_frames(chip_smoke.FRAMES)
    params = _c1_params(chip_smoke.T1_C1_STYLE)
    return {
        "what": "BASELINE config 1 at MQ code-block style "
                f"{chip_smoke.T1_C1_STYLE:#x}: chip_smoke.config1_frames(64) "
                "and the streams of grokimagecompression_tpu encoder.encode("
                "EncoderParams(numresolutions=6, cblk_style=T1_C1_STYLE), "
                "device=False), numpy DWT; tests/test_torch_t1_styles.py "
                "writes it",
        "style": chip_smoke.T1_C1_STYLE,
        "frames": [chip_smoke.frame_digest(im) for im in imgs],
        "streams": [hashlib.sha256(_ref_encode(_ref_image(im), params))
                    .hexdigest() for im in imgs],
    }


def config2_styles_digests():
    """Config-2 frame 0 (`chip_smoke.config2_frames`) through the
    reference host encoder at each of `chip_smoke.T1_C2_STYLES` (ICT +
    9/7, three layers at ratios 24 / 48 / 96, PCRD) and the host
    decoder's pixels of each stream, whole and at layers=1 (the same at
    these ratios: layers 2 and 3 are empty packets); and frame 0 at the
    style and ratios of `chip_smoke.T1_C2_LAYERED` (96 / 48 / 24, whose
    first layer holds a part of each block) with its first layer's
    pixels. Numpy DWT."""
    (img,) = chip_smoke.config2_frames(1)
    ref = _ref_image(img)
    styles = {}
    for style in chip_smoke.T1_C2_STYLES:
        cs = _ref_encode(ref, _c2_params(style))
        styles[f"{style:#x}"] = {
            "stream": hashlib.sha256(cs).hexdigest(),
            "pixels": chip_smoke.frame_digest(_ref_decode(cs)),
            "layers1": chip_smoke.frame_digest(_ref_decode(cs, layers=1)),
        }
    style, rates = chip_smoke.T1_C2_LAYERED
    cs = _ref_encode(ref, _c2_params(style, rates))
    return {
        "what": "BASELINE config 2 frame 0 (chip_smoke.config2_frames) "
                "through grokimagecompression_tpu encoder.encode("
                "EncoderParams(numresolutions=6, transform=DWT_97, "
                "numlayers=3, rates=(24, 48, 96), cblk_style=s), "
                "device=False) at each chip_smoke.T1_C2_STYLES s, and its "
                "decoder.decode pixels (chip_smoke.frame_digest) whole and "
                "at layers=1; 'layered': at chip_smoke.T1_C2_LAYERED's "
                "style and rates, decoded at layers=1; numpy DWT; "
                "tests/test_torch_t1_styles.py writes it",
        "frame": chip_smoke.frame_digest(img),
        "styles": styles,
        "layered": {"style": style, "rates": list(rates),
                    "stream": hashlib.sha256(cs).hexdigest(),
                    "layers1": chip_smoke.frame_digest(
                        _ref_decode(cs, layers=1))},
    }


def test_config1_styles_digest_file_is_current():
    with open(os.path.join(REPO, chip_smoke.T1_C1_DIGESTS)) as f:
        assert json.load(f) == config1_styles_digests()


def test_config2_styles_digest_file_is_current():
    with open(os.path.join(REPO, chip_smoke.T1_C2_DIGESTS)) as f:
        assert json.load(f) == config2_styles_digests()


# ---- on the card

@pytest.mark.gpu
def test_cuda_styled_encode_and_decode_equal_cpu():
    """On the card a styled encode (9/7, rates, all six styles) launches
    the DWT kernel and calls the host coder, and its stream equals the
    CPU route's; its decode launches the DWT kernel's inverse and no MQ
    decoder, and equals the CPU decode."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from grokimagecompression_tpu_torch.ops import dwt, mq_dec, mq_scan
    img = convert.image_from_reference(natural_image(96, 80, ncomp=3,
                                                     seed=9))
    params = convert.params_from_reference(EncoderParams(
        numresolutions=4, transform=Transform.DWT_97, cblk_style=0x3F,
        numlayers=2, rates=(8.0, 16.0), cblk_w_exp=5, cblk_h_exp=5))
    want = encoder.encode(img, params, device="cpu")
    dwt.LAUNCHES["dwt"] = mq_scan.LAUNCHES["mq"] = 0
    t1_native.CALLS["t1"] = 0
    assert encoder.encode(img, params, device="cuda") == want
    assert dwt.LAUNCHES["dwt"] >= 1 and t1_native.CALLS["t1"] >= 1
    assert mq_scan.LAUNCHES["mq"] == 0
    dwt.LAUNCHES["dwt"] = mq_dec.LAUNCHES["mq_dec"] = 0
    got = decoder.decode(want, device="cuda")
    assert dwt.LAUNCHES["dwt"] >= 1 and mq_dec.LAUNCHES["mq_dec"] == 0
    cpu = decoder.decode(want, device="cpu")
    for g, w in zip(got.components, cpu.components):
        np.testing.assert_array_equal(g.data, w.data)


if __name__ == "__main__":
    for path, make in ((chip_smoke.T1_C1_DIGESTS, config1_styles_digests),
                       (chip_smoke.T1_C2_DIGESTS, config2_styles_digests)):
        with open(os.path.join(REPO, path), "w") as f:
            json.dump(make(), f, indent=1)
            f.write("\n")
