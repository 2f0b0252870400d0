"""The requests the reference codes on its host tile path, on the port's
kernels: ROI, a custom MCT, tile-part header overrides and a COC that
changes a component's transform and resolutions. Held to the reference
on the CPU.

On the same seeded numpy inputs, with `device="cpu"` (the kernels' plain
versions) and the reference's numpy DWT (`dwt_host._get_native` None,
`GROK_TPU_DWT=python`):

- ROI streams (5/3 and 9/7 MQ, `roi_comp` 1, U 4, as the reference's
  `tests/test_markers_ext.py` ROI case, at 48x32 with 16x16 blocks; and
  9/7 with two rate-controlled layers, whose truncated blocks
  reconstruct at their lowest decoded plane, as the reference's fused
  host decode does) and custom-MCT streams (MQ and HT on 9/7, the
  reference's decoding matrix; HT also at a byte target, the reference's
  bisection by whole encodes) equal the reference host encoder's bytes,
  through `encoder.encode` and `encode_batch`, and decode to the
  reference host decoder's pixels through `decode_batch`, `decode` and
  `codec`;
- the override and COC streams of `chip_smoke.py` phase 22
  (`chip_smoke.override_stream`, `coc_stream`) decode to the reference
  host decoder's pixels, the override stream built from the port's
  streams equal to the one built from the reference's;
- an ROI stream whose COC overrides send the reference's host decode to
  its per-block route reconstructs its ROI component at plane 0 there
  (`_cblk_pmin`), and the port follows it (`pm_zero`);
- the port's plans equal the reference's: `tile.build_comp_plan(
  roishift=)`, the fused encode plan of an ROI tile
  (`convert.plan_from_reference`) and each component group's decode plan
  (`convert.dec_plan_from_reference(comps=)`);
- what the port still refuses raises with its reason: ROI on HT
  code-blocks, an MQ code-block style in a COC, a band whose Kmax with
  its ROI shift passes the MQ decoder's 30 planes, ROI with the HT coder
  (the reference's ValueError), a custom MCT off 9/7.

The `gpu` cases hold the CUDA MQ coder and MQ decoder to their plain
versions on an ROI frame's lane groups: `GROK_TPU_TESTS=1 python -m
pytest tests/test_torch_host_routes.py -m gpu` (this file imports only
the reference's host codec, which imports no JAX).
"""

import contextlib
import dataclasses
import os
import sys

import numpy as np
import pytest
import torch

from grokimagecompression_tpu.codestream import decoder as ref_decoder
from grokimagecompression_tpu.codestream import encoder as ref_encoder
from grokimagecompression_tpu.codestream import markers as ref_markers
from grokimagecompression_tpu.codestream import tile as ref_tile
from grokimagecompression_tpu.core import params as ref_params
from grokimagecompression_tpu.core.params import DecoderParams as RefDParams
from grokimagecompression_tpu.core.params import EncoderParams, Transform
from grokimagecompression_tpu_torch import codec, convert
from grokimagecompression_tpu_torch.codestream import decoder, encoder, tile
from grokimagecompression_tpu_torch.core import params as port_params
from grokimagecompression_tpu_torch.core.geometry import tile_rect
from grokimagecompression_tpu_torch.core.params import DecoderParams
from grokimagecompression_tpu_torch.models import fused_decode, fused_encode

from conftest import natural_image

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
import chip_smoke  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Torch on one thread: the plain versions run many small CPU ops, and
    under pytest-xdist's workers torch's OpenMP threads oversubscribe the
    cores and spin (a case of 2.4 s alone took 43 s among six workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


HT = 0x40
MATRIX = np.asarray(chip_smoke.CUSTOM_MCT, np.float32)
SMALL = dict(numresolutions=3, cblk_w_exp=4, cblk_h_exp=4)
CASES = {
    "roi53": dict(SMALL, transform=Transform.DWT_53, roi_comp=1,
                  roi_shift=4, mct=0),
    "roi97": dict(SMALL, transform=Transform.DWT_97, roi_comp=1,
                  roi_shift=4, mct=0),
    "roi97_layers": dict(SMALL, transform=Transform.DWT_97, roi_comp=0,
                         roi_shift=6, numlayers=2, rates=(20.0, 40.0)),
    "mct_mq": dict(SMALL, transform=Transform.DWT_97, custom_mct=MATRIX),
    "mct_ht": dict(numresolutions=3, transform=Transform.DWT_97,
                   cblk_style=HT, custom_mct=MATRIX),
}
# the per-image requests held to the host decoder on two of the cases
REQUESTS = {"mct_ht": ({"window": (5, 3, 30, 25), "reduce": 1},
                       {"tile_index": 0}),
            "roi97_layers": ({"window": (5, 3, 30, 25)}, {"layers": 1})}
_STREAMS = {}


@contextlib.contextmanager
def _numpy_dwt():
    """The reference host codec with its numpy DWT only (the port's DWT
    equals it bit for bit; its native 9/7 DWT rounds otherwise)."""
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


def _image(seed=7, w=48, h=32):
    return natural_image(w, h, ncomp=3, seed=seed)


def _host(cs, **kw):
    with _numpy_dwt():
        return ref_decoder.decode(cs, RefDParams(**kw), device=False)


def _same(got, want):
    assert (got.x0, got.y0, got.xsiz, got.ysiz) == \
        (want.x0, want.y0, want.xsiz, want.ysiz)
    assert len(got.components) == len(want.components)
    for c, (g, w) in enumerate(zip(got.components, want.components)):
        assert g.data.dtype == np.int32
        np.testing.assert_array_equal(g.data, w.data, err_msg=f"comp {c}")


def _case(name):
    """(reference image, reference params, the reference host encoder's
    stream, the port's `encoder.encode` stream) of a CASES entry; made
    once."""
    if name not in _STREAMS:
        img, params = _image(), EncoderParams(**CASES[name])
        with _numpy_dwt():
            want = ref_encoder.encode(img, params, device=False)
        got = encoder.encode(convert.image_from_reference(img),
                             convert.params_from_reference(params),
                             device="cpu")
        _STREAMS[name] = (img, params, want, got)
    return _STREAMS[name]


@pytest.mark.parametrize("name", list(CASES))
def test_encode_and_decode_equal_reference(name):
    """The stream equals the reference host encoder's byte for byte and
    carries its markers (RGN; CBD / MCT / MCC / MCO and the Part-2 rsiz),
    and `decode` (through `decode_batch`) gives the reference host
    decoder's pixels, as do a window, a reduction, a tile and a layer
    limit on two of the cases; lossless ROI also the source."""
    img, params, want, got = _case(name)
    assert got == want
    hdr = decoder.read_header(got)
    if params.roi_comp is not None:
        assert hdr.roishifts[params.roi_comp] == params.roi_shift
    if params.custom_mct is not None:
        assert hdr.cod.mct == 2 and hdr.siz.rsiz & 0x8100 == 0x8100
        np.testing.assert_array_equal(hdr.custom_mct[0], MATRIX)
    out = decoder.decode(got, device="cpu")
    _same(out, _host(got))
    for kw in REQUESTS.get(name, ()):
        _same(decoder.decode(got, DecoderParams(**kw), device="cpu"),
              _host(got, **kw))
    if name == "roi53":
        for g, w in zip(out.components, img.components):
            np.testing.assert_array_equal(g.data, w.data)


def test_batch_routes_and_codec():
    """`encode_batch` of two ROI frames and of two custom-MCT frames
    equals the reference's streams; `decode_batch` of each pair the host
    decoder's pixels; `codec.decompress_batch` of an ROI, a custom-MCT
    and a plain stream (three batch keys) equals each stream's lone
    decode."""
    imgs = [_image(7, 32, 24), _image(8, 32, 24)]
    port_imgs = [convert.image_from_reference(im) for im in imgs]
    streams = {}
    for name in ("roi53", "mct_ht"):
        params = EncoderParams(**CASES[name])
        with _numpy_dwt():
            want = [ref_encoder.encode(im, params, device=False)
                    for im in imgs]
        got = encoder.encode_batch(port_imgs,
                                   convert.params_from_reference(params),
                                   device="cpu")
        assert got == want
        for out, cs in zip(decoder.decode_batch(got, device="cpu"), got):
            _same(out, _host(cs))
        streams[name] = got[1]
    plain = encoder.encode(port_imgs[0], port_params.EncoderParams(
        numresolutions=3, cblk_style=HT), device="cpu")
    mixed = [streams["roi53"], streams["mct_ht"], plain]
    keys = [decoder.batch_key(decoder.read_header(cs)) for cs in mixed]
    assert keys[0] != keys[1] != keys[2] != keys[0]
    for out, cs in zip(codec.decompress_batch(mixed, device="cpu"), mixed):
        np.testing.assert_array_equal(out, codec.decompress(cs,
                                                            device="cpu"))


def test_custom_mct_ht_byte_target_equals_reference():
    """HT at one byte target with a custom MCT: the reference's bisection
    of the base step by whole encodes (`encoder._ht_rc_bisect`)."""
    img = natural_image(48, 32, ncomp=3, seed=12)
    params = EncoderParams(numresolutions=3, transform=Transform.DWT_97,
                           cblk_style=HT, custom_mct=MATRIX, rates=(8.0,))
    with _numpy_dwt():
        want = ref_encoder.encode(img, params, device=False)
    got = encoder.encode(convert.image_from_reference(img),
                         convert.params_from_reference(params),
                         device="cpu")
    assert got == want
    assert len(got) <= 48 * 32 * 3 // 8


def test_roi_with_coc_reconstructs_at_plane_zero():
    """With a COC the reference's host decode takes its per-block route,
    where an ROI component's truncated blocks reconstruct at plane 0
    (`_cblk_pmin`); without one its fused route reconstructs them at
    their lowest decoded plane. The port follows both (`pm_zero`), and
    the two rules give different pixels on this stream."""
    img = _image(9)
    params = EncoderParams(numresolutions=3, transform=Transform.DWT_97,
                           roi_comp=1, roi_shift=3, numlayers=2,
                           rates=(16.0, 8.0), comp_cblk_exps={2: (3, 3)},
                           **{k: v for k, v in SMALL.items()
                              if k != "numresolutions"})
    with _numpy_dwt():
        cs = ref_encoder.encode(img, params, device=False)
    assert encoder.encode(convert.image_from_reference(img),
                          convert.params_from_reference(params),
                          device="cpu") == cs
    hdr, trs, parsed = decoder.parse_batch([cs])
    (plan,) = decoder.tile_groups(hdr, trs, parsed)
    assert plan.pm_zero == (1,)
    got = decoder.decode(cs, device="cpu")
    _same(got, _host(cs))
    other = dataclasses.replace(plan, pm_zero=())
    flipped = fused_decode.decode_tiles_collect(fused_decode.decode_tiles_submit(
        fused_decode.decoder_for(other, torch.device("cpu")),
        [fused_decode.jobs_by_block(*parsed[0][0][0][:3])]))[0]
    assert not np.array_equal(flipped[1], got.components[1].data)
    np.testing.assert_array_equal(flipped[0], got.components[0].data)


def test_override_stream_decodes_like_host():
    """`chip_smoke.override_stream` at small size: the port's streams
    spliced equal the reference's spliced; every fourth tile carries a
    tile-part COD (32x32 blocks, RPCL) and QCD (base step 2); the decode,
    and a window across an overridden tile and a plain one at a
    reduction, equal the reference host decoder's."""
    img = chip_smoke.route_small_frame()
    ref_b, ref_o = chip_smoke.override_params(ref_params,
                                              chip_smoke.ROUTE_SMALL)
    pb, po = chip_smoke.override_params(port_params, chip_smoke.ROUTE_SMALL)
    from test_torch_host_copies import _reference_image
    rimg = _reference_image(img)
    with _numpy_dwt():
        want = chip_smoke.override_stream(
            ref_encoder.encode(rimg, ref_b, device=False),
            ref_encoder.encode(rimg, ref_o, device=False))
    cs = chip_smoke.override_stream(encoder.encode(img, pb, device="cpu"),
                                    encoder.encode(img, po, device="cpu"))
    assert cs == want
    over = [tp for tp in decoder.iter_tile_parts(
        cs, decoder.read_header(cs).main_header_end) if tp.cod]
    assert [tp.tile_index for tp in over] == [0, 4]
    assert len(decoder.read_header(cs).tlm or ()) == 0
    assert over[0].qcd is not None and over[0].cod.cblk_h_exp == 5
    for kw in chip_smoke.ROUTE_SMALL_REQUESTS:
        _same(decoder.decode(cs, DecoderParams(**kw), device="cpu"),
              _host(cs, **kw))


def test_coc_stream_decodes_like_host():
    """`chip_smoke.coc_stream` at small size: component 1 on 5/3 with two
    resolutions (COC, QCC) beside 9/7 on three: the tile decodes in
    two component groups; the whole image and a window across tiles
    equal the reference host decoder's pixels, and component 1 is
    lossless."""
    img, cs = _coc_streams()["frame"], _coc_streams()["coc"]
    hdr = decoder.read_header(cs)
    assert hdr.cod_comp[1].transform == port_params.Transform.DWT_53
    assert hdr.cod_comp[1].numresolutions == 2
    hdr_, trs, parsed = decoder.parse_batch([cs])
    groups = decoder.tile_groups(hdr_, trs, parsed)
    assert {p.comps for p in groups} == {(0, 2), (1,)}
    assert all(p.cfg.raw for p in groups)
    for kw in chip_smoke.ROUTE_SMALL_REQUESTS:
        out = decoder.decode(cs, DecoderParams(**kw), device="cpu")
        _same(out, _host(cs, **kw))
        if not kw:
            np.testing.assert_array_equal(out.components[1].data,
                                          img.components[1].data)


def test_plans_equal_reference(monkeypatch):
    """`tile.build_comp_plan(roishift=)` (Kmax + shift) equals the
    reference's; the fused encode plan of an ROI tile equals the
    reference's plan of the tile (the shift is T2's); a component group's
    decode plan equals the reference's plan (captured where its batch
    decode builds it) of those components
    (`dec_plan_from_reference(comps=)`), and the COC stream's group of
    the components on the COD is that plan of the same frame coded
    without the COC."""
    from grokimagecompression_tpu.models import fused_decode as ref_fd
    from grokimagecompression_tpu.models import fused_encode as ref_fused
    img = _image()
    params = EncoderParams(**CASES["roi97"])
    rsiz = ref_encoder.build_siz(img, params)
    rcod = ref_encoder.build_cod(img, params)
    rqcd = ref_tile.default_qcd(rsiz, rcod, 2)
    pimg = convert.image_from_reference(img)
    pp = convert.params_from_reference(params)
    siz, cod = encoder.build_siz(pimg, pp), encoder.build_cod(pimg, pp)
    qcd = tile.default_qcd(siz, cod, 2)
    rtr = ref_decoder.tile_rect(0, 48, 32, 0, 0, 48, 32, 0, 0)
    tr = tile_rect(0, 48, 32, 0, 0, 48, 32, 0, 0)
    for c in range(3):
        want = ref_tile.build_comp_plan(rsiz, rcod, rqcd, rtr, c, 4 * c)
        got = tile.build_comp_plan(siz, cod, qcd, tr, c, 4 * c)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
        assert max(b.kmax for b in got.bands.values()) == max(
            b.kmax for b in tile.build_comp_plan(
                siz, cod, qcd, tr, c).bands.values()) + 4 * c
    ref_plan = ref_fused.build_plan(rsiz, rcod, rqcd, rtr, coder="mq")
    assert convert.plan_from_reference(ref_plan) == fused_encode.build_plan(
        siz, cod, qcd, tr, coder="mq")

    captured = []
    monkeypatch.setattr(ref_fd, "_jitted_fused_dec_batch",
                        lambda plan, dims, n: captured.append(plan))
    ht = ref_encoder.encode(img, EncoderParams(numresolutions=3,
                                               cblk_style=HT, mct=0),
                            device=False)
    rh = ref_decoder.read_header(ht)
    (tp,) = ref_decoder.iter_tile_parts(ht, rh.main_header_end)
    _, rjobs, rslots, rplans, rcods = ref_tile.decode_tile(
        tp.body, rh.siz, rh.cod, rh.qcd, rtr, _return_jobs=True)
    ref_fd.decode_tiles_device_submit([(rjobs, rslots)], rplans, rcods,
                                      rh.siz, rh.cod, rtr, {},
                                      _prepare_only=True)
    hdr, trs, parsed = decoder.parse_batch([ht])
    plans = parsed[0][0][0][2]
    for comps in ((0, 2), (1,)):
        assert fused_decode.build_plan(plans, hdr.siz, hdr.cod, trs[0],
                                       comps=comps) == \
            convert.dec_plan_from_reference(captured[-1], comps=comps)

    coc = _coc_streams()["coc"]
    plain = encoder.encode(_COC["frame"], _COC["params"], device="cpu")
    (ch, ctrs, cparsed), (ph, _, pparsed) = (decoder.parse_batch([cs])
                                             for cs in (coc, plain))
    for t in range(len(ctrs)):
        (grp,) = [p for p in decoder.tile_plans(ch, ctrs[t],
                                                cparsed[0][0][t])
                  if p.comps == (0, 2)]
        assert grp == fused_decode.build_plan(
            pparsed[0][0][t][2], ph.siz, ph.cod, ctrs[t], coder="mq",
            comps=(0, 2))


_COC = {}


def _coc_streams():
    """`chip_smoke.coc_stream` of the small RGB frame (component 1 on 5/3
    with two resolutions) and its coding parameters, by the port on the
    CPU; made once."""
    if not _COC:
        frame = chip_smoke.route_small_frame()
        params = port_params.EncoderParams(mct=port_params.MCT.NONE, **dict(
            chip_smoke.ROUTE_SMALL, transform=port_params.Transform.DWT_97))
        _COC["frame"], _COC["params"] = frame, params
        _COC["coc"] = chip_smoke.coc_stream(frame, params, "cpu")
    return _COC


def _splice_main(cs: bytes, seg: bytes) -> bytes:
    """`seg` inserted at the end of the main header."""
    end = decoder.read_header(cs).main_header_end
    return cs[:end] + seg + cs[end:]


def test_refusals_left():
    """What the port still refuses, with its reason and never on the
    host: ROI on HT code-blocks (an RGN spliced into an HT stream); ROI
    with the HT coder and a custom MCT off 9/7 raise the reference's
    ValueError. An MQ code-block style in a COC, an ROI shift whose Kmax
    passes the CUDA MQ decoder's 30 planes and HT refinement passes (a
    stream of them, and the request, equal to the reference host
    encoder's) decode to the host decoder's pixels on the host Tier-1
    route."""
    img = natural_image(32, 32, ncomp=3, seed=3)
    pimg = convert.image_from_reference(img)
    ht = ref_encoder.encode(img, EncoderParams(numresolutions=2,
                                               cblk_style=HT), device=False)
    mq = ref_encoder.encode(img, EncoderParams(numresolutions=2),
                            device=False)
    cod = ref_decoder.read_header(mq).cod
    big = ref_encoder.encode(img, EncoderParams(numresolutions=2, roi_comp=0,
                                                roi_shift=25), device=False)
    refined = ref_encoder.encode(img, EncoderParams(
        numresolutions=2, cblk_style=HT, ht_refinement=True), device=False)
    for cs in (_splice_main(mq, ref_markers.write_coc(
            1, dataclasses.replace(cod, cblk_style=0x08), 3)), big,
               refined):
        (got,) = decoder.decode_batch([cs], device="cpu")
        want = ref_decoder.decode(cs, device=False)
        for g, w in zip(got.components, want.components):
            np.testing.assert_array_equal(g.data, w.data)
    with pytest.raises(NotImplementedError, match="ROI shifts on HT"):
        decoder.decode_batch([_splice_main(ht, ref_markers.write_rgn(
            0, 3, 3))], device="cpu")
    for kw in (dict(cblk_style=HT, roi_comp=0, roi_shift=3),
               dict(transform=Transform.DWT_53, custom_mct=MATRIX),
               dict(transform=Transform.DWT_97, custom_mct=np.eye(2))):
        p = EncoderParams(numresolutions=2, **kw)
        with pytest.raises(ValueError), _numpy_dwt():
            ref_encoder.encode(img, p, device=False)
        with pytest.raises(ValueError):
            encoder.encode(pimg, convert.params_from_reference(p),
                           device="cpu")
    assert encoder.encode(pimg, convert.params_from_reference(
        EncoderParams(numresolutions=2, cblk_style=HT,
                      ht_refinement=True)), device="cpu") == refined


def _roi_group(dev):
    """An ROI stream of a smooth frame (9/7 MQ, rates, shift 6) and the
    lane groups of its encode (the fused MQ encoder's slot streams) and
    its decode (`fused_decode.prepare_chunk`), on `dev`."""
    img = convert.image_from_reference(natural_image(128, 96, ncomp=3,
                                                     seed=31))
    params = convert.params_from_reference(EncoderParams(
        numresolutions=4, transform=Transform.DWT_97, roi_comp=0,
        roi_shift=6, numlayers=2, rates=(16.0, 32.0)))
    cs = encoder.encode(img, params, device=dev)
    p, siz, cod, qcd, cod_comp, trs = encoder._coding(img, params)
    (enc,) = encoder._tile_encoders(p, siz, cod, qcd, cod_comp, trs[:1],
                                    torch.device(dev), True)
    args = fused_encode.upload_tile(encoder.extract_tile_comps(img, siz, 0),
                                    enc)
    hdr, trs_, parsed = decoder.parse_batch([cs])
    (plan,) = decoder.tile_groups(hdr, trs_, parsed)
    arrays = fused_decode.upload(fused_decode.prepare_chunk(
        plan, [fused_decode.jobs_by_block(*parsed[0][0][0][:3])]),
        torch.device(dev))
    return enc, args, plan, arrays


@pytest.mark.gpu
def test_cuda_mq_kernels_on_an_roi_group_equal_plain():
    """The CUDA MQ coder on an ROI frame's slot stream of its largest
    blocks (16 lanes, the leading plane) and the CUDA MQ decoder on its
    decode's lane groups (every lane cut to its first 3 passes) equal
    their plain versions."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from grokimagecompression_tpu_torch.ops import (mq_dec, mq_dec_torch,
                                                    mq_scan, mq_torch)
    enc, args, plan, arrays = _roi_group("cuda")
    mq_scan.LAUNCHES["mq"] = 0
    big = max(range(len(enc.plan.groups)),
              key=lambda g: enc.plan.groups[g][0] * enc.plan.groups[g][1])
    h, w, _ = enc.plan.groups[big]
    gin = list(enc.group_inputs(*args))[big]
    _, slots, _ = enc.group_slots(*gin)
    spans = mq_torch.pass_spans_padded(h, w)
    sub = slots[:sum(spans), :16].contiguous()
    got = mq_scan.mq_scan(sub, spans)
    want = mq_torch.mq_scan_plain(sub, spans)
    for g, wv in zip(got, want):
        assert torch.equal(g, wv)
    assert mq_scan.LAUNCHES["mq"] >= 1
    mq_dec.LAUNCHES["mq_dec"] = 0
    for (w, h, _), group in zip(plan.groups, arrays):
        data, off, nbps, npas, ori = group[:5]
        a = (data, off, nbps, torch.clamp(npas, max=3), ori, w, h)
        got = mq_dec.decode_group(*a, with_stats=True)
        want = mq_dec_torch.decode_group_plain(*a, with_stats=True)
        for g, wv in zip(got, want):
            assert torch.equal(g, wv)
    assert mq_dec.LAUNCHES["mq_dec"] >= 1
