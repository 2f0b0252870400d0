"""The port's per-image decode requests, on the CPU.

`grokimagecompression_tpu_torch.codestream.decoder.decode_batch` and
`decode` (`device="cpu"`: the plain HT and MQ decoders and `dwt_torch`)
must equal the reference's host `decoder.decode` pixel for pixel, with
the same `DecoderParams`, on 300x260 RGB frames at an odd image offset
in 96x96 tiles (`chip_smoke.window_frames`), coded by the reference host
encoder with 5/3 HT and with 9/7 MQ in three layers
(`chip_smoke.WIN_CODINGS`): the whole image, every reduction and one
past the levels, windows across four tiles alone, reduced, layer-limited
and clipped by the image's corner, an interior and the corner tile, and
layer limits (`chip_smoke.window_requests`, the requests whose
reference digests `chip_smoke.py` holds the card to). `decode_batch`
decodes both HT frames at once and MQ frame 0; a window decodes frame by
frame through `decode`.

Also: each window's jobs (`tile.decode_tile(window=)`) equal the
reference's (its `_band_window` filter), each window and single tile
equals the crop of the port's whole decode at the same reduction and
layer limit, an empty window raises ValueError, the streams the
reference sends to its host decode (ROI, tile-part overrides, MQ styles,
HT refinement passes) equal its host decoder's pixels, and
`codec.decompress` / `decompress_batch` equal the reference's.

The reference runs with its numpy DWT (`dwt_host._get_native` None and
GROK_TPU_DWT=python, which its reduced inverse and its windowed inverse
`dwt_window._native()` read): its native 9/7 DWT rounds differently
from `dwt_np`, which the port's DWT equals bit for bit.
"""

import contextlib
import functools
import os
import struct
import sys

import numpy as np
import pytest
import torch

from grokimagecompression_tpu import codec as ref_codec
from grokimagecompression_tpu.codestream import decoder as ref_decoder
from grokimagecompression_tpu.codestream import encoder as ref_encoder
from grokimagecompression_tpu.codestream import tile as ref_tile
from grokimagecompression_tpu.core.geometry import Rect as RefRect
from grokimagecompression_tpu.core.geometry import ceil_div
from grokimagecompression_tpu.core.image import Component as RefComponent
from grokimagecompression_tpu.core.image import Image as RefImage
from grokimagecompression_tpu.core.params import (DecoderParams as
                                                  RefDecoderParams)
from grokimagecompression_tpu.core.params import EncoderParams, Transform
from grokimagecompression_tpu.ops import dwt_host, dwt_window
from grokimagecompression_tpu_torch import codec
from grokimagecompression_tpu_torch.codestream import decoder, tile
from grokimagecompression_tpu_torch.core.params import DecoderParams
from grokimagecompression_tpu_torch.models import fused_decode

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
import chip_smoke  # noqa: E402

CASES = [(coding, kw) for coding in chip_smoke.WIN_CODINGS
         for kw in chip_smoke.window_requests(coding)]
IDS = [f"{coding}-{chip_smoke.request_name(kw)}" for coding, kw in CASES]
REGIONS = [(case, i) for case, i in zip(CASES, IDS)
           if "window" in case[1] or "tile_index" in case[1]]
WINDOWS = [(case, i) for case, i in REGIONS if "window" in case[1]]


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
    """The reference host codec with its numpy DWT only: `dwt_host`'s
    dispatch, and the decoder's packed native inverse and
    `dwt_window._native()`, which GROK_TPU_DWT=python turns off."""
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


def _ref_image(im):
    return RefImage(xsiz=im.xsiz, ysiz=im.ysiz, components=[RefComponent(
        data=c.data, prec=c.prec, signed=c.signed, dx=c.dx, dy=c.dy)
        for c in im.components])


@functools.lru_cache(maxsize=None)
def _streams(coding):
    """The reference host encoder's streams of the two frames."""
    params = chip_smoke.window_params(EncoderParams, Transform, coding)
    with _numpy_dwt():
        return tuple(ref_encoder.encode(_ref_image(im), params, device=False)
                     for im in chip_smoke.window_frames())


def _reference(cs, kw):
    with _numpy_dwt():
        return ref_decoder.decode(cs, RefDecoderParams(**kw), device=False)


def _frames(coding):
    """The streams the CPU test decodes: both frames on HT, frame 0 on MQ
    (the plain MQ decoder's time grows with the lanes: one torch step a
    decision of a lane group's deepest lane)."""
    streams = _streams(coding)
    return streams if coding == "ht53" else streams[:1]


@functools.lru_cache(maxsize=None)
def _port(coding, kw):
    """The port's decode_batch of `_frames` at request `kw` (a sorted
    tuple of DecoderParams items)."""
    return tuple(decoder.decode_batch(list(_frames(coding)),
                                      DecoderParams(**dict(kw)),
                                      device="cpu"))


def _same(got, want):
    assert (got.x0, got.y0, got.xsiz, got.ysiz) == \
        (want.x0, want.y0, want.xsiz, want.ysiz)
    assert len(got.components) == len(want.components)
    for g, w in zip(got.components, want.components):
        assert g.data.dtype == np.int32
        np.testing.assert_array_equal(g.data, w.data)


def _key(kw):
    return tuple(sorted(kw.items()))


@pytest.mark.parametrize("coding,kw", CASES, ids=IDS)
def test_decode_batch_equals_reference(coding, kw):
    streams = _frames(coding)
    got = _port(coding, _key(kw))
    assert len(got) == len(streams)
    for cs, img in zip(streams, got):
        _same(img, _reference(cs, kw))


@pytest.mark.parametrize("kw", [{"tile_index": 11, "reduce": 3},
                                {"reduce": 3, "layers": 1}],
                         ids=chip_smoke.request_name)
def test_decode_equals_reference(kw):
    """`decode` without a window (the window requests above go through
    it already, frame by frame)."""
    cs = _streams("mq97")[1]
    _same(decoder.decode(cs, DecoderParams(**kw), device="cpu"),
          _reference(cs, kw))


def _bodies(cs):
    hdr = decoder.read_header(cs)
    bodies = {}
    for tp in decoder.iter_tile_parts(cs, hdr.main_header_end):
        bodies[tp.tile_index] = bodies.get(tp.tile_index, b"") + tp.body
    return hdr, bodies


@pytest.mark.parametrize("coding,kw", [c for c, _ in WINDOWS],
                         ids=[i for _, i in WINDOWS])
def test_window_jobs_equal_reference(coding, kw):
    """Every tile's window jobs and their code-blocks, against the
    reference's `decode_tile(window=, _return_jobs=True)`; the port's
    window plan has a lane for each job and no other."""
    cs = _streams(coding)[0]
    hdr, bodies = _bodies(cs)
    ref_hdr = ref_decoder.read_header(cs)
    siz = hdr.siz
    trs = decoder._tile_rects(siz)
    req = decoder._request(siz, hdr.cod, trs, DecoderParams(**kw))
    win = req.window
    assert req.tiles and all(not trs[t].clip(win).is_empty()
                             for t in req.tiles)
    for t in req.tiles:
        tr = trs[t]
        _, w_jobs, w_slots, _, _ = ref_tile.decode_tile(
            bodies[t], ref_hdr.siz, ref_hdr.cod, ref_hdr.qcd,
            RefRect(tr.x0, tr.y0, tr.x1, tr.y1),
            max_layers=kw.get("layers", 0),
            window=RefRect(win.x0, win.y0, win.x1, win.y1),
            _return_jobs=True)
        g_jobs, g_slots, plans, _ = tile.decode_tile(
            bodies[t], siz, hdr.cod, hdr.qcd, tr,
            max_layers=kw.get("layers", 0), window=win)
        assert g_jobs == w_jobs
        assert [(c, k, (s.geom.rect.x0, s.geom.rect.y0, s.geom.rect.x1,
                        s.geom.rect.y1)) for c, k, s in g_slots] == \
            [(c, k, (s.geom.rect.x0, s.geom.rect.y0, s.geom.rect.x1,
                     s.geom.rect.y1)) for c, k, s in w_slots]
        assert len(g_jobs) <= len(tile.decode_tile(bodies[t], siz, hdr.cod,
                                                   hdr.qcd, tr)[0])
        plan = fused_decode.build_plan(
            plans, siz, hdr.cod, tr, max_res=hdr.cod.numresolutions - 1
            - req.reduce, window_slots=g_slots,
            coder="ht" if hdr.cod.cblk_style & 0x40 else "mq")
        lanes = {b.slot for (_, _, blks) in plan.groups for b in blks}
        assert lanes == set(fused_decode.jobs_by_block(
            g_jobs, g_slots, plans, plan.max_res))


@pytest.mark.parametrize("coding,kw", [c for c, _ in REGIONS],
                         ids=[i for _, i in REGIONS])
def test_region_equals_crop_of_whole_decode(coding, kw):
    """A window or a tile equals the crop of the whole image's decode at
    the same reduction and layer limit (a request of CASES too)."""
    r = kw.get("reduce", 0)
    whole_kw = {k: v for k, v in kw.items() if k in ("reduce", "layers")}
    assert whole_kw in chip_smoke.window_requests(coding)
    for part, whole in zip(_port(coding, _key(kw)),
                           _port(coding, _key(whole_kw))):
        for p, w in zip(part.components, whole.components):
            y0 = ceil_div(part.y0, 1 << r) - ceil_div(whole.y0, 1 << r)
            x0 = ceil_div(part.x0, 1 << r) - ceil_div(whole.x0, 1 << r)
            assert p.data.size
            np.testing.assert_array_equal(
                p.data, w.data[y0:y0 + p.data.shape[0],
                               x0:x0 + p.data.shape[1]])


def test_bad_requests_raise():
    cs = _streams("ht53")[0]
    for kw in ({"window": (400, 0, 500, 10)}, {"window": (0, 0, 5, 3)},
               {"tile_index": 12}):
        with pytest.raises(ValueError):
            decoder.decode(cs, DecoderParams(**kw), device="cpu")
        with pytest.raises(ValueError):
            decoder.decode_batch([cs], DecoderParams(**kw), device="cpu")
    with pytest.raises(ValueError):
        ref_decoder.decode(cs, RefDecoderParams(window=(400, 0, 500, 10)))


def _tile_part_override(cs: bytes) -> bytes:
    """A copy of the main COD spliced into the first tile-part's header
    (its Psot grown to match)."""
    from grokimagecompression_tpu.codestream import markers as ref_markers
    hdr = ref_decoder.read_header(cs)
    pos = hdr.main_header_end
    seg = ref_markers.write_cod(hdr.cod)
    psot = struct.unpack(">I", cs[pos + 6:pos + 10])[0]
    return (cs[:pos + 6] + struct.pack(">I", psot + len(seg))
            + cs[pos + 10:pos + 12] + seg + cs[pos + 12:])


def test_host_only_requests_raise():
    """Streams the reference decodes on its host: ROI shifts and
    tile-part header overrides decode on every route (a window, a
    reduction, a tile) to the reference host decoder's pixels now, and so
    does a stream with an MQ code-block style other than 0 (the host
    Tier-1 route) and a stream with HT refinement passes (the host
    decoders)."""
    img = _ref_image(chip_smoke.window_frames(1, 48, 40)[0])
    roi = ref_encoder.encode(img, EncoderParams(
        numresolutions=3, roi_comp=0, roi_shift=3, cblk_w_exp=4,
        cblk_h_exp=4), device=False)
    over = _tile_part_override(ref_encoder.encode(
        img, EncoderParams(numresolutions=3, cblk_style=0x40),
        device=False))
    lazy = ref_encoder.encode(img, EncoderParams(numresolutions=3,
                                                 cblk_style=0x01),
                              device=False)
    refined = ref_encoder.encode(img, EncoderParams(
        numresolutions=3, cblk_style=0x40, ht_refinement=True), device=False)
    for kw in ({"window": (4, 4, 20, 20)}, {"reduce": 1},
               {"tile_index": 0}):
        for cs in (roi, over, lazy, refined):
            got = decoder.decode(cs, DecoderParams(**kw), device="cpu")
            want = ref_decoder.decode(cs, RefDecoderParams(**kw),
                                      device=False)
            for g, w in zip(got.components, want.components):
                np.testing.assert_array_equal(g.data, w.data)


def test_codec_decompress_equals_reference():
    cs = _streams("mq97")[0]
    with _numpy_dwt():
        want = ref_codec.decompress(cs, reduce=2, layers=1)
    got = codec.decompress(cs, reduce=2, layers=1, device="cpu")
    assert got.shape == want.shape and got.shape[-1] == 3
    np.testing.assert_array_equal(got, want)


def test_codec_decompress_batch_equals_reference():
    """A window over a batch of streams of two geometries, in order."""
    streams = [_streams("ht53")[0], _streams("mq97")[0], _streams("ht53")[1]]
    window = (101, 97, 190, 200)
    with _numpy_dwt():
        want = ref_codec.decompress_batch(streams, workers=1, reduce=2,
                                          window=window)
    got = codec.decompress_batch(streams, reduce=2, window=window,
                                 device="cpu")
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    image = codec.to_image(got[0])
    assert codec.from_image(image).tolist() == got[0].tolist()
