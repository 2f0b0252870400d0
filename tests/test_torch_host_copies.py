"""The port's copies of the reference's host layers, held to the originals.

The port owns copies of the host code it runs (`core/`, the codestream
markers, header walk, tile plans and T2, the native T2 and HT prepass in
`csrc/host/`). On the streams of the encode cases, its `read_header`,
tile packet parse (jobs and slots), `build_comp_plan` and `default_qcd`
must equal the reference's; its native T2 must agree with its Python
T2; the digest files that `chip_smoke.py` checks the card's streams
against (config 1 HT and MQ, config 2 rate-controlled 9/7) must equal
digests made afresh with the reference host encoder, and the corpus
decode digests (`corpus_decode.json`) and the per-image decode's
(`window_decode.json`) its host decoder's, the per-image encode's
(`image_encode.json`) its host encoder and codec's, and those of the
ROI, custom-MCT, override and COC streams (`host_routes.json`) its host
encoder's and decoder's; and the port's
MQ
tables, quantization helpers, irreversible plans and QCDs, PCRD hull and
allocator, T2 tile simulator and `PassInfo` must equal the reference's.

Run `PYTHONPATH=. python tests/test_torch_host_copies.py` from the
repository root to rewrite the digest files.
"""

import contextlib
import dataclasses
import functools
import hashlib
import json
import os
import sys

import numpy as np
import pytest
import torch

from grokimagecompression_tpu.codestream import decoder as ref_decoder
from grokimagecompression_tpu.codestream import encoder as ref_encoder
from grokimagecompression_tpu.codestream import tile as ref_tile
from grokimagecompression_tpu.core.geometry import tile_grid_size as ref_grid
from grokimagecompression_tpu.core.geometry import tile_rect as ref_rect
from grokimagecompression_tpu.core.params import EncoderParams
from grokimagecompression_tpu.ops import mq_jax
from grokimagecompression_tpu.t1 import mq as ref_mq
from grokimagecompression_tpu_torch import convert
from grokimagecompression_tpu_torch.codestream import decoder, encoder, tile
from grokimagecompression_tpu_torch.codestream.t2 import decode_packet
from grokimagecompression_tpu_torch.core.geometry import tile_rect
from grokimagecompression_tpu_torch.codestream.packetiter import (
    CompIterInfo, packet_order)
from grokimagecompression_tpu_torch.codestream.t2 import PrecDec, CblkDec
from grokimagecompression_tpu_torch.ops import mq_tables

from conftest import natural_image


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
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(REPO, "grokimagecompression_tpu_torch", "data")
DIGESTS = os.path.join(DATA, "config1_ht_lossless.json")
MQ_DIGESTS = os.path.join(DATA, "config1_mq_lossless.json")
C2_DIGESTS = os.path.join(DATA, "config2_pcrd_97.json")
C2_DEC_DIGESTS = os.path.join(DATA, "config2_decode_97.json")
C2_HT_DIGESTS = os.path.join(DATA, "config2_ht_97.json")
CIN_DIGESTS = os.path.join(DATA, "cinema_profiles.json")
CORPUS_DIGESTS = os.path.join(DATA, "corpus_decode.json")
CORPUS = os.path.join(REPO, "tests", "corpus")
WIN_DIGESTS = os.path.join(DATA, "window_decode.json")
IMG_ENC_DIGESTS = os.path.join(DATA, "image_encode.json")
ROUTE_DIGESTS = os.path.join(DATA, "host_routes.json")

CASES = [
    ("gray", [natural_image(64, 64, seed=0)],
     EncoderParams(numresolutions=3, cblk_style=HT)),
    ("rgb_rct", [natural_image(40, 36, ncomp=3, seed=4)],
     EncoderParams(numresolutions=3, cblk_style=HT)),
    ("two_tiles", [natural_image(64, 40, seed=8)],
     EncoderParams(numresolutions=3, cblk_style=HT, tile_size=(40, 40),
                   cblk_w_exp=4, cblk_h_exp=4)),
    ("odd_origin_12bit", [natural_image(45, 27, seed=11, prec=12)],
     EncoderParams(numresolutions=4, cblk_style=HT, image_offset=(3, 5),
                   tile_offset=(1, 2))),
    ("sop_eph_rpcl_precincts", [natural_image(33, 29, seed=3)],
     EncoderParams(numresolutions=3, cblk_style=HT, sop_markers=True,
                   eph_markers=True, progression=2, precincts=[(4, 4)])),
]
IDS = [c[0] for c in CASES]


def _stream(imgs, params):
    return ref_encoder.encode(imgs[0], params, device=False)


def _asdict(x):
    return dataclasses.asdict(x)


@pytest.mark.parametrize("name,imgs,params", CASES, ids=IDS)
def test_read_header_equals_reference(name, imgs, params):
    cs = _stream(imgs, params)
    want = ref_decoder.read_header(cs)
    got = decoder.read_header(cs)
    assert _asdict(got) == _asdict(want)
    want_parts = list(ref_decoder.iter_tile_parts(cs, want.main_header_end))
    got_parts = list(decoder.iter_tile_parts(cs, got.main_header_end))
    assert [_asdict(p) for p in got_parts] == [_asdict(p) for p in want_parts]


def _slot_key(slot):
    c, key, cb = slot
    r = cb.geom.rect
    return (c, tuple(key), r.x0, r.y0, r.x1, r.y1, cb.geom.cx, cb.geom.cy,
            cb.numbps, cb.numpasses)


@pytest.mark.parametrize("name,imgs,params", CASES, ids=IDS)
def test_tile_parse_and_plans_equal_reference(name, imgs, params):
    cs = _stream(imgs, params)
    hdr = decoder.read_header(cs)
    siz, cod, qcd = hdr.siz, hdr.cod, hdr.qcd
    bodies = {}
    for tp in decoder.iter_tile_parts(cs, hdr.main_header_end):
        bodies.setdefault(tp.tile_index, b"")
        bodies[tp.tile_index] += tp.body
    ntx, nty = ref_grid(siz.xsiz, siz.ysiz, siz.xosiz, siz.yosiz, siz.xtsiz,
                        siz.ytsiz, siz.xtosiz, siz.ytosiz)
    ref_hdr = ref_decoder.read_header(cs)
    for t in range(ntx * nty):
        args = (siz.xsiz, siz.ysiz, siz.xosiz, siz.yosiz, siz.xtsiz,
                siz.ytsiz, siz.xtosiz, siz.ytosiz)
        tr, ref_tr = tile_rect(t, *args), ref_rect(t, *args)
        assert _asdict(tr) == _asdict(ref_tr)
        _, w_jobs, w_slots, w_plans, _ = ref_tile.decode_tile(
            bodies[t], ref_hdr.siz, ref_hdr.cod, ref_hdr.qcd, ref_tr,
            _return_jobs=True)
        g_jobs, g_slots, g_plans, _ = tile.decode_tile(
            bodies[t], siz, cod, qcd, tr)
        assert g_jobs == w_jobs
        assert [_slot_key(s) for s in g_slots] == \
            [_slot_key(s) for s in w_slots]
        assert [_asdict(p) for p in g_plans] == [_asdict(p) for p in w_plans]
        for c in range(len(siz.comps)):
            assert _asdict(tile.build_comp_plan(siz, cod, qcd, tr, c)) == \
                _asdict(ref_tile.build_comp_plan(ref_hdr.siz, ref_hdr.cod,
                                                 ref_hdr.qcd, ref_tr, c))
    port_img = convert.image_from_reference(imgs[0])
    port_params = convert.params_from_reference(params)
    psiz = encoder.build_siz(port_img, port_params)
    pcod = encoder.build_cod(port_img, port_params)
    rsiz = ref_encoder.build_siz(imgs[0], params)
    rcod = ref_encoder.build_cod(imgs[0], params)
    assert _asdict(psiz) == _asdict(rsiz)
    assert _asdict(pcod) == _asdict(rcod)
    for gb in (1, 2):
        assert _asdict(tile.default_qcd(psiz, pcod, gb)) == \
            _asdict(ref_tile.default_qcd(rsiz, rcod, gb))


LAYERED = [
    ("lrcp", dict(rates=(96.0, 48.0, 24.0))),
    ("rpcl_sop_eph", dict(rates=(24.0, 12.0, 6.0), progression=2,
                          sop_markers=True, eph_markers=True)),
]


@pytest.mark.parametrize("name,kw", LAYERED, ids=[c[0] for c in LAYERED])
def test_layer_limited_parse_equals_reference(name, kw):
    """The native parser's layer limit against the reference's Python
    parse with `decode_packet(..., discard=True)`: the same jobs and
    code-block states at every limit."""
    from grokimagecompression_tpu.core.params import Transform
    img = natural_image(48, 40, ncomp=3, seed=12)
    cs = _stream([img], EncoderParams(
        numresolutions=3, transform=Transform.DWT_97, numlayers=3,
        cblk_w_exp=4, cblk_h_exp=4, **kw))
    hdr = decoder.read_header(cs)
    ref_hdr = ref_decoder.read_header(cs)
    body = b"".join(tp.body for tp in decoder.iter_tile_parts(
        cs, hdr.main_header_end))
    args = tuple(getattr(hdr.siz, k) for k in (
        "xsiz", "ysiz", "xosiz", "yosiz", "xtsiz", "ytsiz", "xtosiz",
        "ytosiz"))
    npasses = []
    for layers in (1, 2, 3):
        _, w_jobs, w_slots, _, _ = ref_tile.decode_tile(
            body, ref_hdr.siz, ref_hdr.cod, ref_hdr.qcd, ref_rect(0, *args),
            max_layers=layers, _return_jobs=True)
        g_jobs, g_slots, _, _ = tile.decode_tile(
            body, hdr.siz, hdr.cod, hdr.qcd, tile_rect(0, *args),
            max_layers=layers)
        assert g_jobs == w_jobs
        assert [_slot_key(s) for s in g_slots] == \
            [_slot_key(s) for s in w_slots]
        npasses.append(sum(j[6] for j in g_jobs))
    assert npasses[0] < npasses[1] < npasses[2]


@pytest.mark.parametrize("name,imgs,params", CASES, ids=IDS)
def test_native_t2_parse_equals_python_t2(name, imgs, params):
    """The port's native packet parser against its Python T2 (the plain
    reference of the copied parser) on the same tile bodies."""
    cs = _stream(imgs, params)
    hdr = decoder.read_header(cs)
    siz, cod, qcd = hdr.siz, hdr.cod, hdr.qcd
    tp = next(iter(decoder.iter_tile_parts(cs, hdr.main_header_end)))
    tr = tile_rect(tp.tile_index, siz.xsiz, siz.ysiz, siz.xosiz, siz.yosiz,
                   siz.xtsiz, siz.ytsiz, siz.xtosiz, siz.ytosiz)
    jobs, slots, plans, cods = tile.decode_tile(tp.body, siz, cod, qcd, tr)
    precs = []
    for c, plan in enumerate(plans):
        per = {}
        for res in plan.layout.resolutions:
            for band in res.bands:
                per[(res.r, band.orient)] = [
                    PrecDec(geom=prc, cblks=[CblkDec(geom=cb)
                                             for cb in prc.cblks])
                    for prc in band.precincts]
        precs.append(per)
    comps = [CompIterInfo(
        numresolutions=cod.numresolutions, dx=siz.comps[c].dx,
        dy=siz.comps[c].dy, tc_rect=plans[c].layout.tc_rect,
        prec_info=[(r.ppx, r.ppy, r.num_precincts_w, r.num_precincts_h)
                   for r in plans[c].layout.resolutions])
        for c in range(len(plans))]
    pos = 0
    for (l, r, c, p) in packet_order(cod.progression, cod.numlayers, comps,
                                     tr):
        orients = (0,) if r == 0 else (1, 2, 3)
        pos = decode_packet(tp.body, pos, l,
                            [precs[c][(r, o)][p] for o in orients],
                            [plans[c].bands[(r, o)].kmax for o in orients],
                            cod.cblk_style, sop=cod.sop, eph=cod.eph)
    want = []
    for c, plan in enumerate(plans):
        for res in plan.layout.resolutions:
            for band in res.bands:
                for prc in precs[c][(res.r, band.orient)]:
                    for cb in prc.cblks:
                        if cb.numpasses:
                            want.append((cb.data_and_seg_lengths()[0],
                                         cb.numbps, cb.numpasses))
    assert [(j[0], j[5], j[6]) for j in jobs] == want


def config1_digests(cblk_style=HT):
    """SHA-256 of the 64 config-1 frames (`chip_smoke.frame_digest`) and
    of the reference host encoder's streams of them, with the HT block
    coder (0x40) or the MQ coder (0)."""
    sys.path.insert(0, REPO)
    import chip_smoke

    from grokimagecompression_tpu.core.image import Component, Image
    imgs = chip_smoke.config1_frames(chip_smoke.FRAMES)
    params = EncoderParams(numresolutions=6, cblk_style=cblk_style)
    streams = [ref_encoder.encode(Image(
        xsiz=im.xsiz, ysiz=im.ysiz, components=[Component(
            data=c.data, prec=c.prec, signed=c.signed, dx=c.dx, dy=c.dy)
            for c in im.components]), params, device=False)
        for im in imgs]
    return {
        "what": "BASELINE config 1: chip_smoke.config1_frames(64) and the "
                "streams of grokimagecompression_tpu encoder.encode("
                f"EncoderParams(numresolutions=6, cblk_style={cblk_style:#x}"
                "), device=False); tests/test_torch_host_copies.py writes "
                "it",
        "frames": [chip_smoke.frame_digest(im) for im in imgs],
        "streams": [hashlib.sha256(cs).hexdigest() for cs in streams],
    }


def test_config1_digest_file_is_current():
    with open(DIGESTS) as f:
        assert json.load(f) == config1_digests()


def test_config1_mq_digest_file_is_current():
    with open(MQ_DIGESTS) as f:
        assert json.load(f) == config1_digests(0)


def test_mq_tables_equal_reference():
    assert mq_tables.MQ_TABLE == ref_mq.MQ_TABLE
    assert mq_tables.NUM_CTXS == ref_mq.NUM_CTXS == mq_jax.NUM_CTXS
    for name in ("CTX_ZC", "CTX_SC", "CTX_MAG", "CTX_RL", "CTX_UNI"):
        assert getattr(mq_tables, name) == getattr(ref_mq, name), name
    for name in ("_TBL_PACKED", "_CTX_INIT", "NCTX_WORDS",
                 "_CTX_INIT_PACKED"):
        assert getattr(mq_tables, name) == getattr(mq_jax, name), name
    # the port's state is the reference's without the word accumulator
    # (wacc, wcnt: entries 4 and 5)
    assert mq_tables.NSTATE == mq_jax.NSTATE - 2
    assert mq_tables.STATE_INIT == (mq_jax.STATE_INIT[:4]
                                    + mq_jax.STATE_INIT[6:])


def test_trunc_plane_equals_reference():
    from grokimagecompression_tpu.ops import quant as ref_quant
    from grokimagecompression_tpu_torch.ops import quant
    for nb in range(-1, 18):
        for npas in range(-1, 3 * max(nb, 1) + 2):
            assert quant.trunc_plane(nb, npas) == \
                ref_quant.trunc_plane(nb, npas), (nb, npas)


def test_port_frames_digest_like_reference_frames():
    sys.path.insert(0, REPO)
    import chip_smoke
    img = chip_smoke.config1_frames(1, size=32)[0]
    data = img.components[0].data
    assert data.dtype == np.int32 and data.shape == (32, 32)
    assert chip_smoke.frame_digest(img) == hashlib.sha256(
        data.astype("<i4").tobytes()).hexdigest()


@contextlib.contextmanager
def _numpy_dwt():
    """The reference host codec with its numpy DWT only: `dwt_host`'s
    dispatch, and the decoder's packed native inverse
    (`codestream/tile.py`) and windowed one (`dwt_window._native()`,
    whose choice is cached), which only GROK_TPU_DWT=python turns off.
    The native 9/7 DWT rounds differently from the numpy oracle, which
    the port's DWT equals bit for bit."""
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


def _c2_params(rates):
    from grokimagecompression_tpu.core.params import Transform
    return EncoderParams(numresolutions=6, transform=Transform.DWT_97,
                         numlayers=3, rates=rates)


def _reference_image(im):
    from grokimagecompression_tpu.core.image import Component, Image
    return Image(xsiz=im.xsiz, ysiz=im.ysiz, components=[Component(
        data=c.data, prec=c.prec, signed=c.signed, dx=c.dx, dy=c.dy)
        for c in im.components])


@functools.lru_cache(maxsize=1)
def _config2_streams():
    """The 4 config-2 frames and the reference host encoder's streams of
    them (ICT + 9/7, three layers at ratios 24 / 48 / 96), numpy DWT."""
    sys.path.insert(0, REPO)
    import chip_smoke
    imgs = chip_smoke.config2_frames(chip_smoke.C2_FRAMES)
    with _numpy_dwt():
        streams = [ref_encoder.encode(_reference_image(im),
                                      _c2_params((24.0, 48.0, 96.0)),
                                      device=False) for im in imgs]
    return imgs, streams


def config2_digests():
    """SHA-256 of the 4 config-2 frames (`chip_smoke.config2_frames`) and
    of the reference host encoder's streams of them (ICT + 9/7, three
    layers at ratios 24 / 48 / 96), run with its numpy DWT."""
    sys.path.insert(0, REPO)
    import chip_smoke
    imgs, streams = _config2_streams()
    return {
        "what": "BASELINE config 2: chip_smoke.config2_frames(4) and the "
                "streams of grokimagecompression_tpu encoder.encode("
                "EncoderParams(numresolutions=6, transform=DWT_97, "
                "numlayers=3, rates=(24, 48, 96)), device=False) with "
                "ops/dwt_host's numpy DWT; tests/test_torch_host_copies.py "
                "writes it",
        "frames": [chip_smoke.frame_digest(im) for im in imgs],
        "streams": [hashlib.sha256(cs).hexdigest() for cs in streams],
    }


def test_config2_digest_file_is_current():
    with open(C2_DIGESTS) as f:
        assert json.load(f) == config2_digests()


def config2_decode_digests():
    """SHA-256 of the reference host decoder's pixels (numpy DWT) of the 4
    config-2 streams, and of frame 0 encoded with its layers the other
    way round, ratios 96 / 48 / 24 (so that each layer carries data: at
    24 / 48 / 96 layers 1 and 2 are empty packets), decoded at layers 1,
    2 and all, with the host's MSE against the frame at each."""
    sys.path.insert(0, REPO)
    import chip_smoke

    from grokimagecompression_tpu.core.params import (DecoderParams as
                                                      RefDecoderParams)
    imgs, streams = _config2_streams()
    rates = (96.0, 48.0, 24.0)
    with _numpy_dwt():
        decoded = [chip_smoke.frame_digest(ref_decoder.decode(
            cs, device=False)) for cs in streams]
        cs = ref_encoder.encode(_reference_image(imgs[0]), _c2_params(rates),
                                device=False)
        layered = {}
        for layers in (1, 2, 0):
            out = ref_decoder.decode(cs, RefDecoderParams(layers=layers),
                                     device=False)
            layered[str(layers)] = {
                "pixels": chip_smoke.frame_digest(out),
                "mse": chip_smoke.frame_mse(out, imgs[0])}
    return {
        "what": "the reference host decoder (grokimagecompression_tpu "
                "decoder.decode(device=False), numpy DWT: "
                "dwt_host._get_native None and GROK_TPU_DWT=python) on the "
                "streams of config2_pcrd_97.json, and on frame 0 encoded "
                "as there with rates (96, 48, 24), decoded at layers 1, 2 "
                "and 0 (all); tests/test_torch_host_copies.py writes it",
        "decoded": decoded,
        "layered": {"rates": list(rates),
                    "stream": hashlib.sha256(cs).hexdigest(),
                    "layers": layered},
    }


def test_config2_decode_digest_file_is_current():
    with open(C2_DEC_DIGESTS) as f:
        assert json.load(f) == config2_decode_digests()


def _c2_ht_params(rates=()):
    from grokimagecompression_tpu.core.params import Transform
    return EncoderParams(numresolutions=6, transform=Transform.DWT_97,
                         cblk_style=HT, rates=rates)


def config2_ht_digests():
    """SHA-256 of the reference host encoder's HT streams of the 4
    config-2 frames (ICT + 9/7, the HT block coder; at the default base
    step and at ratio 24, one layer, by its quantizer-step search), each
    stream's length and target, and of the host decoder's pixels of every
    stream; numpy DWT throughout."""
    sys.path.insert(0, REPO)
    import chip_smoke
    imgs = _config2_streams()[0]
    out = {
        "what": "BASELINE config 2 with the HT block coder: the streams of "
                "grokimagecompression_tpu encoder.encode(EncoderParams("
                "numresolutions=6, transform=DWT_97, cblk_style=0x40[, "
                "rates=(24,)]), device=False) of chip_smoke."
                "config2_frames(4), and the pixels of decoder.decode("
                "device=False) of each, numpy DWT (dwt_host._get_native "
                "None, GROK_TPU_DWT=python); "
                "tests/test_torch_host_copies.py writes it",
        "frames": [chip_smoke.frame_digest(im) for im in imgs],
    }
    with _numpy_dwt():
        for key, rates in (("fixed", ()), ("ratio24", (24.0,))):
            streams = [ref_encoder.encode(_reference_image(im),
                                          _c2_ht_params(rates),
                                          device=False) for im in imgs]
            out[key] = {
                "rates": list(rates),
                "streams": [hashlib.sha256(cs).hexdigest()
                            for cs in streams],
                "bytes": [len(cs) for cs in streams],
                "decoded": [chip_smoke.frame_digest(ref_decoder.decode(
                    cs, device=False)) for cs in streams],
            }
    out["ratio24"]["targets"] = [
        max(256, int(sum(c.data.size * c.prec for c in im.components)
                     // 8 / 24.0)) for im in imgs]
    return out


def test_config2_ht_digest_file_is_current():
    with open(C2_HT_DIGESTS) as f:
        assert json.load(f) == config2_ht_digests()


def cinema_profiles_digests():
    """SHA-256 of the profile frames (`chip_smoke.cinema_sets`), of the
    reference host encoder's streams of each `chip_smoke.CIN_CASES` case
    (`profiles.encode_with_profile(..., device=False)`, numpy DWT), each
    stream's length, rsiz and per-component packet bytes (the reference's
    `index_tile_packets`) beside the profile's caps, and for the cinema
    cases the host decoder's pixels of every stream."""
    sys.path.insert(0, REPO)
    import chip_smoke

    from grokimagecompression_tpu.codestream import profiles as ref_profiles
    sets = chip_smoke.cinema_sets()
    out = {
        "what": "the profile encodes of chip_smoke.CIN_CASES: the streams "
                "of grokimagecompression_tpu profiles.encode_with_profile("
                "frame, profiles.apply_*(EncoderParams(...), frame, ...), "
                "device=False) of chip_smoke.cinema_sets(), their bytes, "
                "rsiz and per-component packet bytes (tile."
                "index_tile_packets), and for the cinema cases the pixels "
                "of decoder.decode(device=False) of each, numpy DWT "
                "(dwt_host._get_native None, GROK_TPU_DWT=python); "
                "tests/test_torch_host_copies.py writes it",
        "frames": {k: [chip_smoke.frame_digest(im) for im in v]
                   for k, v in sets.items() if k != "2k0"},
        "cases": {},
    }
    with _numpy_dwt():
        for case in chip_smoke.CIN_CASES:
            imgs = [_reference_image(im) for im in sets[case[1]]]
            entry = {"streams": [], "bytes": [], "comp_bytes": []}
            for img in imgs:
                prof = chip_smoke.cinema_profile(ref_profiles, EncoderParams,
                                                 case, img)
                cs = ref_profiles.encode_with_profile(img, prof,
                                                      device=False)
                hdr = ref_decoder.read_header(cs)
                bodies: dict = {}
                for tp in ref_decoder.iter_tile_parts(cs,
                                                      hdr.main_header_end):
                    bodies[tp.tile_index] = bodies.get(tp.tile_index,
                                                       b"") + tp.body
                comp = [0] * len(img.components)
                for t, body in bodies.items():
                    for (*_, c, _p, _o, ln) in ref_tile.index_tile_packets(
                            body, hdr, t):
                        comp[c] += ln
                entry["streams"].append(hashlib.sha256(cs).hexdigest())
                entry["bytes"].append(len(cs))
                entry["comp_bytes"].append(comp)
                entry.update(rsiz=hdr.siz.rsiz, tlm=hdr.tlm is not None,
                             max_cs_bytes=prof.max_cs_bytes,
                             max_comp_bytes=prof.max_comp_bytes)
                if case[2] == "apply_cinema":
                    entry.setdefault("decoded", []).append(
                        chip_smoke.frame_digest(ref_decoder.decode(
                            cs, device=False)))
            out["cases"][case[0]] = entry
    return out


def corpus_decode_digests():
    """The MD5 of the reference host decoder's planes (`test_goldens.
    _plane_md5`, numpy DWT) of every `tests/corpus/` stream that the
    port's decode_batch takes, and the names of those it refuses."""
    from test_goldens import _plane_md5
    decoded, refused = {}, []
    for name in sorted(os.listdir(CORPUS)):
        if not name.endswith((".j2k", ".jp2")):
            continue
        with open(os.path.join(CORPUS, name), "rb") as f:
            data = f.read()
        try:
            decoder.parse_batch([data])
        except NotImplementedError:
            refused.append(name)
            continue
        with _numpy_dwt():
            decoded[name] = _plane_md5(ref_decoder.decode(data, device=False))
    return {
        "what": "the MD5 of the planes (tests/test_goldens._plane_md5) of "
                "grokimagecompression_tpu decoder.decode(device=False), "
                "numpy DWT (dwt_host._get_native None, GROK_TPU_DWT="
                "python), of each tests/corpus stream that the port's "
                "decode_batch takes, and the streams it refuses; "
                "tests/test_torch_host_copies.py writes it",
        "decoded": decoded,
        "refused": refused,
    }


def test_corpus_decode_digest_file_is_current():
    with open(CORPUS_DIGESTS) as f:
        assert json.load(f) == corpus_decode_digests()


def window_decode_digests():
    """SHA-256 of the small window-decode frames
    (`chip_smoke.window_frames`), of the reference host encoder's streams
    of them at each `chip_smoke.WIN_CODINGS` entry (numpy DWT), and of
    its host decoder's pixels of each stream at each of the coding's
    `chip_smoke.window_requests` (numpy DWT, windowed inverse included)."""
    sys.path.insert(0, REPO)
    import chip_smoke

    from grokimagecompression_tpu.core.params import (DecoderParams as
                                                      RefDecoderParams)
    from grokimagecompression_tpu.core.params import Transform
    frames = chip_smoke.window_frames()
    codings = {}
    with _numpy_dwt():
        for coding in chip_smoke.WIN_CODINGS:
            params = chip_smoke.window_params(EncoderParams, Transform,
                                              coding)
            streams = [ref_encoder.encode(_reference_image(im), params,
                                          device=False) for im in frames]
            codings[coding] = {
                "streams": [hashlib.sha256(cs).hexdigest()
                            for cs in streams],
                "requests": {
                    chip_smoke.request_name(kw): [
                        chip_smoke.frame_digest(ref_decoder.decode(
                            cs, RefDecoderParams(**kw), device=False))
                        for cs in streams]
                    for kw in chip_smoke.window_requests(coding)}}
    return {
        "what": "grokimagecompression_tpu encoder.encode(device=False) of "
                "chip_smoke.window_frames() at each chip_smoke.WIN_CODINGS "
                "entry, and decoder.decode(DecoderParams(**request), "
                "device=False) of each stream at each of the coding's "
                "chip_smoke.window_requests, numpy DWT (dwt_host."
                "_get_native None, GROK_TPU_DWT=python); "
                "tests/test_torch_host_copies.py writes it",
        "frames": [chip_smoke.frame_digest(im) for im in frames],
        "codings": codings,
    }


def test_window_decode_digest_file_is_current():
    with open(WIN_DIGESTS) as f:
        assert json.load(f) == window_decode_digests()


def image_encode_digests():
    """SHA-256 of the small per-image encode frames
    (`chip_smoke.image_encode_frames`) and of the reference host
    encoder's streams of them (numpy DWT): `encoder.encode` at each
    `chip_smoke.IMG_ENC_CASES` entry, `codec.compress` at each
    `chip_smoke.IMG_COMPRESS` route, and `codec.Codec(preset=,
    container=).compress_image` of the small gray frame at each preset
    and container."""
    sys.path.insert(0, REPO)
    import chip_smoke

    from grokimagecompression_tpu import codec as ref_codec
    from grokimagecompression_tpu.codestream import markers as ref_markers
    from grokimagecompression_tpu.core import params as ref_params

    def sha(cs):
        return hashlib.sha256(cs).hexdigest()

    frames = chip_smoke.image_encode_frames()
    ref = {k: _reference_image(im) for k, im in frames.items()}
    with _numpy_dwt():
        encode = {case: sha(ref_encoder.encode(
            ref[frame], chip_smoke.image_encode_params(
                ref_params, ref_markers.PocEntry, case), device=False))
            for case, (frame, _) in chip_smoke.IMG_ENC_CASES.items()}
        compress = {route: sha(ref_codec.compress(
            chip_smoke.compress_array(frames, route), device=False, **opts))
            for route, opts in chip_smoke.IMG_COMPRESS.items()}
        presets = {f"{p}/{c}": sha(ref_codec.Codec(
            preset=p, container=c, device=False).compress_image(
                ref["small"]))
            for p in ref_codec.PRESETS for c in ("j2k", "jp2")}
    return {
        "what": "grokimagecompression_tpu encoder.encode(device=False) of "
                "chip_smoke.image_encode_frames() at each chip_smoke."
                "IMG_ENC_CASES entry, codec.compress(device=False) of "
                "chip_smoke.compress_array at each chip_smoke.IMG_COMPRESS "
                "route, and codec.Codec(preset=, container=, device=False)"
                ".compress_image of the small gray frame, numpy DWT "
                "(dwt_host._get_native None, GROK_TPU_DWT=python); "
                "tests/test_torch_host_copies.py writes it",
        "frames": {k: chip_smoke.frame_digest(im) for k, im in frames.items()},
        "encode": encode,
        "compress": compress,
        "presets": presets,
    }


def host_routes_digests():
    """`chip_smoke.py` phase 22's digests: config-2 frame 0
    (`chip_smoke.config2_frames`) coded by the reference host encoder at
    each `chip_smoke.ROUTE_CASES` entry (ROI at shift 6 and at
    `roi_max_shift`, a custom MCT with MQ at ratios 24 / 48 / 96 and with
    HT at the default step), SHA-256 of each stream and of the host
    decoder's pixels of it; and the small override and COC streams
    (`chip_smoke.override_stream` of the reference host encoder's streams
    at `override_params(ROUTE_SMALL)`, `chip_smoke.coc_stream` by the
    port on the CPU) of `chip_smoke.route_small_frame`, with the host
    decoder's pixels of each, whole and of one window at a reduction;
    numpy DWT throughout."""
    sys.path.insert(0, REPO)
    import chip_smoke

    from grokimagecompression_tpu.core import params as ref_params
    from grokimagecompression_tpu.core.params import (DecoderParams as
                                                      RefDecoderParams)
    from grokimagecompression_tpu_torch.core import params as port_params

    def sha(cs):
        return hashlib.sha256(cs).hexdigest()

    frame = chip_smoke.config2_frames(1)[0]
    small = chip_smoke.route_small_frame()
    cases = {}
    with _numpy_dwt():
        for name in chip_smoke.ROUTE_CASES:
            p = chip_smoke.route_params(ref_params, name)
            cs = ref_encoder.encode(_reference_image(frame), p, device=False)
            cases[name] = {"roi_shift": p.roi_shift, "stream": sha(cs),
                           "pixels": chip_smoke.frame_digest(
                               ref_decoder.decode(cs, device=False))}
        base, over = chip_smoke.override_params(ref_params,
                                                chip_smoke.ROUTE_SMALL)
        ref_small = _reference_image(small)
        override = chip_smoke.override_stream(
            ref_encoder.encode(ref_small, base, device=False),
            ref_encoder.encode(ref_small, over, device=False))
    coc = chip_smoke.coc_stream(small, port_params.EncoderParams(
        mct=port_params.MCT.NONE, **dict(
            chip_smoke.ROUTE_SMALL, transform=port_params.Transform.DWT_97)),
        "cpu")
    smalls = {}
    with _numpy_dwt():
        for name, cs in (("override", override), ("coc", coc)):
            smalls[name] = {"stream": sha(cs), "pixels": {
                chip_smoke.request_name(kw): chip_smoke.frame_digest(
                    ref_decoder.decode(cs, RefDecoderParams(**kw),
                                       device=False))
                for kw in chip_smoke.ROUTE_SMALL_REQUESTS}}
    return {
        "what": "grokimagecompression_tpu encoder.encode(device=False) of "
                "chip_smoke.config2_frames(1)[0] at each chip_smoke."
                "ROUTE_CASES entry and decoder.decode(device=False) of each "
                "stream; the small override stream (chip_smoke."
                "override_stream of the reference's streams) and COC stream "
                "(chip_smoke.coc_stream, the port on the CPU) of chip_smoke."
                "route_small_frame and the reference host decoder's pixels "
                "at each chip_smoke.ROUTE_SMALL_REQUESTS entry; numpy DWT "
                "(dwt_host._get_native None, GROK_TPU_DWT=python); "
                "tests/test_torch_host_copies.py writes it",
        "frame": chip_smoke.frame_digest(frame),
        "small_frame": chip_smoke.frame_digest(small),
        "cases": cases,
        "small": smalls,
    }


def test_host_routes_digest_file_is_current():
    with open(ROUTE_DIGESTS) as f:
        assert json.load(f) == host_routes_digests()


def test_image_encode_digest_file_is_current():
    with open(IMG_ENC_DIGESTS) as f:
        assert json.load(f) == image_encode_digests()


def test_cinema_profiles_digest_file_is_current():
    with open(CIN_DIGESTS) as f:
        assert json.load(f) == cinema_profiles_digests()


def test_chip_smoke_plane_md5_is_the_goldens():
    sys.path.insert(0, REPO)
    import chip_smoke
    from test_goldens import _plane_md5
    img = natural_image(24, 16, ncomp=3, seed=5)
    assert chip_smoke.plane_md5(img) == _plane_md5(img)


def test_quant_helpers_equal_reference():
    from grokimagecompression_tpu.ops import mct_np
    from grokimagecompression_tpu.ops import quant as ref_quant
    from grokimagecompression_tpu_torch.ops import quant
    for name in ("DWT_NORMS_53", "DWT_NORMS_97"):
        assert getattr(quant, name) == getattr(ref_quant, name), name
    assert quant.MCT_NORMS_IRREV == mct_np.MCT_NORMS_IRREV
    assert quant.MCT_NORMS_REV == mct_np.MCT_NORMS_REV
    for orient in range(4):
        for level in range(12):
            for rev in (True, False):
                assert quant.band_norm(orient, level, rev) == \
                    ref_quant.band_norm(orient, level, rev)
            assert quant.default_irrev_stepsize(orient, level) == \
                ref_quant.default_irrev_stepsize(orient, level)
    for step in (1e-4, 0.0371, 0.49, 0.5, 1.0, 1.7, 3.25, 117.0):
        for nbps in (8, 9, 12, 16):
            em = quant.encode_stepsize(step, nbps)
            assert em == ref_quant.encode_stepsize(step, nbps)
            assert quant.decode_stepsize(*em, nbps) == \
                ref_quant.decode_stepsize(*em, nbps)


def test_dequantize_and_reconstruct_equal_reference():
    """The copy of `quant.dequantize` equals the reference's, and the
    decode's tensor form `quant.reconstruct` equals both, bit for bit."""
    import torch
    from grokimagecompression_tpu.ops import quant as ref_quant
    from grokimagecompression_tpu_torch.ops import quant
    rng = np.random.default_rng(3)
    mag = rng.integers(0, 1 << 15, (32, 48)).astype(np.uint32)
    mag[rng.random(mag.shape) < 0.3] = 0
    neg = (rng.random(mag.shape) < 0.5).astype(np.uint8)
    for step in (0.0371, 0.4807, 1.0, 3.25):
        for pm in (0, 1, 4):
            want = ref_quant.dequantize(mag, neg, step, p_min=pm)
            got = quant.dequantize(mag, neg, step, p_min=pm)
            assert got.dtype == np.float32
            np.testing.assert_array_equal(got, want)
            rec = quant.reconstruct(
                torch.from_numpy(mag.astype(np.int32)),
                torch.from_numpy(neg != 0),
                torch.tensor(0.5 * (1 << pm), dtype=torch.float32),
                torch.tensor(step, dtype=torch.float32))
            np.testing.assert_array_equal(rec.numpy(), want)


def test_deadzone_equals_host_quantizer():
    import torch
    from grokimagecompression_tpu.ops import quant as ref_quant
    from grokimagecompression_tpu_torch.ops import quant
    rng = np.random.default_rng(2)
    v = (rng.standard_normal((64, 64)) * 300).astype(np.float32)
    step = 1.0 / 2.08
    v[0, :8] = np.float32(step) * np.arange(8, dtype=np.float32)  # on steps
    mag, neg = ref_quant.quantize(v, step)
    got = quant.deadzone(torch.from_numpy(v),
                         torch.tensor(step, dtype=torch.float64))
    np.testing.assert_array_equal(got.numpy(), mag.astype(np.int64))


@pytest.mark.parametrize("base_step", [0.0, 2.5])
@pytest.mark.parametrize("geom", [(2048, 2048, 6), (95, 81, 4),
                                  (45, 27, 3)])
def test_irreversible_plans_equal_reference(geom, base_step):
    from grokimagecompression_tpu.core.params import Transform
    w, h, nres = geom
    img = natural_image(w, h, ncomp=3, seed=1) if w < 2048 else \
        natural_image(64, 64, ncomp=3, seed=1)
    params = EncoderParams(numresolutions=nres, transform=Transform.DWT_97,
                           image_offset=(0, 0) if w == 2048 else (3, 1))
    if w == 2048:
        img = dataclasses.replace(img, xsiz=w, ysiz=h)
    rsiz = ref_encoder.build_siz(img, params)
    rcod = ref_encoder.build_cod(img, params)
    pimg = convert.image_from_reference(img)
    pparams = convert.params_from_reference(params)
    psiz = encoder.build_siz(pimg, pparams)
    pcod = encoder.build_cod(pimg, pparams)
    for gb in (1, 2):
        rqcd = ref_tile.default_qcd(rsiz, rcod, gb, base_step)
        pqcd = tile.default_qcd(psiz, pcod, gb, base_step)
        assert _asdict(pqcd) == _asdict(rqcd)
        derived = dataclasses.replace(pqcd, style=1)      # SCALAR_DERIVED
        rderived = dataclasses.replace(rqcd, style=1)
        tr = tile_rect(0, psiz.xsiz, psiz.ysiz, psiz.xosiz, psiz.yosiz,
                       psiz.xtsiz, psiz.ytsiz, psiz.xtosiz, psiz.ytosiz)
        rtr = ref_rect(0, rsiz.xsiz, rsiz.ysiz, rsiz.xosiz, rsiz.yosiz,
                       rsiz.xtsiz, rsiz.ytsiz, rsiz.xtosiz, rsiz.ytosiz)
        for c in range(3):
            for pq, rq in ((pqcd, rqcd), (derived, rderived)):
                assert _asdict(tile.build_comp_plan(psiz, pcod, pq, tr, c)) \
                    == _asdict(ref_tile.build_comp_plan(rsiz, rcod, rq, rtr,
                                                        c))


def _rd_blocks(mod_t2, n, seed):
    """n code-blocks of the given T2 module with random monotone R-D
    tables (a few with no passes)."""
    from grokimagecompression_tpu_torch.core.geometry import (CodeBlock,
                                                              Rect)
    rng = np.random.default_rng(seed)
    cbs = []
    for i in range(n):
        npas = int(rng.integers(0, 20)) if i % 7 else 0
        rates = np.cumsum(rng.integers(0, 60, npas))
        dists = np.cumsum(rng.random(npas) * rng.choice([1e2, 1e5], npas))
        passes = [mod_t2.PassInfo(rate=int(r), distortion=float(d),
                                  terminated=k == npas - 1)
                  for k, (r, d) in enumerate(zip(rates, dists))]
        # 12 blocks a precinct of a 4 x 3 code-block grid
        geom = CodeBlock(rect=Rect(0, 0, 4, 4), cx=i % 12 % 4,
                         cy=i % 12 // 4)
        cbs.append(mod_t2.CblkEnc(geom=geom, data=bytes(int(rates[-1])
                                                        if npas else 0),
                                  numbps=5, imsb=2, numpasses=npas,
                                  passes=passes))
    return cbs


def test_pcrd_hull_and_allocator_equal_reference():
    from grokimagecompression_tpu.codestream import pcrd as ref_pcrd
    from grokimagecompression_tpu.codestream import t2 as ref_t2
    from grokimagecompression_tpu.t1 import t1_np
    from grokimagecompression_tpu_torch.codestream import pcrd
    from grokimagecompression_tpu_torch.codestream import t2 as port_t2

    class RefT2:
        PassInfo = t1_np.PassInfo
        CblkEnc = ref_t2.CblkEnc

    ours = _rd_blocks(port_t2, 40, seed=3)
    theirs = _rd_blocks(RefT2, 40, seed=3)
    for a, b in zip(ours, theirs):
        assert [dataclasses.astuple(h) for h in pcrd.convex_hull(a)] == \
            [dataclasses.astuple(h) for h in ref_pcrd.convex_hull(b)]
    for rates, q in (((24.0, 48.0, 96.0), ()), ((3.0, 0.0), ()),
                     ((8.0, 4.0, 1.5), ())):
        got = []
        for mod, cbs in ((pcrd, ours), (ref_pcrd, theirs)):
            def sim(layer, cbs=cbs):
                return sum(cb.pass_bytes(0, sum(cb.layer_npasses[:layer + 1]))
                           + 3 for cb in cbs)
            ctx = mod.RateControlCtx(cblks=cbs, numlayers=len(rates),
                                     tile_samples=4096, image_samples=4096,
                                     max_prec=8, simulate_upto=sim)
            mod.PCRDAllocator(rates=rates, quality_psnr=q,
                              image_bytes=4096)(ctx)
            got.append([list(cb.layer_npasses) for cb in cbs])
        assert got[0] == got[1], rates


def test_tile_sim_equals_reference():
    """The port's native tile simulator against the reference's on one
    rate-controlled tile: byte totals per layer and per precinct group."""
    from grokimagecompression_tpu.codestream import t2 as ref_t2
    from grokimagecompression_tpu.native import t2_native as ref_native
    from grokimagecompression_tpu.t1 import t1_np
    from grokimagecompression_tpu_torch.codestream import t2 as port_t2
    from grokimagecompression_tpu_torch.native import t2_native

    class RefT2:
        PassInfo = t1_np.PassInfo
        CblkEnc = ref_t2.CblkEnc
        PrecEnc = ref_t2.PrecEnc

    sims = []
    for mod, native in ((port_t2, t2_native), (RefT2, ref_native)):
        cbs = _rd_blocks(mod, 48, seed=9)
        groups = [((g, 0, 0), g % 3,
                   [mod.PrecEnc(geom=_prec_geom(),
                                cblks=cbs[12 * g:12 * g + 12])])
                  for g in range(4)]
        rng = np.random.default_rng(4)
        cols = np.zeros((3, len(cbs)), np.int64)
        for i, cb in enumerate(cbs):
            cut = sorted(rng.integers(0, cb.numpasses + 1, 2)) \
                if cb.numpasses else [0, 0]
            cols[:, i] = (cut[0], cut[1] - cut[0], cb.numpasses - cut[1])
        sim = native.TileSim(groups, 3, True)
        for layer in range(3):
            sim.write_rows(layer, cols[layer], cbs)
        sims.append(sim)
    for layer in range(3):
        a_tot, a_g = sims[0].simulate(layer)
        b_tot, b_g = sims[1].simulate(layer)
        assert a_tot == b_tot and list(a_g) == list(b_g), layer
    assert sims[0].comps == sims[1].comps


def _prec_geom():
    from grokimagecompression_tpu_torch.core.geometry import Precinct, Rect
    return Precinct(index=0, rect=Rect(0, 0, 16, 12), cblk_grid_w=4,
                    cblk_grid_h=3, cblks=())


def test_pass_info_equals_reference():
    from grokimagecompression_tpu.t1 import t1_np
    from grokimagecompression_tpu_torch.codestream import t2 as port_t2
    assert [(f.name, f.type, f.default) for f in
            dataclasses.fields(port_t2.PassInfo)] == \
        [(f.name, f.type, f.default) for f in
         dataclasses.fields(t1_np.PassInfo)]


if __name__ == "__main__":
    for path, style in ((DIGESTS, HT), (MQ_DIGESTS, 0)):
        with open(path, "w") as f:
            json.dump(config1_digests(style), f, indent=1)
            f.write("\n")
    with open(C2_DIGESTS, "w") as f:
        json.dump(config2_digests(), f, indent=1)
        f.write("\n")
    with open(C2_DEC_DIGESTS, "w") as f:
        json.dump(config2_decode_digests(), f, indent=1)
        f.write("\n")
    with open(C2_HT_DIGESTS, "w") as f:
        json.dump(config2_ht_digests(), f, indent=1)
        f.write("\n")
    with open(CORPUS_DIGESTS, "w") as f:
        json.dump(corpus_decode_digests(), f, indent=1)
        f.write("\n")
    with open(CIN_DIGESTS, "w") as f:
        json.dump(cinema_profiles_digests(), f, indent=1)
        f.write("\n")
    with open(WIN_DIGESTS, "w") as f:
        json.dump(window_decode_digests(), f, indent=1)
        f.write("\n")
    with open(IMG_ENC_DIGESTS, "w") as f:
        json.dump(image_encode_digests(), f, indent=1)
        f.write("\n")
    with open(ROUTE_DIGESTS, "w") as f:
        json.dump(host_routes_digests(), f, indent=1)
        f.write("\n")
