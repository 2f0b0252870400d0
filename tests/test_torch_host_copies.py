"""The port's copies of the reference's host layers, held to the originals.

The port owns copies of the host code it runs (`core/`, the codestream
markers, header walk, tile plans and T2, the native T2 and HT prepass in
`csrc/host/`). On the streams of the encode cases, its `read_header`,
tile packet parse (jobs and slots), `build_comp_plan` and `default_qcd`
must equal the reference's; its native T2 must agree with its Python
T2; the config-1 digest files that `chip_smoke.py` checks the card's
streams against (HT and MQ) must equal digests made afresh with the
reference host encoder; and the port's MQ tables and `trunc_plane` must
equal the reference's.

Run `PYTHONPATH=. python tests/test_torch_host_copies.py` from the
repository root to rewrite the digest files.
"""

import dataclasses
import hashlib
import json
import os
import sys

import numpy as np
import pytest

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

HT = 0x40
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(REPO, "grokimagecompression_tpu_torch", "data")
DIGESTS = os.path.join(DATA, "config1_ht_lossless.json")
MQ_DIGESTS = os.path.join(DATA, "config1_mq_lossless.json")

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


if __name__ == "__main__":
    for path, style in ((DIGESTS, HT), (MQ_DIGESTS, 0)):
        with open(path, "w") as f:
            json.dump(config1_digests(style), f, indent=1)
            f.write("\n")
