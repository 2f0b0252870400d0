"""The port's HT lossless decode slice end to end, on the CPU.

`grokimagecompression_tpu_torch.codestream.decoder.decode_batch` must
return the source pixels and equal the reference's host decode
(`decoder.decode(cs, device=False)`) on streams of the reference host
encoder: gray, RGB with RCT, two tiles, an odd origin at 12 bits, a
stream that lost a tile, two tiles with equal band shapes but opposite
origin parity (which must not share a decode plan), and frames that
leave out different code-blocks of one tile. One case also equals the
reference's fused `decode_batch(device=True)`. Streams
outside the slice (`tests/test_torch_decode_gate.py` holds the gate to
the reference's) raise NotImplementedError, and a reduced, windowed or
single-tile request equals the reference's decode; a CUDA request
without CUDA raises RuntimeError.
"""

import struct

import numpy as np
import pytest
import torch

from grokimagecompression_tpu.codestream import decoder as ref_decoder
from grokimagecompression_tpu.codestream import encoder as ref_encoder
from grokimagecompression_tpu.core.image import Component, Image
from grokimagecompression_tpu.core.params import (DecoderParams as
                                                  RefDecoderParams)
from grokimagecompression_tpu.core.params import EncoderParams
from grokimagecompression_tpu_torch.codestream import decoder
from grokimagecompression_tpu_torch.core.params import DecoderParams
from grokimagecompression_tpu_torch.models import pipeline

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


def _frames(n, w, h, ncomp=1, seed=0, prec=8):
    return [natural_image(w, h, ncomp=ncomp, seed=seed + i, prec=prec)
            for i in range(n)]


def _encode(imgs, params):
    return [ref_encoder.encode(im, params, device=False) for im in imgs]


def _check(imgs, streams, chunk=32):
    got = decoder.decode_batch(streams, device="cpu", chunk=chunk)
    assert len(got) == len(streams)
    for im, cs, out in zip(imgs, streams, got):
        ref = ref_decoder.decode(cs, device=False)
        assert (out.x0, out.y0, out.xsiz, out.ysiz) == \
            (ref.x0, ref.y0, ref.xsiz, ref.ysiz)
        for c, comp in enumerate(out.components):
            assert comp.data.dtype == np.int32
            np.testing.assert_array_equal(comp.data,
                                          ref.components[c].data)
            if im is not None:
                np.testing.assert_array_equal(
                    comp.data, im.components[c].data[out.y0:, out.x0:])
    return got


CASES = [
    ("gray_chunk2", _frames(3, 64, 64),
     EncoderParams(numresolutions=3, cblk_style=HT), 2),
    ("rgb_rct", _frames(2, 40, 36, ncomp=3, seed=4),
     EncoderParams(numresolutions=3, cblk_style=HT), 32),
    ("two_tiles", _frames(2, 64, 40, seed=8),
     EncoderParams(numresolutions=3, cblk_style=HT, tile_size=(40, 40),
                   cblk_w_exp=4, cblk_h_exp=4), 3),
    ("odd_origin_12bit", _frames(1, 45, 27, seed=11, prec=12),
     EncoderParams(numresolutions=4, cblk_style=HT, image_offset=(3, 5),
                   tile_offset=(1, 2)), 32),
]


@pytest.mark.parametrize("name,imgs,params,chunk", CASES,
                         ids=[c[0] for c in CASES])
def test_decode_batch_returns_source(name, imgs, params, chunk):
    _check(imgs, _encode(imgs, params), chunk)


def test_missing_tile_stays_zero():
    imgs = _frames(2, 64, 40, seed=8)
    params = EncoderParams(numresolutions=3, cblk_style=HT,
                           tile_size=(40, 40))
    streams = _encode(imgs, params)
    cut = []
    for cs in streams:
        hdr = decoder.read_header(cs)
        start = hdr.main_header_end
        psot = struct.unpack(">I", cs[start + 6:start + 10])[0]
        cut.append(cs[:start + psot] + b"\xff\xd9")   # tile 0, then EOC
    got = _check([None, None], cut)
    for im, out in zip(imgs, got):
        np.testing.assert_array_equal(out.components[0].data[:, :40],
                                      im.components[0].data[:, :40])
        assert not out.components[0].data[:, 40:].any()


def test_equal_band_shapes_opposite_parity_do_not_share_a_plan():
    """Tiles 0 and 2 are both 32 x 32 with equal band shapes and block
    layouts (one 64 x 64 code-block grid cell per band), at canvas
    origins 1 (odd) and 66 (even): their inverse DWT differs, so they
    need two plans."""
    imgs = _frames(2, 98, 32, seed=21)
    params = EncoderParams(numresolutions=2, cblk_style=HT,
                           tile_size=(33, 32), image_offset=(1, 0))
    streams = _encode(imgs, params)
    hdr, trs, parsed = decoder.parse_batch(streams)
    assert (trs[0].x0, trs[0].w, trs[2].x0, trs[2].w) == (1, 32, 66, 32)
    groups = decoder.tile_groups(hdr, trs, parsed)
    sigs = {(plan.band_shapes, plan.groups)
            for plan, tiles in groups.items() if 0 in tiles or 2 in tiles}
    assert len(sigs) == 1          # same shapes and blocks ...
    cfg0 = pipeline.config_for_tile(hdr.siz, hdr.cod, trs[0])
    cfg2 = pipeline.config_for_tile(hdr.siz, hdr.cod, trs[2])
    assert cfg0 != cfg2            # ... but another transform
    assert not any(0 in t and 2 in t for t in groups.values())
    _check(imgs, streams, chunk=3)


def _gray(d):
    return Image(xsiz=d.shape[1], ysiz=d.shape[0], components=[
        Component(data=d, prec=8, signed=False, dx=1, dy=1)])


def test_frames_that_leave_out_different_code_blocks():
    """Two frames of one geometry, flat (mid-grey) in the top left and
    the top right corner, whose streams leave out their all-zero
    code-blocks: as many blocks in each, but not the same ones. Every job must reach its own
    code-block's lane."""
    params = EncoderParams(numresolutions=3, cblk_style=HT, cblk_w_exp=4,
                           cblk_h_exp=4)
    noise = np.random.default_rng(3).integers(0, 256, (96, 96)).astype(
        np.int32)
    imgs = []
    for y, x in ((0, 0), (0, 48)):
        d = noise.copy()
        d[y:y + 48, x:x + 48] = 128
        imgs.append(_gray(d))
    flat = _encode([_gray(np.full((96, 96), 128, np.int32))], params)
    zero_segs = [bytes(j[0]) for j in decoder.parse_batch(flat)[2][0][0][0][0]]
    streams, kept = [], []
    for im, cs in zip(imgs, _encode(imgs, params)):
        jobs = decoder.parse_batch([cs])[2][0][0][0][0]
        segs = [bytes(j[0]) for j in jobs]
        # a block coded as the flat frame codes it is all zero: leave it
        # out of the stream (no coding passes), as encoders may
        segs = [(b"", 0, 0) if sg == z else sg
                for sg, z in zip(segs, zero_segs)]
        kept.append({i for i, sg in enumerate(segs) if sg != (b"", 0, 0)})
        streams.append(ref_encoder.encode(
            im, params, device=False, _t1_segments_by_tile={0: segs}))
    assert len(kept[0]) == len(kept[1]) < len(zero_segs)
    assert kept[0] != kept[1]
    _check(imgs, streams, chunk=2)


def test_prepare_chunk_rejects_a_block_outside_the_plan():
    from grokimagecompression_tpu_torch.models import fused_decode

    streams = _encode(_frames(1, 32, 32), EncoderParams(numresolutions=2,
                                                        cblk_style=HT))
    hdr, trs, parsed = decoder.parse_batch(streams)
    jobs, slots, plans, _ = parsed[0][0][0]
    plan = fused_decode.build_plan(plans, hdr.siz, hdr.cod, trs[0])
    frame = fused_decode.jobs_by_block(jobs, slots, plans)
    assert len(frame) == sum(len(lanes) for _, _, lanes in plan.groups)
    fused_decode.prepare_chunk(plan, [frame])
    stray = dict(frame)
    stray[(0, (0, 0), 999, 0)] = jobs[0]
    with pytest.raises(ValueError):
        fused_decode.prepare_chunk(plan, [frame, stray])


def test_equals_reference_fused_decode_batch():
    """The reference's own decode_batch case (5/3 frames of
    tests/test_device_decode.py, one with all-empty blocks), cut from 5
    frames of 96x128 to 3 of 48x64 in one chunk: the reference's fused
    decode compiles once, and its compile is most of the test's time."""
    rng = np.random.default_rng(5)
    frames = []
    for i in range(3):
        if i == 2:
            d = np.zeros((48, 64), np.int32)
            d[10, 10] = 200
        else:
            d = rng.integers(0, 256, (48, 64)).astype(np.int32)
        frames.append(Image(xsiz=64, ysiz=48, components=[
            Component(data=d, prec=8, signed=False, dx=1, dy=1)]))
    params = EncoderParams(numresolutions=4, cblk_style=HT)
    streams = _encode(frames, params)
    want = ref_decoder.decode_batch(streams, device=True, chunk=3)
    got = _check(frames, streams, chunk=3)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.components[0].data,
                                      w.components[0].data)


def test_out_of_slice_raises():
    img = _frames(1, 24, 24)
    for params in (EncoderParams(cblk_style=0x01),   # MQ with bypass
                   EncoderParams(cblk_style=HT, ht_refinement=True),
                   EncoderParams(roi_comp=0, roi_shift=3)):
        with pytest.raises(NotImplementedError):
            decoder.decode_batch(_encode(img, params), device="cpu")
    # packed headers and COC are inside the gate now
    # (tests/test_torch_decode_gate.py decodes them)
    for params in (EncoderParams(cblk_style=HT, ppt_markers=True),
                   EncoderParams(cblk_style=HT, ppm_markers=True),
                   EncoderParams(cblk_style=HT, comp_cblk_exps={0: (4, 4)})):
        decoder.parse_batch(_encode(img, params))
    # reduce, window and single-tile requests are inside the slice now
    # (tests/test_torch_window_decode.py holds them to the reference)
    cs = _encode(img, EncoderParams(cblk_style=HT, numresolutions=3))
    for kw in ({"reduce": 1}, {"window": (0, 0, 8, 8)}, {"tile_index": 0}):
        (got,) = decoder.decode_batch(cs, DecoderParams(**kw), device="cpu")
        want = ref_decoder.decode(cs[0], RefDecoderParams(**kw),
                                  device=False)
        np.testing.assert_array_equal(got.components[0].data,
                                      want.components[0].data)
    other = _encode(_frames(1, 24, 16), EncoderParams(cblk_style=HT,
                                                      numresolutions=3))
    with pytest.raises(NotImplementedError):
        decoder.decode_batch(cs + other, device="cpu")
    assert decoder.decode_batch([], device="cpu") == []


def test_cuda_request_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    cs = _encode(_frames(1, 16, 16), EncoderParams(cblk_style=HT,
                                                   numresolutions=2))
    with pytest.raises(RuntimeError):
        decoder.decode_batch(cs)


@pytest.mark.parametrize("name,imgs,params,chunk", CASES[1:],
                         ids=[c[0] for c in CASES[1:]])
def test_dec_plan_equals_reference_plan(monkeypatch, name, imgs, params,
                                        chunk):
    """The port's decode plan of every tile equals the reference's
    `FusedDecPlan` (captured where its batch decode builds it) carried
    over by `convert.dec_plan_from_reference`."""
    from grokimagecompression_tpu.codestream import tile as ref_tile
    from grokimagecompression_tpu.models import fused_decode as ref_fd
    from grokimagecompression_tpu_torch import convert
    from grokimagecompression_tpu_torch.models import fused_decode

    captured = []
    monkeypatch.setattr(ref_fd, "_jitted_fused_dec_batch",
                        lambda plan, dims, n: captured.append(plan))
    streams = _encode(imgs, params)
    hdr, trs, parsed = decoder.parse_batch(streams)
    ref_hdr = ref_decoder.read_header(streams[0])
    bodies = {}
    for tp in ref_decoder.iter_tile_parts(streams[0], ref_hdr.main_header_end):
        bodies[tp.tile_index] = bodies.get(tp.tile_index, b"") + tp.body
    for t, tr in enumerate(trs):
        jobs, slots, plans, _ = parsed[0][0][t]
        ref_rect = ref_decoder.tile_rect(
            t, *(getattr(ref_hdr.siz, k) for k in (
                "xsiz", "ysiz", "xosiz", "yosiz", "xtsiz", "ytsiz",
                "xtosiz", "ytosiz")))
        _, rjobs, rslots, rplans, rcods = ref_tile.decode_tile(
            bodies[t], ref_hdr.siz, ref_hdr.cod, ref_hdr.qcd, ref_rect,
            _return_jobs=True)
        ref_fd.decode_tiles_device_submit(
            [(rjobs, rslots)], rplans, rcods, ref_hdr.siz, ref_hdr.cod,
            ref_rect, {}, _prepare_only=True)
        want = convert.dec_plan_from_reference(captured[-1])
        assert len(jobs) == sum(len(lanes) for _, _, lanes in want.groups)
        assert fused_decode.build_plan(plans, hdr.siz, hdr.cod, tr) == want
