"""The port's Part-1 MQ lossless decode slice end to end, on the CPU.

`grokimagecompression_tpu_torch.codestream.decoder.decode_batch` on
streams of the reference host encoder in the default code-block style
(`cblk_style=0`) must return the source pixels and equal the reference's
host decode (`decoder.decode(cs, device=False)`): gray, RGB with RCT, two
tiles at an odd origin, frames that leave out different code-blocks of
one tile, and a 5/3 stream with a rate target, whose truncated blocks
take the per-lane mid-point addends. One small case also equals the
reference's fused device decode (`fused_decode.decode_tile_device` on
the CPU, through `mq_dec_jax.decode_core`). Other MQ code-block styles
and blocks of several codeword segments raise NotImplementedError.

Code-blocks are 16x16 or smaller: the plain decoder walks one torch step
per decision of the batch's busiest lanes.
"""

import numpy as np
import pytest
import torch

from grokimagecompression_tpu.codestream import decoder as ref_decoder
from grokimagecompression_tpu.codestream import encoder as ref_encoder
from grokimagecompression_tpu.core.image import Component, Image
from grokimagecompression_tpu.core.params import EncoderParams
from grokimagecompression_tpu_torch.codestream import decoder
from grokimagecompression_tpu_torch.models import fused_decode

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


SMALL = dict(cblk_w_exp=4, cblk_h_exp=4)


def _encode(imgs, params):
    return [ref_encoder.encode(im, params, device=False) for im in imgs]


def _check(imgs, streams, chunk=32):
    """decode_batch on the CPU equals the reference host decode and, where
    a source is given, the source."""
    got = decoder.decode_batch(streams, device="cpu", chunk=chunk)
    assert len(got) == len(streams)
    for im, cs, out in zip(imgs, streams, got):
        ref = ref_decoder.decode(cs, device=False)
        assert (out.x0, out.y0, out.xsiz, out.ysiz) == \
            (ref.x0, ref.y0, ref.xsiz, ref.ysiz)
        for c, comp in enumerate(out.components):
            assert comp.data.dtype == np.int32
            np.testing.assert_array_equal(comp.data, ref.components[c].data)
            if im is not None:
                np.testing.assert_array_equal(
                    comp.data, im.components[c].data[out.y0:, out.x0:])
    return got


CASES = [
    ("gray_64x48", [natural_image(64, 48, seed=s) for s in range(2)],
     EncoderParams(numresolutions=3, cblk_style=0, **SMALL), 32),
    ("rgb_rct", [natural_image(40, 36, ncomp=3, seed=4)],
     EncoderParams(numresolutions=3, cblk_style=0, **SMALL), 32),
    ("two_tiles_odd_origin", [natural_image(45, 27, seed=11)],
     EncoderParams(numresolutions=3, cblk_style=0, tile_size=(24, 24),
                   image_offset=(3, 5), tile_offset=(1, 2), **SMALL), 1),
]


@pytest.mark.parametrize("name,imgs,params,chunk", CASES,
                         ids=[c[0] for c in CASES])
def test_decode_batch_returns_source(name, imgs, params, chunk):
    _check(imgs, _encode(imgs, params), chunk)


def test_rate_truncated_53_equals_host_decode():
    """A 5/3 stream with a rate target: blocks lose passes and bytes, and
    their nonzero magnitudes take half of their lowest decoded plane."""
    img = natural_image(64, 48, seed=7)
    params = EncoderParams(numresolutions=3, cblk_style=0, rates=(6.0,),
                           **SMALL)
    (cs,) = _encode([img], params)
    hdr, trs, parsed = decoder.parse_batch([cs])
    jobs = parsed[0][0][0][0]
    assert any(j[6] < 3 * j[5] - 2 for j in jobs)      # truncated blocks
    (out,) = _check([None], [cs])
    assert not np.array_equal(out.components[0].data,
                              img.components[0].data)


def _gray(d):
    return Image(xsiz=d.shape[1], ysiz=d.shape[0], components=[
        Component(data=d, prec=8, signed=False, dx=1, dy=1)])


def test_frames_that_leave_out_different_code_blocks():
    """Two frames of one geometry, flat (mid-grey) but for a patch of
    noise, in the left half of one and the right half of the other: the
    MQ encoder leaves out their all-zero
    code-blocks (no coding pass), as many in each frame, but not the
    same ones. Every job must reach its own code-block's lane; a
    left-out block stays zero."""
    params = EncoderParams(numresolutions=2, cblk_style=0, cblk_w_exp=3,
                           cblk_h_exp=3)
    noise = np.random.default_rng(3).integers(0, 256, (16, 16))
    imgs = []
    for x in (8, 40):   # 32 apart: a multiple of every level's block grid
        d = np.full((32, 64), 128, np.int32)
        d[8:24, x:x + 16] = noise
        imgs.append(_gray(d))
    streams = _encode(imgs, params)
    hdr, trs, parsed = decoder.parse_batch(streams)
    kept = [set(fused_decode.jobs_by_block(*p[0][0][:3])) for p in parsed]
    plan = fused_decode.build_plan(parsed[0][0][0][2], hdr.siz, hdr.cod,
                                   trs[0], coder="mq")
    nblocks = sum(len(lanes) for _, _, lanes in plan.groups)
    assert len(kept[0]) == len(kept[1]) < nblocks
    assert kept[0] != kept[1]
    _check(imgs, streams, chunk=2)


def test_equals_reference_fused_mq_decode():
    """The reference's fused device decode of one tile on the CPU (its MQ
    groups through mq_dec_jax.decode_core) against the port's."""
    from grokimagecompression_tpu.codestream import tile as ref_tile
    from grokimagecompression_tpu.models import fused_decode as ref_fd

    img = natural_image(20, 12, seed=2)
    (cs,) = _encode([img], EncoderParams(numresolutions=2, cblk_style=0,
                                         cblk_w_exp=3, cblk_h_exp=3))
    hdr = ref_decoder.read_header(cs)
    body = b"".join(tp.body for tp in ref_decoder.iter_tile_parts(
        cs, hdr.main_header_end))
    rect = ref_decoder.tile_rect(0, *(getattr(hdr.siz, k) for k in (
        "xsiz", "ysiz", "xosiz", "yosiz", "xtsiz", "ytsiz", "xtosiz",
        "ytosiz")))
    _, jobs, slots, plans, cods = ref_tile.decode_tile(
        body, hdr.siz, hdr.cod, hdr.qcd, rect, _return_jobs=True)
    want = ref_fd.decode_tile_device(jobs, slots, plans, cods, hdr.siz,
                                     hdr.cod, rect, {})
    assert want is not None
    (got,) = _check([img], [cs])
    np.testing.assert_array_equal(got.components[0].data, want[0])


def test_other_mq_styles_and_segments_raise():
    """HT refinement streams, with each MQ mode switch bit beside the HT
    one, decode on the host decoders to the host decoder's pixels (the MQ
    styles themselves decode on the host Tier-1 route,
    tests/test_torch_t1_styles.py); an MQ plan's lane group raises on a
    block of several codeword segments."""
    img = [natural_image(16, 16, seed=1)]
    for style in (0x01, 0x02, 0x04, 0x08, 0x10, 0x20):
        _check([None], _encode(img, EncoderParams(
            numresolutions=2, cblk_style=0x40 | style,
            ht_refinement=True)))
    streams = _encode(img, EncoderParams(numresolutions=2, cblk_style=0))
    hdr, trs, parsed = decoder.parse_batch(streams)
    jobs, slots, plans = parsed[0][0][0][:3]
    plan = fused_decode.build_plan(plans, hdr.siz, hdr.cod, trs[0],
                                   coder="mq")
    frame = fused_decode.jobs_by_block(jobs, slots, plans)
    fused_decode.prepare_chunk(plan, [frame])
    key = next(k for k, j in frame.items() if len(j[0]) > 2)
    job = frame[key]
    split = dict(frame)
    split[key] = (job[0], [2, len(job[0]) - 2]) + tuple(job[2:])
    with pytest.raises(NotImplementedError):
        fused_decode.prepare_chunk(plan, [split])
