"""`encode_batch`'s chunk, capped to the device memory an MQ plan needs.

`fused_encode.mq_frame_bytes` gives a plan's peak device bytes a frame
in the MQ encode, and `fused_encode.chunk_cap` the frames that fit in
half of a given free byte count, at least one; `encoder.encode_batch`
caps its chunk with them on a CUDA device (`free_device_bytes`). On the
CPU the free byte count is given by the test. The streams must not
depend on the chunk. A profile's explicit allocator plans the R-D
tables, and the model counts them.
"""

import dataclasses
import os
import sys

import numpy as np
import pytest
import torch

from grokimagecompression_tpu_torch.codestream import encoder
from grokimagecompression_tpu_torch.codestream.tile import default_qcd
from grokimagecompression_tpu_torch.core.geometry import tile_rect
from grokimagecompression_tpu_torch.core.image import Component, Image
from grokimagecompression_tpu_torch.core.params import (EncoderParams,
                                                        Transform)
from grokimagecompression_tpu_torch.models import fused_encode
from grokimagecompression_tpu_torch.ops import mq_scan, mq_torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Torch on one thread: the plain versions run many small CPU ops, and
    under pytest-xdist's workers torch's OpenMP threads oversubscribe the
    cores and spin (a case of 2.4 s alone took 43 s among six workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _plan(img, params, coder="mq"):
    siz = encoder.build_siz(img, params)
    cod = encoder.build_cod(img, params)
    qcd = default_qcd(siz, cod, params.num_guard_bits, params.base_step)
    tr = tile_rect(0, siz.xsiz, siz.ysiz, siz.xosiz, siz.yosiz, siz.xtsiz,
                   siz.ytsiz, siz.xtosiz, siz.ytosiz)
    return fused_encode.build_plan(siz, cod, qcd, tr, coder=coder,
                                   want_rd=bool(params.rates))


def _config2_plan():
    sys.path.insert(0, REPO)
    import chip_smoke
    img = chip_smoke.config2_frames(1)[0]
    return _plan(img, EncoderParams(numresolutions=6,
                                    transform=Transform.DWT_97, numlayers=3,
                                    rates=(24.0, 48.0, 96.0)))


def _frames(n, w=32, h=32):
    rng = np.random.default_rng(8)
    yy, xx = np.mgrid[0:h, 0:w]
    return [Image(xsiz=w, ysiz=h, components=[Component(
        data=(128 + 60 * np.sin(yy / 5.0 + i) * np.cos(xx / 7.0)
              + rng.integers(0, 16, (h, w))).astype(np.int32),
        prec=8, signed=False, dx=1, dy=1)]) for i in range(n)]


def test_chunk_cap_from_free_bytes():
    plan = _config2_plan()
    per = fused_encode.mq_frame_bytes(plan)
    (h, w, blocks), = plan.groups
    stream = len(blocks) * 15 * mq_torch.slots_per_plane(h, w)
    assert stream < per < 8 * stream             # the slot stream leads
    fixed = mq_scan.EMIT_BLOCK_BYTES
    assert fused_encode.chunk_cap(plan, 2 * (9 * per + fixed)) == 9
    assert fused_encode.chunk_cap(plan, 2 * (9 * per + fixed) - 2) == 8
    assert fused_encode.chunk_cap(plan, 0) == 1
    # the default chunk of 32 config-2 frames does not fit an 80 GB card
    assert fused_encode.chunk_cap(plan, 80 * 10 ** 9) < 32
    with pytest.raises(ValueError):
        fused_encode.mq_frame_bytes(_plan(
            _frames(1)[0], EncoderParams(numresolutions=3, cblk_style=0x40),
            coder="ht"))


def test_streams_do_not_depend_on_the_chunk(monkeypatch):
    """A small 9/7 plan with rates: the streams at chunk 1, 2 and 4 are
    equal, and a free byte count that caps the chunk to 1 encodes them
    one frame a chunk, to the same streams."""
    imgs = _frames(4)
    params = EncoderParams(numresolutions=3, transform=Transform.DWT_97,
                           numlayers=2, rates=(30.0, 10.0), cblk_w_exp=4,
                           cblk_h_exp=4)
    want = encoder.encode_batch(imgs, params, device="cpu", chunk=4)
    for chunk in (1, 2):
        assert encoder.encode_batch(imgs, params, device="cpu",
                                    chunk=chunk) == want
    sizes = []
    submit = fused_encode.encode_tile_submit
    monkeypatch.setattr(encoder, "free_device_bytes", lambda dev: 1)
    monkeypatch.setattr(fused_encode, "encode_tile_submit",
                        lambda comps, enc: sizes.append(comps[0].shape[0])
                        or submit(comps, enc))
    assert encoder.encode_batch(imgs, params, device="cpu") == want
    assert sizes == [1, 1, 1, 1]


def _config2_ht_plan():
    """BASELINE config 2 with the HT block coder at the default step
    (one guard bit, as HT streams carry)."""
    sys.path.insert(0, REPO)
    import chip_smoke
    img = chip_smoke.config2_frames(1)[0]
    params = EncoderParams(numresolutions=6, transform=Transform.DWT_97,
                           cblk_style=0x40)
    siz = encoder.build_siz(img, params)
    cod = encoder.build_cod(img, params)
    tr = tile_rect(0, siz.xsiz, siz.ysiz, siz.xosiz, siz.yosiz, siz.xtsiz,
                   siz.ytsiz, siz.xtosiz, siz.ytosiz)
    return fused_encode.build_plan(siz, cod, default_qcd(siz, cod, 1, 0.0),
                                   tr)


def test_ht_chunk_cap_from_free_bytes():
    """The HT model a config-2 frame: the ICT's float64 transform leads
    (25 bytes a sample with the uploaded one), above the encode's terms
    also under rate control (the resident blocks' probe copy, output
    regions at Mb 30), which a small frame's model shows; `chunk_cap`
    divides half the free bytes, less the encoder's stepsizes, by it."""
    plan = _config2_ht_plan()
    samples = 3 * 2048 * 2048
    fixed = fused_encode.ht_frame_bytes(plan)
    searched = fused_encode.ht_frame_bytes(plan, rate_control=True)
    assert fixed == searched == 25 * samples
    small = _plan(_frames(1, 64, 64)[0], EncoderParams(
        numresolutions=3, transform=Transform.DWT_97, cblk_style=0x40),
        coder="ht")
    assert fused_encode.ht_frame_bytes(small) < \
        fused_encode.ht_frame_bytes(small, rate_control=True)
    assert fused_encode.frame_bytes(plan) == fixed
    steps = fused_encode.HT_STEP_BYTES * plan.nblocks   # once a chunk
    assert fused_encode.chunk_cap(plan, 2 * (9 * fixed + steps)) == 9
    assert fused_encode.chunk_cap(plan, 2 * (9 * fixed + steps) - 2) == 8
    assert fused_encode.chunk_cap(plan, 2 * (9 * searched + steps),
                                  rate_control=True) == 9
    assert fused_encode.chunk_cap(plan, 2 * (9 * searched + steps) - 2,
                                  rate_control=True) == 8
    assert fused_encode.chunk_cap(plan, 0) == 1
    # the default chunk of 32 config-2 HT frames fits an 80 GB card
    assert fused_encode.chunk_cap(plan, 80 * 10 ** 9,
                                  rate_control=True) >= 32
    with pytest.raises(ValueError):
        fused_encode.ht_frame_bytes(_config2_plan())


@pytest.mark.parametrize("rates", [(), (4.0,)], ids=["fixed", "rates"])
def test_ht_streams_do_not_depend_on_the_capped_chunk(monkeypatch, rates):
    """HT on 9/7, at the default step and with a byte target: a free byte
    count that caps the chunk to 1 encodes the frames one a chunk, to the
    streams of one chunk of all of them."""
    imgs = _frames(3, 64, 64)
    params = EncoderParams(numresolutions=3, transform=Transform.DWT_97,
                           cblk_style=0x40, rates=rates, cblk_w_exp=4,
                           cblk_h_exp=4)
    want = encoder.encode_batch(imgs, params, device="cpu", chunk=3)
    sizes = []
    submit = fused_encode.encode_tile_submit
    search = encoder._HTRateSearch
    monkeypatch.setattr(encoder, "free_device_bytes", lambda dev: 1)
    monkeypatch.setattr(fused_encode, "encode_tile_submit",
                        lambda comps, enc: sizes.append(comps[0].shape[0])
                        or submit(comps, enc))
    monkeypatch.setattr(encoder, "_HTRateSearch",
                        lambda ims, *a: sizes.append(len(ims))
                        or search(ims, *a))
    assert encoder.encode_batch(imgs, params, device="cpu") == want
    assert sizes == [1, 1, 1]


# Peak device memory of the cinema 2K encode at 24 fps, 4 frames of
# 2048x1080 12-bit RGB in one chunk with the profile's allocator, above
# what was held before: 8.288 GB on an NVIDIA H100 80GB HBM3 at 700 W
# (`chip_smoke.py` phase 18).
CINEMA_2K_PEAK_4 = 8.288e9


class _Planned(Exception):
    pass


def test_cinema_model_counts_the_rd_tables_of_an_allocator(monkeypatch):
    """A profile's allocator makes `encode_batch` plan the MQ encode with
    R-D tables though the parameters set no target, and the model of that
    12-bit cinema 2K plan, 4 frames a chunk, holds the peak measured on
    the card; without the R-D buffers the model falls below it (the
    chunk cap would overrun)."""
    sys.path.insert(0, REPO)
    import chip_smoke
    from grokimagecompression_tpu_torch.codestream import profiles
    img = chip_smoke.cinema_frames(1)[0]
    prof = profiles.apply_cinema(EncoderParams(), img)
    assert not prof.params.rates and not prof.params.quality_psnr
    plans = []

    def capture(plan, free, rate_control=False):
        plans.append(plan)
        raise _Planned

    monkeypatch.setattr(encoder, "free_device_bytes", lambda dev: 80e9)
    monkeypatch.setattr(fused_encode, "chunk_cap", capture)
    with pytest.raises(_Planned):
        encoder.encode_batch([img], prof.params, device="cpu",
                             rsiz=prof.rsiz,
                             layer_alloc=profiles.profile_allocator(prof))
    (plan,) = plans
    assert plan.coder == "mq" and plan.want_rd
    assert plan.nblocks == 6708
    assert max(b.kmax for (_, _, blocks) in plan.groups
               for b in blocks) == 19
    fixed = mq_scan.EMIT_BLOCK_BYTES
    model = 4 * fused_encode.mq_frame_bytes(plan) + fixed
    assert CINEMA_2K_PEAK_4 <= model <= 1.25 * CINEMA_2K_PEAK_4
    no_rd = dataclasses.replace(plan, want_rd=False)
    assert 4 * fused_encode.mq_frame_bytes(no_rd) + fixed < CINEMA_2K_PEAK_4
