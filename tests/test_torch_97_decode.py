"""The port's irreversible (9/7) decode with layer limits, on the CPU.

`grokimagecompression_tpu_torch.codestream.decoder.decode_batch(...,
device="cpu")` on 9/7 streams of the reference host encoder must equal
the reference host decoder (`decoder.decode(cs, device=False)`) pixel for
pixel: RGB with ICT and three quality layers at rates (96, 48, 24),
decoded at layers 0 (all), 1, 2 and 5 (more than the stream has); rates
(24, 48, 96); PSNR targets; a gray stream without targets; and an HT
(`cblk_style=0x40`) stream. The three layer limits give three different
images, so the limit acts. The host decoder runs with its numpy inverse
DWT: both `dwt_host._get_native` (patched to None) and its packed native
inverse, which `codestream/tile.py` calls directly unless the
environment sets GROK_TPU_DWT=python; the native 9/7 DWT rounds
differently from `dwt_np`, which the port's DWT equals bit for bit.

The reference's fused device decode on the CPU
(`fused_decode.decode_tile_device`, its float32 mid-point and stepsize
order and its XLA inverse transform) is a second oracle, held within a
max |diff| of 1: the reference's own comment
(`grokimagecompression_tpu/codestream/decoder.py:388-390`) allows its
fused 9/7 route to differ from the host by one on knife-edge samples.
On the two streams here it differs from the port in 0 (MQ) and 0 (HT)
samples.

Frames are small (the plain MQ and HT decoders take one torch step per
decision or quad step of the busiest lanes).
"""

import numpy as np
import pytest
import torch

from grokimagecompression_tpu.codestream import decoder as ref_decoder
from grokimagecompression_tpu.codestream import encoder as ref_encoder
from grokimagecompression_tpu.core.params import (DecoderParams as
                                                  RefDecoderParams)
from grokimagecompression_tpu.core.params import EncoderParams, Transform
from grokimagecompression_tpu.ops import dwt_host
from grokimagecompression_tpu_torch.codestream import decoder
from grokimagecompression_tpu_torch.core.params import DecoderParams

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
SMALL = dict(cblk_w_exp=4, cblk_h_exp=4)


@pytest.fixture
def numpy_dwt(monkeypatch):
    """The reference host codec with its numpy DWT only."""
    monkeypatch.setattr(dwt_host, "_get_native", lambda: None)
    monkeypatch.setenv("GROK_TPU_DWT", "python")


def _p97(**kw):
    return EncoderParams(transform=Transform.DWT_97, **kw)


def _check(streams, layers=0):
    """decode_batch on the CPU equals the reference host decode at the
    layer limit; returns the port's images."""
    got = decoder.decode_batch(streams, DecoderParams(layers=layers),
                               device="cpu")
    assert len(got) == len(streams)
    for cs, out in zip(streams, got):
        ref = ref_decoder.decode(cs, RefDecoderParams(layers=layers),
                                 device=False)
        assert (out.x0, out.y0, out.xsiz, out.ysiz) == \
            (ref.x0, ref.y0, ref.xsiz, ref.ysiz)
        for c, comp in enumerate(out.components):
            assert comp.data.dtype == np.int32
            np.testing.assert_array_equal(comp.data, ref.components[c].data)
    return got


def _mse(a, b):
    return float(np.mean([(x.data.astype(np.float64) - y.data) ** 2
                          for x, y in zip(a.components, b.components)]))


def test_layer_limits_equal_host_decode(numpy_dwt):
    img = natural_image(64, 64, ncomp=3, seed=1)
    cs = ref_encoder.encode(img, _p97(numresolutions=4, numlayers=3,
                                      rates=(96.0, 48.0, 24.0), **SMALL),
                            device=False)
    outs = {layers: _check([cs], layers)[0] for layers in (1, 2, 0, 5)}
    mses = [_mse(outs[k], img) for k in (1, 2, 0)]
    assert len(set(mses)) == 3 and mses[0] > mses[2]
    for c, comp in enumerate(outs[5].components):
        np.testing.assert_array_equal(comp.data, outs[0].components[c].data)


CASES = [
    ("rates_24_48_96", [natural_image(64, 48, ncomp=3, seed=2)],
     _p97(numresolutions=4, numlayers=3, rates=(24.0, 48.0, 96.0),
          **SMALL)),
    ("psnr_targets", [natural_image(48, 48, seed=3)],
     _p97(numresolutions=3, numlayers=2, quality_psnr=(30.0, 38.0),
          **SMALL)),
    ("gray_two_frames", [natural_image(40, 36, seed=s) for s in (4, 5)],
     _p97(numresolutions=3)),
    ("ht", [natural_image(64, 48, ncomp=3, seed=6)],
     _p97(numresolutions=4, cblk_style=HT)),
]


@pytest.mark.parametrize("name,imgs,params", CASES,
                         ids=[c[0] for c in CASES])
def test_equals_host_decode(numpy_dwt, name, imgs, params):
    streams = [ref_encoder.encode(im, params, device=False) for im in imgs]
    _check(streams)


@pytest.mark.parametrize("style", [0, HT], ids=["mq", "ht"])
def test_within_one_of_reference_fused_decode(numpy_dwt, style):
    """The reference's fused device decode of the tile on the CPU, and
    the port's, differ by at most 1 and in no sample here."""
    from grokimagecompression_tpu.codestream import tile as ref_tile
    from grokimagecompression_tpu.models import fused_decode as ref_fd

    img = natural_image(16, 12, seed=7)
    cs = ref_encoder.encode(img, _p97(numresolutions=2, cblk_style=style,
                                      cblk_w_exp=3, cblk_h_exp=3),
                            device=False)
    hdr = ref_decoder.read_header(cs)
    body = b"".join(tp.body for tp in ref_decoder.iter_tile_parts(
        cs, hdr.main_header_end))
    rect = ref_decoder.tile_rect(0, *(getattr(hdr.siz, k) for k in (
        "xsiz", "ysiz", "xosiz", "yosiz", "xtsiz", "ytsiz", "xtosiz",
        "ytosiz")))
    _, jobs, slots, plans, cods = ref_tile.decode_tile(
        body, hdr.siz, hdr.cod, hdr.qcd, rect, _return_jobs=True)
    steps = {(c, k): plans[c].bands[k].stepsize
             for c in range(len(plans)) for k in plans[c].bands}
    want = ref_fd.decode_tile_device(jobs, slots, plans, cods, hdr.siz,
                                     hdr.cod, rect, steps)
    assert want is not None
    (got,) = _check([cs])
    diff = np.stack([np.abs(g.data.astype(np.int64) - w)
                     for g, w in zip(got.components, want)])
    assert int(diff.max()) <= 1
    assert int((diff != 0).sum()) == 0
