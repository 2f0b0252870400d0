"""The port's HT block coder on the irreversible 9/7 transform, at a fixed
base step and with a byte target (`rates=(r,)`, the quantizer-step
search of HT rate control), against the reference, on the CPU.

On the same numpy frames and arguments, `encode_batch(device="cpu")`
must give the reference host encoder's streams
(`encoder.encode(device=False)`) byte for byte, run with its numpy DWT
(`dwt_host._get_native` patched to None: the native 9/7 DWT rounds
differently from the numpy oracle, which the port's DWT equals). Under
rate control the port's probe totals (`encoder._ht_rc_segment_bytes`)
must equal the reference's `_ht_rc_segment_bytes` at every step its
search visits, and each stream must stay within its target. The
reference's native HT coder is undefined at Mb 31 (ROADMAP Queue C 4);
the searches here reach Mb 12 (ratios 8, 24) and 13 (ratio 96), at base
step 1.0 (asserted). The plain HT encoder runs every probe here, which
keeps these cases small.

Also: the streams do not depend on the chunk; the port's HT 9/7 plan
equals the reference's (`convert.plan_from_reference`); the reference's
ValueErrors; the streams decode through `decode_batch(device="cpu")` to
the host decoder's pixels; and the port's float64 quantization differs
from the reference fused program's float32 one (ROADMAP Queue C 1) only
where |v| / step lies within float32 rounding of an integer.
"""

import dataclasses
import functools
import os
import sys

import numpy as np
import pytest
import torch

from grokimagecompression_tpu.codestream import decoder as ref_decoder
from grokimagecompression_tpu.codestream import encoder as ref_encoder
from grokimagecompression_tpu.codestream import tile as ref_tile
from grokimagecompression_tpu.core.geometry import tile_rect as ref_tile_rect
from grokimagecompression_tpu.core.params import EncoderParams, Transform
from grokimagecompression_tpu.models import fused_encode as ref_fused
from grokimagecompression_tpu.ops import dwt_host
from grokimagecompression_tpu_torch import convert
from grokimagecompression_tpu_torch.codestream import decoder, encoder
from grokimagecompression_tpu_torch.codestream.tile import default_qcd
from grokimagecompression_tpu_torch.core.geometry import tile_rect
from grokimagecompression_tpu_torch.models import fused_encode
from grokimagecompression_tpu_torch.ops import ht_tables, quant

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


@pytest.fixture(autouse=True)
def numpy_dwt(monkeypatch):
    """The reference host codec with its numpy DWT only."""
    monkeypatch.setattr(dwt_host, "_get_native", lambda: None)
    monkeypatch.setenv("GROK_TPU_DWT", "python")


HT = 0x40
BLOCKS = dict(cblk_w_exp=5, cblk_h_exp=5)


def _p(**kw):
    return EncoderParams(transform=Transform.DWT_97, cblk_style=HT, **kw)


def _port(imgs, params, **kw):
    return encoder.encode_batch(
        [convert.image_from_reference(im) for im in imgs],
        convert.params_from_reference(params), device="cpu", **kw)


def _host(imgs, params):
    return [ref_encoder.encode(im, params, device=False) for im in imgs]


REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _config2_like(size, n=2):
    """`n` frames made as BASELINE config 2's (`chip_smoke.config2_frames`:
    a wave plus uniform texture, RGB) at `size` x `size`, as reference
    images."""
    sys.path.insert(0, REPO)
    import chip_smoke
    from grokimagecompression_tpu.core.image import Component, Image
    return [Image(xsiz=im.xsiz, ysiz=im.ysiz, components=[Component(
        data=c.data, prec=c.prec, signed=c.signed, dx=c.dx, dy=c.dy)
        for c in im.components])
        for im in chip_smoke.config2_frames(n, size=size)]


# Per ratio: the frames and their coding. At ratio 96 smaller frames
# cannot reach their target (the reference's search runs the step up to
# 4096, where its QCD exponents go negative), and 16x16 blocks spend too
# much on packet headers; sides that halve evenly keep the blocks in one
# or two quad-shape groups, which keeps the plain encoder's probes short.
RATE_CASES = {8.0: (128, dict(numresolutions=4, cblk_w_exp=4,
                              cblk_h_exp=4)),
              24.0: (128, dict(numresolutions=4, cblk_w_exp=4,
                               cblk_h_exp=4)),
              96.0: (256, dict(numresolutions=5, **BLOCKS))}


@functools.lru_cache(maxsize=None)
def _rate_run(ratio):
    """The frames, the port's and the reference's streams of them at
    `ratio`, and each side's probe totals by frame: {step: total}."""
    size, coding = RATE_CASES[ratio]
    frames = _config2_like(size)
    params = _p(rates=(ratio,), **coding)
    ref_seen = [{} for _ in frames]
    port_seen = [{} for _ in frames]
    frame_of = {}
    ref_probe = ref_encoder._ht_rc_segment_bytes
    port_probe = encoder._ht_rc_segment_bytes

    def ref_rec(image, params, rsiz, coeff_by_tile, step):
        total = ref_probe(image, params, rsiz, coeff_by_tile, step)
        ref_seen[frame_of[id(image)]][step] = total
        return total

    def port_rec(search, frames, steps):
        totals = port_probe(search, frames, steps)
        for f, s, n in zip(frames, steps, totals):
            assert s not in port_seen[f]
            port_seen[f][s] = n
        return totals

    mp = pytest.MonkeyPatch()
    mp.setattr(dwt_host, "_get_native", lambda: None)
    mp.setattr(ref_encoder, "_ht_rc_segment_bytes", ref_rec)
    mp.setattr(encoder, "_ht_rc_segment_bytes", port_rec)
    try:
        want = []
        for f, im in enumerate(frames):
            frame_of[id(im)] = f
            want.append(ref_encoder.encode(im, params, device=False))
        got = _port(frames, params)
    finally:
        mp.undo()
    return frames, params, want, got, ref_seen, port_seen


def _largest_mb(frames, params, frames_seen):
    """The largest band Mb (expn + 1 guard bit - 1) the QCDs of the
    visited steps give."""
    im = convert.image_from_reference(frames[0])
    p = convert.params_from_reference(params)
    siz, cod = encoder.build_siz(im, p), encoder.build_cod(im, p)
    steps = {s for seen in frames_seen for s in seen}
    return max(e for s in steps
               for (e, _) in default_qcd(siz, cod, 1, s).steps)


FIXED_CASES = [
    ("rgb_two_frames", [natural_image(96, 96, ncomp=3, seed=s)
                        for s in (3, 4)], _p(numresolutions=4, **BLOCKS)),
    ("gray_odd_origin", [natural_image(75, 69, seed=5)],
     _p(numresolutions=3, image_offset=(3, 1), **BLOCKS)),
    ("rgb_base_step", [natural_image(64, 64, ncomp=3, seed=6)],
     _p(numresolutions=4, base_step=2.5, **BLOCKS)),
]


@functools.lru_cache(maxsize=None)
def _fixed_port(name):
    """The port's streams of the FIXED_CASES entry `name`, made once."""
    _, imgs, params = next(c for c in FIXED_CASES if c[0] == name)
    return _port(imgs, params)


@pytest.mark.parametrize("name,imgs,params", FIXED_CASES)
def test_fixed_step_matches_host(name, imgs, params):
    assert _fixed_port(name) == _host(imgs, params)


@pytest.mark.parametrize("ratio", sorted(RATE_CASES))
def test_rate_controlled_matches_host(ratio):
    frames, _, want, got, _, _ = _rate_run(ratio)
    assert got == want
    for im, cs in zip(frames, got):
        image_bytes = sum(c.data.size * c.prec for c in im.components) // 8
        assert len(cs) <= max(256, int(image_bytes / ratio))


@pytest.mark.parametrize("ratio,largest_mb", [(8.0, 12), (24.0, 12),
                                              (96.0, 13)])
def test_probe_totals_equal_reference(ratio, largest_mb):
    """At every step the reference's search visits, the port's probe gives
    its total; the two searches visit the same steps. The largest Mb the
    searches reach, at base step 1.0, is below the native coder's
    undefined Mb 31."""
    frames, params, _, _, ref_seen, port_seen = _rate_run(ratio)
    assert port_seen == ref_seen
    assert all(len(seen) >= 5 for seen in port_seen)
    assert _largest_mb(frames, dataclasses.replace(params, rates=()),
                       port_seen) == largest_mb


def test_streams_do_not_depend_on_the_chunk():
    imgs = _config2_like(64, 3)
    params = _p(rates=(8.0,), numresolutions=3, cblk_w_exp=4,
                cblk_h_exp=4)
    one = _port(imgs, params, chunk=1)
    assert one == _port(imgs, params, chunk=3)
    assert one == _host(imgs, params)


@pytest.mark.parametrize("size,ncomp,numres,base_step", [
    (2048, 3, 6, 0.0),          # BASELINE config 2
    (75, 3, 4, 2.5),
    (33, 1, 3, 0.3),
])
def test_plan_equals_reference(size, ncomp, numres, base_step):
    img = natural_image(size if size < 2048 else 64, size - 3 if size < 2048
                        else 64, ncomp=ncomp, seed=1)
    if size == 2048:
        img = dataclasses.replace(img, xsiz=2048, ysiz=2048)
    params = _p(numresolutions=numres, base_step=base_step)
    rsiz = ref_encoder.build_siz(img, params)
    rcod = ref_encoder.build_cod(img, params)
    rtr = ref_tile_rect(0, rsiz.xsiz, rsiz.ysiz, rsiz.xosiz, rsiz.yosiz,
                        rsiz.xtsiz, rsiz.ytsiz, rsiz.xtosiz, rsiz.ytosiz)
    ref_plan = ref_fused.build_plan(
        rsiz, rcod, ref_tile.default_qcd(rsiz, rcod, 1, base_step), rtr,
        coder="ht")
    pimg = convert.image_from_reference(img)
    pparams = convert.params_from_reference(params)
    siz = encoder.build_siz(pimg, pparams)
    cod = encoder.build_cod(pimg, pparams)
    tr = tile_rect(0, siz.xsiz, siz.ysiz, siz.xosiz, siz.yosiz,
                   siz.xtsiz, siz.ytsiz, siz.xtosiz, siz.ytosiz)
    plan = fused_encode.build_plan(siz, cod,
                                   default_qcd(siz, cod, 1, base_step), tr)
    assert plan is not None and not plan.cfg.reversible
    assert convert.plan_from_reference(ref_plan) == plan
    if size == 2048:
        # config 2: one quad-shape group of 3072 64x64 blocks a frame
        assert [(qh, qw, len(b)) for (qh, qw, b) in plan.groups] == \
            [(32, 32, 3072)]


@pytest.mark.parametrize("kw,match", [
    (dict(transform=Transform.DWT_53, rates=(24.0,)), "9/7"),
    (dict(rates=(24.0, 48.0)), "single layer"),
    (dict(rates=(24.0,), numlayers=2), "single layer"),
    (dict(rates=(0.0,)), "positive ratio"),
    (dict(rates=(-3.0,)), "positive ratio"),
    (dict(quality_psnr=(30.0,)), "PSNR"),
])
def test_reference_value_errors(kw, match):
    img = natural_image(32, 32, seed=2)
    params = dataclasses.replace(_p(numresolutions=3), **kw)
    with pytest.raises(ValueError, match=match):
        ref_encoder.encode(img, params, device=False)
    with pytest.raises(ValueError, match=match):
        _port([img, img], params)


def test_streams_decode_to_host_pixels():
    from grokimagecompression_tpu.core.params import (DecoderParams as
                                                      RefDecoderParams)
    from grokimagecompression_tpu_torch.core.params import DecoderParams
    fixed = _fixed_port("rgb_two_frames")
    # the fixed-step streams in one batch; each rate-controlled stream
    # alone, as each has its own base step, hence its own QCD
    batches = [fixed] + [[cs] for cs in _rate_run(24.0)[3]]
    for streams in batches:
        got = decoder.decode_batch(streams, DecoderParams(), device="cpu")
        for cs, out in zip(streams, got):
            ref = ref_decoder.decode(cs, RefDecoderParams(), device=False)
            for c, comp in enumerate(out.components):
                np.testing.assert_array_equal(comp.data,
                                              ref.components[c].data)


def test_quantization_is_the_hosts_not_float32():
    """`FusedHTEncoder.group_inputs`' signed coefficients equal the host
    rule (numpy: floor(|v| / step) in float64, sign of v) on a frame's
    gathered 9/7 blocks, and on coefficients planted on and next to step
    multiples; the reference fused program's float32 product
    floor(|v| * float32(1 / step)) (`models/fused_encode.py` there) differs
    from them only where |v| / step lies within float32 rounding of an
    integer, and does on some planted ones."""
    img = convert.image_from_reference(natural_image(64, 64, ncomp=3,
                                                     seed=11))
    params = convert.params_from_reference(_p(numresolutions=3, **BLOCKS))
    siz, cod = encoder.build_siz(img, params), encoder.build_cod(img,
                                                                 params)
    tr = tile_rect(0, siz.xsiz, siz.ysiz, siz.xosiz, siz.yosiz,
                   siz.xtsiz, siz.ytsiz, siz.xtosiz, siz.ytosiz)
    plan = fused_encode.build_plan(siz, cod, default_qcd(siz, cod, 1, 0.0),
                                   tr)
    enc = fused_encode.FusedHTEncoder(
        plan, ht_tables.device_tables(torch.device("cpu")))
    frames = [torch.from_numpy(c.data[None].astype(np.uint8))
              for c in img.components]
    blocks = enc.gather(enc.transform(*frames))
    rng = np.random.default_rng(4)
    planted = 0
    for g, ((qh, qw, specs), (coeffs, _)) in enumerate(
            zip(plan.groups, enc.group_inputs(*frames))):
        v = blocks[g].reshape(-1, 2 * qh, 2 * qw).numpy()
        step = np.asarray([b.step for b in specs])[:, None, None]
        _compare(v, step, coeffs.numpy())
        # plant k * step, rounded to float32, and its float32 neighbours
        k = rng.integers(1, 2000, v.shape)
        on = (k * step).astype(np.float32)
        pick = rng.integers(0, 3, v.shape)
        on = np.where(pick == 0, np.nextafter(on, np.float32(0)),
                      np.where(pick == 1, on, np.nextafter(on,
                                                           np.float32(1e9))))
        on = np.where(rng.random(v.shape) < 0.5, -on, on).astype(np.float32)
        got = quant.signed_deadzone(torch.from_numpy(on),
                                    torch.from_numpy(step)).numpy()
        planted += _compare(on, step, got)
    assert planted > 0


def _compare(v, step, got):
    """Check `got` against the host rule and the float32 product on `v`;
    returns the samples where the float32 product differs."""
    exact = np.abs(v).astype(np.float64) / step
    host = np.floor(exact).astype(np.int64)
    np.testing.assert_array_equal(got, np.where(v < 0, -host, host))
    inv = (1.0 / step).astype(np.float32)
    f32 = np.floor(np.abs(v) * inv).astype(np.int64)
    diff = f32 != host
    near = np.abs(exact - np.round(exact)) <= 2.0 ** -21 * exact
    assert not (diff & ~near).any()
    return int(diff.sum())
