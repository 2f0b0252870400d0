"""Transform stages of the torch port against the JAX reference.

`mct_torch` against `mct_jax`, `dwt_torch` against `dwt_jax` and the numpy
oracle `dwt_np`, and the port's `pipeline._fwd_transform` against the
reference pipeline, on the same numpy inputs. 5/3 and the integer MCT are
exact. The float32 9/7 DWT is held to the numpy oracle exactly (same
float32 operations, no FMA contraction on either side) and to XLA within
4 float32 ulps of each band's largest magnitude, because XLA on the CPU
may contract a*b+c into an FMA; the ICT to XLA's within 4 ulps and, in
the pipeline, to the host encoder's (`mct_np`) exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from grokimagecompression_tpu.core.geometry import Rect, component_rect
from grokimagecompression_tpu.core.params import EncoderParams, Transform
from grokimagecompression_tpu.codestream.encoder import build_cod, build_siz
from grokimagecompression_tpu.models import pipeline as ref_pipeline
from grokimagecompression_tpu.ops import dwt_jax, dwt_np, mct_jax, mct_np
from grokimagecompression_tpu_torch.models import pipeline
from grokimagecompression_tpu_torch.ops import dwt_torch, mct_torch

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


# the rects of tests/test_dwt_jax.py, plus a subsampled tile-component
RECTS = [
    Rect(0, 0, 64, 64),
    Rect(0, 0, 37, 53),
    Rect(3, 5, 70, 61),     # odd origin parity
    Rect(1, 1, 2, 2),       # tiny
    Rect(5, 2, 6, 40),      # 1-wide
    component_rect(Rect(3, 5, 70, 61), 2, 2),   # subsampled, odd origin
]


def _ulp_close(want, got, ulps=4):
    want = np.asarray(want, np.float32)
    got = np.asarray(got, np.float32)
    assert want.shape == got.shape
    if want.size == 0:
        return
    tol = ulps * np.spacing(np.float32(np.abs(want).max()))
    np.testing.assert_array_less(np.abs(want - got), tol + 1e-30)


def test_mct_matches_jax():
    rng = np.random.default_rng(0)
    r, g, b = (rng.integers(-128, 128, (4, 9, 11)).astype(np.int32)
               for _ in range(3))
    tr, tg, tb = (torch.from_numpy(x) for x in (r, g, b))
    for want, got in zip(mct_jax.rct_fwd(r, g, b), mct_torch.rct_fwd(tr, tg, tb)):
        np.testing.assert_array_equal(np.asarray(want), got.numpy())
    y, u, v = mct_torch.rct_fwd(tr, tg, tb)
    for want, got in zip(mct_jax.rct_inv(*(x.numpy() for x in (y, u, v))),
                         mct_torch.rct_inv(y, u, v)):
        np.testing.assert_array_equal(np.asarray(want), got.numpy())
    for want, got in zip(mct_jax.ict_fwd(r, g, b),
                         mct_torch.ict_fwd(tr, tg, tb)):
        _ulp_close(want, got.numpy())
    fy, fu, fv = (x.astype(np.float32) for x in (r, g, b))
    for want, got in zip(mct_jax.ict_inv(fy, fu, fv),
                         mct_torch.ict_inv(*(torch.from_numpy(x)
                                             for x in (fy, fu, fv)))):
        _ulp_close(want, got.numpy())
    for prec, signed in ((8, False), (12, True), (16, False)):
        a = rng.integers(-70000, 70000, (5, 6)).astype(np.int32)
        ta = torch.from_numpy(a)
        np.testing.assert_array_equal(
            np.asarray(mct_jax.dc_shift_fwd(a, prec, signed)),
            mct_torch.dc_shift_fwd(ta, prec, signed).numpy())
        np.testing.assert_array_equal(
            np.asarray(mct_jax.dc_shift_inv(a, prec, signed)),
            mct_torch.dc_shift_inv(ta, prec, signed).numpy())


@pytest.mark.parametrize("rect", RECTS)
@pytest.mark.parametrize("numres", [2, 6])
def test_dwt53_matches_jax_and_numpy(rect, numres):
    rng = np.random.default_rng(rect.x0 * 100 + rect.w + numres)
    a = rng.integers(-(1 << 10), 1 << 10, (2, rect.h, rect.w)).astype(
        np.int32)
    got = dwt_torch.fwd_dwt_2d(torch.from_numpy(a), rect, numres, True)
    want = jax.jit(lambda x: dwt_jax.fwd_dwt_2d(x, rect, numres, True))(a)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(np.asarray(want[k]), got[k].numpy(),
                                      err_msg=str(k))
        ref = dwt_np.fwd_dwt_2d(a[1], rect, numres, reversible=True)[k]
        np.testing.assert_array_equal(ref, got[k][1].numpy(), err_msg=str(k))
    rec = dwt_torch.inv_dwt_2d(got, rect, numres, True)
    np.testing.assert_array_equal(a, rec.numpy())
    rec_jax = jax.jit(lambda b: dwt_jax.inv_dwt_2d(b, rect, numres, True))(
        {k: v.numpy() for k, v in got.items()})
    np.testing.assert_array_equal(np.asarray(rec_jax), rec.numpy())


@pytest.mark.parametrize("rect", RECTS)
def test_dwt97_matches_numpy(rect):
    numres = 3
    rng = np.random.default_rng(rect.y0 * 100 + rect.h)
    a = rng.integers(-128, 128, (rect.h, rect.w)).astype(np.float32)
    got = dwt_torch.fwd_dwt_2d(torch.from_numpy(a), rect, numres, False)
    ref = dwt_np.fwd_dwt_2d(a, rect, numres, reversible=False)
    assert set(got) == set(ref)
    for k in ref:
        assert got[k].dtype == torch.float32
        np.testing.assert_array_equal(ref[k], got[k].numpy(), err_msg=str(k))
    rec = dwt_torch.inv_dwt_2d(got, rect, numres, False)
    rec_np = dwt_np.inv_dwt_2d(ref, rect, numres, reversible=False)
    np.testing.assert_array_equal(rec_np, rec.numpy())


# op by op, as XLA runs it without jit: a jitted program fuses more
# multiply-adds into FMAs
@pytest.mark.parametrize("rect", RECTS[2:])
def test_dwt97_within_ulps_of_jax(rect):
    numres = 3
    rng = np.random.default_rng(rect.y0 * 100 + rect.h)
    a = rng.integers(-128, 128, (rect.h, rect.w)).astype(np.float32)
    got = dwt_torch.fwd_dwt_2d(torch.from_numpy(a), rect, numres, False)
    want = dwt_jax.fwd_dwt_2d(jnp.asarray(a), rect, numres, False)
    for k in want:
        _ulp_close(want[k], got[k].numpy())
    rec = dwt_torch.inv_dwt_2d(got, rect, numres, False)
    rec_jax = dwt_jax.inv_dwt_2d({k: jnp.asarray(v.numpy())
                                  for k, v in got.items()},
                                 rect, numres, False)
    _ulp_close(rec_jax, rec.numpy())


@pytest.mark.parametrize("transform", [Transform.DWT_53, Transform.DWT_97])
def test_fwd_transform_matches_reference_pipeline(transform):
    img = natural_image(23, 18, ncomp=3, seed=5)
    params = EncoderParams(numresolutions=3, transform=transform,
                           tile_offset=(3, 1), image_offset=(3, 1))
    img.x0, img.y0 = 3, 1
    siz = build_siz(img, params)
    cod = build_cod(img, params)
    tile = Rect(3, 1, 23, 18)
    ref_cfg = ref_pipeline.config_for_tile(siz, cod, tile)
    cfg = pipeline.config_for_tile(siz, cod, tile)
    assert dataclasses_fields(cfg) == dataclasses_fields(ref_cfg)
    comps = [np.stack([c.data[1:, 3:], c.data[1:, 3:] ^ 5])
             for c in img.components]
    if transform == Transform.DWT_53:
        want = jax.jit(lambda *c: ref_pipeline._fwd_transform(ref_cfg, c))(
            *comps)
    else:
        # the port's ICT rounds as the host encoder's matrix product
        # (`mct_np.ict_fwd`), the reference of its streams, not as the
        # reference pipeline's op-by-op sum: exact against the former;
        # the 9/7 bands against the reference's DWT of the same ICT
        # output, op by op (see test_dwt97_within_ulps_of_jax)
        shifted = [mct_np.dc_shift_fwd(c.astype(np.int32), 8, False)
                   for c in comps]
        ycc = mct_np.ict_fwd(*shifted)
        for a, b in zip(ycc, mct_torch.ict_fwd(
                *(torch.from_numpy(x) for x in shifted))):
            np.testing.assert_array_equal(a, b.numpy())
        want = [dwt_jax.fwd_dwt_2d(jnp.asarray(y), r, 3, False)
                for y, r in zip(ycc, ref_cfg.tc_rects)]
    got = pipeline._fwd_transform(cfg, [torch.from_numpy(c) for c in comps])
    for wc, gc in zip(want, got):
        assert set(wc) == set(gc) == set(pipeline._band_keys(3))
        for k in wc:
            if transform == Transform.DWT_53:
                np.testing.assert_array_equal(np.asarray(wc[k]),
                                              gc[k].numpy())
            else:
                _ulp_close(wc[k], gc[k].numpy())
    back = pipeline._inv_transform(cfg, got)
    if transform == Transform.DWT_53:
        for c, b in zip(comps, back):
            np.testing.assert_array_equal(c, b.numpy())
    else:
        want_back = ref_pipeline._inv_transform(
            ref_cfg, [{k: jnp.asarray(v.numpy()) for k, v in gc.items()}
                      for gc in got])
        for wb, b in zip(want_back, back):
            assert np.abs(np.asarray(wb) - b.numpy()).max() <= 1


def dataclasses_fields(cfg):
    # the port's Rect is its own type: compare the coordinates
    return (tuple((r.x0, r.y0, r.x1, r.y1) for r in cfg.tc_rects),
            cfg.precs, cfg.signeds, cfg.numresolutions, cfg.reversible,
            cfg.mct)
