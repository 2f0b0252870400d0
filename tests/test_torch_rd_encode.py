"""The port's rate-controlled MQ encode (BASELINE config-2 path) against the
JAX reference and the host encoder, on the CPU.

Layer by layer, on the same numpy inputs:
- (a) `mq_torch.build_slot_stream(want_dist=True)` against
  `mq_jax.build_slot_stream(want_dist=True)`: slots exact, the pass
  distortions within float32 relative 1e-6 (the reference sums in
  float32, the port in float64); after `batch_pass_tables`, which undoes
  the 4^-plane scaling, the port's cumulative distortions equal the host
  T1's pass distortions (the native coder's pass tables through
  `t1/backend.encode_cblk_batch_bands(..., needs_pass_rates=True)`)
  exactly: the host's per-sample terms are multiples of 1/4, so float64
  sums of them are exact in any order;
- (b) the pass-end byte-outs `cumbo` of the plain MQ coder
  (`mq_torch.mq_scan_plain`) against `mq_jax.pass_cum_byteouts` over the
  reference's compacting-scan oracle `_mq_scans_compact_ref`, exactly;
- (c) the port's block coder on a list of quantized blocks
  (`mq_scan.encode_blocks(want_rd=True)`) against
  `mq_jax.mq_encode_blocks(want_rd=True)` (segments and rates exact,
  distortions within float32 relative 1e-6) and against the host T1
  (segments, rates and distortions exact);
- (d) the slice: `encode_batch(device="cpu")` on two 95 x 81 RGB frames
  with ICT,
  9/7, 4 resolutions and three layers at rates (24, 48, 96) must give the
  reference host encoder's streams byte for byte, run with its numpy DWT
  (`dwt_host._get_native` patched to None in the test: the native 9/7 DWT
  rounds differently from the numpy oracle the port is exact with); also
  9/7 without rates, 5/3 with rates and 9/7 with PSNR targets, on 47 x 41
  frames (the plain MQ coder takes one torch step per decision), and flat
  frames, whose high-pass shape groups quantize to zero; and the 9/7 R-D
  plan equals the reference's.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax import lax

from grokimagecompression_tpu.codestream import encoder as ref_encoder
from grokimagecompression_tpu.codestream import tile as ref_tile
from grokimagecompression_tpu.core.geometry import tile_rect as ref_tile_rect
from grokimagecompression_tpu.core.params import EncoderParams, Transform
from grokimagecompression_tpu.models import fused_encode as ref_fused
from grokimagecompression_tpu.ops import dwt_host, mq_jax
from grokimagecompression_tpu.t1 import backend as t1_backend
from grokimagecompression_tpu_torch import convert
from grokimagecompression_tpu_torch.codestream import encoder
from grokimagecompression_tpu_torch.codestream.tile import default_qcd
from grokimagecompression_tpu_torch.core.geometry import tile_rect
from grokimagecompression_tpu_torch.models import fused_encode
from grokimagecompression_tpu_torch.ops import mq_scan, mq_torch

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


H, W = 13, 16          # a block height that is not a multiple of 4


def _blocks(seed):
    """12 quantized blocks: each orientation with an all-zero block, a
    sparse one and a dense one, bit-plane counts from 0 to 9."""
    rng = np.random.default_rng(seed)
    out = []
    for orient in range(4):
        for dens, mb in ((0.0, 0), (0.15, 6), (0.9, 9)):
            m = rng.integers(0, 1 << mb, (H, W)) if mb else np.zeros((H, W))
            m = np.where(rng.random((H, W)) < dens, m, 0).astype(np.uint32)
            out.append((m, rng.integers(0, 2, (H, W)).astype(np.int32),
                        orient))
    return out


@pytest.fixture(scope="module")
def blocks():
    return _blocks(seed=5)


def _rel_close(got, want, rtol=1e-6):
    """float32 relative 1e-6 of the largest magnitude."""
    want = np.asarray(want, np.float64)
    tol = rtol * max(float(np.abs(want).max()), 1.0)
    np.testing.assert_allclose(np.asarray(got, np.float64), want, rtol=0,
                               atol=tol)


def _port_slots(blocks, npl):
    mag = torch.from_numpy(np.stack([b[0] for b in blocks]).astype(np.int32))
    neg = torch.from_numpy(np.stack([b[1] for b in blocks]))
    orient = torch.tensor([b[2] for b in blocks])
    nbps = mq_torch.bit_planes(mag)
    return nbps, mq_torch.build_slot_stream(mag, neg, orient, nbps, npl,
                                            want_dist=True)


def _host_t1(blocks):
    """The host encoder's T1 on the blocks: (data, numbps, numpasses,
    passes) per block, each block its own signed int32 band."""
    bands = [np.where(b[1] > 0, -b[0].astype(np.int64),
                      b[0].astype(np.int64)).astype(np.int32)
             for b in blocks]
    descs = [(i, 0, 0, W, H) for i in range(len(blocks))]
    return t1_backend.encode_cblk_batch_bands(
        bands, descs, [b[2] for b in blocks], [16] * len(blocks), 0,
        needs_pass_rates=True)


def test_slot_stream_distortions_match_jax_and_host(blocks):
    nbs = [int(b[0].max()).bit_length() for b in blocks]
    npl = max(nbs) + 1                    # the top plane is dead
    nbps, (slots, dists) = _port_slots(blocks, npl)
    B = len(blocks)
    hp = -(-H // 4) * 4
    mag_t = np.zeros((hp, W, B), np.uint32)
    neg_t = np.zeros((hp, W, B), np.int32)
    for k, (m, n, _) in enumerate(blocks):
        mag_t[:H, :, k] = m
        neg_t[:H, :, k] = n
    geo = mq_jax._geometry(H, W)
    ref = jax.jit(lambda m, n, o, nb: mq_jax.build_slot_stream(
        jnp, lax, m, n, o[None, None, :], nb[None, None, :], npl, geo,
        want_dist=True))
    want_slots, want_dists = ref(mag_t, neg_t,
                                 np.asarray([b[2] for b in blocks], np.int32),
                                 np.asarray(nbs, np.int32))
    np.testing.assert_array_equal(slots.numpy(), np.asarray(want_slots))
    assert dists.dtype == torch.float64 and dists.shape == (npl, 3, B)
    _rel_close(dists.numpy(), np.asarray(want_dists))
    # exact against the host coder's cumulative pass distortions
    rates, dcum = mq_torch.batch_pass_tables(
        np.zeros(B, np.int64), nbps.numpy(), npl,
        np.zeros((3 * npl, B), np.int64), dists.reshape(3 * npl, B).numpy())
    for k, (_, nb, npasses, passes) in enumerate(_host_t1(blocks)):
        assert nb == nbs[k] and npasses == max(3 * nb - 2, 0)
        got = mq_torch.passes_from_tables(nb, npl, rates[:, k], dcum[:, k])
        assert [p.distortion for p in got] == \
            [p.distortion for p in passes], f"block {k}"


def test_plain_coder_pass_byteouts_match_reference(blocks):
    npl = max(int(b[0].max()).bit_length() for b in blocks)
    _, (slots, _) = _port_slots(blocks, npl)
    spans = mq_torch.pass_spans_padded(H, W)
    data, lens, state, cumbo = mq_torch.mq_scan_plain(slots, spans)
    assert cumbo.dtype == torch.int32 and cumbo.shape == (3 * npl,
                                                          len(blocks))
    T, B = slots.shape
    padded = np.zeros((T, 128), np.int8)
    padded[:, :B] = slots.numpy()
    _, _, nboc, _ = mq_jax._mq_scans_compact_ref(jnp, lax,
                                                 jnp.asarray(padded))
    want = mq_jax.pass_cum_byteouts(jnp, nboc, H, W, npl)
    np.testing.assert_array_equal(
        cumbo.numpy(), np.asarray(want).reshape(3 * npl, 128)[:, :B])
    # the scan's other outputs are those of the coder without the ends
    for a, b in zip((data, lens, state), mq_torch.mq_scan_plain(slots)):
        assert torch.equal(a, b)


def test_block_coder_matches_reference_and_host(blocks):
    got = mq_scan.encode_blocks(blocks, want_rd=True, device="cpu")
    want = mq_jax.mq_encode_blocks(blocks, want_rd=True)
    host = _host_t1(blocks)
    for k, (g, w, h) in enumerate(zip(got, want, host)):
        assert g[:3] == w[:3] == h[:3], f"block {k}"
        assert [p.rate for p in g[3]] == [p.rate for p in w[3]] \
            == [p.rate for p in h[3]], f"block {k}"
        assert [p.terminated for p in g[3]] == [p.terminated for p in h[3]]
        assert [p.distortion for p in g[3]] == \
            [p.distortion for p in h[3]], f"block {k}"
        if g[3]:
            _rel_close([p.distortion for p in g[3]],
                       [p.distortion for p in w[3]])
    assert [g[:3] for g in mq_scan.encode_blocks(blocks, device="cpu")] == \
        [g[:3] for g in got]


def _rgb(n, w, h, seed):
    return [natural_image(w, h, ncomp=3, seed=seed + i) for i in range(n)]


def test_rd_plan_equals_reference():
    img = _rgb(1, 95, 81, seed=3)[0]
    params = EncoderParams(numresolutions=4, transform=Transform.DWT_97,
                           numlayers=3, rates=(24.0, 48.0, 96.0),
                           cblk_style=0)
    rsiz = ref_encoder.build_siz(img, params)
    rcod = ref_encoder.build_cod(img, params)
    rqcd = ref_tile.default_qcd(rsiz, rcod, 2, params.base_step)
    rtr = ref_tile_rect(0, rsiz.xsiz, rsiz.ysiz, rsiz.xosiz, rsiz.yosiz,
                        rsiz.xtsiz, rsiz.ytsiz, rsiz.xtosiz, rsiz.ytosiz)
    ref_plan = ref_fused.build_plan(rsiz, rcod, rqcd, rtr, coder="mq",
                                    want_rd=True)
    pparams = convert.params_from_reference(params)
    assert (pparams.rates, pparams.numlayers) == ((24.0, 48.0, 96.0), 3)
    pimg = convert.image_from_reference(img)
    siz = encoder.build_siz(pimg, pparams)
    cod = encoder.build_cod(pimg, pparams)
    tr = tile_rect(0, siz.xsiz, siz.ysiz, siz.xosiz, siz.yosiz,
                   siz.xtsiz, siz.ytsiz, siz.xtosiz, siz.ytosiz)
    plan = fused_encode.build_plan(siz, cod, default_qcd(siz, cod, 2), tr,
                                   coder="mq", want_rd=True)
    assert convert.plan_from_reference(ref_plan) == plan
    assert plan.want_rd and not plan.cfg.reversible
    assert all(b.step < 1.0 for (_, _, bs) in plan.groups for b in bs)


@pytest.mark.parametrize("name,size,params", [
    ("97_rates_3layers", (63, 57), EncoderParams(
        numresolutions=4, transform=Transform.DWT_97, numlayers=3,
        rates=(24.0, 48.0, 96.0), cblk_style=0)),
    ("97_one_layer", (47, 41), EncoderParams(
        numresolutions=4, transform=Transform.DWT_97, cblk_style=0)),
    ("53_rates_3layers", (47, 41), EncoderParams(
        numresolutions=4, numlayers=3, rates=(8.0, 4.0, 2.0),
        cblk_style=0)),
    ("97_psnr_3layers", (47, 41), EncoderParams(
        numresolutions=4, transform=Transform.DWT_97,
        quality_psnr=(30.0, 38.0, 45.0), cblk_style=0)),
    # flat frames: shape groups whose every block quantizes to zero
    ("97_rates_flat", (40, 32), EncoderParams(
        numresolutions=3, transform=Transform.DWT_97, numlayers=2,
        rates=(20.0, 40.0), cblk_style=0)),
])
def test_encode_batch_matches_host(name, size, params, monkeypatch):
    imgs = _rgb(2, *size, seed=11)
    if name == "97_rates_flat":
        for im in imgs:
            for k, c in enumerate(im.components):
                c.data[...] = 77 + 9 * k
    got = encoder.encode_batch([convert.image_from_reference(im)
                                for im in imgs],
                               convert.params_from_reference(params),
                               device="cpu", chunk=2)
    monkeypatch.setattr(dwt_host, "_get_native", lambda: None)
    want = [ref_encoder.encode(im, params, device=False) for im in imgs]
    assert got == want
