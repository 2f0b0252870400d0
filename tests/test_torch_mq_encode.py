"""The port's Part-1 MQ lossless encode against the JAX reference, on the CPU.

Layer by layer, on the same numpy inputs:
- `ops/mq_torch.build_slot_stream` must equal `mq_jax.build_slot_stream`
  (jnp on the CPU) slot for slot, at a block height that is not a
  multiple of 4 and at 16 x 16, with all four orientations, mixed
  bit-plane counts and a dead top plane;
- the plain MQ coder (`mq_torch.mq_scan_plain`, what `ops/mq_scan.py`
  runs for CPU tensors) must give the segments of the reference's
  `_mq_scans_compact_ref` + `assemble_mq_segments`, its end-of-scan
  state, and the Annex-D oracle `t1/t1_np.encode_cblk`, byte for byte;
- `build_plan(coder="mq")` must equal the reference's MQ plan;
- `codestream/encoder.encode_batch(device="cpu", cblk_style=0)` must
  give the reference host encoder's streams byte for byte, on a small
  geometry, on three RCT components and on an odd-origin multi-tile one.
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
from grokimagecompression_tpu.core.params import EncoderParams
from grokimagecompression_tpu.models import fused_encode as ref_fused
from grokimagecompression_tpu.ops import mq_jax
from grokimagecompression_tpu.t1 import t1_np
from grokimagecompression_tpu_torch import convert
from grokimagecompression_tpu_torch.codestream import encoder
from grokimagecompression_tpu_torch.codestream.tile import default_qcd
from grokimagecompression_tpu_torch.core.geometry import tile_rect
from grokimagecompression_tpu_torch.models import fused_encode
from grokimagecompression_tpu_torch.ops import mq_torch

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


SHAPES = [(7, 13), (16, 16)]


def _blocks(h, w, seed):
    """12 blocks: each orientation with an all-zero block, a sparse one
    and a dense one, bit-plane counts from 0 to 8."""
    rng = np.random.default_rng(seed)
    mags, negs, orients = [], [], []
    for orient in range(4):
        for dens, mb in ((0.0, 0), (0.1, 5), (0.9, 8)):
            m = rng.integers(0, 1 << mb, (h, w)) if mb else np.zeros((h, w))
            m = np.where(rng.random((h, w)) < dens, m, 0)
            mags.append(m.astype(np.uint32))
            negs.append(rng.integers(0, 2, (h, w)).astype(np.uint8))
            orients.append(orient)
    mag = np.stack(mags)
    nbps = np.asarray([int(m.max()).bit_length() for m in mag], np.int32)
    return mag, np.stack(negs), np.asarray(orients, np.int32), nbps


@pytest.fixture(scope="module", params=SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def streams(request):
    """(blocks, nplanes, reference slot stream, port slot stream) for one
    block shape; one JAX compile per shape."""
    h, w = request.param
    mag, neg, orient, nbps = _blocks(h, w, seed=h * 100 + w)
    nplanes = int(nbps.max()) + 1          # the top plane is dead
    hp = -(-h // 4) * 4
    B = mag.shape[0]
    mag_t = np.zeros((hp, w, B), np.uint32)
    mag_t[:h] = mag.transpose(1, 2, 0)
    neg_t = np.zeros((hp, w, B), np.int32)
    neg_t[:h] = neg.transpose(1, 2, 0)
    geo = mq_jax._geometry(h, w)
    ref = jax.jit(lambda m, n, o, nb: mq_jax.build_slot_stream(
        jnp, lax, m, n, o[None, None, :], nb[None, None, :], nplanes, geo))
    want = np.asarray(ref(mag_t, neg_t, orient, nbps))
    got = mq_torch.build_slot_stream(
        torch.from_numpy(mag.astype(np.int32)), torch.from_numpy(neg),
        torch.from_numpy(orient), torch.from_numpy(nbps), nplanes)
    return (mag, neg, orient, nbps), nplanes, want, got


def test_slot_stream_matches_jax(streams):
    (mag, _, _, nbps), nplanes, want, got = streams
    h, w = mag.shape[1:]
    assert got.dtype == torch.int8
    assert got.shape == (nplanes * mq_torch.slots_per_plane(h, w),
                         mag.shape[0])
    np.testing.assert_array_equal(got.numpy(), want)
    # the dead top plane is all zero slots, the live ones code something
    tp = mq_torch.slots_per_plane(h, w)
    assert not want[:tp].any() and (want[tp:] & 1).any()


def _reference_segments(slots):
    """Segments and end-of-scan state of the reference's compacting-scan
    oracle (`_mq_scans_compact_ref`, lanes padded to 128) spliced by its
    host tail (`assemble_mq_segments`)."""
    T, B = slots.shape
    padded = np.zeros((T, 128), np.int8)
    padded[:, :B] = slots
    comp1, counts1, _, st = mq_jax._mq_scans_compact_ref(
        jnp, lax, jnp.asarray(padded))
    nch = counts1.shape[0]
    comp1 = np.asarray(comp1).reshape(nch, mq_jax.MQ_CCAP, 128)
    counts1 = np.asarray(counts1).reshape(nch, 128)
    st = np.asarray(st).reshape(mq_jax.NSTATE, 128)
    assert counts1.max() <= mq_jax.MQ_CCAP   # no compaction overflow
    words, metrics = [], []
    for b in range(B):
        for ch in range(nch):
            words += list(comp1[ch, :counts1[ch, b], b])
        if st[5, b]:
            words.append(st[4, b])
        metrics.append((4 * counts1[:, b].sum() + st[5, b],
                        *st[:5, b]))
    segs = mq_jax.assemble_mq_segments(np.asarray(words, np.int32),
                                       np.asarray(metrics, np.int64))
    return segs, np.concatenate([st[:4, :B], st[6:, :B]])


def test_plain_coder_matches_reference_and_oracle(streams):
    (mag, neg, orient, nbps), _, want_slots, got_slots = streams
    data, lens, state = mq_torch.mq_scan_plain(got_slots)
    ends = np.cumsum(lens.numpy())
    segs = [bytes(data.numpy()[e - n:e]) for e, n in zip(ends, lens.numpy())]
    ref_segs, ref_state = _reference_segments(want_slots)
    assert segs == ref_segs
    np.testing.assert_array_equal(state.numpy(), ref_state)
    for b in range(mag.shape[0]):
        oracle, nb, npasses, _ = t1_np.encode_cblk(mag[b], neg[b],
                                                   int(orient[b]))
        assert nb == nbps[b]
        if nb:
            assert npasses == 3 * nb - 2
            assert segs[b] == oracle, f"lane {b}"


def test_mq_plan_equals_reference():
    """BASELINE config-1 geometry: the MQ plan's groups are keyed by block
    shape in samples, deepest bands first."""
    img = natural_image(512, 512)
    params = EncoderParams(numresolutions=6, cblk_style=0)
    rsiz = ref_encoder.build_siz(img, params)
    rcod = ref_encoder.build_cod(img, params)
    rqcd = ref_tile.default_qcd(rsiz, rcod, 2, params.base_step)
    rtr = ref_tile_rect(0, rsiz.xsiz, rsiz.ysiz, rsiz.xosiz, rsiz.yosiz,
                        rsiz.xtsiz, rsiz.ytsiz, rsiz.xtosiz, rsiz.ytosiz)
    ref_plan = ref_fused.build_plan(rsiz, rcod, rqcd, rtr, coder="mq")
    pimg = convert.image_from_reference(img)
    pparams = convert.params_from_reference(params)
    siz = encoder.build_siz(pimg, pparams)
    cod = encoder.build_cod(pimg, pparams)
    tr = tile_rect(0, siz.xsiz, siz.ysiz, siz.xosiz, siz.yosiz,
                   siz.xtsiz, siz.ytsiz, siz.xtosiz, siz.ytosiz)
    plan = fused_encode.build_plan(siz, cod, default_qcd(siz, cod, 2), tr,
                                   coder="mq")
    assert convert.plan_from_reference(ref_plan) == plan
    assert [(h, w, len(b)) for (h, w, b) in plan.groups] == [
        (16, 16, 4), (32, 32, 3), (64, 64, 63)]
    kmaxs = [b.kmax for b in plan.groups[-1][2]]
    assert kmaxs == sorted(kmaxs, reverse=True)


def _frames(n, w, h, seed, ncomp=1):
    return [natural_image(w, h, ncomp=ncomp, seed=seed + i) for i in range(n)]


@pytest.mark.parametrize("name,imgs,params,chunk", [
    ("64x48_3res_16x16", _frames(3, 64, 48, seed=20),
     EncoderParams(numresolutions=3, cblk_style=0, cblk_w_exp=4,
                   cblk_h_exp=4), 2),
    # three components with the RCT: blocks of every component share the
    # shape groups
    ("rgb_rct_32x24", _frames(2, 32, 24, seed=40, ncomp=3),
     EncoderParams(numresolutions=2, cblk_style=0), 2),
    ("odd_origin_tiles", _frames(2, 45, 27, seed=30),
     EncoderParams(numresolutions=3, cblk_style=0, cblk_w_exp=4,
                   cblk_h_exp=4, image_offset=(3, 5), tile_offset=(1, 2),
                   tile_size=(24, 16)), 2),
])
def test_encode_batch_matches_host(name, imgs, params, chunk):
    got = encoder.encode_batch(
        [convert.image_from_reference(im) for im in imgs],
        convert.params_from_reference(params), device="cpu", chunk=chunk)
    assert got == [ref_encoder.encode(im, params, device=False)
                   for im in imgs]
