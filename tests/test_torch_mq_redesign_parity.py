"""The port's plain MQ coder and decoder against the JAX reference at the
shapes and streams the CUDA kernels' layouts treat specially, on the CPU.

The kernels (`csrc/mq_scan.cu`, `csrc/mq_dec.cu`) walk stripe-column
state words and per-lane lists of coding slots; their `gpu` tests
(`tests/test_torch_mq_scan.py`, `tests/test_torch_mq_dec.py`) hold them
to the plain versions on the card on these shapes. Here the plain
versions are held, on the same numpy inputs, to the reference, so that
kernel = plain = JAX on each of them:
- the plain coder `mq_torch.mq_scan_plain` against the reference's
  compacting-scan oracle `mq_jax._mq_scans_compact_ref` spliced by
  `assemble_mq_segments` (segments, end-of-scan state, and the byte-outs
  at every pass end from its per-256-slot sums) and against the Annex-D
  oracle `t1_np.encode_cblk`, on partial stripes, one-column and one-row
  blocks, and a wide block, with lanes that code nothing and a dead top
  plane (passes with no coding slot);
- the plain decoder `mq_dec_torch.decode_blocks(device="cpu")` against
  `mq_dec_jax.decode_blocks` and `t1_np.decode_cblk`, on partial stripes
  (h = 5, 6, 7), one-column and one-row blocks, 4 x 1024, and segments
  cut mid-way or carrying 0xFF before bytes above and below 0x8F.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax import lax

from grokimagecompression_tpu.ops import mq_dec_jax, mq_jax
from grokimagecompression_tpu.t1 import t1_np
from grokimagecompression_tpu_torch.ops import mq_dec_torch, mq_torch

from test_torch_mq_dec import _plant_markers


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Torch on one thread: the plain versions run many small CPU ops, and
    under pytest-xdist's workers torch's OpenMP threads oversubscribe the
    cores and spin (a case of 2.4 s alone took 43 s among six workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _blocks(rng, h, w, n, hi):
    """n blocks (orientations cycling; lane 1 all zero, lane k's
    magnitudes cut to k % 7 + 1 bits so that depths differ)."""
    mag = (rng.random((n, h, w)) < 0.5) * rng.integers(0, hi, (n, h, w))
    mag = mag & ((1 << (np.arange(n) % 7 + 1)) - 1)[:, None, None]
    mag[1] = 0
    neg = rng.integers(0, 2, (n, h, w))
    return mag.astype(np.uint32), neg.astype(np.uint8), np.arange(n) % 4


def _reference(slots, spans):
    """Segments, end-of-scan state and pass-end byte-outs of the
    reference's compacting-scan oracle (lanes padded to 128) spliced by
    its host tail."""
    T, B = slots.shape
    padded = np.zeros((T, 128), np.int8)
    padded[:, :B] = slots
    comp1, counts1, nboc, st = mq_jax._mq_scans_compact_ref(
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
        metrics.append((4 * counts1[:, b].sum() + st[5, b], *st[:5, b]))
    segs = mq_jax.assemble_mq_segments(np.asarray(words, np.int32),
                                       np.asarray(metrics, np.int64))
    cum = np.cumsum(np.asarray(nboc).reshape(nch, 128)[:, :B], axis=0)
    ends = mq_torch.pass_ends(T, spans)
    cumbo = cum[[e // 256 - 1 for e in ends]]
    return segs, np.concatenate([st[:4, :B], st[6:, :B]]), cumbo


CODER_CASES = [
    ("partial_stripe_5x9", (5, 9, 9, 200)),
    ("one_column_7x1", (7, 1, 9, 200)),
    ("one_row_1x12", (1, 12, 9, 200)),
    ("wide_4x64", (4, 64, 9, 60)),
]


@pytest.mark.parametrize("name,spec", CODER_CASES,
                         ids=[c[0] for c in CODER_CASES])
def test_plain_coder_at_awkward_shapes(name, spec):
    h, w, n, hi = spec
    rng = np.random.default_rng(h * 31 + w)
    mag, neg, orient = _blocks(rng, h, w, n, hi)
    tm = torch.from_numpy(mag.astype(np.int32))
    nbps = mq_torch.bit_planes(tm)
    npl = int(nbps.max()) + 1              # the top plane is dead
    slots = mq_torch.build_slot_stream(
        tm, torch.from_numpy(neg), torch.from_numpy(orient), nbps, npl)
    spans = mq_torch.pass_spans_padded(h, w)
    assert not bool((slots[:, 1] & 1).any())      # a lane with E = 0
    data, lens, state, cumbo = mq_torch.mq_scan_plain(slots, spans)
    ends = np.cumsum(lens.numpy())
    segs = [bytes(data.numpy()[e - k:e]) for e, k in zip(ends, lens.numpy())]
    ref_segs, ref_state, ref_cumbo = _reference(slots.numpy(), spans)
    assert segs == ref_segs
    np.testing.assert_array_equal(state.numpy(), ref_state)
    np.testing.assert_array_equal(cumbo.numpy(), ref_cumbo)
    for b in range(n):
        oracle, nb, npasses, _ = t1_np.encode_cblk(mag[b], neg[b],
                                                   int(orient[b]))
        assert nb == int(nbps[b])
        if nb:
            assert npasses == 3 * nb - 2 and segs[b] == oracle, f"lane {b}"


DECODER_CASES = [
    ("partial_stripes", dict(shapes=((5, 8), (6, 8), (7, 8)), hi=200)),
    ("one_column_one_row", dict(shapes=((9, 1), (1, 11), (1, 1)), hi=200)),
    ("wide_4x1024", dict(shapes=((4, 1024),), hi=4, n=3)),
    ("cut_and_markers", dict(shapes=((6, 6), (5, 3)), hi=200, cut=True)),
]


@pytest.mark.parametrize("name,spec", DECODER_CASES,
                         ids=[c[0] for c in DECODER_CASES])
def test_plain_decoder_at_awkward_shapes(name, spec):
    rng = np.random.default_rng(len(name))
    blocks = []
    for (h, w) in spec["shapes"]:
        mag, neg, orient = _blocks(rng, h, w, spec.get("n", 6), spec["hi"])
        for b in range(mag.shape[0]):
            data, nb, npas, _ = t1_np.encode_cblk(mag[b], neg[b],
                                                  int(orient[b]))
            if spec.get("cut") and nb:
                blocks.append((data[:len(data) // 2], w, h, int(orient[b]),
                               nb, npas))
                data = _plant_markers(data)
            blocks.append((data, w, h, int(orient[b]), nb, npas))
    assert len({b[4] for b in blocks}) > 2
    got = mq_dec_torch.decode_blocks(blocks, device="cpu")
    for ref in (mq_dec_jax.decode_blocks(blocks),
                [t1_np.decode_cblk(d, None, w, h, o, nb, npas)
                 for (d, w, h, o, nb, npas) in blocks]):
        for i, ((gm, gn), (em, en)) in enumerate(zip(got, ref)):
            assert np.array_equal(gm, em), f"block {i} {blocks[i][1:]}: mags"
            live = em != 0
            assert np.array_equal(gn[live], en[live]), f"block {i}: signs"
