"""The Part-1 MQ decoder of the torch port against the JAX reference.

- the plain group decoder `mq_dec_torch.decode_group_plain` (what
  `mq_dec.decode_group` runs for CPU tensors), through the block API
  `mq_dec_torch.decode_blocks`, against `mq_dec_jax.decode_blocks` on one
  8x8 batch over all four orientations with mixed depths and an all-zero
  lane, and against the Annex-D oracle `t1_np.decode_cblk` on edge
  shapes, pass- and byte-truncated segments and a 16x16 block, exactly
  (magnitudes, and the signs of significant samples), on segments of the
  reference's `t1_np.encode_cblk`;
- the plain decoder's statistics and the round trip through the port's
  own MQ encoder (`mq_torch.build_slot_stream`, `mq_scan.mq_scan`);
- the wrapper's checks, and its lane order (`mq_dec.lane_order`: a
  permutation by work that leaves the samples in lane order).
The Pallas kernel itself is not run here: the reference keeps its
interpret mode opt-in for its cost. The `gpu` case holds the CUDA kernel
against the plain version on the card, lane for lane, on segments of the
port's MQ encoder: partial stripes, one-column and one-row blocks, 4 x
1024, all four orientations and lanes of very different depth in one
launch, truncated, cut, marker-planted and idle lanes, and lane counts
that are not a multiple of the kernel's block. The plain version is
held to the JAX reference and the Annex-D oracle at the same awkward
shapes in `tests/test_torch_mq_redesign_parity.py`.

The reference is imported inside the tests that use it, so the `gpu` case
also runs where only torch is installed.
"""

import numpy as np
import pytest
import torch

from grokimagecompression_tpu_torch.ops import (mq_dec, mq_dec_torch,
                                                mq_scan, mq_torch)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Torch on one thread: the plain versions run many small CPU ops, and
    under pytest-xdist's workers torch's OpenMP threads oversubscribe the
    cores and spin (a case of 2.4 s alone took 43 s among six workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _mk(rng, h, w, dens, hi, orient):
    mag = rng.integers(0, hi, (h, w)).astype(np.uint32)
    mag = np.where(rng.random((h, w)) < 1 - dens, 0, mag).astype(np.uint32)
    neg = rng.integers(0, 2, (h, w)).astype(np.uint8)
    return mag, neg, orient


def _ref_blocks(cases, trunc=None, cuts=()):
    """Blocks of the reference encoder `t1_np.encode_cblk`: each case
    whole, cut to its first `trunc` passes, or cut at the byte counts
    `cuts` with every pass kept."""
    from grokimagecompression_tpu.t1 import t1_np
    blocks = []
    for (mag, neg, o) in cases:
        data, nb, npas, passes = t1_np.encode_cblk(mag, neg, o)
        h, w = mag.shape
        if trunc is not None and passes:
            k = min(trunc, npas)
            blocks.append((data[:passes[k - 1].rate], w, h, o, nb, k))
        elif cuts:
            blocks += [(data[:c], w, h, o, nb, npas) for c in cuts]
        else:
            blocks.append((data, w, h, o, nb, npas))
    return blocks


def _assert_equal(got, want, blocks):
    for i, ((gm, gn), (em, en)) in enumerate(zip(got, want)):
        assert gm.dtype == np.uint32 and gn.dtype == np.uint8
        assert np.array_equal(gm, em), f"block {i} {blocks[i][1:]}: mags"
        live = em != 0
        assert np.array_equal(gn[live], en[live]), f"block {i}: signs"


def _oracle(blocks):
    from grokimagecompression_tpu.t1 import t1_np
    return [t1_np.decode_cblk(d, None, w, h, o, nb, npas)
            for (d, w, h, o, nb, npas) in blocks]


def test_plain_equals_mq_dec_jax_on_8x8_batch():
    """One 8x8 group: every orientation, three depths each, an all-zero
    block (no pass: zeros, no lane) and a lane cut to 4 passes."""
    from grokimagecompression_tpu.ops import mq_dec_jax
    rng = np.random.default_rng(41)
    cases = [_mk(rng, 8, 8, dens, hi, o) for o in range(4)
             for dens, hi in ((0.5, 60), (0.06, 250), (1.0, 15))]
    cases.append((np.zeros((8, 8), np.uint32), np.zeros((8, 8), np.uint8),
                  3))
    blocks = _ref_blocks(cases) + _ref_blocks(cases[:1], trunc=4)
    assert blocks[-2][4] == 0 and len({b[4] for b in blocks}) > 3
    got = mq_dec_torch.decode_blocks(blocks, device="cpu")
    _assert_equal(got, mq_dec_jax.decode_blocks(blocks), blocks)
    _assert_equal(got, _oracle(blocks), blocks)


ORACLE_CASES = [
    ("edge_shapes", dict(shapes=((1, 1), (3, 5), (7, 9), (13, 6)))),
    ("pass_truncated", dict(shapes=((16, 16),), trunc=(1, 2, 3, 5, 8, 11))),
    ("byte_truncated", dict(shapes=((16, 16),), cuts=(1, 5, 23, 60))),
    ("block_16x16", dict(shapes=((16, 16),))),
]


@pytest.mark.parametrize("name,spec", ORACLE_CASES,
                         ids=[c[0] for c in ORACLE_CASES])
def test_plain_equals_annex_d_oracle(name, spec):
    rng = np.random.default_rng(57)
    cases = [_mk(rng, h, w, 0.45, 120, k % 4)
             for k, (h, w) in enumerate(spec["shapes"])]
    blocks = []
    for t in spec.get("trunc", (None,)):
        blocks += _ref_blocks(cases, trunc=t, cuts=spec.get("cuts", ()))
    got = mq_dec_torch.decode_blocks(blocks, device="cpu")
    _assert_equal(got, _oracle(blocks), blocks)


def _port_blocks(rng, h, w, n, dev, hi=300, deep=False):
    """n random w x h blocks of magnitudes below `hi` (orientations
    cycling, lane 1 all zero; with `deep`, lane k's magnitudes cut to
    k % 9 + 1 bits, so that depths differ) through the port's MQ encoder
    on `dev`: (mag, neg, orient) numpy, segments, numbps."""
    mag = (rng.random((n, h, w)) < 0.5) * rng.integers(0, hi, (n, h, w))
    if deep:
        mag = mag & ((1 << (np.arange(n) % 9 + 1)) - 1)[:, None, None]
    mag[1] = 0
    neg = rng.integers(0, 2, (n, h, w))
    orient = np.arange(n) % 4
    tm = torch.from_numpy(mag.astype(np.int32)).to(dev)
    nbps = mq_torch.bit_planes(tm)
    npl = int(nbps.max())
    slots = mq_torch.build_slot_stream(
        tm, torch.from_numpy(neg).to(dev), torch.from_numpy(orient).to(dev),
        nbps, npl)
    data, lens, _ = mq_scan.mq_scan(slots)
    data, lens = data.cpu().numpy(), lens.cpu().numpy()
    ends = np.cumsum(lens)
    segs = [data[e - n_:e].tobytes() for e, n_ in zip(ends, lens)]
    return mag, neg, orient, segs, nbps.cpu().numpy()


def test_plain_inverts_the_port_encoder_and_counts():
    rng = np.random.default_rng(9)
    mag, neg, orient, segs, nbps = _port_blocks(rng, 6, 10, 5, "cpu")
    npas = np.where(nbps > 0, 3 * nbps - 2, 0)
    arrays = [torch.from_numpy(a) for a in mq_dec.pack_lanes(
        segs, orient, nbps, npas)]
    before = dict(mq_dec.LAUNCHES)
    packed, stats = mq_dec.decode_group(*arrays, 10, 6, with_stats=True)
    assert mq_dec.LAUNCHES == before
    assert packed.shape == (60, 5) and packed.dtype == torch.int32
    mags, negs = mq_dec_torch.unpack(packed.numpy())
    for b in range(5):
        assert np.array_equal(mags[:, b].reshape(6, 10), mag[b])
        live = mag[b] != 0
        assert np.array_equal(negs[:, b].reshape(6, 10)[live], neg[b][live])
    # the all-zero lane has no pass: no decision, INITDEC's BYTEIN only
    assert stats.shape == (2, 5) and stats[:, 1].tolist() == [0, 1]
    assert (stats[0, [0, 2, 3, 4]] > 60).all()


def test_wrapper_validates_inputs():
    arrays = [torch.from_numpy(a) for a in mq_dec.pack_lanes(
        [b"\x12\x34", b""], [0, 1], [3, 0], [7, 0])]
    data, off, nbps, npas, ori = arrays
    with pytest.raises(TypeError):
        mq_dec.decode_group(data.to(torch.int32), off, nbps, npas, ori, 4, 4)
    with pytest.raises(ValueError):
        mq_dec.decode_group(data, off[:-1], nbps, npas, ori, 4, 4)
    with pytest.raises(ValueError):
        mq_dec.decode_group(data, off, nbps.to(torch.int64), npas, ori, 4, 4)
    with pytest.raises(ValueError):
        mq_dec.decode_group(data, off, nbps, npas, ori, 64, 128)
    for k, bad in ((2, nbps + 40), (3, npas - 9), (4, ori + 3),
                   (1, off + 1)):
        args = [data, off, nbps, npas, ori]
        args[k] = bad
        with pytest.raises(ValueError):
            mq_dec.decode_group(*args, 4, 4)
    assert mq_dec.decode_group(data, off, nbps, npas, ori, 4, 4).shape == \
        (16, 2)


def _plant_markers(seg: bytes) -> bytes:
    """`seg` with 0xFF bytes planted before a byte above 0x8F (a marker)
    and before one below it (a stuffed byte), and a trailing 0xFF."""
    s = bytearray(seg)
    if len(s) > 8:
        s[len(s) // 2:len(s) // 2 + 2] = b"\xff\x93"
        s[len(s) // 3:len(s) // 3 + 2] = b"\xff\x21"
        s[-1] = 0xFF
    return bytes(s)


def test_lane_order_is_a_permutation_by_work():
    """`lane_order` sorts the lanes by the passes the decoder walks, then
    by segment bytes, both descending, idle lanes last; decoding the lanes
    in that order and putting them back gives the samples in lane
    order."""
    rng = np.random.default_rng(13)
    _, _, orient, segs, nbps = _port_blocks(rng, 6, 5, 9, "cpu", deep=True)
    npas = np.where(nbps > 0, 3 * nbps - 2, 0)
    npas[3] = min(npas[3], 2)
    arrays = [torch.from_numpy(a) for a in mq_dec.pack_lanes(
        segs + [b""], list(orient) + [0], list(nbps) + [0], list(npas) + [0])]
    data, off, nb, npa, ori = arrays
    order = mq_dec.lane_order(off, nb, npa)
    assert order.dtype == torch.int32
    assert sorted(order.tolist()) == list(range(nb.shape[0]))
    walked = torch.where(nb > 0, torch.minimum(npa, 3 * nb - 2), 0)
    key = [(int(walked[i]), int(off[i + 1] - off[i])) for i in order]
    assert key == sorted(key, reverse=True) and key[-1] == (0, 0)
    # the lanes re-packed in that order decode to the same lanes' samples
    o = order.tolist()
    perm = [torch.from_numpy(a) for a in mq_dec.pack_lanes(
        [(segs + [b""])[i] for i in o], ori[o].tolist(), nb[o].tolist(),
        npa[o].tolist())]
    want = mq_dec.decode_group(*arrays, 5, 6)
    got = mq_dec.decode_group(*perm, 5, 6)
    assert torch.equal(got[:, torch.argsort(order)], want)


@pytest.mark.gpu
def test_cuda_decoder_matches_plain():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda")
    rng = np.random.default_rng(11)
    # partial stripes (h = 5, 6, 7), one column, one row, 4 x 1024 and
    # (4096, 1), whose state words need more than 48 KB of shared memory;
    # lane counts 6 to 38, not a multiple of the kernel's block
    for (h, w, n, hi, deep) in (
            (64, 64, 5, 16, False), (32, 32, 6, 300, False),
            (5, 7, 6, 300, False), (5, 8, 13, 300, True),
            (6, 9, 13, 300, True), (7, 3, 9, 300, True),
            (9, 1, 9, 300, True), (1, 11, 9, 300, True),
            (1, 1, 5, 300, False), (8, 8, 37, 300, True),
            (4, 512, 5, 8, False), (4, 1024, 7, 8, True),
            (4096, 1, 5, 4, False)):
        mag, _, orient, segs, nbps = _port_blocks(rng, h, w, n, dev, hi,
                                                  deep)
        npas = np.where(nbps > 0, 3 * nbps - 2, 0)
        # truncations: lane 2 to 4 passes, lane 3 to half its bytes, lane 4
        # with planted markers, and an idle lane
        npas[2] = min(npas[2], 4)
        segs[3] = segs[3][:len(segs[3]) // 2]
        segs[4] = _plant_markers(segs[4])
        arrays = [torch.from_numpy(a).to(dev) for a in mq_dec.pack_lanes(
            segs + [b""], list(orient) + [0], list(nbps) + [0],
            list(npas) + [0])]
        before = mq_dec.LAUNCHES["mq_dec"]
        got, gstats = mq_dec.decode_group(*arrays, w, h, with_stats=True)
        torch.cuda.synchronize()
        assert mq_dec.LAUNCHES["mq_dec"] == before + 1
        want, wstats = mq_dec_torch.decode_group_plain(*arrays, w, h,
                                                       with_stats=True)
        assert torch.equal(got, want), f"{w}x{h} samples"
        assert torch.equal(gstats, wstats), f"{w}x{h} statistics"
        mags, _ = mq_dec_torch.unpack(got.cpu().numpy())
        for b in (0, 1) + tuple(range(5, n)):
            assert np.array_equal(mags[:, b].reshape(h, w), mag[b])
