"""HT decoder stages of the torch port against the JAX reference.

- the port's native prepass (`native/ht_prepass.py`) against the
  reference's numpy prepass (`ht_dec_jax._prepass_mel/_vlc/_ms`, the
  `GROK_TPU_PREPASS=numpy` path) on random segments;
- the plain group decoder `ht_dec_torch.decode_group_plain` (what
  `ht_dec.decode_group` runs for CPU tensors) against the Pallas kernel
  `ht_dec_pallas.decode_group_pallas` in interpret mode (at the 16x16
  shape the reference's own test compiles), `ht_dec_jax.ht_decode_blocks`
  and the reference's native block decoder, exactly, on streams of the
  reference's native HT encoder, with empty lanes and magnitudes near the
  Mb gate;
- the port's tables and decode LUTs against the reference's.
The `gpu` case holds the CUDA kernel (`decode_segments`, on raw segments)
against the plain version on the card, on segments of the port's own HT
encoder and on the raw-reader edge segments.

The reference is imported inside the helpers and tests that use it, not
at module level, so the `gpu` case also runs where only torch is
installed.
"""

import numpy as np
import pytest
import torch

from grokimagecompression_tpu_torch import convert
from grokimagecompression_tpu_torch.models import fused_decode
from grokimagecompression_tpu_torch.native import ht_prepass
from grokimagecompression_tpu_torch.ops import (ht_dec, ht_dec_torch,
                                                ht_enc, ht_tables)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Torch on one thread: the plain versions run many small CPU ops, and
    under pytest-xdist's workers torch's OpenMP threads oversubscribe the
    cores and spin (a case of 2.4 s alone took 43 s among six workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _blocks(rng, h, w, dens, mbits, n, mb=12):
    cases = []
    for _ in range(n):
        mag = ((rng.random((h, w)) < dens)
               * rng.integers(1, 1 << mbits, (h, w))).astype(np.uint32)
        neg = (rng.random((h, w)) < 0.5).astype(np.uint8)
        cases.append((mag, neg, mb))
    return cases


def _lengths(segs):
    return segs, [len(s) for s in segs], [(s[-1] << 4) + (s[-2] & 0xF)
                                          for s in segs]


def _segments(cases):
    """Segments of the reference's native HT encoder."""
    from grokimagecompression_tpu.native import t1_native
    return _lengths([bytes(s)
                     for s in t1_native.ht_encode_cblk_batch(cases)])


def _port_segments(cases, device):
    """Segments of the port's HT encoder on `device` (one shape group), as
    `models/fused_encode.py` codes them (`ht_enc.encode_segments`: the
    kernel on the card, its plain version on the CPU)."""
    h, w = cases[0][0].shape
    qh, qw = (h + 1) // 2, (w + 1) // 2
    co = np.zeros((len(cases), 2 * qh, 2 * qw), np.int64)
    for i, (m, n, _) in enumerate(cases):
        co[i, :h, :w] = np.where(n == 1, -m.astype(np.int64), m)
    mbs = torch.as_tensor([c[2] for c in cases], dtype=torch.int32,
                          device=device)
    tables = convert.tables_from_reference(ht_tables._tables(), device)
    data, lens = ht_enc.encode_segments(
        torch.from_numpy(co.astype(np.int32)).to(device), mbs, tables)
    ends = np.cumsum(lens.cpu().numpy(), dtype=np.int64)
    buf = data.cpu().numpy().tobytes()
    return _lengths([buf[e - n:e] for e, n in zip(ends, lens.tolist())])


def _words(segs, lcups, scups):
    """The port's prepass at fused_decode's word widths, as int32
    tensors."""
    return [torch.from_numpy(a.view(np.int32))
            for a in ht_prepass.prepass_group(segs, lcups, scups)]


def _tables():
    return convert.dec_tables_from_reference(ht_tables._dec_tables(), "cpu")


def test_tables_equal_reference():
    from grokimagecompression_tpu.ops import ht_dec_jax, ht_jax
    for got, want in zip(ht_tables._tables(), ht_jax._tables(),
                         strict=True):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    for got, want in zip(ht_tables._dec_tables(), ht_dec_jax._dec_tables(),
                         strict=True):
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(ht_tables.MEL_EXP, ht_jax.MEL_EXP)
    t = convert.dec_tables_from_reference(ht_dec_jax._dec_tables(), "cpu")
    assert t["dec0"].dtype == torch.int32 and t["dec0"].shape == (1024,)


@pytest.mark.parametrize("h,w,dens,mbits,seed", [
    (16, 16, 0.4, 8, 1), (13, 10, 0.6, 10, 2), (64, 5, 0.05, 6, 3),
    (3, 40, 0.9, 14, 4)])
def test_prepass_equals_numpy_prepass(h, w, dens, mbits, seed):
    from grokimagecompression_tpu.ops import ht_dec_jax
    rng = np.random.default_rng(seed)
    segs, lcups, scups = _segments(_blocks(rng, h, w, dens, mbits, 5))
    # the dummy segment of an empty lane, as fused_decode stages it
    segs.append(fused_decode.DUMMY_SEGMENT)
    lcups.append(2)
    scups.append(2)
    wm = ht_prepass.bucket_words((8 * (max(scups) + 7)) // 32 + 4)
    wm_ms = ht_prepass.bucket_words(
        (8 * (max(lc - sc for lc, sc in zip(lcups, scups)) + 8)) // 32 + 4)
    assert (wm, wm_ms) == (ht_dec_jax.bucket_words(
        (8 * (max(scups) + 7)) // 32 + 4), ht_dec_jax.bucket_words(
        (8 * (max(lc - sc for lc, sc in zip(lcups, scups)) + 8)) // 32 + 4))
    got = ht_prepass.ht_dec_prepass(segs, lcups, scups, wm, wm, wm_ms)
    want = (ht_dec_jax._prepass_mel(segs, lcups, scups, wm),
            ht_dec_jax._prepass_vlc(segs, lcups, scups, wm),
            ht_dec_jax._prepass_ms(segs, lcups, scups, wm_ms))
    for name, g, wnt in zip(("mel", "vlc", "ms"), got, want):
        assert g.dtype == np.uint32
        np.testing.assert_array_equal(g, wnt, err_msg=name)


def test_plain_decoder_equals_pallas_interpret():
    """The reference's own interpret-mode case (tests/test_ht_dec_pallas.py)
    plus an empty lane: same (W, B_pad) shapes, so the same compile."""
    import jax.numpy as jnp

    from grokimagecompression_tpu.ops import ht_dec_pallas
    h = w = 16
    rng = np.random.default_rng(h * 31 + w)
    segs, lcups, scups = _segments(_blocks(rng, h, w, 0.4, 8, 4))
    segs.append(fused_decode.DUMMY_SEGMENT)
    lcups.append(2)
    scups.append(2)
    mel, vlc, ms = _words(segs, lcups, scups)
    want = ht_dec_pallas.decode_group_pallas(w, h, interpret=True)(
        *(jnp.asarray(a.numpy().view(np.uint32)) for a in (mel, vlc, ms)))
    got = ht_dec.decode_group(mel, vlc, ms, w, h, _tables())
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    sig = got[0].numpy() > 0
    np.testing.assert_array_equal(got[1].numpy()[sig],
                                  np.asarray(want[1])[sig])


@pytest.mark.parametrize("h,w,dens,mbits,mb,jax_too", [
    (16, 16, 0.5, 8, 12, True),
    (8, 12, 0.3, 27, 28, True),     # magnitudes near the Mb + 3 <= 32 gate
    (7, 5, 0.6, 6, 10, False),
    (1, 9, 0.5, 8, 10, False),
    (9, 1, 0.5, 8, 10, False),
])
def test_plain_decoder_equals_jax_decode_blocks(h, w, dens, mbits, mb,
                                                jax_too):
    """Against the reference's native block decoder on every shape, and
    against `ht_dec_jax.ht_decode_blocks` (bit-exact with it, one XLA
    compile per shape) on two."""
    from grokimagecompression_tpu.native import t1_native
    from grokimagecompression_tpu.ops import ht_dec_jax
    rng = np.random.default_rng(h * 100 + w)
    cases = _blocks(rng, h, w, dens, mbits, 4, mb=mb)
    cases.append((np.zeros((h, w), np.uint32), np.zeros((h, w), np.uint8),
                  mb))
    segs, lcups, scups = _segments(cases)
    blocks = [(s, w, h, mb - int(c[0].max()).bit_length())
              for s, c in zip(segs, cases)]
    want = [t1_native.ht_decode_cblk(*b) for b in blocks]
    if jax_too:
        for (wm, wn), (jm, jn) in zip(want, ht_dec_jax.ht_decode_blocks(
                blocks)):
            np.testing.assert_array_equal(jm, wm)
            np.testing.assert_array_equal(jn[wm > 0], wn[wm > 0])
    mags, signs = ht_dec.decode_group(*_words(segs, lcups, scups), w, h,
                                      _tables())
    assert mags.shape == (len(segs), 2 * ((h + 1) // 2), 4 * ((w + 3) // 4))
    for i, (wm, wn) in enumerate(want):
        np.testing.assert_array_equal(mags[i, :h, :w].numpy(), wm)
        sig = wm > 0
        np.testing.assert_array_equal(signs[i, :h, :w].numpy()[sig],
                                      wn[sig])
    assert int(mags.max()) < 1 << 31


def test_decode_group_validates_and_counts_no_launch():
    z = torch.zeros((32, 3), dtype=torch.int32)
    t = _tables()
    with pytest.raises(TypeError):
        ht_dec.decode_group(z.to(torch.int64), z, z, 4, 4, t)
    with pytest.raises(ValueError):
        ht_dec.decode_group(z, z[:, :2], z, 4, 4, t)
    with pytest.raises(ValueError):
        ht_dec.decode_group(z, z, z.T.contiguous().T, 4, 4, t)
    with pytest.raises(ValueError):
        ht_dec.decode_group(z, z, z, 4, 4, {"dec0": t["dec0"][:5],
                                            "dec1": t["dec1"]})
    before = dict(ht_dec.LAUNCHES)
    segs, lcups, scups = _segments(_blocks(np.random.default_rng(3), 4, 4,
                                           0.5, 5, 2))
    ht_dec.decode_group(*_words(segs, lcups, scups), 4, 4, t)
    assert ht_dec.LAUNCHES == before


def test_port_segments_equal_native_segments():
    """The `gpu` case's segment source, on the CPU: the port's encode
    stages give the native encoder's segments."""
    cases = _blocks(np.random.default_rng(5), 12, 20, 0.4, 9, 3, mb=12)
    assert _port_segments(cases, "cpu") == _segments(cases)


@pytest.mark.gpu
def test_cuda_decoder_matches_plain():
    """`decode_segments` on the card against the plain decoder of the
    prepass words on the card: segments of the port's HT encoder at
    several shapes (with the dummy segment), the raw-reader edge segments
    of `test_torch_ht_dec_raw.py` (0xFF before bytes above and below 0x8F,
    scup == lcup, 2-3-byte segments) decoded as 16x16 and 64x64 blocks,
    and one lane group whose segments sit past 2^31 bytes."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from test_torch_ht_dec_raw import _edge_segments
    dev = torch.device("cuda")
    rng = np.random.default_rng(11)
    tables = convert.dec_tables_from_reference(ht_tables._dec_tables(), dev)
    groups = []
    for (h, w, dens, mbits, mb, n) in [(64, 64, 0.3, 9, 12, 40),
                                       (64, 64, 0.01, 9, 12, 8),
                                       (32, 32, 0.4, 27, 28, 9),
                                       (16, 16, 0.5, 8, 10, 33),
                                       (5, 7, 0.6, 6, 10, 5),
                                       (4, 1024, 0.3, 8, 10, 3)]:
        segs, lcups, scups = _port_segments(
            _blocks(rng, h, w, dens, mbits, n, mb=mb), dev)
        groups.append((segs + [fused_decode.DUMMY_SEGMENT], scups + [2], w,
                       h, 0))
    edge, edge_scups = _edge_segments(np.random.default_rng(12), 60)
    groups += [(edge, edge_scups, 16, 16, 0), (edge, edge_scups, 64, 64, 0)]
    groups.append(groups[3][:4] + ((1 << 31) + 5,))
    for segs, scups, w, h, lead in groups:
        data, off, lcup, scup = (torch.from_numpy(a).to(dev) for a in
                                 ht_dec.pack_segments(segs, scups))
        if lead:      # the group's bytes behind `lead` others
            big = torch.zeros(lead + data.numel(), dtype=torch.uint8,
                              device=dev)
            big[lead:] = data
            data, off = big, off + lead
        before = ht_dec.LAUNCHES["dec"]
        got = ht_dec.decode_segments(data, off, lcup, scup, w, h, tables)
        torch.cuda.synchronize()
        assert ht_dec.LAUNCHES["dec"] == before + 1
        del data
        words = [a.to(dev) for a in _words(segs, [len(x) for x in segs],
                                           scups)]
        want = ht_dec_torch.decode_group_plain(*words, w, h, tables["dec0"],
                                               tables["dec1"])
        assert torch.equal(got[0], want[0]), f"{w}x{h} mags (lead {lead})"
        assert torch.equal(got[1], want[1]), f"{w}x{h} signs (lead {lead})"
