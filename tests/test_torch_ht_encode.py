"""HT encode stages of the torch port against the JAX reference.

`ht_torch.encode_streams` and `group_metrics` against
`ht_jax._encode_streams` and `_group_metrics` (lax.scan path) on the same
numpy blocks, and the segments the port's metrics and exactly placed
words assemble to against the native host coder
(`t1_native.ht_encode_cblk_batch`). Everything byte-identical.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from grokimagecompression_tpu.native import t1_native
from grokimagecompression_tpu.ops import ht_jax
from grokimagecompression_tpu_torch import convert
from grokimagecompression_tpu_torch.ops import ht_torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Torch on one thread: the plain versions run many small CPU ops, and
    under pytest-xdist's workers torch's OpenMP threads oversubscribe the
    cores and spin (a case of 2.4 s alone took 43 s among six workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _blocks(rng, n, h, w, mb, dens, zero_every=0):
    out = []
    for i in range(n):
        mag = rng.integers(0, 1 << mb, (h, w)).astype(np.uint32)
        mag = np.where(rng.random((h, w)) < dens, mag, 0).astype(np.uint32)
        if zero_every and i % zero_every == 0:
            mag[:] = 0
        neg = rng.integers(0, 2, (h, w)).astype(np.uint8)
        out.append((mag, neg, mb))
    return out


def _padded(blocks):
    h, w = blocks[0][0].shape
    qh, qw = (h + 1) // 2, (w + 1) // 2
    B = len(blocks)
    mag = np.zeros((B, 2 * qh, 2 * qw), np.uint32)
    neg = np.zeros((B, 2 * qh, 2 * qw), np.uint8)
    for i, (m, s, _) in enumerate(blocks):
        mag[i, :h, :w] = m
        neg[i, :h, :w] = s
    mbs = np.asarray([b[2] for b in blocks], np.int32)
    return mag, neg, mbs


# (B, h, w, Mb, density): odd quad width, odd sample dims, Mb > 14 (two
# MagSgn halves per sample), dense and sparse content, one-quad-row blocks
CASES = [
    (5, 16, 20, 10, 0.6),
    (4, 13, 10, 10, 0.3),
    (3, 12, 12, 20, 0.9),
    (6, 2, 14, 7, 0.5),
]


@pytest.mark.parametrize("B,h,w,mb,dens", CASES)
def test_encode_streams_and_metrics_match_jax(B, h, w, mb, dens):
    rng = np.random.default_rng(B * 1000 + h * 10 + w)
    blocks = _blocks(rng, B, h, w, mb, dens, zero_every=3)
    mag, neg, mbs = _padded(blocks)
    tables_np = ht_jax._tables()
    mbb = ht_jax._mb_bucket(mb)

    @jax.jit
    def ref(mag, neg, mbs):
        streams = ht_jax._encode_streams(jnp, jax, lax, mag, neg, mbs,
                                         tables_np, mbb)
        return streams, ht_jax._group_metrics(jnp, B, *streams)[0]

    want, want_metrics = ref(mag, neg, mbs)

    tables = convert.tables_from_reference(tables_np, "cpu")
    got = ht_torch.encode_streams(torch.from_numpy(mag.astype(np.int64)),
                                  torch.from_numpy(neg.astype(bool)),
                                  torch.from_numpy(mbs), tables, mbb)
    for name, w_stream, g_stream in zip(("mel", "vlc", "ms"), want, got):
        w_words, w_mask, w_state = w_stream
        np.testing.assert_array_equal(np.asarray(w_words),
                                      g_stream[0].numpy(), err_msg=name)
        np.testing.assert_array_equal(np.asarray(w_mask),
                                      g_stream[1].numpy(), err_msg=name)
        np.testing.assert_array_equal(
            np.stack([np.asarray(c) for c in w_state]),
            g_stream[2].numpy(), err_msg=name)

    metrics = ht_torch.group_metrics(B, *got)
    assert metrics.dtype == torch.int32
    assert metrics.shape == (B, ht_jax.NMETRICS)
    np.testing.assert_array_equal(np.asarray(want_metrics),
                                  metrics[:, :15].numpy())
    assert not metrics[:, 15].any()

    words = ht_torch.place_words([got])
    assert words.shape[0] == int((metrics[:, :3].numpy() >> 2).sum())
    segs = ht_jax.assemble_segments_host(words.numpy(), metrics.numpy())
    assert segs == t1_native.ht_encode_cblk_batch(blocks)


def test_place_words_two_groups_match_native():
    """Two shape groups placed into one buffer: group-major, lane-major."""
    rng = np.random.default_rng(9)
    groups = [_blocks(rng, 3, 8, 8, 9, 0.7, zero_every=2),
              _blocks(rng, 2, 6, 10, 16, 0.5)]
    tables = convert.tables_from_reference(ht_jax._tables(), "cpu")
    outs = []
    mets = []
    for blocks in groups:
        mag, neg, mbs = _padded(blocks)
        mbb = ht_jax._mb_bucket(int(mbs.max()))
        streams = ht_torch.encode_streams(
            torch.from_numpy(mag.astype(np.int64)),
            torch.from_numpy(neg.astype(bool)), torch.from_numpy(mbs),
            tables, mbb)
        outs.append(streams)
        mets.append(ht_torch.group_metrics(len(blocks), *streams))
    words = ht_torch.place_words(outs)
    segs = ht_jax.assemble_segments_host(words.numpy(),
                                         torch.cat(mets).numpy())
    assert segs == t1_native.ht_encode_cblk_batch(groups[0] + groups[1])


def test_bit_length_exact():
    x = np.concatenate([np.arange(0, 70), (1 << np.arange(32)) - 1,
                        1 << np.arange(32), [0xFFFFFFFF]]).astype(np.int64)
    got = ht_torch.bit_length(torch.from_numpy(x)).numpy()
    want = [int(v).bit_length() for v in x]
    np.testing.assert_array_equal(got, want)
