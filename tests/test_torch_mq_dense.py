"""The dense-output MQ scan of the torch port against the JAX reference.

`ops/mq_scan.run_mq_scans` / `run_mq_scans_blocked` are the counterparts
of `mq_jax.run_mq_scans` / `run_mq_scans_blocked`, the entry points of
the Pallas kernel `mq_scan_pallas.mq_scan_blocked`. On the CPU the port
runs its plain version (`mq_torch.mq_scan_dense_plain`) and the reference
its XLA form (`mq_jax._mq_scan_w`; the Pallas kernel has no interpret
switch), and every output must be equal exactly: the per-step words, the
mask or the chunk-local word index `m8`, the per-step byte-outs, and all
11 words of the final state. Inputs: random slot streams (skewed
decisions, so carries and 0xFF stuffing occur, and one all-passthrough
lane) and the slot streams of 16x16 code-blocks from `build_slot_stream`,
at B = 128, 200 (not a multiple of 128: flat form only) and 256, with T
across at least two 256-step chunks and lanes that end mid-word. The
words' bytes, in order, with the state's partial word, must also be the
plain compact coder's segment before its flush tail. The CUDA kernel is
held to the plain version on the card in `tests/test_torch_mq_scan.py`
(which, unlike this file, imports no JAX).

`_expand_tiles` is a numpy model of how the kernel (`csrc/mq_dense.cu`)
turns its compacted walk back into dense rows: per 128-row tile and lane,
one 32-bit vote per 32 rows marks the coding rows; the coder records, for
each of its coding steps, the byte-outs, the word completed and that
word's index in its 256-row chunk (a count carried from tile to tile and
reset every second tile); and row r of a lane takes the record whose
index is the lane's coding rows before its group plus the popcount of
the vote's bits below r. Fed the plain coder's per-step records
(`mq_torch.dense_steps`), it must rebuild the plain version's and the
reference's rows exactly.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax import lax

from grokimagecompression_tpu.ops import mq_jax
from grokimagecompression_tpu_torch.ops import mq_scan, mq_tables, mq_torch

from test_torch_mq_scan import _random_slots


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Torch on one thread: the plain versions run many small CPU ops, and
    under pytest-xdist's workers torch's OpenMP threads oversubscribe the
    cores and spin (a case of 2.4 s alone took 43 s among six workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _reference(slots, blocked):
    """The reference's dense scan of a (T, B) int8 stream, as numpy."""
    s = jnp.asarray(slots.numpy().astype(np.int32))
    if blocked:
        out = mq_jax.run_mq_scans_blocked(jnp, lax, s)
        return [np.asarray(a) for a in out]
    words, mask, nbo, st = mq_jax.run_mq_scans(jnp, lax, s, s.shape[1])
    return [np.asarray(words), np.asarray(mask), np.asarray(nbo),
            np.stack([np.asarray(a) for a in st])]


def _check(slots, blocked=False):
    """Port and reference equal on every output; returns the port's."""
    run = mq_scan.run_mq_scans_blocked if blocked else mq_scan.run_mq_scans
    got = run(slots)
    want = _reference(slots, blocked)
    names = ("words", "m8" if blocked else "mask", "nbo", "state")
    for name, g, w in zip(names, got, want):
        assert g.shape == w.shape, name
        np.testing.assert_array_equal(g.numpy(), w, err_msg=name)
    assert got[0].dtype == got[2].dtype == got[3].dtype == torch.int32
    assert got[1].dtype == (torch.int32 if blocked else torch.bool)
    return got


def _block_slots(B, h=16, w=16, seed=0):
    """Slot stream of B h x w code-blocks of natural-looking magnitudes
    (a smooth ramp plus noise, 1-5 bit-planes), all band orientations."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    amp = rng.integers(1, 12, (B, 1, 1))
    mag = (amp * (1 + np.sin(yy / 3.0 + rng.random((B, 1, 1)) * 6))
           + rng.integers(0, 4, (B, h, w))).astype(np.int32)
    mag[rng.random((B, h, w)) < 0.3] = 0
    mag[3] = 0                                   # an all-zero block
    neg = rng.random((B, h, w)) < 0.5
    mag_t = torch.from_numpy(mag)
    nbps = mq_torch.bit_planes(mag_t)
    return mq_torch.build_slot_stream(
        mag_t, torch.from_numpy(neg), torch.from_numpy(np.arange(B) % 4),
        nbps, int(nbps.max()))


def test_dense_state_layout_equals_reference():
    assert mq_tables.DENSE_NSTATE == mq_jax.NSTATE
    assert list(mq_tables.DENSE_STATE_INIT) == list(mq_jax.STATE_INIT)


@pytest.mark.parametrize("B", [128, 200, 256])
def test_random_streams_flat(B):
    slots = _random_slots(np.random.default_rng(B), 700, B)
    words, mask, nbo, state = _check(slots)
    assert mask[:256].any() and mask[256:512].any() and mask[512:].any()
    assert (state[5] > 0).any()                  # lanes end mid-word


def test_multi_byteout_steps():
    """Each lane codes one context, an LPS among long MPS runs: its
    probability estimate falls to the smallest Qe, so an LPS renormalises
    by up to 15 bits and some steps make two byte-outs, a word
    straddling them."""
    rng = np.random.default_rng(4)
    T, B = 6000, 128
    d = rng.random((T, B)) < rng.choice([0.001, 0.002, 0.005], (1, B))
    slots = torch.from_numpy((1 | (d.astype(np.int8) << 1)).astype(np.int8))
    words, mask, nbo, state = _check(slots)
    two = nbo >= 2
    assert two.any() and (mask & two).any()


@pytest.mark.parametrize("B", [128, 256])
def test_random_streams_blocked(B):
    slots = _random_slots(np.random.default_rng(B + 1), 700, B)
    words, m8, nbo, state = _check(slots, blocked=True)
    assert words.shape == (768, B // 128, 128)
    assert int(m8.max()) >= 1 and (m8[700:] == -1).all()


@pytest.mark.parametrize("B,blocked", [(200, False), (128, True)])
def test_code_block_streams(B, blocked):
    slots = _block_slots(B)
    assert slots.shape[0] >= 2 * 256
    got = _check(slots, blocked)
    state = got[3].reshape(mq_tables.DENSE_NSTATE, -1)
    assert (state[5] > 0).any()


def test_words_rebuild_the_compact_segments():
    """Per lane, the words' bytes in step order and then the state's
    partial word (wcnt bytes of wacc) are the plain compact coder's
    segment up to its flush tail."""
    slots = _block_slots(40, seed=5)
    words, mask, _, state = mq_scan.run_mq_scans(slots)
    data, lens, _ = mq_torch.mq_scan_plain(slots)
    ends = np.cumsum(lens.numpy())
    buf = data.numpy().tobytes()
    w_np, m_np, st = words.numpy(), mask.numpy(), state.numpy()
    for b in range(slots.shape[1]):
        got = w_np[m_np[:, b], b].astype("<i4").tobytes()
        got += (int(st[4, b]) & 0xFFFFFFFF).to_bytes(4, "little")[:st[5, b]]
        seg = buf[ends[b] - lens[b]:ends[b]]
        assert len(got) <= len(seg) and seg[:len(got)] == got, b


def test_wrappers_validate_and_count_no_launch_on_the_cpu():
    z = torch.zeros((300, 5), dtype=torch.int8)
    before = dict(mq_scan.LAUNCHES)
    words, mask, nbo, state = mq_scan.run_mq_scans(z)
    assert mq_scan.LAUNCHES == before
    assert not mask.any() and not words.any() and not nbo.any()
    assert state[:, 0].tolist() == list(mq_tables.DENSE_STATE_INIT)
    with pytest.raises(TypeError):
        mq_scan.run_mq_scans(z.to(torch.int32))
    with pytest.raises(ValueError):
        mq_scan.run_mq_scans_blocked(z)          # B % 128 != 0
    with pytest.raises(ValueError):
        mq_scan.scan_dense(z, 200)               # t_out < T


def _expand_tiles(slots, t_out, tile=128, chunk=256):
    """The kernel's tile expansion as numpy: (words, m8, nbo) (t_out, B)
    int32 from the plain coder's per-coding-step records and the per-32-row
    votes of each tile's coding rows."""
    emit = (slots.numpy() & 1).astype(bool)
    T, B = emit.shape
    rec_w, rec_full, rec_nbo, _ = (a.numpy() for a in mq_torch.dense_steps(
        mq_torch.emitting_slots(slots)))
    lanes = np.arange(B)
    words = np.zeros((t_out, B), np.int64)
    m8 = np.full((t_out, B), -1, np.int64)
    nbo = np.zeros((t_out, B), np.int64)
    done = np.zeros(B, np.int64)      # entries coded in earlier tiles
    wc = np.zeros(B, np.int64)        # words of the current chunk
    for t0 in range(0, t_out, tile):
        rows = np.zeros((tile, B), bool)
        n = max(0, min(tile, T - t0))
        rows[:n] = emit[t0:t0 + n]
        if t0 % chunk == 0:
            wc[:] = 0
        # the coder: each entry's chunk-local word index
        count = rows.sum(axis=0)
        idx = np.zeros((tile, B), np.int64)
        for e in range(int(count.max(initial=0))):
            k = np.minimum(done + e, max(rec_full.shape[0] - 1, 0))
            live = e < count
            idx[e] = wc
            wc += live & rec_full[k, lanes]
        # the expansion: votes of 32 rows, the entries before them
        bits = rows.reshape(tile // 32, 32, B).astype(np.uint64)
        votes = (bits << np.arange(32, dtype=np.uint64)[None, :, None]) \
            .sum(axis=1)
        ones = np.bitwise_count(votes).astype(np.int64)
        before = np.cumsum(ones, 0) - ones
        for r in range(min(tile, t_out - t0)):
            vote = votes[r // 32]
            coding = (vote >> np.uint64(r % 32)) & np.uint64(1) == 1
            below = vote & np.uint64((1 << (r % 32)) - 1)
            e = before[r // 32] + np.bitwise_count(below).astype(np.int64)
            k = np.where(coding, done + e, 0)
            full = coding & rec_full[k, lanes]
            nbo[t0 + r] = np.where(coding, rec_nbo[k, lanes], 0)
            words[t0 + r] = np.where(full, rec_w[k, lanes], 0)
            m8[t0 + r] = np.where(full, idx[np.minimum(e, tile - 1), lanes],
                                  -1)
        done += count
    return [np.where(a >= 1 << 31, a - (1 << 32), a).astype(np.int32)
            for a in (words, m8, nbo)]


@pytest.mark.parametrize("T,B,t_out", [
    (300, 5, 0),        # T off the 128-row tile, into a second chunk
    (300, 5, 512),      # no-op rows past T to the next 256
    (600, 33, 0),       # across two 256-row chunk boundaries
    (600, 33, 768),
])
def test_tile_expansion_model(T, B, t_out):
    """The numpy model of the kernel's expansion, on the plain coder's
    records, equals the plain dense scan and the reference's
    `mq_jax.run_mq_scans` (on the stream padded with no-op rows to
    t_out) on every row."""
    slots = _random_slots(np.random.default_rng(T + B + t_out), T, B)
    t_out = t_out or T
    got = _expand_tiles(slots, t_out)
    want = mq_torch.mq_scan_dense_plain(slots, t_out)
    for name, g, w in zip(("words", "m8", "nbo"), got, want):
        np.testing.assert_array_equal(g, w.numpy(), err_msg=name)
    padded = torch.cat([slots, torch.zeros((t_out - T, B), dtype=torch.int8)])
    ref = _reference(padded, blocked=False)
    np.testing.assert_array_equal(got[0], ref[0], err_msg="words")
    np.testing.assert_array_equal(got[1] >= 0, ref[1], err_msg="mask")
    np.testing.assert_array_equal(got[2], ref[2], err_msg="nbo")
    assert (got[1] >= 1).any()               # chunks of several words
    assert (got[1][T:] == -1).all() and not got[2][T:].any()
