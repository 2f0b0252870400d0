"""The MQ scan of the torch port: wrapper checks here, the kernel on the card.

`ops/mq_scan.mq_scan` runs `csrc/mq_scan.cu` for CUDA tensors and the
plain version `ops/mq_torch.mq_scan_plain` for CPU tensors. The `gpu`
case holds the kernel against the plain version on the card, on random
slot streams with one all-passthrough lane: every lane's segment bytes,
lengths and end-of-scan state must be equal, and with pass spans given
the byte-outs at every pass end too; and the dense-output scan
(`mq_scan.scan_dense`, `csrc/mq_dense.cu`) must equal its plain version
on every step's word, word index and byte-outs and on the 11-word state,
with t_out = T and with no-op rows past T. The kernel's cases
reach what its tiles and per-lane compaction treat specially: lanes with
no coding slot, passes with none, coding slots clustered at tile and pass
boundaries, streams that are not a whole number of tiles, lane counts
that are not a whole number of blocks, and a stream that starts off the
8-byte alignment. The plain coder is held to the JAX reference and the
Annex-D oracle at awkward block shapes in
`tests/test_torch_mq_redesign_parity.py`. The plain versions
themselves are held to the reference in `tests/test_torch_mq_encode.py`,
(pass-end byte-outs) `tests/test_torch_rd_encode.py` and (dense scan)
`tests/test_torch_mq_dense.py`.
"""

import numpy as np
import pytest
import torch

from grokimagecompression_tpu_torch.ops import mq_scan, mq_torch
from grokimagecompression_tpu_torch.ops.mq_tables import NSTATE, NUM_CTXS


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Torch on one thread: the plain versions run many small CPU ops, and
    under pytest-xdist's workers torch's OpenMP threads oversubscribe the
    cores and spin (a case of 2.4 s alone took 43 s among six workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _random_slots(rng, T, B):
    """Slot bytes emit | d << 1 | cx << 2 with per-lane emit densities
    from sparse to dense, skewed decisions (long MPS runs and LPS bursts,
    so carries and 0xFF stuffing occur), and lane 1 all passthrough
    (emit = 0 with d and cx bits set)."""
    emit = rng.random((T, B)) < rng.choice([0.02, 0.1, 0.5, 1.0], (1, B))
    emit[:, 1 % B] = False
    d = rng.random((T, B)) < rng.choice([0.05, 0.5, 0.95], (1, B))
    cx = rng.integers(0, NUM_CTXS, (T, B))
    slots = emit.astype(np.int64) | (d.astype(np.int64) << 1) | (cx << 2)
    return torch.from_numpy(slots.astype(np.int8))


def test_wrapper_validates_inputs():
    z = torch.zeros((8, 3), dtype=torch.int8)
    with pytest.raises(TypeError):
        mq_scan.mq_scan(z.to(torch.int32))
    with pytest.raises(ValueError):
        mq_scan.mq_scan(z[0])
    with pytest.raises(ValueError):
        mq_scan.mq_scan(z.T)


def test_pass_spans_must_tile_the_stream():
    z = torch.zeros((768, 2), dtype=torch.int8)
    with pytest.raises(ValueError):
        mq_scan.mq_scan(z, (256, 256, 512))      # 768 is not whole planes
    with pytest.raises(ValueError):
        mq_scan.mq_scan(z, (128, 128, 512))      # not 256-slot aligned
    *_, cumbo = mq_scan.mq_scan(z, (256, 256, 256))
    assert cumbo.shape == (3, 2) and not cumbo.any()


def test_lane_emits_in_blocks(monkeypatch):
    """The per-lane count of emitting slots, summed in row blocks (here
    of 1 to 7 rows, ending mid-block), equals the whole-stream sum."""
    slots = _random_slots(np.random.default_rng(5), 300, 7)
    want = (slots & 1).sum(dim=0)
    for block in (9 * 7, 9 * 7 * 4, 9 * 7 * 7, 1):
        monkeypatch.setattr(mq_scan, "EMIT_BLOCK_BYTES", block)
        assert torch.equal(mq_scan.lane_emits(slots), want)


def test_plain_scan_counts_no_launch_and_keeps_the_contract():
    before = dict(mq_scan.LAUNCHES)
    slots = _random_slots(np.random.default_rng(3), 300, 5)
    data, lens, state = mq_scan.mq_scan(slots)
    assert mq_scan.LAUNCHES == before
    assert data.dtype == torch.uint8 and data.shape == (int(lens.sum()),)
    assert lens.dtype == torch.int32 and lens.shape == (5,)
    assert state.dtype == torch.int32 and state.shape == (NSTATE, 5)
    # the passthrough lane ends in the initial state and flushes to the
    # segment of an empty coder
    init = mq_torch.init_state(1, "cpu")
    want = torch.cat([torch.stack(init[:4]),
                      mq_torch.pack_contexts(init[4])])[:, 0]
    assert torch.equal(state[:, 1], want.to(torch.int32))


def _clustered_slots(rng, T, B, rows):
    """Slots that code only at `rows` (in every lane but lane 2, which
    never codes), and lane 3 coding nowhere in rows 300 .. 1100."""
    slots = np.zeros((T, B), np.int64)
    for t in rows:
        slots[t] = 1 | (rng.integers(0, 2, B) << 1) \
            | (rng.integers(0, NUM_CTXS, B) << 2)
    slots[:, 2] = 0
    slots[300:1100, 3] = 0
    return torch.from_numpy(slots.astype(np.int8))


def _misaligned(slots: torch.Tensor, shift: int) -> torch.Tensor:
    """A copy of `slots` whose data starts `shift` bytes past an aligned
    address."""
    T, B = slots.shape
    buf = torch.zeros(T * B + shift, dtype=torch.int8, device=slots.device)
    buf[shift:] = slots.reshape(-1)
    return buf[shift:].view(T, B)


@pytest.mark.gpu
def test_cuda_kernel_matches_plain():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda")
    rng = np.random.default_rng(7)
    # the kernel's tiles (128 rows) and blocks (4 lanes): T and B on and
    # off them
    cases = [_random_slots(rng, T, B) for T, B in (
        (2048, 2017), (1000, 33), (513, 9), (1, 3), (1536, 8), (700, 5))]
    cases.append(_misaligned(_random_slots(rng, 600, 13).to(dev), 3))
    cases.append(_clustered_slots(rng, 1100, 11, list(range(505, 519))
                                  + list(range(1020, 1030)) + [1099]))
    for slots in cases:
        slots = slots.to(dev)
        T, B = slots.shape
        before = mq_scan.LAUNCHES["mq"]
        got = mq_scan.mq_scan(slots)
        torch.cuda.synchronize()
        assert mq_scan.LAUNCHES["mq"] == before + 1
        want = mq_torch.mq_scan_plain(slots)
        for name, w, g in zip(("data", "lens", "state"), want, got):
            assert torch.equal(w, g), f"T={T} B={B}: {name}"


@pytest.mark.gpu
def test_cuda_pass_byteouts_match_plain():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda")
    rng = np.random.default_rng(9)
    spans = (256, 512, 512)
    # coding slots clustered at tile ends (128 k) and pass ends (256,
    # 768, 1280, ...), passes in which lanes 2 and 3 code nothing
    clustered = _clustered_slots(
        rng, 3 * 1280, 11, list(range(0, 5)) + list(range(250, 262))
        + list(range(506, 518)) + list(range(763, 770))
        + list(range(1279, 1285)) + list(range(2550, 2565)) + [3 * 1280 - 1])
    for slots in (_random_slots(rng, 3 * 1280, 70), clustered):
        slots = slots.to(dev)
        got = mq_scan.mq_scan(slots, spans)
        torch.cuda.synchronize()
        want = mq_torch.mq_scan_plain(slots, spans)
        for name, w, g in zip(("data", "lens", "state", "cumbo"), want,
                              got):
            assert torch.equal(w, g), f"B={slots.shape[1]}: {name}"


def _skewed_slots(rng, T, B):
    """Every lane codes one context, an LPS among long MPS runs: its
    estimate falls to the smallest Qe, so an LPS renormalises by up to 15
    bits and some steps make two or three byte-outs."""
    d = rng.random((T, B)) < rng.choice([0.001, 0.002, 0.005], (1, B))
    return torch.from_numpy((1 | (d.astype(np.int8) << 1)).astype(np.int8))


# the dense kernel's cases: lane counts on and off its blocks (up to 64
# lanes), a stream off the 8-byte alignment, coding slots clustered at
# tile and chunk ends, steps of several byte-outs
_DENSE_CASES = {
    "B1": lambda rng: _random_slots(rng, 700, 1),
    "B5": lambda rng: _random_slots(rng, 700, 5),
    "B33": lambda rng: _random_slots(rng, 1000, 33),
    "B2017": lambda rng: _random_slots(rng, 2048, 2017),
    "misaligned": lambda rng: _random_slots(rng, 600, 13),
    "clustered": lambda rng: _clustered_slots(
        rng, 1100, 11, list(range(120, 136)) + list(range(250, 262))
        + list(range(505, 519)) + list(range(1020, 1030)) + [1099]),
    "multi_byteout": lambda rng: _skewed_slots(rng, 3000, 40),
}


@pytest.mark.gpu
@pytest.mark.parametrize("pad", [False, True], ids=["t_out=T", "t_out=256k"])
@pytest.mark.parametrize("case", list(_DENSE_CASES))
def test_cuda_dense_kernel_matches_plain(case, pad):
    """The dense scan (`csrc/mq_dense.cu`) equals its plain version on
    every step's word, word index and byte-outs and on the 11-word state,
    over t_out = T rows or no-op rows up to the next 256 past T; one
    counted launch."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda")
    slots = _DENSE_CASES[case](np.random.default_rng(11)).to(dev)
    if case == "misaligned":
        slots = _misaligned(slots, 3)
        assert slots.data_ptr() % 8 == 3
    T, B = slots.shape
    t_out = T + 256 - T % 256 if pad else T
    before = mq_scan.LAUNCHES["mq_dense"]
    got = mq_scan.scan_dense(slots, t_out)
    torch.cuda.synchronize()
    assert mq_scan.LAUNCHES["mq_dense"] == before + 1
    want = mq_torch.mq_scan_dense_plain(slots, t_out)
    for name, w, g in zip(("words", "m8", "nbo", "state"), want, got):
        assert torch.equal(w, g), f"{case}, t_out={t_out}: {name}"
    if case == "multi_byteout":
        assert (got[2] >= 2).any()
