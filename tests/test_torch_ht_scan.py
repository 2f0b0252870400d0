"""HT stream scans of the torch port against the JAX reference.

The plain torch `mel_scan` / `vlc_scan` / `ms_scan` (what the wrappers run
for CPU tensors) must give the same words, valid mask and final state as
the reference's lax.scan versions `ht_jax._mel_scan_w` / `_vlc_scan_w` /
`_ms_scan_w`, which share their step bodies with the Pallas kernels.
The scans are part of the plain HT encoder; on the card the encoder is
one kernel (`csrc/ht_enc.cu`, tested in `tests/test_torch_ht_enc.py`),
and a scan wrapper given a tensor off the CPU raises.
"""

import numpy as np
import pytest
import torch

from grokimagecompression_tpu_torch.ops import ht_enc, ht_scan


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Torch on one thread: the plain versions run many small CPU ops, and
    under pytest-xdist's workers torch's OpenMP threads oversubscribe the
    cores and spin (a case of 2.4 s alone took 43 s among six workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_scan(kind, a, b):
    import jax.numpy as jnp
    from jax import lax

    from grokimagecompression_tpu.ops import ht_jax

    fn = {"mel": ht_jax._mel_scan_w, "vlc": ht_jax._vlc_scan_w,
          "ms": ht_jax._ms_scan_w}[kind]
    words, mask, carry = fn(jnp, lax, jnp.asarray(a), jnp.asarray(b),
                            a.shape[1])
    return (np.asarray(words), np.asarray(mask),
            np.stack([np.asarray(c) for c in carry]))


def _mel_ops(rng, T, B):
    """MEL events: sparse and dense regions, long runs of 0 bits (run
    growth) and of 1 bits, T padded up to a multiple of 4 with invalid
    events as the encoder pads."""
    valid = (rng.random((T, B)) < 0.7).astype(np.int32)
    p1 = rng.choice([0.02, 0.3, 0.95], size=(1, B))
    bit = (rng.random((T, B)) < p1).astype(np.int32)
    pad = -T % 4
    return (np.pad(valid, ((0, pad), (0, 0))),
            np.pad(bit, ((0, pad), (0, 0))))


def _append_ops(rng, T, B):
    """(val, len) appends of <= 16 bits with val < 2**len; a third of the
    rows are all-ones (0xFF byte runs that force bit stuffing) and some
    are empty."""
    lens = rng.integers(0, 17, (T, B)).astype(np.int32)
    vals = rng.integers(0, 1 << 16, (T, B)).astype(np.int64)
    ones = rng.random((T, B)) < 0.33
    vals = np.where(ones, (1 << 16) - 1, vals)
    lens = np.where(ones & (rng.random((T, B)) < 0.5), 16, lens)
    vals = vals & ((1 << lens.astype(np.int64)) - 1)
    return vals.astype(np.int32), lens


SHAPES = [(1, 61), (7, 130), (33, 257)]   # (B, T): B = 1, B odd, T % 4 != 0


@pytest.mark.parametrize("B,T", SHAPES)
@pytest.mark.parametrize("kind", ["mel", "vlc", "ms"])
def test_plain_scan_matches_jax(kind, B, T):
    rng = np.random.default_rng(1000 * B + T)
    a, b = (_mel_ops if kind == "mel" else _append_ops)(rng, T, B)
    want = _jax_scan(kind, a, b)
    scan = {"mel": ht_scan.mel_scan, "vlc": ht_scan.vlc_scan,
            "ms": ht_scan.ms_scan}[kind]
    got = scan(torch.from_numpy(a), torch.from_numpy(b))
    assert got[0].dtype == torch.int32 and got[2].dtype == torch.int32
    assert got[1].dtype == torch.bool
    for name, w, g in zip(("words", "mask", "state"), want, got):
        np.testing.assert_array_equal(w, g.numpy(), err_msg=name)
    # the stuffing paths were exercised: some word was emitted
    assert got[1].any()


def test_scan_wrappers_validate_inputs():
    z = torch.zeros((8, 3), dtype=torch.int32)
    with pytest.raises(TypeError):
        ht_scan.vlc_scan(z.to(torch.int64), z.to(torch.int64))
    with pytest.raises(ValueError):
        ht_scan.ms_scan(z, z[:4])
    with pytest.raises(ValueError):
        ht_scan.mel_scan(z[:6], z[:6])            # T % 4 != 0
    with pytest.raises(ValueError):
        ht_scan.vlc_scan(z.T, z.T)                # not contiguous


@pytest.mark.parametrize("kind", ["mel", "vlc", "ms"])
def test_scan_wrappers_raise_off_the_cpu(kind):
    """No op stream reaches a scan on a device: there the HT encoder is
    one kernel, so a wrapper given a tensor off the CPU raises."""
    z = torch.zeros((8, 3), dtype=torch.int32, device="meta")
    scan = getattr(ht_scan, f"{kind}_scan")
    with pytest.raises(ValueError, match="CPU tensors only"):
        scan(z, z)


def test_plain_scan_counts_no_launch():
    before = dict(ht_enc.LAUNCHES)
    a, b = _append_ops(np.random.default_rng(3), 16, 5)
    ht_scan.ms_scan(torch.from_numpy(a), torch.from_numpy(b))
    assert ht_enc.LAUNCHES == before
