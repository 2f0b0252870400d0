"""The port's HT cleanup encoder (`ops/ht_enc.py`) against the references.

`encode_segments(device="cpu")` runs the plain version
(`encode_segments_plain`: the torch op streams, the plain scans, the
metrics, the word placement and the host splice). On the same numpy
code-blocks its segments must equal, byte for byte:
- the reference's `ht_jax._encode_streams` -> `_group_metrics` ->
  `assemble_segments_host` under `jax.jit` on the CPU (the lax.scan
  scans), with the words placed lane by lane;
- the reference's native coder `t1_native.ht_encode_cblk_batch`, up to
  Mb 30 (it aligns magnitudes by shifts of 30 - Mb, which are undefined
  from Mb 31 up; the other two agree there).
Cases: odd sample dimensions and quad widths, one quad row, 8 x 512 and
512 x 8 blocks, Mb 7 / 14 / 15 / 20 / 30 / 31 (full-range int32 content
at 30 and 31), all-zero lanes, MagSgn content rich in 0xFF bytes, and
lanes on both sides of the MEL / VLC fuse rule.

The `gpu` case holds the CUDA kernel (`csrc/ht_enc.cu`) to the plain
version on the card at those shapes, with lane counts off the kernel's
CTA. JAX and the reference are imported inside the helpers, so the `gpu`
case also runs where only torch is installed.
"""

import numpy as np
import pytest
import torch

from grokimagecompression_tpu_torch.ops import ht_enc, ht_tables, ht_torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Torch on one thread: the plain versions run many small CPU ops, and
    under pytest-xdist's workers torch's OpenMP threads oversubscribe the
    cores and spin (a case of 2.4 s alone took 43 s among six workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# (B, h, w, Mb, density, content): "rand" magnitudes below 2^(Mb + 1),
# "full" full-range int32 samples, "ff" negative powers of two (MagSgn
# values of all ones: 0xFF bytes and their stuffing); lane 0 is all zero
CASES = [
    (5, 13, 10, 7, 0.6, "rand"),       # odd sample dims, odd quad width
    (4, 2, 14, 14, 0.5, "rand"),       # one quad row
    (3, 1, 9, 15, 0.7, "rand"),        # one sample row, odd width
    (4, 12, 12, 20, 0.9, "rand"),
    (2, 8, 512, 15, 0.4, "rand"),
    (2, 512, 8, 20, 0.4, "rand"),
    (4, 15, 17, 30, 0.5, "full"),
    (4, 16, 16, 31, 0.8, "full"),
    (5, 16, 16, 14, 0.7, "ff"),
    (4, 11, 9, 31, 0.9, "ff"),
    (6, 6, 8, 7, 0.05, "rand"),        # sparse: MEL-dominated lanes
]
# the cases of at most 300 samples a block (the plain scans step through
# every quad, and the wide cases take seconds)
SMALL = [c for c in CASES if c[1] * c[2] <= 300]


def _case(seed, B, h, w, mb, dens, kind):
    """(coeffs int32 (B, 2 qh, 2 qw), mbs int32 (B,)): lane 0 all zero,
    the last lane at Mb, the others at Mb - 3 .. Mb."""
    rng = np.random.default_rng(seed)
    H, W = 2 * ((h + 1) // 2), 2 * ((w + 1) // 2)
    co = np.zeros((B, H, W), np.int64)
    keep = rng.random((B, h, w)) < dens
    if kind == "rand":
        mag = rng.integers(0, 1 << min(mb + 1, 31), (B, h, w))
        co[:, :h, :w] = keep * mag * rng.choice([-1, 1], (B, h, w))
    elif kind == "full":
        co[:, :h, :w] = keep * rng.integers(-(1 << 31), 1 << 31, (B, h, w))
    else:
        k = rng.integers(0, min(mb, 30) + 1, (B, h, w))
        co[:, :h, :w] = -(keep * (np.int64(1) << k))
    co[0] = 0
    mbs = rng.integers(max(mb - 3, 0), mb + 1, B)
    mbs[-1] = mb
    return co.astype(np.int32), mbs.astype(np.int32), (h, w)


def _native_blocks(co, mbs, hw):
    h, w = hw
    x = co[:, :h, :w].astype(np.int64)
    return [(np.abs(x[i]).astype(np.uint32), (x[i] < 0).astype(np.uint8),
             int(mbs[i])) for i in range(len(mbs))]


def _split(data, lens):
    buf = data.cpu().numpy().tobytes()
    ends = np.cumsum(lens.cpu().numpy(), dtype=np.int64)
    return [buf[e - n:e] for e, n in zip(ends, lens.cpu().numpy())]


def _jax_segments(co, mbs):
    """The reference's lax.scan encode of one shape group, its metrics and
    its host splice, with each lane's MS, MEL and VLC words placed in
    turn."""
    import jax
    import jax.numpy as jnp
    from jax import lax

    from grokimagecompression_tpu.ops import ht_jax

    B = co.shape[0]
    mag = np.abs(co.astype(np.int64)).astype(np.uint32)
    neg = (co < 0).astype(np.uint8)
    mbb = ht_jax._mb_bucket(int(mbs.max()))
    tables = ht_jax._tables()

    @jax.jit
    def run(mag, neg, mbs):
        streams = ht_jax._encode_streams(jnp, jax, lax, mag, neg, mbs,
                                         tables, mbb)
        return streams, ht_jax._group_metrics(jnp, B, *streams)[0]

    (mel, vlc, ms), metrics = run(mag, neg, mbs)
    words = np.concatenate([np.asarray(s[0]) for s in (ms, mel, vlc)]).T
    mask = np.concatenate([np.asarray(s[1]) for s in (ms, mel, vlc)]).T
    metrics = np.concatenate([np.asarray(metrics),
                              np.zeros((B, 1), np.int32)], axis=1)
    return ht_jax.assemble_segments_host(words[mask], metrics)


def _tables():
    return ht_tables.device_tables(torch.device("cpu"))


@pytest.mark.parametrize("B,h,w,mb,dens,kind", CASES)
def test_plain_encoder_matches_jax_and_native(B, h, w, mb, dens, kind):
    from grokimagecompression_tpu.native import t1_native

    co, mbs, hw = _case(B * 100 + h + w + mb, B, h, w, mb, dens, kind)
    data, lens = ht_enc.encode_segments(torch.from_numpy(co),
                                        torch.from_numpy(mbs), _tables())
    assert data.dtype == torch.uint8 and lens.dtype == torch.int32
    assert lens.shape == (B,) and int(lens.sum()) == data.numel()
    got = _split(data, lens)
    assert got == [bytes(s) for s in _jax_segments(co, mbs)]
    if mb <= 30:
        assert got == [bytes(s) for s in t1_native.ht_encode_cblk_batch(
            _native_blocks(co, mbs, hw))]
    if kind == "ff":
        # MagSgn runs of all-ones values: many 0xFF bytes, each followed
        # by a stuffed 7-bit byte
        assert max(s.count(0xFF) for s in got) > 50


def test_fuse_rule_taken_and_not_taken():
    """Over the cases' lanes, the MEL / VLC fuse rule holds on some lanes
    with a pending MEL or VLC byte and fails on others (metrics columns
    9 nonzero and 10 fuse_ok of the plain version)."""
    seen = set()
    for i, (B, h, w, mb, dens, kind) in enumerate(SMALL):
        co, mbs, _ = _case(i, B, h, w, mb, dens, kind)
        mbs_t = torch.from_numpy(mbs)
        co_t = torch.from_numpy(co)
        streams = ht_torch.encode_streams(co_t.to(torch.int64).abs(),
                                          co_t < 0, mbs_t, _tables(),
                                          int(mbs.max()))
        m = ht_torch.group_metrics(B, *streams).numpy()
        seen |= {(int(a), int(b)) for a, b in m[:, 9:11]}
    assert (1, 1) in seen and (1, 0) in seen


def test_wrapper_validates_and_counts_no_launch():
    t = _tables()
    co = torch.zeros((3, 4, 6), dtype=torch.int32)
    mbs = torch.full((3,), 9, dtype=torch.int32)
    before = dict(ht_enc.LAUNCHES)
    data, lens = ht_enc.encode_segments(co, mbs, t)
    assert ht_enc.LAUNCHES == before
    assert lens.tolist() == [len(s) for s in _split(data, lens)]
    data, lens = ht_enc.encode_segments(co[:0], mbs[:0], t)
    assert data.shape == (0,) and lens.shape == (0,)
    with pytest.raises(TypeError):
        ht_enc.encode_segments(co.to(torch.int64), mbs, t)
    with pytest.raises(TypeError):
        ht_enc.encode_segments(co, mbs.to(torch.int64), t)
    with pytest.raises(ValueError):
        ht_enc.encode_segments(co[:, :3], mbs, t)                # odd rows
    with pytest.raises(ValueError):
        ht_enc.encode_segments(co[0], mbs, t)                    # not 3-D
    with pytest.raises(ValueError):
        ht_enc.encode_segments(torch.zeros((1, 64, 66), dtype=torch.int32),
                               mbs[:1], t)                       # > 4096
    with pytest.raises(ValueError):
        ht_enc.encode_segments(co, mbs[:2], t)
    with pytest.raises(ValueError):
        ht_enc.encode_segments(co.transpose(1, 2), mbs, t)       # strided
    with pytest.raises(ValueError):
        ht_enc.encode_segments(co, torch.tensor([9, -1, 9],
                                                dtype=torch.int32), t)
    with pytest.raises(ValueError):
        ht_enc.encode_segments(co, mbs, dict(t, enc_packed=t["enc0"]))
    with pytest.raises(ValueError):
        ht_enc.encode_segments(co.to("meta"), mbs.to("meta"), t)
    assert ht_enc.LAUNCHES == before


def test_lane_bounds_cover_worst_lanes():
    """`lane_bounds` holds the longest segments the cases give (the
    kernel writes in place into regions of that size)."""
    for i, (B, h, w, mb, dens, kind) in enumerate(SMALL):
        co, mbs, _ = _case(i + 50, B, h, w, mb, 1.0, kind)
        _, lens = ht_enc.encode_segments(torch.from_numpy(co),
                                         torch.from_numpy(mbs), _tables())
        bound = ht_enc.lane_bounds(mbs, co.shape[1] // 2, co.shape[2] // 2)
        assert (lens.numpy() <= bound).all()


@pytest.mark.gpu
def test_cuda_encoder_matches_plain():
    """`encode_segments` on the card against the plain version on the same
    card tensors: every case above, lane counts off the CTA (the first
    cases' lanes, and 2 x 64 + 3 lanes of 64 x 64 blocks at Mb 12 and 31),
    each call one launch."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda")
    t = ht_tables.device_tables(dev)
    cases = [(i,) + c for i, c in enumerate(CASES)]
    cases += [(90, 131, 64, 64, 12, 0.8, "rand"),
              (91, 67, 64, 64, 31, 1.0, "full"),
              (92, 33, 32, 32, 14, 0.7, "ff")]
    for seed, B, h, w, mb, dens, kind in cases:
        co, mbs, _ = _case(seed, B, h, w, mb, dens, kind)
        co_t = torch.from_numpy(co).to(dev)
        mbs_t = torch.from_numpy(mbs).to(dev)
        before = ht_enc.LAUNCHES["enc"]
        got = ht_enc.encode_segments(co_t, mbs_t, t)
        torch.cuda.synchronize()
        assert ht_enc.LAUNCHES["enc"] == before + 1
        want = ht_enc.encode_segments_plain(co_t, mbs_t, t)
        assert torch.equal(got[1], want[1]), (B, h, w, mb, kind)
        assert torch.equal(got[0], want[0]), (B, h, w, mb, kind)
    empty = ht_enc.encode_segments(co_t[:0], mbs_t[:0], t)
    assert empty[0].numel() == 0 and empty[1].numel() == 0


@pytest.mark.gpu
def test_cuda_fused_ht97_encoder_matches_cpu():
    """`FusedHTEncoder` on a small 9/7 RGB frame (ICT, 4 resolutions,
    32 x 32 blocks): on the card, `forward` and the step search's probe
    `segment_totals` (frames picked, each at its own base step) against
    the same module on the CPU, which runs the plain encoder; the card's
    calls launch the kernel once a shape group, the probe and the
    encode alike."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from grokimagecompression_tpu_torch.codestream import encoder
    from grokimagecompression_tpu_torch.codestream.tile import default_qcd
    from grokimagecompression_tpu_torch.core.geometry import tile_rect
    from grokimagecompression_tpu_torch.core.image import Component, Image
    from grokimagecompression_tpu_torch.core.params import (EncoderParams,
                                                            Transform)
    from grokimagecompression_tpu_torch.models import fused_encode

    rng = np.random.default_rng(12)
    yy, xx = np.mgrid[0:72, 0:80]
    frames = [np.stack([(128 + 60 * np.sin(yy / 9.0 + f + c)
                         * np.cos(xx / 7.0) + rng.integers(0, 24, (72, 80)))
                        .clip(0, 255).astype(np.uint8) for c in range(3)])
              for f in range(2)]
    img = Image(xsiz=80, ysiz=72, components=[Component(
        data=frames[0][c].astype(np.int32), prec=8, signed=False, dx=1,
        dy=1) for c in range(3)])
    params = EncoderParams(numresolutions=4, transform=Transform.DWT_97,
                           cblk_style=0x40, cblk_w_exp=5, cblk_h_exp=5)
    siz, cod = encoder.build_siz(img, params), encoder.build_cod(img, params)
    tr = tile_rect(0, siz.xsiz, siz.ysiz, siz.xosiz, siz.yosiz, siz.xtsiz,
                   siz.ytsiz, siz.xtosiz, siz.ytosiz)

    def plan_at(step):
        return fused_encode.build_plan(siz, cod,
                                       default_qcd(siz, cod, 1, step), tr)

    outs = []
    for dev in (torch.device("cpu"), torch.device("cuda")):
        enc = fused_encode.FusedHTEncoder(plan_at(0.0),
                                          ht_tables.device_tables(dev))
        comps = [torch.from_numpy(np.stack([f[c] for f in frames])).to(dev)
                 for c in range(3)]
        before = ht_enc.LAUNCHES["enc"]
        lens, data = enc(*comps)
        blocks = enc.gather(enc.transform(*comps))
        lanes = [enc.lanes(plan_at(s)) for s in (0.37, 6.5)]
        totals = enc.segment_totals(blocks, [1, 0], lanes)
        one = enc.segment_totals(blocks, [1], lanes[:1])
        launches = ht_enc.LAUNCHES["enc"] - before
        outs.append((lens.cpu(), data.cpu(), totals.cpu(), one.cpu(),
                     launches))
    (cpu_lens, cpu_data, cpu_tot, cpu_one, _), \
        (lens, data, tot, one, launches) = outs
    assert torch.equal(lens, cpu_lens) and torch.equal(data, cpu_data)
    assert torch.equal(tot, cpu_tot) and torch.equal(one, cpu_one)
    assert one[0] == tot[0] and tot[0] > tot[1] > 0
    assert launches == 3 * len(plan_at(0.0).groups)
