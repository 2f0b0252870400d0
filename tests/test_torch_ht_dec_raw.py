"""The HT decoder on raw segments (`ops/ht_dec.decode_segments`).

- A step-faithful model of the CUDA kernel's three stream readers
  (`csrc/ht_dec.cu`: aligned word loads two words ahead, the 64-bit
  window refilled below 32 bits, four plain bytes at once or byte by
  byte, each stream's unstuffing with the whole-byte OR of a stuffed
  byte, the pad past the end) against the host prepass
  (`native/ht_prepass.ht_dec_prepass`) bit for bit: at every read
  position of a walk with the kernel's read sizes, the model's 32-bit
  window equals the prepass words' fetch at that bit offset. Segments
  carry 0xFF before bytes above and below 0x8F, scup == lcup, 2- and
  3-byte segments and the dummy segment.
- `decode_segments` on the CPU (the prepass, then the plain decoder)
  against the reference's `ht_dec_jax.ht_decode_blocks` and its jitted
  `decode_group_core`, exactly, on segments of the reference's native
  encoder: random magnitudes, all-zero blocks, 4x4, 8x64 and 64x8 blocks.
- The CPU decode route keeps the prepass (its calls are counted); the
  `gpu` case in `tests/test_torch_ht_dec.py` holds the kernel to the plain
  version on these segments.
"""

import numpy as np
import pytest
import torch

from grokimagecompression_tpu_torch import convert
from grokimagecompression_tpu_torch.models import fused_decode
from grokimagecompression_tpu_torch.native import ht_prepass
from grokimagecompression_tpu_torch.ops import ht_dec, ht_tables


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Torch on one thread: the plain versions run many small CPU ops, and
    under pytest-xdist's workers torch's OpenMP threads oversubscribe the
    cores and spin (a case of 2.4 s alone took 43 s among six workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


M64 = (1 << 64) - 1


def _simd_eq4(x: int, y: int) -> bool:
    """`__vcmpeq4(x, y) != 0`: some byte of x equals y's byte there."""
    return any(((x >> k) & 0xFF) == ((y >> k) & 0xFF) for k in (0, 8, 16, 24))


class Bytes:
    """`Bytes<kBack>` of the kernel: a stream's bytes in stream order from
    aligned little-endian words of `buf`, n of them from byte `p`
    (backward: p, p - 1, ...), then `pad`; `raw` holds 4-8 upcoming
    bytes, `q0` and `q1` the two words after them."""

    def __init__(self, buf: bytes, p: int, n: int, pad: int, back: bool):
        self.buf, self.back, self.pad = buf, back, pad
        self.wa = p >> 2                  # the first byte's aligned word
        j = p & 3
        skip = 3 - j if back else j
        self.nw = 0
        if n > 0:
            self.nw = (self.wa - ((p - n + 1) >> 2) + 1 if back
                       else (j + n + 3) >> 2)
        self.left = n
        self.raw = self.load(0) >> (8 * skip)
        self.nraw = 4 - skip
        self.raw |= self.load(1) << (8 * self.nraw)
        self.nraw += 4
        self.q0, self.q1 = self.load(2), self.load(3)
        self.wi = 3

    def load(self, k: int) -> int:
        if k >= self.nw:
            return 0
        a = 4 * (self.wa - k if self.back else self.wa + k)
        word = int.from_bytes(self.buf[a:a + 4].ljust(4, b"\0"), "little")
        if self.back:
            word = int.from_bytes(word.to_bytes(4, "little"), "big")
        return word

    def advance(self):
        self.raw |= self.q0 << (8 * self.nraw)
        self.nraw += 4
        self.q0 = self.q1
        self.wi += 1
        self.q1 = self.load(self.wi)
        assert 4 <= self.nraw <= 8 and self.raw < 1 << 64

    def take(self) -> int:
        if self.left <= 0:
            return self.pad
        d = self.raw & 0xFF
        self.raw >>= 8
        self.left -= 1
        self.nraw -= 1
        if self.nraw < 4:
            self.advance()
        return d

    def peek4(self) -> int:
        return self.raw & 0xFFFFFFFF

    def take4(self):
        assert self.left >= 4
        self.raw >>= 32
        self.left -= 4
        self.nraw -= 4
        self.advance()


class LsbReader:
    """`MsReader` (forward, 7 bits after 0xFF, pad 0xFF) or `VlcReader`
    (backward after the nibble, 7 bits for a byte of low bits 0x7F after
    a byte above 0x8F, pad 0x00): below 32 bits, four plain bytes at once,
    the pad at once, else byte by byte."""

    def __init__(self, buf: bytes, base: int, lcup: int, scup: int,
                 vlc: bool):
        self.vlc = vlc
        if vlc:
            d0 = buf[base + lcup - 2]
            self.win = d0 >> 4
            self.nbits = 4 - (1 if (self.win & 7) == 7 else 0)
            self.unstuff = (d0 | 0xF) > 0x8F
            self.src = Bytes(buf, base + lcup - 3, scup - 2, 0, True)
        else:
            self.win, self.nbits, self.unstuff = 0, 0, False
            self.src = Bytes(buf, base, lcup - scup, 0xFF, False)
        self.fill()

    def fill(self):
        if self.nbits >= 32:
            return
        x = self.src.peek4()
        plain = (not _simd_eq4(x & 0x7F7F7F7F, 0x7F7F7F7F) if self.vlc
                 else not self.unstuff and not _simd_eq4(x, 0xFFFFFFFF))
        if self.src.left >= 4 and plain:
            self.win |= x << self.nbits
            self.nbits += 32
            if self.vlc:
                self.unstuff = (x >> 24) > 0x8F
            self.src.take4()
            return
        if self.src.left <= 0:           # the pad
            if not self.vlc:
                self.win |= (M64 << self.nbits) & M64
            self.nbits = 64
            return
        while self.nbits < 32:
            d = self.src.take()
            self.win |= d << self.nbits
            if self.vlc:
                self.nbits += 7 if self.unstuff and (d & 0x7F) == 0x7F \
                    else 8
                self.unstuff = d > 0x8F
            else:
                self.nbits += 7 if self.unstuff else 8
                self.unstuff = d == 0xFF
        assert self.win <= M64

    def peek(self) -> int:
        return self.win & 0xFFFFFFFF

    def skip(self, c: int):
        while c > self.nbits:          # MagSgn only, on corrupt streams
            c -= self.nbits
            self.win >>= self.nbits
            self.nbits = 0
            self.fill()
        self.win >>= c
        self.nbits -= c
        self.fill()


class MelReader:
    """`MelReader`: forward over scup - 1 bytes from lcup - scup, the last
    with its low nibble forced to 0xF, MSB first, a byte after 0xFF
    deposited one bit early (7 new bits), pad 0xFF; below 32 bits, byte
    by byte to 57-64."""

    def __init__(self, buf: bytes, base: int, lcup: int, scup: int):
        self.src = Bytes(buf, base + lcup - scup, scup - 1, 0xFF, False)
        self.win, self.nbits, self.unstuff = 0, 0, False
        self.fill()

    def fill(self):
        if self.nbits >= 32:
            return
        while self.nbits <= 56:
            last = self.src.left == 1
            d = self.src.take() | (0xF if last else 0)
            s = self.nbits - 1 if self.unstuff else self.nbits
            self.win = (self.win | (d << (56 - s))) & M64
            self.nbits += 7 if self.unstuff else 8
            self.unstuff = d == 0xFF

    def peek(self) -> int:
        return self.win >> 32

    def skip(self, c: int):
        self.win = (self.win << c) & M64
        self.nbits -= c
        self.fill()


def _fetch(words: np.ndarray, lane: int, off: int, msb: bool) -> int:
    """`ht_dec_torch.fetch_lsb` / `fetch_msb` on one lane of prepass
    words: 32 bits at bit offset `off`, the word index clamped to W - 2."""
    col = words[:, lane].astype(np.uint64)
    wi = min(off >> 5, words.shape[0] - 2)
    sh = off & 31
    w0, w1 = int(col[wi]), int(col[wi + 1])
    if msb:
        return ((w0 << sh) & 0xFFFFFFFF) | ((w1 >> (32 - sh)) if sh else 0)
    return (w0 >> sh) | (((w1 << (32 - sh)) & 0xFFFFFFFF) if sh else 0)


def _edge_segments(rng, n):
    """Segments with 0xFF before bytes above and below 0x8F, 0x7F-tailed
    bytes, lengths 2 and 3 among them, scup anywhere in [2, lcup]
    (scup == lcup included), and the dummy segment."""
    menu = np.array([0xFF, 0xFF, 0xFF, 0x7F, 0xFF, 0x80, 0x8F, 0x90, 0xFE,
                     0x00, 0x0F, 0xF0], np.uint8)
    segs, scups = [fused_decode.DUMMY_SEGMENT], [2]
    for i in range(n):
        lcup = int(rng.choice([2, 3, 4, 5, 9, 17, 40, 130]))
        pick = rng.random(lcup) < 0.6
        seg = np.where(pick, menu[rng.integers(0, len(menu), lcup)],
                       rng.integers(0, 256, lcup)).astype(np.uint8)
        scup = (lcup if i % 4 == 0 else 2 if i % 4 == 1
                else int(rng.integers(2, lcup + 1)))
        segs.append(seg.tobytes())
        scups.append(scup)
    return segs, scups


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_register_readers_equal_prepass(seed):
    rng = np.random.default_rng(seed)
    segs, scups = _edge_segments(rng, 40)
    data, off, lcups, scups_a = ht_dec.pack_segments(segs, scups)
    buf = data.tobytes()
    mel_w, vlc_w, ms_w = ht_prepass.prepass_group(segs, lcups.tolist(),
                                                  scups_a.tolist())
    for lane, (base, lcup, scup) in enumerate(zip(off[:-1].tolist(),
                                                  lcups.tolist(), scups)):
        readers = ((MelReader(buf, base, lcup, scup), mel_w, True, 6),
                   (LsbReader(buf, base, lcup, scup, True), vlc_w, False,
                    16),
                   (LsbReader(buf, base, lcup, scup, False), ms_w, False,
                    32))
        for reader, words, msb, most in readers:
            pos = 0
            end = 32 * words.shape[0] + 96       # past the words: the pad
            while pos < end:
                assert reader.peek() == _fetch(words, lane, pos, msb), \
                    (lane, "mel" if msb else most, pos)
                c = int(rng.integers(0, most + 1))
                if not msb and most == 32 and rng.random() < 0.02:
                    c = 60 + int(rng.integers(0, 40))   # a corrupt read
                reader.skip(c)
                pos += c


def test_pack_segments_and_dummy_lanes():
    segs = [b"\x01\x02\x03\x21", b"", b"\x00\x00\x05", None]
    jobs = [None if s is None else (s,) for s in segs]
    data, off, lcup, scup, valid = fused_decode._prepare_ht_group(jobs)
    # \x01\x02\x03\x21: scup = (0x21 << 4) + 3 > lcup: invalid
    assert valid.tolist() == [0, 0, 0, 0]
    assert lcup.tolist() == [2, 2, 2, 2] and scup.tolist() == [2, 2, 2, 2]
    assert off.tolist() == [0, 2, 4, 6, 8]
    assert data.tobytes() == fused_decode.DUMMY_SEGMENT * 4
    ok = b"\x11\x22\x33\x44\x45\x00"     # scup = (0 << 4) + 5 = 5
    data, off, lcup, scup, valid = fused_decode._prepare_ht_group([(ok,)])
    assert (valid.tolist(), lcup.tolist(), scup.tolist()) == ([1], [6], [5])
    assert off.dtype == np.int64 and lcup.dtype == scup.dtype == np.int32


def test_decode_segments_validates():
    t = convert.dec_tables_from_reference(ht_tables._dec_tables(), "cpu")
    data, off, lcup, scup = (torch.from_numpy(a) for a in
                             ht_dec.pack_segments([b"\x00\x00"] * 2, [2, 2]))
    with pytest.raises(TypeError):
        ht_dec.decode_segments(data.to(torch.int32), off, lcup, scup, 4, 4, t)
    with pytest.raises(ValueError):
        ht_dec.decode_segments(data, off.to(torch.int32), lcup, scup, 4, 4,
                               t)
    with pytest.raises(ValueError):      # scup below 2
        ht_dec.decode_segments(data, off, lcup, scup - 1, 4, 4, t)
    with pytest.raises(ValueError):      # lcup past the segment's bytes
        ht_dec.decode_segments(data, off, lcup + 1, scup, 4, 4, t)
    with pytest.raises(ValueError):      # word matrices decode on the CPU only
        ht_dec.decode_group(torch.zeros((4, 2), dtype=torch.int32,
                                        device="meta"), *[torch.zeros(
                                            (4, 2), dtype=torch.int32,
                                            device="meta")] * 2, 4, 4, t)
    before = dict(ht_dec.LAUNCHES)
    calls = ht_prepass.CALLS["prepass"]
    mags, signs = ht_dec.decode_segments(data, off, lcup, scup, 4, 4, t)
    assert ht_dec.LAUNCHES == before     # the CPU runs the plain version
    assert ht_prepass.CALLS["prepass"] == calls + 1
    assert mags.shape == signs.shape == (2, 4, 4)
    empty = ht_dec.decode_segments(data[:0], off[:1], lcup[:0], scup[:0], 8,
                                   6, t)
    assert empty[0].shape == (0, 6, 8)


def _blocks(rng, h, w, n, mb):
    cases = []
    for i in range(n):
        dens = (0.0, 0.05, 0.4, 0.9)[i % 4]
        mbits = int(rng.integers(1, mb - 1))
        mag = ((rng.random((h, w)) < dens)
               * rng.integers(1, 1 << mbits, (h, w))).astype(np.uint32)
        neg = (rng.random((h, w)) < 0.5).astype(np.uint8)
        cases.append((mag, neg, mb))
    return cases


@pytest.mark.parametrize("h,w", [(4, 4), (8, 64), (64, 8)])
def test_decode_segments_equals_jax(h, w):
    from grokimagecompression_tpu.native import t1_native
    from grokimagecompression_tpu.ops import ht_dec_jax, ht_jax
    rng = np.random.default_rng(h * 1000 + w)
    cases = _blocks(rng, h, w, 8, mb=14)
    segs = [bytes(s) for s in t1_native.ht_encode_cblk_batch(cases)]
    scups = [(s[-1] << 4) + (s[-2] & 0xF) for s in segs]
    tables = convert.dec_tables_from_reference(ht_tables._dec_tables(),
                                               "cpu")
    mags, signs = ht_dec.decode_segments(
        *(torch.from_numpy(a) for a in ht_dec.pack_segments(segs, scups)),
        w, h, tables)
    # ht_decode_blocks: the reference's batch entry point (cropped)
    blocks = [(s, w, h, c[2] - int(c[0].max()).bit_length())
              for s, c in zip(segs, cases)]
    for i, (jm, jn) in enumerate(ht_dec_jax.ht_decode_blocks(blocks)):
        np.testing.assert_array_equal(mags[i, :h, :w].numpy(), jm)
        sig = jm > 0
        np.testing.assert_array_equal(signs[i, :h, :w].numpy()[sig], jn[sig])
    # decode_group_core, jitted as ht_decode_blocks jits it: the whole
    # padded grid, signs of zero samples included
    lcups = [len(s) for s in segs]
    wm = ht_dec_jax.bucket_words((8 * (max(scups) + 7)) // 32 + 4)
    wm_ms = ht_dec_jax.bucket_words(
        (8 * (max(lc - sc for lc, sc in zip(lcups, scups)) + 8)) // 32 + 4)
    words = ht_dec_jax.prepass_all(segs, lcups, scups, wm, wm, wm_ms)
    bp = ht_jax._pad_batch(len(segs))
    padded = [np.pad(a, ((0, 0), (0, bp - a.shape[1]))) for a in words]
    jm, jn = ht_dec_jax._jitted_decode(w, h, wm, wm, wm_ms)(*padded)
    np.testing.assert_array_equal(mags.numpy(),
                                  np.asarray(jm)[:len(segs)].astype(np.int64))
    np.testing.assert_array_equal(signs.numpy(),
                                  np.asarray(jn)[:len(segs)].astype(np.int64))


def test_cpu_decode_route_keeps_the_prepass():
    """decode_batch(device="cpu") decodes HT streams through the prepass:
    one call per lane group (the CUDA route makes none, chip_smoke.py)."""
    from grokimagecompression_tpu_torch.codestream import decoder, encoder
    from grokimagecompression_tpu_torch.core.image import make_image
    from grokimagecompression_tpu_torch.core.params import EncoderParams
    rng = np.random.default_rng(4)
    img = make_image([rng.integers(0, 256, (40, 72)).astype(np.int32)])
    params = EncoderParams(numresolutions=3, cblk_style=0x40)
    (cs,) = encoder.encode_batch([img], params, device="cpu")
    calls = ht_prepass.CALLS["prepass"]
    before = dict(ht_dec.LAUNCHES)
    (out,) = decoder.decode_batch([cs], device="cpu")
    np.testing.assert_array_equal(out.components[0].data,
                                  img.components[0].data)
    assert ht_prepass.CALLS["prepass"] > calls
    assert ht_dec.LAUNCHES == before
