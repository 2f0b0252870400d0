"""The reference's transform-only mesh route in the port, on CPU meshes.

Styled MQ requests and refined HT requests (`block_coder` "t1") on a mesh
of two or three shards: each shard's device runs the transform of its
tiles (`fused_encode.FusedT1Encoder` under `sharding.
fused_entropy_tiles_on_mesh`) and the host Tier-1 coders code the band
planes; their streams must equal the one-device encode's and the
reference host encoder's byte for byte: MQ 0x01 on 9/7 at two rates, MQ
0x3F on 9/7 at two rates under the image-wide allocator (Queue C 10: its
float64 sums stay in tile order), refined HT on 5/3 and on 9/7, and
refined HT at one byte target (the step search's probes on the sharded
HT encoder, its confirms refined on the mesh). `encode_batch`'s mesh
form and `sharding.encode_sharded` give the same streams.

The decodes of those streams, of a deep HT stream (Mb + 3 > 32: the
host cleanup decoder) and of an MQ stream whose band passes 30 planes
(an ROI shift) through `decode_batch`, `decode` and a windowed `decode`
on the same meshes must equal the one-device decodes pixel for pixel;
so must a batch in which one stream refines its tiles and the other does
not (`decoder.tile_groups` unions the refined components).

The host coders' thread cap: `t1_native.set_thread_override` caps
`default_threads()` in its own thread only, `GROK_TPU_THREADS` is
honoured, `sharding.shard_threads` splits the cores among the shards and
`_code_shard` caps its host coders while it runs; `t1_native.CALLS`
and `ht_prepass.CALLS` count every call made from more threads than
cores at once.

The reference runs with its numpy DWT (`test_torch_t1_styles._numpy_dwt`),
which the port's DWT equals. The `gpu` case codes a 0x3F and a refined
request on [cuda:0, cuda:0] and holds them to the card's one-device
encode and decode; the reference's host codec imports no JAX at module
level.
"""

import dataclasses
import functools
import os
import sys
import threading

import numpy as np
import pytest
import torch

from grokimagecompression_tpu.core.params import EncoderParams, Transform
from grokimagecompression_tpu_torch import convert
from grokimagecompression_tpu_torch.codestream import decoder, encoder
from grokimagecompression_tpu_torch.core.params import DecoderParams
from grokimagecompression_tpu_torch.models import fused_encode
from grokimagecompression_tpu_torch.native import ht_prepass, t1_native
from grokimagecompression_tpu_torch.parallel import sharding

from conftest import natural_image
from test_torch_ht_refine import _deep_image
from test_torch_t1_styles import _ref_encode, _same_pixels

CPU = torch.device("cpu")
MESHES = {"one": None, "2": [CPU] * 2, "3": [CPU] * 3}
HT = 0x40
TILES = dict(numresolutions=3, tile_size=(24, 20), cblk_w_exp=4,
             cblk_h_exp=4)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Torch on one thread: the plain versions run many small CPU ops, and
    under pytest-xdist's workers torch's OpenMP threads oversubscribe the
    cores and spin."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# name -> (the reference image, the reference EncoderParams): 48 x 40
# frames in four 24 x 20 tiles, split 2 / 2 and 2 / 2 / 0 over the
# meshes; the byte-target case in three 16^2 tiles (the plain HT encoder
# runs every probe, and smaller frames at higher ratios make the
# reference's QCD fail, ROADMAP Queue C 6)
CASES = {
    "mq01_97_rates": (
        lambda: natural_image(48, 40, ncomp=1, seed=21),
        EncoderParams(transform=Transform.DWT_97, cblk_style=0x01,
                      numlayers=2, rates=(16.0, 4.0), **TILES)),
    "mq3f_97_global": (
        lambda: natural_image(48, 40, ncomp=3, seed=22),
        EncoderParams(transform=Transform.DWT_97, cblk_style=0x3F,
                      numlayers=2, rates=(16.0, 4.0), rate_alloc="global",
                      **TILES)),
    "ht_refined_53": (
        lambda: natural_image(48, 40, ncomp=1, seed=23),
        EncoderParams(cblk_style=HT, ht_refinement=True, **TILES)),
    "ht_refined_97": (
        lambda: natural_image(48, 40, ncomp=3, seed=24),
        EncoderParams(transform=Transform.DWT_97, cblk_style=HT,
                      ht_refinement=True, **TILES)),
    "ht_refined_rate": (
        lambda: natural_image(48, 16, ncomp=1, seed=25),
        EncoderParams(numresolutions=2, tile_size=(16, 16), cblk_w_exp=4,
                      cblk_h_exp=4, transform=Transform.DWT_97,
                      cblk_style=HT, ht_refinement=True, rates=(4.0,))),
}


@functools.lru_cache(maxsize=None)
def _inputs(name):
    """(the reference image and params, the port's image and params)."""
    make, params = CASES[name]
    img = make()
    return (img, params, convert.image_from_reference(img),
            convert.params_from_reference(params))


@functools.lru_cache(maxsize=None)
def _case(name):
    """(the port's image and params, the reference host encoder's
    stream, the port's one-device stream)."""
    img, params, pimg, pparams = _inputs(name)
    return (pimg, pparams, _ref_encode(img, params),
            encoder.encode(pimg, pparams, device="cpu"))


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("name", list(CASES))
def test_mesh_encode_equals_one_device_and_reference(name, mesh):
    img, params, want, one = _case(name)
    assert one == want
    if MESHES[mesh] is not None:
        t1_native.CALLS["t1"] = 0
        assert encoder.encode(img, params, mesh=MESHES[mesh]) == want
        assert t1_native.CALLS["t1"] > 0


@pytest.mark.parametrize("name", ["mq3f_97_global", "ht_refined_97"])
def test_encode_batch_and_encode_sharded_on_a_mesh(name):
    """`encode_batch`'s mesh form (each plan's tiles split over the mesh,
    a chunk of two frames) and `sharding.encode_sharded` code the
    one-device streams."""
    img, params, want, _ = _case(name)
    assert encoder._encode_batch([img, img], params, MESHES["3"]) == \
        [want, want]
    assert sharding.encode_sharded(img, params, mesh=MESHES["2"]) == want


def _deep_ht_stream():
    """A 28-bit 5/3 HT stream in tiles: HH bands of Mb 30, Mb + 3 > 32."""
    return _ref_encode(_deep_image(28, w=32, h=24), EncoderParams(
        numresolutions=3, cblk_style=HT, tile_size=(16, 12)))


def _deep_mq_stream():
    """An MQ stream in tiles whose ROI shift takes the HH bands' Kmax to
    31, past the CUDA MQ decoder's 30 planes."""
    return _ref_encode(natural_image(32, 24, ncomp=1, seed=26),
                       EncoderParams(numresolutions=2, tile_size=(16, 12),
                                     roi_comp=0, roi_shift=20))


@functools.lru_cache(maxsize=None)
def _stream(name):
    if name == "deep_ht":
        return _deep_ht_stream()
    if name == "deep_mq":
        return _deep_mq_stream()
    return _case(name)[3]


def _requests(cs):
    """(label, DecoderParams) of the three decodes held on a mesh: the
    whole image through `decode_batch`, through `decode`, and a window
    across the tiles through `decode`."""
    h = decoder.read_header(cs)
    w = (3, 2, h.siz.xsiz - 5, h.siz.ysiz - 3)
    return (("decode_batch", DecoderParams()), ("decode", DecoderParams()),
            ("window", DecoderParams(window=w)))


def _decode(label, cs, params, **where):
    if label == "decode_batch":
        return decoder.decode_batch([cs], params, **where)[0]
    return decoder.decode(cs, params, **where)


@functools.lru_cache(maxsize=None)
def _one_device(name, label):
    cs = _stream(name)
    return _decode(label, cs, dict(_requests(cs))[label], device="cpu")


@pytest.mark.parametrize("mesh", ["2", "3"])
@pytest.mark.parametrize("name", list(CASES) + ["deep_ht", "deep_mq"])
def test_mesh_decode_equals_one_device(name, mesh):
    cs = _stream(name)
    hdr, trs, parsed = decoder.parse_batch([cs])
    assert any(p.coder == "t1" for p in decoder.tile_groups(hdr, trs,
                                                             parsed))
    for label, params in _requests(cs):
        _same_pixels(_decode(label, cs, params, mesh=MESHES[mesh]),
                     _one_device(name, label))


def test_mixed_refined_batch_on_a_mesh():
    """A batch of a refined and a plain HT stream of one geometry on a
    mesh of three shards: the refined components go to the host decoders
    for both streams, and each frame equals its one-device decode."""
    img, params, _, refined = _case("ht_refined_53")
    plain = encoder.encode(img, dataclasses.replace(params,
                                                    ht_refinement=False),
                           device="cpu")
    assert plain != refined
    got = decoder.decode_batch([refined, plain, refined],
                               mesh=MESHES["3"], chunk=2)
    for cs, out in zip((refined, plain, refined), got):
        _same_pixels(out, decoder.decode(cs, device="cpu"))


# ---- the host coders' threads and call counts

def test_thread_override_caps_its_own_thread(monkeypatch):
    """`set_thread_override` caps `default_threads()` in the thread that
    sets it, and nowhere else; `GROK_TPU_THREADS` caps it where no
    override is set; clearing the override restores the default."""
    monkeypatch.delenv("GROK_TPU_THREADS", raising=False)
    cores = t1_native.default_threads()
    seen = {}

    def worker():
        t1_native.set_thread_override(3)
        seen["in"] = t1_native.default_threads()
        t1_native.set_thread_override(None)
        seen["cleared"] = t1_native.default_threads()
    started = threading.Event()
    release = threading.Event()

    def capped():
        t1_native.set_thread_override(2)
        started.set()
        release.wait(30)
        seen["capped"] = t1_native.default_threads()
    other = threading.Thread(target=capped)
    other.start()
    started.wait(30)
    seen["main"] = t1_native.default_threads()
    t = threading.Thread(target=worker)
    t.start()
    t.join()
    release.set()
    other.join()
    assert seen == {"in": 3, "cleared": cores, "main": cores, "capped": 2}
    monkeypatch.setenv("GROK_TPU_THREADS", "5")
    assert t1_native.default_threads() == 5
    t1_native.set_thread_override(2)
    try:
        assert t1_native.default_threads() == 2
    finally:
        t1_native.set_thread_override(None)
    assert t1_native.default_threads() == 5


@pytest.mark.parametrize("cores,shards,want", [
    (8, 1, 8), (8, 2, 4), (8, 3, 2), (8, 8, 1), (8, 16, 1), (None, 2, 1)])
def test_shard_threads_split_the_cores(monkeypatch, cores, shards, want):
    monkeypatch.setattr(sharding.os, "cpu_count", lambda: cores)
    assert sharding.shard_threads(shards) == want


def test_code_shard_caps_its_host_coders(monkeypatch):
    """`_code_shard(threads=)` runs the host Tier-1 coding of its chunks
    with `default_threads()` capped to `threads`, and clears the cap
    after; without `threads` (CPU shards, or one CUDA shard) the coders
    keep the default."""
    monkeypatch.delenv("GROK_TPU_THREADS", raising=False)
    img, params, want, _ = _case("mq01_97_rates")
    seen = []
    collect = fused_encode.encode_tile_collect

    def rec(handle):
        seen.append(t1_native.default_threads())
        return collect(handle)
    monkeypatch.setattr(fused_encode, "encode_tile_collect", rec)
    p, siz, cod, qcd, cod_comp, trs = encoder._coding(img, params)
    work = {}
    for t, enc in enumerate(encoder._tile_encoders(
            p, siz, cod, qcd, cod_comp, trs, CPU, True)):
        work.setdefault(enc, []).append(t)
    segs = sharding._code_shard(img, siz, list(work.items()),
                                [2] * len(work), threads=1)
    assert seen and set(seen) == {1}
    assert sorted(segs) == list(range(len(trs)))
    assert t1_native.default_threads() == (os.cpu_count() or 1)
    seen.clear()
    assert encoder.encode(img, params, mesh=MESHES["2"]) == want
    assert seen and set(seen) == {t1_native.default_threads()}


def test_calls_count_from_threads():
    """Sixteen threads (more than the cores) calling the host coder and
    the HT prepass at once, the interpreter switching threads every
    microsecond: every call is counted."""
    mag = np.arange(64, dtype=np.uint32).reshape(8, 8) % 5
    neg = np.zeros((8, 8), np.uint8)
    t1_native.encode_cblk(mag, neg, 0)       # the library built first
    c0, p0 = t1_native.CALLS["t1"], ht_prepass.CALLS["prepass"]
    nthreads, calls = 16, 200
    barrier = threading.Barrier(nthreads)

    def work():
        barrier.wait(30)
        for _ in range(calls):
            t1_native.encode_cblk(mag, neg, 0)
            ht_prepass.ht_dec_prepass([b"\x00\x00\x00"], [3], [2], 32, 32,
                                      32)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work) for _ in range(nthreads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(120)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert t1_native.CALLS["t1"] - c0 == nthreads * calls
    assert ht_prepass.CALLS["prepass"] - p0 == nthreads * calls


# ---- on the card

@pytest.mark.gpu
def test_cuda_styled_and_refined_on_two_shards_equal_one_card():
    """A 0x3F 9/7 request and a refined HT request on [cuda:0, cuda:0]
    (two shard threads, each host coder on `shard_threads(2)` workers)
    code the card's one-device streams, and their decodes on the same
    mesh, whole and windowed, give the card's one-device pixels; the
    DWT kernel is launched and no MQ kernel. (The reference's host codec
    is not run here: its native library is not built on the card's
    machine.)"""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from grokimagecompression_tpu_torch.ops import dwt, mq_dec, mq_scan
    dev = torch.device("cuda", 0)
    for name in ("mq3f_97_global", "ht_refined_97"):
        img, params = _inputs(name)[2:]
        one = encoder.encode(img, params, device=dev)
        dwt.LAUNCHES["dwt"] = mq_scan.LAUNCHES["mq"] = 0
        mq_dec.LAUNCHES["mq_dec"] = 0
        assert encoder.encode(img, params, mesh=[dev, dev]) == one
        for label, p in _requests(one):
            _same_pixels(_decode(label, one, p, mesh=[dev, dev]),
                         _decode(label, one, p, device=dev))
        assert dwt.LAUNCHES["dwt"] > 0
        assert mq_scan.LAUNCHES["mq"] == mq_dec.LAUNCHES["mq_dec"] == 0
