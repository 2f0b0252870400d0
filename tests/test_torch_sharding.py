"""The port's multi-device encode and decode on CPU meshes.

`encoder.encode(..., mesh=)` (each plan group's tiles split over the mesh
in contiguous blocks, `parallel.sharding.fused_entropy_tiles_on_mesh`) on
meshes of two and three CPU shards must be byte-identical to the port's
one-device `encode(device="cpu")` and to the reference's host
`encoder.encode(device=False)`, the yardstick the reference's own
tests/test_sharding.py holds its `encode_sharded` to: HT 5/3 gray in
edge-tile plans (tiles not a multiple of the shards), MQ 5/3 RGB, MQ 9/7
at a rate, image-wide PCRD (`rate_alloc="global"`) on a flat-and-noisy
image, a single tile, POC with tile-parts, PLT and TLM, and PPM.
`decoder.decode(..., mesh=)` (each plan group's tiles round-robin over
the mesh) must be pixel-identical to the reference's host decoder: the
whole image, reduce 1, a window, the first layer, and a COC stream.
`parallel.sharding`'s wrappers, the mesh checks and the refusals.

The reference runs with its numpy DWT (`dwt_host._get_native` None and
GROK_TPU_DWT=python): its native 9/7 DWT rounds differently from
`dwt_np`, which the port's DWT equals bit for bit. The reference's own
`sharding.encode_sharded` is not run here: it compiles its sharded JAX
programs, 18 s for the smallest HT case alone on a 2-device CPU mesh.

The `gpu` case holds a two-shard mesh on one card to `encode` on that
card; the reference's host codec imports no JAX at module level.
"""

import functools

import numpy as np
import pytest
import torch

from grokimagecompression_tpu.codestream import decoder as ref_decoder
from grokimagecompression_tpu.codestream import encoder as ref_encoder
from grokimagecompression_tpu.codestream.markers import PocEntry
from grokimagecompression_tpu.core.image import Component, Image
from grokimagecompression_tpu.core.params import DecoderParams as RefDec
from grokimagecompression_tpu.core.params import (EncoderParams, Progression,
                                                  Transform)
from grokimagecompression_tpu.ops import dwt_host
from grokimagecompression_tpu_torch import convert
from grokimagecompression_tpu_torch.codestream import decoder, encoder
from grokimagecompression_tpu_torch.core.params import DecoderParams
from grokimagecompression_tpu_torch.models import fused_encode
from grokimagecompression_tpu_torch.parallel import sharding
from grokimagecompression_tpu_torch.utils.device import resolve_mesh

CPU = torch.device("cpu")
MESHES = {"one": None, "2": [CPU] * 2, "3": [CPU] * 3}
HT = 0x40


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Torch on one thread: the plain versions run many small CPU ops, and
    under pytest-xdist's workers torch's OpenMP threads oversubscribe the
    cores and spin."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def numpy_dwt(monkeypatch):
    monkeypatch.setattr(dwt_host, "_get_native", lambda: None)
    monkeypatch.setenv("GROK_TPU_DWT", "python")


def _noise(w, h, ncomps=1, seed=0):
    """The reference test's `_image`: uniform 8-bit noise."""
    rng = np.random.default_rng(seed)
    return Image(xsiz=w, ysiz=h, components=[Component(
        data=rng.integers(0, 256, (h, w)).astype(np.int32), prec=8,
        signed=False, dx=1, dy=1) for _ in range(ncomps)])


def _structured(w, h, ncomps=3, seed=5):
    """The reference test's `_structured_image`: gradient plus mild
    texture."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    return Image(xsiz=w, ysiz=h, components=[Component(
        data=(((xx * (c + 2) + yy * 3) // 8) % 200
              + rng.integers(0, 24, (h, w))).astype(np.int32),
        prec=8, signed=False, dx=1, dy=1) for c in range(ncomps)])


def _hetero(w, h, seed=5):
    """The reference's tests/test_pcrd.py `_hetero_image` pattern: the
    left half flat, the right half noisy."""
    rng = np.random.default_rng(seed)
    d = np.zeros((h, w), np.int32)
    d[:, :w // 2] = 128
    d[:, w // 2:] = rng.integers(0, 256, (h, w // 2))
    return Image(xsiz=w, ysiz=h, components=[Component(
        data=d, prec=8, signed=False, dx=1, dy=1)])


POCS = (PocEntry(rs=0, cs=0, lye=1, re=2, ce=3, prog=Progression.RLCP),
        PocEntry(rs=2, cs=0, lye=1, re=3, ce=3, prog=Progression.CPRL))

# name -> (image, reference EncoderParams); the reference test's sizes or
# smaller
CASES = {
    "ht53_gray_edge_tiles": (
        lambda: _noise(104, 72, seed=9),
        EncoderParams(numresolutions=3, tile_size=(32, 32), cblk_style=HT)),
    "mq53_rgb": (
        lambda: _structured(48, 32, seed=2),
        EncoderParams(numresolutions=3, tile_size=(16, 16), cblk_w_exp=4,
                      cblk_h_exp=4)),
    "mq97_rate": (
        lambda: _structured(48, 48, ncomps=1, seed=3),
        EncoderParams(numresolutions=3, transform=Transform.DWT_97,
                      tile_size=(24, 24), cblk_w_exp=4, cblk_h_exp=4,
                      rates=(16.0,))),
    "global_pcrd": (
        lambda: _hetero(64, 64),
        EncoderParams(numresolutions=3, transform=Transform.DWT_97,
                      tile_size=(32, 32), cblk_w_exp=4, cblk_h_exp=4,
                      numlayers=2, rates=(12.0, 48.0),
                      rate_alloc="global")),
    "single_tile": (
        lambda: _structured(32, 24, ncomps=1, seed=4),
        EncoderParams(numresolutions=3, cblk_w_exp=4, cblk_h_exp=4)),
    "poc_tileparts_plt_tlm": (
        lambda: _structured(72, 56, seed=6),
        EncoderParams(numresolutions=3, tile_size=(32, 32), cblk_style=HT,
                      cblk_w_exp=4, cblk_h_exp=4, pocs=POCS, tp_flag="R",
                      plt_markers=True, tlm_markers=True)),
    "ppm": (
        lambda: _noise(80, 56, seed=7),
        EncoderParams(numresolutions=3, tile_size=(48, 48), cblk_style=HT,
                      ppm_markers=True)),
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
    """(the reference image, the port's image and params, the reference
    host encoder's stream)."""
    img, params, port_img, port_params = _inputs(name)
    return (img, port_img, port_params,
            ref_encoder.encode(img, params, device=False))


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("name", list(CASES))
def test_mesh_encode_matches_reference(name, mesh):
    _, img, params, want = _case(name)
    if MESHES[mesh] is None:
        got = encoder.encode(img, params, device="cpu")
    else:
        got = encoder.encode(img, params, mesh=MESHES[mesh])
    assert got == want


def test_shards_split_plan_groups_in_contiguous_blocks(monkeypatch):
    """Each plan group's tiles go to the shards in contiguous blocks of
    ceil(b / ndev), as the reference's shard_map splits its padded batch;
    one encoder a plan and device; a three-shard mesh leaves the last
    shard short (and a one-tile group on the first shard alone)."""
    assert sharding.shard_blocks(list(range(7)), 3) == [
        [0, 1, 2], [3, 4, 5], [6]]
    assert sharding.shard_blocks([4], 3) == [[4], [], []]
    submits = []
    submit = fused_encode.encode_tile_submit

    def rec(comps, enc):
        submits.append((id(enc), enc.plan, comps[0].shape[0]))
        return submit(comps, enc)
    monkeypatch.setattr(fused_encode, "encode_tile_submit", rec)
    _, img, params, want = _case("ht53_gray_edge_tiles")
    assert encoder.encode(img, params, mesh=MESHES["3"]) == want
    sizes = {}
    for _, plan, n in submits:
        sizes.setdefault(plan, []).append(n)
    # 12 tiles: 6 interior, 3 right-edge, 2 bottom-edge, 1 corner; the
    # three shards are on the one CPU device, so one encoder a plan
    assert sorted(map(sorted, sizes.values())) == [
        [1], [1, 1], [1, 1, 1], [2, 2, 2]]
    assert len({i for i, _, _ in submits}) == 4


def test_mesh_chunks_share_a_device(monkeypatch):
    """A shard's chunk is capped to its device's free memory split among
    the mesh's shards on that device, and the stream does not change."""
    seen = []
    capped = encoder._capped_chunk

    def rec(chunk, encoders, dev, rate_control=False, shares=1):
        seen.append(shares)
        return min(capped(chunk, encoders, dev, rate_control, shares), 1)
    monkeypatch.setattr(encoder, "_capped_chunk", rec)
    _, img, params, want = _case("ppm")
    assert encoder.encode(img, params, mesh=[CPU, CPU]) == want
    assert set(seen) == {2}
    _, siz, cod, qcd, _, trs = encoder._coding(img, params)
    (plan,) = encoder.tile_plans(siz, cod, qcd, trs[:1], "ht")
    monkeypatch.setattr(encoder, "free_device_bytes", lambda dev: 8 << 30)
    assert capped(10 ** 6, [plan], CPU, shares=4) == \
        fused_encode.chunk_cap(plan, (8 << 30) // 4)


def test_sharding_wrappers_and_mesh_checks():
    _, img, params, want = _case("ppm")
    assert sharding.encode_sharded(img, params, mesh=MESHES["2"]) == want
    out = sharding.decode_sharded(want, mesh=MESHES["3"])
    ref = ref_decoder.decode(want, device=False)
    assert np.array_equal(out.components[0].data, ref.components[0].data)
    assert resolve_mesh(None, "cpu") == [CPU]
    assert resolve_mesh(["cpu", CPU]) == [CPU, CPU]
    with pytest.raises(ValueError):
        resolve_mesh([])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            sharding.default_mesh()
        with pytest.raises(RuntimeError):
            sharding.encode_sharded(img, params)
        with pytest.raises(RuntimeError):
            encoder.encode(img, params, mesh=["cuda:0", "cuda:0"])
        with pytest.raises(RuntimeError):
            decoder.decode(want, mesh=["cpu", "cuda"])


def test_tile_outside_the_plan_raises(monkeypatch):
    """A tile the fused plan cannot code raises instead of being coded on
    a host coder, whatever the mesh."""
    _, img, params, _ = _case("ppm")
    monkeypatch.setattr(fused_encode, "build_plan", lambda *a, **kw: None)
    for mesh in (None, MESHES["2"]):
        with pytest.raises(NotImplementedError):
            encoder.encode(img, params, device="cpu", mesh=mesh)


def test_failed_shard_fails_the_encode(monkeypatch):
    _, img, params, _ = _case("ht53_gray_edge_tiles")
    submit = fused_encode.encode_tile_submit
    calls = [0]

    def fail_second(comps, enc):
        calls[0] += 1
        if calls[0] == 2:
            raise RuntimeError("shard failed")
        return submit(comps, enc)
    monkeypatch.setattr(fused_encode, "encode_tile_submit", fail_second)
    with pytest.raises(RuntimeError, match="shard failed"):
        encoder.encode(img, params, mesh=MESHES["2"])


# (label, stream case, reference DecoderParams arguments); the COC stream
# is made below
REQUESTS = {
    "whole": ("ht53_gray_edge_tiles", {}),
    "reduce_1": ("poc_tileparts_plt_tlm", {"reduce": 1}),
    "window": ("ht53_gray_edge_tiles", {"window": (10, 9, 90, 60)}),
    "window_reduce_1": ("poc_tileparts_plt_tlm",
                        {"window": (10, 7, 70, 50), "reduce": 1}),
    "layers_1": ("global_pcrd", {"layers": 1}),
    "coc": ("coc", {}),
}


@functools.lru_cache(maxsize=None)
def _stream(name):
    if name == "coc":
        return ref_encoder.encode(_structured(96, 64, seed=8), EncoderParams(
            numresolutions=3, tile_size=(32, 32), cblk_style=HT,
            comp_cblk_exps={1: (3, 3)}), device=False)
    return _case(name)[3]


@functools.lru_cache(maxsize=None)
def _ref_pixels(label):
    name, kw = REQUESTS[label]
    out = ref_decoder.decode(_stream(name), RefDec(**kw), device=False)
    return (out.x0, out.y0, out.xsiz, out.ysiz), [c.data for c in
                                                  out.components]


@pytest.mark.parametrize("mesh", ["2", "3"])
@pytest.mark.parametrize("label", list(REQUESTS))
def test_mesh_decode_matches_reference(label, mesh):
    name, kw = REQUESTS[label]
    area, want = _ref_pixels(label)
    out = decoder.decode(_stream(name), DecoderParams(**kw),
                         mesh=MESHES[mesh])
    assert (out.x0, out.y0, out.xsiz, out.ysiz) == area
    assert len(out.components) == len(want)
    for c, w in zip(out.components, want):
        assert np.array_equal(c.data, w)


def test_mesh_decode_batch_round_robin(monkeypatch):
    """decode_batch under a mesh: each plan's (frame, tile) instances go
    round-robin over the shards, and two frames decode as one."""
    cs = _stream("poc_tileparts_plt_tlm")
    one = decoder.decode_batch([cs], device="cpu")[0]
    devs = []
    submit = decoder.fused_decode.decode_tiles_submit

    def rec(dec, frames):
        devs.append(len(frames))
        return submit(dec, frames)
    monkeypatch.setattr(decoder.fused_decode, "decode_tiles_submit", rec)
    a, b = decoder.decode_batch([cs, cs], mesh=MESHES["3"], chunk=2)
    for c in range(3):
        assert np.array_equal(a.components[c].data, one.components[c].data)
        assert np.array_equal(b.components[c].data, one.components[c].data)
    # 6 tiles in 4 plans of 2, 1, 2 and 1 tiles: 4, 2, 4 and 2
    # instances, dealt 2 / 1 / 1 and 1 / 1 / 0 over the shards
    assert devs == [2, 1, 1, 1, 1] * 2


@pytest.mark.gpu
def test_cuda_two_shards_on_one_card_equal_encode():
    """Two shards on one card (each its own host thread) give encode's
    stream on that card, MQ with image-wide PCRD, HT, and HT at a byte
    target (the step search with each plan's tiles split over the mesh;
    on the CPU its plain coder takes 15-30 s for the smallest tiled
    case), and the decode over the same mesh equals the card's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda", 0)
    ht_rate = (convert.image_from_reference(_structured(256, 192, seed=12)),
               convert.params_from_reference(EncoderParams(
                   numresolutions=4, transform=Transform.DWT_97,
                   tile_size=(96, 96), cblk_style=HT, rates=(8.0,))))
    for img, params in [_inputs(name)[2:] for name in (
            "global_pcrd", "ht53_gray_edge_tiles")] + [ht_rate]:
        want = encoder.encode(img, params, device=dev)
        cs = encoder.encode(img, params, mesh=[dev, dev])
        assert cs == want
        one = decoder.decode(cs, device=dev)
        two = decoder.decode(cs, mesh=[dev, dev])
        for a, b in zip(one.components, two.components):
            assert np.array_equal(a.data, b.data)
