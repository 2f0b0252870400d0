"""The profile encode (digital cinema, broadcast, IMF) of the torch port.

`codestream/profiles.py` is the port's copy of the reference's: its
`apply_*` functions must give the reference's parameters, rsiz, caps and
warnings; its `encode_with_profile(device="cpu")` runs the fused batch
encode (`encoder.encode_batch` with the profile's `rsiz` and PCRD
allocator, the per-pass R-D tables of the MQ coder's plain version, the
per-component simulator in `tile.encode_tile`) and must give the
reference host encoder's `encode_with_profile(..., device=False)` stream
byte for byte, both on the same 12-bit frames made from a seed, the
reference with its numpy DWT (`dwt_host._get_native` None: its native
9/7 DWT rounds differently, and the port equals the numpy one). The
cinema caps are test-scale: a frame cap and a per-component cap, each
binding in its own case, and kept. One stream decodes through
`decode_batch(device="cpu")` to the reference host decoder's pixels.

The port's MQ coder takes one torch step a coding decision on the CPU,
so the frames are small (cinema 2K at 160x96, 4K at 256x136) and each
port stream is made once.
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

from grokimagecompression_tpu.codestream import decoder as ref_decoder
from grokimagecompression_tpu.codestream import profiles as ref_profiles
from grokimagecompression_tpu.codestream import tile as ref_tile
from grokimagecompression_tpu.core.image import Component, Image
from grokimagecompression_tpu.core.params import EncoderParams
from grokimagecompression_tpu.ops import dwt_host
from grokimagecompression_tpu_torch import convert
from grokimagecompression_tpu_torch.codestream import (decoder, encoder,
                                                       profiles, tile)
from grokimagecompression_tpu_torch.core.params import (EncoderParams as
                                                        PortParams)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Torch on one thread: the plain versions run many small CPU ops, and
    under pytest-xdist's workers torch's OpenMP threads oversubscribe the
    cores and spin (a case of 2.4 s alone took 43 s among six workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def numpy_dwt(monkeypatch):
    """The reference host codec with its numpy DWT only (its encoder's
    `dwt_host` dispatch and its decoder's packed native inverse)."""
    monkeypatch.setattr(dwt_host, "_get_native", lambda: None)
    monkeypatch.setenv("GROK_TPU_DWT", "python")


def _frames(n, w, h, prec=12, seed=13):
    """n RGB frames of smooth waves plus a little uniform noise, as the
    reference's Image: few bit-planes in the detail bands, so the plain
    MQ coder's steps stay few."""
    rng = np.random.default_rng(seed)
    y = np.arange(h)[:, None]
    x = np.arange(w)[None, :]
    mid = 1 << (prec - 1)
    out = []
    for i in range(n):
        comps = []
        for c in range(3):
            wave = mid + (mid // 7) * np.sin(y / (9.0 + c) + i) \
                * np.cos(x / (13.0 + c))
            data = wave.astype(np.int32) + rng.integers(0, 16, (h, w))
            comps.append(Component(data=data.astype(np.int32), prec=prec,
                                   signed=False, dx=1, dy=1))
        out.append(Image(xsiz=w, ysiz=h, components=comps))
    return out


# (frames, profile function, EncoderParams arguments, profile arguments,
# test-scale caps (max_cs_bytes, max_comp_bytes) or None for the profile's)
CASES = {
    # the frame cap binds (the stream without it is 3.8x as long)
    "cinema2k_24_frame_cap": ((160, 96), "apply_cinema", {}, {"fps": 24},
                              (6000, 100000)),
    # the per-component cap binds (each component codes to ~7.5 kB with
    # the frame cap alone)
    "cinema2k_48_comp_cap": ((160, 96), "apply_cinema", {}, {"fps": 48},
                             (100000, 3000)),
    "cinema4k_24": ((256, 136), "apply_cinema", {"numresolutions": 7},
                    {"four_k": True}, (6000, 100000)),
    "broadcast": ((64, 48), "apply_broadcast", {"numresolutions": 7},
                  {"level": 3}, None),
    "imf2k": ((64, 48), "apply_imf", {"numresolutions": 9},
              {"variant": "2k", "mainlevel": 2, "sublevel": 1}, None),
    "imf2k_r": ((64, 48), "apply_imf", {"numresolutions": 9},
                {"variant": "2k_r", "mainlevel": 2, "sublevel": 1}, None),
}


def _profile(mod, params_cls, name, img, caps="case"):
    size, fn, params_kw, profile_kw, case_caps = CASES[name]
    prof = getattr(mod, fn)(params_cls(**params_kw), img, **profile_kw)
    caps = case_caps if caps == "case" else caps
    if caps is not None:
        prof.max_cs_bytes, prof.max_comp_bytes = caps
    return prof


@functools.lru_cache(maxsize=None)
def _case(name):
    """(reference frame, reference stream, port stream) of a case: frame
    0 of its size, each side's `encode_with_profile`."""
    img = _frames(1, *CASES[name][0])[0]
    want = ref_profiles.encode_with_profile(
        img, _profile(ref_profiles, EncoderParams, name, img), device=False)
    port_img = convert.image_from_reference(img)
    got = profiles.encode_with_profile(
        port_img, _profile(profiles, PortParams, name, port_img),
        device="cpu")
    return img, want, got


def _comp_bytes(cs):
    """Each component's packet bytes, by the port's packet index over the
    tile's tile-parts."""
    hdr = decoder.read_header(cs)
    bodies = {}
    for tp in decoder.iter_tile_parts(cs, hdr.main_header_end):
        bodies[tp.tile_index] = bodies.get(tp.tile_index, b"") + tp.body
    comp = [0] * len(hdr.siz.comps)
    for t, body in bodies.items():
        for (_l, _r, c, _p, _o, ln) in tile.index_tile_packets(body, hdr, t):
            comp[c] += ln
    return comp


def _ref_comp_bytes(cs):
    hdr = ref_decoder.read_header(cs)
    body = b"".join(tp.body for tp in ref_decoder.iter_tile_parts(
        cs, hdr.main_header_end))
    comp = [0] * len(hdr.siz.comps)
    for (_l, _r, c, _p, _o, ln) in ref_tile.index_tile_packets(body, hdr, 0):
        comp[c] += ln
    return comp


def test_constants_equal_reference():
    names = [n for n in dir(ref_profiles) if n.isupper()]
    assert len(names) > 20
    for n in names:
        assert getattr(profiles, n) == getattr(ref_profiles, n), n
    for rsiz in (0x0003, 0x0104, 0x04F2, 0x07A3):
        for fn in ("get_profile", "get_level", "get_imf_sublevel"):
            assert getattr(profiles, fn)(rsiz) == \
                getattr(ref_profiles, fn)(rsiz)
    for level in range(13):
        for rate in (0, 24, 25, 60):
            assert profiles.broadcast_max_cs_bytes(level, rate) == \
                ref_profiles.broadcast_max_cs_bytes(level, rate)
            assert profiles.imf_max_cs_bytes(level, rate) == \
                ref_profiles.imf_max_cs_bytes(level, rate)


def _grid_image(w, h, prec=12, ncomp=3, sub=1):
    """An image of w x h for the profiles' rules, which read its geometry
    and sample format only (its sample arrays are 1 x 1)."""
    comps = [Component(data=np.zeros((1, 1), np.int32), prec=prec,
                       signed=False, dx=sub if c else 1, dy=sub if c else 1)
             for c in range(ncomp)]
    return Image(xsiz=w, ysiz=h, components=comps)


APPLY_GRID = [
    ("cinema_2k_24", "apply_cinema", (2048, 1080), {}, {"fps": 24}),
    ("cinema_2k_48_layers", "apply_cinema", (2048, 1080),
     {"numlayers": 4, "numresolutions": 8, "tile_size": (256, 256)},
     {"fps": 48}),
    ("cinema_4k_nres7", "apply_cinema", (4096, 2160),
     {"numresolutions": 7}, {"four_k": True}),
    ("cinema_4k_nres1", "apply_cinema", (4096, 2160),
     {"numresolutions": 1}, {"four_k": True, "fps": 48}),
    ("cinema_4k_nres9", "apply_cinema", (4096, 2160),
     {"numresolutions": 9}, {"four_k": True}),
    ("broadcast_single", "apply_broadcast", (1920, 1080),
     {"numresolutions": 7}, {"level": 3}),
    ("broadcast_multi_fps", "apply_broadcast", (1920, 1080),
     {"rates": (10.0, 5.0)}, {"level": 5, "multi": True, "framerate": 25}),
    ("broadcast_multi_r", "apply_broadcast", (1920, 1080),
     {"numresolutions": 1}, {"level": 11, "reversible_multi": True,
                             "framerate": 60}),
    ("broadcast_msamples", "apply_broadcast", (512, 512), {},
     {"level": 1, "framerate": 600}),
    ("broadcast_tiles", "apply_broadcast", (256, 256),
     {"tile_size": (86, 86)}, {"level": 2, "multi": True}),
    ("imf_2k", "apply_imf", (2048, 1080), {"numresolutions": 9},
     {"variant": "2k", "mainlevel": 2, "sublevel": 1}),
    ("imf_2k_r_fps", "apply_imf", (2048, 1080), {"numresolutions": 9},
     {"variant": "2k_r", "mainlevel": 3, "sublevel": 1, "framerate": 25}),
    ("imf_4k", "apply_imf", (4096, 2160), {"numresolutions": 8},
     {"variant": "4k", "mainlevel": 4, "sublevel": 2, "framerate": 24}),
    ("imf_4k_r_tiles", "apply_imf", (4096, 2160),
     {"tile_size": (2048, 2048)}, {"variant": "4k_r", "mainlevel": 5}),
    ("imf_8k_r_small_tile", "apply_imf", (8192, 4320),
     {"tile_size": (512, 512)}, {"variant": "8k_r", "mainlevel": 6}),
    ("imf_sublevel_rule", "apply_imf", (128, 128), {},
     {"variant": "2k", "mainlevel": 1, "sublevel": 5}),
    ("imf_too_large", "apply_imf", (4096, 2160), {}, {"variant": "2k"}),
]


@pytest.mark.parametrize("name,fn,size,params_kw,profile_kw", APPLY_GRID,
                         ids=[g[0] for g in APPLY_GRID])
def test_apply_equals_reference(name, fn, size, params_kw, profile_kw):
    """The port's `apply_*` (and the validators they call) give the
    reference's parameters, rsiz, caps and warnings."""
    img = _grid_image(*size)
    want = getattr(ref_profiles, fn)(EncoderParams(**params_kw), img,
                                     **profile_kw)
    port_img = convert.image_from_reference(img)
    got = getattr(profiles, fn)(convert.params_from_reference(
        EncoderParams(**params_kw)), port_img, **profile_kw)
    assert got.params == convert.params_from_reference(want.params)
    assert (got.rsiz, got.max_cs_bytes, got.max_comp_bytes, got.warnings) \
        == (want.rsiz, want.max_cs_bytes, want.max_comp_bytes,
            want.warnings)


def test_validators_equal_reference():
    """Non-compliant requests: 17-bit and subsampled images, the
    broadcast and IMF validators on parameters the profiles did not
    make."""
    for img in (_grid_image(64, 64, prec=17, ncomp=1),
                _grid_image(64, 64, sub=2), _grid_image(64, 64, ncomp=5)):
        port_img = convert.image_from_reference(img)
        for params in (EncoderParams(), EncoderParams(
                cblk_w_exp=6, cblk_h_exp=6, precincts=[(8, 8)],
                progression=4, numlayers=2)):
            for rsiz in (0x0103, 0x0302, 0x0421, 0x0733):
                for ref_fn, fn in (
                        (ref_profiles.is_broadcast_compliant,
                         profiles.is_broadcast_compliant),
                        (ref_profiles.is_imf_compliant,
                         profiles.is_imf_compliant)):
                    assert fn(convert.params_from_reference(params),
                              port_img, rsiz, 30) == \
                        ref_fn(params, img, rsiz, 30)
        want = ref_profiles.apply_imf(EncoderParams(), img, "2k")
        got = profiles.apply_imf(convert.params_from_reference(
            EncoderParams()), port_img, "2k")
        assert (got.rsiz, got.warnings) == (want.rsiz, want.warnings)


def test_cinema_frame_cap_binds_and_holds():
    """Cinema 2K at 24 fps with a test-scale frame cap: the port's stream
    is the reference's, within the cap, which binds (the uncapped stream
    is longer), with the profile's rsiz, CPRL, 32x32 blocks and TLM."""
    name = "cinema2k_24_frame_cap"
    img, want, got = _case(name)
    assert got == want
    cap = CASES[name][4][0]
    assert len(got) <= cap
    free = ref_profiles.encode_with_profile(img, _profile(
        ref_profiles, EncoderParams, name, img, caps=(0, 0)), device=False)
    assert len(free) > 2 * cap
    hdr = decoder.read_header(got)
    assert hdr.siz.rsiz == profiles.PROFILE_CINEMA_2K
    assert hdr.tlm is not None
    assert (hdr.cod.cblk_w_exp, hdr.cod.cblk_h_exp) == (5, 5)
    assert int(hdr.cod.progression) == 4
    assert _comp_bytes(got) == _ref_comp_bytes(want)


def test_cinema_component_cap_binds_and_holds():
    """Cinema 2K at 48 fps with a test-scale per-component cap (the
    allocator's `simulate_comp_upto`): the port's stream is the
    reference's, every component's packet bytes within the cap, which
    binds (with the frame cap alone a component exceeds it)."""
    name = "cinema2k_48_comp_cap"
    img, want, got = _case(name)
    assert got == want
    cs_cap, comp_cap = CASES[name][4]
    comp = _comp_bytes(got)
    assert comp == _ref_comp_bytes(want)
    assert max(comp) <= comp_cap
    frame_only = ref_profiles.encode_with_profile(img, _profile(
        ref_profiles, EncoderParams, name, img, caps=(cs_cap, 0)),
        device=False)
    assert max(_ref_comp_bytes(frame_only)) > comp_cap
    assert len(frame_only) < cs_cap - 1024
    assert decoder.read_header(got).siz.rsiz == profiles.PROFILE_CINEMA_2K


def test_cinema_4k_with_poc():
    """Cinema 4K: two POC volumes (all but the top resolution, then the
    top), 6 decomposition levels, the 4K rsiz; the port's stream is the
    reference's, within its test-scale frame cap."""
    _, want, got = _case("cinema4k_24")
    assert got == want
    hdr = decoder.read_header(got)
    assert hdr.siz.rsiz == profiles.PROFILE_CINEMA_4K
    assert [(e.rs, e.re) for e in hdr.pocs] == [(0, 6), (6, 7)]
    assert hdr.cod.numresolutions == 7
    assert len(got) <= CASES["cinema4k_24"][4][0]


@pytest.mark.parametrize("name", ["broadcast", "imf2k", "imf2k_r"])
def test_broadcast_and_imf_equal_reference(name):
    """Broadcast single (9/7) and IMF 2K (9/7) and 2K_R (5/3) at the
    reference tests' settings: no frame cap without a frame rate, one
    tile-part a component (`tp_flag` "C"), the profile's rsiz."""
    _, want, got = _case(name)
    assert got == want
    hdr = decoder.read_header(got)
    assert hdr.siz.rsiz == ref_decoder.read_header(want).siz.rsiz != 0
    assert len(list(decoder.iter_tile_parts(got, hdr.main_header_end))) \
        == 3


def test_encode_batch_with_profile_equals_encode_with_profile():
    """Two frames through one `encode_batch(..., rsiz=, layer_alloc=)`
    (one allocator serves both) give each frame's `encode_with_profile`
    stream: the reference's for both, the port's for frame 0."""
    name = "cinema2k_24_frame_cap"
    imgs = _frames(2, *CASES[name][0])
    assert imgs[0].components[0].data.tobytes() == \
        _case(name)[0].components[0].data.tobytes()
    want = [ref_profiles.encode_with_profile(
        im, _profile(ref_profiles, EncoderParams, name, im), device=False)
        for im in imgs]
    assert want[0] == _case(name)[2]
    port_imgs = [convert.image_from_reference(im) for im in imgs]
    prof = _profile(profiles, PortParams, name, port_imgs[0])
    got = encoder.encode_batch(port_imgs, prof.params, device="cpu",
                               rsiz=prof.rsiz,
                               layer_alloc=profiles.profile_allocator(prof))
    assert got == want
    assert want[0] != want[1]


def test_cinema_stream_decodes_like_host_decoder():
    """The 4K stream (POC, TLM, rsiz 4, 256^2 precincts, 32x32 blocks,
    12 bits) through `decode_batch(device="cpu")` gives the reference
    host decoder's pixels."""
    _, want, got = _case("cinema4k_24")
    ref = ref_decoder.decode(want, device=False)
    (out,) = decoder.decode_batch([got], device="cpu")
    for a, b in zip(out.components, ref.components):
        np.testing.assert_array_equal(a.data, b.data)


def test_profile_allocator():
    prof = profiles.apply_cinema(convert.params_from_reference(
        EncoderParams()), convert.image_from_reference(
            _grid_image(2048, 1080)), fps=48)
    alloc = profiles.profile_allocator(prof)
    assert (alloc.rates, alloc.image_bytes, alloc.max_abs_bytes,
            alloc.max_comp_bytes) == ((1.0,), profiles.CINEMA_48_CS - 1024,
                                      profiles.CINEMA_48_CS - 1024,
                                      profiles.CINEMA_48_COMP)
    assert profiles.profile_allocator(dataclasses.replace(
        prof, max_cs_bytes=0)) is None


def test_ht_with_an_allocator_raises():
    """HT with an explicit rate allocator (a cinema profile's caps) codes
    as the reference's host encoder codes it: each block's cleanup goes
    to the allocator as one pass, on the HT coder's route, through
    `encode_with_profile` and `encode_batch(layer_alloc=)`; with
    refinement passes asked for, the allocator drops them, as the
    reference's does."""
    ref_img = _frames(1, 32, 24)[0]
    img = convert.image_from_reference(ref_img)
    prof = profiles.apply_cinema(convert.params_from_reference(
        EncoderParams()), img)
    ref_prof = ref_profiles.apply_cinema(EncoderParams(), ref_img)
    for refine in (False, True):
        ht = dataclasses.replace(prof, params=dataclasses.replace(
            prof.params, cblk_style=0x40, ht_refinement=refine))
        ref_ht = dataclasses.replace(ref_prof, params=dataclasses.replace(
            ref_prof.params, cblk_style=0x40, ht_refinement=refine))
        want = ref_profiles.encode_with_profile(ref_img, ref_ht,
                                                device=False)
        assert profiles.encode_with_profile(img, ht, device="cpu") == want
        assert encoder.encode_batch(
            [img], ht.params, device="cpu", rsiz=ht.rsiz,
            layer_alloc=profiles.profile_allocator(ht)) == [want]
