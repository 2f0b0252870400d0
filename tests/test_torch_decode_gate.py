"""The port's batch decode gate, held to the reference's, on the CPU.

`grokimagecompression_tpu_torch.codestream.decoder.decode_batch` takes
what the reference's `decode_batch` sends to its device decode: JP2
files, COC overrides that keep the COD's transform, resolution count and
code-block style, QCC, POC, and packed packet headers (PPM, PPT). Each
case gives the port and the reference the same numpy inputs:

- the corpus streams of that gate (`tests/corpus/`): the port's jobs,
  component plans and decode plans against the reference's
  `decode_tile(..., _return_jobs=True)`, captured inside its own
  `decode_batch` where it hands them to its device (no T1 runs);
- pixel decodes against the reference host decoder: its own widened-gate
  HT cases (3 frames of 96x64 RGB: tiled, tiled RPCL, PPM, POC),
  `ppm_tiled.j2k`, `container.jp2`, a 2-layer MQ PPT stream at
  `layers=1` and an RGB MQ COC stream;
- 9/7 streams with a QCC spliced in for component 1 (QCD's exponents,
  other mantissas), against the host decoder with its numpy DWT
  (`dwt_host._get_native` None, `GROK_TPU_DWT=python`), which the port's
  DWT equals;
- the port's `encode_batch` with COC + POC + PPM and with PPT, byte for
  byte against the host encoder; on 9/7 with the HT coder at a fixed
  step the decoded pixels do not depend on code-block size, progression,
  packed headers or container (what `chip_smoke.py` phase 15 rests on);
- `codestream/jp2.py` against the reference's;
- streams outside the gate raise NotImplementedError.

The reference's host codec imports no JAX at module level, so the `gpu`
case (the CUDA decode of a COC + POC + PPM HT stream against the CPU
decode) runs where only torch is: `GROK_TPU_TESTS=1 python -m pytest
tests/test_torch_decode_gate.py -m gpu`.
"""

import contextlib
import dataclasses
import os
import struct

import numpy as np
import pytest
import torch

from grokimagecompression_tpu.codestream import decoder as ref_decoder
from grokimagecompression_tpu.codestream import encoder as ref_encoder
from grokimagecompression_tpu.codestream import jp2 as ref_jp2
from grokimagecompression_tpu.codestream import markers as ref_markers
from grokimagecompression_tpu.core.image import Component, Image
from grokimagecompression_tpu.core.params import DecoderParams as RefParams
from grokimagecompression_tpu.core.params import (EncoderParams, Progression,
                                                  Transform)
from grokimagecompression_tpu_torch import convert
from grokimagecompression_tpu_torch.codestream import (decoder, encoder, jp2,
                                                       markers)
from grokimagecompression_tpu_torch.core.params import DecoderParams

from conftest import natural_image


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Torch on one thread: the plain versions run many small CPU ops, and
    under pytest-xdist's workers torch's OpenMP threads oversubscribe the
    cores and spin (a case of 2.4 s alone took 43 s among six workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


HT = 0x40
CORPUS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "corpus")
# the corpus streams inside the reference's device gate that the port
# refused before it took JP2, COC / QCC, POC and PPM / PPT
GATE_STREAMS = ["container.jp2", "jp2_gray16.jp2", "jp2_rgb.jp2",
                "multicomp5_coc.j2k", "poc_2seg.j2k", "ppm_tiled.j2k",
                "ppt_tiled.j2k", "tileparts_ppt.j2k"]
# the corpus streams outside it: ROI, a custom MCT, non-default MQ styles
OUT_OF_GATE = ["custom_mct.j2k", "poc_roi.j2k", "roi_shift6.j2k",
               "sty_all_part1.j2k", "sty_lazy.j2k", "sty_lazy_termall.j2k",
               "sty_pterm.j2k", "sty_reset.j2k", "sty_reset_vsc_segsym.j2k",
               "sty_segsym.j2k", "sty_termall.j2k", "sty_vsc.j2k",
               "styles_lazy_termall.j2k"]
POCS = (ref_markers.PocEntry(rs=0, cs=0, lye=1, re=2, ce=3,
                             prog=Progression.RLCP),
        ref_markers.PocEntry(rs=2, cs=0, lye=1, re=3, ce=3,
                             prog=Progression.CPRL))


def _corpus(name):
    with open(os.path.join(CORPUS, name), "rb") as f:
        return f.read()


def _encode(imgs, params):
    return [ref_encoder.encode(im, params, device=False) for im in imgs]


def _asdict(x):
    return dataclasses.asdict(x)


def _assert_decodes_like_host(streams, layers=0, chunk=32):
    """The port's decode_batch(device="cpu") of `streams` against the
    reference host decoder's pixels, frame by frame."""
    got = decoder.decode_batch(streams, DecoderParams(layers=layers),
                               device="cpu", chunk=chunk)
    assert len(got) == len(streams)
    for cs, out in zip(streams, got):
        want = ref_decoder.decode(cs, RefParams(layers=layers), device=False)
        assert (out.x0, out.y0, out.xsiz, out.ysiz) == \
            (want.x0, want.y0, want.xsiz, want.ysiz)
        assert len(out.components) == len(want.components)
        for c, (g, w) in enumerate(zip(out.components, want.components)):
            assert g.data.dtype == np.int32
            np.testing.assert_array_equal(g.data, w.data, err_msg=f"comp {c}")
    return got


@contextlib.contextmanager
def _numpy_dwt():
    """The reference host codec with its numpy DWT only: `dwt_host`'s
    dispatch and the decoder's packed native inverse, which only
    GROK_TPU_DWT=python turns off."""
    from grokimagecompression_tpu.ops import dwt_host
    native, env = dwt_host._get_native, os.environ.get("GROK_TPU_DWT")
    dwt_host._get_native = lambda: None
    os.environ["GROK_TPU_DWT"] = "python"
    try:
        yield
    finally:
        dwt_host._get_native = native
        if env is None:
            del os.environ["GROK_TPU_DWT"]
        else:
            os.environ["GROK_TPU_DWT"] = env


class _AtDevice(Exception):
    """Raised where the reference's decode_batch submits to its device."""


def _reference_jobs(monkeypatch, data):
    """The reference's `decode_tile(..., _return_jobs=True)` results of
    every tile of one stream, taken inside its own `decode_batch(device=
    True)`: its gate, JP2 unwrap and packed-header handoff run, and the
    run stops where it would submit the first chunk to its device (so a
    stream it sends to its host path fails here)."""
    from grokimagecompression_tpu.models import fused_decode as ref_fd
    calls = []
    orig = ref_decoder.decode_tile

    def recorded(*args, **kwargs):
        calls.append(orig(*args, **kwargs))
        return calls[-1]

    def at_device(*args, **kwargs):
        raise _AtDevice()

    monkeypatch.setattr(ref_decoder, "decode_tile", recorded)
    monkeypatch.setattr(ref_fd, "decode_tiles_device_submit", at_device)
    with pytest.raises(_AtDevice):
        ref_decoder.decode_batch([data], device=True)
    return calls


def _slot_key(slot):
    c, key, cb = slot
    r = cb.geom.rect
    return (c, tuple(key), r.x0, r.y0, r.x1, r.y1, cb.numbps, cb.numpasses)


def _plan_lanes(plans):
    """Every code-block of a tile's component plans by block (w, h), as
    DecBlock slots: what the port's decode plan must hold."""
    groups = {}
    for c, p in enumerate(plans):
        for res in p.layout.resolutions:
            for band in res.bands:
                for prc in band.precincts:
                    for cb in prc.cblks:
                        groups.setdefault((cb.rect.w, cb.rect.h), []).append(
                            (c, (res.r, band.orient),
                             cb.rect.y0 - band.rect.y0,
                             cb.rect.x0 - band.rect.x0))
    return [(w, h, tuple(groups[(w, h)])) for (w, h) in sorted(groups)]


def _plan_steps(plans, reversible):
    """Each band's stepsize in the decode plan's band order."""
    keys = [(0, 0)] + [(r, o) for r in range(
        1, len(plans[0].layout.resolutions)) for o in (1, 2, 3)]
    return tuple(1.0 if reversible else float(p.bands[k].stepsize)
                 for p in plans for k in keys)


def _assert_parse_equals_reference(monkeypatch, data):
    """The port's parse_batch and tile_groups of one stream against the
    reference's batch-decode jobs: every job (data, segment lengths, w, h,
    orient, numbps, numpasses, kmax) and slot, every component plan and
    COD, and each decode plan's lanes (block shapes and positions) and
    band stepsizes. Returns the decode plans."""
    hdr, trs, parsed = decoder.parse_batch([data])
    groups = decoder.tile_groups(hdr, trs, parsed)
    want = _reference_jobs(monkeypatch, data)
    assert len(want) == len(trs)
    reversible = hdr.cod.transform == Transform.DWT_53
    for t, (tag, w_jobs, w_slots, w_plans, w_cods) in enumerate(want):
        assert tag == "jobs"
        jobs, slots, plans, cods = parsed[0][0][t]
        assert jobs == w_jobs
        assert [_slot_key(s) for s in slots] == \
            [_slot_key(s) for s in w_slots]
        assert [_asdict(p) for p in plans] == [_asdict(p) for p in w_plans]
        assert [_asdict(c) for c in cods] == [_asdict(c) for c in w_cods]
    assert sorted(t for tiles in groups.values() for t in tiles) == \
        sorted(set().union(*(tiles for _, tiles in parsed)))
    for plan, tiles in groups.items():
        for t in tiles:
            assert [(w, h, tuple(b.slot for b in lanes))
                    for (w, h, lanes) in plan.groups] == \
                _plan_lanes(want[t][3])
            assert plan.stepsizes == _plan_steps(want[t][3], reversible)
    return groups


@pytest.mark.parametrize("name", GATE_STREAMS)
def test_corpus_parse_equals_reference(monkeypatch, name):
    groups = _assert_parse_equals_reference(monkeypatch, _corpus(name))
    if name == "multicomp5_coc.j2k":
        # COC gives components 1 and 3 16x16 and 32x16 blocks beside the
        # main 64x64, which cover the others' 48x40 bands whole
        (plan,) = groups
        shapes = {c: {(w, h) for (w, h, lanes) in plan.groups
                      for b in lanes if b.comp == c} for c in range(5)}
        assert all(w <= 16 and h <= 16 for w, h in shapes[1])
        assert all(w <= 32 and h <= 16 for w, h in shapes[3])
        assert shapes[0] == shapes[2] == shapes[4] == {(24, 20), (48, 40)}


def _widened_gate_frames():
    """The reference's own widened-gate frames
    (`tests/test_device_decode.py`): 3 of 96x64 RGB noise, seed 9."""
    rng = np.random.default_rng(9)
    frames = []
    for _ in range(3):
        comps = [Component(data=rng.integers(0, 256, (64, 96))
                           .astype(np.int32), prec=8, signed=False,
                           dx=1, dy=1) for _ in range(3)]
        frames.append(Image(xsiz=96, ysiz=64, components=comps))
    return frames


WIDENED = [
    ("tiled", dict(tile_size=(32, 32))),
    ("tiled_rpcl", dict(tile_size=(32, 32), progression=Progression.RPCL)),
    ("ppm", dict(tile_size=(32, 32), ppm_markers=True)),
    ("poc", dict(pocs=POCS)),
]


@pytest.mark.parametrize("name,kw", WIDENED, ids=[c[0] for c in WIDENED])
def test_reference_widened_gate_cases_decode_like_host(name, kw):
    frames = _widened_gate_frames()
    streams = _encode(frames, EncoderParams(numresolutions=3,
                                            cblk_style=HT, **kw))
    got = _assert_decodes_like_host(streams, chunk=2)
    for im, out in zip(frames, got):
        for a, b in zip(out.components, im.components):
            np.testing.assert_array_equal(a.data, b.data)


@pytest.mark.parametrize("name", ["ppm_tiled.j2k", "container.jp2"])
def test_corpus_streams_decode_like_host(name):
    _assert_decodes_like_host([_corpus(name)])


def test_mq_ppt_stream_decodes_first_layer_like_host():
    """A 64x64 gray MQ stream of two quality layers with PPT markers, at
    layers=1 (the packed-header parse's layer limit) and at all layers."""
    img = natural_image(64, 64, seed=21)
    (cs,) = _encode([img], EncoderParams(
        numresolutions=3, cblk_style=0, cblk_w_exp=4, cblk_h_exp=4,
        numlayers=2, rates=(12.0, 0.0), ppt_markers=True))
    hdr = decoder.read_header(cs)
    assert hdr.cod.numlayers == 2 and hdr.ppm_sections is None
    first = _assert_decodes_like_host([cs], layers=1)[0]
    full = _assert_decodes_like_host([cs])[0]
    assert not np.array_equal(first.components[0].data,
                              full.components[0].data)
    np.testing.assert_array_equal(full.components[0].data,
                                  img.components[0].data)


def test_mq_coc_stream_decodes_like_host():
    """A 64x64 RGB MQ stream whose COC gives component 1 8x8 blocks beside
    the others' 16x16: two lane groups of the MQ decoder, one plan."""
    imgs = [natural_image(64, 64, ncomp=3, seed=23)]
    streams = _encode(imgs, EncoderParams(
        numresolutions=3, cblk_style=0, cblk_w_exp=4, cblk_h_exp=4,
        comp_cblk_exps={1: (3, 3)}))
    hdr, trs, parsed = decoder.parse_batch(streams)
    (plan,) = decoder.tile_groups(hdr, trs, parsed)
    assert {(w, h) for (w, h, _) in plan.groups} >= {(8, 8), (16, 16)}
    got = _assert_decodes_like_host(streams)
    for im, out in zip(imgs, got):
        for a, b in zip(out.components, im.components):
            np.testing.assert_array_equal(a.data, b.data)


def _splice_main(cs: bytes, segment: bytes) -> bytes:
    """`segment` inserted at the end of the main header (before the first
    SOT)."""
    end = ref_decoder.read_header(cs).main_header_end
    return cs[:end] + segment + cs[end:]


def _qcc_mantissas(cs: bytes, compno: int) -> bytes:
    """A stream with a QCC for `compno` that keeps the QCD's exponents
    (so every band's Mb) and takes other mantissas: the same packets,
    other stepsizes for that component."""
    hdr = ref_decoder.read_header(cs)
    qcd = hdr.qcd
    qcc = dataclasses.replace(qcd, steps=tuple(
        (e, (m + 517 + 97 * i) % 2048) for i, (e, m) in enumerate(qcd.steps)))
    return _splice_main(cs, ref_markers.write_qcc(compno, qcc,
                                                  len(hdr.siz.comps)))


@pytest.mark.parametrize("coder", [HT, 0], ids=["ht", "mq"])
def test_97_qcc_stream_decodes_like_host(monkeypatch, coder):
    imgs = [natural_image(32, 32, ncomp=3, seed=s) for s in (31, 32)]
    params = EncoderParams(numresolutions=3, transform=Transform.DWT_97,
                           cblk_style=coder, cblk_w_exp=4, cblk_h_exp=4)
    with _numpy_dwt():
        streams = [_qcc_mantissas(cs, 1) for cs in _encode(imgs, params)]
        hdr = decoder.read_header(streams[0])
        assert hdr.qcd_comp[1] is not None and hdr.qcd_comp[0] is None
        groups = _assert_parse_equals_reference(monkeypatch, streams[0])
        (plan,) = groups
        nb = len(plan.stepsizes) // 3
        assert plan.stepsizes[nb:2 * nb] != plan.stepsizes[:nb]
        assert plan.stepsizes[2 * nb:] == plan.stepsizes[:nb]
        got = _assert_decodes_like_host(streams)
        plain = decoder.decode_batch(_encode(imgs[:1], params), device="cpu")
    # the QCC changes component 1's pixels and nothing else
    assert not np.array_equal(got[0].components[1].data,
                              plain[0].components[1].data)
    np.testing.assert_array_equal(got[0].components[0].data,
                                  plain[0].components[0].data)


ENCODES = [
    ("ht_coc_poc_ppm", [natural_image(64, 48, ncomp=3, seed=s)
                        for s in (41, 42)],
     EncoderParams(numresolutions=3, cblk_style=HT, cblk_w_exp=5,
                   cblk_h_exp=5, comp_cblk_exps={1: (4, 4), 2: (4, 4)},
                   pocs=POCS, ppm_markers=True)),
    ("ht_tiled_ppt", [natural_image(64, 48, seed=s) for s in (43, 44)],
     EncoderParams(numresolutions=3, cblk_style=HT, tile_size=(32, 32),
                   ppt_markers=True)),
    ("mq_coc_ppm", [natural_image(32, 24, ncomp=3, seed=45)],
     EncoderParams(numresolutions=2, cblk_style=0, cblk_w_exp=4,
                   cblk_h_exp=4, comp_cblk_exps={0: (3, 3)},
                   ppm_markers=True)),
]


@pytest.mark.parametrize("name,imgs,params", ENCODES,
                         ids=[c[0] for c in ENCODES])
def test_encode_batch_with_gate_markers_equals_host(name, imgs, params):
    """The port's encode_batch(device="cpu") with COC + POC + PPM and with
    PPT: streams byte-identical to the host encoder's, which its
    decode_batch then returns exactly."""
    port_params = convert.params_from_reference(params)
    assert all(isinstance(e, markers.PocEntry) for e in port_params.pocs)
    got = encoder.encode_batch([convert.image_from_reference(im)
                                for im in imgs], port_params, device="cpu")
    assert got == _encode(imgs, params)
    for im, out in zip(imgs, decoder.decode_batch(got, device="cpu")):
        for a, b in zip(out.components, im.components):
            np.testing.assert_array_equal(a.data, b.data)


def test_ht97_pixels_do_not_depend_on_blocks_order_or_headers():
    """At a fixed base step the HT coder codes every quantized
    coefficient in one cleanup pass, so the decoded pixels of a 9/7 frame
    are the same whatever its code-block sizes (COC), packet order (POC),
    packed headers (PPM) or container (JP2): the ground on which
    `chip_smoke.py` phase 15 holds such streams to the plain streams'
    digests."""
    imgs = [convert.image_from_reference(natural_image(80, 48, ncomp=3,
                                                       seed=51))]
    base = dict(numresolutions=4, transform=Transform.DWT_97, cblk_style=HT)
    plain = encoder.encode_batch(imgs, convert.params_from_reference(
        EncoderParams(**base)), device="cpu")
    gated = encoder.encode_batch(imgs, convert.params_from_reference(
        EncoderParams(comp_cblk_exps={1: (4, 4), 2: (4, 4)}, ppm_markers=True,
                      pocs=(ref_markers.PocEntry(
                          rs=0, cs=0, lye=1, re=2, ce=3,
                          prog=Progression.RLCP),
                          ref_markers.PocEntry(
                              rs=2, cs=0, lye=1, re=4, ce=3,
                              prog=Progression.CPRL)), **base)),
        device="cpu")
    assert gated != plain
    wrapped = [jp2.wrap_codestream(cs, 80, 48, [(8, False)] * 3)
               for cs in gated]
    want = decoder.decode_batch(plain, device="cpu")
    for out, ref in zip(decoder.decode_batch(wrapped, device="cpu"), want):
        for a, b in zip(out.components, ref.components):
            np.testing.assert_array_equal(a.data, b.data)


@pytest.mark.parametrize("name", ["container.jp2", "jp2_gray16.jp2",
                                  "jp2_rgb.jp2"])
def test_jp2_reads_like_reference(name):
    data = _corpus(name)
    assert jp2.is_jp2(data) and ref_jp2.is_jp2(data)
    got_hdr, got_cs = jp2.read_jp2(data)
    want_hdr, want_cs = ref_jp2.read_jp2(data)
    assert got_cs == want_cs == jp2.extract_codestream(data)
    assert _asdict(got_hdr) == _asdict(want_hdr)
    assert not jp2.is_jp2(got_cs)


WRAPS = [
    dict(comps=[(8, False)] * 3),
    dict(comps=[(16, False)]),
    dict(comps=[(12, True), (8, False), (8, False)], colourspace=18,
         capture_resolution=(2834.6, 2834.6), display_resolution=(72.0, 96.0),
         xml=b"<x/>", channel_defs=[(0, 0, 1), (1, 0, 2), (2, 1, 0)]),
    dict(comps=[(8, False)], icc_profile=b"\x00" * 16),
]


@pytest.mark.parametrize("kw", WRAPS, ids=[str(i) for i in range(len(WRAPS))])
def test_jp2_wraps_like_reference(kw):
    cs = _corpus("ht_lossless.j2k")
    got = jp2.wrap_codestream(cs, 64, 48, **kw)
    assert got == ref_jp2.wrap_codestream(cs, 64, 48, **kw)
    assert jp2.extract_codestream(got) == cs
    assert _asdict(jp2.read_jp2(got)[0]) == _asdict(ref_jp2.read_jp2(got)[0])


class _AtHost(Exception):
    """Raised where the reference's decode_batch falls back to its host
    decode."""


def test_corpus_gate_equals_reference(monkeypatch):
    """Over the whole corpus, the port admits a stream exactly when the
    reference's decode_batch sends it to its device decode (47 of 60)."""
    from grokimagecompression_tpu.models import fused_decode as ref_fd

    def at_device(*args, **kwargs):
        raise _AtDevice()

    def at_host(*args, **kwargs):
        raise _AtHost()

    monkeypatch.setattr(ref_fd, "decode_tiles_device_submit", at_device)
    monkeypatch.setattr(ref_decoder, "decode", at_host)
    names = sorted(n for n in os.listdir(CORPUS)
                   if n.endswith((".j2k", ".jp2")))
    admitted = []
    for name in names:
        data = _corpus(name)
        with pytest.raises((_AtDevice, _AtHost)) as where:
            ref_decoder.decode_batch([data], device=True)
        try:
            decoder.parse_batch([data])
        except NotImplementedError:
            assert where.type is _AtHost, name
        else:
            assert where.type is _AtDevice, name
            admitted.append(name)
    assert len(names) == 60 and len(admitted) == 47
    assert sorted(set(names) - set(admitted)) == sorted(OUT_OF_GATE)
    assert set(GATE_STREAMS) <= set(admitted)


@pytest.mark.parametrize("name", OUT_OF_GATE)
def test_out_of_gate_corpus_streams_raise(name):
    with pytest.raises(NotImplementedError):
        decoder.decode_batch([_corpus(name)], device="cpu")


def _tile_part_override(cs: bytes) -> bytes:
    """A COD copy spliced into the first tile-part's header (its Psot
    grown to match)."""
    hdr = ref_decoder.read_header(cs)
    pos = hdr.main_header_end
    assert struct.unpack(">H", cs[pos:pos + 2])[0] == ref_markers.SOT
    seg = ref_markers.write_cod(hdr.cod)
    psot = struct.unpack(">I", cs[pos + 6:pos + 10])[0]
    return (cs[:pos + 6] + struct.pack(">I", psot + len(seg))
            + cs[pos + 10:pos + 12] + seg + cs[pos + 12:])


def test_out_of_gate_streams_raise():
    """Tile-part header overrides, ROI, an unbatchable COC (another
    resolution count, transform or code-block style), and a batch whose
    streams differ in their COC, POC or packed headers raise
    NotImplementedError; none falls back to a host decode."""
    img = natural_image(32, 32, ncomp=3, seed=61)
    params = EncoderParams(numresolutions=3, cblk_style=HT)
    (cs,) = _encode([img], params)
    hdr = ref_decoder.read_header(cs)
    bad = [_tile_part_override(cs)]
    bad += _encode([img], EncoderParams(numresolutions=3, roi_comp=0,
                                        roi_shift=3))
    for change in (dict(numresolutions=2), dict(transform=Transform.DWT_97),
                   dict(cblk_style=HT | 0x08)):
        bad.append(_splice_main(cs, ref_markers.write_coc(
            1, dataclasses.replace(hdr.cod, **change), 3)))
    for stream in bad:
        with pytest.raises(NotImplementedError):
            decoder.decode_batch([stream], device="cpu")
    coc = _encode([img], EncoderParams(numresolutions=3, cblk_style=HT,
                                       comp_cblk_exps={1: (4, 4)}))
    poc = _encode([img], EncoderParams(numresolutions=3, cblk_style=HT,
                                       pocs=POCS))
    ppm = _encode([img], EncoderParams(numresolutions=3, cblk_style=HT,
                                       ppm_markers=True))
    for other in (coc, poc, ppm):
        with pytest.raises(NotImplementedError):
            decoder.decode_batch([cs] + other, device="cpu")
        decoder.parse_batch(other + other)


@pytest.mark.gpu
def test_cuda_decode_of_coc_poc_ppm_equals_cpu():
    """decode_batch on the card (the HT decoder on two block shapes, the
    DWT kernel) equals the CPU decode of a COC + POC + PPM HT stream, and
    on 9/7 with a QCC."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from grokimagecompression_tpu_torch.native import ht_prepass
    from grokimagecompression_tpu_torch.ops import dwt, ht_dec
    for transform in (Transform.DWT_53, Transform.DWT_97):
        imgs = [convert.image_from_reference(natural_image(
            160, 96, ncomp=3, seed=s)) for s in (71, 72, 73)]
        streams = encoder.encode_batch(imgs, convert.params_from_reference(
            EncoderParams(numresolutions=4, cblk_style=HT,
                          transform=transform, comp_cblk_exps={
                              1: (4, 4), 2: (4, 4)}, pocs=POCS,
                          ppm_markers=True)), device="cpu")
        if transform == Transform.DWT_97:
            hdr = decoder.read_header(streams[0])
            qcc = markers.write_qcc(1, dataclasses.replace(
                hdr.qcd, steps=tuple((e, (m + 517) % 2048)
                                     for e, m in hdr.qcd.steps)), 3)
            end = hdr.main_header_end
            streams = [cs[:end] + qcc + cs[end:] for cs in streams]
        ht_dec.LAUNCHES["dec"] = 0
        dwt.LAUNCHES["dwt"] = 0
        ht_prepass.CALLS["prepass"] = 0
        got = decoder.decode_batch(streams, device="cuda", chunk=2)
        assert ht_dec.LAUNCHES["dec"] >= 2 and dwt.LAUNCHES["dwt"] >= 1
        assert ht_prepass.CALLS["prepass"] == 0
        want = decoder.decode_batch(streams, device="cpu")
        for g, w in zip(got, want):
            for a, b in zip(g.components, w.components):
                np.testing.assert_array_equal(a.data, b.data)
