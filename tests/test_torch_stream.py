"""The port's streaming codestream API, held to the reference's, on the CPU.

`grokimagecompression_tpu_torch.codestream.stream` is a copy of the
reference's `codestream/stream.py` over the port's device encode and
decode. At the cases of the reference's own `tests/test_stream.py` (MQ
and HT, several tiles, a file path and a file object, the TLM patched on
close, the SOT scan of a stream without TLM, a window within a tile,
raster order and completion) plus PPT, PLT, 9/7 and odd image and tile
origins, on the same seeded numpy inputs:

- `StreamEncoder`'s file equals the reference `StreamEncoder`'s byte for
  byte (`device="cpu"`: the kernels' plain versions);
- `StreamDecoder.decode_tile` and `decode` equal the reference's
  `StreamDecoder` pixel for pixel, and its tile index equals the
  reference's;
- the requests the reference's stream encoder refuses raise its
  ValueError, and HT refinement passes are coded as the reference's host
  encoder codes them (its `StreamEncoder` drops them);
- `StreamEncoder` gives each tile the fused plan `encoder.encode`
  gives it, and the tiles of one plan share one encoder.

The images are small and smooth, with 16x16 code-blocks where the MQ
coder runs (its plain version takes one torch step a coding decision).
"""

import dataclasses
import io

import numpy as np
import pytest
import torch

from grokimagecompression_tpu.codestream import stream as ref_stream
from grokimagecompression_tpu.core.params import DecoderParams as RefParams
from grokimagecompression_tpu.core.params import (EncoderParams, Progression,
                                                  Transform)
from grokimagecompression_tpu_torch import convert
from grokimagecompression_tpu_torch.codestream import decoder, encoder, stream
from grokimagecompression_tpu_torch.core.geometry import (tile_grid_size,
                                                          tile_rect)
from grokimagecompression_tpu_torch.core.params import DecoderParams
from grokimagecompression_tpu_torch.models import fused_encode

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
MQ16 = dict(cblk_w_exp=4, cblk_h_exp=4)
CASES = [
    ("mq", (64, 48, 3), dict(numresolutions=3, tile_size=(32, 32), **MQ16)),
    ("ht", (96, 80, 1), dict(numresolutions=4, tile_size=(48, 48),
                             cblk_style=HT)),
    ("ht_ppt_plt", (72, 56, 3), dict(numresolutions=3, tile_size=(32, 32),
                                     cblk_style=HT, ppt_markers=True,
                                     plt_markers=True)),
    ("ht_odd_origins", (77, 61, 3), dict(numresolutions=3,
                                         tile_size=(24, 20),
                                         image_offset=(5, 3),
                                         tile_offset=(2, 1),
                                         cblk_style=HT)),
    ("mq97", (64, 48, 3), dict(numresolutions=3, tile_size=(32, 32),
                               transform=Transform.DWT_97,
                               progression=Progression.RPCL, **MQ16)),
    ("ht97_comment", (64, 64, 1), dict(numresolutions=3, tile_size=(32, 32),
                                       transform=Transform.DWT_97,
                                       cblk_style=HT, base_step=0.5,
                                       comment="streamed")),
]
IDS = [c[0] for c in CASES]
_CACHE = {}


def _image(w, h, nc, seed=1):
    return natural_image(w, h, ncomp=nc, seed=seed)


def _files(name):
    """(reference image, reference params, the reference StreamEncoder's
    bytes, the port StreamEncoder's bytes) of a CASES entry, written tile
    by tile into file objects; made once."""
    if name not in _CACHE:
        _, (w, h, nc), kw = CASES[IDS.index(name)]
        img = _image(w, h, nc)
        params = EncoderParams(**kw)
        bufs = []
        for side in ("ref", "port"):
            buf = io.BytesIO()
            if side == "ref":
                se = ref_stream.StreamEncoder(buf, img, params)
                tile_img = img
            else:
                tile_img = convert.image_from_reference(img)
                se = stream.StreamEncoder(
                    buf, tile_img, convert.params_from_reference(params),
                    device="cpu")
            for t in range(se.numtiles):
                se.write_image_tile(t, tile_img)
            se.close()
            bufs.append(buf.getvalue())
        _CACHE[name] = (img, params, *bufs)
    return _CACHE[name]


def _same_image(got, want):
    assert (got.x0, got.y0, got.xsiz, got.ysiz) == \
        (want.x0, want.y0, want.xsiz, want.ysiz)
    assert len(got.components) == len(want.components)
    for g, w in zip(got.components, want.components):
        assert g.data.dtype == np.int32
        np.testing.assert_array_equal(g.data, w.data)


@pytest.mark.parametrize("name", IDS)
def test_stream_file_equals_reference(name):
    img, params, want, got = _files(name)
    assert got == want
    hdr = decoder.read_header(got)
    ntx, nty = tile_grid_size(hdr.siz.xsiz, hdr.siz.ysiz, hdr.siz.xosiz,
                              hdr.siz.yosiz, hdr.siz.xtsiz, hdr.siz.ytsiz,
                              hdr.siz.xtosiz, hdr.siz.ytosiz)
    # the TLM reserved in the main header was patched with real lengths
    assert len(hdr.tlm) == ntx * nty > 1
    assert all(ln > 0 for (_, ln) in hdr.tlm)


@pytest.mark.parametrize("name", ["mq", "ht_ppt_plt", "ht_odd_origins"])
def test_stream_decoder_equals_reference(name):
    """Every tile, a window within a middle tile, and the whole image,
    through the port's StreamDecoder (file object, no mmap) and the
    reference's; lossless streams also against the source."""
    img, params, want_cs, cs = _files(name)
    sd = stream.StreamDecoder(io.BytesIO(cs), device="cpu")
    ref = ref_stream.StreamDecoder(io.BytesIO(want_cs))
    assert sd.numtiles == ref.numtiles
    assert sd._index == ref._index
    for t in range(sd.numtiles):
        assert sd.tile_parts(t) == ref.tile_parts(t)
        _same_image(sd.decode_tile(t), ref.decode_tile(t))
    s = sd.header.siz
    mid = sd.numtiles // 2
    tr = tile_rect(mid, s.xsiz, s.ysiz, s.xosiz, s.yosiz, s.xtsiz, s.ytsiz,
                   s.xtosiz, s.ytosiz)
    win = (tr.x0 + 2, tr.y0 + 1, tr.x1 - 3, tr.y1 - 2)
    _same_image(sd.decode_tile(mid, DecoderParams(window=win)),
                ref.decode_tile(mid, RefParams(window=win)))
    whole = sd.decode()
    _same_image(whole, ref.decode())
    for g, w in zip(whole.components, img.components):
        np.testing.assert_array_equal(g.data, w.data[s.yosiz:, s.xosiz:])
    with pytest.raises(ValueError):
        sd.decode_tile(sd.numtiles)


def test_stream_decoder_file_path_mmap_and_sot_scan(tmp_path):
    """A file path through StreamEncoder and StreamDecoder (memory map),
    and a stream without TLM (`encoder.encode`), whose index the
    decoder builds by hopping SOTs: tiles and index equal to the
    reference's."""
    img, params, _, cs = _files("ht")
    path = str(tmp_path / "s.j2k")
    port_img = convert.image_from_reference(img)
    with stream.StreamEncoder(path, port_img,
                              convert.params_from_reference(params),
                              device="cpu") as se:
        for t in range(se.numtiles):
            se.write_image_tile(t, port_img)
    assert open(path, "rb").read() == cs
    plain = encoder.encode(port_img, convert.params_from_reference(params),
                           device="cpu")
    assert decoder.read_header(plain).tlm is None
    nopath = str(tmp_path / "n.j2k")
    open(nopath, "wb").write(plain)
    for p in (path, nopath):
        with stream.StreamDecoder(p, device="cpu") as sd, \
                ref_stream.StreamDecoder(p) as ref:
            assert sd._mm is not None
            assert sd._index == ref._index and len(sd._index) == 4
            for t in (0, 3):
                _same_image(sd.decode_tile(t), ref.decode_tile(t))
    with stream.StreamDecoder(open(nopath, "rb"), use_mmap=False,
                              device="cpu") as sd:
        assert sd._mm is None
        _same_image(sd.decode_tile(1), decoder.decode(
            plain, DecoderParams(tile_index=1), device="cpu"))


def test_stream_encoder_order_completion_and_close(tmp_path):
    """The reference's rules: raster order, every tile before close, no
    write after close (ValueError each), close idempotent; the file then
    equals the reference's."""
    img = _image(64, 32, 1, seed=5)
    pimg = convert.image_from_reference(img)
    params = EncoderParams(tile_size=(32, 32), numresolutions=2,
                           cblk_style=HT)
    files = {}
    for side in ("ref", "port"):
        path = str(tmp_path / f"{side}.j2k")
        if side == "ref":
            se = ref_stream.StreamEncoder(path, img, params)
            im = img
        else:
            se = stream.StreamEncoder(path, pimg,
                                      convert.params_from_reference(params),
                                      device="cpu")
            im = pimg
        with pytest.raises(ValueError, match="in order"):
            se.write_image_tile(1, im)
        se.write_image_tile(0, im)
        with pytest.raises(ValueError, match="tiles written"):
            se.close()
        se.write_image_tile(1, im)
        se.close()
        se.close()
        with pytest.raises(ValueError, match="closed"):
            se.write_image_tile(2, im)
        files[side] = open(path, "rb").read()
    assert files["port"] == files["ref"]


@pytest.mark.parametrize("kw,exc", [
    (dict(rates=(20.0,)), ValueError),
    (dict(quality_psnr=(30.0,)), ValueError),
    (dict(ppm_markers=True), ValueError),
    (dict(transform=Transform.DWT_97,
          custom_mct=[[1.0, 0.0, 0.0], [0.0, 1.0, 0.0], [0.0, 0.0, 1.0]]),
     ValueError),
    # the HT coder with its refinement passes, with the bypass mode
    # switch and without: coded
    (dict(cblk_style=HT | 0x01, ht_refinement=True), None),
    (dict(cblk_style=HT, ht_refinement=True), None),
], ids=["rates", "psnr", "ppm", "custom_mct", "mq_lazy", "ht_refinement"])
def test_stream_encoder_refusals(kw, exc):
    """What the reference's stream encoder refuses raises its ValueError
    on both sides. HT refinement passes are coded: the port's file equals
    the reference host encoder's stream with TLM, refinement and all,
    while the reference's `StreamEncoder` drops the refinement (its file
    equals the host encoder's plain HT stream; ROADMAP Queue C)."""
    from grokimagecompression_tpu.codestream import encoder as ref_encoder
    img = _image(32, 32, 3, seed=8)
    params = EncoderParams(tile_size=(16, 16), numresolutions=2, **kw)
    if exc is ValueError:
        with pytest.raises(ValueError):
            ref_stream.StreamEncoder(io.BytesIO(), img, params)
        with pytest.raises(exc):
            stream.StreamEncoder(io.BytesIO(),
                                 convert.image_from_reference(img),
                                 convert.params_from_reference(params),
                                 device="cpu")
        return
    files = {}
    for side, mod, im, p in (
            ("ref", ref_stream, img, params),
            ("port", stream, convert.image_from_reference(img),
             convert.params_from_reference(params))):
        buf = io.BytesIO()
        se = mod.StreamEncoder(buf, im, p, **(
            {"device": "cpu"} if side == "port" else {}))
        for t in range(se.numtiles):
            se.write_image_tile(t, im)
        se.close()
        files[side] = buf.getvalue()
    host = {r: ref_encoder.encode(img, dataclasses.replace(
        params, tlm_markers=True, ht_refinement=r), device=False)
        for r in (True, False)}
    assert host[True] != host[False]
    assert files["port"] == host[True]
    assert files["ref"] == host[False]


@pytest.mark.parametrize("kw", [
    dict(numresolutions=4, tile_size=(40, 36), image_offset=(3, 5)),
    dict(numresolutions=3, tile_size=(32, 24), cblk_w_exp=3, cblk_h_exp=4,
         precincts=((4, 4), (3, 3), (3, 3))),
    dict(numresolutions=5, tile_size=(64, 64), cblk_w_exp=3, cblk_h_exp=3,
         precincts=((5, 5),)),
], ids=["offsets", "precincts", "one_precinct_size"])
def test_stream_encoders_shared_by_plan(kw):
    """`StreamEncoder` gives each tile the fused encoder of its plan
    through `encoder.plan_encoder`, as `encoder.encode` does: the same
    plan as `encoder._tile_encoders` gives the tile, one encoder for
    every tile of one plan, and fewer encoders than tiles (the interior
    tiles share one)."""
    img = convert.image_from_reference(_image(200, 150, 2, seed=3))
    p = convert.params_from_reference(EncoderParams(cblk_style=HT, **kw))
    se = stream.StreamEncoder(io.BytesIO(), img, p, device="cpu")
    siz, cod, qcd = se.siz, se.cod, se.qcd
    ntx, nty = tile_grid_size(siz.xsiz, siz.ysiz, siz.xosiz, siz.yosiz,
                              siz.xtsiz, siz.ytsiz, siz.xtosiz, siz.ytosiz)
    trs = [tile_rect(t, siz.xsiz, siz.ysiz, siz.xosiz, siz.yosiz,
                     siz.xtsiz, siz.ytsiz, siz.xtosiz, siz.ytosiz)
           for t in range(ntx * nty)]
    got = [se.encoder_for(tr) for tr in trs]
    want = encoder._tile_encoders(p, siz, cod, qcd, None, trs,
                                  torch.device("cpu"), False)
    assert [e.plan for e in got] == [e.plan for e in want]
    for i in range(len(trs)):
        for j in range(len(trs)):
            assert (got[i] is got[j]) == (
                fused_encode.build_plan(siz, cod, qcd, trs[i])
                == fused_encode.build_plan(siz, cod, qcd, trs[j])), (i, j)
    assert len(se._encoders) < len(trs)
