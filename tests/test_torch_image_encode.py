"""The port's per-image encode and the codec's encode API, on the CPU.

`grokimagecompression_tpu_torch.codestream.encoder.encode(device="cpu")`
(the plain HT and MQ coders and `dwt_torch`) must equal the reference's
host `encoder.encode(device=False)` byte for byte on the small frames of
`chip_smoke.image_encode_frames` (72x56 gray and RGB at image offset (5,
3) in 32x32 or 16x16 tiles, several plans, interior tiles sharing one; a
smooth 64x64 RGB frame for HT rate control) at every
`chip_smoke.IMG_ENC_CASES`
entry (the cases whose reference digests `chip_smoke.py` holds the card
to): HT 5/3, MQ 5/3 with a POC, MQ 9/7 in three layers at byte targets
with per-tile and image-wide (`rate_alloc="global"`) allocation, MQ 9/7
at PSNR targets with image-wide allocation, HT 9/7 at ratio 24, tile-parts
split by resolution with PLT and TLM, PPT, PPM and a COC. Both packages'
`EncoderParams` are made from the same arguments. Same-plan tiles are
coded together: one device call a plan.

`codec.compress` on each of the reference's routes, `Codec` on every
preset in both containers and `compress_batch` against the reference's
and against sequential `compress`; `encode_batch` of mixed geometries
and with `rate_alloc="global"` against `encode`; the port's
`GlobalPCRDAllocator` against the reference's on the same tile contexts,
and an error in it or in a tile before it reaching every tile; and
`codec.decompress_batch` on streams that `decode_batch` cannot take
together (COC, POC) against each stream's lone decode.

The reference runs with its numpy DWT (`dwt_host._get_native` None and
GROK_TPU_DWT=python): its native 9/7 DWT rounds differently from
`dwt_np`, which the port's DWT equals bit for bit.
"""

import functools
import os
import sys
import threading

import numpy as np
import pytest
import torch

from grokimagecompression_tpu import codec as ref_codec
from grokimagecompression_tpu.codestream import encoder as ref_encoder
from grokimagecompression_tpu.codestream import markers as ref_markers
from grokimagecompression_tpu.codestream import pcrd as ref_pcrd
from grokimagecompression_tpu.codestream import t2 as ref_t2
from grokimagecompression_tpu.core import params as ref_params
from grokimagecompression_tpu.core.image import Component as RefComponent
from grokimagecompression_tpu.core.image import Image as RefImage
from grokimagecompression_tpu.ops import dwt_host
from grokimagecompression_tpu.t1 import t1_np
from grokimagecompression_tpu_torch import codec
from grokimagecompression_tpu_torch.codestream import encoder, markers, pcrd
from grokimagecompression_tpu_torch.codestream import t2 as port_t2
from grokimagecompression_tpu_torch.core import params
from grokimagecompression_tpu_torch.core.geometry import CodeBlock, Rect
from grokimagecompression_tpu_torch.models import fused_encode

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
import chip_smoke  # noqa: E402

CASES = list(chip_smoke.IMG_ENC_CASES)
# a joined thread that is still alive after this long is a deadlock
JOIN_S = 60


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
    monkeypatch.setattr(dwt_host, "_get_native", lambda: None)
    monkeypatch.setenv("GROK_TPU_DWT", "python")


@functools.lru_cache(maxsize=None)
def _frames():
    return chip_smoke.image_encode_frames()


def _ref_image(im):
    return RefImage(xsiz=im.xsiz, ysiz=im.ysiz, components=[RefComponent(
        data=c.data, prec=c.prec, signed=c.signed, dx=c.dx, dy=c.dy)
        for c in im.components])


def _params(case, ref=False):
    if ref:
        return chip_smoke.image_encode_params(ref_params,
                                              ref_markers.PocEntry, case)
    return chip_smoke.image_encode_params(params, markers.PocEntry, case)


@functools.lru_cache(maxsize=None)
def _port_stream(case):
    frame = chip_smoke.IMG_ENC_CASES[case][0]
    return encoder.encode(_frames()[frame], _params(case), device="cpu")


@functools.lru_cache(maxsize=None)
def _ref_stream(case):
    frame = chip_smoke.IMG_ENC_CASES[case][0]
    return ref_encoder.encode(_ref_image(_frames()[frame]),
                              _params(case, ref=True), device=False)


@pytest.mark.parametrize("case", CASES)
def test_encode_matches_reference(case):
    assert _port_stream(case) == _ref_stream(case)


def test_global_allocation_differs_from_per_tile():
    """The image-wide cases are not the per-tile ones under another name:
    the allocation moves bytes between tiles, within the budget."""
    glob, tile = _port_stream("mq97_layers_global"), _port_stream(
        "mq97_layers")
    assert glob != tile
    image_bytes = 72 * 56
    assert len(glob) <= image_bytes / 3.0 + 600


def test_same_plan_tiles_code_together(monkeypatch):
    """`encode` stacks the tiles of each plan into one device call: as
    many calls as plans, every tile coded once, interior tiles together."""
    stacks = []
    submit = fused_encode.encode_tile_submit

    def rec(comps, enc):
        stacks.append((enc.plan, comps[0].shape[0]))
        return submit(comps, enc)
    monkeypatch.setattr(fused_encode, "encode_tile_submit", rec)
    img = _frames()["rgb"]
    p = _params("ht53")
    assert encoder.encode(img, p, device="cpu") == _ref_stream("ht53")
    plans = [plan for plan, _ in stacks]
    assert len(set(plans)) == len(plans) >= 4
    assert sum(n for _, n in stacks) == len(encoder._coding(img, p)[5])
    assert max(n for _, n in stacks) >= 4


def test_plan_chunks_collected_behind_the_next(monkeypatch):
    """With two tiles a chunk, a plan's tiles take several calls; each
    chunk is collected once the next is submitted, so at most two are on
    the device at once, and the stream does not change."""
    monkeypatch.setattr(encoder, "_capped_chunk",
                        lambda chunk, *a, **kw: min(chunk, 2))
    live, most, sizes = [0], [0], []
    submit = fused_encode.encode_tile_submit
    collect = fused_encode.encode_tile_collect

    def rec_submit(comps, enc):
        sizes.append(comps[0].shape[0])
        live[0] += 1
        most[0] = max(most[0], live[0])
        return submit(comps, enc)

    def rec_collect(handle):
        live[0] -= 1
        return collect(handle)
    monkeypatch.setattr(fused_encode, "encode_tile_submit", rec_submit)
    monkeypatch.setattr(fused_encode, "encode_tile_collect", rec_collect)
    img = _frames()["rgb"]
    p = _params("ht53")
    assert encoder.encode(img, p, device="cpu") == _ref_stream("ht53")
    assert max(sizes) == 2 and sum(sizes) == encoder.tile_count(img, p)
    assert len(sizes) > 4 and most[0] == 2 and live[0] == 0


@pytest.mark.parametrize("route", list(chip_smoke.IMG_COMPRESS))
def test_compress_matches_reference(route):
    a = chip_smoke.compress_array(_frames(), route)
    opts = chip_smoke.IMG_COMPRESS[route]
    assert codec.compress(a, device="cpu", **opts) == \
        ref_codec.compress(a, device=False, **opts)


@pytest.mark.parametrize("preset", list(ref_codec.PRESETS))
def test_codec_presets_match_reference(preset):
    assert list(codec.PRESETS) == list(ref_codec.PRESETS)
    img = _frames()["small"]
    for container in ("j2k", "jp2"):
        got = codec.Codec(preset=preset, container=container,
                          device="cpu").compress_image(img)
        want = ref_codec.Codec(preset=preset, container=container,
                               device=False).compress_image(_ref_image(img))
        assert got == want, container
    if preset == "lossless_fast":
        out = codec.Codec(device="cpu").decompress_image(got)
        np.testing.assert_array_equal(out.components[0].data,
                                      img.components[0].data)


def test_compress_batch_equals_sequential(monkeypatch):
    """Untiled arrays of one shape go through one `encode_batch` call, an
    array alone through `encode`; the streams are sequential
    `compress`'s, in input order, in both containers."""
    rng = np.random.default_rng(21)
    arrays = [rng.integers(0, 256, (24, 16, 3), dtype=np.int32)
              for _ in range(3)]
    arrays.insert(1, rng.integers(0, 256, (16, 8), dtype=np.int32))
    calls = []
    batch = encoder.encode_batch

    def rec(imgs, *a, **kw):
        calls.append(len(imgs))
        return batch(imgs, *a, **kw)
    monkeypatch.setattr(encoder, "encode_batch", rec)
    for container in ("j2k", "jp2"):
        got = codec.compress_batch(arrays, ht=True, container=container,
                                   device="cpu")
        assert got == [codec.compress(a, ht=True, container=container,
                                      device="cpu") for a in arrays]
    assert calls == [3, 3]
    assert codec.compress_batch([], device="cpu") == []


def test_compress_batch_of_tiled_arrays_encodes_each(monkeypatch):
    """Tiled arrays of one shape go through `encode` one image at a time
    (its same-plan tiles stacked), not `encode_batch`, which launches once
    a tile position; the streams are sequential `compress`'s."""
    rng = np.random.default_rng(22)
    arrays = [rng.integers(0, 256, (24, 16, 3), dtype=np.int32)
              for _ in range(2)]
    monkeypatch.setattr(encoder, "encode_batch", None)
    opts = dict(ht=True, tile_size=(8, 8))
    assert codec.compress_batch(arrays, device="cpu", **opts) == \
        [codec.compress(a, device="cpu", **opts) for a in arrays]


def test_encode_batch_of_mixed_geometries_equals_encode():
    frames = _frames()
    p = _params("ht53")
    # each frame's `encode` once (the ht53 case's frame is cached)
    one = {k: _port_stream("ht53") if k == chip_smoke.IMG_ENC_CASES[
        "ht53"][0] else encoder.encode(frames[k], p, device="cpu")
        for k in ("rgb", "gray")}
    assert encoder.encode_batch([frames[k] for k in ("rgb", "gray", "rgb")],
                                p, device="cpu") == \
        [one[k] for k in ("rgb", "gray", "rgb")]


def test_encode_batch_global_equals_encode():
    """The chunked path with one image-wide allocator a frame, two frames
    coded together and their T2 on the batch's pool."""
    img = _frames()["gray"]
    got = encoder.encode_batch([img, img], _params("mq97_layers_global"),
                               device="cpu")
    assert got == [_port_stream("mq97_layers_global")] * 2


def _tiles(mod_t2, pass_info, ntiles, seed):
    """`ntiles` lists of 12 code-blocks of the given T2 module with random
    monotone R-D tables (a few with no passes), tile t's content scaled
    by 4^t so the slopes differ between tiles."""
    rng = np.random.default_rng(seed)
    tiles = []
    for t in range(ntiles):
        cbs = []
        for i in range(12):
            npas = int(rng.integers(0, 16)) if (i + t) % 5 else 0
            rates = np.cumsum(rng.integers(1, 40, npas))
            dists = np.cumsum(rng.random(npas) * 100.0 * 4.0 ** t)
            passes = [pass_info(rate=int(r), distortion=float(d),
                                terminated=k == npas - 1)
                      for k, (r, d) in enumerate(zip(rates, dists))]
            cbs.append(mod_t2.CblkEnc(
                geom=CodeBlock(rect=Rect(0, 0, 4, 4), cx=i % 4, cy=i // 4),
                data=bytes(int(rates[-1]) if npas else 0), numbps=5,
                imsb=2, numpasses=npas, passes=passes))
        tiles.append(cbs)
    return tiles


def _run_tiles(alloc, ctxs):
    """Each context handed to `alloc` on its own thread, in reverse tile
    order; returns each thread's exception or None."""
    errors = [None] * len(ctxs)

    def one(i):
        try:
            alloc(ctxs[i])
        except BaseException as e:      # recorded for the test to read
            errors[i] = e
    threads = [threading.Thread(target=one, args=(i,), daemon=True)
               for i in reversed(range(len(ctxs)))]
    for th in threads:
        th.start()
    for th in threads:
        th.join(JOIN_S)
    assert not any(th.is_alive() for th in threads), "a tile still waits"
    return errors


def _ctxs(mod, tiles, numlayers, fail_tile=None):
    ctxs = []
    for t, cbs in enumerate(tiles):
        def sim(layer, cbs=cbs, t=t):
            if t == fail_tile:
                raise ValueError("simulator failure")
            return sum(cb.pass_bytes(0, sum(cb.layer_npasses[:layer + 1]))
                       + 3 for cb in cbs)
        ctxs.append(mod.RateControlCtx(
            cblks=cbs, numlayers=numlayers, tile_samples=4096,
            image_samples=4096 * len(tiles), max_prec=8,
            simulate_upto=sim, tile_index=t))
    return ctxs


@pytest.mark.parametrize("rates,psnr", [((24.0, 8.0, 3.0), ()),
                                        ((6.0, 0.0), ()),
                                        ((), (20.0, 30.0))])
def test_global_allocator_equals_reference(rates, psnr):
    class RefT2:
        CblkEnc = ref_t2.CblkEnc
    nl = max(len(rates), len(psnr))
    got = []
    for mod, t2, pass_info in ((pcrd, port_t2, port_t2.PassInfo),
                               (ref_pcrd, RefT2, t1_np.PassInfo)):
        tiles = _tiles(t2, pass_info, 5, seed=7)
        alloc = mod.GlobalPCRDAllocator(rates=rates, quality_psnr=psnr,
                                        image_bytes=4096 * 5, numtiles=5)
        assert _run_tiles(alloc, _ctxs(mod, tiles, nl)) == [None] * 5
        got.append([[list(cb.layer_npasses) for cb in cbs]
                    for cbs in tiles])
    assert got[0] == got[1]


def test_global_allocator_error_reaches_every_tile():
    tiles = _tiles(port_t2, port_t2.PassInfo, 4, seed=8)
    alloc = pcrd.GlobalPCRDAllocator(rates=(8.0,), image_bytes=4096 * 4,
                                     numtiles=4)
    errors = _run_tiles(alloc, _ctxs(pcrd, tiles, 1, fail_tile=2))
    assert all(e is not None for e in errors)
    assert sum(isinstance(e, ValueError) for e in errors) == 1
    assert all(isinstance(e, (ValueError, RuntimeError)) for e in errors)


def test_tile_failing_before_the_allocator_releases_the_others(
        monkeypatch):
    """A tile whose T2 raises before it registers with the image-wide
    allocator makes `write_codestream` raise, not wait for it forever (the
    other tiles register synthetic contexts)."""
    img = _frames()["gray"]
    p = _params("mq97_layers_global")
    ntiles = len(encoder._coding(img, p)[5])
    ctxs = _ctxs(pcrd, _tiles(port_t2, port_t2.PassInfo, ntiles, seed=5), 3)

    def tile_t2(segs, *a, layer_alloc=None, tile_index=-1, **kw):
        if tile_index == ntiles // 2:
            raise ValueError("tile failure")
        layer_alloc(ctxs[tile_index])
    monkeypatch.setattr(encoder, "encode_tile", tile_t2)
    errors = []

    def run():
        try:
            encoder.write_codestream(img, p, dict.fromkeys(range(ntiles)))
        except BaseException as e:      # recorded for the test to read
            errors.append(e)
    th = threading.Thread(target=run, daemon=True)
    th.start()
    th.join(JOIN_S)
    assert not th.is_alive(), "write_codestream waits for a failed tile"
    assert len(errors) == 1


def test_decompress_batch_of_streams_the_gate_keeps_apart():
    """HT streams with and without a COC, MQ streams with and without a
    POC, and a plain stream again, in one call: each decodes as it does
    alone (decode_batch refuses streams whose COC / POC differ)."""
    rng = np.random.default_rng(9)
    rgb = rng.integers(0, 256, (32, 32, 3), dtype=np.int32)
    gray = rng.integers(0, 256, (16, 16), dtype=np.int32)
    E = ref_params.EncoderParams
    ht = dict(numresolutions=3, cblk_style=0x40, cblk_w_exp=3, cblk_h_exp=3)
    mq = dict(numresolutions=3, cblk_w_exp=3, cblk_h_exp=3)
    poc = (ref_markers.PocEntry(rs=0, cs=0, lye=1, re=2, ce=1,
                                prog=ref_params.Progression.RLCP),
           ref_markers.PocEntry(rs=2, cs=0, lye=1, re=3, ce=1,
                                prog=ref_params.Progression.CPRL))
    streams = [
        ref_codec.Codec(params=E(**ht), device=False).compress_image(
            ref_codec.to_image(rgb)),
        ref_codec.Codec(params=E(**ht, comp_cblk_exps={1: (4, 4)}),
                        device=False).compress_image(ref_codec.to_image(rgb)),
        ref_codec.Codec(params=E(**mq), device=False).compress_image(
            ref_codec.to_image(gray)),
        ref_codec.Codec(params=E(**mq, pocs=poc), device=False
                        ).compress_image(ref_codec.to_image(gray)),
    ]
    streams.append(streams[0])
    got = codec.decompress_batch(streams, device="cpu")
    for cs, out in zip(streams, got):
        np.testing.assert_array_equal(out, codec.decompress(cs,
                                                            device="cpu"))
    for out, src in zip(got, (rgb, rgb, gray, gray, rgb)):
        np.testing.assert_array_equal(out, src)


@pytest.mark.parametrize("kw,exc", [
    # the HT coder with its refinement passes, with the bypass mode switch
    # and without: coded on the host coders' route
    (dict(cblk_style=0x41, ht_refinement=True), None),
    (dict(cblk_style=0x40, ht_refinement=True), None),
    (dict(transform=ref_params.Transform.DWT_53,
          custom_mct=np.eye(3).tolist()), ValueError),
    (dict(cblk_style=0x40, roi_comp=0, roi_shift=3), ValueError)],
    ids=["mq_style", "ht_refinement", "custom_mct", "roi"])
def test_host_t1_requests_raise(kw, exc):
    """The requests the reference codes on its host: HT refinement passes
    (and the MQ code-block styles, tests/test_torch_t1_styles.py) code
    through `encode` and `Codec` to the reference host encoder's streams
    (the refinement's own cases: tests/test_torch_ht_refine.py); a
    custom MCT and ROI are coded on the device now
    (tests/test_torch_host_routes.py), so their cases are the
    reference's own refusals: a custom MCT off 9/7 and ROI with the HT
    coder raise its ValueError, on both sides."""
    img = _frames()["rgb"]
    p = params.EncoderParams(**{k: (params.Transform(v) if k == "transform"
                                    else v) for k, v in kw.items()})
    if exc is None:
        want = ref_encoder.encode(_ref_image(img), ref_params.EncoderParams(
            **kw), device=False)
        assert encoder.encode(img, p, device="cpu") == want
        assert codec.Codec(params=p, device="cpu").compress_image(img) \
            == want
        return
    with pytest.raises(ValueError):
        ref_encoder.encode(_ref_image(img), ref_params.EncoderParams(
            **kw), device=False)
    with pytest.raises(exc):
        encoder.encode(img, p, device="cpu")
    with pytest.raises(exc):
        codec.Codec(params=p, device="cpu").compress_image(img)


def test_cuda_request_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    img = _frames()["gray"]
    with pytest.raises(RuntimeError):
        encoder.encode(img)
    with pytest.raises(RuntimeError):
        codec.compress(codec.from_image(img))
    with pytest.raises(RuntimeError):
        codec.Codec().compress_image(img)
