"""The port's fused HT lossless encode slice end to end, on the CPU.

`grokimagecompression_tpu_torch.codestream.encoder.encode_batch` must give
codestreams byte-identical to the reference's fused device encode
(`encoder.encode_batch(device=True)`, JAX on the CPU) and to the host
encoder (`encoder.encode(device=False)`). Both sides get the same numpy
frames and arguments: the port its own `Image` / `EncoderParams`
(`convert.image_from_reference` / `params_from_reference`). The port must
run, encode and decode where neither JAX nor the reference package can be
imported, and neither it nor `chip_smoke.py` may import either.
"""

import ast
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from grokimagecompression_tpu.codestream import decoder
from grokimagecompression_tpu.codestream import encoder as ref_encoder
from grokimagecompression_tpu.codestream import tile as ref_tile
from grokimagecompression_tpu.core.geometry import tile_rect as ref_tile_rect
from grokimagecompression_tpu.core.params import EncoderParams, Transform
from grokimagecompression_tpu.models import fused_encode as ref_fused
from grokimagecompression_tpu_torch import convert
from grokimagecompression_tpu_torch.codestream import encoder
from grokimagecompression_tpu_torch.codestream.tile import default_qcd
from grokimagecompression_tpu_torch.core.geometry import tile_rect
from grokimagecompression_tpu_torch.models import fused_encode
from grokimagecompression_tpu_torch.utils.device import resolve_device

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
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _frames(n, w, h, ncomp=1, seed=0):
    return [natural_image(w, h, ncomp=ncomp, seed=seed + i) for i in range(n)]


def _host(imgs, params):
    return [ref_encoder.encode(im, params, device=False) for im in imgs]


def _port_batch(imgs, params, **kw):
    """The port's encode_batch on the same frames and arguments."""
    return encoder.encode_batch(
        [convert.image_from_reference(im) for im in imgs],
        convert.params_from_reference(params), **kw)


def test_gray_matches_reference_device_and_host():
    imgs = _frames(3, 64, 64)
    params = EncoderParams(numresolutions=3, cblk_style=HT)
    got = _port_batch(imgs, params, device="cpu", chunk=2)
    assert got == ref_encoder.encode_batch(imgs, params, device=True)
    assert got == _host(imgs, params)
    for im, cs in zip(imgs, got):
        out = decoder.decode(cs, device=False)
        np.testing.assert_array_equal(out.components[0].data,
                                      im.components[0].data)


def test_rgb_matches_reference_device_and_host():
    imgs = _frames(2, 32, 24, ncomp=3, seed=4)
    params = EncoderParams(numresolutions=3, cblk_style=HT)
    got = _port_batch(imgs, params, device="cpu")
    assert got == ref_encoder.encode_batch(imgs, params, device=True)
    assert got == _host(imgs, params)


@pytest.mark.parametrize("name,imgs,params", [
    ("rgb_rct", _frames(2, 40, 36, ncomp=3, seed=4),
     EncoderParams(numresolutions=3, cblk_style=HT)),
    ("two_tiles", _frames(2, 64, 40, seed=8),
     EncoderParams(numresolutions=3, cblk_style=HT, tile_size=(40, 40),
                   cblk_w_exp=4, cblk_h_exp=4)),
    ("odd_origin_12bit", [natural_image(45, 27, seed=11, prec=12)],
     EncoderParams(numresolutions=4, cblk_style=HT, image_offset=(3, 5),
                   tile_offset=(1, 2))),
])
def test_matches_host(name, imgs, params):
    got = _port_batch(imgs, params, device="cpu")
    assert got == _host(imgs, params)


def _plans(img, params):
    rsiz = ref_encoder.build_siz(img, params)
    rcod = ref_encoder.build_cod(img, params)
    rqcd = ref_tile.default_qcd(rsiz, rcod, 1, params.base_step)
    rtr = ref_tile_rect(0, rsiz.xsiz, rsiz.ysiz, rsiz.xosiz, rsiz.yosiz,
                        rsiz.xtsiz, rsiz.ytsiz, rsiz.xtosiz, rsiz.ytosiz)
    pimg = convert.image_from_reference(img)
    pparams = convert.params_from_reference(params)
    siz = encoder.build_siz(pimg, pparams)
    cod = encoder.build_cod(pimg, pparams)
    tr = tile_rect(0, siz.xsiz, siz.ysiz, siz.xosiz, siz.yosiz,
                   siz.xtsiz, siz.ytsiz, siz.xtosiz, siz.ytosiz)
    ref_plan = ref_fused.build_plan(rsiz, rcod, rqcd, rtr, coder="ht")
    plan = fused_encode.build_plan(
        siz, cod, default_qcd(siz, cod, 1, params.base_step), tr)
    return ref_plan, plan


@pytest.mark.parametrize("size,ncomp,numres,transform", [
    (512, 1, 6, Transform.DWT_53),      # BASELINE config 1
    (75, 3, 4, Transform.DWT_53),
    (33, 1, 3, Transform.DWT_97),
])
def test_plan_from_reference_equals_build_plan(size, ncomp, numres,
                                               transform):
    img = natural_image(size, size - 3, ncomp=ncomp)
    ref_plan, plan = _plans(img, EncoderParams(
        numresolutions=numres, cblk_style=HT, transform=transform))
    # 9/7 too: its blocks carry their band stepsizes
    assert plan is not None
    assert plan.cfg.reversible == (transform == Transform.DWT_53)
    assert convert.plan_from_reference(ref_plan) == plan
    if size == 512:
        # config 1 (the frames are 512 x 509 here): three quad-shape groups
        assert [(qh, qw) for (qh, qw, _) in plan.groups][-1] == (32, 32)


def test_out_of_slice_raises():
    imgs = _frames(2, 16, 16)
    # MQ: only the default code-block style 0 is ported
    mq_styles = (0x01, 0x02, 0x04, 0x08, 0x10, 0x20)   # LAZY .. SEGSYM
    for params in tuple(EncoderParams(cblk_style=s) for s in mq_styles) + (
                   EncoderParams(cblk_style=0, transform=Transform.DWT_97,
                                 custom_mct=np.eye(3).tolist()),
                   EncoderParams(cblk_style=0, roi_comp=0, roi_shift=3),
                   EncoderParams(cblk_style=HT, ht_refinement=True)):
        with pytest.raises(NotImplementedError):
            _port_batch(imgs, params, device="cpu")


def test_cuda_request_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError):
        resolve_device("cuda")
    with pytest.raises(RuntimeError):
        _port_batch(_frames(1, 16, 16), EncoderParams(cblk_style=HT))
    assert resolve_device("cpu") == torch.device("cpu")


def test_port_runs_without_jax(monkeypatch):
    """Encode and decode round trips with both JAX and the reference
    package blocked, with the HT and the MQ coder; each stream equals the
    reference host encoder's, made in this process from the same frame.
    A 9/7 stream with two quality layers, encoded there too, decodes at
    its first layer to the reference host decoder's pixels (both with the
    numpy DWT), and the dense MQ scan runs. The MQ modules, the DWT
    kernel's wrapper and the rate control are imported there too, and
    `jp2`: a JP2 file of an HT stream with packed headers (PPM), wrapped
    there as the reference wraps it, decodes to the reference host
    decoder's pixels. So is `profiles`: a 12-bit cinema 2K encode with a
    frame cap equals the reference host encoder's `encode_with_profile`."""
    from grokimagecompression_tpu.core.params import DecoderParams
    from grokimagecompression_tpu.ops import dwt_host
    monkeypatch.setattr(dwt_host, "_get_native", lambda: None)
    monkeypatch.setenv("GROK_TPU_DWT", "python")
    rng = np.random.default_rng(5)
    data = rng.integers(0, 256, (64, 64)).astype(np.int32)
    params = EncoderParams(numresolutions=3, cblk_style=HT)
    want = ref_encoder.encode(convert_image(data), params, device=False)
    mq_params = EncoderParams(numresolutions=2, cblk_style=0)
    want_mq = ref_encoder.encode(convert_image(data[:8, :12]), mq_params,
                                 device=False)
    p97 = dict(numresolutions=2, numlayers=2, rates=(20.0, 5.0),
               cblk_w_exp=3, cblk_h_exp=3)
    small97 = natural_image(32, 24, seed=9).components[0].data
    want_97 = ref_encoder.encode(convert_image(small97), EncoderParams(
        transform=Transform.DWT_97, **p97), device=False)
    want_97_l1 = decoder.decode(want_97, DecoderParams(layers=1),
                                device=False).components[0].data
    from grokimagecompression_tpu.codestream import jp2 as ref_jp2
    ppm = ref_encoder.encode(convert_image(data[:32, :40]), EncoderParams(
        numresolutions=3, cblk_style=HT, cblk_w_exp=4, cblk_h_exp=4,
        ppm_markers=True), device=False)
    want_jp2 = ref_jp2.wrap_codestream(ppm, 40, 32, [(8, False)])
    want_ppm = decoder.decode(want_jp2, device=False).components[0].data
    from grokimagecompression_tpu.codestream import profiles as ref_profiles
    from grokimagecompression_tpu.core.image import Component, Image
    cin = Image(xsiz=40, ysiz=24, components=[Component(
        data=(data[:24, :40] * 16 + c).astype(np.int32), prec=12,
        signed=False, dx=1, dy=1) for c in range(3)])
    cin_prof = ref_profiles.apply_cinema(EncoderParams(), cin)
    cin_prof.max_cs_bytes = 2000
    want_cin = ref_profiles.encode_with_profile(cin, cin_prof, device=False)
    code = textwrap.dedent(f"""
        import sys
        sys.modules["jax"] = None
        sys.modules["grokimagecompression_tpu"] = None
        import numpy as np
        from grokimagecompression_tpu_torch.codestream import decoder, encoder
        from grokimagecompression_tpu_torch.core.image import Component, Image
        from grokimagecompression_tpu_torch.core.params import EncoderParams
        from grokimagecompression_tpu_torch.codestream import pcrd
        from grokimagecompression_tpu_torch.ops import (
            dwt, mq_dec, mq_dec_torch, mq_scan, mq_tables, mq_torch, quant)
        data = np.random.default_rng(5).integers(0, 256, (64, 64)).astype(
            np.int32)
        img = Image(xsiz=64, ysiz=64, components=[Component(
            data=data, prec=8, signed=False, dx=1, dy=1)])
        params = EncoderParams(numresolutions=3, cblk_style=0x40)
        (cs,) = encoder.encode_batch([img], params, device="cpu")
        assert cs.hex() == "{want.hex()}"
        (out,) = decoder.decode_batch([cs], device="cpu")
        assert np.array_equal(out.components[0].data, data)
        small = Image(xsiz=12, ysiz=8, components=[Component(
            data=data[:8, :12], prec=8, signed=False, dx=1, dy=1)])
        (cs,) = encoder.encode_batch(
            [small], EncoderParams(numresolutions=2, cblk_style=0),
            device="cpu")
        assert cs.hex() == "{want_mq.hex()}"
        (out,) = decoder.decode_batch([cs], device="cpu")
        assert np.array_equal(out.components[0].data, data[:8, :12])
        from grokimagecompression_tpu_torch.core.params import (
            DecoderParams, Transform)
        small97 = np.frombuffer(bytes.fromhex("{small97.astype('<i4').tobytes().hex()}"),
                                "<i4").reshape(24, 32)
        (cs,) = encoder.encode_batch(
            [Image(xsiz=32, ysiz=24, components=[Component(
                data=small97, prec=8, signed=False, dx=1, dy=1)])],
            EncoderParams(transform=Transform.DWT_97, **{p97!r}),
            device="cpu")
        assert cs.hex() == "{want_97.hex()}"
        (out,) = decoder.decode_batch([cs], DecoderParams(layers=1),
                                      device="cpu")
        assert out.components[0].data.astype("<i4").tobytes().hex() == \
            "{want_97_l1.astype('<i4').tobytes().hex()}"
        from grokimagecompression_tpu_torch.codestream import jp2
        wrapped = jp2.wrap_codestream(bytes.fromhex("{ppm.hex()}"), 40, 32,
                                      [(8, False)])
        assert wrapped.hex() == "{want_jp2.hex()}"
        (out,) = decoder.decode_batch([wrapped], device="cpu")
        assert out.components[0].data.astype("<i4").tobytes().hex() == \
            "{want_ppm.astype('<i4').tobytes().hex()}"
        from grokimagecompression_tpu_torch.codestream import profiles
        cin = Image(xsiz=40, ysiz=24, components=[Component(
            data=(data[:24, :40] * 16 + c).astype(np.int32), prec=12,
            signed=False, dx=1, dy=1) for c in range(3)])
        prof = profiles.apply_cinema(EncoderParams(), cin)
        prof.max_cs_bytes = 2000
        cs = profiles.encode_with_profile(cin, prof, device="cpu")
        assert cs.hex() == "{want_cin.hex()}"
        import torch
        words, mask, nbo, state = mq_scan.run_mq_scans(
            torch.ones((300, 4), dtype=torch.int8))
        assert state.shape == (mq_tables.DENSE_NSTATE, 4)
        assert not any(m.split(".")[0] in ("jax", "grokimagecompression_tpu")
                       for m in sys.modules if sys.modules[m] is not None)
        print("OK")
    """)
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().endswith("OK")


def convert_image(data):
    from grokimagecompression_tpu.core.image import Component, Image
    return Image(xsiz=data.shape[1], ysiz=data.shape[0], components=[
        Component(data=data, prec=8, signed=False, dx=1, dy=1)])


def _imported_modules(path):
    """Every module an import statement of the file names, including
    imports inside functions."""
    names = []
    for node in ast.walk(ast.parse(open(path).read())):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.append(node.module)
    return names


def test_port_package_never_imports_jax():
    pkg = os.path.join(REPO, "grokimagecompression_tpu_torch")
    paths = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, files in os.walk(pkg):
        paths += [os.path.join(root, f) for f in files if f.endswith(".py")]
    assert len(paths) > 20
    for path in paths:
        text = open(path).read()
        assert "import jax" not in text, path
        assert "from jax" not in text, path
        for mod in _imported_modules(path):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "grokimagecompression_tpu"), \
                f"{path} imports {mod}"
