"""The port's command-line tools (`grokimagecompression_tpu_torch/cli/`)
held to the reference's, on the CPU.

The cases of the reference's tests/test_cli.py run through both
packages' tools on the same input files: the reference on its host
route, the port with `--torch-device cpu` (the kernels' plain versions).
Every file they write must be byte-equal, and grk_dump's and compare's
printed text equal. Images are small (48 x 40 gray, 32 x 24 RGB) and
smooth: the plain MQ coder takes a torch step a coding decision.

JP2 files with a palette, an opacity channel, an ICC profile and CIELab
go through the decode's colour policy on both sides. Also:
`--ht-refinement` codes and decodes to the reference tools' files; ROI
with the HT coder fails on both sides; a CUDA request on a machine
without CUDA ends with the reason, a non-zero exit code and no file; the flag lines that `chip_smoke.py` phase 21 runs at
BASELINE widths make the library's streams of the digest files'
parameters; `codec.compress_batch` / `decompress_batch` take `workers=`
and give the same outputs; the tools run with JAX and the reference
blocked; and `data/cli.json`, the reference tools' digests of
`chip_smoke.CLI_CASES` on `chip_smoke.cli_inputs`, is current.

The reference runs with its numpy DWT (`_numpy_dwt`): its native 9/7 DWT
rounds differently from `dwt_np`, which the port's DWT equals.

Run `PYTHONPATH=.:tests python tests/test_torch_cli.py` from the
repository root to rewrite `data/cli.json`.
"""

import contextlib
import hashlib
import io
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from grokimagecompression_tpu import codec as ref_codec
from grokimagecompression_tpu.cli import compare as ref_compare
from grokimagecompression_tpu.cli import compress as ref_compress
from grokimagecompression_tpu.cli import decompress as ref_decompress
from grokimagecompression_tpu.cli import dump as ref_dump
from grokimagecompression_tpu.codestream import encoder as ref_encoder
from grokimagecompression_tpu.core import params as ref_params
from grokimagecompression_tpu.io import pnm as ref_pnm
from grokimagecompression_tpu_torch import codec
from grokimagecompression_tpu_torch.cli import (common, compare, compress,
                                                decompress, dump)
from grokimagecompression_tpu_torch.codestream import decoder, encoder
from grokimagecompression_tpu_torch.core.params import EncoderParams
from grokimagecompression_tpu_torch.io import pnm
from grokimagecompression_tpu_torch.native import t1_native

from test_torch_host_copies import _numpy_dwt

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
import chip_smoke  # noqa: E402

CLI_DIGESTS = os.path.join(REPO, chip_smoke.CLI_DIGESTS)
REF = {"compress": ref_compress, "decompress": ref_decompress,
       "dump": ref_dump}
PORT = {"compress": compress, "decompress": decompress, "dump": dump}
CPU = ["--torch-device", "cpu"]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Torch on one thread: under pytest-xdist's workers torch's OpenMP
    threads oversubscribe the cores and spin."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def smooth(h, w, ncomps=1, seed=0):
    """(h, w, ncomps) uint8: waves plus a little noise."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    return np.stack([(128 + 60 * np.sin(y / (6.0 + c)) * np.cos(x / 8.0)
                      + rng.normal(0, 3, (h, w))).clip(0, 255)
                     for c in range(ncomps)], axis=-1).astype(np.uint8)


def pnm_bytes(a):
    h, w, n = a.shape
    return f"P{5 if n == 1 else 6}\n{w} {h}\n255\n".encode() + a.tobytes()


class Sides:
    """The reference's and the port's tools side by side, each in a
    directory of its own holding the same inputs; "@name" in an argument
    list is a file in the side's directory."""

    def __init__(self, root):
        self.dirs = {"ref": root / "ref", "port": root / "port"}
        for d in self.dirs.values():
            d.mkdir()

    def write(self, name, data: bytes):
        for d in self.dirs.values():
            (d / name).parent.mkdir(parents=True, exist_ok=True)
            (d / name).write_bytes(data)

    def args(self, side, argv):
        return [str(self.dirs[side] / a[1:]) if a.startswith("@") else a
                for a in argv]

    def run(self, tool, argv):
        """Run `tool` on both sides; both must exit 0."""
        with _numpy_dwt():
            rc = REF[tool].main(self.args("ref", argv))
        extra = CPU if tool != "dump" else []
        assert (rc, PORT[tool].main(self.args("port", argv) + extra)) == \
            (0, 0)

    def same(self, *names):
        """Each named file equal on both sides; returns the port's bytes."""
        out = []
        for n in names:
            a = (self.dirs["ref"] / n).read_bytes()
            assert (self.dirs["port"] / n).read_bytes() == a, n
            out.append(a)
        return out[0] if len(out) == 1 else out

    def dump(self, capsys, argv):
        """grk_dump's printed text on both sides, which must be equal."""
        capsys.readouterr()
        outs = []
        for side, tool in (("ref", ref_dump), ("port", dump)):
            assert tool.main(self.args(side, argv)) == 0
            outs.append(capsys.readouterr().out)
        assert outs[0] == outs[1]
        return outs[1]


@pytest.fixture
def sides(tmp_path):
    return Sides(tmp_path)


@pytest.fixture
def gray(sides):
    d = smooth(40, 48)
    sides.write("in.pgm", pnm_bytes(d))
    return d[:, :, 0]


# ---- the cases of the reference's tests/test_cli.py, through both tools

def test_cli_roundtrip_lossless(sides, gray):
    sides.run("compress", ["-i", "@in.pgm", "-o", "@out.j2k", "-n", "4"])
    sides.same("out.j2k")
    sides.run("decompress", ["-i", "@out.j2k", "-o", "@dec.pgm"])
    sides.same("dec.pgm")
    rec = pnm.read_pnm(sides.args("port", ["@dec.pgm"])[0])
    np.testing.assert_array_equal(rec.components[0].data, gray)


def test_cli_lossy_rates(sides, gray):
    sides.run("compress", ["-i", "@in.pgm", "-o", "@out.j2k", "-I", "-r",
                           "20,5", "-p", "RPCL", "-n", "4"])
    assert len(sides.same("out.j2k")) <= 40 * 48 / 5 + 400
    sides.run("decompress", ["-i", "@out.j2k", "-o", "@dec.pgm", "-l",
                             "1"])
    sides.same("dec.pgm")


def test_cli_reduce(sides, gray):
    sides.run("compress", ["-i", "@in.pgm", "-o", "@out.j2k", "-n", "4",
                           "-M", "64"])
    sides.run("decompress", ["-i", "@out.j2k", "-o", "@dec.pgm", "-r", "1"])
    sides.same("out.j2k", "dec.pgm")
    rec = pnm.read_pnm(sides.args("port", ["@dec.pgm"])[0])
    assert rec.components[0].data.shape == (20, 24)
    # -D (the reference's TPU opt-in) and -H (its T1 threads) change
    # nothing in the port
    assert compress.main(sides.args("port", [
        "-i", "@in.pgm", "-o", "@dh.j2k", "-n", "4", "-M", "64", "-D", "-H",
        "2"]) + CPU) == 0
    assert decompress.main(sides.args("port", [
        "-i", "@dh.j2k", "-o", "@dh.pgm", "-r", "1", "-H", "2"]) + CPU) == 0
    assert sides.same("out.j2k", "dec.pgm") == [
        (sides.dirs["port"] / n).read_bytes() for n in ("dh.j2k", "dh.pgm")]


def test_cli_dump(sides, gray, capsys):
    sides.run("compress", ["-i", "@in.pgm", "-o", "@out.j2k", "-n", "3",
                           "-t", "32,32", "-S", "-E", "-M", "64"])
    sides.same("out.j2k")
    txt = sides.dump(capsys, ["-i", "@out.j2k"])
    assert "x1=48, y1=40" in txt and "numresolutions=3" in txt
    assert "tw=2, th=2" in txt and "tile-part" in txt


def test_jp2_container_roundtrip(sides, gray):
    from grokimagecompression_tpu_torch.codestream import jp2
    sides.run("compress", ["-i", "@in.pgm", "-o", "@out.jp2", "-M", "64",
                           "-n", "4"])
    raw = sides.same("out.jp2")
    assert jp2.is_jp2(raw)
    hdr, _ = jp2.read_jp2(raw)
    assert (hdr.width, hdr.height, hdr.numcomps) == (48, 40, 1)
    assert hdr.colourspace == jp2.CS_GREYSCALE
    sides.run("decompress", ["-i", "@out.jp2", "-o", "@dec.pgm"])
    rec = pnm.read_pnm(sides.args("port", ["@dec.pgm"])[0])
    np.testing.assert_array_equal(rec.components[0].data, gray)


def test_bmp_cli_pipeline(sides):
    from grokimagecompression_tpu_torch.io import bmp
    d = smooth(24, 32, 3, seed=2)
    sides.write("in.ppm", pnm_bytes(d))
    img = pnm.read_pnm(sides.args("port", ["@in.ppm"])[0])
    for side in ("ref", "port"):
        bmp.write_bmp(sides.args(side, ["@in.bmp"])[0], img)
    sides.run("compress", ["-i", "@in.bmp", "-o", "@o.j2k", "-n", "3",
                           "-M", "64"])
    sides.run("decompress", ["-i", "@o.j2k", "-o", "@o.bmp"])
    sides.same("o.j2k", "o.bmp")
    back = bmp.read_bmp(sides.args("port", ["@o.bmp"])[0])
    for c in range(3):
        np.testing.assert_array_equal(back.components[c].data, d[:, :, c])


def test_dump_packet_index_matches_plt(sides, gray, capsys):
    """-m -p on a stream with PLT and TLM markers: the port's library
    stream equals the reference's, the packet index agrees with the PLT
    lengths, and both dumps print the same text."""
    from grokimagecompression_tpu_torch.codestream.tile import (
        index_tile_packets)
    img = pnm.read_pnm(sides.args("port", ["@in.pgm"])[0])
    kw = dict(numresolutions=4, plt_markers=True, tlm_markers=True,
              cblk_style=0x40, tile_size=(32, 32))
    cs = encoder.encode(img, EncoderParams(**kw), device="cpu")
    assert cs == ref_encoder.encode(
        ref_pnm.read_pnm(sides.args("ref", ["@in.pgm"])[0]),
        ref_params.EncoderParams(**kw), device=False)
    hdr = decoder.read_header(cs)
    tp = next(decoder.iter_tile_parts(cs, hdr.main_header_end))
    pkts = index_tile_packets(tp.body, hdr, 0)
    assert [ln for (*_, ln) in pkts] == tp.plt_lengths
    assert sum(tp.plt_lengths) == len(tp.body)
    sides.write("d.j2k", cs)
    out = sides.dump(capsys, ["-i", "@d.j2k", "-m", "-p"])
    assert "Marker index" in out and "Packet index" in out
    assert "TLM index" in out and "PLT packet lengths" in out


def test_compare_tool(tmp_path):
    rng = np.random.default_rng(0)
    a = rng.integers(0, 256, (20, 30, 1)).astype(np.uint8)
    b = np.clip(a.astype(int) + rng.integers(-2, 3, a.shape), 0,
                255).astype(np.uint8)
    pa, pb = tmp_path / "a.pgm", tmp_path / "b.pgm"
    pa.write_bytes(pnm_bytes(a))
    pb.write_bytes(pnm_bytes(b))
    for argv, want in (([pa, pb, "4", "10"], 0), ([pa, pb, "0.5", "0.1"], 1),
                       ([pa, pa, "0", "0"], 0)):
        args = ["-b", str(argv[0]), "-t", str(argv[1]), "-p", argv[2], "-m",
                argv[3]]
        assert compare.main(args) == ref_compare.main(args) == want
    texts = []
    for mod in (ref_compare, compare):
        out = io.StringIO()
        mod.compare(mod.common.read_image(str(pa)),
                    mod.common.read_image(str(pb)), [4.0], [10.0], out=out)
        texts.append(out.getvalue())
    assert texts[0] == texts[1] and "PEAK=" in texts[1]


def test_decompress_split_pnm(sides):
    d = smooth(24, 32, 3, seed=3)
    sides.write("s.ppm", pnm_bytes(d))
    sides.run("compress", ["-i", "@s.ppm", "-o", "@s.j2k", "-M", "64",
                           "-n", "3"])
    sides.run("decompress", ["-i", "@s.j2k", "-o", "@o.ppm",
                             "--split-pnm"])
    sides.same("s.j2k", "o_0.pgm", "o_1.pgm", "o_2.pgm")
    for c in range(3):
        rec = pnm.read_pnm(sides.args("port", [f"@o_{c}.pgm"])[0])
        np.testing.assert_array_equal(rec.components[0].data, d[:, :, c])


def test_compress_cli_poc_tp_mct_and_directory(sides):
    """-P (POC), -u (tile-parts), -Y (MCT select) and -y / -O / -a
    (directory mode); the reference's case adds -R (ROI), which
    test_roi_and_custom_mct_flags_equal_reference runs."""
    d = smooth(40, 48, 3, seed=5)
    sides.write("in.ppm", pnm_bytes(d))
    sides.run("compress", ["-i", "@in.ppm", "-o", "@out.j2k", "-n", "4",
                           "-P", "T0=0,0,1,3,3,CPRL/T0=3,0,1,4,3,LRCP",
                           "-u", "R", "-Y", "0", "-M", "64"])
    sides.run("decompress", ["-i", "@out.j2k", "-o", "@dec.ppm"])
    sides.same("out.j2k", "dec.ppm")
    got = pnm.read_pnm(sides.args("port", ["@dec.ppm"])[0])
    for c in range(3):
        np.testing.assert_array_equal(got.components[c].data, d[:, :, c])
    for n in ("a", "b"):
        sides.write(f"imgs/{n}.ppm", pnm_bytes(d[::-1] if n == "b" else d))
    sides.run("compress", ["-y", "@imgs", "-O", "J2K", "-a", "@outs", "-M",
                           "64", "-n", "3"])
    assert sorted(os.listdir(sides.args("port", ["@outs"])[0])) == \
        ["a.j2k", "b.j2k"]
    sides.same("outs/a.j2k", "outs/b.j2k")


def test_decompress_cli_precision_and_dir(sides, gray):
    sides.run("compress", ["-i", "@in.pgm", "-o", "@x.j2k", "-M", "64"])
    sides.run("decompress", ["-i", "@x.j2k", "-o", "@p10.pgm", "-p",
                             "10S"])
    sides.run("decompress", ["-i", "@x.j2k", "-o", "@p6.pgm", "-p", "6C"])
    sides.same("x.j2k", "p10.pgm", "p6.pgm")
    got = pnm.read_pnm(sides.args("port", ["@p10.pgm"])[0])
    assert got.components[0].prec == 10
    np.testing.assert_array_equal(got.components[0].data,
                                  gray.astype(np.int32) << 2)
    assert pnm.read_pnm(sides.args("port", ["@p6.pgm"])[0]) \
        .components[0].data.max() <= 63
    sides.run("decompress", ["-y", "@", "-a", "@outs", "-O", "pgm"])
    rec = pnm.read_pnm(sides.args("port", ["@outs/x.pgm"])[0])
    np.testing.assert_array_equal(rec.components[0].data, gray)
    sides.same("outs/x.pgm")


def test_jp2_colour_boxes(sides):
    """The decode's colour policy through both tools: a JP2 with a pclr /
    cmap palette, one with an opacity channel (`cdef`, from an RGBA PNG),
    one with a matrix-shaper ICC profile and one in CIELab."""
    from grokimagecompression_tpu_torch.io import png
    rng = np.random.default_rng(11)
    idx = rng.integers(0, 4, (16, 16, 1)).astype(np.uint8)
    sides.write("idx.pgm", pnm_bytes(idx))
    sides.run("compress", ["-i", "@idx.pgm", "-o", "@idx.j2k", "-n", "2",
                           "-M", "64"])
    rgb = smooth(24, 32, 3, seed=12)
    sides.write("rgb.ppm", pnm_bytes(rgb))
    sides.run("compress", ["-i", "@rgb.ppm", "-o", "@rgb.j2k", "-n", "3",
                           "-M", "64"])
    cs = sides.same("rgb.j2k")
    for kind, nc in (("icc", 3), ("cielab", 3)):
        sides.write(f"{kind}.jp2", chip_smoke.cli_jp2(kind, cs, 32, 24, nc))
    sides.write("pal.jp2", chip_smoke.cli_jp2(
        "palette", sides.same("idx.j2k"), 16, 16, 1))
    rgba = np.concatenate([rgb, smooth(24, 32, 1, seed=13)], axis=-1)
    img = pnm.make_image([rgba[:, :, c] for c in range(4)])
    img.components[3].alpha = True
    for side in ("ref", "port"):
        png.write_png(sides.args(side, ["@rgba.png"])[0], img)
    sides.run("compress", ["-i", "@rgba.png", "-o", "@rgba.jp2", "-n", "3",
                           "-M", "64"])
    for src, dst in (("pal.jp2", "pal.ppm"), ("icc.jp2", "icc.ppm"),
                     ("cielab.jp2", "lab.ppm"), ("rgba.jp2", "rgba.png")):
        sides.run("decompress", ["-i", f"@{src}", "-o", f"@{dst}"])
    sides.same("rgba.jp2", "pal.ppm", "icc.ppm", "lab.ppm", "rgba.png")
    pal = pnm.read_pnm(sides.args("port", ["@pal.ppm"])[0])
    assert len(pal.components) == 3
    back = png.read_png(sides.args("port", ["@rgba.png"])[0])
    assert [c.alpha for c in back.components] == [False] * 3 + [True]
    for c in range(4):
        np.testing.assert_array_equal(back.components[c].data, rgba[:, :, c])


# ---- what the port does not code, and no fallback

@pytest.mark.parametrize("flags,coded", [
    # the HT coder with its refinement passes, with the bypass mode
    # switch and without: coded, as the reference's host coder codes them
    (["-M", "65", "--ht-refinement"], True),
    (["-M", "64", "--ht-refinement"], True),
    (["-M", "64", "-R", "c=0,U=4"], False),
], ids=["mq-lazy", "ht-refinement", "roi-ht"])
def test_out_of_slice_flags_fail(sides, capsys, flags, coded):
    """`--ht-refinement` (with `-M 64` and `-M 65`) codes through the
    port's tool to the reference tool's file, on the host coders behind
    the transform, and `grk_decompress` of it writes the reference tool's
    image. ROI with the HT coder fails on both sides with the reference's
    ValueError, and neither writes a file."""
    d = smooth(24, 32, 3, seed=6)
    sides.write("in.ppm", pnm_bytes(d))
    argv = ["-i", "@in.ppm", "-o", "@out.j2k", "-n", "3"] + flags
    if not coded:
        with pytest.raises(ValueError, match="ROI upshift"):
            ref_compress.main(sides.args("ref", argv))
        with pytest.raises(ValueError, match="ROI upshift"):
            compress.main(sides.args("port", argv) + CPU)
        for side in ("ref", "port"):
            assert not os.path.exists(sides.args(side, ["@out.j2k"])[0])
        return
    t1_native.CALLS["t1"] = 0
    sides.run("compress", argv)
    sides.run("decompress", ["-i", "@out.j2k", "-o", "@out.ppm"])
    assert t1_native.CALLS["t1"] >= 2
    cs, _ = sides.same("out.j2k", "out.ppm")
    sides.run("compress", ["-i", "@in.ppm", "-o", "@plain.j2k", "-n", "3"]
              + flags[:-1])
    assert sides.same("plain.j2k") != cs


@pytest.mark.parametrize("flags", [
    ["-R", "c=0,U=4"],
    ["-m", "@mct.txt"],
], ids=["roi", "custom-mct"])
def test_roi_and_custom_mct_flags_equal_reference(sides, flags):
    """`grk_compress -R c=0,U=4` (ROI) and `-m` with a decoding matrix
    file (a custom MCT on 9/7) code on the port's kernels to the
    reference tool's file, and `grk_decompress` of it writes the
    reference tool's image."""
    d = smooth(24, 32, 3, seed=6)
    sides.write("in.ppm", pnm_bytes(d))
    sides.write("mct.txt", "".join(",".join(repr(v) for v in row) + "\n"
                                   for row in chip_smoke.CUSTOM_MCT).encode())
    sides.run("compress", ["-i", "@in.ppm", "-o", "@out.j2k", "-n", "3"]
              + flags)
    sides.run("decompress", ["-i", "@out.j2k", "-o", "@out.ppm"])
    cs, _ = sides.same("out.j2k", "out.ppm")
    assert (b"\xff\x5e" in cs) == (flags[0] == "-R")      # RGN
    assert (b"\xff\x74" in cs) == (flags[0] == "-m")      # MCT


def test_out_of_slice_stream_fails_to_decode(sides, capsys):
    """A stream with HT refinement passes made by the reference's tool
    decodes through the port's `grk_decompress` to the reference tool's
    image (the host decoders behind the inverse transform)."""
    sides.write("in.ppm", pnm_bytes(smooth(24, 32, 3, seed=7)))
    with _numpy_dwt():
        assert ref_compress.main(sides.args("ref", [
            "-i", "@in.ppm", "-o", "@in.ppm.j2k", "-n", "3", "-M",
            "64", "--ht-refinement"])) == 0
    sides.write("in.j2k", (sides.dirs["ref"] / "in.ppm.j2k").read_bytes())
    t1_native.CALLS["t1"] = 0
    sides.run("decompress", ["-i", "@in.j2k", "-o", "@out.ppm"])
    assert t1_native.CALLS["t1"] >= 1
    sides.same("out.ppm")


@pytest.mark.parametrize("tool", ["compress", "decompress"])
def test_cuda_request_without_cuda_fails(sides, gray, capsys, monkeypatch,
                                         tool):
    """The tools default to the card; without CUDA they exit non-zero
    with the error and write nothing: never a CPU run."""
    sides.run("compress", ["-i", "@in.pgm", "-o", "@x.j2k", "-M", "64"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = ["-i", "@in.pgm", "-o", "@new.j2k"] if tool == "compress" \
        else ["-i", "@x.j2k", "-o", "@new.pgm"]
    capsys.readouterr()
    with pytest.raises(SystemExit) as e:
        PORT[tool].main(sides.args("port", argv))
    assert e.value.code == 1
    assert "CUDA device requested" in capsys.readouterr().err
    assert sorted(os.listdir(sides.dirs["port"])) == ["in.pgm", "x.j2k"]


# ---- the flag lines of chip_smoke.py phase 21 at BASELINE widths

@pytest.mark.parametrize("flags,kw,ncomps,prec", [
    (["-n", "6", "-M", "64"], dict(numresolutions=6, cblk_style=0x40), 1,
     8),
    (["-n", "6"], dict(numresolutions=6, cblk_style=0), 1, 8),
    (["-n", "6", "-I", "-r", "24,48,96"],
     dict(numresolutions=6, transform="DWT_97", numlayers=3,
          rates=(24.0, 48.0, 96.0)), 3, 8),
    (["-n", "6", "-M", "64", "-t", "1024,1024"],
     dict(numresolutions=6, cblk_style=0x40, tile_size=(1024, 1024)), 1,
     12),
], ids=["config1-ht", "config1-mq", "config2", "s1"])
def test_cli_flag_lines_make_the_digest_files_params(tmp_path, flags, kw,
                                                     ncomps, prec):
    """Each flag line with `-C grokimagecompression_tpu` makes the
    library's stream of the parameters that `data/config1_*.json`,
    `config2_pcrd_97.json` and phase 19 / 20's S1 encode with (the
    reference's tool and library, on a small frame); SIZ, COD, QCD and
    the comment read back equal through the port's `read_header`."""
    a = smooth(64, 64, ncomps, seed=8).astype(np.int32) << (prec - 8)
    img = ref_pnm.make_image([a[:, :, c] for c in range(ncomps)], prec=prec)
    src = str(tmp_path / ("in.ppm" if ncomps == 3 else "in.pgm"))
    ref_pnm.write_pnm(src, img)
    out = str(tmp_path / "out.j2k")
    if "transform" in kw:
        kw = dict(kw, transform=ref_params.Transform.DWT_97)
    with _numpy_dwt():
        assert ref_compress.main(["-i", src, "-o", out, "-C",
                                  "grokimagecompression_tpu"] + flags) == 0
        want = ref_encoder.encode(ref_pnm.read_pnm(src),
                                  ref_params.EncoderParams(**kw),
                                  device=False)
    with open(out, "rb") as f:
        cs = f.read()
    assert cs == want
    h = decoder.read_header(cs)
    assert h.comments == ["grokimagecompression_tpu"]
    assert (h.cod.numresolutions, h.cod.cblk_style, h.cod.numlayers) == (
        kw["numresolutions"], kw.get("cblk_style", 0),
        kw.get("numlayers", 1))


# ---- workers=, and the tools without JAX

def test_codec_batch_workers_change_nothing():
    """`workers=` is accepted as the reference's is and changes no stream
    or output; the reference's own calls with and without it agree with
    each other and with the port's."""
    arrays = [smooth(24, 32, 1, seed=s)[:, :, 0] for s in (1, 2)] \
        + [smooth(20, 28, 3, seed=3)]
    kw = dict(ht=True)
    with _numpy_dwt():
        ref_plain = ref_codec.compress_batch(arrays, device=False, **kw)
        ref_two = ref_codec.compress_batch(arrays, workers=2, device=False,
                                           **kw)
    assert ref_two == ref_plain
    plain = codec.compress_batch(arrays, device="cpu", **kw)
    assert codec.compress_batch(arrays, workers=2, device="cpu",
                                **kw) == plain == ref_plain
    dec = codec.decompress_batch(plain, device="cpu")
    two = codec.decompress_batch(plain, workers=2, device="cpu")
    with _numpy_dwt():
        ref_dec = ref_codec.decompress_batch(plain, workers=2)
        assert all(np.array_equal(a, b) for a, b in zip(
            ref_dec, ref_codec.decompress_batch(plain)))
    for a, b, r, src in zip(dec, two, ref_dec, arrays):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, r)
        np.testing.assert_array_equal(a, src)


def test_cli_runs_without_jax(tmp_path):
    """`python -m ...cli.compress --help`, and grk_compress, grk_decompress
    and grk_dump on a small file, with JAX and the reference blocked; the
    stream and the dump's text equal the reference tools'."""
    (tmp_path / "in.pgm").write_bytes(pnm_bytes(smooth(24, 32, seed=9)))
    out = io.StringIO()
    ref_args = ["-i", str(tmp_path / "in.pgm"), "-o",
                str(tmp_path / "ref.j2k"), "-n", "3", "-M", "64"]
    assert ref_compress.main(ref_args) == 0
    with contextlib.redirect_stdout(out):
        assert ref_dump.main(["-i", str(tmp_path / "ref.j2k")]) == 0
    code = textwrap.dedent(f"""
        import runpy, sys
        sys.modules["jax"] = None
        sys.modules["grokimagecompression_tpu"] = None
        def tool(name, *argv):
            sys.argv = [name, *argv]
            try:
                runpy.run_module(
                    "grokimagecompression_tpu_torch.cli." + name,
                    run_name="__main__")
            except SystemExit as e:
                assert not e.code, (name, e.code)
        tool("compress", "--help")
        d = {str(tmp_path)!r}
        tool("compress", "-i", d + "/in.pgm", "-o", d + "/port.j2k", "-n",
             "3", "-M", "64", "--torch-device", "cpu")
        tool("decompress", "-i", d + "/port.j2k", "-o", d + "/dec.pgm",
             "--torch-device", "cpu")
        tool("dump", "-i", d + "/port.j2k")
        assert "jax" not in [m.split(".")[0] for m in sys.modules
                             if sys.modules[m] is not None]
    """)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=300,
                          env=dict(os.environ, PYTHONPATH=REPO))
    assert proc.returncode == 0, proc.stderr
    assert "usage: grk_compress" in proc.stdout
    assert proc.stdout.endswith(out.getvalue())
    assert (tmp_path / "port.j2k").read_bytes() == \
        (tmp_path / "ref.j2k").read_bytes()
    assert pnm.read_pnm(str(tmp_path / "dec.pgm")).components[0].data \
        .tolist() == smooth(24, 32, seed=9)[:, :, 0].tolist()


def test_common_helpers_equal_reference(tmp_path, capsys):
    """`read_image` / `write_image` over every extension, and `fail`."""
    from grokimagecompression_tpu.cli import common as ref_common
    d = smooth(12, 10, 3, seed=10)
    (tmp_path / "a.ppm").write_bytes(pnm_bytes(d))
    img = common.read_image(str(tmp_path / "a.ppm"))
    ref_img = ref_common.read_image(str(tmp_path / "a.ppm"))
    for ext in ("ppm", "bmp", "png", "tif", "tga", "raw", "rawl", "pgx"):
        common.write_image(str(tmp_path / f"p.{ext}"), img)
        ref_common.write_image(str(tmp_path / f"r.{ext}"), ref_img)
        assert (tmp_path / f"p.{ext}").read_bytes() == \
            (tmp_path / f"r.{ext}").read_bytes(), ext
        desc = "10,12,3,8,u" if ext.startswith("raw") else None
        got = common.read_image(str(tmp_path / f"p.{ext}"), raw_desc=desc)
        want = ref_common.read_image(str(tmp_path / f"p.{ext}"),
                                     raw_desc=desc)
        for g, w in zip(got.components, want.components):
            np.testing.assert_array_equal(g.data, w.data)
    got = common.read_image(str(tmp_path / "a.ppm"), force_format="pnm")
    np.testing.assert_array_equal(got.components[1].data, d[:, :, 1])
    with pytest.raises(SystemExit) as e:
        common.fail("why")
    assert e.value.code == 1 and capsys.readouterr().err == "error: why\n"
    with pytest.raises(SystemExit, match="unsupported input format"):
        common.read_image(str(tmp_path / "a.xyz"))


# ---- the digests of chip_smoke.py phase 21 (a)

def cli_digests(d):
    """The reference tools' outputs of `chip_smoke.CLI_CASES` on the
    inputs `chip_smoke.cli_inputs` writes into directory `d`, by case and
    file (SHA-256), with the inputs' digests; the library stream of the
    "plt" case is the reference host encoder's (3 resolutions, 32 x 32
    tiles, PLT and TLM)."""
    chip_smoke.cli_inputs(d)
    digests = {}
    for r, _, fs in os.walk(d):
        for f in fs:
            with open(os.path.join(r, f), "rb") as fh:
                digests[os.path.relpath(os.path.join(r, f), d)] = \
                    hashlib.sha256(fh.read()).hexdigest()

    def plt_stream(path):
        return ref_encoder.encode(ref_pnm.read_pnm(path),
                                  ref_params.EncoderParams(
                                      numresolutions=3, tile_size=(32, 32),
                                      plt_markers=True, tlm_markers=True),
                                  device=False)
    with _numpy_dwt():
        cases = chip_smoke.run_cli_cases(d, REF, plt_stream=plt_stream)
    return {
        "what": "the grokimagecompression_tpu tools (cli.compress, "
                "cli.decompress, cli.dump; host route, numpy DWT) run on "
                "chip_smoke.cli_inputs at each chip_smoke.CLI_CASES entry; "
                "SHA-256 of the inputs and of each case's output files; "
                "tests/test_torch_cli.py writes it",
        "inputs": dict(sorted(digests.items())),
        "cases": cases,
    }


def test_cli_digest_file_is_current(tmp_path):
    with open(CLI_DIGESTS) as f:
        assert json.load(f) == cli_digests(str(tmp_path))


def test_port_cli_equals_digests_on_some_cases(tmp_path):
    """A few CLI_CASES entries through the port's tools on the CPU, against
    the digest file (phase 21 runs every entry on the card)."""
    with open(CLI_DIGESTS) as f:
        want = json.load(f)["cases"]
    names = {"HT", "in TIFF LZW 16", "in PNG 16", "out PNG", "out PPM",
             "ICC JP2", "ICC", "CIELab JP2", "CIELab", "out TIFF deflate",
             "in TGA", "out TGA"}
    cases = [c for c in chip_smoke.CLI_CASES if c[0] in names]
    chip_smoke.cli_inputs(str(tmp_path))
    got = chip_smoke.run_cli_cases(str(tmp_path), PORT, extra=CPU,
                                   cases=cases)
    assert got == {k: want[k] for k in got}


if __name__ == "__main__":
    import tempfile
    with tempfile.TemporaryDirectory() as tmp:
        with open(CLI_DIGESTS, "w") as f:
            json.dump(cli_digests(tmp), f, indent=1)
            f.write("\n")
