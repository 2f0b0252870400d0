"""The port's multi-process encode on a gloo group, on the CPU.

`parallel.multihost.encode_multihost(device="cpu")` in two worker
processes (a gloo group at 127.0.0.1 on a free port, JAX and the
reference package blocked in the workers) must give the same bytes on
both ranks, equal to the port's one-process `encoder.encode` and to the
reference's host encode, on copies of the reference's
tests/multihost_cases.py inputs: "lossless" (HT, TLM) and "global-pcrd"
(9/7, rates (24, 8), `rate_alloc="global"`: the process-reduce
`GlobalPCRDAllocator`), and on a one-tile image, where rank 1 owns no
tile. Three processes on a two-tile image under the image-wide allocator
leave rank 2 without a tile: it joins the allocator's collectives
through `participate_empty`. A rank that dies makes the other fail
within the group's timeout instead of waiting. Each worker has a hard
timeout.

The factory `make_case` below is a copy of tests/multihost_cases.py's
with the image and parameter classes passed in, so that the workers
build the port's inputs from its source and this process the
reference's.
"""

import inspect
import os
import socket
import subprocess
import sys
import textwrap
import time

import pytest
import torch

from grokimagecompression_tpu.codestream import encoder as ref_encoder
from grokimagecompression_tpu.core import image as ref_image
from grokimagecompression_tpu.core import params as ref_params
from grokimagecompression_tpu.ops import dwt_host
from grokimagecompression_tpu_torch.codestream import encoder
from grokimagecompression_tpu_torch.core import image as port_image
from grokimagecompression_tpu_torch.core import params as port_params

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER_S = 120
GROUP_TIMEOUT_S = 60


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


def make_case(mode, image_mod, params_mod):
    """tests/multihost_cases.py's `make_case`, with the `Image` /
    `Component` of `image_mod` and the `EncoderParams` / `Transform` of
    `params_mod`; and "one-tile" (40 x 32 MQ 9/7 at rates (24, 8), one
    tile) and "two-tile-global" (48 x 24 in two 24 x 24 tiles, MQ 9/7 at
    rates (16, 4) with `rate_alloc="global"`)."""
    import numpy as np
    Image, Component = image_mod.Image, image_mod.Component
    EncoderParams, Transform = params_mod.EncoderParams, params_mod.Transform
    rng = np.random.default_rng(5)
    if mode == "lossless":
        d = rng.integers(0, 256, (192, 256)).astype(np.int32)
        img = Image(xsiz=256, ysiz=192, components=[
            Component(data=d, prec=8, signed=False, dx=1, dy=1)])
        params = EncoderParams(numresolutions=3, tile_size=(64, 64),
                               cblk_style=0x40, tlm_markers=True)
        return img, params
    if mode == "global-pcrd":
        h, w = 160, 256
        yy, xx = np.mgrid[0:h, 0:w]
        smooth = ((yy * 2 + xx) // 3) % 256
        noise = rng.integers(0, 256, (h, w))
        d = np.where(xx < w // 2, smooth, noise).astype(np.int32)
        img = Image(xsiz=w, ysiz=h, components=[
            Component(data=d, prec=8, signed=False, dx=1, dy=1)])
        params = EncoderParams(numresolutions=4, tile_size=(64, 64),
                               transform=Transform.DWT_97,
                               numlayers=2, rates=(24.0, 8.0),
                               rate_alloc="global")
        return img, params
    if mode in ("one-tile", "two-tile-global"):
        w, h = (40, 32) if mode == "one-tile" else (48, 24)
        yy, xx = np.mgrid[0:h, 0:w]
        d = (((xx * 3 + yy * 2) // 4) % 200
             + rng.integers(0, 32, (h, w))).astype(np.int32)
        img = Image(xsiz=w, ysiz=h, components=[
            Component(data=d, prec=8, signed=False, dx=1, dy=1)])
        if mode == "one-tile":
            return img, EncoderParams(numresolutions=3, cblk_w_exp=4,
                                      cblk_h_exp=4,
                                      transform=Transform.DWT_97,
                                      numlayers=2, rates=(24.0, 8.0),
                                      rate_alloc="global")
        return img, EncoderParams(numresolutions=3, tile_size=(24, 24),
                                  cblk_w_exp=4, cblk_h_exp=4,
                                  transform=Transform.DWT_97, numlayers=2,
                                  rates=(16.0, 4.0), rate_alloc="global")
    raise ValueError(f"unknown multihost case {mode!r}")


_WORKER = """
import os, sys
sys.modules["jax"] = None
sys.modules["grokimagecompression_tpu"] = None
import torch
torch.set_num_threads(1)
from grokimagecompression_tpu_torch.core import image as image_mod
from grokimagecompression_tpu_torch.core import params as params_mod
from grokimagecompression_tpu_torch.parallel import multihost
{factory}
rank, world = int(sys.argv[1]), int(sys.argv[2])
multihost.init_distributed(sys.argv[3], world, rank,
                           timeout_s={timeout})
if sys.argv[4] == "die" and rank == 1:
    os._exit(3)
mode = "lossless" if sys.argv[4] == "die" else sys.argv[4]
img, params = make_case(mode, image_mod, params_mod)
cs = multihost.encode_multihost(img, params, device="cpu")
open(sys.argv[5] + "." + str(rank), "wb").write(cs)
assert not any(m.split(".")[0] in ("jax", "grokimagecompression_tpu")
               for m in sys.modules if sys.modules[m] is not None)
print("OK", rank, len(cs))
"""


def _start(tmp_path, mode, world):
    """The workers of one case, started; (processes, output prefix)."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    code = _WORKER.format(factory=textwrap.dedent(inspect.getsource(
        make_case)), timeout=GROUP_TIMEOUT_S)
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    out = str(tmp_path / "cs")
    procs = [subprocess.Popen(
        [sys.executable, "-c", code, str(r), str(world), f"127.0.0.1:{port}",
         mode, out], cwd=REPO, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT) for r in range(world)]
    return procs, out


def _finish(procs):
    """Wait for every worker (killing them all past WORKER_S); their
    (return code, output)."""
    deadline = time.monotonic() + WORKER_S
    res = []
    try:
        for p in procs:
            out, _ = p.communicate(
                timeout=max(1.0, deadline - time.monotonic()))
            res.append((p.returncode, out.decode(errors="replace")))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return res


@pytest.mark.parametrize("mode,world", [("lossless", 2), ("global-pcrd", 2),
                                        ("one-tile", 2),
                                        ("two-tile-global", 3)])
def test_ranks_equal_one_process_and_reference(tmp_path, mode, world):
    procs, out = _start(tmp_path, mode, world)
    # the one-process streams, made while the workers run
    img, params = make_case(mode, port_image, port_params)
    one = encoder.encode(img, params, device="cpu")
    ref = ref_encoder.encode(*make_case(mode, ref_image, ref_params),
                             device=False)
    for rc, text in _finish(procs):
        assert rc == 0, text[-3000:]
    streams = [open(f"{out}.{r}", "rb").read() for r in range(world)]
    assert all(cs == streams[0] for cs in streams)
    assert streams[0] == one == ref
    if mode in ("one-tile", "two-tile-global"):
        assert encoder.tile_count(img, params) == world - 1
    if mode == "global-pcrd":
        # the rate target bound the stream
        assert len(one) < img.xsiz * img.ysiz // 6


def test_a_dead_rank_fails_the_others(tmp_path):
    """Rank 1 leaves the group before the encode: rank 0 fails in the
    tile gather instead of waiting past the group's timeout."""
    procs, _ = _start(tmp_path, "die", 2)
    t0 = time.monotonic()
    (rc0, text0), (rc1, _) = _finish(procs)
    assert rc1 == 3
    assert rc0 != 0 and "OK" not in text0
    assert time.monotonic() - t0 < WORKER_S


def test_one_process_is_encode():
    """Without a process group `encode_multihost` is `encoder.encode`, and
    the ownership and gather helpers take the one process as the group."""
    from grokimagecompression_tpu_torch.parallel import multihost
    img, params = make_case("one-tile", port_image, port_params)
    assert multihost.encode_multihost(img, params, device="cpu") == \
        encoder.encode(img, params, device="cpu")
    assert multihost.owned_tiles(5) == [0, 1, 2, 3, 4]
    assert multihost.owned_tiles(5, 1, 2) == [1, 3]
    assert multihost.gather_tile_bytes([b"ab", b"c"], [2, 0], 3) == [
        b"c", b"", b"ab"]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            multihost.encode_multihost(img, params)
