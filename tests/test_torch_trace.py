"""The port's stage tracer (`utils/trace.py`, a copy of the reference's).

The reference's two cases of tests/test_trace.py on the port's tracer.
Their encode is a styled one (MQ BYPASS, 0x01) here: the port traces the
host stages it shares with the reference's tile path, and the default
MQ style codes on the CUDA MQ kernel's route, which has no host Tier-1
stage. Where the reference asserts bytes on `enc.dwt`, the port asserts
them on `enc.t1` (block area x 4, the reference's count): the port's
transforms run on the device inside one forward and have no host stage.

A styled encode and decode on the CPU records `enc.t1`, `enc.t2`,
`dec.setup`, `dec.t2` and `dec.t1` with the calls and bytes the
reference's tracer records for the same request on its host codec; so
does a refined HT request. Disabled, the tracer records nothing. Stages
recorded from several threads at once add up, and `GROK_TPU_TRACE=1`
enables it at import.
"""

import importlib
import sys
import threading

import numpy as np
import pytest
import torch

from grokimagecompression_tpu.codestream import decoder as ref_decoder
from grokimagecompression_tpu.codestream import encoder as ref_encoder
from grokimagecompression_tpu.core.params import EncoderParams as RefParams
from grokimagecompression_tpu.utils import trace as ref_trace
from grokimagecompression_tpu_torch import convert
from grokimagecompression_tpu_torch.codestream import decoder, encoder
from grokimagecompression_tpu_torch.core.image import Component, Image
from grokimagecompression_tpu_torch.core.params import EncoderParams
from grokimagecompression_tpu_torch.utils import trace

from test_torch_t1_styles import _numpy_dwt

SHARED = ("enc.t1", "enc.t2", "dec.setup", "dec.t2", "dec.t1")


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
def tracer_off():
    """Each case starts and ends with both tracers disabled and empty."""
    for t in (trace, ref_trace):
        t.disable()
        t.reset()
    yield
    for t in (trace, ref_trace):
        t.disable()
        t.reset()


def test_trace_collects_stages():
    trace.enable()
    rng = np.random.default_rng(0)
    img = Image(xsiz=96, ysiz=64, components=[
        Component(data=rng.integers(0, 256, (64, 96)).astype(np.int32),
                  prec=8, signed=False, dx=1, dy=1)])
    cs = encoder.encode(img, EncoderParams(numresolutions=3, cblk_style=0x01),
                        device="cpu")
    decoder.decode(cs, device="cpu")
    snap = trace.snapshot()
    assert "enc.t1" in snap and snap["enc.t1"]["calls"] == 1
    assert snap["enc.t1"]["bytes"] == 96 * 64 * 4
    assert "enc.t2" in snap
    assert "dec.t1" in snap
    rep = trace.report()
    assert "enc.t1" in rep and "MB/s" in rep


def test_trace_disabled_is_silent():
    assert not trace.enabled()
    rng = np.random.default_rng(1)
    img = Image(xsiz=32, ysiz=32, components=[
        Component(data=rng.integers(0, 256, (32, 32)).astype(np.int32),
                  prec=8, signed=False, dx=1, dy=1)])
    cs = encoder.encode(img, EncoderParams(numresolutions=2, cblk_style=0x01),
                        device="cpu")
    decoder.decode(cs, device="cpu")
    assert trace.snapshot() == {}
    assert trace.report().startswith("trace: no stages recorded")


@pytest.mark.parametrize("kw", [
    dict(cblk_style=0x3F, numlayers=2, rates=(16.0, 4.0)),
    dict(cblk_style=0x40, ht_refinement=True),
], ids=["mq-0x3f", "ht-refined"])
def test_stages_match_reference_tracer(kw):
    """One styled or refined tile coded and decoded: the port's tracer
    records each shared stage as often and with as many bytes as the
    reference's tracer records it on the reference's host codec."""
    from conftest import natural_image
    img = natural_image(40, 32, ncomp=1, seed=4)
    params = RefParams(numresolutions=3, cblk_w_exp=4, cblk_h_exp=4, **kw)
    ref_trace.enable()
    with _numpy_dwt():
        want = ref_encoder.encode(img, params, device=False)
        ref_decoder.decode(want, device=False)
    trace.enable()
    cs = encoder.encode(convert.image_from_reference(img),
                        convert.params_from_reference(params), device="cpu")
    decoder.decode(cs, device="cpu")
    assert cs == want
    got, ref = trace.snapshot(), ref_trace.snapshot()
    assert set(SHARED) <= set(got)
    assert set(got) <= set(ref)
    for name in SHARED:
        assert (got[name]["calls"], got[name]["bytes"]) == \
            (ref[name]["calls"], ref[name]["bytes"]), name


def test_stages_from_threads_add_up():
    """Sixteen threads (more than the cores) recording at once, the
    interpreter switching threads every microsecond: the totals add up."""
    trace.enable()
    nthreads, calls = 16, 500
    barrier = threading.Barrier(nthreads)

    def work():
        barrier.wait(30)
        for _ in range(calls):
            with trace.stage("a", 3):
                pass
            trace.add_time("b", 0.001, 2)
            trace.add_bytes("b", 1)
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
    snap = trace.snapshot()
    n = nthreads * calls
    assert (snap["a"]["calls"], snap["a"]["bytes"]) == (n, 3 * n)
    assert (snap["b"]["calls"], snap["b"]["bytes"]) == (n, 3 * n)
    assert snap["b"]["seconds"] == pytest.approx(0.001 * n)
    trace.reset()
    assert trace.snapshot() == {}


def test_environment_enables_at_import(monkeypatch):
    monkeypatch.setenv("GROK_TPU_TRACE", "1")
    try:
        assert importlib.reload(trace).enabled()
        monkeypatch.setenv("GROK_TPU_TRACE", "0")
        assert not importlib.reload(trace).enabled()
    finally:
        monkeypatch.delenv("GROK_TPU_TRACE")
        importlib.reload(trace)
    assert not trace.enabled()
