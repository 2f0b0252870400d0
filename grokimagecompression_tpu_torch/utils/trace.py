"""Stage tracing: wall time, calls and bytes of the host stages.

A copy of `grokimagecompression_tpu/utils/trace.py`. Enable with
GROK_TPU_TRACE=1 (or `trace.enable()`); the host stages the port shares
with the reference's tile path record into one registry under the
reference's names: `enc.t1` (the host Tier-1 coders,
`tile.encode_t1_blocks`; bytes: block area x 4), `enc.t2`
(`tile.encode_tile`), `dec.setup` and `dec.t2` (`tile.decode_tile`) and
`dec.t1` (the host Tier-1 decoders, `fused_decode._prepare_t1`; bytes:
the blocks' segment bytes). The transforms run on the device inside one
forward, so the reference's `enc.dc_mct`, `enc.dwt` and `dec.dwt` have
no host stage here.

    from grokimagecompression_tpu_torch.utils import trace
    trace.enable()
    ... encode/decode ...
    print(trace.report())       # per-stage totals
    trace.reset()

A disabled stage costs one bool check.
"""

from __future__ import annotations

import contextlib
import os
import threading
import time
from collections import defaultdict
from typing import Dict

_enabled = os.environ.get("GROK_TPU_TRACE", "") == "1"
_lock = threading.Lock()
_totals: Dict[str, list] = defaultdict(lambda: [0.0, 0, 0])  # time, calls, bytes


def enable() -> None:
    global _enabled
    _enabled = True


def disable() -> None:
    global _enabled
    _enabled = False


def enabled() -> bool:
    return _enabled


def reset() -> None:
    with _lock:
        _totals.clear()


@contextlib.contextmanager
def stage(name: str, nbytes: int = 0):
    """Time a pipeline stage. `nbytes` feeds the throughput column."""
    if not _enabled:
        yield
        return
    t0 = time.perf_counter()
    try:
        yield
    finally:
        add_time(name, time.perf_counter() - t0, nbytes)


def add_time(name: str, seconds: float, nbytes: int = 0) -> None:
    """Record an already-measured interval (for stages that can't wrap a
    `with` block without awkward reindentation)."""
    if not _enabled:
        return
    with _lock:
        rec = _totals[name]
        rec[0] += seconds
        rec[1] += 1
        rec[2] += nbytes


def add_bytes(name: str, nbytes: int) -> None:
    if not _enabled:
        return
    with _lock:
        _totals[name][2] += nbytes


def snapshot() -> Dict[str, dict]:
    with _lock:
        return {
            k: {"seconds": v[0], "calls": v[1], "bytes": v[2]}
            for k, v in _totals.items()
        }


def report() -> str:
    snap = snapshot()
    if not snap:
        return "trace: no stages recorded (is tracing enabled?)"
    total = sum(v["seconds"] for v in snap.values())
    lines = [f"{'stage':<22}{'ms':>10}{'%':>7}{'calls':>8}{'MB/s':>10}"]
    for name, v in sorted(snap.items(), key=lambda kv: -kv[1]["seconds"]):
        ms = v["seconds"] * 1e3
        pct = 100.0 * v["seconds"] / total if total else 0.0
        mbs = (v["bytes"] / v["seconds"] / 1e6) if v["seconds"] and \
            v["bytes"] else 0.0
        lines.append(f"{name:<22}{ms:>10.2f}{pct:>6.1f}%{v['calls']:>8}"
                     f"{mbs:>10.1f}")
    return "\n".join(lines)
