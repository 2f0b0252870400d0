"""PCRD-opt rate control: convex-hull pass pruning + slope-threshold
search with full Tier-2 packet simulation.

A copy of `grokimagecompression_tpu/codestream/pcrd.py`: `HullPoint`,
`convex_hull`, `_npasses_at`, `RateControlCtx`, `_TileTables`,
`PCRDAllocator`, the image-wide `GlobalPCRDAllocator` on one device and
`make_layer_alloc`, as they are, but for `_TileTables`, which always
builds its hull tables with the Python `convex_hull` (the reference's
oracle for its native batch hull, which computes the same tables), and
`GlobalPCRDAllocator`, whose cross-process reduction runs over
`torch.distributed`, which has no device-mesh reduction (see its
docstring), no last-layer byte cap (`max_abs_bytes`, which no caller of
the image-wide allocator sets) and takes a `fail(exc)` that wakes every
waiting tile. `tests/test_torch_host_copies.py`
and `tests/test_torch_image_encode.py` hold the copy to the original.

Algorithmic analog of the reference's feasible-slope bisection
(reference: src/lib/jp2/TileProcessor.cpp pcrd_bisect_feasible:371,
makelayer_feasible:281, rate hull RateControl.cpp convexHull:31, simulate
T2.cpp encode_packets_simulate:131): per-pass (rate, distortion) tables
come from the device encode in one shot, the hull and the search are
host math, and the simulation is the real packet writer run in counting
mode (`native/t2_native.TileSim`).
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np

from .t2 import CblkEnc


@dataclasses.dataclass
class HullPoint:
    npasses: int      # truncation after this many passes
    rate: int         # cumulative bytes
    dist: float       # cumulative distortion decrease (weighted)
    slope: float      # R-D slope vs previous hull point


def convex_hull(cblk: CblkEnc) -> List[HullPoint]:
    """Feasible truncation points with strictly decreasing slopes."""
    pts: List[Tuple[int, int, float]] = [(0, 0, 0.0)]
    for i, p in enumerate(cblk.passes):
        pts.append((i + 1, p.rate, p.distortion))
    hull: List[Tuple[int, int, float]] = [pts[0]]
    for pt in pts[1:]:
        while hull:
            n0, r0, d0 = hull[-1]
            dr = pt[1] - r0
            dd = pt[2] - d0
            if dr < 0 or (dr == 0 and dd <= 0):
                break
            if dr == 0:           # free distortion: replace
                hull.pop()
                continue
            slope = dd / dr
            if len(hull) >= 2:
                n1, r1, d1 = hull[-2]
                prev_slope = (d0 - d1) / max(1, (r0 - r1))
                if slope >= prev_slope:
                    hull.pop()
                    continue
            if dd <= 0:
                break             # no gain: not a feasible point
            hull.append(pt)
            break
        else:
            hull.append(pt)
    out: List[HullPoint] = []
    for i in range(1, len(hull)):
        n0, r0, d0 = hull[i - 1]
        n1, r1, d1 = hull[i]
        out.append(HullPoint(npasses=n1, rate=r1, dist=d1,
                             slope=(d1 - d0) / max(1, r1 - r0)))
    return out


def _npasses_at(hull: List[HullPoint], thresh: float) -> Tuple[int, float]:
    """(passes included, distortion decrease) at slope threshold."""
    n, d = 0, 0.0
    for hp in hull:
        if hp.slope >= thresh:
            n, d = hp.npasses, hp.dist
        else:
            break
    return n, d


@dataclasses.dataclass
class RateControlCtx:
    """Per-tile context handed to a layer allocator by encode_tile."""

    cblks: List[CblkEnc]
    numlayers: int
    tile_samples: int       # samples in this tile across components
    image_samples: int      # samples in the whole image across components
    max_prec: int           # max component bit depth (for maxSE)
    simulate_upto: Callable[[int], int]  # bytes of packets for layers 0..l
    # per-component packet byte totals for layers 0..l (cinema caps)
    simulate_comp_upto: Optional[Callable[[int], dict]] = None
    # Optional fast path: write one layer's pass counts (values aligned
    # with the filtered cblk list passed alongside) straight into the
    # native simulator's buffer, skipping per-object attribute stores
    # during bisection.
    write_layer: Optional[Callable[[int, "np.ndarray", list], None]] = None
    # Global tile index: orders cross-tile float reductions so the
    # global allocator is deterministic regardless of which tile thread
    # (or host) registers first.
    tile_index: int = -1


class _TileTables:
    """Vectorized per-tile hull tables + layer application helpers.

    Slopes are strictly descending along each row, so the passes included
    at a threshold is the last column with slope >= thresh — one
    vectorized comparison for the whole tile instead of a Python hull
    walk per block."""

    def __init__(self, ctx: RateControlCtx):
        self.ctx = ctx
        self.cblks = [cb for cb in ctx.cblks if cb.numpasses > 0]
        N = len(self.cblks)
        for cb in ctx.cblks:
            cb.layer_npasses = [0] * ctx.numlayers
        hull_list = [convex_hull(cb) for cb in self.cblks]
        self.slopes = [hp.slope for h in hull_list for hp in h]
        H = max((len(h) for h in hull_list), default=0) or 1
        self.S = np.full((N, H), -np.inf)
        self.NPV = np.full((N, H), 1 << 30, dtype=np.int64)
        self.DV = np.zeros((N, H))
        for i, h in enumerate(hull_list):
            for j, hp in enumerate(h):
                self.S[i, j] = hp.slope
                self.NPV[i, j] = hp.npasses
                self.DV[i, j] = hp.dist
        self.rows = np.arange(N)
        self.numpasses_vec = np.asarray(
            [cb.numpasses for cb in self.cblks], np.int64)
        self.prev_n = np.zeros(N, dtype=np.int64)
        self.cur_col = np.zeros(N, dtype=np.int64)
        self.distotile = sum(cb.passes[-1].distortion for cb in self.cblks)
        # ascending distinct slope values (the byte-budget search space)
        self.svals = np.unique(np.asarray(self.slopes)) \
            if self.slopes else np.zeros(0)

    def n_d_at(self, thresh: float):
        k = (self.S >= thresh).sum(axis=1)
        idx = np.maximum(k - 1, 0)
        pos = k > 0
        n = np.where(pos, self.NPV[self.rows, idx], 0)
        d = np.where(pos, self.DV[self.rows, idx], 0.0)
        return n, d

    def apply(self, thresh: Optional[float], layer: int) -> None:
        """Set layer pass counts from threshold (None = all rest)."""
        if thresh is None:
            n = self.numpasses_vec
        else:
            n, _ = self.n_d_at(thresh)
        n = np.maximum(n, self.prev_n)
        self.cur_col = n - self.prev_n
        if self.ctx.write_layer is not None:
            self.ctx.write_layer(layer, self.cur_col, self.cblks)
        else:
            for cb, v in zip(self.cblks, self.cur_col):
                cb.layer_npasses[layer] = int(v)

    def apply_zero(self, layer: int) -> None:
        self.cur_col = np.zeros(len(self.cblks), dtype=np.int64)
        if self.ctx.write_layer is not None:
            self.ctx.write_layer(layer, self.cur_col, self.cblks)
        for cb in self.cblks:
            cb.layer_npasses[layer] = 0

    def store_objects(self, layer: int) -> None:
        """Materialize the converged column into the CblkEnc objects
        (packet emission reads them; bisection iterations don't)."""
        if self.ctx.write_layer is not None:
            for cb, v in zip(self.cblks, self.cur_col):
                cb.layer_npasses[layer] = int(v)

    def commit_layer(self) -> None:
        self.prev_n = self.prev_n + self.cur_col

    def included_dist(self, thresh: float) -> float:
        n, d = self.n_d_at(thresh)
        j = (self.NPV <= self.prev_n[:, None]).sum(axis=1)
        d_prev = np.where(j > 0,
                          self.DV[self.rows, np.maximum(j - 1, 0)], 0.0)
        d_eff = np.where(n < self.prev_n, d_prev, d)
        return float(np.maximum(d_eff, 0.0).sum())


class PCRDAllocator:
    """Assigns passes to quality layers to meet byte and/or PSNR targets.

    `rates`: per-layer cumulative compression ratios (like -r); 0 = no
    constraint (all remaining passes — lossless last layer).
    `quality_psnr`: per-layer PSNR targets in dB (like -q); 0 on the last
    layer = lossless.
    `image_bytes`: uncompressed image size the ratios refer to.
    """

    def __init__(self, rates: Sequence[float] = (),
                 quality_psnr: Sequence[float] = (),
                 image_bytes: int = 0,
                 max_abs_bytes: int = 0,
                 max_comp_bytes: int = 0):
        self.rates = tuple(rates)
        self.quality_psnr = tuple(quality_psnr)
        self.image_bytes = image_bytes
        # Absolute codestream byte cap (profiles): overrides ratio-derived
        # targets on the final layer.
        self.max_abs_bytes = max_abs_bytes
        # Per-component packet byte cap (cinema: reference T2.cpp:181
        # encode_packets_simulate m_max_comp_size check).
        self.max_comp_bytes = max_comp_bytes

    def __call__(self, ctx: RateControlCtx) -> None:
        tt = _TileTables(ctx)
        if not tt.slopes:
            if ctx.cblks:
                for cb in ctx.cblks:
                    cb.layer_npasses[-1] = cb.numpasses
            return
        smin, smax = min(tt.slopes), max(tt.slopes)
        tile_frac = ctx.tile_samples / max(1, ctx.image_samples)
        max_se = float((1 << ctx.max_prec) - 1) ** 2 * ctx.tile_samples

        for layer in range(ctx.numlayers):
            rate = self.rates[layer] if layer < len(self.rates) else 0.0
            q = (self.quality_psnr[layer]
                 if layer < len(self.quality_psnr) else 0.0)
            target_bytes = 0
            if rate > 0:
                target_bytes = int(self.image_bytes / rate * tile_frac)
            if self.max_abs_bytes and layer == ctx.numlayers - 1:
                cap = int(self.max_abs_bytes * tile_frac)
                target_bytes = min(target_bytes, cap) if target_bytes \
                    else cap
            if target_bytes <= 0 and q <= 0:
                tt.apply(None, layer)
                tt.store_objects(layer)
                tt.prev_n = tt.numpasses_vec.copy()
                continue

            if q > 0:
                # Quality mode (reference pcrd "fixed quality"): remaining
                # distortion grows with threshold; find the LARGEST feasible
                # threshold (fewest passes) meeting the PSNR target.
                limit = max_se / (10.0 ** (q / 10.0))
                lo, hi = smin, smax
                feasible = (tt.distotile - tt.included_dist(smin)) <= limit
                if feasible:
                    for _ in range(60):
                        mid = 0.5 * (lo + hi)
                        if (tt.distotile - tt.included_dist(mid)) <= limit:
                            lo = mid
                        else:
                            hi = mid
                    thresh = lo
                else:
                    thresh = smin  # best effort: include everything feasible
                tt.apply(thresh, layer)
                tt.store_objects(layer)
            else:
                # Byte-budget mode: bytes shrink as threshold grows; find
                # the SMALLEST feasible threshold (most passes) that fits.
                comp_cap = 0
                if self.max_comp_bytes and ctx.simulate_comp_upto:
                    comp_cap = max(1, int(self.max_comp_bytes * tile_frac))

                def fits(l: int) -> bool:
                    if ctx.simulate_upto(l) > target_bytes:
                        return False
                    if comp_cap:
                        per_comp = ctx.simulate_comp_upto(l)
                        if any(v > comp_cap for v in per_comp.values()):
                            return False
                    return True

                # Discrete search: the pass set only changes at the
                # distinct slope values, so binary-search those instead
                # of 60 blind halvings (log2(#slopes) simulate calls —
                # the simulate is the hot path of a rate-controlled
                # encode). Also strictly more exact than the continuous
                # bisection, which could never return the densest
                # assignment (its lower bracket was untested).
                svals = tt.svals
                tt.apply(svals[-1], layer)
                if fits(layer):
                    lo_i, hi_i = 0, len(svals) - 1
                    while lo_i < hi_i:
                        mid_i = (lo_i + hi_i) // 2
                        tt.apply(svals[mid_i], layer)
                        if fits(layer):
                            hi_i = mid_i
                        else:
                            lo_i = mid_i + 1
                    tt.apply(svals[hi_i], layer)
                    tt.store_objects(layer)
                else:
                    # Even the sparsest assignment busts the budget: emit
                    # an empty layer (headers only), like the reference's
                    # failure path.
                    tt.apply_zero(layer)
            tt.commit_layer()


class GlobalPCRDAllocator:
    """Image-wide PCRD: ONE slope threshold per layer across ALL tiles.

    The reference (and PCRDAllocator) splits the byte budget
    proportionally per tile (`tile_frac`,
    reference: src/lib/jp2/TileProcessor.cpp pcrd_bisect_feasible:371
    runs per tile) — simple, communication-free, but suboptimal when
    content complexity varies across tiles. Global allocation spends the
    budget where the R-D slopes are steepest image-wide, the textbook
    PCRD-opt formulation.

    Concurrency: encode_tile calls this object once per tile from the
    tile thread pool, which must admit every tile at once; callers block
    at a barrier until every tile has registered, then the last one
    bisects the shared threshold — each iteration applies the threshold
    to every tile and sums the simulated packet bytes, tiles in
    `tile_index` order, so the float sums and the bytes do not depend on
    which thread registered first. An error in the allocation is raised
    in every waiting tile; `fail` does the same for a tile that failed
    before it registered, which would otherwise leave the others waiting.

    With `process_reduce` (the multi-process encode,
    `parallel.multihost`), `numtiles` counts the tiles this process owns
    (the barrier) and every sum runs over all the processes of the
    `torch.distributed` group: each process gathers every process's
    (tile index, float64 value) rows as int32 words (`_pg`), sorts them
    by tile index and sums them in that order, so every process derives
    the single-process allocator's thresholds bit for bit and the bytes
    do not depend on how the tiles were split. `global_numtiles` (the
    image's tiles) sizes the gathered rows; `numlayers` lets a process
    that owns no tile walk the layer loop in lockstep
    (`participate_empty`). Only the allocating thread of each process
    makes the collectives, and every process makes the same ones in the
    same order. A process that fails leaves the others in a collective
    until the group's timeout, which then raises there.

    The reference's device-mesh reduction (`mesh`: its `_mesh_sum`, a
    psum of per-shard partials, distortions in float32) is not ported:
    within one process every tile's tables are on the host already, so
    the tile-order float64 sum above serves a sharded encode too, and its
    bytes equal the one-device encode's by construction.
    """

    def __init__(self, rates: Sequence[float] = (),
                 quality_psnr: Sequence[float] = (),
                 image_bytes: int = 0, numtiles: int = 1,
                 process_reduce: bool = False, global_numtiles: int = 0,
                 numlayers: int = 0):
        self.rates = tuple(rates)
        self.quality_psnr = tuple(quality_psnr)
        self.image_bytes = image_bytes
        self.numtiles = numtiles
        self.process_reduce = process_reduce
        self.global_numtiles = global_numtiles or numtiles
        self._numlayers_hint = numlayers
        self._lock = threading.Lock()
        self._done = threading.Event()
        self._ctxs: List[RateControlCtx] = []
        self._error: Optional[BaseException] = None

    def participate_empty(self) -> None:
        """Join the allocation's collectives with no owned tile (a process
        of a group larger than the tile grid; without it every other
        process would wait in a collective)."""
        self._allocate()
        self._done.set()

    def fail(self, exc: BaseException) -> None:
        """Release every tile waiting at the barrier with `exc` (a tile
        that raised before it registered)."""
        with self._lock:
            if self._error is None:
                self._error = exc
        self._done.set()

    @staticmethod
    def _sum(values: List[float]) -> float:
        """The reference's local reduction (`_shard_partials` into one
        shard, then `_mesh_sum` without a mesh), in its float order."""
        parts = np.zeros(1)
        for v in values:
            parts[0] += v
        return float(parts.sum())

    # ---- the multi-process collectives (process_reduce) ----
    #
    # Every process must derive the float64 values the single-process
    # allocator computes, so floats cross as two int32 words and the
    # per-tile terms are summed in ascending tile order, the order of
    # `_allocate`'s sorted contexts.

    @staticmethod
    def _f64w(x: float) -> np.ndarray:
        return np.frombuffer(np.float64(x).tobytes(), np.int32).copy()

    @staticmethod
    def _wf64(words: np.ndarray) -> float:
        return float(np.frombuffer(
            np.ascontiguousarray(words, np.int32).tobytes(), np.float64)[0])

    @staticmethod
    def _pg(mat: np.ndarray) -> np.ndarray:
        """All-gather a small int32 matrix over the processes of the
        `torch.distributed` group (CPU tensors): the (P * rows, cols)
        stack, process 0 first. Every process calls it in lockstep with
        the same shape; without a group it is the matrix itself."""
        import torch
        import torch.distributed as dist
        mat = np.ascontiguousarray(mat, np.int32)
        if not dist.is_initialized():
            return mat
        t = torch.from_numpy(mat)
        parts = [torch.empty_like(t) for _ in range(dist.get_world_size())]
        dist.all_gather(parts, t)
        return torch.cat(parts).numpy().reshape((-1, mat.shape[-1]))

    def _rows_per_proc(self) -> int:
        import torch.distributed as dist
        p = dist.get_world_size() if dist.is_initialized() else 1
        return max(-(-self.global_numtiles // p), 1)

    def _psum_tiles(self, pairs) -> float:
        """Sum (tile_index, float64 value) pairs of every process in
        ascending tile order: bit-identical to the single-process sum over
        the sorted contexts."""
        k = self._rows_per_proc()
        pairs = list(pairs)
        if len(pairs) > k:
            raise ValueError(
                f"process registered {len(pairs)} tiles but the global "
                f"PCRD gather is sized for at most {k} per process "
                f"(global_numtiles={self.global_numtiles}); split tiles "
                "across processes more evenly or raise global_numtiles")
        for t, _ in pairs:
            if t < 0:
                raise ValueError(
                    "rate_alloc='global' requires every tile context to "
                    "carry a non-negative global tile_index; got "
                    f"tile_index={t} (left at the default?)")
        mat = np.full((k, 3), -1, np.int32)
        for i, (t, v) in enumerate(pairs):
            w = self._f64w(v)
            mat[i] = (t, w[0], w[1])
        g = self._pg(mat)
        g = g[g[:, 0] >= 0]
        g = g[np.argsort(g[:, 0], kind="stable")]
        total = np.float64(0.0)
        for row in g:
            total = total + np.frombuffer(
                np.ascontiguousarray(row[1:3]).tobytes(), np.float64)[0]
        return float(total)

    def _sum_live(self, live, fn) -> float:
        if self.process_reduce:
            return self._psum_tiles(
                [(tt.ctx.tile_index, float(fn(tt))) for tt in live])
        return self._sum([float(fn(tt)) for tt in live])

    def __call__(self, ctx: RateControlCtx) -> None:
        with self._lock:
            self._ctxs.append(ctx)
            is_last = len(self._ctxs) == self.numtiles
        if is_last:
            try:
                self._allocate()
            except BaseException as e:  # propagate to every waiter
                self._error = e
                raise
            finally:
                self._done.set()
        else:
            self._done.wait()
            if self._error is not None:
                raise RuntimeError(
                    "global PCRD allocation failed") from self._error

    def _allocate(self) -> None:
        # Deterministic reduction order: sort by global tile index
        # (stable, so callers that never set tile_index keep their
        # registration order).
        ctxs = sorted(self._ctxs, key=lambda c: c.tile_index)
        tables = [_TileTables(c) for c in ctxs]
        live = [tt for tt in tables if tt.slopes]
        for tt in tables:
            if not tt.slopes and tt.ctx.cblks:
                for cb in tt.ctx.cblks:
                    cb.layer_npasses[-1] = cb.numpasses
        if self.process_reduce:
            # one gather of [live tiles, slope min words, max words]
            lmin = min((min(tt.slopes) for tt in live), default=np.inf)
            lmax = max((max(tt.slopes) for tt in live), default=-np.inf)
            g = self._pg(np.concatenate([
                np.asarray([len(live)], np.int32), self._f64w(lmin),
                self._f64w(lmax)]).reshape(1, -1))
            if int(g[:, 0].sum()) == 0:
                return
            smin = min(self._wf64(row[1:3]) for row in g)
            smax = max(self._wf64(row[3:5]) for row in g)
            numlayers = ctxs[0].numlayers if ctxs else self._numlayers_hint
            if numlayers <= 0:
                raise ValueError("process_reduce allocation on a process "
                                 "with no tiles needs numlayers=")
        else:
            if not live:
                return
            numlayers = ctxs[0].numlayers
            smin = min(min(tt.slopes) for tt in live)
            smax = max(max(tt.slopes) for tt in live)
        max_se = self._sum_live(
            live, lambda tt: float((1 << tt.ctx.max_prec) - 1) ** 2
            * tt.ctx.tile_samples)
        distotal = self._sum_live(live, lambda tt: tt.distotile)

        def apply_all(thresh: Optional[float], layer: int) -> None:
            for tt in live:
                tt.apply(thresh, layer)

        def total_bytes(layer: int) -> float:
            return self._sum_live(
                live, lambda tt: float(tt.ctx.simulate_upto(layer)))

        def total_included(thresh: float) -> float:
            return self._sum_live(live, lambda tt: tt.included_dist(thresh))

        for layer in range(numlayers):
            rate = self.rates[layer] if layer < len(self.rates) else 0.0
            q = (self.quality_psnr[layer]
                 if layer < len(self.quality_psnr) else 0.0)
            target_bytes = 0
            if rate > 0:
                target_bytes = int(self.image_bytes / rate)
            if target_bytes <= 0 and q <= 0:
                for tt in live:
                    tt.apply(None, layer)
                    tt.store_objects(layer)
                    tt.prev_n = tt.numpasses_vec.copy()
                continue

            if q > 0:
                limit = max_se / (10.0 ** (q / 10.0))
                lo, hi = smin, smax
                if (distotal - total_included(smin)) <= limit:
                    for _ in range(60):
                        mid = 0.5 * (lo + hi)
                        if (distotal - total_included(mid)) <= limit:
                            lo = mid
                        else:
                            hi = mid
                    thresh = lo
                else:
                    thresh = smin
                apply_all(thresh, layer)
            else:
                lo, hi = smin, smax
                apply_all(hi, layer)
                if total_bytes(layer) <= target_bytes:
                    for _ in range(60):
                        mid = 0.5 * (lo + hi)
                        apply_all(mid, layer)
                        if total_bytes(layer) <= target_bytes:
                            hi = mid
                        else:
                            lo = mid
                    apply_all(hi, layer)
                else:
                    for tt in live:
                        tt.apply_zero(layer)
            for tt in live:
                tt.store_objects(layer)
                tt.commit_layer()


def make_layer_alloc(image, params) -> PCRDAllocator:
    """Build the allocator from EncoderParams (-r ratios / -q PSNR)."""
    image_bytes = sum(
        c.data.shape[0] * c.data.shape[1] * c.prec for c in image.components
    ) // 8
    return PCRDAllocator(rates=params.rates,
                         quality_psnr=params.quality_psnr,
                         image_bytes=image_bytes)
