"""The port's DWT (`ops/dwt.py`) against the reference's Pallas DWT and numpy
oracle, on the CPU, and its CUDA kernel against its plain version on the card.

On a CPU tensor `ops/dwt` runs its plain version (`dwt_torch`); it must
equal `dwt_np` exactly, 5/3 and 9/7, and the Pallas kernels
(`dwt_pallas.fwd_dwt_2d` / `inv_dwt_2d` in interpret mode, as
`tests/test_dwt_pallas.py` runs them) exactly for 5/3, and for 9/7 within
4 float32 ulps of the band's largest magnitude (the measure of
`tests/test_torch_transform.py`) for each of the four lifting steps of
each level the band went through, 16 ulps a level: the Pallas kernel
lifts in place at stride 2^level under XLA, which may contract a*b+c
into an FMA, and it lands up to 6 ulps from `dwt_np` after one forward
level and 12 after an inverse of one to three levels. Geometries: (2, h, w) batches at the origin and at odd origins, and
ones with single-sample levels, which the Pallas kernels do not take
(`dwt_pallas.supports`) and are held to `dwt_np` only. The `gpu` case holds
the CUDA kernel to the plain version bit for bit; it runs where JAX is not
installed, so the reference is imported inside the CPU tests.
"""

import numpy as np
import pytest
import torch

from grokimagecompression_tpu_torch.core.geometry import Rect
from grokimagecompression_tpu_torch.ops import dwt, dwt_torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Torch on one thread: the plain versions run many small CPU ops, and
    under pytest-xdist's workers torch's OpenMP threads oversubscribe the
    cores and spin (a case of 2.4 s alone took 43 s among six workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# (x0, y0, x1, y1, numresolutions)
GEOMS = [
    (0, 0, 64, 48, 3),
    (1, 3, 67, 50, 3),       # odd origin in both axes
    (3, 5, 40, 37, 2),
    (5, 2, 6, 17, 3),        # 1 wide: single-sample lines at every level
    (7, 9, 10, 11, 3),       # 3 x 2: single-sample lines from level 1 on
    # one below, at and one above the CUDA kernel's tile sides (64, 32,
    # 16: dwt.TILES), some at odd origins
    (0, 0, 63, 63, 3),
    (0, 0, 64, 64, 3),
    (1, 3, 66, 68, 3),
    (1, 1, 32, 34, 2),
    (3, 5, 19, 21, 2),
    (0, 0, 17, 15, 2),
]
IDS = [f"{g[2] - g[0]}x{g[3] - g[1]}@{g[0]},{g[1]}_r{g[4]}" for g in GEOMS]


def _reference():
    """(Rect, dwt_np, dwt_pallas) of the reference package."""
    from grokimagecompression_tpu.core.geometry import Rect as RefRect
    from grokimagecompression_tpu.ops import dwt_np, dwt_pallas
    return RefRect, dwt_np, dwt_pallas


def _input(rect, reversible, seed):
    rng = np.random.default_rng(seed)
    x = rng.integers(-(1 << 10), 1 << 10, size=(2, rect.h, rect.w))
    return x.astype(np.int32 if reversible else np.float32)


def _ulp_close(want, got, ulps=4):
    want = np.asarray(want, np.float32)
    got = np.asarray(got, np.float32)
    assert want.shape == got.shape
    if want.size == 0:
        return
    tol = ulps * np.spacing(np.float32(np.abs(want).max()))
    np.testing.assert_array_less(np.abs(want - got), tol + 1e-30)


def _pallas_close(want, got, reversible, levels):
    """5/3 exact; 9/7 within 4 ulps per lifting step of `levels` levels."""
    if reversible:
        np.testing.assert_array_equal(np.asarray(want), got)
    else:
        _ulp_close(want, got, ulps=16 * levels)


@pytest.mark.parametrize("reversible", [True, False], ids=["53", "97"])
@pytest.mark.parametrize("geom", GEOMS, ids=IDS)
def test_forward_matches_numpy_and_pallas(geom, reversible):
    RefRect, dwt_np, dwt_pallas = _reference()
    *corners, nres = geom
    rect, ref_rect = Rect(*corners), RefRect(*corners)
    x = _input(rect, reversible, seed=sum(corners))
    before = dwt.LAUNCHES["dwt"]
    got = dwt.fwd_dwt_2d(torch.from_numpy(x), rect, nres, reversible)
    assert dwt.LAUNCHES["dwt"] == before     # the CPU runs the plain version
    for i in range(2):
        want = dwt_np.fwd_dwt_2d(x[i], ref_rect, nres, reversible=reversible)
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_array_equal(got[k][i].numpy(), want[k],
                                          err_msg=str(k))
    if dwt_pallas.supports(ref_rect, nres):
        pal = dwt_pallas.fwd_dwt_2d(x, ref_rect, nres, interpret=True,
                                    reversible=reversible)
        for (r, o) in pal:
            levels = nres - 1 if r == 0 else nres - r
            _pallas_close(pal[(r, o)], got[(r, o)].numpy(), reversible,
                          levels)


@pytest.mark.parametrize("reversible", [True, False], ids=["53", "97"])
@pytest.mark.parametrize("geom", GEOMS, ids=IDS)
def test_inverse_matches_numpy_and_pallas(geom, reversible):
    RefRect, dwt_np, dwt_pallas = _reference()
    *corners, nres = geom
    rect, ref_rect = Rect(*corners), RefRect(*corners)
    x = _input(rect, reversible, seed=7 + sum(corners))
    bands = [dwt_np.fwd_dwt_2d(x[i], ref_rect, nres, reversible=reversible)
             for i in range(2)]
    stacked = {k: np.stack([b[k] for b in bands]) for k in bands[0]}
    got = dwt.inv_dwt_2d({k: torch.from_numpy(v) for k, v in stacked.items()},
                         rect, nres, reversible).numpy()
    for i in range(2):
        want = dwt_np.inv_dwt_2d(bands[i], ref_rect, nres,
                                 reversible=reversible)
        np.testing.assert_array_equal(got[i], want)
    if reversible:
        np.testing.assert_array_equal(got, x)
    if dwt_pallas.supports(ref_rect, nres):
        pal = dwt_pallas.inv_dwt_2d(stacked, ref_rect, nres, interpret=True,
                                    reversible=reversible)
        _pallas_close(pal, got, reversible, nres - 1)


# reduced inverses (max_res below the levels): odd tile origins, and edge
# tiles whose sides are not powers of two (a 740-wide last column of a
# 10980-wide image in 1024 tiles, a tile cut by an odd image offset)
REDUCED_GEOMS = [(1, 3, 67, 50, 4), (10240, 10240, 10980, 10980, 6),
                 (5, 3, 96, 96, 4), (289, 194, 300, 260, 4),
                 (10241, 7, 10980, 300, 5)]
REDUCED_IDS = [f"{g[2] - g[0]}x{g[3] - g[1]}@{g[0]},{g[1]}_r{g[4]}"
               for g in REDUCED_GEOMS]


@pytest.mark.parametrize("reversible", [True, False], ids=["53", "97"])
@pytest.mark.parametrize("geom", REDUCED_GEOMS[::2],
                         ids=REDUCED_IDS[::2])
def test_reduced_inverse_matches_numpy(geom, reversible):
    """The inverse to every max_res below the levels equals `dwt_np`'s,
    the reference host decoder's reduced inverse."""
    RefRect, dwt_np, _ = _reference()
    *corners, nres = geom
    rect, ref_rect = Rect(*corners), RefRect(*corners)
    x = _input(rect, reversible, seed=11)[:1]
    want_bands = dwt_np.fwd_dwt_2d(x[0], ref_rect, nres,
                                   reversible=reversible)
    bands = {k: torch.from_numpy(v[None]) for k, v in want_bands.items()}
    for max_res in range(nres - 1):
        got = dwt.inv_dwt_2d(bands, rect, nres, reversible, max_res)
        want = dwt_np.inv_dwt_2d(want_bands, ref_rect, nres,
                                 reversible=reversible, max_res=max_res)
        np.testing.assert_array_equal(got[0].numpy(), want)


def test_band_shapes_match_numpy():
    """Batched band shapes equal the oracle's at a config-1-like geometry
    (6 resolutions)."""
    RefRect, dwt_np, _ = _reference()
    rect = Rect(0, 0, 64, 64)
    x = torch.zeros((3, 64, 64), dtype=torch.int32)
    got = dwt.fwd_dwt_2d(x, rect, 6)
    want = dwt_np.fwd_dwt_2d(np.zeros((64, 64), np.int32),
                             RefRect(0, 0, 64, 64), 6)
    assert {k: tuple(v.shape) for k, v in got.items()} == \
        {k: (3,) + v.shape for k, v in want.items()}


def test_tile_choice_fills_the_card():
    """Each level takes the largest tile that still gives MIN_CTAS CTAs."""
    assert dwt.tile_for(32, 512, 512) == 64       # config-1 chunk, level 0
    assert dwt.tile_for(32, 32, 32) == 16
    assert dwt.tile_for(3, 2048, 2048) == 64      # config-2 frame
    assert dwt.tile_for(3, 256, 256) == 32
    assert dwt.tile_for(3, 128, 128) == 16
    for n, h, w in [(1, 1, 1), (2, 65, 65), (40, 64, 64)]:
        t = dwt.tile_for(n, h, w)
        assert t in dwt.TILES
        assert t == dwt.TILES[-1] or n * -(-h // t) * -(-w // t) >= \
            dwt.MIN_CTAS


@pytest.mark.gpu
def test_cuda_kernel_matches_plain(monkeypatch):
    """Every geometry under each tile side: MIN_CTAS 1 takes the largest
    tile, the default the wrapper's choice, a huge one the smallest."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda")
    geoms = GEOMS + [(0, 0, 512, 512, 6), (0, 0, 2048, 256, 6),
                     (0, 0, 13000, 4, 2), (0, 0, 200, 70, 2),
                     (0, 1, 264, 141, 3)]
    cases = [(g, r, m) for g in geoms for r in (True, False)
             for m in (1, dwt.MIN_CTAS, 1 << 30)]
    for (*corners, nres), reversible, min_ctas in cases:
        monkeypatch.setattr(dwt, "MIN_CTAS", min_ctas)
        rect = Rect(*corners)
        x = torch.from_numpy(_input(rect, reversible, seed=1))
        want = dwt_torch.fwd_dwt_2d(x, rect, nres, reversible)
        before = dwt.LAUNCHES["dwt"]
        got = dwt.fwd_dwt_2d(x.to(dev), rect, nres, reversible)
        back = dwt.inv_dwt_2d(got, rect, nres, reversible)
        torch.cuda.synchronize()
        # at most one launch per level and direction (none for a level of
        # no samples)
        assert before < dwt.LAUNCHES["dwt"] <= before + 2 * (nres - 1)
        for k in want:
            assert torch.equal(got[k].cpu(), want[k]), (corners, k, min_ctas)
        assert torch.equal(back.cpu(), dwt_torch.inv_dwt_2d(
            want, rect, nres, reversible)), (corners, min_ctas)


@pytest.mark.gpu
def test_cuda_reduced_inverse_matches_plain(monkeypatch):
    """The CUDA inverse to every max_res from 0 to the levels, on odd
    origins and edge-tile shapes, equals `dwt_torch`'s bit for bit, at
    every tile side; one launch a level inverted."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda")
    for (*corners, nres), reversible, min_ctas in [
            (g, r, m) for g in REDUCED_GEOMS for r in (True, False)
            for m in (1, dwt.MIN_CTAS, 1 << 30)]:
        monkeypatch.setattr(dwt, "MIN_CTAS", min_ctas)
        rect = Rect(*corners)
        x = torch.from_numpy(_input(rect, reversible, seed=3))
        bands = dwt_torch.fwd_dwt_2d(x, rect, nres, reversible)
        on_card = {k: v.to(dev) for k, v in bands.items()}
        for max_res in range(nres):
            before = dwt.LAUNCHES["dwt"]
            got = dwt.inv_dwt_2d(on_card, rect, nres, reversible, max_res)
            torch.cuda.synchronize()
            assert dwt.LAUNCHES["dwt"] - before == max_res
            want = dwt_torch.inv_dwt_2d(bands, rect, nres, reversible,
                                        max_res)
            assert torch.equal(got.cpu(), want), (corners, max_res,
                                                  min_ctas)
