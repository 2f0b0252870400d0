"""Multi-device encode and decode: the tile grid is the data-parallel axis.

Port of `grokimagecompression_tpu/parallel/sharding.py`. A mesh is a
sequence of torch devices, one shard per entry (`utils.device.
resolve_mesh`); entries may repeat a device, so two shards can share one
card, or the CPU.

The encode groups an image's tiles by their fused plan and splits each
group's tile stack over the mesh as the reference's `shard_map` splits
its batch: contiguous blocks of ceil(b / ndev) tiles, shard di on
mesh[di]. Each shard runs the fused encode of its tiles on its device's
own encoder (`encoder.plan_encoder`, one per plan and device), chunked to
what that device's free memory holds, a CUDA shard on a host thread of
its own, so that every card's shard is submitted before any is
collected and the cards run together. Tiles are independent, so no collective runs between shards.
Markers, tile-parts, packed headers and rate control (image-wide PCRD
included) all run through the one encoder code path
(`encoder.write_codestream`), so the sharded bytes equal the one-device
encode's. The decode mirror is `codestream.decoder.decode(mesh=)`, which
sends each plan group's tiles round-robin over the mesh.

Unlike the reference, a tile the fused plan cannot code raises
NotImplementedError (the reference codes such a tile on its host), and
so does a request in an MQ code-block style other than the default or
with HT refinement passes on more than one shard
(`encoder._out_of_slice`, `decoder._check_mesh`):
the reference's transform-only mesh route (`transform_tiles_on_mesh`,
`inverse_tiles_on_mesh`, `pcrd_global_stats`), which feeds its host
coder, is not ported; on one device such a request takes the port's
host Tier-1 route.
"""

from __future__ import annotations

import collections
import concurrent.futures
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..codestream import encoder
from ..core.geometry import tile_grid_size, tile_rect
from ..core.image import Image
from ..core.params import DecoderParams, EncoderParams
from ..models import fused_encode
from ..utils.device import DeviceLike, resolve_mesh

Mesh = Sequence[DeviceLike]


def default_mesh(n_devices: Optional[int] = None) -> List[torch.device]:
    """The first `n_devices` cards, all of `torch.cuda.device_count()` by
    default. Raises without CUDA: a CPU mesh exists only when the caller
    builds one (`[torch.device("cpu")] * n`)."""
    if not torch.cuda.is_available():
        raise RuntimeError("default_mesh needs CUDA (torch.cuda."
                           "is_available() is False); build a CPU mesh "
                           "explicitly")
    count = torch.cuda.device_count()
    n = count if n_devices is None else n_devices
    if not 1 <= n <= count:
        raise ValueError(f"a mesh of {n} cards: {count} are present")
    return [torch.device("cuda", i) for i in range(n)]


def shard_blocks(items: Sequence, ndev: int) -> List[List]:
    """`items` split as the reference's `shard_map` splits a batch padded
    to a multiple of `ndev`: shard di holds the contiguous block of
    ceil(b / ndev) items from di * ceil(b / ndev), fewer or none at the
    end."""
    n = -(-len(items) // ndev)
    return [list(items[di * n:(di + 1) * n]) for di in range(ndev)]


def plan_shards(tiles: Sequence[int], plans: Sequence, ndev: int
                ) -> List[Tuple[object, int, List[int]]]:
    """(plan, shard index, tiles) of every non-empty shard: `tiles`
    grouped by their `plans` in order of first appearance, each group
    split over `ndev` shards by `shard_blocks`."""
    by_plan: Dict[object, List[int]] = {}
    for t, plan in zip(tiles, plans):
        by_plan.setdefault(plan, []).append(t)
    return [(plan, di, part) for plan, group in by_plan.items()
            for di, part in enumerate(shard_blocks(group, ndev)) if part]


def _code_shard(image: Image, siz, work, chunks) -> Dict[int, List]:
    """One shard's fused encode: its (encoder, tiles) runs, each stacked
    and coded `chunks[i]` tiles a call, a chunk collected once the next
    is submitted (at most two chunks' outputs on the device). Returns
    {tile: segments}."""
    segs: Dict[int, List] = {}
    prev = None
    for (enc, tiles), n in zip(work, chunks):
        for lo in range(0, len(tiles), n):
            part = tiles[lo:lo + n]
            stacks = zip(*(encoder.extract_tile_comps(image, siz, t)
                           for t in part))
            handle = fused_encode.encode_tile_submit(
                [np.stack(c) for c in stacks], enc)
            if prev is not None:
                segs.update(zip(prev[0], fused_encode.encode_tile_collect(
                    prev[1])))
            prev = (part, handle)
    if prev is not None:
        segs.update(zip(prev[0], fused_encode.encode_tile_collect(prev[1])))
    return segs


def fused_entropy_tiles_on_mesh(image: Image, siz, cod, qcd, mesh: Mesh,
                                coder: str, cod_comp=None, want_rd=False,
                                custom_mct=None,
                                tiles: Optional[Sequence[int]] = None
                                ) -> Dict[int, List]:
    """The fused device encode of every tile (or of the tiles numbered in
    `tiles`) over the mesh: {tile_index: segments in t1-desc order} (HT
    segment bytes, MQ (data, numbps, numpasses) tuples, with `want_rd`
    each with its R-D pass table), as `encoder.write_codestream` takes
    them.

    The tiles are grouped by their fused plan (`encoder.tile_plans`, with
    the COC overrides `cod_comp` and a custom MCT's coding matrix
    `custom_mct`), each group split over the mesh (`shard_blocks`) and
    each shard coded on its device's encoder for the plan. A shard's
    chunk is capped to its device's free memory shared among the mesh's
    shards on that device (`encoder._capped_chunk`). With more than one
    CUDA shard, each CUDA shard runs on a host thread of its own; the
    others run one after another on the calling thread. An error in any
    shard is raised here. Raises NotImplementedError for a tile the
    fused plan cannot code."""
    devs = resolve_mesh(mesh)
    ntx, nty = tile_grid_size(siz.xsiz, siz.ysiz, siz.xosiz, siz.yosiz,
                              siz.xtsiz, siz.ytsiz, siz.xtosiz, siz.ytosiz)
    wanted = list(range(ntx * nty)) if tiles is None else sorted(tiles)
    plans = encoder.tile_plans(
        siz, cod, qcd, [tile_rect(t, siz.xsiz, siz.ysiz, siz.xosiz,
                                  siz.yosiz, siz.xtsiz, siz.ytsiz,
                                  siz.xtosiz, siz.ytosiz) for t in wanted],
        coder, cod_comp, want_rd, custom_mct)
    if any(d.type == "cuda" for d in devs):
        from ..ops import _build
        _build.load()
    shares = collections.Counter(devs)
    encoders: Dict = {}
    work = [[] for _ in devs]
    chunks = [[] for _ in devs]
    for plan, di, part in plan_shards(wanted, plans, len(devs)):
        work[di].append((encoder.plan_encoder(plan, devs[di], encoders),
                         part))
        chunks[di].append(max(1, min(encoder._capped_chunk(
            len(part), [plan], devs[di], shares=shares[devs[di]]),
            len(part))))
    live = [di for di in range(len(devs)) if work[di]]
    # a CUDA shard waits on its card at its syncs, so CUDA shards run on
    # threads of their own; a CPU shard computes as it submits, and CPU
    # shards on threads only contend for the interpreter, so they run on
    # the calling thread
    pooled = [di for di in live if devs[di].type == "cuda"]
    pooled = pooled if len(pooled) > 1 else []
    out: Dict[int, List] = {}
    with concurrent.futures.ThreadPoolExecutor(
            max_workers=max(1, len(pooled))) as ex:
        futures = [ex.submit(_code_shard, image, siz, work[di], chunks[di])
                   for di in pooled]
        for di in live:
            if di not in pooled:
                out.update(_code_shard(image, siz, work[di], chunks[di]))
        for fut in futures:
            out.update(fut.result())
    return out


def encode_sharded(image: Image, params: Optional[EncoderParams] = None,
                   mesh: Optional[Mesh] = None) -> bytes:
    """Encode with the tiles sharded over the mesh (all cards by
    default): `encoder.encode(mesh=)`, byte-identical to the one-device
    encode for every request it takes."""
    return encoder.encode(image, params, mesh=mesh or default_mesh())


def decode_sharded(data: bytes, params: Optional[DecoderParams] = None,
                   mesh: Optional[Mesh] = None) -> Image:
    """Decode with each plan group's tiles round-robin over the mesh (all
    cards by default): `decoder.decode(mesh=)`, pixel-identical to the
    one-device decode for every request it takes."""
    from ..codestream import decoder
    return decoder.decode(data, params, mesh=mesh or default_mesh())
