"""Multi-process encode over `torch.distributed`, image-wide PCRD included.

Port of `grokimagecompression_tpu/parallel/multihost.py`. Each process
codes the tiles it owns (tile t to process t % P) on its own device and
runs their T2 through the one encoder code path
(`encoder.write_codestream(only_tiles=)`); with `rate_alloc="global"`
that T2 runs the process-reduce `pcrd.GlobalPCRDAllocator`, whose sums
cross every process as int32 words in tile order, so every process
derives the single-process thresholds bit for bit. The finished tile
results then cross every process (`gather_tile_bytes`) and each process
assembles the whole codestream from them
(`encoder.write_codestream(tile_results=)`): every process returns the
same bytes, equal to the one-process `encoder.encode`'s.

Every payload is host data (pickled tile results, int32 words), so the
group is a gloo one: gloo carries them between nodes and between two
processes on one card, which NCCL refuses. A collective that waits
longer than the group's timeout raises, so a process that fails does
not leave the others waiting for ever.
"""

from __future__ import annotations

import datetime
import pickle
from typing import List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from ..codestream import encoder
from ..core.params import EncoderParams
from ..utils.device import DeviceLike, resolve_device

TIMEOUT_S = 600


def init_distributed(coordinator: str, num_processes: int, process_id: int,
                     timeout_s: float = TIMEOUT_S) -> None:
    """Join the gloo process group at `coordinator` ("host:port" of
    process 0) as process `process_id` of `num_processes`; a collective
    that waits longer than `timeout_s` raises. Nothing happens when the
    process has joined a group already."""
    if dist.is_initialized():
        return
    dist.init_process_group(
        "gloo", init_method=f"tcp://{coordinator}", world_size=num_processes,
        rank=process_id, timeout=datetime.timedelta(seconds=timeout_s))


def _rank_world():
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def owned_tiles(numtiles: int, process_id: Optional[int] = None,
                num_processes: Optional[int] = None) -> List[int]:
    """The tiles of process `process_id` (this one by default): tile t
    belongs to process t % P."""
    rank, world = _rank_world()
    p = rank if process_id is None else process_id
    n = world if num_processes is None else num_processes
    return [t for t in range(numtiles) if t % n == p]


def gather_tile_bytes(local: Sequence[bytes], owned: Sequence[int],
                      numtiles: int) -> List[bytes]:
    """All-gather per-tile byte strings over the process group: `local[i]`
    holds the bytes of tile `owned[i]`; every process returns all
    `numtiles` of them. The lengths cross first (an int32 all-gather),
    then every process's (numtiles, longest) uint8 rows, zero where it
    owns no tile, which are summed: each tile has one owner."""
    _, world = _rank_world()
    lens = np.zeros(numtiles, np.int32)
    for t, b in zip(owned, local):
        lens[t] = len(b)
    if world == 1:
        all_lens = lens[None]
    else:
        t_lens = torch.from_numpy(lens)
        parts = [torch.empty_like(t_lens) for _ in range(world)]
        dist.all_gather(parts, t_lens)
        all_lens = torch.stack(parts).numpy()
    cap = max(int(all_lens.max()), 1)
    mat = np.zeros((numtiles, cap), np.uint8)
    for t, b in zip(owned, local):
        mat[t, :len(b)] = np.frombuffer(b, np.uint8)
    if world == 1:
        total = mat
    else:
        t_mat = torch.from_numpy(mat)
        parts = [torch.empty_like(t_mat) for _ in range(world)]
        dist.all_gather(parts, t_mat)
        total = torch.stack(parts).to(torch.int32).sum(0).to(
            torch.uint8).numpy()
    ends = all_lens.max(axis=0)
    return [total[t, :int(ends[t])].tobytes() for t in range(numtiles)]


def encode_multihost(image, params: Optional[EncoderParams] = None,
                     rsiz: int = 0, device: DeviceLike = None) -> bytes:
    """Encode one image with its tiles split over the processes of the
    group (`init_distributed`); every process returns the same
    codestream, equal to `encoder.encode`'s. Each process codes its own
    tiles (`owned_tiles`) on `device`, by default `cuda:{rank % the
    card count}`, and runs their T2 (under `rate_alloc="global"` with the
    process-reduce allocator); the tile results cross the group
    (`gather_tile_bytes`) and every process writes the codestream from
    them. With one process this is `encoder.encode`. HT rate control
    (HT with `rates`), whose step search spans the whole image, raises
    NotImplementedError with more than one process."""
    params = params or EncoderParams()
    rank, world = _rank_world()
    if device is None:
        device = "cuda" if not torch.cuda.is_available() else \
            torch.device("cuda", rank % torch.cuda.device_count())
    dev = resolve_device(device)
    if world == 1:
        return encoder.encode(image, params, device=dev, rsiz=rsiz)
    numtiles = encoder.tile_count(image, params)
    owned = owned_tiles(numtiles)
    mine = encoder._encode(image, params, None, [dev], rsiz,
                           only_tiles=owned)
    gathered = gather_tile_bytes([pickle.dumps(mine[t]) for t in owned],
                                 owned, numtiles)
    results = {t: pickle.loads(gathered[t]) for t in range(numtiles)}
    return encoder.write_codestream(image, params, None, rsiz,
                                    tile_results=results)
