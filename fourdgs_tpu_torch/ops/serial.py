"""Serial scalar stores and a per-tile counter with a dependent store
(counterpart: scripts/exp_pallas_serial.py, `store_kernel` and
`counter_kernel`, D4a and D4b).

`scalar_store` and `tile_counter_store` launch the CUDA kernels of
csrc/serial.cu for tensors on the card and run `scalar_store_plain` and
`tile_counter_store_plain` for tensors on the CPU; a CUDA tensor that a
kernel cannot take raises. `.launches` on each wrapper counts kernel
launches.

Both follow the script's serial loop, so among pairs that land on one
element the last one in order wins. Indexed assignment with repeated
indices leaves the winner undefined, so neither plain version uses it on
repeats: `scatter_reduce_("amax")` over the pair numbers names each
element's last writer first.
"""
from __future__ import annotations

import torch

from fourdgs_tpu_torch.ops import launches
from fourdgs_tpu_torch.ops._build import _launch, load_library

# The counting kernels' tile limit: one array of MAX_TILES int counters, a
# segment's staged items (32 bytes each for the binner's) and the kernels'
# 16 static bytes in the H100's 227 KB of opt-in shared memory
# (csrc/rank_common.cuh: rank_pairs, which checks the card's own limit)
MAX_TILES = 56_956


def _check_pairs(idx, val, what):
    if idx.dtype != torch.int32 or val.dtype != torch.int32:
        raise TypeError(f"{what} and val must be int32")
    if idx.dim() != 1 or idx.shape != val.shape:
        raise ValueError(f"{what} and val must be (M,), got "
                         f"{tuple(idx.shape)} and {tuple(val.shape)}")
    if idx.device != val.device:
        raise ValueError(f"{what} and val must share a device")
    if idx.shape[0] >= 2 ** 31:
        raise ValueError("at most 2^31 - 1 pairs")


def _store_last_plain(dest, val, n_out):
    """out (n_out,) zeros with out[dest[i]] = val[i], the largest i winning
    on each element; dest outside [0, n_out) dropped."""
    out = torch.zeros(n_out, dtype=torch.int32, device=val.device)
    keep = (dest >= 0) & (dest < n_out)
    d = dest[keep].long()
    order = torch.arange(dest.shape[0], device=val.device)[keep]
    winner = torch.full((n_out,), -1, dtype=torch.long, device=val.device)
    winner.scatter_reduce_(0, d, order, "amax")
    last = winner[d] == order
    out[d[last]] = val[keep][last]
    return out


def scalar_store(idx: torch.Tensor, val: torch.Tensor, *,
                 n_out: int) -> torch.Tensor:
    """out[idx[i]] = val[i] in order i over zeros -> (n_out,) int32: the
    last write wins among repeated indices; an index outside [0, n_out) is
    dropped. CUDA tensors launch D4a's kernel; CPU tensors run the plain
    version."""
    _check_pairs(idx, val, "idx")
    if n_out < 1:
        raise ValueError(f"n_out must be positive, got {n_out}")
    if idx.device.type == "cpu":
        return scalar_store_plain(idx, val, n_out=n_out)
    if idx.device.type != "cuda":
        raise ValueError(f"no serial-store kernel for device {idx.device}")
    lib = load_library()
    idx, val = idx.contiguous(), val.contiguous()
    buf = idx.new_empty(2 * n_out)      # out, then the kernel's winners
    _launch(lib, lib.scalar_store_launch, idx, idx.data_ptr(), val.data_ptr(),
            idx.shape[0], n_out, buf.data_ptr())
    launches.count(scalar_store)
    return buf[:n_out]


scalar_store.launches = 0


def scalar_store_plain(idx: torch.Tensor, val: torch.Tensor, *,
                       n_out: int) -> torch.Tensor:
    """The same stores: each element's last writer by `scatter_reduce_`,
    then one indexed assignment of the winners."""
    _check_pairs(idx, val, "idx")
    return _store_last_plain(idx, val, n_out)


def _check_counter(n_tiles, tile_cap, n_out):
    if not 1 <= n_tiles <= MAX_TILES:
        raise ValueError(f"n_tiles {n_tiles} outside [1, {MAX_TILES}]")
    if tile_cap < 1 or n_out < 1 or n_tiles * tile_cap >= 2 ** 31:
        raise ValueError(f"tile_cap {tile_cap} and n_out {n_out} must be "
                         f"positive, n_tiles * tile_cap below 2^31")


def tile_counter_store(tid: torch.Tensor, val: torch.Tensor, *, n_tiles: int,
                       tile_cap: int,
                       n_out: int) -> tuple[torch.Tensor, torch.Tensor]:
    """For each pair i in order: r = cnt[t]++ with t = tid[i], then
    out[min(t * tile_cap + r, n_out - 1)] = val[i], the last write winning
    on an element that two pairs reach. Returns out (n_out,) int32 over
    zeros and cnt (n_tiles,) int32; a tid outside [0, n_tiles) is neither
    counted nor stored. CUDA tensors launch D4b's kernels; CPU tensors run
    the plain version."""
    _check_pairs(tid, val, "tid")
    _check_counter(n_tiles, tile_cap, n_out)
    if tid.device.type == "cpu":
        return tile_counter_store_plain(tid, val, n_tiles=n_tiles,
                                        tile_cap=tile_cap, n_out=n_out)
    if tid.device.type != "cuda":
        raise ValueError(f"no tile-counter kernel for device {tid.device}")
    lib = load_library()
    tid, val = tid.contiguous(), val.contiguous()
    m = tid.shape[0]
    seg = lib.rank_segment_items()
    cnt = tid.new_empty(n_tiles)
    hist = tid.new_empty(n_tiles * max(-(-m // seg), 1))
    dest = tid.new_empty(m)
    buf = tid.new_empty(2 * n_out)      # out, then the kernel's winners
    _launch(lib, lib.tile_counter_store_launch, tid, tid.data_ptr(),
            val.data_ptr(), m, n_tiles, tile_cap, n_out, hist.data_ptr(),
            dest.data_ptr(), cnt.data_ptr(), buf.data_ptr())
    launches.count(tile_counter_store)
    return buf[:n_out], cnt


tile_counter_store.launches = 0


def serial_ranks(tile: torch.Tensor, n_tiles: int) -> tuple[torch.Tensor,
                                                            torch.Tensor]:
    """Each element's rank among the earlier elements on its tile, in
    order, and each tile's total: a stable sort by tile. Elements outside
    [0, n_tiles) get rank -1 and no count."""
    valid = (tile >= 0) & (tile < n_tiles)
    key = torch.where(valid, tile, n_tiles).long()
    ordered, perm = torch.sort(key, stable=True)
    total = torch.bincount(key, minlength=n_tiles + 1)
    start = torch.cumsum(total, 0) - total
    rank = torch.empty_like(key)
    rank[perm] = torch.arange(key.shape[0], device=key.device) \
        - start[ordered]
    return torch.where(valid, rank, -1), total[:n_tiles].to(torch.int32)


def tile_counter_store_plain(tid: torch.Tensor, val: torch.Tensor, *,
                             n_tiles: int, tile_cap: int,
                             n_out: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The same counter and stores: ranks by a stable sort by tile
    (`serial_ranks`), then the last-writer stores of `scalar_store_plain`."""
    _check_pairs(tid, val, "tid")
    _check_counter(n_tiles, tile_cap, n_out)
    rank, cnt = serial_ranks(tid, n_tiles)
    dest = torch.where(rank >= 0, torch.clamp(tid.long() * tile_cap + rank,
                                              max=n_out - 1), -1)
    return _store_last_plain(dest, val, n_out), cnt
