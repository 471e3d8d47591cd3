"""Serial pair expansion and per-tile rank, the prototype of a counting
binner without host syncs (counterpart: scripts/exp_pallas_binner_proto.py,
`make_kernel`, D2).

`expand_rank` launches the CUDA kernels of csrc/binner_proto.cu for tensors
on the card and runs `expand_rank_plain` for tensors on the CPU; a CUDA
tensor that the kernels cannot take raises. `expand_rank.launches` counts
launches.

For each gaussian i, chunk by chunk and in order, and each pair j < sx * sy
of its tile rect, in order: t = (y0 + j // sx) * grid_x + x0 + j % sx and
rank = cnt[t]++, with the counters carried across chunks, so a pair's rank
is the number of earlier pairs on its tile. If slot0 + j < pc, the chunk's
row slot0 + j becomes [dest, gid, 0, 0, 0, 0, 0, 0], dest = t * tile_cap
+ rank, or n_tiles * tile_cap once rank >= tile_cap. A pair past pc still
advances its counter but writes nothing, and rows that no pair writes stay
zero (the TPU leaves them undefined). Gaussians with sx or sy below 1 have
no pairs; a pair whose tile lies outside [0, n_tiles) takes no rank and,
if stored, the dest n_tiles * tile_cap. The stored pairs' slots must be
distinct, as a running offset per chunk gives them.
"""
from __future__ import annotations

import torch

from fourdgs_tpu_torch.ops import launches
from fourdgs_tpu_torch.ops.serial import MAX_TILES, serial_ranks

ROW_W = 8


def _check(arrays, pc, n_tiles, grid_x, tile_cap):
    if any(a.dtype != torch.int32 for a in arrays):
        raise TypeError("x0, y0, sx, sy, slot0 and gid must be int32")
    shape = arrays[0].shape
    if len(shape) not in (2, 3) or (len(shape) == 3 and shape[1] != 1) \
            or any(a.shape != shape for a in arrays):
        raise ValueError(f"the six inputs must share one shape (chunks, g) "
                         f"or (chunks, 1, g), got "
                         f"{[tuple(a.shape) for a in arrays]}")
    if any(a.device != arrays[0].device for a in arrays):
        raise ValueError("the six inputs must share a device")
    if not 1 <= n_tiles <= MAX_TILES:
        raise ValueError(f"n_tiles {n_tiles} outside [1, {MAX_TILES}]")
    if min(pc, grid_x, tile_cap) < 1 or (n_tiles + 1) * tile_cap >= 2 ** 31 \
            or shape[0] * pc * ROW_W >= 2 ** 31:
        raise ValueError(f"pc {pc}, grid_x {grid_x}, tile_cap {tile_cap} out "
                         f"of range")


def expand_rank(x0: torch.Tensor, y0: torch.Tensor, sx: torch.Tensor,
                sy: torch.Tensor, slot0: torch.Tensor, gid: torch.Tensor, *,
                pc: int, n_tiles: int, grid_x: int,
                tile_cap: int) -> torch.Tensor:
    """The six per-gaussian int32 inputs, (chunks, g) or the script's
    (chunks, 1, g) -> (chunks, pc, 8) int32 rows. CUDA tensors launch the
    kernels; CPU tensors run the plain version."""
    arrays = (x0, y0, sx, sy, slot0, gid)
    _check(arrays, pc, n_tiles, grid_x, tile_cap)
    if x0.device.type == "cpu":
        return expand_rank_plain(*arrays, pc=pc, n_tiles=n_tiles,
                                 grid_x=grid_x, tile_cap=tile_cap)
    if x0.device.type != "cuda":
        raise ValueError(f"no binner kernel for device {x0.device}")
    from fourdgs_tpu_torch.ops._build import check_launch, load_library
    lib = load_library()
    arrays = [a.contiguous() for a in arrays]
    n_chunks, g = x0.shape[0], x0.shape[-1]
    n = n_chunks * g
    seg = lib.rank_segment_items()
    dev = x0.device
    with torch.cuda.device(dev):
        out = torch.zeros((n_chunks, pc, ROW_W), dtype=torch.int32,
                          device=dev)
        hist = torch.empty(n_tiles * max(-(-n // seg), 1), dtype=torch.int32,
                           device=dev)
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.expand_rank_launch(*(a.data_ptr() for a in arrays), n, g,
                                     pc, n_tiles, grid_x, tile_cap,
                                     hist.data_ptr(), out.data_ptr(), stream)
    check_launch(lib, "expand_rank", err)
    launches.count(expand_rank)
    return out


expand_rank.launches = 0


def expand_rank_plain(x0: torch.Tensor, y0: torch.Tensor, sx: torch.Tensor,
                      sy: torch.Tensor, slot0: torch.Tensor,
                      gid: torch.Tensor, *, pc: int, n_tiles: int,
                      grid_x: int, tile_cap: int) -> torch.Tensor:
    """The same rows: the pairs expanded in serial order with
    `repeat_interleave`, ranks by a stable sort by tile
    (`ops/serial.py:serial_ranks`), one indexed assignment of the stored
    rows."""
    arrays = (x0, y0, sx, sy, slot0, gid)
    _check(arrays, pc, n_tiles, grid_x, tile_cap)
    n_chunks, g = x0.shape[0], x0.shape[-1]
    x0, y0, sx, sy, slot0, gid = (a.reshape(-1).long() for a in arrays)
    dev = x0.device
    touched = torch.where((sx > 0) & (sy > 0), sx * sy, 0)
    owner = torch.repeat_interleave(torch.arange(x0.shape[0], device=dev),
                                    touched)
    first = torch.cumsum(touched, 0) - touched
    j = torch.arange(owner.shape[0], device=dev) - first[owner]
    w = sx[owner]
    tile = (y0[owner] + torch.div(j, w, rounding_mode="floor")) * grid_x \
        + x0[owner] + torch.remainder(j, w)
    rank, _ = serial_ranks(tile, n_tiles)
    dest = torch.where((rank >= 0) & (rank < tile_cap), tile * tile_cap + rank,
                       n_tiles * tile_cap)
    slot = slot0[owner] + j
    stored = (slot >= 0) & (slot < pc)
    out = torch.zeros((n_chunks, pc, ROW_W), dtype=torch.int32, device=dev)
    chunk, slot = owner[stored] // g, slot[stored]
    out[chunk, slot, 0] = dest[stored].to(torch.int32)
    out[chunk, slot, 1] = gid[owner[stored]].to(torch.int32)
    return out
