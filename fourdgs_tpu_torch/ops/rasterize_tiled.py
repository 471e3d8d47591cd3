"""Tile-binned Gaussian rasterizer, differentiable
(counterpart: fourdgs_tpu/ops/rasterize_tiled.py).

  1. project_gaussians     — EWA projection (ops/projection.py)
  2. bin_gaussians_count   — per-tile fixed-capacity index lists
     (num_tiles, tile_cap) in depth order, with the JAX package's global
     pair budget and exact corner cull; runs without autograd, as the
     JAX package stops the gradient into the binner (the binner kernel,
     csrc/binner.cu, on the card; the plain torch version on the CPU)
  3. blend                 — front-to-back compositing over the lists and
     its backward (ops/blend.py: CUDA kernels K1 and K2, or K3 under
     FOURDGS_PALLAS_NO_FUSED_BWD, on the card; the plain torch versions
     on the CPU)

Blending numerics follow the spec in ops/rasterize_ref.py.
"""
from __future__ import annotations

import dataclasses
import os
from typing import NamedTuple

import torch
from torch.profiler import record_function

from fourdgs_tpu_torch.data.camera import Camera
from fourdgs_tpu_torch.ops._build import _launch, load_library
from fourdgs_tpu_torch.ops.blend import blend, pack_attr_table
from fourdgs_tpu_torch.ops.projection import Projected, project_gaussians
from fourdgs_tpu_torch.ops.rasterize_ref import T_MIN, RenderOutput
from fourdgs_tpu_torch.ops.scatter import scatter_set_scalars
from fourdgs_tpu_torch.ops.serial import MAX_TILES

# corner-cull distance clamp: 2 * 23000^2 stays below the 2^30 no-cull
# sentinel, as in the JAX binner
_CULL_CLAMP = 23000


@dataclasses.dataclass(frozen=True)
class RasterConfig:
    """Static rasterizer configuration."""
    img_width: int
    img_height: int
    tile_size: int = 16
    tile_cap: int = 1024       # max gaussians composited per tile
    chunk: int = 32            # gaussians per compositing step
    bin_chunk: int = 4096      # gaussians per pair-budget unit
    bin_pairs_per_chunk: int = 32768  # pair slots per bin_chunk gaussians

    @property
    def grid_x(self) -> int:
        return -(-self.img_width // self.tile_size)

    @property
    def grid_y(self) -> int:
        return -(-self.img_height // self.tile_size)

    @property
    def num_tiles(self) -> int:
        return self.grid_x * self.grid_y

    @property
    def pixels_per_tile(self) -> int:
        return self.tile_size * self.tile_size


class BinnedTiles(NamedTuple):
    gidx: torch.Tensor           # (num_tiles, tile_cap) int32, -1 padded
    counts: torch.Tensor         # (num_tiles,) int32
    num_pairs: torch.Tensor      # () int32 total pairs before capping
    dropped_pairs: torch.Tensor  # () int32 pairs beyond the pair budget
    dropped_tile: torch.Tensor   # () int32 pairs beyond per-tile cap
    overflow: torch.Tensor       # (num_tiles,) int32 per-tile cap excess


def bin_gaussians_count(proj: Projected, cfg: RasterConfig) -> BinnedTiles:
    """Per-tile depth-ordered gaussian index lists, with the contract of
    the JAX package's counting binner.

    Pair budget: depth-ordered gaussians take contiguous slot runs in one
    budget of `ceil(n / bin_chunk) * bin_pairs_per_chunk` slots, each run
    in row-major order over the gaussian's tile rect; the first
    `total_slots` pairs of that expansion are kept, including the partial
    run of the gaussian that straddles the budget. The exact corner cull
    then drops kept pairs whose whole tile lies beyond the gate radius,
    and each remaining pair takes its rank among the earlier ones on its
    tile.

    Tensors on the card run the binner kernel (`bin_tiles`,
    csrc/binner.cu); tensors on the CPU, and `meta` tensors (shape
    checks), run `bin_gaussians_count_plain`. Both give the same
    BinnedTiles bit for bit, every shape is static and nothing is read to
    the host, so that a CUDA graph can capture it."""
    kind = proj.depth.device.type
    if kind == "cuda":
        return bin_tiles(proj, cfg)
    if kind in ("cpu", "meta"):
        return bin_gaussians_count_plain(proj, cfg)
    raise ValueError(f"no binner for device {proj.depth.device}")


def _pair_budget(n: int, cfg: RasterConfig) -> int:
    """The binner's slots for n gaussians: bin_pairs_per_chunk per
    bin_chunk of them, as in the JAX binner."""
    return -(-n // cfg.bin_chunk) * cfg.bin_pairs_per_chunk


def _depth_order(proj: Projected) -> torch.Tensor:
    """The gaussians in depth order, those that touch no tile last: a
    stable sort, so that ties keep their index order."""
    inf = torch.full_like(proj.depth, float("inf"))
    return torch.sort(torch.where(proj.tiles_touched > 0, proj.depth, inf),
                      stable=True).indices


def depth_ordered_items(proj: Projected, cfg: RasterConfig
                        ) -> tuple[torch.Tensor, torch.Tensor, int]:
    """The binner kernel's items, the plain version of its gather
    (csrc/binner.cu: bin_items_kernel) and the run ends: each gaussian's
    row in depth order -> rows (n, 8) int32 [rect x0, rect y0, sx,
    touched, qpix x, qpix y, cull_r2, gid], the inclusive run ends (n,)
    int32 (the cumulative sum of touched) and total_slots, the pair
    budget."""
    n = proj.depth.shape[0]
    total_slots = _pair_budget(n, cfg)
    order = _depth_order(proj)
    qpix = torch.round(torch.clamp(proj.pix, -(1 << 20), 1 << 20)).to(
        torch.int32)
    sx = torch.clamp(proj.rect_max[:, 0] - proj.rect_min[:, 0], min=1)
    table = torch.stack([
        proj.rect_min[:, 0], proj.rect_min[:, 1], sx, proj.tiles_touched,
        qpix[:, 0], qpix[:, 1], proj.cull_r2,
        torch.arange(n, dtype=torch.int32, device=proj.depth.device)], 1)
    rows = table.index_select(0, order)
    ends = torch.cumsum(rows[:, 3], 0, dtype=torch.int32)
    return rows, ends, total_slots


def _aligned(x: torch.Tensor, what: str, nbytes: int) -> torch.Tensor:
    x = x.contiguous()
    if x.data_ptr() % nbytes:
        raise ValueError(f"the binner kernel needs {what} {nbytes}-byte "
                         f"aligned")
    return x


def bin_tiles(proj: Projected, cfg: RasterConfig) -> BinnedTiles:
    """The binner on the card: the depth sort in PyTorch, then
    csrc/binner.cu: the depth-ordered items (bin_items_launch), their run
    ends (a cumulative sum in PyTorch), and the rank (rank_common.cuh's
    histogram, scan and walk) with the counts (bin_tiles_launch); K5
    after it under FOURDGS_BIN_SCATTER=pallas. `bin_tiles.launches`
    counts the binner's runs. Raises for what the kernels cannot take; it
    never falls back."""
    dev = proj.depth.device
    if dev.type != "cuda":
        raise ValueError(f"the binner kernel needs CUDA tensors, got {dev}")
    n, nt, cap = proj.depth.shape[0], cfg.num_tiles, cfg.tile_cap
    n_out = nt * cap
    total_slots = _pair_budget(n, cfg)
    if not 1 <= nt <= MAX_TILES:
        raise ValueError(f"{nt} tiles outside [1, {MAX_TILES}]")
    if n_out >= 2 ** 31 or total_slots >= 2 ** 31:
        raise ValueError(f"{n_out} list slots or a budget of {total_slots} "
                         f"pairs past int32")
    ints = (proj.rect_min, proj.rect_max, proj.tiles_touched, proj.cull_r2)
    if proj.pix.dtype != torch.float32 or any(x.dtype != torch.int32
                                              for x in ints):
        raise TypeError("the binner kernel needs float32 pix and int32 "
                        "rects, tiles_touched and cull_r2")
    lib = load_library()
    order = _depth_order(proj)
    rows = proj.tiles_touched.new_empty((n, 8))
    touched_s = proj.tiles_touched.new_empty(n)
    pallas = os.environ.get("FOURDGS_BIN_SCATTER") == "pallas"
    if pallas:      # the gather fills dest with n_out, gidx with -1
        gidx = None
        dest, src = rows.new_empty(total_slots), rows.new_empty(total_slots)
        ptrs, fill, value = (0, dest.data_ptr(), src.data_ptr()), dest, n_out
    else:
        gidx = rows.new_empty(n_out)
        ptrs, fill, value = (gidx.data_ptr(), 0, 0), gidx, -1
    _launch(lib, lib.bin_items_launch, rows, order.data_ptr(),
            _aligned(proj.pix, "pix", 8).data_ptr(),
            _aligned(proj.rect_min, "rect_min", 8).data_ptr(),
            _aligned(proj.rect_max, "rect_max", 8).data_ptr(),
            proj.tiles_touched.contiguous().data_ptr(),
            proj.cull_r2.contiguous().data_ptr(), n, rows.data_ptr(),
            touched_s.data_ptr(), fill.data_ptr(), fill.numel(), value)
    ends = torch.cumsum(touched_s, 0, dtype=torch.int32)
    seg = lib.rank_segment_items()
    scratch = rows.new_empty(max(-(-n // seg), 1) * nt + nt)
    hist, cnt = scratch[:-nt], scratch[-nt:]
    out = rows.new_empty(2 * nt + 3)
    counts, overflow, scalars = out[:nt], out[nt:2 * nt], out[2 * nt:]
    _launch(lib, lib.bin_tiles_launch, rows, rows.data_ptr(),
            ends.data_ptr(), n, total_slots, nt, cfg.grid_x, cfg.tile_size,
            cap, hist.data_ptr(), cnt.data_ptr(), *ptrs, counts.data_ptr(),
            overflow.data_ptr(), scalars.data_ptr())
    bin_tiles.launches += 1
    if pallas:
        # the JAX package's switch (rasterize_tiled.py:383-393): K5 over
        # each budget slot's pair, the culled, past-tile_cap and empty
        # slots sent to n_out, which it drops
        gidx = scatter_set_scalars(dest, src, n_out=n_out)
    return BinnedTiles(gidx=gidx.reshape(nt, cap), counts=counts,
                       num_pairs=scalars[0], dropped_pairs=scalars[1],
                       dropped_tile=scalars[2], overflow=overflow)


bin_tiles.launches = 0


def bin_gaussians_count_plain(proj: Projected,
                              cfg: RasterConfig) -> BinnedTiles:
    """The binner in PyTorch: slot s of the budget takes its owner by a
    search over the depth-ordered run ends, invalid and culled slots take
    the sentinel tile id `num_tiles`, a stable sort by tile id over the
    depth-ordered slots gives each pair its in-tile rank (the sentinel
    sorts last), and the lists are written through a sacrificial last
    index. The mechanism differs from the JAX package's rank scan, which
    works around TPU costs; the outputs are the same. Every shape is
    static and nothing is read to the host."""
    dev = proj.depth.device
    n = proj.depth.shape[0]
    nt = cfg.num_tiles
    ts = cfg.tile_size
    total_slots = _pair_budget(n, cfg)

    order = _depth_order(proj)
    touched_s = proj.tiles_touched[order].long()
    off = torch.cumsum(touched_s, 0)                    # run ends
    total = off[-1:].sum()                              # 0 when n == 0

    # ---- pair expansion (depth-major, row-major within each rect) ----
    slot = torch.arange(total_slots, device=dev)
    owner = torch.clamp(torch.searchsorted(off, slot, right=True),
                        max=max(n - 1, 0))              # depth rank per slot
    local = slot - (off - touched_s)[owner]
    gid = order[owner]
    rmin = proj.rect_min[gid].long()
    sx = torch.clamp(proj.rect_max[gid, 0].long() - rmin[:, 0], min=1)
    dy = torch.div(local, sx, rounding_mode="floor")
    tx = rmin[:, 0] + (local - dy * sx)
    ty = rmin[:, 1] + dy

    # ---- exact corner cull (the -1 absorbs qpix rounding) ----
    qpix = torch.round(torch.clamp(proj.pix[gid], -(1 << 20), 1 << 20)).long()
    lox, loy = tx * ts, ty * ts
    ddx = torch.clamp(torch.maximum(lox - qpix[:, 0],
                                    qpix[:, 0] - (lox + ts - 1)) - 1,
                      0, _CULL_CLAMP)
    ddy = torch.clamp(torch.maximum(loy - qpix[:, 1],
                                    qpix[:, 1] - (loy + ts - 1)) - 1,
                      0, _CULL_CLAMP)
    keep = (slot < total) & (ddx * ddx + ddy * ddy
                             <= proj.cull_r2[gid].long())
    tile_id = torch.where(keep, ty * cfg.grid_x + tx, nt)

    # ---- in-tile rank: stable sort by tile keeps depth order ----
    tile_sorted, perm = torch.sort(tile_id, stable=True)
    counter = torch.zeros(nt + 1, dtype=torch.long, device=dev).scatter_add_(
        0, tile_id, torch.ones_like(tile_id))
    tile_start = torch.cumsum(counter, 0) - counter
    rank = slot - tile_start[tile_sorted]
    counter = counter[:nt]
    n_out = nt * cfg.tile_cap
    dest = torch.where((tile_sorted < nt) & (rank < cfg.tile_cap),
                       tile_sorted * cfg.tile_cap + rank, n_out)
    src = gid[perm].to(torch.int32)
    if os.environ.get("FOURDGS_BIN_SCATTER") == "pallas":
        # the JAX package's switch (rasterize_tiled.py:383-393): K5, with
        # the pairs past tile_cap sent to index n_out, which it drops
        gidx = scatter_set_scalars(dest.to(torch.int32), src, n_out=n_out)
    else:
        gidx = torch.full((n_out + 1,), -1, dtype=torch.int32,
                          device=dev).scatter_(0, dest, src)[:n_out]

    overflow = torch.clamp(counter - cfg.tile_cap, min=0).to(torch.int32)
    return BinnedTiles(
        gidx=gidx.reshape(nt, cfg.tile_cap),
        counts=torch.clamp(counter, max=cfg.tile_cap).to(torch.int32),
        num_pairs=proj.tiles_touched.sum().to(torch.int32),
        dropped_pairs=torch.clamp(total - total_slots, min=0).to(torch.int32),
        dropped_tile=overflow.sum().to(torch.int32),
        overflow=overflow,
    )


def _untile(x: torch.Tensor, cfg: RasterConfig) -> torch.Tensor:
    """(num_tiles, P, ...) -> (H, W, ...) crop."""
    t = cfg.tile_size
    ch = tuple(x.shape[2:])
    x = x.reshape((cfg.grid_y, cfg.grid_x, t, t) + ch)
    x = x.transpose(1, 2)  # (gy, t, gx, t, ...)
    x = x.reshape((cfg.grid_y * t, cfg.grid_x * t) + ch)
    return x[: cfg.img_height, : cfg.img_width]


def project_and_bin(
    means3d: torch.Tensor,
    scales: torch.Tensor,
    quats: torch.Tensor,
    opacities: torch.Tensor,     # (N,) activated
    camera: Camera,
    cfg: RasterConfig,
    ndc_offset: torch.Tensor | None = None,
    alive: torch.Tensor | None = None,
    scale_modifier: float = 1.0,
) -> tuple[Projected, BinnedTiles]:
    """Projection (differentiable) and binning (on detached values)."""
    with record_function("raster.project"):
        proj = project_gaussians(
            means3d, scales, quats, camera, cfg.img_width, cfg.img_height,
            cfg.tile_size, ndc_offset=ndc_offset, alive=alive,
            scale_modifier=scale_modifier, opacities=opacities)
    with record_function("raster.bin"), torch.no_grad():
        binned = bin_gaussians_count(proj, cfg)
    return proj, binned


def prepare_blend(
    means3d: torch.Tensor,
    scales: torch.Tensor,
    quats: torch.Tensor,
    opacities: torch.Tensor,     # (N,) activated
    colors: torch.Tensor,        # (N, 3) precomputed RGB
    camera: Camera,
    cfg: RasterConfig,
    alive: torch.Tensor | None = None,
    scale_modifier: float = 1.0,
) -> tuple[Projected, BinnedTiles, torch.Tensor]:
    """Projection, binning and the packed attribute table: everything
    the blend kernels take, for checking them on a render's input.
    Returns (proj, binned, table)."""
    proj, binned = project_and_bin(means3d, scales, quats, opacities, camera,
                                   cfg, alive=alive,
                                   scale_modifier=scale_modifier)
    with torch.no_grad():
        table = pack_attr_table(proj.pix, proj.conic, colors, opacities,
                                proj.depth)
    return proj, binned, table


def rasterize(
    means3d: torch.Tensor,
    scales: torch.Tensor,
    quats: torch.Tensor,
    opacities: torch.Tensor,     # (N,) activated
    colors: torch.Tensor,        # (N, 3) precomputed RGB
    camera: Camera,
    bg: torch.Tensor,            # (3,)
    cfg: RasterConfig,
    ndc_offset: torch.Tensor | None = None,   # (N, 2) zero grad-carrier
    alive: torch.Tensor | None = None,
    scale_modifier: float = 1.0,
) -> RenderOutput:
    """Differentiable render of one camera, in the means, scales, quats,
    opacities, colors and `ndc_offset` (whose gradient is the densify
    statistic)."""
    proj, binned = project_and_bin(means3d, scales, quats, opacities, camera,
                                   cfg, ndc_offset, alive, scale_modifier)
    with record_function("raster.blend"):
        color_t, depth_t, t_t = blend(binned.gidx, binned.counts, proj.pix,
                                      proj.conic, colors, opacities,
                                      proj.depth, cfg)
    with record_function("raster.compose"):
        t_img = _untile(t_t, cfg)
        color = _untile(color_t, cfg) + t_img[..., None] * bg
        # Effective tile-cap drops: a tile's excess counts only where some
        # pixel is still unsaturated. Dropped pairs sit behind every
        # composited one, so in a saturated tile they could not
        # contribute.
        unsat = (t_t > T_MIN).any(dim=1)
        dropped_tile = (binned.overflow * unsat).sum().to(torch.int32)
        tile_peak = (binned.counts + binned.overflow).max()
        return RenderOutput(color=color, depth=_untile(depth_t, cfg),
                            alpha=1.0 - t_img, radii=proj.radius,
                            visibility=proj.radius > 0,
                            dropped_pairs=binned.dropped_pairs,
                            dropped_tile=dropped_tile,
                            num_pairs=binned.num_pairs,
                            tile_peak=tile_peak)
