"""Tile-binned Gaussian rasterizer, differentiable
(counterpart: fourdgs_tpu/ops/rasterize_tiled.py).

  1. project_gaussians     — EWA projection (ops/projection.py)
  2. bin_gaussians_count   — per-tile fixed-capacity index lists
     (num_tiles, tile_cap) in depth order, with the JAX package's global
     pair budget and exact corner cull (or of a band of tile rows, the
     cull off: the tile-sharded step's); runs without autograd, as the
     JAX package stops the gradient into the binner (the binner kernel,
     csrc/binner.cu, on the card; the plain torch version on the CPU)
  3. blend                 — front-to-back compositing over the lists and
     its backward (ops/blend.py: CUDA kernels K1 and K2, or K3 under
     FOURDGS_PALLAS_NO_FUSED_BWD, on the card; the plain torch versions
     on the CPU). K3's table is reduced by K4 under
     FOURDGS_PALLAS_GRAD_SCATTER, else by `reassociate_pair_grads` over
     the binner's BlendSlots, as in the JAX package

Blending numerics follow the spec in ops/rasterize_ref.py. Spans
(utils/tracing.py): `raster.project`, `raster.bin`, `raster.blend`
(`raster.pack` and K1; in the backward `raster.blend_backward`, K2) and
`raster.compose`.
"""
from __future__ import annotations

import dataclasses
import os
from typing import NamedTuple

import torch

from fourdgs_tpu_torch.data.camera import Camera
from fourdgs_tpu_torch.ops import launches
from fourdgs_tpu_torch.ops._build import _launch, load_library
from fourdgs_tpu_torch.ops.blend import (blend, pack_attr_table,
                                         reassociates)
from fourdgs_tpu_torch.ops.projection import Projected, project_gaussians
from fourdgs_tpu_torch.ops.rasterize_ref import T_MIN, RenderOutput
from fourdgs_tpu_torch.ops.scatter import scatter_set_scalars
from fourdgs_tpu_torch.ops.serial import MAX_TILES
from fourdgs_tpu_torch.utils import tracing

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


class BlendSlots(NamedTuple):
    """The binner's slot metadata for the reassociated blend backward
    (JAX: rasterize_tiled.py:88-101). Each gaussian's pairs take one
    contiguous run of the global pair budget, so its gradient sum is a
    difference of prefix sums over slot space (`reassociate_pair_grads`).
    Np = ceil(n / bin_chunk) * bin_chunk, n_chunks = Np / bin_chunk."""
    dest: torch.Tensor   # (n_chunks, bin_pairs_per_chunk) int32: budget
    #                      slot -> row t * tile_cap + rank of the per-slot
    #                      table; num_tiles * tile_cap (out of bounds) for
    #                      a dropped, culled, past-tile_cap or empty slot
    slot0: torch.Tensor  # (Np,) int32 first slot of each depth-ordered
    #                      gaussian's run, min(run start, budget)
    alloc: torch.Tensor  # (Np,) int32 slots of its run inside the budget
    gid: torch.Tensor    # (Np,) int32 its gaussian index (n for padding)


class BinnedTiles(NamedTuple):
    gidx: torch.Tensor           # (num_tiles, tile_cap) int32, -1 padded
    counts: torch.Tensor         # (num_tiles,) int32
    num_pairs: torch.Tensor      # () int32 total pairs before capping
    dropped_pairs: torch.Tensor  # () int32 pairs beyond the pair budget
    dropped_tile: torch.Tensor   # () int32 pairs beyond per-tile cap
    overflow: torch.Tensor       # (num_tiles,) int32 per-tile cap excess
    slots: BlendSlots | None = None   # when the binner is asked for them


def bin_gaussians_count(proj: Projected, cfg: RasterConfig,
                        slots: bool = False,
                        num_tiles: int | None = None) -> BinnedTiles:
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
    the host, so that a CUDA graph can capture it. `slots` adds the
    BlendSlots of the reassociated backward.

    `num_tiles` (JAX's argument of the same name) bins a band of tile
    rows: `proj`'s rects clipped to the band (`clip_proj_to_tile_rows`),
    the lists covering its num_tiles tiles in band-local ids, and the
    corner cull off, since the band-local rect rows no longer give pixel
    rows."""
    kind = proj.depth.device.type
    if kind == "cuda":
        return bin_tiles(proj, cfg, slots, num_tiles)
    if kind in ("cpu", "meta"):
        return bin_gaussians_count_plain(proj, cfg, slots, num_tiles)
    raise ValueError(f"no binner for device {proj.depth.device}")


def _tiles(cfg: RasterConfig, num_tiles: int | None) -> int:
    """The tiles a binning covers: the grid's, or a band's."""
    if num_tiles is None:
        return cfg.num_tiles
    if not 0 < num_tiles <= cfg.num_tiles:
        raise ValueError(f"a band of {num_tiles} tiles outside (0, "
                         f"{cfg.num_tiles}]")
    return num_tiles


def clip_proj_to_tile_rows(proj: Projected, row0: int,
                           rows: int) -> Projected:
    """Restrict a projection's tile rects to `rows` tile rows starting at
    row `row0`, in band-local row coordinates (JAX:
    rasterize_tiled.py:132-150): the hook of the tile-sharded step, whose
    ranks each bin only their band of rows * grid_x tiles
    (`bin_gaussians_count(..., num_tiles=)`). A gaussian outside the band
    touches no tile of it."""
    y0 = torch.clamp(proj.rect_min[:, 1], row0, row0 + rows) - row0
    y1 = torch.clamp(proj.rect_max[:, 1], row0, row0 + rows) - row0
    span_x = torch.clamp(proj.rect_max[:, 0] - proj.rect_min[:, 0], min=0)
    touched = torch.where(proj.tiles_touched > 0,
                          span_x * torch.clamp(y1 - y0, min=0),
                          torch.zeros_like(span_x))
    rect_min = torch.stack([proj.rect_min[:, 0], y0], dim=-1)
    rect_max = torch.where((touched > 0)[:, None],
                           torch.stack([proj.rect_max[:, 0], y1], dim=-1),
                           rect_min)
    return proj._replace(rect_min=rect_min, rect_max=rect_max,
                         tiles_touched=touched)


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


def blend_slots(dest: torch.Tensor, touched_s: torch.Tensor,
                order: torch.Tensor, cfg: RasterConfig) -> BlendSlots:
    """The BlendSlots of a binning: `dest` (total_slots,) each budget
    slot's row of the per-slot table (or num_tiles * tile_cap),
    `touched_s` (n,) the depth-ordered gaussians' tiles touched and
    `order` (n,) their indices. Static shapes, no host sync."""
    n = order.shape[0]
    n_pad = -(-n // cfg.bin_chunk) * cfg.bin_chunk
    total_slots = _pair_budget(n, cfg)
    touched = torch.zeros(n_pad, dtype=torch.int64, device=order.device)
    touched[:n] = touched_s
    start = torch.cumsum(touched, 0) - touched
    gid = torch.full((n_pad,), n, dtype=torch.int32, device=order.device)
    gid[:n] = order
    return BlendSlots(
        dest=dest.to(torch.int32).reshape(-1, cfg.bin_pairs_per_chunk),
        slot0=torch.clamp(start, max=total_slots).to(torch.int32),
        alloc=torch.clamp(torch.minimum(touched, total_slots - start),
                          min=0).to(torch.int32),
        gid=gid)


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


def bin_tiles(proj: Projected, cfg: RasterConfig, slots: bool = False,
              num_tiles: int | None = None) -> BinnedTiles:
    """The binner on the card: the depth sort in PyTorch, then
    csrc/binner.cu: the depth-ordered items (bin_items_launch), their run
    ends (a cumulative sum in PyTorch), and the rank (rank_common.cuh's
    histogram, scan and walk) with the counts (bin_tiles_launch); K5
    after it under FOURDGS_BIN_SCATTER=pallas, or when `slots` asks for
    the BlendSlots, whose `dest` is the budget slots' rows that K5
    scatters. `num_tiles` bins a band (`bin_gaussians_count`): that many
    tiles, the corner cull off. `bin_tiles.launches` counts the binner's
    runs. Raises for what the kernels cannot take; it never falls back."""
    dev = proj.depth.device
    if dev.type != "cuda":
        raise ValueError(f"the binner kernel needs CUDA tensors, got {dev}")
    n, nt, cap = proj.depth.shape[0], _tiles(cfg, num_tiles), cfg.tile_cap
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
    per_slot = slots or os.environ.get("FOURDGS_BIN_SCATTER") == "pallas"
    if per_slot:    # the gather fills dest with n_out, gidx with -1
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
            cap, int(num_tiles is None), hist.data_ptr(), cnt.data_ptr(),
            *ptrs, counts.data_ptr(), overflow.data_ptr(), scalars.data_ptr())
    launches.count(bin_tiles)
    if per_slot:
        # the JAX package's switch (rasterize_tiled.py:383-393): K5 over
        # each budget slot's pair, the culled, past-tile_cap and empty
        # slots sent to n_out, which it drops (also the lists of a
        # binning whose slots the reassociated backward reads)
        gidx = scatter_set_scalars(dest, src, n_out=n_out)
    return BinnedTiles(gidx=gidx.reshape(nt, cap), counts=counts,
                       num_pairs=scalars[0], dropped_pairs=scalars[1],
                       dropped_tile=scalars[2], overflow=overflow,
                       slots=(blend_slots(dest, touched_s, order, cfg)
                              if slots else None))


bin_tiles.launches = 0


def bin_gaussians_count_plain(proj: Projected, cfg: RasterConfig,
                              slots: bool = False,
                              num_tiles: int | None = None) -> BinnedTiles:
    """The binner in PyTorch: slot s of the budget takes its owner by a
    search over the depth-ordered run ends, invalid and culled slots take
    the sentinel tile id `num_tiles`, a stable sort by tile id over the
    depth-ordered slots gives each pair its in-tile rank (the sentinel
    sorts last), and the lists are written through a sacrificial last
    index. The mechanism differs from the JAX package's rank scan, which
    works around TPU costs; the outputs are the same. Every shape is
    static and nothing is read to the host. `slots` adds the BlendSlots,
    each budget slot's row taken back from the sort's order. `num_tiles`
    bins a band, the corner cull off (`bin_gaussians_count`)."""
    dev = proj.depth.device
    n = proj.depth.shape[0]
    nt = _tiles(cfg, num_tiles)
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

    keep = slot < total
    if num_tiles is None:
        # ---- exact corner cull (the -1 absorbs qpix rounding) ----
        qpix = torch.round(torch.clamp(proj.pix[gid], -(1 << 20),
                                       1 << 20)).long()
        lox, loy = tx * ts, ty * ts
        ddx = torch.clamp(torch.maximum(lox - qpix[:, 0],
                                        qpix[:, 0] - (lox + ts - 1)) - 1,
                          0, _CULL_CLAMP)
        ddy = torch.clamp(torch.maximum(loy - qpix[:, 1],
                                        qpix[:, 1] - (loy + ts - 1)) - 1,
                          0, _CULL_CLAMP)
        keep = keep & (ddx * ddx + ddy * ddy <= proj.cull_r2[gid].long())
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
        slots=(blend_slots(torch.empty_like(dest).scatter_(0, perm, dest),
                           touched_s, order, cfg) if slots else None),
    )


def reassociate_pair_grads(packed: torch.Tensor, slots: BlendSlots,
                           n: int) -> torch.Tensor:
    """Per-gaussian sums (n, W) of the per-slot gradient rows `packed`
    (num_tiles * tile_cap, W), without a scatter-add (JAX:
    rasterize_tiled.py:567-602): each gaussian's slots are a contiguous
    run of the global slot space, so the rows are gathered into slot
    order (a dropped slot gives 0), summed by a cumulative sum within
    each block of bin_pairs_per_chunk slots plus the exclusive sums of
    the blocks before, and each run's sum is the difference of the
    prefix sums at its ends. Plain torch ops: the JAX package runs this
    as XLA, with no Pallas kernel. Only the rows that `slots.dest` names
    are read; the table's other rows may hold anything (K3 leaves the
    rows past a tile's occupied chunks unwritten). Deterministic: the
    same sums from run to run."""
    nblk, sblk = slots.dest.shape
    total_slots = nblk * sblk
    rows, w = packed.shape
    zero = torch.zeros((), dtype=packed.dtype, device=packed.device)
    dest = slots.dest.reshape(-1).long()
    gs = torch.where((dest < rows)[:, None],
                     packed[torch.clamp(dest, max=rows - 1)], zero)
    # column-major, so that each scan runs along the innermost axis (a
    # scan along an outer axis runs one thread a column on the card)
    cs_in = torch.cumsum(gs.t().reshape(w, nblk, sblk), dim=2)
    tot = cs_in[:, :, -1]                             # (w, nblk)
    boff = torch.cumsum(tot, dim=1) - tot             # exclusive block base
    cs = (cs_in + boff[:, :, None]).reshape(w, total_slots)

    def csf(i):
        """The sum of the slot rows before slot i, (w, len(i))."""
        i = i.long()
        return torch.where(i > 0, cs[:, torch.clamp(i - 1, min=0)], zero)

    seg = (csf(slots.slot0 + slots.alloc) - csf(slots.slot0)).t() \
        if total_slots else torch.zeros((slots.gid.shape[0], w),
                                        dtype=packed.dtype,
                                        device=packed.device)
    idx = torch.where(slots.gid < n, slots.gid, n).long()
    out = torch.zeros((n + 1, w), dtype=packed.dtype, device=packed.device)
    return out.index_put_((idx,), seg)[:n]


def _untile(x: torch.Tensor, cfg: RasterConfig) -> torch.Tensor:
    """(num_tiles, P, ...) -> (H, W, ...) crop."""
    t = cfg.tile_size
    ch = tuple(x.shape[2:])
    x = x.reshape((cfg.grid_y, cfg.grid_x, t, t) + ch)
    x = x.transpose(1, 2)  # (gy, t, gx, t, ...)
    x = x.reshape((cfg.grid_y * t, cfg.grid_x * t) + ch)
    return x[: cfg.img_height, : cfg.img_width]


def tile_image(img: torch.Tensor, cfg: RasterConfig) -> torch.Tensor:
    """(H, W, ...) -> (num_tiles, P, ...), the inverse of `_untile`
    (JAX: rasterize_tiled.py:735-746), zero-padded where H or W is not a
    multiple of the tile size: the tile-sharded step slices the targets
    by tile."""
    t = cfg.tile_size
    ch = tuple(img.shape[2:])
    pad_h = cfg.grid_y * t - img.shape[0]
    pad_w = cfg.grid_x * t - img.shape[1]
    if pad_h or pad_w:
        img = torch.cat([img, img.new_zeros((pad_h, img.shape[1]) + ch)])
        img = torch.cat([img, img.new_zeros((img.shape[0], pad_w) + ch)], 1)
    img = img.reshape((cfg.grid_y, t, cfg.grid_x, t) + ch).transpose(1, 2)
    return img.reshape((cfg.num_tiles, t * t) + ch)


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
    slots: bool = False,
) -> tuple[Projected, BinnedTiles]:
    """Projection (differentiable) and binning (on detached values),
    with the BlendSlots where `slots` asks for them."""
    with tracing.span("raster.project") as sp:
        proj = project_gaussians(
            means3d, scales, quats, camera, cfg.img_width, cfg.img_height,
            cfg.tile_size, ndc_offset=ndc_offset, alive=alive,
            scale_modifier=scale_modifier, opacities=opacities)
        proj = Projected(*sp.grads(*proj))
    with tracing.span("raster.bin"), torch.no_grad():
        binned = bin_gaussians_count(proj, cfg, slots)
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
    slots: bool = False,
) -> tuple[Projected, BinnedTiles, torch.Tensor]:
    """Projection, binning (with the BlendSlots where `slots` asks for
    them) and the packed attribute table: everything the blend kernels
    take, for checking them on a render's input. Returns (proj, binned,
    table)."""
    proj, binned = project_and_bin(means3d, scales, quats, opacities, camera,
                                   cfg, alive=alive,
                                   scale_modifier=scale_modifier,
                                   slots=slots)
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
    # the binner's slot runs, for a backward that reassociates
    slots = torch.is_grad_enabled() and reassociates()
    proj, binned = project_and_bin(means3d, scales, quats, opacities, camera,
                                   cfg, ndc_offset, alive, scale_modifier,
                                   slots)
    with tracing.span("raster.blend") as sp:
        color_t, depth_t, t_t = sp.grads(*blend(
            binned.gidx, binned.counts, proj.pix, proj.conic, colors,
            opacities, proj.depth, cfg, binned.slots))
    with tracing.span("raster.compose") as sp:
        t_img = _untile(t_t, cfg)
        color = _untile(color_t, cfg) + t_img[..., None] * bg
        # Effective tile-cap drops: a tile's excess counts only where some
        # pixel is still unsaturated. Dropped pairs sit behind every
        # composited one, so in a saturated tile they could not
        # contribute.
        unsat = (t_t > T_MIN).any(dim=1)
        dropped_tile = (binned.overflow * unsat).sum().to(torch.int32)
        tile_peak = (binned.counts + binned.overflow).max()
        color, depth, alpha = sp.grads(color, _untile(depth_t, cfg),
                                       1.0 - t_img)
        return RenderOutput(color=color, depth=depth,
                            alpha=alpha, radii=proj.radius,
                            visibility=proj.radius > 0,
                            dropped_pairs=binned.dropped_pairs,
                            dropped_tile=dropped_tile,
                            num_pairs=binned.num_pairs,
                            tile_peak=tile_peak)
