"""Binning and blending of the reference, in plain PyTorch.

The blending semantics are those of fourdgs_tpu_torch/ops/rasterize_ref.py
(the port's specification): gaussians composited per pixel in ascending
view depth (ties by index), alpha = min(0.99, opacity * exp(power)) with
power > 0 skipped, alpha < 1/255 skipped, a gaussian used only while the
entering transmittance passes 1e-4, a gaussian covering only the pixels of
the tiles of its projected rect, color = sum c alpha T + T_final bg. The
per-chunk recurrence `_chunk_math` is a frozen copy of
fourdgs_tpu_torch/ops/blend.py:_chunk_math (the order in which its gate
values are computed is the one the port's kernels reproduce), the corner
cull a copy of the plain binner's (fourdgs_tpu_torch/ops/rasterize_tiled.py:
bin_gaussians_count_plain; a culled pair has alpha < 1/255 at every pixel
of its tile, so it changes no image, only the count of evaluations).
The lists here hold every pair: no tile cap and no pair budget.

`blend_tiles` walks each batch of tiles chunk by chunk and stops once every
pixel of the batch has exited; it also counts the evaluations the inputs
need: the list entries each pixel of the image reaches with its
transmittance above 1e-4 (`Evaluations`; the pixels of a partial tile
beyond the image's edge need nothing).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from portbench.reference.precision import matmul
from portbench.reference.splats import ALPHA_MAX, ALPHA_MIN, Projected

T_MIN = 1e-4
CULL_CLAMP = 23000


class Tiles(NamedTuple):
    """Depth-ordered per-tile lists: `gid` the pairs' gaussian ids grouped
    by tile, `start` and `count` (num_tiles,) each tile's run in it."""
    gid: torch.Tensor
    start: torch.Tensor
    count: torch.Tensor
    grid_x: int
    tile_size: int
    width: int
    height: int


class Evaluations(NamedTuple):
    """What one render's inputs need of a blend: `evaluated`, the (pixel,
    gaussian) pairs reached with the entering transmittance above 1e-4;
    `contributing`, those of them that pass the 1/255 gate."""
    evaluated: int
    contributing: int


def bin_tiles(proj: Projected, width: int, height: int,
              tile_size: int) -> Tiles:
    """Every (tile, gaussian) pair of the gaussians' rects, the corner cull
    applied, each tile's pairs in depth order."""
    dev = proj.depth.device
    grid_x = -(-width // tile_size)
    grid_y = -(-height // tile_size)
    nt = grid_x * grid_y
    touched = proj.tiles_touched.long()
    inf = torch.full_like(proj.depth, float("inf"))
    order = torch.sort(torch.where(touched > 0, proj.depth.detach(), inf),
                       stable=True).indices
    counts = touched[order]
    total = int(counts.sum())
    owner = torch.repeat_interleave(
        torch.arange(order.shape[0], device=dev), counts,
        output_size=total)
    local = torch.arange(total, device=dev) - (torch.cumsum(counts, 0)
                                               - counts)[owner]
    gid = order[owner]
    rmin = proj.rect_min[gid].long()
    sx = torch.clamp(proj.rect_max[gid, 0].long() - rmin[:, 0], min=1)
    dy = torch.div(local, sx, rounding_mode="floor")
    tx = rmin[:, 0] + (local - dy * sx)
    ty = rmin[:, 1] + dy
    qpix = torch.round(torch.clamp(proj.pix.detach()[gid], -(1 << 20),
                                   1 << 20)).long()
    lox, loy = tx * tile_size, ty * tile_size
    ddx = torch.clamp(torch.maximum(lox - qpix[:, 0],
                                    qpix[:, 0] - (lox + tile_size - 1)) - 1,
                      0, CULL_CLAMP)
    ddy = torch.clamp(torch.maximum(loy - qpix[:, 1],
                                    qpix[:, 1] - (loy + tile_size - 1)) - 1,
                      0, CULL_CLAMP)
    keep = ddx * ddx + ddy * ddy <= proj.cull_r2[gid].long()
    tile_id = (ty * grid_x + tx)[keep]
    gid = gid[keep]
    tile_sorted, perm = torch.sort(tile_id, stable=True)
    count = torch.bincount(tile_sorted, minlength=nt)
    start = torch.cumsum(count, 0) - count
    return Tiles(gid[perm], start, count, grid_x, tile_size, width, height)


def _chunk_math(rows, px, py, t):
    dx = rows[:, :, 0:1] - px[:, None, :]
    dy = rows[:, :, 1:2] - py[:, None, :]
    power = (-0.5 * (rows[:, :, 2:3] * dx * dx
                     + rows[:, :, 4:5] * dy * dy)
             - rows[:, :, 3:4] * dx * dy)
    alpha_u = torch.where(
        power > 0.0, torch.zeros_like(power),
        rows[:, :, 8:9] * torch.exp(torch.clamp(power, max=0.0)))
    alpha = torch.clamp(alpha_u, max=ALPHA_MAX)
    gated = alpha >= ALPHA_MIN
    g = torch.where(gated, alpha, torch.zeros_like(alpha))
    cp = torch.cumprod(1.0 - g, dim=1)
    t_pref = t[:, None, :] * torch.cat(
        [torch.ones_like(cp[:, :1]), cp[:, :-1]], dim=1)
    use = gated & (t_pref > T_MIN)
    w = torch.where(use, alpha, torch.zeros_like(alpha)) * t_pref
    t_next = t * torch.where(use, cp, torch.ones_like(cp)).amin(dim=1)
    return use, t_pref, w, t_next


def pack_table(proj: Projected, colors, opacities) -> torch.Tensor:
    """(N+1, 10) rows [pix(2), conic(3), color(3), opacity, depth] and a
    zero row at N for the padding (opacity 0: no contribution)."""
    rows = torch.cat([proj.pix, proj.conic, colors, opacities[:, None],
                      proj.depth[:, None]], dim=1)
    return torch.cat([rows, rows.new_zeros((1, rows.shape[1]))])


def tile_pixels(tiles: Tiles, tile_ids: torch.Tensor):
    """(nb, P) float pixel x and y of the given tiles."""
    t = tiles.tile_size
    pix = torch.arange(t * t, device=tile_ids.device)
    px = (tile_ids % tiles.grid_x)[:, None] * t + (pix % t)[None, :]
    py = (tile_ids // tiles.grid_x)[:, None] * t + (pix // t)[None, :]
    return px.to(torch.float32), py.to(torch.float32)


def blend_tiles(table: torch.Tensor, tiles: Tiles, tile_ids: torch.Tensor,
                bg: torch.Tensor, chunk: int, precision: str):
    """Color (nb, P, 3) of a batch of tiles, and the batch's
    (evaluated, contributing) counts as 0-d tensors."""
    n = table.shape[0] - 1
    dev = table.device
    px, py = tile_pixels(tiles, tile_ids)
    count = tiles.count[tile_ids]
    start = tiles.start[tile_ids]
    longest = int(count.max()) if tile_ids.numel() else 0
    nb, p = px.shape
    inside = ((px < tiles.width) & (py < tiles.height))[:, None, :]
    color = table.new_zeros((nb, p, 3))
    t = table.new_ones((nb, p))
    evaluated = torch.zeros((), dtype=torch.int64, device=dev)
    contributing = torch.zeros((), dtype=torch.int64, device=dev)
    for j in range(0, longest, chunk):
        if j and not bool((t > T_MIN).any()):
            break
        pos = j + torch.arange(chunk, device=dev)
        valid = pos[None, :] < count[:, None]                    # (nb, K)
        at = torch.clamp(start[:, None] + pos[None, :],
                         max=max(tiles.gid.shape[0] - 1, 0))
        idx = torch.where(valid, tiles.gid[at] if tiles.gid.numel()
                          else torch.full_like(at, n), n)
        rows = table[idx]                                         # (nb,K,10)
        use, t_pref, w, t = _chunk_math(rows, px, py, t)
        live = valid[:, :, None] & (t_pref > T_MIN) & inside
        evaluated = evaluated + live.sum()
        contributing = contributing + (use & inside).sum()
        color = color + matmul(w.transpose(1, 2), rows[:, :, 5:8],
                               precision)
    return color + t[..., None] * bg, evaluated, contributing


def tile_batches(tiles: Tiles, batch: int):
    """Tile ids in batches of `batch`, sorted by list length so that a
    batch's padding is small."""
    order = torch.argsort(tiles.count, descending=True)
    return [order[i:i + batch] for i in range(0, order.shape[0], batch)]


def untile_into(image: torch.Tensor, color: torch.Tensor, tiles: Tiles,
                tile_ids: torch.Tensor) -> None:
    """Write a batch's (nb, P, 3) colors into the (H, W, 3) image."""
    h, w = image.shape[:2]
    px, py = tile_pixels(tiles, tile_ids)
    px, py = px.long().reshape(-1), py.long().reshape(-1)
    inside = (px < w) & (py < h)
    image[py[inside], px[inside]] = color.reshape(-1, 3)[inside]


def rasterize(proj: Projected, colors, opacities, bg, width, height,
              tile_size: int, precision: str, chunk: int = 32,
              batch: int = 128):
    """(image (H, W, 3), Evaluations) without autograd."""
    with torch.no_grad():
        tiles = bin_tiles(proj, width, height, tile_size)
        table = pack_table(proj, colors, opacities)
        image = table.new_zeros((height, width, 3))
        ev = co = 0
        for ids in tile_batches(tiles, batch):
            color, e, c = blend_tiles(table, tiles, ids, bg, chunk,
                                      precision)
            untile_into(image, color, tiles, ids)
            ev += int(e)
            co += int(c)
    return image, Evaluations(ev, co)
