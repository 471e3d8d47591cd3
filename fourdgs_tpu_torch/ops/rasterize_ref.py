"""Oracle rasterizer, blending constants and the render output record
(counterpart: fourdgs_tpu/ops/rasterize_ref.py).

`rasterize_reference` is exact per-pixel alpha compositing in plain
torch: the numerical specification the tiled path (ops/rasterize_tiled.py,
ops/blend.py) is held to, in images and in autograd gradients. It loops
over the gaussians in Python, so it is for small scenes only.

Blending semantics, shared by every blend in this package (the oracle,
the plain versions and the CUDA kernels of ops/blend.py):
  * gaussians are composited in ascending view-depth order;
  * alpha_i = min(0.99, opacity_i * exp(power_i)),
    power_i = -0.5*(A dx^2 + C dy^2) - B dx dy, d = splat_center - pixel;
    power > 0 means skip;
  * a gaussian is skipped at a pixel if alpha_i < 1/255;
  * a gaussian contributes at a pixel only while the ENTERING
    transmittance T_i > 1e-4 (prefix test);
  * out_color = sum_i c_i alpha_i T_i + T_final * bg;
  * a gaussian covers only pixels whose tile lies in its projected rect;
  * out_depth = sum_i z_i alpha_i T_i (expected depth, unnormalized).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from fourdgs_tpu_torch.data.camera import Camera
from fourdgs_tpu_torch.ops.projection import (ALPHA_MAX, ALPHA_MIN,
                                              project_gaussians)

T_MIN = 1e-4


class RenderOutput(NamedTuple):
    color: torch.Tensor        # (H, W, 3)
    depth: torch.Tensor        # (H, W)
    alpha: torch.Tensor        # (H, W) = 1 - T_final
    radii: torch.Tensor        # (N,) int32
    visibility: torch.Tensor   # (N,) bool
    # binner overflow telemetry: fixed-capacity buffers drop the furthest
    # pairs when a scene exceeds tile_cap or the pair budget
    dropped_pairs: torch.Tensor | None = None   # () int32
    dropped_tile: torch.Tensor | None = None    # () int32
    num_pairs: torch.Tensor | None = None       # () int32 total (pre-cap)
    tile_peak: torch.Tensor | None = None       # () int32 max true per-tile
    #                                             count (pre-cap)


def rasterize_reference(
    means3d: torch.Tensor,
    scales: torch.Tensor,
    quats: torch.Tensor,
    opacities: torch.Tensor,     # (N,) activated in (0, 1)
    colors: torch.Tensor,        # (N, 3) precomputed RGB
    camera: Camera,
    img_width: int,
    img_height: int,
    bg: torch.Tensor,            # (3,)
    tile_size: int = 16,
    ndc_offset: torch.Tensor | None = None,
    alive: torch.Tensor | None = None,
) -> RenderOutput:
    """Composite every gaussian over every pixel of its rect in depth
    order (the projection's culled and rect-less gaussians skipped)."""
    proj = project_gaussians(means3d, scales, quats, camera, img_width,
                             img_height, tile_size, ndc_offset=ndc_offset,
                             alive=alive, opacities=opacities)
    dev = means3d.device
    visible = proj.tiles_touched > 0
    order = torch.argsort(torch.where(visible, proj.depth.detach(),
                                      torch.full_like(proj.depth,
                                                      float("inf"))),
                          stable=True)
    py, px = torch.meshgrid(
        torch.arange(img_height, dtype=torch.float32, device=dev),
        torch.arange(img_width, dtype=torch.float32, device=dev),
        indexing="ij")                                   # each (H, W)
    tile_x = (px / tile_size).to(torch.int32)
    tile_y = (py / tile_size).to(torch.int32)
    color = torch.zeros((img_height, img_width, 3), device=dev)
    depth = torch.zeros((img_height, img_width), device=dev)
    t = torch.ones((img_height, img_width), device=dev)
    for i in order[visible[order]].tolist():
        dx = proj.pix[i, 0] - px
        dy = proj.pix[i, 1] - py
        a_, b_, c_ = proj.conic[i].unbind()
        power = -0.5 * (a_ * dx * dx + c_ * dy * dy) - b_ * dx * dy
        alpha = torch.where(
            power > 0.0, torch.zeros_like(power),
            torch.clamp(opacities[i] * torch.exp(torch.clamp(power, max=0.0)),
                        max=ALPHA_MAX))
        rmin, rmax = proj.rect_min[i], proj.rect_max[i]
        in_rect = ((tile_x >= rmin[0]) & (tile_x < rmax[0])
                   & (tile_y >= rmin[1]) & (tile_y < rmax[1]))
        use = in_rect & (alpha >= ALPHA_MIN) & (t > T_MIN)
        a = torch.where(use, alpha, torch.zeros_like(alpha))
        w = a * t
        color = color + w[..., None] * colors[i]
        depth = depth + w * proj.depth[i]
        t = t * (1.0 - a)
    color = color + t[..., None] * bg
    return RenderOutput(color=color, depth=depth, alpha=1.0 - t,
                        radii=proj.radius, visibility=proj.radius > 0)
