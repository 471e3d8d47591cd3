"""Blending constants and the render output record
(counterpart: fourdgs_tpu/ops/rasterize_ref.py).

Blending semantics, shared by every blend in this package (the plain
version and the CUDA kernel of ops/blend.py):
  * gaussians are composited in ascending view-depth order;
  * alpha_i = min(0.99, opacity_i * exp(power_i)),
    power_i = -0.5*(A dx^2 + C dy^2) - B dx dy, d = splat_center - pixel;
    power > 0 means skip;
  * a gaussian is skipped at a pixel if alpha_i < 1/255;
  * a gaussian contributes at a pixel only while the ENTERING
    transmittance T_i > 1e-4 (prefix test);
  * out_color = sum_i c_i alpha_i T_i + T_final * bg;
  * out_depth = sum_i z_i alpha_i T_i (expected depth, unnormalized).

The per-pixel oracle `rasterize_reference` comes with a later slice.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from fourdgs_tpu_torch.ops.projection import ALPHA_MAX, ALPHA_MIN  # noqa: F401

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
