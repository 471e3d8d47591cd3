"""Dense trilinear voxel grid, the `empty_voxel` mask of the deformation
field (counterpart: fourdgs_tpu/models/dense_grid.py).

A trilinear gather and lerp over an (X, Y, Z, C) grid at points in
[-1, 1], corners aligned and coordinates clamped to the border. Plain
torch indexing: the JAX package runs it as XLA, with no Pallas kernel."""
from __future__ import annotations

import torch


def init_dense_grid(world_size=(64, 64, 64), channels: int = 1,
                    device: str | torch.device | None = None
                    ) -> torch.Tensor:
    """A zero (X, Y, Z, channels) grid, on `device` (None: the CPU, as
    the module that holds it is built there and moved after)."""
    return torch.zeros(tuple(world_size) + (channels,), dtype=torch.float32,
                       device=device)


def _axis_coords(v: torch.Tensor, size: int):
    x = torch.clamp((v + 1.0) * 0.5 * (size - 1), 0.0, size - 1)
    # the clamp keeps a NaN coordinate's index in range (its weight stays
    # NaN, so the sample is NaN, as the JAX package's clamped gather gives)
    x0 = torch.clamp(torch.floor(x).to(torch.int64), 0, size - 1)
    x1 = torch.clamp(x0 + 1, max=size - 1)
    return x0, x1, (x - x0)[:, None]


def dense_grid_sample(grid: torch.Tensor,
                      pts_norm: torch.Tensor) -> torch.Tensor:
    """Sample the (X, Y, Z, C) grid at (N, 3) coordinates in [-1, 1]
    (aligned corners, border clamp). Returns (N, C)."""
    gx, gy, gz, _ = grid.shape
    x0, x1, fx = _axis_coords(pts_norm[:, 0], gx)
    y0, y1, fy = _axis_coords(pts_norm[:, 1], gy)
    z0, z1, fz = _axis_coords(pts_norm[:, 2], gz)

    def g(i, j, k):
        return grid[i, j, k]

    c00 = g(x0, y0, z0) * (1 - fx) + g(x1, y0, z0) * fx
    c01 = g(x0, y0, z1) * (1 - fx) + g(x1, y0, z1) * fx
    c10 = g(x0, y1, z0) * (1 - fx) + g(x1, y1, z0) * fx
    c11 = g(x0, y1, z1) * (1 - fx) + g(x1, y1, z1) * fx
    c0 = c00 * (1 - fy) + c10 * fy
    c1 = c01 * (1 - fy) + c11 * fy
    return c0 * (1 - fz) + c1 * fz
