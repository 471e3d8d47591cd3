"""Voxel-downsample a dense point cloud to a training init budget
(counterpart: scripts/downsample_point.py): the mean position and color of
each occupied voxel, the voxel size searched until the cloud fits the
budget (40,000 points by default) or given with --voxel_size.

    python -m fourdgs_tpu_torch.tools.downsample_point <in.ply> <out.ply> \\
        [--budget 40000] [--voxel_size S]

Host code in numpy, the JAX script's arithmetic, so that the PLY it
writes is the script's byte for byte.
"""
from __future__ import annotations

import argparse

import numpy as np

from fourdgs_tpu_torch.data import ply


def voxel_downsample(points: np.ndarray, colors: np.ndarray,
                     voxel_size: float):
    """Mean position and color per occupied voxel."""
    keys = np.floor(points / voxel_size).astype(np.int64)
    _, inv, counts = np.unique(keys, axis=0, return_inverse=True,
                               return_counts=True)
    n_vox = counts.shape[0]
    pts = np.zeros((n_vox, 3))
    cols = np.zeros((n_vox, 3))
    np.add.at(pts, inv, points)
    np.add.at(cols, inv, colors)
    pts /= counts[:, None]
    cols /= counts[:, None]
    return pts.astype(np.float32), cols.astype(np.float32)


def downsample_to_budget(points, colors, budget: int = 40_000,
                         tol: float = 0.1, max_iter: int = 20):
    """Binary-search the voxel size to land under `budget` points."""
    if len(points) <= budget:
        return points, colors
    extent = points.max(0) - points.min(0)
    lo, hi = 1e-6, float(np.max(extent))
    best = None
    for _ in range(max_iter):
        mid = (lo + hi) / 2
        p, c = voxel_downsample(points, colors, mid)
        if len(p) > budget:
            lo = mid
        else:
            best = (p, c)
            hi = mid
            if len(p) > budget * (1 - tol):
                break
    return best if best is not None else voxel_downsample(points, colors, hi)


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("input")
    parser.add_argument("output")
    parser.add_argument("--budget", type=int, default=40_000)
    parser.add_argument("--voxel_size", type=float, default=None)
    args = parser.parse_args(argv)

    pts, cols, _ = ply.fetch_point_cloud(args.input)
    if args.voxel_size:
        p, c = voxel_downsample(pts, cols, args.voxel_size)
    else:
        p, c = downsample_to_budget(pts, cols, args.budget)
    print(f"{len(pts)} -> {len(p)} points")
    ply.store_point_cloud(args.output, p, c * 255.0)


if __name__ == "__main__":
    main()
