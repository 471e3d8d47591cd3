"""Density-based point growing, the `--add_point` path
(counterpart: fourdgs_tpu/utils/point_grow.py).

Points whose mean k-NN squared distance is above a quantile (sparse
regions) are candidates; each gets a copy displaced by Gaussian noise
scaled by that distance. The k-NN is the port's chunked brute force
(ops/knn.py).
"""
from __future__ import annotations

import torch

from fourdgs_tpu_torch.ops.knn import knn_mean_sq_dist


def low_density_points(xyz: torch.Tensor, k: int = 8,
                       quantile: float = 0.8):
    """Mask of points whose mean k-NN squared distance exceeds the
    quantile, and the distances."""
    d2 = knn_mean_sq_dist(xyz, k=k)
    thresh = torch.quantile(d2, quantile)
    return d2 > thresh, d2


def grow_points(xyz: torch.Tensor, displacement_scale: float, k: int = 8,
                quantile: float = 0.8,
                generator: torch.Generator | None = None,
                noise: torch.Tensor | None = None):
    """(candidate_mask, new_xyz): perturbed copies of sparse-region
    points. `noise` (standard normal, xyz's shape) is drawn from
    `generator` unless given (the parity tests inject the JAX package's
    draw); a generator lies on xyz's device."""
    mask, d2 = low_density_points(xyz, k, quantile)
    sigma = torch.sqrt(torch.clamp(d2, min=1e-12))[:, None] \
        * displacement_scale
    if noise is None:
        noise = torch.randn(xyz.shape, generator=generator,
                            device=xyz.device)
    return mask, xyz + noise * sigma
