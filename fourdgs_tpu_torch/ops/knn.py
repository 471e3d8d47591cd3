"""Mean squared distance to the nearest neighbours, for the initial
gaussian scales (counterpart: fourdgs_tpu/ops/knn.py, which stands in for
the reference's simple-knn CUDA extension).

Exact chunked brute force on the device: each block of query rows takes
its distances to every point as |q|^2 + |p|^2 - 2 q.p (the JAX package's
formula, so that both round alike) and keeps the k+1 smallest. It runs
once at initialisation.
"""
from __future__ import annotations

import numpy as np
import torch

from fourdgs_tpu_torch.utils.device import resolve_device


def knn_mean_sq_dist(points: torch.Tensor, k: int = 3,
                     chunk: int = 1024) -> torch.Tensor:
    """(N,) mean squared distance from each point to its k nearest other
    points. Query rows go in blocks of `chunk` (a block holds chunk x N
    distances)."""
    sq = (points * points).sum(-1)
    out = []
    for start in range(0, points.shape[0], chunk):
        q = points[start:start + chunk]
        d2 = sq[start:start + chunk, None] + sq[None, :] - 2.0 * (q @ points.T)
        d2 = torch.clamp(d2, min=0.0)
        best = torch.topk(d2, k + 1, dim=1, largest=False).values
        out.append(best[:, 1:].mean(-1))   # the smallest is the point itself
    return torch.cat(out)


def dist2_init(points: np.ndarray,
               device: str | torch.device | None = None) -> torch.Tensor:
    """The simple-knn entry: clamped mean 3-NN squared distance, on
    `device` (None: cuda, which raises without a card)."""
    dev = resolve_device(device)
    pts = torch.from_numpy(np.asarray(points, np.float32)).to(dev)
    with torch.no_grad():
        return torch.clamp(knn_mean_sq_dist(pts, k=3), min=1e-7)
