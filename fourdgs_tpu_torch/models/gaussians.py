"""Gaussian point-set parameters on a fixed-capacity buffer
(counterpart: fourdgs_tpu/models/gaussians.py).

A capacity-`cap` buffer plus an `alive` mask, in the raw (pre-activation)
parameterization: log-scales, logit-opacity, unnormalized wxyz quaternions
and SH color coefficients. Keeping the JAX package's layout lets state be
compared slot by slot.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from fourdgs_tpu_torch.ops import knn, sh, transforms
from fourdgs_tpu_torch.utils.device import resolve_device

FIELDS = ("xyz", "features_dc", "features_rest", "scaling", "rotation",
          "opacity")


@dataclasses.dataclass
class GaussianParams:
    """Per-point parameters; every field has leading dim `cap`."""
    xyz: torch.Tensor            # (cap, 3)
    features_dc: torch.Tensor    # (cap, 1, 3) SH DC band
    features_rest: torch.Tensor  # (cap, K-1, 3) higher SH bands
    scaling: torch.Tensor        # (cap, 3) log-scale
    rotation: torch.Tensor       # (cap, 4) unnormalized wxyz
    opacity: torch.Tensor        # (cap, 1) logit

    @property
    def capacity(self) -> int:
        return self.xyz.shape[0]

    def features(self) -> torch.Tensor:
        """(cap, K, 3) concatenated SH coefficients."""
        return torch.cat([self.features_dc, self.features_rest], dim=1)

    def to(self, device) -> "GaussianParams":
        return GaussianParams(**{f.name: getattr(self, f.name).to(device)
                                 for f in dataclasses.fields(self)})


def create_from_points(points: np.ndarray, colors: np.ndarray, cap: int,
                       max_sh_degree: int = 3,
                       device: str | torch.device | None = None
                       ) -> tuple[GaussianParams, torch.Tensor]:
    """Initialise from a colored point cloud: SH DC from RGB, log-scale
    from the square root of the mean 3-NN squared distance, identity
    rotations, opacity 0.1, in a capacity-`cap` buffer on `device` (None:
    cuda, which raises without a card). Returns (params, alive) with
    `alive` marking the first n slots."""
    dev = resolve_device(device)
    n = points.shape[0]
    if n > cap:
        raise ValueError(f"point cloud ({n}) exceeds capacity ({cap})")
    k = (max_sh_degree + 1) ** 2
    xyz = torch.zeros((cap, 3), device=dev)
    xyz[:n] = torch.from_numpy(np.asarray(points, np.float32)).to(dev)
    dc = torch.zeros((cap, 1, 3), device=dev)
    dc[:n, 0] = sh.rgb_to_sh(
        torch.from_numpy(np.asarray(colors, np.float32)).to(dev))
    scaling = torch.zeros((cap, 3), device=dev)
    scaling[:n] = torch.log(torch.sqrt(knn.dist2_init(points, dev)))[:, None]
    rotation = torch.zeros((cap, 4), device=dev)
    rotation[:, 0] = 1.0
    opacity = torch.full((cap, 1), float(transforms.inverse_sigmoid(
        torch.tensor(0.1, dtype=torch.float32))), device=dev)
    alive = torch.zeros((cap,), dtype=torch.bool, device=dev)
    alive[:n] = True
    return GaussianParams(
        xyz=xyz, features_dc=dc,
        features_rest=torch.zeros((cap, k - 1, 3), device=dev),
        scaling=scaling, rotation=rotation, opacity=opacity), alive
