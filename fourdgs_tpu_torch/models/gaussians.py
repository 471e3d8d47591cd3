"""Gaussian point-set parameters on a fixed-capacity buffer
(counterpart: fourdgs_tpu/models/gaussians.py).

A capacity-`cap` buffer plus an `alive` mask, in the raw (pre-activation)
parameterization: log-scales, logit-opacity, unnormalized wxyz quaternions
and SH color coefficients. Keeping the JAX package's layout lets state be
compared slot by slot.
"""
from __future__ import annotations

import dataclasses

import torch


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
