"""The deformed gaussians at a timestamp
(counterpart: fourdgs_tpu/render/state_at_time.py), for per-frame export
and compositing."""
from __future__ import annotations

import torch

from fourdgs_tpu_torch.models.deformation import Deformation
from fourdgs_tpu_torch.models.gaussians import GaussianParams


@torch.no_grad()
def get_state_at_time(gauss: GaussianParams, deform: Deformation,
                      aabb: torch.Tensor, time: float):
    """The deformed RAW parameters (xyz, scaling, rotation, opacity, shs) at
    `time`, over the whole buffer (the caller applies the alive mask)."""
    t = torch.tensor(time, dtype=torch.float32, device=gauss.xyz.device)
    # detached: a field the deformation leaves alone comes back as the
    # trainable leaf itself
    return tuple(x.detach() for x in deform(
        aabb, gauss.xyz, gauss.scaling, gauss.rotation, gauss.opacity,
        gauss.features(), t))
