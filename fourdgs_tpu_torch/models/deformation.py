"""Spatio-temporal deformation network: HexPlane features -> MLP heads
producing per-Gaussian deltas at time t
(counterpart: fourdgs_tpu/models/deformation.py, `deform_apply`).

  hidden = feature_out(HexPlane(xyz_norm, t))
  dx/ds/dr (+do/dshs when enabled) = head_i(hidden), each head is
  [ReLU, Linear(W,W), ReLU, Linear(W,out)]; deformed value = raw + delta
  (rotation optionally quaternion-multiplied).

Parity notes:
  * feature_out is Linear(feat_dim, W) followed by (depth-1) x [ReLU,
    Linear(W,W)]; depth <= 1 means a single Linear.
  * `timenet` holds parameters that the forward never uses; they are kept
    so that snapshots enumerate the same parameter groups.
  * `empty_voxel` adds a (64, 64, 64, 1) grid parameter
    (models/dense_grid.py) whose trilinear sample at the normalised
    position is the mask, unless `static_mlp` gives it.
  * The JAX package stores each weight as (fan_in, fan_out); here they sit
    in `nn.Linear` as (fan_out, fan_in). `convert.deformation_from_flat`
    transposes them.
"""
from __future__ import annotations

import dataclasses

import torch
from torch import nn

from fourdgs_tpu_torch.models.dense_grid import (dense_grid_sample,
                                                 init_dense_grid)
from fourdgs_tpu_torch.models.hexplane import (HexPlaneConfig, HexPlaneField,
                                               normalize_aabb)
from fourdgs_tpu_torch.ops.transforms import quat_multiply
from fourdgs_tpu_torch.utils import tracing


@dataclasses.dataclass(frozen=True)
class DeformConfig:
    net_width: int = 64
    defor_depth: int = 1
    grid: HexPlaneConfig = HexPlaneConfig()
    timenet_width: int = 64
    timenet_output: int = 32
    timebase_pe: int = 4
    no_dx: bool = False
    no_grid: bool = False
    no_ds: bool = False
    no_dr: bool = False
    no_do: bool = True
    no_dshs: bool = True
    apply_rotation: bool = False
    empty_voxel: bool = False
    static_mlp: bool = False
    sh_coeffs: int = 16  # (max_sh_degree+1)^2; shs head outputs sh_coeffs*3
    # Soft delta saturation: each head's delta passes through s*tanh(x/s);
    # 0 disables (unbounded deltas). Units: world (dx), log-scale (ds),
    # quaternion (dr).
    dx_bound: float = 0.0
    ds_bound: float = 0.0
    dr_bound: float = 0.0


def _linear(fan_in: int, fan_out: int, generator: torch.Generator | None):
    """xavier-uniform weight, torch-default uniform bias."""
    lin = nn.utils.skip_init(nn.Linear, fan_in, fan_out)
    limit = (6.0 / (fan_in + fan_out)) ** 0.5
    bound = 1.0 / fan_in ** 0.5
    with torch.no_grad():
        lin.weight.uniform_(-limit, limit, generator=generator)
        lin.bias.uniform_(-bound, bound, generator=generator)
    return lin


class Head(nn.Module):
    """[ReLU, Linear(W,W), ReLU, Linear(W,out)]."""

    def __init__(self, width: int, out_dim: int, generator=None):
        super().__init__()
        self.h0 = _linear(width, width, generator)
        self.h1 = _linear(width, out_dim, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.h1(torch.relu(self.h0(torch.relu(x))))


class Deformation(nn.Module):
    """The deformation field; `forward` is the JAX package's
    `deform_apply`."""

    def __init__(self, cfg: DeformConfig,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.cfg = cfg
        w = cfg.net_width
        in_dim = 4 if cfg.no_grid else cfg.grid.feat_dim
        self.grid = HexPlaneField(cfg.grid, generator)
        fo = {"fo0": _linear(in_dim, w, generator)}
        for i in range(cfg.defor_depth - 1):
            fo[f"fo{i + 1}"] = _linear(w, w, generator)
        self.feature_out = nn.ModuleDict(fo)
        self.pos = Head(w, 3, generator)
        self.scales = Head(w, 3, generator)
        self.rotations = Head(w, 4, generator)
        self.opacity = Head(w, 1, generator)
        self.shs = Head(w, cfg.sh_coeffs * 3, generator)
        times_ch = 2 * cfg.timebase_pe + 1
        self.timenet = nn.ModuleDict({
            "t0": _linear(times_ch, cfg.timenet_width, generator),
            "t1": _linear(cfg.timenet_width, cfg.timenet_output, generator),
        })
        self.static = Head(w, 1, generator) if cfg.static_mlp else None
        # the (64, 64, 64, 1) mask grid, zeros at init; a parameter of the
        # deformation group, under the JAX package's key `empty_voxel`
        self.empty_voxel = (nn.Parameter(init_dense_grid())
                            if cfg.empty_voxel else None)

    def _hidden(self, feat: torch.Tensor) -> torch.Tensor:
        x = self.feature_out["fo0"](feat)
        for i in range(max(self.cfg.defor_depth, 1) - 1):
            x = self.feature_out[f"fo{i + 1}"](torch.relu(x))
        return x

    def forward(self, aabb: torch.Tensor, xyz: torch.Tensor,
                scaling: torch.Tensor, rotation: torch.Tensor,
                opacity: torch.Tensor, shs: torch.Tensor, t):
        """Deformed raw params (xyz, scaling, rotation, opacity, shs) at
        time `t` (a float, a 0-d tensor or an (N,) tensor). aabb is (2, 3)
        with rows (max, min)."""
        cfg = self.cfg
        n = xyz.shape[0]
        t = torch.as_tensor(t, dtype=torch.float32, device=xyz.device)
        if cfg.no_grid:
            feat = torch.cat([xyz, t.expand(n)[:, None]], dim=-1)
        else:
            feat = self.grid(normalize_aabb(xyz, aabb), t)
        with tracing.span("splats.heads") as sp:
            return sp.grads(*self._heads(feat, aabb, xyz, scaling, rotation,
                                         opacity, shs))

    def _heads(self, feat, aabb, xyz, scaling, rotation, opacity, shs):
        """The MLP heads' deformation of the raw params from the field's
        features."""
        cfg = self.cfg
        n = xyz.shape[0]
        hidden = self._hidden(feat)
        # the mask: the static head, else the empty-voxel grid, else ones
        if self.static is not None:
            mask = self.static(hidden)
        elif self.empty_voxel is not None:
            mask = dense_grid_sample(self.empty_voxel,
                                     normalize_aabb(xyz, aabb))
        else:
            mask = torch.ones((n, 1), dtype=xyz.dtype, device=xyz.device)

        def bound(x, s):
            return torch.tanh(x / s) * s if s else x

        out_xyz = xyz
        if not cfg.no_dx:
            out_xyz = xyz * mask + bound(self.pos(hidden), cfg.dx_bound)
        out_scaling = scaling
        if not cfg.no_ds:
            out_scaling = scaling * mask + bound(self.scales(hidden),
                                                 cfg.ds_bound)
        out_rotation = rotation
        if not cfg.no_dr:
            dr = bound(self.rotations(hidden), cfg.dr_bound)
            out_rotation = (quat_multiply(rotation, dr) if cfg.apply_rotation
                            else rotation + dr)
        out_opacity = opacity
        if not cfg.no_do:
            out_opacity = opacity * mask + self.opacity(hidden)
        out_shs = shs
        if not cfg.no_dshs:
            dshs = self.shs(hidden).reshape(n, cfg.sh_coeffs, 3)
            out_shs = shs * mask[..., None] + dshs
        return out_xyz, out_scaling, out_rotation, out_opacity, out_shs
