"""Training state: everything a train step touches
(counterpart: fourdgs_tpu/train/state.py).

The same fields as the JAX package's `TrainState`. `params` is
{'gauss': GaussianParams, 'deform': Deformation}: the gaussian fields are
leaf tensors that require grad, and the deformation is an `nn.Module`.
The optimizer state is the grouped Adam's explicit `AdamGroupState`.
"""
from __future__ import annotations

import copy
import dataclasses

import numpy as np
import torch

from fourdgs_tpu_torch.models.deformation import Deformation
from fourdgs_tpu_torch.models.gaussians import (FIELDS, GaussianParams,
                                                create_from_points)
from fourdgs_tpu_torch.train import optim
from fourdgs_tpu_torch.train.config import Config, deform_config_from
from fourdgs_tpu_torch.utils.device import resolve_device


@dataclasses.dataclass
class TrainState:
    params: dict                     # {'gauss': ..., 'deform': Deformation}
    opt_state: optim.AdamGroupState
    alive: torch.Tensor              # (cap,) bool
    aabb: torch.Tensor               # (2, 3) rows (max, min)
    xyz_gradient_accum: torch.Tensor  # (cap,)
    denom: torch.Tensor              # (cap,)
    max_radii2d: torch.Tensor        # (cap,) float32
    step: torch.Tensor               # () int32 within the current stage

    @property
    def capacity(self) -> int:
        return self.alive.shape[0]

    def n_alive(self) -> torch.Tensor:
        return self.alive.sum()

    def to(self, device, capacity: int | None = None) -> "TrainState":
        """A copy on `device` (the parameters stay trainable leaves); it
        shares no storage with this state, also on the same device. With
        `capacity` every per-slot tensor is cut to it or padded with dead
        slots (zeros; a padded rotation has w = 1, as compact_and_resize
        pads), with no read to the host and no compaction: a program's
        buffers at another bucket, whose values the first bind replaces."""
        cap = self.capacity if capacity is None else capacity
        keep = min(cap, self.capacity)

        def cp(x):
            return x.detach().to(device, copy=True)

        def slots(x):
            x = x.detach()
            if cap == self.capacity:
                return x.to(device, copy=True)
            out = x.new_zeros((cap,) + x.shape[1:], device=device)
            out[:keep] = x[:keep]
            return out

        def gauss(g, params=False):
            out = GaussianParams(**{f: slots(getattr(g, f)) for f in FIELDS})
            if params and cap > keep:
                out.rotation[keep:, 0] = 1.0
            return out

        def tree(t):
            return {"gauss": gauss(t["gauss"]),
                    "deform": {k: cp(v) for k, v in t["deform"].items()}}
        opt = self.opt_state
        return TrainState(
            params={"gauss": make_trainable(gauss(self.params["gauss"],
                                                  params=True)),
                    "deform": copy.deepcopy(self.params["deform"]).to(device)},
            opt_state=optim.AdamGroupState(count=cp(opt.count),
                                           mu=tree(opt.mu), nu=tree(opt.nu)),
            alive=slots(self.alive), aabb=cp(self.aabb),
            xyz_gradient_accum=slots(self.xyz_gradient_accum),
            denom=slots(self.denom), max_radii2d=slots(self.max_radii2d),
            step=cp(self.step))


def make_trainable(gauss: GaussianParams) -> GaussianParams:
    """The gaussian fields as leaf tensors that require grad."""
    return GaussianParams(**{
        f: getattr(gauss, f).detach().requires_grad_(True) for f in FIELDS})


def create_state(
    cfg: Config,
    points: np.ndarray | None,
    colors: np.ndarray | None,
    spatial_lr_scale: float,
    aabb: np.ndarray | None = None,
    deform: Deformation | None = None,
    gauss: GaussianParams | None = None,
    alive: torch.Tensor | None = None,
    generator: torch.Generator | None = None,
    device: str | torch.device | None = None,
) -> TrainState:
    """Fresh state for a training stage on `device` (None: cuda, which
    raises without a card). Like the reference, each stage builds a new
    optimizer state, so moments and schedules restart. `generator` seeds
    the deformation's initial weights when `deform` is not given; it does
    not reproduce the JAX package's draws (tests convert a JAX state with
    `convert.train_state_from_numpy` instead)."""
    dev = resolve_device(device)
    cap = cfg.raster.capacity
    if gauss is None:
        gauss, alive = create_from_points(points, colors, cap,
                                          cfg.model.sh_degree, dev)
    if deform is None:
        deform = Deformation(deform_config_from(cfg), generator=generator)
    params = {"gauss": make_trainable(gauss), "deform": deform.to(dev)}
    opt_state = optim.build_optimizer(cfg.opt, spatial_lr_scale).init(params)
    if aabb is None:
        b = cfg.hidden.bounds
        aabb = np.array([[b, b, b], [-b, -b, -b]], np.float32)
    zeros = lambda: torch.zeros((cap,), dtype=torch.float32, device=dev)
    return TrainState(
        params=params, opt_state=opt_state, alive=alive.to(dev),
        aabb=torch.as_tensor(np.asarray(aabb, np.float32), device=dev),
        xyz_gradient_accum=zeros(), denom=zeros(), max_radii2d=zeros(),
        step=torch.zeros((), dtype=torch.int32, device=dev))
