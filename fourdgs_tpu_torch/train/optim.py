"""Grouped Adam (eps 1e-15) with per-group learning-rate schedules
(counterpart: fourdgs_tpu/train/optim.py).

The reference's eight groups: xyz, deformation and grid follow the
exponential schedule, f_dc, f_rest, opacity, scaling and rotation are
constant. The learning rate is taken at the step count after the
increment, so the first step uses lr(1).

A plain function over explicit `count`/`mu`/`nu` state (`AdamGroupState`)
and not `torch.optim.Adam`, because:
  * a leaf without a gradient (the deformation in the coarse stage, the
    timenet) gets a zero-gradient update here, as in the JAX package,
    where `torch.optim.Adam` skips it;
  * the densify surgery replaces the per-point tensors, which an
    optimizer holding its own references would not see;
  * the moments sit in the parameters' tree ({'gauss': GaussianParams,
    'deform': {name: tensor}}), which the comparison with the JAX
    package's moments needs.
The update runs in place on the parameters, the moments and the count.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch

from fourdgs_tpu_torch.models.gaussians import FIELDS, GaussianParams
from fourdgs_tpu_torch.ops.schedule import make_expon_lr

GAUSS_LABELS = GaussianParams(
    xyz="xyz", features_dc="f_dc", features_rest="f_rest",
    scaling="scaling", rotation="rotation", opacity="opacity")


def _deform_label(name: str) -> str:
    return "grid" if name.startswith("grid.") else "deformation"


def param_labels(params: dict) -> dict:
    """Label tree matching {'gauss': GaussianParams, 'deform': module}:
    {'gauss': GaussianParams of labels, 'deform': {name: label}}."""
    labels: dict[str, Any] = {"gauss": GAUSS_LABELS}
    if "deform" in params:
        labels["deform"] = {name: _deform_label(name)
                            for name, _ in params["deform"].named_parameters()}
    return labels


def param_leaves(params: dict) -> list[torch.Tensor]:
    """Every parameter tensor in a fixed order: the gaussian fields, then
    the deformation's parameters by name."""
    leaves = [getattr(params["gauss"], f) for f in FIELDS]
    if "deform" in params:
        leaves += [p for _, p in params["deform"].named_parameters()]
    return leaves


def _label_leaves(params: dict) -> list[str]:
    labels = param_labels(params)
    out = [getattr(labels["gauss"], f) for f in FIELDS]
    return out + list(labels.get("deform", {}).values())


def moment_leaves(tree: dict) -> list[torch.Tensor]:
    """A moment tree's tensors in `param_leaves` order."""
    return ([getattr(tree["gauss"], f) for f in FIELDS]
            + list(tree.get("deform", {}).values()))


def build_schedules(opt, spatial_lr_scale: float) -> dict[str, Callable]:
    s = spatial_lr_scale

    def const(v):
        return lambda step: torch.full_like(
            torch.as_tensor(step, dtype=torch.float32), v)

    return {
        "xyz": make_expon_lr(opt.position_lr_init * s,
                             opt.position_lr_final * s,
                             lr_delay_mult=opt.position_lr_delay_mult,
                             max_steps=opt.position_lr_max_steps),
        "deformation": make_expon_lr(
            opt.deformation_lr_init * s, opt.deformation_lr_final * s,
            lr_delay_mult=opt.deformation_lr_delay_mult,
            max_steps=opt.position_lr_max_steps),
        "grid": make_expon_lr(opt.grid_lr_init * s, opt.grid_lr_final * s,
                              lr_delay_mult=opt.deformation_lr_delay_mult,
                              max_steps=opt.position_lr_max_steps),
        "f_dc": const(opt.feature_lr),
        "f_rest": const(opt.feature_lr / 20.0),
        "opacity": const(opt.opacity_lr),
        "scaling": const(opt.scaling_lr),
        "rotation": const(opt.rotation_lr),
    }


class AdamGroupState(NamedTuple):
    count: torch.Tensor  # () int32
    mu: dict             # first moment, in the parameters' tree
    nu: dict             # second moment


class GroupedAdam(NamedTuple):
    init: Callable       # params -> AdamGroupState
    update: Callable     # (grads, state, params) -> AdamGroupState


def build_optimizer(opt, spatial_lr_scale: float, params: dict | None = None,
                    b1: float = 0.9, b2: float = 0.999,
                    eps: float = 1e-15) -> GroupedAdam:
    """The grouped Adam. `update(grads, state, params)` takes the
    gradients as a list in `param_leaves(params)` order (None for a leaf
    without one), updates `params`, the moments and the count in place
    and returns the state."""
    schedules = build_schedules(opt, spatial_lr_scale)
    del params  # the tree is read at each call (densify resizes buffers)

    def init_fn(params_: dict) -> AdamGroupState:
        def zeros():
            tree = {"gauss": GaussianParams(**{
                f: torch.zeros_like(getattr(params_["gauss"], f))
                for f in FIELDS})}
            if "deform" in params_:
                tree["deform"] = {
                    name: torch.zeros_like(p)
                    for name, p in params_["deform"].named_parameters()}
            return tree
        dev = params_["gauss"].xyz.device
        return AdamGroupState(
            count=torch.zeros((), dtype=torch.int32, device=dev),
            mu=zeros(), nu=zeros())

    @torch.no_grad()
    def update_fn(grads: list, state: AdamGroupState,
                  params_: dict) -> AdamGroupState:
        # the count advances in place, as the moments do: a captured step
        # (train/graphs.py) replays on the tensors it was captured with
        count = state.count.add_(1)
        c = count.to(torch.float32)
        bc1 = 1.0 - b1 ** c
        bc2 = 1.0 - b2 ** c
        # the reference sets lr(iteration), iteration from 1, before each
        # step
        lrs = {k: fn(count) for k, fn in schedules.items()}
        leaves = param_leaves(params_)
        if len(grads) != len(leaves):
            raise ValueError(f"{len(grads)} gradients for {len(leaves)} "
                             f"parameters")
        for p, g, mu, nu, lab in zip(leaves, grads, moment_leaves(state.mu),
                                     moment_leaves(state.nu),
                                     _label_leaves(params_)):
            if g is None:
                g = torch.zeros_like(p)
            mu.mul_(b1).add_((1 - b1) * g)
            nu.mul_(b2).add_((1 - b2) * (g * g))
            p.add_(-lrs[lab] * (mu / bc1) / (torch.sqrt(nu / bc2) + eps))
        return state

    return GroupedAdam(init_fn, update_fn)


@torch.no_grad()
def reset_moments_for_slots(opt_state: AdamGroupState,
                            slot_mask: torch.Tensor, params: dict = None,
                            group: str | None = None) -> AdamGroupState:
    """Zero the Adam moments of the gaussian-buffer leaves at masked slots,
    in place. group=None resets all six per-point tensors (densify);
    group="opacity" only the opacity moments (opacity reset). `params` is
    accepted for symmetry with the JAX package and unused."""
    del params
    keep = (~slot_mask).to(torch.float32)
    for tree in (opt_state.mu, opt_state.nu):
        for f in FIELDS:
            if group is None or getattr(GAUSS_LABELS, f) == group:
                x = getattr(tree["gauss"], f)
                x.mul_(keep.reshape((-1,) + (1,) * (x.dim() - 1)))
    return opt_state
