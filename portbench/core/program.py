"""The system under test, fourdgs_tpu_torch, built from the benchmark's
inputs: its configuration read from the port's own config file, its
training state and renderer holding the benchmark's named tensors, its
cameras. Everything the harness takes from the program passes through
here or through the cells' calls of its entry points.
"""
from __future__ import annotations

from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[2]

# the configuration file's published keys and where the port's Config keeps
# them
_CHECKS = {
    "kplanes_resolution": lambda c: list(c.hidden.kplanes_config["resolution"]),
    "kplanes_dim": lambda c: c.hidden.kplanes_config["output_coordinate_dim"],
    "multires": lambda c: list(c.hidden.multires),
    "net_width": lambda c: c.hidden.net_width,
    "defor_depth": lambda c: c.hidden.defor_depth,
    "no_dx": lambda c: c.hidden.no_dx,
    "no_ds": lambda c: c.hidden.no_ds,
    "no_dr": lambda c: c.hidden.no_dr,
    "no_do": lambda c: c.hidden.no_do,
    "no_dshs": lambda c: c.hidden.no_dshs,
    "bounds": lambda c: c.hidden.bounds,
    "sh_degree": lambda c: c.model.sh_degree,
    "white_background": lambda c: c.model.white_background,
    "batch_size": lambda c: c.opt.batch_size,
    "lambda_dssim": lambda c: c.opt.lambda_dssim,
    "time_smoothness_weight": lambda c: c.hidden.time_smoothness_weight,
    "l1_time_planes": lambda c: c.hidden.l1_time_planes,
    "plane_tv_weight": lambda c: c.hidden.plane_tv_weight,
    "position_lr_init": lambda c: c.opt.position_lr_init,
    "position_lr_final": lambda c: c.opt.position_lr_final,
    "position_lr_max_steps": lambda c: c.opt.position_lr_max_steps,
    "deformation_lr_init": lambda c: c.opt.deformation_lr_init,
    "deformation_lr_final": lambda c: c.opt.deformation_lr_final,
    "grid_lr_init": lambda c: c.opt.grid_lr_init,
    "grid_lr_final": lambda c: c.opt.grid_lr_final,
    "feature_lr": lambda c: c.opt.feature_lr,
    "opacity_lr": lambda c: c.opt.opacity_lr,
    "scaling_lr": lambda c: c.opt.scaling_lr,
    "rotation_lr": lambda c: c.opt.rotation_lr,
    "tile_size": lambda c: c.raster.tile_size,
}
# switches the reference does not have: the port's config must leave them off
_OFF = ("empty_voxel", "static_mlp", "apply_rotation", "no_grid")


def load_config(config: dict):
    """The port's Config from its config file (`port_config`, a path from
    the checkout's root), held to the configuration file's published
    values: a difference raises, so the benchmark never runs a config
    other than the one it states. The assumed capacity has to be the
    driver's bucket for the assumed count (`loop.pick_bucket` at the
    config's maximum, minimum bucket and headroom)."""
    from fourdgs_tpu_torch.train import config as config_mod
    cfg = config_mod.apply_config_file(config_mod.Config(),
                                       str(ROOT / config["port_config"]))
    wrong = {k: (v, _CHECKS[k](cfg)) for k, v in config["published"].items()
             if k in _CHECKS and _CHECKS[k](cfg) != v}
    wrong.update({k: True for k in _OFF if getattr(cfg.hidden, k)})
    r = cfg.raster
    from fourdgs_tpu_torch.train.loop import pick_bucket
    cap = pick_bucket(config["assumed"]["gaussians"], r.capacity,
                      r.min_bucket, r.bucket_headroom)
    if cap != config["assumed"]["capacity"]:
        wrong["capacity"] = (config["assumed"]["capacity"], cap)
    if wrong:
        raise ValueError(f"{config['port_config']} differs from "
                         f"{config['name']}'s published values "
                         f"(stated, read): {wrong}")
    return cfg


def gaussians(params: dict, trainable: bool):
    from fourdgs_tpu_torch.models.gaussians import FIELDS, GaussianParams
    from fourdgs_tpu_torch.train.state import make_trainable
    g = GaussianParams(**{f: params[f].clone() for f in FIELDS})
    return make_trainable(g) if trainable else g


def deformation(cfg, params: dict, device):
    """The port's Deformation at the config's widths, its parameters the
    benchmark's (made on the device; the constructor's own draws are
    overwritten)."""
    from fourdgs_tpu_torch.models.deformation import Deformation
    from fourdgs_tpu_torch.train.config import deform_config_from
    with torch.device(device):
        # skip_init's linears land on the CPU whatever the default device
        d = Deformation(deform_config_from(cfg)).to(device)
    named = dict(d.named_parameters())
    mine = {k for k in params if k not in _gauss_fields()}
    if set(named) != mine:
        raise ValueError(f"the port's deformation parameters differ: "
                         f"{sorted(set(named) ^ mine)}")
    with torch.no_grad():
        for k, p in named.items():
            if tuple(p.shape) != tuple(params[k].shape):
                raise ValueError(f"{k}: the port's {tuple(p.shape)}, the "
                                 f"benchmark's {tuple(params[k].shape)}")
            p.copy_(params[k])
    return d


def _gauss_fields():
    from fourdgs_tpu_torch.models.gaussians import FIELDS
    return FIELDS


def names(state) -> list[str]:
    """The parameter names in the port's leaf order (optim.param_leaves)."""
    return list(_gauss_fields()) + [
        k for k, _ in state.params["deform"].named_parameters()]


def named_params(state) -> dict:
    from fourdgs_tpu_torch.train import optim
    return dict(zip(names(state), optim.param_leaves(state.params)))


def named_first_moment(state) -> dict:
    from fourdgs_tpu_torch.train import optim
    return dict(zip(names(state), optim.moment_leaves(state.opt_state.mu)))


def train_state(cfg, params: dict, fixed: dict, count: int,
                spatial_lr_scale: float, device):
    """(TrainState, GroupedAdam): the benchmark's parameters, fresh
    moments, Adam's count at `count`."""
    from fourdgs_tpu_torch.train import optim
    from fourdgs_tpu_torch.train.state import TrainState
    p = {"gauss": gaussians(params, True),
         "deform": deformation(cfg, params, device)}
    tx = optim.build_optimizer(cfg.opt, spatial_lr_scale)
    opt_state = tx.init(p)
    opt_state.count.fill_(count)
    cap = fixed["alive"].shape[0]

    def zeros():
        return torch.zeros((cap,), dtype=torch.float32, device=device)
    return TrainState(
        params=p, opt_state=opt_state, alive=fixed["alive"].clone(),
        aabb=fixed["aabb"].clone(), xyz_gradient_accum=zeros(),
        denom=zeros(), max_radii2d=zeros(),
        step=torch.zeros((), dtype=torch.int32, device=device)), tx


def camera(cam: dict):
    from fourdgs_tpu_torch.data.camera import Camera
    return Camera(**cam)


def raster_config(cfg, config: dict):
    """The port's raster config at the configuration's image size, with the
    binner caps the configuration assumes."""
    import dataclasses
    from fourdgs_tpu_torch.train.config import raster_config_from
    w, h = config["published"]["image"]
    return dataclasses.replace(raster_config_from(cfg, w, h),
                               **config["assumed"]["caps"])


def grow_caps(rc, render_fn, cams, capacity: int, room: float = 0.75,
              rounds: int = 8):
    """The port's growth rule (double the overflowing cap: tile_cap for a
    tile's list, bin_pairs_per_chunk for the pair budget, within the
    port's limits) run before the window, with room: each camera is
    rendered (`render_fn(rc, cam)` -> RenderOutput) at `room` of the tile
    cap, and a cap doubles until no camera drops a pair there (the port's
    count of the drops that reach an unsaturated pixel) and the pairs
    fill at most `room` of the budget. The port's driver grows a cap again
    when training moves the state past it; inside a timed window that
    would be a capture, so the room is left beforehand. Returns the raster
    config, the doublings made and the fullest use seen."""
    import dataclasses
    grown = []
    for _ in range(rounds):
        probe = dataclasses.replace(rc, tile_cap=int(rc.tile_cap * room)
                                    // rc.chunk * rc.chunk)
        dp = dt = pairs = 0
        for cam in cams:
            out = render_fn(probe, cam)
            dp = max(dp, int(out.dropped_pairs))
            dt = max(dt, int(out.dropped_tile))
            pairs = max(pairs, int(out.num_pairs))
        budget = -(-capacity // rc.bin_chunk) * rc.bin_pairs_per_chunk
        changes = {}
        if dt and rc.tile_cap < 8192:
            changes["tile_cap"] = rc.tile_cap * 2
        if (dp or pairs > room * budget) and \
                rc.bin_pairs_per_chunk < (1 << 18):
            changes["bin_pairs_per_chunk"] = rc.bin_pairs_per_chunk * 2
        if not changes:
            if dp or dt:
                raise RuntimeError(f"drops at the port's largest caps: "
                                   f"{dp} pairs, {dt} tile")
            return rc, grown, {"pairs": pairs, "pair_budget": budget}
        rc = dataclasses.replace(rc, **changes)
        grown.append(changes)
    raise RuntimeError(f"caps still overflow after {rounds} doublings")
