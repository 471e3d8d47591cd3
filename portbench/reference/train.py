"""One fine-stage training step of the reference: render the batch, L1 plus
the HexPlane regularizers, every parameter's gradient, the grouped Adam.

Frozen copies: fourdgs_tpu_torch/models/regularization.py (the plane,
time and L1-to-one terms), fourdgs_tpu_torch/ops/schedule.py (`expon_lr`)
and the update of fourdgs_tpu_torch/train/optim.py (eps 1e-15, the
learning rate at the count after its increment, eight groups). The loss's
formula is train/loop.py:step_gradients' with lambda_dssim 0.

The blend's gradient is taken batch of tiles by batch of tiles: the
rasterizer's inputs are made leaves (`pack_table`'s rows), each batch's
part of the L1 is differentiated into them at once, and their gradient is
then carried back through the splats. The loss is a sum over pixels, so
this is the gradient of the whole.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from portbench.reference import raster
from portbench.reference.deformation import DeformSpec
from portbench.reference.splats import project, splats

SPACE_PLANES = (0, 1, 3)
TIME_PLANES = (2, 4, 5)
GAUSS_GROUP = {"xyz": "xyz", "features_dc": "f_dc",
               "features_rest": "f_rest", "scaling": "scaling",
               "rotation": "rotation", "opacity": "opacity"}


def _smooth(plane):
    first = plane[1:] - plane[:-1]
    second = first[1:] - first[:-1]
    return (second ** 2).mean()


def regulation(params: dict, weights) -> torch.Tensor:
    time_w, l1_w, tv_w = weights
    plane = time = l1 = 0.0
    for name, g in params.items():
        if not name.startswith("grid.planes."):
            continue
        pid = int(name.split("_p")[1])
        if pid in SPACE_PLANES:
            plane = plane + _smooth(g)
        if pid in TIME_PLANES:
            time = time + _smooth(g)
            l1 = l1 + (1.0 - g).abs().mean()
    return tv_w * plane + time_w * time + l1_w * l1


def group_of(name: str) -> str:
    if name in GAUSS_GROUP:
        return GAUSS_GROUP[name]
    return "grid" if name.startswith("grid.") else "deformation"


def expon_lr(step, lr_init, lr_final, max_steps):
    step = torch.as_tensor(step, dtype=torch.float32)
    t = torch.clamp(step / max_steps, 0, 1)
    log_init = float(np.log(np.float32(lr_init)))
    log_final = float(np.log(np.float32(lr_final)))
    return torch.exp(log_init * (1 - t) + log_final * t)


def learning_rates(opt: dict, count: torch.Tensor) -> dict:
    """Each group's rate at Adam's count (after its increment); `opt`
    holds the configuration's rates, `spatial_lr_scale` and
    `position_lr_max_steps`."""
    s = opt["spatial_lr_scale"]
    m = opt["position_lr_max_steps"]
    return {
        "xyz": expon_lr(count, opt["position_lr_init"] * s,
                        opt["position_lr_final"] * s, m),
        "deformation": expon_lr(count, opt["deformation_lr_init"] * s,
                                opt["deformation_lr_final"] * s, m),
        "grid": expon_lr(count, opt["grid_lr_init"] * s,
                         opt["grid_lr_final"] * s, m),
        "f_dc": torch.tensor(opt["feature_lr"]),
        "f_rest": torch.tensor(opt["feature_lr"] / 20.0),
        "opacity": torch.tensor(opt["opacity_lr"]),
        "scaling": torch.tensor(opt["scaling_lr"]),
        "rotation": torch.tensor(opt["rotation_lr"]),
    }


def loss_and_grads(params: dict, spec: DeformSpec, aabb, alive, cams: list,
                   gts: torch.Tensor, bg, width: int, height: int,
                   tile_size: int, reg_weights, precision: str,
                   batch: int = 32, chunk: int = 32):
    """(loss as a float64 0-d tensor, {name: gradient}) of one step."""
    leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
    n_values = len(cams) * height * width * 3
    total = torch.zeros((), dtype=torch.float64, device=gts.device)
    for cam, gt in zip(cams, gts):
        xyz, scales, quats, opac, colors = splats(leaves, spec, aabb, cam,
                                                  precision)
        proj = project(xyz, scales, quats, opac, cam, width, height,
                       tile_size, alive, precision)
        table = raster.pack_table(proj, colors, opac)
        rows = table.detach().requires_grad_(True)
        with torch.no_grad():
            tiles = raster.bin_tiles(proj, width, height, tile_size)
        for ids in raster.tile_batches(tiles, batch):
            color, _, _ = raster.blend_tiles(rows, tiles, ids, bg, chunk,
                                             precision)
            px, py = raster.tile_pixels(tiles, ids)
            px, py = px.long(), py.long()
            inside = (px < width) & (py < height)
            target = gt[torch.clamp(py, max=height - 1),
                        torch.clamp(px, max=width - 1)]
            part = ((color - target).abs().sum(-1) * inside).sum() / n_values
            if part.requires_grad:      # a batch of empty tiles has none
                part.backward()
            total += part.detach().double()
        if rows.grad is not None:
            torch.autograd.backward(table, rows.grad)
    reg = regulation(leaves, reg_weights)
    reg.backward()
    total += reg.detach().double()
    grads = {k: (v.grad if v.grad is not None else torch.zeros_like(v))
             for k, v in leaves.items()}
    return total, grads


class Adam:
    """The grouped Adam's state: count and moments, keyed by name."""

    def __init__(self, params: dict, count: int, opt: dict):
        self.count = torch.tensor(count, dtype=torch.int32)
        self.mu = {k: torch.zeros_like(v) for k, v in params.items()}
        self.nu = {k: torch.zeros_like(v) for k, v in params.items()}
        self.opt = opt

    @torch.no_grad()
    def update(self, params: dict, grads: dict, b1=0.9, b2=0.999,
               eps=1e-15) -> None:
        self.count += 1
        c = self.count.to(torch.float32)
        bc1 = 1.0 - b1 ** c
        bc2 = 1.0 - b2 ** c
        lrs = learning_rates(self.opt, self.count)
        for k, p in params.items():
            g = grads[k]
            mu, nu = self.mu[k], self.nu[k]
            mu.mul_(b1).add_((1 - b1) * g)
            nu.mul_(b2).add_((1 - b2) * (g * g))
            lr = lrs[group_of(k)].to(p.device)
            p.add_(-lr * (mu / bc1.to(p.device))
                   / (torch.sqrt(nu / bc2.to(p.device)) + eps))


def follow(params: dict, spec: DeformSpec, aabb, alive, batches: list,
           bg, width, height, tile_size, reg_weights, opt: dict,
           count: int, precision: str) -> dict:
    """The reference's first steps from `params` (copied): for each
    (cameras, targets) of `batches` a step. Returns the losses, the first
    step's gradients, and each parameter's change over all the steps."""
    start = {k: v.detach().clone() for k, v in params.items()}
    cur = {k: v.detach().clone() for k, v in params.items()}
    adam = Adam(cur, count, opt)
    losses, first = [], None
    for cams, gts in batches:
        loss, grads = loss_and_grads(cur, spec, aabb, alive, cams, gts, bg,
                                     width, height, tile_size, reg_weights,
                                     precision)
        losses.append(float(loss))
        if first is None:
            first = grads
        adam.update(cur, grads)
        if not all(math.isfinite(x) for x in losses):
            break
    change = {k: cur[k] - start[k] for k in cur}
    return {"losses": losses, "grads": first, "change": change}
