"""The training step and the eval render
(counterpart: fourdgs_tpu/train/loop.py, `train_step` and `eval_step`).

One step: render the batch's cameras (sequential renders, as the JAX
step unrolls batches of 1-3; larger batches stay a loop here), the loss
(L1, plus the grid regularizer in the fine stage, plus
lambda_dssim * (1 - SSIM) when lambda_dssim is not 0), the gradients of
every parameter and of a zero `ndc_offset`, the grouped Adam update, and
the densify statistics (radii max, visibility count, screen-space
gradient norm).

The SH degree is a Python int (the JAX step traces it to keep its jit
from recompiling; PyTorch has no jit to keep).
"""
from __future__ import annotations

from collections.abc import Sequence
from typing import Any, NamedTuple

import torch
from torch.profiler import record_function

from fourdgs_tpu_torch.data.camera import Camera
from fourdgs_tpu_torch.models.regularization import compute_regulation
from fourdgs_tpu_torch.ops import losses
from fourdgs_tpu_torch.ops.rasterize_ref import RenderOutput
from fourdgs_tpu_torch.ops.rasterize_tiled import RasterConfig
from fourdgs_tpu_torch.render.render import render
from fourdgs_tpu_torch.train import optim
from fourdgs_tpu_torch.train.state import TrainState


class StepAux(NamedTuple):
    """What a step reports, as device tensors (reading one is a host
    sync): the loss terms, the first image of the batch, and the binner's
    and the render's health counters summed (or maxed) over the batch."""
    loss: torch.Tensor
    l1: torch.Tensor
    psnr: torch.Tensor
    image: torch.Tensor           # first image of the batch
    dropped_pairs: Any = 0
    dropped_tile: Any = 0
    n_visible: Any = -1           # gaussians visible in any batch view
    num_pairs: Any = 0
    tile_peak: Any = 0
    max_alpha: Any = 1.0          # max accumulated alpha over the batch


class StepGrads(NamedTuple):
    """The forward and backward of one step, before the update."""
    loss: torch.Tensor
    l1: torch.Tensor
    outs: list            # RenderOutput per camera
    imgs: torch.Tensor    # (B, H, W, 3), detached
    grads: list           # per `optim.param_leaves` leaf (None: unused)
    ndc_grad: torch.Tensor | None   # (cap, 2) screen-space gradient


def step_gradients(state: TrainState, cameras: Sequence[Camera],
                   gts: torch.Tensor, bg: torch.Tensor, active_sh: int, *,
                   stage: str, raster_cfg: RasterConfig, lambda_dssim: float,
                   reg_weights: tuple) -> StepGrads:
    """Render the batch, take the loss and its gradients in every
    parameter and in a zero `ndc_offset`. Changes nothing in `state`."""
    params = state.params
    gauss, deform = params["gauss"], params["deform"]
    leaves = optim.param_leaves(params)
    ndc_offset = torch.zeros((state.capacity, 2), device=state.alive.device,
                             requires_grad=True)
    with record_function("train.forward"):
        outs: list[RenderOutput] = [
            render(gauss, deform, cam, bg, raster_cfg, state.aabb,
                   state.alive, active_sh, stage=stage, ndc_offset=ndc_offset)
            for cam in cameras]
        imgs = torch.stack([o.color for o in outs])
        l1 = losses.l1_loss(imgs, gts)
        loss = l1
        if stage == "fine" and reg_weights[0] != 0:
            time_w, l1_w, tv_w = reg_weights
            loss = loss + compute_regulation(deform.grid.planes, time_w,
                                             l1_w, tv_w)
        if lambda_dssim != 0:
            loss = loss + lambda_dssim * (1.0 - losses.ssim(imgs, gts))
    with record_function("train.backward"):
        *grads, ndc_grad = torch.autograd.grad(loss, leaves + [ndc_offset],
                                               allow_unused=True)
    return StepGrads(loss=loss.detach(), l1=l1.detach(), outs=outs,
                     imgs=imgs.detach(), grads=grads, ndc_grad=ndc_grad)


def train_step(state: TrainState, cameras: Sequence[Camera],
               gts: torch.Tensor, bg: torch.Tensor, active_sh: int, *,
               stage: str, raster_cfg: RasterConfig, tx: optim.GroupedAdam,
               lambda_dssim: float, reg_weights: tuple,
               track_stats: bool = True) -> tuple[TrainState, StepAux]:
    """One optimization step over a batch of cameras with targets
    gts (B, H, W, 3). Updates `state` IN PLACE (parameters, Adam moments
    and count, densify statistics, step) and returns it with the aux."""
    sg = step_gradients(state, cameras, gts, bg, active_sh, stage=stage,
                        raster_cfg=raster_cfg, lambda_dssim=lambda_dssim,
                        reg_weights=reg_weights)
    with record_function("train.adam"):
        state.opt_state = tx.update(sg.grads, state.opt_state, state.params)
    outs = sg.outs
    with torch.no_grad(), record_function("train.stats"):
        radii = torch.stack([o.radii for o in outs]).amax(dim=0)
        visible = torch.stack([o.visibility for o in outs]).any(dim=0)
        if track_stats:
            # densification stats (ref train.py:259-262)
            ndc_grad = sg.ndc_grad
            if ndc_grad is None:
                ndc_grad = torch.zeros((state.capacity, 2),
                                       device=state.alive.device)
            gnorm = torch.linalg.vector_norm(ndc_grad, dim=-1)
            state.max_radii2d.copy_(torch.where(
                visible, torch.maximum(state.max_radii2d, radii),
                state.max_radii2d))
            state.xyz_gradient_accum.add_(
                torch.where(visible, gnorm, torch.zeros_like(gnorm)))
            state.denom.add_(visible.to(torch.float32))
        state.step.add_(1)
        aux = StepAux(
            loss=sg.loss, l1=sg.l1, psnr=losses.psnr(sg.imgs, gts).mean(),
            image=sg.imgs[0],
            dropped_pairs=torch.stack([o.dropped_pairs for o in outs]).sum(),
            dropped_tile=torch.stack([o.dropped_tile for o in outs]).sum(),
            n_visible=visible.sum(),
            num_pairs=torch.stack([o.num_pairs for o in outs]).sum(),
            tile_peak=torch.stack([o.tile_peak for o in outs]).amax(),
            max_alpha=torch.stack([o.alpha.detach() for o in outs]).amax())
    return state, aux


@torch.no_grad()
def eval_step(state: TrainState, camera: Camera, bg: torch.Tensor, *,
              stage: str, active_sh: int,
              raster_cfg: RasterConfig) -> RenderOutput:
    """The render of one camera with the state's parameters, no autograd."""
    return render(state.params["gauss"], state.params["deform"], camera, bg,
                  raster_cfg, state.aabb, state.alive, active_sh,
                  stage=stage)
