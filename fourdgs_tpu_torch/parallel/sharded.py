"""The tile-sharded train step and eval render over a ("data", "tile") mesh
(counterpart: fourdgs_tpu/parallel/sharded.py: `ShardedAux`,
`_render_tiles_local`, `make_sharded_loss`, `sharded_train_step`,
`sharded_eval_render`).

  * cameras are split over "data": each rank renders its data
    coordinate's slice of the global batch (`multihost.host_batch_slice`);
  * within a camera, the tiles are split over "tile": rank t blends,
    takes the pixel loss of and backpropagates the nt_local = num_tiles /
    n_tile tiles [t * nt_local, (t + 1) * nt_local), a band of whole tile
    rows when n_tile divides grid_y;
  * deformation, SH and projection run on the rank's cap / n_tile
    gaussians when n_tile divides the capacity, and an all_gather over
    "tile" assembles the projected set, colors and opacities;
  * binning: on the band route (n_tile divides grid_y) each rank clips
    the rects to its band of tile rows and bins only its tiles, the corner
    cull off (`clip_proj_to_tile_rows`, `bin_gaussians_count(...,
    num_tiles=)`); otherwise every rank bins the whole grid and slices its
    tiles' lists (the fallback);
  * the blend kernels (K1, and K2 or K3 in the backward) take the band's
    first global tile (`tile0`) for their pixel coordinates.

Gradients equal the single-card step's. Each rank backpropagates its own
share of the loss: its tiles' |error| sum over the global denominator, the
regularizer over the world size, and the SSIM term (over whole images
all-gathered across "tile") over n_tile * n_data; then the parameter and
`ndc_offset` gradients are summed over all ranks in one all-reduce.
JAX reaches the same sums through shard_map's transposes. Adam then runs
on every rank on the same gradients, so every rank's state stays the same
bit for bit, and every host-side decision of the stage driver (surgery,
buckets, cap growth, rollback) reads values already reduced over all
ranks. As JAX's sharded step, this one always tracks the densify
statistics.

The step and the frame are captured programs, as JAX jits them
(`sharded_train_step`, `_make_sharded_render`): `step_of_key` gives
train/graphs.py the step function of a `graphs.StepKey` whose `mesh` is
this rank's `mesh_key` (the mesh's shape, the tile coordinate, the band
and the binner's route), and `tools/render.py:MeshRenderer` captures
`sharded_render` as `Renderer` captures a frame. Neither makes a host
sync. They are captured over NCCL, and over a one-rank mesh with no
group (whose collectives are the identity); over gloo, whose
collectives pass through the host, they run eagerly.
"""
from __future__ import annotations

from collections.abc import Callable, Sequence
from typing import NamedTuple

import torch
from torch.profiler import record_function

from fourdgs_tpu_torch.data.camera import Camera
from fourdgs_tpu_torch.models.gaussians import FIELDS, GaussianParams
from fourdgs_tpu_torch.models.regularization import compute_regulation
from fourdgs_tpu_torch.ops import losses
from fourdgs_tpu_torch.ops.blend import blend, reassociates
from fourdgs_tpu_torch.ops.projection import Projected, project_gaussians
from fourdgs_tpu_torch.ops.rasterize_ref import T_MIN, RenderOutput
from fourdgs_tpu_torch.ops.rasterize_tiled import (RasterConfig, _untile,
                                                   bin_gaussians_count,
                                                   clip_proj_to_tile_rows,
                                                   tile_image)
from fourdgs_tpu_torch.parallel._collectives import all_gather, pmax, psum
from fourdgs_tpu_torch.parallel.mesh import Mesh
from fourdgs_tpu_torch.render.render import splats_at
from fourdgs_tpu_torch.train import optim
from fourdgs_tpu_torch.train.loop import StepAux

__all__ = ["ShardedAux", "sharded_step_gradients", "sharded_train_step",
           "step_of_key", "sharded_render", "sharded_eval_render",
           "band_route", "MeshKey", "mesh_key"]


class ShardedAux(NamedTuple):
    l1: torch.Tensor
    psnr: torch.Tensor
    radii: torch.Tensor          # (cap,) max over the global batch
    visible: torch.Tensor        # (cap,) any over the global batch
    dropped_pairs: torch.Tensor  # () summed over every rank
    dropped_tile: torch.Tensor
    max_alpha: torch.Tensor      # () max accumulated alpha over every pixel


class _Tiles(NamedTuple):
    """One camera's band, as a rank renders it."""
    color: torch.Tensor          # (nt_local, P, 3), background added
    t: torch.Tensor              # (nt_local, P) final transmittance
    depth: torch.Tensor          # (nt_local, P)
    radii: torch.Tensor          # (cap,) every gaussian's radius
    dropped_pairs: torch.Tensor
    dropped_tile: torch.Tensor
    num_pairs: torch.Tensor
    tile_peak: torch.Tensor


def check_mesh(mesh: Mesh, cfg: RasterConfig, aligned: bool = True) -> None:
    """JAX's asserts: the tiles split evenly over "tile", and (for the
    step, `aligned`) the image is whole tiles, since the pixel loss and
    SSIM read the tiles as the image."""
    n_tile = mesh.shape["tile"]
    assert cfg.num_tiles % n_tile == 0, (cfg.num_tiles, n_tile)
    assert not aligned or (cfg.img_width % cfg.tile_size == 0
                           and cfg.img_height % cfg.tile_size == 0), \
        "sharded path requires tile-aligned image dims"


def band_route(mesh: Mesh, cfg: RasterConfig) -> bool:
    """Whether each rank bins only its band (n_tile divides the tile rows),
    not the whole grid."""
    n_tile = mesh.shape["tile"]
    return n_tile > 1 and cfg.grid_y % n_tile == 0


class MeshKey(NamedTuple):
    """What a rank's sharded program is static in, beyond the raster
    config: the mesh's shape, this rank's tile coordinate, its band (the
    first global tile and the count) and whether the band route bins."""
    n_data: int
    n_tile: int
    tile: int
    tile0: int
    tiles: int
    band: bool

    def label(self) -> str:
        return (f"mesh {self.n_data}x{self.n_tile} tile {self.tile} tiles "
                f"{self.tile0}+{self.tiles} "
                + ("band" if self.band else "fallback"))


def mesh_key(mesh: Mesh, cfg: RasterConfig) -> MeshKey:
    """This rank's MeshKey at `cfg`."""
    nt_local = cfg.num_tiles // mesh.shape["tile"]
    return MeshKey(mesh.n_data, mesh.n_tile, mesh.tile,
                   mesh.tile * nt_local, nt_local, band_route(mesh, cfg))


def _render_tiles_local(gauss: GaussianParams, deform, cfg: RasterConfig,
                        aabb, alive, active_sh: int, stage: str,
                        camera: Camera, bg, ndc_offset, mesh: Mesh,
                        slots: bool) -> _Tiles:
    """This rank's band of one camera (JAX: `_render_tiles_local`)."""
    cap = gauss.capacity
    n_tile, t = mesh.shape["tile"], mesh.tile
    shard_gauss = n_tile > 1 and cap % n_tile == 0
    if shard_gauss:
        lo, hi = t * (cap // n_tile), (t + 1) * (cap // n_tile)
        gauss = GaussianParams(**{f: getattr(gauss, f)[lo:hi]
                                  for f in FIELDS})
        alive = alive[lo:hi]
        ndc_offset = None if ndc_offset is None else ndc_offset[lo:hi]
    with record_function("render.splats"):
        xyz, scales, quats, opacities, colors = splats_at(
            gauss, deform, camera, aabb, active_sh, stage)
    with record_function("raster.project"):
        proj = project_gaussians(xyz, scales, quats, camera, cfg.img_width,
                                 cfg.img_height, cfg.tile_size,
                                 ndc_offset=ndc_offset, alive=alive,
                                 opacities=opacities)
    if shard_gauss:
        # two gathers: the float fields (with gradients) and the ints
        floats = all_gather(torch.cat(
            [proj.pix, proj.depth[:, None], proj.conic, colors,
             opacities[:, None]], 1), mesh.tile_group)
        ints = all_gather(torch.stack(
            [proj.radius, proj.rect_min[:, 0], proj.rect_min[:, 1],
             proj.rect_max[:, 0], proj.rect_max[:, 1], proj.tiles_touched,
             proj.cull_r2], 1).to(torch.int32), mesh.tile_group)
        proj = Projected(pix=floats[:, 0:2], depth=floats[:, 2],
                         conic=floats[:, 3:6], radius=ints[:, 0],
                         rect_min=ints[:, 1:3].contiguous(),
                         rect_max=ints[:, 3:5].contiguous(),
                         tiles_touched=ints[:, 5].contiguous(),
                         cull_r2=ints[:, 6].contiguous())
        colors, opacities = floats[:, 6:9], floats[:, 9]
    nt_local = cfg.num_tiles // n_tile
    start = t * nt_local
    band = band_route(mesh, cfg)
    with record_function("raster.bin"), torch.no_grad():
        proj_sg = Projected(*[x.detach() for x in proj])
        if band:
            rows = cfg.grid_y // n_tile
            binned = bin_gaussians_count(
                clip_proj_to_tile_rows(proj_sg, t * rows, rows), cfg,
                slots, num_tiles=nt_local)
            gidx, counts, overflow = (binned.gidx, binned.counts,
                                      binned.overflow)
            blend_slots = binned.slots
        else:
            # the fallback: bin the whole grid, slice this rank's tiles
            # (whose BlendSlots would name the whole grid's rows: only a
            # one-rank tile axis keeps them)
            binned = bin_gaussians_count(proj_sg, cfg, slots and n_tile == 1)
            band_of = slice(start, start + nt_local)
            gidx = binned.gidx[band_of].contiguous()
            counts = binned.counts[band_of].contiguous()
            overflow = binned.overflow[band_of]
            blend_slots = binned.slots
    with record_function("raster.blend"):
        color_t, depth_t, t_t = blend(gidx, counts, proj.pix, proj.conic,
                                      colors, opacities, proj.depth, cfg,
                                      blend_slots, tile0=start)
    color_t = color_t + t_t[..., None] * bg
    # effective tile-cap drops: the excess of a tile with an unsaturated
    # pixel, as in rasterize()
    unsat = (t_t.detach() > T_MIN).any(dim=1)
    return _Tiles(color=color_t, t=t_t, depth=depth_t, radii=proj.radius,
                  dropped_pairs=binned.dropped_pairs,
                  dropped_tile=(overflow * unsat).sum().to(torch.int32),
                  num_pairs=binned.num_pairs,
                  tile_peak=(counts + overflow).max())


class ShardedGrads(NamedTuple):
    loss: torch.Tensor           # () the global loss
    aux: ShardedAux
    grads: list                  # per `optim.param_leaves` leaf, summed
    ndc_grad: torch.Tensor | None


def _sum_grads(grads: list, group) -> list:
    """Every gradient summed over `group` in one all-reduce (the leaves
    without a gradient, None on every rank alike, stay None)."""
    present = [g for g in grads if g is not None]
    if group is None or not present:
        return grads
    flat = psum(torch.cat([g.reshape(-1) for g in present]), group)
    out, at = [], 0
    for g in grads:
        if g is None:
            out.append(None)
            continue
        out.append(flat[at:at + g.numel()].view_as(g))
        at += g.numel()
    return out


def sharded_step_gradients(state, cameras: Sequence[Camera],
                           gts: torch.Tensor, bg: torch.Tensor,
                           active_sh: int, *, mesh: Mesh, stage: str,
                           raster_cfg: RasterConfig, lambda_dssim: float,
                           reg_weights: tuple) -> ShardedGrads:
    """The loss, its gradients summed over every rank, and the aux of one
    sharded step (JAX: `make_sharded_loss` and its value_and_grad).
    `cameras` and `gts` (B_local, H, W, 3) are this rank's slice of the
    global batch; every data coordinate's slice has B_local cameras.
    Changes nothing in `state`."""
    cfg = raster_cfg
    check_mesh(mesh, cfg)
    n_data, n_tile = mesh.shape["data"], mesh.shape["tile"]
    nt_local = cfg.num_tiles // n_tile
    band_of = slice(mesh.tile * nt_local, (mesh.tile + 1) * nt_local)
    params = state.params
    leaves = optim.param_leaves(params)
    ndc_offset = torch.zeros((state.capacity, 2), device=state.alive.device,
                             requires_grad=True)
    slots = reassociates()
    pixels = cfg.img_width * cfg.img_height
    b_local = len(cameras)
    b_global = b_local * n_data
    denom = b_global * pixels * 3
    with record_function("train.forward"):
        outs = [_render_tiles_local(params["gauss"], params["deform"], cfg,
                                    state.aabb, state.alive, active_sh,
                                    stage, cam, bg, ndc_offset, mesh, slots)
                for cam in cameras]
        color_t = torch.stack([o.color for o in outs])    # (B, ntl, P, 3)
        gts_t = torch.stack([tile_image(g, cfg)[band_of] for g in gts])
        err = color_t - gts_t
        l1_partial = err.abs().sum()
        share = l1_partial / denom
        if stage == "fine" and reg_weights[0] != 0:
            time_w, l1_w, tv_w = reg_weights
            share = share + compute_regulation(
                params["deform"].grid.planes, time_w, l1_w, tv_w) / mesh.size
        if lambda_dssim != 0:
            # SSIM needs whole images: gather the data row's bands; every
            # rank of the row holds the same term, which the all_gather's
            # backward sums back onto each band
            full = all_gather(color_t.transpose(0, 1).contiguous(),
                              mesh.tile_group).transpose(0, 1)
            imgs = torch.stack([_untile(x, cfg) for x in full])
            share = share + lambda_dssim * (1.0 - losses.ssim(imgs, gts)) \
                / (n_tile * n_data)
    with record_function("train.backward"):
        *grads, ndc_grad = torch.autograd.grad(
            share, leaves + [ndc_offset], allow_unused=True)
    with record_function("train.allreduce"):
        *grads, ndc_grad = _sum_grads(grads + [ndc_grad], mesh.group)
    with torch.no_grad():
        sums = psum(torch.stack([
            share.detach().double(), l1_partial.detach().double(),
            sum(o.dropped_pairs for o in outs).double(),
            sum(o.dropped_tile for o in outs).double()]), mesh.group)
        # per-image PSNR over the data row's bands, averaged over the
        # global batch
        mse = psum((err.detach().double() ** 2).sum(dim=(1, 2, 3)),
                   mesh.tile_group) / (pixels * 3)
        psnr = psum((20.0 * torch.log10(1.0 / torch.sqrt(mse))).sum(),
                    mesh.data_group) / b_global
        radii = torch.stack([o.radii for o in outs]).amax(dim=0)
        alpha = (1.0 - torch.stack([o.t for o in outs]).detach()).amax()
        maxes = pmax(torch.cat([radii.double(), alpha.double()[None]]),
                     mesh.group)
        radii = maxes[:-1].to(radii.dtype)
        aux = ShardedAux(l1=(sums[1] / denom).float(), psnr=psnr.float(),
                         radii=radii, visible=radii > 0,
                         dropped_pairs=sums[2].to(torch.int32),
                         dropped_tile=sums[3].to(torch.int32),
                         max_alpha=maxes[-1].float())
    return ShardedGrads(loss=sums[0].float(), aux=aux, grads=grads,
                        ndc_grad=ndc_grad)


def sharded_train_step(state, cameras: Sequence[Camera], gts: torch.Tensor,
                       bg: torch.Tensor, active_sh: int, *, mesh: Mesh,
                       stage: str, raster_cfg: RasterConfig,
                       tx: optim.GroupedAdam, reg_weights: tuple,
                       lambda_dssim: float = 0.0):
    """One step over the mesh (JAX: `sharded_train_step`): the sharded
    forward and backward, the gradients summed over every rank, the same
    Adam update on every rank, and the densify statistics, always
    tracked. Updates `state` IN PLACE; returns (state, loss, aux).
    `cameras` and `gts` are this rank's slice of the global batch."""
    sg = sharded_step_gradients(state, cameras, gts, bg, active_sh,
                                mesh=mesh, stage=stage,
                                raster_cfg=raster_cfg,
                                lambda_dssim=lambda_dssim,
                                reg_weights=reg_weights)
    with record_function("train.adam"):
        tx.update(sg.grads, state.opt_state, state.params)
    aux = sg.aux
    with torch.no_grad(), record_function("train.stats"):
        ndc_grad = sg.ndc_grad
        if ndc_grad is None:
            ndc_grad = torch.zeros((state.capacity, 2),
                                   device=state.alive.device)
        gnorm = torch.linalg.vector_norm(ndc_grad, dim=-1)
        state.max_radii2d.copy_(torch.where(
            aux.visible, torch.maximum(state.max_radii2d, aux.radii),
            state.max_radii2d))
        state.xyz_gradient_accum.add_(
            torch.where(aux.visible, gnorm, torch.zeros_like(gnorm)))
        state.denom.add_(aux.visible.to(torch.float32))
        state.step.add_(1)
    return state, sg.loss, aux


def step_of_key(tx: optim.GroupedAdam, mesh: Mesh):
    """The mesh's counterpart of `loop.step_of_key`: the step function of
    a `graphs.StepKey` whose `mesh` is this rank's `mesh_key` and whose
    `active_sh` is the SH degree (static, as in JAX's sharded step).
    `fn(state, cameras, gts, bg, active_sh)` runs `sharded_train_step` in
    place on `state` (this rank's slice of the batch) at the key's degree,
    which `active_sh` must equal, and returns a `loop.StepAux`
    of device tensors: the loss, l1 and PSNR, the drops and the visible
    count reduced over every rank; the mesh reports no image, pair count
    or tile peak (zeros, as JAX's sharded aux)."""
    def of_key(key) -> Callable:
        if key.mesh != mesh_key(mesh, key.raster_cfg):
            raise ValueError(f"a step key for {key.mesh} on rank "
                             f"{mesh.rank} of a {mesh.n_data}x"
                             f"{mesh.n_tile} mesh")

        def fn(state, cameras, gts, bg, active_sh):
            if active_sh != key.active_sh:
                raise ValueError(f"SH degree {active_sh} for a step key of "
                                 f"degree {key.active_sh}")
            _, loss, aux = sharded_train_step(
                state, cameras, gts, bg, key.active_sh, mesh=mesh,
                stage=key.stage, raster_cfg=key.raster_cfg, tx=tx,
                reg_weights=key.reg_weights, lambda_dssim=key.lambda_dssim)
            none = loss.new_zeros((), dtype=torch.int32)
            return StepAux(loss=loss, l1=aux.l1, psnr=aux.psnr,
                           image=loss.new_zeros((1, 1, 3)),
                           dropped_pairs=aux.dropped_pairs,
                           dropped_tile=aux.dropped_tile,
                           n_visible=aux.visible.sum(), num_pairs=none,
                           tile_peak=none, max_alpha=aux.max_alpha)
        return fn
    return of_key


@torch.no_grad()
def sharded_render(state, camera: Camera, bg: torch.Tensor, *, mesh: Mesh,
                   raster_cfg: RasterConfig, stage: str,
                   active_sh: int) -> RenderOutput:
    """One camera rendered tile-sharded over the mesh's "tile" axis (every
    data coordinate renders it alike), assembled on every rank: the
    image, depth and alpha, and the binner's drops over the whole image.
    `state` has `params` ({"gauss", "deform"}), `alive` and `aabb`."""
    cfg = raster_cfg
    check_mesh(mesh, cfg, aligned=False)
    group = mesh.tile_group
    out = _render_tiles_local(
        state.params["gauss"], state.params["deform"], cfg, state.aabb,
        state.alive, active_sh, stage, camera, bg, None, mesh, False)
    tiles = all_gather(torch.cat([out.color, out.depth[..., None],
                                  out.t[..., None]], -1), group)
    dropped_tile = psum(out.dropped_tile, group)
    pairs = torch.stack([out.dropped_pairs, out.num_pairs])
    if band_route(mesh, cfg):
        # a pair lies in one band; the fallback binned the whole grid on
        # every rank
        pairs = psum(pairs, group)
    return RenderOutput(color=_untile(tiles[..., :3], cfg),
                        depth=_untile(tiles[..., 3], cfg),
                        alpha=1.0 - _untile(tiles[..., 4], cfg),
                        radii=out.radii, visibility=out.radii > 0,
                        dropped_pairs=pairs[0], dropped_tile=dropped_tile,
                        num_pairs=pairs[1],
                        tile_peak=pmax(out.tile_peak, group))


def sharded_eval_render(state, camera: Camera, bg: torch.Tensor, *,
                        mesh: Mesh, raster_cfg: RasterConfig, stage: str,
                        active_sh: int):
    """The tile-sharded novel-view render (JAX: `sharded_eval_render`):
    (color (H, W, 3), depth (H, W), alpha (H, W)), the same on every
    rank."""
    out = sharded_render(state, camera, bg, mesh=mesh,
                         raster_cfg=raster_cfg, stage=stage,
                         active_sh=active_sh)
    return out.color, out.depth, out.alpha
