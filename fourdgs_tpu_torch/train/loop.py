"""The training step, the eval render and the stage driver
(counterpart: fourdgs_tpu/train/loop.py: `train_step`, `eval_step`,
`pick_bucket`, `compact_and_resize` and `run_stage`).

One step: render the batch's cameras (sequential renders, as the JAX
step unrolls batches of 1-3; larger batches stay a loop here), the loss
(L1, plus the grid regularizer in the fine stage, plus
lambda_dssim * (1 - SSIM) when lambda_dssim is not 0), the gradients of
every parameter and of a zero `ndc_offset`, the grouped Adam update, and
the densify statistics (radii max, visibility count, screen-space
gradient norm).

The SH degree is a Python int or, as JAX's step traces it, a 0-d int32
tensor (render/render.py); `run_stage` passes a tensor on a single card,
so the captured step (train/graphs.py) reads it from a buffer and the SH
ramp recaptures nothing, and an int over a mesh, whose captured step is
static in it as JAX's sharded step is.
"""
from __future__ import annotations

import dataclasses
import math
import time
from collections.abc import Callable, Sequence
from typing import Any, NamedTuple

import numpy as np
import torch

from fourdgs_tpu_torch.data.camera import Camera
from fourdgs_tpu_torch.data.scene import ImageBank
from fourdgs_tpu_torch.models.gaussians import FIELDS, GaussianParams
from fourdgs_tpu_torch.models.regularization import compute_regulation
from fourdgs_tpu_torch.ops import losses
from fourdgs_tpu_torch.ops.rasterize_ref import RenderOutput
from fourdgs_tpu_torch.ops.rasterize_tiled import RasterConfig
from fourdgs_tpu_torch.render.render import render
from fourdgs_tpu_torch.train import densify as densify_mod
from fourdgs_tpu_torch.train import graphs, optim
from fourdgs_tpu_torch.train.config import Config, raster_config_from
from fourdgs_tpu_torch.train.state import TrainState, make_trainable
from fourdgs_tpu_torch.utils import tracing

__all__ = ["StepAux", "StepGrads", "StageResult", "step_gradients",
           "train_step", "step_of_key", "eval_step", "pick_bucket",
           "compact_and_resize", "BucketPrewarmer", "run_stage",
           "raster_config_from"]


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
                   gts: torch.Tensor, bg: torch.Tensor,
                   active_sh: int | torch.Tensor, *,
                   stage: str, raster_cfg: RasterConfig, lambda_dssim: float,
                   reg_weights: tuple) -> StepGrads:
    """Render the batch, take the loss and its gradients in every
    parameter and in a zero `ndc_offset`. Changes nothing in `state`."""
    params = state.params
    gauss, deform = params["gauss"], params["deform"]
    leaves = optim.param_leaves(params)
    ndc_offset = torch.zeros((state.capacity, 2), device=state.alive.device,
                             requires_grad=True)
    with tracing.span("train.forward"):
        outs: list[RenderOutput] = [
            render(gauss, deform, cam, bg, raster_cfg, state.aabb,
                   state.alive, active_sh, stage=stage, ndc_offset=ndc_offset)
            for cam in cameras]
        with tracing.span("train.loss") as sp:
            imgs = torch.stack([o.color for o in outs])
            (l1,) = sp.grads(losses.l1_loss(imgs, gts))
        loss = l1
        if stage == "fine" and reg_weights[0] != 0:
            time_w, l1_w, tv_w = reg_weights
            with tracing.span("train.regulariser") as sp:
                (reg,) = sp.grads(compute_regulation(
                    deform.grid.planes, time_w, l1_w, tv_w))
            loss = loss + reg
        if lambda_dssim != 0:
            with tracing.span("train.loss") as sp:
                (dssim,) = sp.grads(lambda_dssim
                                    * (1.0 - losses.ssim(imgs, gts)))
            loss = loss + dssim
    with tracing.span("train.backward"):
        *grads, ndc_grad = torch.autograd.grad(loss, leaves + [ndc_offset],
                                               allow_unused=True)
    return StepGrads(loss=loss.detach(), l1=l1.detach(), outs=outs,
                     imgs=imgs.detach(), grads=grads, ndc_grad=ndc_grad)


def train_step(state: TrainState, cameras: Sequence[Camera],
               gts: torch.Tensor, bg: torch.Tensor,
               active_sh: int | torch.Tensor, *,
               stage: str, raster_cfg: RasterConfig, tx: optim.GroupedAdam,
               lambda_dssim: float, reg_weights: tuple,
               track_stats: bool = True) -> tuple[TrainState, StepAux]:
    """One optimization step over a batch of cameras with targets
    gts (B, H, W, 3). Updates `state` IN PLACE (parameters, Adam moments
    and count, densify statistics, step) and returns it with the aux."""
    sg = step_gradients(state, cameras, gts, bg, active_sh, stage=stage,
                        raster_cfg=raster_cfg, lambda_dssim=lambda_dssim,
                        reg_weights=reg_weights)
    with tracing.span("train.adam"):
        tx.update(sg.grads, state.opt_state, state.params)
    outs = sg.outs
    with torch.no_grad(), tracing.span("train.stats"):
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


def step_of_key(tx: optim.GroupedAdam
                ) -> Callable[[graphs.StepKey], Callable]:
    """The step function of a captured step's key (graphs.StepPrograms'
    `step_fn`): `fn(state, cameras, gts, bg, active_sh)` runs `train_step`
    with the key's static arguments at SH degree `active_sh` (a 0-d int32
    tensor: the captured step's degree buffer) and returns its aux."""
    def of_key(key: graphs.StepKey) -> Callable:
        def fn(state, cameras, gts, bg, active_sh):
            return train_step(
                state, cameras, gts, bg, active_sh, stage=key.stage,
                raster_cfg=key.raster_cfg, tx=tx,
                lambda_dssim=key.lambda_dssim, reg_weights=key.reg_weights,
                track_stats=key.track_stats)[1]
        return fn
    return of_key


@torch.no_grad()
def eval_step(state: TrainState, camera: Camera, bg: torch.Tensor, *,
              stage: str, active_sh: int,
              raster_cfg: RasterConfig) -> RenderOutput:
    """The render of one camera with the state's parameters, no autograd.
    The train CLI replays the same render as a captured frame on a single
    card (graphs.EvalPrograms); this eager function is the CPU's route."""
    return render(state.params["gauss"], state.params["deform"], camera, bg,
                  raster_cfg, state.aabb, state.alive, active_sh,
                  stage=stage)


# ---------------------------------------------------------------------------
# Bucketed capacity (host side)
# ---------------------------------------------------------------------------

def pick_bucket(n_alive: int, max_cap: int, min_bucket: int = 4096,
                headroom: float = 2.0) -> int:
    """Smallest capacity bucket >= n_alive * headroom, clamped to max_cap:
    powers of two up to 64k and multiples of 64k above (JAX: loop.py:218)."""
    want = max(min_bucket, int(n_alive * headroom))
    if want <= 65536:
        b = 1 << (want - 1).bit_length()
    else:
        b = -(-want // 65536) * 65536
    return min(b, max_cap)


@torch.no_grad()
def compact_and_resize(state: TrainState, new_cap: int) -> TrainState:
    """Move the alive slots to the front (stable) and pad or trim every
    per-point buffer (parameters, their Adam moments, the densify
    statistics, `alive`) to new_cap. Padded parameter rotations get w = 1
    so that they normalise; the moments never do (a mu of 1 over a tiny nu
    makes a 1e14 step). The deformation, its moments and the Adam count
    stay as they are. Reads the alive count to the host."""
    alive = state.alive
    n_alive = int(alive.sum())
    if n_alive > new_cap:
        raise ValueError(f"{n_alive} alive gaussians do not fit {new_cap}")
    order = torch.argsort((~alive).to(torch.uint8), stable=True)

    def fix(x):
        x = x.detach()[order]
        if new_cap <= x.shape[0]:
            return x[:new_cap].contiguous()
        return torch.cat([x, x.new_zeros((new_cap - x.shape[0],)
                                         + x.shape[1:])])

    def fix_gauss(g: GaussianParams) -> GaussianParams:
        return GaussianParams(**{f: fix(getattr(g, f)) for f in FIELDS})

    gauss = fix_gauss(state.params["gauss"])
    if new_cap > n_alive:
        dead = gauss.rotation.abs().sum(dim=1) == 0
        gauss.rotation[:, 0] = torch.where(dead, 1.0, gauss.rotation[:, 0])
    opt = state.opt_state
    state.params["gauss"] = make_trainable(gauss)
    state.opt_state = opt._replace(
        mu={**opt.mu, "gauss": fix_gauss(opt.mu["gauss"])},
        nu={**opt.nu, "gauss": fix_gauss(opt.nu["gauss"])})
    state.alive = fix(alive)
    state.xyz_gradient_accum = fix(state.xyz_gradient_accum)
    state.denom = fix(state.denom)
    state.max_radii2d = fix(state.max_radii2d)
    return state


class BucketPrewarmer:
    """Which training steps to build ahead of their keys (counterpart:
    JAX's `BucketPrewarmer`, loop.py:249-286, and its `queue_prewarm`,
    :436-460). `mark` records the live step's key; `queue` hands a key
    neither live nor queued before to `start(key, state, cameras, gts,
    bg)` once (on the card `graphs.StepPrograms.prewarm`, which captures
    it on a thread). `run_stage` calls both at JAX's triggers. It reads
    nothing of the card, so a test can pass a `start` that records."""

    def __init__(self, start: Callable):
        self.start = start
        self._seen: set = set()

    def mark(self, key: graphs.StepKey) -> None:
        self._seen.add(key)

    def queue(self, key: graphs.StepKey, state: TrainState, cameras, gts,
              bg) -> None:
        if key in self._seen:
            return
        self._seen.add(key)
        self.start(key, state, cameras, gts, bg)


# ---------------------------------------------------------------------------
# Stage driver
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class StageResult:
    state: TrainState
    history: list
    wall_time: float
    active_sh: int = 0
    # the live raster config at the stage's end: the binner's caps may
    # have grown or shrunk; the next stage and the evals take this one
    raster_cfg: Any = None
    # what the driver did to the buffer, in order: dicts with `iter`,
    # `kind` (densify, prune, grow, reset_opacity, resize, rollback,
    # tile_cap, bin_pairs_per_chunk), `points` and `capacity` after it
    events: list = dataclasses.field(default_factory=list)
    # the captured steps (graphs.StepPrograms.report), None when eager
    graphs: dict | None = None


def _nan_count(state: TrainState) -> torch.Tensor:
    """NaN values over every parameter (a NaN-poisoned model culls every
    gaussian, so the loss alone stays finite)."""
    return sum(torch.isnan(p).sum() for p in optim.param_leaves(state.params))


def _grid_absmax(state: TrainState) -> torch.Tensor:
    return torch.stack([p.detach().abs().max() for p in
                        state.params["deform"].grid.planes.values()]).max()


def run_stage(
    cfg: Config,
    state: TrainState,
    stage: str,
    iterations: int,
    cameras: Sequence[Camera],        # one Camera per training view
    images,                           # an ImageBank, or (n_views, H, W, 3)
    tx: optim.GroupedAdam,
    raster_cfg: RasterConfig,
    rng: np.random.Generator,
    generator: torch.Generator | None = None,
    log_every: int = 100,
    log_fn: Callable[[dict], None] | None = None,
    zerostamp_view_mask: np.ndarray | None = None,
    cameras_extent: float = 1.0,
    test_iterations: tuple = (),
    save_iterations: tuple = (),
    checkpoint_iterations: tuple = (),
    on_test: Callable | None = None,
    on_save: Callable | None = None,
    on_checkpoint: Callable | None = None,
    epoch_order_fn: Callable | None = None,
    mesh=None,
    on_iteration: Callable | None = None,
    start_iteration: int = 0,
    initial_active_sh: int = 0,
    capture: bool | None = None,
    prewarmer: BucketPrewarmer | None = None,
) -> StageResult:
    """One training stage (JAX: loop.py:355): batches drawn from epoch
    permutations of `rng`, `train_step`, the NaN guard with rollback every
    25 iterations, the binner caps' growth and shrink, the densify, prune,
    grow and opacity-reset schedule with capacity buckets, the SH ramp
    every 1000 iterations, the callbacks, and a log record every
    `log_every` iterations. `generator` (on the state's device) draws the
    split and grow noise. `start_iteration` resumes mid-stage; the loop
    runs iterations start_iteration + 1 .. iterations.

    The state is updated in place by the step; the guard keeps a copy of
    the last healthy state on the device. The alive count lives on the
    host and is read back only at surgery.

    `mesh` (a `parallel.mesh.Mesh`; JAX: loop.py:485-531) trains over
    ranks: every rank draws the same permutation, takes its data
    coordinate's slice of each batch (`multihost.host_batch_slice`, the
    batch size a multiple of the mesh's data size) and prefetches only
    that slice, and the step is `parallel.sharded.sharded_train_step`
    (`sharded.step_of_key`), which always tracks the densify statistics
    as JAX's does. Every host-side decision reads values already reduced
    over the ranks, and every rank draws the same noise from
    `generator`, so the ranks' states, and the keys of their captured
    steps, stay equal. `log_fn`, `on_save` and `on_checkpoint` run on
    rank 0 only; `on_test` and `on_iteration` on every rank (a sharded
    eval render is collective).

    `capture` (default: on the card) replays the step as a CUDA graph per
    `graphs.StepKey` (the JAX step's static arguments; over a mesh also
    the rank's `sharded.mesh_key` and the SH degree), with the state bound
    to the program's buffers; a step whose key changed (a bucket, a cap
    growth, the densify statistics' stop; over a mesh the SH ramp) takes
    a prewarmed program or captures anew, on every rank of a mesh at the
    same iteration. False runs the step eagerly; the CPU has no graphs. A
    mesh over NCCL, or of one rank with no group, captures; over gloo
    (ranks sharing a card) `capture=True` raises and the default runs
    eagerly, which rank 0 prints.

    `prewarmer` decides at JAX's triggers which keys to build ahead: at
    each iteration it marks the live key; it queues the next bucket
    (twice the capacity, within `cfg.raster.capacity`) with the live
    statistics once `n_alive * headroom * 2` passes the capacity, the
    live capacity without statistics within 300 iterations of
    `densify_until_iter`, and the next bucket again at the new caps after
    a cap growth. By default, when `cfg.raster.prewarm` is set, there is
    no mesh and the step is captured, it is a `BucketPrewarmer` whose
    keys `graphs.StepPrograms.prewarm` captures on a thread; a caller
    may pass its own (a test's recorder), also to an eager stage. A
    mesh's ranks capture in lockstep, so a prewarmer with a mesh raises.
    Every prewarm thread is joined before the stage returns."""
    lead = mesh is None or mesh.rank == 0

    def say(msg):   # once a mesh, from rank 0
        if lead:
            print(msg)

    opt = cfg.opt
    dev = state.alive.device
    if not isinstance(images, ImageBank):
        images = ImageBank("device", dev, images=images)
    bg = torch.tensor([1.0, 1.0, 1.0] if cfg.model.white_background
                      else [0.0, 0.0, 0.0], device=dev)
    n_views = len(cameras)
    batch = opt.batch_size
    extent = float(cameras_extent)
    reg_weights = (cfg.hidden.time_smoothness_weight,
                   cfg.hidden.l1_time_planes, cfg.hidden.plane_tv_weight)

    view_pool = np.arange(n_views)
    if zerostamp_view_mask is not None:
        view_pool = view_pool[zerostamp_view_mask]

    def next_epoch():
        if epoch_order_fn is not None:
            return epoch_order_fn(rng)
        return rng.permutation(view_pool)

    perm = next_epoch()
    ptr = 0

    active_sh = min(initial_active_sh, cfg.model.sh_degree)
    history: list = []
    events: list = []
    t0 = time.perf_counter()
    paused = 0.0
    nan_check_every = 25
    # the guard starts from the incoming state, so that a divergence in the
    # first window can roll back
    last_good, last_good_it = state.to(dev), start_iteration
    rollbacks = 0
    last_cap_change = start_iteration
    n_alive = int(state.alive.sum())

    def bucket_for(n):
        return pick_bucket(n, cfg.raster.capacity, cfg.raster.min_bucket,
                           cfg.raster.bucket_headroom)

    def event(it, kind):
        events.append(dict(iter=it, kind=kind, points=n_alive,
                           capacity=state.capacity))

    lambda_dssim = float(opt.lambda_dssim)
    if mesh is not None and mesh.backend == "gloo":
        if capture:
            raise ValueError("a mesh over gloo is not captured: gloo's "
                             "collectives pass through the host, which a "
                             "CUDA graph cannot record; run it over NCCL "
                             "or with capture=False")
        if capture is None:
            say(f"[capture] {stage}: the mesh's steps run eagerly: its "
                f"process group is gloo, whose collectives pass through "
                f"the host and cannot be captured in a CUDA graph")
        capture = False
    if capture is None:
        capture = dev.type == "cuda"
    if mesh is None:
        step_fn = step_of_key(tx)
    else:
        from fourdgs_tpu_torch.parallel import multihost, sharded
        step_fn = sharded.step_of_key(tx, mesh)

        def rank_slice(ids):
            return ids[multihost.host_batch_slice(len(ids), mesh)]
    steps = graphs.StepPrograms(step_fn) if capture else None
    if prewarmer is not None and mesh is not None:
        raise ValueError("the prewarmer runs on a single card: a mesh's "
                         "ranks capture their steps in lockstep")
    if (prewarmer is None and steps is not None and mesh is None
            and cfg.raster.prewarm):
        prewarmer = BucketPrewarmer(steps.prewarm)
    headroom = cfg.raster.bucket_headroom

    def step_key(capacity: int, track: bool) -> graphs.StepKey:
        # the mesh always tracks the statistics and is static in the SH
        # degree; a single card's step reads the degree from a buffer
        return graphs.StepKey(
            stage, capacity, raster_cfg, mesh is not None or track, batch,
            lambda_dssim, reg_weights, graphs.switches(),
            None if mesh is None else sharded.mesh_key(mesh, raster_cfg),
            None if mesh is None else active_sh)

    def prewarm_next_bucket(track: bool):
        # JAX's trigger (loop.py:510-513): the count past half of what
        # switches the bucket
        if (state.capacity < cfg.raster.capacity
                and n_alive * headroom * 2 > state.capacity):
            prewarmer.queue(step_key(min(state.capacity * 2,
                                         cfg.raster.capacity), track),
                            state, cams, gts, bg)

    aux = None
    degree = None       # a single card's SH degree: (int, 0-d int32 tensor)
    try:
        for it in range(start_iteration + 1, iterations + 1):
            if on_iteration is not None:
                tp = time.perf_counter()
                on_iteration(it, state, active_sh)
                paused += time.perf_counter() - tp
            if it % 1000 == 0 and active_sh < cfg.model.sh_degree:
                active_sh += 1

            if ptr + batch > len(perm):
                perm = next_epoch()
                ptr = 0
            idxs = perm[ptr:ptr + batch]
            ptr += batch
            nxt = perm[ptr:ptr + batch] if ptr + batch <= len(perm) else None
            if mesh is not None:
                idxs = rank_slice(idxs)
                nxt = None if nxt is None else rank_slice(nxt)
            cams = [cameras[int(i)] for i in idxs]
            # a host or lazy bank starts the next batch's bytes while this
            # step runs (not at an epoch's end, whose next permutation is not
            # drawn yet) and uploads this one on the training thread's stream
            gts = images.batch(idxs, nxt)
            # the mesh's guards read the reduced visibility and alpha, and
            # it reports no pair count or tile peak (0, as JAX's sharded
            # aux)
            key = step_key(state.capacity, it < opt.densify_until_iter)
            if mesh is not None:
                sh = active_sh
            else:
                if degree is None or degree[0] != active_sh:
                    degree = (active_sh, torch.full(
                        (), active_sh, dtype=torch.int32, device=dev))
                sh = degree[1]
            if prewarmer is not None:
                # JAX's triggers (loop.py:504-516): the next bucket, and
                # the statistics' stop within 300 iterations of it
                prewarmer.mark(key)
                prewarm_next_bucket(key.track_stats)
                if key.track_stats and opt.densify_until_iter - it <= 300:
                    prewarmer.queue(key._replace(track_stats=False), state,
                                    cams, gts, bg)
            if steps is None:
                aux = step_fn(key)(state, cams, gts, bg, sh)
            else:
                aux = steps.run(key, state, cams, gts, bg, sh)

            # NaN guard: roll back to the last healthy state. One host read
            # carries every number the guard and the cap growth look at.
            if it % nan_check_every == 0 or it == iterations:
                probe = torch.stack([
                    aux.loss.double(), torch.as_tensor(aux.n_visible).double(),
                    torch.as_tensor(aux.max_alpha).double(),
                    _nan_count(state).double(),
                    torch.as_tensor(aux.dropped_pairs).double(),
                    torch.as_tensor(aux.dropped_tile).double(),
                    torch.as_tensor(aux.num_pairs).double(),
                    torch.as_tensor(aux.tile_peak).double()]).cpu().tolist()
                loss, visible, max_alpha, nans, dp, dt, npairs, peak = probe
                collapsed = visible == 0 and n_alive > 0
                gate_collapsed = max_alpha <= 0.0 and n_alive > 0
                healthy = (math.isfinite(loss) and not collapsed
                           and not gate_collapsed and nans == 0)
                if not healthy:
                    rollbacks += 1
                    if rollbacks >= 3:
                        raise FloatingPointError(
                            f"training diverged at {stage} iteration {it} after "
                            f"{rollbacks - 1} rollbacks"
                            + (" (visibility collapse)" if collapsed else
                               " (contribution collapse: no gaussian passes the"
                               " alpha gate)" if gate_collapsed else ""))
                    say(f"[{stage} {it}] "
                          + ("all gaussians culled" if collapsed
                             else "zero blend contribution (alpha-gate collapse)"
                             if gate_collapsed else "loss non-finite")
                          + f"; rolling back {it - last_good_it} iterations")
                    state = last_good.to(dev)
                    n_alive = int(state.alive.sum())
                    event(it, "rollback")
                    perm = next_epoch()
                    ptr = 0
                else:
                    last_good, last_good_it = state.to(dev), it
                    rollbacks = 0

                # binner overflow: grow the overflowing cap (tile-cap drops
                # only past 0.5 % of the step's pairs), or shrink an oversized
                # tile_cap with strong hysteresis
                dp, dt = int(dp), int(dt)
                if cfg.raster.autogrow and (dp or dt):
                    changes = {}
                    if (dt > max(64, max(int(npairs), 1) // 200)
                            and raster_cfg.tile_cap < 8192):
                        changes["tile_cap"] = min(raster_cfg.tile_cap * 2, 8192)
                    if dp and raster_cfg.bin_pairs_per_chunk < (1 << 18):
                        changes["bin_pairs_per_chunk"] = min(
                            raster_cfg.bin_pairs_per_chunk * 2, 1 << 18)
                    if changes:
                        raster_cfg = dataclasses.replace(raster_cfg, **changes)
                        last_cap_change = it
                        say(f"[{stage} {it}] binner overflow ({dp} pairs / "
                              f"{dt} tile-cap): growing {changes}")
                        for k in changes:
                            event(it, k)
                        # a next bucket prewarmed at the old caps is stale:
                        # queue it at the new ones (JAX: loop.py:614-620)
                        if prewarmer is not None:
                            prewarm_next_bucket(it < opt.densify_until_iter)
                elif cfg.raster.autogrow:
                    peak = int(peak)
                    if (peak > 0 and raster_cfg.tile_cap > 256
                            and peak * 4 < raster_cfg.tile_cap
                            and it - last_cap_change
                            >= cfg.raster.cap_shrink_spacing):
                        raster_cfg = dataclasses.replace(
                            raster_cfg, tile_cap=raster_cfg.tile_cap // 2)
                        last_cap_change = it
                        say(f"[{stage} {it}] tile peak {peak} << cap: "
                              f"shrinking tile_cap to {raster_cfg.tile_cap}")
                        event(it, "tile_cap")

            # densification schedule
            if it < opt.densify_until_iter:
                if stage == "coarse":
                    op_thresh = opt.opacity_threshold_coarse
                    dense_thresh = opt.densify_grad_threshold_coarse
                else:
                    frac = it / opt.densify_until_iter
                    op_thresh = (opt.opacity_threshold_fine_init
                                 - frac * (opt.opacity_threshold_fine_init
                                           - opt.opacity_threshold_fine_after))
                    dense_thresh = (opt.densify_grad_threshold_fine_init
                                    - frac * (opt.densify_grad_threshold_fine_init
                                              - opt.densify_grad_threshold_after))

                did_surgery = False
                if (it > opt.densify_from_iter
                        and it % opt.densification_interval == 0
                        and n_alive < opt.densify_max_points):
                    # grow the bucket first so that clones and splits find
                    # free slots
                    bucket = bucket_for(n_alive)
                    if bucket != state.capacity:
                        state = compact_and_resize(state, bucket)
                        event(it, "resize")
                    state, _ = densify_mod.densify(
                        state, float(dense_thresh), opt.percent_dense, extent,
                        opt.densify_max_points, generator=generator)
                    did_surgery = True
                    n_alive = int(state.alive.sum())
                    event(it, "densify")
                if (it > opt.pruning_from_iter
                        and it % opt.pruning_interval == 0
                        and n_alive > opt.prune_min_points):
                    size_thresh = 20 if it > opt.opacity_reset_interval else None
                    state = densify_mod.prune(state, float(op_thresh), extent,
                                              size_thresh, opt.prune_min_points)
                    did_surgery = True
                    n_alive = int(state.alive.sum())
                    event(it, "prune")
                if (opt.add_point and it % opt.densification_interval == 0
                        and n_alive < opt.densify_max_points):
                    state, _ = densify_mod.grow(
                        state, max_points=opt.densify_max_points,
                        generator=generator)
                    did_surgery = True
                    n_alive = int(state.alive.sum())
                    event(it, "grow")
                if it % opt.opacity_reset_interval == 0:
                    state = densify_mod.reset_opacity(state)
                    event(it, "reset_opacity")
                if did_surgery:
                    bucket = bucket_for(n_alive)
                    if bucket != state.capacity:
                        state = compact_and_resize(state, bucket)
                        event(it, "resize")

            # evals, snapshots and checkpoints, outside the reported train time
            if ((it in test_iterations and on_test)
                    or (it in save_iterations and on_save)
                    or (it in checkpoint_iterations and on_checkpoint)):
                tp = time.perf_counter()
                if it in test_iterations and on_test:
                    on_test(it, state, active_sh, raster_cfg=raster_cfg)
                if it in save_iterations and on_save and lead:
                    on_save(it, state)
                if it in checkpoint_iterations and on_checkpoint and lead:
                    on_checkpoint(it, state, active_sh)
                paused += time.perf_counter() - tp

            if it % log_every == 0 or it == iterations:
                tp = time.perf_counter()
                g = state.params["gauss"]
                (loss, l1, psnr, dp, dt, npairs, rot_max, op_max, visible,
                 max_alpha, gmax) = torch.stack([
                     aux.loss.double(), aux.l1.double(), aux.psnr.double(),
                     torch.as_tensor(aux.dropped_pairs).double(),
                     torch.as_tensor(aux.dropped_tile).double(),
                     torch.as_tensor(aux.num_pairs).double(),
                     g.rotation.detach().abs().max().double(),
                     g.opacity.detach().max().double(),
                     torch.as_tensor(aux.n_visible).double(),
                     torch.as_tensor(aux.max_alpha).double(),
                     _grid_absmax(state).double()]).cpu().tolist()
                rec = dict(stage=stage, iter=it, loss=loss, l1=l1, psnr=psnr,
                           points=n_alive, capacity=state.capacity,
                           elapsed=tp - t0 - paused,
                           dropped_pairs=int(dp), dropped_tile=int(dt),
                           num_pairs=int(npairs), rot_max=rot_max,
                           op_max=op_max, visible=int(visible),
                           max_alpha=max_alpha, grid_absmax=gmax)
                if dp or dt > max(64, int(npairs) // 200):
                    say(f"[{stage} {it}] WARNING: binner overflow: "
                          f"{int(dp)} pairs / {int(dt)} tile-cap drops this "
                          f"step; raise tile_cap/pair_cap or the scene will "
                          f"lose far gaussians")
                history.append(rec)
                if log_fn and lead:
                    log_fn(rec)
                paused += time.perf_counter() - tp
    finally:
        if steps is not None:
            steps.close()

    return StageResult(state=state, history=history,
                       wall_time=time.perf_counter() - t0 - paused,
                       active_sh=active_sh, raster_cfg=raster_cfg,
                       events=events,
                       graphs=None if steps is None else steps.report())
