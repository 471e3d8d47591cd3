#!/usr/bin/env python3
"""On-card smoke run of the PyTorch port (fourdgs_tpu_torch) on one GPU.

    python3 chip_smoke.py [--seed 0] [--frames 24] [--steps 30]

Phases, each of which raises on failure (so the exit code is nonzero):
  1. device: the card's name and power limit;
  2. build:  the CUDA kernels from fourdgs_tpu_torch/csrc with nvcc;
  3. slice:  a synthetic snapshot (100,000 Gaussians, D-NeRF deformation
             width, random weights from --seed) served through
             Renderer.from_snapshot at 800x800 for --frames frames, with
             the kernels' launch counts read around that run, and checks
             of the images against the plain blend on the card and the
             CPU path on a small image;
  4. kernel: K1 (blend forward) against its plain PyTorch version, on the
             inputs that one of phase 3's frames gives it (the caps after
             the cap probe), with CUDA-event times;
  5. train:  a TrainState of the same scene (capacity 1<<17, the first
             100,000 slots alive) takes --steps fine train_steps at
             800x800 toward four targets that eval_step rendered before
             seeded noise moved its colors and opacities, with the launch
             counts read around those steps; the loss must fall, and one
             step's gradients with K2 must equal those with the plain
             backward on the card;
  6. kernel: K2 (blend backward) against its plain version on the step
             input of the trained state's frame at t = 0.5 (its
             cotangents, its caps), with CUDA-event times.
The second-to-last line of stdout is the kernels JSON, the last line the
result JSON. It imports nothing of JAX or the JAX package.
"""
from __future__ import annotations

import argparse
import contextlib
import copy
import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
N_GAUSS = 100_000
SIZE = 800
OPACITY_LOGIT = 2.197          # sigmoid = 0.9, a trained-like opacity
RASTER = dict(tile_size=32, tile_cap=768, chunk=32, bin_chunk=4096,
              bin_pairs_per_chunk=18432)
KERNEL_CHECK_FRAME = 0.5       # the main-path frame at t = 0.5
TOL = {"color": 1e-5, "depth": 1e-4, "t": 1e-5}
GRAD_TOL = 1e-4                # gradients, normalised by their max |.|
TRAIN_CAPACITY = 1 << 17
TRAIN_TIMES = (0.0, 1.0 / 3.0, 2.0 / 3.0, 1.0)
UNTIMED_STEPS = 3
PROFILED_STEPS = 4             # after the checked run, under torch.profiler
SPATIAL_LR_SCALE = 1.0
# seeded noise on the trained fields, in raw units (SH DC, opacity logit)
NOISE_DC, NOISE_OPACITY = 0.3, 1.0
GRAD_COLUMNS = ("pix_x", "pix_y", "conic_a", "conic_b", "conic_c", "red",
                "green", "blue", "opacity", "depth")
FRAME_TOL = 1e-4               # one frame: kernel blend vs plain blend
MEAN_ALPHA_FLOOR = 0.1
# a small image rendered on the card and on the CPU (plain path): the two
# differ in float association only, except where a gate decision
# (alpha >= 1/255, T > 1e-4) flips on a last-bit difference, which moves a
# pixel by at most alpha * T < 5e-3
SMALL = 160
SMALL_TOL_MEAN, SMALL_TOL_MAX = 1e-5, 5e-3

# H100 SXM peaks (NVIDIA data sheet and CUDA guide): 3.35 TB/s HBM3; 128
# FP32 instructions issued per clock per SM (a fused multiply-add is one)
# and 16 SFU results (expf's MUFU.EX2), x 132 SMs x 1.98 GHz
HBM_BYTES_S = 3.35e12
FP32_ISSUE_S = 128 * 132 * 1.98e9
MUFU_OP_S = 16 * 132 * 1.98e9
# FP32-pipe instructions of csrc/blend_fwd.cu's loop body per pixel x slot
# evaluation, by how far the evaluation gets, as the sm_90a SASS
# (`cuobjdump -sass` of the built library) has them (compares and fminf
# counted as FP32 issues; expf without fast math is 5 FP32 instructions,
# one MUFU.EX2 and a final multiply):
#   every one: dx, dy (2), the three quadratic terms (6), power (3) and
#     its test (1)
#   power <= 0: expf (6), opacity x exp (1), fminf (1), the alpha test (1)
#   used (alpha >= 1/255, entering T > 1e-4): T x cp and its test (2),
#     the weight (1), four fused sums (4), 1 - alpha and cp (2)
BLEND_FP32_INSTR = {"eval": 12, "exp": 9, "used": 9}
# FP32-pipe instructions of csrc/blend_bwd.cu's loop body per pixel x slot
# evaluation, as its sm_90a SASS has them: the replay up to the alpha test
# is K1's (12 and 9); a used slot runs T x cp and its test (2), the
# gradient chain and the two IEEE divisions (each MUFU.RCP, FCHK and five
# FFMA), 53 in all. The bound adds the 10 additions per used pixel x slot
# that any sum into the per-gaussian rows needs, and counts one MUFU.EX2
# per expf and two MUFU.RCP per used slot.
BLEND_BWD_FP32_INSTR = {"eval": 12, "exp": 9, "used": 53}


def log(msg: str) -> None:
    print(msg, flush=True)


# ---------------------------------------------------------------------------
# phase 1-2
# ---------------------------------------------------------------------------

def phase_device(torch) -> str:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available()"
                         " is false)")
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    log(f"device: {name}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}; count {torch.cuda.device_count()}")
    log(smi)
    return name


def phase_build():
    from fourdgs_tpu_torch.ops import _build
    t0 = time.perf_counter()
    _build.build()
    _build.load_library()
    info = _build.build_info
    log(f"build: {time.perf_counter() - t0:.2f} s "
        f"(nvcc {info['seconds']:.2f} s, cached={info['cached']}) "
        f"-> {Path(info['path']).relative_to(ROOT)}")
    for line in info["ptxas"]:
        log(f"  {line}")


# ---------------------------------------------------------------------------
# the synthetic scene
# ---------------------------------------------------------------------------

def make_scene(torch, seed: int, device):
    """100,000 Gaussians by the JAX package's benchmark point rule
    (uniform in [-1, 1]^3, random colors), scales from the mean 3-NN
    squared distance as at initialisation, opacity 0.9, random SH rest
    bands, and a D-NeRF-width deformation with random time planes."""
    from scipy.spatial import cKDTree

    from fourdgs_tpu_torch import convert
    from fourdgs_tpu_torch.models.deformation import Deformation
    from fourdgs_tpu_torch.ops import sh
    from fourdgs_tpu_torch.train import config as config_mod

    rng = np.random.default_rng(seed)
    pts = rng.uniform(-1.0, 1.0, (N_GAUSS, 3)).astype(np.float32)
    cols = rng.uniform(0.0, 1.0, (N_GAUSS, 3)).astype(np.float32)
    dist, _ = cKDTree(pts).query(pts, k=4)
    d2 = np.maximum((dist[:, 1:] ** 2).mean(-1), 1e-7)
    fields = dict(
        xyz=pts,
        features_dc=sh.rgb_to_sh(cols)[:, None, :],
        features_rest=rng.normal(0.0, 0.1, (N_GAUSS, 15, 3)),
        scaling=np.repeat(np.log(np.sqrt(d2))[:, None], 3, 1),
        rotation=np.tile([1.0, 0.0, 0.0, 0.0], (N_GAUSS, 1)),
        opacity=np.full((N_GAUSS, 1), OPACITY_LOGIT))
    gauss = convert.gaussians_from_numpy(fields, device)

    cfg = config_mod.Config()
    cfg.hidden.multires = [1, 2]        # configs/dnerf/dnerf_default.py
    cfg.hidden.defor_depth = 0
    cfg.hidden.net_width = 64
    cfg.raster = config_mod.RasterParams(capacity=1 << 17, **RASTER)
    gen = torch.Generator().manual_seed(seed)
    deform = Deformation(config_mod.deform_config_from(cfg), generator=gen)
    with torch.no_grad():
        for key, p in deform.grid.planes.items():
            if key[-1] in "245":        # the time planes (x,t) (y,t) (z,t)
                p.add_(torch.randn(p.shape, generator=gen) * 0.3)
    b = cfg.hidden.bounds
    aabb = np.array([[b, b, b], [-b, -b, -b]], np.float32)
    alive = torch.ones(N_GAUSS, dtype=torch.bool, device=device)
    return cfg, gauss, alive, deform.to(device).eval(), aabb


# ---------------------------------------------------------------------------
# phase 3: the serving slice
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def plain_version(name: str):
    """Route the differentiable blend through the plain version of
    `name` ("blend_forward" or "blend_backward") for one comparison."""
    from fourdgs_tpu_torch.ops import blend
    saved = getattr(blend, name)
    setattr(blend, name, getattr(blend, name + "_plain"))
    try:
        yield
    finally:
        setattr(blend, name, saved)


def phase_slice(torch, scene, device, frames: int, work: Path):
    from fourdgs_tpu_torch.data.camera import look_at_camera
    from fourdgs_tpu_torch.ops import blend
    from fourdgs_tpu_torch.render.serve import Renderer
    from fourdgs_tpu_torch.train import checkpoint
    from fourdgs_tpu_torch.train import config as config_mod

    cfg, gauss, alive, deform, aabb = scene
    model = work / "model"
    checkpoint.save_snapshot(str(model), 1, gauss, alive, deform, aabb)
    config_mod.save_cfg(cfg, str(model / "cfg_args.json"))
    cams = [look_at_camera(time=i / frames, device=device)
            for i in range(frames)]

    # ---- the main path, with the launch counts read around it ----
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    blend.blend_forward.launches = 0
    t0 = time.perf_counter()
    renderer = Renderer.from_snapshot(str(model), width=SIZE, height=SIZE)
    torch.cuda.synchronize()
    t_load = time.perf_counter() - t0
    t0 = time.perf_counter()
    outs = [renderer.render(c) for c in cams]
    torch.cuda.synchronize()
    t_frames = time.perf_counter() - t0
    launches = {"blend_fwd": blend.blend_forward.launches}
    peak = torch.cuda.max_memory_allocated()

    renders = renderer.probe_renders + frames
    log(f"slice: from_snapshot {t_load:.3f} s ({renderer.probe_renders} "
        f"probe renders, caps {renderer.raster_cfg}); {frames} frames in "
        f"{t_frames:.3f} s = {1e3 * t_frames / frames:.3f} ms/frame "
        f"({frames / t_frames:.2f} FPS); peak memory "
        f"{peak / 2**20:.1f} MiB")
    if launches["blend_fwd"] != renders:
        raise AssertionError(f"blend_fwd launched {launches['blend_fwd']} "
                             f"times for {renders} renders")
    alphas = [float(o.alpha.mean()) for o in outs]
    for o in outs:
        if o.color.shape != (SIZE, SIZE, 3) or not bool(
                torch.isfinite(o.color).all() & torch.isfinite(o.depth).all()):
            raise AssertionError("non-finite or misshapen frame")
    if min(alphas) < MEAN_ALPHA_FLOOR:
        raise AssertionError(f"mean alpha {min(alphas)} < {MEAN_ALPHA_FLOOR}")
    num_pairs = [int(o.num_pairs) for o in outs]
    log(f"slice: mean alpha {min(alphas):.4f}..{max(alphas):.4f}; "
        f"num_pairs {min(num_pairs)}..{max(num_pairs)}; max_dropped_pairs "
        f"{max(int(o.dropped_pairs) for o in outs)}; max_dropped_tile "
        f"{max(int(o.dropped_tile) for o in outs)}; frame 0 vs frame -1 "
        f"max diff {float((outs[0].color - outs[-1].color).abs().max()):.4f}")

    # ---- frame 0 through the plain blend on the card ----
    with plain_version("blend_forward"):
        ref = renderer.render(cams[0])
    diff = float((outs[0].color - ref.color).abs().max())
    log(f"slice: frame 0, kernel vs plain blend: color max abs err "
        f"{diff:.3g} (tol {FRAME_TOL:g})")
    if not diff <= FRAME_TOL:
        raise AssertionError(f"frame 0 kernel vs plain blend {diff}")

    # ---- a small image on the card and on the CPU path ----
    small = dataclasses.replace(renderer.raster_cfg, img_width=SMALL,
                                img_height=SMALL)
    gpu = dataclasses.replace(renderer, raster_cfg=small)
    cpu = dataclasses.replace(
        renderer, gauss=renderer.gauss.to("cpu"),
        alive=renderer.alive.cpu(),
        deform=copy.deepcopy(renderer.deform).to("cpu"),
        aabb=renderer.aabb.cpu(), bg=renderer.bg.cpu(), raster_cfg=small,
        device=torch.device("cpu"))
    cam = look_at_camera(time=0.3, device=device)
    a = gpu.render(cam).color.cpu()
    b = cpu.render(cam).color
    d = (a - b).abs()
    log(f"slice: {SMALL}x{SMALL} card vs CPU path: color mean abs err "
        f"{float(d.mean()):.3g} (tol {SMALL_TOL_MEAN:g}), max "
        f"{float(d.max()):.3g} (tol {SMALL_TOL_MAX:g})")
    if not (float(d.mean()) <= SMALL_TOL_MEAN
            and float(d.max()) <= SMALL_TOL_MAX):
        raise AssertionError("card and CPU paths disagree")
    return renderer, cams, launches, renders


# ---------------------------------------------------------------------------
# phase 4: the kernels against their plain versions
# ---------------------------------------------------------------------------

def time_pair(torch, kernel, plain, launches: int = 50):
    """ms per call of each, CUDA events around batches run in the order
    plain, kernel, kernel, plain (launches/2 calls per batch)."""
    for fn in (kernel, plain):      # warm-up
        fn()
    torch.cuda.synchronize()
    total = {"kernel": 0.0, "plain": 0.0}
    half = launches // 2
    for which in ("plain", "kernel", "kernel", "plain"):
        fn = kernel if which == "kernel" else plain
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(half):
            fn()
        stop.record()
        stop.synchronize()
        total[which] += start.elapsed_time(stop)
    return total["kernel"] / (2 * half), total["plain"] / (2 * half)


def blend_work(torch, gidx, counts, table, cfg) -> dict:
    """This input's pixel x slot evaluations, by how far each gets in the
    kernels' loop bodies: all evaluated, past the power test (an expf),
    and used; and the slots some pixel of a warp used (a warp reduction in
    K2) and some pixel of a tile used (a flush of ten values in K2). A
    pixel evaluates every slot of its tile's list (up to the count) while
    its entering transmittance is above T_MIN. Walks the plain
    recurrence."""
    from fourdgs_tpu_torch.ops.blend import tile_pixel_coords
    from fourdgs_tpu_torch.ops.rasterize_ref import ALPHA_MAX, ALPHA_MIN, T_MIN
    k = cfg.chunk
    px, py = tile_pixel_coords(cfg, table.device)
    idx = torch.where(gidx >= 0, gidx, table.shape[0] - 1).long()
    t = torch.ones_like(px)
    work = {"eval": 0, "exp": 0, "used": 0, "warp_slots": 0, "tile_slots": 0}
    for j in range(-(-int(counts.max()) // k)):
        rows = table[idx[:, j * k:(j + 1) * k]]
        dx = rows[:, :, 0:1] - px[:, None, :]
        dy = rows[:, :, 1:2] - py[:, None, :]
        power = (-0.5 * (rows[:, :, 2:3] * dx * dx + rows[:, :, 4:5] * dy * dy)
                 - rows[:, :, 3:4] * dx * dy)
        alpha = torch.clamp(rows[:, :, 8:9] * torch.exp(
            torch.clamp(power, max=0.0)), max=ALPHA_MAX)
        g = torch.where((power <= 0) & (alpha >= ALPHA_MIN), alpha, 0.0)
        cp = torch.cumprod(1.0 - g, dim=1)
        t_pref = t[:, None, :] * torch.cat(
            [torch.ones_like(cp[:, :1]), cp[:, :-1]], dim=1)
        live = torch.arange(j * k, (j + 1) * k, device=table.device)[None, :] \
            < counts[:, None]
        ev = (t_pref > T_MIN) & live[:, :, None]
        used = ev & (g > 0)
        work["eval"] += int(ev.sum())
        work["exp"] += int((ev & (power <= 0)).sum())
        work["used"] += int(used.sum())
        nt, kk, p = used.shape
        work["warp_slots"] += int(used.reshape(nt, kk, p // 32, 32)
                                  .any(-1).sum())
        work["tile_slots"] += int(used.any(-1).sum())
        use = (g > 0) & (t_pref > T_MIN)
        t = t * torch.where(use, cp, torch.ones_like(cp)).amin(dim=1)
    return work


def phase_kernels(torch, renderer, cam):
    """K1 against its plain version on the inputs that the main path's
    frame at `cam` gives it: the renderer's objects and its caps after
    the cap probe."""
    from fourdgs_tpu_torch.ops import blend
    from fourdgs_tpu_torch.ops.rasterize_tiled import prepare_blend
    from fourdgs_tpu_torch.render.render import splats_at

    rc = renderer.raster_cfg
    cam = cam.to(renderer.device)
    with torch.no_grad():
        splats = splats_at(renderer.gauss, renderer.deform, cam,
                           renderer.aabb, renderer.sh_degree)
        _, binned, table = prepare_blend(*splats, cam, rc, renderer.alive)
    gidx, counts = binned.gidx, binned.counts
    log(f"kernel input: frame at t={float(cam.time):g}, caps tile_cap "
        f"{rc.tile_cap}, bin_pairs_per_chunk {rc.bin_pairs_per_chunk}; "
        f"{int(binned.num_pairs)} pairs, {int(binned.dropped_pairs)} dropped "
        f"by the pair budget, {int(binned.overflow.sum())} past tile_cap")
    out = blend.blend_forward(gidx, counts, table, rc)
    ref = blend.blend_forward_plain(gidx, counts, table, rc)
    torch.cuda.synchronize()
    err = {name: float((a - b).abs().max())
           for name, a, b in zip(("color", "depth", "t"), out, ref)}
    log(f"kernel blend_fwd vs plain at {rc.num_tiles} tiles x "
        f"{rc.pixels_per_tile} px, tile_cap {rc.tile_cap}, "
        f"{int(counts.sum())} pairs: max abs err " +
        ", ".join(f"{k} {v:.3g} (tol {TOL[k]:g})" for k, v in err.items()))
    for k, v in err.items():
        if not v <= TOL[k]:
            raise AssertionError(f"blend_fwd disagrees with plain: {k} {v}")

    ms, plain_ms = time_pair(
        torch, lambda: blend.blend_forward(gidx, counts, table, rc),
        lambda: blend.blend_forward_plain(gidx, counts, table, rc))
    work = blend_work(torch, gidx, counts, table, rc)
    instr = sum(BLEND_FP32_INSTR[k] * work[k] for k in BLEND_FP32_INSTR)
    n_rows = int(torch.unique(gidx[gidx >= 0]).numel())
    nbytes = (4 * rc.num_tiles + 4 * int(counts.sum()) + 48 * n_rows
              + 5 * 4 * rc.num_tiles * rc.pixels_per_tile)
    bounds = {"hbm bytes": nbytes / HBM_BYTES_S,
              "fp32 issue": instr / FP32_ISSUE_S,
              "mufu (expf)": work["exp"] / MUFU_OP_S}
    resource = max(bounds, key=bounds.get)
    log(f"blend_fwd: {ms:.4f} ms/launch, plain {plain_ms:.4f} ms; "
        f"pixel x slot evaluations {work}, {instr} FP32 instructions, "
        f"{nbytes} bytes; bounds " +
        ", ".join(f"{k} {v * 1e3:.4f} ms" for k, v in bounds.items()) +
        f"; bound by {resource}")
    return {
        "name": "blend_fwd",
        "route": "cuda",
        "source": "fourdgs_tpu_torch/csrc/blend_fwd.cu",
        "replaces": "fourdgs_tpu/ops/pallas/blend.py:80",
        "tpu_kernel": "fourdgs_tpu/ops/pallas/blend.py:_fwd_kernel",
        "max_abs_err": err["color"],
        "max_abs_err_depth": err["depth"],
        "max_abs_err_t": err["t"],
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bounds[resource] * 1e3,
        "bound_by": "bytes" if resource == "hbm bytes" else "operations",
        "bound_resource": resource,
        "library_ms": None,        # no single PyTorch call blends
        "evaluations": work,
        "ok": True,
    }


# ---------------------------------------------------------------------------
# phase 5: the training slice
# ---------------------------------------------------------------------------

def make_train_state(torch, scene, device):
    """The scene's gaussians in a capacity-TRAIN_CAPACITY buffer with the
    first N_GAUSS slots alive, and a copy of its deformation."""
    from fourdgs_tpu_torch.models.gaussians import FIELDS, GaussianParams
    from fourdgs_tpu_torch.train.state import create_state

    cfg, gauss, _, deform, aabb = scene
    cfg = copy.deepcopy(cfg)
    cfg.raster.capacity = TRAIN_CAPACITY

    def pad(x, fill=0.0):
        out = torch.full((TRAIN_CAPACITY,) + tuple(x.shape[1:]), fill,
                         dtype=x.dtype, device=device)
        out[:N_GAUSS] = x
        return out

    padded = GaussianParams(**{f: pad(getattr(gauss, f)) for f in FIELDS})
    padded.rotation[N_GAUSS:, 0] = 1.0
    alive = pad(torch.ones(N_GAUSS, dtype=torch.bool, device=device), False)
    state = create_state(cfg, None, None, SPATIAL_LR_SCALE, aabb=aabb,
                         deform=copy.deepcopy(deform), gauss=padded,
                         alive=alive, device=device)
    return cfg, state


def grads_agree(a, b) -> float:
    """Largest normalised difference of two gradients of one leaf, the
    difference divided by the leaf's largest |b| (b the reference), as
    the JAX package's gradient tests normalise."""
    return float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)


def phase_train(torch, scene, renderer, device, steps: int, seed: int):
    """Fine train_steps at 800x800 on the scene, with the caps the cap
    probe found; returns what phase 6 needs."""
    from fourdgs_tpu_torch.data.camera import look_at_camera
    from fourdgs_tpu_torch.ops import blend
    from fourdgs_tpu_torch.tools.profile_render import (TRAIN_SPANS,
                                                        profile_calls)
    from fourdgs_tpu_torch.train import loop, optim

    cfg, state = make_train_state(torch, scene, device)
    rc, bg, sh = renderer.raster_cfg, renderer.bg, cfg.model.sh_degree
    cams = [look_at_camera(theta=0.3 + 0.2 * i, time=t, device=device)
            for i, t in enumerate(TRAIN_TIMES)]
    check_cam = look_at_camera(time=KERNEL_CHECK_FRAME, device=device)
    gts = [loop.eval_step(state, c, bg, stage="fine", active_sh=sh,
                          raster_cfg=rc).color for c in cams + [check_cam]]
    rng = np.random.default_rng(seed + 1)
    g = state.params["gauss"]
    with torch.no_grad():
        g.features_dc[:N_GAUSS] += torch.from_numpy(rng.normal(
            0.0, NOISE_DC, (N_GAUSS, 1, 3)).astype(np.float32)).to(device)
        g.opacity[:N_GAUSS] += torch.from_numpy(rng.normal(
            0.0, NOISE_OPACITY, (N_GAUSS, 1)).astype(np.float32)).to(device)
    tx = optim.build_optimizer(cfg.opt, SPATIAL_LR_SCALE)
    reg = (cfg.hidden.time_smoothness_weight, cfg.hidden.l1_time_planes,
           cfg.hidden.plane_tv_weight)
    kw = dict(stage="fine", raster_cfg=rc, lambda_dssim=cfg.opt.lambda_dssim,
              reg_weights=reg)

    def step(i):
        return loop.train_step(state, [cams[i % len(cams)]],
                               gts[i % len(cams)][None], bg, sh, tx=tx, **kw)

    # ---- the main path, with the launch counts read around it ----
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    blend.blend_forward.launches = 0
    blend.blend_backward.launches = 0
    auxes = []
    for i in range(steps):
        if i == UNTIMED_STEPS:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
        auxes.append(step(i)[1])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = {"blend_fwd": blend.blend_forward.launches,
                "blend_bwd": blend.blend_backward.launches}
    peak = torch.cuda.max_memory_allocated()
    ms = 1e3 * seconds / (steps - UNTIMED_STEPS)
    losses = [float(a.loss) for a in auxes]
    log(f"train: {steps} fine steps at {SIZE}x{SIZE}, {N_GAUSS} gaussians "
        f"in capacity {TRAIN_CAPACITY}, caps {rc}; {ms:.3f} ms/step over "
        f"the last {steps - UNTIMED_STEPS} = "
        f"{SIZE * SIZE / (ms / 1e3):.0f} rays/s; peak memory "
        f"{peak / 2**20:.1f} MiB; launches {launches}")
    log(f"train: loss first {losses[0]:.6f}, last-5 mean "
        f"{np.mean(losses[-5:]):.6f}, psnr first {float(auxes[0].psnr):.3f}"
        f" last {float(auxes[-1].psnr):.3f}; max dropped_pairs "
        f"{max(int(a.dropped_pairs) for a in auxes)}, max dropped_tile "
        f"{max(int(a.dropped_tile) for a in auxes)}; num_pairs "
        f"{int(auxes[0].num_pairs)}")
    if launches != {"blend_fwd": steps, "blend_bwd": steps}:
        raise AssertionError(f"launches {launches} for {steps} steps")
    if not all(np.isfinite(losses)):
        raise AssertionError(f"non-finite loss: {losses}")
    if not np.mean(losses[-5:]) < losses[0]:
        raise AssertionError(f"the loss did not fall: {losses}")
    nan = sum(int(torch.isnan(p).sum()) for p in optim.param_leaves(
        state.params))
    if nan:
        raise AssertionError(f"{nan} NaN parameter values")

    it = iter(range(PROFILED_STEPS))
    prof = profile_calls(lambda: step(next(it)), PROFILED_STEPS,
                         spans=TRAIN_SPANS, label="step")
    calls = prof["runtime_calls_per_step"]

    # ---- one step's gradients with K2 and with the plain backward ----
    def grads():
        sg = loop.step_gradients(state, [cams[0]], gts[0][None], bg, sh, **kw)
        return [x for x in sg.grads + [sg.ndc_grad] if x is not None]

    with_k2 = grads()
    with plain_version("blend_backward"):
        plain = grads()
    err = max(grads_agree(a, b) for a, b in zip(with_k2, plain))
    log(f"train: one step's gradients, K2 vs plain backward on the card: "
        f"{len(plain)} leaves, normalised max abs err {err:.3g} "
        f"(tol {GRAD_TOL:g})")
    if not err <= GRAD_TOL:
        raise AssertionError(f"K2 step gradients disagree: {err}")
    return state, rc, bg, sh, check_cam, gts[-1], launches, {
        "ms_per_step": ms, "rays_per_s": SIZE * SIZE / (ms / 1e3),
        "peak_mib": peak / 2**20, "loss_first": losses[0],
        "loss_last5": float(np.mean(losses[-5:])),
        "runtime_calls_per_step": calls,
        "device_busy_share": prof["device_busy_share"],
        "kernel_ms_per_step": prof["kernel_ms_per_step"]}


# ---------------------------------------------------------------------------
# phase 6: K2 against its plain version
# ---------------------------------------------------------------------------

def phase_kernels_bwd(torch, state, rc, bg, sh, cam, gt):
    """K2 on the step input of the trained state's frame at `cam`: K1's
    outputs and the cotangents that the step's L1 loss gives them."""
    from fourdgs_tpu_torch.ops import blend, losses
    from fourdgs_tpu_torch.ops.rasterize_tiled import _untile, prepare_blend
    from fourdgs_tpu_torch.render.render import splats_at

    g = state.params["gauss"]
    with torch.no_grad():
        splats = splats_at(g, state.params["deform"], cam, state.aabb, sh)
        _, binned, table = prepare_blend(*splats, cam, rc, state.alive)
        out = blend.blend_forward(binned.gidx, binned.counts, table, rc)
    leaves = [o.clone().requires_grad_(True) for o in out]
    color = _untile(leaves[0], rc) + _untile(leaves[2], rc)[..., None] * bg
    loss = losses.l1_loss(color[None], gt[None])
    cot = torch.autograd.grad(loss, leaves, allow_unused=True)
    cot = [torch.zeros_like(o) if c is None else c.contiguous()
           for o, c in zip(out, cot)]
    gidx, counts = binned.gidx, binned.counts
    args = (gidx, counts, table, *out, *cot, rc)
    got = blend.blend_backward(*args)
    ref = blend.blend_backward_plain(*args)
    torch.cuda.synchronize()
    scale = ref.abs().amax(dim=0).clamp(min=1e-30)
    col_err = ((got - ref).abs() / scale).amax(dim=0).tolist()
    abs_err = float((got - ref).abs().max())
    log(f"kernel input: frame at t={float(cam.time):g}, caps tile_cap "
        f"{rc.tile_cap}; {int(counts.sum())} pairs, "
        f"{int(binned.overflow.sum())} past tile_cap")
    log("kernel blend_bwd vs plain: normalised max abs err per column " +
        ", ".join(f"{n} {e:.3g}" for n, e in zip(GRAD_COLUMNS, col_err)) +
        f" (tol {GRAD_TOL:g}); max abs err {abs_err:.3g}")
    if not max(col_err) <= GRAD_TOL:
        raise AssertionError(f"blend_bwd disagrees with plain: {col_err}")

    ms, plain_ms = time_pair(torch, lambda: blend.blend_backward(*args),
                             lambda: blend.blend_backward_plain(*args),
                             launches=20)
    work = blend_work(torch, gidx, counts, table, rc)
    instr = (sum(BLEND_BWD_FP32_INSTR[k] * work[k]
                 for k in BLEND_BWD_FP32_INSTR) + 10 * work["used"])
    mufu = work["exp"] + 2 * work["used"]
    n_rows = int(torch.unique(gidx[gidx >= 0]).numel())
    pixels = rc.num_tiles * rc.pixels_per_tile
    nbytes = (4 * rc.num_tiles + 4 * int(counts.sum()) + 48 * n_rows
              + 10 * 4 * pixels + 10 * 4 * table.shape[0])
    bounds = {"hbm bytes": nbytes / HBM_BYTES_S,
              "fp32 issue": instr / FP32_ISSUE_S,
              "mufu (expf, 2 rcp)": mufu / MUFU_OP_S}
    resource = max(bounds, key=bounds.get)
    atomics = {"shared": 10 * work["warp_slots"],
               "global": 10 * work["tile_slots"]}
    log(f"blend_bwd: {ms:.4f} ms/launch, plain {plain_ms:.4f} ms; pixel x "
        f"slot work {work}; atomics (at most) {atomics}; {instr} FP32 "
        f"instructions, {mufu} MUFU, {nbytes} bytes; bounds " +
        ", ".join(f"{k} {v * 1e3:.4f} ms" for k, v in bounds.items()) +
        f"; bound by {resource}")
    return {
        "name": "blend_bwd",
        "route": "cuda",
        "source": "fourdgs_tpu_torch/csrc/blend_bwd.cu",
        "replaces": "fourdgs_tpu/ops/pallas/blend.py:197",
        "tpu_kernel": "fourdgs_tpu/ops/pallas/blend.py:_bwd_fused_kernel",
        "max_abs_err": abs_err,
        "max_normalised_err": max(col_err),
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bounds[resource] * 1e3,
        "bound_by": "bytes" if resource == "hbm bytes" else "operations",
        "bound_resource": resource,
        "library_ms": None,   # no single PyTorch call computes it
        "evaluations": work,
        "atomics": atomics,
        "ok": True,
    }


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--frames", type=int, default=24)
    parser.add_argument("--steps", type=int, default=30)
    args = parser.parse_args(argv)
    if args.steps <= UNTIMED_STEPS + 5:
        parser.error(f"--steps must exceed {UNTIMED_STEPS + 5}")

    import torch
    name = phase_device(torch)
    # Full float32 everywhere: the deformation MLP heads must not run in
    # TF32 (three decimal digits) for parity with the reference.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)

    phase_build()
    work = ROOT / "build" / "chip_smoke"
    work.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    scene = make_scene(torch, args.seed, device)
    log(f"scene: {N_GAUSS} gaussians, seed {args.seed}, "
        f"{time.perf_counter() - t0:.2f} s")
    renderer, cams, launches, renders = phase_slice(
        torch, scene, device, args.frames, work)
    cam = cams[round(KERNEL_CHECK_FRAME * args.frames)]
    k1 = phase_kernels(torch, renderer, cam)
    k1["launches"] = launches["blend_fwd"]
    k1["launches_per_frame"] = launches["blend_fwd"] / renders
    state, rc, bg, sh, check_cam, gt, train_launches, train = phase_train(
        torch, scene, renderer, device, args.steps, args.seed)
    k1["launches_train"] = train_launches["blend_fwd"]
    k2 = phase_kernels_bwd(torch, state, rc, bg, sh, check_cam, gt)
    k2["launches"] = train_launches["blend_bwd"]
    k2["launches_per_step"] = train_launches["blend_bwd"] / args.steps
    k2["train"] = train
    kernels = [k1, k2]
    for k in kernels:
        if k["launches"] == 0:
            raise AssertionError(f"{k['name']} never launched on the path")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
