#!/usr/bin/env python3
"""On-card smoke run of the PyTorch port (fourdgs_tpu_torch) on one GPU.

    python3 chip_smoke.py [--seed 0] [--frames 24] [--steps 30]
                          [--coarse 300] [--fine 1200]

Phases, each of which raises on failure (so the exit code is nonzero):
  1. device: the card's name and power limit;
  2. build:  the CUDA kernels from fourdgs_tpu_torch/csrc with nvcc;
  3. slice:  a synthetic snapshot (100,000 Gaussians, D-NeRF deformation
             width, random weights from --seed) served through
             Renderer.from_snapshot at 800x800 for --frames frames, each
             a replay of the captured frame (train/graphs.py), with the
             kernels' runs read around that run; the same frames rendered
             eagerly, equal bit for bit; each mode's ms/frame, FPS, peak
             memory and, from a profile of a few frames, its syncs, copies
             from the host, graph and kernel launches a frame (none of
             the first two in a replay; the eager one's raster.bin and
             render.splats kernel time); the runs of K1, the binner
             kernel and D1 a frame, counted over the replays; and checks
             of the images against the plain blend on the card and the
             CPU path on a small image;
  4. kernel: K1 (blend forward) against its plain PyTorch version, on the
             inputs that one of phase 3's frames gives it (the caps after
             the cap probe), with CUDA-event, device and host-enqueue
             times, and where its time can go
             (tools/profile_blend_split.py:blend_work: the tiles'
             occupancy, the heaviest tile's one-SM time, the evaluations
             that warps of either shape issue); on the same frame's
             input, the binner kernel (csrc/binner.cu) against the plain
             binner (equal) and D1 at each HexPlane gather of the frame
             against `index_select` (equal), each with CUDA-event,
             device and host times, its bound and the plain or library
             route's time;
  5. train:  a TrainState of the same scene (capacity 1<<17, the first
             100,000 slots alive) takes --steps fine train_steps at
             800x800 toward four targets that eval_step rendered before
             seeded noise moved its colors and opacities, eagerly and
             then as replays of the captured step, each from the same
             state, with the kernels' runs read around both; the loss must
             fall in each, the captured run's leaves after one step must
             equal the eager run's (GRAD_TOL) and its losses follow
             (STEP_LOSS_RTOL); each mode's ms/step, rays/s, peak memory
             and, from a profile of a few steps, its syncs, copies from
             the host, graph and kernel launches and kernel time a step
             (the eager one's spans too: raster.bin and render.splats
             printed); the binner kernel and D1 ran each step, counted
             over the replays; and one step's gradients with K2 must
             equal those with the plain backward on the card, on each
             training view and on phase 6's view;
  6. kernel: K2 (blend backward) against its plain version on the step
             input of the trained state's frame at t = 0.5 (its
             cotangents, its caps), with CUDA-event, device and
             host-enqueue times, the float2 atomics, reduced warp
             batches and block chunks that a counting build of K2 tallies
             on that input, and where its sums can go
             (tools/profile_blend_split.py:bwd_work); on the same step
             input, the binner kernel and D1 as in phase 4;
  7. driver: the training CLI (tools.train.main) on a synthetic D-NeRF
             scene (tools.make_synthetic_scene: 60 train and 10 test views
             at 800x800) at the D-NeRF width of dnerf_default.py, its
             schedule cut to --coarse/--fine iterations, with the four
             switches of the per-slot path set (K3 for the blend backward,
             K4 for its reduction and the HexPlane gather backward, K5 for
             the binner): densify, prune, opacity reset, bucket resizes,
             the SH ramp, test evaluations, a snapshot and a checkpoint,
             then a 20-iteration resume from that checkpoint, then
             Renderer.from_snapshot on the trained snapshot rendering test
             view 0 at its probed caps and as the run's eval rendered it
             (the eval's caps, the run's buffer capacity), each render's
             drops and caps printed; the CLI replays captured steps (its
             default on the card), and the phase prints the capture
             seconds of each key, the recaptures, the rebinds after
             surgeries and the replays; the kernels' runs are read around
             the whole phase;
  8. kernel: K3, K4 and K5 against their plain versions on phase 6's step
             input (K4 also at a HexPlane plane's shape, K5 at the
             binner's), one step's gradients through K3 + K4 against
             K2's, with CUDA-event times, the device time (torch.profiler,
             fills included) and the host's time to enqueue one call, and
             the PyTorch call that computes the same function where there
             is one; K3's table twice, bit for bit, and what a counting
             build of K3 tallies (its float2 stores, five a row of the
             tiles' occupied chunks, its reduced warp batches, equal to
             phase 6's count of K2's, and the chunks its blocks walk,
             against those of K2's sub-tile blocks: the coupled exit);
  9. dev:    the six tools of fourdgs_tpu_torch/tools that port the Pallas
             prototypes of scripts/ (D1-D6), each through its `main` at its
             script's shapes, with the launch counts read around the six;
             then each kernel against its plain version on its tool's
             inputs (D1, D2, D4a, D4b equal; D3 to SCATTER_TOL; D5, K1 at
             tile 16, to TOL; D6 to DEV_TOL), with the tools' CUDA-event
             times and bounds, and for D4 and D6 the device time
             (torch.profiler, or where it keeps no record, CUDA events
             behind a held stream) and the held stream's time beside it.
The second-to-last line of stdout is the kernels JSON, the last line the
result JSON. It imports nothing of JAX or the JAX package.
"""
from __future__ import annotations

import argparse
import contextlib
import copy
import dataclasses
import json
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

from fourdgs_tpu_torch.tools.profile_blend_split import (BLEND_FP32_INSTR,
                                                         blend_work,
                                                         bwd_work)
from fourdgs_tpu_torch.utils.timing import (FP32_ISSUE_S, HBM_BYTES_S,
                                            HELD_STREAM, MUFU_OP_S,
                                            NoKernelRecords, held_stream_ms,
                                            kernel_records, per_call_ms,
                                            time_call, time_pair)

ROOT = Path(__file__).resolve().parent
N_GAUSS = 100_000
SIZE = 800
OPACITY_LOGIT = 2.197          # sigmoid = 0.9, a trained-like opacity
RASTER = dict(tile_size=32, tile_cap=768, chunk=32, bin_chunk=4096,
              bin_pairs_per_chunk=18432)
KERNEL_CHECK_FRAME = 0.5       # the main-path frame at t = 0.5
TOL = {"color": 1e-5, "depth": 1e-4, "t": 1e-5}
GRAD_TOL = 1e-4                # gradients, normalised by their max |.|
# phase 5: the captured run's losses against the eager run's, relative;
# the two backward passes sum with float atomics in different orders, and
# Adam's division by sqrt(nu) carries the last bits on from step to step
STEP_LOSS_RTOL = 1e-3
# the kernels of the main paths: reported name -> wrapper name
REPORTED = {"blend_fwd": "blend_forward", "blend_bwd": "blend_backward",
            "blend_bwd_slots": "blend_backward_slots",
            "scatter_add_rows": "scatter_add_rows",
            "scatter_set_scalars": "scatter_set_scalars",
            "binner": "bin_tiles", "gather_rows": "gather_rows"}
# the kernels of the serve and step paths, each run once a frame or step
# (K1, K2 the step only, the binner), and the HexPlane's forward gathers
# (D1): 12 for a level's three spatial planes, 6 for its three time planes
# at one timestamp
PATH_KERNELS = ("blend_fwd", "blend_bwd", "binner", "gather_rows")
HEX_GATHERS_PER_LEVEL = 18
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

# FP32-pipe instructions of csrc/blend_bwd.cu's loop body per pixel x slot
# evaluation, as its sm_90a SASS has them: the replay up to the alpha test
# is K1's (12 and 9); a used slot runs T x cp and its test (2), the
# gradient chain and the two IEEE divisions (each MUFU.RCP, FCHK and five
# FFMA), 53 in all. The bound adds the 10 additions per used pixel x slot
# that any sum into the per-gaussian rows needs, and counts one MUFU.EX2
# per expf and two MUFU.RCP per used slot.
BLEND_BWD_FP32_INSTR = {"eval": 12, "exp": 9, "used": 53}
# K3 (csrc/blend_bwd.cu's per-slot build) runs K2's replay and gradient
# chain; its per-slot sums over the tile's pixels need the same 10
# additions per used pixel x slot, so its bound counts K2's instructions.

# phase 7: the switches of the per-slot path, read at call time by
# ops/blend.py, ops/scatter.py's callers and models/hexplane.py
SWITCHES = {"FOURDGS_PALLAS_NO_FUSED_BWD": "1",
            "FOURDGS_PALLAS_GRAD_SCATTER": "1",
            "FOURDGS_HEX_BWD": "pallas", "FOURDGS_BIN_SCATTER": "pallas"}
DRIVER_SIZE = 800              # data/blender.py RESOLUTION
DRIVER_VIEWS = (60, 10)        # train, test: the JAX scene script's defaults
RESUME_ITERS = 20
# fourdgs_tpu/configs/dnerf/dnerf_default.py's values; the schedule is cut
# to the run's length (densify, prune and reset every 100/100/600
# iterations, densify until 1000, prune above 1000 live points), and the
# capacity buckets start at 1,024 (of 4,096) so that the cut run's few
# thousand points cross bucket sizes: its count ends near the 4,096
# bucket's 2,730-point edge, on either side from run to run
DRIVER_CONFIG = """\
OptimizationParams = dict(
    coarse_iterations={coarse},
    deformation_lr_init=0.00016,
    deformation_lr_final=0.0000016,
    deformation_lr_delay_mult=0.01,
    grid_lr_init=0.0016,
    grid_lr_final=0.000016,
    iterations={fine},
    pruning_interval=100,
    percent_dense=0.01,
    densify_from_iter=100,
    pruning_from_iter=100,
    densification_interval=100,
    opacity_reset_interval=600,
    densify_until_iter=1000,
    prune_min_points=1000,
)
ModelHiddenParams = dict(
    multires=[1, 2],
    defor_depth=0,
    net_width=64,
    plane_tv_weight=0.0001,
    time_smoothness_weight=0.01,
    l1_time_planes=0.0001,
    weight_decay_iteration=0,
    bounds=1.6,
)
RasterParams = dict(min_bucket=1024)
"""
RENDER_PSNR_TOL = 0.1          # dB: the snapshot's render vs the run's eval
SCATTER_TOL = 1e-5             # K4 vs plain, max |a - b| / max |b|
# phase 9: D6's four bodies vs plain, max |a - b| / max |b|; the same sums
# of 768 terms a pixel in another association
DEV_TOL = 1e-5


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


def host_calls(prof: dict, label: str) -> dict:
    """A profile's host syncs, copies from the host and graph launches a
    call (tools/profile_render.py:profile_calls). A sync of the path (a
    `.item()`, a data-dependent size, a copy from pageable host memory)
    is a cudaStreamSynchronize; the cudaDeviceSynchronize calls are the
    profile window's own `torch.cuda.synchronize()`."""
    calls = prof[f"runtime_calls_per_{label}"]
    return {"syncs": calls.get("cudaStreamSynchronize", 0.0),
            "window_device_syncs": calls.get("cudaDeviceSynchronize", 0.0),
            "copies_from_host": prof[f"device_copies_per_{label}"]["HtoD"],
            "graph_launches": calls.get("cudaGraphLaunch", 0.0),
            "kernel_launches": prof[f"kernel_launches_per_{label}"],
            "kernel_ms": prof[f"kernel_ms_per_{label}"],
            "device_busy_share": prof["device_busy_share"]}


def phase_slice(torch, scene, device, frames: int, work: Path):
    """The served frames, captured (the Renderer's default on the card)
    and eager, in one call; returns what phase 4 needs and each mode's
    numbers."""
    from fourdgs_tpu_torch.data.camera import look_at_camera
    from fourdgs_tpu_torch.render.serve import Renderer
    from fourdgs_tpu_torch.tools.profile_render import profile_calls
    from fourdgs_tpu_torch.train import checkpoint, graphs
    from fourdgs_tpu_torch.train import config as config_mod

    cfg, gauss, alive, deform, aabb = scene
    model = work / "model"
    checkpoint.save_snapshot(str(model), 1, gauss, alive, deform, aabb)
    config_mod.save_cfg(cfg, str(model / "cfg_args.json"))
    cams = [look_at_camera(time=i / frames, device=device)
            for i in range(frames)]

    # ---- the main path, with the launch counts read around it: the
    # snapshot loaded, one untimed frame (the capture), then the frames ----
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    graphs.zero_counts()
    t0 = time.perf_counter()
    renderer = Renderer.from_snapshot(str(model), width=SIZE, height=SIZE)
    torch.cuda.synchronize()
    t_load = time.perf_counter() - t0
    t0 = time.perf_counter()
    renderer.render(cams[0])
    torch.cuda.synchronize()
    t_capture = time.perf_counter() - t0
    t0 = time.perf_counter()
    outs = [renderer.render(c) for c in cams]
    torch.cuda.synchronize()
    t_frames = time.perf_counter() - t0
    ran = kernel_runs()
    launches = {k: ran[k] for k in ("blend_fwd", "binner", "gather_rows")}
    peak = torch.cuda.max_memory_allocated()
    (frame,) = renderer.frames.values()
    replays = frame.program.replays

    renders = renderer.probe_renders + graphs.WARMUP + 1 + frames
    gathers = HEX_GATHERS_PER_LEVEL * len(cfg.hidden.multires)
    log(f"slice: from_snapshot {t_load:.3f} s ({renderer.probe_renders} "
        f"probe renders, caps {renderer.raster_cfg}); captured: first "
        f"frame (capture) {t_capture:.3f} s, {frames} frames in "
        f"{t_frames:.3f} s = {1e3 * t_frames / frames:.3f} ms/frame "
        f"({frames / t_frames:.2f} FPS); peak memory "
        f"{peak / 2**20:.1f} MiB; graph replays {replays}")
    log(f"slice: kernel runs over {renders} renders (replays counted): "
        f"{launches}; a frame: blend_fwd "
        f"{launches['blend_fwd'] / renders:g}, binner "
        f"{launches['binner'] / renders:g}, gather_rows "
        f"{launches['gather_rows'] / renders:g}; the captured frame's "
        f"launches {frame.program.launches}")
    want = {"blend_fwd": renders, "binner": renders,
            "gather_rows": gathers * renders}
    if launches != want or replays != frames + 1:
        raise AssertionError(f"kernel runs {launches} ({replays} replays) "
                             f"for {renders} renders, not {want}")

    # ---- the same frames rendered eagerly, and both modes profiled ----
    eager = dataclasses.replace(renderer, capture=False)
    eager.render(cams[0])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    eager_outs = [eager.render(c) for c in cams]
    torch.cuda.synchronize()
    t_eager = time.perf_counter() - t0
    peak_eager = torch.cuda.max_memory_allocated()
    modes = {}
    for name, r, seconds, pk in (("captured", renderer, t_frames, peak),
                                 ("eager", eager, t_eager, peak_eager)):
        it = iter(cams[:PROFILED_STEPS])
        prof = profile_calls(lambda: r.render(next(it)), PROFILED_STEPS)
        modes[name] = {"ms_per_frame": 1e3 * seconds / frames,
                       "fps": frames / seconds, "peak_mib": pk / 2**20,
                       **host_calls(prof, "frame")}
        if name == "eager":
            modes[name]["spans"] = prof["spans"]
            log("slice eager: kernels a frame by span: " + ", ".join(
                f"{k} {prof['spans'][k]['kernel_ms']:.4f} ms"
                for k in ("render.splats", "raster.bin")))
        log(f"slice {name}: {modes[name]['ms_per_frame']:.3f} ms/frame "
            f"({modes[name]['fps']:.2f} FPS); per frame: syncs "
            f"{modes[name]['syncs']:g}, copies from the host "
            f"{modes[name]['copies_from_host']:g}, graph launches "
            f"{modes[name]['graph_launches']:g}, kernel launches "
            f"{modes[name]['kernel_launches']:g}, kernels "
            f"{modes[name]['kernel_ms']:.3f} ms; peak memory "
            f"{modes[name]['peak_mib']:.1f} MiB")
    modes["captured"].update(replays=replays,
                             capture_s=frame.program.seconds)
    if modes["captured"]["syncs"] or modes["captured"]["copies_from_host"]:
        raise AssertionError(f"a replayed frame synced or copied from the "
                             f"host: {modes['captured']}")
    differ = [i for i, (a, b) in enumerate(zip(outs, eager_outs))
              if not all(torch.equal(getattr(a, f), getattr(b, f))
                         for f in ("color", "depth", "alpha", "radii"))]
    log(f"slice: captured frames against eager, bit for bit: "
        f"{frames - len(differ)}/{frames} equal")
    if differ:
        raise AssertionError(f"captured frames {differ} differ from eager")

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

    # ---- frame 0 through the plain blend on the card (eagerly: a
    # captured frame would replay the kernel) ----
    with plain_version("blend_forward"):
        ref = eager.render(cams[0])
    diff = float((outs[0].color - ref.color).abs().max())
    log(f"slice: frame 0, kernel vs plain blend: color max abs err "
        f"{diff:.3g} (tol {FRAME_TOL:g})")
    if not diff <= FRAME_TOL:
        raise AssertionError(f"frame 0 kernel vs plain blend {diff}")

    # ---- a small image on the card and on the CPU path ----
    small = dataclasses.replace(renderer.raster_cfg, img_width=SMALL,
                                img_height=SMALL)
    gpu = dataclasses.replace(eager, raster_cfg=small)
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
    return renderer, cams, launches, renders, modes


# ---------------------------------------------------------------------------
# phase 4: the kernels against their plain versions
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def recorded_gathers(calls: list):
    """Record the (table, idx) of each D1 call that the HexPlane's
    forward makes in a block (models/hexplane.py:_GatherRows)."""
    from fourdgs_tpu_torch.models import hexplane
    real = hexplane.gather_rows

    def record(table, idx):
        calls.append((table, idx))
        return real(table, idx)

    hexplane.gather_rows = record
    try:
        yield calls
    finally:
        hexplane.gather_rows = real


def check_binner(torch, label: str, proj, rc) -> dict:
    """The binner on a path's projection: the kernel route
    (`bin_gaussians_count` on the card: the depth sort and items in
    PyTorch, then csrc/binner.cu) against the plain binner, every field
    equal; its CUDA-event, device and host times beside the plain route's
    and its byte bound (each input of the projection read once, the lists
    and counts written once)."""
    from fourdgs_tpu_torch.ops import rasterize_tiled as rt

    def kernel():
        return rt.bin_gaussians_count(proj, rc)

    def plain():
        return rt.bin_gaussians_count_plain(proj, rc)

    got, want = kernel(), plain()
    torch.cuda.synchronize()
    differ = [f for f in rt.BinnedTiles._fields
              if not torch.equal(getattr(got, f), getattr(want, f))]
    ms, plain_ms = time_pair(kernel, plain, launches=20)
    dev = device_ms(kernel)
    # csrc/binner.cu's own kernels: the items' gather, the rank, the counts
    own_ms = sum(v for k, v in dev["kernels"].items()
                 if k.startswith(("bin_", "rank_")))
    n, nt = proj.depth.shape[0], rc.num_tiles
    # pix 8, depth 4, rect_min 8, rect_max 8, tiles_touched 4, cull_r2 4
    nbytes = 36 * n + 4 * nt * rc.tile_cap + 8 * nt + 12
    bound_ms = nbytes / HBM_BYTES_S * 1e3
    pairs = int(want.num_pairs)
    log(f"kernel binner ({label}) vs plain: {n} gaussians, {pairs} pairs, "
        f"{int(want.counts.sum())} ranked into {nt} tiles x tile_cap "
        f"{rc.tile_cap}, {int(want.dropped_pairs)} past the budget, "
        f"{int(want.dropped_tile)} past tile_cap; equal on every field: "
        f"{not differ}")
    if differ:
        raise AssertionError(f"binner ({label}) differs from plain in "
                             f"{differ}")
    log(f"binner ({label}): {ms:.4f} ms/call, device {dev['ms']:.4f} ms "
        f"(csrc/binner.cu's kernels {own_ms:.4f} ms) "
        f"{dev['kernels']}, host {dev['host_ms']:.4f} ms, plain "
        f"{plain_ms:.4f} ms; {nbytes} bytes, bound {bound_ms:.4f} ms "
        f"(hbm bytes)")
    return {"ms": ms, "device_ms": dev["ms"], "own_device_ms": own_ms,
            "device_kernels": dev["kernels"],
            "device_records": dev["records"], "host_ms": dev["host_ms"],
            "plain_ms": plain_ms, "bound_ms": bound_ms, "nbytes": nbytes,
            "gaussians": n, "pairs": pairs,
            "ranked": int(want.counts.sum()) + int(want.dropped_tile)}


def check_gathers(torch, label: str, calls: list) -> dict:
    """D1 on each HexPlane gather of a path's frame or step (`calls`, the
    recorded (table, idx)): equal to `index_select`; the CUDA-event,
    device and host times of all of them as one call, beside the plain
    version's and index_select's, and each shape's alone; the byte bound
    (the indices and each row named read once, the output written
    once)."""
    from fourdgs_tpu_torch.ops import gather

    differ = [i for i, (t, x) in enumerate(calls)
              if not torch.equal(gather.gather_rows(t, x),
                                 torch.index_select(t, 0, x))]
    torch.cuda.synchronize()
    if differ:
        raise AssertionError(f"gather_rows ({label}) differs from "
                             f"index_select in calls {differ}")

    def nbytes_of(t, x):
        rows = int(torch.unique(x).numel())
        return 4 * x.numel() + 4 * t.shape[1] * (rows + x.numel())

    def timed(group):
        def kernel():
            return [gather.gather_rows(t, x) for t, x in group]

        def plain():
            return [gather.gather_rows_plain(t, x) for t, x in group]

        def library():
            return [torch.index_select(t, 0, x) for t, x in group]

        ms, plain_ms = time_pair(kernel, plain, launches=20)
        lib_ms = time_call(library)
        dev, lib_dev = device_ms(kernel), device_ms(library)
        nbytes = sum(nbytes_of(t, x) for t, x in group)
        return {"ms": ms, "device_ms": dev["ms"], "host_ms": dev["host_ms"],
                "device_records": dev["records"], "plain_ms": plain_ms,
                "library_ms": lib_ms, "library_device_ms": lib_dev["ms"],
                "library_host_ms": lib_dev["host_ms"], "nbytes": nbytes,
                "bound_ms": nbytes / HBM_BYTES_S * 1e3}

    shapes = {}
    for t, x in calls:
        shapes.setdefault((t.shape[0], t.shape[1], x.numel()),
                          []).append((t, x))
    per_shape = {}
    for (rows, w, m), group in sorted(shapes.items()):
        rec = timed(group[:1])
        per_shape[f"{rows}x{w} <- {m}"] = {"calls": len(group), **rec}
        log(f"gather_rows ({label}) at a ({rows}, {w}) table, {m} indices "
            f"({len(group)} calls a pass): {rec['ms']:.4f} ms, device "
            f"{rec['device_ms']:.4f} ms, host {rec['host_ms']:.4f} ms, "
            f"plain {rec['plain_ms']:.4f} ms, index_select "
            f"{rec['library_ms']:.4f} ms (device "
            f"{rec['library_device_ms']:.4f} ms); bound "
            f"{rec['bound_ms']:.4f} ms")
    rec = timed(calls)
    log(f"kernel gather_rows ({label}) vs index_select: {len(calls)} "
        f"HexPlane gathers, all equal; together {rec['ms']:.4f} ms, device "
        f"{rec['device_ms']:.4f} ms, host {rec['host_ms']:.4f} ms, plain "
        f"{rec['plain_ms']:.4f} ms, index_select {rec['library_ms']:.4f} ms "
        f"(device {rec['library_device_ms']:.4f} ms); {rec['nbytes']} "
        f"bytes, bound {rec['bound_ms']:.4f} ms (hbm bytes)")
    return {**rec, "calls": len(calls), "shapes": per_shape}


def phase_kernels(torch, renderer, cam):
    """K1 against its plain version on the inputs that the main path's
    frame at `cam` gives it: the renderer's objects and its caps after
    the cap probe; then the binner kernel and D1 on the same frame."""
    from fourdgs_tpu_torch.ops import blend
    from fourdgs_tpu_torch.ops.rasterize_tiled import prepare_blend
    from fourdgs_tpu_torch.render.render import splats_at

    rc = renderer.raster_cfg
    cam = cam.to(renderer.device)
    with torch.no_grad(), recorded_gathers([]) as gathers:
        splats = splats_at(renderer.gauss, renderer.deform, cam,
                           renderer.aabb, renderer.sh_degree)
        proj, binned, table = prepare_blend(*splats, cam, rc,
                                            renderer.alive)
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

    def kernel():
        return blend.blend_forward(gidx, counts, table, rc)

    ms, plain_ms = time_pair(
        kernel, lambda: blend.blend_forward_plain(gidx, counts, table, rc))
    dev = device_ms(kernel)
    work = blend_work(gidx, counts, table, rc)
    instr = sum(BLEND_FP32_INSTR[k] * work[k] for k in BLEND_FP32_INSTR)
    n_rows = int(torch.unique(gidx[gidx >= 0]).numel())
    nbytes = (4 * rc.num_tiles + 4 * int(counts.sum()) + 48 * n_rows
              + 5 * 4 * rc.num_tiles * rc.pixels_per_tile)
    bounds = {"hbm bytes": nbytes / HBM_BYTES_S,
              "fp32 issue": instr / FP32_ISSUE_S,
              "mufu (expf)": work["exp"] / MUFU_OP_S}
    resource = max(bounds, key=bounds.get)
    where = {k: work.pop(k) for k in ("occupancy", "heaviest_tile",
                                      "heaviest_sub_tile", "warp_issued")}
    log(f"blend_fwd: {ms:.4f} ms/launch, device {dev['ms']:.4f} ms "
        f"{dev['kernels']}, host {dev['host_ms']:.4f} ms, plain "
        f"{plain_ms:.4f} ms; pixel x slot evaluations {work}, {instr} FP32 "
        f"instructions, {nbytes} bytes; bounds " +
        ", ".join(f"{k} {v * 1e3:.4f} ms" for k, v in bounds.items()) +
        f"; bound by {resource}")
    log(f"blend_fwd: occupancy {where['occupancy']}; heaviest tile "
        f"{where['heaviest_tile']}; heaviest sub-tile "
        f"{where['heaviest_sub_tile']}; warp-issued evaluations "
        f"{where['warp_issued']} against {work['lanes_walked']} walked and "
        f"{work['eval']} needed")
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
        "device_ms": dev["ms"],
        "device_kernels": dev["kernels"],
        "device_records": dev["records"],
        "host_ms": dev["host_ms"],
        "plain_ms": plain_ms,
        "bound_ms": bounds[resource] * 1e3,
        "bound_by": "bytes" if resource == "hbm bytes" else "operations",
        "bound_resource": resource,
        "library_ms": None,        # no single PyTorch call blends
        "evaluations": work,
        **where,
        "ok": True,
    }, {"binner": check_binner(torch, "serve", proj, rc),
        "gather_rows": check_gathers(torch, "serve", gathers)}


# ---------------------------------------------------------------------------
# phase 5: the training slice
# ---------------------------------------------------------------------------

def padded(torch, gauss, alive, capacity: int):
    """Gaussians and their alive mask in a buffer of `capacity` slots, the
    given ones first; the slots after them dead, with identity
    rotations."""
    from fourdgs_tpu_torch.models.gaussians import FIELDS, GaussianParams

    n = alive.shape[0]

    def pad(x, fill=0.0):
        out = torch.full((capacity,) + tuple(x.shape[1:]), fill,
                         dtype=x.dtype, device=x.device)
        out[:n] = x
        return out

    out = GaussianParams(**{f: pad(getattr(gauss, f)) for f in FIELDS})
    out.rotation[n:, 0] = 1.0
    return out, pad(alive, False)


def make_train_state(torch, scene, device):
    """The scene's gaussians in a capacity-TRAIN_CAPACITY buffer with the
    first N_GAUSS slots alive, and a copy of its deformation."""
    from fourdgs_tpu_torch.train.state import create_state

    cfg, gauss, alive, deform, aabb = scene
    cfg = copy.deepcopy(cfg)
    cfg.raster.capacity = TRAIN_CAPACITY
    gauss, alive = padded(torch, gauss, alive, TRAIN_CAPACITY)
    state = create_state(cfg, None, None, SPATIAL_LR_SCALE, aabb=aabb,
                         deform=copy.deepcopy(deform), gauss=gauss,
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
    from fourdgs_tpu_torch.train import graphs, loop, optim

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

    start = state.to(device)     # both modes start from this state
    key = graphs.StepKey("fine", state.capacity, rc, sh, True, 1,
                         float(cfg.opt.lambda_dssim), reg, graphs.switches())
    step_fn = loop.step_of_key(tx)       # run_stage's step of a key
    programs = graphs.StepPrograms(step_fn)
    states = {"eager": start.to(device), "captured": start.to(device)}
    del start
    run = {"eager": lambda st, c, g: step_fn(key)(st, c, g, bg),
           "captured": lambda st, c, g: programs.run(key, st, c, g, bg)}

    def step(mode, i):
        return run[mode](states[mode], [cams[i % len(cams)]],
                         gts[i % len(cams)][None])

    # ---- the main path, both modes from one state, with the launch
    # counts read around the two runs ----
    modes, after_one, launches = {}, {}, {}
    graphs.zero_counts()
    for mode in ("eager", "captured"):
        before = kernel_runs()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        auxes = []
        for i in range(steps):
            if i == UNTIMED_STEPS:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
            auxes.append(step(mode, i))
            if i == 0:
                after_one[mode] = states[mode].to(device)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        ran = kernel_runs()
        launches[mode] = {k: ran[k] - before[k] for k in PATH_KERNELS}
        ms = 1e3 * seconds / (steps - UNTIMED_STEPS)
        losses = [float(a.loss) for a in auxes]
        modes[mode] = {"ms_per_step": ms, "rays_per_s": SIZE * SIZE
                       / (ms / 1e3), "peak_mib": peak / 2**20,
                       "losses": losses}
        log(f"train {mode}: {steps} fine steps at {SIZE}x{SIZE}, {N_GAUSS} "
            f"gaussians in capacity {TRAIN_CAPACITY}, caps {rc}; {ms:.3f} "
            f"ms/step over the last {steps - UNTIMED_STEPS} = "
            f"{SIZE * SIZE / (ms / 1e3):.0f} rays/s; peak memory "
            f"{peak / 2**20:.1f} MiB; kernel runs {launches[mode]}")
        log(f"train {mode}: loss first {losses[0]:.6f}, last-5 mean "
            f"{np.mean(losses[-5:]):.6f}, psnr first "
            f"{float(auxes[0].psnr):.3f} last {float(auxes[-1].psnr):.3f}; "
            f"max dropped_pairs {max(int(a.dropped_pairs) for a in auxes)}, "
            f"max dropped_tile {max(int(a.dropped_tile) for a in auxes)}; "
            f"num_pairs {int(auxes[0].num_pairs)}")
        if not all(np.isfinite(losses)):
            raise AssertionError(f"{mode}: non-finite loss: {losses}")
        if not np.mean(losses[-5:]) < losses[0]:
            raise AssertionError(f"{mode}: the loss did not fall: {losses}")
        nan = sum(int(torch.isnan(p).sum()) for p in optim.param_leaves(
            states[mode].params))
        if nan:
            raise AssertionError(f"{mode}: {nan} NaN parameter values")

    live = programs.live.program
    gathers = HEX_GATHERS_PER_LEVEL * len(cfg.hidden.multires)
    a_step = {"blend_fwd": 1, "blend_bwd": 1, "binner": 1,
              "gather_rows": gathers}
    want = {"eager": {k: v * steps for k, v in a_step.items()},
            "captured": {k: v * (steps + graphs.WARMUP)
                         for k, v in a_step.items()}}
    runs = {mode: steps + (mode == "captured") * graphs.WARMUP
            for mode in launches}
    log("train: kernel runs a step (replays counted): " + "; ".join(
        f"{mode} " + ", ".join(f"{k} {v / runs[mode]:g}"
                               for k, v in launches[mode].items())
        for mode in launches) + f"; the captured step's launches "
        f"{live.launches}")
    if (launches != want or live.replays != steps
            or live.launches != {REPORTED[k]: v for k, v in a_step.items()}):
        raise AssertionError(f"kernel runs {launches} ({live.replays} "
                             f"replays of {live.launches}) for {steps} "
                             f"steps a mode, not {want}")

    # ---- the captured step against the eager one: every leaf after one
    # step, and the losses of the whole run ----
    def leaves(st):
        return (optim.param_leaves(st.params)
                + optim.moment_leaves(st.opt_state.mu)
                + optim.moment_leaves(st.opt_state.nu)
                + [st.xyz_gradient_accum, st.denom, st.max_radii2d])
    one_step = max(grads_agree(a.detach(), b.detach()) for a, b in zip(
        leaves(after_one["captured"]), leaves(after_one["eager"]),
        strict=True))
    le = np.array(modes["eager"]["losses"])
    lc = np.array(modes["captured"]["losses"])
    loss_err = float(np.max(np.abs(lc - le) / np.abs(le)))
    log(f"train: captured against eager: after one step, every leaf "
        f"within {one_step:.3g} normalised (tol {GRAD_TOL:g}); losses of "
        f"the {steps} steps within {loss_err:.3g} relative (tol "
        f"{STEP_LOSS_RTOL:g})")
    if not one_step <= GRAD_TOL:
        raise AssertionError(f"captured step leaves off by {one_step}")
    if not loss_err <= STEP_LOSS_RTOL:
        raise AssertionError(f"captured losses off by {loss_err}")
    del after_one

    # ---- both modes profiled: spans (eager only: a replay opens none),
    # syncs, copies from the host, graph launches, kernel time ----
    state = states["eager"]
    for mode in ("captured", "eager"):
        it = iter(range(PROFILED_STEPS))
        prof = profile_calls(lambda: step(mode, next(it)), PROFILED_STEPS,
                             spans=TRAIN_SPANS, label="step")
        modes[mode].update(host_calls(prof, "step"),
                           runtime_calls=prof["runtime_calls_per_step"])
        if mode == "eager":
            modes[mode]["spans"] = prof["spans"]
            log("train eager: kernels a step by span: " + ", ".join(
                f"{k} {prof['spans'][k]['kernel_ms']:.4f} ms"
                for k in ("render.splats", "raster.bin")))
    modes["captured"].update(replays=live.replays, capture_s=live.seconds)
    for mode, m in modes.items():
        log(f"train {mode}: per step: syncs {m['syncs']:g}, copies from the "
            f"host {m['copies_from_host']:g}, graph launches "
            f"{m['graph_launches']:g}, kernel launches "
            f"{m['kernel_launches']:g}, kernels {m['kernel_ms']:.3f} ms, "
            f"device busy {100 * m['device_busy_share']:.1f}%"
            + (f"; {m['replays']} replays, captured in {m['capture_s']:.3f} "
               f"s" if mode == "captured" else ""))
    if modes["captured"]["syncs"] or modes["captured"]["copies_from_host"]:
        raise AssertionError(f"a replayed step synced or copied from the "
                             f"host: {modes['captured']}")
    launches = {k: launches["eager"][k] + launches["captured"][k]
                for k in PATH_KERNELS}

    # ---- one step's gradients with K2 and with the plain backward, on
    # each training view and the kernel check's view ----
    def grads(cam, gt):
        sg = loop.step_gradients(state, [cam], gt[None], bg, sh, **kw)
        return [x for x in sg.grads + [sg.ndc_grad] if x is not None]

    errs = []
    for view, (cam, gt) in enumerate(zip(cams + [check_cam], gts)):
        with_k2 = grads(cam, gt)
        with plain_version("blend_backward"):
            plain = grads(cam, gt)
        leaf_errs = [grads_agree(a, b) for a, b in zip(with_k2, plain)]
        errs.append(max(leaf_errs))
        if not errs[-1] <= GRAD_TOL:
            leaf = int(np.argmax(leaf_errs))
            raise AssertionError(
                f"K2 step gradients disagree on view {view}: {errs[-1]} in "
                f"leaf {leaf} of shape {tuple(plain[leaf].shape)}")
    log(f"train: one step's gradients, K2 vs plain backward on the card: "
        f"{len(plain)} leaves, normalised max abs err per view "
        f"{', '.join(f'{e:.3g}' for e in errs)} (tol {GRAD_TOL:g})")
    return state, rc, bg, sh, check_cam, gts[-1], launches, {
        **modes, "captured_vs_eager": {"one_step_leaves": one_step,
                                       "losses": loss_err},
        "step_grad_errs": errs}


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
    with torch.no_grad(), recorded_gathers([]) as gathers:
        splats = splats_at(g, state.params["deform"], cam, state.aabb, sh)
        proj, binned, table = prepare_blend(*splats, cam, rc, state.alive)
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

    def kernel():
        return blend.blend_backward(*args)

    ms, plain_ms = time_pair(kernel,
                             lambda: blend.blend_backward_plain(*args),
                             launches=20)
    dev = device_ms(kernel)
    work = blend_work(gidx, counts, table, rc)
    sums = bwd_work(gidx, counts, table, rc)
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
    # the atomics, reduced batches and block chunks that K2's counting
    # build tallies on this input; the timed build is the same kernel
    # without the tally
    tally = torch.zeros(3, dtype=torch.int64, device=table.device)
    counted = blend.blend_backward(*args, tally=tally)
    torch.cuda.synchronize()
    atomics, batches, chunks = tally.tolist()
    count_err = float(((counted - ref).abs() / scale).max())
    if not count_err <= GRAD_TOL:
        raise AssertionError(f"K2's counting build disagrees: {count_err}")
    # what the counts imply: 45 shuffles a reduced batch, no shared
    # atomics, and at most five float2 atomics a slot a 16 x 8 sub-tile
    # used (a pair whose sum is zero issues none); the first K2 took ten
    # shuffle sums of 5 steps and ten shared atomics per slot a 32-pixel
    # warp used, and ten float atomics per slot a tile used
    first = {"atomics": {"global": 10 * sums["block_slots"]["tile"],
                         "shared": 10 * sums["warp_slots"]["row"]},
             "shuffles": 50 * sums["warp_slots"]["row"]}
    log(f"blend_bwd: {ms:.4f} ms/launch, device {dev['ms']:.4f} ms "
        f"{dev['kernels']}, host {dev['host_ms']:.4f} ms, plain "
        f"{plain_ms:.4f} ms; pixel x slot work {work}; {instr} FP32 "
        f"instructions, {mufu} MUFU, {nbytes} bytes; bounds " +
        ", ".join(f"{k} {v * 1e3:.4f} ms" for k, v in bounds.items()) +
        f"; bound by {resource}")
    log(f"blend_bwd: sums over pixels {sums}; counted by the kernel: "
        f"{atomics} float2 atomics (at most "
        f"{5 * sums['block_slots']['sub_tile']}), 0 shared, {batches} "
        f"batches reduced, so {45 * batches} warp shuffles; {chunks} "
        f"chunks walked by its sub-tile blocks (blend_work's walk: "
        f"{work['block_chunks']['sub_tile']}); the first design's at these "
        f"counts: {first}; counting build's normalised max abs err "
        f"{count_err:.3g}")
    return {
        "name": "blend_bwd",
        "route": "cuda",
        "source": "fourdgs_tpu_torch/csrc/blend_bwd.cu",
        "replaces": "fourdgs_tpu/ops/pallas/blend.py:197",
        "tpu_kernel": "fourdgs_tpu/ops/pallas/blend.py:_bwd_fused_kernel",
        "max_abs_err": abs_err,
        "max_normalised_err": max(col_err),
        "ms": ms,
        "device_ms": dev["ms"],
        "device_kernels": dev["kernels"],
        "device_records": dev["records"],
        "host_ms": dev["host_ms"],
        "plain_ms": plain_ms,
        "bound_ms": bounds[resource] * 1e3,
        "bound_by": "bytes" if resource == "hbm bytes" else "operations",
        "bound_resource": resource,
        "library_ms": None,   # no single PyTorch call computes it
        "evaluations": work,
        "sums": sums,
        "float2_atomics": atomics,
        "reduced_batches": batches,
        "block_chunks": chunks,
        "ok": True,
    }, args, work, {"binner": check_binner(torch, "step", proj, rc),
                    "gather_rows": check_gathers(torch, "step", gathers)}


# ---------------------------------------------------------------------------
# phase 7: the training driver with the per-slot path's switches
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def switches_set(values: dict):
    """Set environment variables for a block, and restore them after."""
    saved = {k: os.environ.get(k) for k in values}
    os.environ.update(values)
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def kernel_runs() -> dict:
    """The kernels that ran, launched by the host or by graph replays
    (train/graphs.py:kernel_runs), by the names the kernels line reports
    them under."""
    from fourdgs_tpu_torch.train import graphs
    runs = graphs.kernel_runs()
    return {name: runs[wrapper] for name, wrapper in REPORTED.items()}


def surgery_counts(events, start: int):
    """The live count after each densify, prune and grow, and how many
    densify calls grew it."""
    counts, grew, last = [], 0, start
    for e in events:
        if e["kind"] in ("densify", "prune", "grow", "rollback"):
            counts.append((e["iter"], e["kind"], e["points"]))
            grew += e["kind"] == "densify" and e["points"] > last
            last = e["points"]
    return counts, grew


def as_run_eval(torch, renderer, raster_cfg: dict, capacity: int,
                caps: dict):
    """The Renderer as the run's eval renders a view: the snapshot's
    gaussians in a buffer of the run's capacity, since the binner's pair
    budget is ceil(buffer / bin_chunk) x bin_pairs_per_chunk slots, at the
    run's final raster config with the caps that the eval grew on the
    view. The buffer keeps the run's order of the live gaussians, so the
    binner makes and drops the same pairs."""
    from fourdgs_tpu_torch.ops.rasterize_tiled import RasterConfig

    gauss, alive = padded(torch, renderer.gauss, renderer.alive, capacity)
    rc = dataclasses.replace(RasterConfig(**raster_cfg),
                             tile_cap=caps["tile_cap"],
                             bin_pairs_per_chunk=caps["bin_pairs_per_chunk"])
    return dataclasses.replace(renderer, gauss=gauss, alive=alive,
                               raster_cfg=rc)


def render_drops(out, rc) -> dict:
    """What a render dropped, at which caps."""
    return {"dropped_pairs": int(out.dropped_pairs),
            "dropped_tile": int(out.dropped_tile),
            "num_pairs": int(out.num_pairs), "tile_cap": rc.tile_cap,
            "bin_pairs_per_chunk": rc.bin_pairs_per_chunk}


def phase_driver(torch, device, work: Path, coarse: int, fine: int,
                 seed: int):
    """The training CLI through both stages with the per-slot path, its
    resume, and the Renderer on the trained snapshot. Returns the launch
    counts of the whole phase and what it measured."""
    from fourdgs_tpu_torch.data.blender import read_cameras_from_transforms
    from fourdgs_tpu_torch.data.blender import read_timeline
    from fourdgs_tpu_torch.data.scene import camera_from_info
    from fourdgs_tpu_torch.ops import losses
    from fourdgs_tpu_torch.render.serve import Renderer
    from fourdgs_tpu_torch.tools import make_synthetic_scene
    from fourdgs_tpu_torch.tools import train as train_cli
    from fourdgs_tpu_torch.train import checkpoint, graphs

    scene, model = work / "scene", work / "driver"
    resumed = work / "driver_resume"
    for d in (model, resumed):
        shutil.rmtree(d, ignore_errors=True)
    t0 = time.perf_counter()
    make_synthetic_scene.main([str(scene), "--size", str(DRIVER_SIZE),
                               "--n_train", str(DRIVER_VIEWS[0]),
                               "--n_test", str(DRIVER_VIEWS[1]),
                               "--device", device.type])
    torch.cuda.synchronize()
    log(f"driver: synthetic scene {DRIVER_VIEWS[0]} + {DRIVER_VIEWS[1]} "
        f"views at {DRIVER_SIZE}x{DRIVER_SIZE} in "
        f"{time.perf_counter() - t0:.2f} s")
    config = work / "dnerf_smoke.py"
    config.write_text(DRIVER_CONFIG.format(coarse=coarse, fine=fine))
    ckpt_it = fine - RESUME_ITERS
    common = ["-s", str(scene), "--configs", str(config), "--quiet",
              "--seed", str(seed), "--device", device.type]

    # ---- the main path, with the launch counts read around it ----
    with switches_set(SWITCHES):
        torch.cuda.synchronize()
        graphs.zero_counts()
        t0 = time.perf_counter()
        summary = train_cli.main(common + [
            "-m", str(model), "--test_iterations", str(coarse), str(fine),
            "--save_iterations", str(fine),
            "--checkpoint_iterations", str(ckpt_it)])
        t_train = time.perf_counter() - t0
        t0 = time.perf_counter()
        resume = train_cli.main(common + [
            "-m", str(resumed), "--test_iterations", str(fine),
            "--start_checkpoint", str(model / f"chkpnt_fine_{ckpt_it}.npz")])
        t_resume = time.perf_counter() - t0
        renderer = Renderer.from_snapshot(str(model), device=device,
                                          width=DRIVER_SIZE,
                                          height=DRIVER_SIZE)
        mapper, _ = read_timeline(str(scene))
        test0 = read_cameras_from_transforms(
            str(scene), "transforms_test.json", True, ".png", mapper,
            (DRIVER_SIZE, DRIVER_SIZE))[0]
        test_cam = camera_from_info(test0, device)
        out = renderer.render(test_cam)
        # the same view as the run's eval rendered it (its last record)
        with open(model / "train_log.jsonl") as f:
            last_eval = [r for r in map(json.loads, f)
                         if r.get("eval") == "test"][-1]
        twin = as_run_eval(torch, renderer, summary["stages"][-1]["raster_cfg"],
                           last_eval["capacity"],
                           last_eval["render_per_view"][0])
        twin_out = twin.render(test_cam)
        torch.cuda.synchronize()
        launches = kernel_runs()

    # ---- what the run reports, and its checks ----
    stats = {"seconds_train_cli": t_train, "seconds_resume_cli": t_resume,
             "stages": {}}
    for st in summary["stages"]:
        n_it = st["iterations"] - st["start"]
        hist = st["history"]
        counts, grew = surgery_counts(st["events"], hist[0]["points"])
        kinds = [e["kind"] for e in st["events"]]
        rec = {"iterations": n_it, "ms_per_iteration":
               1e3 * st["wall_time"] / n_it,
               "iterations_per_s": n_it / st["wall_time"],
               "loss_first": hist[0]["loss"], "loss_last": hist[-1]["loss"],
               "points_last": hist[-1]["points"],
               "capacity_last": hist[-1]["capacity"],
               "test_psnr": st["test_psnr"], "active_sh": st["active_sh"],
               "peak_mib": (st["peak_bytes"] or 0) / 2**20,
               "densify_grew": grew, "events": {k: kinds.count(k)
                                                for k in sorted(set(kinds))},
               "tile_cap": st["raster_cfg"]["tile_cap"]}
        g = st["graphs"]
        rec["graphs"] = {
            "captures": len(g["captures"]),
            "recaptures": len(g["captures"]) - 1,
            "rebinds": g["rebinds"], "replays": g["replays"],
            "capture_s": sum(c["seconds"] for c in g["captures"]),
            "capture_s_per_key": [(c["key"], c["seconds"])
                                  for c in g["captures"]]}
        stats["stages"][st["stage"]] = rec
        log(f"driver {st['stage']}: {n_it} iterations, "
            f"{rec['ms_per_iteration']:.3f} ms/iteration "
            f"({rec['iterations_per_s']:.2f} it/s); loss first (it "
            f"{hist[0]['iter']}) {hist[0]['loss']:.6f}, last (it "
            f"{hist[-1]['iter']}) {hist[-1]['loss']:.6f}; test PSNR "
            f"{st['test_psnr']}; SH degree {st['active_sh']}; peak memory "
            f"{rec['peak_mib']:.1f} MiB; events {rec['events']}")
        log(f"driver {st['stage']}: live count after each surgery "
            f"(iteration, kind, points): {counts}")
        gr = rec["graphs"]
        log(f"driver {st['stage']}: captured steps: {gr['captures']} "
            f"captures ({gr['recaptures']} recaptures), {gr['rebinds']} "
            f"rebinds, {gr['replays']} replays, {gr['capture_s']:.2f} s "
            f"capturing")
        for key, sec in gr["capture_s_per_key"]:
            log(f"driver {st['stage']}:   {key}: {sec:.3f} s")
    (res_stage,) = resume["stages"]
    log(f"driver resume: fine from iteration {res_stage['start']} to "
        f"{res_stage['iterations']}, {t_resume:.2f} s; loss last "
        f"{res_stage['history'][-1]['loss']:.6f}; test PSNR "
        f"{res_stage['test_psnr']}")
    gt0 = torch.from_numpy(test0.image).to(device)[None]

    def psnr_of(o):
        return float(losses.psnr(torch.clamp(o.color, 0, 1)[None], gt0)[0])

    psnr, twin_psnr = psnr_of(out), psnr_of(twin_out)
    fine_eval = summary["stages"][-1]["test_psnr"][-1][1]
    view0 = last_eval["psnr_per_view"][0]
    drops = {"renderer": render_drops(out, renderer.raster_cfg),
             "run's eval": last_eval["render_per_view"][0],
             "renderer at the eval's caps": render_drops(twin_out,
                                                         twin.raster_cfg)}
    log(f"driver: Renderer on the trained snapshot (iteration "
        f"{renderer.iteration}, {int(renderer.alive.sum())} points): test "
        f"view 0 PSNR {psnr:.4f} dB at its probed caps, {twin_psnr:.4f} dB "
        f"at the eval's caps in the run's capacity "
        f"{last_eval['capacity']}; the run's eval of it {view0:.4f} dB "
        f"(mean over the test views {fine_eval:.4f}); CLI {t_train:.2f} s; "
        f"launches {launches}")
    for name, d in drops.items():
        log(f"driver: test view 0, {name}: dropped_pairs "
            f"{d['dropped_pairs']}, dropped_tile {d['dropped_tile']}, "
            f"num_pairs {d['num_pairs']}; tile_cap {d['tile_cap']}, "
            f"bin_pairs_per_chunk {d['bin_pairs_per_chunk']}")

    co, fi = stats["stages"]["coarse"], stats["stages"]["fine"]
    ev = {k: co["events"].get(k, 0) + fi["events"].get(k, 0)
          for k in ("densify", "prune", "reset_opacity", "resize")}
    checks = {
        "three densify calls grew the count":
            co["densify_grew"] + fi["densify_grew"] >= 3,
        "a prune": ev["prune"] >= 1,
        "an opacity reset": ev["reset_opacity"] >= 1,
        "a bucket change": ev["resize"] >= 1,
        "the SH ramp": fi["active_sh"] >= 1,
        "test evaluations": bool(co["test_psnr"]) and bool(fi["test_psnr"]),
        "the loss fell": fi["loss_last"] < co["loss_first"],
        "a snapshot": (model / "point_cloud" / f"iteration_{fine}").is_dir(),
        "a checkpoint": (model / f"chkpnt_fine_{ckpt_it}.npz").exists(),
        "the resume ran to the end":
            res_stage["start"] == ckpt_it
            and res_stage["history"][-1]["iter"] == fine,
        "the render matches the run's eval":
            abs(twin_psnr - view0) <= RENDER_PSNR_TOL,
        "every iteration replayed a captured step":
            co["graphs"]["replays"] == co["iterations"]
            and fi["graphs"]["replays"] == fi["iterations"],
    }
    gauss, flat, _ = checkpoint.load_snapshot(
        str(model / "point_cloud" / f"iteration_{fine}"))
    checks["no NaN parameter"] = all(
        np.isfinite(v).all() for v in list(gauss.values())
        + list(flat.values()))
    for kernel in ("blend_fwd", "blend_bwd_slots", "scatter_add_rows",
                   "scatter_set_scalars", "binner", "gather_rows"):
        checks[f"{kernel} launched"] = launches[kernel] > 0
    failed = [k for k, ok in checks.items() if not ok]
    log(f"driver checks: {len(checks) - len(failed)}/{len(checks)} hold"
        + (f"; FAILED: {failed}" if failed else ""))
    if failed:
        raise AssertionError(f"driver phase: {failed}")
    stats.update(render_psnr=psnr, render_psnr_at_eval_caps=twin_psnr,
                 eval_psnr_view0=view0, test_view0_drops=drops)
    return launches, stats


# ---------------------------------------------------------------------------
# phase 8: K3, K4 and K5 against their plain versions
# ---------------------------------------------------------------------------

def scatter_rel_err(a, b) -> float:
    return float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)


def host_ms(fn, n: int = 200) -> float:
    """The host's ms per call to enqueue fn: n calls on the host clock
    with no synchronize inside, after one call and a drain."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    ms = (time.perf_counter() - t0) / n * 1e3
    torch.cuda.synchronize()
    return ms


def device_ms(fn, n: int = 20) -> dict:
    """Device ms per call of fn, fills and copies included, summed over
    the kernels torch.profiler sees, with the breakdown by name; the
    records the profiler kept of those the host launched over n calls
    (`records`; where it kept fewer, each kernel's time is the mean of
    the records it kept times its launches a call, and the reading is
    flagged in the log); and the host's ms per call to enqueue it, what
    events time when it is the larger. Where the profiler kept no record
    in any window, the time is `held_stream_ms`'s, flagged in the log and
    under `records["held_stream"]`."""
    try:
        records, launched = kernel_records(fn, n)
    except NoKernelRecords as e:
        held = held_stream_ms(fn, n)
        log(f"device_ms: {e}; timed instead by {HELD_STREAM}: {held:.4f} "
            f"ms a call")
        return {"ms": held, "host_ms": host_ms(fn),
                "kernels": {HELD_STREAM: round(held, 5)},
                "records": {"kept": {}, "launched": e.launched,
                            "held_stream": True}}
    kernels = per_call_ms(records, n)
    kept = {k: len(v) for k, v in records.items()}
    if sum(kept.values()) != launched:
        log(f"device_ms: the profiler kept {sum(kept.values())} records "
            f"{kept} of the {launched} the host launched over {n} calls; "
            f"those kernels' times are estimated from the kept records")
    return {"ms": sum(kernels.values()), "host_ms": host_ms(fn),
            "kernels": {k: round(v, 5) for k, v in kernels.items()},
            "records": {"kept": kept, "launched": launched}}


def k3_counts(torch, args, got, occupied, k2: dict, modelled: int) -> dict:
    """What K3's counting build tallies on `args`: its table must be the
    timed build's `got` bit for bit on the rows it writes (`occupied`), its
    float2 stores five a row of those, and its reduced warp batches those
    of K2's counting build (`k2`, phase 6's entry; the same replay). It
    also counts the chunks its blocks walk, which the coupled exit holds
    at or above K2's; `modelled` is blend_work's walk of them."""
    from fourdgs_tpu_torch.ops import blend
    tally = torch.zeros(3, dtype=torch.int64, device=got.device)
    counted = blend.blend_backward_slots(*args, tally=tally)
    torch.cuda.synchronize()
    stored, batches, chunks = tally.tolist()
    written = int(occupied.sum())
    log(f"blend_bwd_slots: counted by the kernel: {stored} float2 stores "
        f"(5 x {written} rows), {batches} batches reduced (K2's "
        f"{k2['reduced_batches']}), {chunks} chunks walked by its blocks "
        f"against K2's {k2['block_chunks']} (the coupled exit: "
        f"{chunks / k2['block_chunks'] - 1:.2%} more; blend_work's walk: "
        f"{modelled})")
    if not torch.equal(counted[occupied], got[occupied]):
        raise AssertionError("K3's counting build's table differs")
    if (batches != k2["reduced_batches"] or stored != 5 * written
            or chunks < k2["block_chunks"]):
        raise AssertionError(
            f"K3 counted {stored} stores, {batches} batches and {chunks} "
            f"block chunks, not {5 * written}, {k2['reduced_batches']} and "
            f"at least {k2['block_chunks']}")
    return {"float2_stores": stored, "reduced_batches": batches,
            "block_chunks": chunks}


def occupied_rows(torch, counts, rc):
    """(num_tiles, tile_cap) mask of the rows of each tile's occupied
    chunks, the rows K3 writes."""
    ends = (counts.long() + rc.chunk - 1) // rc.chunk * rc.chunk
    return (torch.arange(rc.tile_cap, device=counts.device)[None]
            < ends[:, None])


def phase_kernels_slots(torch, args, work_k2, state, rc, bg, sh, cam, gt,
                        launches: dict, k2: dict) -> list:
    """K3 on phase 6's step input, K4 at the reduction's and a HexPlane
    plane's shapes, K5 at the binner's, and one step's gradients through
    K3 + K4 against K2's (`k2`: phase 6's entry, with its counts)."""
    from fourdgs_tpu_torch.models import hexplane
    from fourdgs_tpu_torch.ops import blend, rasterize_tiled, scatter
    from fourdgs_tpu_torch.ops.rasterize_tiled import prepare_blend
    from fourdgs_tpu_torch.render.render import splats_at
    from fourdgs_tpu_torch.train import loop

    gidx, counts, table = args[0], args[1], args[2]
    n = table.shape[0] - 1
    # ---- K3 ----
    got = blend.blend_backward_slots(*args)
    ref = blend.blend_backward_slots_plain(*args)
    torch.cuda.synchronize()
    used = gidx >= 0
    g, r = got[used], ref[used]
    scale = r.abs().amax(dim=0).clamp(min=1e-30)
    col_err = ((g - r).abs() / scale).amax(dim=0).tolist()
    log("kernel blend_bwd_slots vs plain over the slots with gidx >= 0: "
        "normalised max abs err per column " +
        ", ".join(f"{c} {e:.3g}" for c, e in zip(GRAD_COLUMNS, col_err)) +
        f" (tol {GRAD_TOL:g})")
    if not max(col_err) <= GRAD_TOL:
        raise AssertionError(f"blend_bwd_slots disagrees: {col_err}")
    # the rows it writes: each slot of the tiles' occupied chunks, zero
    # past the count, and the same twice (no atomics)
    occupied = occupied_rows(torch, counts, rc)
    again = blend.blend_backward_slots(*args)
    torch.cuda.synchronize()
    if bool(got[occupied & ~used].any()):
        raise AssertionError("K3 wrote a nonzero row past a tile's count")
    if not torch.equal(again[occupied], got[occupied]):
        raise AssertionError("K3 gave two tables on one input")

    def kernel():
        return blend.blend_backward_slots(*args)

    ms3, plain3 = time_pair(kernel,
                            lambda: blend.blend_backward_slots_plain(*args),
                            launches=20)
    dev3 = device_ms(kernel)
    instr = (sum(BLEND_BWD_FP32_INSTR[k] * work_k2[k]
                 for k in BLEND_BWD_FP32_INSTR) + 10 * work_k2["used"])
    mufu = work_k2["exp"] + 2 * work_k2["used"]
    n_rows = int(torch.unique(gidx[used]).numel())
    pixels = rc.num_tiles * rc.pixels_per_tile
    written = int(occupied.sum())
    nbytes = (4 * rc.num_tiles + 4 * int(counts.sum()) + 48 * n_rows
              + 10 * 4 * pixels + 4 * blend.GRAD_W * written)
    bounds = {"hbm bytes": nbytes / HBM_BYTES_S,
              "fp32 issue": instr / FP32_ISSUE_S,
              "mufu (expf, 2 rcp)": mufu / MUFU_OP_S}
    res3 = max(bounds, key=bounds.get)
    log(f"blend_bwd_slots: {ms3:.4f} ms/launch, device {dev3['ms']:.4f} ms "
        f"{dev3['kernels']}, host {dev3['host_ms']:.4f} ms, plain "
        f"{plain3:.4f} ms; table {tuple(got.shape)}, {written} rows "
        f"written; {instr} FP32 instructions, {nbytes} bytes; bounds " +
        ", ".join(f"{k} {v * 1e3:.4f} ms" for k, v in bounds.items()) +
        f"; bound by {res3}")
    # the coupled exit: a tile's cluster walks a chunk while any of its
    # sub-tiles has a live pixel, K2's sub-tile block while one of its own
    subs = (rc.tile_size // 16) * (rc.tile_size // 8)
    modelled = subs * work_k2["block_chunks"]["tile"]
    k3 = {"name": "blend_bwd_slots", "route": "cuda",
          "source": "fourdgs_tpu_torch/csrc/blend_bwd.cu",
          "replaces": "fourdgs_tpu/ops/pallas/blend.py:115",
          "tpu_kernel": "fourdgs_tpu/ops/pallas/blend.py:_bwd_kernel",
          "launches": launches["blend_bwd_slots"],
          "max_abs_err": float((g - r).abs().max()),
          "max_normalised_err": max(col_err), "ms": ms3,
          "device_ms": dev3["ms"], "device_kernels": dev3["kernels"],
          "device_records": dev3["records"],
          "host_ms": dev3["host_ms"], "plain_ms": plain3,
          "bound_ms": bounds[res3] * 1e3,
          "bound_by": "bytes" if res3 == "hbm bytes" else "operations",
          "bound_resource": res3, "library_ms": None,
          **k3_counts(torch, args, got, occupied, k2, modelled), "ok": True}

    # ---- K4: the reduction's shapes and a HexPlane plane's ----
    flat = gidx.reshape(-1)
    red_idx = torch.where(flat >= 0, flat, n).to(torch.int32)
    red_rows = got.reshape(-1, blend.GRAD_W)
    gauss = state.params["gauss"]
    plane = state.params["deform"].grid.planes["l1_p0"]     # x-y, level 1
    h, w, c = plane.shape
    pts = hexplane.normalize_aabb(gauss.xyz.detach(), state.aabb)
    x0, _ = hexplane._axis_coord(pts[:, 0], w)
    y0, _ = hexplane._axis_coord(pts[:, 1], h)
    hex_idx = (y0 * w + x0).to(torch.int32)
    gen = torch.Generator(device=table.device).manual_seed(7)
    hex_rows = torch.randn((hex_idx.shape[0], c), generator=gen,
                           device=table.device)
    # the blend reduction's sacrificial row n takes the rows past each
    # tile's occupied chunks, which K3 leaves unwritten: it is compared on
    # its first n rows, as the reduction keeps them
    k4_cases = {"blend reduction": (red_idx, red_rows, n + 1, n),
                "hexplane l1_p0": (hex_idx, hex_rows, h * w, h * w)}
    k4_rec = {}
    for label, (idx, rows, n_out, keep) in k4_cases.items():
        a = scatter.scatter_add_rows(idx, rows, n_out=n_out)[:keep]
        b = scatter.scatter_add_rows_plain(idx, rows, n_out=n_out)[:keep]
        torch.cuda.synchronize()
        err = scatter_rel_err(a, b)
        ms, plain_ms = time_pair(
            lambda: scatter.scatter_add_rows(idx, rows, n_out=n_out),
            lambda: scatter.scatter_add_rows_plain(idx, rows, n_out=n_out))
        def library():
            return torch.zeros((n_out, rows.shape[1]),
                               device=rows.device).index_add_(0, idx.long(),
                                                              rows)

        lib_ms = time_call(library)
        dev = device_ms(lambda: scatter.scatter_add_rows(idx, rows,
                                                         n_out=n_out))
        lib_dev = device_ms(library)
        nbytes = 4 * idx.numel() + 4 * rows.numel() + 4 * n_out * rows.shape[1]
        bound = nbytes / HBM_BYTES_S * 1e3
        log(f"kernel scatter_add_rows ({label}): idx {tuple(idx.shape)}, rows "
            f"{tuple(rows.shape)} -> ({n_out}, {rows.shape[1]}); max |a-b| / "
            f"max |b| {err:.3g} (tol {SCATTER_TOL:g}); {ms:.4f} ms/launch, "
            f"device {dev['ms']:.4f} ms {dev['kernels']}, host "
            f"{dev['host_ms']:.4f} ms, plain {plain_ms:.4f} ms, index_add_ "
            f"{lib_ms:.4f} ms (device {lib_dev['ms']:.4f} ms "
            f"{lib_dev['kernels']}, host {lib_dev['host_ms']:.4f} ms); "
            f"{nbytes} bytes, "
            f"bound {bound:.4f} ms (hbm bytes)")
        if not err <= SCATTER_TOL:
            raise AssertionError(f"scatter_add_rows ({label}) disagrees: "
                                 f"{err}")
        k4_rec[label] = {"max_rel_err": err,
                         "max_abs_err": float((a - b).abs().max()),
                         "ms": ms, "device_ms": dev["ms"],
                         "device_kernels": dev["kernels"],
                         "device_records": dev["records"],
                         "host_ms": dev["host_ms"],
                         "plain_ms": plain_ms, "library_ms": lib_ms,
                         "library_device_ms": lib_dev["ms"],
                         "library_device_kernels": lib_dev["kernels"],
                         "library_device_records": lib_dev["records"],
                         "library_host_ms": lib_dev["host_ms"],
                         "bound_ms": bound,
                         "shape": [int(idx.numel()), int(rows.shape[1]),
                                   int(n_out)]}
    main4 = k4_rec["blend reduction"]
    k4 = {"name": "scatter_add_rows", "route": "cuda",
          "source": "fourdgs_tpu_torch/csrc/scatter.cu",
          "replaces": "fourdgs_tpu/ops/pallas/scatter.py:26",
          "tpu_kernel": "fourdgs_tpu/ops/pallas/scatter.py:scatter_add_rows",
          "launches": launches["scatter_add_rows"],
          "max_abs_err": max(v["max_abs_err"] for v in k4_rec.values()),
          "max_rel_err": max(v["max_rel_err"] for v in k4_rec.values()),
          "ms": main4["ms"], "device_ms": main4["device_ms"],
          "host_ms": main4["host_ms"], "plain_ms": main4["plain_ms"],
          "bound_ms": main4["bound_ms"], "bound_by": "bytes",
          "library_ms": main4["library_ms"], "cases": k4_rec, "ok": True}

    # ---- K5: the binner's pairs on the step's frame ----
    captured = {}
    real = rasterize_tiled.scatter_set_scalars

    def capture(idx, val, *, n_out):
        captured.update(idx=idx.clone(), val=val.clone(), n_out=n_out)
        return real(idx, val, n_out=n_out)

    rasterize_tiled.scatter_set_scalars = capture
    try:
        with switches_set({"FOURDGS_BIN_SCATTER": "pallas"}), \
                torch.no_grad():
            splats = splats_at(gauss, state.params["deform"], cam, state.aabb,
                               sh)
            _, binned, _ = prepare_blend(*splats, cam, rc, state.alive)
    finally:
        rasterize_tiled.scatter_set_scalars = real
    idx, val, n_out = captured["idx"], captured["val"], captured["n_out"]
    if not torch.equal(binned.gidx.reshape(-1), gidx.reshape(-1)):
        raise AssertionError("the binner's gidx through K5 differs from the "
                             "default binner's")
    a = scatter.scatter_set_scalars(idx, val, n_out=n_out)
    b = scatter.scatter_set_scalars_plain(idx, val, n_out=n_out)
    torch.cuda.synchronize()
    equal = bool(torch.equal(a, b))
    ms5, plain5 = time_pair(
        lambda: scatter.scatter_set_scalars(idx, val, n_out=n_out),
        lambda: scatter.scatter_set_scalars_plain(idx, val, n_out=n_out))
    safe = torch.clamp(idx, max=n_out).long()

    def library():
        buf = torch.full((n_out + 1,), -1, dtype=torch.int32,
                         device=idx.device)
        buf[safe] = val
        return buf

    lib5 = time_call(library)
    dev5 = device_ms(lambda: scatter.scatter_set_scalars(idx, val,
                                                         n_out=n_out))
    lib_dev5 = device_ms(library)
    # the pieces of a call's host path: the launch function alone (fill
    # and scatter into a made buffer), the two ways to name the stream,
    # the two allocations
    from fourdgs_tpu_torch.ops._build import load_library
    lib, out = load_library(), idx.new_empty(n_out)
    stream = torch._C._cuda_getCurrentRawStream(idx.get_device())
    pieces = {
        "launch function": lambda: lib.scatter_set_scalars_launch(
            idx.data_ptr(), val.data_ptr(), idx.numel(), n_out,
            out.data_ptr(), stream),
        "current_stream().cuda_stream":
            lambda: torch.cuda.current_stream().cuda_stream,
        "_cuda_getCurrentRawStream":
            lambda: torch._C._cuda_getCurrentRawStream(idx.get_device()),
        "torch.empty": lambda: torch.empty((n_out,), dtype=torch.int32,
                                           device=idx.device),
        "new_empty": lambda: idx.new_empty(n_out),
        "torch.full": lambda: torch.full((n_out + 1,), -1,
                                         dtype=torch.int32,
                                         device=idx.device)}
    host5 = {k: host_ms(f) for k, f in pieces.items()}
    log("host ms a call of the pieces of K5's path: " + ", ".join(
        f"{k} {v:.4f}" for k, v in host5.items()))
    nbytes5 = 8 * idx.numel() + 4 * n_out
    bound5 = nbytes5 / HBM_BYTES_S * 1e3
    log(f"kernel scatter_set_scalars (binner): {idx.numel()} pairs -> "
        f"{n_out} slots, {int((idx >= n_out).sum())} past tile_cap; equal "
        f"{equal}; {ms5:.4f} ms/launch, device {dev5['ms']:.4f} ms "
        f"{dev5['kernels']}, host {dev5['host_ms']:.4f} ms, plain "
        f"{plain5:.4f} ms, indexed assignment {lib5:.4f} ms (device "
        f"{lib_dev5['ms']:.4f} ms {lib_dev5['kernels']}, host "
        f"{lib_dev5['host_ms']:.4f} ms); {nbytes5} bytes, bound "
        f"{bound5:.4f} ms "
        f"(hbm bytes)")
    if not equal:
        raise AssertionError("scatter_set_scalars disagrees with plain")
    k5 = {"name": "scatter_set_scalars", "route": "cuda",
          "source": "fourdgs_tpu_torch/csrc/scatter.cu",
          "replaces": "fourdgs_tpu/ops/pallas/scatter.py:73",
          "tpu_kernel":
              "fourdgs_tpu/ops/pallas/scatter.py:scatter_set_scalars",
          "launches": launches["scatter_set_scalars"], "max_abs_err": 0.0,
          "ms": ms5, "device_ms": dev5["ms"],
          "device_kernels": dev5["kernels"],
          "device_records": dev5["records"], "host_ms": dev5["host_ms"],
          "plain_ms": plain5,
          "bound_ms": bound5, "bound_by": "bytes", "library_ms": lib5,
          "library_device_ms": lib_dev5["ms"],
          "library_device_kernels": lib_dev5["kernels"],
          "library_device_records": lib_dev5["records"],
          "library_host_ms": lib_dev5["host_ms"], "host_pieces_ms": host5,
          "ok": True}

    # ---- one step's gradients, K3 + K4 against K2 ----
    kw = dict(stage="fine", raster_cfg=rc, lambda_dssim=0.0,
              reg_weights=(0.01, 0.0001, 0.0001))

    def grads():
        sg = loop.step_gradients(state, [cam], gt[None], bg, sh, **kw)
        return [x for x in sg.grads + [sg.ndc_grad] if x is not None]

    with_k2 = grads()
    before = kernel_runs()
    with switches_set({"FOURDGS_PALLAS_NO_FUSED_BWD": "1",
                       "FOURDGS_PALLAS_GRAD_SCATTER": "1"}):
        with_k3 = grads()
    torch.cuda.synchronize()
    after = kernel_runs()
    if (after["blend_bwd_slots"] - before["blend_bwd_slots"] != 1
            or after["blend_bwd"] != before["blend_bwd"]):
        raise AssertionError(f"the switched step ran {before} -> {after}")
    err = max(grads_agree(x, y) for x, y in zip(with_k3, with_k2))
    log(f"step gradients through K3 + K4 vs K2: {len(with_k2)} leaves, "
        f"normalised max abs err {err:.3g} (tol {GRAD_TOL:g})")
    if not err <= GRAD_TOL:
        raise AssertionError(f"K3 + K4 step gradients disagree: {err}")
    k3["step_grad_err_vs_k2"] = err
    return [k3, k4, k5]


# ---------------------------------------------------------------------------
# phase 9: the dev tools' kernels (D1-D6) at the scripts' shapes
# ---------------------------------------------------------------------------

def dev_entry(kid: str, name: str, source: str, replaces: str,
              tpu_kernel: str, launches: int, err: float, rec: dict,
              library_ms=None, **extra) -> dict:
    """A kernels-line entry of a dev tool's kernel from its tool's record
    (ms, plain_ms, bound_ms, bound_by, bound_resource)."""
    return {"name": f"{kid} {name}", "route": "cuda",
            "source": f"fourdgs_tpu_torch/csrc/{source}",
            "replaces": replaces, "tpu_kernel": tpu_kernel,
            "launches": launches, "max_abs_err": err, "ms": rec["ms"],
            "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
            "bound_by": rec["bound_by"],
            "bound_resource": rec["bound_resource"],
            "library_ms": library_ms, "ok": True, **extra}


def device_share(fn, rec: dict) -> dict:
    """A dev kernel's device time a call (`device_ms`: by kernel, the
    records kept, the host's enqueue time), the same time taken without
    the profiler (`held_stream_ms`, what `device_ms` falls back on), and
    its bound's share of the events time (rec's ms) and of the device
    time."""
    dev = device_ms(fn)
    return {"device_ms": dev["ms"], "device_kernels": dev["kernels"],
            "device_records": dev["records"], "host_ms": dev["host_ms"],
            "held_stream_ms": held_stream_ms(fn),
            "bound_share_events": rec["bound_ms"] / rec["ms"],
            "bound_share_device": rec["bound_ms"] / dev["ms"]}


def phase_dev_kernels(torch, device, seed: int) -> list:
    """Each tool of fourdgs_tpu_torch/tools that ports a Pallas prototype
    of scripts/ runs through its `main` at its script's shapes, with the
    launch counts read around the six; then each kernel against its plain
    version on the tool's inputs."""
    from fourdgs_tpu_torch.ops import (binner_proto, blend, blend_variants,
                                       gather, scatter, serial)
    from fourdgs_tpu_torch.tools import (exp_binner_proto, exp_gather,
                                         exp_scatter, exp_serial,
                                         profile_blend_split,
                                         profile_kernel_variants)
    from fourdgs_tpu_torch.utils.timing import bound

    bodies = [getattr(blend_variants, b) for b in blend_variants.BODIES]
    wrappers = [gather.gather_rows, binner_proto.expand_rank,
                scatter.scatter_add_rows, serial.scalar_store,
                serial.tile_counter_store, blend.blend_forward, *bodies]
    tools = {"D1": exp_gather, "D2": exp_binner_proto, "D3": exp_scatter,
             "D4": exp_serial, "D5": profile_blend_split,
             "D6": profile_kernel_variants}
    argv = ["--seed", str(seed), "--device", device.type]

    # ---- the main path, with the launch counts read around it ----
    torch.cuda.synchronize()
    for fn in wrappers:
        fn.launches = 0
    t0 = time.perf_counter()
    res = {kid: tool.main(argv) for kid, tool in tools.items()}
    torch.cuda.synchronize()
    launches = {fn.__name__: fn.launches for fn in wrappers}
    log(f"dev tools: {time.perf_counter() - t0:.2f} s; launches {launches}")

    # ---- each kernel against its plain version on its tool's inputs ----
    out = []
    table, idx = res["D1"]["inputs"]["table"], res["D1"]["inputs"]["idx"]
    ref = gather.gather_rows_plain(table, idx)
    equal = bool(torch.equal(gather.gather_rows(table, idx), ref))
    log(f"kernel gather_rows vs plain: equal {equal}")
    if not equal:
        raise AssertionError("gather_rows disagrees with plain")
    out.append(dev_entry(
        "D1", "gather_rows", "gather.cu", "scripts/exp_pallas_gather.py:50",
        "scripts/exp_pallas_gather.py:50, :75, :102, :125 (gather1-4)",
        launches["gather_rows"], 0.0, res["D1"],
        library_ms=res["D1"]["library_ms"], nbytes=res["D1"]["nbytes"]))

    rec = res["D2"]
    kw = dict(pc=exp_binner_proto.PC, n_tiles=exp_binner_proto.NT,
              grid_x=exp_binner_proto.GRID_X,
              tile_cap=exp_binner_proto.TILE_CAP)
    inp = list(rec["inputs"].values())
    equal = bool(torch.equal(binner_proto.expand_rank(*inp, **kw),
                             binner_proto.expand_rank_plain(*inp, **kw)))
    log(f"kernel expand_rank vs plain: equal {equal}")
    if not equal:
        raise AssertionError("expand_rank disagrees with plain")
    out.append(dev_entry(
        "D2", "expand_rank", "binner_proto.cu",
        "scripts/exp_pallas_binner_proto.py:78",
        "scripts/exp_pallas_binner_proto.py:29 (kernel)",
        launches["expand_rank"], 0.0, rec, pairs=rec["pairs"],
        pairs_per_s=rec["pairs_per_s"], pairs_past_pc=rec["pairs_past_pc"],
        pairs_past_tile_cap=rec["pairs_past_tile_cap"],
        passes_ms=rec["passes_ms"], device_ms=rec["device_ms"]))

    cases = {}
    for case, rec in res["D3"].items():
        i = rec["inputs"]
        a = scatter.scatter_add_rows(i["idx"], i["rows"], n_out=i["n_out"])
        b = scatter.scatter_add_rows_plain(i["idx"], i["rows"],
                                           n_out=i["n_out"])
        err = scatter_rel_err(a, b)
        log(f"kernel scatter_add_rows ({case}, {rec['shape']}) vs plain: max "
            f"|a-b| / max |b| {err:.3g} (tol {SCATTER_TOL:g})")
        if not err <= SCATTER_TOL:
            raise AssertionError(f"scatter_add_rows ({case}) disagrees: "
                                 f"{err}")
        cases[case] = {k: v for k, v in rec.items() if k != "inputs"}
        cases[case].update(max_rel_err=err,
                           max_abs_err=float((a - b).abs().max()))
    main3 = cases["hexplane"]
    out.append(dev_entry(
        "D3", "scatter_add_rows", "scatter.cu",
        "scripts/exp_pallas_scatter.py:66",
        "scripts/exp_pallas_scatter.py:48 (make_scatter_add's kernel)",
        launches["scatter_add_rows"],
        max(c["max_abs_err"] for c in cases.values()), main3,
        library_ms=main3["library_ms"], cases=cases))

    i = res["D4"]["inputs"]
    store = serial.scalar_store(i["idx"], i["val"], n_out=exp_serial.TABLE)
    kw = dict(n_tiles=exp_serial.NT, tile_cap=exp_serial.TILE_CAP,
              n_out=exp_serial.TABLE)
    counter = serial.tile_counter_store(i["tid"], i["val"], **kw)
    equal = {"scalar_store": bool(torch.equal(store, serial.scalar_store_plain(
        i["idx"], i["val"], n_out=exp_serial.TABLE))),
        "tile_counter_store": all(
            torch.equal(a, b) for a, b in zip(
                counter, serial.tile_counter_store_plain(i["tid"], i["val"],
                                                         **kw)))}
    log(f"kernels scalar_store, tile_counter_store vs plain ("
        f"{res['D4']['repeats']} repeated indices): equal {equal}")
    if not all(equal.values()):
        raise AssertionError(f"serial stores disagree with plain: {equal}")
    calls = {"D4a": lambda: serial.scalar_store(i["idx"], i["val"],
                                                n_out=exp_serial.TABLE),
             "D4b": lambda: serial.tile_counter_store(i["tid"], i["val"],
                                                      **kw)}
    for kid, name, line, body in (("D4a", "scalar_store", 70, "store_kernel"
                                   " :31"),
                                  ("D4b", "tile_counter_store", 77,
                                   "counter_kernel :43")):
        rec = res["D4"]["store" if kid == "D4a" else "counter"]
        out.append(dev_entry(
            kid, name, "serial.cu", f"scripts/exp_pallas_serial.py:{line}",
            f"scripts/exp_pallas_serial.py:{body}", launches[name], 0.0,
            rec, pairs_per_s=rec["pairs_per_s"], passes_ms=rec["passes_ms"],
            **device_share(calls[kid], rec),
            library_note="no single PyTorch call: indexed assignment leaves "
                         "the winner among repeated indices undefined"))

    rec = res["D5"]
    i = rec["inputs"]
    args = (i["gidx"], i["counts"], i["table"], i["cfg"])
    got, ref = blend.blend_forward(*args), blend.blend_forward_plain(*args)
    err = {k: float((a - b).abs().max())
           for k, a, b in zip(("color", "depth", "t"), got, ref)}
    log("kernel blend_fwd (tile 16) vs plain: max abs err " + ", ".join(
        f"{k} {v:.3g} (tol {TOL[k]:g})" for k, v in err.items()))
    if not all(v <= TOL[k] for k, v in err.items()):
        raise AssertionError(f"blend_fwd (tile 16) disagrees: {err}")
    cfg = i["cfg"]
    work = blend_work(*args)
    n_rows = int(torch.unique(i["gidx"][i["gidx"] >= 0]).numel())
    nbytes = (4 * cfg.num_tiles + 4 * int(i["counts"].sum()) + 48 * n_rows
              + 5 * 4 * cfg.num_tiles * cfg.pixels_per_tile)
    rec5 = {**rec, **bound(nbytes, sum(BLEND_FP32_INSTR[k] * work[k]
                                       for k in BLEND_FP32_INSTR),
                           work["exp"])}
    log(f"blend_fwd (tile 16): {rec['ms']:.4f} ms, bound "
        f"{rec5['bound_ms']:.4f} ms ({rec5['bound_resource']}); "
        f"evaluations {work}")
    out.append(dev_entry(
        "D5", "blend_fwd (tile 16)", "blend_fwd.cu",
        "scripts/profile_pallas_split.py:83",
        "scripts/profile_pallas_split.py:83 (_raw_fwd around K1's "
        "_fwd_kernel)", launches["blend_forward"], err["color"], rec5,
        max_abs_err_depth=err["depth"], max_abs_err_t=err["t"],
        pack_ms=rec["pack_ms"], pack_and_blend_ms=rec["pack_and_blend_ms"],
        evaluations=work))

    i = res["D6"]["inputs"]
    for fn, line in zip(bodies, (66, 77, 91, 108)):
        name = fn.__name__
        a, b = fn(i["attrs"], i["px"]), getattr(
            blend_variants, name + "_plain")(i["attrs"], i["px"])
        err = scatter_rel_err(a, b)
        log(f"kernel {name} vs plain: max |a-b| / max |b| {err:.3g} (tol "
            f"{DEV_TOL:g})")
        if not err <= DEV_TOL:
            raise AssertionError(f"{name} disagrees with plain: {err}")
        rec = res["D6"][name]
        out.append(dev_entry(
            "D6", f"blend_variants.{name}", "blend_variants.cu",
            "scripts/profile_kernel_variants.py:50",
            f"scripts/profile_kernel_variants.py:{line} (k_{name})",
            launches[name], float((a - b).abs().max()), rec,
            max_rel_err=err, clocks=rec.get("clocks"),
            sass_loop=res["D6"].get("sass_loop", {}).get(name),
            **device_share(lambda: fn(i["attrs"], i["px"]), rec)))
    for e in out:
        log(f"{e['name']}: {e['ms']:.4f} ms, plain {e['plain_ms']:.4f} ms, "
            f"library {e['library_ms']}, bound {e['bound_ms']:.4f} ms "
            f"({e['bound_resource']}); launches {e['launches']}" + (
                f"; device {e['device_ms']:.4f} ms (held stream "
                f"{e['held_stream_ms']:.4f} ms), bound share "
                f"{e['bound_share_events']:.1%} by events, "
                f"{e['bound_share_device']:.1%} on the device"
                if "bound_share_device" in e else ""))
    return out


def path_entries(serve: dict, step: dict, serve_runs: dict,
                 step_runs: dict) -> list:
    """The kernels-line entries of the binner kernel and of D1 as the
    HexPlane's forward gather: their runs on the serve and step paths
    (phases 3 and 5), and the checks on phase 4's frame and phase 6's
    step input, the step's at the top level."""
    out = []
    for name, source, replaces, tpu_kernel in (
            ("binner", "binner.cu", "scripts/exp_pallas_binner_proto.py:78",
             "scripts/exp_pallas_binner_proto.py:29 (kernel), at "
             "fourdgs_tpu/ops/rasterize_tiled.py:178 bin_gaussians_count's "
             "contract"),
            ("gather_rows", "gather.cu", "scripts/exp_pallas_gather.py:50",
             "scripts/exp_pallas_gather.py:50, :75, :102, :125 (gather1-4), "
             "as fourdgs_tpu/models/hexplane.py:71 _gather_rows")):
        top = step[name]
        out.append({
            "name": f"{name} (main path)", "route": "cuda",
            "source": f"fourdgs_tpu_torch/csrc/{source}",
            "replaces": replaces, "tpu_kernel": tpu_kernel,
            "launches": serve_runs[name] + step_runs[name],
            "launches_serve": serve_runs[name],
            "launches_step": step_runs[name], "max_abs_err": 0.0,
            "ms": top["ms"], "device_ms": top["device_ms"],
            "host_ms": top["host_ms"], "plain_ms": top["plain_ms"],
            "bound_ms": top["bound_ms"], "bound_by": "bytes",
            "bound_resource": "hbm bytes",
            "library_ms": top.get("library_ms"),
            "step": step[name], "serve": serve[name], "ok": True})
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--frames", type=int, default=24)
    parser.add_argument("--steps", type=int, default=30)
    parser.add_argument("--coarse", type=int, default=300,
                        help="coarse iterations of the driver phase")
    parser.add_argument("--fine", type=int, default=1200,
                        help="fine iterations of the driver phase (the SH "
                        "ramp needs 1000)")
    args = parser.parse_args(argv)
    if args.steps <= UNTIMED_STEPS + 5:
        parser.error(f"--steps must exceed {UNTIMED_STEPS + 5}")

    import torch
    name = phase_device(torch)
    from fourdgs_tpu_torch.train import graphs
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
    renderer, cams, launches, renders, serve = phase_slice(
        torch, scene, device, args.frames, work)
    cam = cams[round(KERNEL_CHECK_FRAME * args.frames)]
    k1, serve_checks = phase_kernels(torch, renderer, cam)
    k1["launches"] = launches["blend_fwd"]
    k1["launches_per_frame"] = launches["blend_fwd"] / renders
    k1["serve"] = serve
    state, rc, bg, sh, check_cam, gt, train_launches, train = phase_train(
        torch, scene, renderer, device, args.steps, args.seed)
    k1["launches_train"] = train_launches["blend_fwd"]
    k2, step_args, work_k2, step_checks = phase_kernels_bwd(
        torch, state, rc, bg, sh, check_cam, gt)
    k2["launches"] = train_launches["blend_bwd"]
    k2["launches_per_step"] = train_launches["blend_bwd"] / (
        2 * args.steps + graphs.WARMUP)
    k2["train"] = train
    driver_launches, driver = phase_driver(torch, device, work, args.coarse,
                                           args.fine, args.seed)
    k1["launches_driver"] = driver_launches["blend_fwd"]
    kernels = [k1, k2] + phase_kernels_slots(
        torch, step_args, work_k2, state, rc, bg, sh, check_cam, gt,
        driver_launches, k2)
    kernels[2]["driver"] = driver
    kernels += path_entries(serve_checks, step_checks, launches,
                            train_launches)
    kernels += phase_dev_kernels(torch, device, args.seed)
    for k in kernels:
        if k["launches"] == 0 or k.get("launches_serve", 1) == 0 \
                or k.get("launches_step", 1) == 0:
            raise AssertionError(f"{k['name']} never launched on the path")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
