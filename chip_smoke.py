#!/usr/bin/env python3
"""On-card smoke run of the PyTorch port (fourdgs_tpu_torch) on one GPU.

    python3 chip_smoke.py [--seed 0] [--frames 24]

Phases, each of which raises on failure (so the exit code is nonzero):
  1. device: the card's name and power limit;
  2. build:  the CUDA kernels from fourdgs_tpu_torch/csrc with nvcc;
  3. slice:  a synthetic snapshot (100,000 Gaussians, D-NeRF deformation
             width, random weights from --seed) served through
             Renderer.from_snapshot at 800x800 for --frames frames, with
             the kernels' launch counts read around that run, and checks
             of the images against the plain blend on the card and the
             CPU path on a small image;
  4. kernel: every kernel of the render path against its plain PyTorch
             version, on the inputs that one of phase 3's frames gives it
             (the caps after the cap probe), with CUDA-event times.
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
def plain_blend():
    """Route rasterize through the plain blend (for one comparison)."""
    from fourdgs_tpu_torch.ops import blend, rasterize_tiled
    saved = rasterize_tiled.blend_forward
    rasterize_tiled.blend_forward = blend.blend_forward_plain
    try:
        yield
    finally:
        rasterize_tiled.blend_forward = saved


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
    with plain_blend():
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
    kernel's loop body: all evaluated, past the power test (an expf), and
    used. A pixel evaluates every slot of its tile's list (up to the
    count) while its entering transmittance is above T_MIN. Walks the
    plain recurrence."""
    from fourdgs_tpu_torch.ops.blend import tile_pixel_coords
    from fourdgs_tpu_torch.ops.rasterize_ref import ALPHA_MAX, ALPHA_MIN, T_MIN
    k = cfg.chunk
    px, py = tile_pixel_coords(cfg, table.device)
    idx = torch.where(gidx >= 0, gidx, table.shape[0] - 1).long()
    t = torch.ones_like(px)
    work = {"eval": 0, "exp": 0, "used": 0}
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
        work["eval"] += int(ev.sum())
        work["exp"] += int((ev & (power <= 0)).sum())
        work["used"] += int((ev & (g > 0)).sum())
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
    instr = sum(BLEND_FP32_INSTR[k] * work[k] for k in work)
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


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--frames", type=int, default=24)
    args = parser.parse_args(argv)

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
    kernels = [phase_kernels(torch, renderer, cam)]
    for k in kernels:
        k["launches"] = launches[k["name"]]
        k["launches_per_frame"] = launches[k["name"]] / renders
        if k["launches"] == 0:
            raise AssertionError(f"{k['name']} never launched on the path")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
