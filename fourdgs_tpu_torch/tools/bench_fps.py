"""Serving FPS of the port at the JAX package's bench point: the fine
stage's forward render (deformation, SH, projection, binner, blend) of a
synthetic scene, frames timed with one host sync at the end, one JSON line
(counterpart: scripts/bench_fps.py).

    BENCH_POINTS=100000 BENCH_SIZE=800 BENCH_FRAMES=100 \\
        python -m fourdgs_tpu_torch.tools.bench_fps [--device cpu]

The operating point is the script's, from the same environment names:
BENCH_POINTS gaussians (100,000) by the benchmark scene rule
(tools/profile_blend_split.py:synthetic_points, seed 0), a BENCH_SIZE
square image (800), BENCH_FRAMES frames (100), tile 32, tile_cap
BENCH_TILE_CAP (512), pair_cap 1<<21, chunk 32, bin_pairs_per_chunk
BENCH_BIN_PC (18,432); the D-NeRF deformation width (multires [1, 2],
depth 0, width 64); every opacity logit 2.197 (alpha 0.9); SH degree 3,
a black background, the look-at camera (data/camera.py:look_at_camera)
at t = i / frames. The capacity is the next power of two above the point
count, the script's rule (`tools/bench.py` takes `pick_bucket` at headroom
1; both give 131,072 at 100k points). The state is the port's own
`create_state`, its deformation drawn from a generator seeded 0: it does
not reproduce JAX's draws.

The frames are served by `render/serve.py:Renderer`: on the card one
untimed frame (its capture, train/graphs.py's captured frame), then
BENCH_FRAMES replays, their cameras made on the card before the loop, so
that the host copies nothing in it, closed by one synchronize. A second,
untimed pass over the same frames takes the largest `dropped_pairs` and
`dropped_tile` on the card and reads them once (the script's second pass:
its timed frames return the color only). `--device cpu` renders every
frame eagerly through the plain versions: its numbers are no device
metric.

`main` prints one JSON line with the script's keys (`detail.device` holds
the card's name and power limit from nvidia-smi) and returns it; `run`
takes the point as arguments and also returns the renderer, the cameras
and the first frame.
"""
from __future__ import annotations

import argparse
import json
import os
import time

import torch

from fourdgs_tpu_torch.data.camera import Camera, look_at_camera
from fourdgs_tpu_torch.models.gaussians import FIELDS, GaussianParams
from fourdgs_tpu_torch.render.serve import Renderer, _full_float32
from fourdgs_tpu_torch.tools.bench import card_limit
from fourdgs_tpu_torch.tools.profile_blend_split import synthetic_points
from fourdgs_tpu_torch.train import config as config_mod
from fourdgs_tpu_torch.train.state import TrainState, create_state
from fourdgs_tpu_torch.utils.device import resolve_device

BASELINE_FPS = 82.0
OPACITY_LOGIT = 2.197          # sigmoid = 0.9
SH_DEGREE = 3
SEED = 0


def bench_config(points: int, tile_cap: int = 512,
                 bin_pairs_per_chunk: int = 18432) -> config_mod.Config:
    """The script's configuration at `points` gaussians."""
    cfg = config_mod.Config()
    cfg.hidden.multires = [1, 2]
    cfg.hidden.defor_depth = 0
    cfg.hidden.net_width = 64
    cfg.raster = config_mod.RasterParams(
        capacity=1 << (points - 1).bit_length(), tile_size=32,
        tile_cap=tile_cap, pair_cap=1 << 21, chunk=32,
        bin_pairs_per_chunk=bin_pairs_per_chunk)
    return cfg


def bench_state(cfg: config_mod.Config, points: int,
                device: torch.device) -> TrainState:
    """The scene's state: `points` gaussians by the benchmark scene rule,
    the deformation drawn from a generator seeded SEED."""
    pts, cols = synthetic_points(points, SEED)
    return create_state(cfg, pts, cols, 1.0,
                        generator=torch.Generator().manual_seed(SEED),
                        device=device)


def bench_renderer(cfg: config_mod.Config, state: TrainState, size: int,
                   device: torch.device) -> Renderer:
    """A Renderer of `state` at the bench point: every opacity logit
    OPACITY_LOGIT, a black background, SH degree 3, a `size` square
    image, no cap probe (the script renders at its caps)."""
    g = state.params["gauss"]
    gauss = GaussianParams(**{
        f: (torch.full_like(g.opacity, OPACITY_LOGIT) if f == "opacity"
            else getattr(g, f)).detach() for f in FIELDS})
    return Renderer(gauss=gauss, alive=state.alive,
                    deform=state.params["deform"], aabb=state.aabb,
                    bg=torch.zeros(3, device=device),
                    raster_cfg=config_mod.raster_config_from(cfg, size, size),
                    sh_degree=SH_DEGREE, device=device)


def frame_cameras(frames: int, device: torch.device) -> list[Camera]:
    """The look-at camera at t = i / frames, i < frames, on `device`."""
    return [look_at_camera(time=i / frames, device=device)
            for i in range(frames)]


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def run(points: int = 100_000, size: int = 800, frames: int = 100,
        tile_cap: int = 512, bin_pairs_per_chunk: int = 18432,
        device: torch.device | str | None = None):
    """The bench at a point: returns its result (the JSON line's object),
    the renderer, the cameras and the first frame's output (on the card
    the capture's replay)."""
    dev = resolve_device(device)
    _full_float32()
    cfg = bench_config(points, tile_cap, bin_pairs_per_chunk)
    renderer = bench_renderer(cfg, bench_state(cfg, points, dev), size, dev)
    cams = frame_cameras(frames, dev)

    first = renderer.render(cams[0])
    _sync(dev)
    t0 = time.perf_counter()
    for cam in cams:
        renderer.render(cam)
    _sync(dev)
    seconds = time.perf_counter() - t0
    fps = frames / seconds

    # the drops, outside the timed loop: the same frames again, the
    # counters' maxima kept on the device and read once
    acc = torch.zeros(2, dtype=torch.int64, device=dev)
    for cam in cams:
        out = renderer.render(cam)
        acc = torch.maximum(acc, torch.stack([
            torch.as_tensor(out.dropped_pairs, device=dev),
            torch.as_tensor(out.dropped_tile, device=dev)]).long())
    max_dp, max_dt = (int(x) for x in acc.cpu())
    result = {
        "metric": "render_fps_fine", "value": round(fps, 2), "unit": "fps",
        "vs_baseline": round(fps / BASELINE_FPS, 4),
        "detail": {"frames": frames, "seconds": round(seconds, 3),
                   "ms_per_frame": round(seconds / frames * 1000, 2),
                   "points": points, "image": size,
                   "max_dropped_pairs": max_dp,
                   "max_dropped_tile": max_dt,
                   "baseline_fps": BASELINE_FPS,
                   "device": card_limit(dev) or str(dev)}}
    return result, renderer, cams, first


def main(argv=None) -> dict:
    """Run the bench at the point the BENCH_* variables give and print its
    line."""
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default=None,
                        help="default cuda; 'cpu' runs the plain path")
    args = parser.parse_args(argv)
    result, *_ = run(
        int(os.environ.get("BENCH_POINTS", 100_000)),
        int(os.environ.get("BENCH_SIZE", 800)),
        int(os.environ.get("BENCH_FRAMES", 100)),
        int(os.environ.get("BENCH_TILE_CAP", 512)),
        int(os.environ.get("BENCH_BIN_PC", 18432)), args.device)
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
