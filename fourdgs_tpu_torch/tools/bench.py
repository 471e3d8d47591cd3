"""Training-step throughput of the port at the JAX package's bench.py
operating point: rays/s, forward and backward, on one card.

    python -m fourdgs_tpu_torch.tools.bench [--steps 30] [--points 100000]
        [--size 800] [--device cpu]

The operating point is bench.py's (`bench.py:40-127`): the benchmark scene
rule at 100k points (tools/profile_blend_split.py:synthetic_points, the
port's copy), the capacity bucket that `pick_bucket` picks at headroom 1,
tile 32, tile_cap 512, bin_pairs_per_chunk 18432 per 4096 gaussians,
opacity 0.9 everywhere, a uniform random target, a black background,
batch 1, the fine stage at SH degree 3, λ_dssim 0 and regularizer weights
(0.01, 1e-4, 1e-4), the D-NeRF deformation width (multires [1, 2], depth
0, width 64), data from seed 0. One untimed step and three warm-up steps,
then --steps timed steps, each a replay of the captured step
(`loop.step_of_key`, `graphs.StepPrograms`, as `run_stage` runs it),
closed by one read of the last loss. rays/s = size^2 x steps / seconds;
vs_baseline divides by the reference's 30.7M rays/s on an RTX 3090
(bench.py's derivation). The switches of the JAX package
(FOURDGS_HEX_BWD and the others) are read at call time, as in training.

Prints one JSON line with bench.py's keys, the card's name and power
limit, and the last step's drops, and returns it. A CPU run (--device cpu)
takes its steps eagerly and measures the host running the plain versions:
its numbers are no device metric.
"""
from __future__ import annotations

import argparse
import json
import math
import subprocess
import time

import numpy as np
import torch

from fourdgs_tpu_torch.data.camera import look_at_camera
from fourdgs_tpu_torch.tools.profile_blend_split import synthetic_points
from fourdgs_tpu_torch.train import config as config_mod
from fourdgs_tpu_torch.train import graphs, loop, optim
from fourdgs_tpu_torch.train.state import create_state
from fourdgs_tpu_torch.utils.device import resolve_device

BASELINE_RAYS_PER_S = 23000 / 480.0 * 800 * 800  # reference, RTX 3090
OPACITY = 0.9
REG_WEIGHTS = (0.01, 1e-4, 1e-4)
WARMUP_STEPS = 1 + 3
SEED = 0


def bench_config(points: int) -> config_mod.Config:
    """bench.py's configuration at `points` gaussians."""
    cfg = config_mod.Config()
    cfg.hidden.multires = [1, 2]
    cfg.hidden.defor_depth = 0
    cfg.hidden.net_width = 64
    cap = loop.pick_bucket(points, 1 << 22, headroom=1.0)
    cfg.raster = config_mod.RasterParams(
        capacity=cap, tile_size=32, tile_cap=512, pair_cap=1 << 21, chunk=32,
        bin_chunk=4096, bin_pairs_per_chunk=18432)
    return cfg


def card_limit(dev: torch.device) -> str | None:
    """`nvidia-smi`'s name and power limit of the card, or None off it."""
    if dev.type != "cuda":
        return None
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--steps", type=int, default=30)
    parser.add_argument("--points", type=int, default=100_000)
    parser.add_argument("--size", type=int, default=800)
    parser.add_argument("--device", default=None)
    args = parser.parse_args(argv)
    dev = resolve_device(args.device)
    captured = dev.type == "cuda"

    cfg = bench_config(args.points)
    pts, cols = synthetic_points(args.points, SEED)
    state = create_state(cfg, pts, cols, 1.0,
                         generator=torch.Generator().manual_seed(SEED),
                         device=dev)
    with torch.no_grad():
        state.params["gauss"].opacity.fill_(math.log(OPACITY
                                                     / (1.0 - OPACITY)))
    tx = optim.build_optimizer(cfg.opt, 1.0)
    state.opt_state = tx.init(state.params)
    rc = config_mod.raster_config_from(cfg, args.size, args.size)
    cams = [look_at_camera(device=dev)]
    rng = np.random.default_rng(SEED)
    gts = torch.from_numpy(rng.uniform(0, 1, (1, args.size, args.size, 3))
                           .astype(np.float32)).to(dev)
    bg = torch.zeros(3, device=dev)
    key = graphs.StepKey("fine", state.capacity, rc, 3, True, 1, 0.0,
                         REG_WEIGHTS, graphs.switches())
    step_fn = loop.step_of_key(tx)
    if captured:
        programs = graphs.StepPrograms(step_fn)

        def step():
            return programs.run(key, state, cams, gts, bg)
    else:
        eager_step = step_fn(key)

        def step():
            return eager_step(state, cams, gts, bg)

    for _ in range(WARMUP_STEPS):
        aux = step()
    float(aux.loss)
    t0 = time.perf_counter()
    for _ in range(args.steps):
        aux = step()
    final_loss = float(aux.loss)     # one read closes the timed steps
    seconds = time.perf_counter() - t0
    if not math.isfinite(final_loss):
        raise RuntimeError(f"non-finite loss {final_loss}")
    rays_per_s = args.size * args.size * args.steps / seconds
    out = {
        "metric": "train_rays_per_s_per_chip_fwd_bwd",
        "value": round(rays_per_s, 1),
        "unit": "rays/s",
        "vs_baseline": round(rays_per_s / BASELINE_RAYS_PER_S, 4),
        "detail": {
            "steps": args.steps, "seconds": round(seconds, 3),
            "steps_per_s": round(args.steps / seconds, 3),
            "ms_per_step": 1e3 * seconds / args.steps,
            "points": args.points, "capacity": state.capacity,
            "image": args.size,
            "backend": "cuda graphs" if captured else f"eager ({dev.type})",
            "switches": dict(zip(graphs.SWITCHES, graphs.switches())),
            "loss": final_loss,
            "dropped_pairs": int(aux.dropped_pairs),
            "dropped_tile": int(aux.dropped_tile),
            "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                       else str(dev)),
            "card": card_limit(dev),
            "baseline_rays_per_s": round(BASELINE_RAYS_PER_S, 1),
        },
    }
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
