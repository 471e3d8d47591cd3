"""Multi-card scaling of the tile-sharded training step: rays/s and scaling
efficiency over the mesh shapes that the machine's cards allow
(counterpart: scripts/bench_scaling.py).

    python -m fourdgs_tpu_torch.tools.bench_scaling [--cards N]
        [--steps 10] [--points 100000] [--size 800] [--device cpu]

The operating point is the JAX script's (scripts/bench_scaling.py:53-73):
100,000 points by the benchmark scene rule (the port's copy,
tools/profile_blend_split.py:synthetic_points) in the 131,072 bucket, the
D-NeRF deformation at multires [1, 2] and defor_depth 0, tile 16,
tile_cap 768, chunk 32, 800x800, the fine stage at SH degree 3, the
regularizer (0.01, 1e-4, 1e-4) and no SSIM term; a global batch of n_data
look-at cameras (theta 0.3 + 0.1 i, time i / batch), and uniform targets
drawn from seed 0, mesh after mesh. Each mesh starts from the same state:
one untimed step, then --steps timed steps closed by one read of the
loss.

Meshes follow the JAX script's rule (:75-81): (1, 1), then for n = 2, 4, ...
up to the card count, (n, 1) and, where n divides the tiles, (1, n). For
each mesh size the tool starts that many rank processes (this module with
--worker, RANK, WORLD_SIZE, MASTER_ADDR and MASTER_PORT in their
environment), which join one process group: on the cards NCCL, one rank a
card, each step a replay of the captured sharded step
(`parallel.sharded.step_of_key` under `graphs.StepPrograms`, as
`run_stage` runs it). The (1, 1) line runs the same path over a one-rank
NCCL group, so that every efficiency compares like with like.
`--device cpu` runs gloo ranks on the CPU, one thread each, eagerly, over
--cards ranks (default 2) at a small point (4,096 points, 128x128, 5
steps, as the JAX script's BENCH_CPU_DEVICES): its lines time host code
and are no device figure.

Prints one JSON line per mesh with the JAX script's keys (`mesh`,
`rays_per_s`, `steps_per_s`, `scaling_efficiency`: the mesh's rays/s over
the (1, 1) line's times its ranks), and `captured`, the device, the card's
name and power limit (tools/bench.py:card_limit), ms a step, the last
step's loss and drops; returns the lines.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from fourdgs_tpu_torch.tools.profile_blend_split import synthetic_points
from fourdgs_tpu_torch.train import config as config_mod

REG_WEIGHTS = (0.01, 1e-4, 1e-4)
SEED = 0
ACTIVE_SH = 3
CPU_POINT = {"points": 4096, "size": 128, "steps": 5}
CPU_RANKS = 2
RANKS_TIMEOUT = 900          # seconds a launch's ranks may take


def mesh_shapes(n_dev: int, num_tiles: int) -> list[tuple[int, int]]:
    """The JAX script's meshes for `n_dev` devices (:75-81)."""
    shapes = [(1, 1)]
    n = 2
    while n <= n_dev:
        shapes.append((n, 1))
        if num_tiles % n == 0:
            shapes.append((1, n))
        n *= 2
    return shapes


def operating_point(points: int) -> tuple[np.ndarray, np.ndarray]:
    """The scene's points and colours (the JAX script's
    `_synthetic_scene(points)`)."""
    return synthetic_points(points, SEED)


def bench_config(points: int) -> config_mod.Config:
    """The JAX script's configuration at `points` points."""
    cfg = config_mod.Config()
    cfg.hidden.multires = [1, 2]
    cfg.hidden.defor_depth = 0
    cfg.raster = config_mod.RasterParams(
        capacity=1 << (points - 1).bit_length(), tile_size=16, tile_cap=768,
        chunk=32)
    return cfg


def _num_tiles(size: int) -> int:
    return config_mod.raster_config_from(bench_config(2), size,
                                         size).num_tiles


def _targets(shapes, size: int) -> list:
    """Each mesh's global batch of targets, drawn from one generator in
    the meshes' order, as the JAX script draws them."""
    rng = np.random.default_rng(SEED)
    return [rng.uniform(0, 1, (n_data, size, size, 3)).astype(np.float32)
            for n_data, _ in shapes]


def _sync_ranks(dev: torch.device) -> None:
    """A collective and a host read: every rank is past its last step."""
    import torch.distributed as dist
    one = torch.ones(1, device=dev)
    dist.all_reduce(one)
    float(one)


def worker(args) -> None:
    """One rank: every mesh of the world's size, in the JAX script's
    order; rank 0 prints one JSON line a mesh (without the efficiency,
    which needs the (1, 1) line)."""
    import torch.distributed as dist

    from fourdgs_tpu_torch.data.camera import look_at_camera
    from fourdgs_tpu_torch.parallel import multihost, sharded
    from fourdgs_tpu_torch.parallel.mesh import make_mesh
    from fourdgs_tpu_torch.render.serve import _full_float32
    from fourdgs_tpu_torch.tools.bench import card_limit
    from fourdgs_tpu_torch.train import graphs, loop, optim
    from fourdgs_tpu_torch.train.state import create_state

    on_cpu = args.device == "cpu"
    if on_cpu:
        torch.set_num_threads(1)
    _full_float32()
    assert multihost.initialize_distributed(args.device)
    try:
        world, rank = dist.get_world_size(), dist.get_rank()
        dev = (torch.device("cpu") if on_cpu
               else torch.device("cuda", torch.cuda.current_device()))
        cfg = bench_config(args.points)
        pts, cols = operating_point(args.points)
        base = create_state(cfg, pts, cols, 1.0,
                            generator=torch.Generator().manual_seed(SEED),
                            device=dev)
        base = loop.compact_and_resize(base, cfg.raster.capacity)
        tx = optim.build_optimizer(cfg.opt, 1.0)
        base.opt_state = tx.init(base.params)
        rc = config_mod.raster_config_from(cfg, args.size, args.size)
        bg = torch.zeros(3, device=dev)
        shapes = mesh_shapes(args.cards, rc.num_tiles)
        for shape, gts_all in zip(shapes, _targets(shapes, args.size)):
            if shape[0] * shape[1] != world:
                continue
            mesh = make_mesh(*shape)
            batch = shape[0]
            sl = multihost.host_batch_slice(batch, mesh)
            cams = [look_at_camera(theta=0.3 + 0.1 * i, time=i / batch,
                                   device=dev) for i in range(batch)][sl]
            gts = torch.from_numpy(gts_all[sl]).to(dev)
            state = base.to(dev)
            key = graphs.StepKey("fine", state.capacity, rc, ACTIVE_SH, True,
                                 batch, 0.0, REG_WEIGHTS, graphs.switches(),
                                 sharded.mesh_key(mesh, rc))
            step_fn = sharded.step_of_key(tx, mesh)
            captured = dev.type == "cuda" and mesh.backend == "nccl"
            programs = graphs.StepPrograms(step_fn) if captured else None

            def step():
                if programs is None:
                    return step_fn(key)(state, cams, gts, bg)
                return programs.run(key, state, cams, gts, bg)

            float(step().loss)       # untimed: the capture and its warm-up
            _sync_ranks(dev)
            t0 = time.perf_counter()
            for _ in range(args.steps):
                aux = step()
            loss = float(aux.loss)   # one read closes the timed steps
            seconds = time.perf_counter() - t0
            _sync_ranks(dev)
            if rank == 0:
                print(json.dumps({
                    "mesh": f"{shape[0]}x{shape[1]}",
                    "rays_per_s": batch * args.size ** 2 * args.steps
                    / seconds,
                    "steps_per_s": args.steps / seconds,
                    "ms_per_step": 1e3 * seconds / args.steps,
                    "captured": captured, "backend": mesh.backend,
                    "device": (torch.cuda.get_device_name(dev)
                               if dev.type == "cuda" else "cpu"),
                    "card": card_limit(dev), "ranks": world, "batch": batch,
                    "points": args.points, "capacity": state.capacity,
                    "image": args.size, "steps": args.steps, "loss": loss,
                    "dropped_pairs": int(aux.dropped_pairs),
                    "dropped_tile": int(aux.dropped_tile)}), flush=True)
            del programs, state
    finally:
        dist.destroy_process_group()


def _free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def launch(args, world: int, out: Path) -> list[dict]:
    """`world` rank processes of this module's worker; returns rank 0's
    lines. Raises with a rank's output if one fails or outlasts
    RANKS_TIMEOUT; stops every rank it started."""
    port = _free_port()
    cmd = [sys.executable, "-m", "fourdgs_tpu_torch.tools.bench_scaling",
           "--worker", "--cards", str(args.cards), "--steps",
           str(args.steps), "--points", str(args.points), "--size",
           str(args.size), "--device", args.device]
    root = Path(__file__).resolve().parents[2]
    procs, logs = [], []
    try:
        for r in range(world):
            env = {**os.environ, "MASTER_ADDR": "127.0.0.1",
                   "MASTER_PORT": str(port), "RANK": str(r),
                   "WORLD_SIZE": str(world), "LOCAL_RANK": str(r),
                   "LOCAL_WORLD_SIZE": str(world)}
            logs.append(open(out / f"rank{world}_{r}.log", "w+"))
            procs.append(subprocess.Popen(cmd, cwd=root, env=env,
                                          stdout=logs[-1],
                                          stderr=subprocess.STDOUT))
        deadline = time.monotonic() + RANKS_TIMEOUT
        for r, p in enumerate(procs):
            rc = p.wait(timeout=max(deadline - time.monotonic(), 1.0))
            if rc != 0:
                logs[r].seek(0)
                raise RuntimeError(f"rank {r} of {world} exited {rc}:\n"
                                   + logs[r].read()[-6000:])
        logs[0].seek(0)
        lines = [json.loads(x) for x in logs[0].read().splitlines()
                 if x.startswith('{"mesh"')]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in logs:
            f.close()
    return lines


def main(argv=None) -> list[dict]:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--cards", type=int, default=None,
                        help="ranks to sweep up to (default: the cards; "
                        f"{CPU_RANKS} on the CPU)")
    parser.add_argument("--steps", type=int, default=None)
    parser.add_argument("--points", type=int, default=None)
    parser.add_argument("--size", type=int, default=None)
    parser.add_argument("--device", default="cuda",
                        help="cuda (NCCL, captured) or cpu (gloo, eager)")
    parser.add_argument("--worker", action="store_true",
                        help=argparse.SUPPRESS)
    args = parser.parse_args(argv)
    on_cpu = args.device == "cpu"
    if not on_cpu and args.device != "cuda":
        parser.error("--device is cuda or cpu")
    point = CPU_POINT if on_cpu else {"points": 100_000, "size": 800,
                                      "steps": 10}
    for k, v in point.items():
        if getattr(args, k) is None:
            setattr(args, k, v)
    if args.worker:
        worker(args)
        return []
    if args.cards is None:
        args.cards = CPU_RANKS if on_cpu else torch.cuda.device_count()
    if not on_cpu and not 1 <= args.cards <= torch.cuda.device_count():
        raise RuntimeError(f"{args.cards} card(s) asked for, "
                           f"{torch.cuda.device_count()} present; pass "
                           f"--device cpu to run gloo ranks on the CPU")
    shapes = mesh_shapes(args.cards, _num_tiles(args.size))
    sizes = sorted({d * t for d, t in shapes})
    lines = []
    with tempfile.TemporaryDirectory() as tmp:
        for world in sizes:
            lines += launch(args, world, Path(tmp))
    base = lines[0]["rays_per_s"]
    out = []
    for rec in lines:
        d, t = (int(x) for x in rec["mesh"].split("x"))
        rec = {"mesh": rec["mesh"], "rays_per_s": rec["rays_per_s"],
               "steps_per_s": rec["steps_per_s"],
               "scaling_efficiency": rec["rays_per_s"] / (base * d * t),
               **{k: v for k, v in rec.items()
                  if k not in ("mesh", "rays_per_s", "steps_per_s")}}
        if on_cpu:
            rec["note"] = ("gloo ranks on the CPU, eager: host time, no "
                           "device figure")
        print(json.dumps(rec), flush=True)
        out.append(rec)
    return out


if __name__ == "__main__":
    main()
