"""Rank processes of tests/test_torch_parallel*.py: `spawn` starts N
processes (the spawn start method) that join one gloo process group on
the CPU, each running the runs that job["runs"] names (`JOBS`) on a
(n_data, n_tile) mesh of the port, while the test process runs the JAX
package. A job is a dict saved with torch.save; each rank saves {run:
what it returned} to <out>/rank<r>.pt. This module imports torch and the
port only, so that a rank process never loads JAX."""
from __future__ import annotations

import os
import socket
import time
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def spawn(job: dict, nprocs: int, out: Path):
    """Start the ranks of `job` (not joined: the caller runs JAX in the
    meantime, then `collect`s)."""
    out.mkdir(parents=True, exist_ok=True)
    path = out / "job.pt"
    torch.save(job, path)
    return mp.start_processes(_entry, args=(nprocs, free_port(), str(path)),
                              nprocs=nprocs, join=False,
                              start_method="spawn")


def collect(ctx, out: Path, nprocs: int, timeout: float = 300.0) -> list:
    """Join the ranks (a failed rank raises here; one still running after
    `timeout` seconds is killed, and this raises) and load their results,
    by rank."""
    deadline = time.monotonic() + timeout
    while not ctx.join(max(deadline - time.monotonic(), 0.0)):
        if time.monotonic() >= deadline:
            for proc in ctx.processes:
                proc.kill()
            raise TimeoutError(f"ranks still running after {timeout} s")
    return [torch.load(out / f"rank{r}.pt", weights_only=False)
            for r in range(nprocs)]


def _entry(rank: int, world: int, port: int, job_path: str) -> None:
    torch.set_num_threads(1)
    os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                      RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(world))
    from fourdgs_tpu_torch.parallel import multihost
    job = torch.load(job_path, weights_only=False)
    assert multihost.initialize_distributed(device=job.get("device", "cpu"),
                                            backend=job.get("backend"))
    try:
        result = {kind: JOBS[kind](job) for kind in job["runs"]}
        torch.save(result, Path(job_path).parent / f"rank{rank}.pt")
    finally:
        dist.destroy_process_group()


def _state(job: dict):
    """The job's state on its device: a TrainState (job["state"]), or one
    from a flattened JAX state (job["flat"])."""
    if "state" in job:
        return job["state"].to(job.get("device", "cpu"))
    from fourdgs_tpu_torch import convert
    from fourdgs_tpu_torch.train import config as tconfig
    return convert.train_state_from_numpy(
        job["flat"], tconfig.deform_config_from(job["cfg"]), device="cpu")


def snapshot(state) -> dict:
    """The state's parameters, moments and statistics as numpy."""
    from fourdgs_tpu_torch.models.gaussians import FIELDS

    def host(x):
        return x.detach().cpu().numpy().copy()

    out = {f"gauss/{f}": host(getattr(state.params["gauss"], f))
           for f in FIELDS}
    out.update({f"deform/{n}": host(p)
                for n, p in state.params["deform"].named_parameters()})
    for which in ("mu", "nu"):
        tree = getattr(state.opt_state, which)
        out.update({f"{which}/gauss/{f}": host(getattr(tree["gauss"], f))
                    for f in FIELDS})
        out.update({f"{which}/deform/{n}": host(x)
                    for n, x in tree["deform"].items()})
    for k in ("xyz_gradient_accum", "denom", "max_radii2d", "alive"):
        out[k] = host(getattr(state, k))
    return out


def job_steps(job: dict) -> list:
    """One sharded step from the job's state per entry of job["steps"]
    (each from the same initial state): its loss, l1, psnr, drops and the
    state after it."""
    from fourdgs_tpu_torch.parallel import multihost
    from fourdgs_tpu_torch.parallel.mesh import make_mesh
    from fourdgs_tpu_torch.parallel.sharded import sharded_train_step
    from fourdgs_tpu_torch.train import optim as toptim
    from fourdgs_tpu_torch.ops import blend
    mesh = make_mesh(*job["mesh"])
    sl = multihost.host_batch_slice(len(job["cams"]), mesh)
    dev = torch.device(job.get("device", "cpu"))
    cams = [c.to(dev) for c in job["cams"][sl]]
    out = []
    for step in job["steps"]:
        state = _state(job)
        tx = toptim.build_optimizer(job["cfg"].opt, 1.0)
        before = (blend.blend_forward.launches,
                  blend.blend_backward.launches)
        state, loss, aux = sharded_train_step(
            state, cams, job["gts"][sl].to(dev), job["bg"].to(dev),
            step["active_sh"], mesh=mesh, stage=step["stage"],
            raster_cfg=job["raster"], tx=tx,
            reg_weights=step["reg_weights"],
            lambda_dssim=step["lambda_dssim"])
        out.append(dict(loss=float(loss), l1=float(aux.l1),
                        psnr=float(aux.psnr),
                        dropped_pairs=int(aux.dropped_pairs),
                        dropped_tile=int(aux.dropped_tile),
                        max_alpha=float(aux.max_alpha),
                        n_visible=int(aux.visible.sum()),
                        launches=(blend.blend_forward.launches - before[0],
                                  blend.blend_backward.launches
                                  - before[1]),
                        state=snapshot(state)))
    return out


def job_eval(job: dict) -> dict:
    """`sharded_eval_render` of the job's state at each of
    job["eval_cams"] (by default its cameras)."""
    from fourdgs_tpu_torch.parallel.mesh import make_mesh
    from fourdgs_tpu_torch.parallel.sharded import sharded_eval_render
    mesh = make_mesh(*job["mesh"])
    state = _state(job)
    frames = []
    for cam in job.get("eval_cams", job["cams"]):
        color, depth, alpha = sharded_eval_render(
            state, cam, job["bg"], mesh=mesh, raster_cfg=job["raster"],
            stage=job["stage"], active_sh=job["active_sh"])
        frames.append((color.numpy(), depth.numpy(), alpha.numpy()))
    return {"frames": frames}


def job_stage(job: dict) -> dict:
    """`run_stage` over the mesh from the job's state: its history and
    events, and the state at the end."""
    from fourdgs_tpu_torch.parallel.mesh import make_mesh
    from fourdgs_tpu_torch.train import loop
    from fourdgs_tpu_torch.train import optim as toptim
    mesh = make_mesh(*job["mesh"])
    state = _state(job)
    cfg = job["cfg"]
    tx = toptim.build_optimizer(cfg.opt, 1.0)
    state.opt_state = tx.init(state.params)
    tests = []

    def on_test(it, st, active_sh, raster_cfg):
        from fourdgs_tpu_torch.parallel.sharded import sharded_eval_render
        color, _, _ = sharded_eval_render(
            st, job["cams"][0], job["bg"], mesh=mesh, raster_cfg=raster_cfg,
            stage=job["stage"], active_sh=active_sh)
        tests.append(float(((color - job["gts"][0]) ** 2).mean()))

    res = loop.run_stage(
        cfg, state, job["stage"], job["iterations"], job["cams"],
        job["gts"], tx, job["raster"], rng=np.random.default_rng(1),
        generator=torch.Generator().manual_seed(3),
        log_every=job["log_every"], cameras_extent=1.0,
        test_iterations=job.get("test_iterations", ()), on_test=on_test,
        mesh=mesh)
    return {"history": res.history, "events": res.events, "tests": tests,
            "state": snapshot(res.state)}


JOBS = {"steps": job_steps, "eval": job_eval, "stage": job_stage}
