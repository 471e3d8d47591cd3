"""Training CLI: two-stage 4DGS optimisation on the card
(counterpart: scripts/train.py).

    python -m fourdgs_tpu_torch.tools.train -s <scene> -m <out> \\
        --configs <config.py> [--device cpu]

The coarse stage (static gaussians) and then the fine stage (gaussians and
deformation) run through `train.loop.run_stage`, each with a fresh
optimizer; `--start_checkpoint` resumes mid-stage. Every `log` record goes
to <out>/train_log.jsonl with the JAX script's keys, and every test
evaluation adds a record with `"eval": "test"`, which also gives the
state's capacity and what each view's render dropped at which caps
(`render_per_view`). Snapshots land under
<out>/point_cloud/ and checkpoints at <out>/chkpnt_{stage}_{iter}.npz, in
the JAX package's layouts.

The scene is read through `data.scene.Scene.load`: the Blender (D-NeRF)
layout, its images resized to 800x800 or to `--image_size`, and the
Colmap (the config's `images` directory and `llffhold`), nerfies
(HyperNeRF), dynerf (DyNeRF), PanopticSports and MultipleView layouts at
their images' size, divided by `--resolution` where it is above 1 (the JAX
script's `-r`).
A split too large for the device trains from a host or lazy image bank,
its next batch prefetched (a lazy bank decodes in spawned processes,
which import the main module again: a script that calls `main` keeps the
call under `if __name__ == "__main__":`). `--mesh`, `--distributed` and
`--gui` are not ported yet and raise; `--profile` runs the fine stage
eagerly, so that its spans show (a replayed CUDA graph opens none), wraps
it in `torch.profiler` and writes a Chrome trace under <out>/trace/.

On the card each step is otherwise a replay of a captured CUDA graph
(train/graphs.py), captured when the step's key changes.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import time

import numpy as np
import torch

from fourdgs_tpu_torch.data.scene import Scene
from fourdgs_tpu_torch.ops import losses
from fourdgs_tpu_torch.render.serve import _full_float32
from fourdgs_tpu_torch.train import checkpoint, loop, optim
from fourdgs_tpu_torch.train import config as config_mod
from fourdgs_tpu_torch.train import state as state_mod
from fourdgs_tpu_torch.utils.device import resolve_device


def build_parser() -> tuple[argparse.ArgumentParser, config_mod.Config]:
    parser = argparse.ArgumentParser(description="4DGS training (PyTorch)")
    parser.add_argument("-s", "--source_path", required=True)
    parser.add_argument("-m", "--model_path", default="")
    parser.add_argument("--expname", default="default")
    parser.add_argument("--configs", default="")
    parser.add_argument("--test_iterations", nargs="+", type=int,
                        default=[3000, 7000, 14000])
    parser.add_argument("--save_iterations", nargs="+", type=int,
                        default=[14000, 20000, 30000, 45000, 60000])
    parser.add_argument("--checkpoint_iterations", nargs="+", type=int,
                        default=[])
    parser.add_argument("--start_checkpoint", default=None)
    parser.add_argument("--quiet", action="store_true")
    parser.add_argument("--seed", type=int, default=6666)
    parser.add_argument("--profile", action="store_true",
                        help="trace the fine stage with torch.profiler")
    parser.add_argument("--distributed", action="store_true",
                        help="multi-host training (not ported yet)")
    parser.add_argument("--mesh", default="",
                        help="multi-GPU mesh 'data,tile' (not ported yet)")
    parser.add_argument("--detect_anomaly", action="store_true",
                        help="torch.autograd anomaly detection (slow)")
    parser.add_argument("--gui", action="store_true",
                        help="the viewer bridge (not ported yet)")
    parser.add_argument("--ip", type=str, default="127.0.0.1")
    parser.add_argument("--port", type=int, default=6009)
    parser.add_argument("--device", default=None,
                        help="default cuda; 'cpu' runs the plain path")
    parser.add_argument("--image_size", nargs=2, type=int, default=None,
                        metavar=("W", "H"),
                        help="the Blender images' size (default 800 800)")
    cfg = config_mod.Config()
    config_mod.add_args(parser, cfg)
    return parser, cfg


def eval_render(state, cam, bg, stage, active_sh, rcfg, renders=4):
    """One view with the live caps; an overflowing view doubles the
    overflowing cap and renders again, up to `renders` renders. Returns the
    last render's color, and what it dropped at which caps."""
    for i in range(renders):
        out = loop.eval_step(state, cam, bg, stage=stage,
                             active_sh=active_sh, raster_cfg=rcfg)
        dp, dt, npairs = (int(x) for x in torch.stack([
            out.dropped_pairs, out.dropped_tile, out.num_pairs]).cpu())
        dt_thresh = max(64, npairs // 200)
        if i == renders - 1 or not (dp or dt > dt_thresh):
            break
        changes = {}
        if dt > dt_thresh:
            changes["tile_cap"] = min(rcfg.tile_cap * 2, 8192)
        if dp:
            changes["bin_pairs_per_chunk"] = min(
                rcfg.bin_pairs_per_chunk * 2, 1 << 18)
        if all(getattr(rcfg, k) == v for k, v in changes.items()):
            break
        rcfg = dataclasses.replace(rcfg, **changes)
    return out.color, {"dropped_pairs": dp, "dropped_tile": dt,
                       "num_pairs": npairs, "tile_cap": rcfg.tile_cap,
                       "bin_pairs_per_chunk": rcfg.bin_pairs_per_chunk}


def main(argv=None) -> dict:
    """Train; returns a summary: per stage its iterations, wall time (train
    time without evals and saves), SH degree at the end, events, log
    history, test PSNRs and, on the card, peak memory."""
    parser, cfg = build_parser()
    args = parser.parse_args(argv)
    for flag in ("distributed", "mesh", "gui"):
        if getattr(args, flag):
            raise NotImplementedError(f"--{flag} is not ported yet")
    if args.configs:
        cfg = config_mod.apply_config_file(cfg, args.configs)
    cfg = config_mod.apply_args(cfg, args)
    cfg.model.source_path = os.path.abspath(args.source_path)
    cfg.model.model_path = args.model_path or os.path.join(
        "./output/", args.expname)
    cfg.expname = args.expname
    cfg.seed = args.seed
    os.makedirs(cfg.model.model_path, exist_ok=True)
    config_mod.save_cfg(cfg, os.path.join(cfg.model.model_path,
                                          "cfg_args.json"))
    dev = resolve_device(args.device)
    _full_float32()
    if args.detect_anomaly:
        torch.autograd.set_detect_anomaly(True)

    t_setup = time.time()
    print(f"Loading scene from {cfg.model.source_path}", flush=True)
    scene = Scene.load(cfg.model.source_path,
                       white_background=cfg.model.white_background,
                       eval_split=cfg.model.eval,
                       extension=cfg.model.extension,
                       images=cfg.model.images or None,
                       llffhold=cfg.model.llffhold,
                       downscale=max(cfg.model.resolution, 1), device=dev,
                       resolution=(tuple(args.image_size)
                                   if args.image_size else None))
    t_load = time.time() - t_setup
    print(f"  type={scene.dataset_type} train={len(scene.train)} "
          f"test={len(scene.test)} extent={scene.cameras_extent:.3f} "
          f"({t_load:.1f}s)", flush=True)

    pcd = scene.info.point_cloud
    st = state_mod.create_state(
        cfg, pcd.points, pcd.colors, spatial_lr_scale=scene.cameras_extent,
        aabb=scene.aabb, generator=torch.Generator().manual_seed(cfg.seed),
        device=dev)
    st = loop.compact_and_resize(
        st, loop.pick_bucket(int(st.alive.sum()), cfg.raster.capacity))
    deform_cfg = config_mod.deform_config_from(cfg)
    raster_cfg = config_mod.raster_config_from(cfg, scene.train.width,
                                               scene.train.height)
    bg = torch.tensor([1.0, 1.0, 1.0] if cfg.model.white_background
                      else [0.0, 0.0, 0.0], device=dev)
    rng = np.random.default_rng(cfg.seed)
    log_path = os.path.join(cfg.model.model_path, "train_log.jsonl")

    def write_log(rec):
        with open(log_path, "a") as f:
            f.write(json.dumps(rec) + "\n")

    def log_fn(rec):
        if not args.quiet:
            print(f"[{rec['stage']} {rec['iter']}] loss={rec['loss']:.5f} "
                  f"psnr={rec['psnr']:.2f} pts={rec['points']} "
                  f"t={rec['elapsed']:.1f}s", flush=True)
        write_log(rec)

    epoch_order_fn = None
    if cfg.opt.custom_sampler:
        from fourdgs_tpu_torch.train.sampler import fine_sample_order
        frame_length = len(np.unique(scene.train.times))
        n_poses = max(len(scene.train) // max(frame_length, 1), 1)

        def epoch_order_fn(r):
            return fine_sample_order(len(scene.train), n_poses, r)

    test_psnrs: dict[str, list] = {"coarse": [], "fine": []}

    def make_on_test(stage):
        def eval_split(split, it, state, active_sh, rcfg, n=None):
            n = len(split) if n is None else min(len(split), n)
            out, renders = [], []
            for i in range(n):
                color, drops = eval_render(state, split.cameras[i], bg,
                                           stage, active_sh, rcfg)
                img = torch.clamp(color, 0, 1)
                out.append(losses.psnr(img, split.images[[i]][0])[0])
                renders.append(drops)
            return torch.stack(out).cpu().tolist(), renders

        def on_test(it, state, active_sh, raster_cfg):
            rcfg = raster_cfg
            test, renders = eval_split(scene.test, it, state, active_sh,
                                       rcfg)
            train, _ = eval_split(scene.train, it, state, active_sh, rcfg,
                                  n=5)
            print(f"\n[ITER {it}] Evaluating test: PSNR "
                  f"{np.mean(test):.2f} over {len(test)} views "
                  f"(train probe {np.mean(train):.2f})", flush=True)
            test_psnrs[stage].append((it, float(np.mean(test))))
            write_log({"stage": stage, "iter": it, "eval": "test",
                       "psnr": float(np.mean(test)),
                       "psnr_per_view": [round(p, 4) for p in test],
                       "capacity": state.capacity,
                       "render_per_view": renders,
                       "train_probe_psnr": float(np.mean(train))})
        return on_test

    def make_on_save(stage):
        def on_save(it, state):
            path = checkpoint.save_snapshot(
                cfg.model.model_path, it, state.params["gauss"], state.alive,
                state.params["deform"], state.aabb.cpu().numpy(), stage)
            print(f"\n[ITER {it}] Saved snapshot to {path}", flush=True)
        return on_save

    def make_on_ckpt(stage):
        def on_ckpt(it, state, active_sh):
            path = os.path.join(cfg.model.model_path,
                                f"chkpnt_{stage}_{it}.npz")
            checkpoint.save_checkpoint(state, path, it, stage, active_sh)
            print(f"\n[ITER {it}] Saved checkpoint {path}", flush=True)
        return on_ckpt

    stages = [("coarse", cfg.opt.coarse_iterations),
              ("fine", cfg.opt.iterations)]
    start_stage = 0
    resumed = None
    if args.start_checkpoint:
        resumed = checkpoint.load_checkpoint(args.start_checkpoint,
                                             deform_cfg, dev)
        if resumed[2] == "fine":
            start_stage = 1
            print("start from fine stage, skip coarse stage.")

    summary = {"model_path": cfg.model.model_path, "scene_load_s": t_load,
               "stages": []}
    total_time = 0.0
    active_sh = 0   # carried across stages
    for si, (stage, iters) in enumerate(stages):
        if si < start_stage:
            continue
        tx = optim.build_optimizer(cfg.opt, scene.cameras_extent)
        st.opt_state = tx.init(st.params)
        st.step = torch.zeros((), dtype=torch.int32, device=dev)
        start_it = 0
        if resumed is not None and si == start_stage:
            st, start_it, _, active_sh = resumed
            print(f"resumed {stage} stage at iteration {start_it} "
                  f"(sh degree {active_sh})")
        zmask = (scene.zerostamp_mask()
                 if stage == "coarse" and cfg.opt.zerostamp_init else None)
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        profile = args.profile and stage == "fine"
        acts = [torch.profiler.ProfilerActivity.CPU]
        if dev.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        with (torch.profiler.profile(activities=acts) if profile
              else contextlib.nullcontext()) as prof:
            res = loop.run_stage(
                cfg, st, stage, iters, scene.train.cameras,
                scene.train.images, tx, raster_cfg, rng=rng,
                generator=torch.Generator(device=dev).manual_seed(
                    cfg.seed + si),
                log_fn=log_fn, zerostamp_view_mask=zmask,
                cameras_extent=scene.cameras_extent,
                test_iterations=tuple(args.test_iterations),
                save_iterations=tuple(args.save_iterations) + (iters,),
                checkpoint_iterations=tuple(args.checkpoint_iterations),
                on_test=make_on_test(stage), on_save=make_on_save(stage),
                on_checkpoint=make_on_ckpt(stage),
                epoch_order_fn=None if stage == "coarse" else epoch_order_fn,
                start_iteration=start_it, initial_active_sh=active_sh,
                capture=False if profile else None)
        if profile:
            trace_dir = os.path.join(cfg.model.model_path, "trace")
            os.makedirs(trace_dir, exist_ok=True)
            prof.export_chrome_trace(os.path.join(trace_dir, "fine.json"))
        st = res.state
        active_sh = res.active_sh
        raster_cfg = res.raster_cfg
        total_time += res.wall_time
        summary["stages"].append(dict(
            stage=stage, start=start_it, iterations=iters,
            wall_time=res.wall_time, active_sh=res.active_sh,
            events=res.events, graphs=res.graphs,
            history=res.history, test_psnr=test_psnrs[stage],
            raster_cfg=dataclasses.asdict(raster_cfg),
            peak_bytes=(torch.cuda.max_memory_allocated(dev)
                        if dev.type == "cuda" else None)))
        print(f"{stage} stage done in {res.wall_time:.1f}s "
              f"({int(st.alive.sum())} points)", flush=True)

    print(f"\nTraining complete in {total_time:.1f}s (excl. eval/saving).")
    return summary


if __name__ == "__main__":
    main()
