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

Where `torch.utils.tensorboard` imports (the `tensorboard` package is
installed), a TensorBoard event file in <out> gets the JAX script's
records under its tags: at each log record the l1 and total loss, the
point count and the PSNR, and at each test evaluation the test and
train-probe PSNR and histograms of the alive slots' opacity and
accumulated motion. The CLI prints once whether it writes one.

The scene is read through `data.scene.Scene.load`: the Blender (D-NeRF)
layout, its images resized to 800x800 or to `--image_size`, and the
Colmap (the config's `images` directory and `llffhold`), nerfies
(HyperNeRF), dynerf (DyNeRF), PanopticSports and MultipleView layouts at
their images' size, divided by `--resolution` where it is above 1 (the JAX
script's `-r`).
A split too large for the device trains from a host or lazy image bank,
its next batch prefetched (a lazy bank decodes on threads, in the host
library). `--profile` runs the fine
stage eagerly, so that its spans show (a replayed CUDA graph opens none),
wraps it in `torch.profiler` and writes a Chrome trace under <out>/trace/.

Multi-GPU (parallel/): under `python -m torch.distributed.run
--nproc_per_node N -m fourdgs_tpu_torch.tools.train ... --distributed
--mesh D,T` the N = D x T ranks join one process group
(`multihost.initialize_distributed`: NCCL on the card, gloo on the CPU;
`FOURDGS_DIST_BACKEND=gloo` for ranks that share a card) and train over
the ("data", "tile") mesh with the tile-sharded step; the batch size is
rounded up to a multiple of D. Evaluations render tile-sharded when T
divides the tiles. Over NCCL each step is a replay of the captured
sharded step (a `[capture] ...` line from rank 0 for each key) and each
sharded evaluation a replay of a captured sharded frame
(`tools/render.py:MeshRenderer`); over gloo both run eagerly, which rank
0 prints. Rank 0 alone writes the config, the log, the snapshots, the
checkpoints and the triptychs, and at the end every rank's state must be
the same bytes (a digest gathered from each, logged as `"mesh"`).

`--gui` opens the live viewer bridge (viewer/network_gui.py) on
`--ip`:`--port`: after every iteration a poll serves the frames that a
connected SIBR-protocol client asks for, each rendered eagerly at the
client's size at the video timestamp of the iteration; with no client a
poll is one non-blocking `accept`. With the config's `render_process`,
every test evaluation writes test view 0's gt / render / depth triptych
to <out>/train_render/<stage>test/<iteration>.jpg (utils/visualize.py).

On the card each step is otherwise a replay of a captured CUDA graph
(train/graphs.py), captured when the step's key changes.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import functools
import json
import os
import time

import numpy as np
import torch

from fourdgs_tpu_torch.data.scene import Scene
from fourdgs_tpu_torch.ops import losses
from fourdgs_tpu_torch.render.render import render
from fourdgs_tpu_torch.render.serve import _full_float32
from fourdgs_tpu_torch.train import checkpoint, loop, optim
from fourdgs_tpu_torch.train import config as config_mod
from fourdgs_tpu_torch.train import state as state_mod
from fourdgs_tpu_torch.utils.device import resolve_device
from fourdgs_tpu_torch.utils.visualize import render_training_image


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
                        help="join torchrun's process group (see the "
                        "module's docstring)")
    parser.add_argument("--mesh", default="",
                        help="train over a 'data,tile' mesh of the ranks")
    parser.add_argument("--detect_anomaly", action="store_true",
                        help="torch.autograd anomaly detection (slow)")
    parser.add_argument("--gui", action="store_true",
                        help="serve the live viewer bridge on --ip:--port")
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
    """One view with the live caps (`eval_output`). Returns the last
    render's color, and what it dropped at which caps."""
    out, drops = eval_output(state, cam, bg, stage, active_sh, rcfg, renders)
    return out.color, drops


def eval_output(state, cam, bg, stage, active_sh, rcfg, renders=4,
                sharded=None):
    """One view with the live caps; an overflowing view doubles the
    overflowing cap and renders again, up to `renders` renders. Returns the
    last render's output, and what it dropped at which caps. With
    `sharded` (a `tools/render.py:MeshRenderer` over the run's mesh, whose
    tile axis divides the tiles) the render is tile-sharded
    (`sharded_render`, collective: every rank calls it), as JAX's train
    script renders its evals: a replay of its captured frame over NCCL."""
    for i in range(renders):
        if sharded is not None:
            out = sharded.render_state(state, cam, rcfg, stage, active_sh)
        else:
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
    return out, {"dropped_pairs": dp, "dropped_tile": dt,
                       "num_pairs": npairs, "tile_cap": rcfg.tile_cap,
                       "bin_pairs_per_chunk": rcfg.bin_pairs_per_chunk}


def open_writer(model_path: str):
    """A TensorBoard `SummaryWriter` on `model_path` where
    `torch.utils.tensorboard` imports (it needs the `tensorboard`
    package), else None; prints which, and the seconds the import and
    the writer took (the import is paid once a process)."""
    t0 = time.perf_counter()
    try:
        from torch.utils.tensorboard import SummaryWriter
    except ImportError as e:
        print(f"TensorBoard: off ({e}); the log is train_log.jsonl",
              flush=True)
        return None
    writer = SummaryWriter(model_path)
    print(f"TensorBoard: writing to {model_path} (opened in "
          f"{time.perf_counter() - t0:.3f} s)", flush=True)
    return writer


def write_eval_summaries(tb, stage: str, it: int, state, test_psnr: float,
                         train_psnr: float) -> None:
    """A test evaluation's TensorBoard records under the JAX script's
    tags: the test and train-probe PSNR, and histograms of the alive
    slots' opacity (sigmoid) and accumulated motion (the densify gradient
    sum over max(denom, 1)), read to the host here, outside the timed
    steps."""
    tb.add_scalar(f"{stage}/test/loss_viewpoint - psnr", test_psnr, it)
    tb.add_scalar(f"{stage}/train/loss_viewpoint - psnr", train_psnr, it)
    alive = state.alive.cpu().numpy()
    op = torch.sigmoid(state.params["gauss"].opacity.detach()[:, 0])
    tb.add_histogram(f"{stage}/scene/opacity_histogram",
                     op.cpu().numpy()[alive], it)
    motion = state.xyz_gradient_accum / torch.clamp(state.denom, min=1.0)
    tb.add_histogram(f"{stage}/scene/motion_histogram",
                     motion.cpu().numpy()[alive], it)


def main(argv=None) -> dict:
    """Train; returns a summary: per stage its iterations, wall time (train
    time without evals and saves), SH degree at the end, events, log
    history, test PSNRs and, on the card, peak memory."""
    parser, cfg = build_parser()
    args = parser.parse_args(argv)
    joined = False
    if args.distributed:
        # before anything touches the card: the rank takes its device
        from fourdgs_tpu_torch.parallel import multihost
        joined = multihost.initialize_distributed(
            args.device, os.environ.get("FOURDGS_DIST_BACKEND") or None)
    try:
        return _train(args, cfg)
    finally:
        if joined:
            torch.distributed.destroy_process_group()


def _train(args, cfg) -> dict:
    mesh = None
    if args.mesh:
        from fourdgs_tpu_torch.parallel.mesh import make_mesh
        n_data, n_tile = (int(x) for x in args.mesh.split(","))
        mesh = make_mesh(n_data, n_tile)
    lead = mesh is None or mesh.rank == 0
    if args.configs:
        cfg = config_mod.apply_config_file(cfg, args.configs)
    cfg = config_mod.apply_args(cfg, args)
    cfg.model.source_path = os.path.abspath(args.source_path)
    cfg.model.model_path = args.model_path or os.path.join(
        "./output/", args.expname)
    cfg.expname = args.expname
    cfg.seed = args.seed
    os.makedirs(cfg.model.model_path, exist_ok=True)
    if mesh is not None:
        from fourdgs_tpu_torch.parallel.multihost import pad_batch_for_hosts
        cfg.opt.batch_size = pad_batch_for_hosts(cfg.opt.batch_size, mesh)
        if lead:
            print(f"training on mesh data={mesh.n_data} tile={mesh.n_tile}"
                  f" (batch {cfg.opt.batch_size})", flush=True)
    if lead:
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
        if not lead:
            return
        with open(log_path, "a") as f:
            f.write(json.dumps(rec) + "\n")

    tb = open_writer(cfg.model.model_path) if lead else None

    def log_fn(rec):
        if not args.quiet:
            print(f"[{rec['stage']} {rec['iter']}] loss={rec['loss']:.5f} "
                  f"psnr={rec['psnr']:.2f} pts={rec['points']} "
                  f"t={rec['elapsed']:.1f}s", flush=True)
        write_log(rec)
        if tb is not None:
            s, it = rec["stage"], rec["iter"]
            tb.add_scalar(f"{s}/train_loss_patches/l1_loss", rec["l1"], it)
            tb.add_scalar(f"{s}/train_loss_patchestotal_loss", rec["loss"],
                          it)
            tb.add_scalar(f"{s}/total_points", rec["points"], it)
            tb.add_scalar(f"{s}/psnr", rec["psnr"], it)

    gui = None
    if args.gui and lead:
        from fourdgs_tpu_torch.viewer.network_gui import NetworkGui
        gui = NetworkGui(dev)
        gui.init(args.ip, args.port)
        print(f"viewer bridge listening on {args.ip}:{args.port}",
              flush=True)

    @functools.lru_cache(maxsize=4)
    def gui_raster_cfg(w, h):
        return config_mod.raster_config_from(cfg, w, h)

    def make_on_iteration(stage):
        """The viewer's poll after each iteration: each frame an eager
        render of the live state (its identity changes at every surgery)
        at the client's size, at the iteration's video timestamp."""
        if gui is None:
            return None

        def on_iteration(it, state, active_sh):
            n_video = max(len(scene.video), 1)
            t = float(scene.video.times[it % n_video])

            @torch.no_grad()
            def gui_render(camera, w, h, scaling_modifier):
                return render(state.params["gauss"], state.params["deform"],
                              camera, bg, gui_raster_cfg(w, h), state.aabb,
                              state.alive, active_sh, stage=stage,
                              scale_modifier=scaling_modifier).color

            gui.poll(gui_render, cfg.model.source_path, time=t)
        return on_iteration

    epoch_order_fn = None
    if cfg.opt.custom_sampler:
        from fourdgs_tpu_torch.train.sampler import fine_sample_order
        frame_length = len(np.unique(scene.train.times))
        n_poses = max(len(scene.train) // max(frame_length, 1), 1)

        def epoch_order_fn(r):
            return fine_sample_order(len(scene.train), n_poses, r)

    test_psnrs: dict[str, list] = {"coarse": [], "fine": []}
    sharded_eval = None
    if mesh is not None and raster_cfg.num_tiles % mesh.n_tile == 0:
        from fourdgs_tpu_torch.render.serve import Renderer
        from fourdgs_tpu_torch.tools.render import MeshRenderer
        sharded_eval = MeshRenderer(Renderer(
            gauss=st.params["gauss"], alive=st.alive,
            deform=st.params["deform"], aabb=st.aabb, bg=bg,
            raster_cfg=raster_cfg, sh_degree=0, device=dev), mesh)

    def make_on_test(stage):
        def eval_split(split, name, it, state, active_sh, rcfg, n=None,
                       save_triptych=False):
            n = len(split) if n is None else min(len(split), n)
            out, renders = [], []
            for i in range(n):
                rendered, drops = eval_output(state, split.cameras[i], bg,
                                              stage, active_sh, rcfg,
                                              sharded=sharded_eval)
                img = torch.clamp(rendered.color, 0, 1)
                gt = split.images[[i]][0]
                out.append(losses.psnr(img, gt)[0])
                renders.append(drops)
                if save_triptych and i == 0 and lead:
                    render_training_image(
                        os.path.join(cfg.model.model_path, "train_render",
                                     f"{stage}{name}"),
                        f"{stage}{name}", it, 0.0, gt.cpu().numpy(),
                        img.cpu().numpy(), rendered.depth.cpu().numpy(),
                        float(split.times[i]))
            return torch.stack(out).cpu().tolist(), renders

        def on_test(it, state, active_sh, raster_cfg):
            rcfg = raster_cfg
            test, renders = eval_split(
                scene.test, "test", it, state, active_sh, rcfg,
                save_triptych=cfg.model.render_process)
            train, _ = eval_split(scene.train, "train", it, state,
                                  active_sh, rcfg, n=5)
            if lead:
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
            if tb is not None:
                write_eval_summaries(tb, stage, it, state,
                                     float(np.mean(test)),
                                     float(np.mean(train)))
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
    try:
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
                    on_iteration=make_on_iteration(stage),
                    start_iteration=start_it, initial_active_sh=active_sh,
                    capture=False if profile else None, mesh=mesh)
            if profile and lead:
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
            if lead:
                print(f"{stage} stage done in {res.wall_time:.1f}s "
                      f"({int(st.alive.sum())} points)", flush=True)
    finally:
        if gui is not None:
            gui.close()
        if tb is not None:
            tb.close()
    if mesh is not None:
        from fourdgs_tpu_torch.parallel.multihost import (gather_objects,
                                                          ranks_agree)
        from fourdgs_tpu_torch.train import graphs
        agree, digest = ranks_agree(
            optim.param_leaves(st.params) + [st.alive, st.denom,
                                             st.xyz_gradient_accum,
                                             st.max_radii2d],
            mesh.group)
        # each rank's kernel runs (rank r > 0 blends, binds and gathers
        # at a nonzero band and gaussian offset)
        summary["mesh"] = {"shape": [mesh.n_data, mesh.n_tile],
                           "ranks_equal": agree, "digest": digest,
                           "kernel_runs": gather_objects(graphs.kernel_runs(),
                                                         mesh.group),
                           "eval_frames": None if sharded_eval is None else {
                               "captured": sharded_eval.captures,
                               "captures": sharded_eval.renderer.captured,
                               "replays": sharded_eval.renderer.replayed}}
        write_log({"mesh": summary["mesh"]})
        if lead:
            print(f"mesh ranks' final states equal: {agree} ({digest[:16]})",
                  flush=True)
        if not agree:
            raise RuntimeError("the mesh's ranks ended with different "
                               "states")
    if lead:
        print(f"\nTraining complete in {total_time:.1f}s "
              f"(excl. eval/saving).")
    return summary


if __name__ == "__main__":
    main()
