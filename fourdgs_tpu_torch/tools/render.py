"""Rendering CLI: a trained model's train, test and video splits as PNGs,
with the frames per second over each split (counterpart:
scripts/render.py).

    python -m fourdgs_tpu_torch.tools.render -m <model> [-s <scene>] \\
        [--iteration N] [--skip_train] [--skip_test] [--skip_video] \\
        [--image_size W H] [--configs <config.py>] [--device cpu]

The snapshot (the newest, or `--iteration`'s) is loaded by
`render.serve.Renderer.from_snapshot` at the scene's size, with the cap
probe on the first train camera, as the JAX script probes. Other views may
need more pairs than that one: where a split's render overflowed the caps,
they grow by the probe's rule and the split is rendered again, so that the
PNGs hold every splat (the JAX script writes such renders with their
drops). Each split is written to <model>/<split>/ours_<iteration>/renders/
(and gt/ for the train and test splits) as 00000.png, 00001.png, ...,
quantised as the JAX script quantises, `(clip(x, 0, 1) * 255).astype(uint8)`;
the video split also goes to video_rgb.mp4 when `imageio` imports. The FPS
is timed over the split's last pass after one untimed frame, each frame
copied to the host as the JAX script's `np.asarray` does; on the card every
frame is a replay of the captured frame (train/graphs.py).

The scene is read through `data.scene.Scene.load` at the model's
`resolution` divisor (cfg_args.json), the Blender layout at 800x800 or
`--image_size`. Every split renders at the train split's size, as in the
JAX script (a HyperNeRF video view's full-resolution size is not used);
DyNeRF's and MultipleView's video split is their 300 spiral poses,
PanopticSports' its test split, Colmap's its train split. A host or lazy
image bank serves the targets view by view. `--mesh` is not ported yet and
raises.
"""
from __future__ import annotations

import argparse
import concurrent.futures
import dataclasses
import os
import time

import numpy as np
import torch

from fourdgs_tpu_torch.data.png import write_png
from fourdgs_tpu_torch.data.scene import Scene, StackedCameras
from fourdgs_tpu_torch.render.serve import PROBE_ROUNDS, Renderer, overflows
from fourdgs_tpu_torch.train import config as config_mod
from fourdgs_tpu_torch.utils.device import resolve_device

_WRITERS = 8


def quantise(img) -> np.ndarray:
    """A float image in [0, 1] as 8-bit, truncated (the JAX script's
    `write_png`); a tensor is converted on its device and only the bytes
    are copied to the host."""
    if isinstance(img, torch.Tensor):
        return (torch.clamp(img, 0, 1) * 255).to(torch.uint8).cpu().numpy()
    return (np.clip(img, 0, 1) * 255).astype(np.uint8)


def render_split(renderer: Renderer, name: str, split: StackedCameras,
                 out_dir: str, with_gt: bool,
                 pool: concurrent.futures.Executor) -> dict:
    """Render every view of `split` into <out_dir>/renders (and the
    targets into <out_dir>/gt). A view whose render overflowed the caps
    (`render.serve.overflows`) grows them and the split is rendered again,
    up to the probe's rounds. Returns the view count, the renders made
    (untimed ones included), the passes, the last pass's seconds, FPS and
    drops, and its frames (float32 (H, W, 3) on the host)."""
    dev = renderer.device
    n, renders = len(split), 0
    for passes in range(1, PROBE_ROUNDS + 1):
        renderer.render(split.cameras[0])       # untimed: capture, warm-up
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        frames, drops = [], []
        for cam in split.cameras:
            out = renderer.render(cam)
            frames.append(out.color.cpu().numpy())
            drops.append(torch.stack([out.dropped_pairs, out.dropped_tile,
                                      out.num_pairs]))
        seconds = time.perf_counter() - t0
        renders += n + 1
        drops = torch.stack(drops).cpu().numpy()
        over = [overflows(*map(int, d)) for d in drops]
        if passes == PROBE_ROUNDS:
            break
        changes = renderer.grow_caps(any(p for p, _ in over),
                                     any(t for _, t in over))
        if not changes:
            break
        print(f"{name}: {sum(map(any, over))} views overflowed the caps: "
              f"growing {changes}, rendering again")
    renders_dir = os.path.join(out_dir, "renders")
    gt_dir = os.path.join(out_dir, "gt")
    os.makedirs(renders_dir, exist_ok=True)
    os.makedirs(gt_dir, exist_ok=True)
    futures = [pool.submit(write_png,
                           os.path.join(renders_dir, f"{i:05d}.png"),
                           quantise(img)) for i, img in enumerate(frames)]
    if with_gt and split.images is not None:
        futures += [pool.submit(write_png,
                                os.path.join(gt_dir, f"{i:05d}.png"),
                                quantise(split.images[[i]][0].cpu().numpy()))
                    for i in range(n)]
    for f in futures:
        f.result()
    return {"views": n, "renders": renders, "passes": passes,
            "seconds": seconds, "fps": n / max(seconds, 1e-9),
            "dir": out_dir, "max_dropped_pairs": int(drops[:, 0].max()),
            "max_dropped_tile": int(drops[:, 1].max()),
            "views_dropping": int((drops[:, :2].sum(axis=1) > 0).sum()),
            "frames": frames}


def write_video(path: str, frames: list) -> bool:
    """video_rgb.mp4 at 30 FPS through imageio, when it imports; prints
    why not otherwise."""
    try:
        import imageio
        imageio.mimwrite(path, [quantise(f) for f in frames], fps=30)
    except Exception as e:  # imageio and its ffmpeg are optional
        print(f"video writing skipped: {e}")
        return False
    return True


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="4DGS rendering (PyTorch)")
    parser.add_argument("-m", "--model_path", required=True)
    parser.add_argument("-s", "--source_path", default=None)
    parser.add_argument("--iteration", type=int, default=-1)
    parser.add_argument("--skip_train", action="store_true")
    parser.add_argument("--skip_test", action="store_true")
    parser.add_argument("--skip_video", action="store_true")
    parser.add_argument("--configs", default="")
    parser.add_argument("--mesh", default="",
                        help="multi-GPU mesh 'data,tile' (not ported yet)")
    parser.add_argument("--image_size", nargs=2, type=int, default=None,
                        metavar=("W", "H"),
                        help="the Blender images' size (default 800 800)")
    parser.add_argument("--device", default=None,
                        help="default cuda; 'cpu' runs the plain path")
    return parser


def main(argv=None) -> dict:
    """Render; returns per split its view count, seconds, FPS, drops and
    directory, with the iteration, the device, the cap probe's renders and
    caps, and the captured frames and their replays (0 on the CPU)."""
    args = build_parser().parse_args(argv)
    if args.mesh:
        raise NotImplementedError("--mesh is not ported yet")
    dev = resolve_device(args.device)
    cfg_path = os.path.join(args.model_path, "cfg_args.json")
    cfg = (config_mod.load_cfg(cfg_path) if os.path.exists(cfg_path)
           else config_mod.Config())
    if args.configs:
        cfg = config_mod.apply_config_file(cfg, args.configs)
    scene = Scene.load(args.source_path or cfg.model.source_path,
                       white_background=cfg.model.white_background,
                       eval_split=cfg.model.eval,
                       extension=cfg.model.extension,
                       images=cfg.model.images or None,
                       llffhold=cfg.model.llffhold, device=dev,
                       downscale=max(cfg.model.resolution, 1),
                       resolution=(tuple(args.image_size)
                                   if args.image_size else None))
    renderer = Renderer.from_snapshot(
        args.model_path, args.iteration, dev, scene.train.width,
        scene.train.height, configs=args.configs,
        probe_camera=scene.train.cameras[0])
    it = renderer.iteration
    print(f"rendering snapshot of iteration {it} "
          f"({int(renderer.alive.sum())} points)")
    name = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
            else "cpu")
    summary = {"iteration": it, "device": name, "splits": {}}
    with concurrent.futures.ThreadPoolExecutor(_WRITERS) as pool:
        for split, skip, with_gt in (("train", args.skip_train, True),
                                     ("test", args.skip_test, True),
                                     ("video", args.skip_video, False)):
            if skip:
                continue
            out_dir = os.path.join(args.model_path, split, f"ours_{it}")
            res = render_split(renderer, split, getattr(scene, split),
                               out_dir, with_gt, pool)
            print(f"{split}: {res['views']} views, FPS: {res['fps']:.2f}"
                  + (f" ({res['views_dropping']} views dropped splats)"
                     if res["views_dropping"] else ""), flush=True)
            frames = res.pop("frames")
            if split == "video":
                res["mp4"] = write_video(
                    os.path.join(out_dir, "video_rgb.mp4"), frames)
            summary["splits"][split] = res
    summary.update(probe_renders=renderer.probe_renders,
                   raster_cfg=dataclasses.asdict(renderer.raster_cfg),
                   captures=renderer.captured, replays=renderer.replayed)
    return summary


if __name__ == "__main__":
    main()
