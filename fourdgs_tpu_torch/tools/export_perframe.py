"""Bake a trained model's deformed gaussians at each timestamp into static
3DGS PLY files, so that any 3DGS viewer can play the sequence frame by
frame (counterpart: scripts/export_perframe_3DGS.py).

    python -m fourdgs_tpu_torch.tools.export_perframe -m <model> \\
        [-s <scene>] [--iteration N] [--n_frames N] [--device cpu]

The snapshot (the newest, or `--iteration`'s) is deformed on the device
through render/state_at_time.py:get_state_at_time at each timestamp: N
uniform ones in [0, 1] with `--n_frames`, else the test split's distinct
timestamps of the scene (`-s`, or the one the model was trained on).
Each frame's alive rows go to <model>/gaussian_pertimestamp/
time_{i:05d}.ply (data/ply.py:save_gaussians).
"""
from __future__ import annotations

import argparse
import os
import time

import numpy as np

from fourdgs_tpu_torch.data import ply
from fourdgs_tpu_torch.render.serve import _full_float32
from fourdgs_tpu_torch.render.state_at_time import get_state_at_time
from fourdgs_tpu_torch.train import checkpoint
from fourdgs_tpu_torch.utils.device import resolve_device


def main(argv=None) -> list:
    """Write the frames; returns their paths."""
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("-m", "--model_path", required=True)
    parser.add_argument("-s", "--source_path", default=None)
    parser.add_argument("--iteration", type=int, default=-1)
    parser.add_argument("--n_frames", type=int, default=0,
                        help="bake N uniform timestamps instead of the "
                             "test split's")
    parser.add_argument("--device", default=None,
                        help="default cuda; 'cpu' runs the plain path")
    args = parser.parse_args(argv)
    dev = resolve_device(args.device)
    _full_float32()
    cfg, gauss, alive, deform, aabb, _ = checkpoint.load_model(
        args.model_path, args.iteration, dev)
    if args.n_frames:
        times = np.linspace(0, 1, args.n_frames)
    else:
        from fourdgs_tpu_torch.data.scene import Scene
        scene = Scene.load(args.source_path or cfg.model.source_path,
                           white_background=cfg.model.white_background,
                           eval_split=cfg.model.eval, load_images=False,
                           device=dev)
        times = np.unique(scene.test.times)

    out_root = os.path.join(args.model_path, "gaussian_pertimestamp")
    os.makedirs(out_root, exist_ok=True)
    keep = alive.cpu().numpy()
    paths = []
    for i, t in enumerate(times):
        t0 = time.perf_counter()
        xyz, scaling, rotation, opacity, shs = (
            x.cpu().numpy()[keep]
            for x in get_state_at_time(gauss, deform, aabb, float(t)))
        path = os.path.join(out_root, f"time_{i:05d}.ply")
        ply.save_gaussians(path, xyz, shs[:, :1], shs[:, 1:], opacity,
                           scaling, rotation)
        paths.append(path)
        print(f"baked t={t:.4f} -> time_{i:05d}.ply ({keep.sum()} pts, "
              f"{time.perf_counter() - t0:.3f} s)", flush=True)
    return paths


if __name__ == "__main__":
    main()
