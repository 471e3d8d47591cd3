"""A synthetic animated scene in the Blender (D-NeRF) layout
(counterpart: scripts/make_synthetic_scene.py, its monocular protocol).

    python -m fourdgs_tpu_torch.tools.make_synthetic_scene <out_dir> \\
        [--size 800] [--n_train 60] [--n_test 10] [--device cpu]

Twelve coloured blobs of gaussians on sinusoidal paths (`ball_scene`) are
rendered with the port's rasterizer from cameras on a circle around the
origin (`lookat_c2w`), one view per timestamp, into
transforms_{train,test}.json and RGBA PNGs written by the port's own codec
(data/png.py). The default size is the Blender reader's RESOLUTION, so the
scene trains at its stored size.
"""
from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch

from fourdgs_tpu_torch.data.camera import make_camera
from fourdgs_tpu_torch.data.png import write_png
from fourdgs_tpu_torch.data.scene_info import blender_matrix_to_rt
from fourdgs_tpu_torch.ops.rasterize_tiled import RasterConfig, rasterize
from fourdgs_tpu_torch.utils.device import resolve_device

FOVX = 0.8


def ball_scene(t: float, n_balls: int = 12, pts_per_ball: int = 300,
               seed: int = 3):
    """Gaussian blobs on sinusoidal paths at time t in [0, 1]: means,
    scales, quaternions, opacities and colours as float32 arrays."""
    rng = np.random.default_rng(seed)
    centers = rng.uniform(-0.9, 0.9, (n_balls, 3))
    vel = rng.uniform(-0.8, 0.8, (n_balls, 3))
    phase = rng.uniform(0, 2 * np.pi, n_balls)
    colors = rng.uniform(0.2, 1.0, (n_balls, 3))
    radius = rng.uniform(0.08, 0.18, n_balls)

    means, cols, scales = [], [], []
    for b in range(n_balls):
        c = centers[b] + vel[b] * np.sin(2 * np.pi * t + phase[b]) * 0.4
        offs = rng.normal(0, radius[b] * 0.5, (pts_per_ball, 3))
        means.append(c + offs)
        cols.append(np.tile(colors[b], (pts_per_ball, 1)))
        scales.append(np.full((pts_per_ball, 3), radius[b] * 0.25))
    means = np.concatenate(means).astype(np.float32)
    cols = np.concatenate(cols).astype(np.float32)
    scales = np.concatenate(scales).astype(np.float32)
    n = len(means)
    quats = np.tile(np.array([1.0, 0, 0, 0], np.float32), (n, 1))
    opac = np.full(n, 0.8, np.float32)
    return means, scales, quats, opac, cols


def lookat_c2w(theta: float, phi: float = -0.4, radius: float = 4.0):
    """OpenGL-style camera-to-world looking at the origin."""
    pos = radius * np.array([np.sin(theta) * np.cos(phi),
                             -np.sin(phi),
                             np.cos(theta) * np.cos(phi)])
    fwd = pos / np.linalg.norm(pos)           # OpenGL: -z is the view dir
    up = np.array([0.0, 1.0, 0.0])
    right = np.cross(up, fwd)
    right /= np.linalg.norm(right)
    true_up = np.cross(fwd, right)
    c2w = np.eye(4)
    c2w[:3, 0] = right
    c2w[:3, 1] = true_up
    c2w[:3, 2] = fwd
    c2w[:3, 3] = pos
    return c2w


@torch.no_grad()
def write_split(out_dir: str, name: str, n_views: int, theta_offset: float,
                size: int, device):
    """Render n_views views at times i / (n_views - 1) over a white
    background into <out_dir>/<name>/ and write transforms_<name>.json."""
    cfg = RasterConfig(img_width=size, img_height=size, tile_size=16,
                       tile_cap=512, chunk=32)
    bg = torch.ones(3, device=device)
    os.makedirs(os.path.join(out_dir, name), exist_ok=True)
    frames = []
    for i in range(n_views):
        t = i / max(n_views - 1, 1)
        theta = 2 * np.pi * (i * 7 % n_views) / n_views + theta_offset
        c2w = lookat_c2w(theta)
        R, T = blender_matrix_to_rt(c2w)
        camera = make_camera(R, T, FOVX, FOVX, time=t, device=device)
        m, s, q, o, c = (torch.from_numpy(x).to(device)
                         for x in ball_scene(t))
        img = rasterize(m, s, q, o, c, camera, bg, cfg).color.cpu().numpy()
        rgba = np.concatenate([np.clip(img, 0, 1),
                               np.ones((size, size, 1), np.float32)], -1)
        write_png(os.path.join(out_dir, f"{name}/r_{i}.png"),
                  (rgba * 255).astype(np.uint8))
        frames.append({"file_path": f"./{name}/r_{i}", "time": t,
                       "transform_matrix": c2w.tolist()})
    with open(os.path.join(out_dir, f"transforms_{name}.json"), "w") as f:
        json.dump({"camera_angle_x": FOVX, "frames": frames}, f)


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("out_dir")
    parser.add_argument("--size", type=int, default=800)
    parser.add_argument("--n_train", type=int, default=60)
    parser.add_argument("--n_test", type=int, default=10)
    parser.add_argument("--device", default=None,
                        help="default cuda; 'cpu' runs the plain path")
    args = parser.parse_args(argv)
    dev = resolve_device(args.device)
    write_split(args.out_dir, "train", args.n_train, 0.0, args.size, dev)
    write_split(args.out_dir, "test", args.n_test, 0.13, args.size, dev)
    print(f"synthetic dynamic scene written to {args.out_dir}")


if __name__ == "__main__":
    main()
