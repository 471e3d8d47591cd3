"""Render several trained 4DGS models together, each under its own rigid
transform, into one video: the scene-editing demo
(counterpart: scripts/merge_many_4dgs.py).

    python -m fourdgs_tpu_torch.tools.merge_many -m <model> [<model> ...] \\
        -s <scene> [--offsets dx,dy,dz ...] [--scales s ...] \\
        [--out merged] [--n_frames 60] [--device cpu]

At each of the first `--n_frames` video cameras of the scene `-s`, every
model's snapshot is deformed at the camera's timestamp
(render/state_at_time.py), its alive gaussians moved to
`xyz * scale + offset` and their scales to `exp(scaling) * scale`, their
colours taken from the SH at degree 3 toward the camera centre and their
opacities through a sigmoid; then all models' gaussians go through one
`rasterize` call (K1 and the binner on the card) at the default
RasterConfig and the video's size, on a black background. Each frame is
written to <out>/{i:05d}.png, and merged.mp4 where imageio imports. An
offset may start with a minus sign (`--offsets 0.6,0,0 -0.6,0,0`).
"""
from __future__ import annotations

import argparse
import os
import re
import sys
import time

import numpy as np
import torch

from fourdgs_tpu_torch.data.png import write_png
from fourdgs_tpu_torch.ops import sh as sh_ops
from fourdgs_tpu_torch.ops.rasterize_tiled import RasterConfig, rasterize
from fourdgs_tpu_torch.render.serve import _full_float32
from fourdgs_tpu_torch.render.state_at_time import get_state_at_time
from fourdgs_tpu_torch.tools.render import quantise
from fourdgs_tpu_torch.train import checkpoint
from fourdgs_tpu_torch.utils.device import resolve_device


def merged_splats(models: list, camera, t: float):
    """The rasterizer's inputs (means, scales, quats, opacities, colors)
    of every model at timestamp t, concatenated in the models' order.
    `models` holds (gauss, alive row indices, deformation, aabb, offset
    (3,) tensor, scale)."""
    parts = []
    for gauss, rows, deform, aabb, offset, scale in models:
        xyz, scaling, rotation, opacity, shs = (
            x.index_select(0, rows)
            for x in get_state_at_time(gauss, deform, aabb, t))
        xyz = xyz * scale + offset
        dirs = xyz - camera.cam_center
        dirs = dirs / torch.clamp(
            torch.linalg.vector_norm(dirs, dim=-1, keepdim=True), min=1e-8)
        parts.append((xyz, torch.exp(scaling) * scale, rotation,
                      torch.sigmoid(opacity)[:, 0],
                      sh_ops.sh_to_rgb(3, shs, dirs)))
    return tuple(torch.cat(cols) for cols in zip(*parts))


def _offset_values(argv: list) -> list:
    """argv with each value of --offsets that starts with a minus sign
    (argparse would take '-0.6,0,0' for an option) prefixed by a space,
    which float() ignores."""
    out, taking = [], False
    for a in argv:
        if a == "--offsets":
            taking = True
        elif taking and re.fullmatch(r"-[\d.]+(,-?[\d.]+)*", a):
            a = " " + a
        elif a.startswith("-"):
            taking = False
        out.append(a)
    return out


def main(argv=None) -> dict:
    """Write the frames; returns a summary: the frame count, the seconds
    of each frame (rendered and copied to the host, the PNG's writing
    left out) and each frame's drops."""
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("-m", "--model_paths", nargs="+", required=True)
    parser.add_argument("-s", "--source_path", required=True,
                        help="scene providing the camera path")
    parser.add_argument("--offsets", nargs="+", default=[],
                        help="per-model 'dx,dy,dz' translations")
    parser.add_argument("--scales", nargs="+", type=float, default=[])
    parser.add_argument("--out", default="merged")
    parser.add_argument("--n_frames", type=int, default=60)
    parser.add_argument("--device", default=None,
                        help="default cuda; 'cpu' runs the plain path")
    args = parser.parse_args(_offset_values(
        sys.argv[1:] if argv is None else list(argv)))
    dev = resolve_device(args.device)
    _full_float32()

    models = []
    with torch.no_grad():
        for i, mp in enumerate(args.model_paths):
            _, gauss, alive, deform, aabb, _ = checkpoint.load_model(
                mp, -1, dev)
            offset = np.zeros(3)
            if i < len(args.offsets):
                offset = np.array([float(x)
                                   for x in args.offsets[i].split(",")])
            scale = args.scales[i] if i < len(args.scales) else 1.0
            models.append((gauss, torch.nonzero(alive)[:, 0], deform, aabb,
                           torch.as_tensor(offset, dtype=torch.float32,
                                           device=dev), float(scale)))

    from fourdgs_tpu_torch.data.scene import Scene
    scene = Scene.load(args.source_path, load_images=False, device=dev)
    cams = scene.video
    rcfg = RasterConfig(img_width=cams.width, img_height=cams.height)
    bg = torch.zeros(3, device=dev)
    os.makedirs(args.out, exist_ok=True)

    frames, seconds, drops = [], [], []
    n = min(args.n_frames, len(cams))
    for fi in range(n):
        t0 = time.perf_counter()
        cam = cams.cameras[fi]
        with torch.no_grad():
            out = rasterize(*merged_splats(models, cam, float(cams.times[fi])),
                            cam, bg, rcfg)
            img = quantise(out.color)
        seconds.append(time.perf_counter() - t0)
        drops.append({"dropped_pairs": int(out.dropped_pairs),
                      "dropped_tile": int(out.dropped_tile),
                      "num_pairs": int(out.num_pairs)})
        write_png(os.path.join(args.out, f"{fi:05d}.png"), img)
        frames.append(img)
        print(f"frame {fi + 1}/{n} ({seconds[-1] * 1e3:.2f} ms, drops "
              f"{drops[-1]})", flush=True)
    try:
        import imageio
        imageio.mimwrite(os.path.join(args.out, "merged.mp4"), frames,
                         fps=30)
    except Exception as e:
        print(f"mp4 skipped: {e}")
    return {"frames": n, "seconds": seconds, "drops": drops,
            "gaussians": sum(int(m[1].numel()) for m in models)}


if __name__ == "__main__":
    main()
