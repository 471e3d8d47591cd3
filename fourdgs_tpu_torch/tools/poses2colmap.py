"""Known poses into a COLMAP text sparse model for the triangulation
pipeline (counterpart: scripts/poses2colmap.py): cameras.txt, images.txt
and an empty points3D.txt, ready for `colmap point_triangulator`.

    python -m fourdgs_tpu_torch.tools.poses2colmap transforms_train.json \\
        <out_dir> [--width 800] [--height 800]
    python -m fourdgs_tpu_torch.tools.poses2colmap poses_bounds.npy <out_dir>
    python -m fourdgs_tpu_torch.tools.poses2colmap <hypernerf capture dir>

The input picks the layout: a Blender (D-NeRF) transforms file, an LLFF
`poses_bounds.npy` (DyNeRF), or a HyperNeRF (nerfies) capture directory
with camera/ and rgb/2x/, which writes <input>/sparse_ and copies the
chosen frames to <input>/image_colmap as the JAX script does. Host code,
numpy only; the files equal the JAX script's byte for byte.
"""
from __future__ import annotations

import argparse
import json
import os
import shutil

import numpy as np

from fourdgs_tpu_torch.data.colmap import rotmat2qvec
from fourdgs_tpu_torch.data.llff_poses import c2w_to_rt, load_poses_bounds
from fourdgs_tpu_torch.data.scene_info import blender_matrix_to_rt
from fourdgs_tpu_torch.ops.transforms import fov2focal


def write_sparse_text(out_dir, cameras, images):
    """cameras: {id: (model, w, h, params)}; images: [(id, qvec, tvec,
    cam_id, name)]."""
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "cameras.txt"), "w") as f:
        f.write("# Camera list\n")
        for cid, (model, w, h, params) in cameras.items():
            f.write(f"{cid} {model} {w} {h} "
                    + " ".join(str(p) for p in params) + "\n")
    with open(os.path.join(out_dir, "images.txt"), "w") as f:
        f.write("# Image list\n")
        for iid, qvec, tvec, cam_id, name in images:
            f.write(f"{iid} " + " ".join(f"{v:.10f}" for v in qvec) + " "
                    + " ".join(f"{v:.10f}" for v in tvec)
                    + f" {cam_id} {name}\n\n")
    open(os.path.join(out_dir, "points3D.txt"), "w").close()


def from_blender(path: str, out_dir: str, width=800, height=800):
    with open(path) as f:
        contents = json.load(f)
    focal = fov2focal(contents["camera_angle_x"], width)
    cameras = {1: ("SIMPLE_PINHOLE", width, height,
                   [focal, width / 2, height / 2])}
    images = []
    for i, frame in enumerate(contents["frames"]):
        R, T = blender_matrix_to_rt(frame["transform_matrix"])
        # COLMAP stores world->cam: R_w2c = R.T, t = T
        name = os.path.basename(frame["file_path"]) + ".png"
        images.append((i + 1, rotmat2qvec(R.T), T, 1, name))
    write_sparse_text(out_dir, cameras, images)
    print(f"wrote {len(images)} poses to {out_dir}")


def from_llff(path: str, out_dir: str, image_names=None):
    poses, _, hwf = load_poses_bounds(path)
    h, w, focal = int(hwf[0]), int(hwf[1]), float(hwf[2])
    cameras = {1: ("SIMPLE_PINHOLE", w, h, [focal, w / 2, h / 2])}
    images = []
    for i, pose in enumerate(poses):
        R, T = c2w_to_rt(pose)
        name = (image_names[i] if image_names
                else f"cam{i:02d}/frame_00001.jpg")
        images.append((i + 1, rotmat2qvec(R.T), T, 1, name))
    write_sparse_text(out_dir, cameras, images)
    print(f"wrote {len(images)} poses to {out_dir}")


def from_hypernerf(root_dir: str, max_images: int = 200,
                   copy_images: bool = True):
    """A HyperNeRF capture: the nerfies camera JSONs under camera/ and the
    2x frames under rgb/2x/, every `step`-th frame kept (step from 2 up
    until at most `max_images` remain), one SIMPLE_PINHOLE camera an image
    (focal and principal point halved for the 2x frames), each image
    referencing its own camera; writes <root_dir>/sparse_ and copies the
    kept frames to <root_dir>/image_colmap."""
    image_dir = os.path.join(root_dir, "rgb", "2x")
    names = sorted(os.listdir(image_dir))
    cams = []
    for jf in sorted(os.listdir(os.path.join(root_dir, "camera"))):
        with open(os.path.join(root_dir, "camera", jf)) as f:
            cams.append(json.load(f))
    step = 2
    while len(cams) // step > max_images:
        step += 1
    out_dir = os.path.join(root_dir, "sparse_")
    img_out = os.path.join(root_dir, "image_colmap")
    if copy_images:
        os.makedirs(img_out, exist_ok=True)
    cameras, images, idx = {}, [], 0
    for cnt, (cam, name) in enumerate(zip(cams, names), 1):
        if cnt % step != 0:
            continue
        # nerfies: world->camera rows and the position in world space;
        # COLMAP: the world->cam quaternion and t = -R_w2c @ position
        r_w2c = np.array(cam["orientation"])
        tvec = -r_w2c @ np.array(cam["position"])
        w, h = (int(v) for v in cam["image_size"])
        cameras[idx + 1] = ("SIMPLE_PINHOLE", w // 2, h // 2,
                            [cam["focal_length"] / 2,
                             cam["principal_point"][0] / 2,
                             cam["principal_point"][1] / 2])
        images.append((idx + 1, rotmat2qvec(r_w2c), tvec, idx + 1, name))
        if copy_images:
            shutil.copy(os.path.join(image_dir, name),
                        os.path.join(img_out, name))
        idx += 1
    write_sparse_text(out_dir, cameras, images)
    print(f"wrote {idx} poses to {out_dir}")


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("input", help="transforms json, poses_bounds.npy, "
                        "or a HyperNeRF capture dir (camera/ + rgb/2x)")
    parser.add_argument("out_dir", nargs="?", default=None,
                        help="output sparse dir (unused for hypernerf: "
                        "writes <input>/sparse_ like the reference)")
    parser.add_argument("--width", type=int, default=800)
    parser.add_argument("--height", type=int, default=800)
    args = parser.parse_args(argv)
    if os.path.isdir(args.input):
        from_hypernerf(args.input)
    elif args.input.endswith(".npy"):
        from_llff(args.input, args.out_dir)
    else:
        from_blender(args.input, args.out_dir, args.width, args.height)


if __name__ == "__main__":
    main()
