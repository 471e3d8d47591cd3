"""Blender / D-NeRF synthetic dataset reader
(counterpart: fourdgs_tpu/data/blender.py).

transforms_{train,test}.json with per-frame `time` and `transform_matrix`,
images alpha-composited onto the background color, timestamps normalised
to [0, 1] over the union of the train and test times, a spherical video
path (160 poses, phi -30 degrees, radius 4), and a random 2,000-point
initial cloud when the scene has no fused.ply.

Images are decoded by the port's own PNG codec (data/png.py); an image of
another size than `resolution` is quantised by truncation and resized with
Pillow's default filter, BICUBIC (data/resample.py), as the JAX reader
does with PIL.
"""
from __future__ import annotations

import json
import os
from pathlib import Path

import numpy as np

from fourdgs_tpu_torch.data import ply
from fourdgs_tpu_torch.data.png import read_png
from fourdgs_tpu_torch.data.resample import resize
from fourdgs_tpu_torch.data.scene_info import (CameraInfo, PointCloud,
                                               SceneInfo,
                                               blender_matrix_to_rt,
                                               nerfpp_norm)
from fourdgs_tpu_torch.ops.sh import sh_dc_to_rgb
from fourdgs_tpu_torch.ops.transforms import focal2fov, fov2focal

RESOLUTION = (800, 800)


def _load_image(path: str, white_background: bool,
                resolution=RESOLUTION) -> np.ndarray:
    """(H, W, 3) float32 in [0, 1], RGBA composited over the background.
    The composite runs in float64 (the background is float64, as in the
    JAX package) and is cast to float32 at the end. An image whose (H, W)
    is not `resolution` is resized to `resolution` taken as (W, H), the
    JAX reader's comparison and PIL's order."""
    img = read_png(path)
    if img.shape[2] == 3:       # what PIL's convert("RGBA") does to RGB
        img = np.concatenate(
            [img, np.full(img.shape[:2] + (1,), 255, np.uint8)], axis=2)
    im_data = np.array(img, dtype=np.float32) / 255.0
    bg = np.array([1.0, 1, 1] if white_background else [0.0, 0, 0])
    rgb = im_data[:, :, :3] * im_data[:, :, 3:4] + bg * (1 - im_data[:, :, 3:4])
    if resolution is not None and (rgb.shape[0], rgb.shape[1]) != resolution:
        rgb = resize((rgb * 255).astype(np.uint8), resolution,
                     "bicubic").astype(np.float32) / 255.0
    return rgb.astype(np.float32)


def read_timeline(path: str):
    """{time: time / max_time} over both splits, and max_time."""
    times = []
    for split in ("transforms_train.json", "transforms_test.json"):
        with open(os.path.join(path, split)) as f:
            times += [fr["time"] for fr in json.load(f)["frames"]]
    timeline = sorted(set(times))
    max_time = max(timeline)
    return {t: t / max_time for t in timeline}, max_time


def read_cameras_from_transforms(path: str, transformsfile: str,
                                 white_background: bool, extension: str,
                                 mapper: dict,
                                 resolution=RESOLUTION) -> list[CameraInfo]:
    with open(os.path.join(path, transformsfile)) as f:
        contents = json.load(f)
    fovx = contents.get("camera_angle_x")
    if fovx is None:
        fovx = focal2fov(contents["fl_x"], contents["w"])
    infos = []
    for idx, frame in enumerate(contents["frames"]):
        cam_name = frame["file_path"] + extension
        time = mapper[frame["time"]]
        R, T = blender_matrix_to_rt(frame["transform_matrix"])
        image_path = os.path.join(path, cam_name)
        image = _load_image(image_path, white_background, resolution)
        h, w = image.shape[:2]
        fovy = focal2fov(fov2focal(fovx, w), h)
        infos.append(CameraInfo(
            uid=idx, R=R, T=T, fovx=fovx, fovy=fovy, image=image,
            image_path=image_path, image_name=Path(cam_name).stem,
            width=w, height=h, time=time))
    return infos


def _pose_spherical(theta: float, phi: float, radius: float) -> np.ndarray:
    """NeRF-style spherical camera-to-world."""
    def trans_t(t):
        m = np.eye(4)
        m[2, 3] = t
        return m

    def rot_phi(p):
        m = np.eye(4)
        m[1, 1] = np.cos(p); m[1, 2] = -np.sin(p)
        m[2, 1] = np.sin(p); m[2, 2] = np.cos(p)
        return m

    def rot_theta(t):
        m = np.eye(4)
        m[0, 0] = np.cos(t); m[0, 2] = -np.sin(t)
        m[2, 0] = np.sin(t); m[2, 2] = np.cos(t)
        return m

    c2w = trans_t(radius)
    c2w = rot_phi(phi / 180.0 * np.pi) @ c2w
    c2w = rot_theta(theta / 180.0 * np.pi) @ c2w
    c2w = np.array([[-1.0, 0, 0, 0], [0, 0, 1, 0],
                    [0, 1, 0, 0], [0, 0, 0, 1]]) @ c2w
    return c2w


def generate_spherical_video_cameras(path: str, template_transformsfile: str,
                                     maxtime: float, n_poses: int = 160,
                                     resolution=RESOLUTION) -> list[CameraInfo]:
    with open(os.path.join(path, template_transformsfile)) as f:
        contents = json.load(f)
    fovx = contents.get("camera_angle_x")
    if fovx is None:
        fovx = focal2fov(contents["fl_x"], contents["w"])
    w, h = resolution
    fovy = focal2fov(fov2focal(fovx, w), h)
    infos = []
    angles = np.linspace(-180, 180, n_poses + 1)[:-1]
    times = np.linspace(0, maxtime, n_poses) / maxtime
    for idx, (angle, time) in enumerate(zip(angles, times)):
        c2w = _pose_spherical(angle, -30.0, 4.0)
        R, T = blender_matrix_to_rt(c2w)
        infos.append(CameraInfo(
            uid=idx, R=R, T=T, fovx=fovx, fovy=fovy, image=None,
            image_path=None, image_name=None, width=w, height=h,
            time=float(time)))
    return infos


def read_blender_scene(path: str, white_background: bool, eval_split: bool,
                       extension: str = ".png",
                       resolution=RESOLUTION,
                       rng: np.random.Generator | None = None) -> SceneInfo:
    """The scene's cameras and images, and the initial point cloud: the
    scene's fused.ply, or 2,000 random points from `rng` (default
    np.random.default_rng(0), the JAX package's)."""
    mapper, max_time = read_timeline(path)
    train = read_cameras_from_transforms(path, "transforms_train.json",
                                         white_background, extension, mapper,
                                         resolution)
    test = read_cameras_from_transforms(path, "transforms_test.json",
                                        white_background, extension, mapper,
                                        resolution)
    video = generate_spherical_video_cameras(path, "transforms_train.json",
                                             max_time, resolution=resolution)
    if not eval_split:
        train = train + test
        test = []

    norm = nerfpp_norm(train)
    ply_path = os.path.join(path, "fused.ply")
    if os.path.exists(ply_path):
        pts, cols, normals = ply.fetch_point_cloud(ply_path)
        pcd = PointCloud(points=pts, colors=cols, normals=normals)
    else:
        # random init inside the synthetic scene bounds
        rng = rng or np.random.default_rng(0)
        num_pts = 2000
        xyz = (rng.random((num_pts, 3)) * 2.6 - 1.3).astype(np.float32)
        shs = rng.random((num_pts, 3)).astype(np.float32) / 255.0
        pcd = PointCloud(points=xyz,
                         colors=np.asarray(sh_dc_to_rgb(shs), np.float32),
                         normals=np.zeros((num_pts, 3), np.float32))

    return SceneInfo(point_cloud=pcd, train_cameras=train, test_cameras=test,
                     video_cameras=video, nerf_normalization=norm,
                     ply_path=ply_path, maxtime=max_time)
