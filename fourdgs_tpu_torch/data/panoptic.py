"""PanopticSports scene reader, the CMU Panoptic sequences as Dynamic 3D
Gaussians distributes them (counterpart: fourdgs_tpu/data/panoptic.py).

{train,test}_meta.json hold, for each timestep, every camera's 3x3
intrinsics K, its 4x4 world-to-camera matrix and its image under ims/;
the initial cloud is init_pt_cld.npz (written out as pointd3D.ply). The
cameras' principal points are off centre, so each camera's projection is
built from K (`camera_from_k_w2c`) rather than from symmetric fields of
view; the frustum clamp stays the symmetric one of w / (2 fx), as in the
JAX package. The test split is also the video split.

A view is a `PanopticCameraInfo`, numpy and plain values only (no tensor
outside the device the split is stacked on);
`data/scene.py:camera_from_info` builds its Camera on the device when the
split is stacked. The reader keeps each view's path and size; the image
bank decodes it (data/images.py, a JPEG through data/jpeg.py).
"""
from __future__ import annotations

import json
import os
from typing import NamedTuple

import numpy as np

from fourdgs_tpu_torch.data import ply
from fourdgs_tpu_torch.data.camera import Camera, f32_tensor
from fourdgs_tpu_torch.data.scene_info import PointCloud, SceneInfo
from fourdgs_tpu_torch.utils.device import resolve_device


class PanopticCameraInfo(NamedTuple):
    k: np.ndarray           # (3, 3) intrinsics
    w2c: np.ndarray         # (4, 4) world -> camera (OpenCV axes)
    image_path: str
    width: int
    height: int
    time: float
    image_name: str
    image: np.ndarray | None = None   # never decoded by the reader


def projection_from_k_w2c(k, w2c, w: int, h: int, near: float = 0.01,
                          far: float = 100.0):
    """float64 (world_view, full_proj, cam_center, tanfovx, tanfovy) of a
    K and a w2c (column vectors), off-centre principal points included."""
    k = np.asarray(k, np.float64)
    w2c = np.asarray(w2c, np.float64)
    fx, fy, cx, cy = k[0][0], k[1][1], k[0][2], k[1][2]
    proj = np.array([
        [2 * fx / w, 0.0, -(w - 2 * cx) / w, 0.0],
        [0.0, 2 * fy / h, -(h - 2 * cy) / h, 0.0],
        [0.0, 0.0, far / (far - near), -(far * near) / (far - near)],
        [0.0, 0.0, 1.0, 0.0]])
    return (w2c, proj @ w2c, np.linalg.inv(w2c)[:3, 3], w / (2 * fx),
            h / (2 * fy))


def camera_from_k_w2c(k, w2c, w: int, h: int, near: float = 0.01,
                      far: float = 100.0, time: float = 0.0,
                      device=None) -> Camera:
    """A Camera on `device` (None: cuda) from a 3x3 K and a 4x4 w2c: the
    matrices in float64 numpy, cast to float32 at the end."""
    device = resolve_device(device)
    view, full, center, tx, ty = projection_from_k_w2c(k, w2c, w, h, near,
                                                       far)
    return Camera(world_view=f32_tensor(view, device),
                  full_proj=f32_tensor(full, device),
                  cam_center=f32_tensor(center, device),
                  tanfovx=f32_tensor(tx, device),
                  tanfovy=f32_tensor(ty, device),
                  time=f32_tensor(time, device))


def read_panoptic_meta(datadir: str, json_path: str):
    """(the views, maxtime = the timesteps' count, the radius: 1.1 x the
    largest distance of a camera centre from their mean at timestep 0)."""
    with open(os.path.join(datadir, json_path)) as f:
        meta = json.load(f)
    w, h = meta["w"], meta["h"]
    max_time = len(meta["fn"])
    cam_infos = []
    for index in range(len(meta["fn"])):
        time = index / len(meta["fn"])
        for k, w2c, fn in zip(meta["k"][index], meta["w2c"][index],
                              meta["fn"][index]):
            cam_infos.append(PanopticCameraInfo(
                k=np.asarray(k, np.float64), w2c=np.asarray(w2c, np.float64),
                image_path=os.path.join(datadir, "ims", fn), width=w,
                height=h, time=time, image_name=fn))
    centers = np.linalg.inv(np.asarray(meta["w2c"][0]))[:, :3, 3]
    radius = 1.1 * np.max(
        np.linalg.norm(centers - centers.mean(0)[None], axis=-1))
    return cam_infos, max_time, radius


def read_panoptic_scene(datadir: str) -> SceneInfo:
    train, max_time, radius = read_panoptic_meta(datadir, "train_meta.json")
    test, _, _ = read_panoptic_meta(datadir, "test_meta.json")
    norm = {"radius": radius, "translate": np.zeros(3)}
    data = np.load(os.path.join(datadir, "init_pt_cld.npz"))["data"]
    xyz, rgb = data[:, :3], data[:, 3:6]
    pcd = PointCloud(points=xyz.astype(np.float32),
                     colors=rgb.astype(np.float32),
                     normals=np.ones((len(xyz), 3), np.float32))
    ply_path = os.path.join(datadir, "pointd3D.ply")
    ply.store_point_cloud(ply_path, xyz, rgb)
    return SceneInfo(point_cloud=pcd, train_cameras=train, test_cameras=test,
                     video_cameras=test, nerf_normalization=norm,
                     ply_path=ply_path, maxtime=max_time)
