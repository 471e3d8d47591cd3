"""Scene-level records shared by the dataset readers
(counterpart: fourdgs_tpu/data/scene_info.py; a copy, numpy only).

Images are numpy (H, W, 3) float32 arrays, channels last, as in the JAX
package.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np

from fourdgs_tpu_torch.ops.transforms import world_to_view


class CameraInfo(NamedTuple):
    uid: int
    R: np.ndarray          # (3,3) cam-to-world rotation (reference convention)
    T: np.ndarray          # (3,) world-to-cam translation
    fovx: float
    fovy: float
    image: np.ndarray | None   # (H, W, 3) float32 in [0,1]; None for video poses
    image_path: str | None
    image_name: str | None
    width: int
    height: int
    time: float
    mask: np.ndarray | None = None


class PointCloud(NamedTuple):
    points: np.ndarray
    colors: np.ndarray
    normals: np.ndarray


class SceneInfo(NamedTuple):
    point_cloud: PointCloud
    train_cameras: list
    test_cameras: list
    video_cameras: list
    nerf_normalization: dict
    ply_path: str
    maxtime: float


def nerfpp_norm(cam_infos: list[CameraInfo]) -> dict:
    """Camera-center bounding sphere: radius = 1.1 * max distance from the
    mean camera center; the spatial LR scale and scene extent."""
    centers = []
    for cam in cam_infos:
        w2c = world_to_view(cam.R, cam.T)
        centers.append(np.linalg.inv(w2c)[:3, 3])
    centers = np.stack(centers)
    avg = centers.mean(axis=0)
    diagonal = np.linalg.norm(centers - avg, axis=1).max()
    return {"translate": -avg, "radius": diagonal * 1.1}


def blender_matrix_to_rt(c2w: np.ndarray):
    """Blender/NeRF transform_matrix -> the reference's (R, T) convention,
    its sign flips included."""
    matrix = np.linalg.inv(np.asarray(c2w))
    R = -np.transpose(matrix[:3, :3])
    R[:, 0] = -R[:, 0]
    T = -matrix[:3, 3]
    return R, T
