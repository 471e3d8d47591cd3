"""COLMAP (static or monocular) scene reader
(counterpart: fourdgs_tpu/data/colmap_scene.py).

A sparse/0 reconstruction, binary or else text; each view's time is its
index in the extrinsics' order over their count (a monocular video),
taken before the views are sorted by image name; every llffhold-th view
of the sorted list (index % llffhold == 0) is a test view; points3D.bin
(or .txt) becomes points3D.ply on the first load. (SIMPLE_)PINHOLE,
SIMPLE_RADIAL and OPENCV cameras are read as undistorted: the fields of
view come from the focal lengths alone, the principal point is ignored.

The reader keeps each view's path and size; the image bank decodes it
(data/images.py, a JPEG through data/jpeg.py).
"""
from __future__ import annotations

import os

import numpy as np

from fourdgs_tpu_torch.data import colmap, ply
from fourdgs_tpu_torch.data.scene_info import (CameraInfo, PointCloud,
                                               SceneInfo, nerfpp_norm)
from fourdgs_tpu_torch.ops.transforms import focal2fov


def read_colmap_cameras(cam_extrinsics, cam_intrinsics,
                        images_folder) -> list[CameraInfo]:
    infos = []
    n = len(cam_extrinsics)
    for idx, key in enumerate(cam_extrinsics):
        extr = cam_extrinsics[key]
        intr = cam_intrinsics[extr.camera_id]
        R = np.transpose(colmap.qvec2rotmat(extr.qvec))
        T = np.array(extr.tvec)
        if intr.model in ("SIMPLE_PINHOLE", "SIMPLE_RADIAL"):
            fovy = focal2fov(intr.params[0], intr.height)
            fovx = focal2fov(intr.params[0], intr.width)
        elif intr.model in ("PINHOLE", "OPENCV"):
            fovx = focal2fov(intr.params[0], intr.width)
            fovy = focal2fov(intr.params[1], intr.height)
        else:
            raise ValueError(
                f"unsupported COLMAP camera model {intr.model}: only "
                "undistorted (SIMPLE_)PINHOLE/OPENCV datasets supported")
        image_path = os.path.join(images_folder, os.path.basename(extr.name))
        infos.append(CameraInfo(
            uid=intr.id, R=R, T=T, fovx=fovx, fovy=fovy, image=None,
            image_path=image_path,
            image_name=os.path.basename(image_path).split(".")[0],
            width=intr.width, height=intr.height, time=float(idx / n)))
    return infos


def load_sparse(path: str, sub: str = "sparse/0"):
    """(extrinsics, intrinsics) of `sub`: the binary files, else the text
    ones."""
    try:
        extr = colmap.read_images_binary(os.path.join(path, sub, "images.bin"))
        intr = colmap.read_cameras_binary(os.path.join(path, sub,
                                                       "cameras.bin"))
    except (FileNotFoundError, OSError):
        extr = colmap.read_images_text(os.path.join(path, sub, "images.txt"))
        intr = colmap.read_cameras_text(os.path.join(path, sub, "cameras.txt"))
    return extr, intr


def ensure_points_ply(path: str, sub: str = "sparse/0",
                      name: str = "points3D") -> str:
    """`sub`/`name`.ply, written from `name`.bin (or .txt) where it is
    missing."""
    ply_path = os.path.join(path, sub, f"{name}.ply")
    if not os.path.exists(ply_path):
        bin_path = os.path.join(path, sub, f"{name}.bin")
        txt_path = os.path.join(path, sub, f"{name}.txt")
        try:
            xyz, rgb, _ = colmap.read_points3d_binary(bin_path)
        except (FileNotFoundError, OSError):
            xyz, rgb, _ = colmap.read_points3d_text(txt_path)
        ply.store_point_cloud(ply_path, xyz, rgb)
    return ply_path


def read_colmap_scene(path: str, images: str | None, eval_split: bool,
                      llffhold: int = 8) -> SceneInfo:
    """The scene's splits: train, test (llffhold) and the train views
    again as the video split; maxtime 0."""
    extr, intr = load_sparse(path)
    reading_dir = "images" if images is None else images
    infos = read_colmap_cameras(extr, intr, os.path.join(path, reading_dir))
    infos = sorted(infos, key=lambda c: c.image_name)
    if eval_split:
        train = [c for i, c in enumerate(infos) if i % llffhold != 0]
        test = [c for i, c in enumerate(infos) if i % llffhold == 0]
    else:
        train, test = infos, []
    norm = nerfpp_norm(train)
    ply_path = ensure_points_ply(path)
    pts, cols, normals = ply.fetch_point_cloud(ply_path)
    pcd = PointCloud(points=pts, colors=cols, normals=normals)
    return SceneInfo(point_cloud=pcd, train_cameras=train, test_cameras=test,
                     video_cameras=train, nerf_normalization=norm,
                     ply_path=ply_path, maxtime=0)
