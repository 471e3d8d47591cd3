"""MultipleView (a multi-camera rig) scene reader
(counterpart: fourdgs_tpu/data/multiview.py).

sparse_/ holds the rig's COLMAP extrinsics and camera 1's intrinsics,
which every camera uses; an image named frameNN.jpg in it is the camera
whose frames are camNN/frame_00001.jpg, ... (as many frames as cam01 holds
files, each at time index / count); the test split is frames 0, n // 3
and 2n // 3 of every camera; the video split is a spiral of 300 poses
from poses_bounds_multipleview.npy (the test split where that file is
missing); points3D_multipleview.ply is written from its .bin (or .txt)
where it is missing.

The reader keeps each view's path and size; the image bank decodes it
(data/images.py, a JPEG through data/jpeg.py).
"""
from __future__ import annotations

import os

import numpy as np

from fourdgs_tpu_torch.data import colmap, ply
from fourdgs_tpu_torch.data.llff_poses import c2w_to_rt, get_spiral
from fourdgs_tpu_torch.data.scene_info import (CameraInfo, PointCloud,
                                               SceneInfo, nerfpp_norm)
from fourdgs_tpu_torch.ops.transforms import focal2fov

N_VIDEO = 300


def _camera_infos(datadir, cam_extrinsics, cam_intrinsics,
                  split) -> list[CameraInfo]:
    intr = cam_intrinsics[1]
    focal = intr.params[0]
    fovy = focal2fov(focal, intr.height)
    fovx = focal2fov(focal, intr.width)
    image_length = len(os.listdir(os.path.join(datadir, "cam01")))
    infos = []
    uid = 0
    for key in cam_extrinsics:
        extr = cam_extrinsics[key]
        R = np.transpose(colmap.qvec2rotmat(extr.qvec))
        T = np.array(extr.tvec)
        number = os.path.basename(extr.name)[5:-4]
        images_folder = os.path.join(datadir, "cam" + number.zfill(2))
        image_range = range(image_length)
        if split == "test":
            image_range = [0, image_length // 3, image_length * 2 // 3]
        for i in image_range:
            p = os.path.join(images_folder,
                             "frame_" + str(i + 1).zfill(5) + ".jpg")
            infos.append(CameraInfo(
                uid=uid, R=R, T=T, fovx=fovx, fovy=fovy, image=None,
                image_path=p, image_name=os.path.basename(p),
                width=intr.width, height=intr.height,
                time=float(i / image_length)))
            uid += 1
    return infos


def read_multipleview_scene(datadir: str) -> SceneInfo:
    extr = colmap.read_images_binary(os.path.join(datadir, "sparse_",
                                                  "images.bin"))
    intr = colmap.read_cameras_binary(os.path.join(datadir, "sparse_",
                                                   "cameras.bin"))
    train = _camera_infos(datadir, extr, intr, "train")
    test = _camera_infos(datadir, extr, intr, "test")
    norm = nerfpp_norm(train)

    video = []
    pb_path = os.path.join(datadir, "poses_bounds_multipleview.npy")
    if os.path.exists(pb_path):
        arr = np.load(pb_path)
        poses = arr[:, :-2].reshape([-1, 3, 5])
        near_fars = arr[:, -2:]
        poses = np.concatenate(
            [poses[..., 1:2], -poses[..., :1], poses[..., 2:4]], -1)
        val_poses = get_spiral(poses, near_fars, N_views=N_VIDEO)
        intr1 = intr[1]
        fovx = focal2fov(intr1.params[0], intr1.width)
        fovy = focal2fov(intr1.params[0], intr1.height)
        for idx, p in enumerate(val_poses):
            pose = np.eye(4)
            pose[:3, :] = p[:3, :]
            R, T = c2w_to_rt(pose)
            video.append(CameraInfo(
                uid=idx, R=R, T=T, fovx=fovx, fovy=fovy, image=None,
                image_path=None, image_name=f"{idx}", width=intr1.width,
                height=intr1.height, time=idx / len(val_poses)))

    ply_path = os.path.join(datadir, "points3D_multipleview.ply")
    if not os.path.exists(ply_path):
        bin_path = os.path.join(datadir, "points3D_multipleview.bin")
        txt_path = os.path.join(datadir, "points3D_multipleview.txt")
        try:
            xyz, rgb, _ = colmap.read_points3d_binary(bin_path)
        except (FileNotFoundError, OSError):
            xyz, rgb, _ = colmap.read_points3d_text(txt_path)
        ply.store_point_cloud(ply_path, xyz, rgb)
    pts, cols, normals = ply.fetch_point_cloud(ply_path)
    pcd = PointCloud(points=pts, colors=cols, normals=normals)
    return SceneInfo(point_cloud=pcd, train_cameras=train, test_cameras=test,
                     video_cameras=video or test, nerf_normalization=norm,
                     ply_path=ply_path, maxtime=0)
