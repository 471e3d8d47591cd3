"""DyNeRF / Neu3D (Plenoptic Video) dataset reader
(counterpart: fourdgs_tpu/data/dynerf.py).

poses_bounds.npy holds the LLFF poses of the cameras, one cam*.mp4 video
each; the videos' frames are read from cam*/images/%04d.png (300 a camera
at most), camera 0 is held out as the test split, every view's time is
its frame index / 300, the video split is a spiral of 300 poses around
the average pose, and the initial cloud is points3D_downsample2.ply.

The videos themselves are decoded only where the frames are missing, by
`extract_video_frames` with OpenCV; a machine without it (the card's) needs
the frames extracted beforehand. The frames are 8-bit PNGs read by the
port's codec (data/png.py), resized to IMG_WH with Pillow's LANCZOS
(data/resample.py) where they have another size, as the JAX reader does
with PIL.
"""
from __future__ import annotations

import glob
import os

import numpy as np

from fourdgs_tpu_torch.data import ply
from fourdgs_tpu_torch.data.llff_poses import (c2w_to_rt, get_spiral,
                                               load_poses_bounds)
from fourdgs_tpu_torch.data.png import write_png
from fourdgs_tpu_torch.data.resample import resize
from fourdgs_tpu_torch.data.scene_info import (CameraInfo, PointCloud,
                                               SceneInfo, nerfpp_norm)
from fourdgs_tpu_torch.ops.transforms import focal2fov

IMG_WH = (1352, 1014)
N_FRAMES = 300


def extract_video_frames(video_path: str, img_wh=IMG_WH,
                         n_frames: int = N_FRAMES) -> str:
    """The directory of a video's frames, <video path up to its first
    dot>/images; where it does not exist yet, the video's first n_frames
    frames are decoded with OpenCV, resized to img_wh with LANCZOS and
    written there as %04d.png with Paeth rows (as PIL's encoder mostly
    writes a photograph's)."""
    image_dir = os.path.join(video_path.split(".")[0], "images")
    if os.path.exists(image_dir):
        return image_dir
    try:
        import cv2
    except ImportError as e:
        raise ImportError(
            f"{video_path}: its frames are not under {image_dir} and OpenCV "
            f"(cv2), which decodes the video, is not installed; extract the "
            f"frames beforehand as camNN/images/%04d.png on a machine that "
            f"has it") from e
    os.makedirs(image_dir)
    cap = cv2.VideoCapture(video_path)
    count = 0
    while cap.isOpened() and count < n_frames:
        ret, frame = cap.read()
        if not ret:
            break
        frame = cv2.cvtColor(frame, cv2.COLOR_BGR2RGB)
        write_png(os.path.join(image_dir, "%04d.png" % count),
                  resize(frame, img_wh, "lanczos"), row_filter=4)
        count += 1
    cap.release()
    return image_dir


def camera_poses(datadir: str, img_wh=IMG_WH):
    """What the reader makes of poses_bounds.npy: the (N, 3, 5) poses in
    the repo's axis convention, their near/far bounds, and the focal
    length at img_wh (the file's is at 2704 px wide)."""
    poses, near_fars, hwf = load_poses_bounds(
        os.path.join(datadir, "poses_bounds.npy"))
    focal = hwf[2] / (2704 / img_wh[0])
    return poses, near_fars, focal


def _camera_infos(datadir: str, split: str, poses_all: np.ndarray,
                  focal: float, img_wh, eval_index: int) -> list[CameraInfo]:
    infos = []
    uid = 0
    w, h = img_wh
    fovx = focal2fov(focal, w)
    fovy = focal2fov(focal, h)
    videos = sorted(glob.glob(os.path.join(datadir, "cam*.mp4")))
    for index, video_path in enumerate(videos):
        if (index == eval_index) == (split == "train"):
            continue
        image_dir = extract_video_frames(video_path, img_wh)
        frames = sorted(os.listdir(image_dir))[:N_FRAMES]
        R, T = c2w_to_rt(poses_all[index])
        for idx, name in enumerate(frames):
            p = os.path.join(image_dir, name)
            infos.append(CameraInfo(
                uid=uid, R=R, T=T, fovx=fovx, fovy=fovy,
                image=None,
                image_path=p, image_name=name, width=w, height=h,
                time=idx / N_FRAMES))
            uid += 1
    return infos


def read_dynerf_scene(datadir: str, eval_index: int = 0,
                      img_wh=IMG_WH) -> SceneInfo:
    """The scene's splits. Every view keeps its frame's path and size; the
    image bank decodes it (data/images.py)."""
    poses, near_fars, focal = camera_poses(datadir, img_wh)

    train = _camera_infos(datadir, "train", poses, focal, img_wh, eval_index)
    test = _camera_infos(datadir, "test", poses, focal, img_wh, eval_index)

    # the spiral video path over 300 poses
    val_poses = get_spiral(poses, near_fars, N_views=300)
    w, h = img_wh
    video = []
    for idx, p in enumerate(val_poses):
        pose = np.eye(4)
        pose[:3, :] = p[:3, :]
        R, T = c2w_to_rt(pose)
        video.append(CameraInfo(
            uid=idx, R=R, T=T, fovx=focal2fov(focal, w),
            fovy=focal2fov(focal, h), image=None, image_path=None,
            image_name=f"{idx}", width=w, height=h,
            time=idx / len(val_poses)))

    norm = nerfpp_norm(train) if train else {"translate": np.zeros(3),
                                             "radius": 1.0}
    ply_path = os.path.join(datadir, "points3D_downsample2.ply")
    pts, cols, normals = ply.fetch_point_cloud(ply_path)
    pcd = PointCloud(points=pts, colors=cols, normals=normals)
    return SceneInfo(point_cloud=pcd, train_cameras=train, test_cameras=test,
                     video_cameras=video, nerf_normalization=norm,
                     ply_path=ply_path, maxtime=300)
