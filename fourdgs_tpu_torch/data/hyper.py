"""HyperNeRF / Nerfies dataset reader
(counterpart: fourdgs_tpu/data/hyper.py).

scene.json (near, far, scale, center), metadata.json (each image's
camera_id and warp_id), dataset.json (the ids and the train and val
splits, or with no val ids every 4th image for training and the image two
after each of those but the last for testing), a Nerfies camera JSON per
image (orientation, position, focal_length, image_size at full
resolution), the images under rgb/{1/ratio}x/, the test views' covisible
masks where covisible/ exists, times divided by the largest warp_id, and
the test cameras again as the video split.

Sizes: a train or test view has its image's size, a video view the camera
JSON's full-resolution `image_size`; the field of view comes from the
full-resolution size in both. The JAX reader takes a view's size from its
decoded image; this one reads it from the PNG header (data/png.py:
png_size), so that a view the image bank decodes later has it too.
"""
from __future__ import annotations

import json
import os
from copy import deepcopy

import numpy as np

from fourdgs_tpu_torch.data import ply
from fourdgs_tpu_torch.data.png import png_size, read_png
from fourdgs_tpu_torch.data.scene_info import (CameraInfo, PointCloud,
                                               SceneInfo, nerfpp_norm)
from fourdgs_tpu_torch.ops.transforms import focal2fov


class NerfiesCamera:
    """The fields of a Nerfies camera that the reader uses: orientation is
    the world-to-camera rotation (rows = camera axes), position the camera
    centre in world space."""

    def __init__(self, orientation, position, focal_length, principal_point,
                 image_size, skew=0.0, pixel_aspect_ratio=1.0,
                 radial_distortion=None, tangential_distortion=None):
        self.orientation = np.asarray(orientation, np.float32)
        self.position = np.asarray(position, np.float32)
        self.focal_length = float(focal_length)
        self.principal_point = np.asarray(principal_point, np.float32)
        self.image_size = np.asarray(image_size, np.uint32)  # (W, H)
        self.skew = float(skew)
        self.pixel_aspect_ratio = float(pixel_aspect_ratio)
        self.radial_distortion = (np.zeros(3, np.float32)
                                  if radial_distortion is None
                                  else np.asarray(radial_distortion, np.float32))
        self.tangential_distortion = (np.zeros(2, np.float32)
                                      if tangential_distortion is None
                                      else np.asarray(tangential_distortion,
                                                      np.float32))

    @classmethod
    def from_json(cls, path):
        with open(path) as f:
            d = json.load(f)
        if "tangential" in d:
            d["tangential_distortion"] = d["tangential"]
        return cls(
            orientation=d["orientation"], position=d["position"],
            focal_length=d["focal_length"],
            principal_point=d["principal_point"], image_size=d["image_size"],
            skew=d.get("skew", 0.0),
            pixel_aspect_ratio=d.get("pixel_aspect_ratio", 1.0),
            radial_distortion=d.get("radial_distortion"),
            tangential_distortion=d.get("tangential_distortion"))

    def rt(self):
        """The repo's (R, T): R = orientation.T, T = -position @ R."""
        R = self.orientation.T
        T = -self.position @ R
        return R, T


def _slerp(q1, q2, t):
    dot = np.dot(q1, q2)
    if dot < 0.0:
        q1, dot = -q1, -dot
    dot = np.clip(dot, -1.0, 1.0)
    theta = np.arccos(dot) * t
    q3 = q2 - q1 * dot
    n = np.linalg.norm(q3)
    q3 = q3 / n if n > 1e-12 else q3
    return np.cos(theta) * q1 + np.sin(theta) * q3


def smooth_camera_poses(cameras, num_interpolations=5):
    """SLERP of the orientations and linear interpolation of the
    positions between consecutive cameras, with their times."""
    from scipy.spatial.transform import Rotation

    out_cams, out_times = [], []
    n = len(cameras)
    total = (n - 1) + (n - 1) * num_interpolations
    time_inc = 10 / max(total, 1)
    for i in range(n - 1):
        c1, c2 = cameras[i], cameras[i + 1]
        q1 = Rotation.from_matrix(c1.orientation).as_quat()
        q2 = Rotation.from_matrix(c2.orientation).as_quat()
        for j in range(num_interpolations + 1):
            t = j / (num_interpolations + 1)
            cam = deepcopy(c1)
            cam.orientation = Rotation.from_quat(_slerp(q1, q2, t)).as_matrix()
            cam.position = (1 - t) * c1.position + t * c2.position
            out_cams.append(cam)
            out_times.append(i * 10 / (n - 1) + time_inc * j)
    out_cams.append(cameras[-1])
    out_times.append(1.0)
    return out_cams, out_times


class HyperScene:
    """A nerfies directory's JSON files: ids, splits, times, cameras and
    the image and mask paths. Reads no image."""

    def __init__(self, datadir: str, ratio: float = 0.5):
        datadir = os.path.expanduser(datadir)
        self.datadir = datadir
        with open(f"{datadir}/scene.json") as f:
            scene_json = json.load(f)
        with open(f"{datadir}/metadata.json") as f:
            meta_json = json.load(f)
        with open(f"{datadir}/dataset.json") as f:
            dataset_json = json.load(f)
        self.near = scene_json["near"]
        self.far = scene_json["far"]
        self.coord_scale = scene_json["scale"]
        self.scene_center = scene_json["center"]

        self.all_img_ids = dataset_json["ids"]
        val_ids = dataset_json["val_ids"]
        if len(val_ids) == 0:
            self.i_train = np.array(
                [i for i in np.arange(len(self.all_img_ids)) if i % 4 == 0])
            self.i_test = (self.i_train + 2)[:-1]
        else:
            train_ids = dataset_json["train_ids"]
            self.i_train = [i for i, iid in enumerate(self.all_img_ids)
                            if iid in train_ids]
            self.i_test = [i for i, iid in enumerate(self.all_img_ids)
                           if iid in val_ids]

        times = [meta_json[i]["warp_id"] for i in self.all_img_ids]
        max_t = max(times)
        self.all_time = [t / max_t for t in times]
        self.max_time = max(self.all_time)
        self.all_cam_params = [
            NerfiesCamera.from_json(f"{datadir}/camera/{i}.json")
            for i in self.all_img_ids]
        sub = int(1 / ratio)
        self.all_img = [f"{datadir}/rgb/{sub}x/{i}.png"
                        for i in self.all_img_ids]
        cov = os.path.join(datadir, "covisible")
        self.image_mask = (
            [f"{datadir}/covisible/2x/val/{i}.png" for i in self.all_img_ids]
            if os.path.exists(cov) else None)
        # full-res (W, H) from the camera json; the fields of view use these
        self.w, self.h = (int(x) for x in self.all_cam_params[0].image_size)

    def camera_info(self, idx: int, with_mask: bool = False,
                    image_sized: bool = True) -> CameraInfo:
        """One view, its image left on disk for the image bank.
        `image_sized` (train and test views) gives it its image's size,
        read from the PNG header; a video view (False) has the full
        resolution's."""
        cam = self.all_cam_params[idx]
        R, T = cam.rt()
        fovy = focal2fov(cam.focal_length, self.h)
        fovx = focal2fov(cam.focal_length, self.w)
        w, h = self.w, self.h
        if image_sized:
            w, h = png_size(self.all_img[idx])
        mask = None
        if with_mask and self.image_mask is not None:
            m = read_png(self.image_mask[idx]).astype(np.float32)
            mask = (m / 255.0) if m.max() > 1 else m
            if mask.ndim == 3:
                mask = mask[..., 0]
        return CameraInfo(
            uid=idx, R=R, T=T, fovx=fovx, fovy=fovy, image=None,
            image_path=self.all_img[idx],
            image_name=os.path.basename(self.all_img[idx]),
            width=w, height=h, time=self.all_time[idx], mask=mask)


def read_hyper_scene(datadir: str, ratio: float = 0.5) -> SceneInfo:
    """The scene's splits. Every view keeps its image's path and size; the
    image bank decodes it (data/images.py)."""
    scene = HyperScene(datadir, ratio)
    train = [scene.camera_info(i) for i in scene.i_train]
    test = [scene.camera_info(i, with_mask=True)
            for i in scene.i_test]
    video = [scene.camera_info(i, image_sized=False) for i in scene.i_test]
    norm = nerfpp_norm(train)
    ply_path = os.path.join(datadir, "points3D_downsample2.ply")
    pts, cols, normals = ply.fetch_point_cloud(ply_path)
    pcd = PointCloud(points=pts, colors=cols, normals=normals)
    return SceneInfo(point_cloud=pcd, train_cameras=train, test_cameras=test,
                     video_cameras=video, nerf_normalization=norm,
                     ply_path=ply_path, maxtime=scene.max_time)
