"""Scene facade: dataset-type detection, loading and device staging
(counterpart: fourdgs_tpu/data/scene.py).

The Blender (D-NeRF) layout is read; the other layouts the JAX package
detects (Colmap, dynerf, nerfies, PanopticSports, MultipleView) raise
`NotImplementedError`. A split's images live on the device as one float32
tensor (the JAX package's "device" `ImageBank`); its "host" and "lazy"
modes and `downscale > 1` are not ported and raise.
"""
from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np
import torch

from fourdgs_tpu_torch.data.camera import Camera, make_camera
from fourdgs_tpu_torch.data.scene_info import CameraInfo, SceneInfo
from fourdgs_tpu_torch.utils.device import resolve_device

# staging budget: a split bigger than this (decoded float32) would need the
# JAX package's host or lazy image bank
DEVICE_IMAGE_BUDGET = 4 << 30


def detect_scene_type(path: str) -> str:
    if os.path.exists(os.path.join(path, "sparse")):
        return "Colmap"
    if os.path.exists(os.path.join(path, "transforms_train.json")):
        return "Blender"
    if os.path.exists(os.path.join(path, "poses_bounds.npy")):
        return "dynerf"
    if os.path.exists(os.path.join(path, "dataset.json")):
        return "nerfies"
    if os.path.exists(os.path.join(path, "train_meta.json")):
        return "PanopticSports"
    if os.path.exists(os.path.join(path, "points3D_multipleview.ply")):
        return "MultipleView"
    raise ValueError(f"could not recognize scene type for {path}")


def load_scene_info(path: str, *, white_background: bool = True,
                    eval_split: bool = True, extension: str = ".png",
                    resolution=None,
                    rng: np.random.Generator | None = None
                    ) -> tuple[SceneInfo, str]:
    """The scene's info and its type. `resolution` (None: the Blender
    reader's RESOLUTION) is the size every image must have."""
    kind = detect_scene_type(path)
    if kind != "Blender":
        raise NotImplementedError(f"the {kind} reader is not ported yet; "
                                  f"the port reads the Blender layout")
    from fourdgs_tpu_torch.data.blender import RESOLUTION, read_blender_scene
    info = read_blender_scene(path, white_background, eval_split, extension,
                              resolution=resolution or RESOLUTION, rng=rng)
    return info, kind


def camera_from_info(info: CameraInfo, device) -> Camera:
    return make_camera(info.R, info.T, info.fovx, info.fovy, time=info.time,
                       device=device)


class ImageBank:
    """A split's images on the device as one (n, H, W, 3) float32 tensor
    (the JAX package's ImageBank in its "device" mode): `bank[idxs]` is a
    device gather."""

    mode = "device"

    def __init__(self, images: torch.Tensor):
        self._images = images

    @property
    def shape(self):
        return self._images.shape

    def __len__(self):
        return int(self._images.shape[0])

    def __getitem__(self, idxs):
        if isinstance(idxs, (np.ndarray, list)):
            idxs = torch.as_tensor(np.asarray(idxs), dtype=torch.long,
                                   device=self._images.device)
        return self._images[idxs]


@dataclass
class StackedCameras:
    """One split: a Camera per view (on the device), its image bank and
    its timestamps."""
    cameras: list
    images: ImageBank | None
    times: np.ndarray
    width: int
    height: int

    def __len__(self):
        return int(np.asarray(self.times).shape[0])


def stack_cameras(infos: list, device, with_images: bool = True,
                  downscale: int = 1,
                  device_budget: int = DEVICE_IMAGE_BUDGET) -> StackedCameras:
    if downscale > 1:
        raise NotImplementedError("downscale > 1 needs a LANCZOS resize, "
                                  "which the port does not have yet")
    cams = [camera_from_info(i, device) for i in infos]
    first = infos[0]
    w, h = int(first.width), int(first.height)
    times = np.array([i.time for i in infos], np.float32)
    images = None
    if with_images:
        n = len(infos)
        if n * h * w * 3 * 4 > device_budget:
            raise NotImplementedError(
                f"{n} views of {w}x{h} pass the device image budget; the "
                f"host and lazy image banks are not ported yet")
        images = ImageBank(torch.from_numpy(
            np.stack([i.image for i in infos])).to(device))
    return StackedCameras(cameras=cams, images=images, times=times,
                          width=w, height=h)


@dataclass
class Scene:
    """A loaded scene ready for training."""
    info: SceneInfo
    dataset_type: str
    train: StackedCameras
    test: StackedCameras
    video: StackedCameras
    cameras_extent: float
    aabb: np.ndarray          # (2, 3) rows (max, min) for the deform field
    maxtime: float

    @classmethod
    def load(cls, path: str, downscale: int = 1,
             device: str | torch.device | None = None, **kwargs) -> "Scene":
        """The scene's splits on `device` (None: cuda, which raises without
        a card). `kwargs` go to `load_scene_info`."""
        dev = resolve_device(device)
        info, kind = load_scene_info(path, **kwargs)
        train = stack_cameras(info.train_cameras, dev, downscale=downscale)
        test = (stack_cameras(info.test_cameras, dev, downscale=downscale)
                if info.test_cameras else train)
        video = (stack_cameras(info.video_cameras, dev, with_images=False,
                               downscale=downscale)
                 if info.video_cameras else test)
        pts = info.point_cloud.points
        aabb = np.stack([pts.max(0), pts.min(0)]).astype(np.float32)
        return cls(info=info, dataset_type=kind, train=train, test=test,
                   video=video,
                   cameras_extent=float(info.nerf_normalization["radius"]),
                   aabb=aabb, maxtime=info.maxtime)

    def zerostamp_mask(self) -> np.ndarray:
        """Views at the first timestamp (the coarse stage's zerostamp
        init)."""
        t = self.train.times
        return t == t.min()
