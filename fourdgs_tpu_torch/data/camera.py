"""Camera representation (counterpart: fourdgs_tpu/data/camera.py).

Matrix convention: column vectors, p_view = world_view @ [p, 1];
p_clip = full_proj @ [p, 1] with w_clip = z_view.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from fourdgs_tpu_torch.ops import transforms
from fourdgs_tpu_torch.utils.device import resolve_device


@dataclasses.dataclass
class Camera:
    """Per-view data, all float32 tensors on one device."""
    world_view: torch.Tensor   # (4, 4) world -> view
    full_proj: torch.Tensor    # (4, 4) world -> clip
    cam_center: torch.Tensor   # (3,)
    tanfovx: torch.Tensor      # ()
    tanfovy: torch.Tensor      # ()
    time: torch.Tensor         # () in [0, 1]

    def to(self, device) -> "Camera":
        return Camera(**{f.name: getattr(self, f.name).to(device)
                         for f in dataclasses.fields(self)})


def f32_tensor(x, device) -> torch.Tensor:
    """x as a float32 tensor on `device` (cast from numpy on the host)."""
    return torch.as_tensor(np.asarray(x, np.float32), device=device)


def make_camera(R: np.ndarray, T: np.ndarray, fovx: float, fovy: float,
                time: float = 0.0, znear: float = 0.01, zfar: float = 100.0,
                trans=None, scale: float = 1.0,
                device: str | torch.device | None = None) -> Camera:
    """Build a Camera from the (R, T) convention: R = cam-to-world
    rotation, T = world-to-cam translation. The matrices are numpy math
    on the host; the result lives on `device` (None: cuda, which raises
    without a card)."""
    device = resolve_device(device)
    W = transforms.world_to_view(R, T, translate=trans, scale=scale)
    P = transforms.projection_matrix(znear, zfar, fovx, fovy)
    full = P @ W
    center = np.linalg.inv(W)[:3, 3]
    return Camera(world_view=f32_tensor(W, device),
                  full_proj=f32_tensor(full, device),
                  cam_center=f32_tensor(center, device),
                  tanfovx=f32_tensor(np.tan(fovx * 0.5), device),
                  tanfovy=f32_tensor(np.tan(fovy * 0.5), device),
                  time=f32_tensor(time, device))


def look_at_camera(theta: float = 0.3, radius: float = 4.0, fov: float = 0.9,
                   time: float = 0.5,
                   device: str | torch.device | None = None) -> Camera:
    """A camera on a circle of `radius` around the origin, at angle `theta`
    and height 0.2, looking at the origin (the render-benchmark camera of
    the JAX package's `__graft_entry__._look_at_camera`)."""
    pos = np.array([radius * np.sin(theta), 0.2, radius * np.cos(theta)])
    fwd = -pos / np.linalg.norm(pos)
    up = np.array([0.0, 1.0, 0.0])
    right = np.cross(up, fwd)
    right /= np.linalg.norm(right)
    true_up = np.cross(fwd, right)
    r_w2c = np.stack([right, true_up, fwd])
    return make_camera(r_w2c.T, -r_w2c @ pos, fov, fov, time=time,
                       device=device)
