"""Geometry substrate: quaternions, covariance build, camera matrices
(counterpart: fourdgs_tpu/ops/transforms.py).

Tensor functions are batched over leading axes. The camera matrices are
numpy, built once per camera on the host; they are a copy of the JAX
package's numpy math, not an import of it.
"""
from __future__ import annotations

import math

import numpy as np
import torch

SCALE_LOG_MAX = 15.0  # exp(15) ~ 3.3e6: far beyond any useful world scale


def safe_exp_scales(scaling: torch.Tensor) -> torch.Tensor:
    """exp with an overflow clamp for the scale activation: a raw log-scale
    past ~88 would make exp() inf and poison the covariance."""
    return torch.exp(torch.clamp(scaling, max=SCALE_LOG_MAX))


def quat_normalize(q: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """L2-normalize quaternions along the last axis."""
    norm = torch.linalg.vector_norm(q, dim=-1, keepdim=True)
    return q / torch.clamp(norm, min=eps)


def quat_to_rotmat(q: torch.Tensor) -> torch.Tensor:
    """(..., 4) wxyz quaternions -> (..., 3, 3) rotation matrices
    (normalizes internally)."""
    q = quat_normalize(q)
    r, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    row0 = torch.stack(
        [1 - 2 * (y * y + z * z), 2 * (x * y - r * z), 2 * (x * z + r * y)], -1)
    row1 = torch.stack(
        [2 * (x * y + r * z), 1 - 2 * (x * x + z * z), 2 * (y * z - r * x)], -1)
    row2 = torch.stack(
        [2 * (x * z - r * y), 2 * (y * z + r * x), 1 - 2 * (x * x + y * y)], -1)
    return torch.stack([row0, row1, row2], dim=-2)


def quat_multiply(q1: torch.Tensor, q2: torch.Tensor) -> torch.Tensor:
    """Batched Hamilton product, normalized."""
    w1, x1, y1, z1 = q1[..., 0], q1[..., 1], q1[..., 2], q1[..., 3]
    w2, x2, y2, z2 = q2[..., 0], q2[..., 1], q2[..., 2], q2[..., 3]
    w = w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2
    x = w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2
    y = w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2
    z = w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2
    return quat_normalize(torch.stack([w, x, y, z], dim=-1))


def build_covariance_packed(scaling: torch.Tensor, rotation: torch.Tensor,
                            scaling_modifier: float = 1.0) -> torch.Tensor:
    """Sigma = R diag(s^2) R^T as the packed 6-vector
    [xx, xy, xz, yy, yz, zz], elementwise over the batch."""
    q = quat_normalize(rotation)
    r, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    r00 = 1 - 2 * (y * y + z * z)
    r01 = 2 * (x * y - r * z)
    r02 = 2 * (x * z + r * y)
    r10 = 2 * (x * y + r * z)
    r11 = 1 - 2 * (x * x + z * z)
    r12 = 2 * (y * z - r * x)
    r20 = 2 * (x * z - r * y)
    r21 = 2 * (y * z + r * x)
    r22 = 1 - 2 * (x * x + y * y)
    s = scaling_modifier * scaling
    s0, s1, s2 = s[..., 0] ** 2, s[..., 1] ** 2, s[..., 2] ** 2
    return torch.stack([
        r00 * r00 * s0 + r01 * r01 * s1 + r02 * r02 * s2,
        r00 * r10 * s0 + r01 * r11 * s1 + r02 * r12 * s2,
        r00 * r20 * s0 + r01 * r21 * s1 + r02 * r22 * s2,
        r10 * r10 * s0 + r11 * r11 * s1 + r12 * r12 * s2,
        r10 * r20 * s0 + r11 * r21 * s1 + r12 * r22 * s2,
        r20 * r20 * s0 + r21 * r21 * s1 + r22 * r22 * s2], dim=-1)


def inverse_sigmoid(x: torch.Tensor) -> torch.Tensor:
    return torch.log(x / (1 - x))


# ---------------------------------------------------------------------------
# Camera matrices (numpy, host side)
# ---------------------------------------------------------------------------

def world_to_view(R: np.ndarray, t: np.ndarray,
                  translate: np.ndarray = None, scale: float = 1.0) -> np.ndarray:
    """World->camera 4x4. `R` is the camera-to-world rotation and `t` the
    world-to-camera translation. Column-vector convention:
    p_view = W @ [p_world, 1]."""
    Rt = np.zeros((4, 4))
    Rt[:3, :3] = R.transpose()
    Rt[:3, 3] = t
    Rt[3, 3] = 1.0
    if translate is not None or scale != 1.0:
        translate = np.zeros(3) if translate is None else translate
        C2W = np.linalg.inv(Rt)
        cam_center = (C2W[:3, 3] + translate) * scale
        C2W[:3, 3] = cam_center
        Rt = np.linalg.inv(C2W)
    return np.float32(Rt)


def projection_matrix(znear: float, zfar: float, fovx: float,
                      fovy: float) -> np.ndarray:
    """Perspective projection, view -> clip, w_clip = z_view.
    Column-vector convention: p_clip = P @ p_view."""
    tan_y = math.tan(fovy / 2)
    tan_x = math.tan(fovx / 2)
    top = tan_y * znear
    right = tan_x * znear
    P = np.zeros((4, 4))
    P[0, 0] = znear / right
    P[1, 1] = znear / top
    P[2, 2] = zfar / (zfar - znear)
    P[2, 3] = -(zfar * znear) / (zfar - znear)
    P[3, 2] = 1.0
    return np.float32(P)


def fov2focal(fov: float, pixels: float) -> float:
    return pixels / (2 * math.tan(fov / 2))


def focal2fov(focal: float, pixels: float) -> float:
    return 2 * math.atan(pixels / (2 * focal))
