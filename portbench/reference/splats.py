"""Frozen copies of fourdgs_tpu_torch/ops/sh.py (`eval_sh` to degree 3,
`sh_to_rgb`), fourdgs_tpu_torch/ops/transforms.py (`safe_exp_scales`,
`quat_normalize`, `build_covariance_packed`) and
fourdgs_tpu_torch/ops/projection.py (`project_gaussians`, `_footprint`),
and the composition of fourdgs_tpu_torch/render/render.py:splats_at.

The projection's three matrix products go through `precision.matmul`
(the matrix-vector product for w stays float32, as a GEMV takes no tensor
core).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from portbench.reference.deformation import DeformSpec, deform
from portbench.reference.precision import matmul

C0 = 0.28209479177387814
C1 = 0.4886025119029199
C2 = (1.0925484305920792, -1.0925484305920792, 0.31539156525252005,
      -1.0925484305920792, 0.5462742152960396)
C3 = (-0.5900435899266435, 2.890611442640554, -0.4570457994644658,
      0.3731763325901154, -0.4570457994644658, 1.445305721320277,
      -0.5900435899266435)

FRUSTUM_NEAR = 0.2
LOWPASS = 0.3
RADIUS_SIGMA = 3.0
ALPHA_MIN = 1.0 / 255.0
ALPHA_MAX = 0.99
NO_CULL_R2 = 1 << 30
SCALE_LOG_MAX = 15.0


def eval_sh3(sh: torch.Tensor, dirs: torch.Tensor) -> torch.Tensor:
    """Degree-3 real SH (..., 16, C) at unit directions (..., 3)."""
    x = dirs[..., 0:1]
    y = dirs[..., 1:2]
    z = dirs[..., 2:3]
    result = C0 * sh[..., 0, :]
    result = (result - C1 * y * sh[..., 1, :] + C1 * z * sh[..., 2, :]
              - C1 * x * sh[..., 3, :])
    xx, yy, zz = x * x, y * y, z * z
    xy, yz, xz = x * y, y * z, x * z
    result = (result
              + C2[0] * xy * sh[..., 4, :]
              + C2[1] * yz * sh[..., 5, :]
              + C2[2] * (2.0 * zz - xx - yy) * sh[..., 6, :]
              + C2[3] * xz * sh[..., 7, :]
              + C2[4] * (xx - yy) * sh[..., 8, :])
    result = (result
              + C3[0] * y * (3 * xx - yy) * sh[..., 9, :]
              + C3[1] * xy * z * sh[..., 10, :]
              + C3[2] * y * (4 * zz - xx - yy) * sh[..., 11, :]
              + C3[3] * z * (2 * zz - 3 * xx - 3 * yy) * sh[..., 12, :]
              + C3[4] * x * (4 * zz - xx - yy) * sh[..., 13, :]
              + C3[5] * z * (xx - yy) * sh[..., 14, :]
              + C3[6] * x * (xx - 3 * yy) * sh[..., 15, :])
    return result


def quat_normalize(q: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    norm = torch.linalg.vector_norm(q, dim=-1, keepdim=True)
    return q / torch.clamp(norm, min=eps)


def covariance_packed(scaling: torch.Tensor, rotation: torch.Tensor):
    """Sigma = R diag(s^2) R^T as [xx, xy, xz, yy, yz, zz]."""
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
    s0, s1, s2 = (scaling[..., 0] ** 2, scaling[..., 1] ** 2,
                  scaling[..., 2] ** 2)
    return torch.stack([
        r00 * r00 * s0 + r01 * r01 * s1 + r02 * r02 * s2,
        r00 * r10 * s0 + r01 * r11 * s1 + r02 * r12 * s2,
        r00 * r20 * s0 + r01 * r21 * s1 + r02 * r22 * s2,
        r10 * r10 * s0 + r11 * r11 * s1 + r12 * r12 * s2,
        r10 * r20 * s0 + r11 * r21 * s1 + r12 * r22 * s2,
        r20 * r20 * s0 + r21 * r21 * s1 + r22 * r22 * s2], dim=-1)


class Projected(NamedTuple):
    pix: torch.Tensor        # (N, 2)
    depth: torch.Tensor      # (N,)
    conic: torch.Tensor      # (N, 3)
    radius: torch.Tensor     # (N,) int32, 0 = culled
    rect_min: torch.Tensor   # (N, 2) int32 inclusive tile
    rect_max: torch.Tensor   # (N, 2) int32 exclusive tile
    tiles_touched: torch.Tensor
    cull_r2: torch.Tensor    # (N,) int32


def _tile_index(x, tile_size, grid):
    q = torch.clamp(x / tile_size, -1.0, grid + 1.0).to(torch.int32)
    return torch.clamp(q, 0, grid)


def project(means3d, scales, quats, opacities, cam: dict, width: int,
            height: int, tile_size: int, alive, precision: str) -> Projected:
    """EWA projection of activated gaussians; `cam` holds `world_view`,
    `full_proj`, `tanfovx`, `tanfovy` (float32 tensors)."""
    W = cam["world_view"]
    t = matmul(means3d, W[:3, :3].T, precision) + W[:3, 3]
    tz = t[:, 2]
    in_front = tz > FRUSTUM_NEAR
    tz_safe = torch.where(in_front, tz, torch.ones_like(tz))
    P = cam["full_proj"]
    ph = matmul(means3d, P[:3, :3].T, precision) + P[:3, 3]
    pw = means3d @ P[3, :3] + P[3, 3]
    rw = 1.0 / torch.where(in_front, pw + 1e-7, torch.ones_like(pw))
    ndc_xy = ph[:, :2] * rw[:, None]
    pix = torch.stack([
        ((ndc_xy[:, 0] + 1.0) * width - 1.0) * 0.5,
        ((ndc_xy[:, 1] + 1.0) * height - 1.0) * 0.5], dim=-1)
    cov3d = covariance_packed(scales, quats)
    c_xx, c_xy, c_xz, c_yy, c_yz, c_zz = cov3d.unbind(-1)
    tanx, tany = cam["tanfovx"], cam["tanfovy"]
    fx = width / (2.0 * tanx)
    fy = height / (2.0 * tany)
    limx = 1.3 * tanx
    limy = 1.3 * tany
    txz = torch.clamp(t[:, 0] / tz_safe, -limx, limx) * tz_safe
    tyz = torch.clamp(t[:, 1] / tz_safe, -limy, limy) * tz_safe
    inv_z = 1.0 / tz_safe
    inv_z2 = inv_z * inv_z
    j00 = fx * inv_z
    j02 = -fx * txz * inv_z2
    j11 = fy * inv_z
    j12 = -fy * tyz * inv_z2
    R3 = W[:3, :3]
    m0 = j00[:, None] * R3[0] + j02[:, None] * R3[2]
    m1 = j11[:, None] * R3[1] + j12[:, None] * R3[2]

    def sigma_vec(v):
        return torch.stack([
            c_xx * v[:, 0] + c_xy * v[:, 1] + c_xz * v[:, 2],
            c_xy * v[:, 0] + c_yy * v[:, 1] + c_yz * v[:, 2],
            c_xz * v[:, 0] + c_yz * v[:, 1] + c_zz * v[:, 2]], dim=-1)

    s_m0 = sigma_vec(m0)
    s_m1 = sigma_vec(m1)
    cov00 = (m0 * s_m0).sum(-1) + LOWPASS
    cov01 = (m0 * s_m1).sum(-1)
    cov11 = (m1 * s_m1).sum(-1) + LOWPASS
    det = cov00 * cov11 - cov01 * cov01
    det_ok = det > 0.0
    det_safe = torch.where(det_ok, det, torch.ones_like(det))
    inv_det = torch.where(det_ok, 1.0 / torch.clamp(det_safe, min=1e-30),
                          torch.zeros_like(det))
    conic = torch.stack([cov11 * inv_det, -cov01 * inv_det,
                         cov00 * inv_det], dim=-1)
    with torch.no_grad():
        foot = _footprint(pix, cov00, cov11, det, det_ok, in_front, alive,
                          opacities, width, height, tile_size)
    return Projected(pix, tz, conic, *foot)


def _footprint(pix, cov00, cov11, det, det_ok, in_front, alive, opacities,
               width, height, tile_size):
    n = pix.shape[0]
    mid = 0.5 * (cov00 + cov11)
    lam1 = mid + torch.sqrt(torch.clamp(mid * mid - det, min=0.1))
    radius_f = torch.ceil(RADIUS_SIGMA * torch.sqrt(lam1))
    visible = in_front & det_ok & alive
    radius = torch.where(visible, radius_f,
                         torch.zeros_like(radius_f)).to(torch.int32)
    grid_x = (width + tile_size - 1) // tile_size
    grid_y = (height + tile_size - 1) // tile_size
    rf = radius.to(torch.float32)
    op = opacities
    op_ok = op > ALPHA_MIN
    q = 2.0 * torch.log(torch.clamp(op, min=ALPHA_MIN) / ALPHA_MIN) + 1e-6
    rx = torch.minimum(torch.sqrt(q * torch.clamp(cov00, min=0.0)), rf)
    ry = torch.minimum(torch.sqrt(q * torch.clamp(cov11, min=0.0)), rf)
    zero = torch.zeros_like(rx)
    rx = torch.where(op_ok, rx, zero)
    ry = torch.where(op_ok, ry, zero)
    radius = torch.where(op_ok, radius, torch.zeros_like(radius))
    cull_r2 = torch.clamp(torch.ceil(q * lam1) + 64.0,
                          max=float(NO_CULL_R2)).to(torch.int32)
    del n
    rect_min = torch.stack([
        _tile_index(pix[:, 0] - rx, tile_size, grid_x),
        _tile_index(pix[:, 1] - ry, tile_size, grid_y)], dim=-1)
    rect_max = torch.stack([
        _tile_index(pix[:, 0] + rx + tile_size - 1, tile_size, grid_x),
        _tile_index(pix[:, 1] + ry + tile_size - 1, tile_size, grid_y)],
        dim=-1)
    spans = torch.clamp(rect_max - rect_min, min=0)
    tiles_touched = torch.where(radius > 0, spans[:, 0] * spans[:, 1],
                                torch.zeros_like(radius))
    rect_max = torch.where((tiles_touched > 0)[:, None], rect_max, rect_min)
    return radius, rect_min, rect_max, tiles_touched, cull_r2


def splats(params: dict, spec: DeformSpec, aabb, cam: dict,
           precision: str):
    """The rasterizer's inputs at the camera's timestamp, fine stage, SH
    degree 3: (means3d, scales, quats, opacities, colors)."""
    shs = torch.cat([params["features_dc"], params["features_rest"]], dim=1)
    xyz, scaling, rotation, opacity, shs_f = deform(
        params, spec, aabb, params["xyz"], params["scaling"],
        params["rotation"], params["opacity"], shs, cam["time"], precision)
    scales = torch.exp(torch.clamp(scaling, max=SCALE_LOG_MAX))
    quats = quat_normalize(rotation)
    opacities = torch.sigmoid(opacity[:, 0])
    dirs = xyz - cam["cam_center"]
    dirs = dirs / torch.clamp(
        torch.linalg.vector_norm(dirs, dim=-1, keepdim=True), min=1e-8)
    colors = torch.clamp(eval_sh3(shs_f, dirs) + 0.5, min=0.0)
    return xyz, scales, quats, opacities, colors
