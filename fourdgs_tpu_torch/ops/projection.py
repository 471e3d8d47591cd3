"""Gaussian projection: 3D -> screen-space splats (EWA)
(counterpart: fourdgs_tpu/ops/projection.py, `project_gaussians`).

View transform, frustum cull at z <= 0.2, perspective projection, 2D
covariance by local affine (EWA) with the +0.3 pixel low-pass, conic,
3-sigma radius, opacity-aware tile rects and the binner's corner-cull
radius. Plain elementwise tensor math over the N axis.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from fourdgs_tpu_torch.data.camera import Camera
from fourdgs_tpu_torch.ops import transforms

FRUSTUM_NEAR = 0.2     # view-space z cull threshold
LOWPASS = 0.3          # pixel-space covariance dilation
RADIUS_SIGMA = 3.0
# Blending gate constants (single source; rasterize_ref re-exports them).
ALPHA_MIN = 1.0 / 255.0
ALPHA_MAX = 0.99
NO_CULL_R2 = 1 << 30   # corner-cull sentinel: never fires


class Projected(NamedTuple):
    """Per-Gaussian screen-space quantities (all (N, ...))."""
    pix: torch.Tensor            # (N, 2) pixel-space center
    depth: torch.Tensor          # (N,) view-space z
    conic: torch.Tensor          # (N, 3) inverse 2D covariance (A, B, C)
    radius: torch.Tensor         # (N,) int32 screen radius (0 = culled)
    rect_min: torch.Tensor       # (N, 2) int32 inclusive tile min (x, y)
    rect_max: torch.Tensor       # (N, 2) int32 exclusive tile max (x, y)
    tiles_touched: torch.Tensor  # (N,) int32
    cull_r2: torch.Tensor        # (N,) int32 squared pixel radius beyond
    #   which alpha < ALPHA_MIN is guaranteed; NO_CULL_R2 = never cull


def _tile_index(x: torch.Tensor, tile_size: int, grid: int) -> torch.Tensor:
    """int32(x / tile_size) (truncation toward zero), clipped to
    [0, grid]. The float is clamped first so that the cast never sees a
    value outside int32; the clip makes the result the same."""
    q = torch.clamp(x / tile_size, -1.0, grid + 1.0).to(torch.int32)
    return torch.clamp(q, 0, grid)


def project_gaussians(
    means3d: torch.Tensor,          # (N, 3)
    scales: torch.Tensor,           # (N, 3) activated (positive)
    quats: torch.Tensor,            # (N, 4) (normalized internally)
    camera: Camera,
    img_width: int,
    img_height: int,
    tile_size: int,
    ndc_offset: torch.Tensor | None = None,   # (N, 2) zero grad-carrier
    alive: torch.Tensor | None = None,        # (N,) bool
    scale_modifier: float = 1.0,
    opacities: torch.Tensor | None = None,    # (N,) activated, optional
) -> Projected:
    W = camera.world_view

    # --- view transform + frustum cull ---
    t = means3d @ W[:3, :3].T + W[:3, 3]
    tz = t[:, 2]
    in_front = tz > FRUSTUM_NEAR
    # Culled gaussians get a safe depth for all division-bearing math: a
    # point within float-epsilon of the camera plane would otherwise give
    # inf/NaN. Their outputs are never consumed (radius 0, never binned).
    tz_safe = torch.where(in_front, tz, torch.ones_like(tz))

    # --- perspective projection to NDC, then pixels ---
    P = camera.full_proj
    ph = means3d @ P[:3, :3].T + P[:3, 3]
    pw = means3d @ P[3, :3] + P[3, 3]
    rw = 1.0 / torch.where(in_front, pw + 1e-7, torch.ones_like(pw))
    ndc_xy = ph[:, :2] * rw[:, None]
    if ndc_offset is not None:
        ndc_xy = ndc_xy + ndc_offset
    pix = torch.stack([
        ((ndc_xy[:, 0] + 1.0) * img_width - 1.0) * 0.5,
        ((ndc_xy[:, 1] + 1.0) * img_height - 1.0) * 0.5], dim=-1)

    # --- 3D covariance (packed symmetric) ---
    cov3d = transforms.build_covariance_packed(scales, quats, scale_modifier)
    c_xx, c_xy, c_xz, c_yy, c_yz, c_zz = cov3d.unbind(-1)

    # --- EWA: cov2d = M Sigma M^T, M = J @ W3 (2x3 per Gaussian) ---
    fx = img_width / (2.0 * camera.tanfovx)
    fy = img_height / (2.0 * camera.tanfovy)
    limx = 1.3 * camera.tanfovx
    limy = 1.3 * camera.tanfovy
    txz = torch.clamp(t[:, 0] / tz_safe, -limx, limx) * tz_safe
    tyz = torch.clamp(t[:, 1] / tz_safe, -limy, limy) * tz_safe
    inv_z = 1.0 / tz_safe
    inv_z2 = inv_z * inv_z
    j00 = fx * inv_z
    j02 = -fx * txz * inv_z2
    j11 = fy * inv_z
    j12 = -fy * tyz * inv_z2
    R3 = W[:3, :3]
    m0 = j00[:, None] * R3[0] + j02[:, None] * R3[2]   # (N, 3)
    m1 = j11[:, None] * R3[1] + j12[:, None] * R3[2]   # (N, 3)

    def sigma_vec(v):
        """Sigma @ v for packed symmetric Sigma, batched."""
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
    # the floor keeps inv_det finite for denormal dets; the inner where
    # keeps a culled det out of the reciprocal's backward
    det_safe = torch.where(det_ok, det, torch.ones_like(det))
    inv_det = torch.where(det_ok, 1.0 / torch.clamp(det_safe, min=1e-30),
                          torch.zeros_like(det))
    conic = torch.stack([cov11 * inv_det, -cov01 * inv_det, cov00 * inv_det],
                        dim=-1)
    with torch.no_grad():
        radius, rect_min, rect_max, tiles_touched, cull_r2 = _footprint(
            pix, cov00, cov11, det, det_ok, in_front, alive, opacities,
            img_width, img_height, tile_size)
    return Projected(pix=pix, depth=tz, conic=conic, radius=radius,
                     rect_min=rect_min, rect_max=rect_max,
                     tiles_touched=tiles_touched, cull_r2=cull_r2)


def _footprint(pix, cov00, cov11, det, det_ok, in_front, alive, opacities,
               img_width, img_height, tile_size):
    """The integer outputs: radius, tile rects, tiles touched and the
    corner-cull radius. Binning decisions carry no gradient."""
    n = pix.shape[0]
    mid = 0.5 * (cov00 + cov11)
    lam1 = mid + torch.sqrt(torch.clamp(mid * mid - det, min=0.1))
    radius_f = torch.ceil(RADIUS_SIGMA * torch.sqrt(lam1))

    visible = in_front & det_ok
    if alive is not None:
        visible = visible & alive
    radius = torch.where(visible, radius_f,
                         torch.zeros_like(radius_f)).to(torch.int32)

    # --- tile rects ---
    # Square box of the 3-sigma circumradius, tightened per axis when
    # opacities are given: alpha(d) <= op * exp(-0.5 dx^2 / cov_xx), so
    # every pixel with |dx| >= sqrt(2 ln(op / ALPHA_MIN) cov_xx) (same for
    # y) is a guaranteed blend-gate skip and culling its tile cannot change
    # the image.
    grid_x = (img_width + tile_size - 1) // tile_size
    grid_y = (img_height + tile_size - 1) // tile_size
    rf = radius.to(torch.float32)
    cull_r2 = torch.full((n,), NO_CULL_R2, dtype=torch.int32,
                         device=pix.device)
    if opacities is not None:
        op = opacities
        op_ok = op > ALPHA_MIN
        q = 2.0 * torch.log(torch.clamp(op, min=ALPHA_MIN) / ALPHA_MIN) + 1e-6
        rx = torch.minimum(torch.sqrt(q * torch.clamp(cov00, min=0.0)), rf)
        ry = torch.minimum(torch.sqrt(q * torch.clamp(cov11, min=0.0)), rf)
        zero = torch.zeros_like(rx)
        rx = torch.where(op_ok, rx, zero)
        ry = torch.where(op_ok, ry, zero)
        radius = torch.where(op_ok, radius, torch.zeros_like(radius))
        # Corner-cull radius for the binner: every pixel with
        # d^2 > q * lam1 has alpha < ALPHA_MIN. +64 absorbs f32 rounding.
        cull_r2 = torch.clamp(torch.ceil(q * lam1) + 64.0,
                              max=float(NO_CULL_R2)).to(torch.int32)
    else:
        rx = ry = rf
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
    # zero the rect span for untouched gaussians so binning is clean
    rect_max = torch.where((tiles_touched > 0)[:, None], rect_max, rect_min)
    return radius, rect_min, rect_max, tiles_touched, cull_r2
