"""render(): deformation -> activation -> SH -> rasterize
(counterpart: fourdgs_tpu/render/render.py).

Raw params are deformed in the "fine" stage at the camera's timestamp,
then activated (exp / normalize / sigmoid); colors come from SH evaluated
toward the camera, and everything goes through the tiled rasterizer.
Differentiable; a zero `ndc_offset` input is the screen-space gradient
carrier for the densify statistics. Serving wraps it in torch.no_grad()
(render/serve.py).

The SH degree is a Python int or a 0-d integer tensor, as in the JAX
package: an int evaluates the bands up to it (`sh_to_rgb`; serving, the
evaluations and the mesh's step, whose captured programs key on it), a
tensor evaluates every band of the coefficients and masks those above it
(`sh_to_rgb_dynamic`; the single-card training step, whose captured
program reads the degree from a buffer, so the SH ramp recaptures
nothing). Bands above the active degree get a zero gradient in both.

Spans (utils/tracing.py): `render.splats` over `splats_at`, inside it
`splats.hexplane` (models/hexplane.py) and `splats.heads` (the
deformation's MLP heads, models/deformation.py; the activations and SH
here).
"""
from __future__ import annotations

import math

import torch

from fourdgs_tpu_torch.data.camera import Camera
from fourdgs_tpu_torch.models.deformation import Deformation
from fourdgs_tpu_torch.models.gaussians import GaussianParams
from fourdgs_tpu_torch.ops import sh as sh_ops
from fourdgs_tpu_torch.ops import transforms
from fourdgs_tpu_torch.ops.rasterize_ref import RenderOutput
from fourdgs_tpu_torch.ops.rasterize_tiled import RasterConfig, rasterize
from fourdgs_tpu_torch.utils import tracing


def splats_at(
    gauss: GaussianParams,
    deform: Deformation,
    camera: Camera,
    aabb: torch.Tensor,
    active_sh_degree: int | torch.Tensor,
    stage: str = "fine",
    override_color: torch.Tensor | None = None,
):
    """The rasterizer's inputs at the camera's timestamp:
    (means3d, scales, quats, opacities, colors)."""
    shs = gauss.features()
    if stage == "coarse":
        xyz, scaling, rotation, opacity, shs_f = (
            gauss.xyz, gauss.scaling, gauss.rotation, gauss.opacity, shs)
    elif stage == "fine":
        xyz, scaling, rotation, opacity, shs_f = deform(
            aabb, gauss.xyz, gauss.scaling, gauss.rotation, gauss.opacity,
            shs, camera.time)
    else:
        raise NotImplementedError(stage)

    with tracing.span("splats.heads") as sp:
        scales = transforms.safe_exp_scales(scaling)
        quats = transforms.quat_normalize(rotation)
        opacities = torch.sigmoid(opacity[:, 0])

        if override_color is None:
            dirs = xyz - camera.cam_center
            dirs = dirs / torch.clamp(
                torch.linalg.vector_norm(dirs, dim=-1, keepdim=True),
                min=1e-8)
            if isinstance(active_sh_degree, torch.Tensor):
                max_deg = math.isqrt(shs_f.shape[1]) - 1
                colors = sh_ops.sh_to_rgb_dynamic(active_sh_degree, shs_f,
                                                  dirs, max_deg)
            else:
                colors = sh_ops.sh_to_rgb(int(active_sh_degree), shs_f, dirs)
        else:
            colors = override_color
        return sp.grads(xyz, scales, quats, opacities, colors)


def render(
    gauss: GaussianParams,
    deform: Deformation,
    camera: Camera,
    bg: torch.Tensor,
    raster_cfg: RasterConfig,
    aabb: torch.Tensor,
    alive: torch.Tensor,
    active_sh_degree: int | torch.Tensor,
    stage: str = "fine",
    ndc_offset: torch.Tensor | None = None,
    scale_modifier: float = 1.0,
    override_color: torch.Tensor | None = None,
) -> RenderOutput:
    with tracing.span("render.splats"):
        splats = splats_at(gauss, deform, camera, aabb, active_sh_degree,
                           stage, override_color)
    return rasterize(*splats, camera, bg, raster_cfg, ndc_offset=ndc_offset,
                     alive=alive, scale_modifier=scale_modifier)
