"""The scene of a run, made on the device from the run's seed: a "true"
scene, whose renders are the training targets and which the serving cells
serve, and the trained state, a seeded perturbation of it.

The gaussians follow the benchmark scene rule (a frozen copy of
fourdgs_tpu_torch/tools/profile_blend_split.py:synthetic_points): n points
uniform in a cube of half-side max(1, (n / 100k)^(1/3)), so that the depth
per tile stays that of 100k points in [-1, 1]^3, and uniform colors (the
SH DC term); the configuration's `assumed.scene` adds what that rule
leaves open: log-scales at `scale_spacing` times the mean point spacing
with a normal jitter (the mean 3-NN distance of uniform points is 0.75
spacings, which is how the port initialises scales), uniform opacities,
random rotations, small higher SH bands. The deformation's planes and
weights are drawn as the port initialises them (spatial planes uniform in
[0.1, 0.5], xavier-uniform weights, biases uniform in 1/sqrt(fan_in)),
the time planes at 1 plus a uniform jitter so that the scene moves with
t. Slots n and above are dead: zero, rotation w = 1, as the port pads.

Every tensor comes from a few large draws of one `torch.Generator` on the
run's device; the same seed gives the same scene.
"""
from __future__ import annotations

import math

import torch

from portbench.reference.deformation import COO_COMBS, DeformSpec

C0 = 0.28209479177387814
GAUSS_SHAPES = {"xyz": (3,), "features_dc": (1, 3), "features_rest": (15, 3),
                "scaling": (3,), "rotation": (4,), "opacity": (1,)}


def generator(seed: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % (1 << 63))
    return g


def deform_spec(config: dict) -> DeformSpec:
    p = config["published"]
    return DeformSpec(
        resolution=tuple(p["kplanes_resolution"]), out_dim=p["kplanes_dim"],
        multires=tuple(p["multires"]), net_width=p["net_width"],
        defor_depth=p["defor_depth"], no_dx=p["no_dx"], no_ds=p["no_ds"],
        no_dr=p["no_dr"], no_do=p["no_do"], no_dshs=p["no_dshs"],
        sh_coeffs=(p["sh_degree"] + 1) ** 2)


def _deformation(spec: DeformSpec, s: dict, g, device) -> dict:
    shapes = spec.shapes()
    total = sum(math.prod(v) for v in shapes.values())
    u = torch.rand(total, generator=g, device=device)
    out, at = {}, 0
    for name, shape in shapes.items():
        k = math.prod(shape)
        x = u[at:at + k].reshape(shape)
        at += k
        if name.startswith("grid.planes."):
            ci = int(name.split("_p")[1])
            if 3 in COO_COMBS[ci]:
                j = s["grid_time_jitter"]
                x = 1.0 + j * (2 * x - 1)
            else:
                lo, hi = s["grid_space"]
                x = lo + (hi - lo) * x
        elif name.endswith(".weight"):
            fo, fi = shape
            x = (2 * x - 1) * (6.0 / (fi + fo)) ** 0.5
        else:
            fi = shapes[name[:-len("bias")] + "weight"][1]
            x = (2 * x - 1) / fi ** 0.5
        out[name] = x.contiguous()
    return out


def true_scene(config: dict, seed: int, device) -> tuple[dict, dict]:
    """(params, fixed): the true scene's named parameters at the
    configuration's capacity, and `alive`, `aabb` and the background."""
    a = config["assumed"]
    s = a["scene"]
    n, cap = a["gaussians"], a["capacity"]
    g = generator(seed, device)
    half = max(1.0, (n / 100_000.0) ** (1.0 / 3.0))
    u = torch.rand((n, 10), generator=g, device=device)
    z = torch.randn((n, 4 + 3 + 45), generator=g, device=device)
    spacing = 2 * half / n ** (1.0 / 3.0)
    lo, hi = s["opacity"]
    op = lo + (hi - lo) * u[:, 9]
    live = {
        "xyz": (2 * u[:, 0:3] - 1) * half,
        "features_dc": ((u[:, 3:6] - 0.5) / C0)[:, None, :],
        "features_rest": s["f_rest_sd"] * z[:, 7:52].reshape(n, 15, 3),
        "scaling": (math.log(s["scale_spacing"] * spacing)
                    + s["scale_jitter"] * z[:, 4:7]),
        "rotation": z[:, 0:4],
        "opacity": torch.log(op / (1 - op))[:, None],
    }
    params = {}
    for k, shape in GAUSS_SHAPES.items():
        x = torch.zeros((cap,) + shape, device=device)
        x[:n] = live[k]
        params[k] = x
    params["rotation"][n:, 0] = 1.0
    params.update(_deformation(deform_spec(config), s, g, device))
    b = config["published"]["bounds"]
    alive = torch.zeros(cap, dtype=torch.bool, device=device)
    alive[:n] = True
    bgv = 1.0 if config["published"]["white_background"] else 0.0
    fixed = {"alive": alive,
             "aabb": torch.tensor([[b, b, b], [-b, -b, -b]], device=device),
             "bg": torch.full((3,), bgv, device=device)}
    return params, fixed


def trained_state(config: dict, truth: dict, seed: int, device) -> dict:
    """The state a trainer holds late in the fine stage: the true scene
    perturbed by `assumed.trained_from_truth`'s normal deviations (a
    seeded stream of its own)."""
    p = config["assumed"]["trained_from_truth"]
    n = config["assumed"]["gaussians"]
    g = generator(seed ^ 0x5EED, device)
    sd = {"xyz": p["xyz_sd"], "features_dc": p["f_dc_sd"],
          "features_rest": p["f_rest_sd"], "scaling": p["log_scale_sd"],
          "rotation": p["rotation_sd"], "opacity": p["opacity_logit_sd"]}
    parts = {k: (v[:n] if k in sd else v) for k, v in truth.items()}
    z = torch.randn(sum(x.numel() for x in parts.values()), generator=g,
                    device=device)
    out, at = {}, 0
    for k, v in truth.items():
        x = v.clone()
        part = x[:n] if k in sd else x
        part += sd.get(k, p["deform_sd"]) * z[at:at + part.numel()].reshape(
            part.shape)
        at += part.numel()
        out[k] = x
    return out
