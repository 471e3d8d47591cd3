"""The reference's render against a per-pixel loop over the spec of
fourdgs_tpu_torch/ops/rasterize_ref.py on a tiny scene, its evaluation
counts against the loop's, and the control's TF32 rounding."""
import math

import pytest
import torch

from portbench.reference import raster
from portbench.reference.precision import matmul, tf32_round
from portbench.reference.splats import ALPHA_MAX, ALPHA_MIN, project

W, H, TILE = 40, 24, 16


def _camera():
    from portbench.core import cameras
    c = cameras.look_at([0.3, 0.2, 4.0], 0.9, 2 * math.atan(
        math.tan(0.45) * H / W), 0.5)
    return cameras.to_tensors(c, "cpu")


def _scene(n=30, seed=3):
    g = torch.Generator().manual_seed(seed)
    xyz = (torch.rand((n, 3), generator=g) - 0.5) * 1.6
    scales = torch.exp(torch.rand((n, 3), generator=g) * 1.5 - 3.5)
    quats = torch.randn((n, 4), generator=g)
    opac = 0.2 + 0.79 * torch.rand(n, generator=g)
    colors = torch.rand((n, 3), generator=g)
    alive = torch.ones(n, dtype=torch.bool)
    alive[-2:] = False
    return xyz, scales, quats, opac, colors, alive


def _loop(proj, colors, opac, bg):
    """Composite every gaussian over every pixel, one at a time."""
    visible = proj.tiles_touched > 0
    order = sorted(range(len(opac)), key=lambda i: (
        float(proj.depth[i]) if visible[i] else math.inf, i))
    img = torch.zeros((H, W, 3), dtype=torch.float64)
    ev = co = 0
    for y in range(H):
        for x in range(W):
            t, c = 1.0, torch.zeros(3, dtype=torch.float64)
            for i in order:
                if not visible[i]:
                    continue
                rmin, rmax = proj.rect_min[i], proj.rect_max[i]
                if not (rmin[0] <= x // TILE < rmax[0]
                        and rmin[1] <= y // TILE < rmax[1]):
                    continue
                if t <= 1e-4:
                    break
                ev += 1
                dx = float(proj.pix[i, 0]) - x
                dy = float(proj.pix[i, 1]) - y
                a_, b_, c_ = (float(v) for v in proj.conic[i])
                power = -0.5 * (a_ * dx * dx + c_ * dy * dy) - b_ * dx * dy
                alpha = 0.0 if power > 0 else min(
                    ALPHA_MAX, float(opac[i]) * math.exp(power))
                if alpha < ALPHA_MIN:
                    continue
                co += 1
                c += alpha * t * colors[i].double()
                t *= 1.0 - alpha
            img[y, x] = c + t * bg.double()
    return img, ev, co


def test_render_matches_a_per_pixel_loop():
    xyz, scales, quats, opac, colors, alive = _scene()
    bg = torch.tensor([1.0, 1.0, 1.0])
    proj = project(xyz, scales, quats, opac, _camera(), W, H, TILE, alive,
                   "fp32")
    img, counts = raster.rasterize(proj, colors, opac, bg, W, H, TILE,
                                   "fp32", chunk=4, batch=2)
    want, ev, co = _loop(proj, colors, opac, bg)
    assert float((img.double() - want).abs().max()) < 1e-5
    # the corner cull removes whole tiles' pairs only where every pixel
    # is gated off, so the loop's counts bound the reference's from above
    assert counts.contributing == co
    assert 0 < counts.evaluated <= ev


def test_evaluations_stop_at_each_pixels_exit():
    """Two opaque gaussians over the same pixels: the second is reached
    only where the first leaves the transmittance above 1e-4, which
    alpha 0.99 does (T = 0.01)."""
    xyz = torch.tensor([[0.0, 0.0, 0.0], [0.0, 0.0, -0.5]])
    scales = torch.full((2, 3), 0.5)
    quats = torch.tensor([[1.0, 0, 0, 0], [1.0, 0, 0, 0]])
    opac = torch.tensor([0.999, 0.999])
    colors = torch.rand(2, 3)
    alive = torch.ones(2, dtype=torch.bool)
    proj = project(xyz, scales, quats, opac, _camera(), W, H, TILE, alive,
                   "fp32")
    _, counts = raster.rasterize(proj, colors, opac, torch.zeros(3), W, H,
                                 TILE, "fp32", chunk=1)
    _, ev, co = _loop(proj, colors, opac, torch.zeros(3))
    assert counts.evaluated == ev and counts.contributing == co
    assert ev == 2 * W * H


@pytest.mark.parametrize("value,want", [(1.0, 1.0), (1 + 2 ** -11, 1.0),
                                        (1 + 3 * 2 ** -11, 1 + 2 ** -9),
                                        (-(1 + 2 ** -10), -(1 + 2 ** -10))])
def test_tf32_rounds_to_ten_mantissa_bits(value, want):
    assert float(tf32_round(torch.tensor([value]))[0]) == want


def test_tf32_matmul_and_its_gradient_differ_from_float32():
    g = torch.Generator().manual_seed(0)
    a = torch.randn((64, 64), generator=g, requires_grad=True)
    b = torch.randn((64, 8), generator=g)
    exact = matmul(a, b, "fp32")
    low = matmul(a, b, "tf32")
    exact = exact.detach()
    rel = float((low.detach() - exact).abs().max() / exact.abs().max())
    assert 1e-5 < rel < 1e-2
    low.sum().backward()
    want = tf32_round(b).sum(1)[None, :].expand(64, 64)
    assert torch.allclose(a.grad, want, rtol=1e-6, atol=1e-6)
