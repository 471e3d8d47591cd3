"""Port parity for the blend backward (ops/blend.py), the differentiable
rasterizer (ops/rasterize_tiled.py), the projection's backward guards
(ops/projection.py) and the per-pixel oracle (ops/rasterize_ref.py).

On the CPU the port's backward is its plain version. It is held against
the JAX package's XLA blend backward (`_make_blend`, backend "xla"), which
tests/test_pallas_blend.py proves equal to the Pallas kernels; the Pallas
backward in interpret mode is too slow for the fast tier. Gradients are
compared with the JAX tests' normalised tolerance: each column group (or
each leaf) divided by its largest magnitude, atol 1e-4
(tests/test_pallas_blend.py). tests/test_torch_kernels_gpu.py holds the
CUDA kernel K2 against the plain version on the card.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fourdgs_tpu.ops import rasterize_ref as jref
from fourdgs_tpu.ops import rasterize_tiled as jrt
from fourdgs_tpu_torch.data import camera as tcam
from fourdgs_tpu_torch.ops import blend as tblend
from fourdgs_tpu_torch.ops import rasterize_ref as tref
from fourdgs_tpu_torch.ops import rasterize_tiled as trt
from tests.test_rasterize import FOV, H, W, simple_camera
from tests.test_torch_blend import _binned_inputs, _cfgs, _scene

torch.set_num_threads(1)

GRAD_TOL = 1e-4
# column groups of the (N, 10) gradient rows
GROUPS = {"pix": (0, 2), "conic": (2, 5), "color": (5, 8), "opacity": (8, 9),
          "depth": (9, 10)}
BG = np.array([0.3, 0.1, 0.7], np.float32)


def _normalised_close(port, ref, name):
    port, ref = np.asarray(port), np.asarray(ref)
    assert np.isfinite(port).all(), name
    scale = np.abs(ref).max() + 1e-8
    np.testing.assert_allclose(port / scale, ref / scale, atol=GRAD_TOL,
                               err_msg=name)


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.mark.parametrize("ts", [16, 32])
@pytest.mark.parametrize("kind", ["random", "saturating"])
def test_blend_backward_plain_matches_jax(kind, ts):
    """The same binned inputs and random cotangents through JAX's XLA
    blend VJP and the port's forward + plain backward."""
    jcfg, tcfg = _cfgs(ts)
    proj, binned, opac, colors = _binned_inputs(kind, jcfg)
    rng = np.random.default_rng(5)
    nt, p = tcfg.num_tiles, tcfg.pixels_per_tile
    g_c = rng.normal(size=(nt, p, 3)).astype(np.float32)
    g_d = rng.normal(size=(nt, p)).astype(np.float32)
    g_t = rng.normal(size=(nt, p)).astype(np.float32)

    blend = jrt._make_blend(jcfg)
    px, py = jrt._tile_pixel_coords(jcfg)

    def f(pix, conic, color, op, depth):
        return blend(binned.gidx, px, py, pix, conic, color, op, depth,
                     None, None, None)

    _, vjp = jax.vjp(f, proj.pix, proj.conic, jnp.asarray(colors),
                     jnp.asarray(opac), proj.depth)
    ref = vjp((jnp.asarray(g_c), jnp.asarray(g_d), jnp.asarray(g_t)))
    ref = np.concatenate([np.asarray(r).reshape(len(opac), -1) for r in ref],
                         axis=1)

    table = tblend.pack_attr_table(_t(proj.pix), _t(proj.conic), _t(colors),
                                   _t(opac), _t(proj.depth))
    gidx, counts = _t(binned.gidx), _t(binned.counts)
    out = tblend.blend_forward(gidx, counts, table, tcfg)
    before = tblend.blend_backward.launches
    port = tblend.blend_backward(gidx, counts, table, *out, _t(g_c),
                                 _t(g_d), _t(g_t), tcfg)
    assert port.shape == (len(opac), tblend.GRAD_W)
    assert tblend.blend_backward.launches == before  # the CPU runs no kernel
    for name, (a, b) in GROUPS.items():
        _normalised_close(port[:, a:b].numpy(), ref[:, a:b], name)
    assert np.abs(ref).max() > 0


def _raster_loss(out):
    """The loss of tests/test_pallas_blend.py: color, depth and alpha all
    carry a cotangent."""
    return ((out.color ** 2).mean() + 0.1 * out.depth.mean()
            + 0.05 * (out.alpha ** 2).mean())


def _port_grads(fn, arrays):
    leaves = [_t(x).requires_grad_(True) for x in arrays]
    loss = _raster_loss(fn(*leaves))
    return [g.numpy() for g in torch.autograd.grad(loss, leaves)]


def _raster_args(kind):
    means, scales, quats, opac, colors = _scene(kind)
    ndc = np.zeros((len(opac), 2), np.float32)
    return means, scales, quats, opac, colors, ndc


@pytest.mark.parametrize("ts", [16, 32])
@pytest.mark.parametrize("kind", ["random", "saturating"])
def test_rasterize_gradients_match_jax(kind, ts):
    """Gradients of the whole tiled rasterizer in means, scales, quats,
    opacities, colors and the ndc_offset carrier."""
    jcfg, tcfg = _cfgs(ts)
    jcfg = jrt.RasterConfig(**{**jcfg.__dict__, "backend": "xla"})
    args = _raster_args(kind)
    tcam_ = tcam.make_camera(np.eye(3), np.zeros(3), FOV, FOV, device="cpu")

    def jloss(m, s, q, o, c, ndc):
        return _raster_loss(jrt.rasterize(m, s, q, o, c, simple_camera(),
                                          jnp.asarray(BG), jcfg,
                                          ndc_offset=ndc))

    ref = jax.grad(jloss, argnums=tuple(range(6)))(
        *(jnp.asarray(x) for x in args))
    port = _port_grads(
        lambda m, s, q, o, c, ndc: trt.rasterize(m, s, q, o, c, tcam_,
                                                 _t(BG), tcfg,
                                                 ndc_offset=ndc), args)
    for name, a, b in zip(("means", "scales", "quats", "opacities", "colors",
                           "ndc_offset"), port, ref):
        _normalised_close(a, b, name)


def test_rasterize_gradients_match_the_oracle():
    """The tiled path's gradients against the port's own per-pixel
    oracle, as tests/test_rasterize.py holds the JAX package's, at a
    tile_cap that drops no pair (the oracle has no caps)."""
    _, tcfg = _cfgs(16, cap=128)
    args = _raster_args("random")
    cam = tcam.make_camera(np.eye(3), np.zeros(3), FOV, FOV, device="cpu")
    tiled = _port_grads(
        lambda m, s, q, o, c, ndc: trt.rasterize(m, s, q, o, c, cam, _t(BG),
                                                 tcfg, ndc_offset=ndc), args)
    oracle = _port_grads(
        lambda m, s, q, o, c, ndc: tref.rasterize_reference(
            m, s, q, o, c, cam, W, H, _t(BG), 16, ndc_offset=ndc), args)
    for name, a, b in zip("msqoc", tiled, oracle):
        _normalised_close(a, b, name)


@pytest.mark.parametrize("with_ndc", [False, True])
def test_rasterize_reference_matches_jax(with_ndc):
    means, scales, quats, opac, colors, ndc = _raster_args("random")
    if with_ndc:
        ndc = np.random.default_rng(8).normal(
            0, 0.01, ndc.shape).astype(np.float32)
    alive = np.ones(len(opac), bool)
    alive[::7] = False
    a = jref.rasterize_reference(
        *(jnp.asarray(x) for x in (means, scales, quats, opac, colors)),
        simple_camera(), W, H, jnp.asarray(BG), ndc_offset=jnp.asarray(ndc),
        alive=jnp.asarray(alive))
    cam = tcam.make_camera(np.eye(3), np.zeros(3), FOV, FOV, device="cpu")
    b = tref.rasterize_reference(
        *(_t(x) for x in (means, scales, quats, opac, colors)), cam, W, H,
        _t(BG), ndc_offset=_t(ndc), alive=_t(alive))
    np.testing.assert_allclose(b.color.numpy(), np.asarray(a.color),
                               atol=1e-5)
    np.testing.assert_allclose(b.depth.numpy(), np.asarray(a.depth),
                               atol=1e-4)
    np.testing.assert_allclose(b.alpha.numpy(), np.asarray(a.alpha),
                               atol=1e-5)
    np.testing.assert_array_equal(b.radii.numpy(), np.asarray(a.radii))
    assert 0.05 < float(b.alpha.mean()) < 0.95


def test_backward_guards_keep_every_gradient_finite():
    """A gaussian behind the camera, one on the camera plane, one with a
    degenerate (rank-one, huge) covariance whose 2D determinant cancels,
    and ordinary ones in front: every leaf's gradient is finite, and the
    culled ones get none."""
    rng = np.random.default_rng(9)
    n = 12
    means = np.stack([rng.uniform(-0.5, 0.5, n), rng.uniform(-0.5, 0.5, n),
                      rng.uniform(2.0, 5.0, n)], -1).astype(np.float32)
    scales = np.exp(rng.uniform(-3, -1.5, (n, 3))).astype(np.float32)
    quats = rng.normal(size=(n, 4)).astype(np.float32)
    means[0] = [0.1, 0.0, -2.0]          # behind the camera
    means[1] = [0.1, 0.1, 0.0]           # on the camera plane
    means[2] = [0.0, 0.0, 3.0]           # degenerate covariance
    scales[2] = [3e4, 1e-8, 1e-8]
    quats[2] = [0.92388, 0.0, 0.0, 0.38268]
    opac = rng.uniform(0.3, 0.9, n).astype(np.float32)
    colors = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    ndc = np.zeros((n, 2), np.float32)
    _, tcfg = _cfgs(16)
    cam = tcam.make_camera(np.eye(3), np.zeros(3), FOV, FOV, device="cpu")
    leaves = [_t(x).requires_grad_(True)
              for x in (means, scales, quats, opac, colors, ndc)]
    m, s, q, o, c, d = leaves
    # raw parameters through the activations, as the render path has them
    out = trt.rasterize(m, torch.exp(torch.log(s)), q, o, c, cam, _t(BG),
                        tcfg, ndc_offset=d)
    assert int(out.radii[0]) == 0 and int(out.radii[1]) == 0
    grads = torch.autograd.grad(_raster_loss(out), leaves)
    for name, g in zip(("means", "scales", "quats", "opacities", "colors",
                        "ndc_offset"), grads):
        assert torch.isfinite(g).all(), name
    assert float(grads[0][:2].abs().max()) == 0.0
    assert float(grads[0][3:].abs().max()) > 0.0


def test_blend_backward_rejects_bad_inputs():
    _, tcfg = _cfgs(16)
    nt, p = tcfg.num_tiles, tcfg.pixels_per_tile
    gidx = torch.full((nt, 64), -1, dtype=torch.int32)
    counts = torch.zeros(nt, dtype=torch.int32)
    table = torch.zeros((5, 16))
    out = tblend.blend_forward(gidx, counts, table, tcfg)
    cot = (torch.zeros(nt, p, 3), torch.zeros(nt, p), torch.zeros(nt, p))
    with pytest.raises(ValueError, match="cotangent color"):
        tblend.blend_backward(gidx, counts, table, *out,
                              torch.zeros(nt, p, 4), *cot[1:], tcfg)
    with pytest.raises(ValueError, match="output t"):
        tblend.blend_backward(gidx, counts, table, *out[:2],
                              out[2].double(), *cot, tcfg)
    g = tblend.blend_backward(gidx, counts, table, *out, *cot, tcfg)
    assert g.shape == (4, tblend.GRAD_W) and float(g.abs().max()) == 0.0


def test_nan_splat_is_skipped_like_jax():
    """A splat whose conic is NaN composites nothing, in the port's blend as
    in the JAX package's (its alpha gate `alpha >= 1/255` is false for a
    NaN); the other splats are untouched."""
    jcfg, tcfg = _cfgs(16)
    proj, binned, opac, colors = _binned_inputs("random", jcfg)
    conic = np.array(proj.conic)
    hit = int(np.asarray(binned.gidx)[np.asarray(binned.counts) > 0][0, 0])
    conic[hit] = np.nan
    blend = jrt._make_blend(jcfg)
    px, py = jrt._tile_pixel_coords(jcfg)
    ref = blend(binned.gidx, px, py, proj.pix, jnp.asarray(conic),
                jnp.asarray(colors), jnp.asarray(opac), proj.depth,
                None, None, None)
    table = tblend.pack_attr_table(_t(proj.pix), _t(conic), _t(colors),
                                   _t(opac), _t(proj.depth))
    port = tblend.blend_forward(_t(binned.gidx), _t(binned.counts), table,
                                tcfg)
    for name, a, b, tol in zip(("color", "depth", "t"), port, ref,
                               (1e-5, 1e-4, 1e-5)):
        assert np.isfinite(a.numpy()).all(), name
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=tol,
                                   err_msg=name)
