"""Port parity for the blend forward (ops/blend.py) and the forward
rasterizer (ops/rasterize_tiled.py).

On the CPU the port's blend is its plain version; it is held against the
JAX package's Pallas blend (K1, interpret mode on the CPU, as
tests/test_pallas_blend.py runs it) and its XLA blend, on the same binned
inputs, at tile sizes 16 and 32. Tolerances are those of
tests/test_pallas_blend.py: color 1e-5, depth 1e-4, transmittance/alpha
1e-5. tests/test_torch_kernels_gpu.py holds the CUDA kernel against the
plain version on the card."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fourdgs_tpu.ops import rasterize_tiled as jrt
from fourdgs_tpu.ops.pallas import blend as jpb
from fourdgs_tpu.ops.projection import project_gaussians
from fourdgs_tpu_torch.data import camera as tcam
from fourdgs_tpu_torch.ops import blend as tblend
from fourdgs_tpu_torch.ops import rasterize_tiled as trt
from tests.test_rasterize import FOV, H, W, random_scene, simple_camera

torch.set_num_threads(1)

TOL = {"color": 1e-5, "depth": 1e-4, "t": 1e-5}


def _cfgs(ts, cap=64, chunk=8):
    kw = dict(img_width=W, img_height=H, tile_size=ts, tile_cap=cap,
              chunk=chunk, bin_pairs_per_chunk=4096)
    return jrt.RasterConfig(**kw), trt.RasterConfig(**kw)


def _scene(kind):
    if kind == "random":
        return tuple(np.asarray(x) for x in
                     random_scene(np.random.default_rng(11), n=96))
    # deep stack of near-opaque splats covering the image: every pixel
    # saturates after the first chunks (tests/test_pallas_blend.py:38)
    rng = np.random.default_rng(7)
    n = 64
    means = np.stack([rng.uniform(-0.1, 0.1, n), rng.uniform(-0.1, 0.1, n),
                      np.linspace(2.0, 6.0, n)], -1).astype(np.float32)
    scales = np.full((n, 3), 2.0, np.float32)
    quats = np.tile(np.array([1, 0, 0, 0], np.float32), (n, 1))
    opac = rng.uniform(0.9, 0.99, n).astype(np.float32)
    colors = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    return means, scales, quats, opac, colors


def _binned_inputs(kind, jcfg):
    """JAX projection + binning of a scene, and the attributes both blends
    take."""
    means, scales, quats, opac, colors = _scene(kind)
    proj = project_gaussians(jnp.asarray(means), jnp.asarray(scales),
                             jnp.asarray(quats), simple_camera(), W, H,
                             jcfg.tile_size, opacities=jnp.asarray(opac))
    binned = jrt.bin_gaussians_count(proj, jcfg)
    return proj, binned, opac, colors


def _jax_blend(backend, jcfg, proj, binned, opac, colors):
    blend = (jpb.make_blend(jcfg) if backend == "pallas"
             else jrt._make_blend(jcfg))
    px, py = jrt._tile_pixel_coords(jcfg)
    out = blend(binned.gidx, px, py, proj.pix, proj.conic,
                jnp.asarray(colors), jnp.asarray(opac), proj.depth,
                None, None, None)
    return [np.asarray(o) for o in out]


def _port_blend(tcfg, proj, binned, opac, colors):
    def t(x):
        return torch.from_numpy(np.array(x))
    table = tblend.pack_attr_table(t(proj.pix), t(proj.conic), t(colors),
                                   t(opac), t(proj.depth))
    return tblend.blend_forward(t(binned.gidx), t(binned.counts), table,
                                tcfg)


def _assert_blend_close(port, ref):
    for name, a, b in zip(("color", "depth", "t"), port, ref):
        assert tuple(a.shape) == b.shape, name
        np.testing.assert_allclose(a.numpy(), b, atol=TOL[name],
                                   err_msg=name)


@pytest.mark.parametrize("backend", ["pallas", "xla"])
@pytest.mark.parametrize("ts", [16, 32])
@pytest.mark.parametrize("kind", ["random", "saturating"])
def test_blend_plain_matches_jax(kind, ts, backend):
    jcfg, tcfg = _cfgs(ts)
    proj, binned, opac, colors = _binned_inputs(kind, jcfg)
    ref = _jax_blend(backend, jcfg, proj, binned, opac, colors)
    port = _port_blend(tcfg, proj, binned, opac, colors)
    _assert_blend_close(port, ref)
    if kind == "saturating":
        assert float(port[2].max()) <= 1e-3   # every pixel saturated
    else:
        assert 0.0 < float(port[2].min()) < 0.5 < float(port[2].max())


def test_tile_pixel_coords():
    for ts in (16, 32):
        jcfg, tcfg = _cfgs(ts)
        for a, b in zip(tblend.tile_pixel_coords(tcfg, "cpu"),
                        jrt._tile_pixel_coords(jcfg)):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_pack_attr_table():
    rng = np.random.default_rng(3)
    cols = [rng.normal(size=s).astype(np.float32)
            for s in ((50, 2), (50, 3), (50, 3), (50,), (50,))]
    a = tblend.pack_attr_table(*(torch.from_numpy(c) for c in cols))
    np.testing.assert_array_equal(a.numpy(),
                                  np.asarray(jpb.pack_attr_table(*cols)))


@pytest.mark.parametrize("backend", ["pallas", "xla"])
@pytest.mark.parametrize("ts", [16, 32])
def test_rasterize_matches_jax(ts, backend):
    jcfg, tcfg = _cfgs(ts)
    jcfg = jrt.RasterConfig(**{**jcfg.__dict__, "backend": backend})
    means, scales, quats, opac, colors = _scene("random")
    bg = np.array([0.3, 0.1, 0.7], np.float32)
    a = jrt.rasterize(*(jnp.asarray(x) for x in
                        (means, scales, quats, opac, colors)),
                      simple_camera(), jnp.asarray(bg), jcfg)
    cam = tcam.make_camera(np.eye(3), np.zeros(3), FOV, FOV, device="cpu")
    b = trt.rasterize(*(torch.from_numpy(np.array(x)) for x in
                        (means, scales, quats, opac, colors)),
                      cam, torch.from_numpy(bg), tcfg)
    np.testing.assert_allclose(b.color.numpy(), np.asarray(a.color),
                               atol=TOL["color"])
    np.testing.assert_allclose(b.depth.numpy(), np.asarray(a.depth),
                               atol=TOL["depth"])
    np.testing.assert_allclose(b.alpha.numpy(), np.asarray(a.alpha),
                               atol=TOL["t"])
    for f in ("dropped_pairs", "dropped_tile", "num_pairs", "tile_peak"):
        assert int(getattr(b, f)) == int(getattr(a, f)), f
    np.testing.assert_array_equal(b.radii.numpy(), np.asarray(a.radii))


def test_blend_rejects_bad_inputs():
    _, tcfg = _cfgs(16)
    nt = tcfg.num_tiles
    gidx = torch.full((nt, 64), -1, dtype=torch.int32)
    counts = torch.zeros(nt, dtype=torch.int32)
    table = torch.zeros((5, 16))
    with pytest.raises(TypeError):
        tblend.blend_forward(gidx.long(), counts, table, tcfg)
    with pytest.raises(ValueError):
        tblend.blend_forward(gidx[:, :32], counts, table, tcfg)
    with pytest.raises(ValueError):
        tblend.blend_forward(gidx, counts, table[:, :10], tcfg)
    # an empty tile list blends to the background
    c, d, t = tblend.blend_forward(gidx, counts, table, tcfg)
    assert float(c.abs().max()) == 0 and float(t.min()) == 1.0
