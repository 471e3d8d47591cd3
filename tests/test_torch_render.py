"""The port's render slice as a whole, against the JAX package.

A JAX training state at test size is written with the JAX package's
`save_snapshot` (PLY + npz) and `save_cfg`; the port loads it with
`Renderer.from_snapshot(..., device="cpu")` and renders the fine and coarse
stages at three timestamps, which are compared with the JAX `render` of the
same state. This covers the PLY and npz round trip and convert.py.

Tolerances: color and alpha atol 2e-6, depth rtol 5e-6 (atol 1e-6). The
two sides differ only in float association (the deformation MLP's matmul
sums, the chunked blend products). The worst differences measured at this
size are 3.6e-7 (color), 2.4e-7 (alpha) and 5.5e-7 relative (depth), so
the bounds keep a margin of four to nine over them, well inside the 1e-4
that a first bound would have allowed.
"""
import dataclasses
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from __graft_entry__ import _synthetic_scene
from fourdgs_tpu.data.camera import make_camera as jax_make_camera
from fourdgs_tpu.render.render import render as jax_render
from fourdgs_tpu.train import checkpoint as jckpt
from fourdgs_tpu.train import config as jconfig
from fourdgs_tpu.train import state as jstate
from fourdgs_tpu.ops.rasterize_tiled import RasterConfig as JaxRasterConfig
from fourdgs_tpu_torch import convert
from fourdgs_tpu_torch.data.camera import look_at_camera, make_camera
from fourdgs_tpu_torch.ops import _build
from fourdgs_tpu_torch.render import serve
from fourdgs_tpu_torch.render.render import render as port_render
from fourdgs_tpu_torch.train import checkpoint as tckpt
from fourdgs_tpu_torch.train import config as tconfig
from fourdgs_tpu_torch.render.serve import Renderer
from fourdgs_tpu_torch.utils.device import resolve_device

torch.set_num_threads(1)
cpu_camera = functools.partial(make_camera, device="cpu")

W, H = 64, 48
TIMES = (0.0, 0.4, 1.0)
TOL_C = 2e-6
TOL_D = 5e-6


def _cfg():
    cfg = jconfig.Config()
    cfg.hidden.kplanes_config["resolution"] = [8, 8, 8, 4]
    cfg.hidden.kplanes_config["output_coordinate_dim"] = 8
    cfg.hidden.multires = [1, 2]
    cfg.hidden.net_width = 32
    cfg.raster = jconfig.RasterParams(capacity=512, tile_size=16,
                                      tile_cap=64, chunk=8)
    return cfg


def _look_at(theta, make):
    pos = np.array([4.0 * np.sin(theta), 0.2, 4.0 * np.cos(theta)])
    fwd = -pos / np.linalg.norm(pos)
    right = np.cross([0.0, 1.0, 0.0], fwd)
    right /= np.linalg.norm(right)
    r_w2c = np.stack([right, np.cross(fwd, right), fwd])
    return lambda t: make(r_w2c.T, -r_w2c @ pos, 0.9, 0.7, time=t)


@pytest.fixture(scope="module")
def snapshot(tmp_path_factory):
    """A JAX state with nontrivial parameters (numpy noise on the time
    planes, SH rest bands, opacities and rotations), saved by the JAX
    package."""
    cfg = _cfg()
    pts, cols = _synthetic_scene(256, seed=3)
    st = jstate.create_state(jax.random.key(0), cfg, pts, cols, 1.0)
    rng = np.random.default_rng(0)
    flat = jckpt._flatten(st.params["deform"])
    for k in flat:
        if k.startswith("grid/"):
            flat[k] = (flat[k] + rng.normal(0, 0.3, flat[k].shape)).astype(
                np.float32)
    deform = jckpt.deform_params_from_flat(st.params["deform"], flat)
    g = st.params["gauss"]
    cap = g.xyz.shape[0]
    gauss = g._replace(
        features_rest=jnp.asarray(rng.normal(0, 0.3, g.features_rest.shape),
                                  jnp.float32),
        opacity=jnp.asarray(rng.normal(0.5, 1.5, (cap, 1)), jnp.float32),
        rotation=jnp.asarray(rng.normal(size=(cap, 4)), jnp.float32),
        scaling=g.scaling + 0.5)
    st = st._replace(params={"gauss": gauss, "deform": deform})
    path = str(tmp_path_factory.mktemp("snap"))
    jckpt.save_snapshot(st, path, 7)
    jconfig.save_cfg(cfg, os.path.join(path, "cfg_args.json"))
    return path, cfg, st


@pytest.fixture(scope="module")
def renderer(snapshot):
    path, _, _ = snapshot
    return Renderer.from_snapshot(path, device="cpu", width=W, height=H)


def test_snapshot_round_trip(snapshot, renderer):
    _, _, st = snapshot
    alive = np.asarray(st.alive)
    n = int(alive.sum())
    assert renderer.iteration == 7 and renderer.gauss.capacity == n
    for f in ("xyz", "features_dc", "features_rest", "scaling", "rotation",
              "opacity"):
        np.testing.assert_array_equal(
            getattr(renderer.gauss, f).numpy(),
            np.asarray(getattr(st.params["gauss"], f))[alive], err_msg=f)
    flat = jckpt._flatten(st.params["deform"])
    back = convert.deformation_to_flat(renderer.deform)
    assert sorted(back) == sorted(flat)
    for k in flat:
        np.testing.assert_array_equal(back[k], flat[k], err_msg=k)
    np.testing.assert_array_equal(renderer.aabb.numpy(), np.asarray(st.aabb))


@pytest.mark.parametrize("stage", ["fine", "coarse"])
@pytest.mark.parametrize("t", TIMES)
def test_render_matches_jax(snapshot, renderer, stage, t):
    _, cfg, st = snapshot
    rc = renderer.raster_cfg
    jrc = JaxRasterConfig(img_width=W, img_height=H,
                          **{f.name: getattr(rc, f.name)
                             for f in dataclasses.fields(rc)
                             if f.name not in ("img_width", "img_height")})
    a = jax_render(st.params["gauss"], st.params["deform"],
                   _look_at(0.3, jax_make_camera)(t), jnp.ones(3), jrc,
                   jstate.deform_config_from(cfg), st.aabb, st.alive, 3,
                   stage=stage)
    b = renderer.render(_look_at(0.3, cpu_camera)(t), stage=stage)
    alpha = b.alpha.numpy()
    assert alpha.mean() > 0.05 and alpha.min() < 0.9   # a real image
    np.testing.assert_allclose(b.color.numpy(), np.asarray(a.color),
                               atol=TOL_C)
    np.testing.assert_allclose(alpha, np.asarray(a.alpha), atol=TOL_C)
    np.testing.assert_allclose(b.depth.numpy(), np.asarray(a.depth),
                               rtol=TOL_D, atol=1e-6)
    for f in ("dropped_pairs", "num_pairs"):
        assert int(getattr(b, f)) == int(getattr(a, f)), f


@pytest.mark.parametrize("option", ["sh_degree_1", "override_color"])
def test_render_options_match_jax(snapshot, renderer, option):
    """An integer active SH degree below the maximum with a scale
    modifier, and override colors (which skip the SH evaluation)."""
    _, cfg, st = snapshot
    rc = renderer.raster_cfg
    jrc = JaxRasterConfig(img_width=W, img_height=H,
                          **{f.name: getattr(rc, f.name)
                             for f in dataclasses.fields(rc)
                             if f.name not in ("img_width", "img_height")})
    alive = np.asarray(st.alive)
    kw = dict(active_sh_degree=1, scale_modifier=0.8)
    tkw = dict(kw)
    if option == "override_color":
        cols = np.random.default_rng(4).uniform(
            0, 1, (alive.shape[0], 3)).astype(np.float32)
        kw = dict(active_sh_degree=3, override_color=jnp.asarray(cols))
        tkw = dict(active_sh_degree=3,
                   override_color=torch.from_numpy(cols[alive]))
    a = jax_render(st.params["gauss"], st.params["deform"],
                   _look_at(0.3, jax_make_camera)(0.6), jnp.ones(3), jrc,
                   jstate.deform_config_from(cfg), st.aabb, st.alive,
                   **kw)
    with torch.no_grad():
        b = port_render(renderer.gauss, renderer.deform,
                        _look_at(0.3, cpu_camera)(0.6), renderer.bg, rc,
                        renderer.aabb, renderer.alive, **tkw)
    np.testing.assert_allclose(b.color.numpy(), np.asarray(a.color),
                               atol=TOL_C)
    np.testing.assert_allclose(b.alpha.numpy(), np.asarray(a.alpha),
                               atol=TOL_C)


def test_time_moves_the_fine_render(renderer):
    cam = _look_at(0.3, cpu_camera)
    a = renderer.render(cam(0.0)).color
    b = renderer.render(cam(1.0)).color
    c = renderer.render(cam(0.0), stage="coarse").color
    d = renderer.render(cam(1.0), stage="coarse").color
    assert float((a - b).abs().max()) > 1e-3
    assert float((c - d).abs().max()) == 0.0


def test_serve_cli_cpu(snapshot, tmp_path, capsys):
    path, _, _ = snapshot
    serve.main(["-m", path, "--frames", "2", "--device", "cpu",
                "--width", str(W), "--height", str(H),
                "--out", str(tmp_path)])
    out = capsys.readouterr().out
    assert "device: cpu; frames: 2" in out
    frames = sorted(p for p in os.listdir(tmp_path) if p.endswith(".npy"))
    assert len(frames) == 2
    img = np.load(tmp_path / frames[1])
    assert img.shape == (H, W, 3) and np.isfinite(img).all()


def test_no_fallback_without_cuda(snapshot):
    """With no card, the default device raises; nothing falls back. That
    holds for every loader of the snapshot and parameter API, not only for
    the renderer."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    path, cfg, st = snapshot
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="CUDA"):
        Renderer.from_snapshot(path)
    snap_dir, _ = tckpt.find_latest_snapshot(path)
    with pytest.raises(RuntimeError, match="CUDA"):
        tckpt.restore_gaussians_from_snapshot(snap_dir, cap=1)
    flat = jckpt._flatten(st.params["deform"])
    dcfg = tconfig.deform_config_from(tconfig.load_cfg(
        os.path.join(path, "cfg_args.json")))
    with pytest.raises(RuntimeError, match="CUDA"):
        tckpt.deform_params_from_flat(flat, dcfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        convert.deformation_from_flat(flat, dcfg)
    fields = {f: np.asarray(getattr(st.params["gauss"], f))
              for f in st.params["gauss"]._fields}
    with pytest.raises(RuntimeError, match="CUDA"):
        convert.gaussians_from_numpy(fields)
    with pytest.raises(RuntimeError, match="CUDA"):
        make_camera(np.eye(3), np.zeros(3), 0.9, 0.7)
    with pytest.raises(RuntimeError, match="CUDA"):
        look_at_camera()
    with pytest.raises(RuntimeError, match="CUDA"):
        _build.load_library()
    assert resolve_device("cpu").type == "cpu"
