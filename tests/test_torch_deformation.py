"""Port parity for the deformation field: models/hexplane.py and
models/deformation.py against the JAX package at the D-NeRF width
(configs/dnerf/dnerf_default.py: resolution [64,64,64,25], out_dim 32,
multires [1,2], net_width 64, defor_depth 0, sh_degree 3). JAX parameters
come from `init_deform` with numpy noise on the time planes, and cross over
through convert.py."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fourdgs_tpu.models import deformation as jdef
from fourdgs_tpu.models import hexplane as jhex
from fourdgs_tpu.train.checkpoint import _flatten
from fourdgs_tpu_torch import convert
from fourdgs_tpu_torch.models import deformation as tdef
from fourdgs_tpu_torch.models import hexplane as thex

torch.set_num_threads(1)

N = 512
GRID = dict(resolution=(64, 64, 64, 25), out_dim=32, multires=(1, 2))
BASE = dict(net_width=64, defor_depth=0, sh_coeffs=16)
VARIANT = dict(net_width=64, defor_depth=2, sh_coeffs=16, static_mlp=True,
               apply_rotation=True, no_do=False, no_dshs=False,
               dx_bound=0.1, ds_bound=0.2, dr_bound=0.3)
TOL = dict(rtol=1e-5, atol=1e-5)


def _configs(kw):
    jc = jdef.DeformConfig(grid=jhex.HexPlaneConfig(**GRID), **kw)
    tc = tdef.DeformConfig(grid=thex.HexPlaneConfig(**GRID), **kw)
    return jc, tc


def _jax_params(jc, seed=0):
    """init_deform's draws with the time planes (all ones at init) and the
    spatial planes perturbed by numpy noise, so that t matters."""
    params = jdef.init_deform(jax.random.key(seed), jc)
    rng = np.random.default_rng(seed)
    flat = _flatten(params)
    for k in flat:
        if k.startswith("grid/"):
            flat[k] = (flat[k] + rng.normal(0, 0.3, flat[k].shape)).astype(
                np.float32)
    return flat


def _inputs(seed=1):
    rng = np.random.default_rng(seed)
    xyz = np.concatenate([rng.uniform(-1.5, 1.5, (N - 16, 3)),
                          rng.uniform(-2.5, 2.5, (16, 3))])   # border clamp
    return dict(
        xyz=xyz.astype(np.float32),
        scaling=rng.uniform(-5, -1, (N, 3)).astype(np.float32),
        rotation=rng.normal(size=(N, 4)).astype(np.float32),
        opacity=rng.normal(size=(N, 1)).astype(np.float32),
        shs=rng.normal(size=(N, 16, 3)).astype(np.float32),
    )


AABB = np.array([[1.6, 1.6, 1.6], [-1.6, -1.6, -1.6]], np.float32)
T_POINT = np.random.default_rng(2).uniform(0, 1, N).astype(np.float32)


@pytest.fixture(scope="module")
def base():
    jc, tc = _configs(BASE)
    flat = _jax_params(jc)
    return jc, tc, flat, jax.tree.map(jnp.asarray, _unflatten(flat))


def _unflatten(flat):
    out = {}
    for k, v in flat.items():
        d = out
        *path, leaf = k.split("/")
        for p in path:
            d = d.setdefault(p, {})
        d[leaf] = v
    return out


@pytest.mark.parametrize("t", [0.37, T_POINT], ids=["scalar_t", "point_t"])
def test_hexplane_features(base, t):
    jc, tc, flat, jparams = base
    x = _inputs()["xyz"]
    pts = np.array(jhex.normalize_aabb(jnp.asarray(x), jnp.asarray(AABB)))
    pts_t = thex.normalize_aabb(torch.as_tensor(x), torch.as_tensor(AABB))
    np.testing.assert_allclose(pts_t.numpy(), pts, rtol=1e-6, atol=1e-6)
    a = jhex.hexplane_features(jparams["grid"], jc.grid, jnp.asarray(pts),
                               jnp.asarray(t))
    module = convert.deformation_from_flat(flat, tc, device="cpu")
    b = module.grid(torch.as_tensor(pts), torch.as_tensor(t))
    assert b.shape == (N, 64)
    np.testing.assert_allclose(b.detach().numpy(), np.asarray(a), **TOL)


def test_const_t_sampler_matches_generic():
    rng = np.random.default_rng(3)
    plane = torch.as_tensor(rng.normal(size=(25, 64, 8)).astype(np.float32))
    u = torch.as_tensor(rng.uniform(-1.2, 1.2, 300).astype(np.float32))
    for v in (-1.0, 0.0, 0.37, 1.0):
        vt = torch.tensor(v)
        np.testing.assert_allclose(
            thex.bilinear_sample_const_v(plane, u, vt).numpy(),
            thex.bilinear_sample(plane, u, vt.expand(300)).numpy(),
            rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("where", ["u", "v"])
def test_nan_coordinate_samples_nan_in_range(where):
    """A NaN coordinate (a NaN-poisoned model) samples what JAX's clamped
    gather samples on the same inputs, the same rows NaN, instead of
    gathering out of range, so that the stage's NaN guard can roll back."""
    rng = np.random.default_rng(4)
    plane = rng.normal(size=(25, 64, 8)).astype(np.float32)
    u = np.array([0.3, -0.8, np.nan if where == "u" else 0.1, 1.0],
                 np.float32)
    v = np.float32(np.nan if where == "v" else 0.2)
    vs = np.full(u.shape, v, np.float32)
    pairs = [
        (jhex.bilinear_sample_const_v(jnp.asarray(plane), jnp.asarray(u),
                                      jnp.asarray(v)),
         thex.bilinear_sample_const_v(torch.from_numpy(plane),
                                      torch.from_numpy(u), torch.tensor(v))),
        (jhex.bilinear_sample(jnp.asarray(plane), jnp.asarray(u),
                              jnp.asarray(vs)),
         thex.bilinear_sample(torch.from_numpy(plane), torch.from_numpy(u),
                              torch.from_numpy(vs)))]
    for want, got in pairs:
        want, got = np.asarray(want), got.numpy()
        assert np.isnan(want[2]).all()
        np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
        np.testing.assert_allclose(got, want, equal_nan=True, **TOL)


def _run_both(kw, t, seed=0):
    jc, tc = _configs(kw)
    flat = _jax_params(jc, seed)
    jparams = jax.tree.map(jnp.asarray, _unflatten(flat))
    inp = _inputs()
    a = jdef.deform_apply(jparams, jc, jnp.asarray(AABB),
                          *(jnp.asarray(inp[k]) for k in
                            ("xyz", "scaling", "rotation", "opacity", "shs")),
                          jnp.asarray(t))
    module = convert.deformation_from_flat(flat, tc, device="cpu")
    with torch.no_grad():
        b = module(torch.as_tensor(AABB),
                   *(torch.as_tensor(inp[k]) for k in
                     ("xyz", "scaling", "rotation", "opacity", "shs")),
                   torch.as_tensor(t))
    return a, b, inp


@pytest.mark.parametrize("t", [0.37, T_POINT], ids=["scalar_t", "point_t"])
@pytest.mark.parametrize("kw", [BASE, VARIANT], ids=["dnerf", "variant"])
def test_deform_apply(kw, t):
    a, b, inp = _run_both(kw, t)
    names = ("xyz", "scaling", "rotation", "opacity", "shs")
    for name, x, y, raw in zip(names, a, b, (inp[k] for k in names)):
        np.testing.assert_allclose(y.numpy(), np.asarray(x), **TOL,
                                   err_msg=name)
    # the deltas are live: positions, scales and rotations moved
    for name, y in zip(names[:3], b[:3]):
        assert not np.allclose(y.numpy(), inp[name]), name
    if kw is VARIANT:   # opacity and SH heads enabled there
        assert not np.allclose(b[3].numpy(), inp["opacity"])
        assert not np.allclose(b[4].numpy(), inp["shs"])


def test_flat_round_trip():
    jc, tc = _configs(VARIANT)
    flat = _jax_params(jc)
    module = convert.deformation_from_flat(flat, tc, device="cpu")
    back = convert.deformation_to_flat(module)
    assert sorted(back) == sorted(flat)
    for k in flat:
        np.testing.assert_array_equal(back[k], flat[k], err_msg=k)
    # a missing key is refused, not silently initialised
    with pytest.raises(RuntimeError):
        convert.deformation_from_flat(
            {k: v for k, v in flat.items() if k != "mlp/pos/h0/w"}, tc,
            device="cpu")


def test_empty_voxel_refused():
    _, tc = _configs(BASE)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tdef.Deformation(dataclasses.replace(tc, empty_voxel=True))
