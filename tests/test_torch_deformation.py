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
from fourdgs_tpu.models import dense_grid as jdg
from fourdgs_tpu.models import hexplane as jhex
from fourdgs_tpu.train.checkpoint import _flatten
from fourdgs_tpu_torch import convert
from fourdgs_tpu_torch.models import deformation as tdef
from fourdgs_tpu_torch.models import dense_grid as tdg
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


@pytest.mark.parametrize("hex_bwd", ["default", "pallas"])
@pytest.mark.parametrize("t", [0.37, T_POINT], ids=["scalar_t", "point_t"])
def test_hexplane_gradients_match_jax(base, t, hex_bwd, monkeypatch):
    """The planes' gradients of a weighted sum of the features, through
    the int32-indexed gathers (the forward's `index_select` on the CPU,
    D1 on the card) and either backward (`index_add_`, or K4's plain
    version under FOURDGS_HEX_BWD=pallas), against jax.grad of the same
    sum. Sums over up to N points per plane cell in another order than
    XLA's: rtol and atol 1e-5, as the features."""
    if hex_bwd == "pallas":
        monkeypatch.setenv("FOURDGS_HEX_BWD", "pallas")
    jc, tc, flat, jparams = base
    x = _inputs()["xyz"]
    pts = np.array(jhex.normalize_aabb(jnp.asarray(x), jnp.asarray(AABB)))
    w = np.random.default_rng(6).normal(size=(N, 64)).astype(np.float32)

    def loss(grid):
        f = jhex.hexplane_features(grid, jc.grid, jnp.asarray(pts),
                                   jnp.asarray(t))
        return jnp.sum(f * jnp.asarray(w))

    want = jax.grad(loss)(jparams["grid"])
    module = convert.deformation_from_flat(flat, tc, device="cpu")
    feats = module.grid(torch.as_tensor(pts), torch.as_tensor(t))
    (feats * torch.as_tensor(w)).sum().backward()
    for key, p in module.grid.planes.items():
        np.testing.assert_allclose(p.grad.numpy(), np.asarray(want[key]),
                                   **TOL, err_msg=key)
    x0, _ = thex._axis_coord(torch.as_tensor(pts[:, 0]), 64)
    assert x0.dtype == torch.int32


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


@pytest.mark.parametrize("channels", [1, 3])
def test_dense_grid_sample_matches_jax(channels):
    """models/dense_grid.py against JAX's at points inside and outside
    [-1, 1] (the border clamp), within 1e-6."""
    rng = np.random.default_rng(channels)
    grid = rng.normal(size=(9, 7, 5, channels)).astype(np.float32)
    pts = np.concatenate([rng.uniform(-1, 1, (200, 3)),
                          rng.uniform(-2, 2, (56, 3)),
                          [[-1, -1, -1], [1, 1, 1], [1, -1, 0.5]]]
                         ).astype(np.float32)
    want = jdg.dense_grid_sample(jnp.asarray(grid), jnp.asarray(pts))
    got = tdg.dense_grid_sample(torch.from_numpy(grid), torch.from_numpy(pts))
    assert got.shape == (len(pts), channels)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)
    assert tdg.init_dense_grid().shape == (64, 64, 64, 1)
    assert not tdg.init_dense_grid().any()


EMPTY_VOXEL = dict(BASE, empty_voxel=True)


def _empty_voxel_params(jc, seed=0):
    """init_deform's draws with a random mask grid in place of its zeros
    (at zeros the mask would remove every raw value)."""
    flat = _jax_params(jc, seed)
    assert flat["empty_voxel"].shape == (64, 64, 64, 1)
    flat["empty_voxel"] = np.random.default_rng(seed + 3).uniform(
        0.2, 1.5, (64, 64, 64, 1)).astype(np.float32)
    return flat


@pytest.mark.parametrize("t", [0.37, T_POINT], ids=["scalar_t", "point_t"])
def test_empty_voxel_matches_jax(t):
    """Deformation with empty_voxel and a random converted grid against
    `deform_apply`: outputs within 1e-5, and the gradients of a weighted
    sum of the outputs (every parameter's, the grid's among them, and
    the inputs'), each normalised by its largest magnitude, within 1e-4."""
    jc, tc = _configs(EMPTY_VOXEL)
    flat = _empty_voxel_params(jc)
    jparams = jax.tree.map(jnp.asarray, _unflatten(flat))
    inp = _inputs()
    names = ("xyz", "scaling", "rotation", "opacity", "shs")
    rng = np.random.default_rng(8)
    weights = [rng.normal(size=inp[k].shape).astype(np.float32)
               for k in names]

    def jloss(params, xyz, scaling):
        out = jdef.deform_apply(params, jc, jnp.asarray(AABB), xyz, scaling,
                                jnp.asarray(inp["rotation"]),
                                jnp.asarray(inp["opacity"]),
                                jnp.asarray(inp["shs"]), jnp.asarray(t))
        return sum(jnp.sum(o * w) for o, w in zip(out, weights)), out

    (_, want), jgrads = jax.value_and_grad(jloss, argnums=(0, 1, 2),
                                           has_aux=True)(
        jparams, jnp.asarray(inp["xyz"]), jnp.asarray(inp["scaling"]))
    module = convert.deformation_from_flat(flat, tc, device="cpu")
    xyz = torch.from_numpy(inp["xyz"]).requires_grad_(True)
    scaling = torch.from_numpy(inp["scaling"]).requires_grad_(True)
    got = module(torch.as_tensor(AABB), xyz, scaling,
                 torch.from_numpy(inp["rotation"]),
                 torch.from_numpy(inp["opacity"]),
                 torch.from_numpy(inp["shs"]), torch.as_tensor(t))
    for name, a, b in zip(names, got, want):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), **TOL,
                                   err_msg=name)
    # the mask is live: the positions differ from the ones-mask field's
    ones = convert.deformation_from_flat(
        {k: v for k, v in flat.items() if k != "empty_voxel"},
        dataclasses.replace(tc, empty_voxel=False), device="cpu")
    with torch.no_grad():
        plain = ones(torch.as_tensor(AABB), xyz, scaling,
                     *(torch.from_numpy(inp[k]) for k in names[2:]),
                     torch.as_tensor(t))
    assert not torch.allclose(plain[0], got[0])
    sum((o * torch.from_numpy(w)).sum()
        for o, w in zip(got, weights)).backward()
    # unused heads (the timenet, opacity and SH) take no gradient here
    # and zeros in JAX
    grads = {}
    for name, p in module.named_parameters():
        key, transpose = convert._flat_key(name)
        g = p.grad if p.grad is not None else torch.zeros_like(p)
        grads[key] = g.T if transpose else g
    assert sorted(grads) == sorted(flat)
    jflat = _flatten(jgrads[0])
    for k, g in grads.items():
        w = np.asarray(jflat[k])
        scale = np.abs(w).max() + 1e-12
        np.testing.assert_allclose(g.numpy() / scale, w / scale, atol=1e-4,
                                   err_msg=k)
    assert np.abs(np.asarray(jflat["empty_voxel"])).max() > 0
    for a, b in ((xyz.grad, jgrads[1]), (scaling.grad, jgrads[2])):
        b = np.asarray(b)
        scale = np.abs(b).max()
        np.testing.assert_allclose(a.numpy() / scale, b / scale, atol=1e-4)


def test_empty_voxel_snapshot_and_checkpoint_round_trip(tmp_path):
    """The `empty_voxel` leaf under its JAX key: a snapshot's
    deformation.npz read back by both packages, and a checkpoint with its
    Adam moments in the `deformation` group, read back equal."""
    from fourdgs_tpu.models.deformation import init_deform
    from fourdgs_tpu.train import checkpoint as jckpt
    from fourdgs_tpu.train import optim as joptim
    from fourdgs_tpu_torch.models.gaussians import GaussianParams
    from fourdgs_tpu_torch.train import checkpoint as tckpt
    from fourdgs_tpu_torch.train import config as tconfig
    from fourdgs_tpu_torch.train import optim as toptim
    from fourdgs_tpu_torch.train import state as tstate
    jc, tc = _configs(EMPTY_VOXEL)
    flat = _empty_voxel_params(jc)
    module = convert.deformation_from_flat(flat, tc, device="cpu")
    rng = np.random.default_rng(1)
    n = 16
    gauss = GaussianParams(
        xyz=torch.from_numpy(rng.normal(size=(n, 3)).astype(np.float32)),
        features_dc=torch.zeros((n, 1, 3)),
        features_rest=torch.zeros((n, 15, 3)),
        scaling=torch.full((n, 3), -3.0), rotation=torch.ones((n, 4)),
        opacity=torch.zeros((n, 1)))
    snap = tckpt.save_snapshot(str(tmp_path), 7, gauss,
                               torch.ones(n, dtype=torch.bool), module, AABB)
    _, back, _ = tckpt.load_snapshot(snap)
    np.testing.assert_array_equal(back["empty_voxel"], flat["empty_voxel"])
    again = tckpt.deform_params_from_flat(back, tc, device="cpu")
    assert torch.equal(again.empty_voxel, module.empty_voxel)
    jparams = jckpt.deform_params_from_flat(
        init_deform(jax.random.key(0), jc), back)
    np.testing.assert_array_equal(np.asarray(jparams["empty_voxel"]),
                                  flat["empty_voxel"])
    # the optimizer group, as the JAX package labels it
    labels = toptim.param_labels({"gauss": gauss, "deform": module})
    assert labels["deform"]["empty_voxel"] == "deformation"
    assert joptim.param_labels({"deform": jparams})["deform"][
        "empty_voxel"] == "deformation"
    # a checkpoint of a training state with the leaf and its moments
    cfg = tconfig.Config()
    cfg.hidden.empty_voxel = True
    cfg.raster.capacity = n
    st = tstate.create_state(cfg, None, None, 1.0, aabb=AABB, deform=module,
                             gauss=gauss, alive=torch.ones(n, dtype=bool),
                             device="cpu")
    st.opt_state.mu["deform"]["empty_voxel"].fill_(0.25)
    path = str(tmp_path / "chkpnt_fine_7.npz")
    tckpt.save_checkpoint(st, path, 7, "fine")
    with np.load(path) as z:
        assert "params/deform/empty_voxel" in z.files
        assert "opt_state/mu/deform/empty_voxel" in z.files
    loaded, it, stage, _ = tckpt.load_checkpoint(path, tc, device="cpu")
    assert (it, stage) == (7, "fine")
    assert torch.equal(loaded.params["deform"].empty_voxel,
                       module.empty_voxel)
    assert bool((loaded.opt_state.mu["deform"]["empty_voxel"] == 0.25).all())

