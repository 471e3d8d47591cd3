"""Port parity for the training slice: losses, schedules, the grouped Adam,
the grid regularizer, initialisation, and one fine and one coarse
`train_step` against the JAX package's, from one state.

The JAX package builds the state with `create_state` (tests/test_train.py's
tiny config, 96 points, 64x64 images, numpy noise on the opacities, SH
rest bands, rotations and time planes); `convert.train_state_from_numpy`
carries it over, so both packages start from the same numbers. Each
comparison states its tolerance:
  * loss, l1 and psnr: 1e-5 relative;
  * every gradient leaf, read as mu / (1 - b1) after step 1, and nu:
    normalised by the leaf's largest magnitude, atol 1e-4 (the JAX tests'
    gradient tolerance, tests/test_pallas_blend.py);
  * the densify statistics: xyz_gradient_accum normalised 1e-4, denom and
    max_radii2d exact;
  * the updated parameters: rtol 1e-5, where |g| > 1e-3 max|g| of the leaf.
    With eps 1e-15, Adam's first update is about -lr * sign(g) for ANY
    nonzero g, so a gradient that is round-off noise (a gaussian whose
    effect on the image cancels) can flip sign between the two packages
    and move its parameter by 2 lr; those entries are masked, the
    tolerance is not loosened.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from fourdgs_tpu.data import camera as jcam
from fourdgs_tpu.models import gaussians as jgauss
from fourdgs_tpu.models import regularization as jreg
from fourdgs_tpu.ops import knn as jknn
from fourdgs_tpu.ops import losses as jlosses
from fourdgs_tpu.ops import schedule as jsched
from fourdgs_tpu.train import checkpoint as jckpt
from fourdgs_tpu.train import loop as jloop
from fourdgs_tpu.train import optim as joptim
from fourdgs_tpu.train import state as jstate
from fourdgs_tpu_torch import convert
from fourdgs_tpu_torch.data import camera as tcam
from fourdgs_tpu_torch.models import gaussians as tgauss
from fourdgs_tpu_torch.models import regularization as treg
from fourdgs_tpu_torch.ops import knn as tknn
from fourdgs_tpu_torch.ops import losses as tlosses
from fourdgs_tpu_torch.ops import schedule as tsched
from fourdgs_tpu_torch.train import config as tconfig
from fourdgs_tpu_torch.train import loop as tloop
from fourdgs_tpu_torch.train import optim as toptim
from fourdgs_tpu_torch.train import state as tstate
from tests.test_train import tiny_config

torch.set_num_threads(1)

IMG = 64
N_POINTS = 96
B1 = 0.9
GRAD_TOL = 1e-4
REL_TOL = 1e-5
NOISE = 1e-3


def _t(x, dtype=None):
    t = torch.from_numpy(np.array(x))
    return t if dtype is None else t.to(dtype)


def _normalised_close(port, ref, name, tol=GRAD_TOL):
    port, ref = np.asarray(port), np.asarray(ref)
    assert port.shape == ref.shape, name
    assert np.isfinite(port).all(), name
    scale = np.abs(ref).max() + 1e-12
    np.testing.assert_allclose(port / scale, ref / scale, atol=tol,
                               err_msg=name)


# ---------------------------------------------------------------------------
# losses, schedules, regularizer, optimizer, initialisation
# ---------------------------------------------------------------------------

def _images(shape, seed, near_white):
    rng = np.random.default_rng(seed)
    if near_white:   # SSIM's cancellation case: E[x^2] - mu^2 ~ 1e-3
        a = 1.0 - rng.uniform(0.0, 0.06, shape)
        b = np.clip(a + rng.normal(0.0, 0.01, shape), 0.0, 1.0)
    else:
        a = rng.uniform(0.0, 1.0, shape)
        b = np.clip(a + rng.normal(0.0, 0.1, shape), 0.0, 1.0)
    return a.astype(np.float32), b.astype(np.float32)


# Float32 SSIM on near-white images sits on a rounding floor: its variance
# terms E[x^2] - mu^2 ~ 3e-4 cancel two 121-term window sums of ~0.94, so
# each package's result is 1e-6 off the float64 value (measured at
# (2, 40, 48, 3): the port 1.3e-6 per image, XLA 1.6e-6). There the port
# is held to 2e-6 of the float64 value and to JAX within 1e-6 beyond both
# packages' distances to it; on ordinary images plainly to 1e-6.
SSIM_FLOOR = 2e-6


def _ssim_close(port_fn, jax_fn, a, b, name, floor):
    port = port_fn(_t(a), _t(b)).numpy()
    ref = np.asarray(jax_fn(a, b))
    if not floor:
        np.testing.assert_allclose(port, ref, atol=1e-6, err_msg=name)
        return
    exact = port_fn(_t(a).double(), _t(b).double()).numpy()
    np.testing.assert_allclose(port, exact, atol=SSIM_FLOOR, err_msg=name)
    slack = np.abs(port - exact).max() + np.abs(ref - exact).max()
    np.testing.assert_allclose(port, ref, atol=1e-6 + slack, err_msg=name)


@pytest.mark.parametrize("near_white", [False, True])
def test_losses_match_jax(near_white):
    """l1, l2 and psnr (atol 1e-6, psnr in dB 1e-5), and ssim with both
    reductions (SSIM_FLOOR)."""
    a, b = _images((2, 40, 48, 3), 1, near_white)
    mask = (np.random.default_rng(2).uniform(size=(2, 40, 48, 3)) > 0.3)
    ta, tb = _t(a), _t(b)
    for name, port, ref, tol in (
            ("l1", tlosses.l1_loss(ta, tb), jlosses.l1_loss(a, b), 1e-6),
            ("l2", tlosses.l2_loss(ta, tb), jlosses.l2_loss(a, b), 1e-6),
            ("psnr", tlosses.psnr(ta, tb), jlosses.psnr(a, b), 1e-5),
            ("psnr_mask", tlosses.psnr(ta, tb, _t(mask)),
             jlosses.psnr(a, b, jnp.asarray(mask)), 1e-5)):
        np.testing.assert_allclose(port.numpy(), np.asarray(ref), atol=tol,
                                   err_msg=name)
    _ssim_close(tlosses.ssim, jlosses.ssim, a, b, "ssim", near_white)
    _ssim_close(lambda x, y: tlosses.ssim(x, y, size_average=False),
                lambda x, y: jlosses.ssim(x, y, size_average=False), a, b,
                "ssim per image", near_white)
    _ssim_close(tlosses.ssim, jlosses.ssim, a[0], b[0], "ssim (H, W, C)",
                near_white)
    if near_white:
        assert 0.0 < float(tlosses.ssim(ta, tb)) < 1.0


def test_ms_ssim_matches_jax():
    a, b = _images((1, 192, 176, 3), 3, near_white=False)
    # five levels of products of such means: XLA is 1.9e-6 from the
    # float64 value here (the port 3e-7), so the floor rule applies
    _ssim_close(tlosses.ms_ssim, jlosses.ms_ssim, a, b, "ms_ssim", True)
    _ssim_close(tlosses.d_ssim, jlosses.d_ssim, a[0], b[0], "d_ssim", True)


@pytest.mark.parametrize("size", [8, 32, 175, 176])
def test_ms_ssim_of_a_small_image_is_nan_like_jax(size):
    """Under 176 px (11 x 2^4) a level of MS-SSIM has no valid window
    position: JAX's mean over the empty map is NaN, and so is the port's
    (which raised in conv2d before)."""
    a, b = _images((2, size, size + 3, 3), 4, near_white=False)
    port = tlosses.ms_ssim(_t(a), _t(b)).numpy()
    ref = np.asarray(jlosses.ms_ssim(a, b))
    assert np.isnan(port).all() == np.isnan(ref).all() == (size < 176)
    np.testing.assert_allclose(port, ref, atol=2e-6)


def test_schedules_match_jax():
    cfg = tiny_config()
    steps = [0, 1, 1000, cfg.opt.position_lr_max_steps]
    for kw in (dict(lr_init=1.6e-4, lr_final=1.6e-6, lr_delay_mult=0.01,
                    max_steps=20000),
               dict(lr_init=1e-2, lr_final=1e-3, lr_delay_steps=500,
                    lr_delay_mult=0.1, max_steps=3000)):
        for s in steps + [-1]:
            np.testing.assert_allclose(
                tsched.expon_lr(s, **kw).numpy(),
                np.asarray(jsched.expon_lr(s, **kw)), rtol=1e-6,
                err_msg=f"{kw} step {s}")
    jaxs = joptim.build_schedules(cfg.opt, 2.0)
    ports = toptim.build_schedules(cfg.opt, 2.0)
    assert sorted(jaxs) == sorted(ports)
    for name in jaxs:
        for s in steps:
            np.testing.assert_allclose(
                ports[name](torch.tensor(s, dtype=torch.int32)).numpy(),
                np.asarray(jaxs[name](jnp.int32(s))), rtol=1e-6,
                err_msg=f"{name} step {s}")


def _noisy_jax_state(cfg, seed=0):
    """A JAX state from `create_state`, with numpy noise on the fields
    that start uniform, so that every group has a real gradient (the
    initial gaussians are isotropic, whose rotation gradient is zero up to
    round-off)."""
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-1, 1, (N_POINTS, 3)).astype(np.float32)
    cols = rng.uniform(0, 1, (N_POINTS, 3)).astype(np.float32)
    st = jstate.create_state(jax.random.key(seed), cfg, pts, cols, 1.0)
    g = st.params["gauss"]
    cap = g.xyz.shape[0]
    flat = jckpt._flatten(st.params["deform"])
    for k in flat:
        if k.startswith("grid/"):
            flat[k] = (flat[k] + rng.normal(0, 0.1, flat[k].shape)).astype(
                np.float32)
    deform = jckpt.deform_params_from_flat(st.params["deform"], flat)
    gauss = g._replace(
        features_rest=jnp.asarray(rng.normal(0, 0.2, g.features_rest.shape),
                                  jnp.float32),
        opacity=jnp.asarray(rng.normal(0.5, 1.0, (cap, 1)), jnp.float32),
        rotation=g.rotation + jnp.asarray(rng.normal(0, 0.2, (cap, 4)),
                                          jnp.float32),
        scaling=g.scaling + jnp.asarray(rng.normal(0.7, 0.4, (cap, 3)),
                                        jnp.float32))
    return st._replace(params={"gauss": gauss, "deform": deform})


def _port_state(st, cfg):
    return convert.train_state_from_numpy(
        jckpt._flatten(st._asdict()),
        tconfig.deform_config_from(_port_cfg(cfg)), device="cpu")


def _port_cfg(cfg):
    """The port's Config with the same fields as a JAX Config."""
    port = tconfig.Config()
    for group in ("model", "opt", "hidden"):
        for k, v in vars(getattr(cfg, group)).items():
            setattr(getattr(port, group), k, v)
    port.raster = tconfig.RasterParams(**{
        k: v for k, v in vars(cfg.raster).items()
        if k in vars(port.raster)})
    return port


def _mu_tree(opt_state):
    """The port's moments flattened to the JAX checkpoint's keys."""
    out = {}
    for which in ("mu", "nu"):
        tree = getattr(opt_state, which)
        for f in tgauss.FIELDS:
            out[f"{which}/gauss/{f}"] = getattr(tree["gauss"], f).numpy().copy()
        for name, x in tree["deform"].items():
            arr = x.numpy().copy()
            out[f"{which}/deform/{_jax_key(name)}"] = (
                arr.T if name.endswith(".weight") else arr)
    return out


def _jax_key(name):
    """'grid.planes.l0_p0' -> 'grid/l0_p0'; 'pos.h0.weight' -> 'mlp/pos/h0/w'."""
    if name.startswith("grid.planes."):
        return "grid/" + name[len("grid.planes."):]
    *path, leaf = name.split(".")
    return "mlp/" + "/".join(path) + ("/w" if leaf == "weight" else "/b")


def _port_grads(flat_g, port):
    """JAX-layout gradients (flattened) -> the port's leaf list."""
    out = [_t(flat_g[f"gauss/{f}"]) for f in tgauss.FIELDS]
    for name, _ in port.params["deform"].named_parameters():
        arr = flat_g["deform/" + _jax_key(name)]
        out.append(_t(arr.T if name.endswith(".weight") else arr))
    return out


def test_adam_update_and_moment_reset_match_jax():
    """Two grouped-Adam updates on random gradients (count 1 and 2), one
    leaf without a gradient on the port's side (a zero gradient on the
    JAX side), then a densify-style and an opacity-only moment reset:
    moments and parameters at rtol 1e-6, atol 1e-8 (an ulp of the
    moments' 0.1 scale)."""
    cfg = tiny_config(cap=256)
    st = _noisy_jax_state(cfg)
    port = _port_state(st, cfg)
    tx_j = joptim.build_optimizer(cfg.opt, 1.5, st.params)
    tx_t = toptim.build_optimizer(_port_cfg(cfg).opt, 1.5)
    jax_update = jax.jit(tx_j.update)
    rng = np.random.default_rng(4)
    params_j, opt_j, opt_t = st.params, st.opt_state, port.opt_state
    no_grad = next(iter(port.params["deform"].named_parameters()))[0]
    for _ in range(2):
        flat_g = {k: rng.normal(size=v.shape).astype(np.float32)
                  for k, v in jckpt._flatten(params_j).items()}
        flat_g["deform/" + _jax_key(no_grad)] *= 0.0
        grads = jckpt._unflatten_into(params_j, flat_g)
        updates, opt_j = jax_update(grads, opt_j, params_j)
        params_j = jax.tree.map(lambda p, u: p + u, params_j, updates)
        g_t = _port_grads(flat_g, port)
        g_t[len(tgauss.FIELDS)] = None
        opt_t = tx_t.update(g_t, opt_t, port.params)
    assert int(opt_t.count) == int(opt_j.count) == 2
    flat_j = jckpt._flatten({"mu": opt_j.mu, "nu": opt_j.nu})
    flat_t = _mu_tree(opt_t)
    assert sorted(flat_t) == sorted(flat_j)
    for k, v in flat_t.items():
        np.testing.assert_allclose(v, flat_j[k], rtol=1e-6, atol=1e-8,
                                   err_msg=k)
    pj = jckpt._flatten(params_j)
    for f in tgauss.FIELDS:
        np.testing.assert_allclose(
            getattr(port.params["gauss"], f).detach().numpy(),
            pj[f"gauss/{f}"], rtol=1e-6, atol=1e-7, err_msg=f)
    for name, p in port.params["deform"].named_parameters():
        arr = p.detach().numpy()
        np.testing.assert_allclose(
            arr.T if name.endswith(".weight") else arr,
            pj["deform/" + _jax_key(name)], rtol=1e-6, atol=1e-7,
            err_msg=name)

    mask = np.zeros(st.capacity, bool)
    mask[[3, 17, 40]] = True
    for group in ("opacity", None):
        opt_j2 = joptim.reset_moments_for_slots(opt_j, jnp.asarray(mask),
                                                group=group)
        opt_t = toptim.reset_moments_for_slots(opt_t, _t(mask), group=group)
        flat_j = jckpt._flatten({"mu": opt_j2.mu, "nu": opt_j2.nu})
        flat_t = _mu_tree(opt_t)
        for k in flat_t:
            np.testing.assert_allclose(flat_t[k], flat_j[k], rtol=1e-6,
                                       atol=1e-8, err_msg=f"{group} {k}")
        assert float(np.abs(flat_t["mu/gauss/opacity"][mask]).max()) == 0.0
        opt_j = opt_j2


def test_compute_regulation_matches_jax():
    cfg = tiny_config(cap=256)
    st = _noisy_jax_state(cfg)
    port = _port_state(st, cfg)
    grids_j = st.params["deform"]["grid"]
    grids_t = dict(port.params["deform"].grid.planes)
    assert sorted(grids_j) == sorted(grids_t)
    for w in ((0.01, 1e-4, 1e-4), (0.0, 1.0, 0.0), (1.0, 0.0, 0.5)):
        np.testing.assert_allclose(
            treg.compute_regulation(grids_t, *w).detach().numpy(),
            np.asarray(jreg.compute_regulation(grids_j, *w)), rtol=1e-6,
            err_msg=str(w))


def test_create_from_points_matches_jax():
    """dist2_init (mean 3-NN squared distance by the same |a|^2 + |b|^2 -
    2ab formula) and the initial buffer, rtol 1e-5 (the formula's float
    cancellation at the smallest distances, atol 1e-7)."""
    rng = np.random.default_rng(6)
    pts = rng.uniform(-1, 1, (300, 3)).astype(np.float32)
    cols = rng.uniform(0, 1, (300, 3)).astype(np.float32)
    np.testing.assert_allclose(tknn.dist2_init(pts, "cpu").numpy(),
                               np.asarray(jknn.dist2_init(pts)), rtol=1e-5,
                               atol=1e-7)
    g_t, alive_t = tgauss.create_from_points(pts, cols, 512, 2, "cpu")
    g_j, alive_j = jgauss.create_from_points(pts, cols, 512, 2)
    np.testing.assert_array_equal(alive_t.numpy(), np.asarray(alive_j))
    for f in tgauss.FIELDS:
        np.testing.assert_allclose(getattr(g_t, f).numpy(),
                                   np.asarray(getattr(g_j, f)), rtol=1e-5,
                                   atol=1e-7, err_msg=f)


# ---------------------------------------------------------------------------
# the gate: one fine and one coarse train_step from one state
# ---------------------------------------------------------------------------

def _look_at(make, t, theta=0.3):
    pos = np.array([4.0 * np.sin(theta), 0.2, 4.0 * np.cos(theta)])
    fwd = -pos / np.linalg.norm(pos)
    right = np.cross([0.0, 1.0, 0.0], fwd)
    right /= np.linalg.norm(right)
    r_w2c = np.stack([right, np.cross(fwd, right), fwd])
    return make(r_w2c.T, -r_w2c @ pos, 0.9, 0.9, time=t)


# (stage, lambda_dssim, batch): JAX renders a batch of 2 unrolled and a
# batch of 4 under vmap; the port loops over the cameras. Every camera of
# a batch shares one ndc_offset, and the densify statistics take the
# radii's max and the visibility's any over the batch.
STEP_CASES = [("fine", 0.0, 1), ("fine", 0.2, 1), ("coarse", 0.0, 1),
              ("coarse", 0.2, 1), ("fine", 0.0, 2), ("fine", 0.0, 4)]
# the batch's cameras: (time, angle) around the scene
BATCH_VIEWS = ((0.4, 0.3), (0.7, 0.8), (0.1, -0.4), (0.9, 1.3))


@pytest.fixture(scope="module", params=STEP_CASES,
                ids=[f"{s}-dssim{l}" + (f"-batch{b}" if b > 1 else "")
                     for s, l, b in STEP_CASES])
def two_steps(request):
    """Two steps (one at batch 2 and 4) of each package from one JAX-built
    state, on a batch of cameras and targets: the JAX step is compiled
    once per case."""
    stage, lam, batch = request.param
    cfg = tiny_config(cap=256)
    pcfg = _port_cfg(cfg)
    st = _noisy_jax_state(cfg)
    port = _port_state(st, cfg)
    target = np.random.default_rng(7).uniform(
        0.0, 1.0, (batch, IMG, IMG, 3)).astype(np.float32)
    bg = np.array([1.0, 1.0, 1.0], np.float32)
    reg = (cfg.hidden.time_smoothness_weight, cfg.hidden.l1_time_planes,
           cfg.hidden.plane_tv_weight)
    jrc = jloop.raster_config_from(cfg, IMG, IMG)
    trc = tconfig.raster_config_from(pcfg, IMG, IMG)
    tx_j = joptim.build_optimizer(cfg.opt, 1.0, st.params)
    tx_t = toptim.build_optimizer(pcfg.opt, 1.0)
    views = BATCH_VIEWS[:batch]
    jcam_ = jax.tree.map(lambda *xs: jnp.stack(xs), *[
        _look_at(jcam.make_camera, t, theta) for t, theta in views])
    tcams = [_look_at(lambda *a, **k: tcam.make_camera(*a, device="cpu",
                                                       **k), t, theta)
             for t, theta in views]
    jax_states, jax_aux, port_states, port_aux = [st], [], [], []
    # batch 1 takes a second step, at count 2's learning rates; a batch
    # takes one (the second step's image would carry the first update's
    # noise-gradient entries, which move by lr either way, see above)
    for _ in range(2 if batch == 1 else 1):
        st, aux = jloop.train_step(
            st, jcam_, jnp.asarray(target), jnp.asarray(bg), jnp.int32(1),
            stage=stage, raster_cfg=jrc,
            deform_cfg=jstate.deform_config_from(cfg), tx=tx_j,
            lambda_dssim=lam, reg_weights=reg)
        jax_states.append(jckpt._flatten(st._asdict()))
        jax_aux.append(aux)
        port, aux = tloop.train_step(
            port, tcams, _t(target), _t(bg), 1, stage=stage,
            raster_cfg=trc, tx=tx_t, lambda_dssim=lam, reg_weights=reg)
        port_aux.append(aux)
        port_states.append({
            "params": {f: getattr(port.params["gauss"], f).detach().clone()
                       for f in tgauss.FIELDS},
            "deform": {n: p.detach().clone()
                       for n, p in port.params["deform"].named_parameters()},
            "moments": _mu_tree(port.opt_state),
            "stats": {k: getattr(port, k).clone() for k in
                      ("xyz_gradient_accum", "denom", "max_radii2d", "step")},
            "count": int(port.opt_state.count)})
    return dict(stage=stage, batch=batch, jax_states=jax_states,
                jax_aux=jax_aux, port_states=port_states, port_aux=port_aux)


def test_train_step_loss_matches_jax(two_steps):
    """loss, l1 and psnr of both steps (the second at the lr of count 2),
    1e-5 relative; the step's counters exactly."""
    for ja, ta in zip(two_steps["jax_aux"], two_steps["port_aux"]):
        for f in ("loss", "l1", "psnr"):
            np.testing.assert_allclose(float(getattr(ta, f)),
                                       float(getattr(ja, f)), rtol=REL_TOL,
                                       err_msg=f)
        for f in ("dropped_pairs", "dropped_tile", "num_pairs", "tile_peak",
                  "n_visible"):
            assert int(getattr(ta, f)) == int(getattr(ja, f)), f
        np.testing.assert_allclose(float(ta.max_alpha), float(ja.max_alpha),
                                   atol=1e-5)
        np.testing.assert_allclose(ta.image.numpy(), np.asarray(ja.image),
                                   atol=1e-5)
    assert float(two_steps["port_aux"][0].max_alpha) > 0.5   # a real image


def test_train_step_gradients_match_jax(two_steps):
    """Every gradient leaf, read from the first moment after step 1 as
    mu / (1 - b1), and the second moments: normalised atol 1e-4. The
    deformation's leaves get no gradient in the coarse stage (zero
    moments in both); the rest bands above the active degree neither."""
    jflat, port = two_steps["jax_states"][1], two_steps["port_states"][0]
    assert port["count"] == int(jflat["opt_state/count"]) == 1
    nonzero = 0
    for key, v in port["moments"].items():
        ref = jflat[f"opt_state/{key}"]
        if key.startswith("mu/"):
            _normalised_close(v / (1 - B1), ref / (1 - B1), key)
            nonzero += bool(np.abs(ref).max() > 0)
        else:
            _normalised_close(v, ref, key)
    # the fine stage moves every gaussian field and the deformation; the
    # coarse stage the gaussian fields only (not timenet either way)
    expect = 6 + 14 if two_steps["stage"] == "fine" else 6
    assert nonzero >= expect, nonzero


def test_train_step_densify_stats_match_jax(two_steps):
    for jflat, port in zip(two_steps["jax_states"][1:],
                           two_steps["port_states"]):
        stats = port["stats"]
        _normalised_close(stats["xyz_gradient_accum"].numpy(),
                          jflat["xyz_gradient_accum"], "xyz_gradient_accum")
        np.testing.assert_array_equal(stats["denom"].numpy(), jflat["denom"])
        np.testing.assert_array_equal(stats["max_radii2d"].numpy(),
                                      jflat["max_radii2d"])
        assert int(stats["step"]) == int(jflat["step"])
    assert float(np.abs(jflat["xyz_gradient_accum"]).max()) > 0


def test_train_step_params_match_jax(two_steps):
    """The parameters after step 1 where the gradient is not noise
    (|g| > 1e-3 max|g| of the leaf), rtol 1e-5 (atol 1e-7); entries with
    a noise gradient move by at most lr either way."""
    jflat, port = two_steps["jax_states"][1], two_steps["port_states"][0]
    checked = 0
    for key, arr in list(port["params"].items()) + [
            (f"deform:{n}", p) for n, p in port["deform"].items()]:
        if key.startswith("deform:"):
            name = key[len("deform:"):]
            jkey = "deform/" + _jax_key(name)
            arr = arr.numpy()
            arr = arr.T if name.endswith(".weight") else arr
        else:
            jkey = f"gauss/{key}"
            arr = arr.numpy()
        g = jflat[f"opt_state/mu/{jkey}"]
        real = np.abs(g) > NOISE * np.abs(g).max()
        if not real.any():
            continue
        np.testing.assert_allclose(arr[real], jflat[f"params/{jkey}"][real],
                                   rtol=REL_TOL, atol=1e-7, err_msg=jkey)
        checked += int(real.sum())
    assert checked > 500


def test_entry_points_default_to_cuda():
    """create_state, train_state_from_numpy and dist2_init run on cuda
    unless given device="cpu", and raise without a card."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    cfg = tiny_config(cap=256)
    st = _noisy_jax_state(cfg)
    pcfg = _port_cfg(cfg)
    pts = np.random.default_rng(0).uniform(-1, 1, (32, 3)).astype(np.float32)
    with pytest.raises(RuntimeError, match="CUDA"):
        tstate.create_state(pcfg, pts, pts, 1.0)
    with pytest.raises(RuntimeError, match="CUDA"):
        convert.train_state_from_numpy(jckpt._flatten(st._asdict()),
                                       tconfig.deform_config_from(pcfg))
    with pytest.raises(RuntimeError, match="CUDA"):
        tknn.dist2_init(pts)
    state = tstate.create_state(pcfg, pts, pts, 1.0, device="cpu",
                                generator=torch.Generator().manual_seed(0))
    assert state.alive.device.type == "cpu" and int(state.n_alive()) == 32
    assert all(p.requires_grad for p in toptim.param_leaves(state.params))
