"""Port parity for the math substrate: ops/transforms.py, ops/sh.py,
data/camera.py and ops/projection.py against the JAX package, on the same
numpy inputs."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fourdgs_tpu.data import camera as jcam
from fourdgs_tpu.ops import projection as jproj
from fourdgs_tpu.ops import sh as jsh
from fourdgs_tpu.ops import transforms as jtf
from fourdgs_tpu_torch.data import camera as tcam
from fourdgs_tpu_torch.ops import projection as tproj
from fourdgs_tpu_torch.ops import sh as tsh
from fourdgs_tpu_torch.ops import transforms as ttf

torch.set_num_threads(1)


def _t(x):
    return torch.as_tensor(np.asarray(x))


def _close(a, b, **kw):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), **kw)


@pytest.fixture
def quats():
    return np.random.default_rng(1).normal(size=(256, 4)).astype(np.float32)


@pytest.mark.parametrize("name", ["quat_normalize", "quat_to_rotmat"])
def test_quat_unary(name, quats):
    _close(getattr(ttf, name)(_t(quats)), getattr(jtf, name)(quats),
           atol=1e-6)


def test_quat_multiply(quats):
    q2 = np.random.default_rng(2).normal(size=quats.shape).astype(np.float32)
    _close(ttf.quat_multiply(_t(quats), _t(q2)), jtf.quat_multiply(quats, q2),
           atol=1e-6)


def test_build_covariance_packed(quats):
    rng = np.random.default_rng(3)
    scales = np.exp(rng.uniform(-3, 0, (256, 3))).astype(np.float32)
    for mod in (1.0, 0.7):
        _close(ttf.build_covariance_packed(_t(scales), _t(quats), mod),
               jtf.build_covariance_packed(scales, quats, mod), atol=1e-6)


def test_scalar_activations():
    rng = np.random.default_rng(4)
    logs = rng.uniform(-5, 20, (512, 3)).astype(np.float32)
    _close(ttf.safe_exp_scales(_t(logs)), jtf.safe_exp_scales(logs),
           rtol=1e-6)
    p = rng.uniform(0.01, 0.99, 512).astype(np.float32)
    _close(ttf.inverse_sigmoid(_t(p)), jtf.inverse_sigmoid(p), atol=1e-6)


def test_camera_matrices():
    rng = np.random.default_rng(5)
    R, _ = np.linalg.qr(rng.normal(size=(3, 3)))
    T = rng.normal(size=3)
    for kw in ({}, {"trans": np.array([0.1, -0.2, 0.3]), "scale": 1.5}):
        a = tcam.make_camera(R, T, 0.9, 0.7, time=0.25, device="cpu", **kw)
        b = jcam.make_camera(R, T, 0.9, 0.7, time=0.25, **kw)
        for f in ("world_view", "full_proj", "cam_center", "tanfovx",
                  "tanfovy", "time"):
            _close(getattr(a, f), getattr(b, f), atol=1e-6, err_msg=f)
    _close(ttf.projection_matrix(0.01, 100.0, 0.9, 0.7),
           jtf.projection_matrix(0.01, 100.0, 0.9, 0.7), atol=0)


@pytest.mark.parametrize("deg", [0, 1, 2, 3])
def test_sh(deg):
    rng = np.random.default_rng(10 + deg)
    sh = rng.normal(size=(300, 16, 3)).astype(np.float32) * 0.5
    d = rng.normal(size=(300, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    _close(tsh.eval_sh(deg, _t(sh), _t(d)), jsh.eval_sh(deg, sh, d),
           atol=1e-6)
    rgb = tsh.sh_to_rgb(deg, _t(sh), _t(d))
    _close(rgb, jsh.sh_to_rgb(deg, sh, d), atol=1e-6)
    assert float(rgb.min()) == 0.0   # the clamp is exercised
    _close(tsh.rgb_to_sh(_t(sh[:, 0])), jsh.rgb_to_sh(sh[:, 0]), atol=1e-6)
    _close(tsh.sh_dc_to_rgb(_t(sh[:, 0])), jsh.sh_dc_to_rgb(sh[:, 0]),
           atol=1e-6)


def _sh_outputs(fn, sh, d, w):
    """fn(sh, dirs) and the gradients of sum(fn * w) in sh and dirs."""
    s = torch.tensor(sh, requires_grad=True)
    dd = torch.tensor(d, requires_grad=True)
    out = fn(s, dd)
    (out * _t(w)).sum().backward()
    g_dirs = dd.grad if dd.grad is not None else torch.zeros_like(dd)
    return out.detach().numpy(), s.grad.numpy(), g_dirs.numpy()


@pytest.mark.parametrize("deg", [0, 1, 2, 3])
def test_sh_dynamic(deg):
    """sh_to_rgb_dynamic at a 0-d int32 degree (the captured step's): its
    colors and their gradients in sh and dirs equal the static
    sh_to_rgb's bit for bit (each masked band adds an exact zero), and
    JAX's sh_to_rgb_dynamic's within 1e-6 (the static test's tolerance;
    the gradients normalised by their largest magnitude)."""
    rng = np.random.default_rng(20 + deg)
    sh = rng.normal(size=(300, 16, 3)).astype(np.float32) * 0.5
    d = rng.normal(size=(300, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    w = rng.normal(size=(300, 3)).astype(np.float32)
    degree = torch.tensor(deg, dtype=torch.int32)
    dyn = _sh_outputs(lambda s, dd: tsh.sh_to_rgb_dynamic(degree, s, dd),
                      sh, d, w)
    static = _sh_outputs(lambda s, dd: tsh.sh_to_rgb(deg, s, dd), sh, d, w)
    for a, b, name in zip(dyn, static, ("rgb", "d/dsh", "d/ddirs")):
        np.testing.assert_array_equal(a, b, err_msg=name)
    assert float(dyn[0].min()) == 0.0 or deg == 0   # the clamp is hit
    # the masked bands take no gradient
    assert not dyn[1][:, (deg + 1) ** 2:].any()

    def jax_loss(s, dd):
        return jnp.sum(jsh.sh_to_rgb_dynamic(jnp.int32(deg), s, dd) * w)
    j_rgb = jsh.sh_to_rgb_dynamic(jnp.int32(deg), sh, d)
    j_sh, j_dirs = jax.grad(jax_loss, argnums=(0, 1))(sh, d)
    _close(dyn[0], j_rgb, atol=1e-6)
    for a, b in ((dyn[1], j_sh), (dyn[2], j_dirs)):
        scale = max(float(np.abs(np.asarray(b)).max()), 1e-30)
        _close(a / scale, np.asarray(b) / scale, atol=1e-6)


# ---------------------------------------------------------------------------
# projection
# ---------------------------------------------------------------------------

W_IMG, H_IMG, TS = 96, 64, 16


def _projection_scene(n=600):
    """Points in front of, near and behind the camera plane."""
    rng = np.random.default_rng(20)
    z = np.concatenate([rng.uniform(1.0, 8.0, n - 120),
                        rng.uniform(0.15, 0.3, 40),      # near the plane
                        rng.uniform(-0.05, 0.05, 40),    # at the camera
                        rng.uniform(-5.0, -0.5, 40)])    # behind
    means = np.stack([rng.uniform(-1.2, 1.2, n) * np.abs(z) * 0.6,
                      rng.uniform(-1.0, 1.0, n) * np.abs(z) * 0.6, z],
                     -1).astype(np.float32)
    scales = np.exp(rng.uniform(-4.0, -0.5, (n, 3))).astype(np.float32)
    quats = rng.normal(size=(n, 4)).astype(np.float32)
    opac = rng.uniform(0.0, 1.0, n).astype(np.float32)
    alive = rng.uniform(size=n) > 0.05
    return means, scales, quats, opac, alive


def _near_integer(x):
    """Within 1e-4 + 2e-6 |x| of an integer: 1e-4 absolute for quantities
    of pixel scale, and about 30 float32 ulps for large ones."""
    return np.abs(x - np.round(x)) <= 1e-4 + 2e-6 * np.abs(x)


def _boundary_mask(means, scales, quats, opac, cam):
    """Gaussians whose integer outputs hang on a float near a rounding
    boundary (`_near_integer`), recomputed in float64 from
    the inputs: 3*sqrt(lam1) (radius), q*lam1 (cull_r2), the four rect
    quotients, and the tz > 0.2 / opacity > 1/255 gates. float32 rounding
    on either side may legitimately flip these."""
    W = np.asarray(cam.world_view, np.float64)
    P = np.asarray(cam.full_proj, np.float64)
    tanx, tany = float(cam.tanfovx), float(cam.tanfovy)
    m = means.astype(np.float64)
    t = m @ W[:3, :3].T + W[:3, 3]
    tz = t[:, 2]
    tzs = np.where(tz > 0.2, tz, 1.0)
    ph = m @ P[:3, :3].T + P[:3, 3]
    pw = m @ P[3, :3] + P[3, 3]
    rw = 1.0 / np.where(tz > 0.2, pw + 1e-7, 1.0)
    pix = np.stack([((ph[:, 0] * rw + 1) * W_IMG - 1) * 0.5,
                    ((ph[:, 1] * rw + 1) * H_IMG - 1) * 0.5], -1)
    R = np.asarray(jtf.quat_to_rotmat(quats), np.float64)
    cov3 = np.einsum("nij,nj,nkj->nik", R, scales.astype(np.float64) ** 2, R)
    fx, fy = W_IMG / (2 * tanx), H_IMG / (2 * tany)
    txz = np.clip(t[:, 0] / tzs, -1.3 * tanx, 1.3 * tanx) * tzs
    tyz = np.clip(t[:, 1] / tzs, -1.3 * tany, 1.3 * tany) * tzs
    J = np.zeros((len(m), 2, 3))
    J[:, 0, 0] = fx / tzs
    J[:, 0, 2] = -fx * txz / tzs ** 2
    J[:, 1, 1] = fy / tzs
    J[:, 1, 2] = -fy * tyz / tzs ** 2
    M = J @ W[:3, :3]
    cov2 = M @ cov3 @ np.swapaxes(M, 1, 2)
    c00, c01, c11 = cov2[:, 0, 0] + 0.3, cov2[:, 0, 1], cov2[:, 1, 1] + 0.3
    det = c00 * c11 - c01 * c01
    mid = 0.5 * (c00 + c11)
    lam1 = mid + np.sqrt(np.maximum(0.1, mid * mid - det))
    r_pre = 3.0 * np.sqrt(lam1)
    amin = 1.0 / 255.0
    q = 2.0 * np.log(np.maximum(opac, amin) / amin) + 1e-6
    rx = np.minimum(np.sqrt(q * np.maximum(c00, 0)), np.ceil(r_pre))
    ry = np.minimum(np.sqrt(q * np.maximum(c11, 0)), np.ceil(r_pre))
    rect = [(pix[:, 0] - rx) / TS, (pix[:, 1] - ry) / TS,
            (pix[:, 0] + rx + TS - 1) / TS, (pix[:, 1] + ry + TS - 1) / TS]
    qlam = q * lam1   # ceil() of a tiny positive value is 1 on both sides
    mask = (_near_integer(r_pre) | (_near_integer(qlam) & (qlam > 0.5))
            | (np.abs(tz - 0.2) < 1e-4) | (np.abs(opac - amin) < 1e-6))
    for r in rect:
        mask |= _near_integer(r)
    return mask


def test_projection_parity():
    means, scales, quats, opac, alive = _projection_scene()
    jc = jcam.make_camera(np.eye(3), np.zeros(3), 1.0, 0.75)
    tc = tcam.make_camera(np.eye(3), np.zeros(3), 1.0, 0.75, device="cpu")
    a = tproj.project_gaussians(_t(means), _t(scales), _t(quats), tc, W_IMG,
                                H_IMG, TS, alive=_t(alive),
                                opacities=_t(opac))
    b = jproj.project_gaussians(jnp.asarray(means), jnp.asarray(scales),
                                jnp.asarray(quats), jc, W_IMG, H_IMG, TS,
                                alive=jnp.asarray(alive),
                                opacities=jnp.asarray(opac))
    # the scene has every case: culled behind/at the camera, near-plane,
    # dead, transparent and visible gaussians
    bt = np.asarray(b.tiles_touched)
    assert (bt > 0).sum() > 300 and (bt == 0).sum() > 100
    skip = _boundary_mask(means, scales, quats, opac, jc)
    # near-plane splats have huge rects (float32 ulps of several units)
    assert skip.mean() < 0.05, skip.mean()
    keep = ~skip
    for f in ("radius", "rect_min", "rect_max", "tiles_touched", "cull_r2"):
        av = getattr(a, f).numpy()
        assert av.dtype == np.int32, f
        np.testing.assert_array_equal(av[keep], np.asarray(getattr(b, f))[keep],
                                      err_msg=f)
    vis = keep & (bt > 0)
    for f in ("pix", "depth", "conic"):
        _close(getattr(a, f).numpy()[vis], np.asarray(getattr(b, f))[vis],
               rtol=1e-5, atol=1e-6, err_msg=f)
    # culled gaussians stay finite (the tz_safe / inv_det guards)
    for f in ("pix", "conic"):
        assert np.isfinite(getattr(a, f).numpy()).all(), f
