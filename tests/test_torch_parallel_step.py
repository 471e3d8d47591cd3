"""Port parity for the tile-sharded train step
(fourdgs_tpu_torch/parallel/sharded.py) against the JAX package's
`sharded_train_step`, at meshes (1, 2) and (2, 1) of gloo ranks on the
CPU (tests/test_torch_parallel_mesh.py takes (2, 2) and the fallback
grid).

Each case spawns the mesh's ranks (tests/_torch_parallel_worker.py), which
run the port's plain kernels, while this process runs JAX's shard_map on
its 8 virtual CPU devices; both start from one JAX-built state
(tests/test_parallel.py's setup: the e2e ground-truth scene, points near
the true means, capacity 512) and take, each from that state, a coarse
step (lambda_dssim 0) and a fine step with the grid regularizer
(0.01, 1e-4, 1e-4) and lambda_dssim 0.2, on a global batch of 4 views.
Tolerances are JAX's own (tests/test_parallel.py): loss relative 1e-4,
PSNR relative 1e-3, every gaussian field atol 5e-5, denom exact,
xyz_gradient_accum atol 1e-5. The deformation's gradients (its Adam first
moments over 1 - b1) are held normalised to 1e-4, as in
tests/test_torch_train.py: its parameters move by about lr * sign(g)
whatever g's size, so a parameter is no measure of a near-zero gradient.
One term differs by rule: the grid regularizer's mean |1 - p| over the
time planes, whose cells all start at 1. torch's |x| has gradient 0 at 0
(the reference's), JAX's has 1, so each JAX time-plane cell still at 1
carries l1_time_planes / cells more; that term is added to the port's
gradient before the comparison. The fine step is also held to the port's
own single-card `train_step` from the same state (same tolerances, no
such term): the sharded gradients are the single-card ones.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fourdgs_tpu.data import camera as jcam
from fourdgs_tpu.parallel.mesh import make_mesh as jmake_mesh
from fourdgs_tpu.parallel.sharded import sharded_train_step as jstep
from fourdgs_tpu.train import checkpoint as jckpt
from fourdgs_tpu.train import loop as jloop
from fourdgs_tpu.train import optim as joptim
from fourdgs_tpu.train import state as jstate
from fourdgs_tpu_torch.data import camera as tcam
from fourdgs_tpu_torch.models.gaussians import FIELDS
from fourdgs_tpu_torch.models.regularization import TIME_PLANES
from fourdgs_tpu_torch.ops import rasterize_tiled as trt
from fourdgs_tpu_torch.train import config as tconfig
from fourdgs_tpu_torch.train import loop as tloop
from fourdgs_tpu_torch.train import optim as toptim
from tests.test_e2e_train import smoke_config, true_scene
from tests.test_torch_train import _jax_key, _port_cfg
# tests/ is on sys.path under pytest (no __init__.py: "prepend" import)
import _torch_parallel_worker as worker  # noqa: E402

torch.set_num_threads(1)

B1 = 0.9
GRAD_TOL = 1e-4

REG = (0.01, 1e-4, 1e-4)
STEPS = (dict(stage="coarse", lambda_dssim=0.0, reg_weights=REG,
              active_sh=0),
         dict(stage="fine", lambda_dssim=0.2, reg_weights=REG, active_sh=1))
BATCH = 4
CAPACITY = 512
N_VIEWS = 10


def ring(n: int, make, radius: float = 5.0, fov=(0.8, 0.8)):
    """tests/test_e2e_train.py's ring of look-at cameras, through `make`
    (either package's make_camera)."""
    cams = []
    for i in range(n):
        theta = 2 * np.pi * i / n
        pos = np.array([radius * np.sin(theta), 0.3, radius * np.cos(theta)])
        fwd = -pos / np.linalg.norm(pos)
        right = np.cross([0.0, 1.0, 0.0], fwd)
        right /= np.linalg.norm(right)
        r_w2c = np.stack([right, np.cross(fwd, right), fwd])
        cams.append(make(r_w2c.T, -r_w2c @ pos, *fov, time=i / n))
    return cams


@functools.lru_cache(maxsize=4)
def scene(width: int, height: int) -> dict:
    """The ground-truth views of tests/test_e2e_train.py's true scene at
    width x height (tile 16; fov y kept square-pixel), both packages'
    cameras, the JAX state and configs, and the port's."""
    fov = (0.8, 2 * np.arctan(np.tan(0.4) * height / width))
    jcams = ring(N_VIEWS, jcam.make_camera, fov=fov)
    tcams = ring(N_VIEWS, lambda *a, **k: tcam.make_camera(
        *a, device="cpu", **k), fov=fov)
    rng = np.random.default_rng(5)
    means, scales, quats, opac, colors = true_scene(rng)
    # the targets, rendered by the port (a JAX render is slower op by op)
    rcfg = trt.RasterConfig(img_width=width, img_height=height,
                            tile_size=16, tile_cap=256, chunk=8)
    with torch.no_grad():
        images = np.stack([trt.rasterize(
            *(torch.from_numpy(np.array(x)) for x in
              (means, scales, quats, opac, colors)), c, torch.zeros(3),
            rcfg).color.numpy() for c in tcams])
    cfg = smoke_config()
    pts = np.asarray(means) + np.random.default_rng(0).normal(
        0, 0.05, means.shape).astype(np.float32)
    st = jstate.create_state(jax.random.key(0), cfg, pts,
                             np.full_like(np.asarray(colors), 0.5),
                             spatial_lr_scale=1.0)
    st = jloop.compact_and_resize(st, CAPACITY)
    tx = joptim.build_optimizer(cfg.opt, 1.0, st.params)
    st = st._replace(opt_state=tx.init(st.params))
    pcfg = _port_cfg(cfg)
    return dict(jcams=jcams, tcams=tcams, images=images, cfg=cfg, st=st,
                tx=tx, pcfg=pcfg, width=width, height=height,
                jraster=jloop.raster_config_from(cfg, width, height),
                traster=tconfig.raster_config_from(pcfg, width, height))


def batch_ids() -> np.ndarray:
    return np.arange(BATCH) % N_VIEWS


def step_job(sc: dict, mesh: tuple) -> dict:
    ids = batch_ids()
    return dict(runs=["steps"], mesh=mesh,
                flat=jckpt._flatten(sc["st"]._asdict()), cfg=sc["pcfg"],
                raster=sc["traster"], cams=[sc["tcams"][i] for i in ids],
                gts=torch.from_numpy(sc["images"][ids]),
                bg=torch.zeros(3), steps=list(STEPS))


def jax_steps(sc: dict, mesh: tuple) -> list:
    ids = batch_ids()
    bc = jax.tree.map(lambda *xs: jnp.stack(xs),
                      *[sc["jcams"][i] for i in ids])
    gts = jnp.asarray(sc["images"][ids])
    out = []
    for step in STEPS:
        st, loss, aux = jstep(
            sc["st"], bc, gts, jnp.zeros(3), mesh=jmake_mesh(*mesh),
            stage=step["stage"], active_sh=step["active_sh"],
            raster_cfg=sc["jraster"],
            deform_cfg=jstate.deform_config_from(sc["cfg"]), tx=sc["tx"],
            reg_weights=step["reg_weights"],
            lambda_dssim=step["lambda_dssim"])
        out.append(dict(loss=float(loss), l1=float(aux.l1),
                        psnr=float(aux.psnr),
                        n_visible=int(aux.visible.sum()),
                        state=jckpt._flatten(st._asdict())))
    return out


def run_case(sc: dict, mesh: tuple, tmp_path) -> tuple[list, list]:
    """The ranks' results (by rank) and JAX's, for every step."""
    n = mesh[0] * mesh[1]
    ctx = worker.spawn(step_job(sc, mesh), n, tmp_path)
    ref = jax_steps(sc, mesh)
    ranks = worker.collect(ctx, tmp_path, n)
    return [r["steps"] for r in ranks], ref


def deform_grads(snap: dict) -> dict:
    """The port's deformation gradients of one step from zero moments, by
    the JAX checkpoint's key ('grid/l0_p0', 'mlp/pos/h0/w', ...)."""
    out = {}
    for k, v in snap.items():
        if k.startswith("mu/deform/"):
            name = k[len("mu/deform/"):]
            out[_jax_key(name)] = (v.T if name.endswith(".weight")
                                   else v) / (1.0 - B1)
    return out


def jax_deform_grads(flat: dict) -> dict:
    pre = "opt_state/mu/deform/"
    return {k[len(pre):]: v / (1.0 - B1) for k, v in flat.items()
            if k.startswith(pre)}


def jax_abs_term(init: dict, l1_w: float) -> dict:
    """What JAX's |1 - p| adds over torch's to each time plane's gradient:
    -l1_w / cells where the cell is exactly 1 (JAX: d|x|/dx = 1 at 0)."""
    out = {}
    for k, v in init.items():
        if k.startswith("params/deform/grid/") and \
                int(k.rsplit("_p", 1)[1]) in TIME_PLANES:
            out[k[len("params/deform/"):]] = np.where(
                v == 1.0, -l1_w / v.size, 0.0)
    return out


def assert_grads_close(port: dict, ref: dict, what: str,
                       extra: dict | None = None) -> None:
    assert port.keys() == ref.keys(), what
    for k, r in ref.items():
        p = port[k] + (extra or {}).get(k, 0.0)
        scale = np.abs(r).max() + 1e-12
        np.testing.assert_allclose(p / scale, r / scale, atol=GRAD_TOL,
                                   err_msg=f"{what} {k}")


def assert_state_close(ps: dict, js: dict, what: str) -> None:
    """Gaussian fields atol 5e-5; denom, max_radii2d exact;
    xyz_gradient_accum atol 1e-5 (`js` in the JAX checkpoint's keys)."""
    for f in FIELDS:
        np.testing.assert_allclose(ps[f"gauss/{f}"],
                                   js[f"params/gauss/{f}"], atol=5e-5,
                                   err_msg=f"{what} {f}")
    np.testing.assert_array_equal(ps["denom"], js["denom"], err_msg=what)
    np.testing.assert_allclose(ps["xyz_gradient_accum"],
                               js["xyz_gradient_accum"], atol=1e-5,
                               err_msg=what)
    np.testing.assert_array_equal(ps["max_radii2d"], js["max_radii2d"],
                                  err_msg=what)


def assert_step_matches(port: dict, ref: dict, init: dict,
                        what: str) -> None:
    assert port["loss"] == pytest.approx(ref["loss"], rel=1e-4), what
    assert port["l1"] == pytest.approx(ref["l1"], rel=1e-4), what
    assert port["psnr"] == pytest.approx(ref["psnr"], rel=1e-3), what
    assert port["n_visible"] == ref["n_visible"], what
    assert_state_close(port["state"], ref["state"], what)
    if what.endswith("fine"):
        assert_grads_close(deform_grads(port["state"]),
                           jax_deform_grads(ref["state"]), what,
                           jax_abs_term(init, REG[1]))


def single_card_fine_step(sc: dict) -> dict:
    """The port's own train_step, the fine step of STEPS, on the whole
    batch from the same state: its loss and state (snapshot keys)."""
    ids = batch_ids()
    state = worker._state(dict(flat=jckpt._flatten(sc["st"]._asdict()),
                               cfg=sc["pcfg"]))
    step = STEPS[1]
    state, aux = tloop.train_step(
        state, [sc["tcams"][i] for i in ids],
        torch.from_numpy(sc["images"][ids]), torch.zeros(3),
        step["active_sh"], stage=step["stage"], raster_cfg=sc["traster"],
        tx=toptim.build_optimizer(sc["pcfg"].opt, 1.0),
        lambda_dssim=step["lambda_dssim"], reg_weights=step["reg_weights"])
    return dict(loss=float(aux.loss), state=worker.snapshot(state))


def assert_matches_single_card(port: dict, single: dict, what: str) -> None:
    """A sharded fine step against the port's single-card step."""
    assert port["loss"] == pytest.approx(single["loss"], rel=1e-4), what
    ps, ss = port["state"], single["state"]
    as_jax = {(f"params/{k}" if k.startswith("gauss/") else k): v
              for k, v in ss.items()}
    assert_state_close(ps, as_jax, what)
    assert_grads_close(deform_grads(ps), deform_grads(ss), what)


def assert_ranks_equal(ranks: list) -> None:
    """Every rank's state after each step, bit for bit."""
    for step in range(len(STEPS)):
        first = ranks[0][step]["state"]
        for r, rank in enumerate(ranks[1:], 1):
            for k, v in rank[step]["state"].items():
                np.testing.assert_array_equal(v, first[k],
                                              err_msg=f"rank {r} {k}")


@pytest.mark.parametrize("mesh", [(1, 2), (2, 1)], ids=["1x2", "2x1"])
def test_sharded_step_matches_jax(mesh, tmp_path):
    sc = scene(64, 64)
    ranks, ref = run_case(sc, mesh, tmp_path)
    assert_ranks_equal(ranks)
    init = jckpt._flatten(sc["st"]._asdict())
    for step, (port, jax_ref) in enumerate(zip(ranks[0], ref)):
        assert_step_matches(port, jax_ref, init,
                            f"{mesh} {STEPS[step]['stage']}")
    assert_matches_single_card(ranks[0][1], single_card_fine_step(sc),
                               f"{mesh} against train_step")
