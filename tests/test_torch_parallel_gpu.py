"""The tile-sharded step on the card: two ranks sharing cuda:0 over gloo
(NCCL takes one rank a card), each running K1, K2 and the binner kernel on
its band, against the single-card `train_step` from the same state.

Marked `gpu`; the `cuda` fixture skips it without a card. It imports no
JAX and runs with `--noconftest` on a machine with an H100:

    python -m pytest --noconftest tests/test_torch_parallel_gpu.py -q

Tolerances are tests/test_torch_kernels_gpu.py's train-step check (K2
sums with atomics): the loss 1e-4 relative, every Adam moment after the
step normalised 1e-4, xyz_gradient_accum normalised 1e-4, denom and
max_radii2d exact; the ranks' states equal bit for bit.
"""
import numpy as np
import pytest
import torch

from fourdgs_tpu_torch.data.camera import look_at_camera
from fourdgs_tpu_torch.ops import _build
from fourdgs_tpu_torch.train import config as tconfig
from fourdgs_tpu_torch.train import loop, optim
from fourdgs_tpu_torch.train.state import create_state
# tests/ is on sys.path under pytest (no __init__.py: "prepend" import)
import _torch_parallel_worker as worker  # noqa: E402

SIZE = 96            # tile 16: 6 x 6 tiles, a band of 3 rows a rank
GRAD_TOL = 1e-4


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _state_and_cfg():
    cfg = tconfig.Config()
    cfg.model.sh_degree = 1
    cfg.raster = tconfig.RasterParams(capacity=512, tile_size=16,
                                      tile_cap=256, chunk=8)
    cfg.hidden.kplanes_config["resolution"] = [8, 8, 8, 4]
    cfg.hidden.kplanes_config["output_coordinate_dim"] = 8
    cfg.hidden.multires = [1, 2]
    cfg.hidden.net_width = 32
    rng = np.random.default_rng(3)
    pts = rng.uniform(-1, 1, (300, 3)).astype(np.float32)
    cols = rng.uniform(0, 1, (300, 3)).astype(np.float32)
    st = create_state(cfg, pts, cols, 1.0, device="cpu",
                      generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        g = st.params["gauss"]
        g.opacity.add_(torch.from_numpy(
            rng.normal(1.5, 1.0, g.opacity.shape).astype(np.float32)))
        g.scaling.add_(torch.from_numpy(
            rng.normal(0.5, 0.3, g.scaling.shape).astype(np.float32)))
    return cfg, st


def _close(a, b, name):
    scale = float(np.abs(b).max()) + 1e-12
    err = float(np.abs(a - b).max()) / scale
    assert err <= GRAD_TOL, f"{name}: normalised max abs err {err}"


@pytest.mark.gpu
@pytest.mark.parametrize("mesh", [(1, 2), (2, 1)], ids=["1x2", "2x1"])
def test_two_ranks_on_one_card_match_train_step(cuda, mesh, tmp_path):
    _build.load_library()        # built once here, not by both ranks
    cfg, st = _state_and_cfg()
    rc = tconfig.raster_config_from(cfg, SIZE, SIZE)
    cams = [look_at_camera(time=t, device="cpu") for t in (0.2, 0.7)]
    target = torch.from_numpy(np.random.default_rng(4).uniform(
        0, 1, (2, SIZE, SIZE, 3)).astype(np.float32))
    reg = (0.01, 1e-4, 1e-4)
    step = dict(stage="fine", lambda_dssim=0.2, reg_weights=reg, active_sh=1)
    job = dict(runs=["steps"], mesh=mesh, device="cuda", backend="gloo",
               state=st, cfg=cfg, raster=rc, cams=cams, gts=target,
               bg=torch.ones(3), steps=[step])
    ctx = worker.spawn(job, 2, tmp_path)
    single = st.to(cuda)
    _, aux = loop.train_step(
        single, [c.to(cuda) for c in cams], target.to(cuda),
        torch.ones(3, device=cuda), 1, stage="fine", raster_cfg=rc,
        tx=optim.build_optimizer(cfg.opt, 1.0), lambda_dssim=0.2,
        reg_weights=reg)
    ranks = [r["steps"][0] for r in worker.collect(ctx, tmp_path, 2)]
    for k, v in ranks[1]["state"].items():
        np.testing.assert_array_equal(v, ranks[0]["state"][k], err_msg=k)
    port, ref = ranks[0], worker.snapshot(single)
    per_rank = len(cams) // mesh[0]     # the rank's cameras, one K2 each
    assert port["launches"][0] >= per_rank
    assert port["launches"][1] == per_rank
    assert port["loss"] == pytest.approx(float(aux.loss), rel=1e-4)
    for k, v in ref.items():
        if k.startswith(("mu/", "nu/")):
            _close(port["state"][k], v, k)
    _close(port["state"]["xyz_gradient_accum"], ref["xyz_gradient_accum"],
           "xyz_gradient_accum")
    np.testing.assert_array_equal(port["state"]["denom"], ref["denom"])
    np.testing.assert_array_equal(port["state"]["max_radii2d"],
                                  ref["max_radii2d"])
