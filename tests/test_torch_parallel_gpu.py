"""The tile-sharded step on the card: two ranks sharing cuda:0 over gloo
(NCCL takes one rank a card), each running K1, K2 and the binner kernel on
its band, against the single-card `train_step` from the same state; and a
one-rank NCCL group in this process, whose (1, 1) mesh's step and frame
are captured (train/graphs.py): 30 replays of the captured sharded step
against 30 eager steps from the same state (every leaf after one step
normalised 1e-4, the losses 1e-3 relative, as chip_smoke.py's phase 5),
and the captured sharded frame equal to the eager one bit for bit.

Marked `gpu`; the `cuda` fixture skips it without a card. It imports no
JAX and runs with `--noconftest` on a machine with an H100:

    python -m pytest --noconftest tests/test_torch_parallel_gpu.py -q

Tolerances are tests/test_torch_kernels_gpu.py's train-step check (K2
sums with atomics): the loss 1e-4 relative, every Adam moment after the
step normalised 1e-4, xyz_gradient_accum normalised 1e-4, denom and
max_radii2d exact; the ranks' states equal bit for bit.
"""
import socket

import numpy as np
import pytest
import torch
import torch.distributed as dist

from fourdgs_tpu_torch.data.camera import look_at_camera
from fourdgs_tpu_torch.ops import _build
from fourdgs_tpu_torch.parallel import sharded
from fourdgs_tpu_torch.parallel.mesh import make_mesh
from fourdgs_tpu_torch.render.serve import Renderer
from fourdgs_tpu_torch.tools.render import MeshRenderer
from fourdgs_tpu_torch.train import config as tconfig
from fourdgs_tpu_torch.train import graphs, loop, optim
from fourdgs_tpu_torch.train.state import create_state
# tests/ is on sys.path under pytest (no __init__.py: "prepend" import)
import _torch_parallel_worker as worker  # noqa: E402

SIZE = 96            # tile 16: 6 x 6 tiles, a band of 3 rows a rank
GRAD_TOL = 1e-4
LOSS_RTOL = 1e-3
CAPTURED_STEPS = 30
REG = (0.01, 1e-4, 1e-4)


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


@pytest.fixture
def nccl_mesh(cuda):
    """A (1, 1) mesh over a one-rank NCCL group in this process: its
    collectives are real NCCL launches."""
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    torch.cuda.set_device(cuda)
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}",
                            rank=0, world_size=1)
    try:
        mesh = make_mesh(1, 1)
        assert mesh.backend == "nccl"
        yield mesh
    finally:
        dist.destroy_process_group()


def _leaves(st):
    return (optim.param_leaves(st.params)
            + optim.moment_leaves(st.opt_state.mu)
            + optim.moment_leaves(st.opt_state.nu)
            + [st.xyz_gradient_accum, st.denom, st.max_radii2d])


@pytest.mark.gpu
def test_captured_sharded_step_matches_eager_over_nccl(cuda, nccl_mesh):
    mesh = nccl_mesh
    cfg, st = _state_and_cfg()
    tx = optim.build_optimizer(cfg.opt, 1.0)
    st.opt_state = tx.init(st.params)
    rc = tconfig.raster_config_from(cfg, SIZE, SIZE)
    cams = [look_at_camera(time=t, device=cuda) for t in (0.2, 0.7)]
    gts = torch.from_numpy(np.random.default_rng(4).uniform(
        0, 1, (2, SIZE, SIZE, 3)).astype(np.float32)).to(cuda)
    bg = torch.ones(3, device=cuda)
    key = graphs.StepKey("fine", st.capacity, rc, 1, True, 2, 0.2, REG,
                         graphs.switches(), sharded.mesh_key(mesh, rc))
    step_fn = sharded.step_of_key(tx, mesh)
    programs = graphs.StepPrograms(step_fn)
    run = {"eager": lambda s: step_fn(key)(s, cams, gts, bg),
           "captured": lambda s: programs.run(key, s, cams, gts, bg)}
    losses, after_one = {}, {}
    for mode in run:
        state = st.to(cuda)
        losses[mode] = []
        for i in range(CAPTURED_STEPS):
            losses[mode].append(float(run[mode](state).loss))
            if i == 0:
                after_one[mode] = state.to(cuda)
    live = programs.live.program
    assert live.replays == CAPTURED_STEPS and len(programs.captures) == 1
    assert live.launches["blend_forward"] == 2
    assert live.launches["blend_backward"] == 2
    for a, b in zip(_leaves(after_one["captured"]),
                    _leaves(after_one["eager"]), strict=True):
        _close(a.detach().cpu().numpy(), b.detach().cpu().numpy(), "leaf")
    le, lc = np.array(losses["eager"]), np.array(losses["captured"])
    assert np.isfinite(le).all()
    assert np.max(np.abs(lc - le) / np.abs(le)) <= LOSS_RTOL


@pytest.mark.gpu
def test_captured_sharded_frame_equals_eager_over_nccl(cuda, nccl_mesh):
    cfg, st = _state_and_cfg()
    st = st.to(cuda)
    rc = tconfig.raster_config_from(cfg, SIZE, SIZE)
    renderer = Renderer(gauss=st.params["gauss"], alive=st.alive,
                        deform=st.params["deform"], aabb=st.aabb,
                        bg=torch.ones(3, device=cuda), raster_cfg=rc,
                        sh_degree=1, device=cuda)
    frames = MeshRenderer(renderer, nccl_mesh)
    assert frames.captures
    for t in (0.1, 0.6, 0.9):
        cam = look_at_camera(theta=0.2 + t, time=t, device=cuda)
        got, want = frames.render(cam), frames.render_eager(cam)
        for f in ("color", "depth", "alpha", "dropped_pairs",
                  "dropped_tile", "num_pairs"):
            assert torch.equal(getattr(got, f), getattr(want, f)), (t, f)
    assert renderer.captured == 1 and renderer.replayed == 3
