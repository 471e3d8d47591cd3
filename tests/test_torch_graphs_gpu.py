"""The captured step and frame (fourdgs_tpu_torch/train/graphs.py) on the
card, against the eager path.

Every test is marked `gpu` and takes the `cuda` fixture, which skips it
when no CUDA device is present (decided when the test runs, never at
import). Run them on a machine with an H100:

    python -m pytest --noconftest tests/test_torch_graphs_gpu.py -q

A captured frame replays the eager frame's kernels on the same inputs, all
deterministic (K1, the HexPlane gathers, the binner's stable sorts and
integer sums), so it must equal the eager frame bit for bit. A step's
backward sums with float atomics (K2, `index_add_`) in an order that
changes from run to run, so one captured step is held to phase 5's rule
(chip_smoke.py GRAD_TOL): each leaf's largest difference over its largest
magnitude at most 1e-4; a stage's logged losses, to LOSS_RTOL.
"""
import dataclasses

import numpy as np
import pytest
import torch

from fourdgs_tpu_torch.data import scene as tscene
from fourdgs_tpu_torch.data.camera import look_at_camera
from fourdgs_tpu_torch.ops import blend
from fourdgs_tpu_torch.render.serve import Renderer
from fourdgs_tpu_torch.tools.make_synthetic_scene import write_split
from fourdgs_tpu_torch.train import config as tconfig
from fourdgs_tpu_torch.train import graphs, loop, optim
# tests/ is on sys.path under pytest (no __init__.py: "prepend" import)
from test_torch_graphs import _cfg, _run, _stage_cfg, _state, _tensors

GRAD_TOL = 1e-4
# a stage's logged losses, captured against eager, over 60 iterations:
# the atomics' order moves the last bits of each step, and Adam's
# division by sqrt(nu) carries them on (tests/test_torch_stage.py)
LOSS_RTOL = 1e-3
# the kernels a frame runs once each (K1, the binner), and the HexPlane's
# forward gathers (D1): 18 a level at one timestamp, two levels (_cfg)
FRAME_LAUNCHES = {"blend_forward": 1, "bin_tiles": 1, "gather_rows": 36}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


def _renderer(dev, capture, size=96):
    cfg = _cfg()
    st = _state(cfg).to(dev)
    return Renderer(gauss=st.params["gauss"], alive=st.alive,
                    deform=st.params["deform"].eval(), aabb=st.aabb,
                    bg=torch.ones(3, device=dev), sh_degree=1, device=dev,
                    raster_cfg=tconfig.raster_config_from(cfg, size, size),
                    capture=capture)


@pytest.mark.gpu
def test_captured_frame_equals_the_eager_frame(cuda):
    rend = _renderer(cuda, capture=True)
    eager = dataclasses.replace(rend, capture=False)
    cams = [look_at_camera(theta=0.4 * i, time=i / 5, device=cuda)
            for i in range(6)]
    graphs.zero_counts()
    outs = [rend.render(c) for c in cams]
    (frame,) = rend.frames.values()
    assert frame.program.launches == FRAME_LAUNCHES
    # the warm-up's renders ran; the capture's did not
    assert blend.blend_forward.launches == graphs.WARMUP
    assert graphs.REPLAYED["blend_forward"] == len(cams)
    assert graphs.kernel_runs()["blend_forward"] == (graphs.WARMUP
                                                     + len(cams))
    for c, got in zip(cams, outs):
        want = eager.render(c)
        for f in want._fields:
            assert torch.equal(getattr(got, f), getattr(want, f)), f
    assert not torch.equal(outs[0].color, outs[1].color)


def _step_state(dev, batch=1):
    cfg = _cfg()
    st = _state(cfg).to(dev)
    tx = optim.build_optimizer(cfg.opt, 1.0)
    st.opt_state = tx.init(st.params)
    rc = tconfig.raster_config_from(cfg, 96, 96)
    cams = [look_at_camera(theta=0.3 + 0.5 * i, time=0.4 + 0.2 * i,
                           device=dev) for i in range(batch)]
    gt = torch.rand((batch, 96, 96, 3), device=dev,
                    generator=torch.Generator(dev).manual_seed(1))
    bg = torch.ones(3, device=dev)
    key = graphs.StepKey("fine", st.capacity, rc, 1, True, batch, 0.0,
                         (0.01, 1e-4, 1e-4), graphs.switches())
    return st, loop.step_of_key(tx), key, cams, gt, bg


def _captured_step_matches_eager(dev, batch):
    """One step eagerly and one captured from the same state: every leaf
    within GRAD_TOL normalised, the loss to 1e-5; a step renders each
    camera of the batch once, forward and backward."""
    st, step_fn, key, cams, gt, bg = _step_state(dev, batch)
    eager, captured = st.to(dev), st.to(dev)
    aux_e = step_fn(key)(eager, cams, gt, bg)
    steps = graphs.StepPrograms(step_fn)
    aux_c = steps.run(key, captured, cams, gt, bg)
    assert steps.live.program.launches == {
        **{k: batch * v for k, v in FRAME_LAUNCHES.items()},
        "blend_backward": batch}
    errs, want = {}, _tensors(eager)
    for name, a in _tensors(captured).items():
        b = want[name]
        if not b.is_floating_point():
            assert torch.equal(a, b), name
            continue
        errs[name] = float((a - b).abs().max()) / max(
            float(b.abs().max()), 1e-30)
    assert max(errs.values()) <= GRAD_TOL, errs
    assert int(captured.opt_state.count) == int(eager.opt_state.count) == 1
    assert int(captured.step) == 1
    torch.testing.assert_close(aux_c.loss, aux_e.loss, rtol=1e-5, atol=0)
    # a second replay advances the count and the step in place
    steps.run(key, captured, cams, gt, bg)
    assert int(captured.opt_state.count) == 2 and int(captured.step) == 2


@pytest.mark.gpu
def test_one_captured_step_matches_the_eager_step(cuda):
    _captured_step_matches_eager(cuda, 1)


@pytest.mark.gpu
def test_a_captured_batch_two_step_matches_the_eager_step(cuda):
    """Batch 2 (the dynerf configs' batch): the two cameras share one
    ndc_offset, and the densify statistics take the radii's max and the
    visibility's any over the two, in the graph as eagerly."""
    _captured_step_matches_eager(cuda, 2)


@pytest.mark.gpu
def test_a_replay_makes_no_sync(cuda):
    """The frame and the step, eager and replayed, with the sync debug
    mode raising at any host sync (a `.item()`, a copy from or to the
    host, a data-dependent size)."""
    rend = _renderer(cuda, capture=True)
    eager = dataclasses.replace(rend, capture=False)
    cam = look_at_camera(time=0.3, device=cuda)
    st, step_fn, key, cams, gt, bg = _step_state(cuda)
    steps = graphs.StepPrograms(step_fn)
    rend.render(cam)
    eager.render(cam)
    steps.run(key, st, cams, gt, bg)
    step_fn(key)(st, cams, gt, bg)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(3):
            rend.render(cam)
            steps.run(key, st, cams, gt, bg)
        eager.render(cam)
        step_fn(key)(st, cams, gt, bg)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()


@pytest.fixture
def gpu_scene(cuda, tmp_path):
    write_split(str(tmp_path), "train", 6, 0.0, 32, "cpu")
    write_split(str(tmp_path), "test", 2, 0.13, 32, "cpu")
    return tscene.Scene.load(str(tmp_path), device=cuda,
                             white_background=True, eval_split=True,
                             resolution=(32, 32))


@pytest.mark.gpu
def test_captured_stage_follows_the_eager_stage(gpu_scene):
    """tests/test_torch_graphs.py's stage (a densify, a prune, bucket
    changes, the SH ramp, tile_cap growth, the densify statistics' stop
    and a forced rollback) with the card's graphs: every change of key
    captures, every surgery rebinds, and the logged losses follow the
    eager run's."""
    cfg = _stage_cfg()
    eager = _run(cfg, gpu_scene, capture=False)
    captured = _run(cfg, gpu_scene, capture=True)
    kinds = [(e["iter"], e["kind"]) for e in eager.events]
    assert [(e["iter"], e["kind"]) for e in captured.events] == kinds
    for kind in ("densify", "prune", "resize", "rollback", "tile_cap"):
        assert kind in {k for _, k in kinds}, kinds
    for a, b in zip(captured.events, eager.events):
        assert abs(a["points"] - b["points"]) <= 0.01 * b["points"], (a, b)
    la = np.array([h["loss"] for h in captured.history])
    lb = np.array([h["loss"] for h in eager.history])
    np.testing.assert_allclose(la, lb, rtol=LOSS_RTOL, equal_nan=True)
    rep = captured.graphs
    assert rep["replays"] == 60
    keys = [c["key"] for c in rep["captures"]]
    assert any("sh 1" in k for k in keys)
    assert any("stats off" in k for k in keys)
    replaced = {i for i, k in kinds
                if k in ("densify", "prune", "resize", "rollback")} - {1030}
    assert rep["rebinds"] >= len(replaced)
    assert all(c["seconds"] > 0 for c in rep["captures"])


@pytest.mark.gpu
def test_captured_steps_from_a_lazy_bank_follow_the_device_bank(gpu_scene):
    """Captured steps of batch 2 whose targets come from a lazy bank with
    its prefetch (decoded in the bank's processes while a step replays,
    uploaded on the training thread) against the same steps from the
    device bank: the batches are equal (8-bit images), so the logged
    losses follow to LOSS_RTOL."""
    cfg = _cfg()
    cfg.opt.batch_size = 2
    cfg.opt.densify_until_iter = 0           # steps only
    split = gpu_scene.train
    infos = gpu_scene.info.train_cameras
    dev = split.cameras[0].time.device
    lazy = tscene.stack_cameras(infos, dev, device_budget=0, host_budget=0)
    assert lazy.images.mode == "lazy" and split.images.mode == "device"
    idxs = np.array([4, 1])
    assert torch.equal(lazy.images[idxs], split.images[idxs])
    runs = {}
    for name, bank in (("device", split.images), ("lazy", lazy.images)):
        st = _state(cfg).to(dev)
        tx = optim.build_optimizer(cfg.opt, gpu_scene.cameras_extent)
        st.opt_state = tx.init(st.params)
        runs[name] = loop.run_stage(
            cfg, st, "fine", 12, split.cameras, bank, tx,
            tconfig.raster_config_from(cfg, 32, 32), np.random.default_rng(1),
            log_every=1, cameras_extent=gpu_scene.cameras_extent,
            capture=True)
    lazy.images.close()
    assert all(r.graphs["replays"] == 12 for r in runs.values())
    # three batches an epoch: the first of each is not prefetched
    assert lazy.images.stats["prefetched"] == 8
    la = np.array([h["loss"] for h in runs["lazy"].history])
    lb = np.array([h["loss"] for h in runs["device"].history])
    np.testing.assert_allclose(la, lb, rtol=LOSS_RTOL)


@pytest.mark.gpu
def test_a_capture_that_cannot_succeed_raises(cuda):
    """The plain blend reads the tiles' largest count to the host, which
    a capture cannot hold: capturing a frame through it raises, and does
    not fall back to the eager frame."""
    rend = _renderer(cuda, capture=True)
    cam = look_at_camera(device=cuda)
    saved = blend.blend_forward
    blend.blend_forward = blend.blend_forward_plain
    try:
        with pytest.raises(RuntimeError):
            rend.render(cam)
    finally:
        blend.blend_forward = saved
    assert not rend.frames
    torch.cuda.synchronize()
