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
import collections
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
from fourdgs_tpu_torch.utils import tracing
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
    assert tracing.replayed_kernels()["blend_forward"] == len(cams)
    assert graphs.kernel_runs()["blend_forward"] == (graphs.WARMUP
                                                     + len(cams))
    for c, got in zip(cams, outs):
        want = eager.render(c)
        for f in want._fields:
            assert torch.equal(getattr(got, f), getattr(want, f)), f
    assert not torch.equal(outs[0].color, outs[1].color)


@pytest.mark.gpu
def test_captured_evaluation_equals_eager_eval_step(cuda):
    """The train CLI's evaluation programs (graphs.EvalPrograms): every
    view's replay equals the eager eval_step of the same state bit for
    bit; a second evaluation after a surgery captures nothing."""
    cfg = _cfg()
    st = _state(cfg).to(cuda)
    rc = tconfig.raster_config_from(cfg, 96, 96)
    bg = torch.ones(3, device=cuda)
    cams = [look_at_camera(theta=0.5 * i, time=i / 4, device=cuda)
            for i in range(4)]
    programs = graphs.EvalPrograms()
    for surgery in (False, True):
        if surgery:
            st = loop.compact_and_resize(st, st.capacity)
            with torch.no_grad():
                st.params["gauss"].opacity.add_(0.5)
        programs.load(st, bg)
        for cam in cams:
            got = programs.render(cam, stage="fine", active_sh=1,
                                  raster_cfg=rc)
            want = loop.eval_step(st, cam, bg, stage="fine", active_sh=1,
                                  raster_cfg=rc)
            for f in want._fields:
                assert torch.equal(getattr(got, f), getattr(want, f)), f
    rep = programs.report()
    assert len(rep["captures"]) == 1 and rep["replays"] == 2 * len(cams)


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
    key = graphs.StepKey("fine", st.capacity, rc, True, batch, 0.0,
                         (0.01, 1e-4, 1e-4), graphs.switches())
    return st, loop.step_of_key(tx), key, cams, gt, bg


def _degree(dev, sh=1):
    """The SH degree as run_stage passes it on a single card."""
    return torch.full((), sh, dtype=torch.int32, device=dev)


def _captured_step_matches_eager(dev, batch, backward=None):
    """One step eagerly and one captured from the same state: every leaf
    within GRAD_TOL normalised, the loss to 1e-5; a step renders each
    camera of the batch once, forward and backward (`backward`: the
    backward's launches, by default K2's)."""
    st, step_fn, key, cams, gt, bg = _step_state(dev, batch)
    sh = _degree(dev)
    eager, captured = st.to(dev), st.to(dev)
    aux_e = step_fn(key)(eager, cams, gt, bg, sh)
    steps = graphs.StepPrograms(step_fn)
    aux_c = steps.run(key, captured, cams, gt, bg, sh)
    assert steps.live.program.launches == {
        **{k: batch * v for k, v in FRAME_LAUNCHES.items()},
        **(backward or {"blend_backward": batch})}
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
    steps.run(key, captured, cams, gt, bg, sh)
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
def test_a_captured_reassociated_step_matches_the_eager_step(cuda,
                                                             monkeypatch):
    """FOURDGS_PALLAS_NO_FUSED_BWD alone: K3's table reduced by
    reassociation over the binner's slots, which the binner writes in the
    graph (its budget slots' rows, and the lists through K5)."""
    monkeypatch.setenv("FOURDGS_PALLAS_NO_FUSED_BWD", "1")
    monkeypatch.delenv("FOURDGS_PALLAS_GRAD_SCATTER", raising=False)
    monkeypatch.delenv("FOURDGS_BIN_SCATTER", raising=False)
    _captured_step_matches_eager(cuda, 1, {"blend_backward_slots": 1,
                                           "scatter_set_scalars": 1})


def _leaf_errors(a, b) -> dict:
    """Each floating leaf's largest difference over its largest magnitude
    (the others must be equal)."""
    errs, want = {}, _tensors(b)
    for name, x in _tensors(a).items():
        y = want[name]
        if not y.is_floating_point():
            assert torch.equal(x, y), name
            continue
        errs[name] = float((x - y).abs().max()) / max(
            float(y.abs().max()), 1e-30)
    return errs


@pytest.mark.gpu
def test_a_step_prewarmed_on_a_second_thread_matches_one_captured_here(cuda):
    """StepPrograms.prewarm builds the statistics-off step and the next
    bucket's on daemon threads, each captured in thread-local mode on a
    pool stream of its own, while this thread replays the live step on the
    default stream and reads its loss to the host after each replay: the
    captures hold (the pool's streams are non-blocking, so the default
    stream's work never joins them). At the switch the prewarmed program
    is taken, and its replays follow those of the same key captured on
    this thread (leaves after one step within GRAD_TOL, losses within
    LOSS_RTOL: K2's atomics). kernel_runs() counts every warm-up and
    replay of the four programs, launched from both threads, and none of
    their captures."""
    st, step_fn, key, cams, gt, bg = _step_state(cuda)
    sh = _degree(cuda)
    graphs.zero_counts()
    steps = graphs.StepPrograms(step_fn)
    live = st.to(cuda)
    steps.run(key, live, cams, gt, bg, sh)
    first = steps.live.program
    off = key._replace(track_stats=False)
    steps.prewarm(off, live, cams, gt, bg)
    steps.prewarm(key._replace(capacity=2 * key.capacity), live, cams, gt,
                  bg)
    overlapped = 0
    while any(p.building() for p in steps.prewarms):
        assert np.isfinite(float(steps.run(key, live, cams, gt, bg,
                                           sh).loss))
        overlapped += 1
    assert overlapped > 0
    assert all(p.built and p.error is None for p in steps.prewarms)
    built = [p.step.program for p in steps.prewarms]
    start = live.to(cuda)
    a, b = start.to(cuda), start.to(cuda)
    steps_here = graphs.StepPrograms(step_fn)
    losses = {"prewarmed": [], "here": []}
    for i in range(5):
        losses["prewarmed"].append(float(steps.run(off, a, cams, gt, bg,
                                                   sh).loss))
        losses["here"].append(float(steps_here.run(off, b, cams, gt, bg,
                                                   sh).loss))
        if i == 0:
            errs = _leaf_errors(a, b)
            assert max(errs.values()) <= GRAD_TOL, errs
    # the switch took the statistics-off program; the bigger bucket's
    # (statistics on) can no longer come, and went with its pool
    pre, bigger = steps.prewarms
    assert pre.used and steps.live.program is built[0]
    assert len(steps.captures) == 1 and not steps_here.prewarms
    assert bigger.dropped and not bigger.used and bigger.step is None
    la, lb = np.array(losses["prewarmed"]), np.array(losses["here"])
    np.testing.assert_allclose(la, lb, rtol=LOSS_RTOL)
    programs = [first, *built, steps_here.live.program]
    want = collections.Counter()
    for prog in programs:
        assert prog.launches["blend_forward"] == 1
        for name, n in prog.launches.items():
            want[name] += (graphs.WARMUP + prog.replays) * n
    ran = {k: v for k, v in graphs.kernel_runs().items() if v}
    assert ran == dict(want)
    steps.close()
    torch.cuda.synchronize()


@pytest.mark.gpu
@pytest.mark.parametrize("size", [(96, 96), (128, 80)])
def test_the_bridge_serves_the_renderers_frame(cuda, size):
    """The viewer bridge on a captured Renderer: the reply's bytes are the
    frame that Renderer.render_eager draws at the request's camera and
    size, converted to uint8; the verify string follows."""
    import socket

    from fourdgs_tpu_torch.viewer import network_gui
    rend = _renderer(cuda, capture=True)
    gui = network_gui.NetworkGui(cuda)
    server, client = socket.socketpair()
    gui.conn = server
    w, h = size
    cam = look_at_camera(theta=0.5, time=0.3, device=cuda)
    view, proj = network_gui.client_matrices(cam)
    seen = []

    def frame(camera, width, height, sm):
        seen.append(camera)
        return rend.gui_frame(camera, width, height, sm)

    for _ in range(2):      # the second a replay of the captured frame
        client.sendall(network_gui.request_bytes(w, h, 0.9, 0.9 * h / w,
                                                 view, proj, train=True))
        gui.poll(frame, "src", time=0.3)
        got, verify = network_gui.recv_reply(client, w, h)
        assert verify == "src" and len(got) == w * h * 3
    assert rend.replayed == 2 and rend.captured == 1
    want = dataclasses.replace(rend, capture=False).render_eager(seen[-1])
    assert got == network_gui.frame_bytes(want.color)
    client.close()
    gui.disconnect()


@pytest.mark.gpu
def test_a_replay_makes_no_sync(cuda):
    """The frame and the step, eager and replayed, with the sync debug
    mode raising at any host sync (a `.item()`, a copy from or to the
    host, a data-dependent size)."""
    rend = _renderer(cuda, capture=True)
    eager = dataclasses.replace(rend, capture=False)
    cam = look_at_camera(time=0.3, device=cuda)
    st, step_fn, key, cams, gt, bg = _step_state(cuda)
    sh = _degree(cuda)
    steps = graphs.StepPrograms(step_fn)
    rend.render(cam)
    eager.render(cam)
    steps.run(key, st, cams, gt, bg, sh)
    step_fn(key)(st, cams, gt, bg, sh)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(3):
            rend.render(cam)
            steps.run(key, st, cams, gt, bg, sh)
        eager.render(cam)
        step_fn(key)(st, cams, gt, bg, sh)
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
    and a forced rollback) with the card's graphs and prewarms: every
    change of key captures or takes its prewarmed program, the ramp
    captures nothing, every surgery rebinds, and the logged losses
    follow the eager run's."""
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
    assert rep["replays"] == 60 and rep["prewarms_failed"] == 0
    keys = ([c["key"] for c in rep["captures"]]
            + [p["key"] for p in rep["prewarms"] if p["used"]])
    assert captured.active_sh == 1
    assert all(970 + c["step"] != 1000 for c in rep["captures"])
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


# a PanopticSports camera (data/panoptic.py): projection from K, the
# principal point moved off centre by 6 % of the width and of the height,
# at a ragged size (8 columns and 22 rows past the 32-pixel tiles)
OFF_CENTRE_WH = (104, 86)
OFF_CENTRE_SHIFT = (0.06, -0.06)
# chip_smoke.py's rule for the card against the CPU path (SMALL_TOL_*)
CPU_TOL_MEAN, CPU_TOL_MAX = 1e-5, 5e-3


def _off_centre_camera(dev, theta=0.3, time=0.4):
    from fourdgs_tpu_torch.data.panoptic import camera_from_k_w2c
    w, h = OFF_CENTRE_WH
    focal = w / (2 * np.tan(0.45))
    pos = 4.0 * np.array([np.sin(theta), 0.1, np.cos(theta)])
    fwd = -pos / np.linalg.norm(pos)
    right = np.cross(fwd, [0.0, 1.0, 0.0])
    right /= np.linalg.norm(right)
    w2c = np.eye(4)
    w2c[:3, :3] = np.stack([right, np.cross(fwd, right), fwd])
    w2c[:3, 3] = -w2c[:3, :3] @ pos
    k = [[focal, 0.0, w / 2 + OFF_CENTRE_SHIFT[0] * w],
         [0.0, focal, h / 2 + OFF_CENTRE_SHIFT[1] * h], [0.0, 0.0, 1.0]]
    return camera_from_k_w2c(k, w2c, w, h, time=time, device=dev)


@pytest.mark.gpu
def test_off_centre_served_frame_matches_the_cpu_path(cuda):
    """A frame served (a replay of the captured frame) through a K-built
    camera with its principal point off centre, at 104x86: equal to the
    eager frame bit for bit, and to the CPU path's frame within the 160x160
    check's tolerances."""
    cfg = _cfg()
    st = _state(cfg)
    rc = tconfig.raster_config_from(cfg, *OFF_CENTRE_WH)

    def renderer(dev, capture):
        s = st.to(dev)
        return Renderer(gauss=s.params["gauss"], alive=s.alive,
                        deform=s.params["deform"].eval(), aabb=s.aabb,
                        bg=torch.ones(3, device=dev), sh_degree=1,
                        device=dev, raster_cfg=rc, capture=capture)

    served = renderer(cuda, True)
    graphs.zero_counts()
    cams = [_off_centre_camera(cuda, theta=0.3 * i, time=i / 4)
            for i in range(4)]
    outs = [served.render(c) for c in cams]
    assert tracing.replayed_kernels()["blend_forward"] == len(cams)
    eager = dataclasses.replace(served, capture=False)
    cpu = renderer(torch.device("cpu"), False)
    for i, got in enumerate(outs):
        assert torch.equal(got.color, eager.render(cams[i]).color)
        want = cpu.render(_off_centre_camera(
            torch.device("cpu"), theta=0.3 * i, time=i / 4)).color
        d = (got.color.cpu() - want).abs()
        assert float(d.mean()) <= CPU_TOL_MEAN, float(d.mean())
        assert float(d.max()) <= CPU_TOL_MAX, float(d.max())
    assert float(outs[0].color.mean()) < 0.99     # splats in the frame


@pytest.mark.gpu
def test_off_centre_step_gradients_with_k2_match_the_plain_backward(cuda):
    """One step's gradients behind the off-centre camera at 104x86, with K2
    and with the plain backward: every leaf within GRAD_TOL of its largest
    magnitude."""
    cfg = _cfg()
    st = _state(cfg).to(cuda)
    rc = tconfig.raster_config_from(cfg, *OFF_CENTRE_WH)
    cam = _off_centre_camera(cuda)
    w, h = OFF_CENTRE_WH
    gt = torch.rand((1, h, w, 3), device=cuda,
                    generator=torch.Generator(cuda).manual_seed(2))
    kw = dict(stage="fine", raster_cfg=rc, lambda_dssim=0.2,
              reg_weights=(0.01, 1e-4, 1e-4))

    def grads():
        sg = loop.step_gradients(st, [cam], gt, torch.ones(3, device=cuda),
                                 1, **kw)
        return [x for x in sg.grads + [sg.ndc_grad] if x is not None]

    before = blend.blend_backward.launches
    with_k2 = grads()
    assert blend.blend_backward.launches == before + 1
    saved = blend.blend_backward
    blend.blend_backward = blend.blend_backward_plain
    try:
        plain = grads()
    finally:
        blend.blend_backward = saved
    assert any(float(p.abs().max()) > 0 for p in plain)
    for i, (a, b) in enumerate(zip(with_k2, plain, strict=True)):
        err = float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)
        assert err <= GRAD_TOL, (i, err)
