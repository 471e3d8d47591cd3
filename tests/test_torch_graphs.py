"""The captured step and frame (fourdgs_tpu_torch/train/graphs.py) on the
CPU, where there are no CUDA graphs.

`ReplayEagerly` stands in for `graphs.Program` here: it warms up as the
card's program does, runs nothing when it "captures", and each replay runs
the program's function again on the same static buffers, which is what a
graph's replay does with its kernels. So the keys, the state binding, the
inputs copied in and the outputs copied out run as they run on the card,
and on the CPU's deterministic arithmetic the captured path must equal the
eager one exactly. The card's graphs are held against the eager path by
tests/test_torch_graphs_gpu.py.
"""
import dataclasses

import numpy as np
import pytest
import torch

from fourdgs_tpu_torch.data import scene as tscene
from fourdgs_tpu_torch.data.camera import look_at_camera
from fourdgs_tpu_torch.render.serve import Renderer
from fourdgs_tpu_torch.tools.make_synthetic_scene import write_split
from fourdgs_tpu_torch.train import config as tconfig
from fourdgs_tpu_torch.train import densify, graphs, loop, optim
from fourdgs_tpu_torch.train.state import create_state

torch.set_num_threads(1)


class ReplayEagerly:
    """`graphs.Program` on the CPU: the warm-up runs, the capture runs
    nothing, and each replay runs `fn` on the program's static buffers."""

    def __init__(self, key, fn, label, warmup=graphs.WARMUP):
        for _ in range(warmup):
            fn()
        self.key, self.fn = key, fn
        self.replays, self.launches, self.seconds = 0, {}, 0.0

    def replay(self):
        self.replays += 1
        return self.fn()


def _cfg(cap=4096):
    cfg = tconfig.Config()
    cfg.model.sh_degree = 1
    cfg.raster = tconfig.RasterParams(capacity=cap, tile_size=16,
                                      tile_cap=64, chunk=8, min_bucket=256)
    cfg.hidden.kplanes_config["resolution"] = [8, 8, 8, 4]
    cfg.hidden.kplanes_config["output_coordinate_dim"] = 8
    cfg.hidden.multires = [1, 2]
    cfg.hidden.net_width = 32
    return cfg


def _state(cfg, n=200, seed=0):
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
    cols = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    st = create_state(cfg, pts, cols, 1.0,
                      generator=torch.Generator().manual_seed(seed),
                      device="cpu")
    return loop.compact_and_resize(st, loop.pick_bucket(
        n, cfg.raster.capacity, cfg.raster.min_bucket,
        cfg.raster.bucket_headroom))


def _tensors(state) -> dict:
    """Every tensor of a TrainState by name."""
    out = {"alive": state.alive, "aabb": state.aabb, "step": state.step,
           "xyz_gradient_accum": state.xyz_gradient_accum,
           "denom": state.denom, "max_radii2d": state.max_radii2d,
           "count": state.opt_state.count}
    for i, p in enumerate(optim.param_leaves(state.params)):
        out[f"param{i}"] = p.detach()
    for tree in ("mu", "nu"):
        for i, m in enumerate(optim.moment_leaves(
                getattr(state.opt_state, tree))):
            out[f"{tree}{i}"] = m
    return out


def _assert_same(a, b):
    ta, tb = _tensors(a), _tensors(b)
    assert ta.keys() == tb.keys()
    for k in ta:
        torch.testing.assert_close(ta[k], tb[k], rtol=0, atol=0,
                                   equal_nan=True, msg=k)


def _is_bound(state, bufs):
    """Whether every tensor of `state` is its buffer's storage."""
    ta, tb = _tensors(state), _tensors(bufs.state)
    return all(ta[k].data_ptr() == tb[k].data_ptr() for k in ta)


def test_adam_advances_the_count_in_place():
    """A replay reads the count it was captured with: Adam must advance
    that tensor, not return a new one."""
    cfg = _cfg()
    st = _state(cfg)
    tx = optim.build_optimizer(cfg.opt, 1.0)
    count = st.opt_state.count
    leaves = optim.param_leaves(st.params)
    for step in (1, 2):
        out = tx.update([torch.ones_like(p) for p in leaves], st.opt_state,
                        st.params)
        assert out.count is count and int(count) == step


def _step(st, cfg, rc, seed):
    tx = optim.build_optimizer(cfg.opt, 1.0)
    gen = torch.Generator().manual_seed(seed)
    cam = look_at_camera(theta=0.2 * seed, time=0.1 * seed, device="cpu")
    gt = torch.rand((1, rc.img_height, rc.img_width, 3), generator=gen)
    bg = torch.ones(3)
    return loop.train_step(st, [cam], gt, bg, 1, stage="fine", raster_cfg=rc,
                           tx=tx, lambda_dssim=0.2,
                           reg_weights=(0.01, 1e-4, 1e-4))[1]


def test_state_binding_gives_the_unbound_values():
    """A state bound to a captured step's buffers (graphs.StateBuffers)
    takes the same values as the state left alone, through steps, densify,
    prune, a resize into new buffers and a rollback, and after each bind
    its tensors are the buffers."""
    cfg = _cfg()
    rc = tconfig.raster_config_from(cfg, 32, 32)
    free = _state(cfg)
    bound = free.to("cpu")
    bufs = graphs.StateBuffers(bound)
    assert bufs.bind(bound) and _is_bound(bound, bufs)
    assert not bufs.bind(bound)             # nothing new: nothing copied

    def both(fn):
        nonlocal free, bound
        free, bound = fn(free), fn(bound)

    def step(seed):
        both(lambda st: (_step(st, cfg, rc, seed), st)[1])
        _assert_same(free, bound)

    step(1)
    noise = tuple(torch.randn((free.capacity, 3),
                              generator=torch.Generator().manual_seed(k))
                  for k in (3, 4))
    both(lambda st: densify.densify(st, 0.0, 0.01, 1.0, 10_000,
                                    noise=noise)[0])
    assert int(bound.alive.sum()) > 200 and not _is_bound(bound, bufs)
    assert bufs.bind(bound) and _is_bound(bound, bufs)
    _assert_same(free, bound)
    step(2)
    both(lambda st: densify.prune(st, 0.5, 1.0, None, 50))
    assert bufs.bind(bound) and _is_bound(bound, bufs)
    _assert_same(free, bound)
    step(3)

    new_cap = 2 * free.capacity             # the next bucket
    both(lambda st: loop.compact_and_resize(st, new_cap))
    with pytest.raises(ValueError):
        bufs.bind(bound)
    bufs = graphs.StateBuffers(bound.to("cpu"))
    assert bufs.bind(bound) and _is_bound(bound, bufs)
    _assert_same(free, bound)
    step(4)

    saved = (free.to("cpu"), bound.to("cpu"))
    step(5)
    free, bound = saved[0].to("cpu"), saved[1].to("cpu")   # the rollback
    assert bufs.bind(bound) and _is_bound(bound, bufs)
    _assert_same(free, bound)
    step(6)
    assert bufs.binds == 2          # the resize's buffers: bound twice


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    root = tmp_path_factory.mktemp("scene")
    write_split(str(root), "train", 6, 0.0, 32, "cpu")
    write_split(str(root), "test", 2, 0.13, 32, "cpu")
    return tscene.Scene.load(str(root), device="cpu", white_background=True,
                             eval_split=True, resolution=(32, 32))


def _stage_cfg(densify_until=1020, batch=1):
    cfg = _cfg(cap=2048)
    o = cfg.opt
    o.batch_size = batch
    o.densify_from_iter = 4
    o.densification_interval = 10
    o.densify_until_iter = densify_until
    o.densify_grad_threshold_fine_init = 0.0
    o.densify_grad_threshold_after = 0.0
    o.densify_max_points = 1200
    o.pruning_from_iter = 4
    o.pruning_interval = 20
    o.prune_min_points = 50
    o.opacity_reset_interval = 990
    o.lambda_dssim = 0.2
    return cfg


def _run(cfg, scene, capture, nan_at=1005):
    """Iterations 971-1030 of a fine stage: densify doubles the count at
    980 and 990 (bucket changes), prunes at 980 and 1000, resets the
    opacity at 990, ramps the SH degree at 1000, stops the densify
    statistics at densify_until_iter (1020 by default), grows tile_cap
    from 64 at the guard's checks, and a NaN put into one parameter at
    `nan_at` rolls back at 1025."""
    dev = scene.train.cameras[0].time.device
    st = _state(cfg).to(dev)
    tx = optim.build_optimizer(cfg.opt, scene.cameras_extent)
    st.opt_state = tx.init(st.params)

    def poison(it, state, active_sh):
        if it == nan_at:
            with torch.no_grad():
                state.params["gauss"].features_dc[0, 0, 0] = float("nan")

    return loop.run_stage(
        cfg, st, "fine", 1030, scene.train.cameras, scene.train.images, tx,
        tconfig.raster_config_from(cfg, 32, 32), np.random.default_rng(1),
        generator=torch.Generator(dev).manual_seed(2), log_every=5,
        cameras_extent=scene.cameras_extent, on_iteration=poison,
        start_iteration=970, capture=capture)


@pytest.mark.parametrize("densify_until,batch", [(1020, 1), (1400, 1),
                                                 (1020, 2)],
                         ids=["statistics_stop", "bucket_ahead", "batch_two"])
def test_captured_stage_follows_the_eager_stage(scene, monkeypatch,
                                                densify_until, batch):
    """run_stage with the captured step, each step a replay on bound
    buffers, against the eager step: the same events, logged values and
    final state, bit for bit, through every surgery, bucket changes, the
    SH ramp, tile_cap growth and a rollback. Each change of key captures
    once, when its step comes: the densify statistics stop inside the run
    (statistics_stop) or go on past it (bucket_ahead: only the buckets,
    the caps and the ramp change the key); batch_two steps two cameras a
    step."""
    monkeypatch.setattr(graphs, "Program", ReplayEagerly)
    cfg = _stage_cfg(densify_until, batch)
    eager = _run(cfg, scene, capture=False)
    captured = _run(cfg, scene, capture=True)

    kinds = [e["kind"] for e in eager.events]
    for kind in ("densify", "prune", "reset_opacity", "resize", "rollback",
                 "tile_cap"):
        assert kind in kinds, kinds
    assert eager.active_sh == 1 and eager.graphs is None
    assert captured.events == eager.events
    assert captured.raster_cfg == eager.raster_cfg
    for a, b in zip(captured.history, eager.history, strict=True):
        np.testing.assert_equal(      # NaN equals NaN here
            {k: v for k, v in a.items() if k != "elapsed"},
            {k: v for k, v in b.items() if k != "elapsed"})
    _assert_same(captured.state, eager.state)

    rep = captured.graphs
    assert rep["replays"] == 60
    # the replay after each iteration that replaced state tensors (a
    # surgery or the rollback) copied them in, without a recapture
    replaced = {e["iter"] for e in eager.events if e["kind"] in (
        "densify", "prune", "resize", "rollback")} - {1030}
    assert rep["rebinds"] >= len(replaced)
    keys = [c["key"] for c in rep["captures"]]
    assert len(set(keys)) == len(keys)      # no key captured twice
    assert any("sh 1" in k for k in keys)
    assert any("stats off" in k for k in keys) == (densify_until == 1020)
    # each bucket the stage resized into was captured
    for cap in {e["capacity"] for e in eager.events if e["kind"] == "resize"}:
        assert any(f"capacity {cap} " in k for k in keys), (cap, keys)


def test_captured_frames_follow_eager_frames(scene, monkeypatch):
    """Renderer.render replaying its captured frame, one static camera
    refilled per frame, gives the eager frames; a new raster config
    captures anew, and only the newest frames are kept."""
    monkeypatch.setattr(graphs, "Program", ReplayEagerly)
    cfg = _cfg()
    st = _state(cfg)
    rend = Renderer(gauss=st.params["gauss"], alive=st.alive,
                    deform=st.params["deform"], aabb=st.aabb,
                    bg=torch.ones(3), sh_degree=1, device=torch.device("cpu"),
                    raster_cfg=tconfig.raster_config_from(cfg, 32, 32),
                    capture=True)
    eager = dataclasses.replace(rend, capture=None)
    assert rend.captures() and not eager.captures()
    cams = [look_at_camera(theta=0.4 * i, time=i / 4, device="cpu")
            for i in range(4)]
    outs = [rend.render(c) for c in cams]
    (frame,) = rend.frames.values()
    assert frame.program.replays == 4
    for c, got in zip(cams, outs):
        want = eager.render(c)
        for f in want._fields:
            torch.testing.assert_close(getattr(got, f), getattr(want, f),
                                       rtol=0, atol=0, msg=f)
    assert not torch.equal(outs[0].color, outs[-1].color)
    for cap in (128, 256):
        rend.raster_cfg = dataclasses.replace(rend.raster_cfg, tile_cap=cap)
        rend.render(cams[0])
    assert len(rend.frames) == 2


def test_a_capture_that_cannot_succeed_raises(scene):
    """Asking for capture where there is no card raises; nothing falls
    back to the eager path."""
    cfg = _cfg()
    st = _state(cfg)
    rend = Renderer(gauss=st.params["gauss"], alive=st.alive,
                    deform=st.params["deform"], aabb=st.aabb,
                    bg=torch.ones(3), sh_degree=1, device=torch.device("cpu"),
                    raster_cfg=tconfig.raster_config_from(cfg, 32, 32),
                    capture=True)
    with pytest.raises(RuntimeError, match="CUDA"):
        rend.render(look_at_camera(device="cpu"))
    with pytest.raises(RuntimeError, match="CUDA"):
        _run(_stage_cfg(), scene, capture=True)
