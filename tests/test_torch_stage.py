"""Port parity for the stage driver (train/loop.py `run_stage`), the
training checkpoints (train/checkpoint.py) and the training CLI
(tools/train.py), on the synthetic ball scene at 32px (tools/make_synthetic_scene.py).

  * A tiny fine stage (20 iterations) runs in both packages from one state
    and one batch order. percent_dense is large, so every densify is a
    clone and no random draw enters; the live counts at every iteration
    (after each surgery) are equal, and the logged losses agree to 1e-3
    relative. One step agrees to 1e-5 (tests/test_torch_train.py); over 20
    steps Adam's division by sqrt(nu) turns the round-off of near-zero
    gradients into steps of up to lr either way, and the drift reaches a
    few 1e-4 by iteration 20.
  * Each package loads the other's checkpoint leaf for leaf.
  * The CLI trains both stages on the CPU, writes snapshots, checkpoints
    and its log, and resumes from its own checkpoint and from one the JAX
    package wrote; its eval logs the caps of the render it kept.
"""
import json
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fourdgs_tpu.data import scene as jscene
from fourdgs_tpu.render import state_at_time as jstate_at_time
from fourdgs_tpu.train import checkpoint as jckpt
from fourdgs_tpu.train import config as jconfig
from fourdgs_tpu.train import loop as jloop
from fourdgs_tpu.train import optim as joptim
from fourdgs_tpu.train import sampler as jsampler
from fourdgs_tpu.train import state as jstate
from fourdgs_tpu_torch import convert
from fourdgs_tpu_torch.data import scene as tscene
from fourdgs_tpu_torch.ops.rasterize_tiled import RasterConfig
from fourdgs_tpu_torch.render import state_at_time as tstate_at_time
from fourdgs_tpu_torch.tools import train as ttrain
from fourdgs_tpu_torch.tools.make_synthetic_scene import write_split
from fourdgs_tpu_torch.train import checkpoint as tckpt
from fourdgs_tpu_torch.train import config as tconfig
from fourdgs_tpu_torch.train import loop as tloop
from fourdgs_tpu_torch.train import optim as toptim
from fourdgs_tpu_torch.train import sampler as tsampler
from tests.test_torch_train import _port_cfg, _port_state
from tests.test_train import tiny_config

torch.set_num_threads(1)

N_POINTS = 200
ITERS = 20
LOSS_RTOL = 1e-3


def _stage_cfg():
    cfg = tiny_config(cap=4096)
    cfg.raster.min_bucket = 1024
    cfg.raster.tile_cap = 1024
    cfg.raster.prewarm = False
    o = cfg.opt
    o.iterations = ITERS
    o.densify_from_iter = 4
    o.densification_interval = 5
    o.pruning_from_iter = 4
    o.pruning_interval = 10
    o.prune_min_points = 50
    o.opacity_reset_interval = 15
    o.percent_dense = 100.0          # every candidate clones: no draws
    return cfg


@pytest.fixture(scope="module")
def fixture_scene(tmp_path_factory):
    """The synthetic ball scene (tools/make_synthetic_scene.py) at 32px:
    6 train and 2 test views."""
    root = tmp_path_factory.mktemp("scene")
    write_split(str(root), "train", 6, 0.0, 32, "cpu")
    write_split(str(root), "test", 2, 0.13, 32, "cpu")
    return root


def _initial_state(cfg, scene):
    pcd = scene.info.point_cloud
    st = jstate.create_state(jax.random.key(0), cfg, pcd.points[:N_POINTS],
                             pcd.colors[:N_POINTS], scene.cameras_extent,
                             aabb=scene.aabb)
    return jloop.compact_and_resize(st, jloop.pick_bucket(
        N_POINTS, cfg.raster.capacity, cfg.raster.min_bucket,
        cfg.raster.bucket_headroom))


def test_run_stage_matches_jax(fixture_scene):
    cfg = _stage_cfg()
    pcfg = _port_cfg(cfg)
    kw = dict(white_background=True, eval_split=True, resolution=(32, 32))
    js = jscene.Scene.load(str(fixture_scene), **kw)
    ts = tscene.Scene.load(str(fixture_scene), device="cpu", **kw)
    st = _initial_state(cfg, js)
    port = _port_state(st, cfg)
    extent = js.cameras_extent
    tx_j = joptim.build_optimizer(cfg.opt, extent, st.params)
    st = st._replace(opt_state=tx_j.init(st.params))
    tx_t = toptim.build_optimizer(pcfg.opt, extent)
    port.opt_state = tx_t.init(port.params)

    counts = {"jax": [], "port": []}

    def count(name):
        def on_iteration(it, state, active_sh):
            counts[name].append(int(np.asarray(state.alive).sum()))
        return on_iteration

    common = dict(log_every=5, cameras_extent=extent)
    jres = jloop.run_stage(
        cfg, st, "fine", ITERS, js.train.cameras, js.train.images, tx_j,
        jloop.raster_config_from(cfg, 32, 32), np.random.default_rng(1),
        jax.random.key(2), on_iteration=count("jax"), **common)
    tres = tloop.run_stage(
        pcfg, port, "fine", ITERS, ts.train.cameras, ts.train.images, tx_t,
        tconfig.raster_config_from(pcfg, 32, 32), np.random.default_rng(1),
        on_iteration=count("port"), **common)

    assert counts["port"] == counts["jax"]
    jcount = int(np.asarray(jres.state.alive).sum())
    assert int(tres.state.alive.sum()) == jcount
    kinds = [e["kind"] for e in tres.events]
    for kind in ("densify", "prune", "reset_opacity", "resize"):
        assert kind in kinds, kinds
    assert counts["port"][-1] > N_POINTS       # the clones grew the set
    assert tres.state.capacity == jres.state.capacity > 1024
    # the count after each iteration's last surgery is the one the JAX
    # stage entered the next iteration with
    after = {e["iter"]: e["points"] for e in tres.events}
    for it, points in after.items():
        assert points == (counts["jax"][it] if it < ITERS else jcount), it
    assert [h["iter"] for h in tres.history] == \
        [h["iter"] for h in jres.history]
    for a, b in zip(tres.history, jres.history):
        assert a["points"] == b["points"] and a["capacity"] == b["capacity"]
        np.testing.assert_allclose(a["loss"], b["loss"], rtol=LOSS_RTOL,
                                   err_msg=f"iteration {a['iter']}")
    assert tres.history[-1]["loss"] < tres.history[0]["loss"]


def _small_state(cfg):
    rng = np.random.default_rng(4)
    pts = rng.uniform(-1, 1, (64, 3)).astype(np.float32)
    st = jstate.create_state(jax.random.key(4), cfg, pts, pts * 0.5 + 0.5,
                             1.0)
    noise = lambda x: jnp.asarray(rng.normal(size=np.shape(x)), jnp.float32)
    return st._replace(opt_state=jax.tree.map(
        lambda x: noise(x) if np.ndim(x) else x, st.opt_state),
        denom=noise(st.denom), step=jnp.int32(7))


def test_checkpoints_load_across_packages(tmp_path):
    """The port loads the JAX package's file and the JAX package loads the
    port's, every leaf equal, with iteration, stage and SH degree."""
    cfg = tiny_config(cap=256)
    st = _small_state(cfg)
    dcfg = tconfig.deform_config_from(_port_cfg(cfg))
    jpath = str(tmp_path / "chkpnt_fine_17.npz")
    jckpt.save_checkpoint(st, jpath, 17, "fine", 2)
    port, it, stage, sh = tckpt.load_checkpoint(jpath, dcfg, device="cpu")
    assert (it, stage, sh) == (17, "fine", 2)
    want = jckpt._flatten(st._asdict())
    got = convert.train_state_to_numpy(port)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)

    tpath = str(tmp_path / "chkpnt_coarse_9.npz")
    tckpt.save_checkpoint(port, tpath, 9, "coarse", 1)
    back, it, stage, sh = jckpt.load_checkpoint(tpath, st)
    assert (it, stage, sh) == (9, "coarse", 1)
    for k, v in jckpt._flatten(back._asdict()).items():
        np.testing.assert_array_equal(v, want[k], err_msg=k)


CLI_CONFIG = """
OptimizationParams = dict(iterations=16, coarse_iterations=8,
    densify_from_iter=3, densification_interval=4, pruning_from_iter=3,
    pruning_interval=4, prune_min_points=50, opacity_reset_interval=12)
ModelHiddenParams = dict(
    kplanes_config={'grid_dimensions': 2, 'input_coordinate_dim': 4,
                    'output_coordinate_dim': 8, 'resolution': [8, 8, 8, 4]},
    multires=[1, 2], defor_depth=0, net_width=32)
RasterParams = dict(capacity=8192, tile_size=16, tile_cap=256, chunk=8)
"""


def _cli(scene, out, *extra):
    return ttrain.main([
        "-s", str(scene), "-m", str(out), "--configs",
        str(scene / "cli.py"), "--device", "cpu", "--image_size", "32", "32",
        "--quiet", *extra])


def test_train_cli_trains_saves_and_resumes(fixture_scene, tmp_path):
    (fixture_scene / "cli.py").write_text(CLI_CONFIG)
    out = tmp_path / "model"
    summary = _cli(fixture_scene, out, "--test_iterations", "8", "16",
                   "--save_iterations", "16", "--checkpoint_iterations", "8",
                   "12")
    assert [s["stage"] for s in summary["stages"]] == ["coarse", "fine"]
    for s in summary["stages"]:
        kinds = {e["kind"] for e in s["events"]}
        assert {"densify", "prune"} <= kinds, kinds
        assert s["test_psnr"] and np.isfinite(s["test_psnr"][-1][1])
    for name in ("point_cloud/coarse_iteration_8/point_cloud.ply",
                 "point_cloud/iteration_16/deformation.npz",
                 "chkpnt_coarse_8.npz", "chkpnt_fine_12.npz",
                 "cfg_args.json"):
        assert (out / name).exists(), name
    with open(out / "train_log.jsonl") as f:
        records = [json.loads(line) for line in f]
    assert {r["stage"] for r in records} == {"coarse", "fine"}
    assert any(r.get("eval") == "test" for r in records)
    assert all(np.isfinite(r["loss"]) for r in records if "loss" in r)

    # resume the fine stage from its own checkpoint: iterations 13..16
    resumed = _cli(fixture_scene, tmp_path / "resumed", "--test_iterations",
                   "16", "--start_checkpoint",
                   str(out / "chkpnt_fine_12.npz"))
    (stage,) = resumed["stages"]
    assert stage["stage"] == "fine" and stage["start"] == 12
    assert stage["history"][-1]["iter"] == 16


@pytest.mark.parametrize("dropped_pairs,dropped_tile,caps", [
    (0, 0, [(64, 1024)]),                          # drop-free at once
    (3, 0, [(64, 1024), (64, 2048), (64, 4096), (64, 8192)]),
    (3, 500, [(64, 1024), (128, 2048), (256, 4096), (512, 8192)]),
    (0, 500, [(4096, 1024), (8192, 1024)])])       # tile_cap at its limit
def test_eval_render_logs_the_caps_it_rendered_at(monkeypatch, dropped_pairs,
                                                  dropped_tile, caps):
    """The train CLI's eval grows an overflowing view's caps and renders
    again, four renders at most; what it logs (`render_per_view`) are the
    drops and caps of the render whose color it returns, also when the
    last render still overflows."""
    seen = []

    def eval_step(state, cam, bg, *, stage, active_sh, raster_cfg):
        seen.append((raster_cfg.tile_cap, raster_cfg.bin_pairs_per_chunk))
        return types.SimpleNamespace(
            color=torch.full((1,), float(len(seen))),
            dropped_pairs=torch.tensor(dropped_pairs),
            dropped_tile=torch.tensor(dropped_tile),
            num_pairs=torch.tensor(20_000))

    monkeypatch.setattr(ttrain.loop, "eval_step", eval_step)
    rcfg = RasterConfig(img_width=32, img_height=32, tile_cap=caps[0][0],
                        bin_pairs_per_chunk=caps[0][1])
    color, drops = ttrain.eval_render(None, None, None, "fine", 0, rcfg)
    assert seen == caps
    assert float(color[0]) == len(caps)
    assert (drops["tile_cap"], drops["bin_pairs_per_chunk"]) == caps[-1]
    assert drops == {"dropped_pairs": dropped_pairs,
                     "dropped_tile": dropped_tile, "num_pairs": 20_000,
                     "tile_cap": caps[-1][0],
                     "bin_pairs_per_chunk": caps[-1][1]}


def test_train_cli_resumes_from_a_jax_checkpoint(fixture_scene, tmp_path):
    """A coarse checkpoint the JAX package wrote, resumed by the port's
    CLI through the rest of the coarse stage and the fine stage."""
    (fixture_scene / "cli.py").write_text(CLI_CONFIG)
    cfg = tconfig.apply_config_file(tconfig.Config(),
                                    str(fixture_scene / "cli.py"))
    jcfg = jconfig.apply_config_file(jconfig.Config(),
                                     str(fixture_scene / "cli.py"))
    js = jscene.Scene.load(str(fixture_scene), resolution=(32, 32))
    pcd = js.info.point_cloud
    st = jstate.create_state(jax.random.key(1), jcfg, pcd.points, pcd.colors,
                             js.cameras_extent, aabb=js.aabb)
    st = jloop.compact_and_resize(st, jloop.pick_bucket(
        len(pcd.points), cfg.raster.capacity))
    path = tmp_path / "chkpnt_coarse_5.npz"
    jckpt.save_checkpoint(st, str(path), 5, "coarse", 0)
    summary = _cli(fixture_scene, tmp_path / "out", "--test_iterations",
                   "16", "--start_checkpoint", str(path))
    assert [(s["stage"], s["start"]) for s in summary["stages"]] == [
        ("coarse", 5), ("fine", 0)]
    assert os.path.exists(tmp_path / "out/point_cloud/iteration_16")


def test_state_at_time_matches_jax():
    """The deformed raw parameters at a timestamp, 1e-5 relative (the
    deformation MLP's float32 sums, as in tests/test_torch_deformation.py)."""
    cfg = tiny_config(cap=256)
    st = _small_state(cfg)
    port = _port_state(st, cfg)
    g = st.params["gauss"]
    a = jstate_at_time.get_state_at_time(
        g, st.params["deform"], jstate.deform_config_from(cfg), st.aabb, 0.3)
    b = tstate_at_time.get_state_at_time(
        port.params["gauss"], port.params["deform"], port.aabb, 0.3)
    assert len(a) == len(b) == 5
    for x, y in zip(a, b):
        np.testing.assert_allclose(y.numpy(), np.asarray(x), rtol=1e-5,
                                   atol=1e-6)


@pytest.mark.parametrize("n_views,n_poses", [(24, 4), (30, 5)])
def test_samplers_match_jax(n_views, n_poses):
    a = jsampler.fine_sample_order(n_views, n_poses,
                                   np.random.default_rng(n_views))
    b = tsampler.fine_sample_order(n_views, n_poses,
                                   np.random.default_rng(n_views))
    np.testing.assert_array_equal(b, a)
    times = np.repeat(np.linspace(0, 1, n_poses), n_views // n_poses)
    for t in (None, times[-1]):
        np.testing.assert_array_equal(tsampler.stamp_indices(times, t),
                                      jsampler.stamp_indices(times, t))
