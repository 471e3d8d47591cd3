"""The serving bench (fourdgs_tpu_torch/tools/bench_fps.py) against
scripts/bench_fps.py on the CPU at a small point (2,000 points, 64x64,
tile_cap 128):

  * a JAX state built as the script builds it (`_synthetic_scene`,
    `create_state` at key 0, `compact_and_resize` to the next power of two,
    every opacity logit 2.197), converted with convert.py, rendered by the
    bench's frame (`bench_renderer`, the look-at camera at t) and by JAX's
    fine render at three timestamps: color within 1e-5, depth within 1e-4,
    the drop counters equal (the tile cap drops at this point);
  * the bench's `main` with --device cpu at BENCH_FRAMES=2 prints one JSON
    line with exactly the script's keys (listed here, and read from the
    script's source);
  * on the captured path (`run` under a `graphs.Program` stand-in that
    replays eagerly, `Renderer.captures` patched on), one capture,
    1 + 2 x frames replays, and the first frame equal to an eager frame
    bit for bit.
The card's numbers come from chip_smoke.py's phase 19.
"""
import ast
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from __graft_entry__ import _look_at_camera, _synthetic_scene
from fourdgs_tpu.render.render import render as jax_render
from fourdgs_tpu.train import checkpoint as jckpt
from fourdgs_tpu.train import loop as jloop
from fourdgs_tpu.train import state as jstate
from fourdgs_tpu.train.config import Config, RasterParams
from fourdgs_tpu_torch import convert
from fourdgs_tpu_torch.data.camera import look_at_camera
from fourdgs_tpu_torch.render.serve import Renderer
from fourdgs_tpu_torch.tools import bench_fps
from fourdgs_tpu_torch.train import config as tconfig
from fourdgs_tpu_torch.train import graphs, loop
from tests.test_torch_graphs import ReplayEagerly

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
POINTS, SIZE, TILE_CAP = 2000, 64, 128
TIMES = (0.0, 0.37, 1.0)
TOL_COLOR, TOL_DEPTH = 1e-5, 1e-4
KEYS = {"metric", "value", "unit", "vs_baseline", "detail"}
DETAIL_KEYS = {"frames", "seconds", "ms_per_frame", "points", "image",
               "max_dropped_pairs", "max_dropped_tile", "baseline_fps",
               "device"}


@pytest.fixture(scope="module")
def states():
    """JAX's state as scripts/bench_fps.py builds it, and the bench's
    renderer of the same state converted."""
    cap = 1 << (POINTS - 1).bit_length()
    cfg = Config()
    cfg.hidden.multires = [1, 2]
    cfg.hidden.defor_depth = 0
    cfg.hidden.net_width = 64
    cfg.raster = RasterParams(capacity=cap, tile_size=32, tile_cap=TILE_CAP,
                              pair_cap=1 << 21, chunk=32,
                              bin_pairs_per_chunk=18432)
    pts, cols = _synthetic_scene(POINTS)
    st = jstate.create_state(jax.random.key(0), cfg, pts, cols,
                             spatial_lr_scale=1.0)
    st = jloop.compact_and_resize(st, cap)
    gauss = st.params["gauss"]._replace(
        opacity=jnp.full_like(st.params["gauss"].opacity, 2.197))
    tcfg = bench_fps.bench_config(POINTS, TILE_CAP)
    assert tcfg.raster.capacity == cap
    port = convert.train_state_from_numpy(
        jckpt._flatten(st._asdict()), tconfig.deform_config_from(tcfg),
        device="cpu")
    renderer = bench_fps.bench_renderer(tcfg, port, SIZE,
                                        torch.device("cpu"))
    return cfg, st, gauss, renderer


@pytest.mark.parametrize("t", TIMES)
def test_bench_frame_matches_jax(states, t):
    cfg, st, gauss, renderer = states
    cam = _look_at_camera()._replace(time=jnp.float32(t))
    want = jax_render(gauss, st.params["deform"], cam, jnp.zeros(3),
                      jloop.raster_config_from(cfg, SIZE, SIZE),
                      jstate.deform_config_from(cfg), st.aabb, st.alive, 3,
                      stage="fine")
    got = renderer.render(look_at_camera(time=t, device="cpu"))
    assert float(got.alpha.mean()) > 0.05             # a real image
    np.testing.assert_allclose(got.color.numpy(), np.asarray(want.color),
                               rtol=0, atol=TOL_COLOR)
    np.testing.assert_allclose(got.depth.numpy(), np.asarray(want.depth),
                               rtol=0, atol=TOL_DEPTH)
    for f in ("dropped_pairs", "dropped_tile", "num_pairs"):
        assert int(getattr(got, f)) == int(getattr(want, f)), f
    assert int(want.dropped_tile) > 0                 # the counters move


def _script_keys():
    """The keys of the JSON object that scripts/bench_fps.py prints, and of
    its `detail`."""
    tree = ast.parse((ROOT / "scripts" / "bench_fps.py").read_text())
    dicts = [n for n in ast.walk(tree) if isinstance(n, ast.Dict)
             and any(isinstance(k, ast.Constant) and k.value == "metric"
                     for k in n.keys)]
    (top,) = dicts
    detail = top.values[[k.value for k in top.keys].index("detail")]
    return ({k.value for k in top.keys}, {k.value for k in detail.keys})


def test_main_prints_the_scripts_keys(monkeypatch, capsys):
    for name, value in (("BENCH_POINTS", 300), ("BENCH_SIZE", 32),
                        ("BENCH_FRAMES", 2), ("BENCH_TILE_CAP", 64)):
        monkeypatch.setenv(name, str(value))
    out = bench_fps.main(["--device", "cpu"])
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert json.loads(line) == out
    assert (KEYS, DETAIL_KEYS) == _script_keys()
    assert set(out) == KEYS and set(out["detail"]) == DETAIL_KEYS
    d = out["detail"]
    assert out["metric"] == "render_fps_fine" and out["unit"] == "fps"
    assert (d["frames"], d["points"], d["image"]) == (2, 300, 32)
    assert d["baseline_fps"] == 82.0 and d["device"] == "cpu"
    assert out["value"] > 0 and d["seconds"] > 0
    # both rounded from the unrounded FPS, as the script rounds them
    assert abs(out["vs_baseline"] - out["value"] / 82.0) <= 1e-4
    assert isinstance(d["max_dropped_pairs"], int)
    assert isinstance(d["max_dropped_tile"], int)


def test_capacity_rule_meets_pick_bucket_at_the_bench_point():
    """The script's next power of two, and tools/bench.py's pick_bucket at
    headroom 1, both 131,072 at 100k points."""
    cfg = bench_fps.bench_config(100_000)
    r = cfg.raster
    assert r.capacity == 131_072 == loop.pick_bucket(100_000, 1 << 22,
                                                     headroom=1.0)
    assert (r.tile_size, r.tile_cap, r.pair_cap, r.chunk,
            r.bin_pairs_per_chunk) == (32, 512, 1 << 21, 32, 18432)
    assert cfg.hidden.multires == [1, 2] and cfg.hidden.net_width == 64
    assert cfg.hidden.defor_depth == 0


def test_captured_path_replays_every_frame(monkeypatch):
    """The card's path on the CPU: one capture, then every frame of both
    passes a replay, the first equal to an eager frame bit for bit."""
    monkeypatch.setattr(graphs, "Program", ReplayEagerly)
    monkeypatch.setattr(Renderer, "captures", lambda self: True)
    frames = 3
    _, renderer, cams, first = bench_fps.run(300, 32, frames, 64,
                                             device="cpu")
    assert renderer.captured == 1 and renderer.replayed == 1 + 2 * frames
    (frame,) = renderer.frames.values()
    assert frame.program.replays == 1 + 2 * frames
    eager = renderer.render_eager(cams[0])
    for f in ("color", "depth", "alpha"):
        assert torch.equal(getattr(first, f), getattr(eager, f)), f
