"""The train CLI's test evaluation as captured programs
(fourdgs_tpu_torch/train/graphs.py:EvalPrograms, through
tools/train.py:eval_output), on the CPU.

`ReplayEagerly` (tests/test_torch_graphs.py) stands in for
`graphs.Program`: the warm-up runs, the capture runs nothing, and each
replay runs the render on the program's buffers, so the keys, the state
copied in and the camera copied in run as they do on the card.

Against JAX's `eval_step` on one state (tests/test_torch_train.py's
noisy JAX state, converted by `convert.train_state_from_numpy`), both
routes of `eval_output` (eager, and replays of the evaluation programs)
at the run's caps and from caps so small that the view doubles tile_cap
until it fits: color within 1e-5, depth within 1e-4, the drop counters and
the caps equal. The train CLI with its evaluations captured against the
same run evaluated eagerly: the same PSNRs and drops. Then the
programs' key logic: two evaluations at one key
capture once, equal to the eager renders bit for bit, also after a
surgery replaced the state's tensors; a doubled cap or another capacity
captures anew; the `held` frames used last are kept. The card's graphs
are held against the eager renders by tests/test_torch_graphs_gpu.py.
"""
import dataclasses
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fourdgs_tpu.data import camera as jcam
from fourdgs_tpu.train import loop as jloop
from fourdgs_tpu.train import state as jstate
from fourdgs_tpu_torch.data import camera as tcam
from fourdgs_tpu_torch.tools import train as ttrain
from fourdgs_tpu_torch.tools.make_synthetic_scene import write_split
from fourdgs_tpu_torch.train import config as tconfig
from fourdgs_tpu_torch.train import graphs
from fourdgs_tpu_torch.train import loop as tloop
from tests.test_torch_graphs import ReplayEagerly
from tests.test_torch_stage import CLI_CONFIG
from tests.test_torch_train import (_look_at, _noisy_jax_state, _port_cfg,
                                    _port_state)
from tests.test_train import tiny_config

torch.set_num_threads(1)

IMG = 64
SH = 1
TOL = {"color": 1e-5, "depth": 1e-4}
COUNTERS = ("dropped_pairs", "dropped_tile", "num_pairs")
VIEWS = ((0.0, 0.3), (0.5, 1.1), (1.0, -0.6))   # (time, theta)
BG = np.array([1.0, 1.0, 1.0], np.float32)


@pytest.fixture(scope="module")
def states():
    cfg = tiny_config(cap=256)
    st = _noisy_jax_state(cfg)
    return cfg, st, _port_state(st, cfg)


def _tcam(t, theta):
    return _look_at(lambda *a, **k: tcam.make_camera(*a, device="cpu", **k),
                    t, theta)


def _programs(monkeypatch, state):
    monkeypatch.setattr(graphs, "Program", ReplayEagerly)
    programs = graphs.EvalPrograms()
    programs.load(state, torch.from_numpy(BG))
    return programs


@pytest.mark.parametrize("route", ["eager", "captured"])
@pytest.mark.parametrize("tile_cap", [256, 8], ids=["run_caps", "grown"])
def test_eval_route_matches_jax_eval_step(states, monkeypatch, route,
                                          tile_cap):
    cfg, st, port = states
    pcfg = _port_cfg(cfg)
    trc = dataclasses.replace(tconfig.raster_config_from(pcfg, IMG, IMG),
                              tile_cap=tile_cap)
    programs = _programs(monkeypatch, port) if route == "captured" else None
    grew = False
    for t, theta in VIEWS:
        out, drops = ttrain.eval_output(port, _tcam(t, theta),
                                        torch.from_numpy(BG), "fine", SH,
                                        trc, programs=programs)
        grew |= drops["tile_cap"] != tile_cap
        jrc = dataclasses.replace(
            jloop.raster_config_from(cfg, IMG, IMG),
            tile_cap=drops["tile_cap"],
            bin_pairs_per_chunk=drops["bin_pairs_per_chunk"])
        want = jloop.eval_step(st, _look_at(jcam.make_camera, t, theta),
                               jnp.asarray(BG), stage="fine", active_sh=SH,
                               raster_cfg=jrc,
                               deform_cfg=jstate.deform_config_from(cfg))
        assert float(out.alpha.mean()) > 0.05              # a real image
        for k, tol in TOL.items():
            np.testing.assert_allclose(getattr(out, k).numpy(),
                                       np.asarray(getattr(want, k)),
                                       rtol=0, atol=tol, err_msg=k)
        for k in COUNTERS:
            assert int(getattr(out, k)) == int(getattr(want, k)) \
                == drops[k], k
    assert grew == (tile_cap == 8)
    if programs is not None:
        rep = programs.report()
        assert rep["loads"] == 1 and rep["replays"] >= len(VIEWS)
        assert len(rep["captures"]) == (1 if tile_cap == 256 else
                                        len(programs.renderer.frames))


def _same(a, b):
    for f in a._fields:
        x, y = getattr(a, f), getattr(b, f)
        if isinstance(x, torch.Tensor):
            torch.testing.assert_close(x, y, rtol=0, atol=0, msg=f)


def _evaluate(programs, state, rc, stage="fine"):
    """One evaluation: the state loaded, each view a replay, against the
    eager eval_step of the same state, bit for bit."""
    bg = torch.from_numpy(BG)
    programs.load(state, bg)
    for t, theta in VIEWS:
        cam = _tcam(t, theta)
        _same(programs.render(cam, stage=stage, active_sh=SH, raster_cfg=rc),
              tloop.eval_step(state, cam, bg, stage=stage, active_sh=SH,
                              raster_cfg=rc))


def test_one_capture_a_key_across_evaluations(states, monkeypatch):
    cfg, _, port = states
    rc = tconfig.raster_config_from(_port_cfg(cfg), IMG, IMG)
    state = port.to("cpu")
    programs = _programs(monkeypatch, state)

    def captures():
        return len(programs.report()["captures"])

    _evaluate(programs, state, rc)
    _evaluate(programs, state, rc)
    assert captures() == 1
    # training moves the values in place, a surgery replaces the tensors:
    # both are copied in, and the frame replays
    with torch.no_grad():
        state.params["gauss"].opacity.add_(0.3)
        for p in state.params["deform"].parameters():
            p.mul_(1.1)
    state.params["gauss"] = dataclasses.replace(
        state.params["gauss"],
        xyz=state.params["gauss"].xyz.detach().clone() + 0.01)
    state.alive = state.alive.clone()
    state.alive[:5] = False
    _evaluate(programs, state, rc)
    assert captures() == 1
    assert programs.report()["loads"] == 4     # the first, then three
    # a doubled cap and another stage are keys of their own
    _evaluate(programs, state, dataclasses.replace(rc, tile_cap=512))
    _evaluate(programs, state, rc, stage="coarse")
    assert captures() == 3 and len(programs.renderer.frames) == 3
    _evaluate(programs, state, rc)
    assert captures() == 3
    # another capacity: new buffers, a new capture
    bigger = tloop.compact_and_resize(state.to("cpu"), 2 * state.capacity)
    _evaluate(programs, bigger, rc)
    assert captures() == 4 and len(programs.renderer.frames) == 1
    # the `held` frames used last are kept: the run's caps stay
    for cap in (8, 16, 32, 64, 128):
        _evaluate(programs, bigger, dataclasses.replace(rc, tile_cap=cap))
        _evaluate(programs, bigger, rc)
    assert len(programs.renderer.frames) == programs.held
    assert captures() == 9


def test_eval_programs_need_a_card(states):
    """Without a card the programs raise at the first render; nothing
    falls back to the eager path."""
    cfg, _, port = states
    programs = graphs.EvalPrograms()
    with pytest.raises(RuntimeError, match="before load"):
        programs.render(_tcam(0.0, 0.3), stage="fine", active_sh=SH,
                        raster_cfg=tconfig.raster_config_from(
                            _port_cfg(cfg), IMG, IMG))
    programs.load(port, torch.from_numpy(BG))
    with pytest.raises(RuntimeError, match="CUDA"):
        programs.render(_tcam(0.0, 0.3), stage="fine", active_sh=SH,
                        raster_cfg=tconfig.raster_config_from(
                            _port_cfg(cfg), IMG, IMG))


def _train(scene, out, *extra):
    return ttrain.main(["-s", str(scene), "-m", str(out), "--configs",
                        str(scene / "cli.py"), "--device", "cpu",
                        "--image_size", "32", "32", "--quiet",
                        "--test_iterations", "8", "16", *extra])


def _evals(out):
    with open(out / "train_log.jsonl") as f:
        return [r for r in map(json.loads, f) if r.get("eval") == "test"]


def test_train_cli_evaluates_through_the_programs(tmp_path, monkeypatch):
    """The train CLI with its evaluations captured (as on a single card;
    `captures_evals` patched, `ReplayEagerly` for the graphs) against the
    same run evaluated eagerly (the CPU's route): the same PSNRs and
    drops at every evaluation; the state loaded once an evaluation; a
    capture only where a key first came up, whose seconds each
    evaluation's record gives."""
    scene = tmp_path / "scene"
    write_split(str(scene), "train", 6, 0.0, 32, "cpu")
    write_split(str(scene), "test", 2, 0.13, 32, "cpu")
    (scene / "cli.py").write_text(CLI_CONFIG)
    eager = _train(scene, tmp_path / "eager")
    assert "eval_programs" not in eager
    monkeypatch.setattr(graphs, "Program", ReplayEagerly)
    monkeypatch.setattr(ttrain, "captures_evals", lambda dev, mesh: True)
    captured = _train(scene, tmp_path / "captured")
    want, got = _evals(tmp_path / "eager"), _evals(tmp_path / "captured")
    assert len(got) == len(want) == 3     # coarse 8, fine 8 and 16
    for a, b in zip(got, want, strict=True):
        for k in ("iter", "stage", "psnr", "psnr_per_view",
                  "train_probe_psnr", "render_per_view", "capacity"):
            assert a[k] == b[k], k
        assert b["eval_s"]["captures"] == 0 and b["eval_s"]["seconds"] > 0
    rep = captured["eval_programs"]
    assert rep["loads"] == 3
    assert rep["replays"] >= 3 * (2 + 5)      # the test and probe views
    keys = [c["key"] for c in rep["captures"]]
    assert len(keys) == sum(r["eval_s"]["captures"] for r in got) >= 2
    assert any("coarse" in k for k in keys) and any("fine" in k for k in keys)
    assert [e["captures"] for s in captured["stages"]
            for e in s["evals"]] == [r["eval_s"]["captures"] for r in got]


def test_train_cli_captures_evals_on_a_single_card():
    """The evaluations are captured on a single card and nowhere else;
    the train CLI has no option to render them eagerly there."""
    parser, _ = ttrain.build_parser()
    with pytest.raises(SystemExit):
        parser.parse_args(["-s", "x", "--eager_eval"])
    assert ttrain.captures_evals(torch.device("cuda"), None)
    assert not ttrain.captures_evals(torch.device("cuda"), object())
    assert not ttrain.captures_evals(torch.device("cpu"), None)
