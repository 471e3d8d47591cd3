"""The full quality run (tools/quality_run.py) on the CPU at a tiny size:
the multiview scene at 32px (3 cameras, 2 timestamps), the test config
of tests/test_torch_stage.py, both variants; and the monocular protocol
(4 + 2 spiral views, one variant) against the JAX package's monocular
record.
Each variant trains with its switches set and every other switch unset,
and the report holds each stage's timing, capture share and live counts,
the in-loop and post-hoc test PSNR, the render FPS, the per-view
comparison with the JAX package's record where it has one, and the
protocol's fault floor."""
import dataclasses
import json
import os
from pathlib import Path

import numpy as np
import torch

from fourdgs_tpu_torch.tools import quality_run
from fourdgs_tpu_torch.train import config as tconfig
from fourdgs_tpu_torch.train import graphs
from tests.test_torch_stage import CLI_CONFIG

torch.set_num_threads(1)


def test_quality_run_reports_both_variants(tmp_path, monkeypatch):
    config = tmp_path / "tiny.py"
    config.write_text(CLI_CONFIG)
    seen = []
    real_train = quality_run.train_cli.main

    def train(argv):
        seen.append({k: os.environ.get(k) for k in graphs.SWITCHES})
        return real_train(argv)

    monkeypatch.setattr(quality_run.train_cli, "main", train)
    monkeypatch.setenv("FOURDGS_HEX_BWD", "pallas")   # unset for default
    out = quality_run.main([
        "--out", str(tmp_path / "run"), "--size", "32", "--n_cams", "3",
        "--n_times", "2", "--configs", str(config), "--test_iterations",
        "16", "--device", "cpu"])
    assert seen == [{k: None for k in graphs.SWITCHES}, graphs.SWITCHES_ON]
    assert os.environ["FOURDGS_HEX_BWD"] == "pallas"   # restored
    with open(tmp_path / "run" / "quality_run.json") as f:
        assert json.load(f)["variants"].keys() == {"default", "switches"}
    assert out["card"] == "cpu" and out["reference"]["results"]
    for name, res in out["variants"].items():
        assert res["variant"] == name
        for stage, n in (("coarse", 8), ("fine", 16)):
            rep = res["stages"][stage]
            assert rep["iterations"] == n and rep["ms_per_iteration"] > 0
            assert rep["peak_points"] >= rep["points_last"] > 0
        assert res["in_loop_test_psnr"][0] == 16
        assert set(res["post_hoc"]) == {"PSNR", "SSIM", "MS-SSIM", "D-SSIM"}
        assert abs(res["post_hoc_minus_in_loop"]) <= 0.1
        assert res["render_views"] == {"train": 4, "test": 2, "video": 160}
        assert all(v > 0 for v in res["render_fps"].values())
        pv = res["per_view"]
        assert sorted(pv["psnr"]) == ["00000.png", "00001.png"]
        assert pv["views_compared"] == 2
        assert np.isfinite(pv["mean_diff"])


def test_quality_run_monocular_protocol(tmp_path, monkeypatch):
    """The monocular protocol: the scene maker's spiral split at its view
    counts, the JAX record's last in-loop eval as the reference (it holds
    no post-hoc files), each stage's capture share, the fault floor."""
    config = tmp_path / "tiny.py"
    config.write_text(CLI_CONFIG)
    made = []
    real_make = quality_run.make_synthetic_scene.main

    def make(argv):
        made.append(argv)
        return real_make(argv)

    monkeypatch.setattr(quality_run.make_synthetic_scene, "main", make)
    monkeypatch.setattr(quality_run, "VARIANTS", {"default": {}})
    out = quality_run.main([
        "--protocol", "monocular", "--out", str(tmp_path / "run"),
        "--size", "32", "--n_train", "4", "--n_test", "2", "--configs",
        str(config), "--test_iterations", "16", "--device", "cpu"])
    (argv,) = made
    assert argv[1:] == ["--protocol", "monocular", "--size", "32",
                        "--n_train", "4", "--n_test", "2", "--device", "cpu"]
    assert out["protocol"] == "monocular"
    assert (out["n_train"], out["n_test"]) == (4, 2) and "n_cams" not in out
    ref = out["reference"]
    assert ref["path"] == os.path.join("output", "synth_mono_r3")
    assert "results" not in ref
    assert ref["in_loop_test_psnr"][0] == 20000
    assert abs(ref["in_loop_test_psnr"][1] - 21.8087) < 1e-4
    (res,) = out["variants"].values()
    assert res["fault_floor_db"] == 21.3
    assert res["below_floor"] == (res["post_hoc"]["PSNR"] < 21.3)
    assert res["render_views"] == {"train": 4, "test": 2, "video": 160}
    assert "reference" not in res["per_view"]
    for rep in res["stages"].values():
        # the CPU runs eagerly: nothing is captured
        assert rep["captures"] == 0 and rep["capture_share"] == 0.0


def test_protocols_name_their_configs_and_records():
    for name, want in (("multiview", ("synth_mv.py", "synth_mv_r5c")),
                       ("monocular", ("synth_mono.py", "synth_mono_r3"))):
        p = quality_run.PROTOCOLS[name]
        assert os.path.basename(p["configs"]) == want[0]
        assert os.path.exists(p["configs"])
        # the port's own config files, not the JAX package's
        assert Path(p["configs"]).parent == tconfig.CONFIG_DIR / "dnerf"
        assert os.path.basename(p["reference"]) == want[1]
        assert quality_run.reference_record(p["reference"]) is not None


def test_quality_run_alternates_the_prewarmer(tmp_path, monkeypatch):
    """The prewarmer's off run is the protocol's config included by a
    two-line file that sets `prewarm=False`, given to --configs: it trains
    through a config that differs from the included one in `prewarm`
    alone, and the stage report carries the prewarm figures."""
    config = tmp_path / "tiny.py"
    config.write_text(CLI_CONFIG)
    off_path = tmp_path / "prewarm_off.py"
    off_path.write_text(f"_base_ = {str(config)!r}\n"
                        "RasterParams = dict(prewarm=False)\n")
    on = tconfig.apply_config_file(tconfig.Config(), str(config))
    off = tconfig.apply_config_file(tconfig.Config(), str(off_path))
    assert on.raster.prewarm and not off.raster.prewarm
    off.raster.prewarm = True
    assert dataclasses.asdict(off) == dataclasses.asdict(on)
    runs = []

    def run_variant(name, args, scene, dev):
        runs.append((name, args.configs))
        return {"variant": name}

    monkeypatch.setattr(quality_run, "run_variant", run_variant)
    quality_run.main([
        "--out", str(tmp_path / "run"), "--size", "32", "--n_cams", "3",
        "--n_times", "2", "--configs", str(off_path), "--device", "cpu"])
    assert runs == [(name, str(off_path)) for name in quality_run.VARIANTS]
    stage = {"iterations": 4, "start": 0, "wall_time": 1.0,
             "history": [{"points": 3, "capacity": 8}], "events": [],
             "raster_cfg": {"tile_cap": 16}, "peak_bytes": None,
             "test_psnr": [], "evals": [],
             "graphs": {"captures": [], "replays": 4, "prewarmed": 1,
                        "prewarms_used": 1, "prewarms_dropped": 0,
                        "prewarms_failed": 0, "prewarms_retried": 0,
                        "prewarms_dropped_for_memory": 0,
                        "prewarm_wait_s": 0.0, "prewarm_s": 0.5,
                        "close_wait_s": 0.0, "step_gaps": {}}}
    rep = quality_run.stage_report(stage)
    assert rep["prewarms_used"] == 1 and rep["prewarm_s"] == 0.5
    assert rep["prewarms_retried"] == 0 == rep["prewarms_dropped_for_memory"]
