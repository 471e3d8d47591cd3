"""The train and render CLIs over a mesh, on the CPU: `python -m
torch.distributed.run --standalone --nproc_per_node 2` runs
tools/train.py with `--distributed --mesh 1,2` (two gloo ranks, the
tile-sharded step) on the 32px synthetic scene and
tests/test_torch_stage.py's tiny schedule (densify, prune, an opacity
reset, tile_cap growth, test evaluations, a checkpoint), then
tools/render.py with `--mesh 1,2`. The run must end with the ranks' states
equal (the digests the CLI gathers), rank 0 alone must write, and the test
PNGs' PSNR must read the last in-loop evaluation within 0.1 dB
(chip_smoke.py's RENDER_PSNR_TOL: 8-bit quantisation)."""
from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np

from fourdgs_tpu_torch.data.png import read_png
from fourdgs_tpu_torch.tools.make_synthetic_scene import main as make_scene
from tests.test_torch_stage import CLI_CONFIG

ROOT = Path(__file__).resolve().parent.parent
RENDER_PSNR_TOL = 0.1


def _torchrun(module: str, *args) -> str:
    env = {**os.environ, "OMP_NUM_THREADS": "1"}
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc_per_node", "2", "-m", module, *args],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    return proc.stdout


def _png_psnr(split_dir: Path) -> float:
    out = []
    for f in sorted((split_dir / "renders").glob("*.png")):
        a = read_png(f).astype(np.float64) / 255.0
        b = read_png(split_dir / "gt" / f.name).astype(np.float64) / 255.0
        out.append(-10.0 * np.log10(((a - b) ** 2).mean()))
    return float(np.mean(out))


def test_train_and_render_clis_over_a_mesh(tmp_path):
    scene = tmp_path / "scene"
    make_scene([str(scene), "--size", "32", "--n_train", "6", "--n_test",
                "2", "--device", "cpu"])
    (tmp_path / "tiny.py").write_text(CLI_CONFIG)
    model = tmp_path / "model"
    out = _torchrun("fourdgs_tpu_torch.tools.train", "-s", str(scene), "-m",
                    str(model), "--configs", str(tmp_path / "tiny.py"),
                    "--device", "cpu", "--image_size", "32", "32",
                    "--test_iterations", "8", "16",
                    "--checkpoint_iterations", "12", "--distributed",
                    "--mesh", "1,2")
    assert out.count("training on mesh data=1 tile=2") == 1, out
    assert "mesh ranks' final states equal: True" in out, out
    with open(model / "train_log.jsonl") as f:
        records = [json.loads(line) for line in f]
    kinds = {r["stage"] for r in records if "stage" in r}
    assert kinds == {"coarse", "fine"}
    # rank 0 alone logs: one record an iteration logged, one an eval
    evals = [r for r in records if r.get("eval") == "test"]
    assert [(r["stage"], r["iter"]) for r in evals] == [
        ("coarse", 8), ("fine", 8), ("fine", 16)]
    assert records[-1]["mesh"]["ranks_equal"] is True
    for name in ("chkpnt_fine_12.npz", "point_cloud/iteration_16",
                 "cfg_args.json"):
        assert (model / name).exists(), name

    out = _torchrun("fourdgs_tpu_torch.tools.render", "-m", str(model),
                    "-s", str(scene), "--image_size", "32", "32",
                    "--device", "cpu", "--mesh", "1,2", "--skip_video")
    assert out.count("rendering on mesh data=1 tile=2") == 1, out
    split = model / "test" / "ours_16"
    assert len(list((split / "renders").glob("*.png"))) == 2
    assert abs(_png_psnr(split) - evals[-1]["psnr"]) <= RENDER_PSNR_TOL
