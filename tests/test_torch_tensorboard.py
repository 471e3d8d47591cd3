"""TensorBoard in the train CLI (fourdgs_tpu_torch/tools/train.py) against
scripts/train.py's writer, on the CPU: the CLI trains the synthetic ball
scene at 32px (tests/test_torch_stage.py's scene and config, 8 coarse and
16 fine iterations) with one test iteration, 8, in each stage; the event
file is read back with tensorboard's event accumulator.

  * The tags are JAX's letter for letter: listed here, and read from the
    `add_scalar` and `add_histogram` calls of scripts/train.py (its
    "train_loss_patchestotal_loss" has no slash, as the reference's).
  * Each scalar equals its train_log.jsonl record as a float32 (the
    event file's type).
  * Each histogram holds as many values as there are alive slots at its
    evaluation (counted where the CLI writes it).
  * Without `torch.utils.tensorboard` the CLI writes no event file and
    says so.
The import of torch.utils.tensorboard takes about 12 s here, so the file
trains once.
"""
import json
import re
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from fourdgs_tpu_torch.tools import train as ttrain
from fourdgs_tpu_torch.tools.make_synthetic_scene import write_split
from tests.test_torch_stage import CLI_CONFIG

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
STAGES = ("coarse", "fine")
SCALAR_TAGS = ("train_loss_patches/l1_loss", "train_loss_patchestotal_loss",
               "total_points", "psnr")
EVAL_TAGS = ("test/loss_viewpoint - psnr", "train/loss_viewpoint - psnr")
HISTOGRAM_TAGS = ("scene/opacity_histogram", "scene/motion_histogram")
# the log record's key of each per-record scalar
RECORD_KEYS = dict(zip(SCALAR_TAGS, ("l1", "loss", "points", "psnr")))


def _jax_tags():
    """The tag suffixes of scripts/train.py's TensorBoard calls, each
    after its `{stage}/` or `{s}/` prefix."""
    src = (ROOT / "scripts" / "train.py").read_text()
    calls = re.findall(r'tb\.add_(scalar|histogram)\(f"\{(?:s|stage)\}/'
                       r'([^"]*)"', src)
    return ({t for kind, t in calls if kind == "scalar"},
            {t for kind, t in calls if kind == "histogram"})


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    root = tmp_path_factory.mktemp("tb")
    scene = root / "scene"
    write_split(str(scene), "train", 6, 0.0, 32, "cpu")
    write_split(str(scene), "test", 2, 0.13, 32, "cpu")
    (root / "cli.py").write_text(CLI_CONFIG)
    model = root / "model"
    alive = {}
    real = ttrain.write_eval_summaries

    def counting(tb, stage, it, state, *psnrs):
        alive[stage, it] = int(state.alive.sum())
        return real(tb, stage, it, state, *psnrs)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ttrain, "write_eval_summaries", counting)
        ttrain.main([
            "-s", str(scene), "-m", str(model), "--configs",
            str(root / "cli.py"),
            "--device", "cpu", "--image_size", "32", "32", "--quiet",
            "--test_iterations", "8"])
    from tensorboard.backend.event_processing import event_accumulator
    acc = event_accumulator.EventAccumulator(
        str(model), size_guidance={event_accumulator.SCALARS: 0,
                                   event_accumulator.HISTOGRAMS: 0})
    acc.Reload()
    with open(model / "train_log.jsonl") as f:
        records = [json.loads(line) for line in f]
    return alive, acc, records


def test_tags_are_jax_letter_for_letter(run):
    _, acc, _ = run
    scalars, histograms = _jax_tags()
    assert scalars == set(SCALAR_TAGS + EVAL_TAGS)
    assert histograms == set(HISTOGRAM_TAGS)
    tags = acc.Tags()
    assert set(tags["scalars"]) == {f"{s}/{t}" for s in STAGES
                                    for t in SCALAR_TAGS + EVAL_TAGS}
    assert set(tags["histograms"]) == {f"{s}/{t}" for s in STAGES
                                       for t in HISTOGRAM_TAGS}
    assert "coarse/train_loss_patchestotal_loss" in tags["scalars"]


def test_scalars_equal_the_log_records(run):
    _, acc, records = run
    for stage in STAGES:
        logged = [r for r in records
                  if r["stage"] == stage and "eval" not in r]
        evals = [r for r in records if r["stage"] == stage
                 and r.get("eval") == "test"]
        assert logged and len(evals) == 1
        for tag, key in RECORD_KEYS.items():
            events = acc.Scalars(f"{stage}/{tag}")
            assert [e.step for e in events] == [r["iter"] for r in logged]
            np.testing.assert_array_equal(
                np.float32([e.value for e in events]),
                np.float32([r[key] for r in logged]), err_msg=tag)
        for tag, key in zip(EVAL_TAGS, ("psnr", "train_probe_psnr")):
            (event,) = acc.Scalars(f"{stage}/{tag}")
            assert event.step == evals[0]["iter"] == 8
            assert event.value == np.float32(evals[0][key]), tag


def test_histograms_count_the_alive_slots(run):
    alive, acc, _ = run
    assert sorted(alive) == [("coarse", 8), ("fine", 8)]
    for stage in STAGES:
        for tag in HISTOGRAM_TAGS:
            (event,) = acc.Histograms(f"{stage}/{tag}")
            assert event.step == 8
            assert event.histogram_value.num == alive[stage, 8] > 0, tag
        (op,) = acc.Histograms(f"{stage}/scene/opacity_histogram")
        assert 0.0 < op.histogram_value.min <= op.histogram_value.max < 1.0


def test_cli_says_when_the_writer_is_off(tmp_path, monkeypatch, capsys):
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    assert ttrain.open_writer(str(tmp_path)) is None
    assert "TensorBoard: off" in capsys.readouterr().out
    assert not list(tmp_path.iterdir())


def test_cli_says_when_the_writer_is_on(run, tmp_path, capsys):
    """The writer prints its path and the seconds its import and opening
    took."""
    tb = ttrain.open_writer(str(tmp_path))
    tb.close()
    out = capsys.readouterr().out
    assert re.search(rf"TensorBoard: writing to {re.escape(str(tmp_path))} "
                     r"\(opened in \d+\.\d{3} s\)", out), out
