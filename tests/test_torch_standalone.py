"""The port with the JAX package out of reach (utils/standalone.py), on the
CPU, where JAX and the JAX package are importable.

A fresh interpreter under the guard's audit hook, which refuses and
counts every open of a path under fourdgs_tpu/ and every import of jax,
jaxlib or the JAX package, runs the chain a user runs: the scene maker
(32 px, 4 + 2 views), the train CLI at tests/test_torch_stage.py's tiny
schedule from an include of the port's configs/dnerf/bouncingballs.py,
the render CLI and the metrics CLI. It must exit 0 with no refused event,
and the post-hoc PSNR must read the last in-loop eval within 0.1 dB.
chip_smoke.py's phase 22 runs the same guard on the card at the full
D-NeRF widths.

TensorFlow is hidden from that interpreter (a `tensorflow` package that
raises ImportError first on PYTHONPATH): torch.utils.tensorboard imports
it where it is installed, and TensorFlow's lite module tries `import jax`
(tensorflow/lite/python/util.py), which the guard would count. The card's
machine has tensorboard without TensorFlow, so this is the setup the port
runs in there; TensorBoard still writes, through its own stub of the TF
API.

The guard must also bite: the train CLI given the JAX package's
bouncingballs.py, runpy of a module of the JAX package, and runpy of
jax each exit nonzero with the refused event counted.
"""
import os
import subprocess

import pytest

from fourdgs_tpu_torch.train.config import CONFIG_DIR
from fourdgs_tpu_torch.utils import standalone
from tests.test_torch_stage import CLI_CONFIG

ROOT = CONFIG_DIR.parent.parent
JAX_BOUNCINGBALLS = ROOT / "fourdgs_tpu" / "configs" / "dnerf" / \
    "bouncingballs.py"
TRAIN, RENDER, METRICS = standalone.CHAIN


def _run(steps, tmp_path, sitecustomize=None):
    """The guarded program over `steps`, with TensorFlow hidden (and a
    `sitecustomize` module's source, if given, run at startup): its exit
    code, its output and its record."""
    hide = tmp_path / "hide" / "tensorflow"
    hide.mkdir(parents=True)
    (hide / "__init__.py").write_text(
        "raise ImportError('TensorFlow hidden from the standalone run')\n")
    if sitecustomize:
        (hide.parent / "sitecustomize.py").write_text(sitecustomize)
    path = [str(hide.parent)] + [p for p in [os.environ.get("PYTHONPATH")]
                                 if p]
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(path),
           "OMP_NUM_THREADS": "2"}
    proc = subprocess.run(standalone.command(ROOT, steps), cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=600)
    return proc, standalone.parse(proc.stdout)


def test_train_render_metrics_without_the_jax_package(tmp_path):
    scene, model = tmp_path / "scene", tmp_path / "model"
    config = tmp_path / "tiny.py"
    config.write_text(f"_base_ = "
                      f"{str(CONFIG_DIR / 'dnerf' / 'bouncingballs.py')!r}\n"
                      + CLI_CONFIG)
    cpu = ["--device", "cpu"]
    size = ["--image_size", "32", "32"]
    proc, rec = _run([
        ("fourdgs_tpu_torch.tools.make_synthetic_scene",
         [scene, "--size", "32", "--n_train", "4", "--n_test", "2", *cpu]),
        (TRAIN, ["-s", scene, "-m", model, "--configs", config, "--quiet",
                 "--test_iterations", "8", "16", *size, *cpu]),
        (RENDER, ["-m", model, "-s", scene, "--skip_video", *size, *cpu]),
        (METRICS, ["-m", model, *cpu])], tmp_path)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert (rec["refused"], rec["events"]) == (0, [])
    assert [s["module"] for s in rec["steps"]] == [
        "fourdgs_tpu_torch.tools.make_synthetic_scene", *standalone.CHAIN]
    fig = rec["figures"]
    assert set(fig["ms_per_iteration"]) == {"coarse", "fine"}
    assert fig["iteration"] == 16 and set(fig["fps"]) == {"train", "test"}
    assert abs(fig["post_hoc_test_psnr"] - fig["in_loop_test_psnr"]) <= 0.1
    # the CPU runs each kernel's plain version: no launch
    assert set(rec["kernel_runs"].values()) == {0}
    assert "TensorBoard: writing to" in proc.stdout


@pytest.mark.parametrize("case", ["jax_config", "jax_package", "jax",
                                  "preloaded"])
def test_the_guard_refuses(case, tmp_path):
    """The train CLI on JAX's bouncingballs.py (apply_config_file opens
    it), a module of the JAX package, jax, and the JAX package imported at
    startup before the hook (by a sitecustomize): each refused, counted,
    and the run exits nonzero."""
    steps, want = {
        "jax_config": ([(TRAIN, ["-s", tmp_path, "-m", tmp_path / "m",
                                 "--configs", JAX_BOUNCINGBALLS,
                                 "--device", "cpu"])],
                       ["open", str(JAX_BOUNCINGBALLS)]),
        "jax_package": ([("fourdgs_tpu.train.config", [])],
                        ["import", "fourdgs_tpu.train"]),
        "jax": ([("jax", [])], None),
        "preloaded": ([], ["imported before the hook", "fourdgs_tpu"]),
    }[case]
    proc, rec = _run(steps, tmp_path, sitecustomize=(
        f"import sys\nsys.path.insert(0, {str(ROOT)!r})\n"
        "import fourdgs_tpu\n") if case == "preloaded" else None)
    assert proc.returncode != 0
    assert rec["refused"] >= 1 and rec["steps"] == []
    if want:
        assert rec["events"][0] == want
    else:
        assert all(standalone.refused_module(name)
                   for event, name in rec["events"]), rec["events"]


@pytest.mark.parametrize("event,what,refused", [
    ("open", "fourdgs_tpu/configs/dnerf/bouncingballs.py", True),
    ("open", "fourdgs_tpu_torch/../fourdgs_tpu/train/config.py", True),
    ("open", "fourdgs_tpu", True),
    ("open", "fourdgs_tpu_torch/configs/dnerf/bouncingballs.py", False),
    ("open", "fourdgs_tpu_torchx/a.py", False),
    ("import", "jax", True),
    ("import", "jaxlib.xla_client", True),
    ("import", "fourdgs_tpu", True),
    ("import", "fourdgs_tpu.train.config", True),
    ("import", "fourdgs_tpu_torch.train.config", False),
    ("import", "jaxtyping", False),
])
def test_guard_compares_components(event, what, refused):
    """Paths by their resolved components and modules by their first
    dotted name: `fourdgs_tpu_torch` starts with `fourdgs_tpu` and passes.
    The hook is called directly (an audit hook, once added, stays)."""
    guard = standalone.Guard(str(ROOT))
    arg = str(ROOT / what) if event == "open" else what
    if refused:
        error = PermissionError if event == "open" else ModuleNotFoundError
        with pytest.raises(error):
            guard(event, (arg, "r", 0))
        assert guard.events == [[event, arg]]
    else:
        guard(event, (arg, "r", 0))
        assert guard.events == []
    assert guard.count == refused
