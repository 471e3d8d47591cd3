"""The suite launchers (fourdgs_tpu_torch/launchers/*.sh) and the suite
aggregate (fourdgs_tpu_torch/tools/read_all_metrics.py) against the JAX
package's (scripts/launchers/*.sh, scripts/read_all_metrics.py):

  * each of the six launchers of either package runs under bash with a
    stub `python` and `python3` first on PATH that appends its arguments
    to a file and exits 0, with the same DATA and OUT (and for
    dynamic3dgs, once more with CFG set); with `scripts/X.py` read as
    `-m fourdgs_tpu_torch.tools.X` and JAX's config files as the port's
    copies, the two command sequences are equal;
  * read_all_metrics prints what JAX's script prints on the same
    hand-written results.json files: a scene without the file, a scene
    without the chosen method, --method, and a root with no results.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
SUITES = ("dnerf", "dynerf", "dycheck", "dynamic3dgs", "hyper_interp",
          "hyper_virg")
SEP = "\x1f"
STUB = f"""#!/bin/bash
printf '%s{SEP}' "$(basename "$0")" "$@" >> "$STUB_LOG"
printf '\\n' >> "$STUB_LOG"
"""


def _commands(script: Path, tmp_path: Path, env_extra: dict) -> list:
    """The argument lists that `script` hands python, in order."""
    bin_dir = tmp_path / "bin"
    bin_dir.mkdir(exist_ok=True)
    for name in ("python", "python3"):
        stub = bin_dir / name
        stub.write_text(STUB)
        stub.chmod(0o755)
    log = tmp_path / f"{script.parent.parent.name}_{script.stem}.log"
    path = f"{bin_dir}{os.pathsep}{os.environ['PATH']}"
    env = {**os.environ, "PATH": path,
           "STUB_LOG": str(log), "DATA": str(tmp_path / "data"),
           "OUT": str(tmp_path / "out"), **env_extra}
    if "CFG" not in env_extra:
        env.pop("CFG", None)
    subprocess.run(["bash", str(script)], cwd=ROOT, env=env, check=True,
                   timeout=60)
    return [line.split(SEP)[:-1] for line in log.read_text().splitlines()]


def _as_module(argv: list) -> list:
    """JAX's `python scripts/X.py ...` as the port's
    `python3 -m fourdgs_tpu_torch.tools.X ...`, a config file of JAX's
    tree (`fourdgs_tpu/configs/Y`) as the port's copy
    (`fourdgs_tpu_torch/configs/Y`), which must exist."""
    prog, script, *rest = argv
    assert prog == "python" and script.startswith("scripts/"), argv
    name = Path(script).stem
    jax_tree, port_tree = "fourdgs_tpu/configs/", "fourdgs_tpu_torch/configs/"
    rest = [port_tree + a[len(jax_tree):] if a.startswith(jax_tree) else a
            for a in rest]
    assert all((ROOT / a).is_file() for a in rest
               if a.startswith(port_tree)), rest
    return ["python3", "-m", f"fourdgs_tpu_torch.tools.{name}", *rest]


@pytest.mark.parametrize("suite,env_extra", [
    *((s, {}) for s in SUITES), ("dynamic3dgs", {"CFG": "my/cfg.py"})],
    ids=[*SUITES, "dynamic3dgs-CFG"])
def test_launcher_issues_jax_commands(suite, env_extra, tmp_path):
    jax = _commands(ROOT / "scripts" / "launchers" / f"train_{suite}.sh",
                    tmp_path, env_extra)
    port = _commands(ROOT / "fourdgs_tpu_torch" / "launchers"
                     / f"train_{suite}.sh", tmp_path, env_extra)
    assert port == [_as_module(a) for a in jax]
    scenes = (len(jax) - 1) // 3
    assert scenes >= 4 and len(jax) == 3 * scenes + 1
    assert port[-1] == ["python3", "-m",
                        "fourdgs_tpu_torch.tools.read_all_metrics",
                        str(tmp_path / "out")]
    if env_extra:
        assert all("my/cfg.py" in a for a in port[0::3][:scenes])


def _write_results(root: Path) -> None:
    """Scenes: two methods; one method; no results.json; only an older
    method; metrics in the metrics CLI's keys."""
    def write(scene, results):
        (root / scene).mkdir(parents=True)
        with open(root / scene / "results.json", "w") as f:
            json.dump(results, f)

    write("bouncingballs", {
        "ours_14000": {"SSIM": 0.98123, "PSNR": 35.51234, "LPIPS": 0.0312,
                       "MS-SSIM": 0.9912, "D-SSIM": 0.0044},
        "ours_7000": {"SSIM": 0.97, "PSNR": 33.1, "LPIPS": 0.05,
                      "MS-SSIM": 0.98, "D-SSIM": 0.01}})
    write("hook", {"ours_14000": {"SSIM": 0.95071, "PSNR": 29.90871,
                                  "LPIPS": 0.0611, "MS-SSIM": 0.9723,
                                  "D-SSIM": 0.0139}})
    (root / "lego").mkdir()
    write("trex", {"ours_3000": {"SSIM": 0.9, "PSNR": 25.0, "LPIPS": 0.1,
                                 "MS-SSIM": 0.93, "D-SSIM": 0.035}})


@pytest.mark.parametrize("case", ["default", "ours_14000", "ours_7000",
                                  "missing", "empty"])
def test_read_all_metrics_prints_what_jax_prints(case, tmp_path):
    root = tmp_path / "out"
    root.mkdir()
    if case != "empty":
        _write_results(root)
    args = [str(root)]
    if case not in ("default", "empty"):
        args += ["--method", {"missing": "ours_20000"}.get(case, case)]
    jax = subprocess.run(
        [sys.executable, str(ROOT / "scripts" / "read_all_metrics.py"),
         *args], cwd=ROOT, capture_output=True, text=True, check=True,
        timeout=60).stdout
    port = subprocess.run(
        [sys.executable, "-m", "fourdgs_tpu_torch.tools.read_all_metrics",
         *args], cwd=ROOT, capture_output=True, text=True, check=True,
        timeout=60).stdout
    assert port == jax
    if case in ("missing", "empty"):
        assert port == "no results.json found\n"
    else:
        assert port.startswith("scenes (")
