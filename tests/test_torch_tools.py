"""Port parity for the per-frame export and the model merge:
tools/export_perframe.py against scripts/export_perframe_3DGS.py and
tools/merge_many.py against scripts/merge_many_4dgs.py, each JAX script
run in-process (its `main` under a patched argv), on tiny snapshots that
the port writes (random gaussians around the origin and a random
deformation field at the test config's widths).

  * The export's PLYs at --n_frames 3 equal the script's within 1e-5.
  * The merge of two models (offsets, a scale) over two video frames of
    a 32px scene: each PNG within 1 level on at least 99.9 % of its
    values; the mp4 line as the script prints it without imageio.
"""
import importlib.util
import os
import sys

import numpy as np
import pytest
import torch

from fourdgs_tpu_torch.data import ply
from fourdgs_tpu_torch.data.png import read_png
from fourdgs_tpu_torch.models.deformation import Deformation
from fourdgs_tpu_torch.models.gaussians import GaussianParams
from fourdgs_tpu_torch.tools import export_perframe, merge_many
from fourdgs_tpu_torch.tools.make_synthetic_scene import write_split
from fourdgs_tpu_torch.train import checkpoint
from fourdgs_tpu_torch.train import config as tconfig
from tests.test_torch_stage import CLI_CONFIG

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZE = 32
N = 300


def _script(name):
    spec = importlib.util.spec_from_file_location(
        f"_script_{name}", os.path.join(REPO, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def write_snapshot(model, config_path, seed, iteration=16):
    """A snapshot of N random gaussians and a random deformation field
    (its planes perturbed, so that time matters), with cfg_args.json."""
    cfg = tconfig.apply_config_file(tconfig.Config(), str(config_path))
    tconfig.save_cfg(cfg, str(model / "cfg_args.json"))
    deform = Deformation(tconfig.deform_config_from(cfg),
                         generator=torch.Generator().manual_seed(seed))
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for p in deform.grid.planes.values():
            p.add_(torch.from_numpy(
                rng.normal(0, 0.3, p.shape).astype(np.float32)))

    def f32(x):
        return torch.from_numpy(np.asarray(x, np.float32))

    gauss = GaussianParams(
        xyz=f32(rng.uniform(-0.8, 0.8, (N, 3))),
        features_dc=f32(rng.normal(0, 0.5, (N, 1, 3))),
        features_rest=f32(rng.normal(0, 0.1, (N, 15, 3))),
        scaling=f32(np.log(rng.uniform(0.03, 0.1, (N, 3)))),
        rotation=f32(rng.normal(size=(N, 4))),
        opacity=f32(rng.normal(0.5, 1.0, (N, 1))))
    aabb = np.array([[1.0] * 3, [-1.0] * 3], np.float32)
    checkpoint.save_snapshot(str(model), iteration, gauss,
                             torch.ones(N, dtype=torch.bool), deform, aabb)
    return model


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    root = tmp_path_factory.mktemp("tools")
    config = root / "tiny.py"
    config.write_text(CLI_CONFIG)
    scene = root / "scene"
    write_split(str(scene), "train", 2, 0.0, SIZE, "cpu")
    write_split(str(scene), "test", 2, 0.13, SIZE, "cpu")
    out = []
    for seed in (1, 2):
        model = root / f"model{seed}"
        model.mkdir()
        out.append(write_snapshot(model, config, seed))
    return scene, out


def _run_script(monkeypatch, name, argv):
    monkeypatch.setattr(sys, "argv", [f"{name}.py"] + argv)
    _script(name).main()


def test_export_perframe_matches_jax(models, monkeypatch, tmp_path):
    _, (model, _) = models
    _run_script(monkeypatch, "export_perframe_3DGS",
                ["-m", str(model), "--n_frames", "3"])
    out = model / "gaussian_pertimestamp"
    want = [ply.load_gaussians(str(out / f"time_{i:05d}.ply"), 3)
            for i in range(3)]
    for f in os.listdir(out):
        os.remove(out / f)
    paths = export_perframe.main(["-m", str(model), "--n_frames", "3",
                                  "--device", "cpu"])
    assert [os.path.basename(p) for p in paths] == [
        f"time_{i:05d}.ply" for i in range(3)]
    for path, w in zip(paths, want):
        got = ply.load_gaussians(path, 3)
        assert sorted(got) == sorted(w)
        for k in w:
            assert got[k].shape == w[k].shape and w[k].shape[0] == N, k
            np.testing.assert_allclose(got[k], w[k], rtol=1e-5, atol=1e-5,
                                       err_msg=k)
    # the frames differ: the field moves the gaussians with time
    assert not np.allclose(want[0]["xyz"], want[2]["xyz"])


def test_merge_many_matches_jax(models, monkeypatch, tmp_path, capsys):
    scene, paths = models
    from fourdgs_tpu.data import blender as jblender
    from fourdgs_tpu_torch.data import blender as tblender
    monkeypatch.setattr(jblender, "RESOLUTION", (SIZE, SIZE))
    monkeypatch.setattr(tblender, "RESOLUTION", (SIZE, SIZE))
    monkeypatch.setitem(sys.modules, "imageio", None)
    common = ["-m", *map(str, paths), "-s", str(scene), "--offsets",
              "0.3,0,0", "0,0.25,0.1", "--scales", "1.0", "0.8",
              "--n_frames", "2"]
    _run_script(monkeypatch, "merge_many_4dgs",
                common + ["--out", str(tmp_path / "jax")])
    jax_out = capsys.readouterr().out
    summary = merge_many.main(common + ["--out", str(tmp_path / "port"),
                                        "--device", "cpu"])
    port_out = capsys.readouterr().out
    assert summary["frames"] == 2 and summary["gaussians"] == 2 * N
    for text in (jax_out, port_out):
        assert "mp4 skipped" in text
    for i in range(2):
        want = read_png(str(tmp_path / "jax" / f"{i:05d}.png"))
        got = read_png(str(tmp_path / "port" / f"{i:05d}.png"))
        assert got.shape == want.shape == (SIZE, SIZE, 3)
        diff = np.abs(got.astype(np.int16) - want.astype(np.int16))
        assert (diff <= 1).mean() >= 0.999
        assert want.std() > 0
