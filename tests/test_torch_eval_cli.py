"""The evaluation path of the port: the render CLI (tools/render.py) and
the metrics CLI (tools/metrics.py) on a tiny model that the port's train
CLI trained on the CPU (tests/test_torch_stage.py's 32px ball scene and
CLI config), against the JAX package:

  * every rendered test PNG within one level of 255 of the JAX package's
    `render/render.py:render` on the same snapshot (restored by its
    `train/checkpoint.py`) and camera, quantised as scripts/render.py's
    `write_png` quantises; the splits' PNG counts and the FPS line;
  * scripts/metrics.py, run on the port's renders as tests/test_cli.py
    runs it, against the port's metrics: PSNR within 1e-4 dB, SSIM and
    MS-SSIM within 1e-5 (with a second method of 192px pairs, since
    MS-SSIM is NaN below 176 px in both packages), the same keys in
    results.json and per_view.json;
    LPIPS skipped in both with the same message, and with random weights
    in the npz layout equal to the JAX package's LPIPS to 1e-5 relative;
  * the run's last in-loop test PSNR against the post-hoc one, within
    0.1 dB (the quantisation to 8 bits lies between them).
"""
import concurrent.futures
import dataclasses
import json
import os
import shutil
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fourdgs_tpu.data import scene as jscene
from fourdgs_tpu.models.deformation import init_deform
from fourdgs_tpu.ops import lpips as jlpips
from fourdgs_tpu.render.render import render as jrender
from fourdgs_tpu.train import checkpoint as jckpt
from fourdgs_tpu.train import config as jconfig
from fourdgs_tpu.train import loop as jloop
from fourdgs_tpu.train.state import deform_config_from
from fourdgs_tpu_torch.data import scene as tscene
from fourdgs_tpu_torch.data.png import read_png, write_png
from fourdgs_tpu_torch.render import serve
from fourdgs_tpu_torch.render.serve import Renderer
from fourdgs_tpu_torch.tools import metrics as tmetrics
from fourdgs_tpu_torch.tools import render as trender
from fourdgs_tpu_torch.tools import train as ttrain
from fourdgs_tpu_torch.tools.make_synthetic_scene import write_split
from tests.test_lpips import random_params
from tests.test_torch_stage import CLI_CONFIG

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZE = 32
ITERS = 16
POST_HOC_TOL = 0.1          # dB, PERF.md's gate
PSNR_TOL = 1e-4             # dB
SSIM_TOL = 1e-5
LPIPS_RTOL = 1e-5


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """The scene (6 train, 2 test views), a model trained by the port's
    CLI through both stages with a test eval at its last iteration, and
    the render CLI's summary over its three splits."""
    root = tmp_path_factory.mktemp("eval")
    scene = root / "scene"
    write_split(str(scene), "train", 6, 0.0, SIZE, "cpu")
    write_split(str(scene), "test", 2, 0.13, SIZE, "cpu")
    (scene / "cli.py").write_text(CLI_CONFIG)
    model = root / "model"
    summary = ttrain.main([
        "-s", str(scene), "-m", str(model), "--configs",
        str(scene / "cli.py"), "--device", "cpu", "--image_size", str(SIZE),
        str(SIZE), "--quiet", "--test_iterations", str(ITERS)])
    rendered = trender.main(["-m", str(model), "-s", str(scene),
                             "--image_size", str(SIZE), str(SIZE),
                             "--device", "cpu"])
    return scene, model, summary, rendered


def test_render_cli_writes_every_split(trained, capsys):
    scene, model, _, rendered = trained
    assert rendered["iteration"] == ITERS and rendered["device"] == "cpu"
    splits = rendered["splits"]
    assert sorted(splits) == ["test", "train", "video"]
    for split, n in (("train", 6), ("test", 2)):
        base = model / split / f"ours_{ITERS}"
        assert sorted(os.listdir(base / "renders")) == \
            sorted(os.listdir(base / "gt")) == [f"{i:05d}.png"
                                               for i in range(n)]
        assert splits[split]["views"] == n and splits[split]["fps"] > 0
    video = model / "video" / f"ours_{ITERS}"
    assert len(os.listdir(video / "renders")) == splits["video"]["views"] > 0
    assert os.listdir(video / "gt") == []
    # a mesh of two ranks needs torchrun's two processes
    # (tests/test_torch_parallel_cli.py runs it there)
    with pytest.raises(ValueError, match="1x2 mesh needs 2 ranks"):
        trender.main(["-m", str(model), "--mesh", "1,2", "--device", "cpu"])


def test_render_split_grows_the_caps_until_drop_free(trained, tmp_path):
    """A split whose renders overflow the caps is rendered again at grown
    caps, and what it writes is the drop-free render."""
    scene, model, _, _ = trained
    ts = tscene.Scene.load(str(scene), device="cpu", resolution=(SIZE, SIZE))
    rend = Renderer.from_snapshot(str(model), device="cpu", width=SIZE,
                                  height=SIZE,
                                  probe_camera=ts.train.cameras[0])
    free = rend.raster_cfg                  # the probe's drop-free caps
    rend.raster_cfg = dataclasses.replace(free, tile_cap=free.tile_cap // 4)
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        res = trender.render_split(rend, "test", ts.test, str(tmp_path),
                                   True, pool)
    assert res["passes"] == 3 and res["renders"] == 3 * (len(ts.test) + 1)
    assert rend.raster_cfg.tile_cap == free.tile_cap
    for i, cam in enumerate(ts.test.cameras):
        out = rend.render_eager(cam)
        assert not any(serve.overflows(int(out.dropped_pairs),
                                       int(out.dropped_tile),
                                       int(out.num_pairs)))
        np.testing.assert_array_equal(
            read_png(str(tmp_path / "renders" / f"{i:05d}.png")),
            trender.quantise(out.color.numpy()))


def _jax_test_renders(scene, model):
    """scripts/render.py's renders of the test views: the snapshot
    restored by the JAX package, its cap probe on the first train camera,
    quantised as its write_png."""
    cfg = jconfig.load_cfg(str(model / "cfg_args.json"))
    js = jscene.Scene.load(str(scene), white_background=True,
                           eval_split=True, resolution=(SIZE, SIZE))
    snap_dir, _ = jckpt.find_latest_snapshot(str(model))
    gauss, alive, flat, aabb = jckpt.restore_gaussians_from_snapshot(
        snap_dir, cap=1, max_sh_degree=cfg.model.sh_degree)
    dcfg = deform_config_from(cfg)
    deform = jckpt.deform_params_from_flat(
        init_deform(jax.random.key(0), dcfg), flat)
    rcfg = jloop.raster_config_from(cfg, SIZE, SIZE)
    bg = jnp.ones(3)

    def render(cam, rc):
        return jrender(gauss, deform, cam, bg, rc, dcfg, jnp.asarray(aabb),
                       alive, cfg.model.sh_degree, stage="fine")

    probe_cam = jax.tree.map(lambda a: a[0], js.train.cameras)
    for _ in range(5):               # scripts/render.py:78-104
        probe = render(probe_cam, rcfg)
        dp, dt = int(probe.dropped_pairs), int(probe.dropped_tile)
        dt_thresh = max(64, int(probe.num_pairs) // 200)
        if not (dp or dt > dt_thresh):
            break
        changes = {}
        if dt > dt_thresh and rcfg.tile_cap < 8192:
            changes["tile_cap"] = rcfg.tile_cap * 2
        if dp and rcfg.bin_pairs_per_chunk < (1 << 18):
            changes["bin_pairs_per_chunk"] = rcfg.bin_pairs_per_chunk * 2
        if not changes:
            break
        rcfg = dataclasses.replace(rcfg, **changes)
    out = []
    for i in range(len(js.test)):
        color = np.asarray(render(
            jax.tree.map(lambda a, i=i: a[i], js.test.cameras), rcfg).color)
        out.append((np.clip(color, 0, 1) * 255).astype(np.uint8))
    return out


def test_render_cli_matches_jax(trained):
    scene, model, _, _ = trained
    want = _jax_test_renders(scene, model)
    renders = model / "test" / f"ours_{ITERS}" / "renders"
    for i, img in enumerate(want):
        got = read_png(str(renders / f"{i:05d}.png"))
        assert got.shape == img.shape == (SIZE, SIZE, 3)
        diff = np.abs(got.astype(np.int16) - img.astype(np.int16))
        assert diff.max() <= 1, (i, diff.max())
        assert img.std() > 0


BIG = 192      # MS-SSIM needs 176 px (11 x 2^4); below it both give NaN


def _methods(model, root):
    """A copy of the port's test renders, and a second method of two
    random 192px pairs, on which MS-SSIM has a value."""
    shutil.copytree(model / "test", root / "test")
    rng = np.random.default_rng(8)
    for sub in ("renders", "gt"):
        (root / "test" / "ours_0" / sub).mkdir(parents=True)
    for i in range(2):
        gt = rng.uniform(0, 1, (BIG, BIG, 3))
        render = np.clip(gt + rng.normal(0, 0.05, gt.shape), 0, 1)
        for sub, img in (("renders", render), ("gt", gt)):
            write_png(str(root / "test" / "ours_0" / sub / f"{i:05d}.png"),
                      trender.quantise(img))
    return root


def _read_results(root):
    with open(root / "results.json") as f:
        results = json.load(f)
    with open(root / "per_view.json") as f:
        return results, json.load(f)


def test_metrics_cli_matches_jax(trained, tmp_path, monkeypatch, capsys):
    _, model, summary, _ = trained
    missing = str(tmp_path / "no_weights.npz")
    monkeypatch.setenv("FOURDGS_LPIPS_WEIGHTS", missing)
    jmodel = _methods(model, tmp_path / "jax_model")
    tmodel = _methods(model, tmp_path / "port_model")
    env = dict(os.environ, JAX_PLATFORMS="cpu", FOURDGS_PLATFORM="cpu",
               PYTHONPATH="",
               XLA_FLAGS="--xla_force_host_platform_device_count=1")
    r = subprocess.run([sys.executable, "scripts/metrics.py", "-m",
                        str(jmodel)], cwd=REPO, env=env, capture_output=True,
                       text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    jres, jview = _read_results(jmodel)
    capsys.readouterr()
    tmetrics.main(["-m", str(tmodel), "--device", "cpu"])
    out = capsys.readouterr().out
    skip = r.stdout[r.stdout.index("LPIPS: skipped"):
                    r.stdout.index("Scene:")]
    assert missing in skip and skip in out
    tres, tview = _read_results(tmodel)
    method = f"ours_{ITERS}"
    assert list(tres) == list(jres) == ["ours_0", method]
    for m in tres:
        assert list(tres[m]) == list(jres[m]) == [
            "PSNR", "SSIM", "MS-SSIM", "D-SSIM"]
        assert list(tview[m]) == list(jview[m])
        for key, tol in (("PSNR", PSNR_TOL), ("SSIM", SSIM_TOL),
                         ("MS-SSIM", SSIM_TOL), ("D-SSIM", SSIM_TOL)):
            np.testing.assert_allclose(tres[m][key], jres[m][key],
                                       atol=tol, err_msg=f"{m} {key}")
            assert list(tview[m][key]) == list(jview[m][key])
            for name, v in tview[m][key].items():
                np.testing.assert_allclose(v, jview[m][key][name], atol=tol,
                                           err_msg=f"{m} {key} {name}")
    assert 0.5 < tres["ours_0"]["MS-SSIM"] < 1
    assert np.isnan(tres[method]["MS-SSIM"])      # 32 px

    # the post-hoc test PSNR against the run's last in-loop eval
    in_loop = summary["stages"][-1]["test_psnr"][-1]
    assert in_loop[0] == ITERS
    assert abs(tres[method]["PSNR"] - in_loop[1]) <= POST_HOC_TOL, (
        tres[method]["PSNR"], in_loop)


def test_metrics_cli_scores_lpips_with_weights(trained, tmp_path,
                                               monkeypatch):
    """With a weight file, each network's LPIPS joins the rows and equals
    the JAX package's on the same images (random weights)."""
    _, model, _, _ = trained
    copy = tmp_path / "model"
    shutil.copytree(model / "test", copy / "test")
    path = str(tmp_path / "lpips.npz")
    np.savez(path, **random_params(np.random.default_rng(1), "alex"))
    monkeypatch.setenv("FOURDGS_LPIPS_WEIGHTS", path)
    # the variable names one file, which serves both networks' lookups
    monkeypatch.setattr(tmetrics, "LPIPS_NETS", ("alex",))
    (res,) = tmetrics.evaluate([str(copy)], "cpu").values()
    method = f"ours_{ITERS}"
    assert list(res[method])[-1] == "lpips-alex"
    renders, gts, names = tmetrics.read_images(
        str(copy / "test" / method / "renders"),
        str(copy / "test" / method / "gt"))
    jfn = jlpips.make_lpips_fn("alex")
    with open(copy / "per_view.json") as f:
        per_view = json.load(f)[method]["lpips-alex"]
    for r, g, name in zip(renders, gts, names):
        np.testing.assert_allclose(per_view[name], jfn(r, g),
                                   rtol=LPIPS_RTOL, err_msg=name)
