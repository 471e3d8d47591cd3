"""The port's preparation, point and report tools (fourdgs_tpu_torch/
tools/: poses2colmap, colmap_converter, downsample_point, grow_point,
merge_point, preprocess_dynerf, cal_modelsize, visualize_hexplane,
diag_checkpoint) against the JAX package's scripts of the same names.

Every input is made here from `np.random.default_rng`: a Blender
transforms file, an LLFF `poses_bounds.npy`, a nerfies capture, a COLMAP
model in binary, PLY clouds, and a snapshot and a checkpoint written by
the port's own writers. The JAX scripts run in one subprocess on the CPU
(`JAX_PLATFORMS=cpu`, `FOURDGS_PLATFORM=cpu`), each as `__main__` with its
arguments, on copies of the inputs; the port's tools run here through
their `main`. Their output files must be equal byte for byte (the PLYs,
the COLMAP text and binary files), the hexplane PNGs equal in their
pixels to the ones the script writes with Pillow, and the printed lines
equal. grow_point draws its noise with `jax.random` in the script: the
port's tool takes that draw (`main(noise=)`), and then the grown points
must agree within 1e-6 and the copies' colors (which show the mask) be
equal.
"""
import contextlib
import io
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from fourdgs_tpu_torch.data import colmap, ply
from fourdgs_tpu_torch.data.png import write_png
from fourdgs_tpu_torch.tools import (cal_modelsize, colmap_converter,
                                     diag_checkpoint, downsample_point,
                                     grow_point, merge_point, poses2colmap,
                                     preprocess_dynerf, visualize_hexplane)
from fourdgs_tpu_torch.train import checkpoint
from fourdgs_tpu_torch.train import config as tconfig
from fourdgs_tpu_torch.train.state import create_state

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
GROW_POINTS = 600
GROW_TOL = 1e-6
# the JAX script run in the subprocess: each case's stdout, or its error
RUNNER = r"""
import contextlib, io, json, runpy, sys, traceback
src, dst = sys.argv[1:3]
cases = json.load(open(src))
out = {}
for name, argv in cases.items():
    buf, err = io.StringIO(), None
    sys.argv = list(argv)
    try:
        with contextlib.redirect_stdout(buf):
            runpy.run_path(argv[0], run_name="__main__")
    except SystemExit as e:
        err = None if not e.code else f"exit {e.code}"
    except BaseException:
        err = traceback.format_exc()
    out[name] = {"stdout": buf.getvalue(), "error": err}
json.dump(out, open(dst, "w"))
"""


def _rotation(rng):
    q, r = np.linalg.qr(rng.normal(size=(3, 3)))
    return q * np.sign(np.diag(r))


def _blender(root: Path, rng) -> Path:
    frames = []
    for i in range(5):
        c2w = np.eye(4)
        c2w[:3, :3] = _rotation(rng)
        c2w[:3, 3] = rng.uniform(-4, 4, 3)
        frames.append({"file_path": f"./train/r_{i:03d}", "time": i / 4,
                       "transform_matrix": c2w.tolist()})
    path = root / "transforms_train.json"
    path.write_text(json.dumps({"camera_angle_x": 0.69, "frames": frames}))
    return path


def _poses_bounds(root: Path, rng) -> Path:
    rows = []
    for _ in range(4):
        pose = np.concatenate([_rotation(rng), rng.uniform(-2, 2, (3, 1)),
                               [[1014.0], [1352.0], [1460.5]]], axis=1)
        rows.append(np.concatenate([pose.ravel(), [0.8, 9.5]]))
    path = root / "poses_bounds.npy"
    np.save(path, np.array(rows))
    return path


def _nerfies(root: Path, rng) -> Path:
    """A nerfies capture: camera/*.json and rgb/2x/*.png, 7 views."""
    for d in ("camera", "rgb/2x"):
        (root / d).mkdir(parents=True)
    for i in range(7):
        name = f"left_{i:05d}"
        (root / "camera" / f"{name}.json").write_text(json.dumps({
            "orientation": _rotation(rng).tolist(),
            "position": rng.uniform(-3, 3, 3).tolist(),
            "focal_length": float(rng.uniform(40, 60)),
            "principal_point": rng.uniform(10, 14, 2).tolist(),
            "image_size": [24, 32]}))
        write_png(str(root / "rgb" / "2x" / f"{name}.png"),
                  rng.integers(0, 256, (16, 12, 3), dtype=np.uint8))
    return root


def _colmap_model(root: Path, rng) -> Path:
    cams = {1: colmap.ColmapCamera(1, "PINHOLE", 640, 480,
                                   np.array([500.5, 501.25, 320.0, 240.0])),
            2: colmap.ColmapCamera(2, "SIMPLE_RADIAL", 320, 240,
                                   rng.uniform(0.1, 300, 4))}
    images = {}
    for i in range(1, 5):
        n = int(rng.integers(0, 6))
        q = rng.normal(size=4)
        images[i] = colmap.ColmapImage(
            i, q / np.linalg.norm(q), rng.normal(size=3), 1 + i % 2,
            f"frame_{i:04d}.png", rng.uniform(0, 640, (n, 2)),
            rng.integers(-1, 20, n).astype(np.int64))
    points = {}
    for pid in rng.choice(100, 12, replace=False):
        n = int(rng.integers(1, 4))
        points[int(pid)] = colmap.ColmapPoint3D(
            int(pid), rng.normal(size=3),
            rng.integers(0, 256, 3).astype(np.float64), float(rng.random()),
            rng.integers(1, 5, n).astype(np.int32),
            rng.integers(0, 6, n).astype(np.int32))
    path = root / "sparse_bin"
    colmap.write_model(cams, images, points, str(path), ".bin")
    return path


def _cloud(path: Path, rng, n: int, offset=0.0) -> Path:
    ply.store_point_cloud(str(path),
                          rng.normal(offset, 1.0, (n, 3)).astype(np.float32),
                          rng.uniform(0, 255, (n, 3)).astype(np.float32))
    return path


def _model(root: Path) -> tuple[Path, Path]:
    """A snapshot (point_cloud/iteration_7) and a checkpoint of one small
    state, by the port's writers."""
    cfg = tconfig.Config()
    cfg.raster = tconfig.RasterParams(capacity=512)
    cfg.hidden.kplanes_config["resolution"] = [8, 8, 8, 4]
    cfg.hidden.kplanes_config["output_coordinate_dim"] = 8
    cfg.hidden.multires = [1, 2]
    cfg.hidden.net_width = 32
    rng = np.random.default_rng(3)
    st = create_state(cfg, rng.uniform(-1, 1, (300, 3)).astype(np.float32),
                      rng.uniform(0, 1, (300, 3)).astype(np.float32), 1.0,
                      generator=torch.Generator().manual_seed(3),
                      device="cpu")
    with torch.no_grad():
        for p in st.params["deform"].grid.planes.values():
            p.add_(torch.from_numpy(rng.normal(0, 0.3, p.shape)
                                    .astype(np.float32)))
        st.params["gauss"].opacity[5, 0] = float("nan")
    model = root / "model"
    checkpoint.save_snapshot(str(model), 7, st.params["gauss"], st.alive,
                             st.params["deform"], st.aabb.numpy())
    ckpt = model / "chkpnt_fine_7.npz"
    checkpoint.save_checkpoint(st, str(ckpt), 7, "fine", 1)
    return model, ckpt


def _dynerf(root: Path, rng) -> Path:
    """cam00-cam01.mp4 placeholders whose frames exist under
    camNN/images."""
    root.mkdir()
    for c in range(2):
        (root / f"cam{c:02d}.mp4").write_bytes(b"")
        frames = root / f"cam{c:02d}" / "images"
        frames.mkdir(parents=True)
        for i in range(3 + c):
            write_png(str(frames / f"{i:04d}.png"),
                      rng.integers(0, 256, (6, 8, 3), dtype=np.uint8))
    return root


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    rng = np.random.default_rng(22)
    root = tmp_path_factory.mktemp("inputs")
    model, ckpt = _model(root)
    cloud = _cloud(root / "dense.ply", rng, 3000)
    return {"blender": _blender(root, rng),
            "llff": _poses_bounds(root, rng),
            "nerfies": _nerfies(root / "nerfies", rng),
            "colmap": _colmap_model(root, rng), "dense": cloud,
            "small": _cloud(root / "small.ply", rng, GROW_POINTS),
            "other": _cloud(root / "other.ply", rng, 250, offset=3.0),
            "model": model, "ckpt": ckpt,
            "dynerf": _dynerf(root / "dynerf", rng)}


def _cases(inputs: dict, jax_dir: Path) -> dict:
    """Each case: (the JAX script's argv, the port tool, its argv), with
    outputs under `jax_dir` or the port's directory given by `{out}`."""
    i = {k: str(v) for k, v in inputs.items()}
    return {
        "poses2colmap_blender": (
            ["poses2colmap.py", i["blender"], "{out}/blender", "--width",
             "640", "--height", "480"], poses2colmap),
        "poses2colmap_llff": (
            ["poses2colmap.py", i["llff"], "{out}/llff"], poses2colmap),
        "poses2colmap_hypernerf": (
            ["poses2colmap.py", "{out}/nerfies"], poses2colmap),
        "colmap_converter": (
            ["colmap_converter.py", "--input_model", i["colmap"],
             "--input_format", ".bin", "--output_model", "{out}/txt",
             "--output_format", ".txt"], colmap_converter),
        "colmap_converter_back": (
            ["colmap_converter.py", "--input_model", "{out}/txt",
             "--output_model", "{out}/bin", "--output_format", ".bin"],
            colmap_converter),
        "downsample_point": (
            ["downsample_point.py", i["dense"], "{out}/down.ply",
             "--budget", "500"], downsample_point),
        "downsample_point_voxel": (
            ["downsample_point.py", i["dense"], "{out}/voxel.ply",
             "--voxel_size", "0.4"], downsample_point),
        "grow_point": (
            ["grow_point.py", i["small"], "{out}/grown.ply", "--quantile",
             "0.7", "--displacement_scale", "0.5"], grow_point),
        "merge_point": (
            ["merge_point.py", i["small"], i["other"], i["dense"], "-o",
             "{out}/merged.ply"], merge_point),
        "preprocess_dynerf": (
            ["preprocess_dynerf.py", "--datadir", i["dynerf"]],
            preprocess_dynerf),
        "cal_modelsize": (
            ["cal_modelsize.py", i["model"], i["model"]], cal_modelsize),
        "visualize_hexplane": (
            ["visualize_hexplane.py", "-m", i["model"], "--out",
             "{out}/hexplane"], visualize_hexplane),
        "diag_checkpoint": (
            ["diag_checkpoint.py", i["ckpt"], "--cpu"], diag_checkpoint),
    }


def _argv(argv, out: Path) -> list:
    return [a.replace("{out}", str(out)) for a in argv]


@pytest.fixture(scope="module")
def jax_runs(inputs, tmp_path_factory):
    """Every case's JAX script, in one subprocess: its stdout and error,
    and its output directory."""
    out = tmp_path_factory.mktemp("jax")
    shutil.copytree(inputs["nerfies"], out / "nerfies")
    cases = {name: [str(REPO / "scripts" / argv[0])] + _argv(argv[1:], out)
             for name, (argv, _) in _cases(inputs, out).items()}
    # the converter's second case reads the first's output
    order = sorted(cases, key=lambda n: n == "colmap_converter_back")
    (out / "cases.json").write_text(json.dumps({n: cases[n] for n in order}))
    env = dict(os.environ, JAX_PLATFORMS="cpu", FOURDGS_PLATFORM="cpu",
               PYTHONPATH="",
               XLA_FLAGS="--xla_force_host_platform_device_count=1")
    r = subprocess.run([sys.executable, "-c", RUNNER, str(out / "cases.json"),
                        str(out / "results.json")], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    return out, json.loads((out / "results.json").read_text())


def _port(inputs, name, out: Path, **kw) -> str:
    argv, tool = _cases(inputs, out)[name]
    if name == "diag_checkpoint":
        argv = argv[:-1] + ["--device", "cpu"]
    if name == "grow_point":
        argv = argv + ["--device", "cpu"]
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        tool.main(_argv(argv[1:], out), **kw)
    return buf.getvalue()


def _same_files(a: Path, b: Path):
    names = sorted(p.name for p in a.iterdir())
    assert names == sorted(p.name for p in b.iterdir())
    for n in names:
        assert (a / n).read_bytes() == (b / n).read_bytes(), n


def _jax_draw(n: int) -> np.ndarray:
    """The script's draw: jax.random.normal(key(0), (n, 3))."""
    return np.asarray(jax.random.normal(jax.random.key(0), (n, 3)))


@pytest.mark.parametrize("name", [
    "poses2colmap_blender", "poses2colmap_llff", "poses2colmap_hypernerf",
    "colmap_converter", "downsample_point", "downsample_point_voxel",
    "grow_point", "merge_point", "preprocess_dynerf", "cal_modelsize",
    "visualize_hexplane", "diag_checkpoint"])
def test_tool_matches_the_jax_script(name, inputs, jax_runs, tmp_path):
    jout, results = jax_runs
    res = results[name]
    assert res["error"] is None, res["error"]
    out = tmp_path
    if name == "poses2colmap_hypernerf":
        shutil.copytree(inputs["nerfies"], out / "nerfies")
    kw = {}
    if name == "grow_point":
        kw["noise"] = _jax_draw(GROW_POINTS)
    if name == "colmap_converter":
        _port(inputs, name, out)
        printed = _port(inputs, "colmap_converter_back", out)
        assert printed == results["colmap_converter_back"]["stdout"]
    printed = _port(inputs, name, out, **kw)
    assert printed == res["stdout"].replace(str(jout), str(out))

    if name.startswith("poses2colmap"):
        sub = {"blender": "blender", "llff": "llff",
               "hypernerf": "nerfies/sparse_"}[name.split("_")[1]]
        _same_files(jout / sub, out / sub)
        if name.endswith("hypernerf"):
            _same_files(jout / "nerfies" / "image_colmap",
                        out / "nerfies" / "image_colmap")
    elif name == "colmap_converter":
        _same_files(jout / "txt", out / "txt")
        _same_files(jout / "bin", out / "bin")
        # the round trip keeps every record
        assert (out / "bin" / "points3D.bin").read_bytes() == (
            inputs["colmap"] / "points3D.bin").read_bytes()
    elif name.startswith("downsample") or name == "merge_point":
        f = {"downsample_point": "down.ply", "merge_point": "merged.ply",
             "downsample_point_voxel": "voxel.ply"}[name]
        assert (jout / f).read_bytes() == (out / f).read_bytes()
    elif name == "grow_point":
        got, gcols, _ = ply.fetch_point_cloud(str(out / "grown.ply"))
        want, wcols, _ = ply.fetch_point_cloud(str(jout / "grown.ply"))
        assert got.shape == want.shape and len(got) > GROW_POINTS
        np.testing.assert_array_equal(gcols, wcols)      # the mask
        np.testing.assert_allclose(got, want, rtol=0, atol=GROW_TOL)
    elif name == "visualize_hexplane":
        pngs = sorted(p.name for p in (jout / "hexplane").iterdir())
        assert len(pngs) == 12
        assert pngs == sorted(p.name for p in (out / "hexplane").iterdir())
        for n in pngs:
            a = Image.open(jout / "hexplane" / n)
            b = Image.open(out / "hexplane" / n)
            assert a.mode == b.mode == "L"
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_preprocess_dynerf_without_opencv_names_the_video(tmp_path,
                                                          monkeypatch):
    """A video whose frames do not exist, on a machine without OpenCV:
    the tool raises extract_video_frames' ImportError, which names the
    video, and writes nothing."""
    (tmp_path / "cam00.mp4").write_bytes(b"")
    monkeypatch.setitem(sys.modules, "cv2", None)
    with pytest.raises(ImportError, match="cam00.mp4.*OpenCV"):
        preprocess_dynerf.main(["--datadir", str(tmp_path)])
    assert not (tmp_path / "cam00").exists()


def test_grow_point_seeded_draw_is_the_seeds(inputs, tmp_path):
    """Without a given draw the tool draws from a torch.Generator seeded
    with --seed: the same seed gives the same cloud, another seed
    another."""
    runs = {}
    for tag, seed in (("a", 0), ("b", 0), ("c", 1)):
        grow_point.main([str(inputs["small"]), str(tmp_path / f"{tag}.ply"),
                         "--seed", str(seed), "--device", "cpu"])
        runs[tag] = (tmp_path / f"{tag}.ply").read_bytes()
    assert runs["a"] == runs["b"] != runs["c"]
