"""Port parity for the nerfies (HyperNeRF) and DyNeRF readers
(data/hyper.py, data/dynerf.py, data/llff_poses.py), Pillow's resampling
(data/resample.py) and the scene facade on those layouts (data/scene.py).

The readers are held against the JAX package's on tests/test_data.py's
HyperNeRF fixture and on the scenes that chip_smoke.py's writers make at
a few dozen pixels: cameras to 1e-6 (both compute them in float64 numpy
from the same JSON or npy files; the tolerance covers the float32 of the
Nerfies camera fields), and sizes, times, splits, masks, normalisation,
point clouds, maxtime and images equal. The resampling is held against
Pillow itself, equal, through the host library and its plain version (the
`route` fixture, tests/_torch_routes.py).
"""
import ast
import dataclasses
import functools
import json
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from PIL import Image

import chip_smoke
from fourdgs_tpu.data import blender as jblender
from fourdgs_tpu.data import dynerf as jdynerf
from fourdgs_tpu.data import hyper as jhyper
from fourdgs_tpu.data import llff_poses as jllff
from fourdgs_tpu.data import scene as jscene
from fourdgs_tpu.train import config as jconfig
from fourdgs_tpu_torch.data import blender as tblender
from fourdgs_tpu_torch.data import dynerf as tdynerf
from fourdgs_tpu_torch.data import hyper as thyper
from fourdgs_tpu_torch.data import llff_poses as tllff
from fourdgs_tpu_torch.data import images, png, resample
from fourdgs_tpu_torch.data import scene as tscene
from fourdgs_tpu_torch.train import config as tconfig
from tests import test_data
from tests._torch_routes import route  # noqa: F401

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
# the DyNeRF scene at test size: frames written at FRAME_WH, read at
# IMG_WH (so the reader resizes them), as 1352 x 1014 is read at IMG_WH
FRAME_WH = (40, 30)
IMG_WH = (32, 24)
NERFIES_WH = (24, 32)


@pytest.fixture(scope="module")
def nerfies_scene(tmp_path_factory):
    root = tmp_path_factory.mktemp("nerfies")
    chip_smoke.write_nerfies_scene(torch, root, torch.device("cpu"),
                                   size=NERFIES_WH, n_times=4)
    return root


@pytest.fixture(scope="module")
def dynerf_scene(tmp_path_factory):
    root = tmp_path_factory.mktemp("dynerf")
    chip_smoke.write_dynerf_scene(torch, root, torch.device("cpu"),
                                  size=FRAME_WH, n_frames=3)
    return root


@pytest.fixture
def small_dynerf(monkeypatch):
    """Both packages' DyNeRF readers at IMG_WH, as `load_scene_info` calls
    them."""
    for mod in (jdynerf, tdynerf):
        monkeypatch.setattr(mod, "read_dynerf_scene", functools.partial(
            mod.read_dynerf_scene, img_wh=IMG_WH))


def _assert_infos_equal(a, b):
    assert len(a) == len(b) > 0
    for x, y in zip(a, b):
        np.testing.assert_allclose(y.R, x.R, atol=1e-6)
        np.testing.assert_allclose(y.T, x.T, atol=1e-6)
        assert (y.fovx, y.fovy, y.time) == pytest.approx(
            (x.fovx, x.fovy, x.time), abs=1e-6)
        assert (y.uid, y.width, y.height, y.image_name, y.image_path) == (
            x.uid, x.width, x.height, x.image_name, x.image_path)
        if x.mask is None:
            assert y.mask is None
        else:
            assert y.mask.dtype == x.mask.dtype
            np.testing.assert_array_equal(y.mask, x.mask)
        if x.image is not None:
            # the nerfies and dynerf readers leave the image on disk for
            # the bank, whose decoder gives what JAX's reader decoded
            got = images.load_image(y.image, y.image_path,
                                    (y.width, y.height))
            assert got.dtype == np.float32
            np.testing.assert_array_equal(got, x.image)


def _assert_scene_info_equal(a, b):
    assert a.maxtime == b.maxtime
    for split in ("train_cameras", "test_cameras", "video_cameras"):
        _assert_infos_equal(getattr(a, split), getattr(b, split))
    np.testing.assert_array_equal(b.nerf_normalization["translate"],
                                  a.nerf_normalization["translate"])
    assert b.nerf_normalization["radius"] == a.nerf_normalization["radius"]
    assert b.ply_path == a.ply_path
    for f in ("points", "colors", "normals"):
        np.testing.assert_array_equal(getattr(b.point_cloud, f),
                                      getattr(a.point_cloud, f))


def test_read_hyper_scene_on_jax_fixture(tmp_path):
    """The every-4th split, no masks; the port's sizes from the PNG
    headers equal JAX's from the decoded images."""
    test_data.TestHyperReader()._write_fixture(tmp_path)
    a = jhyper.read_hyper_scene(str(tmp_path), load_images=True)
    b = thyper.read_hyper_scene(str(tmp_path))
    _assert_scene_info_equal(a, b)
    assert all(i.image is None for i in b.train_cameras + b.test_cameras)
    assert [i.uid for i in a.train_cameras] == [0, 4]
    assert [i.uid for i in a.test_cameras] == [2]
    assert (a.video_cameras[0].width, a.video_cameras[0].height) == (32, 32)
    assert (a.train_cameras[0].width, a.train_cameras[0].height) == (16, 16)


def test_read_hyper_scene_on_writer_output(nerfies_scene):
    """The writer's vrig pair: train and val ids, covisible masks on the
    test views, video views at the JSON's full resolution."""
    a = jhyper.read_hyper_scene(str(nerfies_scene), load_images=True)
    b = thyper.read_hyper_scene(str(nerfies_scene))
    _assert_scene_info_equal(a, b)
    assert [i.image_name for i in b.train_cameras] == [
        f"left_{i:05d}.png" for i in range(4)]
    assert all(i.mask is not None and i.mask.shape == (32, 24)
               for i in b.test_cameras)
    assert all(i.mask is None for i in b.train_cameras)
    assert [(i.width, i.height) for i in b.train_cameras] == [(24, 32)] * 4
    assert [(i.width, i.height) for i in b.video_cameras] == [(48, 64)] * 4
    assert [i.time for i in b.train_cameras] == [0, 1 / 3, 2 / 3, 1]


def test_read_dynerf_scene_matches_jax(dynerf_scene):
    """Cameras from poses_bounds.npy, camera 0 held out, t = index / 300,
    frames resized with LANCZOS to the reader's size, the spiral."""
    kw = dict(img_wh=IMG_WH)
    a = jdynerf.read_dynerf_scene(str(dynerf_scene), load_images=True, **kw)
    b = tdynerf.read_dynerf_scene(str(dynerf_scene), **kw)
    _assert_scene_info_equal(a, b)
    assert all(i.image is None for i in b.train_cameras + b.test_cameras)
    assert len(b.train_cameras) == 3 * 3 and len(b.test_cameras) == 3
    assert len(b.video_cameras) == 300 and b.maxtime == 300
    assert [i.time for i in b.test_cameras] == [0, 1 / 300, 2 / 300]
    assert b.train_cameras[0].image_path.endswith("cam01/images/0000.png")
    # the writer's cameras are the reader's: right, down, forward columns
    # looking at the moved scene
    poses, nf, hwf = tllff.load_poses_bounds(
        str(dynerf_scene / "poses_bounds.npy"))
    ja = jllff.load_poses_bounds(str(dynerf_scene / "poses_bounds.npy"))
    for x, y in zip((poses, nf, hwf), ja):
        np.testing.assert_array_equal(x, y)
    for i, pos in enumerate(chip_smoke.DYNERF_RIG):
        R, _ = tllff.c2w_to_rt(poses[i])
        np.testing.assert_allclose(
            R, chip_smoke.look_at(pos, chip_smoke.DYNERF_OFFSET).T,
            atol=1e-12)
    np.testing.assert_array_equal(
        tllff.get_spiral(poses, nf, N_views=7),
        jllff.get_spiral(ja[0], ja[1], N_views=7))


def test_extract_video_frames_matches_jax(tmp_path, monkeypatch):
    """An mp4v video decoded by OpenCV into PNGs resized with LANCZOS:
    the same pixels as the JAX package's PIL path; without OpenCV, the
    port raises and names the frames' directory."""
    cv2 = pytest.importorskip("cv2")
    frames = np.random.default_rng(0).integers(
        0, 256, (5, FRAME_WH[1], FRAME_WH[0], 3), dtype=np.uint8)
    paths = {}
    for name in ("jax", "port"):
        (tmp_path / name).mkdir()
        paths[name] = str(tmp_path / name / "cam00.mp4")
        out = cv2.VideoWriter(paths[name], cv2.VideoWriter_fourcc(*"mp4v"),
                              30, FRAME_WH)
        for f in frames:
            out.write(np.ascontiguousarray(f))
        out.release()
    a = jdynerf.extract_video_frames(paths["jax"], IMG_WH, n_frames=4)
    b = tdynerf.extract_video_frames(paths["port"], IMG_WH, n_frames=4)
    names = sorted(p.name for p in (tmp_path / "jax/cam00/images").iterdir())
    assert names == ["0000.png", "0001.png", "0002.png", "0003.png"]
    assert sorted(p.name for p in (tmp_path / "port/cam00/images").iterdir()
                  ) == names
    for n in names:
        want = np.asarray(Image.open(f"{a}/{n}"))
        assert want.shape == (IMG_WH[1], IMG_WH[0], 3)
        np.testing.assert_array_equal(png.read_png(f"{b}/{n}"), want)
    monkeypatch.setitem(sys.modules, "cv2", None)
    (tmp_path / "port/cam01.mp4").touch()
    with pytest.raises(ImportError, match="cam01/images"):
        tdynerf.extract_video_frames(str(tmp_path / "port/cam01.mp4"))


def _jax_camera_arrays(cam):
    return [np.asarray(x) for x in (cam.world_view, cam.full_proj,
                                    cam.cam_center, cam.tanfovx,
                                    cam.tanfovy, cam.time)]


def _port_camera_arrays(cam):
    return [x.numpy() for x in (cam.world_view, cam.full_proj,
                                cam.cam_center, cam.tanfovx, cam.tanfovy,
                                cam.time)]


def _assert_scenes_equal(a, b, downscale=1):
    assert b.dataset_type == a.dataset_type
    assert b.cameras_extent == a.cameras_extent and b.maxtime == a.maxtime
    np.testing.assert_array_equal(b.aabb, a.aabb)
    np.testing.assert_array_equal(b.zerostamp_mask(), a.zerostamp_mask())
    for split in ("train", "test", "video"):
        sa, sb = getattr(a, split), getattr(b, split)
        assert len(sb) == len(sa)
        assert (sb.width, sb.height) == (sa.width, sa.height)
        np.testing.assert_array_equal(sb.times, sa.times)
        for i in range(len(sa)):
            ja = _jax_camera_arrays(jax.tree.map(lambda x: x[i],
                                                 sa.cameras))
            for x, y in zip(ja, _port_camera_arrays(sb.cameras[i])):
                np.testing.assert_allclose(y, x, atol=1e-6)
    for split in ("train", "test"):
        got, want = getattr(b, split).images, getattr(a, split).images
        assert got.mode == want.mode == "device"
        idxs = np.arange(len(got))
        np.testing.assert_array_equal(got[idxs].numpy(),
                                      np.asarray(want[idxs]))
    assert b.video.images is None


@pytest.mark.parametrize("downscale", [1, 2])
def test_scene_load_nerfies_matches_jax(nerfies_scene, downscale):
    a = jscene.Scene.load(str(nerfies_scene), downscale=downscale)
    b = tscene.Scene.load(str(nerfies_scene), downscale=downscale,
                          device="cpu")
    assert b.dataset_type == "nerfies"
    assert (b.train.width, b.train.height) == (24 // downscale,
                                               32 // downscale)
    _assert_scenes_equal(a, b)


@pytest.mark.parametrize("downscale", [1, 2])
def test_scene_load_dynerf_matches_jax(dynerf_scene, small_dynerf,
                                       downscale):
    a = jscene.Scene.load(str(dynerf_scene), downscale=downscale)
    b = tscene.Scene.load(str(dynerf_scene), downscale=downscale,
                          device="cpu")
    assert b.dataset_type == "dynerf"
    assert (b.train.width, b.train.height) == (32 // downscale,
                                               24 // downscale)
    _assert_scenes_equal(a, b)


# H x W in, W x H out: halvings of a DyNeRF frame and a HyperNeRF view,
# two small odd shapes, and an upscale
RESIZE_CASES = [((48, 64), (32, 24)), ((1014, 1352), (676, 507)),
                ((53, 37), (12, 17)), ((536, 960), (480, 268)),
                ((24, 32), (61, 45))]


@pytest.mark.parametrize("filt,pil", [("lanczos", Image.LANCZOS),
                                      ("bicubic", Image.BICUBIC)])
@pytest.mark.parametrize("shape,size", RESIZE_CASES,
                         ids=[f"{s[0]}x{s[1]}-{o[0]}x{o[1]}"
                              for s, o in RESIZE_CASES])
def test_resample_equals_pillow(shape, size, filt, pil, route):
    img = np.random.default_rng(sum(shape)).integers(
        0, 256, shape + (3,), dtype=np.uint8)
    got = resample.resize(img, size, filt)
    want = np.asarray(Image.fromarray(img).resize(size, pil))
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def test_resample_greyscale_and_same_size(route):
    rng = np.random.default_rng(1)
    grey = rng.integers(0, 256, (40, 30), dtype=np.uint8)
    np.testing.assert_array_equal(
        resample.resize(grey, (13, 17)),
        np.asarray(Image.fromarray(grey).resize((13, 17), Image.LANCZOS)))
    rgb = rng.integers(0, 256, (30, 40, 3), dtype=np.uint8)
    same = resample.resize(rgb, (40, 30))
    assert same is not rgb
    np.testing.assert_array_equal(same, rgb)
    with pytest.raises(ValueError, match="uint8"):
        resample.resize(rgb.astype(np.float32), (4, 4))


def test_load_image_downscale_matches_jax(tmp_path):
    """`_load_image`'s downscale path truncates to 8 bits before the
    LANCZOS resize, on decoded float images (an alpha-composited Blender
    view) and on views still on disk (a nerfies view)."""
    test_data.write_blender_fixture(tmp_path / "b", n_frames=2)
    kw = dict(white_background=True, eval_split=True, resolution=(32, 32))
    ja = jblender.read_blender_scene(str(tmp_path / "b"), **kw)
    test_data.TestHyperReader()._write_fixture(tmp_path / "h")
    hyper = thyper.read_hyper_scene(str(tmp_path / "h"))
    for info in ja.train_cameras + hyper.train_cameras:
        for d in (1, 2, 3):
            want = jscene._load_image(info, d)
            got = tscene._load_image(info, d)
            assert got.dtype == want.dtype == np.float32
            np.testing.assert_array_equal(got, want)
            np.testing.assert_array_equal(
                tscene._load_u8(info, d),
                np.rint(want * 255.0).astype(np.uint8))


def test_eight_bit_round_trip():
    """Every byte b: rint(float32(b / 255) * 255) == b, which lets a host
    or lazy bank keep a file's bytes as they are."""
    b = np.arange(256, dtype=np.uint8)
    f = b.astype(np.float32) / 255.0
    np.testing.assert_array_equal(np.rint(f * 255.0).astype(np.uint8), b)


@pytest.mark.parametrize("resolution", [(16, 16), (20, 12)])
def test_blender_reader_resizes_as_jax(tmp_path, resolution):
    """A 32px Blender image read at another resolution: truncated to 8
    bits and resized with BICUBIC to `resolution` as (W, H), as the JAX
    reader does with PIL (it compares (H, W) against it)."""
    test_data.write_blender_fixture(tmp_path, n_frames=3)
    kw = dict(white_background=True, eval_split=True, resolution=resolution)
    a = jblender.read_blender_scene(str(tmp_path), **kw)
    b = tblender.read_blender_scene(str(tmp_path), **kw)
    _assert_infos_equal(a.train_cameras, b.train_cameras)
    _assert_infos_equal(a.test_cameras, b.test_cameras)
    assert b.train_cameras[0].image.shape == (resolution[1], resolution[0],
                                              3)


JAX_CONFIGS = ROOT / "fourdgs_tpu" / "configs"
CONFIGS = sorted(str(p.relative_to(JAX_CONFIGS))
                 for p in JAX_CONFIGS.rglob("*.py"))


@pytest.mark.parametrize("path", CONFIGS)
def test_layout_configs_match_jax(path):
    """Every config file of the JAX package's configs/ tree through its
    apply_config_file, and the port's copy under CONFIG_DIR through the
    port's: the whole Configs equal, all five groups (chicken.py's
    ModelParams.kplanes_config ignored in both, dynerf/default.py's no_do
    and no_dshs False, multipleview/default.py's 16-wide planes at
    multires [1, 2])."""
    a = jconfig.apply_config_file(jconfig.Config(), str(JAX_CONFIGS / path))
    b = tconfig.apply_config_file(tconfig.Config(),
                                  str(tconfig.CONFIG_DIR / path))
    assert dataclasses.asdict(b) == dataclasses.asdict(a)
    if path.endswith("dynerf/default.py"):
        assert (b.hidden.no_do, b.hidden.no_dshs, b.opt.batch_size) == (
            False, False, 4)
    if path.endswith("multipleview/default.py"):
        assert (b.hidden.multires, b.hidden.kplanes_config[
            "output_coordinate_dim"], b.opt.batch_size) == ([1, 2], 16, 1)
    if path.endswith("hypernerf/chicken.py"):
        assert b.hidden.kplanes_config["resolution"] == [64, 64, 64, 150]


def _bases(path: Path) -> list:
    """The `_base_` includes a config file names, as written."""
    for node in ast.parse(path.read_text()).body:
        if (isinstance(node, ast.Assign)
                and [getattr(t, "id", None) for t in node.targets]
                == ["_base_"]):
            base = ast.literal_eval(node.value)
            return [base] if isinstance(base, str) else list(base)
    return []


def test_config_trees_match():
    """The port's configs/ tree holds the JAX tree's relative paths, no
    package marker, and every `_base_` include in it resolves to a file of
    the port's tree."""
    port = tconfig.CONFIG_DIR
    assert sorted(str(p.relative_to(port))
                  for p in port.rglob("*.py")) == CONFIGS
    assert not list(port.rglob("__init__.py"))
    included = 0
    for path in port.rglob("*.py"):
        for base in _bases(path):
            target = (path.parent / base).resolve()
            assert target.is_file(), (path, base)
            assert target.is_relative_to(port.resolve()), (path, base)
            included += 1
    assert included >= 24


@pytest.mark.parametrize("channels", [1, 3, 4])
def test_png_paeth_rows_round_trip(tmp_path, channels, route):
    """write_png's Paeth rows (row filter 4, PIL's usual pick) decode to
    the image, with the port's codec and with PIL."""
    rng = np.random.default_rng(channels)
    y, x = np.mgrid[0:19, 0:23]
    img = np.stack([x * 9, y * 7, x * y, 255 - x], -1)[..., :channels]
    img = (img + rng.integers(0, 3, img.shape)).astype(np.uint8)
    if channels == 1:
        img = img[..., 0]
    path = str(tmp_path / "p.png")
    png.write_png(path, img, row_filter=4)
    np.testing.assert_array_equal(png.read_png(path), img)
    np.testing.assert_array_equal(np.asarray(Image.open(path)), img)
    with pytest.raises(ValueError, match="row filter"):
        png.write_png(path, img, row_filter=2)


def test_png_size_and_greyscale(tmp_path):
    img = np.random.default_rng(2).integers(0, 256, (7, 5), dtype=np.uint8)
    png.write_png(str(tmp_path / "g.png"), img)
    assert png.png_size(str(tmp_path / "g.png")) == (5, 7)
    np.testing.assert_array_equal(np.asarray(Image.open(tmp_path / "g.png")),
                                  img)
    np.testing.assert_array_equal(png.read_rgb(str(tmp_path / "g.png")),
                                  np.repeat(img[..., None], 3, axis=2))
    (tmp_path / "x.png").write_text(json.dumps({}))
    with pytest.raises(ValueError, match="not a PNG"):
        png.png_size(str(tmp_path / "x.png"))
