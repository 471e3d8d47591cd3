"""Port parity for the COLMAP model files (data/colmap.py), the Colmap,
MultipleView and PanopticSports readers (data/colmap_scene.py,
data/multiview.py, data/panoptic.py) and the scene facade on those
layouts (data/scene.py), against the JAX package.

The readers are held against JAX's on tests/test_data.py's fixtures (the
MultipleView rig, the Panoptic sequence), on a COLMAP capture written here
in binary and in text, and on the scenes chip_smoke.py's writers make at a
few dozen pixels: cameras to 1e-6, and sizes, times, splits, names,
normalisation, point clouds, maxtime and images equal (the port's views,
decoded by data/images.py through data/jpeg.py, against JAX's PIL
decodes). `Scene.load` is held at downscale 1 and 2, Panoptic's `full_proj`
with its off-centre principal points included.
"""
import json
import os

import numpy as np
import pytest
import torch
from PIL import Image

import chip_smoke
from fourdgs_tpu.data import colmap as jcolmap
from fourdgs_tpu.data import colmap_scene as jcolmap_scene
from fourdgs_tpu.data import multiview as jmultiview
from fourdgs_tpu.data import panoptic as jpanoptic
from fourdgs_tpu.data import scene as jscene
from fourdgs_tpu_torch.data import colmap as tcolmap
from fourdgs_tpu_torch.data import colmap_scene as tcolmap_scene
from fourdgs_tpu_torch.data import images
from fourdgs_tpu_torch.data import multiview as tmultiview
from fourdgs_tpu_torch.data import panoptic as tpanoptic
from fourdgs_tpu_torch.data import scene as tscene
from tests import test_data
from tests.test_torch_readers import (_assert_scene_info_equal,
                                      _assert_scenes_equal,
                                      _jax_camera_arrays,
                                      _port_camera_arrays)

torch.set_num_threads(1)

CPU = torch.device("cpu")
# the writers at test size: (W, H) and their view counts
SIZES = {"multipleview": (48, 32), "panoptic": (40, 24), "colmap": (40, 30)}
VIEWS = {"multipleview": dict(n_frames=4), "panoptic": dict(n_times=3),
         "colmap": dict(n_views=10)}


@pytest.fixture(scope="module")
def written(tmp_path_factory):
    """The three chip_smoke writers' scenes at test size."""
    out = {}
    for kind, size in SIZES.items():
        root = tmp_path_factory.mktemp(kind)
        chip_smoke.WRITERS[kind](torch, root, CPU, size=size, **VIEWS[kind])
        out[kind] = root
    return out


# ---------------------------------------------------------------------------
# data/colmap.py
# ---------------------------------------------------------------------------

def _colmap_model(rng):
    cams = {1: tcolmap.ColmapCamera(id=1, model="PINHOLE", width=640,
                                    height=480,
                                    params=np.array([500.0, 510, 320, 240]))}
    q = rng.normal(size=4)
    q /= np.linalg.norm(q)
    images_ = {1: tcolmap.ColmapImage(
        id=1, qvec=q, tvec=rng.normal(size=3), camera_id=1,
        name="frame_00001.jpg", xys=rng.normal(size=(5, 2)),
        point3D_ids=np.arange(5, dtype=np.int64))}
    return cams, images_


def test_colmap_binary_files_match_jax(tmp_path):
    """The port's writers' files read alike in both packages, and JAX's
    writers' files in the port (test_data.TestColmap's round trip)."""
    rng = np.random.default_rng(0)
    cams, ims = _colmap_model(rng)
    xyz = rng.normal(size=(7, 3))
    rgb = rng.uniform(0, 255, (7, 3)).astype(np.uint8)
    for pkg in (tcolmap, jcolmap):
        d = tmp_path / pkg.__name__.split(".")[0]
        d.mkdir()
        pkg.write_cameras_binary(cams, str(d / "cameras.bin"))
        pkg.write_images_binary(ims, str(d / "images.bin"))
        pkg.write_points3d_binary(xyz, rgb, str(d / "points3D.bin"))
        assert (d / "images.bin").read_bytes() == (
            tmp_path / "fourdgs_tpu_torch" / "images.bin").read_bytes()
        for reader in (tcolmap, jcolmap):
            c = reader.read_cameras_binary(str(d / "cameras.bin"))[1]
            i = reader.read_images_binary(str(d / "images.bin"))[1]
            x, r, e = reader.read_points3d_binary(str(d / "points3D.bin"))
            assert (c.model, c.width, c.height) == ("PINHOLE", 640, 480)
            np.testing.assert_array_equal(c.params, cams[1].params)
            assert (i.name, i.camera_id) == ("frame_00001.jpg", 1)
            for a, b in ((i.qvec, ims[1].qvec), (i.tvec, ims[1].tvec),
                         (i.xys, ims[1].xys), (x, xyz), (r, rgb),
                         (e, np.zeros(7))):
                np.testing.assert_array_equal(a, b)


def test_colmap_text_files_match_jax(tmp_path):
    """test_data.TestColmap's text parsers, an empty points2D row kept."""
    (tmp_path / "cameras.txt").write_text(
        "# comment\n1 PINHOLE 640 480 500.0 510.0 320.0 240.0\n")
    (tmp_path / "images.txt").write_text(
        "# comment\n1 1 0 0 0 0.5 0.5 0.5 1 img.png\n1.0 2.0 3\n"
        "2 1 0 0 0 0.1 0.2 0.3 1 b.png\n\n")
    (tmp_path / "points3D.txt").write_text(
        "# comment\n4 1.0 2.0 3.0 255 0 10 0.5 1 0\n")
    for name in ("cameras", "images"):
        a = getattr(jcolmap, f"read_{name}_text")(
            str(tmp_path / f"{name}.txt"))
        b = getattr(tcolmap, f"read_{name}_text")(
            str(tmp_path / f"{name}.txt"))
        assert a.keys() == b.keys()
        for k in a:
            for x, y in zip(a[k], b[k]):
                np.testing.assert_array_equal(np.asarray(y), np.asarray(x))
    points = str(tmp_path / "points3D.txt")
    for x, y in zip(jcolmap.read_points3d_text(points),
                    tcolmap.read_points3d_text(points)):
        np.testing.assert_array_equal(y, x)


def test_qvec_round_trip_matches_jax():
    rng = np.random.default_rng(3)
    for _ in range(5):
        q = rng.normal(size=4)
        q /= np.linalg.norm(q)
        q *= np.sign(q[0])
        R = tcolmap.qvec2rotmat(q)
        np.testing.assert_array_equal(R, jcolmap.qvec2rotmat(q))
        np.testing.assert_allclose(tcolmap.rotmat2qvec(R), q, atol=1e-6)
        np.testing.assert_array_equal(tcolmap.rotmat2qvec(R),
                                      jcolmap.rotmat2qvec(R))


@pytest.mark.parametrize("ext", [".bin", ".txt"])
def test_read_write_model_matches_jax(tmp_path, ext):
    """test_data.TestColmapModelConversion's model through the port's
    write_model: JAX's read_model reads it back equal, and the port's
    read_model reads JAX's files equal; point ids and tracks survive."""
    model = test_data.TestColmapModelConversion()._model()
    tcolmap.write_model(*model, str(tmp_path / "port"), ext=ext)
    jcolmap.write_model(*model, str(tmp_path / "jax"), ext=ext)
    for name in ("cameras", "images", "points3D"):
        assert (tmp_path / "port" / f"{name}{ext}").read_bytes() == (
            tmp_path / "jax" / f"{name}{ext}").read_bytes()
    checker = test_data.TestColmapModelConversion()
    checker._assert_equal(model, jcolmap.read_model(str(tmp_path / "port")))
    checker._assert_equal(model, tcolmap.read_model(str(tmp_path / "jax")))
    with pytest.raises(FileNotFoundError):
        tcolmap.read_model(str(tmp_path))


# ---------------------------------------------------------------------------
# the readers
# ---------------------------------------------------------------------------

def _write_colmap_fixture(root, text=False, model="PINHOLE", n=11,
                          images_dir="images"):
    """A COLMAP capture of n views whose image ids run against their names
    (so that `time` follows the extrinsics' order, not the sorted one),
    PIL-written JPEGs, in binary or text files."""
    rng = np.random.default_rng(1)
    sparse = root / "sparse" / "0"
    sparse.mkdir(parents=True)
    params = {"PINHOLE": [30.0, 34.0, 12.0, 8.0], "SIMPLE_PINHOLE":
              [30.0, 12.0, 8.0], "SIMPLE_RADIAL": [30.0, 12.0, 8.0, 0.0],
              "OPENCV": [30.0, 33.0, 12.0, 8.0, 0, 0, 0, 0],
              "RADIAL": [30.0, 12.0, 8.0, 0.0, 0.0]}[model]
    cams = {3: jcolmap.ColmapCamera(id=3, model=model, width=24, height=16,
                                    params=np.array(params))}
    ims = {}
    for i in range(n):
        q = rng.normal(size=4)
        q /= np.linalg.norm(q)
        iid = n - i
        ims[iid] = jcolmap.ColmapImage(
            id=iid, qvec=q, tvec=rng.normal(size=3), camera_id=3,
            name=f"sub/img_{(7 * i) % n:03d}.jpg", xys=np.zeros((0, 2)),
            point3D_ids=np.zeros(0, np.int64))
        pixels = rng.integers(0, 256, (16, 24, 3), dtype=np.uint8)
        Image.fromarray(pixels).save(
            root / images_dir / f"img_{(7 * i) % n:03d}.jpg")
    xyz = rng.normal(size=(20, 3))
    rgb = rng.uniform(0, 255, (20, 3)).astype(np.uint8)
    if text:
        jcolmap.write_cameras_text(cams, str(sparse / "cameras.txt"))
        jcolmap.write_images_text(ims, str(sparse / "images.txt"))
        with open(sparse / "points3D.txt", "w") as f:
            for i, (p, c) in enumerate(zip(xyz, rgb)):
                f.write(f"{i} {p[0]} {p[1]} {p[2]} {c[0]} {c[1]} {c[2]} 0\n")
    else:
        jcolmap.write_cameras_binary(cams, str(sparse / "cameras.bin"))
        jcolmap.write_images_binary(ims, str(sparse / "images.bin"))
        jcolmap.write_points3d_binary(xyz, rgb, str(sparse / "points3D.bin"))


def _colmap_root(tmp_path, images_dir="images", **kw):
    (tmp_path / images_dir).mkdir()
    _write_colmap_fixture(tmp_path, images_dir=images_dir, **kw)
    return tmp_path


@pytest.mark.parametrize("text", [False, True], ids=["bin", "txt"])
def test_read_colmap_scene_matches_jax(tmp_path, text):
    """Binary first, then text; uid = the camera id; time = the index in
    the extrinsics' order over their count, before the sort by name; every
    8th view of the sorted list a test view; points3D converted to PLY."""
    root = _colmap_root(tmp_path, text=text)
    b = tcolmap_scene.read_colmap_scene(str(root), None, True)
    ply = root / "sparse" / "0" / "points3D.ply"
    assert ply.exists()
    a = jcolmap_scene.read_colmap_scene(str(root), None, True)
    _assert_scene_info_equal(a, b)
    assert all(i.image is None for i in b.train_cameras)
    names = [i.image_name for i in b.test_cameras + b.train_cameras]
    assert [i.image_name for i in b.test_cameras] == ["img_000", "img_008"]
    assert len(b.train_cameras) == 9 and sorted(names) == [
        f"img_{i:03d}" for i in range(11)]
    times = {i.image_name: i.time for i in b.train_cameras + b.test_cameras}
    assert times["img_007"] == 1 / 11      # the second extrinsic
    assert {i.uid for i in b.train_cameras} == {3}
    assert b.maxtime == 0 and b.video_cameras == b.train_cameras
    # fx != fy: the fields of view differ; the principal point is unused
    cam = b.train_cameras[0]
    assert cam.fovx != cam.fovy
    c = tcolmap_scene.read_colmap_scene(str(root), None, False)
    assert len(c.train_cameras) == 11 and c.test_cameras == []


@pytest.mark.parametrize("model", ["SIMPLE_PINHOLE", "SIMPLE_RADIAL",
                                   "OPENCV", "RADIAL"])
def test_colmap_camera_models_match_jax(tmp_path, model):
    root = _colmap_root(tmp_path, model=model, n=3)
    if model == "RADIAL":
        for pkg in (jcolmap_scene, tcolmap_scene):
            with pytest.raises(ValueError, match="RADIAL"):
                pkg.read_colmap_scene(str(root), None, True)
        return
    _assert_scene_info_equal(
        jcolmap_scene.read_colmap_scene(str(root), None, True),
        tcolmap_scene.read_colmap_scene(str(root), None, True))


def test_load_scene_info_passes_images_and_llffhold(tmp_path):
    """`images` names the image directory and `llffhold` the stride, as
    the JAX package's load_scene_info takes them."""
    root = _colmap_root(tmp_path, images_dir="images_4")
    kw = dict(images="images_4", llffhold=4)
    a, ka = jscene.load_scene_info(str(root), **kw)
    b, kb = tscene.load_scene_info(str(root), **kw)
    assert ka == kb == "Colmap"
    _assert_scene_info_equal(a, b)
    assert len(b.test_cameras) == 3
    assert b.train_cameras[0].image_path.startswith(str(root / "images_4"))


def test_read_multipleview_scene_on_jax_fixture(tmp_path):
    """test_data's rig: camera 1's intrinsics for all, frames counted in
    cam01, the test frames 0, n // 3 and 2n // 3, no spiral file."""
    test_data.TestMultiviewAndColmapScene()._write_rig(tmp_path)
    a = jmultiview.read_multipleview_scene(str(tmp_path), load_images=True)
    b = tmultiview.read_multipleview_scene(str(tmp_path))
    _assert_scene_info_equal(a, b)
    assert len(b.train_cameras) == 8 and len(b.test_cameras) == 6
    assert [i.time for i in b.test_cameras[:3]] == [0.0, 0.25, 0.5]
    assert b.video_cameras == b.test_cameras


def test_read_multipleview_scene_on_writer_output(written):
    root = written["multipleview"]
    a = jmultiview.read_multipleview_scene(str(root), load_images=True)
    b = tmultiview.read_multipleview_scene(str(root))
    _assert_scene_info_equal(a, b)
    assert len(b.train_cameras) == 4 * 4 and len(b.video_cameras) == 300
    assert b.train_cameras[4].image_path.endswith("cam02/frame_00001.jpg")
    # the writer's poses are the reader's
    for i, pos in enumerate(chip_smoke.DYNERF_RIG):
        np.testing.assert_allclose(
            b.train_cameras[4 * i].R,
            chip_smoke.look_at(pos, chip_smoke.DYNERF_OFFSET).T, atol=1e-9)


def _write_panoptic_fixture(root):
    """test_data.TestPanopticReader's sequence: one camera, 3 timesteps,
    16px PIL-written JPEGs."""
    rng = np.random.default_rng(0)
    size = 16
    os.makedirs(root / "ims/c0", exist_ok=True)
    k = [[100.0, 0, 8], [0, 100.0, 8], [0, 0, 1]]
    fns, ks, w2cs = [], [], []
    for t in range(3):
        arr = rng.uniform(0, 255, (size, size, 3)).astype(np.uint8)
        Image.fromarray(arr).save(root / f"ims/c0/{t}.jpg")
        fns.append([f"c0/{t}.jpg"])
        ks.append([k])
        w2c = np.eye(4)
        w2c[2, 3] = 3.0
        w2cs.append([w2c.tolist()])
    meta = {"w": size, "h": size, "fn": fns, "k": ks, "w2c": w2cs,
            "cam_id": [[0], [0], [0]]}
    for name in ("train_meta.json", "test_meta.json"):
        with open(root / name, "w") as f:
            json.dump(meta, f)
    data = np.concatenate(
        [rng.normal(size=(20, 3)), rng.uniform(0, 1, (20, 3)),
         np.ones((20, 1))], axis=1)
    np.savez(root / "init_pt_cld.npz", data=data)


def _assert_panoptic_infos_equal(a, b):
    assert len(a) == len(b) > 0
    for x, y in zip(a, b):
        assert isinstance(y, tpanoptic.PanopticCameraInfo)
        assert (y.width, y.height, y.time, y.image_name) == (
            x["width"], x["height"], x["time"], x["image_name"])
        cam = tpanoptic.camera_from_k_w2c(y.k, y.w2c, y.width, y.height,
                                          time=y.time, device="cpu")
        for p, q in zip(_jax_camera_arrays(x["camera"]),
                        _port_camera_arrays(cam)):
            np.testing.assert_allclose(q, p, atol=1e-6)
        if x["image"] is not None:
            np.testing.assert_array_equal(images.load_image(
                y.image, y.image_path, (y.width, y.height)), x["image"])


def _assert_panoptic_scene_info_equal(a, b):
    assert a.maxtime == b.maxtime
    for split in ("train_cameras", "test_cameras", "video_cameras"):
        _assert_panoptic_infos_equal(getattr(a, split), getattr(b, split))
    assert b.nerf_normalization["radius"] == a.nerf_normalization["radius"]
    np.testing.assert_array_equal(b.nerf_normalization["translate"],
                                  a.nerf_normalization["translate"])
    assert b.ply_path == a.ply_path
    for f in ("points", "colors", "normals"):
        np.testing.assert_array_equal(getattr(b.point_cloud, f),
                                      getattr(a.point_cloud, f))


def test_read_panoptic_scene_on_jax_fixture(tmp_path):
    _write_panoptic_fixture(tmp_path)
    a = jpanoptic.read_panoptic_scene(str(tmp_path), load_images=True)
    b = tpanoptic.read_panoptic_scene(str(tmp_path))
    _assert_panoptic_scene_info_equal(a, b)
    assert b.maxtime == 3 and b.video_cameras == b.test_cameras
    assert (tmp_path / "pointd3D.ply").exists()


def test_read_panoptic_scene_on_writer_output(written):
    """The writer's dome: K's principal points off centre by up to 6 % of
    the width and height, which full_proj's x and y rows carry."""
    root = written["panoptic"]
    a = jpanoptic.read_panoptic_scene(str(root), load_images=True)
    b = tpanoptic.read_panoptic_scene(str(root))
    _assert_panoptic_scene_info_equal(a, b)
    assert len(b.train_cameras) == 4 * 3 and len(b.test_cameras) == 3
    w, h = SIZES["panoptic"]
    for info, (dx, dy) in zip(b.train_cameras[:4], chip_smoke.PANOPTIC_SHIFT):
        np.testing.assert_allclose(info.k[:2, 2],
                                   [w / 2 + dx * w, h / 2 + dy * h])
        full = tpanoptic.projection_from_k_w2c(info.k, info.w2c, w, h)[1]
        proj = full @ np.linalg.inv(info.w2c)
        np.testing.assert_allclose(proj[:2, 2], [2 * dx, 2 * dy], atol=1e-12)


def test_read_colmap_scene_on_writer_output(written):
    root = written["colmap"]
    b = tcolmap_scene.read_colmap_scene(str(root), None, True)
    a = jcolmap_scene.read_colmap_scene(str(root), None, True)
    _assert_scene_info_equal(a, b)
    assert [i.image_name for i in b.test_cameras] == ["00000", "00008"]
    assert b.train_cameras[0].fovy < b.train_cameras[0].fovx * 0.76


@pytest.mark.parametrize("downscale", [1, 2])
@pytest.mark.parametrize("kind", sorted(SIZES))
def test_scene_load_matches_jax(written, kind, downscale):
    root = str(written[kind])
    a = jscene.Scene.load(root, downscale=downscale)
    b = tscene.Scene.load(root, downscale=downscale, device="cpu")
    w, h = SIZES[kind]
    assert (b.train.width, b.train.height) == (w // downscale,
                                               h // downscale)
    _assert_scenes_equal(a, b)


@pytest.mark.parametrize("mode", ["device", "host", "lazy"])
def test_stack_cameras_decodes_in_processes_alike(written, monkeypatch,
                                                  mode):
    """A device or host split over STACK_POOL_PIXELS decodes on the
    DECODE_WORKERS threads (once processes) to the same arrays, bit for
    bit, as on the calling thread; a lazy split is not decoded when it is
    stacked."""
    info, _ = tscene.load_scene_info(str(written["multipleview"]))
    budgets = {"device": {}, "host": {"device_budget": 0},
               "lazy": {"device_budget": 0, "host_budget": 0}}[mode]
    pooled = []
    if mode == "lazy":
        def refuse(*args):
            raise AssertionError("a lazy split was decoded when stacked")
        monkeypatch.setattr(tscene, "_pooled_u8", refuse)
    else:
        real = tscene._pooled_u8

        def recorded(*args):
            out = real(*args)
            pooled.append(out is not None)
            return out
        monkeypatch.setattr(tscene, "_pooled_u8", recorded)
    got = {}
    for route, limit in (("thread", 1 << 62), ("pool", 0)):
        monkeypatch.setattr(tscene, "STACK_POOL_PIXELS", limit)
        split = tscene.stack_cameras(info.train_cameras, CPU, downscale=2,
                                     **budgets)
        assert split.images.mode == mode
        idxs = np.arange(len(split))
        got[route] = split.images[idxs].numpy()
        split.images.close()
    if mode != "lazy":
        assert pooled == [False, True]
    np.testing.assert_array_equal(got["pool"], got["thread"])


def test_readers_keep_infos_free_of_tensors(written):
    """The Panoptic views hold numpy and plain values only, and survive a
    pickle round trip."""
    import pickle
    info, _ = tscene.load_scene_info(str(written["panoptic"]))
    for v in info.train_cameras:
        assert not any(isinstance(x, torch.Tensor) for x in v)
    again = pickle.loads(pickle.dumps(info.train_cameras))
    np.testing.assert_array_equal(again[0].k, info.train_cameras[0].k)


def test_train_and_render_clis_pass_images_and_llffhold(tmp_path,
                                                       monkeypatch):
    """The train and render CLIs hand the config's `images` and `llffhold`
    to Scene.load, as scripts/train.py does."""
    from fourdgs_tpu_torch.tools import render as render_cli
    from fourdgs_tpu_torch.tools import train as train_cli

    class Loaded(Exception):
        pass

    class StubScene:
        @staticmethod
        def load(path, **kw):
            raise Loaded(kw)

    for cli in (train_cli, render_cli):
        monkeypatch.setattr(cli, "Scene", StubScene)
    model = tmp_path / "m"
    with pytest.raises(Loaded) as got:
        train_cli.main(["-s", str(tmp_path), "-m", str(model), "--device",
                        "cpu", "--images", "images_4", "--llffhold", "4"])
    assert (got.value.args[0]["images"], got.value.args[0]["llffhold"]) == (
        "images_4", 4)
    with pytest.raises(Loaded) as got:
        render_cli.main(["-m", str(model), "--device", "cpu"])
    assert (got.value.args[0]["images"], got.value.args[0]["llffhold"]) == (
        "images_4", 4)
