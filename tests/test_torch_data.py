"""Port parity for the data layer: the PNG codec (data/png.py), the Blender
reader (data/blender.py) and the scene facade (data/scene.py).

The codec has no counterpart in the JAX package, which decodes with PIL:
it is held byte for byte against PIL on files PIL wrote (PIL picks a row
filter per row) and on files written here with each of the five row
filters. The readers are held against the JAX package's on
tests/test_data.py's 32px fixture: cameras to 1e-6, images, times and the
normalisation equal.
"""
import json
import struct
import zlib

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from fourdgs_tpu.data import blender as jblender
from fourdgs_tpu.data import scene as jscene
from fourdgs_tpu_torch.data import blender as tblender
from fourdgs_tpu_torch.data import png
from fourdgs_tpu_torch.data import scene as tscene
from tests.test_data import write_blender_fixture

torch.set_num_threads(1)


def _image(channels, seed=0, h=23, w=31):
    """Half smooth gradients (which filters predict well), half noise."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    smooth = np.stack([x * 7, y * 9, (x + y) * 4, 250 - 3 * x], -1) % 256
    noise = rng.integers(0, 256, (h, w, 4))
    img = np.where((y < h // 2)[..., None], smooth, noise).astype(np.uint8)
    return img[..., :channels]


def _filter_rows(img, filters):
    """The PNG row filter filters[r] applied to each row r (the
    specification's definitions, on the original bytes)."""
    h, w, ch = img.shape
    x = img.reshape(h, w * ch).astype(np.int32)
    out = np.empty((h, w * ch + 1), np.uint8)
    for r in range(h):
        cur = x[r]
        up = x[r - 1] if r else np.zeros_like(cur)
        left = np.concatenate([np.zeros(ch, np.int32), cur[:-ch]])
        ul = np.concatenate([np.zeros(ch, np.int32), up[:-ch]])
        f = filters[r]
        if f == 0:
            pred = 0
        elif f == 1:
            pred = left
        elif f == 2:
            pred = up
        elif f == 3:
            pred = (left + up) >> 1
        else:
            p = left + up - ul
            pa, pb, pc = abs(p - left), abs(p - up), abs(p - ul)
            pred = np.where((pa <= pb) & (pa <= pc), left,
                            np.where(pb <= pc, up, ul))
        out[r, 0] = f
        out[r, 1:] = (cur - pred) & 255
    return out


def _write_raw_png(path, w, h, ctype, raw, depth=8, interlace=0):
    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        f.write(chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, ctype, 0,
                                           0, interlace)))
        f.write(chunk(b"IDAT", zlib.compress(raw.tobytes())))
        f.write(chunk(b"IEND", b""))


def _row_filters(path):
    with open(path, "rb") as f:
        data = f.read()
    pos, idat, w = 8, b"", 0
    while pos < len(data):
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        if kind == b"IHDR":
            w, h = struct.unpack(">II", data[pos + 8:pos + 16])
        if kind == b"IDAT":
            idat += data[pos + 8:pos + 8 + length]
        pos += 12 + length
    raw = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, -1)
    return set(raw[:, 0].tolist())


@pytest.mark.parametrize("channels", [3, 4])
def test_png_round_trip(tmp_path, channels):
    img = _image(channels)
    path = str(tmp_path / "a.png")
    png.write_png(path, img)
    np.testing.assert_array_equal(png.read_png(path), img)
    np.testing.assert_array_equal(np.asarray(Image.open(path)), img)


@pytest.mark.parametrize("channels", [3, 4])
def test_png_reads_pil_files(tmp_path, channels):
    """PIL chooses a filter per row; several kinds appear in one file."""
    img = _image(channels, seed=1, h=40, w=50)
    path = str(tmp_path / "pil.png")
    Image.fromarray(img, "RGB" if channels == 3 else "RGBA").save(path)
    assert len(_row_filters(path)) >= 3
    np.testing.assert_array_equal(png.read_png(path),
                                  np.asarray(Image.open(path)))


@pytest.mark.parametrize("channels", [3, 4])
@pytest.mark.parametrize("filters", ["0", "1", "2", "3", "4", "mixed"])
def test_png_decodes_every_filter(tmp_path, channels, filters):
    """Files whose rows all carry one filter, or filters 0-4 in turn:
    equal to the image and to PIL's decoding, byte for byte."""
    img = _image(channels, seed=2)
    h, w = img.shape[:2]
    kinds = ([int(filters)] * h if filters != "mixed"
             else [r % 5 for r in range(h)])
    path = str(tmp_path / "f.png")
    _write_raw_png(path, w, h, 2 if channels == 3 else 6,
                   _filter_rows(img, kinds))
    got = png.read_png(path)
    np.testing.assert_array_equal(got, img)
    np.testing.assert_array_equal(got, np.asarray(Image.open(path)))


def test_png_refuses_what_it_does_not_read(tmp_path):
    """16-bit, palette, greyscale and interlaced files raise."""
    rgb = _image(3)
    cases = {
        "i16.png": Image.fromarray(rgb[..., 0].astype(np.uint16) * 257),
        "p.png": Image.fromarray(rgb, "RGB").convert("P"),
        "l.png": Image.fromarray(rgb[..., 0], "L"),
    }
    for name, im in cases.items():
        im.save(tmp_path / name)
    h, w = rgb.shape[:2]
    _write_raw_png(tmp_path / "interlaced.png", w, h, 2,
                   _filter_rows(rgb, [0] * h), interlace=1)
    for name in list(cases) + ["interlaced.png"]:
        with pytest.raises(ValueError, match="only 8-bit"):
            png.read_png(str(tmp_path / name))
    with pytest.raises(ValueError, match="uint8"):
        png.write_png(str(tmp_path / "x.png"), rgb.astype(np.float32))


def _jax_camera_arrays(cam):
    return [np.asarray(x) for x in (cam.world_view, cam.full_proj,
                                    cam.cam_center, cam.tanfovx,
                                    cam.tanfovy, cam.time)]


def _port_camera_arrays(cam):
    return [x.numpy() for x in (cam.world_view, cam.full_proj,
                                cam.cam_center, cam.tanfovx, cam.tanfovy,
                                cam.time)]


@pytest.mark.parametrize("white", [True, False])
def test_read_blender_scene_matches_jax(tmp_path, white):
    write_blender_fixture(tmp_path, n_frames=5)
    # an RGB file among the RGBA ones (PIL's convert("RGBA") adds alpha 255)
    rgb = np.asarray(Image.open(tmp_path / "train/r_1.png"))[..., :3]
    Image.fromarray(rgb, "RGB").save(tmp_path / "train/r_1.png")
    kw = dict(white_background=white, eval_split=True, resolution=(32, 32))
    a = jblender.read_blender_scene(str(tmp_path), **kw)
    b = tblender.read_blender_scene(str(tmp_path), **kw)
    assert a.maxtime == b.maxtime
    for split in ("train_cameras", "test_cameras", "video_cameras"):
        ca, cb = getattr(a, split), getattr(b, split)
        assert len(ca) == len(cb) > 0
        for x, y in zip(ca, cb):
            np.testing.assert_allclose(y.R, x.R, atol=1e-6)
            np.testing.assert_allclose(y.T, x.T, atol=1e-6)
            assert (y.fovx, y.fovy, y.time) == pytest.approx(
                (x.fovx, x.fovy, x.time), abs=1e-6)
            assert (y.width, y.height, y.image_name) == (
                x.width, x.height, x.image_name)
            if x.image is None:
                assert y.image is None
            else:
                assert y.image.dtype == np.float32
                np.testing.assert_array_equal(y.image, x.image)
    np.testing.assert_array_equal(b.nerf_normalization["translate"],
                                  a.nerf_normalization["translate"])
    assert b.nerf_normalization["radius"] == a.nerf_normalization["radius"]
    for f in ("points", "colors", "normals"):
        np.testing.assert_array_equal(getattr(b.point_cloud, f),
                                      getattr(a.point_cloud, f))


def test_scene_load_matches_jax(tmp_path):
    write_blender_fixture(tmp_path, n_frames=6)
    kw = dict(white_background=True, eval_split=True, resolution=(32, 32))
    a = jscene.Scene.load(str(tmp_path), **kw)
    b = tscene.Scene.load(str(tmp_path), device="cpu", **kw)
    assert b.dataset_type == a.dataset_type == "Blender"
    assert b.cameras_extent == a.cameras_extent
    assert b.maxtime == a.maxtime
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
        got = getattr(b, split).images
        want = np.asarray(getattr(a, split).images[np.arange(len(got))])
        assert got.mode == "device" and got.shape == want.shape
        np.testing.assert_array_equal(got[np.arange(len(got))].numpy(), want)
        np.testing.assert_array_equal(got[[1, 0]].numpy(), want[[1, 0]])
    assert b.video.images is None


def test_readers_refuse_what_is_not_ported(tmp_path):
    write_blender_fixture(tmp_path, n_frames=2)
    with pytest.raises(ValueError, match="r_0.png is 32x32, not 800x800"):
        tblender.read_blender_scene(str(tmp_path), True, True)
    with pytest.raises(NotImplementedError, match="downscale"):
        tscene.Scene.load(str(tmp_path), downscale=2, device="cpu",
                          resolution=(32, 32))
    colmap = tmp_path / "colmap"
    (colmap / "sparse").mkdir(parents=True)
    with pytest.raises(NotImplementedError, match="Colmap"):
        tscene.load_scene_info(str(colmap))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            tscene.Scene.load(str(tmp_path), resolution=(32, 32))


def test_read_timeline_matches_jax(tmp_path):
    """read_timeline normalises over both splits' times, as the JAX
    package's does."""
    write_blender_fixture(tmp_path, n_frames=4)
    with open(tmp_path / "transforms_test.json") as f:
        test = json.load(f)
    test["frames"][0]["time"] = 3.0
    with open(tmp_path / "transforms_test.json", "w") as f:
        json.dump(test, f)
    assert tblender.read_timeline(str(tmp_path)) == \
        jblender.read_timeline(str(tmp_path))
