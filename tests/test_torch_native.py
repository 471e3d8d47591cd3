"""The port's host library (fourdgs_tpu_torch/native, csrc/host/*.cpp)
against Pillow, which the JAX package decodes and resizes with, and
against the plain versions beside each caller, bit for bit; its COLMAP
readers against the JAX package's Python readers.

  * PNG: the five row filters (and all five in turn) x colour types 0, 2
    and 6 x odd widths;
  * JPEG: baseline, SOF1 (16-bit tables) and progressive x 4:4:4, 4:2:2,
    4:2:0 and greyscale x quality 75 and 95 at 104x86 and 37x53; restart
    intervals; the progressive fixtures of tests/jpeg_fixtures, whose
    Pillow pixels' sha256 pillow_pixels.json keeps for the card machine,
    which has no Pillow;
  * LANCZOS and BICUBIC: down, up, one axis only, 1, 3 and 4 channels
    (Pillow's RGBX for four independent channels);
  * points3D.bin of 0 and 1 points, long tracks and 100k points against
    JAX's Python reader; images.bin's poses against JAX's
    `read_images_binary`;
  * corrupt and truncated files raise, naming the file; a missing C++
    compiler raises, and nothing falls back to numpy; the build compiles
    the port's sources alone, once among concurrent processes; decoding
    on many threads at once gives the one-thread bytes;
  * a COLMAP capture whose views are progressive JPEGs loads through
    `Scene.load` as JAX's reader (PIL) loads it.
"""
import hashlib
import io
import json
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

import chip_smoke
import fourdgs_tpu.native as jnative
from fourdgs_tpu.data import colmap as jcolmap
from fourdgs_tpu.data import scene as jscene
from fourdgs_tpu_torch import native
from fourdgs_tpu_torch.data import colmap, images, jpeg, png, resample
from fourdgs_tpu_torch.data import scene as tscene
from fourdgs_tpu_torch.native import build
from tests._torch_routes import route  # noqa: F401
from tests.test_torch_data import _filter_rows, _write_raw_png
from tests.test_torch_readers import _assert_scenes_equal

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
FIXTURES = ROOT / "tests" / "jpeg_fixtures"
MANIFEST = json.loads((FIXTURES / "pillow_pixels.json").read_text())
PIL_SAMPLING = {"4:4:4": 0, "4:2:2": 1, "4:2:0": 2}
SOF = {"baseline": b"\xff\xc0", "sof1": b"\xff\xc1",
       "progressive": b"\xff\xc2"}


def _pil_decode(data: bytes) -> np.ndarray:
    return np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))


# ---------------------------------------------------------------------------
# PNG
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("width", [1, 7, 33])
@pytest.mark.parametrize("ctype", [0, 2, 6])
@pytest.mark.parametrize("filters", ["0", "1", "2", "3", "4", "mixed"])
def test_png_unfilter_equals_pillow_and_plain(tmp_path, filters, ctype,
                                              width):
    ch = {0: 1, 2: 3, 6: 4}[ctype]
    h = 9
    rng = np.random.default_rng(10 * width + ctype)
    img = rng.integers(0, 256, (h, width, ch), dtype=np.uint8)
    y, x, c = np.mgrid[0:h // 2, 0:width, 0:ch]
    img[:h // 2] = (9 * x + 5 * y + 40 * c) % 256     # predictable rows
    kinds = ([int(filters)] * h if filters != "mixed"
             else [r % 5 for r in range(h)])
    raw = _filter_rows(img, kinds)
    path = tmp_path / "f.png"
    _write_raw_png(path, width, h, ctype, raw)
    want = np.asarray(Image.open(path))
    got = png.read_png(str(path))
    assert got.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    unfiltered = native.png_unfilter(raw, ch)
    np.testing.assert_array_equal(unfiltered, png.unfilter_plain(raw, ch))
    np.testing.assert_array_equal(unfiltered, img.reshape(h, width * ch))


# ---------------------------------------------------------------------------
# JPEG
# ---------------------------------------------------------------------------

def _sof1_tables(quality: int, n: int) -> list:
    """libjpeg's tables at `quality`, one entry raised past 255 so that
    the file carries 16-bit tables and an SOF1 frame."""
    tables = []
    for base in (jpeg._LUMA_Q, jpeg._CHROMA_Q)[:n]:
        t = jpeg.quality_table(base, quality).tolist()
        t[63] = 300
        tables.append(t)
    return tables


def _encode(img, kind: str, sampling: str, quality: int, **extra) -> bytes:
    grey = img.ndim == 2
    kw = dict(extra)
    if not grey:
        kw["subsampling"] = PIL_SAMPLING[sampling]
    if kind == "sof1":
        kw["qtables"] = _sof1_tables(quality, 1 if grey else 2)
    else:
        kw["quality"] = quality
    if kind == "progressive":
        kw["progressive"] = True
    b = io.BytesIO()
    Image.fromarray(img).save(b, "JPEG", **kw)
    data = b.getvalue()
    assert SOF[kind] in data
    return data


def _assert_decoders_equal_pillow(data: bytes) -> None:
    want = _pil_decode(data)
    got = native.decode_jpeg(data)
    plain = jpeg.decode_jpeg_plain(data)
    for x in (got, plain):
        assert x.dtype == np.uint8 and x.shape == want.shape
        np.testing.assert_array_equal(x, want)


JPEG_SIZES = [(86, 104), (53, 37)]


@pytest.mark.parametrize("size", JPEG_SIZES,
                         ids=[f"{w}x{h}" for h, w in JPEG_SIZES])
@pytest.mark.parametrize("quality", [75, 95])
@pytest.mark.parametrize("sampling", ["4:4:4", "4:2:2", "4:2:0", "grey"])
@pytest.mark.parametrize("kind", ["baseline", "sof1", "progressive"])
def test_jpeg_decode_equals_pillow_and_plain(kind, sampling, quality, size):
    img = chip_smoke.photo_like(size + (3,), sum(size) + quality)
    if sampling == "grey":
        img = img[..., 0]
    _assert_decoders_equal_pillow(_encode(img, kind, sampling, quality))


@pytest.mark.parametrize("restart", [{"restart_marker_blocks": 1},
                                     {"restart_marker_blocks": 5},
                                     {"restart_marker_rows": 2}],
                         ids=["blocks-1", "blocks-5", "rows-2"])
@pytest.mark.parametrize("kind", ["baseline", "progressive"])
def test_jpeg_restart_intervals_equal_pillow(kind, restart):
    """Restart markers reset the DC predictors (and a progressive scan's
    EOB run) and start each interval byte-aligned."""
    img = chip_smoke.photo_like((61, 83, 3), 7)
    for sampling in ("4:2:0", "4:2:2"):
        data = _encode(img, kind, sampling, 90, **restart)
        assert b"\xff\xdd" in data
        _assert_decoders_equal_pillow(data)


@pytest.mark.parametrize("q", [65535, 20000, 4000])
def test_jpeg_wide_dequantised_values_equal_plain(q):
    """A file whose 16-bit tables are rewritten to q after encoding:
    dequantised values past what the int32 IDCT keeps exact (|coef q| or
    a column's output above 32,767) take the int64 IDCT, which must give
    the plain version's bytes (no encoder writes such a file, and
    libjpeg-turbo's 16-bit SIMD arithmetic wraps there, so Pillow is not
    the reference)."""
    img = np.random.default_rng(q).integers(0, 256, (24, 40, 3),
                                            dtype=np.uint8)
    data = bytearray(_encode(img, "sof1", "4:4:4", 90))
    pos = data.index(b"\xff\xdb")
    n = int.from_bytes(data[pos + 2:pos + 4], "big")
    for t in range(pos + 4, pos + 2 + n, 129):
        assert data[t] >> 4 == 1                      # a 16-bit table
        data[t + 1:t + 129] = q.to_bytes(2, "big") * 64
    got = native.decode_jpeg(bytes(data))
    np.testing.assert_array_equal(got, jpeg.decode_jpeg_plain(bytes(data)))
    assert got.std() > 0


@pytest.mark.parametrize("name", sorted(MANIFEST))
def test_progressive_fixtures_equal_pillows_pixels(name, route):
    """tests/jpeg_fixtures: Pillow's pixels of each file hash to the
    manifest's sha256 (which chip_smoke.py's phase 18 checks on the card),
    and so do the decoder's."""
    path = FIXTURES / name
    assert path.stat().st_size < 64 << 10
    want = MANIFEST[name]
    pil = np.asarray(Image.open(path).convert("RGB"))
    got = jpeg.read_jpeg(str(path))
    for x in (pil, got):
        assert list(x.shape) == want["shape"]
        assert hashlib.sha256(x.tobytes()).hexdigest() == want["sha256"]


def test_progressive_fixtures_stay_small():
    total = sum(p.stat().st_size for p in FIXTURES.iterdir())
    assert total < 256 << 10 and len(MANIFEST) >= 4


# ---------------------------------------------------------------------------
# resampling
# ---------------------------------------------------------------------------

# (H, W) in, (W, H) out: down, up, the width alone, the height alone
RESAMPLE_CASES = [((48, 64), (24, 32)), ((24, 32), (61, 45)),
                  ((30, 40), (13, 30)), ((30, 40), (40, 17))]
PIL_MODES = {1: "L", 3: "RGB", 4: "RGBX"}


@pytest.mark.parametrize("channels", [1, 3, 4])
@pytest.mark.parametrize("filt,pil", [("lanczos", Image.LANCZOS),
                                      ("bicubic", Image.BICUBIC)],
                         ids=["lanczos", "bicubic"])
@pytest.mark.parametrize("shape,size", RESAMPLE_CASES,
                         ids=["down", "up", "width", "height"])
def test_resample_equals_pillow_and_plain(shape, size, filt, pil, channels):
    rng = np.random.default_rng(channels * 100 + size[0])
    img = rng.integers(0, 256, shape + (channels,), dtype=np.uint8)
    im = Image.frombytes(PIL_MODES[channels], shape[::-1], img.tobytes())
    want = np.frombuffer(im.resize(size, pil).tobytes(), np.uint8).reshape(
        size[1], size[0], channels)
    got = native.resample(img, size[0], size[1], filt)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        resample.resample_plain(img, size[0], size[1], filt), want)
    np.testing.assert_array_equal(
        resample.resize(img[..., 0] if channels == 1 else img, size, filt),
        want[..., 0] if channels == 1 else want)


# ---------------------------------------------------------------------------
# COLMAP
# ---------------------------------------------------------------------------

def _points(n: int, tracks, seed: int):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n, 3)), rng.integers(0, 256, (n, 3),
                                                  dtype=np.uint8),
            rng.uniform(0.0, 2.0, n), np.asarray(tracks, np.int64))


POINT_CASES = {"empty": (0, []), "one": (1, [3]),
               "long-tracks": (6, [0, 1, 2, 700, 5000, 5000]),
               "100k": (100_000, np.sort(np.random.default_rng(0).integers(
                   0, 9, 100_000)))}


@pytest.mark.parametrize("case", sorted(POINT_CASES))
def test_points3d_binary_equals_jax_python_reader(tmp_path, monkeypatch,
                                                  case):
    """The native reader, the port's plain one and JAX's Python loop (its
    optional C++ reader is not used: no test builds it) give the same
    float64 arrays."""
    n, tracks = POINT_CASES[case]
    xyz, rgb, err, tracks = _points(n, tracks, len(case))
    path = str(tmp_path / "points3D.bin")
    chip_smoke.write_points3d(Path(path), xyz, rgb, err, tracks, 1)
    monkeypatch.setattr(jnative, "read_points3d_binary", lambda p: None)
    want = jcolmap.read_points3d_binary(path)
    for got in (colmap.read_points3d_binary(path),
                colmap.read_points3d_binary_plain(path)):
        for a, b in zip(got, want):
            assert a.dtype == b.dtype == np.float64 and a.shape == b.shape
            np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(want[0], xyz)
    np.testing.assert_array_equal(want[1], rgb)
    np.testing.assert_array_equal(want[2], err)


def test_image_poses_binary_equal_jax_read_images_binary(tmp_path):
    rng = np.random.default_rng(5)
    ims = {}
    for iid, name, n2d in ((3, "a.jpg", 0), (1, "frame_000001.png", 1),
                           (12, "vue-été/" + "x" * 40 + ".jpg",
                            50)):
        q = rng.normal(size=4)
        ims[iid] = jcolmap.ColmapImage(
            id=iid, qvec=q / np.linalg.norm(q), tvec=rng.normal(size=3),
            camera_id=iid % 4 + 1, name=name, xys=rng.normal(size=(n2d, 2)),
            point3D_ids=rng.integers(-1, 100, n2d))
    path = str(tmp_path / "images.bin")
    jcolmap.write_images_binary(ims, path)
    want = list(jcolmap.read_images_binary(path).values())
    ids, qvec, tvec, cams, names = native.read_image_poses_binary(path)
    assert ids.dtype == cams.dtype == np.int32
    assert ids.tolist() == [w.id for w in want]
    assert cams.tolist() == [w.camera_id for w in want]
    assert names == [w.name for w in want]
    np.testing.assert_array_equal(qvec, np.stack([w.qvec for w in want]))
    np.testing.assert_array_equal(tvec, np.stack([w.tvec for w in want]))


# ---------------------------------------------------------------------------
# errors
# ---------------------------------------------------------------------------

def _corrupt_jpeg(data: bytes, case: str) -> bytes:
    if case == "truncated":
        return data[:len(data) // 2]
    if case == "no-eoi":
        return data[:-2]
    if case == "no-marker":
        return data[:2] + b"\x00" + data[2:]
    # the first scan's data as 1-bits: the all-ones code is never assigned
    sos = data.index(b"\xff\xda")
    start = sos + 2 + int.from_bytes(data[sos + 2:sos + 4], "big")
    return data[:start] + b"\xff\x00" * 64 + b"\xff\xd9"


@pytest.mark.parametrize("case", ["truncated", "no-eoi", "no-marker",
                                  "bad-code"])
@pytest.mark.parametrize("kind", ["baseline", "progressive"])
def test_corrupt_and_truncated_jpegs_raise(tmp_path, kind, case, route):
    data = _encode(chip_smoke.photo_like((40, 56, 3), 2), kind, "4:2:0", 90)
    path = tmp_path / f"{kind}-{case}.jpg"
    path.write_bytes(_corrupt_jpeg(data, case))
    with pytest.raises(ValueError, match=str(path)):
        images.read_rgb(str(path))
    if case == "truncated":
        with pytest.raises(OSError, match="(?i)truncated"):
            Image.open(path).load()


def test_corrupt_and_truncated_files_raise(tmp_path):
    """PNG: a cut IDAT stream and an unknown row filter; COLMAP: a
    points3D.bin and an images.bin that end inside a record."""
    img = chip_smoke.photo_like((12, 16, 3), 3)
    good = tmp_path / "good.png"
    png.write_png(str(good), img, row_filter=4)
    data = good.read_bytes()
    idat = data.index(b"IDAT")
    cut = tmp_path / "cut.png"
    cut.write_bytes(data[:idat + 4 + 40] + data[-12:])
    with pytest.raises(ValueError, match=str(cut)):
        png.read_png(str(cut))
    raw = _filter_rows(img, [4] * 12)
    raw[5, 0] = 7
    bad = tmp_path / "bad.png"
    _write_raw_png(bad, 16, 12, 2, raw)
    with pytest.raises(ValueError, match="row filter"):
        png.read_png(str(bad))
    with pytest.raises(ValueError, match="row filter 7 in row 5"):
        native.png_unfilter(raw, 3)
    xyz, rgb, err, tracks = _points(50, [2] * 50, 0)
    pts = tmp_path / "points3D.bin"
    chip_smoke.write_points3d(pts, xyz, rgb, err, tracks, 0)
    pts.write_bytes(pts.read_bytes()[:-100])
    with pytest.raises(ValueError, match="truncated points3D.bin"):
        colmap.read_points3d_binary(str(pts))
    with pytest.raises(Exception):
        colmap.read_points3d_binary_plain(str(pts))
    ims = tmp_path / "images.bin"
    jcolmap.write_images_binary({1: jcolmap.ColmapImage(
        id=1, qvec=np.ones(4), tvec=np.zeros(3), camera_id=1, name="a.jpg",
        xys=np.zeros((3, 2)), point3D_ids=np.zeros(3, np.int64))}, str(ims))
    ims.write_bytes(ims.read_bytes()[:-10])
    with pytest.raises(ValueError, match="truncated images.bin"):
        native.read_image_poses_binary(str(ims))
    with pytest.raises(OSError):
        colmap.read_points3d_binary(str(tmp_path / "missing.bin"))


# ---------------------------------------------------------------------------
# the build
# ---------------------------------------------------------------------------

def test_a_missing_compiler_raises_and_nothing_falls_back(tmp_path,
                                                          monkeypatch):
    """Without g++ or c++ on PATH and no built library, reading an image
    raises: no numpy decoder takes over."""
    img = chip_smoke.photo_like((8, 8, 3), 1)
    png.write_png(str(tmp_path / "a.png"), img)
    jpeg.write_jpeg(str(tmp_path / "a.jpg"), img)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "lib")
    monkeypatch.setattr(build.shutil, "which", lambda name: None)
    monkeypatch.setattr(native, "_lib", None)
    for name in ("a.png", "a.jpg"):
        with pytest.raises(RuntimeError, match="no C\\+\\+ compiler"):
            images.read_rgb(str(tmp_path / name))
    with pytest.raises(RuntimeError, match="no C\\+\\+ compiler"):
        resample.resize(img, (4, 4))
    assert not list((tmp_path / "lib").glob("*.so"))


_BUILD_IN = """
import sys
from pathlib import Path
from fourdgs_tpu_torch.native import build
build.BUILD_DIR = Path(sys.argv[1])
out = build.build()
print(out.name, build.build_info["cached"])
"""


def test_concurrent_processes_build_the_library_once(tmp_path):
    """Three processes asking for the library at once: one compiles (the
    port's csrc/host sources alone, into BUILD_DIR) while the others wait
    on the lock and load its file; a later call finds it built."""
    procs = [subprocess.Popen([sys.executable, "-c", _BUILD_IN,
                               str(tmp_path)], cwd=ROOT, text=True,
                              stdout=subprocess.PIPE)
             for _ in range(3)]
    outs = [p.communicate(timeout=300)[0].split() for p in procs]
    assert all(p.returncode == 0 for p in procs)
    names = {o[0] for o in outs}
    assert len(names) == 1 and names.pop().startswith("libfourdgs_host_")
    assert sorted(o[1] for o in outs) == ["False", "True", "True"]
    assert [p.name for p in tmp_path.glob("*.so")] == [outs[0][0]]
    assert [p.parent for p in build.sources()] == [build.HOST_SRC] * 4
    assert sorted(p.name for p in build.sources()) == [
        "colmap.cpp", "jpeg.cpp", "png.cpp", "resample.cpp"]


def test_decoders_on_many_threads_give_the_one_thread_bytes(tmp_path):
    """The library's calls release the interpreter lock: 16 threads (more
    than the cores) decoding and resizing at once, with a short switch
    interval, each get the bytes one thread gets."""
    img = chip_smoke.photo_like((64, 80, 3), 9)
    png.write_png(str(tmp_path / "a.png"), img, row_filter=4)
    jpeg.write_jpeg(str(tmp_path / "a.jpg"), img)
    jobs = [lambda: images.read_rgb(str(tmp_path / "a.png")),
            lambda: images.read_rgb(str(tmp_path / "a.jpg")),
            lambda: resample.resize(img, (33, 27), "lanczos")]
    want = [job() for job in jobs]
    results, errors = [], []

    def worker(i):
        try:
            for _ in range(10):
                results.append((i % 3, jobs[i % 3]()))
        except Exception as e:           # reported below
            errors.append(e)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=worker, args=(i,))
                   for i in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads) and not errors
    assert len(results) == 160
    assert all(np.array_equal(got, want[k]) for k, got in results)


# ---------------------------------------------------------------------------
# end to end
# ---------------------------------------------------------------------------

def test_scene_load_reads_progressive_colmap_views_as_jax(tmp_path):
    """chip_smoke's COLMAP capture with every view re-saved by Pillow as a
    progressive JPEG: the port's Scene.load (the host library's decoder)
    and JAX's (PIL) give equal images, cameras and splits."""
    root = tmp_path / "colmap"
    chip_smoke.write_colmap_scene(torch, root, torch.device("cpu"),
                                  size=(40, 30), n_views=10)
    for p in sorted((root / "images").glob("*.jpg")):
        b = io.BytesIO()
        Image.open(p).convert("RGB").save(b, "JPEG", quality=90,
                                          progressive=True)
        p.write_bytes(b.getvalue())
        assert SOF["progressive"] in b.getvalue()
    a = jscene.Scene.load(str(root))
    b = tscene.Scene.load(str(root), device="cpu")
    _assert_scenes_equal(a, b)
