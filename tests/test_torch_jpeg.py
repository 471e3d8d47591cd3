"""The port's JPEG codec (data/jpeg.py) against Pillow (libjpeg-turbo).

The decoder, through the host library and through its plain version (the
`route` fixture, tests/_torch_routes.py), must equal
`np.asarray(Image.open(p).convert("RGB"))` bit for bit (atol 0) on files
Pillow wrote: 4:4:4, 4:2:2 and 4:2:0 sampling and greyscale, quality 75
and 95, odd sizes and one 640x360 view, restart markers, optimised Huffman
tables, 16-bit quantisation tables (SOF1), progressive files (SOF2),
Adobe RGB files, 4:1:1 sampling, fill bytes, comment and EXIF segments.
It refuses lossless, hierarchical, arithmetic, 12-bit and CMYK files with
NotImplementedError naming the marker. The encoder's files decode in Pillow to exactly what
the decoder gives, at every sampling, and a ball render survives quality
95 above 35 dB. `images.read_rgb` picks the codec by the file's signature.
"""
import io

import numpy as np
import pytest
import torch
from PIL import Image

from fourdgs_tpu_torch.data import images, jpeg, png
from tests._torch_routes import route  # noqa: F401

torch.set_num_threads(1)

PIL_SAMPLING = {"4:4:4": 0, "4:2:2": 1, "4:2:0": 2}


def _image(h, w, seed=0, grey=False):
    """Half smooth gradients, half noise (every Huffman code length)."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    smooth = np.stack([x * 3 % 256, y * 5 % 256, (x + y) * 2 % 256], -1)
    noise = rng.integers(0, 256, (h, w, 3))
    img = np.where((y < h // 2)[..., None], smooth, noise).astype(np.uint8)
    return img[..., 0] if grey else img


def _pil_bytes(img, **kw) -> bytes:
    b = io.BytesIO()
    Image.fromarray(img).save(b, "JPEG", **kw)
    return b.getvalue()


def _pil_decode(data: bytes) -> np.ndarray:
    return np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))


def _assert_equal_to_pillow(data: bytes):
    got = jpeg.decode_jpeg(data)
    want = _pil_decode(data)
    assert got.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


SIZES = [(48, 64), (53, 37)]


@pytest.mark.parametrize("quality", [75, 95])
@pytest.mark.parametrize("sampling", ["4:4:4", "4:2:2", "4:2:0", "grey"])
@pytest.mark.parametrize("size", SIZES, ids=[f"{w}x{h}" for h, w in SIZES])
def test_decoder_equals_pillow(size, sampling, quality, route):
    grey = sampling == "grey"
    kw = {} if grey else {"subsampling": PIL_SAMPLING[sampling]}
    _assert_equal_to_pillow(_pil_bytes(_image(*size, sum(size), grey),
                                       quality=quality, **kw))


def test_decoder_equals_pillow_at_640x360(route):
    _assert_equal_to_pillow(_pil_bytes(_image(360, 640, 3), quality=95))


@pytest.mark.parametrize("options", [
    {"restart_marker_blocks": 3}, {"restart_marker_rows": 1},
    {"optimize": True},
    {"optimize": True, "subsampling": 1, "restart_marker_blocks": 1},
    {"qtables": [[300] * 64, [300] * 64]},     # 16-bit tables: SOF1
    {"comment": b"a comment"},
    {"keep_rgb": True},                       # Adobe, transform 0: RGB
    {"subsampling": "4:1:1"},                 # 4x1: plain replication
], ids=["rst-blocks-3", "rst-rows-1", "optimize", "optimize-rst-422",
        "sof1-16bit-dqt", "comment", "adobe-rgb", "411"])
def test_decoder_equals_pillow_on_encoder_options(options, route):
    if "qtables" in options:       # quality would replace the tables
        data = _pil_bytes(_image(53, 37, 1), **options)
        assert b"\xff\xc1" in data
    else:
        data = _pil_bytes(_image(53, 37, 1), quality=90, **options)
    _assert_equal_to_pillow(data)


def test_exif_orientation_and_fill_bytes_are_ignored(route):
    """An EXIF orientation (which `Image.open` does not apply) and 0xFF
    fill bytes before markers decode as Pillow decodes them."""
    exif = Image.Exif()
    exif[0x0112] = 6
    data = _pil_bytes(_image(48, 64, 2), quality=90, exif=exif)
    _assert_equal_to_pillow(data)
    sos = data.index(b"\xff\xda")
    filled = data[:sos] + b"\xff\xff\xff" + data[sos:-2] + b"\xff\xff\xd9"
    np.testing.assert_array_equal(jpeg.decode_jpeg(filled),
                                  _pil_decode(data))


def _cmyk_bytes() -> bytes:
    b = io.BytesIO()
    Image.new("CMYK", (16, 16), (10, 20, 30, 40)).save(b, "JPEG")
    return b.getvalue()


def _with_marker(data: bytes, old: bytes, new: bytes) -> bytes:
    at = data.index(old)
    return data[:at] + new + data[at + len(old):]


@pytest.mark.parametrize("options", [
    {"progressive": True}, {"progressive": True, "subsampling": 0},
    {"progressive": True, "restart_marker_blocks": 2}],
    ids=["420", "444", "rst-blocks-2"])
def test_progressive_file_equals_pillows_decode(options, route):
    """A progressive file (Pillow's default scan script: spectral
    selection and successive approximation, DC and AC, first and
    refinement scans), which the decoders once refused, decodes as Pillow
    decodes it."""
    data = _pil_bytes(_image(48, 64), quality=90, **options)
    assert b"\xff\xc2" in data
    _assert_equal_to_pillow(data)


@pytest.mark.parametrize("make,marker", [
    (lambda d: _with_marker(d, b"\xff\xc0", b"\xff\xc3"), "SOF3"),
    (lambda d: _with_marker(d, b"\xff\xc0", b"\xff\xc9"), "SOF9"),
    (lambda d: _with_marker(d, b"\xff\xc0", b"\xff\xc5"), "SOF5"),
    (lambda d: _with_marker(d, b"\xff\xc4", b"\xff\xcc"), "DAC"),
    (lambda d: d[:d.index(b"\xff\xc0") + 4] + b"\x0c"
     + d[d.index(b"\xff\xc0") + 5:], "12-bit"),
    (lambda d: _cmyk_bytes(), "4-component"),
], ids=["lossless", "arithmetic", "hierarchical", "dac", "12-bit", "cmyk"])
def test_decoder_refuses_what_it_does_not_decode(make, marker, route):
    with pytest.raises(NotImplementedError, match=marker):
        jpeg.decode_jpeg(make(_pil_bytes(_image(48, 64), quality=90)))


@pytest.mark.parametrize("subsampling", sorted(jpeg.SAMPLINGS) + ["grey"])
def test_encoder_decodes_alike_in_pillow(subsampling, tmp_path, route):
    """write_jpeg's files: Pillow's pixels equal read_jpeg's, at every
    sampling (4:4:0 exercises the h1v2 upsampler) and at sizes that leave
    partial MCUs."""
    for h, w in ((53, 37), (17, 9), (3, 3)):
        grey = subsampling == "grey"
        img = _image(h, w, h * w, grey)
        path = str(tmp_path / f"{h}x{w}.jpg")
        jpeg.write_jpeg(path, img, 95,
                        "4:2:0" if grey else subsampling)
        got = jpeg.read_jpeg(path)
        np.testing.assert_array_equal(got, np.asarray(
            Image.open(path).convert("RGB")))
        if subsampling in ("4:4:4", "grey"):
            # unsubsampled: within quality 95's quantisation
            want = np.repeat(img[..., None], 3, 2) if grey else img
            assert np.abs(got.astype(int) - want).mean() < 3


def test_encoder_round_trip_of_a_ball_render():
    """A render of the ball scene (the chip_smoke writers' content) at
    quality 95, 4:2:0: above 35 dB, as Pillow's encoder is."""
    import chip_smoke
    from fourdgs_tpu_torch.data.camera import look_at_camera
    cam = look_at_camera(device="cpu")
    img = chip_smoke.render_ball(torch, cam, 0.5, (96, 64),
                                 torch.device("cpu"))
    got = jpeg.decode_jpeg(jpeg.encode_jpeg(img, 95, "4:2:0"))

    def psnr(x):
        return 10 * np.log10(255 ** 2 / np.mean(
            (x.astype(np.float64) - img) ** 2))
    ours = psnr(got)
    pillows = psnr(_pil_decode(_pil_bytes(img, quality=95, subsampling=2)))
    assert ours > 35 and ours > pillows - 1, (ours, pillows)


def _segments(data: bytes, marker: int) -> bytes:
    """The bodies of every `marker` segment before the scan, joined."""
    pos, out = 2, b""
    while data[pos + 1] != 0xDA:
        n = int.from_bytes(data[pos + 2:pos + 4], "big")
        if data[pos + 1] == marker:
            out += data[pos + 4:pos + 2 + n]
        pos += 2 + n
    return out


def test_quality_tables_match_pillow():
    """The Annex K Huffman tables and libjpeg's quality scaling: the
    segments Pillow writes at quality 75 and 95."""
    for q in (75, 95):
        data = _pil_bytes(_image(16, 16), quality=q)
        dqt = _segments(data, 0xDB)
        assert list(dqt[1:65]) == list(jpeg.quality_table(
            jpeg._LUMA_Q, q)[jpeg.ZIGZAG])
        assert list(dqt[66:130]) == list(jpeg.quality_table(
            jpeg._CHROMA_Q, q)[jpeg.ZIGZAG])
    dht, tables = _segments(data, 0xC4), {}
    p = 0
    while p < len(dht):
        count = sum(dht[p + 1:p + 17])
        tables[dht[p]] = (dht[p + 1:p + 17], dht[p + 17:p + 17 + count])
        p += 17 + count
    assert tables == {0x00: jpeg._DC_LUMA, 0x10: jpeg._AC_LUMA,
                      0x01: jpeg._DC_CHROMA, 0x11: jpeg._AC_CHROMA}


def test_read_rgb_picks_the_codec_by_signature(tmp_path):
    """A JPEG named .png and a PNG named .jpg each go to their codec."""
    img = _image(20, 24, 5)
    jpeg.write_jpeg(str(tmp_path / "a.png"), img, 90)
    png.write_png(str(tmp_path / "b.jpg"), img)
    np.testing.assert_array_equal(images.read_rgb(str(tmp_path / "a.png")),
                                  np.asarray(Image.open(tmp_path / "a.png")))
    np.testing.assert_array_equal(images.read_rgb(str(tmp_path / "b.jpg")),
                                  img)
    (tmp_path / "c.jpg").write_bytes(b"GIF89a")
    with pytest.raises(ValueError, match="neither a PNG nor a JPEG"):
        images.read_rgb(str(tmp_path / "c.jpg"))
