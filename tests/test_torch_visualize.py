"""Port parity for the training triptych (utils/visualize.py) against
fourdgs_tpu/utils/visualize.py:

  * `_colorize_depth` within 1e-6 of JAX's (an all-zero depth included);
  * the uint8 triptych equal to the array that JAX's
    `render_training_image` hands PIL to save, outside the label's rows
    (10-22: PIL's default font there, the port's 5 x 7 bitmap font
    here), and changed by the label inside them;
  * the JPEG that the port writes, decoded by data/jpeg.py, within 2
    levels of mean absolute error of that array, at the JAX path and
    name.
"""
import numpy as np
import pytest
import torch

from fourdgs_tpu.utils import visualize as jvis
from fourdgs_tpu_torch.data.jpeg import read_jpeg
from fourdgs_tpu_torch.utils import visualize as tvis

torch.set_num_threads(1)

H, W = 160, 160   # the label a small part of the JPEG's error


def _inputs(seed=0):
    """Smooth images a little past [0, 1] (a JPEG of noise would measure
    the codec, not the triptych) and a depth with an empty corner."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:H, 0:W] / np.float32(max(H, W))
    phase = rng.uniform(0, 2 * np.pi, (2, 3))
    gt = 0.5 + 0.6 * np.sin(3 * x[..., None] + 2 * y[..., None] + phase[0])
    render = 0.5 + 0.6 * np.cos(2 * x[..., None] - 3 * y[..., None]
                                + phase[1])
    depth = 1.0 + 4.0 * x + rng.normal(0, 0.01, (H, W))
    depth[:8, :8] = 0.0
    return (gt.astype(np.float32), render.astype(np.float32),
            depth.astype(np.float32))


@pytest.mark.parametrize("kind", ["mixed", "zeros"])
def test_colorize_depth_matches_jax(kind):
    depth = _inputs()[2] if kind == "mixed" else np.zeros((H, W), np.float32)
    want = jvis._colorize_depth(depth)
    got = tvis._colorize_depth(depth)
    assert got.shape == (H, W, 3)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_triptych_matches_jax(tmp_path, monkeypatch):
    from PIL import Image
    gt, render, depth = _inputs(1)
    saved = {}
    real_save = Image.Image.save

    def capture(self, path, *args, **kwargs):
        saved["array"] = np.asarray(self).copy()
        saved["path"] = path
        return real_save(self, path, *args, **kwargs)

    monkeypatch.setattr(Image.Image, "save", capture)
    jvis.render_training_image(str(tmp_path / "jax"), "finetest", 120, 0.0,
                               gt, render, depth, 0.25)
    want = saved["array"]
    path = tvis.render_training_image(str(tmp_path / "port"), "finetest",
                                      120, 0.0, gt, render, depth, 0.25)
    assert path.endswith("00120.jpg") and saved["path"].endswith("00120.jpg")
    got = tvis.training_image("finetest", 120, 0.0, gt, render, depth, 0.25)
    assert got.shape == want.shape == (H, 3 * W, 3) and got.dtype == np.uint8
    outside = np.ones(H, bool)
    outside[10:23] = False
    np.testing.assert_array_equal(got[outside], want[outside])
    # the label's yellow pixels, in the box, where the plain array has none
    plain = (np.concatenate([np.clip(gt, 0, 1), np.clip(render, 0, 1),
                             tvis._colorize_depth(depth)], 1)
             * 255).astype(np.uint8)
    changed = (got != plain).any(-1)
    assert changed[10:23].sum() > 50 and not changed[outside].any()
    assert (got[changed] == tvis.LABEL_COLOR).all()
    decoded = read_jpeg(path)
    assert decoded.shape == got.shape
    assert np.abs(decoded.astype(np.float64) - got).mean() <= 2.0


def test_label_font_covers_printable_ascii():
    glyphs = [tvis._glyph(chr(c)) for c in range(0x20, 0x7f)]
    assert all(g.shape == (7, 5) for g in glyphs)
    assert not glyphs[0].any()                    # the space
    assert all(g.any() for g in glyphs[1:])
    # distinct shapes for the label's characters
    label = "finetest it=0123456789 t=s time=."
    shapes = {tvis._glyph(c).tobytes() for c in set(label)}
    assert len(shapes) == len(set(label))
    img = np.zeros((5, 8, 3), np.uint8)
    tvis.draw_text(img, (-2, -3), "A")            # clipped, not wrapped
    assert img.any() and not img[:, 4:].any()
