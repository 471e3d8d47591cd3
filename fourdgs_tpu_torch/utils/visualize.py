"""In-training visual debugging: the gt / render / depth triptych written at
an evaluation (counterpart: fourdgs_tpu/utils/visualize.py), a JPEG with
the stage, iteration, seconds and timestamp in its top-left corner.

The JAX package draws the label with PIL's default font; the port reads
and writes images without PIL, so the label is drawn with a 5 x 7 bitmap
font of printable ASCII that this module carries, in the same place and
colour, and the file is written by data/jpeg.py at quality 90 (PIL's
sampling at that quality, 4:2:0).

`plot_camera_orientations` is the pose-convention debug plot: matplotlib
is imported inside it, so the module imports where matplotlib is
missing."""
from __future__ import annotations

import os

import numpy as np

from fourdgs_tpu_torch.data.jpeg import write_jpeg

# 5 x 7 glyphs of ASCII 0x20-0x7e: five columns each, bit i of a column is
# row i from the top
_GLYPHS = bytes.fromhex(
    "0000000000" "00005f0000" "0007000700" "147f147f14" "242a7f2a12"
    "2313086462" "3649552250" "0005030000" "001c224100" "0041221c00"
    "082a1c2a08" "08083e0808" "0050300000" "0808080808" "0060600000"
    "2010080402" "3e5149453e" "00427f4000" "4261514946" "2141454b31"
    "1814127f10" "2745454539" "3c4a494930" "0171090503" "3649494936"
    "064949291e" "0036360000" "0056360000" "0814224100" "1414141414"
    "4122140800" "0201510906" "324979413e" "7e1111117e" "7f49494936"
    "3e41414122" "7f4141221c" "7f49494941" "7f09090101" "3e41415132"
    "7f0808087f" "00417f4100" "2040413f01" "7f08142241" "7f40404040"
    "7f0204027f" "7f0408107f" "3e4141413e" "7f09090906" "3e4151215e"
    "7f09192946" "4649494931" "01017f0101" "3f4040403f" "1f2040201f"
    "7f2018207f" "6314081463" "0304780403" "6151494543" "00007f4141"
    "0204081020" "41417f0000" "0402010204" "4040404040" "0001020400"
    "2054545478" "7f48444438" "3844444420" "384444487f" "3854545418"
    "087e090102" "081454543c" "7f08040478" "00447d4000" "2040443d00"
    "007f102844" "00417f4000" "7c04180478" "7c08040478" "3844444438"
    "7c14141408" "081414187c" "7c08040408" "4854545420" "043f444020"
    "3c4040207c" "1c2040201c" "3c4030403c" "4428102844" "0c5050503c"
    "4464544c44" "0008364100" "00007f0000" "0041360800" "0804081008")
_GLYPH_W, _GLYPH_H, _ADVANCE = 5, 7, 6
LABEL_COLOR = (255, 255, 0)


def _glyph(ch: str) -> np.ndarray:
    """(7, 5) bool mask of a character (a space for one outside ASCII
    0x20-0x7e)."""
    code = ord(ch)
    if not 0x20 <= code <= 0x7e:
        code = 0x20
    start = (code - 0x20) * _GLYPH_W
    cols = np.frombuffer(_GLYPHS, np.uint8)[start:start + _GLYPH_W]
    return ((cols[None, :] >> np.arange(_GLYPH_H)[:, None]) & 1).astype(bool)


def draw_text(img: np.ndarray, xy: tuple[int, int], text: str,
              color=LABEL_COLOR) -> np.ndarray:
    """Draw `text` into the (H, W, 3) uint8 image in place, its top-left
    corner at xy = (x, y), clipped to the image. Returns the image."""
    x0, y0 = xy
    h, w = img.shape[:2]
    for i, ch in enumerate(text):
        mask = _glyph(ch)
        x = x0 + i * _ADVANCE
        ys, xs = np.nonzero(mask)
        ys, xs = ys + y0, xs + x
        keep = (ys >= 0) & (ys < h) & (xs >= 0) & (xs < w)
        img[ys[keep], xs[keep]] = color
    return img


def _colorize_depth(depth: np.ndarray) -> np.ndarray:
    d = np.asarray(depth, np.float32)
    lo, hi = np.percentile(d[d > 0], [2, 98]) if (d > 0).any() else (0, 1)
    norm = np.clip((d - lo) / max(hi - lo, 1e-6), 0, 1)
    # a simple viridis-like ramp
    r = np.clip(1.5 * norm - 0.25, 0, 1)
    g = np.clip(1.5 * norm, 0, 1) * (1 - 0.3 * norm)
    b = np.clip(1.2 - 1.5 * norm, 0, 1)
    return np.stack([r, g, b], -1)


def training_image(label: str, iteration: int, elapsed_s: float,
                   gt: np.ndarray, render: np.ndarray, depth: np.ndarray,
                   time_value: float) -> np.ndarray:
    """The (H, 3W, 3) uint8 triptych: gt, render and colorized depth side
    by side, the label drawn at (10, 10)."""
    gt = np.clip(np.asarray(gt), 0, 1)
    render = np.clip(np.asarray(render), 0, 1)
    trip = np.concatenate([gt, render, _colorize_depth(depth)], axis=1)
    img = (trip * 255).astype(np.uint8)
    return draw_text(
        img, (10, 10),
        f"{label} it={iteration} t={elapsed_s:.0f}s time={time_value:.3f}")


def render_training_image(out_dir: str, label: str, iteration: int,
                          elapsed_s: float, gt: np.ndarray,
                          render: np.ndarray, depth: np.ndarray,
                          time_value: float) -> str:
    """Write the triptych to <out_dir>/<iteration:05d>.jpg; returns the
    path."""
    img = training_image(label, iteration, elapsed_s, gt, render, depth,
                         time_value)
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"{iteration:05d}.jpg")
    write_jpeg(path, img, quality=90)
    return path


def camera_directions(cam_list, xyz: np.ndarray, threshold: float = 2.0):
    """What `plot_camera_orientations` draws: the points within
    `threshold` of the origin in every coordinate, and each camera's
    position T and viewing direction R @ [0, 0, 1]."""
    xyz = np.asarray(xyz)
    pts = xyz[np.all(np.abs(xyz) <= threshold, axis=1)]
    origins = np.array([np.asarray(cam.T) for cam in cam_list],
                       np.float64).reshape(-1, 3)
    dirs = np.array([np.asarray(cam.R) @ np.array([0.0, 0.0, 1.0])
                     for cam in cam_list], np.float64).reshape(-1, 3)
    return pts, origins, dirs


def plot_camera_orientations(cam_list, xyz, out_path: str = "output.png",
                             threshold: float = 2.0) -> str:
    """3D scatter of the point cloud and the cameras' viewing directions,
    the pose-convention debug plot (counterpart: the JAX package's
    `utils/visualize.py:plot_camera_orientations`). `cam_list` holds
    objects with .R (3, 3) and .T (3,); xyz is (N, 3). Written to
    `out_path` with matplotlib's Agg backend; returns the path."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    pts, origins, dirs = camera_directions(cam_list, xyz, threshold)
    fig = plt.figure()
    ax = fig.add_subplot(111, projection="3d")
    ax.scatter(pts[:, 0], pts[:, 1], pts[:, 2], c="r", s=0.1)
    for t, d in zip(origins, dirs):
        ax.quiver(t[0], t[1], t[2], d[0], d[1], d[2], length=1)
    ax.set_xlabel("X Axis")
    ax.set_ylabel("Y Axis")
    ax.set_zlabel("Z Axis")
    fig.savefig(out_path)
    plt.close(fig)
    return out_path
