"""Image resampling as Pillow does it: `Image.resize` with the LANCZOS and
BICUBIC filters on 8-bit images, bit for bit, in the port's host library
(csrc/host/resample.cpp, `resample`), with its plain version in numpy
(`resample_plain`).

The JAX package resizes with PIL: LANCZOS in data/scene.py:_load_image
(the `downscale` path) and data/dynerf.py (frames not at IMG_WH), and
Pillow's default filter, BICUBIC, in data/blender.py. The port has no PIL,
so it carries Pillow's algorithm (its `Resample.c`):

  * coefficients per output index i: scale = in / out, filterscale =
    max(scale, 1), support = the filter's support x filterscale; center =
    (i + 0.5) * scale, xmin = max(int(center - support + 0.5), 0), xmax =
    min(int(center + support + 0.5), in) - xmin; the weights
    filter((x + xmin - center + 0.5) / filterscale), x < xmax, normalised
    by their sum, then to fixed point, int(k * 2**22 +- 0.5) (half away
    from zero);
  * a horizontal pass, then a vertical one, each skipped where that side's
    size does not change; every output is (2**21 + sum k * v) >> 22 clipped
    to 0..255, so the intermediate image is 8-bit too.

The weights are float64 from the C library's `sin` (Python's `math`, and
the host library's own call), as Pillow's are, so that no weight can round
the other way.
"""
from __future__ import annotations

import functools
import math

import numpy as np

from fourdgs_tpu_torch import native

_PRECISION_BITS = 22


def _sinc(x: float) -> float:
    if x == 0.0:
        return 1.0
    x = x * math.pi
    return math.sin(x) / x


def _lanczos(x: float) -> float:
    # truncated sinc
    if -3.0 <= x < 3.0:
        return _sinc(x) * _sinc(x / 3)
    return 0.0


def _bicubic(x: float) -> float:
    a = -0.5
    if x < 0.0:
        x = -x
    if x < 1.0:
        return ((a + 2.0) * x - (a + 3.0)) * x * x + 1
    if x < 2.0:
        return (((x - 5) * x + 8) * x - 4) * a
    return 0.0


# filter name -> (function, support)
FILTERS = {"lanczos": (_lanczos, 3.0), "bicubic": (_bicubic, 2.0)}


@functools.lru_cache(maxsize=64)
def coefficients(in_size: int, out_size: int, filt: str
                 ) -> tuple[np.ndarray, np.ndarray]:
    """(out_size, ksize) int64 sample indices and fixed-point weights of
    one pass (weights past a row's xmax are 0, their indices clamped)."""
    fn, filter_support = FILTERS[filt]
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = filter_support * filterscale
    ksize = int(math.ceil(support)) * 2 + 1
    idx = np.zeros((out_size, ksize), np.int64)
    kk = np.zeros((out_size, ksize), np.int64)
    ss = 1.0 / filterscale
    one = 1 << _PRECISION_BITS
    for xx in range(out_size):
        center = (xx + 0.5) * scale
        xmin = max(int(center - support + 0.5), 0)
        xmax = min(int(center + support + 0.5), in_size) - xmin
        k = [fn((x + xmin - center + 0.5) * ss) for x in range(xmax)]
        ww = 0.0
        for w in k:
            ww += w
        if ww != 0.0:
            k = [w / ww for w in k]
        kk[xx, :xmax] = [int(-0.5 + w * one) if w < 0 else int(0.5 + w * one)
                         for w in k]
        idx[xx] = np.minimum(xmin + np.arange(ksize), in_size - 1)
    return idx, kk


def _pass(img: np.ndarray, out_size: int, axis: int, filt: str) -> np.ndarray:
    """One 8-bit pass along `axis` (0 rows, 1 columns) of an (H, W, C)
    uint8 image."""
    idx, kk = coefficients(img.shape[axis], out_size, filt)
    src = img.astype(np.int64)
    acc = np.full(img.shape[:axis] + (out_size,) + img.shape[axis + 1:],
                  1 << (_PRECISION_BITS - 1), np.int64)
    shape = (-1, 1, 1) if axis == 0 else (1, -1, 1)
    for j in range(idx.shape[1]):
        acc += np.take(src, idx[:, j], axis=axis) * kk[:, j].reshape(shape)
    return np.clip(acc >> _PRECISION_BITS, 0, 255).astype(np.uint8)


def resample(img: np.ndarray, width: int, height: int,
             filt: str) -> np.ndarray:
    """An (H, W, C) uint8 image at (height, width), both passes in the
    host library."""
    return native.resample(img, width, height, filt)


def resample_plain(img: np.ndarray, width: int, height: int,
                   filt: str) -> np.ndarray:
    """The plain version of `resample`, in numpy."""
    out = img
    if out.shape[1] != width:
        out = _pass(out, width, 1, filt)
    if out.shape[0] != height:
        out = _pass(out, height, 0, filt)
    return out


def resize(img: np.ndarray, size: tuple[int, int],
           filt: str = "lanczos") -> np.ndarray:
    """Pillow's `Image.fromarray(img).resize(size, filter)` for an (H, W),
    (H, W, 3) or (H, W, 4) uint8 image (RGBA as four independent channels,
    which is Pillow's result where alpha is 255); `size` is (W, H), as
    Pillow takes it."""
    if img.dtype != np.uint8 or img.ndim not in (2, 3):
        raise ValueError(f"resize takes (H, W[, C]) uint8, got {img.dtype} "
                         f"{img.shape}")
    w, h = (int(s) for s in size)
    if w < 1 or h < 1:
        raise ValueError(f"resize to {size}")
    out = img if img.ndim == 3 else img[..., None]
    if (out.shape[1], out.shape[0]) == (w, h):
        out = out.copy()
    else:
        out = resample(out, w, h, filt)
    return out if img.ndim == 3 else out[..., 0]
