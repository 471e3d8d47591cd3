"""A view's image as the image banks hold it, in numpy (the counterpart of
fourdgs_tpu/data/scene.py `_load_image`).

The PNG and JPEG codecs and the resampling run in the port's host library
(C++, fourdgs_tpu_torch.native), whose calls release the interpreter lock,
so the image banks' decode workers run them in parallel; neither this
module nor what it imports imports torch. A file's codec is picked by its
signature, not its extension.
"""
from __future__ import annotations

import numpy as np

from fourdgs_tpu_torch.data import jpeg, png
from fourdgs_tpu_torch.data.resample import resize


def read_rgb(path: str) -> np.ndarray:
    """(H, W, 3) uint8 of a PNG (data/png.py) or JPEG (data/jpeg.py) file,
    as `Image.open(path).convert("RGB")` decodes it."""
    with open(path, "rb") as f:
        head = f.read(8)
    if head.startswith(b"\x89PNG"):
        return png.read_rgb(path)
    if head.startswith(b"\xff\xd8"):
        return jpeg.read_jpeg(path)
    raise ValueError(f"{path}: neither a PNG nor a JPEG file")


def load_image(image: np.ndarray | None, path: str | None, size,
               downscale: int = 1) -> np.ndarray:
    """(H, W, 3) float32 in [0, 1]: `image` (a view the reader decoded), or
    the file at `path` decoded and resized with LANCZOS to `size` (W, H)
    where it has another (the dynerf reader's rule); `downscale` > 1
    quantises by truncation and resizes with LANCZOS, as the JAX
    package's `_load_image` does."""
    if image is not None:
        img = image
    else:
        img = resize(read_rgb(path), size, "lanczos").astype(np.float32) / 255.0
    if downscale > 1:
        h, w = img.shape[:2]
        u8 = (np.clip(img, 0, 1) * 255).astype(np.uint8)
        img = resize(u8, (w // downscale, h // downscale),
                     "lanczos").astype(np.float32) / 255.0
    return img


def load_u8(image: np.ndarray | None, path: str | None, size,
            downscale: int = 1) -> np.ndarray:
    """(H, W, 3) uint8: `np.rint(load_image(...) * 255)`, which for a file
    at downscale 1 is its decoded 8-bit pixels (the float32 round trip of
    any byte gives the byte back)."""
    if image is None and downscale == 1:
        return resize(read_rgb(path), size, "lanczos")
    return np.rint(load_image(image, path, size, downscale)
                   * 255.0).astype(np.uint8)
