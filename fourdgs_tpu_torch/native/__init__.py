"""ctypes bindings of the port's host library (the counterpart of
fourdgs_tpu/native/__init__.py): the data layer's hot loops in C++,
csrc/host/*.cpp, built at first use by native/build.py.

  * `png_unfilter`: the five PNG row filters (csrc/host/png.cpp);
  * `decode_jpeg`: baseline, extended-sequential and progressive JPEG
    (csrc/host/jpeg.cpp);
  * `resample`: Pillow's LANCZOS and BICUBIC passes
    (csrc/host/resample.cpp);
  * `read_points3d_binary`, `read_image_poses_binary`: the COLMAP binary
    readers, with the JAX package's C ABI (csrc/host/colmap.cpp).

Each has a plain version in numpy and Python beside its caller
(data/png.py, jpeg.py, resample.py, colmap.py), which the tests hold it to
bit for bit. Unlike the JAX package's bindings, nothing falls back to the
plain version: without a C++ compiler the first call raises. The calls
release the interpreter lock (ctypes' CDLL), so threads decode in
parallel. This package imports neither torch nor CUDA, and importing it
builds nothing.
"""
from __future__ import annotations

import ctypes
import threading

import numpy as np

from fourdgs_tpu_torch.native import build

_lib: ctypes.CDLL | None = None
_lock = threading.Lock()
_ERRORS = {1: ValueError, 2: NotImplementedError, 3: MemoryError}
_FILTERS = {"lanczos": 0, "bicubic": 1}


def _declare(lib: ctypes.CDLL) -> ctypes.CDLL:
    """ctypes signatures: every pointer as c_void_p, every size int64."""
    vp, i64 = ctypes.c_void_p, ctypes.c_int64
    lib.png_unfilter.argtypes = [vp, i64, i64, i64, vp]
    lib.png_unfilter.restype = i64
    lib.jpeg_decode.argtypes = [vp, i64, vp, vp, vp, i64]
    lib.jpeg_decode.restype = i64
    lib.resample_u8.argtypes = [vp, i64, i64, i64, vp, i64, i64, i64]
    lib.resample_u8.restype = i64
    lib.colmap_count_points3d.argtypes = [vp]
    lib.colmap_count_points3d.restype = i64
    lib.colmap_read_points3d.argtypes = [vp, vp, vp, vp, i64]
    lib.colmap_read_points3d.restype = i64
    lib.colmap_count_images.argtypes = [vp]
    lib.colmap_count_images.restype = i64
    lib.colmap_read_image_poses.argtypes = [vp, vp, vp, vp, vp, vp, i64, i64]
    lib.colmap_read_image_poses.restype = i64
    return lib


def load_library() -> ctypes.CDLL:
    """The host library, built on first use (native/build.py)."""
    global _lib
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is None:
            _lib = _declare(ctypes.CDLL(str(build.build())))
    return _lib


def _ptr(a: np.ndarray) -> int:
    return a.ctypes.data


def png_unfilter(raw: np.ndarray, bpp: int) -> np.ndarray:
    """(H, 1 + stride) uint8 inflated PNG rows (each a filter type, then
    its bytes) at `bpp` 1, 3 or 4 -> (H, stride) uint8 unfiltered. Raises
    ValueError on a filter type above 4."""
    raw = np.ascontiguousarray(raw, np.uint8)
    if raw.ndim != 2 or raw.shape[1] < 1:
        raise ValueError(f"png_unfilter takes (H, 1 + stride) uint8, got "
                         f"{raw.shape}")
    h, stride = raw.shape[0], raw.shape[1] - 1
    if bpp not in (1, 3, 4) or stride % bpp:
        raise ValueError(f"a row of {stride} bytes at {bpp} bytes a pixel")
    out = np.empty((h, stride), np.uint8)
    bad = load_library().png_unfilter(_ptr(raw), h, stride, bpp, _ptr(out))
    if bad:
        raise ValueError(f"unknown row filter {raw[bad - 1, 0]} in row "
                         f"{bad - 1}")
    return out


def _raise(code: int, err, name: str) -> None:
    if code:
        raise _ERRORS.get(code, RuntimeError)(
            f"{name}: {err.value.decode(errors='replace')}")


def decode_jpeg(data: bytes, name: str = "<bytes>") -> np.ndarray:
    """A JPEG file's bytes -> (H, W, 3) uint8 RGB, as data/jpeg.py's
    decode_jpeg_plain; errors name the file (`name`)."""
    lib = load_library()
    buf = np.frombuffer(data, np.uint8)
    dims = np.zeros(3, np.int64)
    err = ctypes.create_string_buffer(512)
    _raise(lib.jpeg_decode(_ptr(buf), buf.size, _ptr(dims), None,
                           ctypes.addressof(err), len(err)), err, name)
    out = np.empty((int(dims[0]), int(dims[1]), 3), np.uint8)
    _raise(lib.jpeg_decode(_ptr(buf), buf.size, _ptr(dims), _ptr(out),
                           ctypes.addressof(err), len(err)), err, name)
    return out


def resample(img: np.ndarray, width: int, height: int,
             filt: str) -> np.ndarray:
    """An (H, W, C) uint8 image resized to (height, width) with Pillow's
    `filt` ("lanczos" or "bicubic"), as data/resample.py's
    resample_plain."""
    img = np.ascontiguousarray(img)
    if img.dtype != np.uint8 or img.ndim != 3 or min(img.shape) < 1:
        raise ValueError(f"resample takes (H, W, C) uint8, got {img.dtype} "
                         f"{img.shape}")
    if filt not in _FILTERS:
        raise ValueError(f"unknown filter {filt!r}")
    h, w, ch = img.shape
    out = np.empty((height, width, ch), np.uint8)
    if load_library().resample_u8(_ptr(img), h, w, ch, _ptr(out), height,
                                  width, _FILTERS[filt]):
        raise ValueError(f"resample to {width}x{height}")
    return out


def _path(path: str) -> ctypes.Array:
    return ctypes.create_string_buffer(str(path).encode())


def read_points3d_binary(path: str):
    """points3D.bin -> (xyz (N, 3) float64, rgb (N, 3) float64 of uint8
    values, errors (N,) float64), as data/colmap.py's
    read_points3d_binary_plain."""
    lib = load_library()
    p = _path(path)
    n = lib.colmap_count_points3d(ctypes.addressof(p))
    if n < 0:
        raise OSError(f"{path}: cannot read a points3D.bin header")
    xyz = np.empty((n, 3), np.float64)
    rgb = np.empty((n, 3), np.uint8)
    err = np.empty(n, np.float64)
    got = lib.colmap_read_points3d(ctypes.addressof(p), _ptr(xyz), _ptr(rgb),
                                   _ptr(err), n)
    if got != n:
        raise ValueError(f"{path}: a corrupt or truncated points3D.bin "
                         f"({n} points in its header)")
    return xyz, rgb.astype(np.float64), err


def read_image_poses_binary(path: str, name_cap: int = 256):
    """images.bin -> (ids (N,) int32, qvec (N, 4), tvec (N, 3) float64,
    camera ids (N,) int32, names), the poses of data/colmap.py's
    read_images_binary without their 2D points."""
    lib = load_library()
    p = _path(path)
    n = lib.colmap_count_images(ctypes.addressof(p))
    if n < 0:
        raise OSError(f"{path}: cannot read an images.bin header")
    ids = np.empty(n, np.int32)
    qvec = np.empty((n, 4), np.float64)
    tvec = np.empty((n, 3), np.float64)
    cam_ids = np.empty(n, np.int32)
    names = np.zeros(n * name_cap, np.uint8)
    got = lib.colmap_read_image_poses(ctypes.addressof(p), _ptr(ids),
                                      _ptr(qvec), _ptr(tvec), _ptr(cam_ids),
                                      _ptr(names), name_cap, n)
    if got != n:
        raise ValueError(f"{path}: a corrupt or truncated images.bin "
                         f"({n} images in its header)")
    name_list = [bytes(names[i * name_cap:(i + 1) * name_cap])
                 .split(b"\0", 1)[0].decode("utf-8") for i in range(n)]
    return ids, qvec, tvec, cam_ids, name_list
