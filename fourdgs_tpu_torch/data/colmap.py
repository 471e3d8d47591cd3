"""COLMAP sparse-reconstruction parsers and writers, binary and text
(counterpart: fourdgs_tpu/data/colmap.py; a copy, numpy only).

The COLMAP file formats (cameras, images, points3D; .bin and .txt) that
the Colmap and MultipleView scene readers need, the writers, and the
full-fidelity `read_model`/`write_model` that keep point ids and tracks
(https://colmap.github.io/format.html). `read_points3d_binary` walks
points3D.bin in the port's host library (csrc/host/colmap.cpp, the JAX
package's `native/` reader with its C ABI; unlike JAX's, it is not
optional), `read_points3d_binary_plain` in Python, to the same arrays.
"""
from __future__ import annotations

import os
import struct
from typing import NamedTuple

import numpy as np

from fourdgs_tpu_torch import native

# camera_model_id -> (name, num_params)
CAMERA_MODELS = {
    0: ("SIMPLE_PINHOLE", 3), 1: ("PINHOLE", 4), 2: ("SIMPLE_RADIAL", 4),
    3: ("RADIAL", 5), 4: ("OPENCV", 8), 5: ("OPENCV_FISHEYE", 8),
    6: ("FULL_OPENCV", 12), 7: ("FOV", 5), 8: ("SIMPLE_RADIAL_FISHEYE", 4),
    9: ("RADIAL_FISHEYE", 5), 10: ("THIN_PRISM_FISHEYE", 12),
}
CAMERA_MODEL_IDS = {name: (mid, n) for mid, (name, n) in CAMERA_MODELS.items()}


class ColmapCamera(NamedTuple):
    id: int
    model: str
    width: int
    height: int
    params: np.ndarray


class ColmapImage(NamedTuple):
    id: int
    qvec: np.ndarray
    tvec: np.ndarray
    camera_id: int
    name: str
    xys: np.ndarray
    point3D_ids: np.ndarray


def qvec2rotmat(qvec):
    w, x, y, z = qvec
    return np.array([
        [1 - 2 * y * y - 2 * z * z, 2 * x * y - 2 * w * z, 2 * x * z + 2 * w * y],
        [2 * x * y + 2 * w * z, 1 - 2 * x * x - 2 * z * z, 2 * y * z - 2 * w * x],
        [2 * x * z - 2 * w * y, 2 * y * z + 2 * w * x, 1 - 2 * x * x - 2 * y * y]])


def rotmat2qvec(R):
    Rxx, Ryx, Rzx, Rxy, Ryy, Rzy, Rxz, Ryz, Rzz = R.flat
    K = np.array([
        [Rxx - Ryy - Rzz, 0, 0, 0],
        [Ryx + Rxy, Ryy - Rxx - Rzz, 0, 0],
        [Rzx + Rxz, Rzy + Ryz, Rzz - Rxx - Ryy, 0],
        [Ryz - Rzy, Rzx - Rxz, Rxy - Ryx, Rxx + Ryy + Rzz]]) / 3.0
    eigvals, eigvecs = np.linalg.eigh(K)
    qvec = eigvecs[[3, 0, 1, 2], np.argmax(eigvals)]
    if qvec[0] < 0:
        qvec *= -1
    return qvec


def _read(f, n, fmt):
    return struct.unpack("<" + fmt, f.read(n))


def read_cameras_binary(path: str) -> dict[int, ColmapCamera]:
    cams = {}
    with open(path, "rb") as f:
        (num,) = _read(f, 8, "Q")
        for _ in range(num):
            cid, model_id, w, h = _read(f, 24, "iiQQ")
            name, n_params = CAMERA_MODELS[model_id]
            params = np.array(_read(f, 8 * n_params, "d" * n_params))
            cams[cid] = ColmapCamera(id=cid, model=name, width=int(w),
                                     height=int(h), params=params)
    return cams


def read_cameras_text(path: str) -> dict[int, ColmapCamera]:
    cams = {}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            el = line.split()
            cid = int(el[0])
            cams[cid] = ColmapCamera(
                id=cid, model=el[1], width=int(el[2]), height=int(el[3]),
                params=np.array(el[4:], dtype=np.float64))
    return cams


def read_images_binary(path: str) -> dict[int, ColmapImage]:
    images = {}
    with open(path, "rb") as f:
        (num,) = _read(f, 8, "Q")
        for _ in range(num):
            props = _read(f, 64, "idddddddi")
            iid = props[0]
            qvec = np.array(props[1:5])
            tvec = np.array(props[5:8])
            camera_id = props[8]
            name = b""
            c = f.read(1)
            while c != b"\x00":
                name += c
                c = f.read(1)
            (n_pts,) = _read(f, 8, "Q")
            data = _read(f, 24 * n_pts, "ddq" * n_pts)
            xys = np.column_stack([data[0::3], data[1::3]])
            p3d = np.array(data[2::3], dtype=np.int64)
            images[iid] = ColmapImage(id=iid, qvec=qvec, tvec=tvec,
                                      camera_id=camera_id,
                                      name=name.decode("utf-8"),
                                      xys=xys, point3D_ids=p3d)
    return images


def read_images_text(path: str) -> dict[int, ColmapImage]:
    """Each image is TWO lines (pose row, points2D row); the points2D row
    is EMPTY for known-pose models without triangulated points (as
    scripts/poses2colmap.py writes them), so blank lines
    must be kept when they follow a pose row — dropping them shifts the
    two-line pairing onto the next image's pose row."""
    images = {}
    with open(path) as f:
        raw = [ln.strip() for ln in f if not ln.startswith("#")]
    i = 0
    while i < len(raw):
        if not raw[i]:
            i += 1
            continue
        el = raw[i].split()
        iid = int(el[0])
        qvec = np.array(el[1:5], dtype=np.float64)
        tvec = np.array(el[5:8], dtype=np.float64)
        el2 = raw[i + 1].split() if i + 1 < len(raw) else []
        i += 2
        xys = np.column_stack([np.array(el2[0::3], np.float64),
                               np.array(el2[1::3], np.float64)]) \
            if el2 else np.zeros((0, 2))
        p3d = np.array(el2[2::3], dtype=np.int64) if el2 else np.zeros(0, np.int64)
        images[iid] = ColmapImage(id=iid, qvec=qvec, tvec=tvec,
                                  camera_id=int(el[8]), name=el[9],
                                  xys=xys, point3D_ids=p3d)
    return images


def read_points3d_binary(path: str):
    """Returns (xyz (N,3), rgb (N,3) uint8-valued, errors (N,)), all
    float64, walking the variable-length track records in the host
    library."""
    return native.read_points3d_binary(path)


def read_points3d_binary_plain(path: str):
    """The plain version of `read_points3d_binary`, in Python."""
    with open(path, "rb") as f:
        (num,) = _read(f, 8, "Q")
        xyz = np.empty((num, 3))
        rgb = np.empty((num, 3))
        err = np.empty(num)
        for i in range(num):
            props = _read(f, 43, "QdddBBBd")
            xyz[i] = props[1:4]
            rgb[i] = props[4:7]
            err[i] = props[7]
            (track_len,) = _read(f, 8, "Q")
            f.seek(8 * track_len, os.SEEK_CUR)
    return xyz, rgb, err


def read_points3d_text(path: str):
    xyzs, rgbs, errs = [], [], []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            el = line.split()
            xyzs.append([float(x) for x in el[1:4]])
            rgbs.append([float(x) for x in el[4:7]])
            errs.append(float(el[7]))
    return np.array(xyzs), np.array(rgbs), np.array(errs)


def write_cameras_binary(cams: dict[int, ColmapCamera], path: str):
    """Round-trip support (used by tests and preprocessing tools)."""
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(cams)))
        for cam in cams.values():
            mid, n_params = CAMERA_MODEL_IDS[cam.model]
            f.write(struct.pack("<iiQQ", cam.id, mid, cam.width, cam.height))
            f.write(struct.pack("<" + "d" * n_params, *cam.params[:n_params]))


def write_images_binary(images: dict[int, ColmapImage], path: str):
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(images)))
        for im in images.values():
            f.write(struct.pack("<idddddddi", im.id, *im.qvec, *im.tvec,
                                im.camera_id))
            f.write(im.name.encode("utf-8") + b"\x00")
            n = len(im.point3D_ids)
            f.write(struct.pack("<Q", n))
            for j in range(n):
                f.write(struct.pack("<ddq", im.xys[j, 0], im.xys[j, 1],
                                    int(im.point3D_ids[j])))


def write_points3d_binary(xyz: np.ndarray, rgb: np.ndarray, path: str):
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(xyz)))
        for i in range(len(xyz)):
            f.write(struct.pack("<QdddBBBd", i, *xyz[i],
                                *[int(c) for c in rgb[i]], 0.0))
            f.write(struct.pack("<Q", 0))


# ---------------------------------------------------------------------------
# Full-fidelity sparse-model conversion.
#
# The scene readers above only need (xyz, rgb, err) arrays; model
# CONVERSION must also preserve point ids and observation tracks, so the
# functions below carry complete Point3D records and add the text writers
# plus the read_model/write_model facade with format auto-detection.
# ---------------------------------------------------------------------------

class ColmapPoint3D(NamedTuple):
    id: int
    xyz: np.ndarray
    rgb: np.ndarray
    error: float
    image_ids: np.ndarray
    point2D_idxs: np.ndarray


def read_points3d_binary_full(path: str) -> dict[int, ColmapPoint3D]:
    pts = {}
    with open(path, "rb") as f:
        (num,) = _read(f, 8, "Q")
        for _ in range(num):
            props = _read(f, 43, "QdddBBBd")
            (track_len,) = _read(f, 8, "Q")
            track = _read(f, 8 * track_len, "ii" * track_len)
            pts[props[0]] = ColmapPoint3D(
                id=props[0], xyz=np.array(props[1:4]),
                rgb=np.array(props[4:7]), error=props[7],
                image_ids=np.array(track[0::2], np.int32),
                point2D_idxs=np.array(track[1::2], np.int32))
    return pts


def read_points3d_text_full(path: str) -> dict[int, ColmapPoint3D]:
    pts = {}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            el = line.split()
            pid = int(el[0])
            pts[pid] = ColmapPoint3D(
                id=pid, xyz=np.array(el[1:4], np.float64),
                rgb=np.array(el[4:7], np.float64), error=float(el[7]),
                image_ids=np.array(el[8::2], np.int32),
                point2D_idxs=np.array(el[9::2], np.int32))
    return pts


def write_points3d_binary_full(pts: dict[int, ColmapPoint3D], path: str):
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(pts)))
        for p in pts.values():
            f.write(struct.pack("<QdddBBBd", p.id, *p.xyz,
                                *[int(c) for c in p.rgb], p.error))
            f.write(struct.pack("<Q", len(p.image_ids)))
            for iid, pidx in zip(p.image_ids, p.point2D_idxs):
                f.write(struct.pack("<ii", int(iid), int(pidx)))


def write_cameras_text(cams: dict[int, ColmapCamera], path: str):
    with open(path, "w") as f:
        f.write("# Camera list with one line of data per camera:\n"
                "#   CAMERA_ID, MODEL, WIDTH, HEIGHT, PARAMS[]\n"
                f"# Number of cameras: {len(cams)}\n")
        for cam in cams.values():
            params = " ".join(repr(float(p)) for p in cam.params)
            f.write(f"{cam.id} {cam.model} {cam.width} {cam.height}"
                    f" {params}\n")


def write_images_text(images: dict[int, ColmapImage], path: str):
    mean_obs = (sum(len(im.point3D_ids) for im in images.values())
                / max(len(images), 1))
    with open(path, "w") as f:
        f.write("# Image list with two lines of data per image:\n"
                "#   IMAGE_ID, QW, QX, QY, QZ, TX, TY, TZ, CAMERA_ID, "
                "NAME\n"
                "#   POINTS2D[] as (X, Y, POINT3D_ID)\n"
                f"# Number of images: {len(images)}, mean observations "
                f"per image: {mean_obs}\n")
        for im in images.values():
            head = [im.id, *im.qvec, *im.tvec, im.camera_id, im.name]
            f.write(" ".join(map(str, head)) + "\n")
            f.write(" ".join(
                f"{x} {y} {int(pid)}"
                for (x, y), pid in zip(im.xys, im.point3D_ids)) + "\n")


def write_points3d_text_full(pts: dict[int, ColmapPoint3D], path: str):
    mean_track = (sum(len(p.image_ids) for p in pts.values())
                  / max(len(pts), 1))
    with open(path, "w") as f:
        f.write("# 3D point list with one line of data per point:\n"
                "#   POINT3D_ID, X, Y, Z, R, G, B, ERROR, TRACK[] as "
                "(IMAGE_ID, POINT2D_IDX)\n"
                f"# Number of points: {len(pts)}, mean track length: "
                f"{mean_track}\n")
        for p in pts.values():
            track = " ".join(f"{int(i)} {int(j)}"
                             for i, j in zip(p.image_ids, p.point2D_idxs))
            f.write(f"{p.id} {p.xyz[0]} {p.xyz[1]} {p.xyz[2]} "
                    f"{int(p.rgb[0])} {int(p.rgb[1])} {int(p.rgb[2])} "
                    f"{p.error} {track}\n")


def detect_model_format(path: str, ext: str) -> bool:
    return all(os.path.isfile(os.path.join(path, f + ext))
               for f in ("cameras", "images", "points3D"))


def read_model(path: str, ext: str = ""):
    """(cameras, images, points3D) with ext auto-detection ('' tries .bin
    then .txt)."""
    if ext == "":
        if detect_model_format(path, ".bin"):
            ext = ".bin"
        elif detect_model_format(path, ".txt"):
            ext = ".txt"
        else:
            raise FileNotFoundError(f"no COLMAP model found in {path}")
    j = os.path.join
    if ext == ".bin":
        return (read_cameras_binary(j(path, "cameras.bin")),
                read_images_binary(j(path, "images.bin")),
                read_points3d_binary_full(j(path, "points3D.bin")))
    return (read_cameras_text(j(path, "cameras.txt")),
            read_images_text(j(path, "images.txt")),
            read_points3d_text_full(j(path, "points3D.txt")))


def write_model(cameras, images, points3d, path: str, ext: str = ".bin"):
    os.makedirs(path, exist_ok=True)
    j = os.path.join
    if ext == ".bin":
        write_cameras_binary(cameras, j(path, "cameras.bin"))
        write_images_binary(images, j(path, "images.bin"))
        write_points3d_binary_full(points3d, j(path, "points3D.bin"))
    else:
        write_cameras_text(cameras, j(path, "cameras.txt"))
        write_images_text(images, j(path, "images.txt"))
        write_points3d_text_full(points3d, j(path, "points3D.txt"))
