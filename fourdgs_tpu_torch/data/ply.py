"""Binary PLY I/O for 3DGS Gaussian snapshots, numpy only
(counterpart: fourdgs_tpu/data/ply.py; a copy, byte-compatible with it).

The layout (x,y,z,nx,ny,nz,f_dc_*,f_rest_*,opacity,scale_*,rot_*) is the
one 3DGS viewers and tools open. Only binary_little_endian 1.0 and ascii
are read.
"""
from __future__ import annotations

import io
import os
from typing import NamedTuple

import numpy as np

_DTYPES = {
    "float": "<f4", "float32": "<f4", "double": "<f8", "float64": "<f8",
    "uchar": "u1", "uint8": "u1", "char": "i1", "int8": "i1",
    "ushort": "<u2", "uint16": "<u2", "short": "<i2", "int16": "<i2",
    "uint": "<u4", "uint32": "<u4", "int": "<i4", "int32": "<i4",
}


class PlyVertexData(NamedTuple):
    names: list
    data: np.ndarray  # structured array


def read_ply(path: str) -> PlyVertexData:
    with open(path, "rb") as f:
        line = f.readline().strip()
        if line != b"ply":
            raise ValueError(f"{path} is not a PLY file")
        fmt = None
        count = 0
        props: list[tuple[str, str]] = []
        in_vertex = False
        while True:
            line = f.readline()
            if not line:
                raise ValueError("unexpected EOF in PLY header")
            tok = line.strip().split()
            if not tok:
                continue
            if tok[0] == b"format":
                fmt = tok[1].decode()
            elif tok[0] == b"element":
                in_vertex = tok[1] == b"vertex"
                if in_vertex:
                    count = int(tok[2])
            elif tok[0] == b"property" and in_vertex:
                props.append((tok[2].decode(), _DTYPES[tok[1].decode()]))
            elif tok[0] == b"end_header":
                break
        names = [n for n, _ in props]
        dtype = np.dtype([(n, t) for n, t in props])
        if fmt == "binary_little_endian":
            data = np.frombuffer(f.read(count * dtype.itemsize), dtype=dtype,
                                 count=count)
        elif fmt == "ascii":
            raw = np.loadtxt(io.BytesIO(f.read()), max_rows=count, ndmin=2)
            data = np.zeros(count, dtype=dtype)
            for i, n in enumerate(names):
                data[n] = raw[:, i]
        else:
            raise ValueError(f"unsupported PLY format {fmt}")
        return PlyVertexData(names=names, data=data)


def _write_ply(path: str, arrays: dict[str, np.ndarray]):
    """arrays: ordered {name: (N,) float32}; writes f4 binary_little_endian."""
    names = list(arrays)
    n = len(next(iter(arrays.values())))
    dtype = np.dtype([(name, "<f4") for name in names])
    rec = np.zeros(n, dtype=dtype)
    for name in names:
        rec[name] = arrays[name].astype(np.float32)
    header = ["ply", "format binary_little_endian 1.0",
              f"element vertex {n}"]
    header += [f"property float {name}" for name in names]
    header += ["end_header", ""]
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "wb") as f:
        f.write("\n".join(header).encode())
        f.write(rec.tobytes())


def save_gaussians(path: str, xyz, features_dc, features_rest, opacity,
                   scaling, rotation):
    """Write the 3DGS attribute layout. features_dc (N,1,3) and
    features_rest (N,K-1,3) are flattened channel-major (R coeffs, then G,
    then B)."""
    xyz = np.asarray(xyz, np.float32)
    n = xyz.shape[0]
    f_dc = np.asarray(features_dc, np.float32).transpose(0, 2, 1).reshape(n, -1)
    f_rest = np.asarray(features_rest, np.float32).transpose(0, 2, 1).reshape(n, -1)
    opacity = np.asarray(opacity, np.float32).reshape(n, -1)
    scaling = np.asarray(scaling, np.float32)
    rotation = np.asarray(rotation, np.float32)

    arrays: dict[str, np.ndarray] = {}
    for i, name in enumerate("xyz"):
        arrays[name] = xyz[:, i]
    for name in ("nx", "ny", "nz"):
        arrays[name] = np.zeros(n, np.float32)
    for i in range(f_dc.shape[1]):
        arrays[f"f_dc_{i}"] = f_dc[:, i]
    for i in range(f_rest.shape[1]):
        arrays[f"f_rest_{i}"] = f_rest[:, i]
    arrays["opacity"] = opacity[:, 0]
    for i in range(scaling.shape[1]):
        arrays[f"scale_{i}"] = scaling[:, i]
    for i in range(rotation.shape[1]):
        arrays[f"rot_{i}"] = rotation[:, i]
    _write_ply(path, arrays)


def load_gaussians(path: str, max_sh_degree: int = 3) -> dict:
    """Inverse of save_gaussians. Returns a dict of numpy arrays."""
    ply = read_ply(path)
    d = ply.data
    n = len(d)
    xyz = np.stack([d["x"], d["y"], d["z"]], -1).astype(np.float32)
    opacity = np.asarray(d["opacity"], np.float32)[:, None]

    dc = np.zeros((n, 3, 1), np.float32)
    for i in range(3):
        dc[:, i, 0] = d[f"f_dc_{i}"]
    rest_names = sorted((nm for nm in ply.names if nm.startswith("f_rest_")),
                        key=lambda s: int(s.split("_")[-1]))
    k = (max_sh_degree + 1) ** 2
    if len(rest_names) != 3 * k - 3:
        raise ValueError(f"{path}: {len(rest_names)} f_rest fields, expected "
                         f"{3 * k - 3} for SH degree {max_sh_degree}")
    rest = np.zeros((n, len(rest_names)), np.float32)
    for i, nm in enumerate(rest_names):
        rest[:, i] = d[nm]
    rest = rest.reshape(n, 3, k - 1)

    scale_names = sorted((nm for nm in ply.names if nm.startswith("scale_")),
                         key=lambda s: int(s.split("_")[-1]))
    scaling = np.stack([d[nm] for nm in scale_names], -1).astype(np.float32)
    rot_names = sorted((nm for nm in ply.names if nm.startswith("rot")),
                       key=lambda s: int(s.split("_")[-1]))
    rotation = np.stack([d[nm] for nm in rot_names], -1).astype(np.float32)
    return dict(
        xyz=xyz,
        features_dc=dc.transpose(0, 2, 1),          # (N, 1, 3)
        features_rest=rest.transpose(0, 2, 1),      # (N, K-1, 3)
        opacity=opacity,
        scaling=scaling,
        rotation=rotation,
    )


def fetch_point_cloud(path: str):
    """Returns (points (N,3), colors (N,3) in [0,1], normals (N,3))."""
    ply = read_ply(path)
    d = ply.data
    pts = np.stack([d["x"], d["y"], d["z"]], -1).astype(np.float32)
    cols = np.stack([d["red"], d["green"], d["blue"]], -1).astype(np.float32)
    cols = cols / 255.0
    if "nx" in ply.names:
        normals = np.stack([d["nx"], d["ny"], d["nz"]], -1).astype(np.float32)
    else:
        normals = np.zeros_like(pts)
    return pts, cols, normals
