"""The cameras of the benchmark: the training bank and the serving path of
a configuration's rig, as dicts of float32 tensors (`world_view`,
`full_proj`, `cam_center`, `tanfovx`, `tanfovy`, `time`).

The matrix math is a frozen copy of fourdgs_tpu_torch/ops/transforms.py
(`world_to_view`, `projection_matrix`) and fourdgs_tpu_torch/data/camera.py
(`make_camera`, `look_at_camera`'s basis): column vectors,
p_view = world_view @ [p, 1], p_clip = full_proj @ [p, 1], w_clip = z_view.

Two rigs, named by the configuration (`assumed.rig.kind`):
  * "orbit" (D-NeRF's synthetic captures): cameras at `radius` from the
    origin looking at it; the bank's view i at azimuth 2 pi frac(i phi)
    and an elevation in [elev_min, elev_max] from frac(i / phi + 1/2),
    phi the golden ratio, with timestamp i / (V - 1); the path's frame at
    phase u goes round once at `path_elevation`.
  * "forward" (N3V's rig for DyNeRF): `cols` x `rows` cameras on the plane
    z = `distance`, `spacing` apart, each looking at the origin; the
    bank's view i is camera (7 i) mod n at frame (37 i) mod T of T
    `time_frames`; the path's frame at phase u sits on the rig's arc,
    x = xmax sin(2 pi u), y = 0.
"""
from __future__ import annotations

import math

import numpy as np
import torch

GOLDEN = (1 + 5 ** 0.5) / 2
ZNEAR, ZFAR = 0.01, 100.0


def world_to_view(R: np.ndarray, t: np.ndarray) -> np.ndarray:
    Rt = np.zeros((4, 4))
    Rt[:3, :3] = R.transpose()
    Rt[:3, 3] = t
    Rt[3, 3] = 1.0
    return np.float32(Rt)


def projection_matrix(znear, zfar, fovx, fovy) -> np.ndarray:
    tan_y = math.tan(fovy / 2)
    tan_x = math.tan(fovx / 2)
    top = tan_y * znear
    right = tan_x * znear
    P = np.zeros((4, 4))
    P[0, 0] = znear / right
    P[1, 1] = znear / top
    P[2, 2] = zfar / (zfar - znear)
    P[2, 3] = -(zfar * znear) / (zfar - znear)
    P[3, 2] = 1.0
    return np.float32(P)


def look_at(pos, fovx: float, fovy: float, time: float) -> dict:
    """A camera at `pos` looking at the origin, as numpy float32 arrays."""
    pos = np.asarray(pos, np.float64)
    fwd = -pos / np.linalg.norm(pos)
    up = np.array([0.0, 1.0, 0.0])
    right = np.cross(up, fwd)
    right /= np.linalg.norm(right)
    true_up = np.cross(fwd, right)
    r_w2c = np.stack([right, true_up, fwd])
    W = world_to_view(r_w2c.T, -r_w2c @ pos)
    P = projection_matrix(ZNEAR, ZFAR, fovx, fovy)
    return {"world_view": W, "full_proj": np.float32(P @ W),
            "cam_center": np.float32(np.linalg.inv(W)[:3, 3]),
            "tanfovx": np.float32(np.tan(fovx * 0.5)),
            "tanfovy": np.float32(np.tan(fovy * 0.5)),
            "time": np.float32(time)}


def to_tensors(cam: dict, device) -> dict:
    return {k: torch.as_tensor(np.asarray(v, np.float32), device=device)
            for k, v in cam.items()}


def fovs(rig: dict, width: int, height: int) -> tuple[float, float]:
    fovx = rig["fovx"]
    return fovx, 2 * math.atan(math.tan(fovx / 2) * height / width)


def _orbit_pos(radius, azimuth, elevation):
    return [radius * math.cos(elevation) * math.sin(azimuth),
            radius * math.sin(elevation),
            radius * math.cos(elevation) * math.cos(azimuth)]


def _frac(x: float) -> float:
    return x - math.floor(x)


def _forward_positions(rig: dict) -> list:
    cols, rows, s, d = rig["cols"], rig["rows"], rig["spacing"], \
        rig["distance"]
    return [[(c - (cols - 1) / 2) * s, (r - (rows - 1) / 2) * s, d]
            for r in range(rows) for c in range(cols)]


def bank(rig: dict, views: int, time_frames: int, width: int,
         height: int) -> list[dict]:
    """The training bank's V views (numpy), the same for every seed."""
    fovx, fovy = fovs(rig, width, height)
    out = []
    for i in range(views):
        if rig["kind"] == "orbit":
            az = 2 * math.pi * _frac(i * GOLDEN)
            lo, hi = map(math.radians, (rig["elev_min"], rig["elev_max"]))
            el = lo + (hi - lo) * _frac(i / GOLDEN + 0.5)
            pos = _orbit_pos(rig["radius"], az, el)
            t = i / max(views - 1, 1)
        elif rig["kind"] == "forward":
            cams = _forward_positions(rig)
            pos = cams[(7 * i) % len(cams)]
            t = ((37 * i) % time_frames) / max(time_frames - 1, 1)
        else:
            raise ValueError(f"rig {rig['kind']!r}")
        out.append(look_at(pos, fovx, fovy, t))
    return out


def path(rig: dict, period: int, time_frames: int, width: int,
         height: int) -> list[dict]:
    """The serving path's distinct requests (numpy): frame i at phase
    (i mod period) / period and timestamp (i mod T) / (T - 1), for i below
    lcm(period, T)."""
    fovx, fovy = fovs(rig, width, height)
    n = math.lcm(period, time_frames)
    out = []
    for i in range(n):
        u = (i % period) / period
        t = (i % time_frames) / max(time_frames - 1, 1)
        if rig["kind"] == "orbit":
            pos = _orbit_pos(rig["radius"], 2 * math.pi * u,
                             math.radians(rig["path_elevation"]))
        else:
            xs = [p[0] for p in _forward_positions(rig)]
            pos = [max(xs) * math.sin(2 * math.pi * u), 0.0,
                   rig["distance"]]
        out.append(look_at(pos, fovx, fovy, t))
    return out
