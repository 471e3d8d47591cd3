"""LLFF-style pose math: average pose, spiral render paths, pose conversion
(counterpart: fourdgs_tpu/data/llff_poses.py; a copy, numpy only).

The helpers of the DyNeRF reader (and, later, the MultipleView one): the
poses_bounds.npy layout, the spiral validation path and the pose to
(R, T) conversion with its sign flips.
"""
from __future__ import annotations

import numpy as np


def normalize(v):
    return v / np.linalg.norm(v)


def average_poses(poses: np.ndarray) -> np.ndarray:
    """(N, 3, 4) c2w -> (3, 4) average pose."""
    center = poses[..., 3].mean(0)
    z = normalize(poses[..., 2].mean(0))
    y_ = poses[..., 1].mean(0)
    x = normalize(np.cross(z, y_))
    y = np.cross(x, z)
    return np.stack([x, y, z, center], 1)


def viewmatrix(z, up, pos):
    vec2 = normalize(z)
    vec0 = normalize(np.cross(up, vec2))
    vec1 = normalize(np.cross(vec2, vec0))
    m = np.eye(4)
    m[:3] = np.stack([-vec0, vec1, vec2, pos], 1)
    return m


def render_path_spiral(c2w, up, rads, focal, zdelta, zrate, N_rots=2, N=120):
    render_poses = []
    rads = np.array(list(rads) + [1.0])
    for theta in np.linspace(0.0, 2.0 * np.pi * N_rots, N + 1)[:-1]:
        c = np.dot(c2w[:3, :4],
                   np.array([np.cos(theta), -np.sin(theta),
                             -np.sin(theta * zrate), 1.0]) * rads)
        z = normalize(c - np.dot(c2w[:3, :4], np.array([0, 0, -focal, 1.0])))
        render_poses.append(viewmatrix(z, up, c))
    return render_poses


def get_spiral(c2ws_all: np.ndarray, near_fars: np.ndarray,
               rads_scale: float = 1.0, N_views: int = 120) -> np.ndarray:
    """The spiral validation path around the average pose."""
    c2w = average_poses(c2ws_all)
    up = normalize(c2ws_all[:, :3, 1].sum(0))
    dt = 0.75
    close_depth = near_fars.min() * 0.9
    inf_depth = near_fars.max() * 5.0
    focal = 1.0 / ((1.0 - dt) / close_depth + dt / inf_depth)
    zdelta = near_fars.min() * 0.2
    tt = c2ws_all[:, :3, 3]
    rads = np.percentile(np.abs(tt), 90, 0) * rads_scale
    return np.stack(render_path_spiral(c2w, up, rads, focal, zdelta,
                                       zrate=0.5, N=N_views))


def load_poses_bounds(path: str):
    """poses_bounds.npy -> (poses (N,3,5) in the repo's axis convention,
    near_fars (N,2), hwf (3,)). Applies the LLFF->NeRF axis swap."""
    arr = np.load(path)
    poses = arr[:, :-2].reshape([-1, 3, 5])
    near_fars = arr[:, -2:]
    hwf = poses[0, :, -1]
    poses = np.concatenate(
        [poses[..., 1:2], -poses[..., :1], poses[..., 2:4]], -1)
    return poses, near_fars, hwf


def c2w_to_rt(pose: np.ndarray):
    """The DyNeRF loaders' pose -> (R, T) with their sign flips."""
    R = np.array(pose[:3, :3])
    R = -R
    R[:, 0] = -R[:, 0]
    T = -pose[:3, 3].dot(R)
    return R, T
