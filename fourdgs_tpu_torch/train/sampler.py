"""Batch sampling orders over the (camera x frame) grid
(counterpart: fourdgs_tpu/train/sampler.py; a copy, numpy only).

`fine_sample_order` is the reference's FineSampler: for each timestamp,
walk the camera poses in random order while splicing in replayed earlier
samples (multi-camera datasets, `custom_sampler`). `stamp_indices` picks
every view at one timestamp for the coarse stage's zerostamp init.
"""
from __future__ import annotations

import numpy as np


def fine_sample_order(n_views: int, n_poses: int,
                      rng: np.random.Generator) -> np.ndarray:
    """One epoch of FineSampler indices. Views are assumed ordered
    pose-major: index = pose * frame_length + frame."""
    frame_length = n_views // n_poses
    sample_list: list[int] = []
    for i in range(frame_length):
        now_list: list[int] = []
        for _ in range(4):
            idx = rng.permutation(n_poses) * frame_length + i
            now_list = []
            cnt = 0
            for item in idx.tolist():
                now_list.append(int(item))
                cnt += 1
                if cnt % 2 == 0 and len(sample_list) > 2:
                    now_list += [int(x) for x in
                                 rng.choice(sample_list, 2, replace=False)]
        sample_list += now_list
    return np.asarray(sample_list, np.int64)


def stamp_indices(times: np.ndarray, timestamp_value: float | None = None
                  ) -> np.ndarray:
    """Indices of all views at one timestamp (defaults to the earliest)."""
    t = np.asarray(times)
    target = t.min() if timestamp_value is None else timestamp_value
    return np.nonzero(t == target)[0]
