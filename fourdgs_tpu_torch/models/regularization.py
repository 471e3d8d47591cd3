"""HexPlane grid regularizers: plane smoothness, time smoothness, L1 to one
(counterpart: fourdgs_tpu/models/regularization.py).

Second-difference smoothness along each plane's first stored axis (H),
over the spatial planes {0, 1, 3} ("plane") and the time planes {2, 4, 5}
("time"), plus mean |1 - grid| over the time planes. The grids are the
deformation's `grid.planes`, keyed `l{level}_p{plane}` as in the JAX
package.
"""
from __future__ import annotations

from collections.abc import Mapping

import torch

SPACE_PLANES = (0, 1, 3)
TIME_PLANES = (2, 4, 5)


def _plane_id(name: str) -> int:
    return int(name.split("_p")[1])


def plane_smoothness(plane: torch.Tensor) -> torch.Tensor:
    """Mean squared second difference along axis 0 (the H axis)."""
    first = plane[1:] - plane[:-1]
    second = first[1:] - first[:-1]
    return (second ** 2).mean()


def _sum_over(grids: Mapping[str, torch.Tensor], plane_ids) -> torch.Tensor:
    total = 0.0
    for name, g in grids.items():
        if _plane_id(name) in plane_ids:
            total = total + plane_smoothness(g)
    return total


def plane_regulation(grids) -> torch.Tensor:
    return _sum_over(grids, SPACE_PLANES)


def time_regulation(grids) -> torch.Tensor:
    return _sum_over(grids, TIME_PLANES)


def l1_time_regulation(grids) -> torch.Tensor:
    total = 0.0
    for name, g in grids.items():
        if _plane_id(name) in TIME_PLANES:
            total = total + (1.0 - g).abs().mean()
    return total


def compute_regulation(grids: Mapping[str, torch.Tensor],
                       time_smoothness_weight: float,
                       l1_time_planes_weight: float,
                       plane_tv_weight: float) -> torch.Tensor:
    """plane_tv * plane + time_smoothness * time + l1_time * L1."""
    return (plane_tv_weight * plane_regulation(grids)
            + time_smoothness_weight * time_regulation(grids)
            + l1_time_planes_weight * l1_time_regulation(grids))
