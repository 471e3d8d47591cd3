"""Multi-resolution HexPlane (K-Planes) spatio-temporal feature field
(counterpart: fourdgs_tpu/models/hexplane.py).

Six 2D planes per scale over coordinate pairs of (x, y, z, t), bilinear
sampling with align-corners and border clamp, per-scale feature product,
cross-scale concat.

Plane index convention (itertools.combinations of 4 coords):
0=(x,y) 1=(x,z) 2=(x,t) 3=(y,z) 4=(y,t) 5=(z,t). Plane `ci` over coords
(a, b) is stored (reso_b, reso_a, C) under the key `l{level}_p{ci}`: the
first coord indexes the width axis.

Reference quirks kept for parity with the JAX package:
  * aabb rows are (max, min), so normalize maps max->-1, min->+1;
  * timestamps are NOT aabb-normalized: t in [0,1] samples only half the
    [-1,1] time-grid extent;
  * multires multipliers scale only the three spatial resolutions.
"""
from __future__ import annotations

import dataclasses
import itertools
import os

import torch
from torch import nn

from fourdgs_tpu_torch.ops.gather import gather_rows
from fourdgs_tpu_torch.ops.scatter import scatter_add_rows

COO_COMBS = tuple(itertools.combinations(range(4), 2))


@dataclasses.dataclass(frozen=True)
class HexPlaneConfig:
    resolution: tuple[int, int, int, int] = (64, 64, 64, 25)
    out_dim: int = 32
    multires: tuple[int, ...] = (1, 2, 4, 8)
    init_a: float = 0.1
    init_b: float = 0.5

    @property
    def feat_dim(self) -> int:
        return self.out_dim * len(self.multires)


def normalize_aabb(pts: torch.Tensor, aabb: torch.Tensor) -> torch.Tensor:
    """aabb (2,3) rows (max, min); maps max->-1, min->+1."""
    return (pts - aabb[0]) * (2.0 / (aabb[1] - aabb[0])) - 1.0


def _axis_coord(u: torch.Tensor, size: int):
    """Align-corners coordinate in [-1, 1] -> (floor index, int32 as in
    JAX, and fraction), border-clamped. A NaN coordinate keeps a NaN
    fraction and gathers row 0 (the integer conversion of a NaN is
    undefined; JAX's gather clamps it), so that the NaN guard sees it
    instead of an index out of range."""
    x = torch.clamp((u + 1.0) * 0.5 * (size - 1), 0.0, size - 1)
    x0 = torch.floor(x)
    return torch.clamp(x0.to(torch.int32), 0, size - 1), x - x0


class _GatherRows(torch.autograd.Function):
    """table[idx] with a swappable backward (JAX: the custom VJP of
    hexplane.py:_gather_rows). The forward is D1 (`ops/gather.py:
    gather_rows`, csrc/gather.cu) on the card and its plain
    `index_select` on the CPU. The backward is an atomic `index_add_` by
    default, and K4 (`ops/scatter.py:scatter_add_rows`) under the JAX
    package's FOURDGS_HEX_BWD=pallas, read at call time. The JAX package
    takes its kernel only for 128-wide rows whose table fits VMEM; the
    port's K4 takes any rows. (Advanced indexing's backward,
    `index_put_` with accumulate, sorts the indices and walks each run of
    duplicates serially, which costs hundreds of milliseconds when 100k
    points gather from a few thousand plane cells.)"""

    @staticmethod
    def forward(ctx, table, idx):
        ctx.save_for_backward(idx)
        ctx.n_rows = table.shape[0]
        return gather_rows(table, idx)

    @staticmethod
    def backward(ctx, g):
        (idx,) = ctx.saved_tensors
        g = g.contiguous()
        if os.environ.get("FOURDGS_HEX_BWD") == "pallas":
            return scatter_add_rows(idx, g, n_out=ctx.n_rows), None
        out = torch.zeros((ctx.n_rows, g.shape[1]), dtype=g.dtype,
                          device=g.device)
        return out.index_add_(0, idx, g), None


def _gather_rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """table[idx] for (rows, C) float32 tables and (N,) int32 indices in
    [0, rows)."""
    return _GatherRows.apply(table, idx)


def bilinear_sample(plane: torch.Tensor, u: torch.Tensor,
                    v: torch.Tensor) -> torch.Tensor:
    """Sample a (H, W, C) plane at u (width) and v (height) coords in
    [-1, 1]. Returns (N, C)."""
    h, w, c = plane.shape
    x0, fx = _axis_coord(u, w)
    y0, fy = _axis_coord(v, h)
    x1 = torch.clamp(x0 + 1, max=w - 1)
    y1 = torch.clamp(y0 + 1, max=h - 1)
    fx = fx[:, None]
    fy = fy[:, None]
    flat = plane.reshape(h * w, c)

    def at(y, x):
        return _gather_rows(flat, y * w + x)

    top = at(y0, x0) * (1 - fx) + at(y0, x1) * fx
    bot = at(y1, x0) * (1 - fx) + at(y1, x1) * fx
    return top * (1 - fy) + bot * fy


def bilinear_sample_const_v(plane: torch.Tensor, u: torch.Tensor,
                            v: torch.Tensor) -> torch.Tensor:
    """bilinear_sample for a scalar v (the render case: one timestamp per
    camera). The v lerp is done once on two plane rows, then each point
    gathers its two x corners from that row. Same clamping as
    bilinear_sample; the two lerps run in the JAX fast path's order. The
    rows are picked by `index_select` on the device: indexing with a 0-d
    tensor would read it to the host."""
    h, w, _ = plane.shape
    y = torch.clamp((v + 1.0) * 0.5 * (h - 1), 0.0, h - 1)
    y0 = torch.clamp(torch.floor(y), max=max(h - 2, 0))
    fy = y - y0
    i0 = torch.clamp(y0.long(), 0, max(h - 2, 0)).reshape(1)
    rows = plane.index_select(0, torch.cat(
        [i0, torch.clamp(i0 + 1, max=h - 1)]))             # (2, w, c)
    row = rows[0] * (1.0 - fy) + rows[1] * fy            # (w, c)
    x0, fx = _axis_coord(u, w)
    x1 = torch.clamp(x0 + 1, max=w - 1)
    fx = fx[:, None]
    return (_gather_rows(row, x0) * (1.0 - fx)
            + _gather_rows(row, x1) * fx)


class HexPlaneField(nn.Module):
    """The planes of every level, as parameters keyed `l{lvl}_p{ci}`."""

    def __init__(self, cfg: HexPlaneConfig, generator: torch.Generator
                 | None = None):
        super().__init__()
        self.cfg = cfg
        planes = {}
        for lvl, mult in enumerate(cfg.multires):
            reso = [r * mult for r in cfg.resolution[:3]] + [cfg.resolution[3]]
            for ci, (a, b) in enumerate(COO_COMBS):
                shape = (reso[b], reso[a], cfg.out_dim)
                if 3 in (a, b):
                    p = torch.ones(shape)
                else:
                    p = torch.empty(shape).uniform_(cfg.init_a, cfg.init_b,
                                                    generator=generator)
                planes[f"l{lvl}_p{ci}"] = nn.Parameter(p)
        self.planes = nn.ParameterDict(planes)

    def forward(self, pts_norm: torch.Tensor,
                t: torch.Tensor) -> torch.Tensor:
        """(N, feat_dim): per-level product over 6 planes, concat over
        levels. `t` is a 0-d tensor (one timestamp) or (N,)."""
        t_scalar = t.dim() == 0
        coords = pts_norm if t_scalar else torch.cat(
            [pts_norm, t.expand(pts_norm.shape[0])[:, None]], dim=-1)
        outs = []
        for lvl in range(len(self.cfg.multires)):
            prod = None
            for ci, (a, b) in enumerate(COO_COMBS):
                plane = self.planes[f"l{lvl}_p{ci}"]
                if t_scalar and b == 3:
                    s = bilinear_sample_const_v(plane, coords[:, a], t)
                else:
                    s = bilinear_sample(plane, coords[:, a], coords[:, b])
                prod = s if prod is None else prod * s
            outs.append(prod)
        return torch.cat(outs, dim=-1)
