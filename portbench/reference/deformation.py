"""Frozen copy of fourdgs_tpu_torch/models/hexplane.py (its plain sampling:
`index_select` for the gathers) and of the forward of
fourdgs_tpu_torch/models/deformation.py, over a flat dict of named tensors.

The parameters are keyed as `Deformation.named_parameters()` names them
(`grid.planes.l{level}_p{plane}`, `feature_out.fo{i}.weight`,
`pos.h0.weight`, ...), weights stored (out, in). `DeformSpec` holds the
configuration's widths and switches. Reference quirks kept, as in the
original: aabb rows are (max, min), timestamps are not normalised, the
multires multipliers scale only the spatial resolutions, plane `ci` over
coordinates (a, b) is stored (reso_b, reso_a, C).
"""
from __future__ import annotations

import dataclasses
import itertools

import torch

from portbench.reference.precision import linear

COO_COMBS = tuple(itertools.combinations(range(4), 2))


@dataclasses.dataclass(frozen=True)
class DeformSpec:
    resolution: tuple
    out_dim: int
    multires: tuple
    net_width: int
    defor_depth: int
    no_dx: bool = False
    no_ds: bool = False
    no_dr: bool = False
    no_do: bool = True
    no_dshs: bool = True
    sh_coeffs: int = 16
    timenet_width: int = 64
    timenet_output: int = 32
    timebase_pe: int = 4

    @property
    def feat_dim(self) -> int:
        return self.out_dim * len(self.multires)

    def level_resolution(self, level: int) -> list:
        mult = self.multires[level]
        return [r * mult for r in self.resolution[:3]] + [self.resolution[3]]

    def shapes(self) -> dict:
        """Every parameter's name and shape, in `named_parameters` order."""
        out = {}
        for lvl in range(len(self.multires)):
            reso = self.level_resolution(lvl)
            for ci, (a, b) in enumerate(COO_COMBS):
                out[f"grid.planes.l{lvl}_p{ci}"] = (reso[b], reso[a],
                                                    self.out_dim)
        w = self.net_width
        dims = [(self.feat_dim, w)] + [(w, w)] * (self.defor_depth - 1)
        for i, (fi, fo) in enumerate(dims):
            out[f"feature_out.fo{i}.weight"] = (fo, fi)
            out[f"feature_out.fo{i}.bias"] = (fo,)
        for head, dim in (("pos", 3), ("scales", 3), ("rotations", 4),
                          ("opacity", 1), ("shs", self.sh_coeffs * 3)):
            out[f"{head}.h0.weight"] = (w, w)
            out[f"{head}.h0.bias"] = (w,)
            out[f"{head}.h1.weight"] = (dim, w)
            out[f"{head}.h1.bias"] = (dim,)
        tin = 2 * self.timebase_pe + 1
        out["timenet.t0.weight"] = (self.timenet_width, tin)
        out["timenet.t0.bias"] = (self.timenet_width,)
        out["timenet.t1.weight"] = (self.timenet_output, self.timenet_width)
        out["timenet.t1.bias"] = (self.timenet_output,)
        return out


def normalize_aabb(pts: torch.Tensor, aabb: torch.Tensor) -> torch.Tensor:
    return (pts - aabb[0]) * (2.0 / (aabb[1] - aabb[0])) - 1.0


def _axis_coord(u: torch.Tensor, size: int):
    x = torch.clamp((u + 1.0) * 0.5 * (size - 1), 0.0, size - 1)
    x0 = torch.floor(x)
    return torch.clamp(x0.to(torch.int32), 0, size - 1), x - x0


def bilinear_sample(plane, u, v):
    h, w, c = plane.shape
    x0, fx = _axis_coord(u, w)
    y0, fy = _axis_coord(v, h)
    x1 = torch.clamp(x0 + 1, max=w - 1)
    y1 = torch.clamp(y0 + 1, max=h - 1)
    fx = fx[:, None]
    fy = fy[:, None]
    flat = plane.reshape(h * w, c)

    def at(y, x):
        return flat.index_select(0, (y * w + x).long())

    top = at(y0, x0) * (1 - fx) + at(y0, x1) * fx
    bot = at(y1, x0) * (1 - fx) + at(y1, x1) * fx
    return top * (1 - fy) + bot * fy


def bilinear_sample_const_v(plane, u, v):
    """One timestamp for every point: the v lerp on two plane rows first."""
    h, w, _ = plane.shape
    y = torch.clamp((v + 1.0) * 0.5 * (h - 1), 0.0, h - 1)
    y0 = torch.clamp(torch.floor(y), max=max(h - 2, 0))
    fy = y - y0
    i0 = torch.clamp(y0.long(), 0, max(h - 2, 0)).reshape(1)
    rows = plane.index_select(0, torch.cat(
        [i0, torch.clamp(i0 + 1, max=h - 1)]))
    row = rows[0] * (1.0 - fy) + rows[1] * fy
    x0, fx = _axis_coord(u, w)
    x1 = torch.clamp(x0 + 1, max=w - 1)
    fx = fx[:, None]
    return (row.index_select(0, x0.long()) * (1.0 - fx)
            + row.index_select(0, x1.long()) * fx)


def hexplane(params: dict, spec: DeformSpec, pts_norm: torch.Tensor,
             t: torch.Tensor) -> torch.Tensor:
    """(N, feat_dim): per level the product over the six planes, levels
    concatenated; `t` one timestamp (0-d)."""
    outs = []
    for lvl in range(len(spec.multires)):
        prod = None
        for ci, (a, b) in enumerate(COO_COMBS):
            plane = params[f"grid.planes.l{lvl}_p{ci}"]
            if b == 3:
                s = bilinear_sample_const_v(plane, pts_norm[:, a], t)
            else:
                s = bilinear_sample(plane, pts_norm[:, a], pts_norm[:, b])
            prod = s if prod is None else prod * s
        outs.append(prod)
    return torch.cat(outs, dim=-1)


def deform(params: dict, spec: DeformSpec, aabb, xyz, scaling, rotation,
           opacity, shs, t, precision: str):
    """The deformed raw parameters (xyz, scaling, rotation, opacity, shs)
    at timestamp `t` (0-d tensor)."""
    n = xyz.shape[0]

    def lin(x, name):
        return linear(x, params[name + ".weight"], params[name + ".bias"],
                      precision)

    def head(x, name):
        return lin(torch.relu(lin(torch.relu(x), name + ".h0")), name + ".h1")

    feat = hexplane(params, spec, normalize_aabb(xyz, aabb), t)
    hidden = lin(feat, "feature_out.fo0")
    for i in range(max(spec.defor_depth, 1) - 1):
        hidden = lin(torch.relu(hidden), f"feature_out.fo{i + 1}")
    mask = torch.ones((n, 1), dtype=xyz.dtype, device=xyz.device)
    out_xyz = xyz if spec.no_dx else xyz * mask + head(hidden, "pos")
    out_scaling = (scaling if spec.no_ds
                   else scaling * mask + head(hidden, "scales"))
    out_rotation = (rotation if spec.no_dr
                    else rotation + head(hidden, "rotations"))
    out_opacity = (opacity if spec.no_do
                   else opacity * mask + head(hidden, "opacity"))
    out_shs = shs
    if not spec.no_dshs:
        dshs = head(hidden, "shs").reshape(n, spec.sh_coeffs, 3)
        out_shs = shs * mask[..., None] + dshs
    return out_xyz, out_scaling, out_rotation, out_opacity, out_shs
