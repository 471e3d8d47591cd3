"""What the two kinds of cell share: the run's context, the reference's
renders of a configuration, the outcome a cell hands to run.py."""
from __future__ import annotations

import dataclasses
import time

import torch

from portbench.core import scene
from portbench.reference import raster
from portbench.reference.splats import project, splats

# faults a test or a check plants under the timed path, by kind of cell
FAULTS = {"train": ("unchanged", "half_batch"), "serve": ("altered",)}


@dataclasses.dataclass
class Run:
    cell: dict
    config: dict
    mix: dict
    seed: int
    seconds: float
    trace: bool
    device: torch.device
    t0: float                      # the process's start, perf_counter
    control: str | None = None     # "tf32": the reference in the program's
    #                                place, one precision down
    fault: str | None = None       # one of FAULTS, planted in the program
    phases: dict = dataclasses.field(default_factory=dict)

    def mark(self, phase: str) -> None:
        """The seconds since the last mark (or the process's start), after
        the device's queue drains, under `phase` in the run's notes."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        now = time.perf_counter()
        self.phases[phase] = now - self.t0 - sum(self.phases.values())

    @property
    def size(self) -> tuple[int, int]:
        w, h = self.config["published"]["image"]
        return w, h


@dataclasses.dataclass
class Outcome:
    attempted: int
    failed: int
    metrics: dict                  # end-to-end (untraced) or per-layer
    compared: dict                 # name -> (number, limit)
    memory_peak_bytes: int
    busy_s: float | None = None
    window_s: float | None = None
    breakdown: dict | None = None
    notes: dict = dataclasses.field(default_factory=dict)

    @property
    def correct(self) -> bool:
        return all(v <= lim for v, lim in self.compared.values())


def reference_image(params, fixed, config, cam, precision,
                    with_counts=False):
    """The reference's render of `cam` (a dict of tensors), and its
    Evaluations where asked."""
    w, h = config["published"]["image"]
    tile = config["published"]["tile_size"]
    spec = scene.deform_spec(config)
    with torch.no_grad():
        xyz, scales, quats, opac, colors = splats(params, spec,
                                                  fixed["aabb"], cam,
                                                  precision)
        proj = project(xyz, scales, quats, opac, cam, w, h, tile,
                       fixed["alive"], precision)
        img, ev = raster.rasterize(proj, colors, opac, fixed["bg"], w, h,
                                   tile, precision)
    return (img, ev) if with_counts else img


def norm_gaps(prog: dict, ref: dict, counted: list) -> dict:
    """Each counted leaf's gap between the program's norm and the
    reference's, against the larger of the reference's norm of that leaf
    and of the median leaf."""
    norms = {k: float(torch.linalg.vector_norm(v.double())) for k, v in
             ref.items()}
    med = sorted(norms.values())[len(norms) // 2]
    return {k: abs(float(torch.linalg.vector_norm(prog[k].double()))
                   - norms[k]) / max(norms[k], med, 1e-30) for k in counted}
