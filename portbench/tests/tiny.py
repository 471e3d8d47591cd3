"""Tiny versions of the benchmark's cells for the CPU tests: the real
configuration files with the HexPlane's resolution, the image, the count
and the timestamps cut down, and a port config file that states the same
cut, written under a test's temporary directory."""
from __future__ import annotations

import json
import time
from pathlib import Path

import torch

from portbench.core import common

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
TRAIN = {"kind": "train", "views": 6, "check_steps": 3, "warmup_steps": 1,
         "trace_steps": 2}
SERVE = {"kind": "serve", "loop": "closed", "period": 4, "sample_frames": 3,
         "trace_frames": 3}
TRAIN_LIMITS = json.loads(
    (BENCH / "limits" / "dnerf_bouncingballs.train.json").read_text())
SERVE_LIMITS = json.loads(
    (BENCH / "limits" / "dnerf_bouncingballs.serve.json").read_text())
PORT_CONFIGS = {"dnerf_bouncingballs": "dnerf/bouncingballs.py",
                "dynerf_cut_roasted_beef": "dynerf/cut_roasted_beef.py"}


def config(name: str, tmp: Path) -> dict:
    cfg = json.loads((BENCH / "configs" / f"{name}.json").read_text())
    dim = cfg["published"]["kplanes_dim"]
    port = tmp / f"{name}.py"
    base = ROOT / "fourdgs_tpu_torch" / "configs" / PORT_CONFIGS[name]
    port.write_text(
        f"_base_ = {str(base)!r}\n"
        "ModelHiddenParams = dict(kplanes_config={'grid_dimensions': 2, "
        f"'input_coordinate_dim': 4, 'output_coordinate_dim': {dim}, "
        "'resolution': [8, 8, 8, 6]})\n")
    cfg["port_config"] = str(port)
    cfg["published"]["kplanes_resolution"] = [8, 8, 8, 6]
    cfg["published"]["image"] = [64, 48]
    cfg["assumed"].update(gaussians=1500, capacity=4096, time_frames=6)
    return cfg


def run(name: str, kind: str, tmp: Path, **kw):
    """A tiny run of `name`'s `kind` cell on the CPU: its Outcome."""
    from portbench.core import serve_cell, train_cell
    mix, limits, module = ((TRAIN, TRAIN_LIMITS, train_cell) if kind ==
                           "train" else (SERVE, SERVE_LIMITS, serve_cell))
    r = common.Run(cell={"limits": limits}, config=config(name, tmp),
                   mix={**mix, **kw.pop("mix", {})},
                   seed=kw.pop("seed", 2**31 + 7),
                   seconds=0.2, trace=kw.pop("trace", False),
                   device=torch.device("cpu"), t0=time.perf_counter(), **kw)
    return r, module.run(r)
