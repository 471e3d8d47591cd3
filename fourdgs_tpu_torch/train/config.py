"""Configuration: the JAX package's four hyperparameter groups plus its
rasterizer group, as plain dataclasses with the same fields and defaults
(counterpart: fourdgs_tpu/train/config.py), with:
  * python config files with `_base_` inheritance, loaded by exec;
  * argparse wiring: every scalar field becomes a --flag;
  * `cfg_args.json` dump and load for the post-train tools;
  * the two builders of static configs that the JAX package keeps in
    train/state.py (`deform_config_from`) and train/loop.py
    (`raster_config_from`).
The port's config files are under `CONFIG_DIR` (fourdgs_tpu_torch/configs/,
byte copies of the JAX package's configs/ tree).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any

# the port's config files: one per scene and layout, `_base_` includes
# relative to the including file
CONFIG_DIR = Path(__file__).resolve().parent.parent / "configs"


@dataclass
class ModelParams:
    sh_degree: int = 3
    source_path: str = ""
    model_path: str = ""
    images: str = "images"
    resolution: int = -1
    white_background: bool = True
    data_device: str = "tpu"
    eval: bool = True
    render_process: bool = False   # a gt/render/depth triptych at each test
    #                                eval (tools/train.py, utils/visualize.py)
    add_points: bool = False
    extension: str = ".png"
    llffhold: int = 8


@dataclass
class PipelineParams:
    convert_SHs_python: bool = False
    compute_cov3D_python: bool = False
    debug: bool = False


@dataclass
class ModelHiddenParams:
    net_width: int = 64
    timebase_pe: int = 4
    defor_depth: int = 1
    posebase_pe: int = 10
    scale_rotation_pe: int = 2
    opacity_pe: int = 2
    timenet_width: int = 64
    timenet_output: int = 32
    bounds: float = 1.6
    plane_tv_weight: float = 0.0001
    time_smoothness_weight: float = 0.01
    l1_time_planes: float = 0.0001
    kplanes_config: dict = field(default_factory=lambda: {
        "grid_dimensions": 2,
        "input_coordinate_dim": 4,
        "output_coordinate_dim": 32,
        "resolution": [64, 64, 64, 25],
    })
    multires: list = field(default_factory=lambda: [1, 2, 4, 8])
    no_dx: bool = False
    no_grid: bool = False
    no_ds: bool = False
    no_dr: bool = False
    no_do: bool = True
    no_dshs: bool = True
    empty_voxel: bool = False
    grid_pe: int = 0
    static_mlp: bool = False
    apply_rotation: bool = False
    weight_decay_iteration: int = 5000
    # soft delta saturation bounds (0 = unbounded); see
    # models/deformation.py DeformConfig
    deform_dx_bound: float = 0.0
    deform_ds_bound: float = 0.0
    deform_dr_bound: float = 0.0


@dataclass
class OptimizationParams:
    dataloader: bool = False
    zerostamp_init: bool = False
    custom_sampler: Any = None
    iterations: int = 30_000
    coarse_iterations: int = 3000
    position_lr_init: float = 0.00016
    position_lr_final: float = 0.0000016
    position_lr_delay_mult: float = 0.01
    position_lr_max_steps: int = 20_000
    deformation_lr_init: float = 0.00016
    deformation_lr_final: float = 0.000016
    deformation_lr_delay_mult: float = 0.01
    grid_lr_init: float = 0.0016
    grid_lr_final: float = 0.00016
    feature_lr: float = 0.0025
    opacity_lr: float = 0.05
    scaling_lr: float = 0.005
    rotation_lr: float = 0.001
    percent_dense: float = 0.01
    lambda_dssim: float = 0.0
    lambda_lpips: float = 0.0
    weight_constraint_init: float = 1.0
    weight_constraint_after: float = 0.2
    weight_decay_iteration: int = 5000
    opacity_reset_interval: int = 3000
    densification_interval: int = 100
    densify_from_iter: int = 500
    densify_until_iter: int = 15_000
    densify_grad_threshold_coarse: float = 0.0002
    densify_grad_threshold_fine_init: float = 0.0002
    densify_grad_threshold_after: float = 0.0002
    pruning_from_iter: int = 500
    pruning_interval: int = 100
    opacity_threshold_coarse: float = 0.005
    opacity_threshold_fine_init: float = 0.005
    opacity_threshold_fine_after: float = 0.005
    batch_size: int = 1
    add_point: bool = False
    densify_max_points: int = 360_000
    prune_min_points: int = 200_000


@dataclass
class RasterParams:
    """Rasterizer knobs: buffer capacity and the binner's static budgets.
    The render path reads tile_size, tile_cap, chunk, bin_chunk and
    bin_pairs_per_chunk; the rest are training-loop knobs kept so that
    `cfg_args.json` files round-trip."""
    capacity: int = 400_000
    tile_size: int = 32
    tile_cap: int = 2048
    pair_cap: int = 1 << 21
    chunk: int = 32
    backend: str = "auto"
    bin_chunk: int = 4096
    bin_pairs_per_chunk: int = 16384
    fuse_pack: bool = False
    autogrow: bool = True
    min_bucket: int = 4096
    bucket_headroom: float = 1.5
    # capture the next bucket's step (and the densify statistics' stop)
    # on a thread ahead of its key, as JAX compiles it ahead
    # (train/graphs.py, train/loop.py:BucketPrewarmer)
    prewarm: bool = True
    cap_shrink_spacing: int = 2000


@dataclass
class Config:
    model: ModelParams = field(default_factory=ModelParams)
    pipe: PipelineParams = field(default_factory=PipelineParams)
    opt: OptimizationParams = field(default_factory=OptimizationParams)
    hidden: ModelHiddenParams = field(default_factory=ModelHiddenParams)
    raster: RasterParams = field(default_factory=RasterParams)
    expname: str = ""
    seed: int = 6666


_GROUPS = {"ModelParams": "model", "PipelineParams": "pipe",
           "OptimizationParams": "opt", "ModelHiddenParams": "hidden",
           "RasterParams": "raster"}


def _exec_config_file(path: str) -> dict:
    """Load a python config file, resolving `_base_` includes recursively
    (child values win)."""
    with open(path) as f:
        src = f.read()
    ns: dict[str, Any] = {}
    exec(compile(src, path, "exec"), ns)
    merged: dict[str, Any] = {}
    base = ns.get("_base_")
    if base:
        bases = base if isinstance(base, (list, tuple)) else [base]
        for b in bases:
            parent = _exec_config_file(os.path.join(os.path.dirname(path), b))
            _deep_update(merged, parent)
    child = {k: v for k, v in ns.items()
             if not k.startswith("_") and k != "__builtins__"}
    _deep_update(merged, child)
    return merged


def _deep_update(dst: dict, src: dict):
    for k, v in src.items():
        if isinstance(v, dict) and isinstance(dst.get(k), dict):
            _deep_update(dst[k], v)
        else:
            dst[k] = v


def apply_config_file(cfg: Config, path: str) -> Config:
    """Overlay a config file onto cfg: only keys the group already
    defines win."""
    data = _exec_config_file(path)
    for group_name, attr in _GROUPS.items():
        overrides = data.get(group_name)
        if not overrides:
            continue
        group = getattr(cfg, attr)
        for k, v in overrides.items():
            if hasattr(group, k):
                setattr(group, k, v)
    return cfg


def add_args(parser: argparse.ArgumentParser, cfg: Config):
    """Expose every scalar group field as a --flag (lists and dicts are
    left to config files)."""
    seen = set()
    for attr in _GROUPS.values():
        group = getattr(cfg, attr)
        for f in dataclasses.fields(group):
            if f.name in seen:
                continue
            seen.add(f.name)
            default = getattr(group, f.name)
            try:
                if isinstance(default, bool):
                    parser.add_argument(f"--{f.name}", default=None,
                                        action="store_true")
                elif isinstance(default, (dict, list)) or default is None:
                    continue
                else:
                    parser.add_argument(f"--{f.name}", default=None,
                                        type=type(default))
            except argparse.ArgumentError:
                pass  # flag already defined by the CLI itself
    return parser


def apply_args(cfg: Config, args: argparse.Namespace) -> Config:
    for attr in _GROUPS.values():
        group = getattr(cfg, attr)
        for f in dataclasses.fields(group):
            v = getattr(args, f.name, None)
            if v is not None:
                setattr(group, f.name, v)
    return cfg


def save_cfg(cfg: Config, path: str):
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        json.dump(dataclasses.asdict(cfg), f, indent=2, default=str)


def load_cfg(path: str) -> Config:
    with open(path) as f:
        data = json.load(f)
    cfg = Config()
    for attr in _GROUPS.values():
        group = getattr(cfg, attr)
        for k, v in data.get(attr, {}).items():
            if hasattr(group, k):
                setattr(group, k, v)
    cfg.expname = data.get("expname", "")
    cfg.seed = data.get("seed", 6666)
    return cfg


def deform_config_from(cfg: Config):
    """-> models.deformation.DeformConfig (JAX: train/state.py:40)."""
    from fourdgs_tpu_torch.models.deformation import DeformConfig
    from fourdgs_tpu_torch.models.hexplane import HexPlaneConfig
    h = cfg.hidden
    kp = h.kplanes_config
    return DeformConfig(
        net_width=h.net_width,
        defor_depth=h.defor_depth,
        grid=HexPlaneConfig(
            resolution=tuple(kp["resolution"]),
            out_dim=kp["output_coordinate_dim"],
            multires=tuple(h.multires)),
        timenet_width=h.timenet_width,
        timenet_output=h.timenet_output,
        timebase_pe=h.timebase_pe,
        no_dx=h.no_dx, no_grid=h.no_grid, no_ds=h.no_ds, no_dr=h.no_dr,
        no_do=h.no_do, no_dshs=h.no_dshs, apply_rotation=h.apply_rotation,
        empty_voxel=h.empty_voxel, static_mlp=h.static_mlp,
        sh_coeffs=(cfg.model.sh_degree + 1) ** 2,
        dx_bound=h.deform_dx_bound, ds_bound=h.deform_ds_bound,
        dr_bound=h.deform_dr_bound,
    )


def raster_config_from(cfg: Config, width: int, height: int):
    """-> ops.rasterize_tiled.RasterConfig (JAX: train/loop.py:77)."""
    from fourdgs_tpu_torch.ops.rasterize_tiled import RasterConfig
    r = cfg.raster
    return RasterConfig(img_width=width, img_height=height,
                        tile_size=r.tile_size, tile_cap=r.tile_cap,
                        chunk=r.chunk, bin_chunk=r.bin_chunk,
                        bin_pairs_per_chunk=r.bin_pairs_per_chunk)
