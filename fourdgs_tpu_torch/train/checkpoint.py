"""Model snapshots and training checkpoints
(counterpart: fourdgs_tpu/train/checkpoint.py).

A snapshot is point_cloud/{stage_}iteration_N/ holding point_cloud.ply
(3DGS layout, alive points only) and deformation.npz (the flattened
deformation parameters plus `__aabb__`), as the JAX package writes it.
`save_snapshot` writes the same layout from the port's objects.

A checkpoint chkpnt_{stage}_{iter}.npz holds every leaf of the training
state under the JAX package's dotted keys (`params/gauss/xyz`,
`opt_state/mu/deform/mlp/pos/h0/w`, `alive`, ...) plus `__iteration__`,
`__stage__` and `__active_sh__`, so that each package resumes from the
other's file.
"""
from __future__ import annotations

import os
import re

import numpy as np
import torch

from fourdgs_tpu_torch import convert
from fourdgs_tpu_torch.data import ply
from fourdgs_tpu_torch.models.deformation import DeformConfig, Deformation
from fourdgs_tpu_torch.models.gaussians import GaussianParams
from fourdgs_tpu_torch.utils.device import resolve_device


def load_snapshot(out_dir: str, max_sh_degree: int = 3):
    """-> (gauss arrays dict, deform flat dict, aabb)."""
    gauss = ply.load_gaussians(os.path.join(out_dir, "point_cloud.ply"),
                               max_sh_degree)
    with np.load(os.path.join(out_dir, "deformation.npz")) as z:
        flat = {k: z[k] for k in z.files}
    aabb = flat.pop("__aabb__")
    return gauss, flat, aabb


def find_latest_snapshot(model_path: str, iteration: int = -1,
                         stage_prefix: str = "") -> tuple[str, int]:
    """Pick a snapshot dir. `stage_prefix` restricts to one stage: "" (or
    "fine") matches un-prefixed `iteration_N` dirs; "coarse" matches
    `coarse_iteration_N`. Without it, fine snapshots win ties over coarse
    ones at the same iteration."""
    root = os.path.join(model_path, "point_cloud")
    best, best_it, best_fine = None, -1, False
    pat = re.compile(r"^(?:(\w+)_)?iteration_(\d+)$")
    for name in os.listdir(root):
        m = pat.match(name)
        if not m:
            continue
        stage = m.group(1) or ""
        if stage_prefix and stage != (
                "" if stage_prefix == "fine" else stage_prefix):
            continue
        it = int(m.group(2))
        if iteration >= 0 and it != iteration:
            continue
        is_fine = stage == ""
        if it > best_it or (it == best_it and is_fine and not best_fine):
            best, best_it, best_fine = os.path.join(root, name), it, is_fine
    if best is None:
        raise FileNotFoundError(f"no snapshot under {root}")
    return best, best_it


def restore_gaussians_from_snapshot(out_dir: str, cap: int,
                                    max_sh_degree: int = 3,
                                    device: str | torch.device | None = None):
    """-> (GaussianParams padded to cap, alive, deform flat dict, aabb),
    the tensors on `device` (None: cuda, which raises without a card)."""
    device = resolve_device(device)
    gauss, deform_flat, aabb = load_snapshot(out_dir, max_sh_degree)
    n = gauss["xyz"].shape[0]
    cap = max(cap, n)

    def pad(x):
        out = np.zeros((cap,) + x.shape[1:], np.float32)
        out[:n] = x
        return out

    fields = {k: pad(v) for k, v in gauss.items()}
    fields["rotation"][n:, 0] = 1.0
    alive = torch.zeros((cap,), dtype=torch.bool, device=device)
    alive[:n] = True
    return (convert.gaussians_from_numpy(fields, device), alive, deform_flat,
            aabb)


def deform_params_from_flat(flat: dict, cfg: DeformConfig,
                            device: str | torch.device | None = None
                            ) -> Deformation:
    return convert.deformation_from_flat(flat, cfg, device)


def load_model(model_path: str, iteration: int = -1,
               device: str | torch.device | None = None, configs: str = ""):
    """A trained model's newest (or `iteration`'s) snapshot on `device`
    (None: cuda), with the configs of its cfg_args.json (plus an optional
    config file) -> (cfg, gauss, alive, deformation in eval mode, aabb
    tensor, iteration)."""
    from fourdgs_tpu_torch.train import config as config_mod
    dev = resolve_device(device)
    cfg_path = os.path.join(model_path, "cfg_args.json")
    cfg = (config_mod.load_cfg(cfg_path) if os.path.exists(cfg_path)
           else config_mod.Config())
    if configs:
        cfg = config_mod.apply_config_file(cfg, configs)
    snap_dir, it = find_latest_snapshot(model_path, iteration)
    gauss, alive, flat, aabb = restore_gaussians_from_snapshot(
        snap_dir, cap=1, max_sh_degree=cfg.model.sh_degree, device=dev)
    deform = deform_params_from_flat(
        flat, config_mod.deform_config_from(cfg), dev).eval()
    return (cfg, gauss, alive, deform,
            torch.as_tensor(aabb, dtype=torch.float32, device=dev), it)


def save_snapshot(model_path: str, iteration: int, gauss: GaussianParams,
                  alive: torch.Tensor, deform: Deformation,
                  aabb: np.ndarray, stage: str = "") -> str:
    """Write a snapshot of the alive points: iteration_N for the fine
    stage (or no stage), {stage}_iteration_N for another."""
    tag = (f"{stage}_iteration_{iteration}" if stage and stage != "fine"
           else f"iteration_{iteration}")
    out_dir = os.path.join(model_path, "point_cloud", tag)
    os.makedirs(out_dir, exist_ok=True)
    keep = alive.cpu().numpy()

    def host(x):
        return x.detach().cpu().numpy()[keep]

    ply.save_gaussians(os.path.join(out_dir, "point_cloud.ply"),
                       host(gauss.xyz), host(gauss.features_dc),
                       host(gauss.features_rest), host(gauss.opacity),
                       host(gauss.scaling), host(gauss.rotation))
    flat = convert.deformation_to_flat(deform)
    flat["__aabb__"] = np.asarray(aabb, np.float32)
    np.savez(os.path.join(out_dir, "deformation.npz"), **flat)
    return out_dir


def save_checkpoint(state, path: str, iteration: int, stage: str,
                    active_sh: int = 0):
    """Write every leaf of the training state (JAX: checkpoint.py:154)."""
    os.makedirs(os.path.dirname(os.path.abspath(path)) or ".", exist_ok=True)
    flat = convert.train_state_to_numpy(state)
    flat["__iteration__"] = np.asarray(iteration)
    flat["__stage__"] = np.frombuffer(stage.encode(), dtype=np.uint8)
    flat["__active_sh__"] = np.asarray(active_sh)
    np.savez(path, **flat)


def load_checkpoint(path: str, deform_cfg: DeformConfig,
                    device: str | torch.device | None = None):
    """-> (state, iteration, stage, active_sh), the state on `device`
    (None: cuda). The JAX package rebuilds its pytree from a template
    state; the port needs only the deformation's config. active_sh falls
    back to one degree per 1000 iterations for files without it."""
    with np.load(path) as z:
        flat = {k: z[k] for k in z.files}
    iteration = int(flat.pop("__iteration__"))
    stage = flat.pop("__stage__").tobytes().decode()
    if "__active_sh__" in flat:
        active_sh = int(flat.pop("__active_sh__"))
    else:
        active_sh = min(iteration // 1000, 3)
    state = convert.train_state_from_numpy(flat, deform_cfg, device)
    return state, iteration, stage, active_sh
