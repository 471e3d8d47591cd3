"""Parameters between the JAX package's layout (numpy arrays) and the
port's modules.

  * `gaussians_from_numpy`: the fields of a `GaussianParams` (any mapping
    of field name -> array) -> the port's GaussianParams.
  * `deformation_from_flat`: the flat dict that `deformation.npz` holds
    (and that the JAX checkpoint module's `_flatten(params["deform"])`
    returns), with keys such as `grid/l0_p0`, `mlp/pos/h0/w`,
    `mlp/feature_out/fo0/b` and, with `empty_voxel`, `empty_voxel` -> a
    `Deformation` module.
  * `deformation_to_flat`: the inverse, for writing snapshots.
  * `train_state_from_numpy`: a whole JAX `TrainState` in the flat layout
    of the JAX checkpoint (`_flatten(state._asdict())`, keys such as
    `params/gauss/xyz`, `opt_state/mu/deform/mlp/pos/h0/w`,
    `opt_state/count`, `alive`, `step`) -> the port's `TrainState`, Adam
    moments included, so that both packages can start from one state (a
    fresh one, or one after a densify or a resize: the layout holds any
    capacity);
  * `train_state_to_numpy`: the inverse, the flat dict of a JAX
    checkpoint, which the port's checkpoints store.

The JAX package stores a weight `w` as (fan_in, fan_out) and applies
`x @ w + b`; `nn.Linear` keeps (fan_out, fan_in), so weights are
transposed on the way in and out.

The dev tools' kernels (D1-D6, `tools/exp_*.py`, `profile_blend_split.py`,
`profile_kernel_variants.py`) have no parameters to carry across: their
inputs are made from `--seed` with numpy, as the scripts make them.
"""
from __future__ import annotations

from collections.abc import Mapping
from typing import TYPE_CHECKING

import numpy as np
import torch

from fourdgs_tpu_torch.models.deformation import DeformConfig, Deformation
from fourdgs_tpu_torch.models.gaussians import GaussianParams
from fourdgs_tpu_torch.utils.device import resolve_device

if TYPE_CHECKING:
    from fourdgs_tpu_torch.train.state import TrainState

_GAUSS_FIELDS = ("xyz", "features_dc", "features_rest", "scaling",
                 "rotation", "opacity")


def gaussians_from_numpy(fields: Mapping[str, np.ndarray],
                         device: str | torch.device | None = None
                         ) -> GaussianParams:
    """On `device` (None: cuda, which raises without a card)."""
    dev = resolve_device(device)
    return GaussianParams(**{
        k: torch.from_numpy(np.array(fields[k], np.float32)).to(dev)
        for k in _GAUSS_FIELDS})


def _module_key(flat_key: str) -> tuple[str, bool]:
    """'grid/l0_p0' -> ('grid.planes.l0_p0', False);
    'mlp/pos/h0/w' -> ('pos.h0.weight', True); 'empty_voxel' keeps its
    name."""
    if flat_key == "empty_voxel":
        return "empty_voxel", False
    parts = flat_key.split("/")
    if parts[0] == "grid":
        return "grid.planes." + "/".join(parts[1:]), False
    if parts[0] != "mlp" or parts[-1] not in ("w", "b"):
        raise KeyError(f"unknown deformation parameter {flat_key!r}")
    leaf = "weight" if parts[-1] == "w" else "bias"
    return ".".join(parts[1:-1] + [leaf]), parts[-1] == "w"


def deformation_from_flat(flat: Mapping[str, np.ndarray], cfg: DeformConfig,
                          device: str | torch.device | None = None
                          ) -> Deformation:
    """A Deformation holding exactly the parameters of `flat` (strict: a
    missing or extra key raises), on `device` (None: cuda)."""
    dev = resolve_device(device)
    state = {}
    for key, arr in flat.items():
        name, transpose = _module_key(key)
        t = torch.from_numpy(np.array(arr, np.float32))
        state[name] = t.T.contiguous() if transpose else t
    module = Deformation(cfg)
    module.load_state_dict(state, strict=True)
    return module.to(dev)


def _named_to_flat(named) -> dict[str, np.ndarray]:
    flat = {}
    for name, p in named:
        key, transpose = _flat_key(name)
        arr = p.detach().cpu().numpy()
        flat[key] = np.ascontiguousarray(arr.T) if transpose else arr
    return flat


def deformation_to_flat(module: Deformation) -> dict[str, np.ndarray]:
    """Inverse of deformation_from_flat: the deformation.npz layout."""
    return _named_to_flat(module.state_dict().items())


def _flat_key(name: str) -> tuple[str, bool]:
    """Inverse of _module_key: 'grid.planes.l0_p0' -> ('grid/l0_p0',
    False); 'pos.h0.weight' -> ('mlp/pos/h0/w', True)."""
    if name.startswith("grid.planes."):
        return "grid/" + name[len("grid.planes."):], False
    if name == "empty_voxel":
        return name, False
    *path, leaf = name.split(".")
    if leaf not in ("weight", "bias"):
        raise KeyError(f"unknown deformation parameter {name!r}")
    return "mlp/" + "/".join(path) + ("/w" if leaf == "weight" else "/b"), \
        leaf == "weight"


def _subtree(flat: Mapping[str, np.ndarray], prefix: str) -> dict:
    return {k[len(prefix):]: v for k, v in flat.items()
            if k.startswith(prefix)}


def train_state_from_numpy(flat: Mapping[str, np.ndarray],
                           cfg: DeformConfig,
                           device: str | torch.device | None = None
                           ) -> "TrainState":
    """The port's TrainState from a JAX TrainState flattened as the JAX
    checkpoint flattens it, on `device` (None: cuda). The moments take the
    parameters' tree: the gaussian fields, and the deformation's
    parameters by module name with the MLP weights transposed."""
    from fourdgs_tpu_torch.train import optim
    from fourdgs_tpu_torch.train.state import TrainState, make_trainable
    dev = resolve_device(device)

    def tensor(x, dtype=torch.float32):
        return torch.from_numpy(np.array(x)).to(dtype=dtype, device=dev)

    def moments(prefix):
        deform = {}
        for key, arr in _subtree(flat, prefix + "deform/").items():
            name, transpose = _module_key(key)
            t = tensor(arr)
            deform[name] = t.T.contiguous() if transpose else t
        return {"gauss": GaussianParams(**{
                    f: tensor(flat[f"{prefix}gauss/{f}"])
                    for f in _GAUSS_FIELDS}),
                "deform": deform}

    gauss = gaussians_from_numpy(_subtree(flat, "params/gauss/"), dev)
    deform = deformation_from_flat(_subtree(flat, "params/deform/"), cfg, dev)
    params = {"gauss": make_trainable(gauss), "deform": deform}
    mu, nu = moments("opt_state/mu/"), moments("opt_state/nu/")
    names = [name for name, _ in deform.named_parameters()]
    for tree in (mu, nu):
        if sorted(tree["deform"]) != sorted(names):
            raise KeyError("the deformation's moments do not match its "
                           "parameters")
        tree["deform"] = {name: tree["deform"][name] for name in names}
    return TrainState(
        params=params,
        opt_state=optim.AdamGroupState(
            count=tensor(flat["opt_state/count"], torch.int32), mu=mu, nu=nu),
        alive=tensor(flat["alive"], torch.bool),
        aabb=tensor(flat["aabb"]),
        xyz_gradient_accum=tensor(flat["xyz_gradient_accum"]),
        denom=tensor(flat["denom"]),
        max_radii2d=tensor(flat["max_radii2d"]),
        step=tensor(flat["step"], torch.int32))


def train_state_to_numpy(state: "TrainState") -> dict[str, np.ndarray]:
    """Inverse of train_state_from_numpy: the flat dict of the JAX
    checkpoint layout, every array on the host."""
    def host(x):
        return x.detach().cpu().numpy()

    flat = {}
    for prefix, tree in (("params/", {"gauss": state.params["gauss"]}),
                         ("opt_state/mu/", state.opt_state.mu),
                         ("opt_state/nu/", state.opt_state.nu)):
        for f in _GAUSS_FIELDS:
            flat[f"{prefix}gauss/{f}"] = host(getattr(tree["gauss"], f))
    for k, v in deformation_to_flat(state.params["deform"]).items():
        flat["params/deform/" + k] = v
    for which in ("mu", "nu"):
        moments = getattr(state.opt_state, which)["deform"]
        for k, v in _named_to_flat(moments.items()).items():
            flat[f"opt_state/{which}/deform/" + k] = v
    flat["opt_state/count"] = host(state.opt_state.count)
    for name in ("alive", "aabb", "xyz_gradient_accum", "denom",
                 "max_radii2d", "step"):
        flat[name] = host(getattr(state, name))
    return flat
