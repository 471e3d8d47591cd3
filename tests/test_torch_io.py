"""Port parity for the host-side files the render path reads: the config
copy (train/config.py), the PLY copy (data/ply.py) and snapshot discovery
(train/checkpoint.py), against the JAX package's modules. These are exact
comparisons: the port keeps its own copies and must read and write the
same files."""
import dataclasses
import os

import numpy as np
import pytest
import torch

from fourdgs_tpu.data import ply as jply
from fourdgs_tpu.train import checkpoint as jckpt
from fourdgs_tpu.train import config as jconfig
from fourdgs_tpu.train.loop import raster_config_from as j_raster_config_from
from fourdgs_tpu.train.state import deform_config_from as j_deform_config_from
from fourdgs_tpu_torch.data import ply as tply
from fourdgs_tpu_torch.train import checkpoint as tckpt
from fourdgs_tpu_torch.train import config as tconfig

torch.set_num_threads(1)

JAX_CONFIG_DIR = os.path.join(os.path.dirname(jconfig.__file__), "..",
                              "configs")
CONFIGS = ["dnerf/dnerf_default.py", "dnerf/bouncingballs.py",
           "dnerf/synth_mv.py"]


def _same_fields(port, ref, extra=()):
    """Every field of the port's config equals the JAX one's; the JAX one
    has only the `extra` fields besides."""
    names = {f.name for f in dataclasses.fields(port)}
    assert {f.name for f in dataclasses.fields(ref)} - names == set(extra)
    for name in names:
        if name != "grid":
            assert getattr(port, name) == getattr(ref, name), name


@pytest.mark.parametrize("name", CONFIGS)
def test_config_file_parity(name, tmp_path):
    """`_base_` inheritance (JAX's file through JAX's loader, the port's
    copy through the port's), the static configs built from the groups,
    and the cfg_args.json written by the JAX package."""
    a = jconfig.apply_config_file(jconfig.Config(),
                                  os.path.join(JAX_CONFIG_DIR, name))
    b = tconfig.apply_config_file(tconfig.Config(),
                                  str(tconfig.CONFIG_DIR / name))
    assert dataclasses.asdict(a) == dataclasses.asdict(b)

    jd, td = j_deform_config_from(a), tconfig.deform_config_from(b)
    _same_fields(td, jd)
    # the port takes the constant-t sampler whenever t is a scalar
    assert jd.grid.const_t
    _same_fields(td.grid, jd.grid, extra=("const_t",))
    # the JAX rasterizer's extra knobs pick among its TPU mechanisms; the
    # port has the counting binner's contract only
    jr = j_raster_config_from(a, 640, 480)
    assert jr.binner == "count"
    _same_fields(tconfig.raster_config_from(b, 640, 480), jr,
                 extra=("pair_cap", "backend", "binner", "bin_rank_mode",
                        "fuse_pack"))

    jconfig.save_cfg(a, str(tmp_path / "cfg_args.json"))
    assert dataclasses.asdict(tconfig.load_cfg(
        str(tmp_path / "cfg_args.json"))) == dataclasses.asdict(a)


def test_config_defaults_match():
    assert dataclasses.asdict(jconfig.Config()) == dataclasses.asdict(
        tconfig.Config())


@pytest.mark.parametrize("sh_degree", [0, 3])
def test_ply_byte_compatible(sh_degree, tmp_path):
    rng = np.random.default_rng(sh_degree)
    n, k = 37, (sh_degree + 1) ** 2
    arrays = [rng.normal(size=s).astype(np.float32)
              for s in ((n, 3), (n, 1, 3), (n, k - 1, 3), (n, 1), (n, 3),
                        (n, 4))]
    jply.save_gaussians(str(tmp_path / "j.ply"), *arrays)
    tply.save_gaussians(str(tmp_path / "t.ply"), *arrays)
    assert (tmp_path / "j.ply").read_bytes() == (tmp_path / "t.ply").read_bytes()
    a = jply.load_gaussians(str(tmp_path / "j.ply"), sh_degree)
    b = tply.load_gaussians(str(tmp_path / "j.ply"), sh_degree)
    assert sorted(a) == sorted(b)
    for key in a:
        np.testing.assert_array_equal(a[key], b[key], err_msg=key)
    with pytest.raises(ValueError, match="f_rest"):
        tply.load_gaussians(str(tmp_path / "j.ply"), sh_degree + 1)


@pytest.mark.parametrize("iteration,stage", [(-1, ""), (3, ""), (5, ""),
                                             (-1, "coarse"), (-1, "fine")])
def test_find_latest_snapshot(tmp_path, iteration, stage):
    for d in ("iteration_3", "coarse_iteration_5", "iteration_5",
              "coarse_iteration_7", "not_a_snapshot"):
        os.makedirs(tmp_path / "point_cloud" / d)
    assert tckpt.find_latest_snapshot(str(tmp_path), iteration, stage) == \
        jckpt.find_latest_snapshot(str(tmp_path), iteration, stage)
