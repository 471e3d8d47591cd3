"""The mesh's captured programs on the CPU (fourdgs_tpu_torch/parallel/,
train/graphs.py, train/loop.py:run_stage) and the scaling tool
(fourdgs_tpu_torch/tools/bench_scaling.py).

There are no CUDA graphs on the CPU, so these tests hold what decides a
capture and what refuses one: a mesh's step key differs by the mesh's
shape, the rank's tile coordinate and its band; a one-rank gloo process
group (in this process) makes `run_stage` refuse `capture=True`, naming
gloo, and run eagerly by default, equal bit for bit to a direct
`sharded_train_step`; a collective over gloo inside a (faked) capture
raises. The scaling tool's meshes follow the JAX script's rule
(scripts/bench_scaling.py:75-81, executed from its source), its points
and colours are `__graft_entry__._synthetic_scene`'s, and its CPU run over
two gloo ranks prints one line per mesh. The captured sharded step and
frame under NCCL are held on the card by tests/test_torch_parallel_gpu.py.
"""
from __future__ import annotations

import json
import re
import socket
import textwrap
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch
import torch.distributed as dist

from fourdgs_tpu_torch.data.camera import look_at_camera
from fourdgs_tpu_torch.parallel import _collectives, sharded
from fourdgs_tpu_torch.parallel.mesh import Mesh, make_mesh
from fourdgs_tpu_torch.tools import bench_scaling
from fourdgs_tpu_torch.train import config as tconfig
from fourdgs_tpu_torch.train import graphs, loop, optim
from fourdgs_tpu_torch.train.state import create_state
# tests/ is on sys.path under pytest (no __init__.py: "prepend" import)
import _torch_parallel_worker as worker  # noqa: E402

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
SIZE = 64


def _cfg():
    cfg = tconfig.Config()
    cfg.model.sh_degree = 1
    cfg.raster = tconfig.RasterParams(capacity=512, tile_size=16,
                                      tile_cap=128, chunk=8, min_bucket=256)
    cfg.hidden.kplanes_config["resolution"] = [8, 8, 8, 4]
    cfg.hidden.kplanes_config["output_coordinate_dim"] = 8
    cfg.hidden.multires = [1, 2]
    cfg.hidden.net_width = 32
    cfg.opt.lambda_dssim = 0.2
    return cfg


def _scene(cfg, views=4):
    rng = np.random.default_rng(2)
    pts = rng.uniform(-1, 1, (300, 3)).astype(np.float32)
    cols = rng.uniform(0, 1, (300, 3)).astype(np.float32)
    st = create_state(cfg, pts, cols, 1.0, device="cpu",
                      generator=torch.Generator().manual_seed(0))
    st = loop.compact_and_resize(st, 512)
    cams = [look_at_camera(theta=0.3 + 0.2 * i, time=i / views,
                           device="cpu") for i in range(views)]
    gts = torch.from_numpy(rng.uniform(
        0, 1, (views, SIZE, SIZE, 3)).astype(np.float32))
    return st, cams, gts


@pytest.fixture
def gloo():
    """A one-rank gloo process group in this process."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=0, world_size=1)
    try:
        yield make_mesh(1, 1)
    finally:
        dist.destroy_process_group()


def test_mesh_step_keys_differ_by_shape_tile_and_band():
    """A mesh's StepKey holds its shape, the rank's tile coordinate and
    band (first tile, count) and the binner's route: keys differ where
    any of them does, and a rank's step function refuses another rank's
    key."""
    rc = tconfig.raster_config_from(_cfg(), SIZE, SIZE)       # 4 x 4 tiles
    odd = tconfig.raster_config_from(_cfg(), SIZE, 48)        # 4 x 3 tiles

    def key(mesh, cfg=rc):
        return graphs.StepKey("fine", 512, cfg, 1, True, 2, 0.0,
                              (0.01, 1e-4, 1e-4), graphs.switches(),
                              sharded.mesh_key(mesh, cfg))

    k12 = [key(Mesh(1, 2, rank=r)) for r in range(2)]
    assert k12[0].mesh == sharded.MeshKey(1, 2, 0, 0, 8, True)
    assert k12[1].mesh == sharded.MeshKey(1, 2, 1, 8, 8, True)
    assert k12[0] != k12[1]
    k21 = key(Mesh(2, 1, rank=1))
    assert k21.mesh == sharded.MeshKey(2, 1, 0, 0, 16, False)
    k14 = key(Mesh(1, 4, rank=1))
    assert k14.mesh == sharded.MeshKey(1, 4, 1, 4, 4, True)
    fallback = key(Mesh(1, 2, rank=1), odd)
    assert fallback.mesh == sharded.MeshKey(1, 2, 1, 6, 6, False)
    keys = [*k12, k21, k14, fallback, key(Mesh(1, 1)),
            graphs.StepKey(*key(Mesh(1, 1))[:-1])]
    assert len(set(keys)) == len(keys)
    assert keys[-1].mesh is None
    assert "mesh 1x2 tile 1 tiles 8+8 band" in k12[1].label()
    assert "fallback" in fallback.label()
    tx = optim.build_optimizer(_cfg().opt, 1.0)
    sharded.step_of_key(tx, Mesh(1, 2, rank=1))(k12[1])
    with pytest.raises(ValueError, match="rank 1 of a 1x2 mesh"):
        sharded.step_of_key(tx, Mesh(1, 2, rank=1))(k12[0])


def test_gloo_mesh_refuses_capture_and_runs_eagerly(gloo, capsys):
    """run_stage over a gloo mesh: capture=True raises and names gloo; the
    default runs eagerly (rank 0 says so), reports no capture, and its
    state after one fine step equals a direct sharded_train_step's from
    the same state and batch, bit for bit."""
    mesh = gloo
    assert mesh.backend == "gloo" and mesh.group is not None
    cfg = _cfg()
    st, cams, gts = _scene(cfg)
    rc = tconfig.raster_config_from(cfg, SIZE, SIZE)

    def run(state, capture):
        tx = optim.build_optimizer(cfg.opt, 1.0)
        state.opt_state = tx.init(state.params)
        return loop.run_stage(cfg, state, "fine", 1, cams, gts, tx, rc,
                              rng=np.random.default_rng(5), mesh=mesh,
                              capture=capture)

    with pytest.raises(ValueError, match="gloo"):
        run(st.to("cpu"), True)
    res = run(st.to("cpu"), None)
    assert res.graphs is None
    assert "run eagerly" in capsys.readouterr().out
    direct = st.to("cpu")
    tx = optim.build_optimizer(cfg.opt, 1.0)
    direct.opt_state = tx.init(direct.params)
    ids = np.random.default_rng(5).permutation(len(cams))[
        :cfg.opt.batch_size]
    sharded.sharded_train_step(
        direct, [cams[i] for i in ids], gts[ids],
        torch.ones(3) if cfg.model.white_background else torch.zeros(3), 0,
        mesh=mesh, stage="fine", raster_cfg=rc, tx=tx,
        reg_weights=(cfg.hidden.time_smoothness_weight,
                     cfg.hidden.l1_time_planes, cfg.hidden.plane_tv_weight),
        lambda_dssim=cfg.opt.lambda_dssim)
    got, want = worker.snapshot(res.state), worker.snapshot(direct)
    assert got.keys() == want.keys()
    for k, v in want.items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)
    assert int(res.state.step) == int(direct.step) == 1


def test_a_collective_under_a_faked_capture_on_gloo_raises(gloo,
                                                           monkeypatch):
    """Inside a capture a collective over a gloo group raises, naming
    gloo, forward and backward; outside one it runs; a group of None (a
    one-rank mesh with no process group) stays the identity."""
    group = gloo.group
    x = torch.arange(4.0, requires_grad=True)
    y = _collectives.psum(x, group)
    assert torch.equal(y, x.detach())
    monkeypatch.setattr(_collectives, "capturing", lambda: True)
    for fn in (_collectives.psum, _collectives.pmax,
               _collectives.all_gather):
        with pytest.raises(RuntimeError, match="gloo"):
            fn(x, group)
    with pytest.raises(RuntimeError, match="gloo"):
        y.sum().backward()
    assert _collectives.psum(x, None) is x


def _jax_mesh_rule(n_dev: int, num_tiles: int) -> list:
    """scripts/bench_scaling.py's mesh loop, run from its source."""
    src = (ROOT / "scripts" / "bench_scaling.py").read_text()
    block = re.search(r"\n( *shapes = \[\(1, 1\)\]\n.*?n \*= 2\n)", src,
                      re.S).group(1)
    scope = {"n_dev": n_dev,
             "raster_cfg": SimpleNamespace(num_tiles=num_tiles)}
    exec(textwrap.dedent(block), scope)
    return scope["shapes"]


@pytest.mark.parametrize("cards", [1, 2, 4, 8])
def test_bench_scaling_meshes_follow_jax(cards):
    for tiles in (2500, 16, 12):     # 800x800 at tile 16; 64x64; odd
        assert bench_scaling.mesh_shapes(cards, tiles) == \
            _jax_mesh_rule(cards, tiles), (cards, tiles)
    assert (bench_scaling._num_tiles(800) == 2500
            and bench_scaling.bench_config(100_000).raster.capacity
            == 131_072)


def test_bench_scaling_point_matches_jax_scene():
    from __graft_entry__ import _synthetic_scene
    pts, cols = bench_scaling.operating_point(4096)
    want_pts, want_cols = _synthetic_scene(4096)
    np.testing.assert_array_equal(pts, want_pts)
    np.testing.assert_array_equal(cols, want_cols)


def test_bench_scaling_cpu_run_prints_a_line_per_mesh(capsys):
    """`--device cpu` over two gloo ranks: one JSON line a mesh, (1, 1),
    (2, 1), (1, 2), with the JAX script's keys, eager, marked as no device
    figure."""
    lines = bench_scaling.main(["--device", "cpu", "--points", "1024",
                                "--size", str(SIZE), "--steps", "2"])
    printed = [json.loads(x) for x in capsys.readouterr().out.splitlines()
               if x.startswith("{")]
    assert printed == lines
    assert [x["mesh"] for x in lines] == ["1x1", "2x1", "1x2"]
    for x in lines:
        assert list(x)[:4] == ["mesh", "rays_per_s", "steps_per_s",
                               "scaling_efficiency"]
        assert x["rays_per_s"] > 0 and x["steps_per_s"] > 0
        assert np.isfinite(x["loss"]) and x["captured"] is False
        assert x["backend"] == "gloo" and x["card"] is None
        assert "no device figure" in x["note"]
        assert x["batch"] == int(x["mesh"][0])
    assert lines[0]["scaling_efficiency"] == 1.0
