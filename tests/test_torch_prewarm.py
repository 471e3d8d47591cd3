"""The prewarmer (train/loop.py:BucketPrewarmer, train/graphs.py:
StepPrograms.prewarm) against JAX's `BucketPrewarmer`, and on the CPU with
real threads.

  * The keys: JAX's run_stage with its `BucketPrewarmer` replaced by a
    recorder and the port's run_stage with a recording `start`, from one
    state and one batch order, queue the same (stage, bucket,
    track_stats, tile_cap, bin_pairs_per_chunk) keys in the same order,
    over a stage that crosses a bucket, stops the densify statistics and
    grows tile_cap (clone-only densify, so no random draw enters).
  * The threads: with tests/test_torch_graphs.py's `ReplayEagerly` in
    place of `graphs.Program` (a replay runs the program's function again
    on its static buffers) the prewarms run on daemon threads as on the
    card. A prewarmed program is used at its switch, a stale one is
    dropped and its key queued again at the new caps, a prewarm that
    raises is printed and counted and its switch captures, no thread
    outlives run_stage, and the stage equals the prewarm-off stage bit
    for bit (the CPU's arithmetic is deterministic).
  * The launch counts: `ops/launches.py` under threads racing on one
    wrapper, with a capture recording on its stream.
"""
import sys
import threading

import jax
import numpy as np
import pytest
import torch

from fourdgs_tpu.data import scene as jscene
from fourdgs_tpu.train import loop as jloop
from fourdgs_tpu.train import optim as joptim
from fourdgs_tpu_torch.data import scene as tscene
from fourdgs_tpu_torch.ops import launches
from fourdgs_tpu_torch.parallel.mesh import Mesh
from fourdgs_tpu_torch.tools.make_synthetic_scene import write_split
from fourdgs_tpu_torch.train import config as tconfig
from fourdgs_tpu_torch.train import graphs
from fourdgs_tpu_torch.train import loop as tloop
from fourdgs_tpu_torch.train import optim as toptim
from fourdgs_tpu_torch.utils import tracing
from tests.test_torch_graphs import (ReplayEagerly, _assert_same, _run,
                                     _stage_cfg, _state)
from tests.test_torch_stage import _initial_state
from tests.test_torch_train import _port_cfg, _port_state
from tests.test_train import tiny_config

torch.set_num_threads(1)

ITERS = 30


def _jax_key(key):
    stage, bucket, track, rc = key
    return (stage, bucket, track, rc.tile_cap, rc.bin_pairs_per_chunk)


def _port_key(key):
    rc = key.raster_cfg
    return (key.stage, key.capacity, key.track_stats, rc.tile_cap,
            rc.bin_pairs_per_chunk)


def _keys_cfg():
    """Clone-only densify every 5 iterations from 200 points in the 512
    bucket (past the next bucket's trigger from the first iteration; into
    1,024 at 15 and back at 20's prune), the statistics stopping at 28
    (queued from the first iteration), and a tile_cap of 16 that the
    guards at 25 and 30 grow."""
    cfg = tiny_config(cap=4096)
    cfg.raster.min_bucket = 256
    cfg.raster.tile_cap = 16
    cfg.raster.prewarm = True
    o = cfg.opt
    o.iterations = ITERS
    o.densify_from_iter = 4
    o.densification_interval = 5
    o.densify_until_iter = 28
    o.pruning_from_iter = 4
    o.pruning_interval = 10
    o.prune_min_points = 50
    o.opacity_reset_interval = 15
    o.percent_dense = 100.0
    return cfg


@pytest.fixture(scope="module")
def ball_scene(tmp_path_factory):
    root = tmp_path_factory.mktemp("scene")
    write_split(str(root), "train", 6, 0.0, 32, "cpu")
    write_split(str(root), "test", 2, 0.13, 32, "cpu")
    return root


def test_prewarm_keys_match_jax(ball_scene, monkeypatch):
    cfg = _keys_cfg()
    pcfg = _port_cfg(cfg)
    kw = dict(white_background=True, eval_split=True, resolution=(32, 32))
    js = jscene.Scene.load(str(ball_scene), **kw)
    ts = tscene.Scene.load(str(ball_scene), device="cpu", **kw)
    st = _initial_state(cfg, js)
    port = _port_state(st, cfg)
    extent = js.cameras_extent
    tx_j = joptim.build_optimizer(cfg.opt, extent, st.params)
    st = st._replace(opt_state=tx_j.init(st.params))
    tx_t = toptim.build_optimizer(pcfg.opt, extent)
    port.opt_state = tx_t.init(port.params)

    queued = {"jax": [], "port": []}

    class Recorder(jloop.BucketPrewarmer):
        """JAX's prewarmer with its dedup, starting no compile."""

        def queue(self, key, work):
            with self._lock:
                if key in self._warmed:
                    return
                self._warmed.add(key)
            queued["jax"].append(_jax_key(key))

    monkeypatch.setattr(jloop, "BucketPrewarmer", Recorder)
    common = dict(log_every=5, cameras_extent=extent)
    jres = jloop.run_stage(
        cfg, st, "fine", ITERS, js.train.cameras, js.train.images, tx_j,
        jloop.raster_config_from(cfg, 32, 32), np.random.default_rng(1),
        jax.random.key(2), **common)
    tres = tloop.run_stage(
        pcfg, port, "fine", ITERS, ts.train.cameras, ts.train.images, tx_t,
        tconfig.raster_config_from(pcfg, 32, 32), np.random.default_rng(1),
        prewarmer=tloop.BucketPrewarmer(
            lambda key, *args: queued["port"].append(_port_key(key))),
        **common)

    kinds = [e["kind"] for e in tres.events]
    assert "resize" in kinds and "tile_cap" in kinds, kinds
    assert 1024 in {e["capacity"] for e in tres.events}
    assert tres.state.capacity == jres.state.capacity
    assert tres.raster_cfg.tile_cap == jres.raster_cfg.tile_cap > 16
    assert queued["port"] == queued["jax"]
    q = queued["port"]
    assert len(set(q)) == len(q)
    assert any(k[1] == 1024 and k[2] for k in q)        # the next bucket
    assert any(not k[2] for k in q)                     # the statistics' stop
    assert any(k[3] > 16 for k in q)                    # after the growth


def _prewarm_threads():
    return [t for t in threading.enumerate() if t.name.startswith("prewarm")]


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    root = tmp_path_factory.mktemp("graphs_scene")
    write_split(str(root), "train", 6, 0.0, 32, "cpu")
    write_split(str(root), "test", 2, 0.13, 32, "cpu")
    return tscene.Scene.load(str(root), device="cpu", white_background=True,
                             eval_split=True, resolution=(32, 32))


def _stage(scene, prewarm: bool):
    cfg = _stage_cfg()
    cfg.raster.prewarm = prewarm
    res = _run(cfg, scene, capture=True)
    assert not _prewarm_threads()
    return res


def _same_stage(a, b):
    assert a.events == b.events and a.raster_cfg == b.raster_cfg
    for x, y in zip(a.history, b.history, strict=True):
        np.testing.assert_equal(      # NaN equals NaN here
            {k: v for k, v in x.items() if k != "elapsed"},
            {k: v for k, v in y.items() if k != "elapsed"})
    _assert_same(a.state, b.state)


def test_prewarmed_programs_follow_the_stage(scene, monkeypatch):
    """tests/test_torch_graphs.py's stage (971-1030: two bucket changes,
    tile_cap growth at 975, 1000 and 1030, the statistics' stop at 1020, a
    rollback) with and without the prewarmer."""
    monkeypatch.setattr(graphs, "Program", ReplayEagerly)
    off = _stage(scene, prewarm=False)
    on = _stage(scene, prewarm=True)
    _same_stage(on, off)
    assert not off.graphs["prewarms"]
    rep = on.graphs
    assert rep["prewarms_failed"] == 0 and rep["prewarms_used"] >= 3
    assert rep["prewarmed"] == len(rep["prewarms"])
    assert all(p["used"] != p["dropped"] for p in rep["prewarms"])
    captured = {c["key"]: 970 + c["step"] for c in rep["captures"]}
    off_at = {c["key"]: 970 + c["step"] for c in off.graphs["captures"]}
    used = [p["key"] for p in rep["prewarms"] if p["used"]]
    # each used program came where the prewarm-off stage captured it, and
    # nothing was captured for it there
    for key in used:
        assert key in off_at and key not in captured, key
    assert len(captured) + len(used) == len(off_at)
    # the bucket switches at 981 and 991 and the statistics' stop at 1020
    # took prewarmed programs
    resized = {e["capacity"] for e in on.events if e["kind"] == "resize"}
    for cap in resized:
        assert any(f"capacity {cap} " in k for k in used), (cap, used)
    assert any("stats off" in k for k in used)
    # the next bucket queued at tile_cap 64 went stale when the guard at
    # 975 grew the cap, and was queued again at 128
    stale = [p for p in rep["prewarms"] if p["dropped"]
             and "capacity 1024 tile_cap 64 " in p["key"]]
    assert stale and any("capacity 1024 tile_cap 128 pairs 16384 stats on"
                         in k for k in used)


def test_a_failed_prewarm_is_printed_and_its_switch_captures(
        scene, monkeypatch, capsys):
    """Every prewarm raises on its thread: each is printed as JAX prints
    it and counted, and each switch captures on the training thread, as
    with the prewarmer off."""

    class FailsInTheBackground(ReplayEagerly):
        def __init__(self, *args, **kwargs):
            if graphs._in_background():
                raise RuntimeError("no capture here")
            super().__init__(*args, **kwargs)

    monkeypatch.setattr(graphs, "Program", FailsInTheBackground)
    on = _stage(scene, prewarm=True)
    out = capsys.readouterr().out
    rep = on.graphs
    assert rep["prewarms"] and rep["prewarms_failed"] == len(rep["prewarms"])
    assert rep["prewarmed"] == rep["prewarms_used"] == 0
    for p in rep["prewarms"]:
        assert f"[prewarm] {p['key']} failed: RuntimeError: no capture " \
            f"here" in out
    monkeypatch.setattr(graphs, "Program", ReplayEagerly)
    off = _stage(scene, prewarm=False)
    _same_stage(on, off)
    assert [c["key"] for c in rep["captures"]] == \
        [c["key"] for c in off.graphs["captures"]]


def test_out_of_memory_drops_prewarms_or_builds_again(
        scene, monkeypatch, capsys):
    """Each prewarm's first build runs out of memory: it is printed, built
    once more and used. Then the training thread's first capture while
    prewarms are held runs out of memory: they are dropped, the capture
    runs again, and the stage still equals the prewarm-off one bit for
    bit."""
    programs = []
    real_prewarm = graphs.StepPrograms.prewarm

    def prewarm(self, *args, **kwargs):
        programs.append(self)
        return real_prewarm(self, *args, **kwargs)

    tried, raised = set(), []

    class OutOfMemoryOnce(ReplayEagerly):
        def __init__(self, key, *args, **kwargs):
            if graphs._in_background():
                if key not in tried:
                    tried.add(key)
                    raise torch.cuda.OutOfMemoryError("no room in the pool")
            elif not raised and programs and programs[-1]._pending:
                raised.append(key)
                raise torch.cuda.OutOfMemoryError("no room beside prewarms")
            super().__init__(key, *args, **kwargs)

    monkeypatch.setattr(graphs.StepPrograms, "prewarm", prewarm)
    monkeypatch.setattr(graphs, "Program", OutOfMemoryOnce)
    on = _stage(scene, prewarm=True)
    out = capsys.readouterr().out
    rep = on.graphs
    assert rep["prewarms_failed"] == 0 and raised
    assert rep["prewarms_retried"] == rep["prewarmed"] == len(tried)
    assert rep["prewarms_dropped_for_memory"] >= 1
    for p in rep["prewarms"]:
        assert f"[prewarm] {p['key']} out of memory (no room in the pool)" \
            in out
    assert (f"[prewarm] capturing {raised[0].label()} ran out of memory "
            "(no room beside prewarms)") in out
    monkeypatch.setattr(graphs, "Program", ReplayEagerly)
    off = _stage(scene, prewarm=False)
    _same_stage(on, off)


def test_no_prewarm_over_a_mesh(scene, monkeypatch):
    """A mesh's ranks capture in lockstep: a one-rank mesh builds no
    prewarm by default, and a prewarmer passed with a mesh raises."""
    monkeypatch.setattr(graphs, "Program", ReplayEagerly)
    cfg = _stage_cfg()
    st = _state(cfg)
    tx = toptim.build_optimizer(cfg.opt, scene.cameras_extent)
    st.opt_state = tx.init(st.params)
    kw = dict(cameras_extent=scene.cameras_extent, mesh=Mesh(1, 1),
              capture=True)
    args = (cfg, st, "fine", 6, scene.train.cameras, scene.train.images, tx,
            tconfig.raster_config_from(cfg, 32, 32))
    res = tloop.run_stage(*args, np.random.default_rng(1), **kw)
    assert res.graphs["replays"] == 6 and not res.graphs["prewarms"]
    with pytest.raises(ValueError, match="single card"):
        tloop.run_stage(*args, np.random.default_rng(1),
                        prewarmer=tloop.BucketPrewarmer(print), **kw)


def kernel():
    """A kernel wrapper's counting surface: `__name__`, `.launches`."""


def test_launch_counts_hold_under_threads(monkeypatch):
    """Eight threads count 2,000 launches each of one wrapper with a short
    switch interval, while a capture on another stream records (stood in
    for by the current stream's handle): no launch is lost, and none
    lands in the capture's record."""
    wrapper = kernel
    wrapper.launches = 0
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(torch._C, "_cuda_getCurrentRawStream",
                        lambda device: 7, raising=False)

    class Capture:
        cuda_stream = 8

    saved = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with tracing.capturing(Capture()) as cap:
            record = cap.launches
            threads = [threading.Thread(target=lambda: [
                launches.count(wrapper) for _ in range(2000)])
                for _ in range(8)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
            assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(saved)
    assert wrapper.launches == 16000 and not record
    monkeypatch.setattr(torch._C, "_cuda_getCurrentRawStream",
                        lambda device: 8, raising=False)
    with tracing.capturing(Capture()) as cap:
        launches.count(wrapper)
    assert cap.launches == {"kernel": 1} and wrapper.launches == 16000
    with pytest.raises(RuntimeError, match="two captures"):
        with tracing.capturing(Capture()), tracing.capturing(Capture()):
            pass
