"""The port's trajectory gate: tests/test_golden.py's 400-iteration run
(240 coarse and 160 fine iterations at 64x64, batch 2, a densify every 60
iterations) through the port's `run_stage`, held to the JAX package's
recorded PSNR trajectory (tests/golden/psnr_trajectory.json) within that
test's 0.35 dB at every checkpoint.

Both packages start from one state: the JAX package builds it
(`create_state`, `compact_and_resize` to 1024) and `convert` carries it
over. Their random draws differ, so the split noise of every densify is
the JAX package's, injected into the port: the stage's key chain starts
at `jax.random.key(2)` and splits once per densify, as JAX's loop does
(`fourdgs_tpu/train/loop.py`), and each subkey gives the two normals of
`fourdgs_tpu/train/densify.py`. Batches are drawn from the same numpy
generator in both packages. The config sets no point growth, so no other
draw enters.
"""
import json
import os

import jax
import numpy as np
import torch

from fourdgs_tpu.train import loop as jloop
from fourdgs_tpu.train import state as jstate
from fourdgs_tpu_torch.data.camera import Camera
from fourdgs_tpu_torch.train import config as tconfig
from fourdgs_tpu_torch.train import densify as tdensify
from fourdgs_tpu_torch.train import loop as tloop
from fourdgs_tpu_torch.train import optim as toptim
from tests.test_e2e_train import H, W, gt_data, smoke_config  # noqa: F401
from tests.test_torch_train import _port_cfg, _port_state

torch.set_num_threads(1)

GOLDEN_PATH = os.path.join(os.path.dirname(__file__), "golden",
                           "psnr_trajectory.json")
ATOL_DB = 0.35      # tests/test_golden.py's tolerance


def port_cameras(stacked):
    """A stacked JAX Camera -> one port Camera per view, on the CPU."""
    n = np.asarray(stacked.time).shape[0]
    return [Camera(**{f: torch.from_numpy(np.array(getattr(stacked, f)[i]))
                      for f in stacked._fields}) for i in range(n)]


class JaxSplitDraws:
    """Stands in for the port's `densify` inside `run_stage`: draws the
    split noise from the JAX package's key chain and passes it on."""

    def __init__(self, densify):
        self.densify = densify
        self.key = None
        self.calls = 0

    def start_stage(self, seed):
        self.key = jax.random.key(seed)

    def __call__(self, state, *args, generator=None, noise=None):
        self.key, sub = jax.random.split(self.key)
        cap = state.capacity
        noise = tuple(
            torch.from_numpy(np.array(jax.random.normal(k, (cap, 3))))
            for k in (sub, jax.random.fold_in(sub, 1)))
        self.calls += 1
        return self.densify(state, *args, noise=noise)


def run_port_trajectory(gt_data, monkeypatch):
    """test_golden.py's run_trajectory through the port: the PSNR every
    40 iterations of each stage, and the densify calls made."""
    cams, images, true_means, true_colors = gt_data
    cfg = smoke_config()
    assert not cfg.opt.add_point
    pcfg = _port_cfg(cfg)
    rng = np.random.default_rng(0)
    pts = (true_means
           + rng.normal(0, 0.05, true_means.shape).astype(np.float32))
    cols = np.full_like(true_colors, 0.5)
    st = jstate.create_state(jax.random.key(0), cfg, pts, cols,
                             spatial_lr_scale=1.0)
    st = jloop.compact_and_resize(st, 1024)
    state = _port_state(st, cfg)
    draws = JaxSplitDraws(tdensify.densify)
    monkeypatch.setattr(tdensify, "densify", draws)
    tcams = port_cameras(cams)
    timgs = torch.from_numpy(np.array(images))
    rcfg = tconfig.raster_config_from(pcfg, W, H)
    out = {}
    for stage, iters in (("coarse", 240), ("fine", 160)):
        tx = toptim.build_optimizer(pcfg.opt, 1.0)
        state.opt_state = tx.init(state.params)
        draws.start_stage(2)
        res = tloop.run_stage(pcfg, state, stage, iters, tcams, timgs, tx,
                              rcfg, rng=np.random.default_rng(1),
                              log_every=40)
        state, rcfg = res.state, res.raster_cfg
        out[stage] = {str(h["iter"]): round(float(h["psnr"]), 4)
                      for h in res.history}
    return out, draws.calls


def test_psnr_trajectory_matches_golden(gt_data, monkeypatch):
    """Every checkpoint within 0.35 dB of the JAX package's golden; the
    largest deviation is printed."""
    with open(GOLDEN_PATH) as f:
        golden = json.load(f)
    got, calls = run_port_trajectory(gt_data, monkeypatch)
    # densify at 60, 120, 180 coarse and 60, 120 fine
    assert calls == 5, calls
    devs = {f"{stage} {it}": got[stage][it] - want
            for stage, points in golden.items()
            for it, want in points.items()}
    worst = max(devs, key=lambda k: abs(devs[k]))
    print(f"largest deviation from the golden: {devs[worst]:+.4f} dB at "
          f"{worst}; all: {devs}")
    for name, d in devs.items():
        assert abs(d) <= ATOL_DB, (
            f"{name}: {d:+.3f} dB from the golden (tol {ATOL_DB})\n"
            f"full: {got}")
