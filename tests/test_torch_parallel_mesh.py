"""Port parity for the tile-sharded train step and eval render
(fourdgs_tpu_torch/parallel/sharded.py) against the JAX package's, at a
(2, 2) mesh of four gloo ranks on the CPU, and on a grid whose tile rows
n_tile does not divide (64x48 at tile 16: 4 x 3 tiles, 2 tile ranks), where
every rank bins the whole grid and blends its slice of the tiles (the
fallback route). The cases, state and tolerances are those of
tests/test_torch_parallel_step.py; `sharded_eval_render` is held to
JAX's at (2, 2), color 1e-5, depth 1e-4 (tests/test_pallas_blend.py's),
alpha 1e-5.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fourdgs_tpu.parallel.mesh import make_mesh as jmake_mesh
from fourdgs_tpu.parallel.sharded import sharded_eval_render as jeval
from fourdgs_tpu.train import checkpoint as jckpt
from fourdgs_tpu.train import state as jstate
from fourdgs_tpu_torch.parallel.mesh import Mesh
from fourdgs_tpu_torch.parallel.sharded import band_route
from tests.test_torch_parallel_step import (STEPS, assert_matches_single_card,
                                            assert_ranks_equal,
                                            assert_step_matches, jax_steps,
                                            scene, single_card_fine_step,
                                            step_job)
# tests/ is on sys.path under pytest (no __init__.py: "prepend" import)
import _torch_parallel_worker as worker  # noqa: E402

torch.set_num_threads(1)

EVAL_VIEWS = (1, 6)
EVAL_SH = 1


def jax_eval(sc: dict, mesh: tuple) -> list:
    out = []
    for v in EVAL_VIEWS:
        color, depth, alpha = jeval(
            sc["st"], sc["jcams"][v], jnp.zeros(3), mesh=jmake_mesh(*mesh),
            raster_cfg=sc["jraster"],
            deform_cfg=jstate.deform_config_from(sc["cfg"]), stage="fine",
            active_sh=EVAL_SH)
        out.append(tuple(np.asarray(x) for x in (color, depth, alpha)))
    return out


@pytest.mark.parametrize("mesh,size", [((2, 2), (64, 64)),
                                       ((1, 2), (64, 48))],
                         ids=["2x2", "1x2-fallback"])
def test_sharded_step_matches_jax(mesh, size, tmp_path):
    sc = scene(*size)
    n_tile = mesh[1]
    fallback = size[1] == 48
    assert band_route(Mesh(*mesh), sc["traster"]) != fallback
    assert sc["traster"].num_tiles % n_tile == 0
    job = step_job(sc, mesh)
    if not fallback:
        job.update(runs=["steps", "eval"], stage="fine", active_sh=EVAL_SH,
                   eval_cams=[sc["tcams"][v] for v in EVAL_VIEWS])
    n = mesh[0] * mesh[1]
    ctx = worker.spawn(job, n, tmp_path)
    ref = jax_steps(sc, mesh)
    ref_frames = None if fallback else jax_eval(sc, mesh)
    results = worker.collect(ctx, tmp_path, n)
    ranks = [r["steps"] for r in results]
    assert_ranks_equal(ranks)
    init = jckpt._flatten(sc["st"]._asdict())
    for step, (port, jax_ref) in enumerate(zip(ranks[0], ref)):
        assert_step_matches(port, jax_ref, init,
                            f"{mesh} {STEPS[step]['stage']}")
    assert_matches_single_card(ranks[0][1], single_card_fine_step(sc),
                               f"{mesh} against train_step")
    if fallback:
        return
    for r, res in enumerate(results):
        for v, (port, jref) in enumerate(zip(res["eval"]["frames"],
                                             ref_frames)):
            for name, a, b, tol in zip(("color", "depth", "alpha"), port,
                                       jref, (1e-5, 1e-4, 1e-5)):
                assert a.shape == b.shape, name
                np.testing.assert_allclose(a, b, atol=tol,
                                           err_msg=f"rank {r} view {v} "
                                           f"{name}")
        assert float(res["eval"]["frames"][0][2].max()) > 0.5
