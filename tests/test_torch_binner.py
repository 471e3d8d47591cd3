"""Port parity for the counting binner: ops/rasterize_tiled.py
`bin_gaussians_count` against the JAX package's, given the same projection
(JAX's, converted), on a scene with no depth ties. Every field of the
BinnedTiles contract must be exact: gidx, counts, overflow, num_pairs and
dropped_pairs."""
import numpy as np
import pytest
import torch

from fourdgs_tpu.ops import rasterize_tiled as jrt
from fourdgs_tpu.ops.projection import project_gaussians
from fourdgs_tpu_torch.ops import projection as tproj
from fourdgs_tpu_torch.ops import rasterize_tiled as trt
from tests.test_rasterize import H, W, random_scene, simple_camera

torch.set_num_threads(1)

N = 160
# name -> (tile_cap, chunk, bin_chunk, bin_pairs_per_chunk)
CASES = {
    "drop_free": (256, 8, 4096, 4096),
    "budget_drops": (128, 8, 64, 56),     # 3 x 56 = 168 slots
    "tile_overflow": (16, 8, 4096, 4096),
}


@pytest.fixture(scope="module")
def proj():
    rng = np.random.default_rng(5)
    means, scales, quats, opac, _ = random_scene(rng, n=N)
    scales = scales * 2.5   # larger splats: more pairs per gaussian
    p = project_gaussians(means, scales, quats, simple_camera(), W, H, 16,
                          opacities=opac)
    d = np.asarray(p.depth)[np.asarray(p.tiles_touched) > 0]
    assert len(np.unique(d)) == len(d), "depth ties"
    return p


def _to_torch(p):
    return tproj.Projected(*(torch.from_numpy(np.array(x)) for x in p))


@pytest.mark.parametrize("case", list(CASES))
def test_binner_parity(proj, case):
    cap, chunk, bchunk, bpc = CASES[case]
    jcfg = jrt.RasterConfig(img_width=W, img_height=H, tile_size=16,
                            tile_cap=cap, chunk=chunk, bin_chunk=bchunk,
                            bin_pairs_per_chunk=bpc)
    tcfg = trt.RasterConfig(img_width=W, img_height=H, tile_size=16,
                            tile_cap=cap, chunk=chunk, bin_chunk=bchunk,
                            bin_pairs_per_chunk=bpc)
    a = jrt.bin_gaussians_count(proj, jcfg)
    b = trt.bin_gaussians_count(_to_torch(proj), tcfg)
    for f in ("gidx", "counts", "overflow", "num_pairs", "dropped_pairs",
              "dropped_tile"):
        bv = getattr(b, f).numpy()
        assert bv.dtype == np.int32, f
        np.testing.assert_array_equal(bv, np.asarray(getattr(a, f)),
                                      err_msg=f)

    touched = np.asarray(proj.tiles_touched)
    order = np.argsort(np.where(touched > 0, np.asarray(proj.depth), np.inf))
    start = np.cumsum(touched[order]) - touched[order]
    total_slots = -(-N // bchunk) * bpc
    if case == "budget_drops":
        assert int(b.dropped_pairs) > 0
        # some gaussian's run straddles the end of the budget
        assert ((start < total_slots)
                & (start + touched[order] > total_slots)).any()
    elif case == "tile_overflow":
        assert int(b.overflow.sum()) > 0 and int(b.dropped_pairs) == 0
    else:
        assert int(b.overflow.sum()) == 0 and int(b.dropped_pairs) == 0
        # the corner cull removed pairs
        assert int(b.counts.sum()) < touched.sum()
