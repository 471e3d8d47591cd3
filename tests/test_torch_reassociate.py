"""Port parity for the reassociated per-slot reduction: the binner's
BlendSlots (ops/rasterize_tiled.py) and `reassociate_pair_grads` against
the JAX package's, and the per-slot backward under
FOURDGS_PALLAS_NO_FUSED_BWD alone (K3's table reduced by reassociation,
the JAX package's default) against the JAX package's per-slot path.

  * BlendSlots from the plain binner equal JAX's `bin_gaussians_count`
    slots int for int on one projection, at a drop-free budget, a budget
    that drops pairs (a straddled run) and a tile cap that drops them,
    culled slots included.
  * `reassociate_pair_grads` on one random per-slot table within 1e-5 of
    the largest magnitude of JAX's; rows that no slot names (K3 leaves
    the rows past a tile's occupied chunks unwritten) may hold NaN.
  * The rasterizer's gradients through the per-slot backward with
    reassociation against the JAX package's Pallas blend on the CPU,
    whose backward runs K3 in interpret mode and reassociates, each leaf
    normalised by its largest magnitude, atol 1e-4 (the tolerance of
    tests/test_pallas_blend.py); K4 does not run.

tests/test_torch_kernels_gpu.py holds the reduction on K3's table on the
card.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fourdgs_tpu.ops import rasterize_tiled as jrt
from fourdgs_tpu.ops.projection import project_gaussians
from fourdgs_tpu_torch.data import camera as tcam
from fourdgs_tpu_torch.ops import blend as tblend
from fourdgs_tpu_torch.ops import rasterize_tiled as trt
from fourdgs_tpu_torch.ops import scatter as tscatter
from tests.test_rasterize import FOV, H, W, random_scene, simple_camera
from tests.test_torch_binner import CASES, _to_torch
from tests.test_torch_scatter import BG, GRAD_TOL, _raster_loss
from tests.test_torch_blend import _cfgs, _scene

torch.set_num_threads(1)

N = 160


@pytest.fixture(scope="module")
def proj():
    """A projection with gaussians off screen (no tile touched, so their
    depth keys tie at infinity) and distinct depths among the others."""
    rng = np.random.default_rng(5)
    means, scales, quats, opac, _ = random_scene(rng, n=N)
    means = np.array(means)
    means[:12, 2] = -3.0                     # behind the camera
    p = project_gaussians(jnp.asarray(means), scales * 2.5, quats,
                          simple_camera(), W, H, 16, opacities=opac)
    touched = np.asarray(p.tiles_touched)
    assert (touched == 0).sum() >= 12
    d = np.asarray(p.depth)[touched > 0]
    assert len(np.unique(d)) == len(d), "depth ties"
    return p


def _configs(case):
    cap, chunk, bchunk, bpc = CASES[case]
    kw = dict(img_width=W, img_height=H, tile_size=16, tile_cap=cap,
              chunk=chunk, bin_chunk=bchunk, bin_pairs_per_chunk=bpc)
    return jrt.RasterConfig(**kw), trt.RasterConfig(**kw)


@pytest.mark.parametrize("case", list(CASES))
def test_blend_slots_match_jax(proj, case):
    jcfg, tcfg = _configs(case)
    want = jrt.bin_gaussians_count(proj, jcfg).slots
    binned = trt.bin_gaussians_count(_to_torch(proj), tcfg, slots=True)
    got = binned.slots
    # the gaussians that touch no tile tie at an infinite depth key, whose
    # order JAX's unstable sort leaves open (and the port's stable sort
    # keeps): their gids are compared as a set, every other field and
    # every other gid int for int
    n_vis = int((np.asarray(proj.tiles_touched) > 0).sum())
    for f in trt.BlendSlots._fields:
        g, w = getattr(got, f).numpy(), np.asarray(getattr(want, f))
        assert g.dtype == np.int32, f
        if f == "gid":
            np.testing.assert_array_equal(np.sort(g[n_vis:N]),
                                          np.sort(w[n_vis:N]))
            g, w = np.delete(g, np.s_[n_vis:N]), np.delete(w, np.s_[n_vis:N])
        np.testing.assert_array_equal(g, w, err_msg=f)
    assert not got.alloc.numpy()[n_vis:].any()
    n_out = tcfg.num_tiles * tcfg.tile_cap
    dest = got.dest.numpy().reshape(-1)
    kept = dest < n_out
    # each kept slot names its list entry: the gaussian of its run
    owner = np.repeat(got.gid.numpy(), got.alloc.numpy())
    starts = np.repeat(got.slot0.numpy(), got.alloc.numpy())
    slot_of = starts + (np.arange(len(owner))
                        - np.repeat(np.cumsum(got.alloc.numpy())
                                    - got.alloc.numpy(), got.alloc.numpy()))
    gidx = binned.gidx.numpy().reshape(-1)
    on_run = np.zeros(len(dest), bool)
    on_run[slot_of] = True
    assert not kept[~on_run].any()
    sel = kept[slot_of]
    np.testing.assert_array_equal(gidx[dest[slot_of[sel]]], owner[sel])
    # and the lists hold nothing else
    assert kept.sum() == (gidx >= 0).sum()
    if case == "tile_overflow":       # on-run slots past tile_cap
        assert (~kept[on_run]).any()
    if case == "budget_drops":        # runs cut at the budget
        assert got.alloc.numpy().sum() < int(np.asarray(
            proj.tiles_touched).sum())
    # the lists are the default binning's
    plain = trt.bin_gaussians_count(_to_torch(proj), tcfg)
    assert plain.slots is None
    assert torch.equal(plain.gidx, binned.gidx)


@pytest.mark.parametrize("case", list(CASES))
def test_reassociate_matches_jax(proj, case):
    jcfg, tcfg = _configs(case)
    jslots = jrt.bin_gaussians_count(proj, jcfg).slots
    tslots = trt.bin_gaussians_count(_to_torch(proj), tcfg, slots=True).slots
    rows = tcfg.num_tiles * tcfg.tile_cap
    packed = np.random.default_rng(9).normal(
        size=(rows, tblend.GRAD_W)).astype(np.float32)
    want = np.asarray(jrt.reassociate_pair_grads(jnp.asarray(packed), jslots,
                                                 N))
    got = trt.reassociate_pair_grads(torch.from_numpy(packed), tslots, N)
    assert got.shape == (N, tblend.GRAD_W)
    scale = np.abs(want).max()
    np.testing.assert_allclose(got.numpy() / scale, want / scale, atol=1e-5)
    # rows that no slot names may hold anything
    named = np.zeros(rows, bool)
    dest = tslots.dest.numpy().reshape(-1)
    named[dest[dest < rows]] = True
    poisoned = packed.copy()
    poisoned[~named] = np.nan
    again = trt.reassociate_pair_grads(torch.from_numpy(poisoned), tslots, N)
    assert torch.isfinite(again).all()
    assert torch.equal(again, got)


def test_reassociate_equals_index_add(proj):
    """The reduction's sums against one `index_add_` of the same table by
    the lists (the fallback of reduce_slots without slots)."""
    _, tcfg = _configs("tile_overflow")
    binned = trt.bin_gaussians_count(_to_torch(proj), tcfg, slots=True)
    rows = tcfg.num_tiles * tcfg.tile_cap
    table = torch.from_numpy(np.random.default_rng(4).normal(
        size=(tcfg.num_tiles, tcfg.tile_cap, tblend.GRAD_W)).astype(
            np.float32))
    table[binned.gidx < 0] = 0.0
    a = tblend.reduce_slots(binned.gidx, table, N, binned.slots)
    b = tblend.reduce_slots(binned.gidx, table, N)
    assert rows == table.shape[0] * table.shape[1]
    torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("kind", ["random", "saturating"])
def test_reassociated_backward_matches_jax(kind, monkeypatch):
    """FOURDGS_PALLAS_NO_FUSED_BWD alone: the port's per-slot backward
    (the plain K3 table, reduced by reassociation over the binner's
    slots) against the JAX package's Pallas blend, whose per-slot
    backward runs K3 in interpret mode on the CPU and reassociates. Tile
    size 32, as test_torch_scatter.py's K3 + K4 case."""
    jcfg, tcfg = _cfgs(32)
    jcfg = jrt.RasterConfig(**{**jcfg.__dict__, "backend": "pallas"})
    args = _scene(kind)
    cam = tcam.make_camera(np.eye(3), np.zeros(3), FOV, FOV, device="cpu")

    def jloss(m, s, q, o, c):
        return _raster_loss(jrt.rasterize(m, s, q, o, c, simple_camera(),
                                          jnp.asarray(BG), jcfg))

    ref = jax.grad(jloss, argnums=tuple(range(5)))(
        *(jnp.asarray(x) for x in args))
    monkeypatch.setenv("FOURDGS_PALLAS_NO_FUSED_BWD", "1")
    monkeypatch.delenv("FOURDGS_PALLAS_GRAD_SCATTER", raising=False)
    seen = []
    real = trt.reassociate_pair_grads

    def counted(*a):
        seen.append(a[1])
        return real(*a)

    def refuse(*a, **k):
        raise AssertionError("K4 ran under the reassociated route")

    monkeypatch.setattr(trt, "reassociate_pair_grads", counted)
    monkeypatch.setattr(tblend, "scatter_add_rows", refuse)
    monkeypatch.setattr(tscatter, "scatter_add_rows", refuse)
    leaves = [torch.from_numpy(np.array(x)).requires_grad_(True)
              for x in args]
    loss = _raster_loss(trt.rasterize(*leaves, cam, torch.from_numpy(BG),
                                      tcfg))
    port = torch.autograd.grad(loss, leaves)
    assert len(seen) == 1
    for name, a, b in zip("msqoc", port, ref):
        a, b = a.numpy(), np.asarray(b)
        scale = np.abs(b).max() + 1e-8
        np.testing.assert_allclose(a / scale, b / scale, atol=GRAD_TOL,
                                   err_msg=name)
