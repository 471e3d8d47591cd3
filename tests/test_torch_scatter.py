"""Port parity for the scatter kernels' plain versions (ops/scatter.py) and
the per-slot blend backward's (ops/blend.py), and the four switches that
select the per-slot path.

  * `scatter_add_rows_plain` (K4) and `scatter_set_scalars_plain` (K5)
    against the JAX package's Pallas kernels in interpret mode, called as
    tests/test_pallas_scatter.py calls them: the clamp of out-of-range
    indices to the sacrificial last row, the -1 fill. K4 at rtol 1e-6
    (the JAX test's), K5 exactly.
  * `blend_backward_slots_plain` (K3), reduced per gaussian, through the
    whole rasterizer under FOURDGS_PALLAS_NO_FUSED_BWD, against the JAX
    package's Pallas blend on the CPU (`RasterConfig(backend="pallas")`,
    as tests/test_pallas_blend.py:80 reaches it), whose backward runs K3
    in interpret mode: each leaf normalised by its largest magnitude, atol
    1e-4 (the tolerance of tests/test_pallas_blend.py).
  * FOURDGS_HEX_BWD=pallas and FOURDGS_BIN_SCATTER=pallas leave the port's
    CPU results equal to the defaults.

tests/test_torch_kernels_gpu.py holds the CUDA kernels against these plain
versions on the card.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fourdgs_tpu.ops import rasterize_tiled as jrt
from fourdgs_tpu.ops.pallas import scatter as jscatter
from fourdgs_tpu_torch.data import camera as tcam
from fourdgs_tpu_torch.models.deformation import Deformation
from fourdgs_tpu_torch.ops import blend as tblend
from fourdgs_tpu_torch.ops import rasterize_tiled as trt
from fourdgs_tpu_torch.ops import scatter as tscatter
from fourdgs_tpu_torch.train import config as tconfig
from tests.test_rasterize import FOV, H, W, simple_camera
from tests.test_torch_blend import _binned_inputs, _cfgs, _scene
from tests.test_torch_train import _port_cfg
from tests.test_train import tiny_config

torch.set_num_threads(1)

GRAD_TOL = 1e-4
BG = np.array([0.3, 0.1, 0.7], np.float32)


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.mark.parametrize("m,w,n_out,lo,hi", [
    (200, 16, 37, 0, 37),        # in range, duplicates
    (64, 16, 16, -5, 26),        # below 0 and past n_out: clamped
    (96, 32, 5, 0, 5),           # a HexPlane row width
])
def test_scatter_add_rows_plain_matches_pallas(m, w, n_out, lo, hi):
    rng = np.random.default_rng(m + w)
    rows = rng.standard_normal((m, w)).astype(np.float32)
    idx = rng.integers(lo, hi, m).astype(np.int32)
    want = jscatter.scatter_add_rows(jnp.asarray(idx), jnp.asarray(rows),
                                     n_out=n_out, blk=8, unroll=4)
    before = tscatter.scatter_add_rows.launches
    got = tscatter.scatter_add_rows(_t(idx), _t(rows), n_out=n_out)
    assert tscatter.scatter_add_rows.launches == before   # no kernel here
    assert got.shape == (n_out, w)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_array_equal(
        got.numpy(), tscatter.scatter_add_rows_plain(_t(idx), _t(rows),
                                                     n_out=n_out).numpy())


def _run_heavy_idx(pattern, m, n_out, rng):
    """Index patterns with long runs of one destination, as K4's callers
    send them: sorted runs of random length; per-slot tiles whose empty
    tail goes to the sacrificial row n_out - 1 (the blend reduction); a
    random head and a constant tail (the gaussian buffer's dead slots, all
    in one HexPlane cell); runs past the range, clamped to the last row."""
    if pattern == "sorted runs":
        return np.sort(rng.integers(0, n_out, m))
    if pattern == "sacrificial tail":
        tile = 96
        idx = np.full(m, n_out - 1)
        for start in range(0, m, tile):
            used = min(int(rng.integers(0, tile // 2)), m - start)
            idx[start:start + used] = rng.integers(0, n_out - 1, used)
        return idx
    if pattern == "constant tail":
        idx = rng.integers(0, n_out, m)
        idx[m // 3:] = int(rng.integers(0, n_out))
        return idx
    assert pattern == "clamped runs"
    return np.repeat(rng.integers(-4, n_out + 4, m // 16 + 1), 16)[:m]


@pytest.mark.parametrize("pattern", ["sorted runs", "sacrificial tail",
                                     "constant tail", "clamped runs"])
@pytest.mark.parametrize("w", [10, 32])
def test_scatter_add_rows_plain_matches_pallas_on_runs(pattern, w):
    """Run-heavy indices (the hot rows the CUDA kernel sums per run before
    its atomics): the plain version keeps the JAX kernel's sums, the
    sacrificial row's included, at the JAX test's rtol 1e-6."""
    rng = np.random.default_rng(len(pattern) + w)
    m, n_out = 384, 29
    idx = _run_heavy_idx(pattern, m, n_out, rng).astype(np.int32)
    rows = rng.standard_normal((m, w)).astype(np.float32)
    want = np.asarray(jscatter.scatter_add_rows(
        jnp.asarray(idx), jnp.asarray(rows), n_out=n_out, blk=32, unroll=4))
    got = tscatter.scatter_add_rows(_t(idx), _t(rows), n_out=n_out).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-5)
    clamped = np.clip(idx, 0, n_out - 1)
    np.testing.assert_allclose(got[-1], rows[clamped == n_out - 1].sum(0,
                               dtype=np.float64), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("pattern", ["binner tiles", "all dropped", "odd m"])
def test_scatter_set_scalars_plain_matches_pallas_on_patterns(pattern):
    """The binner's layout (destinations rising within each tile, the pairs
    past tile_cap sent to n_out), every index dropped, and a length no
    multiple of four: equal to the JAX kernel, -1 where nothing was
    written."""
    rng = np.random.default_rng(len(pattern))
    n_tiles, cap = 12, 16
    n_out = n_tiles * cap
    if pattern == "binner tiles":
        counts = rng.integers(0, 2 * cap, n_tiles)
        idx = np.concatenate([np.where(np.arange(c) < cap,
                                       t * cap + np.arange(c), n_out)
                              for t, c in enumerate(counts)])
    elif pattern == "all dropped":
        idx = rng.integers(n_out, 2 * n_out, 101)
    else:
        idx = rng.permutation(n_out + 40)[:n_out - 5]
    idx = idx.astype(np.int32)
    val = rng.integers(0, 10 ** 6, len(idx)).astype(np.int32)
    want = np.asarray(jscatter.scatter_set_scalars(
        jnp.minimum(jnp.asarray(idx), n_out), jnp.asarray(val), n_out=n_out,
        blk=64, unroll=4))
    got = tscatter.scatter_set_scalars(_t(idx), _t(val), n_out=n_out)
    np.testing.assert_array_equal(got.numpy(), want)
    written = idx[idx < n_out]
    assert (got.numpy() == -1).sum() == n_out - len(written)


@pytest.mark.parametrize("n_out,m", [(1000, 600), (300, 300)])
def test_scatter_set_scalars_plain_matches_pallas(n_out, m):
    """Unique indices, some at or past n_out (the JAX caller clamps those
    to n_out, its sacrificial slot; the port takes them as they are):
    equal, -1 where nothing was written."""
    rng = np.random.default_rng(n_out)
    idx = rng.permutation(n_out + 200)[:m].astype(np.int32)
    val = rng.integers(0, 10 ** 6, m).astype(np.int32)
    want = np.asarray(jscatter.scatter_set_scalars(
        jnp.minimum(jnp.asarray(idx), n_out), jnp.asarray(val), n_out=n_out,
        blk=64, unroll=4))
    before = tscatter.scatter_set_scalars.launches
    got = tscatter.scatter_set_scalars(_t(idx), _t(val), n_out=n_out)
    assert tscatter.scatter_set_scalars.launches == before
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want == -1).any() and (idx >= n_out).any()


def test_scatter_wrappers_reject_bad_inputs():
    idx = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(TypeError, match="int32"):
        tscatter.scatter_add_rows(idx.long(), torch.zeros(4, 3), n_out=2)
    with pytest.raises(ValueError, match="idx"):
        tscatter.scatter_add_rows(idx, torch.zeros(5, 3), n_out=2)
    with pytest.raises(ValueError, match="n_out"):
        tscatter.scatter_add_rows(idx, torch.zeros(4, 3), n_out=0)
    with pytest.raises(TypeError, match="int32"):
        tscatter.scatter_set_scalars(idx, torch.zeros(4), n_out=2)


def test_slots_plain_reduces_to_the_fused_plain():
    """The per-slot table summed per gaussian is the plain fused backward,
    and rows past each tile's occupancy are zero."""
    jcfg, tcfg = _cfgs(16)
    proj, binned, opac, colors = _binned_inputs("random", jcfg)
    rng = np.random.default_rng(5)
    nt, p = tcfg.num_tiles, tcfg.pixels_per_tile
    cot = (_t(rng.normal(size=(nt, p, 3)).astype(np.float32)),
           _t(rng.normal(size=(nt, p)).astype(np.float32)),
           _t(rng.normal(size=(nt, p)).astype(np.float32)))
    table = tblend.pack_attr_table(_t(proj.pix), _t(proj.conic), _t(colors),
                                   _t(opac), _t(proj.depth))
    gidx, counts = _t(binned.gidx), _t(binned.counts)
    out = tblend.blend_forward(gidx, counts, table, tcfg)
    args = (gidx, counts, table, *out, *cot, tcfg)
    before = tblend.blend_backward_slots.launches
    slots = tblend.blend_backward_slots(*args)
    assert tblend.blend_backward_slots.launches == before
    assert slots.shape == (nt, tcfg.tile_cap, tblend.GRAD_W)
    assert float(slots[gidx < 0].abs().max()) == 0.0
    reduced = tblend.reduce_slots(gidx, slots, len(opac))
    fused = tblend.blend_backward_plain(*args)
    np.testing.assert_allclose(reduced.numpy(), fused.numpy(), rtol=1e-5,
                               atol=1e-6)


def _raster_loss(out):
    return ((out.color ** 2).mean() + 0.1 * out.depth.mean()
            + 0.05 * (out.alpha ** 2).mean())


@pytest.mark.parametrize("kind", ["random", "saturating"])
def test_slots_backward_matches_pallas_k3(kind, monkeypatch):
    """The rasterizer's gradients with the per-slot backward (the plain K3
    table reduced by the plain K4) against the JAX package's Pallas blend,
    whose backward takes K3 in interpret mode on the CPU. Tile size 32
    keeps the interpret-mode backward to a few seconds."""
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
    monkeypatch.setenv("FOURDGS_PALLAS_GRAD_SCATTER", "1")
    leaves = [_t(x).requires_grad_(True) for x in args]
    loss = _raster_loss(trt.rasterize(*leaves, cam, _t(BG), tcfg))
    port = torch.autograd.grad(loss, leaves)
    for name, a, b in zip("msqoc", port, ref):
        a, b = a.numpy(), np.asarray(b)
        scale = np.abs(b).max() + 1e-8
        np.testing.assert_allclose(a / scale, b / scale, atol=GRAD_TOL,
                                   err_msg=name)


def test_hex_bwd_switch_leaves_gradients_equal(monkeypatch):
    """FOURDGS_HEX_BWD=pallas routes the HexPlane gather's backward through
    scatter_add_rows (K4, its plain version here): the same gradients."""
    cfg = tconfig.deform_config_from(_port_cfg(tiny_config()))
    rng = np.random.default_rng(3)
    n = 64
    xyz = _t(rng.uniform(-1, 1, (n, 3)).astype(np.float32))
    scales = _t(rng.normal(-3, 0.3, (n, 3)).astype(np.float32))
    rots = _t(rng.normal(size=(n, 4)).astype(np.float32))
    ops = _t(rng.normal(size=(n, 1)).astype(np.float32))
    shs = _t(rng.normal(size=(n, 16, 3)).astype(np.float32))
    aabb = _t(np.array([[1.6] * 3, [-1.6] * 3], np.float32))
    t = torch.tensor(0.4)

    def grads():
        deform = Deformation(cfg, generator=torch.Generator().manual_seed(0))
        leaf = xyz.clone().requires_grad_(True)
        out = deform(aabb, leaf, scales, rots, ops, shs, t)
        loss = sum((o ** 2).sum() for o in out)
        params = [leaf] + list(deform.grid.planes.values())
        return torch.autograd.grad(loss, params)

    ref = grads()
    monkeypatch.setenv("FOURDGS_HEX_BWD", "pallas")
    before = tscatter.scatter_add_rows.launches
    got = grads()
    assert tscatter.scatter_add_rows.launches == before
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6,
                                   atol=1e-7)
    assert sum(float(g.abs().max()) > 0 for g in ref[1:]) >= 3


def test_bin_scatter_switch_leaves_gidx_equal(monkeypatch):
    """FOURDGS_BIN_SCATTER=pallas builds the binner's gidx with
    scatter_set_scalars (K5, its plain version here), the pairs past
    tile_cap sent to the sacrificial slot: equal, overflow included."""
    _, tcfg = _cfgs(16, cap=8)
    means, scales, quats, opac, _ = _scene("random")
    cam = tcam.make_camera(np.eye(3), np.zeros(3), FOV, FOV, device="cpu")

    def binned():
        _, b = trt.project_and_bin(_t(means), _t(scales), _t(quats),
                                   _t(opac), cam, tcfg)
        return b

    ref = binned()
    assert int(ref.overflow.sum()) > 0
    monkeypatch.setenv("FOURDGS_BIN_SCATTER", "pallas")
    got = binned()
    for a, b in zip(got, ref):
        if a is None:       # slots, which neither binning was asked for
            assert b is None
            continue
        assert torch.equal(a, b)
