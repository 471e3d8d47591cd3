"""Port parity for the multi-GPU pieces (fourdgs_tpu_torch/parallel/ and
the rasterizer's hooks for it) on the CPU: `factor_devices`, `tile_image`
and `clip_proj_to_tile_rows` against the JAX package's; the band binner
(`bin_gaussians_count(..., num_tiles=)`, the corner cull off) equal to
JAX's; the plain blend forward and backward at a band offset (`tile0`)
against JAX's blend on sliced pixel coordinates (color 1e-5, depth 1e-4,
gradients normalised 1e-4, as tests/test_pallas_blend.py); a one-rank
mesh's sharded step against the port's own `train_step`; `run_stage` over
a (2, 2) mesh of gloo ranks through a densify surgery; and the per-rank
batch slices, the mesh's layout and the refusals. The sharded step and
eval render against JAX's: tests/test_torch_parallel_step.py and
tests/test_torch_parallel_mesh.py.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fourdgs_tpu.ops import rasterize_tiled as jrt
from fourdgs_tpu.parallel.mesh import factor_devices as jfactor
from fourdgs_tpu.train import checkpoint as jckpt
from fourdgs_tpu_torch.ops import blend as tblend
from fourdgs_tpu_torch.ops import rasterize_tiled as trt
from fourdgs_tpu_torch.parallel import multihost
from fourdgs_tpu_torch.parallel.mesh import Mesh, factor_devices, make_mesh
from fourdgs_tpu_torch.parallel.sharded import sharded_train_step
from fourdgs_tpu_torch.train import loop as tloop
from fourdgs_tpu_torch.train import optim as toptim
from tests.test_torch_binner import _to_torch
from tests.test_torch_binner import proj as binner_proj  # noqa: F401
from tests.test_torch_blend import _binned_inputs, _cfgs
from tests.test_torch_parallel_step import (REG, batch_ids, scene,
                                            single_card_fine_step)
# tests/ is on sys.path under pytest (no __init__.py: "prepend" import)
import _torch_parallel_worker as worker  # noqa: E402

torch.set_num_threads(1)

GRAD_TOL = 1e-4
TOL = {"color": 1e-5, "depth": 1e-4, "t": 1e-5}


def _t(x):
    return torch.from_numpy(np.array(x))


def test_factor_devices_matches_jax():
    for n in range(1, 17):
        assert factor_devices(n) == jfactor(n), n


@pytest.mark.parametrize("size", [(64, 48), (50, 37)], ids=["whole", "padded"])
def test_tile_image_matches_jax_and_untiles(size):
    w, h = size
    jcfg = jrt.RasterConfig(img_width=w, img_height=h, tile_size=16)
    tcfg = trt.RasterConfig(img_width=w, img_height=h, tile_size=16)
    img = np.random.default_rng(1).uniform(size=(h, w, 3)).astype(np.float32)
    tiled = trt.tile_image(_t(img), tcfg)
    assert tuple(tiled.shape) == (tcfg.num_tiles, 256, 3)
    np.testing.assert_array_equal(tiled.numpy(),
                                  np.asarray(jrt.tile_image(img, jcfg)))
    np.testing.assert_array_equal(trt._untile(tiled, tcfg).numpy(), img)
    depth = _t(img[..., 0])
    np.testing.assert_array_equal(
        trt._untile(trt.tile_image(depth, tcfg), tcfg).numpy(), img[..., 0])


BANDS = [(0, 1), (1, 2), (2, 1)]   # (first row, rows) of the 3 tile rows


@pytest.mark.parametrize("band", BANDS, ids=lambda b: f"rows{b[0]}+{b[1]}")
def test_clip_and_band_binner_match_jax(binner_proj, band):  # noqa: F811
    """clip_proj_to_tile_rows equal to JAX's, and the band's lists, counts
    and counters from the port's plain binner equal to JAX's
    bin_gaussians_count(num_tiles=), which culls no corner; at two
    budgets, one of which drops pairs."""
    row0, rows = band
    jclip = jrt.clip_proj_to_tile_rows(binner_proj, row0, rows)
    tclip = trt.clip_proj_to_tile_rows(_to_torch(binner_proj), row0, rows)
    for f, a, b in zip(jclip._fields, tclip, jclip):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=f)
    assert int(tclip.tiles_touched.sum()) > 0
    for bpc, bchunk in ((4096, 4096), (16, 64)):
        kw = dict(img_width=64, img_height=48, tile_size=16, tile_cap=16,
                  chunk=8, bin_chunk=bchunk, bin_pairs_per_chunk=bpc)
        jcfg, tcfg = jrt.RasterConfig(**kw), trt.RasterConfig(**kw)
        nt = rows * tcfg.grid_x
        a = jrt.bin_gaussians_count(jclip, jcfg, num_tiles=nt)
        b = trt.bin_gaussians_count(tclip, tcfg, num_tiles=nt)
        for f in ("gidx", "counts", "overflow", "num_pairs",
                  "dropped_pairs", "dropped_tile"):
            np.testing.assert_array_equal(getattr(b, f).numpy(),
                                          np.asarray(getattr(a, f)),
                                          err_msg=f"{f} budget {bpc}")
        assert tuple(b.gidx.shape) == (nt, 16)
        if bpc == 16:
            assert int(b.dropped_pairs) > 0
    # the band's binning keeps pairs the whole grid's corner cull drops
    full = trt.bin_gaussians_count(
        _to_torch(binner_proj), trt.RasterConfig(**{**kw, "tile_cap": 256,
                                                    "bin_chunk": 4096,
                                                    "bin_pairs_per_chunk":
                                                    4096}))
    band_b = trt.bin_gaussians_count(
        tclip, trt.RasterConfig(**{**kw, "tile_cap": 256, "bin_chunk": 4096,
                                   "bin_pairs_per_chunk": 4096}),
        num_tiles=nt)
    own = slice(row0 * 4, (row0 + rows) * 4)
    assert (band_b.counts >= full.counts[own]).all()


@pytest.mark.parametrize("tile0", [4, 8], ids=["middle", "last"])
def test_blend_at_a_band_offset_matches_jax(tile0):
    """The plain blend forward and backward of the band [tile0, tile0 + 4)
    of a 4 x 3 grid against JAX's XLA blend over the band's lists and its
    slice of the pixel coordinates; a band offset outside the grid
    raises."""
    jcfg, tcfg = _cfgs(16)
    proj, binned, opac, colors = _binned_inputs("random", jcfg)
    nt = 4
    band = slice(tile0, tile0 + nt)
    px, py = jrt._tile_pixel_coords(jcfg)
    blend = jrt._make_blend(jcfg)

    def f(pix, conic, color, op, depth):
        return blend(binned.gidx[band], px[band], py[band], pix, conic,
                     color, op, depth, None, None, None)

    ref, vjp = jax.vjp(f, proj.pix, proj.conic, jnp.asarray(colors),
                       jnp.asarray(opac), proj.depth)
    table = tblend.pack_attr_table(_t(proj.pix), _t(proj.conic), _t(colors),
                                   _t(opac), _t(proj.depth))
    gidx = _t(binned.gidx)[band].contiguous()
    counts = _t(binned.counts)[band].contiguous()
    out = tblend.blend_forward(gidx, counts, table, tcfg, tile0=tile0)
    for name, a, b in zip(("color", "depth", "t"), out, ref):
        assert tuple(a.shape) == b.shape, name
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=TOL[name],
                                   err_msg=name)
    assert 0.0 < float(out[2].min()) < 0.5
    # the same lists at the whole grid's offset 0 blend other pixels
    assert float((tblend.blend_forward(gidx, counts, table, tcfg)[0]
                  - out[0]).abs().max()) > 1e-3

    rng = np.random.default_rng(5)
    cot = [rng.normal(size=x.shape).astype(np.float32) for x in out]
    gref = vjp(tuple(jnp.asarray(c) for c in cot))
    gref = np.concatenate([np.asarray(r).reshape(len(opac), -1)
                           for r in gref], axis=1)
    args = (gidx, counts, table, *out, *map(_t, cot), tcfg)
    got = tblend.blend_backward(*args, tile0=tile0)
    slots = tblend.blend_backward_slots(*args, tile0=tile0)
    assert tuple(slots.shape) == (nt, tcfg.tile_cap, tblend.GRAD_W)
    via_slots = tblend.reduce_slots(gidx, slots, len(opac))
    for port in (got, via_slots):
        for a, b in ((0, 2), (2, 5), (5, 8), (8, 9), (9, 10)):
            scale = np.abs(gref[:, a:b]).max() + 1e-8
            np.testing.assert_allclose(port[:, a:b].numpy() / scale,
                                       gref[:, a:b] / scale, atol=GRAD_TOL)
    with pytest.raises(ValueError, match="from tile 10"):
        tblend.blend_forward(gidx, counts, table, tcfg, tile0=10)


def test_one_rank_mesh_equals_train_step():
    """A (1, 1) mesh with no process group runs the sharded code path
    (no collective, no band): its fine step equals the port's own
    train_step from the same state, the loss to 1e-6 relative and every
    parameter, moment and statistic bit for bit."""
    sc = scene(64, 64)
    single = single_card_fine_step(sc)
    state = worker._state(dict(flat=jckpt._flatten(sc["st"]._asdict()),
                               cfg=sc["pcfg"]))
    ids = batch_ids()
    mesh = make_mesh(1, 1)
    assert mesh.group is None and mesh.shape == {"data": 1, "tile": 1}
    state, loss, aux = sharded_train_step(
        state, [sc["tcams"][i] for i in ids],
        torch.from_numpy(sc["images"][ids]), torch.zeros(3), 1, mesh=mesh,
        stage="fine", raster_cfg=sc["traster"],
        tx=toptim.build_optimizer(sc["pcfg"].opt, 1.0), reg_weights=REG,
        lambda_dssim=0.2)
    assert float(loss) == pytest.approx(single["loss"], rel=1e-6)
    port = worker.snapshot(state)
    for k, v in single["state"].items():
        np.testing.assert_array_equal(port[k], v, err_msg=k)


def test_run_stage_over_a_mesh(tmp_path):
    """run_stage over a (2, 2) mesh of four gloo ranks, 70 coarse
    iterations at batch 2 with a densify at 60 and a sharded test render
    at 70: the PSNR rises, the densify ran, and every rank ends with the
    same state bit for bit."""
    sc = scene(64, 64)
    cfg = sc["pcfg"]
    assert cfg.opt.batch_size == 2
    job = dict(runs=["stage"], mesh=(2, 2),
               flat=jckpt._flatten(sc["st"]._asdict()), cfg=cfg,
               raster=sc["traster"], cams=sc["tcams"],
               gts=torch.from_numpy(sc["images"]), bg=torch.zeros(3),
               stage="coarse", iterations=70, log_every=10,
               test_iterations=(70,))
    ctx = worker.spawn(job, 4, tmp_path)
    ranks = [r["stage"] for r in worker.collect(ctx, tmp_path, 4)]
    psnrs = [h["psnr"] for h in ranks[0]["history"]]
    assert np.isfinite(psnrs).all() and psnrs[-1] > psnrs[0], psnrs
    assert "densify" in [e["kind"] for e in ranks[0]["events"]]
    assert len(ranks[0]["tests"]) == 1
    def logged(rank):   # every record but its wall time
        return [{k: v for k, v in h.items() if k != "elapsed"}
                for h in rank["history"]]

    for r in ranks[1:]:
        assert logged(r) == logged(ranks[0])
        assert r["tests"] == ranks[0]["tests"]
        for k, v in r["state"].items():
            np.testing.assert_array_equal(v, ranks[0]["state"][k],
                                          err_msg=k)


def test_batch_slices_follow_the_data_coordinate():
    """host_batch_slice by the data coordinate: the ranks of a data row
    share a slice; pad_batch_for_hosts rounds up to the data size."""
    slices = {r: multihost.host_batch_slice(6, Mesh(3, 2, rank=r))
              for r in range(6)}
    assert slices[0] == slices[1] == slice(0, 2)
    assert slices[2] == slices[3] == slice(2, 4)
    assert slices[4] == slices[5] == slice(4, 6)
    assert multihost.host_batch_slice(4, Mesh(1, 4, rank=3)) == slice(0, 4)
    assert [multihost.pad_batch_for_hosts(b, Mesh(3, 2)) for b in
            (1, 3, 4, 6)] == [3, 3, 6, 6]
    with pytest.raises(AssertionError):
        multihost.host_batch_slice(5, Mesh(2, 1))
    m = Mesh(2, 4, rank=6)
    assert (m.data, m.tile, m.size) == (1, 2, 8)


def test_refusals(monkeypatch):
    """A mesh the ranks do not fill raises; a captured mesh step on the
    CPU raises (it has no CUDA graphs; the gloo refusal:
    tests/test_torch_parallel_capture.py); outside torchrun nothing is
    initialised; ranks that share a card need gloo asked for."""
    with pytest.raises(ValueError, match="needs 2 ranks"):
        make_mesh(2, 1)
    sc = scene(64, 64)
    state = worker._state(dict(flat=jckpt._flatten(sc["st"]._asdict()),
                               cfg=sc["pcfg"]))
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        tloop.run_stage(sc["pcfg"], state, "coarse", 1, sc["tcams"],
                        torch.from_numpy(sc["images"]),
                        toptim.build_optimizer(sc["pcfg"].opt, 1.0),
                        sc["traster"], rng=np.random.default_rng(0),
                        mesh=make_mesh(1, 1), capture=True)
    for k in ("RANK", "WORLD_SIZE"):
        monkeypatch.delenv(k, raising=False)
    assert multihost.initialize_distributed(device="cpu") is False
    monkeypatch.setenv("RANK", "1")
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("LOCAL_RANK", "1")
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match="FOURDGS_DIST_BACKEND=gloo"):
        multihost.initialize_distributed(device="cuda")
    with pytest.raises(ValueError, match="CPU takes gloo"):
        multihost.initialize_distributed(device="cpu", backend="nccl")
