"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here is marked `gpu` and takes the `cuda` fixture, which skips
it when no CUDA device is present. The decision is made when the test
runs, never at import, so every pytest-xdist worker collects the same
tests. Run them on a machine with an H100:

    python -m pytest tests/test_torch_kernels_gpu.py -q

Tolerances are those the blend is held to everywhere: color 1e-5, depth
1e-4, transmittance 1e-5. The kernel and the plain version take the same
gate decisions and differ only in the order of the color and depth sums.
The backward kernel (K2) sums with atomics, in an order that changes from
run to run, so its gradients are held to the JAX tests' normalised
tolerance: each column group divided by its largest magnitude, atol 1e-4
(tests/test_pallas_blend.py). The per-slot backward (K3) has no atomics
and is held per column, over the slots that hold a gaussian, to the same
tolerance; the row scatter-add (K4) adds with atomics, max |a - b| /
max |b| 1e-5; the scalar scatter-set (K5) is exact. The dev tools'
kernels (D1, D2, D4a, D4b) are exact, D6's sums held to rtol 1e-5. The
binner kernel (csrc/binner.cu) is integer work and must equal the plain
binner on every field; D1 as the HexPlane's forward gather must equal
`index_select`, the HexPlane forward on the card the CPU path's (the same
IEEE elementwise operations around exact gathers), and its gradients
the CPU path's within 1e-5 of each plane's largest magnitude (the order
of `index_add_`'s atomics).
"""
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from fourdgs_tpu_torch.data.camera import look_at_camera, make_camera
from fourdgs_tpu_torch.models.deformation import DeformConfig, Deformation
from fourdgs_tpu_torch.models.gaussians import GaussianParams
from fourdgs_tpu_torch.ops import blend, blend_variants
from fourdgs_tpu_torch.ops.binner_proto import expand_rank, expand_rank_plain
from fourdgs_tpu_torch.ops.gather import gather_rows, gather_rows_plain
from fourdgs_tpu_torch.models.hexplane import HexPlaneConfig, HexPlaneField
from fourdgs_tpu_torch.ops import rasterize_tiled
from fourdgs_tpu_torch.ops.projection import Projected
from fourdgs_tpu_torch.ops.rasterize_tiled import RasterConfig, prepare_blend
from fourdgs_tpu_torch.ops.scatter import (scatter_add_rows,
                                           scatter_add_rows_plain,
                                           scatter_set_scalars,
                                           scatter_set_scalars_plain)
from fourdgs_tpu_torch.ops.serial import (MAX_TILES, scalar_store,
                                          scalar_store_plain,
                                          tile_counter_store,
                                          tile_counter_store_plain)
from fourdgs_tpu_torch.render.render import splats_at
from fourdgs_tpu_torch.train import config as tconfig
from fourdgs_tpu_torch.train import loop, optim
from fourdgs_tpu_torch.train.state import create_state

TOL = {"color": 1e-5, "depth": 1e-4, "t": 1e-5}
W, H = 96, 80
# edges of 8 columns and 22 rows at tile 32 (and 8 and 6 at tile 16), as
# 1352 x 1014 leaves: part of a 16-pixel sub-tile row and column
RAGGED_WH = (104, 86)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def ragged_scene(rng, width, height, fovx, fovy, n_faint=18):
    """A dense centre and faint edges. In front, six near-opaque splats 24
    pixels wide at pixel (8, 8) saturate a disc of some 15 pixels around
    it, the image's first 16 x 16 block whole; behind them, three
    near-opaque splats of one random width (1.5 to 4 pixels) at the centre
    of each 16 x 16 block; behind those, `n_faint` wide faint splats spread
    over the image (opacity 0.0042 to 0.005, so that only a disc of 0.4 to
    0.7 sigma around each centre passes alpha 1/255). The saturated pixels
    stop within the first chunk; the pixels between the blobs see only the
    faint splats and walk their tile's whole list. Returns (means, scales,
    quats, opacities, colors) as float32 arrays for a camera at the origin
    looking down +z."""
    tx, ty = np.tan(fovx / 2), np.tan(fovy / 2)
    cx, cy = np.meshgrid(np.arange(8.0, width, 16), np.arange(8.0, height, 16))
    cx = np.concatenate([np.full(6, 8.0), np.repeat(cx.ravel(), 3)])
    cy = np.concatenate([np.full(6, 8.0), np.repeat(cy.ravel(), 3)])
    m = cx.size
    z = np.concatenate([np.linspace(1.9, 1.95, 6),
                        np.tile([2.0, 2.05, 2.1], (m - 6) // 3),
                        rng.uniform(3.0, 6.0, n_faint)])
    u = np.concatenate([(cx + rng.uniform(-0.5, 0.5, m) + 0.5) * 2 / width - 1,
                        rng.uniform(-1.0, 1.0, n_faint)])
    v = np.concatenate([(cy + rng.uniform(-0.5, 0.5, m) + 0.5) * 2 / height - 1,
                        rng.uniform(-1.0, 1.0, n_faint)])
    means = np.stack([u * z * tx, v * z * ty, z], -1)
    # pixel sigma: 24 for the front six, the blob's width, 0.6 of the
    # image's for a faint splat
    sigma = np.concatenate([np.full(6, 24.0),
                            np.repeat(rng.uniform(1.5, 4.0, (m - 6) // 3), 3),
                            np.full(n_faint, 0.6 * width)])
    scales = np.repeat((sigma * z * 2 * tx / width)[:, None], 3, 1)
    quats = np.tile(np.array([1.0, 0.0, 0.0, 0.0]), (m + n_faint, 1))
    opac = np.concatenate([rng.uniform(0.95, 0.99, m),
                           rng.uniform(0.0042, 0.005, n_faint)])
    colors = rng.uniform(0.0, 1.0, (m + n_faint, 3))
    return [np.asarray(x, np.float32)
            for x in (means, scales, quats, opac, colors)]


def _scene(kind, n, seed, size=(W, H)):
    rng = np.random.default_rng(seed)
    if kind == "ragged":
        return ragged_scene(rng, size[0], size[1], 1.0, 0.85)
    if kind == "random":
        means = np.stack([rng.uniform(-1.5, 1.5, n), rng.uniform(-1.2, 1.2, n),
                          rng.uniform(2.0, 6.0, n)], -1)
        scales = np.exp(rng.uniform(-3.0, -1.0, (n, 3)))
        opac = rng.uniform(0.05, 0.99, n)
    else:  # a deep stack of near-opaque splats: every pixel saturates
        means = np.stack([rng.uniform(-0.1, 0.1, n), rng.uniform(-0.1, 0.1, n),
                          np.linspace(2.0, 6.0, n)], -1)
        scales = np.full((n, 3), 2.0)
        opac = rng.uniform(0.9, 0.99, n)
    quats = rng.normal(size=(n, 4))
    colors = rng.uniform(0.0, 1.0, (n, 3))
    return [np.asarray(x, np.float32)
            for x in (means, scales, quats, opac, colors)]


def _inputs(dev, kind, ts, tile_cap=128, chunk=8, n=400, seed=0,
            size=(W, H), slots=False):
    cfg = RasterConfig(img_width=size[0], img_height=size[1], tile_size=ts,
                       tile_cap=tile_cap, chunk=chunk)
    means, scales, quats, opac, colors = (
        torch.from_numpy(x).to(dev) for x in _scene(kind, n, seed, size))
    cam = make_camera(np.eye(3), np.zeros(3), 1.0, 0.85, device=dev)
    _, binned, table = prepare_blend(means, scales, quats, opac, colors, cam,
                                     cfg, slots=slots)
    return binned, table, cfg


def _assert_close(out, ref):
    for name, a, b in zip(("color", "depth", "t"), out, ref):
        assert a.shape == b.shape, name
        err = float((a - b).abs().max())
        assert err <= TOL[name], f"{name}: max abs err {err}"


@pytest.mark.gpu
@pytest.mark.parametrize("ts", [16, 32])
@pytest.mark.parametrize("kind", ["random", "saturating", "ragged"])
def test_blend_kernel_matches_plain(cuda, kind, ts):
    binned, table, cfg = _inputs(cuda, kind, ts)
    assert int(binned.counts.max()) > cfg.chunk     # several chunks
    before = blend.blend_forward.launches
    out = blend.blend_forward(binned.gidx, binned.counts, table, cfg)
    torch.cuda.synchronize()
    assert blend.blend_forward.launches == before + 1
    _assert_close(out, blend.blend_forward_plain(binned.gidx, binned.counts,
                                                 table, cfg))
    if kind == "saturating":
        assert float(out[2].max()) <= 1e-3
    if kind == "ragged":   # tiles that hold both saturated and live pixels
        t = out[2]
        assert bool(((t.amin(1) <= 1e-3) & (t.amax(1) > 0.5)).any())


@pytest.mark.gpu
@pytest.mark.parametrize("ts", [16, 32])
@pytest.mark.parametrize("kind", ["random", "saturating", "ragged"])
def test_blend_kernel_at_a_ragged_size(cuda, kind, ts):
    """K1 at RAGGED_WH, whose last tile row and column end inside a
    sub-tile: every pixel against the plain blend, and the pixels past the
    image's edge in the edge tiles as the plain blend leaves them."""
    binned, table, cfg = _inputs(cuda, kind, ts, size=RAGGED_WH)
    assert (cfg.img_width % 16, cfg.img_height % 16) == (8, 6)
    out = blend.blend_forward(binned.gidx, binned.counts, table, cfg)
    torch.cuda.synchronize()
    _assert_close(out, blend.blend_forward_plain(binned.gidx, binned.counts,
                                                 table, cfg))
    color = rasterize_tiled._untile(out[0], cfg)
    assert color.shape == (RAGGED_WH[1], RAGGED_WH[0], 3)
    assert bool(torch.isfinite(color).all())


@pytest.mark.gpu
@pytest.mark.parametrize("tile_cap,chunk", [(16, 8), (64, 32), (96, 32),
                                            (96, 6), (16, 1)])
def test_blend_kernel_caps_and_chunks(cuda, tile_cap, chunk):
    """Full tiles (tile overflow), counts that end inside a chunk, and
    chunks that are not whole gate batches (K1's ring pads them)."""
    binned, table, cfg = _inputs(cuda, "random", 16, tile_cap, chunk, n=900,
                                 seed=1)
    if tile_cap == 16:
        assert int(binned.overflow.sum()) > 0
    out = blend.blend_forward(binned.gidx, binned.counts, table, cfg)
    _assert_close(out, blend.blend_forward_plain(binned.gidx, binned.counts,
                                                 table, cfg))


def _deep_inputs(dev, ts, tile_cap, chunk, n_faint):
    """The ragged scene with `n_faint` faint splats, at a tile_cap that its
    tiles fill or not."""
    rng = np.random.default_rng(3)
    cfg = RasterConfig(img_width=W, img_height=H, tile_size=ts,
                       tile_cap=tile_cap, chunk=chunk,
                       bin_pairs_per_chunk=1 << 17)
    means, scales, quats, opac, colors = (
        torch.from_numpy(x).to(dev)
        for x in ragged_scene(rng, W, H, 1.0, 0.85, n_faint))
    cam = make_camera(np.eye(3), np.zeros(3), 1.0, 0.85, device=dev)
    _, binned, table = prepare_blend(means, scales, quats, opac, colors, cam,
                                     cfg)
    return binned, table, cfg


@pytest.mark.gpu
@pytest.mark.parametrize("ts,tile_cap,chunk,n_faint", [
    (32, 2048, 32, 2400),     # the train CLI's default tile_cap, full tiles
    (16, 2048, 8, 1200),      # chunk 8, counts ending inside a chunk
    (32, 2048, 1024, 1500),   # chunk 1024: 96 KB of rows, past 48 KB
    (16, 1024, 1024, 700)])   # one chunk that the count ends inside
def test_blend_kernel_long_lists(cuda, ts, tile_cap, chunk, n_faint):
    """Long slot lists: full tiles at tile_cap 2048, the smallest and the
    largest chunk, and counts that end inside a chunk."""
    binned, table, cfg = _deep_inputs(cuda, ts, tile_cap, chunk, n_faint)
    counts = binned.counts
    assert int(binned.dropped_pairs) == 0
    assert bool((counts % chunk != 0).any())
    if n_faint > tile_cap:
        assert int(counts.max()) == tile_cap
    out = blend.blend_forward(binned.gidx, counts, table, cfg)
    ref = blend.blend_forward_plain(binned.gidx, counts, table, cfg)
    _assert_close(out, ref)
    assert float(ref[2].max()) > 1e-3     # pixels that walked every slot


@pytest.mark.gpu
def test_blend_kernel_empty_tiles(cuda):
    """Tiles with count 0 blend to nothing beside tiles that hold slots."""
    binned, table, cfg = _inputs(cuda, "ragged", 32)
    gidx, counts = binned.gidx.clone(), binned.counts.clone()
    gidx[::2], counts[::2] = -1, 0
    assert bool((counts > 0).any())
    color, depth, trans = blend.blend_forward(gidx, counts, table, cfg)
    _assert_close((color, depth, trans),
                  blend.blend_forward_plain(gidx, counts, table, cfg))
    assert float(color[::2].abs().max()) == 0.0
    assert float(trans[::2].min()) == 1.0


@pytest.mark.gpu
@pytest.mark.parametrize("list_slots", [32, 96])
def test_blend_kernel_restages_the_list(cuda, monkeypatch, list_slots):
    """A slot list longer than the staged segment is staged again at each
    segment's first chunk."""
    monkeypatch.setattr(blend, "_LIST_SLOTS", list_slots)
    binned, table, cfg = _deep_inputs(cuda, 16, 512, 32, 400)
    assert int(binned.counts.max()) > 3 * list_slots
    out = blend.blend_forward(binned.gidx, binned.counts, table, cfg)
    _assert_close(out, blend.blend_forward_plain(binned.gidx, binned.counts,
                                                 table, cfg))


@pytest.mark.gpu
def test_blend_kernel_skips_a_nan_splat(cuda):
    """A NaN conic fails the alpha gate in the kernel as in the plain
    version (a NaN-dropping min would have let it through at 0.99)."""
    binned, table, cfg = _inputs(cuda, "random", 16)
    table[int(binned.gidx[binned.counts > 0][0, 0]), 2:5] = float("nan")
    out = blend.blend_forward(binned.gidx, binned.counts, table, cfg)
    assert all(bool(torch.isfinite(x).all()) for x in out)
    _assert_close(out, blend.blend_forward_plain(binned.gidx, binned.counts,
                                                 table, cfg))


@pytest.mark.gpu
def test_blend_kernel_refuses_what_it_cannot_take(cuda):
    before = blend.blend_forward.launches
    binned, table, cfg = _inputs(cuda, "random", 8)
    with pytest.raises(ValueError, match="tile_size 16 or 32"):
        blend.blend_forward(binned.gidx, binned.counts, table, cfg)
    binned, table, cfg = _inputs(cuda, "random", 16)
    with pytest.raises(ValueError, match="device"):
        blend.blend_forward(binned.gidx, binned.counts.cpu(), table, cfg)
    assert blend.blend_forward.launches == before


@pytest.mark.gpu
def test_fine_splats_wait_on_no_host_sync(cuda):
    """The deformation at the camera's timestamp, the HexPlane constant-t
    sampler included, and the SH colors never read the device to the
    host, so they leave the launch queue running."""
    rng = np.random.default_rng(2)
    n = 512
    gauss = GaussianParams(**{
        k: torch.from_numpy(rng.normal(0, 0.3, shape).astype(np.float32)).to(
            cuda)
        for k, shape in (("xyz", (n, 3)), ("features_dc", (n, 1, 3)),
                         ("features_rest", (n, 15, 3)), ("scaling", (n, 3)),
                         ("rotation", (n, 4)), ("opacity", (n, 1)))})
    deform = Deformation(DeformConfig(),
                         generator=torch.Generator().manual_seed(0)).to(cuda)
    aabb = torch.tensor([[1.5] * 3, [-1.5] * 3], device=cuda)
    cam = look_at_camera(time=0.4, device=cuda)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = splats_at(gauss, deform, cam, aabb, 3)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert all(bool(torch.isfinite(x).all()) for x in out)


GROUPS = {"pix": (0, 2), "conic": (2, 5), "color": (5, 8), "opacity": (8, 9),
          "depth": (9, 10)}
GRAD_TOL = 1e-4


def _normalised_close(port, ref, name):
    assert port.shape == ref.shape, name
    assert bool(torch.isfinite(port).all()), name
    scale = float(ref.abs().max()) + 1e-12
    err = float((port - ref).abs().max()) / scale
    assert err <= GRAD_TOL, f"{name}: normalised max abs err {err}"


def _backward_inputs(dev, binned, table, cfg, seed=0):
    """Forward outputs by K1 and seeded cotangents."""
    out = blend.blend_forward(binned.gidx, binned.counts, table, cfg)
    gen = torch.Generator().manual_seed(seed)
    nt, p = cfg.num_tiles, cfg.pixels_per_tile
    cot = [torch.randn(shape, generator=gen).to(dev)
           for shape in ((nt, p, 3), (nt, p), (nt, p))]
    return out, cot


def _check_backward(dev, binned, table, cfg):
    out, cot = _backward_inputs(dev, binned, table, cfg)
    before = blend.blend_backward.launches
    g = blend.blend_backward(binned.gidx, binned.counts, table, *out, *cot,
                             cfg)
    torch.cuda.synchronize()
    assert blend.blend_backward.launches == before + 1
    ref = blend.blend_backward_plain(binned.gidx, binned.counts, table, *out,
                                     *cot, cfg)
    assert g.shape == ref.shape == (table.shape[0] - 1, blend.GRAD_W)
    assert float(ref.abs().max()) > 0
    for name, (a, b) in GROUPS.items():
        _normalised_close(g[:, a:b], ref[:, a:b], name)


@pytest.mark.gpu
@pytest.mark.parametrize("ts", [16, 32])
@pytest.mark.parametrize("kind", ["random", "saturating"])
def test_blend_backward_kernel_matches_plain(cuda, kind, ts):
    binned, table, cfg = _inputs(cuda, kind, ts)
    assert int(binned.counts.max()) > cfg.chunk     # several chunks
    _check_backward(cuda, binned, table, cfg)


@pytest.mark.gpu
@pytest.mark.parametrize("ts", [16, 32])
def test_blend_backward_kernel_on_ragged_k1_outputs(cuda, ts):
    """K2 on K1's outputs of the ragged scene, whose sub-tiles stop at
    different chunks, against the plain backward on the same outputs."""
    binned, table, cfg = _inputs(cuda, "ragged", ts)
    out = blend.blend_forward(binned.gidx, binned.counts, table, cfg)
    _assert_close(out, blend.blend_forward_plain(binned.gidx, binned.counts,
                                                 table, cfg))
    _check_backward(cuda, binned, table, cfg)


@pytest.mark.gpu
@pytest.mark.parametrize("ts", [16, 32])
@pytest.mark.parametrize("kind", ["random", "saturating", "ragged"])
def test_blend_backward_kernel_at_a_ragged_size(cuda, kind, ts):
    """K2 at RAGGED_WH (partial sub-tile rows and columns at the edges)
    against the plain backward on K1's outputs."""
    binned, table, cfg = _inputs(cuda, kind, ts, size=RAGGED_WH)
    _check_backward(cuda, binned, table, cfg)


@pytest.mark.gpu
@pytest.mark.parametrize("tile_cap,chunk", [(16, 8), (64, 32), (96, 32),
                                            (512, 512), (96, 6), (16, 1)])
def test_blend_backward_kernel_caps_and_chunks(cuda, tile_cap, chunk):
    """Full tiles (tile overflow), counts that end inside a chunk, the
    largest chunk the kernel takes, and chunks that are not whole batches
    of four slots (K2's ring pads them)."""
    binned, table, cfg = _inputs(cuda, "random", 16, tile_cap, chunk, n=900,
                                 seed=1)
    if tile_cap == 16:
        assert int(binned.overflow.sum()) > 0
    _check_backward(cuda, binned, table, cfg)


@pytest.mark.gpu
@pytest.mark.parametrize("ts,tile_cap,chunk,n_faint,list_slots", [
    (32, 2048, 32, 2400, 1024),   # the train CLI's tile_cap, full tiles
    (16, 2048, 8, 2000, 1024),    # chunk 8, counts ending inside a chunk
    (32, 2048, 512, 1500, 1024),  # the largest chunk
    (32, 4096, 512, 1500, None)])  # and the whole list: 224 KB of shared
def test_blend_backward_kernel_long_lists(cuda, monkeypatch, ts, tile_cap,
                                          chunk, n_faint, list_slots):
    """Long slot lists: full tiles at tile_cap 2048, staged in segments of
    1,024 ids, the smallest and the largest chunk, and the largest shared
    memory K2 takes (chunk 512 and a list of _LIST_SLOTS ids)."""
    if list_slots is not None:
        monkeypatch.setattr(blend, "_LIST_SLOTS", list_slots)
    binned, table, cfg = _deep_inputs(cuda, ts, tile_cap, chunk, n_faint)
    assert int(binned.dropped_pairs) == 0
    if n_faint > tile_cap:
        assert int(binned.counts.max()) == tile_cap
    if list_slots is not None:
        assert int(binned.counts.max()) > list_slots
    _check_backward(cuda, binned, table, cfg)


@pytest.mark.gpu
@pytest.mark.parametrize("list_slots", [32, 96])
def test_blend_backward_kernel_restages_the_list(cuda, monkeypatch,
                                                 list_slots):
    """A slot list longer than the staged segment is staged again at each
    segment's first chunk."""
    monkeypatch.setattr(blend, "_LIST_SLOTS", list_slots)
    binned, table, cfg = _deep_inputs(cuda, 16, 512, 32, 400)
    assert int(binned.counts.max()) > 3 * list_slots
    _check_backward(cuda, binned, table, cfg)


@pytest.mark.gpu
def test_blend_backward_kernel_empty_tiles(cuda):
    """Tiles with count 0 beside tiles that hold slots: their blocks add
    nothing, and the others' sums are whole."""
    binned, table, cfg = _inputs(cuda, "ragged", 32)
    binned.gidx[::2], binned.counts[::2] = -1, 0
    assert bool((binned.counts > 0).any())
    _check_backward(cuda, binned, table, cfg)


@pytest.mark.gpu
@pytest.mark.parametrize("ts", [16, 32])
def test_blend_backward_kernel_gaussians_in_many_tiles(cuda, ts):
    """Eight wide, faint splats, each in every tile: every sub-tile block
    of the image flushes the same eight rows."""
    rng = np.random.default_rng(4)
    n = 8
    means = np.stack([rng.uniform(-0.3, 0.3, n), rng.uniform(-0.3, 0.3, n),
                      np.linspace(3.0, 4.0, n)], -1)
    cfg = RasterConfig(img_width=W, img_height=H, tile_size=ts,
                       tile_cap=32, chunk=8)
    means, scales, quats, opac, colors = (
        torch.from_numpy(np.asarray(x, np.float32)).to(cuda)
        for x in (means, np.full((n, 3), 1.2), rng.normal(size=(n, 4)),
                  rng.uniform(0.2, 0.4, n), rng.uniform(0.0, 1.0, (n, 3))))
    cam = make_camera(np.eye(3), np.zeros(3), 1.0, 0.85, device=cuda)
    _, binned, table = prepare_blend(means, scales, quats, opac, colors, cam,
                                     cfg)
    assert bool((binned.counts == n).all())
    _check_backward(cuda, binned, table, cfg)


@pytest.mark.gpu
@pytest.mark.parametrize("ts", [16, 32])
def test_blend_backward_kernel_tally(cuda, ts):
    """The counting build gives the timed build's gradients, reduces the
    batches that `bwd_work` counts, issues at most five float2 atomics
    per slot that a 16 x 8 sub-tile used, and its sub-tile blocks walk the
    chunks that `blend_work` counts for them."""
    from fourdgs_tpu_torch.tools.profile_blend_split import (blend_work,
                                                             bwd_work)
    binned, table, cfg = _inputs(cuda, "ragged", ts, tile_cap=96, chunk=6)
    out, cot = _backward_inputs(cuda, binned, table, cfg)
    args = (binned.gidx, binned.counts, table, *out, *cot, cfg)
    tally = torch.zeros(3, dtype=torch.int64, device=cuda)
    g = blend.blend_backward(*args, tally=tally)
    ref = blend.blend_backward(*args)
    for name, (a, b) in GROUPS.items():
        _normalised_close(g[:, a:b], ref[:, a:b], name)
    atomics, batches, chunks = tally.tolist()
    work = bwd_work(binned.gidx, binned.counts, table, cfg)
    assert batches == work["reduced_batches"] > 0
    assert 0 < atomics <= 5 * work["block_slots"]["sub_tile"]
    walked = blend_work(binned.gidx, binned.counts, table, cfg)
    assert chunks == walked["block_chunks"]["sub_tile"] > 0


@pytest.mark.gpu
def test_blend_backward_kernel_refuses_what_it_cannot_take(cuda):
    before = blend.blend_backward.launches
    binned, table, cfg = _inputs(cuda, "random", 16, 1024, 1024)
    out, cot = _backward_inputs(cuda, binned, table, cfg)
    with pytest.raises(ValueError, match="chunk 1024"):
        blend.blend_backward(binned.gidx, binned.counts, table, *out, *cot,
                             cfg)
    binned, table, cfg = _inputs(cuda, "random", 16)
    out, cot = _backward_inputs(cuda, binned, table, cfg)
    with pytest.raises(ValueError, match="cotangent depth"):
        blend.blend_backward(binned.gidx, binned.counts, table, *out,
                             cot[0], cot[1].cpu(), cot[2], cfg)
    with pytest.raises(ValueError, match="cotangent color"):
        blend.blend_backward(binned.gidx, binned.counts, table, *out,
                             cot[0].transpose(0, 1).contiguous()
                             .transpose(0, 1), *cot[1:], cfg)
    cfg8 = RasterConfig(img_width=W, img_height=H, tile_size=8,
                        tile_cap=128, chunk=8)
    binned, table, _ = _inputs(cuda, "random", 8)
    out = blend.blend_forward_plain(binned.gidx, binned.counts, table, cfg8)
    cot = [torch.zeros_like(x) for x in out]
    with pytest.raises(ValueError, match="tile_size 16 or 32"):
        blend.blend_backward(binned.gidx, binned.counts, table, *out, *cot,
                             cfg8)
    assert blend.blend_backward.launches == before


def _small_train_state(device):
    cfg = tconfig.Config()
    cfg.model.sh_degree = 1
    cfg.raster = tconfig.RasterParams(capacity=512, tile_size=16,
                                      tile_cap=256, chunk=8)
    cfg.hidden.kplanes_config["resolution"] = [8, 8, 8, 4]
    cfg.hidden.kplanes_config["output_coordinate_dim"] = 8
    cfg.hidden.multires = [1, 2]
    cfg.hidden.net_width = 32
    rng = np.random.default_rng(3)
    pts = rng.uniform(-1, 1, (300, 3)).astype(np.float32)
    cols = rng.uniform(0, 1, (300, 3)).astype(np.float32)
    st = create_state(cfg, pts, cols, 1.0, device="cpu",
                      generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        g = st.params["gauss"]
        g.opacity.add_(torch.from_numpy(
            rng.normal(1.5, 1.0, g.opacity.shape).astype(np.float32)))
        g.scaling.add_(torch.from_numpy(
            rng.normal(0.5, 0.3, g.scaling.shape).astype(np.float32)))
    return cfg, st.to(device)


@pytest.mark.gpu
@pytest.mark.parametrize("stage", ["fine", "coarse"])
def test_train_step_on_card_matches_cpu(cuda, stage):
    """One train_step on the card (K1 and K2) against the same step on the
    CPU (the plain versions), from one state: loss 1e-5 relative, every
    gradient leaf (mu after step 1) normalised 1e-4, the densify
    statistics."""
    cfg, cpu_state = _small_train_state("cpu")
    gpu_state = cpu_state.to(cuda)
    rc = tconfig.raster_config_from(cfg, 96, 80)
    target = torch.from_numpy(np.random.default_rng(4).uniform(
        0, 1, (1, 80, 96, 3)).astype(np.float32))
    reg = (cfg.hidden.time_smoothness_weight, cfg.hidden.l1_time_planes,
           cfg.hidden.plane_tv_weight)
    tx = optim.build_optimizer(cfg.opt, 1.0)
    auxes = []
    before = blend.blend_backward.launches
    for st in (cpu_state, gpu_state):
        dev = st.alive.device
        cam = look_at_camera(time=0.4, device=dev)
        _, aux = loop.train_step(
            st, [cam], target.to(dev), torch.ones(3, device=dev), 1,
            stage=stage, raster_cfg=rc, tx=tx, lambda_dssim=0.2,
            reg_weights=reg)
        auxes.append(aux)
    torch.cuda.synchronize()
    assert blend.blend_backward.launches == before + 1
    a, b = (float(x.loss) for x in auxes)
    assert abs(a - b) <= 1e-5 * abs(a), (a, b)
    assert float(auxes[0].max_alpha) > 0.5
    for which in ("mu", "nu"):
        ta, tb = (getattr(s.opt_state, which) for s in (cpu_state, gpu_state))
        for leaf_a, leaf_b, name in zip(
                optim.moment_leaves(ta), optim.moment_leaves(tb),
                [f"{which} {i}" for i in range(100)]):
            _normalised_close(leaf_b.cpu(), leaf_a, name)
    _normalised_close(gpu_state.xyz_gradient_accum.cpu(),
                      cpu_state.xyz_gradient_accum, "xyz_gradient_accum")
    assert torch.equal(gpu_state.denom.cpu(), cpu_state.denom)
    assert torch.equal(gpu_state.max_radii2d.cpu(), cpu_state.max_radii2d)


# ---------------------------------------------------------------------------
# K3 (per-slot blend backward), K4 (row scatter-add), K5 (scalar scatter-set)
# ---------------------------------------------------------------------------

def _occupied(counts, cfg):
    """(num_tiles, tile_cap) mask of the rows of each tile's occupied
    chunks, which K3 writes."""
    k = cfg.chunk
    ends = (counts.long() + k - 1) // k * k
    return (torch.arange(cfg.tile_cap, device=counts.device)[None]
            < ends[:, None])


def _check_slots(dev, binned, table, cfg):
    """K3's table against the plain one over the slots with gidx >= 0, each
    column normalised by its max; zeros in the other rows of the occupied
    chunks; and its reduction against K2's rows."""
    out, cot = _backward_inputs(dev, binned, table, cfg)
    args = (binned.gidx, binned.counts, table, *out, *cot, cfg)
    before = blend.blend_backward_slots.launches
    got = blend.blend_backward_slots(*args)
    torch.cuda.synchronize()
    assert blend.blend_backward_slots.launches == before + 1
    ref = blend.blend_backward_slots_plain(*args)
    assert got.shape == ref.shape == (cfg.num_tiles, cfg.tile_cap,
                                      blend.GRAD_W)
    used = binned.gidx >= 0
    for c, name in enumerate(("pix_x", "pix_y", "conic_a", "conic_b",
                              "conic_c", "red", "green", "blue", "opacity",
                              "depth")):
        _normalised_close(got[..., c][used], ref[..., c][used], name)
    # the same table twice: no atomics
    assert torch.equal(blend.blend_backward_slots(*args)[used], got[used])
    assert not bool(got[_occupied(binned.counts, cfg) & ~used].any())
    n = table.shape[0] - 1
    reduced = blend.reduce_slots(binned.gidx, got, n)
    fused = blend.blend_backward(*args)
    for name, (a, b) in GROUPS.items():
        _normalised_close(reduced[:, a:b], fused[:, a:b], name)


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["ragged", "random"])
def test_reassociation_on_k3_table(cuda, kind):
    """The reassociated reduction (plain torch on the card) of K3's table
    over the binner kernel's BlendSlots, on a 104 x 86 frame: against
    `index_add_` by the lists (max |a - b| / max |b| 1e-5), the same bits
    from two runs, and finite and unchanged when K3's table was NaN
    before the launch (every slot it reads is a row K3 writes)."""
    binned, table, cfg = _inputs(cuda, kind, 32, size=RAGGED_WH, slots=True)
    assert binned.slots is not None
    out, cot = _backward_inputs(cuda, binned, table, cfg)
    args = (binned.gidx, binned.counts, table, *out, *cot, cfg)
    n = table.shape[0] - 1
    tbl = blend.blend_backward_slots(*args)
    got = blend.reduce_slots(binned.gidx, tbl, n, binned.slots)
    want = blend.reduce_slots(binned.gidx, tbl, n)
    again = blend.reduce_slots(binned.gidx, blend.blend_backward_slots(*args),
                               n, binned.slots)
    poisoned = torch.full_like(tbl, float("nan"))
    blend.blend_backward_slots(*args, out=poisoned)
    nan_in = blend.reduce_slots(binned.gidx, poisoned, n, binned.slots)
    torch.cuda.synchronize()
    assert bool(torch.isnan(poisoned).any())   # rows K3 leaves unwritten
    err = float((got - want).abs().max()) / float(want.abs().max())
    assert err <= 1e-5, err
    assert torch.equal(got, again)
    assert bool(torch.isfinite(nan_in).all()) and torch.equal(nan_in, got)
    # every list entry is the row of one kept slot
    dest = binned.slots.dest.reshape(-1).long()
    kept = dest < cfg.num_tiles * cfg.tile_cap
    assert int(kept.sum()) == int((binned.gidx >= 0).sum())


@pytest.mark.gpu
@pytest.mark.parametrize("ts", [16, 32])
@pytest.mark.parametrize("kind", ["random", "saturating"])
def test_blend_slots_kernel_matches_plain(cuda, kind, ts):
    binned, table, cfg = _inputs(cuda, kind, ts)
    assert int(binned.counts.max()) > cfg.chunk     # several chunks
    _check_slots(cuda, binned, table, cfg)


@pytest.mark.gpu
@pytest.mark.parametrize("ts", [16, 32])
@pytest.mark.parametrize("kind", ["random", "saturating", "ragged"])
def test_blend_slots_kernel_at_a_ragged_size(cuda, kind, ts):
    """K3 at RAGGED_WH against the plain per-slot table and K2's rows."""
    binned, table, cfg = _inputs(cuda, kind, ts, size=RAGGED_WH)
    _check_slots(cuda, binned, table, cfg)


@pytest.mark.gpu
@pytest.mark.parametrize("ts,tile_cap,chunk", [(16, 16, 8), (16, 64, 32),
                                               (16, 96, 32), (32, 128, 64),
                                               (16, 96, 6), (32, 16, 1),
                                               (16, 512, 512)])
def test_blend_slots_kernel_caps_and_chunks(cuda, ts, tile_cap, chunk):
    """Full tiles, counts that end inside a chunk, chunks that are not
    whole batches of four slots (6, 1), and the largest chunk K3 takes."""
    binned, table, cfg = _inputs(cuda, "random", ts, tile_cap, chunk, n=900,
                                 seed=1)
    _check_slots(cuda, binned, table, cfg)


@pytest.mark.gpu
@pytest.mark.parametrize("ts,tile_cap,chunk,n_faint,list_slots", [
    (32, 2048, 32, 2400, 1024),   # the train CLI's tile_cap, full tiles
    (16, 2048, 8, 2000, 1024),    # chunk 8, counts ending inside a chunk
    (32, 2048, 512, 1500, 1024),  # the largest chunk
    (32, 4096, 512, 1500, None)])  # and the whole list: 224 KB of shared
def test_blend_slots_kernel_long_lists(cuda, monkeypatch, ts, tile_cap,
                                       chunk, n_faint, list_slots):
    """Long slot lists: full tiles at tile_cap 2048, staged in segments of
    1,024 ids, the smallest and the largest chunk, and the largest shared
    memory K3 takes (chunk 512 and a list of _LIST_SLOTS ids), which a
    cluster of eight blocks must find on eight SMs."""
    if list_slots is not None:
        monkeypatch.setattr(blend, "_LIST_SLOTS", list_slots)
    binned, table, cfg = _deep_inputs(cuda, ts, tile_cap, chunk, n_faint)
    assert int(binned.dropped_pairs) == 0
    if n_faint > tile_cap:
        assert int(binned.counts.max()) == tile_cap
    if list_slots is not None:
        assert int(binned.counts.max()) > list_slots
    _check_slots(cuda, binned, table, cfg)


@pytest.mark.gpu
@pytest.mark.parametrize("list_slots", [32, 96])
def test_blend_slots_kernel_restages_the_list(cuda, monkeypatch,
                                              list_slots):
    """A slot list longer than the staged segment is staged again at each
    segment's first chunk on every rank of the tile's cluster."""
    monkeypatch.setattr(blend, "_LIST_SLOTS", list_slots)
    binned, table, cfg = _deep_inputs(cuda, 16, 512, 32, 400)
    assert int(binned.counts.max()) > 3 * list_slots
    _check_slots(cuda, binned, table, cfg)


@pytest.mark.gpu
def test_blend_slots_kernel_empty_tiles(cuda):
    """Tiles with count 0 beside tiles that hold slots: their clusters
    write nothing, and the others' rows are whole."""
    binned, table, cfg = _inputs(cuda, "ragged", 32)
    binned.gidx[::2], binned.counts[::2] = -1, 0
    assert bool((binned.counts > 0).any())
    _check_slots(cuda, binned, table, cfg)


@pytest.mark.gpu
@pytest.mark.parametrize("ts", [16, 32])
def test_blend_slots_kernel_gaussians_in_many_tiles(cuda, ts):
    """Eight wide, faint splats, each in every tile: every tile's cluster
    writes the same eight slots' rows."""
    rng = np.random.default_rng(4)
    n = 8
    means = np.stack([rng.uniform(-0.3, 0.3, n), rng.uniform(-0.3, 0.3, n),
                      np.linspace(3.0, 4.0, n)], -1)
    cfg = RasterConfig(img_width=W, img_height=H, tile_size=ts,
                       tile_cap=32, chunk=8)
    means, scales, quats, opac, colors = (
        torch.from_numpy(np.asarray(x, np.float32)).to(cuda)
        for x in (means, np.full((n, 3), 1.2), rng.normal(size=(n, 4)),
                  rng.uniform(0.2, 0.4, n), rng.uniform(0.0, 1.0, (n, 3))))
    cam = make_camera(np.eye(3), np.zeros(3), 1.0, 0.85, device=cuda)
    _, binned, table = prepare_blend(means, scales, quats, opac, colors, cam,
                                     cfg)
    assert bool((binned.counts == n).all())
    _check_slots(cuda, binned, table, cfg)


def _sub_tile_stack(dev, ts, n_faint=600, seed=5):
    """A list whose first tile's first 16 x 8 sub-tile saturates early and
    alone: in front, three layers of 128 near-opaque splats, one centred
    on each pixel of that sub-tile (opacity 0.99, sigma 0.5 pixel, so a
    pixel outside it keeps T above 0.6); behind them `n_faint` wide faint
    splats over the tile (sigma 20 pixels, opacity 0.004 to 0.008). Every
    tile takes the whole list, 384 + n_faint slots. Returns (binned-like
    gidx and counts, table, cfg) at tile_cap 1024 and chunk 32."""
    rng = np.random.default_rng(seed)
    cfg = RasterConfig(img_width=W, img_height=H, tile_size=ts,
                       tile_cap=1024, chunk=32)
    y, x = np.meshgrid(np.arange(8.0), np.arange(16.0), indexing="ij")
    front = np.tile(np.stack([x.ravel(), y.ravel()], -1), (3, 1))
    pix = np.concatenate([front, rng.uniform(0.0, ts, (n_faint, 2))])
    m = len(pix)
    sharp, wide = 1.0 / 0.5 ** 2, 1.0 / 20.0 ** 2
    conic = np.zeros((m, 3))
    conic[:, 0] = conic[:, 2] = np.r_[np.full(384, sharp),
                                      np.full(n_faint, wide)]
    opacity = np.r_[np.full(384, 0.99), rng.uniform(0.004, 0.008, n_faint)]
    depth = np.r_[np.repeat([1.0, 1.1, 1.2], 128),
                  np.linspace(2.0, 6.0, n_faint)]
    color = rng.uniform(0.0, 1.0, (m, 3))
    table = blend.pack_attr_table(*(
        torch.from_numpy(np.asarray(a, np.float32)).to(dev)
        for a in (pix, conic, color, opacity, depth)))
    gidx = torch.full((cfg.num_tiles, cfg.tile_cap), -1, dtype=torch.int32,
                      device=dev)
    gidx[:, :m] = torch.arange(m, dtype=torch.int32, device=dev)
    counts = torch.full((cfg.num_tiles,), m, dtype=torch.int32, device=dev)
    return SimpleNamespace(gidx=gidx, counts=counts), table, cfg


@pytest.mark.gpu
@pytest.mark.parametrize("ts", [16, 32])
def test_blend_slots_kernel_sub_tiles_saturate_apart(cuda, ts):
    """One sub-tile of the first tile saturates within the front stack's
    chunks, its neighbours walk the whole list: its rank flushes zero
    partial rows for the chunks left, and the tile's rows are whole."""
    binned, table, cfg = _sub_tile_stack(cuda, ts)
    _, _, trans = blend.blend_forward(binned.gidx, binned.counts, table, cfg)
    t0 = trans[0].reshape(ts, ts)
    stacked = torch.zeros((ts, ts), dtype=torch.bool, device=cuda)
    stacked[:8, :16] = True
    assert float(t0[stacked].max()) <= 1e-4
    assert float(t0[~stacked].min()) > 1e-3
    _check_slots(cuda, binned, table, cfg)


@pytest.mark.gpu
@pytest.mark.parametrize("ts", [16, 32])
def test_blend_slots_kernel_tally(cuda, ts):
    """K3's counting build gives the timed build's table bit for bit,
    reduces the batches that K2's counting build reduces on the same
    input, stores five float2 a row of each tile's occupied chunks, and
    its blocks walk the chunks of their tile's cluster: the sub-tiles of a
    tile times the chunks that `blend_work` counts for a tile's block."""
    from fourdgs_tpu_torch.tools.profile_blend_split import blend_work
    binned, table, cfg = _inputs(cuda, "ragged", ts, tile_cap=96, chunk=6)
    out, cot = _backward_inputs(cuda, binned, table, cfg)
    args = (binned.gidx, binned.counts, table, *out, *cot, cfg)
    tally = torch.zeros(3, dtype=torch.int64, device=cuda)
    got = blend.blend_backward_slots(*args, tally=tally)
    ref = blend.blend_backward_slots(*args)
    occupied = _occupied(binned.counts, cfg)
    assert torch.equal(got[occupied], ref[occupied])
    tally2 = torch.zeros(3, dtype=torch.int64, device=cuda)
    blend.blend_backward(*args, tally=tally2)
    stored, batches, chunks = tally.tolist()
    assert batches == int(tally2[1]) > 0
    assert stored == 5 * int(occupied.sum())
    walked = blend_work(binned.gidx, binned.counts, table, cfg)
    subs = (ts // 16) * (ts // 8)
    assert chunks == subs * walked["block_chunks"]["tile"] >= int(tally2[2])


@pytest.mark.gpu
def test_blend_slots_kernel_refuses_what_it_cannot_take(cuda):
    """K3 takes K2's inputs: chunks up to 512 and tile sizes 16 and 32."""
    before = blend.blend_backward_slots.launches
    binned, table, cfg = _inputs(cuda, "random", 16, 1024, 1024)
    out, cot = _backward_inputs(cuda, binned, table, cfg)
    with pytest.raises(ValueError, match="chunk 1024"):
        blend.blend_backward_slots(binned.gidx, binned.counts, table, *out,
                                   *cot, cfg)
    cfg8 = RasterConfig(img_width=W, img_height=H, tile_size=8,
                        tile_cap=128, chunk=8)
    binned, table, _ = _inputs(cuda, "random", 8)
    out = blend.blend_forward_plain(binned.gidx, binned.counts, table, cfg8)
    cot = [torch.zeros_like(x) for x in out]
    with pytest.raises(ValueError, match="tile_size 16 or 32"):
        blend.blend_backward_slots(binned.gidx, binned.counts, table, *out,
                                   *cot, cfg8)
    assert blend.blend_backward_slots.launches == before


@pytest.mark.gpu
def test_blend_switches_select_k3_and_k4(cuda, monkeypatch):
    """One differentiable blend under FOURDGS_PALLAS_NO_FUSED_BWD and
    FOURDGS_PALLAS_GRAD_SCATTER runs K3 and K4 and gives K2's gradients."""
    binned, table, cfg = _inputs(cuda, "random", 16)
    leaves = [table[:-1, a:b].clone().requires_grad_(True)
              for a, b in ((0, 2), (2, 5), (5, 8), (8, 9), (9, 10))]

    def grads():
        color, depth, t = blend.blend(binned.gidx, binned.counts, leaves[0],
                                      leaves[1], leaves[2], leaves[3][:, 0],
                                      leaves[4][:, 0], cfg)
        loss = (color ** 2).mean() + 0.1 * depth.mean() + (t ** 2).mean()
        return torch.autograd.grad(loss, leaves)

    fused = grads()
    monkeypatch.setenv("FOURDGS_PALLAS_NO_FUSED_BWD", "1")
    monkeypatch.setenv("FOURDGS_PALLAS_GRAD_SCATTER", "1")
    k3, k4 = blend.blend_backward_slots.launches, scatter_add_rows.launches
    slots = grads()
    torch.cuda.synchronize()
    assert blend.blend_backward_slots.launches == k3 + 1
    assert scatter_add_rows.launches == k4 + 1
    for i, (a, b) in enumerate(zip(slots, fused)):
        _normalised_close(a, b, f"leaf {i}")


@pytest.mark.gpu
@pytest.mark.parametrize("m,w,n_out", [(5000, 10, 37), (100_000, 32, 4096),
                                       (7, 3, 1)])
def test_scatter_add_rows_kernel_matches_plain(cuda, m, w, n_out):
    """Duplicate indices, and indices below 0 and past n_out (clamped to
    the first and the sacrificial last row); max |a - b| / max |b| 1e-5."""
    rng = np.random.default_rng(m)
    idx = torch.from_numpy(rng.integers(-3, n_out + 5, m).astype(np.int32))
    rows = torch.from_numpy(rng.normal(size=(m, w)).astype(np.float32))
    rows[::7] = 0.0
    before = scatter_add_rows.launches
    got = scatter_add_rows(idx.to(cuda), rows.to(cuda), n_out=n_out)
    torch.cuda.synchronize()
    assert scatter_add_rows.launches == before + 1
    ref = scatter_add_rows_plain(idx, rows, n_out=n_out)
    assert got.shape == ref.shape == (n_out, w)
    err = float((got.cpu() - ref).abs().max()) / float(ref.abs().max())
    assert err <= 1e-5, err


@pytest.mark.gpu
def test_scatter_set_scalars_kernel_matches_plain(cuda):
    """Unique indices, some past n_out (dropped), -1 where unwritten:
    equal."""
    rng = np.random.default_rng(5)
    n_out = 100_000
    idx = rng.permutation(n_out + 20_000)[:60_000].astype(np.int32)
    val = rng.integers(0, 10 ** 6, len(idx)).astype(np.int32)
    before = scatter_set_scalars.launches
    got = scatter_set_scalars(torch.from_numpy(idx).to(cuda),
                              torch.from_numpy(val).to(cuda), n_out=n_out)
    torch.cuda.synchronize()
    assert scatter_set_scalars.launches == before + 1
    ref = scatter_set_scalars_plain(torch.from_numpy(idx),
                                    torch.from_numpy(val), n_out=n_out)
    assert torch.equal(got.cpu(), ref)
    assert int((ref == -1).sum()) > 0


@pytest.mark.gpu
def test_binner_switch_runs_k5(cuda, monkeypatch):
    """FOURDGS_BIN_SCATTER=pallas gives the binner's gidx equal to the
    default's, through K5, tile-cap drops included."""
    ref, _, _ = _inputs(cuda, "random", 16, 16, 8, n=900, seed=1)
    assert int(ref.overflow.sum()) > 0
    monkeypatch.setenv("FOURDGS_BIN_SCATTER", "pallas")
    before = scatter_set_scalars.launches
    got, _, _ = _inputs(cuda, "random", 16, 16, 8, n=900, seed=1)
    assert scatter_set_scalars.launches == before + 1
    assert torch.equal(got.gidx, ref.gidx)


def _runs_idx(pattern, m, n_out, rng):
    """K4's run-heavy patterns: each tile of 768 slots a random head and a
    -1 tail sent to the sacrificial row (the blend reduction); a random
    head and a constant tail of a third of the rows (the buffer's dead
    slots in one HexPlane cell); sorted runs of random length."""
    if pattern == "tile tail":
        idx = np.full(m, n_out - 1)
        for start in range(0, m, 768):
            used = min(int(rng.integers(0, 400)), m - start)
            idx[start:start + used] = rng.integers(0, n_out - 1, used)
        return idx
    if pattern == "dead tail":
        idx = rng.integers(0, n_out, m)
        idx[2 * m // 3:] = int(rng.integers(0, n_out))
        return idx
    assert pattern == "sorted runs"
    return np.sort(rng.integers(0, n_out, m))


def _dyadic_rows(rng, m, w):
    """Rows of multiples of 1/8 up to 8 in magnitude: every partial sum is
    exact in float32, so any order of the atomics gives the same table."""
    return torch.from_numpy((rng.integers(-64, 65, (m, w)) / 8.0)
                            .astype(np.float32))


@pytest.mark.gpu
@pytest.mark.parametrize("pattern", ["tile tail", "dead tail", "sorted runs"])
@pytest.mark.parametrize("w", [1, 3, 10, 16, 32, 128])
def test_scatter_add_rows_kernel_on_runs(cuda, w, pattern):
    """Runs of one index that cross warps and blocks, at every vector
    width (4, 2 and 1 floats an atomic): exact with dyadic rows, and
    within max |a - b| / max |b| 1e-5 with normal ones."""
    rng = np.random.default_rng(w)
    m, n_out = (60_000 if w <= 32 else 12_000), 997
    idx = torch.from_numpy(_runs_idx(pattern, m, n_out, rng).astype(np.int32))
    rows = _dyadic_rows(rng, m, w)
    rows[::11] = 0.0
    before = scatter_add_rows.launches
    got = scatter_add_rows(idx.to(cuda), rows.to(cuda), n_out=n_out)
    torch.cuda.synchronize()
    assert scatter_add_rows.launches == before + 1
    assert torch.equal(got.cpu(), scatter_add_rows_plain(idx, rows,
                                                         n_out=n_out))
    rows = torch.from_numpy(rng.normal(size=(m, w)).astype(np.float32))
    got = scatter_add_rows(idx.to(cuda), rows.to(cuda), n_out=n_out).cpu()
    ref = scatter_add_rows_plain(idx, rows, n_out=n_out)
    err = float((got - ref).abs().max()) / float(ref.abs().max())
    assert err <= 1e-5, err


@pytest.mark.gpu
@pytest.mark.parametrize("w,offset", [(16, 1), (16, 2), (10, 1), (32, 3)])
def test_scatter_add_rows_kernel_misaligned_rows(cuda, w, offset):
    """A row view whose base is 4 or 8 bytes past a 16-byte boundary takes
    the narrower vectors: exact with dyadic rows."""
    rng = np.random.default_rng(offset)
    m, n_out = 20_000, 300
    idx = torch.from_numpy(_runs_idx("tile tail", m, n_out, rng)
                           .astype(np.int32))
    flat = _dyadic_rows(rng, 1, m * w + offset).reshape(-1)
    rows = flat.to(cuda)[offset:].view(m, w)
    assert rows.data_ptr() % 16 != 0
    got = scatter_add_rows(idx.to(cuda), rows, n_out=n_out)
    ref = scatter_add_rows_plain(idx, flat[offset:].view(m, w), n_out=n_out)
    assert torch.equal(got.cpu(), ref)


@pytest.mark.gpu
def test_scatter_add_rows_kernel_edges(cuda):
    """m = 0 gives a zero table; n_out = 1 sends every row, below 0 and
    past the end included, to row 0."""
    got = scatter_add_rows(torch.zeros(0, dtype=torch.int32, device=cuda),
                           torch.zeros((0, 10), device=cuda), n_out=7)
    assert torch.equal(got.cpu(), torch.zeros(7, 10))
    rng = np.random.default_rng(1)
    idx = torch.from_numpy(rng.integers(-5, 5, 5000).astype(np.int32))
    rows = _dyadic_rows(rng, 5000, 12)
    got = scatter_add_rows(idx.to(cuda), rows.to(cuda), n_out=1)
    assert torch.equal(got.cpu(), rows.sum(0, keepdim=True))


@pytest.mark.gpu
def test_scatter_add_rows_kernel_nan_stays_in_its_row(cuda):
    """A NaN only in rows sent to the sacrificial row: that row's columns
    are NaN where the plain version's are, every other row within 1e-5."""
    rng = np.random.default_rng(3)
    m, w, n_out = 30_000, 10, 500
    idx = torch.from_numpy(_runs_idx("tile tail", m, n_out, rng)
                           .astype(np.int32))
    rows = torch.from_numpy(rng.normal(size=(m, w)).astype(np.float32))
    last = torch.nonzero(idx == n_out - 1).reshape(-1)
    rows[last[::97], 3] = float("nan")
    got = scatter_add_rows(idx.to(cuda), rows.to(cuda), n_out=n_out).cpu()
    ref = scatter_add_rows_plain(idx, rows, n_out=n_out)
    assert torch.equal(got.isnan(), ref.isnan())
    assert bool(got[-1, 3].isnan()) and int(got.isnan().sum()) == 1
    err = float((got[:-1] - ref[:-1]).abs().max()) / float(
        ref[:-1].abs().max())
    assert err <= 1e-5, err


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["odd m", "both offset 1", "offsets 1 and 2",
                                  "empty", "all dropped"])
def test_scatter_set_scalars_kernel_edges(cuda, case):
    """A length no multiple of four, views whose bases share or do not
    share their offset within 16 bytes, m = 0 and every index dropped:
    equal to the plain version."""
    rng = np.random.default_rng(len(case))
    n_out = 50_000
    m = {"odd m": 30_003, "empty": 0}.get(case, 30_001)
    hi = 2 * n_out if case == "all dropped" else n_out + 9_000
    lo = n_out if case == "all dropped" else 0
    idx = lo + rng.permutation(hi - lo)[:m]
    if case == "all dropped":
        idx[::2] = -1 - idx[::2]
    off_i, off_v = {"both offset 1": (1, 1),
                    "offsets 1 and 2": (1, 2)}.get(case, (0, 0))
    idx = torch.from_numpy(np.concatenate([np.zeros(off_i), idx])
                           .astype(np.int32))
    val = torch.from_numpy(rng.integers(0, 10 ** 6, m + off_v)
                           .astype(np.int32))
    i_dev, v_dev = idx.to(cuda)[off_i:], val.to(cuda)[off_v:]
    got = scatter_set_scalars(i_dev, v_dev, n_out=n_out).cpu()
    ref = scatter_set_scalars_plain(idx[off_i:], val[off_v:], n_out=n_out)
    assert torch.equal(got, ref)
    if case in ("empty", "all dropped"):
        assert bool((got == -1).all())


# ---------------------------------------------------------------------------
# D1-D6: the kernels of the dev tools (fourdgs_tpu_torch/tools), which port
# the Pallas prototypes of scripts/. D1, D2, D4a and D4b are exact; D6 sums
# in another association than its plain version, rtol 1e-5.
# ---------------------------------------------------------------------------

@pytest.mark.gpu
@pytest.mark.parametrize("rows,w,m", [(1000, 16, 70_000), (37, 4, 999),
                                      (300, 12, 5000), (200, 128, 3001),
                                      (5, 3, 64)])
def test_gather_rows_kernel_matches_plain(cuda, rows, w, m):
    """Indices below 0 and past the table clamp to its first and last
    rows: equal, at row widths of 1, 4 and 32 float4s (the width-templated
    kernel) and 3 (the generic one). A width that is no multiple of 4
    raises, launching nothing."""
    rng = np.random.default_rng(rows)
    table = torch.from_numpy(rng.normal(size=(rows, w)).astype(np.float32))
    idx = torch.from_numpy(rng.integers(-3, rows + 3, m).astype(np.int32))
    before = gather_rows.launches
    if w % 4:
        with pytest.raises(ValueError, match="W % 4"):
            gather_rows(table.to(cuda), idx.to(cuda))
        assert gather_rows.launches == before
        return
    got = gather_rows(table.to(cuda), idx.to(cuda))
    torch.cuda.synchronize()
    assert gather_rows.launches == before + 1
    assert torch.equal(got.cpu(), gather_rows_plain(table, idx))


def _rect_inputs(n, g, nt, grid_x, max_side, seed):
    """Rects of up to max_side^2 pairs, some empty (sx 0), some reaching
    past the grid's last row (tiles >= nt), slot0 per chunk."""
    rng = np.random.default_rng(seed)
    sx = rng.integers(0, max_side + 1, n).astype(np.int32)
    sy = rng.integers(1, max_side + 1, n).astype(np.int32)
    x0 = rng.integers(0, grid_x, n).astype(np.int32)
    y0 = rng.integers(0, nt // grid_x, n).astype(np.int32)
    touched = np.where(sx > 0, sx * sy, 0)
    off = np.concatenate([[0], np.cumsum(touched)])[:-1]
    slot0 = (off - np.repeat(off[::g], g)).astype(np.int32)
    gid = rng.permutation(n).astype(np.int32)
    return [torch.from_numpy(a.reshape(n // g, 1, g))
            for a in (x0, y0, sx, sy, slot0, gid)]


@pytest.mark.gpu
@pytest.mark.parametrize("n,g,pc,nt,grid_x,tile_cap,side", [
    (131_072, 4096, 16384, 625, 25, 1536, 3),   # the script's shapes
    (16_384, 4096, 6000, 625, 25, 40, 3),       # past pc and tile_cap
    (3000, 1000, 50_000, 4096, 64, 300, 9),     # long rects, big grid
    (20_000, 4000, 40_000, 21_463, 169, 64, 4),  # the walk's two groups
    (20_000, 4000, 40_000, 56_956, 491, 64, 4),  # one group, MAX_TILES
])
def test_expand_rank_kernel_matches_plain(cuda, n, g, pc, nt, grid_x,
                                          tile_cap, side):
    """Serial ranks across segments and chunks, pairs past pc, ranks past
    tile_cap, empty rects and tiles past the grid: equal, and the same
    from run to run."""
    arrays = _rect_inputs(n, g, nt, grid_x, side, n)
    kw = dict(pc=pc, n_tiles=nt, grid_x=grid_x, tile_cap=tile_cap)
    ref = expand_rank_plain(*arrays, **kw)
    before = expand_rank.launches
    got = expand_rank(*(a.to(cuda) for a in arrays), **kw)
    again = expand_rank(*(a.to(cuda) for a in arrays), **kw)
    torch.cuda.synchronize()
    assert expand_rank.launches == before + 2
    assert torch.equal(got.cpu(), ref)
    assert torch.equal(again, got)


@pytest.mark.gpu
@pytest.mark.parametrize("m,n_out", [(262_144, 960_000), (50_000, 777),
                                     (3, 1), (0, 1000), (5000, 1),
                                     (1 << 22, 960_000)])
def test_scalar_store_kernel_matches_plain(cuda, m, n_out):
    """Repeated indices (the last store wins) and indices outside
    [0, n_out) (dropped): equal."""
    rng = np.random.default_rng(m)
    idx = torch.from_numpy(rng.integers(-5, n_out + 5, m).astype(np.int32))
    val = torch.from_numpy(rng.integers(0, 1 << 20, m).astype(np.int32))
    before = scalar_store.launches
    got = scalar_store(idx.to(cuda), val.to(cuda), n_out=n_out)
    torch.cuda.synchronize()
    assert scalar_store.launches == before + 1
    assert torch.equal(got.cpu(), scalar_store_plain(idx, val, n_out=n_out))


@pytest.mark.gpu
@pytest.mark.parametrize("m,nt,tile_cap,n_out", [
    (262_144, 625, 1536, 960_000),   # the script's shapes
    (40_000, 8, 1536, 5000),         # the clamp to n_out - 1
    (9000, 3, 1000, 2500),           # ranks past tile_cap, then the clamp
    (262_144, 8160, 8, 50_000),      # four groups past 48 KB
    (262_144, 56_956, 8, 400_000),   # one group, MAX_TILES
])
def test_tile_counter_store_kernel_matches_plain(cuda, m, nt, tile_cap,
                                                 n_out):
    """Serial ranks, the clamp, the last write winning, tile ids outside
    [0, n_tiles) (dropped): equal outputs and counters."""
    rng = np.random.default_rng(m)
    tid = torch.from_numpy(rng.integers(-1, nt + 1, m).astype(np.int32))
    val = torch.from_numpy(rng.integers(0, 1 << 20, m).astype(np.int32))
    kw = dict(n_tiles=nt, tile_cap=tile_cap, n_out=n_out)
    before = tile_counter_store.launches
    out, cnt = tile_counter_store(tid.to(cuda), val.to(cuda), **kw)
    torch.cuda.synchronize()
    assert tile_counter_store.launches == before + 1
    ref_out, ref_cnt = tile_counter_store_plain(tid, val, **kw)
    assert torch.equal(cnt.cpu(), ref_cnt)
    assert torch.equal(out.cpu(), ref_out)


@pytest.mark.gpu
@pytest.mark.parametrize("body", blend_variants.BODIES)
@pytest.mark.parametrize("nt,p", [(300, 256), (7, 100), (2, 1024)])
def test_blend_variant_kernel_matches_plain(cuda, body, nt, p):
    rng = np.random.default_rng(nt)
    attrs = torch.from_numpy(rng.uniform(
        0, 1, (nt, 3 * blend_variants.CHUNK, 16)).astype(np.float32))
    px = torch.from_numpy(rng.uniform(0, 1, (nt, 1, p)).astype(np.float32))
    fn = getattr(blend_variants, body)
    before = fn.launches
    got = fn(attrs.to(cuda), px.to(cuda))
    torch.cuda.synchronize()
    assert fn.launches == before + 1
    ref = getattr(blend_variants, body + "_plain")(attrs, px)
    assert got.shape == ref.shape == (nt, 1, p)
    err = float((got.cpu() - ref).abs().max()) / float(ref.abs().max())
    assert err <= 1e-5, err


@pytest.mark.gpu
@pytest.mark.parametrize("case,nt,nch,p", [
    ("the script's shape", 2504, 24, 256),
    ("one tile", 1, 24, 256),
    ("100 pixels", 64, 5, 100),
    ("1,000 pixels", 50, 5, 1000),
    ("one chunk", 9, 1, 256),
    ("past one resident wave", 4000, 2, 256),
])
@pytest.mark.parametrize("body", blend_variants.BODIES)
def test_blend_variant_kernel_at_shapes(cuda, body, case, nt, nch, p):
    """The script's full shape (24 chunks through a two-stage ring), a lone
    tile, pixel counts that fill no whole thread's pixels, fewer chunks
    than the ring's stages, and more tiles than the card holds at once:
    within 1e-5 of the largest magnitude of the plain version on the
    card."""
    rng = np.random.default_rng(nt + p)
    attrs = torch.from_numpy(rng.uniform(
        0, 1, (nt, nch * blend_variants.CHUNK, 16)).astype(np.float32)).to(
            cuda)
    px = torch.from_numpy(rng.uniform(0, 1, (nt, 1, p)).astype(
        np.float32)).to(cuda)
    fn = getattr(blend_variants, body)
    before = fn.launches
    got = fn(attrs, px)
    torch.cuda.synchronize()
    assert fn.launches == before + 1
    ref = getattr(blend_variants, body + "_plain")(attrs, px)
    assert got.shape == ref.shape == (nt, 1, p)
    err = float((got - ref).abs().max()) / float(ref.abs().max())
    assert err <= 1e-5, err


@pytest.mark.gpu
def test_scalar_store_kernel_all_pairs_on_one_element(cuda):
    """100,000 stores on element 7 of 50: the last one wins, the rest of
    the table stays 0, and a second call gives the same table."""
    rng = np.random.default_rng(7)
    idx = torch.full((100_000,), 7, dtype=torch.int32)
    val = torch.from_numpy(rng.integers(1, 1 << 20, 100_000).astype(np.int32))
    got = scalar_store(idx.to(cuda), val.to(cuda), n_out=50)
    again = scalar_store(idx.to(cuda), val.to(cuda), n_out=50)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), scalar_store_plain(idx, val, n_out=50))
    assert int(got[7]) == int(val[-1])
    assert int(got.count_nonzero()) == 1
    assert torch.equal(again, got)


@pytest.mark.gpu
def test_dev_kernels_refuse_what_they_cannot_take(cuda):
    counts = [fn.launches for fn in (gather_rows, blend_variants.slices)]
    with pytest.raises(ValueError, match="16-byte"):
        gather_rows(torch.zeros(4, 3, device=cuda),
                    torch.zeros(2, dtype=torch.int32, device=cuda))
    with pytest.raises(ValueError, match="chunk 32"):
        blend_variants.slices(torch.zeros(2, 48, 16, device=cuda),
                              torch.zeros(2, 8, device=cuda), chunk=16)
    with pytest.raises(ValueError, match="pixels"):
        blend_variants.slices(torch.zeros(2, 64, 16, device=cuda),
                              torch.zeros(2, 2048, device=cuda))
    with pytest.raises(ValueError, match="n_tiles"):
        tile_counter_store(torch.zeros(2, dtype=torch.int32, device=cuda),
                           torch.zeros(2, dtype=torch.int32, device=cuda),
                           n_tiles=MAX_TILES + 1, tile_cap=4, n_out=8)
    assert counts == [fn.launches for fn in (gather_rows,
                                             blend_variants.slices)]


# ---------------------------------------------------------------------------
# The binner kernel (csrc/binner.cu: D2's rank at the binner's contract) and
# D1 as the HexPlane's forward gather, both on the main path.
# ---------------------------------------------------------------------------

def _proj_fields(n, n_visible, grid, ts, max_side, seed, far=False):
    """A projection of n gaussians, the first n_visible touching tile
    rects of up to max_side tiles a side (clipped to the grid), centres
    near their rects (or far up and left of them), corner-cull radii from
    none to past the rect, and distinct depths."""
    rng = np.random.default_rng(seed)
    gx, gy = grid
    x0 = rng.integers(0, gx, n)
    y0 = rng.integers(0, gy, n)
    x1 = np.minimum(x0 + rng.integers(1, max_side + 1, n), gx)
    y1 = np.minimum(y0 + rng.integers(1, max_side + 1, n), gy)
    touched = (x1 - x0) * (y1 - y0)
    touched[n_visible:] = 0
    x1 = np.where(touched > 0, x1, x0)
    y1 = np.where(touched > 0, y1, y0)
    pix = np.stack([(x0 + x1) * ts / 2, (y0 + y1) * ts / 2], 1)
    pix = pix + rng.normal(0, ts / 2, (n, 2))
    if far:
        pix[:] = -200.0
    r2 = rng.integers(0, (ts * max_side) ** 2, n)
    r2[rng.random(n) < 0.2] = 1 << 30
    if far:
        r2[:] = 0
    return dict(
        pix=pix.astype(np.float32),
        depth=(rng.permutation(n) + 1.0).astype(np.float32),
        conic=np.ones((n, 3), np.float32),
        radius=np.where(touched > 0, 8, 0).astype(np.int32),
        rect_min=np.stack([x0, y0], 1).astype(np.int32),
        rect_max=np.stack([x1, y1], 1).astype(np.int32),
        tiles_touched=touched.astype(np.int32),
        cull_r2=r2.astype(np.int32))


# name -> (n, n_visible, image side or (width, height), tile, max_side,
#          tile_cap, bin_chunk,
#          bin_pairs_per_chunk, far)
BIN_CASES = {
    "drop_free": (3000, 2500, 96, 16, 3, 256, 4096, 32768, False),
    "budget_straddled": (3000, 3000, 96, 16, 4, 512, 1024, 2000, False),
    "tile_overflow": (5000, 4000, 96, 16, 3, 40, 4096, 32768, False),
    "every_pair_culled": (2000, 2000, 96, 16, 3, 64, 4096, 32768, True),
    "no_visible_gaussian": (700, 0, 96, 16, 3, 64, 4096, 32768, False),
    "segments_and_blocks": (40_000, 39_000, 800, 32, 5, 768, 4096, 18432,
                            False),
    # phase 5's step: 100,000 live gaussians in a 131,072-slot buffer at
    # 800x800, tile 32, tile_cap 768, the probed budget
    "phase 5's step": (131_072, 100_000, 800, 32, 4, 768, 4096, 36864, False),
    # grids past the 48 KB of static shared memory, one for each layout of
    # the walk's counters (rank_common.cuh: walk_groups): four sets at
    # 96 x 85 tiles, two at a 2704 x 2028 DyNeRF view (169 x 127), one at
    # MAX_TILES (491 x 116)
    "8,160 tiles": (40_000, 38_000, (1536, 1360), 16, 4, 64, 4096, 32768,
                    False),
    "21,463 tiles": (40_000, 38_000, (2704, 2028), 16, 4, 64, 4096, 32768,
                     False),
    "56,956 tiles": (40_000, 38_000, (7856, 1856), 16, 4, 64, 4096, 32768,
                     False),
}


def _bin_case(dev, case):
    n, vis, side, ts, max_side, cap, bchunk, bpc, far = BIN_CASES[case]
    width, height = side if isinstance(side, tuple) else (side, side)
    cfg = RasterConfig(img_width=width, img_height=height, tile_size=ts,
                       tile_cap=cap, chunk=32, bin_chunk=bchunk,
                       bin_pairs_per_chunk=bpc)
    fields = _proj_fields(n, vis, (cfg.grid_x, cfg.grid_y), ts, max_side,
                          n, far)
    proj = Projected(**{k: torch.from_numpy(v).to(dev)
                        for k, v in fields.items()})
    return proj, cfg


def _assert_binned_equal(got, want):
    for f in rasterize_tiled.BinnedTiles._fields:
        a, b = getattr(got, f), getattr(want, f)
        if f == "slots":
            assert (a is None) == (b is None), f
            for g, w in zip(a or (), b or ()):
                assert g.dtype == w.dtype == torch.int32, f
                assert torch.equal(g, w), f
            continue
        assert a.dtype == b.dtype == torch.int32, f
        assert a.shape == b.shape, f
        assert torch.equal(a, b), f


@pytest.mark.gpu
@pytest.mark.parametrize("switch", ["default", "pallas", "slots"])
@pytest.mark.parametrize("case", list(BIN_CASES))
def test_binner_kernel_matches_plain(cuda, monkeypatch, case, switch):
    """Every BinnedTiles field equal to the plain binner's on the same
    card tensors, with the budget straddled, tiles past their cap, every
    pair culled, no visible gaussian, at phase 5's shape and on grids of
    up to MAX_TILES tiles; under
    FOURDGS_BIN_SCATTER=pallas through K5; with the BlendSlots (the
    budget slots' rows, then K5). The same twice."""
    if switch == "pallas":
        monkeypatch.setenv("FOURDGS_BIN_SCATTER", "pallas")
    slots = switch == "slots"
    proj, cfg = _bin_case(cuda, case)
    before = (rasterize_tiled.bin_tiles.launches,
              scatter_set_scalars.launches)
    got = rasterize_tiled.bin_gaussians_count(proj, cfg, slots)
    again = rasterize_tiled.bin_gaussians_count(proj, cfg, slots)
    torch.cuda.synchronize()
    assert rasterize_tiled.bin_tiles.launches == before[0] + 2
    assert scatter_set_scalars.launches == before[1] + (
        0 if switch == "default" else 2)
    want = rasterize_tiled.bin_gaussians_count_plain(proj, cfg, slots)
    assert (got.slots is None) == (not slots)
    _assert_binned_equal(got, want)
    _assert_binned_equal(again, got)
    if case == "budget_straddled":
        assert int(got.dropped_pairs) > 0
    if case == "tile_overflow":
        assert int(got.dropped_tile) > 0
    if case in ("every_pair_culled", "no_visible_gaussian"):
        assert int(got.counts.sum()) == 0
        assert bool((got.gidx == -1).all())
    if case == "phase 5's step":
        assert int(got.counts.sum()) > 100_000
    if case.endswith(" tiles"):
        assert cfg.num_tiles == int(case.split()[0].replace(",", ""))
        assert cfg.num_tiles <= MAX_TILES
        assert int(got.counts.sum()) > 100_000


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["segments_and_blocks", "8,160 tiles",
                                  "21,463 tiles", "56,956 tiles"])
def test_binner_kernel_replays_in_a_graph(cuda, case):
    """The binner captured in a CUDA graph (static shapes, no host sync)
    and replayed on new depths and rects gives what an eager call gives,
    also where the walk raises its shared-memory limit during capture."""
    proj, cfg = _bin_case(cuda, case)
    fresh = Projected(**{k: v.clone() for k, v in proj._asdict().items()})
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            rasterize_tiled.bin_gaussians_count(proj, cfg)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = rasterize_tiled.bin_gaussians_count(proj, cfg)
    rng = np.random.default_rng(3)
    for _ in range(2):
        perm = torch.from_numpy(rng.permutation(proj.depth.shape[0])).to(
            cuda)
        for name, v in fresh._asdict().items():
            getattr(proj, name).copy_(v[perm])
        graph.replay()
        torch.cuda.synchronize()
        _assert_binned_equal(out, rasterize_tiled.bin_gaussians_count(proj,
                                                                      cfg))


# the HexPlane's gathers at the D-NeRF width: planes of 64 x 64 and
# 128 x 128 rows (the two levels), a time plane's lerped row of 64 or 128,
# rows of 32 floats; 131,072 indices a step, 100,000 a frame
HEX_GATHERS = [(rows, m) for rows in (4096, 16384, 64, 128)
               for m in (131_072, 100_000)]


@pytest.mark.gpu
@pytest.mark.parametrize("rows,m", HEX_GATHERS)
def test_gather_rows_kernel_at_hexplane_shapes(cuda, rows, m):
    rng = np.random.default_rng(rows + m)
    table = torch.from_numpy(rng.normal(size=(rows, 32)).astype(
        np.float32)).to(cuda)
    idx = torch.from_numpy(rng.integers(0, rows, m).astype(np.int32)).to(
        cuda)
    before = gather_rows.launches
    got = gather_rows(table, idx)
    torch.cuda.synchronize()
    assert gather_rows.launches == before + 1
    assert torch.equal(got, torch.index_select(table, 0, idx))


@pytest.mark.gpu
@pytest.mark.parametrize("t", ["scalar", "point"])
def test_hexplane_forward_on_card_matches_cpu(cuda, t):
    """The D-NeRF HexPlane (two levels, 32 features) on the card, its
    gathers through D1, against the CPU path: the features equal, the
    planes' gradients within 1e-5 of each plane's largest magnitude."""
    cfg = HexPlaneConfig(resolution=(64, 64, 64, 25), out_dim=32,
                         multires=(1, 2))
    cpu = HexPlaneField(cfg, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        for p in cpu.planes.values():
            p.add_(torch.randn(p.shape, generator=torch.Generator()
                               .manual_seed(p.numel())) * 0.3)
    card = HexPlaneField(cfg).to(cuda)
    card.load_state_dict(cpu.state_dict())
    rng = np.random.default_rng(1)
    n = 20_000
    pts = torch.from_numpy(rng.uniform(-1.2, 1.2, (n, 3)).astype(np.float32))
    tt = (torch.tensor(0.37) if t == "scalar" else torch.from_numpy(
        rng.uniform(0, 1, n).astype(np.float32)))
    w = torch.from_numpy(rng.normal(size=(n, 64)).astype(np.float32))
    before = gather_rows.launches
    got = card(pts.to(cuda), tt.to(cuda))
    torch.cuda.synchronize()
    assert gather_rows.launches == before + (36 if t == "scalar" else 48)
    want = cpu(pts, tt)
    assert torch.equal(got.detach().cpu(), want.detach())
    (got * w.to(cuda)).sum().backward()
    (want * w).sum().backward()
    for key, p in cpu.planes.items():
        a, b = card.planes[key].grad.cpu(), p.grad
        err = float((a - b).abs().max()) / float(b.abs().max())
        assert err <= 1e-5, (key, err)


def _lpips_params(rng, net):
    """Random weights in the npz layout of ops/lpips.py (the shapes of
    torchvision's VGG16 and AlexNet convolutions)."""
    from fourdgs_tpu_torch.ops import lpips
    if net == "vgg":
        widths = (64, 64, 128, 128, 256, 256, 256, 512, 512, 512, 512, 512,
                  512)
        convs = list(zip((3,) + widths[:-1], widths, [3] * 13))
        channels = lpips.VGG_CHANNELS
    else:
        convs = [(3, 64, 11), (64, 192, 5), (192, 384, 3), (384, 256, 3),
                 (256, 256, 3)]
        channels = lpips.ALEX_CHANNELS
    params = {}
    for i, (cin, cout, k) in enumerate(convs):
        params[f"conv{i}/w"] = (rng.normal(size=(cout, cin, k, k))
                                * 0.05).astype(np.float32)
        params[f"conv{i}/b"] = (rng.normal(size=(cout,))
                                * 0.1).astype(np.float32)
    for lvl, c in enumerate(channels):
        params[f"lin{lvl}/w"] = rng.uniform(0, 1, (c,)).astype(np.float32)
    return params


@pytest.mark.gpu
@pytest.mark.parametrize("net", ["vgg", "alex"])
def test_lpips_on_the_card_matches_the_cpu(cuda, net):
    """LPIPS (ops/lpips.py, cuDNN convolutions in full float32) on the
    card against the CPU on the same random weights and images: 1e-5
    relative."""
    from fourdgs_tpu_torch.ops.lpips import LPIPS
    rng = np.random.default_rng(0)
    model = LPIPS(_lpips_params(rng, net), net).eval()
    x = torch.from_numpy(rng.uniform(0, 1, (2, 3, 128, 128))
                         .astype(np.float32))
    y = (x + torch.from_numpy(rng.normal(0, 0.1, x.shape)
                              .astype(np.float32))).clamp(0, 1)
    saved = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True   # the model must not use it
    try:
        with torch.no_grad():
            want = model(x, y)
            got = model.to(cuda)(x.to(cuda), y.to(cuda)).cpu()
    finally:
        torch.backends.cudnn.allow_tf32 = saved
    assert bool((want > 0).all())
    torch.testing.assert_close(got, want, rtol=1e-5, atol=0)
