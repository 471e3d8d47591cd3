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

# the lists and counters; `slots` (BlendSlots, when asked for) has its own
# test in test_torch_reassociate.py
LIST_FIELDS = tuple(f for f in trt.BinnedTiles._fields if f != "slots")
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


# ---- the edges of the static contract, on hand-made projections ----
# W x H = 64 x 48 at tile 16: a 4 x 3 grid of 12 tiles

def _hand_proj(rect_min, rect_max, pix, cull_r2, depth=None, seed=0):
    """A projection with the given tile rects (exclusive max), centres and
    corner-cull radii, distinct depths, and the counts the projection
    derives from them (a rect of zero span touches nothing)."""
    rect_min = np.asarray(rect_min, np.int32)
    rect_max = np.asarray(rect_max, np.int32)
    n = rect_min.shape[0]
    spans = np.clip(rect_max - rect_min, 0, None)
    touched = (spans[:, 0] * spans[:, 1]).astype(np.int32)
    if depth is None:
        depth = np.random.default_rng(seed).permutation(n) + 1.0
    fields = dict(
        pix=np.asarray(pix, np.float32).reshape(n, 2),
        depth=np.asarray(depth, np.float32),
        conic=np.ones((n, 3), np.float32),
        radius=np.where(touched > 0, 8, 0).astype(np.int32),
        rect_min=rect_min, rect_max=rect_max, tiles_touched=touched,
        cull_r2=np.broadcast_to(np.asarray(cull_r2, np.int32),
                                (n,)).copy())
    return fields


def _bin_both(fields, tile_cap, bin_chunk, bin_pairs_per_chunk, chunk=8):
    from fourdgs_tpu.ops.projection import Projected as JProjected
    import jax.numpy as jnp
    kw = dict(img_width=W, img_height=H, tile_size=16, tile_cap=tile_cap,
              chunk=chunk, bin_chunk=bin_chunk,
              bin_pairs_per_chunk=bin_pairs_per_chunk)
    a = jrt.bin_gaussians_count(
        JProjected(**{k: jnp.asarray(v) for k, v in fields.items()}),
        jrt.RasterConfig(**kw))
    b = trt.bin_gaussians_count(
        tproj.Projected(**{k: torch.from_numpy(v) for k, v in
                           fields.items()}), trt.RasterConfig(**kw))
    for f in ("gidx", "counts", "overflow", "num_pairs", "dropped_pairs",
              "dropped_tile"):
        bv = getattr(b, f).numpy()
        assert bv.dtype == np.int32, f
        np.testing.assert_array_equal(bv, np.asarray(getattr(a, f)),
                                      err_msg=f)
    return b


def _edge_case(name):
    """(fields, tile_cap, bin_chunk, bin_pairs_per_chunk) of one edge."""
    big = 1 << 30
    if name == "straddles_the_budget":
        # six 2 x 2 rects: 24 pairs into 2 x 9 = 18 slots; the fifth in
        # depth order runs from slot 16 over the end
        rmin = [[0, 0], [1, 0], [2, 1], [0, 1], [1, 1], [2, 0]]
        rmax = [[x + 2, y + 2] for x, y in rmin]
        pix = [[16 * x + 16, 16 * y + 16] for x, y in rmin]
        return _hand_proj(rmin, rmax, pix, big), 64, 4, 9
    if name == "no_visible_gaussian":
        rmin = [[1, 1]] * 5
        return _hand_proj(rmin, rmin, [[30, 30]] * 5, big), 16, 4, 16
    if name == "every_pair_culled":
        # centres far up and left of their rects, no cull radius
        rmin = [[1, 0], [2, 1], [0, 1], [1, 1]]
        rmax = [[x + 2, y + 2] for x, y in rmin]
        return _hand_proj(rmin, rmax, [[-200, -200]] * 4, 0), 16, 4, 32
    if name == "one_tile_past_its_cap":
        # nine gaussians in tile (1, 1) alone at tile_cap 8, one elsewhere
        rmin = [[1, 1]] * 9 + [[3, 2]]
        rmax = [[2, 2]] * 9 + [[4, 3]]
        pix = [[24, 24]] * 9 + [[56, 40]]
        return _hand_proj(rmin, rmax, pix, big), 8, 16, 32
    if name == "every_gaussian_in_one_tile":
        rmin = [[2, 1]] * 20
        return (_hand_proj(rmin, [[3, 2]] * 20, [[40, 24]] * 20, big),
                32, 8, 24)
    raise KeyError(name)


EDGES = ("straddles_the_budget", "no_visible_gaussian", "every_pair_culled",
         "one_tile_past_its_cap", "every_gaussian_in_one_tile")


@pytest.mark.parametrize("case", EDGES)
def test_binner_edges_match_jax(case):
    fields, cap, bchunk, bpc = _edge_case(case)
    b = _bin_both(fields, cap, bchunk, bpc)
    counts, over = b.counts.numpy(), b.overflow.numpy()
    if case == "straddles_the_budget":
        assert int(b.dropped_pairs) == 24 - 18
        # the straddling gaussian keeps the two pairs inside the budget
        assert counts.sum() == 18
    elif case == "no_visible_gaussian":
        assert counts.sum() == 0 and int(b.num_pairs) == 0
        assert (b.gidx.numpy() == -1).all()
    elif case == "every_pair_culled":
        assert int(b.num_pairs) == 16 and counts.sum() == 0
        assert (b.gidx.numpy() == -1).all()
    elif case == "one_tile_past_its_cap":
        assert over[5] == 1 and over.sum() == 1 and counts[5] == cap
        assert int(b.dropped_tile) == 1
    else:
        assert counts[6] == 20 and counts.sum() == 20


def test_binner_has_static_shapes():
    """The binner runs on meta tensors, which refuse every operation whose
    output size depends on the data (repeat_interleave without an output
    size, boolean indexing, bincount): its shapes are static, so a CUDA
    graph can capture it."""
    n, cfg = 300, trt.RasterConfig(img_width=W, img_height=H, tile_size=16,
                                   tile_cap=64, chunk=8, bin_chunk=128,
                                   bin_pairs_per_chunk=512)
    meta = torch.device("meta")
    proj = tproj.Projected(
        pix=torch.empty((n, 2), device=meta),
        depth=torch.empty((n,), device=meta),
        conic=torch.empty((n, 3), device=meta),
        radius=torch.empty((n,), dtype=torch.int32, device=meta),
        rect_min=torch.empty((n, 2), dtype=torch.int32, device=meta),
        rect_max=torch.empty((n, 2), dtype=torch.int32, device=meta),
        tiles_touched=torch.empty((n,), dtype=torch.int32, device=meta),
        cull_r2=torch.empty((n,), dtype=torch.int32, device=meta))
    b = trt.bin_gaussians_count(proj, cfg)
    nt = cfg.num_tiles
    assert b.gidx.shape == (nt, 64) and b.gidx.device.type == "meta"
    assert b.counts.shape == (nt,) and b.overflow.shape == (nt,)
    for f in ("num_pairs", "dropped_pairs", "dropped_tile"):
        assert getattr(b, f).shape == ()
    assert b.slots is None
    assert all(x.dtype == torch.int32 for x in b if x is not None)
    slots = trt.bin_gaussians_count(proj, cfg, slots=True).slots
    n_chunks = -(-n // cfg.bin_chunk)
    assert slots.dest.shape == (n_chunks, cfg.bin_pairs_per_chunk)
    for x in slots[1:]:
        assert x.shape == (n_chunks * cfg.bin_chunk,)
    assert all(x.dtype == torch.int32 and x.device.type == "meta"
               for x in slots)


# ---- the binner kernel's decomposition (csrc/binner.cu), on the CPU ----
# The kernel ranks the items that `depth_ordered_items` prepares through
# rank_common.cuh; here the same items go through its Source (the budget
# clamp, the rect walk, the corner cull) written in PyTorch, the serial
# ranks of ops/serial.py:serial_ranks, and either Emit: the lists written
# in place, or each budget slot's (dest, src) scattered by K5's plain
# version (FOURDGS_BIN_SCATTER=pallas). Every field must equal the plain
# binner's and JAX's.

def _decomposed(proj, cfg, emit):
    from fourdgs_tpu_torch.ops.scatter import scatter_set_scalars_plain
    from fourdgs_tpu_torch.ops.serial import serial_ranks
    rows, ends, total_slots = trt.depth_ordered_items(proj, cfg)
    x0, y0, sx, touched, qx, qy, r2, gid = rows.long().unbind(1)
    nt, cap, ts = cfg.num_tiles, cfg.tile_cap, cfg.tile_size
    start = ends.long() - touched
    count = torch.clamp(torch.minimum(total_slots - start, touched), min=0)
    owner = torch.repeat_interleave(torch.arange(rows.shape[0]), count)
    j = torch.arange(owner.shape[0]) - (torch.cumsum(count, 0) - count)[owner]
    dy = torch.div(j, sx[owner], rounding_mode="floor")
    tx, ty = x0[owner] + j - dy * sx[owner], y0[owner] + dy
    ddx = torch.clamp(torch.maximum(tx * ts - qx[owner],
                                    qx[owner] - (tx * ts + ts - 1)) - 1,
                      0, trt._CULL_CLAMP)
    ddy = torch.clamp(torch.maximum(ty * ts - qy[owner],
                                    qy[owner] - (ty * ts + ts - 1)) - 1,
                      0, trt._CULL_CLAMP)
    tile = torch.where(ddx * ddx + ddy * ddy <= r2[owner], ty * cfg.grid_x
                       + tx, -1)
    rank, cnt = serial_ranks(tile, nt)
    ok = (rank >= 0) & (rank < cap)
    dest = torch.where(ok, tile * cap + rank, nt * cap)
    if emit == "lists":
        gidx = torch.full((nt * cap + 1,), -1, dtype=torch.int32)
        gidx[dest] = gid[owner].to(torch.int32)
        gidx = gidx[:-1]
    else:
        slot_dest = torch.full((total_slots,), nt * cap, dtype=torch.int32)
        slot_src = torch.zeros(total_slots, dtype=torch.int32)
        slot = start[owner] + j
        slot_dest[slot] = dest.to(torch.int32)
        slot_src[slot] = gid[owner].to(torch.int32)
        gidx = scatter_set_scalars_plain(slot_dest, slot_src, n_out=nt * cap)
    overflow = torch.clamp(cnt - cap, min=0)
    total = ends[-1] if rows.shape[0] else torch.tensor(0, dtype=torch.int32)
    return trt.BinnedTiles(
        gidx=gidx.reshape(nt, cap), counts=torch.clamp(cnt, max=cap),
        num_pairs=total.to(torch.int32),
        dropped_pairs=torch.clamp(total - total_slots, min=0).to(torch.int32),
        dropped_tile=overflow.sum().to(torch.int32),
        overflow=overflow.to(torch.int32))


def _case_inputs(case, proj):
    """(JAX projection, torch projection, keyword config) of a case of
    either table above."""
    from fourdgs_tpu.ops.projection import Projected as JProjected
    import jax.numpy as jnp
    if case in CASES:
        cap, chunk, bchunk, bpc = CASES[case]
        jp, tp = proj, _to_torch(proj)
    else:
        fields, cap, bchunk, bpc = _edge_case(case)
        chunk = 8
        jp = JProjected(**{k: jnp.asarray(v) for k, v in fields.items()})
        tp = tproj.Projected(**{k: torch.from_numpy(v)
                                for k, v in fields.items()})
    kw = dict(img_width=W, img_height=H, tile_size=16, tile_cap=cap,
              chunk=chunk, bin_chunk=bchunk, bin_pairs_per_chunk=bpc)
    return jp, tp, kw


@pytest.mark.parametrize("emit", ["lists", "slots"])
@pytest.mark.parametrize("case", list(CASES) + list(EDGES))
def test_kernel_decomposition_matches_plain_and_jax(proj, case, emit):
    jp, tp, kw = _case_inputs(case, proj)
    want = jrt.bin_gaussians_count(jp, jrt.RasterConfig(**kw))
    cfg = trt.RasterConfig(**kw)
    plain = trt.bin_gaussians_count_plain(tp, cfg)
    got = _decomposed(tp, cfg, emit)
    for f in LIST_FIELDS:
        g = getattr(got, f)
        assert g.dtype == torch.int32, f
        assert torch.equal(g, getattr(plain, f)), f
        np.testing.assert_array_equal(g.numpy(), np.asarray(getattr(want, f)),
                                      err_msg=f)
    rows, ends, total_slots = trt.depth_ordered_items(tp, cfg)
    assert rows.dtype == ends.dtype == torch.int32
    assert rows.shape == (tp.depth.shape[0], 8)
    if case in ("budget_drops", "straddles_the_budget"):
        start = ends - rows[:, 3]
        assert bool(((start < total_slots) & (ends > total_slots)).any())
    if case in ("tile_overflow", "one_tile_past_its_cap"):
        assert int(got.dropped_tile) > 0
    if case == "every_pair_culled":
        assert int(got.num_pairs) > 0 and int(got.counts.sum()) == 0


def test_binner_refuses_another_device():
    """The binner kernel takes CUDA tensors only: a call with CPU tensors
    raises instead of running the plain version in its place."""
    fields, cap, bchunk, bpc = _edge_case("straddles_the_budget")
    tp = tproj.Projected(**{k: torch.from_numpy(v) for k, v in
                            fields.items()})
    cfg = trt.RasterConfig(img_width=W, img_height=H, tile_size=16,
                           tile_cap=cap, bin_chunk=bchunk,
                           bin_pairs_per_chunk=bpc)
    before = trt.bin_tiles.launches
    with pytest.raises(ValueError, match="CUDA"):
        trt.bin_tiles(tp, cfg)
    assert trt.bin_tiles.launches == before


# The counting kernels' walk keeps four, two or one set of nt shared
# counters as the card's shared memory allows (csrc/rank_common.cuh:
# walk_groups): up to 14,239, 28,478 and 56,956 tiles (MAX_TILES) for the
# binner's items. One grid of each kind, at tile 16: 1536 x 1360 (96 x 85
# tiles), a 2704 x 2028 DyNeRF view (169 x 127) and 7856 x 1856 (491 x 116,
# the limit). Random rects up to 4 tiles a side, twelve gaussians on the
# grid's last tile past its cap of 8.
LARGE_GRIDS = {"8,160 tiles": (1536, 1360), "21,463 tiles": (2704, 2028),
               "56,956 tiles": (7856, 1856)}


def _large_grid_fields(width, height, n=400, seed=11):
    rng = np.random.default_rng(seed)
    gx, gy = -(-width // 16), -(-height // 16)
    x0, y0 = rng.integers(0, gx, n), rng.integers(0, gy, n)
    x0[-12:], y0[-12:] = gx - 1, gy - 1
    rmin = np.stack([x0, y0], 1)
    rmax = np.minimum(rmin + rng.integers(1, 5, (n, 2)), [gx, gy])
    pix = (rmin + rmax) * 8 + rng.normal(0, 8, (n, 2))
    r2 = np.where(rng.random(n) < 0.5, 1 << 30, rng.integers(0, 4096, n))
    return _hand_proj(rmin, rmax, pix, r2, seed=seed), gx * gy


@pytest.mark.parametrize("emit", ["lists", "slots"])
@pytest.mark.parametrize("grid", list(LARGE_GRIDS))
def test_large_tile_grids_match_plain_and_jax(grid, emit):
    """The kernel's decomposition, the plain binner and JAX's on grids
    that take each of the walk's counter layouts, up to MAX_TILES."""
    from fourdgs_tpu.ops.projection import Projected as JProjected
    import jax.numpy as jnp
    from fourdgs_tpu_torch.ops.serial import MAX_TILES
    width, height = LARGE_GRIDS[grid]
    fields, nt = _large_grid_fields(width, height)
    assert nt <= MAX_TILES
    kw = dict(img_width=width, img_height=height, tile_size=16, tile_cap=8,
              chunk=8, bin_chunk=4096, bin_pairs_per_chunk=8192)
    cfg = trt.RasterConfig(**kw)
    assert cfg.num_tiles == nt == int(grid.split()[0].replace(",", ""))
    tp = tproj.Projected(**{k: torch.from_numpy(v)
                            for k, v in fields.items()})
    want = jrt.bin_gaussians_count(
        JProjected(**{k: jnp.asarray(v) for k, v in fields.items()}),
        jrt.RasterConfig(**kw))
    plain = trt.bin_gaussians_count_plain(tp, cfg)
    got = _decomposed(tp, cfg, emit)
    for f in LIST_FIELDS:
        assert torch.equal(getattr(got, f), getattr(plain, f)), f
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)),
                                      err_msg=f)
    assert int(got.overflow[nt - 1]) > 0
    assert 0 < int(got.counts.sum()) < int(got.num_pairs)
