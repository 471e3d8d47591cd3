"""Port parity for the blend forward (ops/blend.py) and the forward
rasterizer (ops/rasterize_tiled.py).

On the CPU the port's blend is its plain version; it is held against the
JAX package's Pallas blend (K1, interpret mode on the CPU, as
tests/test_pallas_blend.py runs it) and its XLA blend, on the same binned
inputs, at tile sizes 16 and 32. Tolerances are those of
tests/test_pallas_blend.py: color 1e-5, depth 1e-4, transmittance/alpha
1e-5. tests/test_torch_kernels_gpu.py holds the CUDA kernel against the
plain version on the card, on the same ragged scene.

tools/profile_blend_split.py:blend_work, which counts where K1's time can
go, is held to a loop over each pixel's walk through the plain
recurrence."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fourdgs_tpu.ops import rasterize_tiled as jrt
from fourdgs_tpu.ops.pallas import blend as jpb
from fourdgs_tpu.ops.projection import project_gaussians
from fourdgs_tpu_torch.data import camera as tcam
from fourdgs_tpu_torch.ops import blend as tblend
from fourdgs_tpu_torch.ops import rasterize_tiled as trt
from fourdgs_tpu_torch.ops.rasterize_ref import ALPHA_MIN, T_MIN
from fourdgs_tpu_torch.tools import profile_blend_split
from tests.test_rasterize import FOV, H, W, random_scene, simple_camera
from tests.test_torch_kernels_gpu import ragged_scene

torch.set_num_threads(1)

TOL = {"color": 1e-5, "depth": 1e-4, "t": 1e-5}


def _cfgs(ts, cap=64, chunk=8):
    kw = dict(img_width=W, img_height=H, tile_size=ts, tile_cap=cap,
              chunk=chunk, bin_pairs_per_chunk=4096)
    return jrt.RasterConfig(**kw), trt.RasterConfig(**kw)


def _scene(kind):
    if kind == "random":
        return tuple(np.asarray(x) for x in
                     random_scene(np.random.default_rng(11), n=96))
    if kind == "ragged":
        return tuple(ragged_scene(np.random.default_rng(5), W, H, FOV, FOV))
    # deep stack of near-opaque splats covering the image: every pixel
    # saturates after the first chunks (tests/test_pallas_blend.py:38)
    rng = np.random.default_rng(7)
    n = 64
    means = np.stack([rng.uniform(-0.1, 0.1, n), rng.uniform(-0.1, 0.1, n),
                      np.linspace(2.0, 6.0, n)], -1).astype(np.float32)
    scales = np.full((n, 3), 2.0, np.float32)
    quats = np.tile(np.array([1, 0, 0, 0], np.float32), (n, 1))
    opac = rng.uniform(0.9, 0.99, n).astype(np.float32)
    colors = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    return means, scales, quats, opac, colors


def _binned_inputs(kind, jcfg):
    """JAX projection + binning of a scene, and the attributes both blends
    take."""
    means, scales, quats, opac, colors = _scene(kind)
    proj = project_gaussians(jnp.asarray(means), jnp.asarray(scales),
                             jnp.asarray(quats), simple_camera(), W, H,
                             jcfg.tile_size, opacities=jnp.asarray(opac))
    binned = jrt.bin_gaussians_count(proj, jcfg)
    return proj, binned, opac, colors


def _jax_blend(backend, jcfg, proj, binned, opac, colors):
    blend = (jpb.make_blend(jcfg) if backend == "pallas"
             else jrt._make_blend(jcfg))
    px, py = jrt._tile_pixel_coords(jcfg)
    out = blend(binned.gidx, px, py, proj.pix, proj.conic,
                jnp.asarray(colors), jnp.asarray(opac), proj.depth,
                None, None, None)
    return [np.asarray(o) for o in out]


def _port_blend(tcfg, proj, binned, opac, colors):
    def t(x):
        return torch.from_numpy(np.array(x))
    table = tblend.pack_attr_table(t(proj.pix), t(proj.conic), t(colors),
                                   t(opac), t(proj.depth))
    return tblend.blend_forward(t(binned.gidx), t(binned.counts), table,
                                tcfg)


def _assert_blend_close(port, ref):
    for name, a, b in zip(("color", "depth", "t"), port, ref):
        assert tuple(a.shape) == b.shape, name
        np.testing.assert_allclose(a.numpy(), b, atol=TOL[name],
                                   err_msg=name)


@pytest.mark.parametrize("backend", ["pallas", "xla"])
@pytest.mark.parametrize("ts", [16, 32])
@pytest.mark.parametrize("kind", ["random", "saturating", "ragged"])
def test_blend_plain_matches_jax(kind, ts, backend):
    jcfg, tcfg = _cfgs(ts)
    proj, binned, opac, colors = _binned_inputs(kind, jcfg)
    ref = _jax_blend(backend, jcfg, proj, binned, opac, colors)
    port = _port_blend(tcfg, proj, binned, opac, colors)
    _assert_blend_close(port, ref)
    if kind == "saturating":
        assert float(port[2].max()) <= 1e-3   # every pixel saturated
    elif kind == "ragged":
        # tiles whose blobs saturate beside pixels that walk the whole list
        t = port[2]
        assert int(binned.counts.max()) > 2 * tcfg.chunk
        assert int(binned.dropped_tile) == 0
        assert bool(((t.amin(1) <= T_MIN) & (t.amax(1) > 0.5)).any())
    else:
        assert 0.0 < float(port[2].min()) < 0.5 < float(port[2].max())


def test_tile_pixel_coords():
    for ts in (16, 32):
        jcfg, tcfg = _cfgs(ts)
        for a, b in zip(tblend.tile_pixel_coords(tcfg, "cpu"),
                        jrt._tile_pixel_coords(jcfg)):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_pack_attr_table():
    rng = np.random.default_rng(3)
    cols = [rng.normal(size=s).astype(np.float32)
            for s in ((50, 2), (50, 3), (50, 3), (50,), (50,))]
    a = tblend.pack_attr_table(*(torch.from_numpy(c) for c in cols))
    np.testing.assert_array_equal(a.numpy(),
                                  np.asarray(jpb.pack_attr_table(*cols)))


@pytest.mark.parametrize("backend", ["pallas", "xla"])
@pytest.mark.parametrize("ts", [16, 32])
def test_rasterize_matches_jax(ts, backend):
    jcfg, tcfg = _cfgs(ts)
    jcfg = jrt.RasterConfig(**{**jcfg.__dict__, "backend": backend})
    means, scales, quats, opac, colors = _scene("random")
    bg = np.array([0.3, 0.1, 0.7], np.float32)
    a = jrt.rasterize(*(jnp.asarray(x) for x in
                        (means, scales, quats, opac, colors)),
                      simple_camera(), jnp.asarray(bg), jcfg)
    cam = tcam.make_camera(np.eye(3), np.zeros(3), FOV, FOV, device="cpu")
    b = trt.rasterize(*(torch.from_numpy(np.array(x)) for x in
                        (means, scales, quats, opac, colors)),
                      cam, torch.from_numpy(bg), tcfg)
    np.testing.assert_allclose(b.color.numpy(), np.asarray(a.color),
                               atol=TOL["color"])
    np.testing.assert_allclose(b.depth.numpy(), np.asarray(a.depth),
                               atol=TOL["depth"])
    np.testing.assert_allclose(b.alpha.numpy(), np.asarray(a.alpha),
                               atol=TOL["t"])
    for f in ("dropped_pairs", "dropped_tile", "num_pairs", "tile_peak"):
        assert int(getattr(b, f)) == int(getattr(a, f)), f
    np.testing.assert_array_equal(b.radii.numpy(), np.asarray(a.radii))


def test_blend_rejects_bad_inputs():
    _, tcfg = _cfgs(16)
    nt = tcfg.num_tiles
    gidx = torch.full((nt, 64), -1, dtype=torch.int32)
    counts = torch.zeros(nt, dtype=torch.int32)
    table = torch.zeros((5, 16))
    with pytest.raises(TypeError):
        tblend.blend_forward(gidx.long(), counts, table, tcfg)
    with pytest.raises(ValueError):
        tblend.blend_forward(gidx[:, :32], counts, table, tcfg)
    with pytest.raises(ValueError):
        tblend.blend_forward(gidx, counts, table[:, :10], tcfg)
    # an empty tile list blends to the background
    c, d, t = tblend.blend_forward(gidx, counts, table, tcfg)
    assert float(c.abs().max()) == 0 and float(t.min()) == 1.0


def _walk_reference(gidx, counts, table, cfg):
    """What blend_work counts, by a loop over each pixel's walk through
    the plain recurrence's per-slot values (ops/blend.py:_chunk_math), as
    K1's thread for the pixel walks it, with K1's layout written out: a
    warp is 32 consecutive pixels ("row") or an 8 x 4 patch ("patch"), a
    block a tile or a 16 x 8 sub-tile."""
    k, ts = cfg.chunk, cfg.tile_size
    nt, p = cfg.num_tiles, cfg.pixels_per_tile
    px, py = tblend.tile_pixel_coords(cfg, "cpu")
    idx = torch.where(gidx >= 0, gidx, table.shape[0] - 1).long()
    xs, ys = np.arange(p) % ts, np.arange(p) // ts
    group = {"row": np.arange(p) // 32,
             "patch": (ys // 4) * (ts // 8) + xs // 8,
             "sub": (ys // 8) * (ts // 16) + xs // 16}
    pix = {key: np.zeros((nt, p), np.int64) for key in ("eval", "exp", "used")}
    ref = {"warp_slots": 0, "tile_slots": 0, "lanes_walked": 0,
           "warp_issued": {"row": 0, "patch": 0},
           "block_chunks": {"tile": 0, "sub_tile": 0}}
    cnt = counts.tolist()
    t = torch.ones((nt, p))
    for j in range(-(-max(cnt) // k)):
        rows = table[idx[:, j * k:(j + 1) * k]]
        dx, dy, _, alpha, _, t_pref, _, t_next = tblend._chunk_math(
            rows, px, py, t)
        power = (-0.5 * (rows[:, :, 2:3] * dx * dx + rows[:, :, 4:5] * dy * dy)
                 - rows[:, :, 3:4] * dx * dy)
        pw, al, tp, t0 = (x.tolist() for x in (power, alpha, t_pref, t))
        for ti in range(nt):
            nk = min(k, cnt[ti] - j * k)
            walked = np.zeros(p, np.int64)
            used = np.zeros((max(nk, 0), p), bool)
            for pi in range(p):
                if not t0[ti][pi] > T_MIN:
                    continue
                for s in range(nk):
                    walked[pi] += 1
                    gate = pw[ti][s][pi] <= 0 and al[ti][s][pi] >= ALPHA_MIN
                    if tp[ti][s][pi] > T_MIN:
                        pix["eval"][ti, pi] += 1
                        pix["exp"][ti, pi] += pw[ti][s][pi] <= 0
                        pix["used"][ti, pi] += gate
                        used[s, pi] = gate
                    elif gate:
                        break
            ref["warp_slots"] += int(used.reshape(-1, p // 32, 32)
                                     .any(-1).sum())
            ref["tile_slots"] += int(used.any(-1).sum())
            ref["lanes_walked"] += int(walked.sum())
            for shape in ("row", "patch"):
                ref["warp_issued"][shape] += 32 * sum(
                    int(walked[group[shape] == g].max())
                    for g in np.unique(group[shape]))
            ref["block_chunks"]["tile"] += int(walked.any())
            ref["block_chunks"]["sub_tile"] += len(
                np.unique(group["sub"][walked > 0]))
        t = t_next
    ref.update({key: int(v.sum()) for key, v in pix.items()})
    c = counts.numpy()
    ref["occupancy"] = {"mean": float(c.mean()),
                        "p99": float(np.percentile(c, 99)),
                        "max": int(c.max())}
    fp32 = sum(w * pix[key]
               for key, w in profile_blend_split.BLEND_FP32_INSTR.items())
    for name, grp in (("heaviest_tile", np.zeros(p, np.int64)),
                      ("heaviest_sub_tile", group["sub"])):
        n_grp = int(grp.max()) + 1
        per = np.stack([fp32[:, grp == g].sum(-1) for g in range(n_grp)], 1)
        tile, part = divmod(int(per.argmax()), n_grp)
        sel = grp == part
        ref[name] = {"tile": tile, "part": part, "count": int(c[tile]),
                     **{key: int(v[tile, sel].sum()) for key, v in pix.items()},
                     "fp32": int(per.max()),
                     "one_sm_ms": float(per.max()) / (128 * 1.98e9) * 1e3}
    return ref


@pytest.mark.parametrize("ts", [16, 32])
@pytest.mark.parametrize("kind", ["random", "saturating", "ragged"])
def test_blend_work_matches_a_pixel_walk(kind, ts):
    jcfg, tcfg = _cfgs(ts)
    proj, binned, opac, colors = _binned_inputs(kind, jcfg)

    def t(x):
        return torch.from_numpy(np.array(x))
    table = tblend.pack_attr_table(t(proj.pix), t(proj.conic), t(colors),
                                   t(opac), t(proj.depth))
    gidx, counts = t(binned.gidx), t(binned.counts)
    work = profile_blend_split.blend_work(gidx, counts, table, tcfg)
    ref = _walk_reference(gidx, counts, table, tcfg)
    for key in ("heaviest_tile", "heaviest_sub_tile"):
        assert work[key].pop("one_sm_ms") == pytest.approx(
            ref[key].pop("one_sm_ms"), rel=1e-12)
    assert work == ref
    # the walk passes the needed evaluations, and a SIMT warp issues more
    for shape in ("row", "patch"):
        assert work["warp_issued"][shape] >= work["lanes_walked"] >= \
            work["eval"] > 0
    if kind == "ragged" and ts == 32:   # a sub-tile stops before its tile
        assert work["block_chunks"]["sub_tile"] < \
            work["block_chunks"]["tile"] * (ts // 16) * (ts // 8)


def test_warp_pixels_are_k1_layout():
    """Each warp covers 32 distinct pixels; an 8 x 4 patch in its 16 x 8
    sub-tile, four warps a sub-tile, sub-tiles in row-major order of the
    tile."""
    for ts in (16, 32):
        p = ts * ts
        for shape in profile_blend_split.WARP_SHAPES:
            lanes = profile_blend_split.warp_pixels(ts, shape)
            assert lanes.shape == (p // 32, 32)
            assert torch.equal(lanes.reshape(-1).sort().values,
                               torch.arange(p))
        lanes = profile_blend_split.warp_pixels(ts, "patch")
        x, y = lanes % ts, lanes // ts
        assert bool(((x.amax(1) - x.amin(1)) == 7).all())
        assert bool(((y.amax(1) - y.amin(1)) == 3).all())
        sub = (y // 8) * (ts // 16) + x // 16
        assert torch.equal(sub, torch.arange(p // 32)[:, None].expand(-1, 32)
                           // 4)
