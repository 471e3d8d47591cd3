"""Port parity for the dev-tool kernels D1-D6: the plain versions in
fourdgs_tpu_torch/ops (gather.py, binner_proto.py, scatter.py, serial.py,
blend_variants.py) and the blend split of tools/profile_blend_split.py
against the Pallas prototypes in scripts/, which the JAX package never
imports. The scripts' kernels run in interpret mode on the CPU: those that
the scripts build with `interpret=` themselves (exp_pallas_binner_proto,
exp_pallas_scatter) as they are, the others (exp_pallas_serial,
profile_kernel_variants) inside a `pl.pallas_call(..., interpret=True)`
built as the script's `main`/`make_call` builds it, with the module's
sizes monkeypatched small. Both sides get the same numpy inputs.

Tolerances: D1, D2, D4a and D4b are integer or copy functions, held to
equality (D2 on the rows the serial loop writes; the TPU leaves the others
undefined, interpret mode fills them with INT32_MIN, the port with
zeros). D3 sums in another order than the serial loop, rtol 1e-6. D6 sums
the same terms in another association than the Pallas bodies (which also
scan their prefix products Kogge-Stone), rtol 1e-5. D5 is K1 at tile 16:
color 1e-5, depth 1e-4, transmittance 1e-5 (tests/test_pallas_blend.py).

Each tool's `main` also runs here at a tiny size with `--device cpu`.
tests/test_torch_kernels_gpu.py holds the CUDA kernels against these plain
versions on the card.
"""
import importlib
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from fourdgs_tpu.ops import rasterize_tiled as jrt
from fourdgs_tpu.ops.projection import project_gaussians as jproject
from fourdgs_tpu_torch.ops import blend as tblend
from fourdgs_tpu_torch.ops import blend_variants
from fourdgs_tpu_torch.ops.binner_proto import expand_rank
from fourdgs_tpu_torch.ops.gather import gather_rows, gather_rows_plain
from fourdgs_tpu_torch.ops.scatter import scatter_add_rows
from fourdgs_tpu_torch.ops.serial import scalar_store, tile_counter_store
from fourdgs_tpu_torch.tools import profile_blend_split
from tests.test_torch_blend import _jax_blend

ROOT = Path(__file__).resolve().parent.parent
# appended, so that no script shadows a module found earlier on the path;
# exp_pallas_scatter imports the scripts' `_timing`
sys.path.append(str(ROOT / "scripts"))
import exp_pallas_binner_proto as jbinner      # noqa: E402
import exp_pallas_scatter as jscatter           # noqa: E402
import exp_pallas_serial as jserial             # noqa: E402
import profile_kernel_variants as jvariants     # noqa: E402

torch.set_num_threads(1)

TOL = {"color": 1e-5, "depth": 1e-4, "t": 1e-5}


def _t(x):
    return torch.from_numpy(np.array(x))


# ---------------------------------------------------------------------------
# D1: row gather
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("rows,width,m", [(1000, 16, 5000), (37, 4, 300),
                                          (5, 3, 64)])
def test_gather_plain_matches_jax(rows, width, m):
    """The script's own reference, `jax.jit(lambda t, i: t[i])`, which
    its four Pallas formulations were held to (`match:` lines): equal."""
    rng = np.random.default_rng(rows)
    table = rng.normal(size=(rows, width)).astype(np.float32)
    idx = rng.integers(0, rows, m).astype(np.int32)
    want = np.asarray(jax.jit(lambda t, i: t[i])(table, idx))
    before = gather_rows.launches
    got = gather_rows(_t(table), _t(idx))
    assert gather_rows.launches == before          # no kernel here
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        gather_rows_plain(_t(table), _t(idx)).numpy(), want)


# ---------------------------------------------------------------------------
# D2: serial pair expansion and per-tile rank
# ---------------------------------------------------------------------------

def _binner_inputs(n, g, nt, grid_x, seed, empty=0):
    """Rects inside the grid, sizes in [1, 3] (and `empty` gaussians with
    sx = 0, which own no pair), slot0 per chunk as the script makes it."""
    rng = np.random.default_rng(seed)
    grid_y = nt // grid_x
    sx = rng.integers(1, min(3, grid_x) + 1, n).astype(np.int32)
    sy = rng.integers(1, min(3, grid_y) + 1, n).astype(np.int32)
    x0 = rng.integers(0, grid_x - sx + 1).astype(np.int32)
    y0 = rng.integers(0, grid_y - sy + 1).astype(np.int32)
    sx[rng.permutation(n)[:empty]] = 0
    touched = np.where(sx > 0, sx * sy, 0).astype(np.int32)
    off = np.concatenate([[0], np.cumsum(touched)])[:-1]
    slot0 = (off - np.repeat(off[::g], g)).astype(np.int32)
    gid = rng.permutation(n).astype(np.int32)
    return [a.reshape(n // g, 1, g) for a in (x0, y0, sx, sy, slot0, gid)], \
        touched


@pytest.mark.parametrize("n,g,pc,nt,grid_x,tile_cap,empty", [
    (256, 32, 70, 9, 3, 7, 0),        # every chunk past pc, tiles past cap
    (512, 128, 400, 20, 5, 40, 17),   # some chunks past pc, empty rects
])
def test_expand_rank_plain_matches_pallas(n, g, pc, nt, grid_x, tile_cap,
                                          empty):
    """The ranks carry across chunks (the counters are zeroed at grid step
    0 only), pairs past pc advance them without a row, and ranks past
    tile_cap take the sacrificial dest: equal on every written row, zeros
    elsewhere."""
    arrays, touched = _binner_inputs(n, g, nt, grid_x, n, empty)
    n_chunks = n // g
    fn = jbinner.make_kernel(g, pc, n_chunks, nt, grid_x, tile_cap)
    want = np.asarray(fn(*(jnp.asarray(a) for a in arrays)))
    before = expand_rank.launches
    got = expand_rank(*(_t(a) for a in arrays), pc=pc, n_tiles=nt,
                      grid_x=grid_x, tile_cap=tile_cap).numpy()
    assert expand_rank.launches == before
    assert got.shape == want.shape == (n_chunks, pc, 8)
    per_chunk = touched.reshape(n_chunks, g).sum(1)
    written = np.arange(pc)[None, :] < np.minimum(per_chunk, pc)[:, None]
    np.testing.assert_array_equal(got[written], want[written])
    assert not got[~written].any()
    assert (per_chunk > pc).any()                       # pc overflows
    assert (got[written][:, 0] == nt * tile_cap).any()  # tile_cap overflows


# ---------------------------------------------------------------------------
# D3: row scatter-add, the prototype of K4
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("m,w,n_out,blk,unroll", [(512, 128, 64, 128, 4),
                                                  (1024, 16, 131, 256, 8)])
def test_scatter_add_plain_matches_pallas_prototype(m, w, n_out, blk,
                                                    unroll):
    """The script's two row widths (128, 16), duplicates throughout;
    rtol 1e-6: the serial loop and `index_add_` sum in other orders."""
    rng = np.random.default_rng(m + w)
    rows = rng.standard_normal((m, w)).astype(np.float32)
    idx = rng.integers(0, n_out, m).astype(np.int32)
    fn = jscatter.make_scatter_add(n_out, w, blk, m, unroll)
    want = np.asarray(fn(jnp.asarray(idx), jnp.asarray(rows)))
    got = scatter_add_rows(_t(idx), _t(rows), n_out=n_out)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------------------
# D4: serial scalar stores and the tile counter
# ---------------------------------------------------------------------------

def _serial_call(kernel, m, counter):
    """`main`'s pallas_call of exp_pallas_serial.py (:64-86), in interpret
    mode, at the module's (monkeypatched) CHUNK, TABLE and NT."""
    smem_chunk = pl.BlockSpec((jserial.CHUNK,), lambda i: (i,),
                              memory_space=pltpu.SMEM)
    whole = pl.BlockSpec((jserial.TABLE, 1), lambda i: (0, 0),
                         memory_space=pltpu.VMEM)
    out_shape = jax.ShapeDtypeStruct((jserial.TABLE, 1), jnp.int32)
    out_specs = whole
    if counter:
        out_shape = (out_shape, jax.ShapeDtypeStruct((jserial.NT,), jnp.int32))
        out_specs = (whole, pl.BlockSpec((jserial.NT,), lambda i: (0,),
                                         memory_space=pltpu.SMEM))
    return pl.pallas_call(kernel, grid=(m // jserial.CHUNK,),
                          out_shape=out_shape,
                          in_specs=[smem_chunk, smem_chunk],
                          out_specs=out_specs, interpret=True)


def test_scalar_store_plain_matches_pallas(monkeypatch):
    """A 500-element table and 1,024 stores: hundreds of repeated indices,
    the last store in order winning each; equal."""
    monkeypatch.setattr(jserial, "CHUNK", 64)
    monkeypatch.setattr(jserial, "TABLE", 500)
    m = 1024
    rng = np.random.default_rng(4)
    idx = rng.integers(0, jserial.TABLE, m).astype(np.int32)
    val = rng.integers(0, 1 << 20, m).astype(np.int32)
    assert m - len(np.unique(idx)) > 300
    want = np.asarray(_serial_call(jserial.store_kernel, m, False)(idx, val))
    before = scalar_store.launches
    got = scalar_store(_t(idx), _t(val), n_out=jserial.TABLE)
    assert scalar_store.launches == before
    np.testing.assert_array_equal(got.numpy(), want[:, 0])


@pytest.mark.parametrize("case", ["every pair on one element",
                                  "pairs on three elements"])
def test_scalar_store_plain_matches_pallas_on_few_elements(monkeypatch,
                                                           case):
    """1,024 stores on one element (the last one in order wins, the rest
    of the table stays 0), or spread over three: equal. JAX's store_kernel
    does not define an index outside the table, so the GPU tests hold that
    case against the plain version."""
    monkeypatch.setattr(jserial, "CHUNK", 64)
    monkeypatch.setattr(jserial, "TABLE", 500)
    m = 1024
    rng = np.random.default_rng(len(case))
    targets = [123] if case == "every pair on one element" else [0, 250, 499]
    idx = rng.choice(np.array(targets, np.int32), m)
    val = rng.integers(1, 1 << 20, m).astype(np.int32)
    want = np.asarray(_serial_call(jserial.store_kernel, m, False)(idx, val))
    before = scalar_store.launches
    got = scalar_store(_t(idx), _t(val), n_out=jserial.TABLE).numpy()
    assert scalar_store.launches == before
    np.testing.assert_array_equal(got, want[:, 0])
    assert np.count_nonzero(got) == len(targets)
    for d in targets:
        assert got[d] == val[np.flatnonzero(idx == d)[-1]]


@pytest.mark.parametrize("nt,table,m", [
    (8, 5000, 1024),     # tiles 4-7 start past the table: all clamp
    (2, 3072, 4096),     # ranks past 1536 run into tile 1, then clamp
])
def test_tile_counter_store_plain_matches_pallas(monkeypatch, nt, table, m):
    """Ranks carried across chunks, the clamp to TABLE - 1 (hit by many
    pairs, the last one winning) and ranks that run into the next tile's
    range: equal outputs and counters."""
    monkeypatch.setattr(jserial, "CHUNK", 128)
    monkeypatch.setattr(jserial, "TABLE", table)
    monkeypatch.setattr(jserial, "NT", nt)
    rng = np.random.default_rng(nt)
    tid = rng.integers(0, nt, m).astype(np.int32)
    val = rng.integers(0, 1 << 20, m).astype(np.int32)
    want_out, want_cnt = (np.asarray(x) for x in
                          _serial_call(jserial.counter_kernel, m, True)(
                              tid, val))
    got_out, got_cnt = tile_counter_store(_t(tid), _t(val), n_tiles=nt,
                                          tile_cap=1536, n_out=table)
    np.testing.assert_array_equal(got_cnt.numpy(), want_cnt)
    np.testing.assert_array_equal(got_out.numpy(), want_out[:, 0])
    clamped = tid.astype(np.int64) * 1536 >= table - 1
    assert clamped.sum() > 1 or (np.bincount(tid) > 1536).any()


# ---------------------------------------------------------------------------
# D5: the blend split at tile 16
# ---------------------------------------------------------------------------

def test_synthetic_points_is_the_jax_rule():
    from __graft_entry__ import _synthetic_scene
    for n in (1000, 250_000):
        for a, b in zip(profile_blend_split.synthetic_points(n, 3),
                        _synthetic_scene(n, 3)):
            np.testing.assert_array_equal(a, b)


def test_blend_split_scene_matches_jax():
    """profile_pallas_split.py's scene (a 64px cut, 2,000 gaussians)
    through the port's projection, binner, pack and plain K1 at tile 16,
    tile_cap 768, chunk 32, against the JAX package's projection, binner
    and Pallas K1 in interpret mode: equal bins, the blend to the blend
    tolerances."""
    from __graft_entry__ import _look_at_camera, _synthetic_scene
    n, size = 2000, 64
    proj, binned, colors, opac, cfg = profile_blend_split.make_inputs(
        n, size, 0, "cpu")
    jcfg = jrt.RasterConfig(img_width=size, img_height=size, tile_size=16,
                            tile_cap=768, chunk=32, backend="pallas")
    pts, _ = _synthetic_scene(n)
    rng = np.random.default_rng(0)
    scales = jnp.exp(jnp.asarray(rng.uniform(-5.5, -4.0, (n, 3)),
                                 jnp.float32))
    quats = jnp.zeros((n, 4)).at[:, 0].set(1.0)
    jproj = jproject(jnp.asarray(pts), scales, quats, _look_at_camera(), size,
                     size, 16)
    jbinned = jrt.bin_gaussians_count(jproj, jcfg)
    np.testing.assert_array_equal(binned.counts.numpy(),
                                  np.asarray(jbinned.counts))
    np.testing.assert_array_equal(binned.gidx.numpy(),
                                  np.asarray(jbinned.gidx))
    assert int(binned.counts.max()) > cfg.chunk       # several chunks
    table = tblend.pack_attr_table(proj.pix, proj.conic, colors, opac,
                                   proj.depth)
    port = tblend.blend_forward(binned.gidx, binned.counts, table, cfg)
    ref = _jax_blend("pallas", jcfg, jproj, jbinned, opac.numpy(),
                     colors.numpy())
    for name, a, b in zip(("color", "depth", "t"), port, ref):
        np.testing.assert_allclose(a.numpy(), b, atol=TOL[name],
                                   err_msg=name)


# ---------------------------------------------------------------------------
# D6: the stripped blend bodies
# ---------------------------------------------------------------------------

def _variant_against_pallas(body, monkeypatch, p):
    """The plain version of `body` against the script's Pallas body in
    interpret mode, built as make_call builds it: 16 tiles x 2 chunks of
    32 rows x p pixels (T_BLK 8), rtol 1e-5."""
    sizes = dict(NT=16, NCH=2, K=32, P=p, T_BLK=8)
    for k, v in sizes.items():
        monkeypatch.setattr(jvariants, k, v)
    nt, nch, k, p, t_blk, attr = (*sizes.values(), jvariants.ATTR)
    rng = np.random.default_rng(6)
    attrs = rng.uniform(0, 1, (nt, nch * k, attr)).astype(np.float32)
    px = rng.uniform(0, 1, (nt, 1, p)).astype(np.float32)
    kernel = getattr(jvariants, "k_" + body)
    want = pl.pallas_call(
        kernel, grid=(nt // t_blk, nch),
        in_specs=[pl.BlockSpec((t_blk, k, attr), lambda t, j: (t, j, 0),
                               memory_space=pltpu.VMEM),
                  pl.BlockSpec((t_blk, 1, p), lambda t, j: (t, 0, 0),
                               memory_space=pltpu.VMEM)],
        out_specs=[pl.BlockSpec((t_blk, 1, p), lambda t, j: (t, 0, 0),
                                memory_space=pltpu.VMEM)],
        out_shape=[jax.ShapeDtypeStruct((nt, 1, p), jnp.float32)],
        scratch_shapes=[pltpu.VMEM((t_blk, 1, p), jnp.float32)],
        interpret=True)(jnp.asarray(attrs), jnp.asarray(px))[0]
    fn = getattr(blend_variants, body)
    before = fn.launches
    got = fn(_t(attrs), _t(px))
    assert fn.launches == before
    assert got.shape == (nt, 1, p)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5)


@pytest.mark.parametrize("body", blend_variants.BODIES)
def test_blend_variant_plain_matches_pallas(body, monkeypatch):
    """16 tiles x 2 chunks of 32 rows x 256 pixels (the script's
    structure, T_BLK 8), rtol 1e-5: other association of the same sums."""
    _variant_against_pallas(body, monkeypatch, 256)


@pytest.mark.parametrize("body", blend_variants.BODIES)
def test_blend_variant_plain_matches_pallas_at_100_pixels(body, monkeypatch):
    """100 pixels a tile, a count that fills no whole thread's pixels in
    the CUDA kernel (8 a thread): rtol 1e-5."""
    _variant_against_pallas(body, monkeypatch, 100)


def test_blend_variants_reject_bad_inputs():
    attrs = torch.zeros(4, 64, 16)
    with pytest.raises(ValueError, match="attrs"):
        blend_variants.slices(torch.zeros(4, 60, 16), torch.zeros(4, 8))
    with pytest.raises(ValueError, match="attrs"):
        blend_variants.scans(attrs, torch.zeros(3, 8))
    with pytest.raises(TypeError, match="float32"):
        blend_variants.exp_only(attrs.double(), torch.zeros(4, 8))


# ---------------------------------------------------------------------------
# the tools on the CPU
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("tool,argv,expect", [
    ("exp_gather", ["--rows", "256", "--n_idx", "1024"], "match: True"),
    ("exp_scatter", ["--scale", "512"], "scatter_add_rows"),
    ("exp_serial", ["--n_pairs", "2048"], "Mpairs/s"),
    ("exp_binner_proto", ["--n", "4096", "--g", "1024"], "pairs/s"),
    ("profile_blend_split", ["--n", "1000", "--size", "64"],
     "blend_forward (K1) only"),
    ("profile_kernel_variants", ["--tiles", "4"], "scans"),
])
def test_tool_runs_on_the_cpu(tool, argv, expect, capsys):
    mod = importlib.import_module(f"fourdgs_tpu_torch.tools.{tool}")
    res = mod.main(argv + ["--device", "cpu", "--iters", "1"])
    out = capsys.readouterr().out
    assert expect in out, out
    assert "inputs" in res or all("inputs" in v for v in res.values())
