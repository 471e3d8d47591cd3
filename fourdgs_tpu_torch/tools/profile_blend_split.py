"""Split timing of the blend path (the counterpart of
scripts/profile_pallas_split.py, D5): the attribute pack, the blend
forward kernel K1 alone on the packed table, and the two together, on the
script's scene: 100,000 synthetic gaussians at 800x800, tile 16, tile_cap
768, chunk 32.

    python -m fourdgs_tpu_torch.tools.profile_blend_split [--n 100000]
        [--size 800] [--seed 0] [--iters 20] [--device cpu]

The scene is the script's: the JAX package's benchmark point rule
(`synthetic_points`, the port's copy of `__graft_entry__._synthetic_scene`),
scales exp(U(-5.5, -4)), identity rotations, opacities U(0.3, 0.9), the
look-at camera at t = 0.5, projected and binned by the port
(ops/projection.py, ops/rasterize_tiled.py:bin_gaussians_count).

The JAX split's first line, "pack_attrs (gather)", gathers every slot's
row into a (tiles, tile_cap, 16) array before its kernel runs. The port's
K1 (csrc/blend_fwd.cu) gathers the rows by gidx inside the kernel, so its
pack is only the (N+1, 16) per-gaussian table (ops/blend.py:
pack_attr_table), and that line has no exact counterpart here. The tool
prints the pack, K1 alone, the two together, and K1's plain version. On
the CPU only the plain version runs, and its times are host times. `main`
returns the numbers and K1's inputs.

`blend_work` counts where K1's time can go on any input (chip_smoke.py
prices K1's and K2's bounds with it, and reads the tiles' occupancy, the
heaviest tile and the warp-issued evaluations off it); `bwd_work` counts
where K2's sums over pixels can go (its warp reductions and atomics).
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from fourdgs_tpu_torch.data.camera import look_at_camera
from fourdgs_tpu_torch.ops.blend import (blend_forward, blend_forward_plain,
                                         pack_attr_table, tile_pixel_coords)
from fourdgs_tpu_torch.ops.projection import project_gaussians
from fourdgs_tpu_torch.ops.rasterize_ref import ALPHA_MAX, ALPHA_MIN, T_MIN
from fourdgs_tpu_torch.ops.rasterize_tiled import (RasterConfig,
                                                   bin_gaussians_count)
from fourdgs_tpu_torch.utils.device import resolve_device
from fourdgs_tpu_torch.utils.timing import (FP32_ISSUE_SM_S, clock,
                                            time_call, time_pair)

# FP32-pipe instructions of K1's loop body (csrc/blend_fwd.cu) per pixel x
# slot evaluation, by how far the evaluation gets, as the sm_90a SASS
# (`cuobjdump -sass` of the built library) has them (compares and fminf
# counted as FP32 issues; expf without fast math is 5 FP32 instructions,
# one MUFU.EX2 and a final multiply):
#   every one: dx, dy (2), the three quadratic terms (6), power (3) and
#     its test (1)
#   power <= 0: expf (6), opacity x exp (1), fminf (1), the alpha test (1)
#   used (alpha >= 1/255, entering T > 1e-4): T x cp and its test (2),
#     the weight (1), four fused sums (4), 1 - alpha and cp (2)
BLEND_FP32_INSTR = {"eval": 12, "exp": 9, "used": 9}
# K1's thread layout (csrc/blend_fwd.cu): a block of 128 threads covers a
# 16 x 8 sub-tile, its warps 8 x 4 patches, two across and two down, each
# lane one pixel, row-major in its patch. The design before it ran a block
# per tile and a warp per 32 consecutive pixels of the tile ("row").
SUB_W, SUB_H, PATCH_W, PATCH_H = 16, 8, 8, 4
WARP_SHAPES = ("row", "patch")
# K2 (csrc/blend_bwd.cu) takes K1's layout and replays and sums the slots
# of a chunk in batches of four
BWD_BATCH = 4


def warp_pixels(tile_size: int, shape: str) -> torch.Tensor:
    """(P / 32, 32) tile-local pixel numbers p = y * tile_size + x of each
    warp's lanes: 32 consecutive pixels ("row", a 32 x 1 row at tile 32),
    or K1's 8 x 4 patches in its block order ("patch"), so that the rows
    [4 b, 4 b + 4) are the warps of sub-tile b (K1's block b of the tile,
    sub-tiles row-major)."""
    p = tile_size * tile_size
    if shape == "row":
        return torch.arange(p).reshape(-1, 32)
    subs_x, n = tile_size // SUB_W, SUB_W * SUB_H
    lane = torch.arange(p)
    b, w, i = lane // n, lane % n // 32, lane % 32
    x = (b % subs_x) * SUB_W + (w % (SUB_W // PATCH_W)) * PATCH_W + i % PATCH_W
    y = (b // subs_x) * SUB_H + (w // (SUB_W // PATCH_W)) * PATCH_H \
        + i // PATCH_W
    return (y * tile_size + x).reshape(-1, 32)


def _chunk_walks(gidx, counts, table, cfg):
    """Per occupied chunk of the plain recurrence (ops/blend.py:
    _chunk_math), what the kernels' thread of each pixel does with each
    slot, as (tile, slot[, pixel]) boolean tensors:

    slot (nt, K): the slot lies within its tile's count;
    live (nt, P): the pixel entered the chunk with T > T_MIN;
    exp (nt, K, P): power <= 0, so the slot takes an expf;
    gated: power <= 0 and alpha >= 1/255;
    eval: evaluated (within the count, the entering T above T_MIN);
    used: evaluated and gated;
    walk: walked in SIMT: from the chunk's first slot, if the pixel was
      live, until it ends or a gated slot finds the entering T at or below
      T_MIN (that slot included)."""
    k = cfg.chunk
    dev = table.device
    px, py = tile_pixel_coords(cfg, dev)
    idx = torch.where(gidx >= 0, gidx, table.shape[0] - 1).long()
    t = torch.ones_like(px)
    for j in range(-(-int(counts.max()) // k)):
        rows = table[idx[:, j * k:(j + 1) * k]]
        dx = rows[:, :, 0:1] - px[:, None, :]
        dy = rows[:, :, 1:2] - py[:, None, :]
        power = (-0.5 * (rows[:, :, 2:3] * dx * dx + rows[:, :, 4:5] * dy * dy)
                 - rows[:, :, 3:4] * dx * dy)
        alpha = torch.clamp(rows[:, :, 8:9] * torch.exp(
            torch.clamp(power, max=0.0)), max=ALPHA_MAX)
        gated = (power <= 0) & (alpha >= ALPHA_MIN)
        g = torch.where(gated, alpha, 0.0)
        cp = torch.cumprod(1.0 - g, dim=1)
        t_pref = t[:, None, :] * torch.cat(
            [torch.ones_like(cp[:, :1]), cp[:, :-1]], dim=1)
        slot = torch.arange(j * k, (j + 1) * k, device=dev)[None, :] \
            < counts[:, None]                             # (nt, K)
        ev = (t_pref > T_MIN) & slot[:, :, None]
        # a lane stops at the first gated slot whose entering T is spent
        stop = (gated & (t_pref <= T_MIN)).int()
        live = t > T_MIN
        walk = (slot[:, :, None] & live[:, None, :]
                & (torch.cumsum(stop, dim=1) - stop == 0))
        yield {"slot": slot, "live": live, "exp": ev & (power <= 0),
               "gated": gated, "eval": ev, "used": ev & gated, "walk": walk}
        use = gated & (t_pref > T_MIN)
        t = t * torch.where(use, cp, torch.ones_like(cp)).amin(dim=1)


def blend_work(gidx, counts, table, cfg) -> dict:
    """Where K1's time can go on this input, by walking the plain
    recurrence (ops/blend.py:_chunk_math) chunk by chunk (`_chunk_walks`):

    eval, exp, used: pixel x slot evaluations by how far each gets in the
      kernels' loop bodies (all evaluated, past the power test, used); a
      pixel evaluates every slot of its tile's list up to the count while
      its entering transmittance is above T_MIN. They price the bound.
    lanes_walked: the slots each pixel's thread walks in SIMT: from the
      chunk's first slot until it ends or a gated slot finds the entering
      transmittance at or below T_MIN, if the pixel was live (T > T_MIN) as
      the chunk began.
    warp_issued: per warp shape (`warp_pixels`), 32 x the slots each warp
      with a live lane walks (the most any of its lanes walks), summed over
      chunks: the evaluations a SIMT design issues.
    block_chunks: the chunks that blocks walk, a block walking a chunk of
      its tile's list while one of its pixels is live: a block per tile
      ("tile"), or per 16 x 8 sub-tile ("sub_tile", K1's).
    occupancy: the mean, p99 and max of counts.
    heaviest_tile, heaviest_sub_tile: the tile (sub-tile) with the most FP32
      instructions by BLEND_FP32_INSTR, its evaluations, and its one-SM
      time, those instructions over one SM's FP32 issue rate (128 lanes at
      1.98 GHz): the least time a design that keeps it on one SM takes."""
    dev = table.device
    nt, p = cfg.num_tiles, cfg.pixels_per_tile
    warps = {s: warp_pixels(cfg.tile_size, s).to(dev) for s in WARP_SHAPES}
    subs = warps["patch"].reshape(-1, SUB_W * SUB_H)  # (sub-tiles, 128)
    pix = {key: torch.zeros((nt, p), dtype=torch.int64, device=dev)
           for key in BLEND_FP32_INSTR}
    work = {"lanes_walked": 0}
    issued = dict.fromkeys(WARP_SHAPES, 0)
    blocks = {"tile": 0, "sub_tile": 0}
    for c in _chunk_walks(gidx, counts, table, cfg):
        for key in BLEND_FP32_INSTR:
            pix[key] += c[key].sum(1)
        walked = c["walk"].sum(1)                         # (nt, P)
        work["lanes_walked"] += int(walked.sum())
        for s, lanes in warps.items():
            issued[s] += 32 * int(walked[:, lanes].amax(-1).sum())
        live = c["live"] & c["slot"][:, :1]               # (nt, P)
        blocks["tile"] += int(live.any(-1).sum())
        blocks["sub_tile"] += int(live[:, subs].any(-1).sum())
    work.update({key: int(v.sum()) for key, v in pix.items()})
    work.update(warp_issued=issued, block_chunks=blocks)
    c = counts.double()
    work["occupancy"] = {"mean": float(c.mean()),
                         "p99": float(torch.quantile(c, 0.99)),
                         "max": int(counts.max())}
    fp32 = sum(w * pix[key] for key, w in BLEND_FP32_INSTR.items())
    for name, groups in (("heaviest_tile", torch.arange(p, device=dev)[None]),
                         ("heaviest_sub_tile", subs)):
        per = fp32[:, groups].sum(-1).reshape(-1)         # tile-major
        top = int(per.argmax())
        tile, part = divmod(top, groups.shape[0])
        work[name] = {"tile": tile, "part": part, "count": int(counts[tile]),
                      **{key: int(v[tile, groups[part]].sum())
                         for key, v in pix.items()},
                      "fp32": int(per[top]),
                      "one_sm_ms": float(per[top]) / FP32_ISSUE_SM_S * 1e3}
    return work


def bwd_work(gidx, counts, table, cfg) -> dict:
    """Where K2's sums over pixels can go on this input (csrc/blend_bwd.cu,
    K1's layout with batches of BWD_BATCH slots), by the walk of
    `_chunk_walks`:

    warp_slots: per warp shape, the slots some pixel of a warp used: the
      first K2 reduced each with ten five-step shuffle sums ("row");
    block_slots: the slots some pixel of a tile ("tile": the first K2's
      flushes, ten atomics each at most) or of a 16 x 8 sub-tile
      ("sub_tile": K2's flushes, five float2 atomics each at most) used;
    reduced_batches: the batches (slots [4 b, 4 b + 4) of a chunk) that an
      8 x 4 patch warp reduces, 45 shuffles each: those in which some lane
      walks to the batch's first slot and some slot of the batch within
      the count is gated for it."""
    k, b = cfg.chunk, BWD_BATCH
    dev = table.device
    nt, p = cfg.num_tiles, cfg.pixels_per_tile
    warps = {s: warp_pixels(cfg.tile_size, s).to(dev) for s in WARP_SHAPES}
    subs = warps["patch"].reshape(-1, SUB_W * SUB_H)
    nb = -(-k // b)
    work = {"warp_slots": dict.fromkeys(WARP_SHAPES, 0),
            "block_slots": {"tile": 0, "sub_tile": 0}, "reduced_batches": 0}
    for c in _chunk_walks(gidx, counts, table, cfg):
        used = c["used"]
        for s, lanes in warps.items():
            work["warp_slots"][s] += int(used[:, :, lanes].any(-1).sum())
        work["block_slots"]["tile"] += int(used.any(-1).sum())
        work["block_slots"]["sub_tile"] += int(used[:, :, subs].any(-1).sum())
        gated = c["gated"] & c["slot"][:, :, None]        # (nt, K, P)
        gated = torch.cat([gated, gated.new_zeros((nt, nb * b - k, p))], 1)
        batch = gated.reshape(nt, nb, b, p).any(2) & c["walk"][:, ::b]
        work["reduced_batches"] += int(batch[:, :, warps["patch"]]
                                       .any(-1).sum())
    return work


def synthetic_points(n_points: int, seed: int = 0):
    """Uniform points in a cube whose volume grows with the count above
    100k (so the per-tile depth stays that of 100k in [-1, 1]^3), and
    uniform colors: the JAX package's benchmark scene rule."""
    rng = np.random.default_rng(seed)
    scale = max(1.0, (n_points / 100_000.0) ** (1.0 / 3.0))
    pts = rng.uniform(-scale, scale, (n_points, 3)).astype(np.float32)
    cols = rng.uniform(0.0, 1.0, (n_points, 3)).astype(np.float32)
    return pts, cols


def make_inputs(n: int, size: int, seed: int, device):
    """The script's scene, projected and binned: (proj, binned, colors,
    opacities, cfg)."""
    cfg = RasterConfig(img_width=size, img_height=size, tile_size=16,
                       tile_cap=768, chunk=32)
    pts, cols = synthetic_points(n, seed)
    rng = np.random.default_rng(seed)
    scales = np.exp(rng.uniform(-5.5, -4.0, (n, 3))).astype(np.float32)
    quats = np.zeros((n, 4), np.float32)
    quats[:, 0] = 1.0
    opac = rng.uniform(0.3, 0.9, n).astype(np.float32)

    def t(x):
        return torch.from_numpy(x).to(device)

    with torch.no_grad():
        proj = project_gaussians(t(pts), t(scales), t(quats),
                                 look_at_camera(device=device), size, size,
                                 cfg.tile_size)
        binned = bin_gaussians_count(proj, cfg)
    return proj, binned, t(cols), t(opac), cfg


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--n", type=int, default=100_000)
    parser.add_argument("--size", type=int, default=800)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--iters", type=int, default=20)
    parser.add_argument("--device", default=None)
    args = parser.parse_args(argv)
    dev = resolve_device(args.device)
    print(f"timing: {clock(dev)}", flush=True)
    proj, binned, colors, opac, cfg = make_inputs(args.n, args.size,
                                                  args.seed, dev)
    gidx, counts = binned.gidx, binned.counts

    def pack():
        return pack_attr_table(proj.pix, proj.conic, colors, opac,
                               proj.depth)

    table = pack()
    pack_ms = time_call(pack, args.iters, dev)
    ms, plain_ms = time_pair(
        lambda: blend_forward(gidx, counts, table, cfg),
        lambda: blend_forward_plain(gidx, counts, table, cfg),
        args.iters, dev)
    full_ms = time_call(lambda: blend_forward(gidx, counts, pack(), cfg),
                        args.iters, dev)
    res = {"pack_ms": pack_ms, "ms": ms, "plain_ms": plain_ms,
           "pack_and_blend_ms": full_ms, "pairs": int(counts.sum()),
           "num_pairs": int(binned.num_pairs),
           "dropped_pairs": int(binned.dropped_pairs),
           "dropped_tile": int(binned.dropped_tile)}
    print(f"scene: {args.n} gaussians, {args.size}x{args.size}, tile 16, "
          f"{cfg.num_tiles} tiles; {res['pairs']} pairs in the tiles "
          f"({res['num_pairs']} touched, {res['dropped_pairs']} past the "
          f"pair budget, {res['dropped_tile']} past tile_cap)", flush=True)
    for name, v in (("pack_attr_table", pack_ms),
                    ("blend_forward (K1) only", ms),
                    ("pack + blend_forward", full_ms),
                    ("blend_forward_plain", plain_ms)):
        print(f"{name:30s} {v:9.4f} ms", flush=True)
    res["inputs"] = {"gidx": gidx, "counts": counts, "table": table,
                     "cfg": cfg}
    return res


if __name__ == "__main__":
    main()
