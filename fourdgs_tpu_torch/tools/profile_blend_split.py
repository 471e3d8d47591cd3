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
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from fourdgs_tpu_torch.data.camera import look_at_camera
from fourdgs_tpu_torch.ops.blend import (blend_forward, blend_forward_plain,
                                         pack_attr_table)
from fourdgs_tpu_torch.ops.projection import project_gaussians
from fourdgs_tpu_torch.ops.rasterize_tiled import (RasterConfig,
                                                   bin_gaussians_count)
from fourdgs_tpu_torch.utils.device import resolve_device
from fourdgs_tpu_torch.utils.timing import clock, time_call, time_pair


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
