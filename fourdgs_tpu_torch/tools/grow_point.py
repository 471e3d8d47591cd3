"""Grow a PLY cloud in its sparse regions (counterpart:
scripts/grow_point.py): each point whose mean squared distance to its 8
nearest neighbours is above the `--quantile` gets a copy displaced by
Gaussian noise scaled by that distance (utils/point_grow.py), and the
copies join the cloud with their source's color.

    python -m fourdgs_tpu_torch.tools.grow_point <in.ply> <out.ply> \\
        [--quantile 0.8] [--displacement_scale 1.0] [--seed 0] \\
        [--device cpu]

The k-NN and the noise run on `--device` (the card by default); the
noise comes from a torch.Generator seeded with `--seed`, so it is not
the JAX script's `jax.random` draw (`main(noise=)` takes a given draw).
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from fourdgs_tpu_torch.data import ply
from fourdgs_tpu_torch.utils.device import resolve_device
from fourdgs_tpu_torch.utils.point_grow import grow_points


def main(argv=None, noise: np.ndarray | None = None) -> dict:
    """Write the grown cloud; returns the point counts and the seconds
    that `grow_points` (the k-NN and the draw) took on the device.
    `noise` (standard normal, the cloud's (N, 3)) replaces the seeded
    draw."""
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("input")
    parser.add_argument("output")
    parser.add_argument("--quantile", type=float, default=0.8)
    parser.add_argument("--displacement_scale", type=float, default=1.0)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--device", default=None,
                        help="default cuda; 'cpu' runs the plain path")
    args = parser.parse_args(argv)
    dev = resolve_device(args.device)

    pts, cols, _ = ply.fetch_point_cloud(args.input)
    xyz = torch.from_numpy(pts).to(dev)
    if noise is not None:
        noise = torch.from_numpy(np.asarray(noise, np.float32)).to(dev)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    with torch.no_grad():
        mask, new_xyz = grow_points(
            xyz, args.displacement_scale, quantile=args.quantile,
            generator=torch.Generator(dev).manual_seed(args.seed),
            noise=noise)
    mask, new_xyz = mask.cpu().numpy(), new_xyz.cpu().numpy()
    seconds = time.perf_counter() - t0
    merged = np.concatenate([pts, new_xyz[mask]])
    merged_cols = np.concatenate([cols, cols[mask]])
    ply.store_point_cloud(args.output, merged, merged_cols * 255.0)
    print(f"{len(pts)} -> {len(merged)} points "
          f"(+{mask.sum()} in sparse regions)")
    return {"points": len(pts), "grown": int(mask.sum()),
            "seconds": seconds, "device": str(dev)}


if __name__ == "__main__":
    main()
