"""A trained model's HexPlane grids as images, one a level and plane: the
feature vector's L2 norm over the plane, scaled to [0, 255]
(counterpart: scripts/visualize_hexplane.py).

    python -m fourdgs_tpu_torch.tools.visualize_hexplane -m <model> \\
        [--iteration N] [--out <dir>]

Host code on the snapshot's deformation.npz (the newest snapshot, or
`--iteration`'s); writes <out>/l{level}_p{plane}_{axes}.png, 8-bit
greyscale, with the port's PNG codec (data/png.py), by default into
<model>/hexplane_vis_<iteration>.
"""
from __future__ import annotations

import argparse
import os

import numpy as np

from fourdgs_tpu_torch.data.png import write_png
from fourdgs_tpu_torch.train import checkpoint

PLANES = ["xy", "xz", "xt", "yz", "yt", "zt"]


def main(argv=None) -> str:
    """Write the images; returns their directory."""
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("-m", "--model_path", required=True)
    parser.add_argument("--iteration", type=int, default=-1)
    parser.add_argument("--out", default=None)
    args = parser.parse_args(argv)

    snap, it = checkpoint.find_latest_snapshot(args.model_path,
                                               args.iteration)
    _, dflat, _ = checkpoint.load_snapshot(snap)
    out_dir = args.out or os.path.join(args.model_path,
                                       f"hexplane_vis_{it}")
    os.makedirs(out_dir, exist_ok=True)
    for key, arr in sorted(dflat.items()):
        if not key.startswith("grid/"):
            continue
        tag = key.split("/")[-1]            # l{level}_p{ci}
        ci = int(tag.split("_p")[1])
        norm = np.linalg.norm(np.asarray(arr), axis=-1)
        lo, hi = norm.min(), norm.max()
        img = ((norm - lo) / max(hi - lo, 1e-9) * 255).astype(np.uint8)
        write_png(os.path.join(out_dir, f"{tag}_{PLANES[ci]}.png"), img)
        print(f"{tag} ({PLANES[ci]}): shape={arr.shape} "
              f"norm range [{lo:.3f}, {hi:.3f}]")
    print(f"wrote plane visualizations to {out_dir}")
    return out_dir


if __name__ == "__main__":
    main()
