"""A trained model's storage size: point_cloud.ply plus deformation.npz of
its newest snapshot, a line a model and the mean over them (counterpart:
scripts/cal_modelsize.py).

    python -m fourdgs_tpu_torch.tools.cal_modelsize <model> [<model> ...]

Host code; MB are 10^6 bytes.
"""
from __future__ import annotations

import argparse
import os

from fourdgs_tpu_torch.train.checkpoint import find_latest_snapshot


def main(argv=None) -> list:
    """Print the sizes; returns them, in MB."""
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("model_paths", nargs="+")
    args = parser.parse_args(argv)
    sizes = []
    for mp in args.model_paths:
        snap, it = find_latest_snapshot(mp)
        total = 0
        for name in ("point_cloud.ply", "deformation.npz"):
            p = os.path.join(snap, name)
            if os.path.exists(p):
                total += os.path.getsize(p)
        mb = total / 1e6
        sizes.append(mb)
        print(f"{mp} (iter {it}): {mb:.2f} MB")
    if sizes:
        print(f"mean: {sum(sizes)/len(sizes):.2f} MB over {len(sizes)} scenes")
    return sizes


if __name__ == "__main__":
    main()
