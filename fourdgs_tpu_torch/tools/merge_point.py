"""Merge several point-cloud PLYs into one (counterpart:
scripts/merge_point.py).

    python -m fourdgs_tpu_torch.tools.merge_point a.ply b.ply ... -o out.ply

Host code: the clouds' points and colors concatenated in the given order.
"""
from __future__ import annotations

import argparse

import numpy as np

from fourdgs_tpu_torch.data import ply


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("inputs", nargs="+")
    parser.add_argument("-o", "--output", required=True)
    args = parser.parse_args(argv)
    pts, cols = [], []
    for p in args.inputs:
        x, c, _ = ply.fetch_point_cloud(p)
        pts.append(x)
        cols.append(c)
    xyz = np.concatenate(pts)
    rgb = np.concatenate(cols)
    ply.store_point_cloud(args.output, xyz, rgb * 255.0)
    print(f"merged {len(args.inputs)} clouds -> {len(xyz)} points")


if __name__ == "__main__":
    main()
