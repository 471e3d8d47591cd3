"""Aggregate the per-scene `results.json` of a benchmark suite
(counterpart: scripts/read_all_metrics.py).

    python -m fourdgs_tpu_torch.tools.read_all_metrics <root> [--method M]

Each subdirectory of <root> that holds a `results.json` (as the metrics CLI,
tools/metrics.py, writes it) is a scene. `--method` picks the method key
(`ours_<iteration>`); by default each file's last key in sorted order. A
scene without that key is left out. Prints the scenes, then for each metric
its mean and its per-scene values.
"""
from __future__ import annotations

import argparse
import json
import os

import numpy as np


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("root", help="output dir containing scene subdirs")
    parser.add_argument("--method", default=None,
                        help="method key (default: the last in sorted "
                        "order)")
    args = parser.parse_args(argv)

    agg: dict[str, list] = {}
    scenes = []
    for name in sorted(os.listdir(args.root)):
        p = os.path.join(args.root, name, "results.json")
        if not os.path.exists(p):
            continue
        with open(p) as f:
            results = json.load(f)
        method = args.method or sorted(results)[-1]
        if method not in results:
            continue
        scenes.append(name)
        for k, v in results[method].items():
            agg.setdefault(k, []).append(v)
    if not scenes:
        print("no results.json found")
        return
    print(f"scenes ({len(scenes)}): {', '.join(scenes)}")
    for k, vals in agg.items():
        print(f"{k:10s} mean={np.mean(vals):.5f}  "
              + " ".join(f"{v:.4f}" for v in vals))


if __name__ == "__main__":
    main()
