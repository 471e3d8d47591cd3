"""Post-mortem of a training checkpoint: its keys and meta, each gaussian
field's statistics over the alive slots, and the alive count
(counterpart: scripts/diag_checkpoint.py).

    python -m fourdgs_tpu_torch.tools.diag_checkpoint <chkpnt.npz> \\
        [--device cpu]

The npz is read on the host (its layout is the JAX package's, which the
port writes); the statistics are taken on `--device` (the card by
default, the JAX script's `--cpu` is `--device cpu`), and the lines
printed are the script's.
"""
from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from fourdgs_tpu_torch.utils.device import resolve_device

FIELDS = ("xyz", "scaling", "rotation", "opacity")


def field_stats(a: torch.Tensor) -> str:
    """min, max, absmax and the NaN and inf counts, as the script prints
    them."""
    return (f"min {float(a.min()):.4g} max {float(a.max()):.4g} "
            f"absmax {float(a.abs().max()):.4g} "
            f"nan {int(torch.isnan(a).sum())} inf {int(torch.isinf(a).sum())}")


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("path")
    parser.add_argument("--device", default=None,
                        help="default cuda; 'cpu' runs on the host")
    args = parser.parse_args(argv)
    dev = resolve_device(args.device)

    raw = np.load(args.path, allow_pickle=True)
    print("keys:", sorted(raw.files)[:8], "...")
    meta = json.loads(str(raw["meta"])) if "meta" in raw.files else {}
    print("meta:", meta)

    def arr(name):
        for k in raw.files:
            if k.endswith(name):
                return np.asarray(raw[k])
        return None

    alive = arr("alive")
    for field in FIELDS:
        a = None
        for k in raw.files:
            if f"gauss.{field}" in k or k == f"params/gauss/{field}":
                a = np.asarray(raw[k])
        if a is None:
            # search loosely
            cands = [k for k in raw.files if field in k and "mu" not in k
                     and "nu" not in k]
            print(f"{field}: candidates {cands[:4]}")
            if cands:
                a = np.asarray(raw[cands[0]])
        if a is None:
            continue
        al = torch.from_numpy(a).to(dev)
        if alive is not None and alive.shape[0] == a.shape[0]:
            al = al[torch.from_numpy(alive.astype(bool)).to(dev)]
        print(f"{field:10s} shape {a.shape} alive-stats: {field_stats(al)}")
    if alive is not None:
        print("alive:", int(alive.sum()), "/", alive.shape[0])


if __name__ == "__main__":
    main()
