"""Stripped variants of the blend forward's loop (the counterpart of
scripts/profile_kernel_variants.py, D6), on the data volume of the
100k-gaussian 800x800 frame: 2,504 tiles x 24 chunks x 32 rows of 16
floats (123 MB of attributes) against 256 pixels a tile, 492M pixel x row
evaluations, at the script's shapes and seed.

    python -m fourdgs_tpu_torch.tools.profile_kernel_variants
        [--tiles 2504] [--seed 0] [--iters 10] [--device cpu]

The four bodies (ops/blend_variants.py, csrc/blend_variants.cu): the
attributes' movement alone (dma_only), one slice and an exp (exp_only),
ten slices (slices), two prefix products (scans). For each the tool prints
the kernel's and the plain version's time and the bound. On the card the
bound of exp_only, slices and scans is priced at the FP32 operations and
exps that their function needs a pixel x row (`FP32_PER_ROW`,
`MUFU_PER_ROW`), not at what the kernel happens to issue; dma_only's is its
bytes. On the CPU only the plain versions run, and their times are host
times. `main` returns the numbers and the inputs.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from fourdgs_tpu_torch.ops import blend_variants
from fourdgs_tpu_torch.utils.device import resolve_device
from fourdgs_tpu_torch.utils.timing import bound, clock, time_pair

NT, NCH, P = 2504, 24, 256
K, ATTR = blend_variants.CHUNK, blend_variants.ATTR_W
# What each body's function needs a pixel x row, whatever code computes
# it, so that the bound does not move with the kernel under test:
#   exp_only  x = a0 - px, x * x, times -0.5 log2(e), the running add: 4
#             FP32 operations and one exp2 (MUFU.EX2)
#   slices    a0 - px, nine multiply-adds a[i] * px, the running add: 11
#   scans     x = a0 * px, the multiply-adds 1 - 0.001 x and 1 - 0.002 x,
#             the two running products, their sum and the running add: 7
# (a multiply-add is one operation, as the card issues it)
FP32_PER_ROW = {"exp_only": 4, "slices": 11, "scans": 7}
MUFU_PER_ROW = {"exp_only": 1}


def make_inputs(tiles: int, seed: int, device):
    """The script's attrs (tiles, 768, 16) and px (tiles, 1, 256), both
    uniform in [0, 1)."""
    rng = np.random.default_rng(seed)
    attrs = rng.uniform(0, 1, (tiles, NCH * K, ATTR)).astype(np.float32)
    px = rng.uniform(0, 1, (tiles, 1, P)).astype(np.float32)
    return torch.from_numpy(attrs).to(device), torch.from_numpy(px).to(device)


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--tiles", type=int, default=NT)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--iters", type=int, default=10)
    parser.add_argument("--device", default=None)
    args = parser.parse_args(argv)
    dev = resolve_device(args.device)
    print(f"timing: {clock(dev)}", flush=True)
    attrs, px = make_inputs(args.tiles, args.seed, dev)
    evals = args.tiles * NCH * K * P
    nbytes = 4 * (attrs.numel() + 2 * px.numel())
    print(f"device={dev} volume={evals / 1e6:.0f}M elem, {nbytes} bytes",
          flush=True)
    res = {"evaluations": evals, "nbytes": nbytes}
    for body in blend_variants.BODIES:
        kernel = getattr(blend_variants, body)
        plain = getattr(blend_variants, body + "_plain")
        ms, plain_ms = time_pair(lambda: kernel(attrs, px),
                                 lambda: plain(attrs, px), args.iters, dev)
        rec = {"ms": ms, "plain_ms": plain_ms}
        if dev.type == "cuda":
            rec.update(bound(nbytes, FP32_PER_ROW.get(body, 0) * evals,
                             MUFU_PER_ROW.get(body, 0) * evals))
        print(f"{body:12s} {ms:9.4f} ms  plain {plain_ms:9.4f} ms" + (
            f"  bound {rec['bound_ms']:.4f} ms ({rec['bound_resource']})"
            if "bound_ms" in rec else ""), flush=True)
        res[body] = rec
    res["inputs"] = {"attrs": attrs, "px": px}
    return res


if __name__ == "__main__":
    main()
