"""Row scatter-add micro-benchmark (the counterpart of
scripts/exp_pallas_scatter.py, D3): out[idx[i]] += rows[i] through K4
(ops/scatter.py:scatter_add_rows, csrc/scatter.cu), at the script's two
shapes and seed: 131,072 rows of 128 into 4,096 cells (a HexPlane-like
backward) and 1,966,080 rows of 16 into 131,080 (a blend-gradient-like
one).

    python -m fourdgs_tpu_torch.tools.exp_scatter [--scale 1] [--seed 0]
        [--iters 20] [--device cpu]

K4 was born from the script's Pallas kernel (fourdgs_tpu/ops/pallas/
scatter.py), so the script's block and unroll variants have one
counterpart here. For each shape the tool prints `index_add_` (the
library call), K4, the plain version, K4's largest difference from
`index_add_` over the largest |value| (the atomics' order differs), and
the byte bound. `--scale` divides the row and cell counts, for a quick run
on the CPU, where only the plain version runs and times are host times.
`main` returns the numbers and the inputs.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from fourdgs_tpu_torch.ops.scatter import (scatter_add_rows,
                                           scatter_add_rows_plain)
from fourdgs_tpu_torch.utils.device import resolve_device
from fourdgs_tpu_torch.utils.timing import bound, clock, time_call, time_pair

# the script's shapes: rows, width, output rows
CASES = {"hexplane": (131_072, 128, 4096), "blend": (1_966_080, 16, 131_080)}


def make_inputs(scale: int, seed: int, device) -> dict:
    """Each case's (idx, rows, n_out), drawn in the script's order from one
    generator: rows normal, indices uniform over the output rows."""
    rng = np.random.default_rng(seed)
    cases = {}
    for name, (m, w, n_out) in CASES.items():
        m, n_out = m // scale, max(n_out // scale, 1)
        rows = rng.standard_normal((m, w)).astype(np.float32)
        idx = rng.integers(0, n_out, m).astype(np.int32)
        cases[name] = (torch.from_numpy(idx).to(device),
                       torch.from_numpy(rows).to(device), n_out)
    return cases


def scatter_bytes(idx, rows, n_out) -> int:
    """Indices and rows read once, the table written once."""
    return 4 * idx.numel() + 4 * rows.numel() + 4 * n_out * rows.shape[1]


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--scale", type=int, default=1)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--iters", type=int, default=20)
    parser.add_argument("--device", default=None)
    args = parser.parse_args(argv)
    dev = resolve_device(args.device)
    print(f"timing: {clock(dev)}", flush=True)
    res = {}
    for name, (idx, rows, n_out) in make_inputs(args.scale, args.seed,
                                                dev).items():
        def library():
            return torch.zeros((n_out, rows.shape[1]), device=dev).index_add_(
                0, idx.long(), rows)

        ref = library()
        got = scatter_add_rows(idx, rows, n_out=n_out)
        err = float((got - ref).abs().max()) / max(float(ref.abs().max()),
                                                   1e-30)
        lib_ms = time_call(library, args.iters, dev)
        ms, plain_ms = time_pair(
            lambda: scatter_add_rows(idx, rows, n_out=n_out),
            lambda: scatter_add_rows_plain(idx, rows, n_out=n_out),
            args.iters, dev)
        nbytes = scatter_bytes(idx, rows, n_out)
        rec = {"ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
               "rel_err_vs_library": err, "nbytes": nbytes,
               "shape": [int(idx.numel()), int(rows.shape[1]), int(n_out)],
               **bound(nbytes)}
        print(f"{name} ({idx.numel()} x {rows.shape[1]} -> {n_out}): "
              f"index_add_ {lib_ms:.4f} ms, scatter_add_rows {ms:.4f} ms "
              f"(err {err:.1e}), plain {plain_ms:.4f} ms; {nbytes} bytes, "
              f"bound {rec['bound_ms']:.4f} ms", flush=True)
        rec["inputs"] = {"idx": idx, "rows": rows, "n_out": n_out}
        res[name] = rec
    return res


if __name__ == "__main__":
    main()
