"""Counting-binner prototype micro-benchmark (the counterpart of
scripts/exp_pallas_binner_proto.py, D2): serial pair expansion and
per-tile rank for 131,072 gaussians in 32 chunks of 4,096, about 524k
pairs over 625 tiles (grid 25 x 25, tile_cap 1536), each chunk's rows in a
16,384-slot buffer, at the script's shapes and seed.

    python -m fourdgs_tpu_torch.tools.exp_binner_proto [--n 131072]
        [--g 4096] [--seed 0] [--iters 20] [--device cpu]

The inputs are built as the script builds them (:88-105): rect sizes sx,
sy in [1, 3] and corners x0, y0 in [0, 22), and slot0, each gaussian's
first pair within its chunk. The tool prints the kernels' time
(ops/binner_proto.py:expand_rank, csrc/binner_proto.cu) and pairs per
second, the plain version's time, the pairs past each chunk's buffer and
past tile_cap, the byte bound, and on the card each pass's device time
(the rank's histogram, scan and walk). No single PyTorch call computes it.
On the CPU only the plain version runs, and its times are host times.
`main` returns the numbers and the inputs.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from fourdgs_tpu_torch.ops.binner_proto import expand_rank, expand_rank_plain
from fourdgs_tpu_torch.utils.device import resolve_device
from fourdgs_tpu_torch.utils.timing import (bound, clock, kernel_times,
                                            time_pair)

PC, NT, GRID_X, TILE_CAP = 16384, 625, 25, 1536


def make_inputs(n: int, g: int, seed: int, device) -> tuple[dict, int]:
    """The script's six (n // g, 1, g) int32 inputs and the pair count."""
    rng = np.random.default_rng(seed)
    n_chunks = n // g
    sx = rng.integers(1, 4, n).astype(np.int32)
    sy = rng.integers(1, 4, n).astype(np.int32)
    x0 = rng.integers(0, 22, n).astype(np.int32)
    y0 = rng.integers(0, 22, n).astype(np.int32)
    touched = (sx * sy).astype(np.int32)
    off = np.concatenate([[0], np.cumsum(touched)])[:-1]
    chunk_start = off[::g]
    slot0 = (off - np.repeat(chunk_start, g)).astype(np.int32)
    gid = np.arange(n, dtype=np.int32)
    arrays = dict(x0=x0, y0=y0, sx=sx, sy=sy, slot0=slot0, gid=gid)
    return ({k: torch.from_numpy(v.reshape(n_chunks, 1, g)).to(device)
             for k, v in arrays.items()}, int(touched.sum()))


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--n", type=int, default=131_072)
    parser.add_argument("--g", type=int, default=4096)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--iters", type=int, default=20)
    parser.add_argument("--device", default=None)
    args = parser.parse_args(argv)
    if args.n % args.g:
        parser.error("--n must be a multiple of --g")
    dev = resolve_device(args.device)
    print(f"timing: {clock(dev)}", flush=True)
    inp, total = make_inputs(args.n, args.g, args.seed, dev)
    kw = dict(pc=PC, n_tiles=NT, grid_x=GRID_X, tile_cap=TILE_CAP)

    def kernel():
        return expand_rank(*inp.values(), **kw)

    out = kernel()
    per_chunk = (inp["sx"] * inp["sy"]).reshape(inp["sx"].shape[0], -1) \
        .sum(1)
    past_pc = int(torch.clamp(per_chunk - PC, min=0).sum())
    past_cap = int((out[..., 0] == NT * TILE_CAP).sum())
    ms, plain_ms = time_pair(kernel,
                             lambda: expand_rank_plain(*inp.values(), **kw),
                             args.iters, dev)
    nbytes = 4 * 6 * args.n + 4 * out.numel()
    res = {"ms": ms, "plain_ms": plain_ms, "pairs": total,
           "pairs_per_s": total / (ms / 1e3), "pairs_past_pc": past_pc,
           "chunks_past_pc": int((per_chunk > PC).sum()),
           "pairs_past_tile_cap": past_cap, "nbytes": nbytes,
           **bound(nbytes)}
    print(f"pairs {total / 1e3:.0f}k  kernel {ms:.4f} ms  rate "
          f"{total / ms / 1e3:.0f}M pairs/s  plain {plain_ms:.4f} ms; "
          f"{past_pc} pairs past pc in {res['chunks_past_pc']} chunks, "
          f"{past_cap} stored past tile_cap; {nbytes} bytes, bound "
          f"{res['bound_ms']:.4f} ms", flush=True)
    if dev.type == "cuda":
        res["passes_ms"] = kernel_times(kernel)
        res["device_ms"] = sum(res["passes_ms"].values())
        print(f"device {res['device_ms']:.4f} ms a call: " + ", ".join(
            f"{k} {v:.4f}" for k, v in res["passes_ms"].items()),
            flush=True)
    res["inputs"] = inp
    return res


if __name__ == "__main__":
    main()
