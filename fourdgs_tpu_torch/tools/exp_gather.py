"""Row-gather micro-benchmark (the counterpart of
scripts/exp_pallas_gather.py, D1): out[i] = table[idx[i]] from a table of
131,072 x 16 float32 (8 MiB) at 2^20 indices, at the script's shapes and
seed.

    python -m fourdgs_tpu_torch.tools.exp_gather [--rows 131072]
        [--width 16] [--n_idx 1048576] [--seed 0] [--iters 20]
        [--device cpu]

The script timed four Pallas formulations of one gather against XLA's. On
the card one kernel (csrc/gather.cu) computes it, with 16-byte loads, four
threads to a row. The tool prints `torch.index_select` (the library call),
the kernel and the plain version, whether the kernel equals the library
call, and the byte bound. `main` returns the numbers and the inputs. On
the CPU only the plain version runs, and its times are host times.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from fourdgs_tpu_torch.ops.gather import gather_rows, gather_rows_plain
from fourdgs_tpu_torch.utils.device import resolve_device
from fourdgs_tpu_torch.utils.timing import bound, clock, time_call, time_pair


def make_inputs(rows: int, width: int, n_idx: int, seed: int, device):
    """The script's table (normal) and indices (uniform over the rows)."""
    rng = np.random.default_rng(seed)
    table = rng.normal(size=(rows, width)).astype(np.float32)
    idx = rng.integers(0, rows, n_idx).astype(np.int32)
    return (torch.from_numpy(table).to(device),
            torch.from_numpy(idx).to(device))


def gather_bytes(table: torch.Tensor, idx: torch.Tensor) -> int:
    """Bytes the gather must move: the indices, each table row that some
    index names (once), and the output."""
    rows = int(torch.unique(idx.clamp(0, table.shape[0] - 1)).numel())
    row_bytes = 4 * table.shape[1]
    return 4 * idx.numel() + row_bytes * rows + row_bytes * idx.numel()


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--rows", type=int, default=1 << 17)
    parser.add_argument("--width", type=int, default=16)
    parser.add_argument("--n_idx", type=int, default=1 << 20)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--iters", type=int, default=20)
    parser.add_argument("--device", default=None)
    args = parser.parse_args(argv)
    dev = resolve_device(args.device)
    print(f"timing: {clock(dev)}", flush=True)
    table, idx = make_inputs(args.rows, args.width, args.n_idx, args.seed,
                             dev)
    ref = torch.index_select(table, 0, idx)
    lib_ms = time_call(lambda: torch.index_select(table, 0, idx), args.iters,
                       dev)
    print(f"{'index_select (library)':40s} {lib_ms:9.4f} ms", flush=True)
    match = bool(torch.equal(gather_rows(table, idx), ref))
    ms, plain_ms = time_pair(lambda: gather_rows(table, idx),
                             lambda: gather_rows_plain(table, idx),
                             args.iters, dev)
    print(f"{'gather_rows':40s} {ms:9.4f} ms   plain {plain_ms:9.4f} ms   "
          f"match: {match}", flush=True)
    res = {"library_ms": lib_ms, "ms": ms, "plain_ms": plain_ms,
           "match": match}
    nbytes = gather_bytes(table, idx)
    res.update(bound(nbytes), nbytes=nbytes)
    print(f"bound: {nbytes} bytes, {res['bound_ms']:.4f} ms at the H100's "
          f"3.35 TB/s", flush=True)
    res["inputs"] = {"table": table, "idx": idx}
    return res


if __name__ == "__main__":
    main()
