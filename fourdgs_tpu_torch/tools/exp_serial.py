"""Serial scalar-store micro-benchmark (the counterpart of
scripts/exp_pallas_serial.py, D4): 2^18 pairs into a 960,000-element int32
table, at the script's shapes and seed.

    python -m fourdgs_tpu_torch.tools.exp_serial [--n_pairs 262144]
        [--seed 0] [--iters 20] [--device cpu]

  * store (D4a, ops/serial.py:scalar_store): out[idx[i]] = val[i] in
    order, the last write winning among repeated indices;
  * counter (D4b, ops/serial.py:tile_counter_store): r = cnt[t]++ over 625
    tiles in order, then out[min(t * 1536 + r, 960,000 - 1)] = val[i].

The tool prints each kernel's and its plain version's time, the pairs per
second and the byte bound, and on the card the device time of each kernel
and fill that a call launches (the event time of back-to-back calls of so
small a function includes the wrapper's host path). No single PyTorch call computes either:
indexed assignment leaves the winner among repeated indices undefined, so
it is no yardstick. On the CPU only the plain versions run, and their
times are host times. `main` returns the numbers and the inputs.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from fourdgs_tpu_torch.ops.serial import (scalar_store, scalar_store_plain,
                                          tile_counter_store,
                                          tile_counter_store_plain)
from fourdgs_tpu_torch.utils.device import resolve_device
from fourdgs_tpu_torch.utils.timing import (bound, clock, kernel_times,
                                            time_pair)

N_PAIRS = 1 << 18
TILE_CAP = 1536
NT = 625
TABLE = NT * TILE_CAP          # gidx-sized: 960,000 int32


def make_inputs(n_pairs: int, seed: int, device) -> dict:
    """The script's draws, in its order: table indices, tile ids, values."""
    rng = np.random.default_rng(seed)
    arrays = {"idx": rng.integers(0, TABLE, n_pairs),
              "tid": rng.integers(0, NT, n_pairs),
              "val": rng.integers(0, 1 << 20, n_pairs)}
    return {k: torch.from_numpy(v.astype(np.int32)).to(device)
            for k, v in arrays.items()}


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--n_pairs", type=int, default=N_PAIRS)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--iters", type=int, default=20)
    parser.add_argument("--device", default=None)
    args = parser.parse_args(argv)
    dev = resolve_device(args.device)
    print(f"timing: {clock(dev)}", flush=True)
    inp = make_inputs(args.n_pairs, args.seed, dev)
    idx, tid, val = inp["idx"], inp["tid"], inp["val"]
    m = idx.numel()
    kw = dict(n_tiles=NT, tile_cap=TILE_CAP, n_out=TABLE)
    runs = {
        "store": (lambda: scalar_store(idx, val, n_out=TABLE),
                  lambda: scalar_store_plain(idx, val, n_out=TABLE),
                  8 * m + 4 * TABLE),
        "counter": (lambda: tile_counter_store(tid, val, **kw),
                    lambda: tile_counter_store_plain(tid, val, **kw),
                    8 * m + 4 * TABLE + 4 * NT),
    }
    res = {"repeats": m - int(torch.unique(idx).numel())}
    for name, (kernel, plain, nbytes) in runs.items():
        ms, plain_ms = time_pair(kernel, plain, args.iters, dev)
        res[name] = {"ms": ms, "plain_ms": plain_ms, "nbytes": nbytes,
                     "pairs_per_s": m / (ms / 1e3), **bound(nbytes)}
        print(f"{name:10s} {ms:9.4f} ms  {m / ms / 1e3:10.1f} Mpairs/s  "
              f"plain {plain_ms:9.4f} ms  bound {res[name]['bound_ms']:.4f} "
              f"ms ({nbytes} bytes)", flush=True)
        if dev.type == "cuda":
            passes = kernel_times(kernel)
            res[name].update(passes_ms=passes,
                             device_ms=sum(passes.values()))
            print(f"{'':10s} device {res[name]['device_ms']:.4f} ms a call: "
                  + ", ".join(f"{k} {v:.4f}" for k, v in passes.items()),
                  flush=True)
    print(f"repeated indices: {res['repeats']} of {m}", flush=True)
    res["inputs"] = inp
    return res


if __name__ == "__main__":
    main()
