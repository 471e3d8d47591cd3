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
bytes. On the card it also prints each kernel's device time (torch.profiler)
and the instructions a lane could issue per evaluation in that time at the
FP32 issue peak (`issue_per_eval`); the SM clock and power that nvidia-smi
reads while each kernel runs back to back (`clocks_under`), since the
bounds are priced at the H100's 1.98 GHz boost clock; and the opcodes that
`cuobjdump -sass` finds in each body's innermost loop (the unrolled rows;
dma_only's chunk loop) and per evaluation there (`sass_loop`). On the CPU
only the plain versions run, and their times are host times. `main`
returns the numbers and the inputs.
"""
from __future__ import annotations

import argparse
import os
import re
import shutil
import subprocess
import time
from datetime import datetime
from pathlib import Path

import numpy as np
import torch

from fourdgs_tpu_torch.ops import blend_variants
from fourdgs_tpu_torch.utils.device import resolve_device
from fourdgs_tpu_torch.utils.timing import (BOOST_HZ, FP32_ISSUE_S, bound,
                                            clock, kernel_times, time_pair)

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


def _kernel_constant(name: str) -> int:
    src = (Path(blend_variants.__file__).resolve().parent.parent / "csrc"
           / "blend_variants.cu").read_text()
    return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))


def sass_loop(library: str) -> dict:
    """Per body, the opcode counts of its kernel's innermost loop in
    `cuobjdump -sass` of the kernels' library (the shortest span that a
    backward branch closes and that holds FP32 work) and the evaluations
    one pass of it makes:
    kRowUnroll rows x kPix pixels, or kPix pixels of one chunk for
    dma_only (csrc/blend_variants.cu)."""
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    tool = shutil.which("cuobjdump") or os.path.join(home, "bin", "cuobjdump")
    text = subprocess.run([tool, "-sass", library], capture_output=True,
                          text=True, check=True).stdout
    pix, unroll = _kernel_constant("kPix"), _kernel_constant("kRowUnroll")
    out = {}
    for func in text.split("Function : ")[1:]:
        m = re.search(r"blend_variant_kernelILi(\d)E", func.split("\n", 1)[0])
        if not m:
            continue
        body = blend_variants.BODIES[int(m.group(1))]
        code = [(int(a, 16), op.strip()) for a, op in re.findall(
            r"/\*([0-9a-f]{4,})\*/\s+([^;]*);", func)]
        ops = [(at, re.sub(r"^@!?U?P\w+\s+", "", op).split()[0])
               for at, op in code]
        loops = sorted(((int(t, 16), at) for at, op in code
                        for t in re.findall(r"\bBRA\b.*?(0x[0-9a-f]+)", op)
                        if int(t, 16) < at), key=lambda lh: lh[1] - lh[0])
        # the shortest loop with FP32 work: not an mbarrier's spin loop
        lo, hi = next((lo, hi) for lo, hi in loops if any(
            lo <= at <= hi and op.startswith(("FFMA", "FADD", "FMUL"))
            for at, op in ops))
        counts: dict[str, int] = {}
        for at, op in ops:
            if lo <= at <= hi:
                counts[op] = counts.get(op, 0) + 1
        evals = pix * (1 if body == "dma_only" else unroll)
        total = sum(counts.values())
        out[body] = {"instructions": total, "evaluations": evals,
                     "per_eval": total / evals,
                     "mufu_ex2_per_eval": counts.get("MUFU.EX2", 0) / evals,
                     "opcodes": dict(sorted(counts.items(),
                                            key=lambda kv: -kv[1]))}
    return out


def clocks_under(fn, seconds: float = 1.0) -> dict:
    """The SM clock (MHz) and power draw (W) that nvidia-smi samples every
    20 ms while fn runs back to back on the card for `seconds`: the median,
    least and largest of the samples taken inside that window."""
    smi = subprocess.Popen(
        ["nvidia-smi", "--query-gpu=timestamp,clocks.sm,power.draw",
         "--format=csv,noheader,nounits", "-lms", "20"],
        stdout=subprocess.PIPE, text=True)
    try:
        time.sleep(0.5)                      # the sampler's start-up
        fn()
        torch.cuda.synchronize()
        t0 = time.time()
        while time.time() - t0 < seconds:
            fn()
        torch.cuda.synchronize()
        t1 = time.time()
    finally:
        smi.terminate()
    samples = []
    for line in smi.communicate()[0].splitlines():
        stamp, mhz, watts = (f.strip() for f in line.split(","))
        at = datetime.strptime(stamp, "%Y/%m/%d %H:%M:%S.%f").timestamp()
        if t0 + 0.05 <= at <= t1 - 0.05:
            samples.append((float(mhz), float(watts)))
    if not samples:
        raise RuntimeError("nvidia-smi took no sample while the kernel ran")
    out = {"samples": len(samples)}
    for i, key in enumerate(("sm_mhz", "power_w")):
        vals = sorted(v[i] for v in samples)
        out[key] = {"median": vals[len(vals) // 2], "min": vals[0],
                    "max": vals[-1]}
    return out


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
        line = f"{body:12s} {ms:9.4f} ms  plain {plain_ms:9.4f} ms"
        if dev.type == "cuda":
            rec.update(bound(nbytes, FP32_PER_ROW.get(body, 0) * evals,
                             MUFU_PER_ROW.get(body, 0) * evals))
            rec["device_ms"] = sum(kernel_times(lambda: kernel(attrs,
                                                               px)).values())
            rec["issue_per_eval"] = rec["device_ms"] * 1e-3 * FP32_ISSUE_S \
                / evals
            rec["clocks"] = clocks_under(lambda: kernel(attrs, px))
            mhz = rec["clocks"]["sm_mhz"]["median"]
            # the bound at the clock the card held, for the FP32 and SFU
            # bounds, which scale with it (the byte bound does not)
            rec["bound_ms_at_clock"] = rec["bound_ms"] * (
                BOOST_HZ / 1e6 / mhz if rec["bound_by"] == "operations"
                else 1.0)
            line += (
                f"  bound {rec['bound_ms']:.4f} ms ({rec['bound_resource']});"
                f" device {rec['device_ms']:.4f} ms, "
                f"{rec['issue_per_eval']:.2f} lane issue slots an evaluation"
                f"\n{'':12s} SM clock {rec['clocks']['sm_mhz']} MHz, power "
                f"{rec['clocks']['power_w']} W over "
                f"{rec['clocks']['samples']} samples; bound at that clock "
                f"{rec['bound_ms_at_clock']:.4f} ms, "
                f"{rec['bound_ms_at_clock'] / rec['device_ms']:.1%} of the "
                f"device time")
        print(line, flush=True)
        res[body] = rec
    if dev.type == "cuda":
        from fourdgs_tpu_torch.ops._build import build
        res["sass_loop"] = sass_loop(str(build()))
        for body, rec in res["sass_loop"].items():
            print(f"{body:12s} SASS loop: {rec['instructions']} instructions "
                  f"for {rec['evaluations']} evaluations, "
                  f"{rec['per_eval']:.2f} an evaluation, MUFU.EX2 "
                  f"{rec['mufu_ex2_per_eval']:.2f}; {rec['opcodes']}",
                  flush=True)
    res["inputs"] = {"attrs": attrs, "px": px}
    return res


if __name__ == "__main__":
    main()
