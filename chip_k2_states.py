#!/usr/bin/env python3
"""K2 (the fused blend backward) against the plain backward on short
training runs of other scenes and tile sizes than chip_smoke.py's.

    python3 chip_k2_states.py [--seed 1] [--tile-size 16]

Runs chip_smoke.py's phases 1-6 on one card at --frames 4 and --steps 9:
the scene of --seed, served for 4 frames (phase 3, K1 checked against the
plain blend), 9 fine train_steps at 800x800 with one step's gradients
through K2 checked against the plain backward on each training view and
on the kernel check's view (phase 5), then K2 on that view's step input
against its plain version, with its counting build's atomics and reduced
batches (phase 6). Prints one JSON line with the per-view errors, K2's
error and time, and the counts; exits nonzero if a check fails. One
process per state, so each starts from a fresh scene and build cache.
"""
import argparse
import json
import sys
import time

import chip_smoke as cs


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=1)
    parser.add_argument("--tile-size", type=int, default=32,
                        choices=(16, 32))
    args = parser.parse_args(argv)

    import torch
    cs.phase_device(torch)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    cs.RASTER = dict(cs.RASTER, tile_size=args.tile_size)
    cs.phase_build()
    work = cs.ROOT / "build" / "k2_states" / f"{args.seed}_{args.tile_size}"
    work.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    scene = cs.make_scene(torch, args.seed, device)
    renderer, _, _, _ = cs.phase_slice(torch, scene, device, 4, work)
    state, rc, bg, sh, check_cam, gt, _, train = cs.phase_train(
        torch, scene, renderer, device, 9, args.seed)
    k2, _, _ = cs.phase_kernels_bwd(torch, state, rc, bg, sh, check_cam, gt)
    print(json.dumps({
        "seed": args.seed, "tile_size": args.tile_size,
        "step_grad_errs": train["step_grad_errs"],
        "k2_max_normalised_err": k2["max_normalised_err"], "k2_ms": k2["ms"],
        "float2_atomics": k2["float2_atomics"],
        "reduced_batches": k2["reduced_batches"],
        "bwd_work_reduced_batches": k2["sums"]["reduced_batches"],
        "seconds": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
