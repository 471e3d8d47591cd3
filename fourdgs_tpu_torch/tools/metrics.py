"""Metrics CLI: PSNR, SSIM, MS-SSIM and D-SSIM (and LPIPS where its
weights are present) of the rendered test views against their targets
(counterpart: scripts/metrics.py).

    python -m fourdgs_tpu_torch.tools.metrics -m <model> [<model> ...] \\
        [--device cpu]

For each `<model>/test/<method>/renders` against `gt` (the render CLI's
output) every view is scored with the port's `ops/losses.py`: PSNR, SSIM,
MS-SSIM and D-SSIM = (1 - MS-SSIM) / 2, and `lpips-vgg` / `lpips-alex`
through `ops/lpips.py` for each network whose npz is found. The means go
to <model>/results.json and the per-view values to <model>/per_view.json,
with the JAX script's keys and layout. Images are read with the port's
PNG codec (data/png.py).
"""
from __future__ import annotations

import argparse
import json
import os
from collections.abc import Callable

import numpy as np
import torch

from fourdgs_tpu_torch.data.png import read_png
from fourdgs_tpu_torch.ops import losses
from fourdgs_tpu_torch.ops import lpips as lpips_mod
from fourdgs_tpu_torch.utils.device import resolve_device

LPIPS_NETS = ("vgg", "alex")


def read_images(renders_dir: str, gt_dir: str
                ) -> tuple[list, list, list[str]]:
    """The renders and their targets as float32 (H, W, 3) in [0, 1], by
    sorted file name."""
    names = sorted(os.listdir(renders_dir))

    def load(path):
        return read_png(path).astype(np.float32)[..., :3] / 255.0

    renders = [load(os.path.join(renders_dir, n)) for n in names]
    gts = [load(os.path.join(gt_dir, n)) for n in names]
    return renders, gts, names


def lpips_fns(device) -> Callable | None:
    """A function (render, gt) -> {"lpips-<net>": value} over the
    networks whose weights are present, or None when none is; then it
    prints which files are missing and how to make them."""
    nets = {k: lpips_mod.make_lpips_fn(k, device=device) for k in LPIPS_NETS}
    nets = {k: v for k, v in nets.items() if v is not None}
    if nets:
        return lambda r, g: {f"lpips-{k}": fn(r, g) for k, fn in nets.items()}
    print(
        "LPIPS: skipped — missing weight files:\n"
        + "".join(f"  {lpips_mod.default_weights_path(k)}\n"
                  for k in LPIPS_NETS)
        + "  To produce them, run ONCE on any machine with torchvision\n"
        "  + network access (this image has neither):\n"
        "    python scripts/export_lpips_weights.py --net alex "
        "--out weights/lpips_alex.npz\n"
        "    python scripts/export_lpips_weights.py --net vgg "
        "--out weights/lpips_vgg.npz\n"
        "  then copy the npz (+ .sha256 sidecar) into <repo>/weights/.\n"
        "  All other metrics are still computed.")
    return None


@torch.no_grad()
def score_view(render: np.ndarray, gt: np.ndarray, device,
               lpips_fn: Callable | None) -> dict:
    r = torch.from_numpy(render).to(device)[None]
    g = torch.from_numpy(gt).to(device)[None]
    row = {"PSNR": float(losses.psnr(r, g)[0]),
           "SSIM": float(losses.ssim(r, g)),
           "MS-SSIM": float(losses.ms_ssim(r, g)[0])}
    row["D-SSIM"] = (1 - row["MS-SSIM"]) / 2
    if lpips_fn is not None:
        row.update(lpips_fn(render, gt))
    return row


def evaluate(model_paths: list[str], device=None) -> dict:
    """Score every method under each model's test/; returns
    {model_path: results} and writes results.json and per_view.json."""
    dev = resolve_device(device)
    lpips_fn = lpips_fns(dev)
    out = {}
    for scene_dir in model_paths:
        print(f"Scene: {scene_dir}")
        full, per_view = {}, {}
        test_dir = os.path.join(scene_dir, "test")
        for method in sorted(os.listdir(test_dir)):
            print(f"  Method: {method}")
            mdir = os.path.join(test_dir, method)
            renders, gts, names = read_images(os.path.join(mdir, "renders"),
                                              os.path.join(mdir, "gt"))
            rows = [score_view(r, g, dev, lpips_fn)
                    for r, g in zip(renders, gts)]
            keys = rows[0].keys()
            agg = {k: float(np.mean([r[k] for r in rows])) for k in keys}
            for k, v in agg.items():
                print(f"    {k:8s}: {v:.7f}")
            full[method] = agg
            per_view[method] = {
                k: {name: r[k] for name, r in zip(names, rows)} for k in keys}
        with open(os.path.join(scene_dir, "results.json"), "w") as f:
            json.dump(full, f, indent=2)
        with open(os.path.join(scene_dir, "per_view.json"), "w") as f:
            json.dump(per_view, f, indent=2)
        out[scene_dir] = full
    return out


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description="4DGS metrics (PyTorch)")
    parser.add_argument("--model_paths", "-m", nargs="+", required=True)
    parser.add_argument("--device", default=None,
                        help="default cuda; 'cpu' runs on the CPU")
    args = parser.parse_args(argv)
    return evaluate(args.model_paths, args.device)


if __name__ == "__main__":
    main()
