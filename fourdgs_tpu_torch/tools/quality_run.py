"""A full quality run on a synthetic scene: make the scene, train it,
render it and score it, without and with the JAX package's four switches,
against the JAX package's record of the same scene.

    python -m fourdgs_tpu_torch.tools.quality_run [--protocol multiview] \\
        [--out build/synth_mv] [--size 400] [--n_cams 6] [--n_times 30] \\
        [--n_train 150] [--n_test 20] [--configs <config.py>] \\
        [--test_iterations 1000 2000 ...] [--device cpu]

Two protocols, each with its config and its record:

  * multiview (the default): a rig of --n_cams cameras over --n_times
    timestamps, camera 0 held out, `configs/dnerf/synth_mv.py`, against
    output/synth_mv_r5c (its results.json and per_view.json);
  * monocular: one spiral view per timestamp, --n_train and --n_test
    views (150 and 20), `configs/dnerf/synth_mono.py`, against
    output/synth_mono_r3 (its last in-loop test evaluation, 21.81 dB at
    fine 20,000; the record holds no post-hoc files).

The steps are the user's commands, run in one process:

    python -m fourdgs_tpu_torch.tools.make_synthetic_scene <out>/scene \\
        --protocol multiview --size 400 --n_cams 6 --n_times 30
    python -m fourdgs_tpu_torch.tools.train -s <out>/scene \\
        -m <out>/model_<variant> --configs <configs> --image_size 400 400 \\
        --test_iterations 1000 2000 3000 5000 ...
    python -m fourdgs_tpu_torch.tools.render -m <out>/model_<variant> \\
        -s <out>/scene --image_size 400 400
    python -m fourdgs_tpu_torch.tools.metrics -m <out>/model_<variant>

The variant `default` trains with none of the switches set (the fused
blend backward, K2); `switches` sets all four (K3 and its K4 reduction, K4
in the HexPlane backward, K5 in the binner), as chip_smoke.py's phase 7
does. The train CLI's seed is its default, 6666, the JAX run's. For each
variant the run reports each stage's ms/iteration (the train CLI's time
without evals and saves), its captures' seconds and their share of the
stage's wall time, its peak live count, the in-loop test PSNRs, the
post-hoc PSNR, SSIM and MS-SSIM, each split's render FPS, each test
view's post-hoc PSNR (beside the record's `per_view.json` where it has
one), and whether the post hoc fell below the protocol's fault floor. It
prints one JSON line per variant, then one with both, the card's name and
power limit, and writes that to <out>/quality_run.json.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import shutil
import time

import numpy as np
import torch

from fourdgs_tpu_torch.tools import make_synthetic_scene
from fourdgs_tpu_torch.tools import metrics as metrics_cli
from fourdgs_tpu_torch.tools import render as render_cli
from fourdgs_tpu_torch.tools import train as train_cli
from fourdgs_tpu_torch.tools.bench import card_limit
from fourdgs_tpu_torch.train import graphs
from fourdgs_tpu_torch.utils.device import resolve_device

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
CONFIGS = os.path.join(REPO, "fourdgs_tpu", "configs", "dnerf")
# each protocol's config, the JAX package's record of its scene and the
# default output directory; a post hoc below `floor_db` is a fault of the
# port (ROADMAP Queue 3)
PROTOCOLS = {
    "multiview": {"configs": os.path.join(CONFIGS, "synth_mv.py"),
                  "reference": os.path.join(REPO, "output", "synth_mv_r5c"),
                  "out": os.path.join("build", "synth_mv"),
                  "floor_db": 32.8},
    "monocular": {"configs": os.path.join(CONFIGS, "synth_mono.py"),
                  "reference": os.path.join(REPO, "output", "synth_mono_r3"),
                  "out": os.path.join("build", "synth_mono"),
                  "floor_db": 21.3},
}
TEST_ITERATIONS = (1000, 2000, 3000, 5000, 7000, 10000, 14000, 17000, 20000)
VARIANTS = {"default": {}, "switches": graphs.SWITCHES_ON}


@contextlib.contextmanager
def environment(values: dict):
    """The switches as `values` sets them, every other one unset, for a
    block; the environment as it was after."""
    saved = {k: os.environ.get(k) for k in graphs.SWITCHES}
    for k in graphs.SWITCHES:
        os.environ.pop(k, None)
    os.environ.update(values)
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def stage_report(stage: dict) -> dict:
    """ms/iteration, the live count's peak and end, captures and evals of
    one stage of the train CLI's summary."""
    n = stage["iterations"] - stage["start"]
    points = ([h["points"] for h in stage["history"]]
              + [e["points"] for e in stage["events"]])
    captured = stage["graphs"] or {"captures": [], "replays": 0}
    capture_s = sum(c["seconds"] for c in captured["captures"])
    return {"iterations": n, "seconds": stage["wall_time"],
            "ms_per_iteration": 1e3 * stage["wall_time"] / n,
            "peak_points": max(points),
            "points_last": stage["history"][-1]["points"],
            "capacity_last": stage["history"][-1]["capacity"],
            "tile_cap": stage["raster_cfg"]["tile_cap"],
            "captures": len(captured["captures"]),
            "capture_s": capture_s,
            "capture_share": capture_s / stage["wall_time"],
            "replays": captured["replays"],
            "rollbacks": sum(e["kind"] == "rollback"
                             for e in stage["events"]),
            "peak_mib": (stage["peak_bytes"] or 0) / 2**20,
            "test_psnr": stage["test_psnr"]}


def reference_record(path: str) -> dict | None:
    """What the checkout holds of a JAX record: its results.json, and the
    last in-loop test evaluation of its train_log.jsonl."""
    out = {"path": os.path.relpath(path, REPO)}
    results = os.path.join(path, "results.json")
    if os.path.exists(results):
        with open(results) as f:
            out["results"] = json.load(f)
    log = os.path.join(path, "train_log.jsonl")
    if os.path.exists(log):
        with open(log) as f:
            evals = [r for r in map(json.loads, f)
                     if r.get("eval") == "test" and r["stage"] == "fine"]
        if evals:
            out["in_loop_test_psnr"] = [evals[-1]["iter"],
                                        evals[-1]["psnr"]]
    return out if len(out) > 1 else None


def per_view(model: str, method: str, reference: str) -> dict:
    """Each test view's post-hoc PSNR, and the reference's beside it
    (where the checkout holds it)."""
    with open(os.path.join(model, "per_view.json")) as f:
        mine = json.load(f)[method]["PSNR"]
    out = {"psnr": mine}
    path = os.path.join(reference, "per_view.json")
    if os.path.exists(path):
        with open(path) as f:
            ref = next(iter(json.load(f).values()))["PSNR"]
        names = sorted(set(mine) & set(ref))
        d = np.array([mine[n] - ref[n] for n in names])
        out.update(reference=ref, views_compared=len(names),
                   mean_diff=float(d.mean()), min_diff=float(d.min()),
                   max_diff=float(d.max()),
                   corr=float(np.corrcoef([mine[n] for n in names],
                                          [ref[n] for n in names])[0, 1]))
    return out


def run_variant(name: str, args, scene: str, dev: torch.device) -> dict:
    model = os.path.join(args.out, f"model_{name}")
    shutil.rmtree(model, ignore_errors=True)
    size = [str(args.size)] * 2
    with environment(VARIANTS[name]):
        t0 = time.perf_counter()
        summary = train_cli.main([
            "-s", scene, "-m", model, "--configs", args.configs,
            "--image_size", *size, "--quiet", "--device", dev.type,
            "--test_iterations", *map(str, args.test_iterations)])
        t_train = time.perf_counter() - t0
        rendered = render_cli.main(["-m", model, "-s", scene,
                                    "--image_size", *size, "--device",
                                    dev.type])
        (results,) = metrics_cli.main(["-m", model, "--device",
                                       dev.type]).values()
    method = f"ours_{rendered['iteration']}"
    stages = {s["stage"]: stage_report(s) for s in summary["stages"]}
    in_loop = stages["fine"]["test_psnr"][-1]
    post = results[method]
    floor = PROTOCOLS[args.protocol]["floor_db"]
    return {"variant": name, "switches": VARIANTS[name],
            "seconds_train_cli": t_train, "stages": stages,
            "in_loop_test_psnr": in_loop, "post_hoc": post,
            "post_hoc_minus_in_loop": post["PSNR"] - in_loop[1],
            "render_fps": {k: v["fps"] for k, v in
                           rendered["splits"].items()},
            "render_views": {k: v["views"] for k, v in
                             rendered["splits"].items()},
            "render_passes": {k: v["passes"] for k, v in
                              rendered["splits"].items()},
            "per_view": per_view(model, method,
                                 PROTOCOLS[args.protocol]["reference"]),
            "fault_floor_db": floor, "below_floor": post["PSNR"] < floor}


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--protocol", choices=sorted(PROTOCOLS),
                        default="multiview")
    parser.add_argument("--out", default=None,
                        help="default: the protocol's, under build/")
    parser.add_argument("--size", type=int, default=400)
    parser.add_argument("--n_cams", type=int, default=6,
                        help="multiview: cameras of the rig")
    parser.add_argument("--n_times", type=int, default=30,
                        help="multiview: timestamps a camera sees")
    parser.add_argument("--n_train", type=int, default=150,
                        help="monocular: training views")
    parser.add_argument("--n_test", type=int, default=20,
                        help="monocular: test views")
    parser.add_argument("--configs", default=None,
                        help="default: the protocol's config")
    parser.add_argument("--test_iterations", nargs="+", type=int,
                        default=list(TEST_ITERATIONS))
    parser.add_argument("--device", default=None,
                        help="default cuda; 'cpu' runs the plain path")
    args = parser.parse_args(argv)
    protocol = PROTOCOLS[args.protocol]
    args.configs = args.configs or protocol["configs"]
    args.out = args.out or protocol["out"]
    dev = resolve_device(args.device)
    os.makedirs(args.out, exist_ok=True)
    scene = os.path.join(args.out, "scene")
    shutil.rmtree(scene, ignore_errors=True)
    t0 = time.perf_counter()
    if args.protocol == "multiview":
        shape = {"n_cams": args.n_cams, "n_times": args.n_times}
    else:
        shape = {"n_train": args.n_train, "n_test": args.n_test}
    make_synthetic_scene.main(
        [scene, "--protocol", args.protocol, "--size", str(args.size),
         *(f for k, v in shape.items() for f in (f"--{k}", str(v))),
         "--device", dev.type])
    out = {"card": card_limit(dev) or "cpu", "torch": torch.__version__,
           "protocol": args.protocol, "size": args.size, **shape,
           "configs": os.path.relpath(args.configs, REPO),
           "seconds_scene": time.perf_counter() - t0, "variants": {}}
    ref = reference_record(protocol["reference"])
    if ref is not None:
        out["reference"] = ref
    for name in VARIANTS:
        res = run_variant(name, args, scene, dev)
        print(json.dumps(res), flush=True)
        out["variants"][name] = res
    with open(os.path.join(args.out, "quality_run.json"), "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
