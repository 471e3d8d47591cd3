"""The benchmark of fourdgs_tpu_torch: one run of one cell of BENCHMARK.json.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

Run from the checkout's root, on a machine with the cards the cell asks
for. Everything is found by name: the cell in BENCHMARK.json's
`workloads`, its configuration file (BENCHMARK.json's `configs`), its mix
`portbench/traffic/<traffic>.json`, its correctness limits
`portbench/limits/<cell>.json`, each per-layer metric's reader
`portbench/metrics/<metric>.py`. The mix's `kind` picks the driver:
`core/train_cell.py` or `core/serve_cell.py`.

`--trace 0` measures the cell's end-to-end metrics over `--seconds`;
`--trace 1` runs a shorter window under torch.profiler and reports the
cell's per-layer metrics, `busy_s`, `window_s` and the breakdown. Both
compare what the timed path produced with the plain reference
(portbench/reference/) and print each compared number beside its limit,
last on standard error and last in the result line. The last line of
standard output is the result: one JSON object.

`--control tf32` puts the reference, one precision down, in the program's
place; `--fault <name>` plants a fault under the timed path (core/common.py
FAULTS). Both exist to show that the comparison fails; the benchmark's own
runs use neither.

Exits 2 without the cards, 3 if JAX or the JAX package was imported.
"""
import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
BENCH = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "fourdgs_tpu")
# kernel and build caches at fixed paths inside the checkout
CACHES = {"TRITON_CACHE_DIR": "build/portbench/triton",
          "TORCH_EXTENSIONS_DIR": "build/portbench/torch_extensions"}


def load_cell(benchmark: dict, name: str) -> dict:
    """The cell `name` with its configuration, mix, limits and metrics,
    each read from its own file."""
    cells = {c["name"]: c for c in benchmark["workloads"]}
    if name not in cells:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    cell = dict(cells[name])
    configs = {c["name"]: c for c in benchmark["configs"]}
    cell["config_data"] = json.loads(
        (ROOT / configs[cell["config"]]["file"]).read_text())
    cell["mix"] = json.loads(
        (BENCH / "traffic" / f"{cell['traffic']}.json").read_text())
    cell["limits"] = json.loads(
        (BENCH / "limits" / f"{name}.json").read_text())

    def ours(metric):
        listed = metric.get("workloads")
        return name in listed if listed is not None else any(
            e["name"] == metric["moves"] for e in end_to_end(benchmark, name))
    cell["end_to_end"] = end_to_end(benchmark, name)
    cell["per_layer"] = [m for m in benchmark["per_layer"] if ours(m)]
    return cell


def end_to_end(benchmark: dict, name: str) -> list:
    return [m for m in benchmark["end_to_end"]
            if name in m.get("workloads", [name])]


def reader(metric: str):
    path = BENCH / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + metric.replace(".", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def card(torch) -> dict:
    """The card's name and power limit from nvidia-smi, where it runs."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30, check=True).stdout.strip().splitlines()[0]
        return {"card": out}
    except (OSError, subprocess.SubprocessError, IndexError):
        return {"card": torch.cuda.get_device_name(0)}


def result_line(cell: dict, outcome, run, device: dict) -> dict:
    """The result's object: the cell's end-to-end metrics (untraced) or
    per-layer metrics (traced) that the run could read, the device, the
    breakdown of a traced run, and the compared numbers with their limits
    last."""
    metrics = {}
    if run.trace:
        for m in cell["per_layer"]:
            value = reader(m["name"])(outcome, run)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        device = {**device, "busy_s": outcome.busy_s,
                  "window_s": outcome.window_s}
    else:
        for m in cell["end_to_end"]:
            if m["name"] in outcome.metrics:
                metrics[m["name"]] = {
                    "value": outcome.metrics[m["name"]][0],
                    "unit": m["unit"]}
    result = {"correct": outcome.correct, "attempted": outcome.attempted,
              "failed": outcome.failed, "metrics": metrics, "device": device}
    if run.trace and outcome.breakdown is not None:
        result["breakdown"] = outcome.breakdown
    result["compared"] = {k: {"value": v, "limit": lim}
                          for k, (v, lim) in outcome.compared.items()}
    return result


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    parser.add_argument("--control", choices=("tf32",), default=None)
    parser.add_argument("--fault", default=None)
    args = parser.parse_args(argv)
    for k, v in CACHES.items():
        os.environ[k] = str(ROOT / v)
    os.environ["USE_FLAX"] = "0"
    sys.path.insert(0, str(ROOT))

    import torch

    benchmark = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell = load_cell(benchmark, args.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell["chips"]:
        print(f"{args.workload} needs {cell['chips']} CUDA device(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2

    from portbench.core import common, serve_cell, train_cell
    from portbench.reference.precision import full_float32
    full_float32()
    kind = cell["mix"]["kind"]
    if args.fault is not None and args.fault not in common.FAULTS[kind]:
        raise SystemExit(f"no fault {args.fault!r} for a {kind} cell")
    run = common.Run(cell=cell, config=cell["config_data"], mix=cell["mix"],
                     seed=args.seed, seconds=args.seconds,
                     trace=bool(args.trace), device=torch.device("cuda", 0),
                     t0=T0, control=args.control, fault=args.fault)
    outcome = (train_cell if kind == "train" else serve_cell).run(run)

    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": 1, "memory_peak_bytes": outcome.memory_peak_bytes,
              **card(torch)}
    result = result_line(cell, outcome, run, device)
    print(json.dumps({"notes": outcome.notes}, default=str), flush=True)
    found = forbidden_modules()
    if found:
        print(f"imported after the window: {found}", file=sys.stderr)
        return 3
    for k, v in result["compared"].items():
        print(f"compared {k}: {v['value']!r} (limit {v['limit']!r})",
              file=sys.stderr)
    print(f"correct: {result['correct']}", file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
