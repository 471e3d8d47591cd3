"""The port's CLIs run with the JAX package out of reach.

`command(repo, steps)` is the command line of a fresh interpreter
(`python3 -c`) whose first act is to load this file by its path and
install an audit hook (`sys.addaudithook`) that refuses, and counts:

  * an `open` event whose path resolves under <repo>/fourdgs_tpu/ (the JAX
    package's tree: its modules and its config files);
  * an `import` event for jax, jaxlib, or `fourdgs_tpu` or a module under
    it. Names are compared by their first dotted component, so
    `fourdgs_tpu_torch` passes.

The hook counts before it raises, since a broad `except` in the code under
test could swallow the error: the count decides. An open raises
PermissionError; an import raises ModuleNotFoundError, as on a machine
without the module, so that a library's optional import (`try: import jax`)
goes on as it would there, counted all the same. A
refused module that was already imported when the hook went in counts too
(its later imports would raise no event). Then the program runs each step,
a module of the port and its arguments, through `runpy` (the module's code
in a fresh namespace, as `python -m` runs it) and calls its `main(argv)`,
keeping what it returns. It exits 1 if any event was refused, and at exit,
whether the steps ended or one failed, prints one line
`{"standalone": {...}}`: the refused count and the first events, the steps
that ended with their seconds, and, once all ended, `figures` of a
train → render → metrics chain and the kernels' runs (`graphs.kernel_runs`)
of the whole process.

This file imports the standard library only: it is loaded before the hook
is in place. chip_smoke.py's phase 22 runs it on the card, and
tests/test_torch_standalone.py on the CPU, where JAX is importable.
"""
from __future__ import annotations

import atexit
import json
import os
import runpy
import sys
import time

REFUSED_MODULES = ("jax", "jaxlib", "fourdgs_tpu")
JAX_TREE = "fourdgs_tpu"          # the JAX package's directory in the repo
KEPT_EVENTS = 20
MARK = "standalone"
CHAIN = ("fourdgs_tpu_torch.tools.train", "fourdgs_tpu_torch.tools.render",
         "fourdgs_tpu_torch.tools.metrics")
PROGRAM = """\
import importlib.util
spec = importlib.util.spec_from_file_location("_standalone", {path!r})
guard = importlib.util.module_from_spec(spec)
spec.loader.exec_module(guard)
guard.run({repo!r}, {steps!r})
"""


def refused_module(name: str) -> bool:
    return name.split(".")[0] in REFUSED_MODULES


def under(path: str, tree: str) -> bool:
    """Whether `path` resolves to `tree` or below it, by path components."""
    parts = os.path.realpath(path).split(os.sep)
    root = tree.split(os.sep)
    return parts[:len(root)] == root


class Guard:
    """The audit hook: refuses and counts the events above."""

    def __init__(self, repo: str):
        self.tree = os.path.join(os.path.realpath(repo), JAX_TREE)
        self.count = 0
        self.events: list = []

    def refuse(self, event: str, what: str) -> None:
        self.count += 1
        if len(self.events) < KEPT_EVENTS:
            self.events.append([event, what])

    def __call__(self, event: str, args: tuple) -> None:
        if event == "open":
            path = args[0]
            if path is None or isinstance(path, int):
                return
            what = os.fsdecode(path)
            if not under(what, self.tree):
                return
        elif event == "import":
            what = args[0]
            if not refused_module(what):
                return
        else:
            return
        self.refuse(event, what)
        error = PermissionError if event == "open" else ModuleNotFoundError
        raise error(f"{MARK}: {event} of {what!r} refused")


def install(repo: str) -> Guard:
    guard = Guard(repo)
    for name in sorted(sys.modules):
        if refused_module(name):
            guard.refuse("imported before the hook", name)
    sys.addaudithook(guard)
    return guard


def figures(results: dict) -> dict:
    """From the train, render and metrics CLIs' returns: each stage's ms an
    iteration (the train CLI's wall time without evals and saves), the last
    in-loop test PSNR and the SH degree the run ended at, the post-hoc
    PSNR of the rendered iteration, and the render CLI's FPS by split."""
    train, rendered, metrics = (results[module] for module in CHAIN)
    (scored,) = metrics.values()
    stages = {st["stage"]: st for st in train["stages"]}
    fine = stages["fine"]
    return {
        "ms_per_iteration": {
            name: 1e3 * st["wall_time"] / (st["iterations"] - st["start"])
            for name, st in stages.items()},
        "in_loop_test_psnr": fine["test_psnr"][-1][1],
        "active_sh": fine["active_sh"],
        "iteration": rendered["iteration"],
        "post_hoc_test_psnr":
            scored[f"ours_{rendered['iteration']}"]["PSNR"],
        "fps": {split: res["fps"]
                for split, res in rendered["splits"].items()},
    }


def run(repo: str, steps: list) -> None:
    """Install the hook, then run the steps; see the module's docstring."""
    guard = install(repo)
    record: dict = {"steps": []}

    def report():
        record.update(refused=guard.count, events=guard.events)
        print(json.dumps({MARK: record}), flush=True)

    atexit.register(report)
    results = {}
    for module, argv in steps:
        t0 = time.perf_counter()
        results[module] = runpy.run_module(
            module, run_name="__standalone__")["main"](list(argv))
        record["steps"].append({"module": module,
                                "seconds": time.perf_counter() - t0})
    if all(module in results for module in CHAIN):
        record["figures"] = figures(results)
    graphs = sys.modules.get("fourdgs_tpu_torch.train.graphs")
    record["kernel_runs"] = graphs.kernel_runs() if graphs else {}
    if guard.count:
        raise SystemExit(f"{MARK}: {guard.count} refused event(s)")


def command(repo, steps) -> list:
    """`python3 -c` with the guard's program: `steps` is a sequence of
    (module, argv)."""
    program = PROGRAM.format(
        path=os.path.abspath(__file__), repo=str(repo),
        steps=[(module, [str(a) for a in argv]) for module, argv in steps])
    return [sys.executable, "-c", program]


def parse(stdout: str) -> dict:
    """The program's record: its last `{"standalone": ...}` line."""
    lines = [line for line in stdout.splitlines()
             if line.startswith('{"' + MARK + '":')]
    if not lines:
        raise ValueError(f"no {MARK} record in the output")
    return json.loads(lines[-1])[MARK]
