"""On the card: every cell of BENCHMARK.json runs briefly through run.py,
exits 0 and prints a correct result line with the result's keys. Run
with `python -m pytest portbench/tests -m gpu` on a machine with a card."""
import json
import subprocess
import sys

import pytest

from portbench import run as bench_run

BENCHMARK = json.loads((bench_run.ROOT / "BENCHMARK.json").read_text())


@pytest.mark.gpu
@pytest.mark.parametrize("cell", [c["name"] for c in
                                  BENCHMARK["workloads"]])
@pytest.mark.parametrize("trace", [0, 1])
def test_cell_runs_on_the_card(cuda, cell, trace):
    proc = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", cell, "--seed",
         "2147483653", "--seconds", "2", "--trace", str(trace)],
        cwd=bench_run.ROOT, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics",
                              "device"]
    assert list(line)[-1] == "compared"
    assert line["correct"] and line["failed"] == 0
    assert line["device"]["platform"] == "gpu"
    if trace:
        assert line["device"]["busy_s"] > 0
