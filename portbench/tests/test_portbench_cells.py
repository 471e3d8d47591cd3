"""Tiny CPU runs of each kind of cell through the port's plain versions:
the comparison with the reference holds, no device metric is printed, the
result line has its keys in order, the control and each fault that a
cell can have read `correct` false, and nothing of JAX is imported."""
import ast
import json
import subprocess
import sys

import pytest

from portbench import run as bench_run
from portbench.tests import tiny

CONFIGS = ("dnerf_bouncingballs", "dynerf_cut_roasted_beef")
KINDS = ("train", "serve")
KEYS = ["correct", "attempted", "failed", "metrics", "device", "compared"]


def _cell(kind):
    benchmark = json.loads((bench_run.ROOT / "BENCHMARK.json").read_text())
    name = next(c["name"] for c in benchmark["workloads"]
                if c["traffic"] == kind)
    return bench_run.load_cell(benchmark, name)


@pytest.mark.parametrize("config", CONFIGS)
@pytest.mark.parametrize("kind", KINDS)
def test_tiny_run_is_correct_and_reports_no_device_metric(config, kind,
                                                          tmp_path):
    r, outcome = tiny.run(config, kind, tmp_path)
    assert outcome.correct, outcome.compared
    assert outcome.attempted > 0 and outcome.failed == 0
    assert outcome.metrics == {} and outcome.memory_peak_bytes == 0
    line = bench_run.result_line(_cell(kind), outcome, r,
                                 {"platform": "cpu"})
    assert list(line) == KEYS
    assert line["metrics"] == {}
    assert all(set(v) == {"value", "limit"}
               for v in line["compared"].values())


def test_open_loop_serves_at_its_rate(tmp_path):
    """A viewer at a fixed rate: requests come due at i / rate over the
    window, and the frames it was given are correct."""
    r, outcome = tiny.run("dnerf_bouncingballs", "serve", tmp_path,
                          mix={"loop": "open", "rate_hz": 20.0})
    assert outcome.correct and outcome.failed == 0
    assert outcome.attempted == 4          # due at 0, 0.05, 0.10, 0.15 s


@pytest.mark.parametrize("kind", KINDS)
def test_traced_tiny_run_reads_no_device_metric(kind, tmp_path):
    r, outcome = tiny.run("dnerf_bouncingballs", kind, tmp_path, trace=True)
    assert outcome.correct
    line = bench_run.result_line(_cell(kind), outcome, r,
                                 {"platform": "cpu"})
    assert line["metrics"] == {}
    assert "breakdown" not in line
    assert list(line)[-1] == "compared"


@pytest.mark.parametrize("config", CONFIGS)
@pytest.mark.parametrize("kind", KINDS)
def test_control_one_precision_down_is_not_correct(config, kind, tmp_path):
    _, outcome = tiny.run(config, kind, tmp_path, control="tf32")
    assert not outcome.correct, outcome.compared


@pytest.mark.parametrize("config,kind,fault", [
    ("dnerf_bouncingballs", "train", "unchanged"),
    ("dynerf_cut_roasted_beef", "train", "unchanged"),
    ("dynerf_cut_roasted_beef", "train", "half_batch"),
    ("dnerf_bouncingballs", "serve", "altered"),
    ("dynerf_cut_roasted_beef", "serve", "altered"),
])
def test_fault_under_the_timed_path_is_not_correct(config, kind, fault,
                                                   tmp_path):
    _, outcome = tiny.run(config, kind, tmp_path, fault=fault)
    assert not outcome.correct, outcome.compared


def test_run_imports_no_jax_and_no_jax_package(tmp_path):
    code = (
        "import sys, pathlib; sys.path.insert(0, sys.argv[1]);"
        "from portbench.tests import tiny;"
        "tiny.run('dnerf_bouncingballs', 'serve', pathlib.Path(sys.argv[2]));"
        "from portbench.run import forbidden_modules;"
        "print(forbidden_modules())")
    out = subprocess.run([sys.executable, "-c", code, str(bench_run.ROOT),
                          str(tmp_path)], capture_output=True, text=True,
                         timeout=600, check=True).stdout.strip()
    assert out.splitlines()[-1] == "[]"


def test_forbidden_names_compare_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "fourdgs_tpu_torch_like", object())
    monkeypatch.setitem(sys.modules, "fourdgs_tpu.ops", object())
    assert bench_run.forbidden_modules() == ["fourdgs_tpu"]


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_reference_and_work_import_nothing_of_the_program():
    files = sorted((bench_run.BENCH / "reference").glob("*.py")) + [
        bench_run.BENCH / "work.py", bench_run.BENCH / "core" / "peaks.py"]
    for f in files:
        for name in _imports(f):
            assert name.split(".")[0] not in ("fourdgs_tpu_torch",
                                              "fourdgs_tpu", "jax"), (f, name)
    code = ("import sys; sys.path.insert(0, sys.argv[1]);"
            "import portbench.reference.train, portbench.work;"
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'fourdgs_tpu_torch', 'fourdgs_tpu', 'jax'}))")
    out = subprocess.run([sys.executable, "-c", code, str(bench_run.ROOT)],
                         capture_output=True, text=True, timeout=300,
                         check=True).stdout.strip()
    assert out == "[]"
