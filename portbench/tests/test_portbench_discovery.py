"""BENCHMARK.json's names find their files: every cell its configuration,
mix and limits; every per-layer metric its reader; every configuration
its port config and a published value for each width."""
import json

import pytest

from portbench import run as bench_run

BENCHMARK = json.loads((bench_run.ROOT / "BENCHMARK.json").read_text())
CELLS = [c["name"] for c in BENCHMARK["workloads"]]


@pytest.mark.parametrize("name", CELLS)
def test_cell_files_found_by_name(name):
    cell = bench_run.load_cell(BENCHMARK, name)
    assert cell["mix"]["kind"] in ("train", "serve")
    assert set(cell["limits"]) >= ({"loss_gap", "grad_gap", "change_gap"}
                                   if cell["mix"]["kind"] == "train"
                                   else {"off_share", "mean_gap"})
    assert any(m["name"] == "setup_s" for m in cell["end_to_end"])
    assert len(cell["end_to_end"]) >= 2
    assert cell["per_layer"]
    reported = {m["name"] for m in cell["end_to_end"]}
    for m in cell["per_layer"]:
        assert m["moves"] in reported


@pytest.mark.parametrize("metric", [m["name"] for m in
                                    BENCHMARK["per_layer"]])
def test_metric_reader_found_by_name(metric):
    read = bench_run.reader(metric)
    assert callable(read)


@pytest.mark.parametrize("config", BENCHMARK["configs"])
def test_config_names_its_port_file(config):
    data = json.loads((bench_run.ROOT / config["file"]).read_text())
    assert data["name"] == config["name"]
    assert data["source"] == config["source"]
    assert (bench_run.ROOT / data["port_config"]).exists()
    assert data["reduced"] == config["reduced"] == []


def test_unknown_cell_refused():
    with pytest.raises(SystemExit):
        bench_run.load_cell(BENCHMARK, "no_such_cell")


@pytest.mark.parametrize("config", BENCHMARK["configs"])
def test_port_config_holds_the_published_values(config):
    from portbench.core import program
    data = json.loads((bench_run.ROOT / config["file"]).read_text())
    cfg = program.load_config(data)
    assert list(cfg.hidden.kplanes_config["resolution"]) == \
        data["published"]["kplanes_resolution"]


def test_a_changed_width_is_refused():
    from portbench.core import program
    data = json.loads((bench_run.ROOT / BENCHMARK["configs"][0]["file"])
                      .read_text())
    data["published"]["net_width"] += 1
    with pytest.raises(ValueError, match="net_width"):
        program.load_config(data)
