"""The torch bench (fourdgs_tpu_torch/tools/bench.py) on the CPU at a tiny
size: its `main` runs bench.py's operating point shrunk to 300 points at
32x32, eagerly, and prints bench.py's keys. A CPU run measures the host
running the plain versions, so only the keys, the counts and the
arithmetic between them are held here; the card's numbers come from a
run on the card."""
import json
import math

import torch

from fourdgs_tpu_torch.tools import bench

torch.set_num_threads(1)


def test_bench_main_prints_bench_keys(capsys):
    out = bench.main(["--points", "300", "--size", "32", "--steps", "2",
                      "--device", "cpu"])
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert json.loads(line) == out
    assert set(out) == {"metric", "value", "unit", "vs_baseline", "detail"}
    d = out["detail"]
    assert d["steps"] == 2 and d["points"] == 300 and d["image"] == 32
    assert d["capacity"] == 4096        # pick_bucket's floor at headroom 1
    assert d["backend"] == "eager (cpu)" and d["card"] is None
    assert math.isfinite(d["loss"]) and out["value"] > 0
    assert out["vs_baseline"] == round(out["value"]
                                       / bench.BASELINE_RAYS_PER_S, 4)
    assert isinstance(d["dropped_pairs"], int)
    assert isinstance(d["dropped_tile"], int)


def test_bench_config_is_bench_py_operating_point():
    cfg = bench.bench_config(100_000)
    r = cfg.raster
    assert (r.capacity, r.tile_size, r.tile_cap, r.bin_chunk,
            r.bin_pairs_per_chunk) == (131_072, 32, 512, 4096, 18432)
    assert cfg.hidden.multires == [1, 2] and cfg.hidden.net_width == 64
    assert cfg.hidden.defor_depth == 0
