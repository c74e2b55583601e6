"""A cell, configuration or metric is added as files alone."""
import json
import os
import shutil

import pytest

from helpers import ROOT
from benchmark import run

BENCH = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))


def test_every_cell_names_a_config_and_has_its_files():
    configs = {c["name"]: c for c in BENCH["configs"]}
    for w in BENCH["workloads"]:
        assert w["config"] in configs
        spec = run.cell_spec(w["name"])
        assert spec["workload"]["config"] == w["config"]
        assert spec["chips"] == w["chips"]
        assert spec["config"]["name"] == w["config"]
        assert spec["end_to_end"] and spec["per_layer"]
    for c in BENCH["configs"]:
        assert c["file"].startswith("benchmark/configs/")
        assert os.path.exists(os.path.join(ROOT, c["file"]))


def test_every_metric_has_a_reader_and_only_benchmark_json_lists_it():
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        mod = run.metric_reader(m["name"])
        assert callable(mod.read)
        # unit, layer and cells live in BENCHMARK.json alone, so that a
        # later cell joins a metric without an edit to its reader
        assert not hasattr(mod, "META"), m["name"]


def test_every_layer_metric_moves_a_metric_its_cells_report():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    cells = [w["name"] for w in BENCH["workloads"]]
    for m in BENCH["per_layer"]:
        moved = e2e[m["moves"]]
        for cell in m.get("workloads", moved.get("workloads", cells)):
            assert cell in cells
            assert cell in moved.get("workloads", cells), (m["name"], cell)
            assert m["name"] in [x["name"] for x in
                                 run.cell_spec(cell)["per_layer"]]
    for w in cells:
        spec = run.cell_spec(w)
        names = [m["name"] for m in spec["end_to_end"]]
        assert "setup_s" in names and len(names) >= 2
        assert spec["per_layer"]


def test_a_new_cell_is_found_from_files_alone(tmp_path):
    root = tmp_path / "checkout"
    root.mkdir()
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), root)
    shutil.copytree(os.path.join(ROOT, "benchmark"), root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "_cache"))
    before = {p: open(p, "rb").read() for p in
              (str(x) for x in (root / "benchmark").rglob("*")
               if x.is_file())}
    wl = json.load(open(root / "benchmark/workloads/facade_p25.exact.json"))
    wl["offset_px"] = 0.5
    json.dump(wl, open(root / "benchmark/workloads/facade_p25.wide.json",
                       "w"))
    bench = json.load(open(root / "BENCHMARK.json"))
    bench["workloads"].append(dict(name="facade_p25.wide",
                                   config="facade_p25", traffic="wide",
                                   chips=1, why="a test cell"))
    json.dump(bench, open(root / "BENCHMARK.json", "w"))
    spec = run.cell_spec("facade_p25.wide", root=str(root))
    assert spec["workload"]["offset_px"] == 0.5
    assert spec["config"]["name"] == "facade_p25"
    # metrics without a "workloads" list apply to the new cell as well
    assert "setup_s" in [m["name"] for m in spec["end_to_end"]]
    assert "images_per_s" not in [m["name"] for m in spec["end_to_end"]]
    assert "match_ms_per_view" not in [m["name"] for m in spec["per_layer"]]
    # a metric restricted to some cells takes the new one in through its
    # BENCHMARK.json entry alone (with the end-to-end metric it moves), and
    # a per-layer metric without a list follows that end-to-end metric
    m = next(m for m in bench["per_layer"]
             if m["name"] == "match_ms_per_view")
    m["workloads"].append("facade_p25.wide")
    moved = next(e for e in bench["end_to_end"] if e["name"] == m["moves"])
    moved["workloads"].append("facade_p25.wide")
    json.dump(bench, open(root / "BENCHMARK.json", "w"))
    spec = run.cell_spec("facade_p25.wide", root=str(root))
    assert "images_per_s" in [m["name"] for m in spec["end_to_end"]]
    joined = [m["name"] for m in spec["per_layer"]]
    assert "match_ms_per_view" in joined and "device_idle_pct" in joined
    assert "device_idle_pct.device_bound" not in joined
    split = run.metric_reader("device_idle_pct.device_bound",
                              root=str(root))
    assert split.read(dict(trace=dict(busy_s=1.0, window_s=4.0))) == 75.0
    reader = run.metric_reader("match_ms_per_view", root=str(root))
    assert reader.read(dict(stats=[dict(t_match=0.5)], views=25)) == 20.0
    for p, data in before.items():
        assert open(p, "rb").read() == data, p
    with pytest.raises(SystemExit):
        run.cell_spec("no_such.cell", root=str(root))
