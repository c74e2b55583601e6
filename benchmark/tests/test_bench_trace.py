"""The per-layer metrics read from the program's recorder (trace.py): their
arithmetic on made-up records, and a traced CPU run of each cell; the
recorder's report (trace_report.py) on the CPU."""
import json

import pytest

from helpers import small_cell
from benchmark import run, scenes, trace_report, tracing

FACADE = ["match_wait_ms_per_view", "dtoh_mb_per_model", "affinity_pairs_s",
          "affinity_enum_s", "affinity_weights_s"]
CLUTTER = ["match_wait_ms_per_view.device_bound",
           "dtoh_mb_per_model.device_bound"]


def read(name, record):
    return run.metric_reader(name).read(record)


def stats(**kw):
    base = dict(t_match=0.5, t_cluster=0.5, t_match_wait=0.05,
                readback_bytes=3_000_000, t_affinity_pairs=0.1,
                t_affinity_enum=0.2, t_affinity_weights=0.3)
    return {**base, **kw}


def test_the_recorder_metrics_are_means_over_the_window():
    r = dict(views=25, stats=[stats(), stats(t_match_wait=0.15,
                                             readback_bytes=5_000_000,
                                             t_affinity_enum=0.4)])
    assert read("match_wait_ms_per_view", r) == pytest.approx(
        1e3 * 0.2 / 50)
    assert read("match_wait_ms_per_view.device_bound", r) == \
        read("match_wait_ms_per_view", r)
    assert read("dtoh_mb_per_model", r) == pytest.approx(4.0)
    assert read("dtoh_mb_per_model.device_bound", r) == pytest.approx(4.0)
    assert read("affinity_pairs_s", r) == pytest.approx(0.1)
    assert read("affinity_enum_s", r) == pytest.approx(0.3)
    assert read("affinity_weights_s", r) == pytest.approx(0.3)


@pytest.mark.parametrize("name", FACADE + CLUTTER)
def test_a_program_without_the_recorder_gives_no_reading(name):
    # the stats of a program that predates the recorder: no key, no value
    old = dict(t_match=0.5, t_cluster=0.5, t_affinity=2.0)
    assert read(name, dict(views=25, stats=[old, old])) is None
    assert read(name, dict(views=25, stats=[])) is None
    assert read(name, dict(views=25, stats=[stats(), old])) is None


@pytest.mark.parametrize("cell,names", [("facade_p25.exact", FACADE),
                                        ("clutter_p25.exact", CLUTTER)])
def test_a_traced_cpu_run_reports_them(cell, names, monkeypatch):
    seen = []
    orig = tracing.profiler_events

    def spy(prof):
        seen.extend(e.name for e in prof.events())
        return orig(prof)
    monkeypatch.setattr(tracing, "profiler_events", spy)
    spec = small_cell(cell)
    assert set(names) <= {m["name"] for m in spec["per_layer"]}
    res = run.run_cell(spec, seed=2 ** 31 + 5, seconds=0.0, trace=True,
                       device="cpu")
    assert res["correct"], res["checks"]
    for n in names:
        assert res["metrics"][n]["value"] >= 0.0, n
    assert res["metrics"][names[0]]["unit"] == "ms"
    # the harness never turns the recorder on, so its profiled model
    # carries no program annotation that could count as device work
    assert seen and not [n for n in seen if n.startswith("l3d.")]


def test_the_report_names_the_idle_time_by_program_span():
    spec = small_cell("facade_p25.exact")
    cap = scenes.make_capture(spec["config"]["scene"])
    kw = run.l3d_config(spec)

    def model():
        return run.run_model(cap, cap.segments, kw, "cpu", run.Recorder())
    got = trace_report.profiled(model)
    # no device on the CPU: the whole window one gap, named by the
    # innermost program span at its middle
    assert got["busy_s"] == 0.0 and got["device_ops"] == []
    [(name, idle)] = got["idle_gaps_program"]
    assert name.split(".")[0] in {"scene", "neighbors", "collinearity",
                                  "matching", "match", "wait", "affinity",
                                  "diffusion", "fh", "fit"}, name
    assert idle == got["idle_s"] == pytest.approx(got["window_s"], rel=1e-6)
    assert got["outside_share"] == 0.0
    s = got["summary"]
    assert s["match.depths_device_ms_per_view"] == 0.0
    assert s["syncs"] == sum(n for n, _ in s["by_site"].values()) > 0
    assert s["dtoh_mb"] * 1e6 == sum(b for _, b in s["by_site"].values())
    assert s["t_affinity_enum"] > 0.0 and s["match_wait_ms_per_view"] > 0.0


def test_the_report_rehearses_a_cell_on_the_cpu(tmp_path, capsys):
    out = tmp_path / "report.json"
    trace_report.main(["clutter_p25.exact", "--device", "cpu", "--views",
                       "5", "--segments", "60", "--profile", "--out",
                       str(out)])
    got = json.loads(out.read_text())
    assert json.loads(capsys.readouterr().out.strip()) == got
    assert got["device"] == "cpu" and "check" not in got
    assert got["profile"]["summary"]["by_site"]["match.selection"][0] == 5
    with pytest.raises(SystemExit, match="needs the card"):
        trace_report.main(["clutter_p25.exact", "--device", "cpu",
                           "--check"])
