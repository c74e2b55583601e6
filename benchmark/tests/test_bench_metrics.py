"""The metric arithmetic on made-up records."""
import math

import pytest

import helpers  # noqa: F401  (puts the checkout on sys.path)
from benchmark import roofline, run, tracing


def read(name, record):
    return run.metric_reader(name).read(record)


def record(**kw):
    base = dict(setup_s=12.5, window_s=10.0, model_s=[1.0] * 10, views=25,
                completed=10, peak_bytes=2 ** 31, stats=[])
    return {**base, **kw}


def test_rate_counts_completed_views_over_the_window():
    assert read("images_per_s", record()) == pytest.approx(25.0)
    assert read("images_per_s", record(completed=9)) == pytest.approx(22.5)
    assert read("setup_s", record()) == 12.5
    assert read("peak_device_gib", record()) == pytest.approx(2.0)


def test_p90_is_over_every_model():
    times = [float(i) for i in range(1, 11)]
    assert read("model_s_p90", record(model_s=times)) == pytest.approx(9.1)
    # one slow model moves the tail
    assert read("model_s_p90", record(model_s=[1.0] * 9 + [50.0])) > 5.0


def test_stage_means():
    st = [dict(t_match=0.25, t_cluster=0.5, t_diffusion=0.1, t_fit=0.2),
          dict(t_match=0.5, t_cluster=0.3, t_diffusion=0.3, t_fit=0.4)]
    r = record(stats=st)
    assert read("match_ms_per_view", r) == pytest.approx(1e3 * 0.75 / 50)
    assert read("cluster_s", r) == pytest.approx(0.4)
    assert read("diffusion_s", r) == pytest.approx(0.2)
    assert read("fit_s", r) == pytest.approx(0.3)
    assert read("cluster_s", record()) is None


def test_idle_share_from_overlapping_intervals():
    # two streams: [0, 4) and [2, 6) overlap, [8, 9) alone -> busy 7 of 10
    assert tracing.union_seconds([(0, 4), (2, 6), (8, 9)]) == 7
    busy, by_op, br = tracing.summarize(
        [("a", 0, 4e6), ("b", 2e6, 6e6), ("a", 8e6, 9e6)],
        [("matching", 0, 8.5e6), ("fh", 6.5e6, 7.5e6)], 0, 10e6)
    assert busy == pytest.approx(7.0)
    assert by_op["a"] == pytest.approx(5.0)
    # the gap [6, 8) is named by the innermost span at its middle, fh;
    # [9, 10) lies outside any span
    gaps = dict(br["idle_gaps"])
    assert gaps["fh"] == pytest.approx(2.0)
    assert gaps["outside spans"] == pytest.approx(1.0)
    r = record(trace=dict(busy_s=busy, window_s=10.0, by_op=by_op, work=[]))
    assert read("device_idle_pct", r) == pytest.approx(30.0)


def test_roofline_from_counted_work():
    ops, nbytes = roofline.k1_work(1000, [1000, 500], valid=2000)
    pairs = 1000 * 1000 + 1000 * 500
    assert ops == (pairs * 162 + 2500 * 59 + 3500 * 24 + 2 * 5
                   + 2000 * 188)
    least = roofline.least_seconds(ops, nbytes)
    assert least == pytest.approx(ops / 67e12)
    work = [dict(src=1000, tgts=[1000, 500], valid=2000, S=1024, M=64)]
    by_op = {"void pair_kernel<...>(Args)": 4 * least, "other": 1.0}
    r = record(trace=dict(busy_s=1.0, window_s=2.0, by_op=by_op, work=work))
    assert read("k1_roofline_pct", r) == pytest.approx(25.0)
    s_ops, s_bytes = roofline.score_work(1024, 64, 2000)
    assert s_bytes == 1024 * 64 * 5 + 2000 * 28
    by_op = {"score_kernel": 2 * roofline.least_seconds(s_ops, s_bytes)}
    r = record(trace=dict(busy_s=1.0, window_s=2.0, by_op=by_op, work=work))
    assert read("score_roofline_pct", r) == pytest.approx(50.0)
    # a kernel absent from the trace gives no reading, never 0
    r = record(trace=dict(busy_s=1.0, window_s=2.0, by_op={}, work=work))
    assert read("k1_roofline_pct", r) is None


def test_spread_is_the_quartile_distance_over_the_median():
    from benchmark import sets
    med, sp = sets.spread([1.0, 2.0, 3.0, 4.0, 5.0])
    assert med == 3.0 and math.isclose(sp, (4.5 - 1.5) / 3.0)
