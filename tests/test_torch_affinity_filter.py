"""The rule by which the card filters the affinity stage's candidate stream
(`csrc/affinity_filter.cu`), rehearsed on the CPU.

`affinity_cuda.filter_plain` is the kernel's rule in numpy: the weight of
`similarity_one` without its 0.01 cut, and a candidate dropped only when
that weight is finite and lies below its kind's threshold by more than
`FILTER_MARGIN` of it.  It must keep every candidate the host's native
sweep passes, and the host's finalize over the kept candidates alone, told
the whole stream's length, must give the whole stream's graph field for
field: on the random streams of tests/test_torch_affinity_order.py with
the rows of a small facade's best matches, on that facade's own stream,
and on it with `min_affinity` and `collinear_affinity` set to candidates'
own native weights and one ulp either side."""
import dataclasses

import numpy as np
import pytest

from line3d_tpu_torch.cluster import affinity, affinity_cuda as ka
from torch_port_helpers import affinity_random_case, assert_same_graph, \
    best_rows, native_weights, small_facade_affinity

# the edge cases' thresholds: the native weight at these quantiles of each
# kind's weights above the 0.01 cut, moved by these ulps
QUANTILES = (0.1, 0.5, 0.9)
ULPS = (-1, 0, 1)
CASES = ([f"random-{block}" for block in range(4)] + ["facade"] +
         [f"edge-q{q}-{d:+d}ulp" for q in QUANTILES for d in ULPS])


@pytest.fixture(scope="module")
def facade():
    return small_facade_affinity()


def ulps(x, d):
    for _ in range(abs(d)):
        x = np.nextafter(x, np.inf if d > 0 else -np.inf)
    return float(x)


def case_streams(facade, case):
    """(best, cams, config, stream, candidates that must be kept) of a
    case."""
    best, cams, cfg, stream = facade
    kind, _, rest = case.partition("-")
    if kind == "random":
        block = int(rest)
        out = []
        for seed in range(10 * block, 10 * block + 10):
            inputs = affinity_random_case(seed, general=seed % 2 == 1)
            got = affinity.enumerate_candidates(*inputs, device="cpu")
            out.append((best_rows(best, len(inputs[0]), seed), cams, cfg,
                        got, []))
        return out
    if kind == "facade":
        return [(best, cams, cfg, stream, [])]
    # a kind's threshold on one candidate's own native weight: that
    # candidate fails at 0 and +1 ulp and passes at -1, and the filter
    # keeps it each time
    q, d = rest.split("-", 1)
    q, d = float(q[1:]), int(d[:-3])
    raw = native_weights(best, stream, cams, dataclasses.replace(
        cfg, min_affinity=-1.0, collinear_affinity=-1.0))
    picks, thr = [], []
    for of_kind in (stream[2] == 0, stream[2] > 0):
        rows = np.flatnonzero(of_kind & (raw > 0.0))
        i = rows[np.argsort(raw[rows], kind="stable")][int(q * len(rows))]
        picks.append(int(i))
        thr.append(ulps(raw[i], d))
    cfg = dataclasses.replace(cfg, min_affinity=thr[0],
                              collinear_affinity=thr[1])
    return [(best, cams, cfg, stream, picks)]


@pytest.mark.parametrize("case", CASES)
def test_the_filter_keeps_what_the_sweep_passes(facade, case):
    seen = np.zeros(3, np.int64)    # candidates, passed, dropped
    for best, cams, cfg, stream, must in case_streams(facade, case):
        n = len(stream[0])
        w = native_weights(best, stream, cams, cfg)
        keep = ka.filter_plain(*stream, best, cams, cfg)
        assert keep[w >= 0.0].all(), case
        assert keep[must].all(), case
        if case.startswith("edge"):
            assert (w[must] >= 0.0).tolist() == [case.endswith("-1ulp")] * 2
        seen += (n, (w >= 0.0).sum(), (~keep).sum())
        kept = [x[keep] for x in stream]
        whole = affinity._finalize_candidates(best, *stream, cams, cfg,
                                              False)
        part = affinity._finalize_candidates(best, *kept, cams, cfg, False,
                                             n)
        assert_same_graph(part, whole)
        assert (part.num_kept, whole.num_kept) == (int(keep.sum()), n)
    # each case has candidates that pass and candidates the filter drops
    assert seen[1] > 0 and seen[2] > 0, (case, seen)


def test_the_kept_stream_takes_the_whole_streams_branch(facade,
                                                        monkeypatch):
    """A kept stream short enough for the numpy sweep still takes the
    native sweep and emission when the whole stream would."""
    best, cams, cfg, stream = facade
    keep = ka.filter_plain(*stream, best, cams, cfg)
    kept = [x[keep] for x in stream]
    m, n = len(kept[0]), len(stream[0])
    assert 0 < m < n
    monkeypatch.setattr(affinity, "NATIVE_SIM_THRESHOLD", m)
    lib, calls = affinity.get_lib(), []

    class Spy:
        def __getattr__(self, name):
            calls.append(name)
            return getattr(lib, name)
    monkeypatch.setattr(affinity, "get_lib", Spy)
    g = affinity._finalize_candidates(best, *kept, cams, cfg, False, n)
    assert calls == ["affinity_weights_range", "affinity_emit"]
    assert (g.num_candidates, g.num_kept) == (n, m)
    calls.clear()
    affinity._finalize_candidates(best, *kept, cams, cfg, False)
    assert calls == []
