"""line3d_tpu_torch.cluster.diffusion / diffusion_device and the
round-parallel F-H mode against line3d_tpu's.

Inputs: random symmetric graphs made with numpy from a seed
(test_cluster._random_sym_graph), and the affinity graph of the noisy
10-view house (the scene of tests/golden/house10_diffusion.txt), built by
line3d_tpu and carried across with convert.affinity_graph_from_reference.

Tolerances (tests/test_cluster.py's): identical (i, j); weights rtol 2e-4 /
atol 1e-7 (float32 device sums in another order than XLA's, and float32
against the float64 host).  F-H parallel labels: identical.  The device
diffusion's plan (its sorts, degrees, length classes and the merge walk's
chunk cuts, all on the device) against numpy lexsorts, and the diffused
weights from it against those from the lexsort plan: identical."""
from unittest import mock

import numpy as np
import pytest
import torch

from line3d_tpu import Line3D as JLine3D, L3DConfig as JConfig
from line3d_tpu.cluster import diffusion as jd, diffusion_device as jdd, \
    fh as jfh
from line3d_tpu_torch import L3DConfig, convert, trace
from line3d_tpu_torch.cluster import diffusion as td, \
    diffusion_device as tdd, fh as tfh
from synthetic import make_scene
from test_cluster import _random_sym_graph
from torch_port_helpers import assert_classes_equal_twin, \
    assert_plan_equals_twin, diffusion_plan_twin, length_classes_twin

RTOL, ATOL = 2e-4, 1e-7


def _same_edges(got, want):
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_allclose(got[2], want[2], rtol=RTOL, atol=ATOL)


@pytest.fixture(scope="module")
def house_graph():
    """The reference's affinity graph of the noisy house (before
    diffusion), from line3d_tpu's own pipeline."""
    from line3d_tpu import pipeline as jp
    seen = []
    orig = jp.affinity.build_affinity_graph

    def spy(*a, **k):
        g = orig(*a, **k)
        seen.append(convert.affinity_graph_from_reference(g))
        return g
    syn = make_scene(num_views=10, noise_px=0.8, seed=3)
    l3d = JLine3D(config=JConfig(use_collinearity=True))
    for v in range(syn.scene.num_views):
        l3d.add_view_segments(
            v, syn.scene.segments[v][syn.scene.seg_mask[v]],
            syn.cameras.K[v], syn.cameras.R[v], syn.cameras.t[v],
            worldpoint_ids=syn.wp_lists[v],
            width=int(syn.cameras.width[v]),
            height=int(syn.cameras.height[v]))
    with mock.patch.object(jp.affinity, "build_affinity_graph", spy):
        l3d.compute_3d_model(perform_diffusion=False)
    return seen[0]


@pytest.mark.parametrize("mode", ["reference", "true"])
@pytest.mark.parametrize("seed", [0, 1])
def test_host_modes_match_reference(mode, seed):
    i, j, w = _random_sym_graph(60, 220, seed)
    jf = jd.diffuse_reference if mode == "reference" else jd.diffuse_true
    tf = td.diffuse_reference if mode == "reference" else td.diffuse_true
    _same_edges(tf(i, j, w, 60, iterations=10),
                jf(i, j, w, 60, iterations=10))


@pytest.mark.parametrize("mode", ["reference", "true"])
@pytest.mark.parametrize("seed,iterations", [(0, 10), (1, 10), (2, 0),
                                             (3, 1)])
def test_device_modes_match_reference_device(mode, seed, iterations):
    """The torch device forms (on CPU tensors) against line3d_tpu's jitted
    device kernels on the CPU, and against the float64 host twin."""
    i, j, w = _random_sym_graph(60, 220, seed)
    if mode == "reference":
        want = jdd.diffuse_reference_device(i, j, w, 60, iterations)
        got = tdd.diffuse_reference_device(i, j, w, 60, iterations,
                                           device="cpu")
        host = jd.diffuse_reference(i, j, w, 60, iterations)
    else:
        want = jdd.diffuse_true_device(i, j, w, 60, iterations)
        got = tdd.diffuse_true_device(i, j, w, 60, iterations,
                                      device="cpu")
        host = jd.diffuse_true(i, j, w, 60, iterations)
    _same_edges(got, want)
    _same_edges(got, host)


@pytest.mark.parametrize("mode", ["reference", "true"])
@pytest.mark.parametrize("backend", ["host", "device"])
def test_run_diffusion_on_house_graph(house_graph, mode, backend):
    """run_diffusion of both packages on the same affinity graph."""
    g_j = convert.affinity_graph_from_reference(house_graph)
    g_t = convert.affinity_graph_from_reference(house_graph)
    jd.run_diffusion(g_j, JConfig(diffusion_mode=mode,
                                  diffusion_backend=backend))
    td.run_diffusion(g_t, L3DConfig(diffusion_mode=mode,
                                    diffusion_backend=backend),
                     device="cpu")
    assert len(g_t.edges_w) == len(house_graph.edges_w) > 500
    _same_edges((g_t.edges_i, g_t.edges_j, g_t.edges_w),
                (g_j.edges_i, g_j.edges_j, g_j.edges_w))
    assert g_t.edges_w.dtype == np.float32


@pytest.mark.parametrize("mode", ["reference", "true"])
def test_device_diffusion_is_deterministic(house_graph, mode):
    """No atomics: two runs give the same bits."""
    g = house_graph
    fn = tdd.diffuse_reference_device if mode == "reference" \
        else tdd.diffuse_true_device
    a = fn(g.edges_i.astype(np.int64), g.edges_j.astype(np.int64),
           g.edges_w.astype(np.float64), g.num_nodes, device="cpu")
    b = fn(g.edges_i.astype(np.int64), g.edges_j.astype(np.int64),
           g.edges_w.astype(np.float64), g.num_nodes, device="cpu")
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)


def _plan_graph(case):
    """(i, j, w, num_nodes) of a plan case: random symmetric graphs; one
    whose nodes are spread over twice their ids (isolated nodes between
    and after them); a hub of degree > 64 beside a random graph (length
    classes up to 128); repeated (i, j) entries with other weights (ties
    of the sort keys); and no edges."""
    if case.startswith("random"):
        return _random_sym_graph(60, 220, int(case[-1])) + (60,)
    if case == "isolated":
        i, j, w = _random_sym_graph(40, 100, 2)
        return 2 * i + 1, 2 * j + 1, w, 90
    if case == "hub":
        rng = np.random.default_rng(4)
        leaves = np.arange(1, 101)
        a, b, wr = _random_sym_graph(101, 300, 4)
        wl = rng.uniform(0.05, 1.0, len(leaves))
        i = np.concatenate([np.zeros(100, np.int64), leaves, a])
        j = np.concatenate([leaves, np.zeros(100, np.int64), b])
        return i, j, np.concatenate([wl, wl, wr]), 101
    if case == "duplicates":
        i, j, w = _random_sym_graph(30, 80, 3)
        rng = np.random.default_rng(3)
        w2 = rng.uniform(0.05, 1.0, 20)
        return (np.concatenate([i, i[:20], j[:20]]),
                np.concatenate([j, j[:20], i[:20]]),
                np.concatenate([w, w2, w2]), 30)
    assert case == "empty"
    z = np.zeros(0, np.int64)
    return z, z, np.zeros(0), 10


@pytest.mark.parametrize("case", ["random0", "random1", "isolated", "hub",
                                  "duplicates", "empty"])
def test_device_plan_equals_lexsort_twin(monkeypatch, case):
    """Every array of the device plan, the terms and length classes of the
    row sums and of both modes' dots, and the merge walk's chunk cuts
    equal their numpy twins (np.lexsort, np.flatnonzero, np.searchsorted);
    each class split reads back 66 integers."""
    i, j, w, n = _plan_graph(case)
    E = len(w)
    p = tdd.build_plan(i, j, w, n, "cpu")
    twin = diffusion_plan_twin(i, j, w, n)
    assert_plan_equals_twin(p, twin)
    deg = twin["deg"]
    with trace.recording():
        assert_classes_equal_twin(tdd._row_sums(p), deg)
        assert_classes_equal_twin(
            tdd._edge_dot(p, 0, E, False),
            np.minimum(deg[twin["rj"]], deg[twin["ri"]]))
        counters = trace.collect()["counters"]
    assert counters["syncs.diffusion.classes"] == 2
    assert counters["dtoh_bytes.diffusion.classes"] == 2 * 66 * 8
    dot = tdd._edge_dot(p, 0, E, True)
    assert_classes_equal_twin(dot, dot.n.numpy())
    if case == "hub":
        assert len(tdd._row_sums(p).classes) >= 5
    monkeypatch.setattr(tdd, "WALK_CHUNK", 16)
    for lo, hi in ((0, E), (E // 3, E)):
        bound = np.cumsum(np.minimum(deg[twin["ri"][lo:hi]],
                                     deg[twin["rj"][lo:hi]]))
        want = np.searchsorted(bound, np.arange(16, bound[-1] if len(bound)
                                                else 0, 16))
        assert E == 0 or len(want) > 2
        np.testing.assert_array_equal(tdd._walk_cuts(p, lo, hi), want)


@pytest.mark.parametrize("mode", ["reference", "true"])
def test_device_plan_keeps_the_diffused_bits(house_graph, monkeypatch,
                                             mode):
    """The house graph diffused from the device plan equals, bit for bit,
    the same iterations from the lexsort twin's plan and flatnonzero
    length classes; the edge order is the twin's."""
    g = house_graph
    args = (g.edges_i.astype(np.int64), g.edges_j.astype(np.int64),
            g.edges_w.astype(np.float64), g.num_nodes)
    fn = getattr(tdd, f"diffuse_{mode}_device")
    got = fn(*args, device="cpu")

    def twin_plan(i, j, w, n, device):
        arrays = diffusion_plan_twin(i, j, w, n)
        return tdd.DiffusionPlan(
            **{k: torch.as_tensor(v) for k, v in arrays.items()},
            num_nodes=n, num_edges=len(w))

    def twin_split(n):
        terms, classes = length_classes_twin(n.numpy())
        return terms, [(torch.as_tensor(sel), torch.arange(L))
                       for L, sel in classes]
    monkeypatch.setattr(tdd, "build_plan", twin_plan)
    monkeypatch.setattr(tdd._PairSums, "split", staticmethod(twin_split))
    want = fn(*args, device="cpu")
    twin = diffusion_plan_twin(*args)
    assert len(got[2]) == len(g.edges_w) > 500
    for a, b in zip(got, want):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(got[0], twin["ri"])
    np.testing.assert_array_equal(got[1], twin["rj"])


def test_resolve_backend_follows_the_line3d_device():
    assert td.resolve_backend("auto", "cpu") == "host"
    assert td.resolve_backend("auto", torch.device("cuda")) == "device"
    assert td.resolve_backend("device", "cpu") == "device"
    assert td.resolve_backend("host", "cuda") == "host"
    with pytest.raises(ValueError):
        td.resolve_backend("tpu", "cpu")


@pytest.mark.parametrize("seed,n,e,c", [(0, 60, 220, 0.3), (4, 200, 900, 1.0),
                                        (7, 40, 60, 0.1)])
def test_fh_parallel_labels_identical(seed, n, e, c):
    i, j, w = _random_sym_graph(n, e, seed)
    np.testing.assert_array_equal(tfh.fh_cluster_parallel(i, j, w, n, c,
                                                          device="cpu"),
                                  jfh.fh_cluster_parallel(i, j, w, n, c))


def test_fh_parallel_labels_identical_on_house_graph(house_graph):
    g = house_graph
    args = (g.edges_i, g.edges_j, g.edges_w, g.num_nodes, 1.0)
    np.testing.assert_array_equal(tfh.fh_cluster_parallel(*args,
                                                          device="cpu"),
                                  jfh.fh_cluster_parallel(*args))
