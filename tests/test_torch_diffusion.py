"""line3d_tpu_torch.cluster.diffusion / diffusion_device and the
round-parallel F-H mode against line3d_tpu's.

Inputs: random symmetric graphs made with numpy from a seed
(test_cluster._random_sym_graph), and the affinity graph of the noisy
10-view house (the scene of tests/golden/house10_diffusion.txt), built by
line3d_tpu and carried across with convert.affinity_graph_from_reference.

Tolerances (tests/test_cluster.py's): identical (i, j); weights rtol 2e-4 /
atol 1e-7 (float32 device sums in another order than XLA's, and float32
against the float64 host).  F-H parallel labels: identical."""
from unittest import mock

import numpy as np
import pytest
import torch

from line3d_tpu import Line3D as JLine3D, L3DConfig as JConfig
from line3d_tpu.cluster import diffusion as jd, diffusion_device as jdd, \
    fh as jfh
from line3d_tpu_torch import L3DConfig, convert
from line3d_tpu_torch.cluster import diffusion as td, \
    diffusion_device as tdd, fh as tfh
from synthetic import make_scene
from test_cluster import _random_sym_graph

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
