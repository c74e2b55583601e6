"""The port at scale against `line3d_tpu`, on the CPU.

(1) `line3d_tpu_torch.utils.host_stage_scaling.synthesize` against the JAX
    package's scripts/host_stage_scaling.py `synthesize` (loaded by path;
    nothing in scripts/ changes) with the same arguments: every array
    equal, dtypes too, and the collinearity dicts equal.
(2) On those inputs the port's cluster stages against line3d_tpu's: the
    affinity graph bit for bit, F-H labels (exact and round-parallel)
    equal after relabelling, the plain fit's TXT within
    `io.writers.compare_txt` (rtol 1e-5 / atol 1e-6, ints exact).
(3) `utils/demo.make_facade_scene(num_views=256)` against line3d_tpu's:
    segments, masks, counts, cameras and worldpoint lists bit for bit, the
    padded segment axis S = 1,408; similarities, neighbours and
    conditioning as tests/test_torch_host.py holds them (neighbours equal,
    float64 within rtol 1e-12).
(4) The port's whole `Line3D(device="cpu")` on the 40-view synthetic house
    against line3d_tpu's `Line3D` on the same scene: the same lines by
    member sets, integer tokens equal; 12 of 3,962 float tokens lie
    outside `compare_txt`'s rtol 1e-5 / atol 1e-6, pinned and traced to
    matching with `utils/compare.py` (every differing best pick a near-tie,
    the port's matching through line3d_tpu's later stages the port's TXT).
(5) The 37-view house over 4 CPU ranks (gloo on 127.0.0.1, the ranks'
    views 10 + 10 + 10 + 7), and the 9-view house (3 + 3 + 3 + 0: a rank
    with no views): every rank's TXT equals the single process's byte for
    byte.  The ranks are this file run as a script, as in
    tests/test_torch_multihost.py.
"""
import dataclasses
import importlib.util
import os
import subprocess
import sys
import time

import numpy as np
import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
if REPO not in sys.path:                      # run as a worker script
    sys.path.insert(0, REPO)

import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

from line3d_tpu_torch import Line3D, L3DConfig  # noqa: E402
from line3d_tpu_torch.parallel import multihost  # noqa: E402
from line3d_tpu_torch.utils import host_stage_scaling as hss  # noqa: E402
from line3d_tpu_torch.utils.synthetic import make_scene  # noqa: E402

# (1)-(2): the JAX script's inputs at a size the CPU runs in seconds
SYNTH = dict(V=48, segs_per_view=300)
# (4): the 40-view synthetic house; (5): view counts the
# ranks do not divide, the views of each rank (the last rank of 9 views
# has none)
HOUSE_VIEWS, SPLIT_RANKS = 40, 4
SPLIT_SHARES = {37: [10, 10, 10, 7], 9: [3, 3, 3, 0]}
# (4): the 40-view house's TXT tokens and the float tokens outside
# compare_txt's tolerance against line3d_tpu's (the largest at 6.39 times
# it): all 16 lines share their member sets and integer tokens; the
# floats move with the near-tie best picks (524 of 639 differ, every one
# within 3.3e-6 of the reference's own pick) and the float32 depths of
# equal picks (within 1.5e-5 relative), as tests/test_torch_host.py finds
# on the facade
HOUSE40_OUTSIDE = (3962, 12, 6.4)
# the 4-view facade's cold TXT (`scale_exact_profile 4 --device cpu`),
# with either selection
SCALE4_SHA256 = \
    "369d1eda4c27ddf197677efd3ea64ff37206af068e9f030ad00480f91f21d0e8"
JOIN_TIMEOUT_S = 180
PORT_IN_USE, PORT_ATTEMPTS = "EADDRINUSE", 3


def _house_model(num_views, txt_path):
    """The port's Line3D(device="cpu") on the synthetic house, its TXT
    written to txt_path; returns the Line3D."""
    syn = make_scene(num_views=num_views, device="cpu")
    l3d = Line3D(config=L3DConfig(use_collinearity=True), device="cpu")
    for v in range(syn.scene.num_views):
        l3d.add_view_segments(
            v, syn.scene.segments[v][syn.scene.seg_mask[v]],
            syn.cameras.K[v], syn.cameras.R[v], syn.cameras.t[v],
            worldpoint_ids=syn.wp_lists[v],
            width=int(syn.cameras.width[v]),
            height=int(syn.cameras.height[v]))
    l3d.compute_3d_model()
    l3d.save_3d_lines_as_txt(l3d.get_result(), txt_path)
    return l3d


def _worker(num_views, port, rank, nproc, outdir):
    assert multihost.initialize(f"127.0.0.1:{port}", nproc, rank)
    torch.set_num_threads(2)
    l3d = _house_model(num_views, os.path.join(outdir, f"rank{rank}.txt"))
    assert l3d.stats["views_local"] == SPLIT_SHARES[num_views][rank]
    dist.destroy_process_group()


# ----------------------------------------------------------------------
# (1) and (2): the host-stage tool's inputs and the cluster stages on them

@pytest.fixture(scope="module")
def synthesized():
    import jax
    spec = importlib.util.spec_from_file_location(
        "jax_host_stage_scaling", os.path.join(REPO, "scripts",
                                               "host_stage_scaling.py"))
    mod = importlib.util.module_from_spec(spec)
    path = list(sys.path)
    try:
        spec.loader.exec_module(mod)          # it puts "." on sys.path
    finally:
        sys.path[:] = path
    assert jax.config.jax_platforms == "cpu"
    return hss.synthesize(**SYNTH), mod.synthesize(**SYNTH)


def _fields(obj):
    return {f.name: getattr(obj, f.name) for f in dataclasses.fields(obj)}


def test_synthesize_equals_the_jax_script(synthesized):
    """(1) every array of the port's inputs equals the JAX script's."""
    (cams, cfg, tr, best, matches, cm, S), \
        (jcams, jcfg, jtr, jbest, jmatches, jcm, jS) = synthesized
    assert S == jS == 3072
    for obj, ref in ((cams, jcams), (tr, jtr), (best, jbest)):
        for name, a in _fields(obj).items():
            b = getattr(ref, name)
            if isinstance(a, np.ndarray):
                assert a.dtype == b.dtype, name
                np.testing.assert_array_equal(a, b, err_msg=name)
            else:
                assert a == b, name
    assert best.view.size == jbest.view.size > 10_000
    assert len(matches) == len(jmatches) == SYNTH["V"]
    for vm, jvm in zip(matches, jmatches):
        assert vm.view == jvm.view
        for name in ("src_seg", "tgt_view", "tgt_seg"):
            a, b = getattr(vm, name), getattr(jvm, name)
            assert a.dtype == b.dtype, name
            np.testing.assert_array_equal(a, b, err_msg=name)
    for name in ("flat_view", "flat_i", "flat_j", "flat_w"):
        a, b = getattr(cm, name), getattr(jcm, name)
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    assert list(cm) == list(jcm)
    # but line3d_tpu's switch of its dense collinearity re-derivation
    jcfg = dataclasses.asdict(jcfg)
    del jcfg["collinearity_exact_fallback"]
    assert dataclasses.asdict(cfg) == jcfg


@pytest.fixture(scope="module")
def graphs(synthesized):
    from line3d_tpu.cluster import affinity as ja
    from line3d_tpu_torch.cluster import affinity
    (cams, cfg, _, best, matches, cm, S), \
        (jcams, jcfg, _, jbest, jmatches, jcm, _) = synthesized
    return (affinity.build_affinity_graph(best, matches, cm, cams, cfg, S),
            ja.build_affinity_graph(jbest, jmatches, jcm, jcams, jcfg, S))


def test_host_stages_affinity_bit_equal(graphs):
    """(2) the affinity graph of the port equals line3d_tpu's bit for
    bit."""
    got, want = graphs
    assert got.num_nodes == want.num_nodes > 10_000
    assert len(got.edges_w) > 100_000
    for name in ("edges_i", "edges_j", "edges_w", "node_view", "node_seg"):
        a, b = getattr(got, name), getattr(want, name)
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)


@pytest.mark.parametrize("parallel", [False, True])
def test_host_stages_fh_labels_equal(graphs, parallel):
    """(2) F-H on the graph: the port's labels equal line3d_tpu's after
    relabelling, exact and round-parallel."""
    from line3d_tpu.cluster import fh as jfh
    from line3d_tpu_torch.cluster import fh
    from torch_port_helpers import relabel
    g = graphs[0]
    name = "fh_cluster_parallel" if parallel else "fh_cluster"
    args = (g.edges_i, g.edges_j, g.edges_w, g.num_nodes, L3DConfig().fh_c)
    kw = dict(device="cpu") if parallel else {}
    got, want = getattr(fh, name)(*args, **kw), getattr(jfh, name)(*args)
    np.testing.assert_array_equal(relabel(got), relabel(want))
    assert len(np.unique(want)) > 1000


def test_host_stages_fit_txt(synthesized, graphs, tmp_path):
    """(2) the plain fit of the F-H clusters: the port's TXT within
    compare_txt of line3d_tpu's (ints exact, floats rtol 1e-5 / atol
    1e-6)."""
    from line3d_tpu.cluster import fh as jfh
    from line3d_tpu.fit import lines as jl
    from line3d_tpu.io import writers as jw
    from line3d_tpu_torch.fit import lines
    from line3d_tpu_torch.io import writers
    (cams, cfg, tr, best, _, _, S), (jcams, jcfg, jtr, jbest, *_) = \
        synthesized
    g = graphs[0]
    labels = jfh.fh_cluster(g.edges_i, g.edges_j, g.edges_w, g.num_nodes,
                            cfg.fh_c)
    V = SYNTH["V"]
    zeros = np.zeros((V, 1, 4), np.float32)
    got = lines.process_clusters(g, labels, best, tr, cfg, S,
                                 scene_segments=zeros, P_cond=cams.P,
                                 device="cpu")
    want = jl.process_clusters(graphs[1], labels, jbest, jtr, jcfg, S,
                               scene_segments=zeros, P_cond=jcams.P)
    assert len(got) == len(want) > 500
    kw = dict(get_segment_2d=lambda v, s: zeros[v, 0],
              view_id_map=list(range(V)))
    a, b = str(tmp_path / "port.txt"), str(tmp_path / "ref.txt")
    writers.save_txt(got, a, **kw)
    jw.save_txt(want, b, **kw)
    rep = writers.compare_txt(a, b)
    assert rep["ok"] and rep["int_bad"] == 0 and not rep["outside"], rep


@pytest.mark.parametrize("tool", ["host_stage_scaling",
                                  "scale_exact_profile"])
def test_scale_tools_raise_without_cuda(tool):
    """Both scale tools run on the card by default: without CUDA they raise
    before any work."""
    import importlib
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    mod = importlib.import_module(f"line3d_tpu_torch.utils.{tool}")
    with pytest.raises(RuntimeError, match="is_available"):
        mod.main(["8"])


def test_host_stage_scaling_main_on_cpu(capsys):
    """`host_stage_scaling 24 --device cpu` prints one JSON line with every
    stage's seconds and the graph's sizes (the host diffusion too, at
    V <= 200)."""
    import json
    assert hss.main(["24", "--device", "cpu"]) == 0
    rec = json.loads(capsys.readouterr().out)
    assert rec["V"] == 24 and rec["device"] == "cpu" and rec["card"] is None
    assert rec["best_rows"] == 24 * 2500 and rec["edges"] > rec["nodes"] > 0
    assert rec["lines"] > 0 and rec["clusters"] > 0
    assert all(isinstance(t, float) for t in rec["seconds"].values())


@pytest.mark.parametrize("host_selection", [False, True])
def test_scale_exact_profile_on_cpu(tmp_path, capsys, host_selection):
    """`scale_exact_profile 4 --device cpu --warm 0 --out DIR`: one cold
    exact run of the 4-view facade, its record (exactness fields, launches
    0 on the CPU, the TXT's sha256) and its TXT; the TXT then checked
    against itself as a one-process `--expect`.  With `--host-selection`
    the same TXT (SCALE4_SHA256) through the host selection."""
    import hashlib
    import json
    from line3d_tpu_torch.utils import scale_exact_profile as sep
    assert sep.main(["4", "--device", "cpu", "--warm", "0", "--out",
                     str(tmp_path)]
                    + ["--host-selection"] * host_selection) == 0
    rec = json.loads(capsys.readouterr().out)
    txt = (tmp_path / "V4.txt").read_bytes()
    assert rec["device_selection"] is not host_selection
    assert rec["txt_sha256"] == hashlib.sha256(txt).hexdigest() == \
        SCALE4_SHA256
    assert rec["V"] == 4 and rec["S"] == 1280 and rec["lines"] > 100
    assert rec["match_overflow"] == 0
    assert (rec["collinearity_overflow"] == 0) == \
        (rec["views_recollin_exact"] == 0)
    assert rec["warm_s"] == [] and rec["txt_equal"] is None
    assert rec["max_memory_allocated"] is None and rec["peak_rss"] > 0
    assert json.loads((tmp_path / "V4.json").read_text()) == rec
    assert sep._check_ranks(txt, 4, str(tmp_path)) == [True]
    with pytest.raises(RuntimeError, match="differs"):
        sep._check_ranks(txt + b" ", 4, str(tmp_path))


# ----------------------------------------------------------------------
# (3) the facade at 256 views

def test_facade256_scene_equals_reference():
    """(3) the 256-view facade: scene and cameras bit for bit, S = 1,408;
    similarities, neighbours and conditioning as test_torch_host holds
    them."""
    from line3d_tpu.core.conditioning import compute_conditioning as jcond
    from line3d_tpu.scene import find_visual_neighbors as jnb, \
        view_similarities_from_worldpoints as jsim
    from line3d_tpu.utils.demo import make_facade_scene as jfacade
    from line3d_tpu_torch.core.conditioning import compute_conditioning
    from line3d_tpu_torch.scene import find_visual_neighbors, \
        view_similarities_from_worldpoints
    from line3d_tpu_torch.utils.demo import make_facade_scene
    V = 256
    scene, cams = make_facade_scene(num_views=V, device="cpu")
    jscene, jcams = jfacade(num_views=V)
    assert scene.max_segments == 1408
    for name in ("segments", "seg_mask", "seg_count"):
        a, b = getattr(scene, name), np.asarray(getattr(jscene, name))
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    for name, a in _fields(cams).items():
        if isinstance(a, np.ndarray):
            np.testing.assert_array_equal(a, getattr(jcams, name), name)
    assert [list(w) for w in scene.wp_lists] == \
        [list(w) for w in jscene.wp_lists]
    sim, _ = view_similarities_from_worldpoints(scene.wp_lists, V)
    want, _ = jsim(jscene.wp_lists, V)
    np.testing.assert_allclose(sim, want, rtol=1e-12, atol=0)
    cfg = L3DConfig()
    nb = find_visual_neighbors(sim, cams.baselines(), cfg.min_baseline,
                               cfg.matching_neighbors, cfg.eps)
    jn = jnb(want, jcams.baselines(), cfg.min_baseline,
             cfg.matching_neighbors, cfg.eps)
    assert [np.asarray(n).tolist() for n in nb] == \
        [np.asarray(n).tolist() for n in jn]
    assert min(len(n) for n in nb) > 0
    got, ref = compute_conditioning(cams.C), jcond(jcams.C)
    for f in ("scale", "R", "t", "Qinv", "scale_inv", "Rinv", "tneg"):
        np.testing.assert_allclose(getattr(got, f), getattr(ref, f),
                                   rtol=1e-12, atol=0, err_msg=f)


# ----------------------------------------------------------------------
# (4) the whole pipeline at 40 views against line3d_tpu's

def test_house40_whole_model_against_reference(tmp_path):
    """(4) the port's Line3D(device="cpu") and line3d_tpu's Line3D (host
    selection, so its ViewMatches carry confidences; the same TXT as its
    default path) on the 40-view house: the same lines by member sets and
    integer tokens; the float tokens outside compare_txt's rtol 1e-5 /
    atol 1e-6 pinned (HOUSE40_OUTSIDE), and traced to matching: every
    view's verified matches equal, every differing best pick a near-tie
    (within 1e-5 of the reference's own pick's confidence), and the
    port's matching outputs through line3d_tpu's affinity, F-H, fit and
    writer give the port's TXT byte for byte."""
    import line3d_tpu.pipeline as jp
    from line3d_tpu import L3DConfig as JConfig, Line3D as JLine3D
    from line3d_tpu.cluster import affinity as ja, fh as jfh
    from line3d_tpu.fit import lines as jl
    from line3d_tpu.io import writers as jw
    from line3d_tpu_torch.io.writers import compare_txt
    from line3d_tpu_torch.utils import compare
    from torch_port_helpers import to_reference
    a = str(tmp_path / "port.txt")
    port = _house_model(HOUSE_VIEWS, a)
    syn = make_scene(num_views=HOUSE_VIEWS, device="cpu")
    cfg = JConfig(use_collinearity=True)
    ref = JLine3D(config=cfg, use_sharded_engine=False)
    for v in range(syn.scene.num_views):
        ref.add_view_segments(
            v, syn.scene.segments[v][syn.scene.seg_mask[v]],
            syn.cameras.K[v], syn.cameras.R[v], syn.cameras.t[v],
            worldpoint_ids=syn.wp_lists[v],
            width=int(syn.cameras.width[v]),
            height=int(syn.cameras.height[v]))
    seen = []
    orig = jp.affinity.build_affinity_graph

    def spy(*args, **kw):
        seen.append(args)
        return orig(*args, **kw)
    jp.affinity.build_affinity_graph = spy
    try:
        res = ref.compute_3d_model()
    finally:
        jp.affinity.build_affinity_graph = orig
    b = str(tmp_path / "ref.txt")
    ref.save_3d_lines_as_txt(res, b)

    assert port.stats["num_lines"] == len(res) > 10
    assert compare.compare_models(a, b)["shared"] == len(res)
    rep = compare_txt(a, b)
    assert rep["int_bad"] == 0, rep
    assert (rep["n_tokens"], len(rep["outside"])) == HOUSE40_OUTSIDE[:2]
    assert rep["worst_ratio"] < HOUSE40_OUTSIDE[2], rep["worst_ratio"]

    (rbest, rmatches, *_), = seen
    diffs = compare.verified_differences(rmatches, port.matches)
    assert all(not x and not y for _, _, x, y in diffs.values())
    picks = compare.best_pick_differences(rbest, port.best, rmatches,
                                          port.matches)
    assert picks["n_a"] == picks["n_b"] and picks["differ"] > 0
    assert picks["near_tie"] == picks["differ"], picks

    S = port.scene.max_segments
    g = ja.build_affinity_graph(
        to_reference(port.best), [to_reference(vm) for vm in port.matches],
        to_reference(port.scene.collin), to_reference(port.cameras), cfg, S)
    labels = jfh.fh_cluster(g.edges_i, g.edges_j, g.edges_w, g.num_nodes,
                            cfg.fh_c)
    attr = jl.process_clusters(g, labels, to_reference(port.best),
                               to_reference(port.transform), cfg, S)
    c = str(tmp_path / "attr.txt")
    segs = port.scene.segments
    jw.save_txt(attr, c, get_segment_2d=lambda v, s: segs[v, s],
                view_id_map=list(range(HOUSE_VIEWS)))
    assert (tmp_path / "attr.txt").read_bytes() == \
        (tmp_path / "port.txt").read_bytes()


# ----------------------------------------------------------------------
# (5) the same model over ranks that do not divide the views

def _free_port():
    import socket
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _run_ranks(num_views, outdir):
    """Start SPLIT_RANKS workers on the num_views-view house, join them
    under JOIN_TIMEOUT_S (the others killed as soon as one fails), restart
    on another port when rank 0 finds its rendezvous port taken; returns
    the processes and logs."""
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    for k in ("WORLD_SIZE", "RANK", "LOCAL_RANK", "MASTER_ADDR",
              "MASTER_PORT"):
        env.pop(k, None)
    for _ in range(PORT_ATTEMPTS):
        port, procs = _free_port(), []
        for r in range(SPLIT_RANKS):
            with open(os.path.join(outdir, f"log{r}.txt"), "w") as log:
                procs.append(subprocess.Popen(
                    [sys.executable, os.path.abspath(__file__),
                     str(num_views), str(port), str(r), str(SPLIT_RANKS),
                     str(outdir)], env=env,
                    stdout=log, stderr=subprocess.STDOUT))
        deadline = time.monotonic() + JOIN_TIMEOUT_S
        try:
            while time.monotonic() < deadline:
                rcs = [p.poll() for p in procs]
                if None not in rcs or any(rc not in (None, 0) for rc in rcs):
                    break
                time.sleep(0.05)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                p.wait()
        logs = []
        for r in range(SPLIT_RANKS):
            with open(os.path.join(outdir, f"log{r}.txt")) as f:
                logs.append(f.read())
        if PORT_IN_USE not in logs[0]:
            break
    return procs, logs


@pytest.mark.parametrize("num_views", sorted(SPLIT_SHARES))
def test_house_over_four_ranks_equals_one_process(tmp_path, num_views):
    """(5) the house over 4 ranks that split its views unevenly (37 views:
    10, 10, 10, 7; 9 views: 3, 3, 3 and none): every rank's TXT equals the
    single process's byte for byte."""
    shares = [np.subtract(*multihost.my_view_range(num_views, r,
                                                   SPLIT_RANKS)[::-1])
              for r in range(SPLIT_RANKS)]
    assert shares == SPLIT_SHARES[num_views]
    procs, logs = _run_ranks(num_views, tmp_path)
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r} failed:\n{log[-4000:]}"
    one = tmp_path / "one.txt"
    _house_model(num_views, str(one))
    want = one.read_bytes()
    assert want.count(b"\n") > 10
    for r in range(SPLIT_RANKS):
        assert (tmp_path / f"rank{r}.txt").read_bytes() == want, r


if __name__ == "__main__":
    _worker(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]),
            int(sys.argv[4]), sys.argv[5])
