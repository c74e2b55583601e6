"""`line3d_tpu_torch.parallel.multihost`: one reconstruction over N real
processes (gloo over 127.0.0.1, `device="cpu"`), held to the port's own
single-process run bit for bit and to `line3d_tpu`.

Each case starts its ranks as `python tests/test_torch_multihost.py <case>
<port> <rank> <nproc> <outdir>` (the worker is `_worker` below), joins
every process under a timeout, and compares what the ranks wrote.  Models
are compared exactly: the TXT files byte for byte and every line's views,
segments and 3D endpoints array for array.  The 2-rank house10 model is
also read against tests/golden/house10.txt as tests/test_golden.py reads
it (ints exact, floats rtol 1e-5 / atol 1e-6, one pinned token,
`torch_port_helpers.HOUSE10_OUTSIDE`).  The sharded affinity graph is
compared exactly with the port's single-process finalize and with
`line3d_tpu`'s on the same arrays.

The cluster stage's split device forms (diffusion by edge, refinement and
bundle adjustment by whole blocks of clusters) run over 2 and 3 ranks with
`refine.BLOCK = STAGE_BLOCK` so that a small fixture has blocks for every
rank; one process runs with the same block size.  Every rank's output must
equal the single process's bit for bit, and `line3d_tpu`'s mesh-sharded
form (the 8-device CPU mesh of tests/conftest.py) within the tolerances
its own tests hold between sharded and unsharded runs: diffusion rtol 2e-4
/ atol 1e-7 (tests/test_torch_diffusion.py), refinement
tests/test_refine.py's criteria, BA lines and poses atol 5e-4 and rms
within 1e-3 (tests/test_bundle.py:131-136).  Each rank's spied shares (the
dot's edges, the clusters of each refinement block and of the BA) must be
its own range.
"""
import os
import pickle
import socket
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
from line3d_tpu_torch.utils.synthetic import make_scene  # noqa: E402
from torch_port_helpers import HOUSE10_OUTSIDE  # noqa: E402

JOIN_TIMEOUT_S = 120
# gloo's TCP store reports a rendezvous port that another process took
PORT_IN_USE, PORT_ATTEMPTS = "EADDRINUSE", 3
# the capped mode of case (b): caps so low that views overflow and their
# owners re-match them (tests/test_torch_caps.py's TINY)
CAPPED = dict(use_collinearity=True, capacity_probe=False,
              match_block_quota=1, max_matches_per_segment=8)
# case (d): two ranks of 3 and 2 views with 64 and 96 segment slots
SEG_VIEWS, SEG_S = (3, 2), (64, 96)
# clusters per block in the cluster-stage cases: 16 clusters make 6
# blocks (the last one short), 3 for each of 2 ranks, 2 for each of 3
STAGE_BLOCK = 3
# the noisy house of tests/golden/house10_diffusion.txt
NOISY = dict(noise_px=0.8, seed=3)
# the cluster stage's device forms on the noisy house: reference-mode
# device diffusion alone (the golden's model), with device refinement,
# and true-mode device diffusion with BA
HOUSE_STAGES = dict(
    diffusion=dict(perform_diffusion=True, diffusion_backend="device"),
    refine=dict(perform_diffusion=True, diffusion_backend="device",
                refine_lines=True, refine_backend="device"),
    bundle=dict(perform_diffusion=True, diffusion_backend="device",
                diffusion_mode="true", refine_backend="device",
                bundle_adjust_cameras=True))


def _free_port():
    """A port free now (the kernel's pick); rank 0 binds it later."""
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _house(num_views, config, **scene):
    syn = make_scene(num_views=num_views, device="cpu", **scene)
    l3d = Line3D(config=config, device="cpu")
    for v in range(syn.scene.num_views):
        l3d.add_view_segments(
            v, syn.scene.segments[v][syn.scene.seg_mask[v]],
            syn.cameras.K[v], syn.cameras.R[v], syn.cameras.t[v],
            worldpoint_ids=syn.wp_lists[v],
            width=int(syn.cameras.width[v]),
            height=int(syn.cameras.height[v]))
    return l3d


def _model(l3d, path):
    """Write the model's TXT to `path`; return its lines as arrays."""
    res = l3d.get_result()
    l3d.save_3d_lines_as_txt(res, path)
    return dict(
        n_segments=np.array([len(r.segments3d) for r in res]),
        views2d=np.concatenate([r.views2d for r in res]),
        segs2d=np.concatenate([r.segs2d for r in res]),
        segments3d=np.concatenate([np.asarray(r.segments3d).reshape(-1, 6)
                                   for r in res]))


def _seg_shard(rank):
    """Rank `rank`'s segment shard of case (d): (segments, mask, start)."""
    rng = np.random.default_rng(10 + rank)
    V, S = SEG_VIEWS[rank], SEG_S[rank]
    segs = rng.uniform(0, 640, (V, S, 4)).astype(np.float32)
    mask = rng.random((V, S)) < 0.7
    return segs, mask, sum(SEG_VIEWS[:rank])


class _Shares:
    """Record, while active, the size of this rank's share at each split
    device form: the rows of every diffusion dot (`_edge_dot`), the
    clusters of every refinement block (`_refine_lines_t`) and of every
    BA solve (`_bundle`)."""

    def __init__(self):
        from line3d_tpu_torch.cluster import diffusion_device as dd
        from line3d_tpu_torch.fit import bundle, refine
        self.sites = ((dd, "_edge_dot", lambda a, out: out.K),
                      (refine, "_refine_lines_t", lambda a, out: len(a[0])),
                      (bundle, "_bundle", lambda a, out: len(a[0])))
        self.sizes = {name: [] for _, name, _ in self.sites}

    def __enter__(self):
        self.orig = [getattr(m, name) for m, name, _ in self.sites]
        for (m, name, size), fn in zip(self.sites, self.orig):
            def wrapped(*a, _fn=fn, _name=name, _size=size, **k):
                out = _fn(*a, **k)
                self.sizes[_name].append(_size(a, out))
                return out
            setattr(m, name, wrapped)
        return self

    def __exit__(self, *exc):
        for (m, name, _), fn in zip(self.sites, self.orig):
            setattr(m, name, fn)


def _stage_results(fx):
    """The split device forms of the cluster stage on the fixture
    `_stage_fixture` made: diffusion in both modes on each graph, the
    refinement and the BA; with this rank's shares."""
    from line3d_tpu_torch.cluster import diffusion_device as dd
    from line3d_tpu_torch.fit import bundle, refine
    out = {}
    with _Shares() as sh:
        for g, (i, j, w, n) in fx["graphs"].items():
            for mode in ("reference", "true"):
                fn = getattr(dd, f"diffuse_{mode}_device")
                ri, rj, rw = fn(i, j, w, n, 10, device="cpu")
                out[f"diff_{g}_{mode}"] = np.stack([ri, rj, rw])
        out["refine"] = np.concatenate([
            x.reshape(len(x), -1) for x in refine.refine_lines_device(
                *fx["refine"], iterations=8, device="cpu")], axis=1)
        P0, d, R, t, rb, ra = bundle.bundle_adjust(
            *fx["bundle"], iterations=5, device="cpu")
        out.update(ba_lines=np.concatenate([P0, d], axis=1), ba_R=R,
                   ba_t=t, ba_rms=np.array([rb, ra]))
    for name, sizes in sh.sizes.items():
        out[f"share{name}"] = np.array(sizes, np.int64)
    return out


def _worker(case, port, rank, nproc, outdir):
    out = os.path.join(outdir, f"{case}_{rank}")
    if case == "dies":
        # rank 1 leaves without taking part: rank 0's gather must fail,
        # not wait for it
        multihost.initialize(f"127.0.0.1:{port}", nproc, rank, timeout_s=30)
        if rank == 1:
            os._exit(3)
        multihost.allgather_array(np.arange(4))
        return
    assert multihost.initialize(f"127.0.0.1:{port}", nproc, rank)
    assert multihost.process_count() == nproc
    assert multihost.process_index() == rank
    if case == "house10":
        if not torch.cuda.is_available():
            # no quiet CPU run under N ranks either
            try:
                Line3D()
            except RuntimeError as e:
                assert "torch.cuda.is_available() is False" in str(e), e
            else:
                raise AssertionError("Line3D() ran without CUDA")
        l3d = _house(10, L3DConfig(use_collinearity=True))
        l3d.compute_3d_model()
        np.savez(out + ".npz", views_local=l3d.stats["views_local"],
                 num_processes=l3d.stats["num_processes"],
                 gathered_bytes=l3d.stats["gathered_bytes"],
                 **_model(l3d, out + ".txt"))
    elif case == "capped":
        l3d = _house(8, L3DConfig(**CAPPED))
        l3d.compute_3d_model()
        np.savez(out + ".npz", views_local=l3d.stats["views_local"],
                 rematched=l3d.stats["views_rematched_uncapped"],
                 overflow=l3d.stats["match_overflow"],
                 **_model(l3d, out + ".txt"))
        # the host selection would gather every view's tables: it raises
        host = _house(8, L3DConfig(**CAPPED))
        host.use_sharded_engine = False
        try:
            host.compute_3d_model()
        except ValueError as e:
            assert "use_sharded_engine=True" in str(e), e
        else:
            raise AssertionError("host selection ran over N processes")
    elif case == "affinity":
        from line3d_tpu_torch.cluster import affinity
        with open(os.path.join(outdir, "fixture.pkl"), "rb") as f:
            best, cams, cfg, src, tgt, kinds, cws = pickle.load(f)
        assert multihost.local_range(len(src)) == \
            multihost.my_view_range(len(src), rank, nproc)
        # the numpy sweep and emission (the fixture's stream is below
        # NATIVE_SIM_THRESHOLD), then the native ones
        for tag, thr in (("numpy", affinity.NATIVE_SIM_THRESHOLD),
                         ("native", 0)):
            affinity.NATIVE_SIM_THRESHOLD = thr
            g = affinity._finalize_candidates(best, src, tgt, kinds, cws,
                                              cams, cfg, False)
            np.savez(f"{out}_{tag}.npz", num_nodes=g.num_nodes,
                     edges_i=g.edges_i, edges_j=g.edges_j,
                     edges_w=g.edges_w, node_view=g.node_view,
                     node_seg=g.node_seg)
    elif case == "stages":
        from line3d_tpu_torch.fit import refine
        with open(os.path.join(outdir, "stages.pkl"), "rb") as f:
            fx = pickle.load(f)
        refine.BLOCK = STAGE_BLOCK
        np.savez(out + ".npz", **_stage_results(fx))
    elif case == "house10stages":
        from line3d_tpu_torch.fit import refine
        refine.BLOCK = STAGE_BLOCK
        got = {}
        for tag, kw in HOUSE_STAGES.items():
            l3d = _house(10, L3DConfig(use_collinearity=True, **kw),
                         **NOISY)
            with _Shares() as sh:
                l3d.compute_3d_model()
            _model(l3d, f"{out}_{tag}.txt")
            got[f"{tag}_bytes"] = np.array(
                [l3d.stats["gathered_by_stage"][k]
                 for k in ("diffusion", "fit")])
            got[f"{tag}_edges"] = l3d.stats["num_edges"]
            for name, sizes in sh.sizes.items():
                got[f"{tag}_share{name}"] = np.array(sizes, np.int64)
            if l3d.refined_poses is not None:
                got[f"{tag}_R"], got[f"{tag}_t"] = l3d.refined_poses
        np.savez(out + ".npz", **got)
    elif case == "segments":
        segs, mask, start = _seg_shard(rank)
        got_s, got_m = multihost.allgather_segments(segs, mask, start,
                                                    sum(SEG_VIEWS))
        np.savez(out + ".npz", segments=got_s, mask=got_m)
    else:
        raise ValueError(case)
    dist.destroy_process_group()


def _start(case, nproc, outdir, port):
    """Start `nproc` ranks of `case` on `port`; each writes its output to
    outdir/log_<case>_<rank>.txt."""
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    for k in ("WORLD_SIZE", "RANK", "LOCAL_RANK", "MASTER_ADDR",
              "MASTER_PORT"):
        env.pop(k, None)
    procs = []
    for r in range(nproc):
        with open(os.path.join(outdir, f"log_{case}_{r}.txt"), "w") as log:
            procs.append(subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), case, str(port),
                 str(r), str(nproc), str(outdir)], env=env, stdout=log,
                stderr=subprocess.STDOUT))
    return procs


def _join(procs, stop_on_failure):
    """Wait for every rank (JOIN_TIMEOUT_S in all), then kill what is left;
    with stop_on_failure, the others are killed as soon as one rank
    fails, which then fails the run."""
    deadline = time.monotonic() + JOIN_TIMEOUT_S
    while time.monotonic() < deadline:
        rcs = [p.poll() for p in procs]
        if None not in rcs or (stop_on_failure and
                               any(rc not in (None, 0) for rc in rcs)):
            break
        time.sleep(0.05)
    _kill(procs)


def _kill(procs):
    """Kill the ranks still running and reap all."""
    for p in procs:
        if p.poll() is None:
            p.kill()
        p.wait()


def _run(case, nproc, outdir, expect_ok=True, procs=None):
    """Start `nproc` ranks of `case` (or take `procs`, the ranks `_start`
    started), join them; returns the processes and their outputs.  Rank 0
    binds the rendezvous port `_free_port` found free, which another
    process may take in between: only then (rank 0 reports the port in
    use) the ranks are started again on another port."""
    for _ in range(PORT_ATTEMPTS):
        if procs is None:
            procs = _start(case, nproc, outdir, _free_port())
        _join(procs, stop_on_failure=expect_ok)
        outs = []
        for r in range(nproc):
            with open(os.path.join(outdir, f"log_{case}_{r}.txt")) as f:
                outs.append(f.read())
        if PORT_IN_USE not in outs[0]:
            break
        procs = None
    if expect_ok:
        for r, (p, o) in enumerate(zip(procs, outs)):
            assert p.returncode == 0, f"rank {r} failed:\n{o[-4000:]}"
    return procs, outs


def _load(outdir, case, rank):
    return dict(np.load(os.path.join(outdir, f"{case}_{rank}.npz")))


def _same_model(got, want):
    for k in ("n_segments", "views2d", "segs2d", "segments3d"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def _txt(path):
    with open(path, "rb") as f:
        return f.read()


def test_two_ranks_house10_equal_one_process_and_golden(tmp_path):
    """(a) house10, collinearity on, on 2 ranks: both ranks' models equal
    the single-process run bit for bit, and the TXT reads as the golden."""
    from line3d_tpu_torch.io.writers import compare_txt
    _run("house10", 2, tmp_path)
    one = _house(10, L3DConfig(use_collinearity=True))
    one.compute_3d_model()
    want = _model(one, str(tmp_path / "one.txt"))
    for r in range(2):
        got = _load(tmp_path, "house10", r)
        _same_model(got, want)
        assert _txt(tmp_path / f"house10_{r}.txt") == \
            _txt(tmp_path / "one.txt")
        assert int(got["num_processes"]) == 2
        assert int(got["views_local"]) == 5
        assert int(got["gathered_bytes"]) > 0
    rep = compare_txt(str(tmp_path / "house10_0.txt"),
                      os.path.join(HERE, "golden", "house10.txt"))
    assert rep["int_bad"] == 0, rep
    assert rep["outside"] == HOUSE10_OUTSIDE, rep
    assert rep["worst_ratio"] < 1.05, rep


def test_three_ranks_capped_rematch_equal_one_process(tmp_path):
    """(b) an 8-view house on 3 ranks (3/3/2 views) in the capped mode:
    views overflow, their owners re-match them, and every rank holds the
    single-process model; the host selection raises under N > 1."""
    _run("capped", 3, tmp_path)
    one = _house(8, L3DConfig(**CAPPED))
    one.compute_3d_model()
    assert one.stats["views_rematched_uncapped"] > 0
    want = _model(one, str(tmp_path / "one.txt"))
    for r, n_local in enumerate((3, 3, 2)):
        got = _load(tmp_path, "capped", r)
        _same_model(got, want)
        assert _txt(tmp_path / f"capped_{r}.txt") == \
            _txt(tmp_path / "one.txt")
        assert int(got["views_local"]) == n_local
        assert int(got["rematched"]) == \
            one.stats["views_rematched_uncapped"]
        assert int(got["overflow"]) == one.stats["match_overflow"]


def _affinity_fixture():
    """tests/multihost_affinity_worker.py's fixture on the port: the
    8-view house's best matches and a random candidate stream (seed 3,
    6,000 candidates)."""
    from line3d_tpu_torch.core.conditioning import compute_conditioning
    from line3d_tpu_torch.match import engine
    from line3d_tpu_torch.scene import find_visual_neighbors, \
        view_similarities_from_worldpoints
    syn = make_scene(num_views=8, device="cpu")
    cams = syn.cameras
    cfg = L3DConfig()
    tr = compute_conditioning(cams.C)
    cams.transform(tr.Qinv, tr.scale)
    sim, _ = view_similarities_from_worldpoints(syn.wp_lists,
                                                syn.scene.num_views)
    neighbors = find_visual_neighbors(sim, cams.baselines(),
                                      cfg.min_baseline,
                                      cfg.matching_neighbors)
    _, best, _ = engine.run_matching(syn.scene, cams, neighbors, cfg)
    B = best.view.size
    rng = np.random.default_rng(3)
    n = 6000
    src = rng.integers(0, B, size=n).astype(np.int64)
    tgt = rng.integers(0, B, size=n).astype(np.int64)
    bad = src == tgt
    tgt[bad] = (tgt[bad] + 1) % B
    kinds = rng.integers(0, 3, size=n).astype(np.int8)
    cws = rng.uniform(0.05, 1.0, size=n)
    return best, cams, cfg, src, tgt, kinds, cws


def test_two_ranks_sharded_affinity_finalize(tmp_path, monkeypatch):
    """(c) the weight sweep split across 2 ranks, by the numpy and by the
    native sweep and emission (NATIVE_SIM_THRESHOLD = 0): each graph
    equals the port's single-process finalize and line3d_tpu's on the same
    arrays."""
    from line3d_tpu.cluster import affinity as jaff
    from line3d_tpu_torch.cluster import affinity as taff
    fx = _affinity_fixture()
    best, cams, cfg, src, tgt, kinds, cws = fx
    assert len(src) < taff.NATIVE_SIM_THRESHOLD
    with open(tmp_path / "fixture.pkl", "wb") as f:
        pickle.dump(fx, f)
    _run("affinity", 2, tmp_path)
    for tag, thr in (("numpy", taff.NATIVE_SIM_THRESHOLD), ("native", 0)):
        monkeypatch.setattr(taff, "NATIVE_SIM_THRESHOLD", thr)
        monkeypatch.setattr(jaff, "NATIVE_SIM_THRESHOLD", thr)
        one = taff._finalize_candidates(best, src, tgt, kinds, cws, cams,
                                        cfg, False)
        ref = jaff._finalize_candidates(best, src, tgt, kinds, cws, cams,
                                        cfg, False)
        assert one.num_nodes > 10 and len(one.edges_i) > 100
        for g in (one, ref):
            for r in range(2):
                got = _load(tmp_path, "affinity", f"{r}_{tag}")
                assert int(got["num_nodes"]) == g.num_nodes, tag
                for k in ("edges_i", "edges_j", "edges_w", "node_view",
                          "node_seg"):
                    np.testing.assert_array_equal(got[k], getattr(g, k),
                                                  err_msg=f"{tag} {k}")


def test_allgather_segments_ragged(tmp_path):
    """(d) two ranks with 64 and 96 segment slots: the gathered [V, S, 4]
    segments and [V, S] mask equal the shards assembled at their starts,
    padded to S = 96."""
    _run("segments", 2, tmp_path)
    V, S = sum(SEG_VIEWS), max(SEG_S)
    want_s = np.zeros((V, S, 4), np.float32)
    want_m = np.zeros((V, S), bool)
    for r in range(2):
        segs, mask, start = _seg_shard(r)
        want_s[start:start + len(segs), :segs.shape[1]] = segs
        want_m[start:start + len(mask), :mask.shape[1]] = mask
    for r in range(2):
        got = _load(tmp_path, "segments", r)
        assert got["segments"].dtype == np.float32
        np.testing.assert_array_equal(got["segments"], want_s)
        np.testing.assert_array_equal(got["mask"], want_m)


def test_my_view_range_equals_reference():
    """(e) the shard of every rank over V in 1..40 and N in 1..5."""
    from line3d_tpu.parallel import multihost as jmh
    for V in range(1, 41):
        for N in range(1, 6):
            got = [multihost.my_view_range(V, r, N) for r in range(N)]
            assert got == [jmh.my_view_range(V, r, N) for r in range(N)]
            assert sum(hi - lo for lo, hi in got) == V


@pytest.mark.parametrize("n, want", [(1, 256), (578, 256), (1024, 256),
                                     (1025, 512), (2890, 768),
                                     (5780, 1536)])
def test_fit_block_size(n, want):
    """The device fits' blocks: a multiple of refine.BLOCK that depends on
    the cluster count alone, at most refine.MAX_BLOCKS of them, the
    smallest such (the facade's 578 clusters keep 3 blocks of 256)."""
    from line3d_tpu_torch.fit import refine
    blk = refine.block_size(n)
    assert blk == want and blk % refine.BLOCK == 0
    assert -(-n // blk) <= refine.MAX_BLOCKS
    assert blk == refine.BLOCK or -(-n // (blk - refine.BLOCK)) > \
        refine.MAX_BLOCKS


def test_single_process_creates_no_group(monkeypatch):
    """(f) without a process group the port runs today's path: initialize
    with one process creates nothing, and a model reports one process,
    all views local and nothing gathered."""
    for k in ("WORLD_SIZE", "RANK", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(k, raising=False)
    assert multihost.initialize() is False
    assert multihost.initialize("127.0.0.1:1", 1, 0) is False
    monkeypatch.setenv("WORLD_SIZE", "1")
    assert multihost.initialize() is False
    assert not dist.is_initialized()
    assert multihost.process_count() == 1 and multihost.process_index() == 0
    assert multihost.local_range(7) == (0, 7)
    assert multihost.resolve_device("cuda") == torch.device("cuda")
    x = np.arange(5, dtype=np.int64)
    (got,) = multihost.allgather_array(x)
    np.testing.assert_array_equal(got, x)
    l3d = _house(8, L3DConfig(use_collinearity=True))
    l3d.compute_3d_model()
    st = l3d.stats
    assert st["num_processes"] == 1 and st["views_local"] == 8
    assert st["gathered_bytes"] == 0 and st["num_lines"] > 0
    assert not dist.is_initialized()


def test_a_rank_that_dies_fails_the_others(tmp_path):
    """A rank that leaves the run makes the others' gather raise within
    the join timeout instead of waiting for it."""
    procs, outs = _run("dies", 2, tmp_path, expect_ok=False)
    assert procs[1].returncode == 3
    assert procs[0].returncode not in (0, None), outs[0][-2000:]


def _house_graph():
    """The port's affinity graph of the noisy house, before diffusion."""
    from line3d_tpu_torch import pipeline
    seen = []
    orig = pipeline.affinity.build_affinity_graph

    def spy(*a, **k):
        seen.append(orig(*a, **k))
        return seen[-1]
    pipeline.affinity.build_affinity_graph = spy
    try:
        _house(10, L3DConfig(use_collinearity=True),
               **NOISY).compute_3d_model()
    finally:
        pipeline.affinity.build_affinity_graph = orig
    g = seen[0]
    return (g.edges_i.astype(np.int64), g.edges_j.astype(np.int64),
            g.edges_w.astype(np.float64), g.num_nodes)


def _stage_fixture():
    """Inputs of the split device forms, made with numpy from seeds:
    tests/test_cluster.py's random graph (seed 0) and the noisy house's
    affinity graph; tests/test_refine.py's 8-view members (16 clusters);
    tests/test_bundle.py's perturbed scene at seed 5 (16 clusters)."""
    from line3d_tpu.fit import refine as jr
    from synthetic import make_scene as jmake_scene
    from test_bundle import _bundle_fixture
    from test_cluster import _random_sym_graph
    rng = np.random.default_rng(3)
    syn = jmake_scene(num_views=8, noise_px=0.3, seed=4)
    mviews, msegs, P0s, d0s = [], [], [], []
    for li, (A, B) in enumerate(syn.lines3d):
        mv = [v for v in range(8)
              for _ in np.nonzero(syn.seg_line_id[v] == li)[0]]
        ms = [s for v in range(8)
              for s in np.nonzero(syn.seg_line_id[v] == li)[0]]
        if len(mv) < 4:
            continue
        mviews.append(np.array(mv))
        msegs.append(np.array(ms))
        d_true = (B - A) / np.linalg.norm(B - A)
        P0s.append((A + B) / 2 + rng.normal(0, 0.03, 3))
        d0 = d_true + rng.normal(0, 0.03, 3)
        d0s.append(d0 / np.linalg.norm(d0))
    data = jr.build_cluster_member_data(mviews, msegs, syn.scene.segments,
                                        syn.cameras.P)
    bx = _bundle_fixture(seed=5)
    i, j, w = _random_sym_graph(60, 220, 0)
    return dict(
        graphs=dict(random=(i, j, w, 60), house=_house_graph()),
        refine=(np.stack(P0s), np.stack(d0s)) + tuple(data),
        bundle=tuple(bx[k] for k in ("P0", "d", "K", "R_pert", "t_pert",
                                     "vidx", "p1", "p2", "mask")))


@pytest.fixture(scope="module")
def stage_runs(tmp_path_factory):
    """The split device forms over 2 and 3 ranks (started first, and run
    while this process computes the rest), one process's results at the
    same block size, and line3d_tpu's mesh-sharded forms."""
    import jax
    from line3d_tpu.cluster import diffusion_device as jdd
    from line3d_tpu.fit import bundle as jb, refine as jr
    from line3d_tpu.parallel import mesh as mesh_mod
    from line3d_tpu_torch.fit import refine
    fx = _stage_fixture()
    dirs = {n: tmp_path_factory.mktemp(f"stages{n}") for n in (2, 3)}
    for d in dirs.values():
        with open(d / "stages.pkl", "wb") as f:
            pickle.dump(fx, f)
    started = {n: _start("stages", n, d, _free_port())
               for n, d in dirs.items()}
    saved = refine.BLOCK
    refine.BLOCK = STAGE_BLOCK
    try:
        one = _stage_results(fx)
        refine.BLOCK = saved
        mesh = mesh_mod.make_view_mesh(jax.devices()[:8])
        ref = {}
        for g, (i, j, w, n) in fx["graphs"].items():
            for mode in ("reference", "true"):
                fn = getattr(jdd, f"diffuse_{mode}_device")
                ref[f"diff_{g}_{mode}"] = np.stack(fn(i, j, w, n, 10,
                                                      mesh=mesh))
        ref["refine"] = jr.refine_lines_device(*fx["refine"], iterations=8,
                                               mesh=mesh)
        ref["bundle"] = jb.bundle_adjust(*fx["bundle"], iterations=5,
                                         mesh=mesh)
        runs = {}
        for n, procs in started.items():
            _run("stages", n, dirs[n], procs=procs)
            runs[n] = [_load(dirs[n], "stages", r) for r in range(n)]
    finally:
        refine.BLOCK = saved
        for procs in started.values():
            _kill(procs)
    return fx, one, ref, runs


def _block_shares(n_items, rank, nproc):
    """The clusters of each block rank `rank` owns of n_items: blocks of a
    multiple of STAGE_BLOCK, at most refine.MAX_BLOCKS of them."""
    from line3d_tpu_torch.fit import refine
    blk = STAGE_BLOCK * -(-n_items // (STAGE_BLOCK * refine.MAX_BLOCKS))
    lo, hi = multihost.my_view_range(-(-n_items // blk), rank, nproc)
    return [min(blk, n_items - b * blk) for b in range(lo, hi)]


@pytest.mark.parametrize("nproc", [2, 3])
@pytest.mark.parametrize("graph", ["random", "house"])
@pytest.mark.parametrize("mode", ["reference", "true"])
def test_split_device_diffusion(stage_runs, nproc, graph, mode):
    """(g) device diffusion split by edge: every rank's edge list equals
    the single process's bit for bit and line3d_tpu's mesh-sharded form
    within rtol 2e-4 / atol 1e-7; each rank built the dot of its own edge
    range only."""
    fx, one, ref, runs = stage_runs
    key = f"diff_{graph}_{mode}"
    E = one[key].shape[1]
    assert E > 400
    want = ref[key]
    np.testing.assert_array_equal(one[key][:2], want[:2])
    np.testing.assert_allclose(one[key][2], want[2], rtol=2e-4, atol=1e-7)
    # the dot of each diffusion: random, house graph; reference, true
    k = 2 * list(fx["graphs"]).index(graph) + ("reference", "true").index(
        mode)
    for r, got in enumerate(runs[nproc]):
        np.testing.assert_array_equal(got[key], one[key])
        lo, hi = multihost.my_view_range(E, r, nproc)
        assert got["share_edge_dot"][k] == hi - lo > 0
    assert one["share_edge_dot"][k] == E


@pytest.mark.parametrize("nproc", [2, 3])
def test_split_device_refinement(stage_runs, nproc):
    """(h) device refinement split by blocks of clusters: every rank's
    lines and rms equal the single process's bit for bit, and
    line3d_tpu's mesh-sharded refinement by tests/test_refine.py's
    criteria; each rank solved its own blocks only."""
    fx, one, ref, runs = stage_runs
    C = len(fx["refine"][0])
    got1 = (one["refine"][:, 0:3], one["refine"][:, 3:6],
            one["refine"][:, 6], one["refine"][:, 7])
    Pd, dd, rb_d, ra_d = got1
    Pr, dr, rb_r, ra_r = ref["refine"]
    np.testing.assert_allclose(rb_d, rb_r, rtol=1e-4, atol=1e-4)
    assert np.median(ra_d) <= np.median(ra_r) * 1.1 + 1e-3
    assert (ra_d <= ra_r + 0.05).all(), (ra_d - ra_r).max()
    assert np.abs(np.sum(dd * dr, axis=1)).min() > 0.9999
    assert np.linalg.norm(np.cross(Pd - Pr, dr), axis=1).max() < 5e-3
    assert list(one["share_refine_lines_t"]) == _block_shares(C, 0, 1)
    for r, got in enumerate(runs[nproc]):
        np.testing.assert_array_equal(got["refine"], one["refine"])
        mine = _block_shares(C, r, nproc)
        assert list(got["share_refine_lines_t"]) == mine and len(mine) > 0


@pytest.mark.parametrize("nproc", [2, 3])
def test_split_bundle_adjustment(stage_runs, nproc):
    """(i) BA split by blocks of clusters, the reduced camera system summed
    over the ranks in block order: every rank's lines, poses and rms equal
    the single process's bit for bit, and line3d_tpu's mesh-sharded BA
    within atol 5e-4 (rms 1e-3); each rank linearised its own clusters
    only."""
    fx, one, ref, runs = stage_runs
    C = len(fx["bundle"][0])
    P0, d, R, t, rb, ra = ref["bundle"]
    np.testing.assert_allclose(one["ba_lines"][:, :3], P0, rtol=0, atol=5e-4)
    np.testing.assert_allclose(one["ba_lines"][:, 3:], d, rtol=0, atol=5e-4)
    np.testing.assert_allclose(one["ba_R"], R, rtol=0, atol=5e-4)
    np.testing.assert_allclose(one["ba_t"], t, rtol=0, atol=5e-4)
    assert abs(one["ba_rms"][1] - ra) < 1e-3 and \
        one["ba_rms"][1] < one["ba_rms"][0]
    assert list(one["share_bundle"]) == [C]
    for r, got in enumerate(runs[nproc]):
        for k in ("ba_lines", "ba_R", "ba_t", "ba_rms"):
            np.testing.assert_array_equal(got[k], one[k], err_msg=k)
        assert list(got["share_bundle"]) == [sum(_block_shares(C, r,
                                                               nproc))]


def test_two_ranks_house10_cluster_stage(tmp_path, monkeypatch):
    """(j) the noisy house through the whole pipeline over 2 ranks with the
    cluster stage's device forms: reference-mode device diffusion alone,
    with device refinement, and true-mode device diffusion with BA.  Every
    rank's TXT equals one process's byte for byte (the refined poses bit
    for bit); the diffusion model reads as tests/golden/house10_diffusion.txt
    with its pinned tokens; each rank received bytes in the stages it
    split and diffused only its own edge range."""
    from line3d_tpu_torch.fit import refine
    from line3d_tpu_torch.io.writers import compare_txt
    from torch_port_helpers import HOUSE10_DIFFUSION_OUTSIDE
    procs = _start("house10stages", 2, tmp_path, _free_port())
    monkeypatch.setattr(refine, "BLOCK", STAGE_BLOCK)
    ones, clusters = {}, {}
    try:
        for tag, kw in HOUSE_STAGES.items():
            ones[tag] = _house(10, L3DConfig(use_collinearity=True, **kw),
                               **NOISY)
            with _Shares() as sh:
                ones[tag].compute_3d_model()
            clusters[tag] = sum(sh.sizes["_refine_lines_t"]) + \
                sum(sh.sizes["_bundle"])
            _model(ones[tag], str(tmp_path / f"one_{tag}.txt"))
        _run("house10stages", 2, tmp_path, procs=procs)
    finally:
        _kill(procs)
    rep = compare_txt(str(tmp_path / "house10stages_0_diffusion.txt"),
                      os.path.join(HERE, "golden", "house10_diffusion.txt"))
    assert rep["int_bad"] == 0, rep
    assert rep["outside"] == HOUSE10_DIFFUSION_OUTSIDE, rep
    for r in range(2):
        got = _load(tmp_path, "house10stages", r)
        for tag, one in ones.items():
            assert _txt(tmp_path / f"house10stages_{r}_{tag}.txt") == \
                _txt(tmp_path / f"one_{tag}.txt"), (r, tag)
            E = int(got[f"{tag}_edges"])
            lo, hi = multihost.my_view_range(E, r, 2)
            assert list(got[f"{tag}_share_edge_dot"]) == [hi - lo]
            split = dict(zip(("diffusion", "fit"), got[f"{tag}_bytes"]))
            assert split["diffusion"] > 0 and \
                (split["fit"] > 0) == (tag != "diffusion"), (tag, split)
            assert one.stats["gathered_by_stage"] == dict.fromkeys(
                ("collinearity", "matching", "affinity", "diffusion",
                 "fit"), 0)
        for a, b in zip((got["bundle_R"], got["bundle_t"]),
                        ones["bundle"].refined_poses):
            np.testing.assert_array_equal(a, b)
        mine = _block_shares(clusters["refine"], r, 2)
        assert list(got["refine_share_refine_lines_t"]) == mine != []
        assert list(got["bundle_share_bundle"]) == \
            [sum(_block_shares(clusters["bundle"], r, 2))] != [0]


if __name__ == "__main__":
    _worker(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]),
            int(sys.argv[4]), sys.argv[5])
