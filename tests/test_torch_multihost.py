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
"""
import os
import pickle
import socket
import subprocess
import sys

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
# the capped mode of case (b): caps so low that views overflow and their
# owners re-match them (tests/test_torch_caps.py's TINY)
CAPPED = dict(use_collinearity=True, capacity_probe=False,
              match_block_quota=1, max_matches_per_segment=8)
# case (d): two ranks of 3 and 2 views with 64 and 96 segment slots
SEG_VIEWS, SEG_S = (3, 2), (64, 96)


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _house(num_views, config):
    syn = make_scene(num_views=num_views, device="cpu")
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
    elif case == "segments":
        segs, mask, start = _seg_shard(rank)
        got_s, got_m = multihost.allgather_segments(segs, mask, start,
                                                    sum(SEG_VIEWS))
        np.savez(out + ".npz", segments=got_s, mask=got_m)
    else:
        raise ValueError(case)
    dist.destroy_process_group()


def _run(case, nproc, outdir, expect_ok=True):
    """Start `nproc` ranks of `case`, join them (JOIN_TIMEOUT_S, then
    kill all); returns their outputs."""
    port = _free_port()
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    for k in ("WORLD_SIZE", "RANK", "LOCAL_RANK", "MASTER_ADDR",
              "MASTER_PORT"):
        env.pop(k, None)
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), case, str(port),
         str(r), str(nproc), str(outdir)], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(nproc)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=JOIN_TIMEOUT_S)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
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


if __name__ == "__main__":
    _worker(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]),
            int(sys.argv[4]), sys.argv[5])
