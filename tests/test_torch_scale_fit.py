"""The port's noisy-capture path at scale, and its tools, on the CPU.

(1) The counterpart of tests/test_pipeline_extras.py's
    test_hundreds_of_views_scale: the port's `Line3D(device="cpu")` on the
    256-view synthetic house (`make_scene(256, radius=6.0)`), collinearity
    off, 4 neighbours, diffusion on, held to line3d_tpu's assertions (every
    view counted, at least 8 lines, each seen in at least 4 views).
(2) The same configuration at HOUSE_VIEWS views against line3d_tpu's
    `Line3D`: the same lines by member sets, integer tokens equal; the
    float tokens outside `compare_txt`'s rtol 1e-5 / atol 1e-6 pinned
    (HOUSE_OUTSIDE) and traced to matching as tests/test_torch_scale.py
    traces the 40-view house: every view's verified matches equal, every
    differing best pick a near-tie, and the port's matching outputs
    through line3d_tpu's affinity, diffusion, F-H, fit and writer give the
    port's TXT byte for byte.
(3) `utils/refine_bench.synthesize` against the JAX package's
    scripts/refine_bench.py `synthesize` (loaded by path, its persistent
    compile cache left off): every array equal.  The port's device
    refinement on CPU tensors against line3d_tpu's `refine_lines_device`
    and against the float64 host at C = 2,000, by tests/test_refine.py's
    criteria (the rms-before tolerance widened to the float32 residual
    floor, `refine_bench.agreement`).
(4) The repairs the card's runs at scale called for.  The device
    diffusion's pair sums formed a chunk of rows at a time, and its
    true-mode merge walk a chunk of edges at a time: on random graphs and
    at any chunk size, the same bits as in one piece.  The round-parallel
    F-H with its rounds in torch: line3d_tpu's labels where the rounds
    number a cluster's size.  The bundle adjustment (BA) on unpadded
    member rows, over 4 CPU ranks: phase facadeba's configuration on the
    4-view facade through `utils/scale_exact_profile.py --config facadeba`
    (its diffusion on the device form, in chunks of CHUNK_ROWS index
    elements), with `refine.BLOCK` cut to BA_BLOCK so that three ranks own
    a block of the fitted clusters each and the fourth none: every rank's
    TXT and refined poses equal one process's byte for byte (`--expect`).
(5) The tools' options on the CPU (`refine_bench`; `scale_exact_profile
    --config`, `--scene clutter`, `--capped` and the file names), and their
    raise without CUDA.
"""
import importlib.util
import json
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

from line3d_tpu_torch import Line3D, L3DConfig  # noqa: E402
from line3d_tpu_torch.fit import refine  # noqa: E402
from line3d_tpu_torch.parallel import multihost  # noqa: E402
from line3d_tpu_torch.utils import refine_bench  # noqa: E402
from line3d_tpu_torch.utils import scale_exact_profile as sep  # noqa: E402
from line3d_tpu_torch.utils.synthetic import make_scene  # noqa: E402

# (1): tests/test_pipeline_extras.py's _run_scale configuration
SCALE_CONFIG = dict(use_collinearity=False, matching_neighbors=4,
                    perform_diffusion=True)
# (2): the reduced view count, and its TXT tokens and the float tokens
# outside compare_txt's tolerance against line3d_tpu's (the largest at
# 6.59 times it): all 16 lines share their member sets and integer tokens
HOUSE_VIEWS = 24
HOUSE_OUTSIDE = (2426, 7, 6.6)
# (3): the clusters of the refinement held to line3d_tpu's
REFINE_CLUSTERS = 2000
# (4): the views, the ranks and the cut block: the 4-view facade fits 300
# clusters, so blocks of 2 * BA_BLOCK = 128 clusters, one on each of the
# first three ranks and none on the last
BA_VIEWS, BA_RANKS, BA_BLOCK = 4, 4, 64
# (4): index elements a chunk of the diffusion's pair sums
CHUNK_ROWS = 64
JOIN_TIMEOUT_S = 180
PORT_IN_USE, PORT_ATTEMPTS = "EADDRINUSE", 3


def _feed(l3d, syn):
    for v in range(syn.scene.num_views):
        l3d.add_view_segments(
            v, syn.scene.segments[v][syn.scene.seg_mask[v]],
            syn.cameras.K[v].copy(), syn.cameras.R[v].copy(),
            syn.cameras.t[v].copy(), worldpoint_ids=syn.wp_lists[v],
            width=640, height=480)
    return l3d


# ----------------------------------------------------------------------
# (1) 256 views with diffusion on

def test_hundreds_of_views_scale():
    """(1) 256 views end to end with diffusion on, on CPU tensors."""
    syn = make_scene(num_views=256, radius=6.0, device="cpu")
    l3d = _feed(Line3D(config=L3DConfig(**SCALE_CONFIG), device="cpu"), syn)
    res = l3d.compute_3d_model()
    assert l3d.stats["num_views"] == syn.scene.num_views == 256
    assert len(res) >= 8
    for line in res:
        assert len(np.unique(line.views2d)) >= 4


# ----------------------------------------------------------------------
# (2) the same configuration against line3d_tpu's model

def test_house_with_diffusion_against_reference(tmp_path):
    """(2) the port's and line3d_tpu's Line3D (host selection, so its
    ViewMatches carry confidences) on the HOUSE_VIEWS-view house with
    (1)'s configuration: the same lines by member sets and integer
    tokens, the float tokens outside pinned (HOUSE_OUTSIDE) and traced to
    matching."""
    import line3d_tpu.pipeline as jp
    from line3d_tpu import L3DConfig as JConfig, Line3D as JLine3D
    from line3d_tpu.cluster import affinity as ja, diffusion as jd, fh as jfh
    from line3d_tpu.fit import lines as jl
    from line3d_tpu.io import writers as jw
    from line3d_tpu_torch.io.writers import compare_txt
    from line3d_tpu_torch.utils import compare
    from torch_port_helpers import to_reference
    syn = make_scene(num_views=HOUSE_VIEWS, radius=6.0, device="cpu")
    port = _feed(Line3D(config=L3DConfig(**SCALE_CONFIG), device="cpu"), syn)
    a = str(tmp_path / "port.txt")
    port.save_3d_lines_as_txt(port.compute_3d_model(), a)
    cfg = JConfig(**SCALE_CONFIG)
    ref = _feed(JLine3D(config=cfg, use_sharded_engine=False), syn)
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
    assert (rep["n_tokens"], len(rep["outside"])) == HOUSE_OUTSIDE[:2]
    assert rep["worst_ratio"] < HOUSE_OUTSIDE[2], rep["worst_ratio"]

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
        None, to_reference(port.cameras), cfg, S)    # collinearity off
    assert port.scene.collin is None
    g = jd.run_diffusion(g, cfg)
    labels = jfh.fh_cluster(g.edges_i, g.edges_j, g.edges_w, g.num_nodes,
                            cfg.fh_c)
    attr = jl.process_clusters(g, labels, to_reference(port.best),
                               to_reference(port.transform), cfg, S)
    c = tmp_path / "attr.txt"
    segs = port.scene.segments
    jw.save_txt(attr, str(c), get_segment_2d=lambda v, s: segs[v, s],
                view_id_map=list(range(HOUSE_VIEWS)))
    assert c.read_bytes() == (tmp_path / "port.txt").read_bytes()


# ----------------------------------------------------------------------
# (3) refine_bench's inputs and the device refinement on them

def _jax_refine_bench(monkeypatch):
    """scripts/refine_bench.py as a module, its persistent compile cache
    (a directory under the home) not switched on."""
    from line3d_tpu.utils import xla_cache
    monkeypatch.setattr(xla_cache, "enable_persistent_cache",
                        lambda *a, **k: None)
    spec = importlib.util.spec_from_file_location(
        "jax_refine_bench", os.path.join(REPO, "scripts", "refine_bench.py"))
    mod = importlib.util.module_from_spec(spec)
    path = list(sys.path)
    try:
        spec.loader.exec_module(mod)          # it puts ".." on sys.path
    finally:
        sys.path[:] = path
    return mod


@pytest.mark.parametrize("C,seed", [(REFINE_CLUSTERS, 0), (37, 5)])
def test_refine_bench_synthesize_equals_the_jax_script(monkeypatch, C,
                                                        seed):
    """(3) every array of the port's refine_bench inputs equals the JAX
    script's, dtypes too."""
    want = _jax_refine_bench(monkeypatch).synthesize(C, seed=seed)
    got = refine_bench.synthesize(C, seed=seed)
    assert len(got) == len(want) == 6
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    assert got[2].shape == (C, 12, 3, 4)


@pytest.fixture(scope="module")
def bench_inputs():
    return refine_bench.synthesize(REFINE_CLUSTERS)


@pytest.fixture(scope="module")
def port_refined(bench_inputs):
    return refine.refine_lines_device(*bench_inputs, device="cpu")


@pytest.mark.parametrize("against", ["line3d_tpu", "host"])
def test_device_refine_at_bench_scale(bench_inputs, port_refined, against):
    """(3) the port's device refinement on CPU tensors at C = 2,000
    (blocks of 512) against line3d_tpu's device refinement and against the
    float64 host, by tests/test_refine.py's criteria."""
    if against == "line3d_tpu":
        from line3d_tpu.fit import refine as jr
        want = jr.refine_lines_device(*bench_inputs)
    else:
        want = refine.refine_lines(*bench_inputs)
    want = [np.asarray(x, np.float64) for x in want]
    ag = refine_bench.agreement(port_refined, want,
                                refine_bench.residual_floor(*bench_inputs))
    assert ag["ok"], ag
    assert ag["within"] > 0.99 and ag["clusters"] == REFINE_CLUSTERS
    assert np.median(port_refined[3]) < np.median(port_refined[2]) / 3


def test_refine_bench_main_on_cpu(tmp_path, capsys):
    """`refine_bench 600 --device cpu --host-subset 200 --out F`: one JSON
    line (seconds, medians, the agreement on the host's 200 clusters) and
    the cold result, which then passes as its own `--expect`."""
    out = str(tmp_path / "rb.npz")
    assert refine_bench.main(["600", "--device", "cpu", "--host-subset",
                              "200", "--out", out]) == 0
    rec = json.loads(capsys.readouterr().out)
    assert rec["C"] == 600 and rec["M"] == 12 and rec["host_clusters"] == 200
    assert rec["block"] == 256 and rec["blocks_local"] == [0, 600]
    assert rec["agreement"]["ok"] and rec["agreement"]["clusters"] == 200
    assert rec["device_rms_after"] < rec["device_rms_before"]
    assert rec["card"] is None and rec["max_memory_allocated"] is None
    assert rec["equal_to_expect"] is None
    with np.load(out) as z:
        res = {k: z[k] for k in refine_bench.OUTPUTS}
    assert res["P0"].shape == (600, 3)
    assert refine_bench._check_expect(res, out)
    res["rms_after"] = res["rms_after"] + 1e-12
    with pytest.raises(RuntimeError, match="differs"):
        refine_bench._check_expect(res, out)


# ----------------------------------------------------------------------
# (4) the repairs: the diffusion in chunks, the BA over 4 ranks

@pytest.mark.parametrize("mode", ["reference", "true"])
@pytest.mark.parametrize("chunk", [40, 1000])
def test_diffusion_chunks_keep_the_bits(monkeypatch, mode, chunk):
    """(4) the device diffusion with its pair sums formed `chunk` index
    elements at a time, and the true mode's merge walk on chunks of edges
    of at most `chunk` meetings, gives the bits of one piece, on a random
    symmetric
    graph of 120 nodes and ~2,700 entries (length classes up to 64, so
    the smaller chunk forms some rows one at a time)."""
    from line3d_tpu_torch.cluster import diffusion_device as dd
    from test_cluster import _random_sym_graph
    n = 120
    i, j, w = _random_sym_graph(n, 1500, 11)
    fn = getattr(dd, f"diffuse_{mode}_device")
    args = (i, j, w, n)
    want = fn(*args, device="cpu")
    monkeypatch.setattr(dd._PairSums, "CHUNK", chunk)
    monkeypatch.setattr(dd, "WALK_CHUNK", chunk)
    got = fn(*args, device="cpu")
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    assert len(want[2]) == len(w) > 2500


@pytest.mark.parametrize("leaves,seed", [(64, 1), (400, 2)])
def test_fh_parallel_rounds_in_torch_equal_reference(leaves, seed):
    """(4) the round-parallel F-H, its rounds in torch (here on the CPU),
    gives line3d_tpu's numpy labels exactly where the rounds number a
    cluster's size: a star whose centre takes in one leaf a round (its
    edges ascending in weight), with heavier random edges among the
    leaves and an unrelated random graph beside it."""
    from line3d_tpu.cluster import fh as jfh
    from line3d_tpu_torch.cluster import fh
    from test_cluster import _random_sym_graph
    rng = np.random.default_rng(seed)
    k = np.arange(1, leaves + 1)
    a = rng.integers(1, leaves + 1, 3 * leaves)
    b = rng.integers(1, leaves + 1, 3 * leaves)
    i2, j2, w2 = _random_sym_graph(200, 600, seed)
    ei = np.concatenate([np.zeros(leaves, np.int64), k, a, b,
                         i2 + leaves + 1])
    ej = np.concatenate([k, np.zeros(leaves, np.int64), b, a,
                         j2 + leaves + 1])
    w_star = 1e-3 * k
    w_cross = rng.uniform(0.6, 0.9, 3 * leaves)
    ew = np.concatenate([w_star, w_star, w_cross, w_cross, w2])
    n = leaves + 201
    want = jfh.fh_cluster_parallel(ei, ej, ew, n, 1.0)
    got = fh.fh_cluster_parallel(ei, ej, ew, n, 1.0, device="cpu")
    np.testing.assert_array_equal(got, want)
    assert np.bincount(want).max() >= leaves // 2


def _device_diffusion(monkeypatch=None):
    """Phase facadeba's configuration with the device diffusion on the CPU,
    its pair sums in chunks of CHUNK_ROWS, and blocks of BA_BLOCK."""
    from line3d_tpu_torch.cluster import diffusion_device as dd
    from line3d_tpu_torch.utils import time_match_view as tmv
    cfg = dict(tmv.FACADE_CONFIGS["facadeba"], diffusion_backend="device")
    for obj, name, value in ((tmv.FACADE_CONFIGS, "facadeba", cfg),
                             (dd._PairSums, "CHUNK", CHUNK_ROWS),
                             (refine, "BLOCK", BA_BLOCK)):
        if monkeypatch is None:
            if isinstance(obj, dict):
                obj[name] = value
            else:
                setattr(obj, name, value)
        elif isinstance(obj, dict):
            monkeypatch.setitem(obj, name, value)
        else:
            monkeypatch.setattr(obj, name, value)


def _ba_worker(port, rank, nproc, outdir):
    assert multihost.initialize(f"127.0.0.1:{port}", nproc, rank)
    torch.set_num_threads(2)
    _device_diffusion()
    rec = sep.profile_views(BA_VIEWS, "cpu", 0, outdir,
                            os.path.join(outdir, "one"), config="facadeba")
    assert rec["txt_equal"] in (None, [True] * nproc)
    assert rec["poses_equal"] in (None, [True] * nproc)
    with open(os.path.join(outdir, f"rank{rank}.json"), "w") as f:
        json.dump(rec, f)
    torch.distributed.destroy_process_group()


def _free_port():
    import socket
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _run_ranks(outdir):
    """Start BA_RANKS workers, join them under JOIN_TIMEOUT_S (the others
    killed as soon as one fails), restart on another port when rank 0
    finds its rendezvous port taken; returns the processes and logs."""
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    for k in ("WORLD_SIZE", "RANK", "LOCAL_RANK", "MASTER_ADDR",
              "MASTER_PORT"):
        env.pop(k, None)
    for _ in range(PORT_ATTEMPTS):
        port, procs = _free_port(), []
        for r in range(BA_RANKS):
            with open(os.path.join(outdir, f"log{r}.txt"), "w") as log:
                procs.append(subprocess.Popen(
                    [sys.executable, os.path.abspath(__file__), str(port),
                     str(r), str(BA_RANKS), str(outdir)], env=env,
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
        for r in range(BA_RANKS):
            with open(os.path.join(outdir, f"log{r}.txt")) as f:
                logs.append(f.read())
        if PORT_IN_USE not in logs[0]:
            break
    return procs, logs


def test_ba_over_four_ranks_equals_one_process(tmp_path, monkeypatch):
    """(4) phase facadeba's configuration on the 4-view facade (its
    diffusion on the device form, in chunks) with blocks of 2 * BA_BLOCK
    clusters: one process writes its TXT and poses, then 4 ranks (a block
    on each of three, none on the last, which still sends its empty share
    of the reduced camera system) write theirs, and rank 0 holds every
    rank's to one process's byte for byte (`--expect`)."""
    from line3d_tpu_torch.cluster import diffusion_device as dd
    _device_diffusion(monkeypatch)
    calls = []
    orig = dd.diffuse_true_device
    monkeypatch.setattr(dd, "diffuse_true_device",
                        lambda *a, **k: calls.append(1) or orig(*a, **k))
    one = sep.profile_views(BA_VIEWS, "cpu", 0, str(tmp_path / "one"),
                            config="facadeba")
    name = sep.stem(BA_VIEWS, config="facadeba")
    assert name == "facade_facadeba_V4"
    C = one["members"]["clusters"]
    blk = refine.block_size(C)
    assert blk == 2 * BA_BLOCK and -(-C // blk) == BA_RANKS - 1, (C, blk)
    assert one["ba_rms"][1] < one["ba_rms"][0] and calls == [1]
    procs, logs = _run_ranks(tmp_path)
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r} failed:\n{log[-4000:]}"
    want_txt = (tmp_path / "one" / f"{name}.txt").read_bytes()
    with np.load(tmp_path / "one" / f"{name}_poses.npz") as z:
        assert z["R"].shape == (BA_VIEWS, 3, 3)
    for r in range(BA_RANKS):
        assert (tmp_path / f"{name}_rank{r}.txt").read_bytes() == want_txt
        rec = json.loads((tmp_path / f"rank{r}.json").read_text())
        assert rec["poses_sha256"] == one["poses_sha256"]
        assert rec["gathered_by_stage"]["fit"] > 0
    rec0 = json.loads((tmp_path / "rank0.json").read_text())
    assert rec0["txt_equal"] == rec0["poses_equal"] == [True] * BA_RANKS


# ----------------------------------------------------------------------
# (5) the tools' options and their raise without CUDA

def test_scale_exact_profile_options(monkeypatch):
    """(5) --config, --scene and --capped reach each V's run, and name its
    files; the configs are time_match_view's, --capped turns the
    uncapped fallback off, --scene clutter is make_demo_scene(V, 2990)."""
    from line3d_tpu_torch.utils.demo import make_demo_scene
    from line3d_tpu_torch.utils.time_match_view import FACADE_CONFIGS
    seen = []
    monkeypatch.setattr(sep, "profile_views",
                        lambda *a: seen.append(a) or dict(V=a[0]))
    assert sep.main(["5", "7", "--device", "cpu", "--config", "facaded",
                     "--scene", "clutter", "--capped", "--warm", "0"]) == 0
    assert [a[0] for a in seen] == [5, 7]
    assert seen[0][1:] == ("cpu", 0, None, None, True, "facaded", "clutter",
                           True)
    cfg = sep.make_config("facadeba", capped=True)
    assert not cfg.uncapped_fallback and cfg.bundle_adjust_cameras
    for k, v in FACADE_CONFIGS["facadeba"].items():
        assert getattr(cfg, k) == v
    assert sep.make_config().uncapped_fallback
    scene, cams = sep.make_scene(4, "clutter", cfg, "cpu")
    want, wcams = make_demo_scene(4, num_random_segments=2990, config=cfg,
                                  device="cpu")
    assert scene.max_segments == 3072
    np.testing.assert_array_equal(scene.segments, want.segments)
    np.testing.assert_array_equal(cams.R, wcams.R)
    assert sep.stem(4) == "V4"
    assert sep.stem(1000, "clutter", "exact", True) == \
        "clutter_exact_capped_V1000"


@pytest.mark.parametrize("tool,argv", [
    ("refine_bench", ["100"]),
    ("scale_exact_profile", ["8", "--config", "facadeba"]),
    ("scale_exact_profile", ["8", "--scene", "clutter", "--capped"]),
    ("stress_stage_bench", []), ("quota_bucket_bench", []),
    ("cli_bench", ["--views", "2", "--format", "nvm"]),
    ("trace_check", ["facade", "--views", "4"])])
def test_tools_raise_without_cuda(tool, argv):
    """The tools run on the card by default: without CUDA they raise
    before any work."""
    import importlib
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    mod = importlib.import_module(f"line3d_tpu_torch.utils.{tool}")
    with pytest.raises(RuntimeError, match="is_available"):
        mod.main(argv)


if __name__ == "__main__":
    _ba_worker(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]),
               sys.argv[4])
