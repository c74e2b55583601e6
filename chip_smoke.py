#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (`line3d_tpu_torch`) end to end on one GPU.

    python3 chip_smoke.py            # all phases

Phases (each prints its own lines and its seconds; any failure raises and
exits non-zero):
  1. device    require CUDA; print the card's name and power limit.
  2. build     compile the CUDA kernels (csrc/*.cu, one nvcc per source in
               parallel, sm_90a) and the native host library (the port's
               own native/*.cpp, one g++) from the checkout; print the
               seconds.
  3. kernels   each kernel against its plain PyTorch twin on the card, on
               inputs cut from view 0 of the 25-view facade scene: K1 (pair
               valid plane, with the pairs that pass its cheap gates and
               the warps holding any), K4 (every view's collinear pair
               lists in one call: the 25 facade views at quota 8 and 1,
               a 512-segment chain where the cap bites, S=100 with a
               masked view, S=2990, and two facade views at sigma = 3,
               where 2 sigma^2 is no power of two), and the scoring kernel
               at M=256 and
               M=1024 (with the dense walk's pair tests and the spatial
               gate's survivors); then the affinity stage's enumeration
               (csrc/affinity_enum.cu) on the inputs of one exact model
               of the benchmark's P25 facade capture (19.6 M
               candidates), its candidate stream held to the native walk's
               element for element, and its weight filter
               (csrc/affinity_filter.cu) on that stream: the kept
               candidates its numpy twin's and a superset of the native
               sweep's passes, the kept share logged; errors, CUDA-event
               times (the enumeration's call, its walk and the filter's
               whole call by host clock) and each kernel's bound.
  4. validate  K5 (dense depth planes) through `pair_dense`, the port's
               counterpart of scripts/tpu_validate.py's phase 2: the house
               pair at S=384 and facade view 0 x 10 neighbors, held against
               the plain twin, and K1's plane held to K5's valid plane;
               K5's fast reciprocals and roots against the IEEE operations
               on every float of their range; CUDA-event times.
  5. peak      K6: the card's float32 FMA rate (`measure_fp32_peak`, the
               marginal-rate protocol of bench.py), and the chain held
               against its twin.
  6. house10   the 10-view synthetic house through Line3D(device="cuda"),
               held against tests/golden/house10.txt.
  7. house10d  the noisy house with diffusion (host backend) against
               tests/golden/house10_diffusion.txt; then the device backend,
               its weights held to the host's on the same graph.
  8. facade    the 25-view facade scene, exact matching: one cold run and
               three warm runs, with the kernels' launch counts from one
               warm run, and one run under torch.profiler with the
               recorder on (the device ops that took the most time, the
               readbacks' synchronisations and bytes by site from the
               recorder's counters, beside the device-to-host copies the
               profiler saw); two runs with
               use_sharded_engine=False (host selection), whose TXT must
               equal the default's byte for byte; then views 0 and 12:
               K1's planes against its twin, the per-view step re-run on
               the CPU with the plain twins
               on the card's K1 planes, its tables, scores and best matches
               compared with the card's, the capacity-probe counters
               held to those counted from the twin's planes, the device
               selection held to the host selection on the same card
               tables, and the host synchronisations of one view's step
               counted (at most three).  Then the reduced facade of
               tests/test_torch_host.py (facade6: 6 views, 960 x 720) on
               the card (launches counted) and on the CPU (plain twins, host
               selection): each view's verified matches may differ on
               less than 1e-3 of them, each differing best-match pick
               must be a near-tie, lie in a row whose verified matches
               differ, or be a tie of the float64 confidences; the two
               models compared by member sets.
  9. facaded   the facade with device diffusion (reference mode) and device
               line refinement: one cold and three warm runs; the diffused
               weights held to the float64 host on the same graph, the
               refined lines to the host refinement on the same clusters;
               the model's TXT recorded (its sha256).
 10. facadeba  one facade run with joint camera + line bundle adjustment,
               "true"-mode device diffusion and the round-parallel F-H; its
               TXT recorded (its sha256) and its refined poses kept.
 11. capped    the facade's three matching modes: (a) the default (the
               probe's one pass: nothing overflows or is re-matched, the
               model of phase 8), (b) capacity_probe=False (the capped pass
               at m_total=256 overflows, the fallback re-matches those
               views, the same TXT model token for token), (c)
               uncapped_fallback=False (the capped pass alone, with its
               warning); and view 0's capped table scored by the kernel at
               M=256 against the twin.
 12. stress    the P25 stress scene, `make_demo_scene(25,
               num_random_segments=2990)` (S = 3072), exact on the card:
               one cold and one warm run, its exact capacities and no
               overflow left.
 13. stressstages
               view 0 of the P25 stress scene (S = 3072, N = 10): the
               per-view step in cumulative stages A-E
               (`utils/stress_stage_bench.py`: K1 + probe counters +
               block compaction, the merge, the depth recompute, the
               scoring kernel, the device selection) at the JAX script's
               (quota, m_total) = (8, 2048) and at the view's exact
               capacity, host clock and CUDA events, with the occupancy of
               the merged table; then the whole step at the ten (m_total,
               quota) pairs of `utils/quota_bucket_bench.py`, where every
               pair that drops nothing must select what the (2048, 8) pair
               selects; each stage's launches counted (K1 once a call, the
               scoring kernel at M > 256 except at m_total 256); the timed
               step's selection equal to `engine.match_views`' at both
               capacities, and K1 and the scoring kernel held against their
               twins at the view.
 14. cli       the 25 facade views rendered at 1920 x 1440 (numpy
               rasteriser, binary PGM) with an NVM_V3 file, through
               `cli.main(["vsfm", ...])` on the card: one stamped STL and
               TXT, the detection's seconds and segments per view, the
               model's median distance to the ground-truth facade lines,
               and K1, the scoring kernel and K4 held against their twins
               at this run's shapes (S = 3072, M = 1024 and 2048; the
               scoring kernel also against its twin in float64; on the
               first of those views the device selection held to the host
               selection); a second run from the 25 segment caches with
               host selection (the same TXT byte for byte); a third as
               `python -m line3d_tpu_torch.cli vsfm
               ... --profile_dir` in a process of its own, whose trace must
               name the three kernels; then, if cv2 or PIL imports, the
               same images as PNG with a bundle.rd.out through
               `cli.main(["bundler", ...])`, held as the vsfm run is.
 15. multiproc the facade over max(2, cards) ranks (torch.distributed,
               gloo on 127.0.0.1), each a process of its own on
               cuda:{rank % cards} (one card: two ranks share it): each
               rank matches and collinearises only its own views (K1 and
               the scoring kernel once per own view, K4 once, and once
               more for the views every rank re-runs at exact capacity)
               and all-gathers what they read back; the exact run and the
               capped run (capacity_probe=False: the owners re-match the
               overflowing views) must write phase 8's TXT byte for byte
               on every rank, and each rank's K4 lists must equal the
               single launch's rows.  Then the cluster stage split across
               the ranks: (c) phase 9's configuration (cold and warm; the
               device diffusion's dot by edge range, the refinement by
               blocks of clusters) and (d) phase 10's (the BA's line blocks
               by blocks of clusters, its reduced camera system summed
               over the ranks): each rank's TXT must equal phase 9's and
               10's byte for byte, (d)'s refined poses phase 10's bit for
               bit, and each rank must have built its dot and its
               per-cluster tensors for its own share only.
 16. scale     the facade at 256 views (S = 1408), exact: (a) one cold and
               one warm run in this process, its launches counted (K1 and
               the scoring kernel once a view, K4 once and once more
               for an exact re-run), the model exact
               (no match overflow left, every view the collinearity's
               first pass dropped pairs of re-run) with lines; (b) K1, the
               scoring kernel and K4 against their twins at that run's
               shapes, as in phase cli: K1 and the scoring kernel at views
               0, 128 and 255, K4 on all 256 views; (c) the same model
               over max(2, cards) ranks, one run each, every rank's TXT
               (a)'s byte for byte.
 17. scalefit  phases facaded's and facadeba's configurations on the
               facade at 256 views: one cold and one counted warm run
               each, the device diffusion run again bit-equal and (true
               mode) held to the float64 host on the same graph, the
               device refinement to the float64 host refinement on the
               same clusters, the BA's rms and poses;
               then max(2, cards) ranks, each rank's TXT of both and its
               refined poses one process's byte for byte; then the
               refinement alone at 173,000 clusters
               (utils/refine_bench.py) against the float64 host on its
               first 20,000.
 18. clutter   make_demo_scene(100, num_random_segments=2990) (S = 3072),
               exact (every view at its exact capacity, K2) and capped
               (uncapped_fallback=False: M = 256, K3, the overflow
               counted), each counted, with K1, the scoring kernel and K4
               held against their twins at views 0, 50 and 99 of each.
 19. cudatests the `cuda`-marked tests of tests/test_torch_kernels_cuda.py
               on the card, in a process of their own (`python -m pytest
               ... -m cuda --noconftest`): pytest must exit 0 and at least
               48 must pass (49 on two cards or more).

Each path's kernel launch counts are set to 0 just before it is driven and
read just after; every counted model must run the affinity enumeration
and its filter once on its card (four launches and two), and where a
path's kernels are held against their twins at its shapes, that run's
candidate stream is held to the native walk's on the same inputs and its
kept candidates to the filter's twin and the native sweep.  The line before last is the card as
`nvidia-smi` reports it, the last line the result object.  The script
imports no JAX and nothing of `line3d_tpu`.
"""
from __future__ import annotations

import contextlib
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

GOLDEN_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "tests", "golden")
# kernel-vs-plain tolerances (tests/test_pallas.py)
# K1 keeps the Pallas kernel's arithmetic, its twin the dense formulation;
# they part on borderline overlap gates: over the 25 facade views 212 of
# 5,279,892 valid pairs, at most 3.55e-4 of a view's (view 12, NVIDIA H100)
PAIR_DISAGREE_MAX = 4e-4          # fraction of the plain twin's valid pairs
SCORE_RTOL, SCORE_ATOL = 2e-3, 2e-4
SCORE_FLIP_MAX = 1e-4             # fraction of scored slots
# the one house10 token outside test_golden.py's rtol 1e-5 / atol 1e-6, on
# the CPU and on the card alike: (line, port, golden).  The golden holds
# XLA:CPU's float32 triangulation (fused multiply-adds, an approximate
# rsqrt); the port's float32 (and a float64) recompute prints -0.57194.
HOUSE10_OUTSIDE = [(0, "-0.57194", "-0.571947")]
# the house10_diffusion tokens outside it (tests/torch_port_helpers.py): a
# sweep-order near-tie of two member endpoints of line 10 (8e-8 apart in
# the golden, swapped by the port's float32 depths) and one token of line
# 11 at 1.01 of its tolerance
HOUSE10_DIFFUSION_OUTSIDE = [(10, "-0.173167", "-0.170758"),
                             (10, "0.00768377", "0.00892661"),
                             (10, "1.09097", "1.08816"),
                             (11, "0.0023077", "0.00230667")]
# K1's disagreements with its twin at facade view 0 against its first
# neighbour (N=1) and all ten (N=10) before K1 was redesigned to
# triangulate only the survivors of its cheap gates: the redesign keeps
# each pair's arithmetic, so the counts must not move
K1_TWIN_DISAGREE = {1: 1, 10: 8}
# f32 operations, counted from the kernel sources (each add, multiply,
# compare, divide, square root, exp or acos counts one): K4's gate per
# pair and its regate per candidate within the quota; the scoring kernel
# per staged slot, per spatial-gate test and per pair that passes the
# spatial gate
K4_OPS, K4_REGATE_OPS = 63, 21
SCORE_SLOT_OPS, SCORE_GATE_OPS, SCORE_PAIR_OPS = 48, 8, 73
# The pair kernels' (K1, K5) f32 operations, counted from
# csrc/pair_math.cuh as the function needs them (see pair_ops): each add,
# subtract, multiply, compare, min/max, reciprocal and square root counts
# one (abs, negation, selects and logic none), and a value counts once
# where the source computes it again or its negation ((c-a)^2 of (a-c)^2),
# and once per segment or per neighbor where it depends on nothing else.
# Per pair: the cheap gates, 4 intersections (13 each), 2 overlap ratios
# (51 each) and the overlap gate (8); the triangulation, 4 ray
# normalizations (23 each) and 4 two-ray terms (22 each: the three dot
# products that mix the pair, the denominator, the numerator, its test);
# K1's sign tests of its survivors (4 products, 4 compares), K5's depths
# (4 reciprocals, 4 products, 4 compares).  Per segment, each source once
# and each neighbor's target once: its line (5), its two normalized rays
# (46), its mask test (1), its overlap length and its two tests (7); per
# segment and neighbor, its two epipolar lines (24).  The segments' terms
# of the two-ray depths, which K5 needs for every pair: a source's a (10),
# its d against each neighbor (10), a target's c and e (20).  Per
# neighbor: lo^2, hi^2 and w0 (5).
PAIR_CHEAP_OPS, PAIR_TRI_OPS, K1_SIGN_OPS, K5_DEPTH_OPS = 162, 180, 8, 12
SEG_OPS, SEG_NB_OPS, NB_OPS = 59, 24, 5
K5_SRC_OPS, K5_SRC_NB_OPS, K5_TGT_OPS = 10, 10, 20
# the card's float32 rate outside the tensor cores and its memory rate
# (NVIDIA H100 SXM data sheet), the denominators of every bound.  67e12
# counts a fused multiply-add as two operations; the kernels are built with
# -fmad=false and issue one add or multiply per instruction (a divide, root,
# exp or acos many), so an operations bound is a floor about 2x below what
# they can reach.
PEAK_F32, PEAK_BYTES = 67e12, 3.35e12
# the host link's rate in one direction (PCIe 5.0 x16: 32 GT/s a lane,
# 128b/130b), the denominator of the affinity enumeration's copies
PEAK_LINK = 63e9
# the affinity enumeration's kernel launches in one model whose stream is
# not empty (`affinity_cuda.LAUNCHES`: prep, pass 1, pass 2 counting and
# writing)
AFFINITY_ENUM_LAUNCHES = 4
# ... and of its weight filter, counted in the same `LAUNCHES`
# (`l3d_affinity_filter`, `l3d_affinity_compact`)
AFFINITY_FILTER_LAUNCHES = 2
# the filter's float64 operations a candidate (csrc/affinity_filter.cu: the
# four endpoint distances 16 each, each side's uncertainties and Gaussians
# 20, the angle 11, the weight and its cut 5; a sqrt, divide, exp or acos
# counted once, so a floor) and the card's float64 rate outside the
# tensor cores (NVIDIA H100 SXM data sheet)
FILTER_F64_OPS, PEAK_F64 = 120, 34e12
# K4's weights against its twin: the same operations in the same order,
# so equal bits are expected; any weight that differs is counted and must
# stay within this
K4_W_ATOL = 1e-6
# K5 depths against the twin on pairs valid in both (tpu_validate.py)
DEPTH_RTOL, DEPTH_ATOL = 1e-3, 1e-4
# device diffusion against the float64 host (tests/test_cluster.py)
DIFF_RTOL, DIFF_ATOL = 2e-4, 1e-7


def log(msg: str):
    print(msg, flush=True)


def require(cond: bool, msg: str):
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


@contextlib.contextmanager
def spy(module, name, calls):
    """Record (args, kwargs, result) of every call of module.name."""
    orig = getattr(module, name)

    def wrapped(*a, **k):
        out = orig(*a, **k)
        calls.append((a, k, out))
        return out
    setattr(module, name, wrapped)
    try:
        yield calls
    finally:
        setattr(module, name, orig)


def feed(l3d, scene, cams):
    """add_view_segments for every view of a (Scene, CameraSet)."""
    for v in range(scene.num_views):
        l3d.add_view_segments(
            v, scene.segments[v][scene.seg_mask[v]], cams.K[v], cams.R[v],
            cams.t[v], worldpoint_ids=scene.wp_lists[v],
            width=int(cams.width[v]), height=int(cams.height[v]))
    return l3d


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds per call on the card (CUDA events, after one
    warm-up call)."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def bound_ms(ops: float, nbytes: float):
    """(least milliseconds, what binds it): the larger of the operations
    over the float32 rate and the bytes over the memory rate."""
    t_ops, t_bytes = ops / PEAK_F32 * 1e3, nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def pair_ops(Ss: int, St: int, N: int, survivors=None) -> int:
    """f32 operations that one view's Ss sources against N neighbors of St
    targets need: K1's valid plane when `survivors` (its cheap-gate
    survivors, each triangulated) is given, else K5's, every pair
    triangulated.  K1's count leaves out the segments' two-ray terms of
    its survivors' segments (20 a segment at most, under 1e-4 of it)."""
    pairs = N * Ss * St
    ops = (pairs * PAIR_CHEAP_OPS + (Ss + N * St) * SEG_OPS
           + N * (Ss + St) * SEG_NB_OPS + N * NB_OPS)
    if survivors is not None:
        return ops + survivors * (PAIR_TRI_OPS + K1_SIGN_OPS)
    return (ops + pairs * (PAIR_TRI_OPS + K5_DEPTH_OPS) + Ss * K5_SRC_OPS
            + N * Ss * K5_SRC_NB_OPS + N * St * K5_TGT_OPS)


def score_gate_counts(cam, depths, valid, N, spatial_k, rows=32):
    """(sum over rows of need^2, the (m, m2) pairs passing the scoring
    kernel's spatial gate with both slots valid, m2 in a camera and
    m2 != m): the pair tests of a dense walk and of the windowed one."""
    import torch
    from line3d_tpu_torch.match import scoring as sc
    need = sc.row_need(valid).long()
    dense = int((need * need).sum())
    sup = valid & (cam >= 0) & (cam < N)
    n_pass = 0
    for r0 in range(0, cam.shape[0], rows):
        d1 = depths[r0:r0 + rows, :, 0]
        d2 = depths[r0:r0 + rows, :, 1]
        ok = ((d1[:, :, None] - d1[:, None, :]).abs()
              <= spatial_k * d1[:, :, None]) & \
            ((d2[:, :, None] - d2[:, None, :]).abs()
             <= spatial_k * d2[:, :, None])
        ok &= valid[r0:r0 + rows, :, None] & sup[r0:r0 + rows, None, :]
        ok &= ~torch.eye(cam.shape[1], dtype=torch.bool,
                         device=cam.device)[None]
        n_pass += int(ok.sum())
    return dense, n_pass


def facade_inputs(device):
    """The facade scene with its tensors on `device`, conditioned cameras
    and visual neighbors — the state the pipeline matches on."""
    from line3d_tpu_torch import L3DConfig
    from line3d_tpu_torch.core.conditioning import compute_conditioning
    from line3d_tpu_torch.scene import view_similarities_from_worldpoints, \
        find_visual_neighbors
    from line3d_tpu_torch.utils.demo import make_facade_scene
    cfg = L3DConfig()
    scene, cams = make_facade_scene(num_views=25, config=cfg, device=device)
    sim, _ = view_similarities_from_worldpoints(scene.wp_lists,
                                                scene.num_views)
    nbrs = find_visual_neighbors(sim, cams.baselines(), cfg.min_baseline,
                                 cfg.matching_neighbors, cfg.eps)
    tr = compute_conditioning(cams.C)
    cams.transform(tr.Qinv, tr.scale)
    return cfg, scene, cams, nbrs


def pair_cases(dev) -> dict:
    """{name: the K1/K5 arguments} on `dev`: the house pair at S = 384
    (scripts/tpu_validate.py's case: house views 1 and 3); facade view 0
    against its 10 neighbors (1280 x 1280 pairs each) and against its
    first; house view 1 against 4 neighbors padded to Ss = 200, St = 328,
    and the same with 8 segments a view 1e19 and 1e21 times farther out,
    where K5 meets operands beyond its fast reciprocals' domain."""
    import torch
    from line3d_tpu_torch.match import engine
    from line3d_tpu_torch.utils.synthetic import make_scene

    def f32(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=dev)

    def b(x):
        return torch.as_tensor(np.asarray(x, bool), device=dev)

    syn = make_scene(num_views=6, device=dev)
    cams, sc = syn.cameras, syn.scene
    out = {}
    S = 384
    segs = np.zeros((2, S, 4), np.float32)
    mask = np.zeros((2, S), bool)
    ns = min(S, sc.segments.shape[1])
    segs[0, :ns], segs[1, :ns] = sc.segments[1][:ns], sc.segments[3][:ns]
    mask[0, :ns], mask[1, :ns] = sc.seg_mask[1][:ns], sc.seg_mask[3][:ns]
    out["house S=384"] = (
        f32(segs[0]), b(mask[0]), f32(segs[1:2]), b(mask[1:2]),
        f32(cams.fundamental(1, 3)[None]), f32(cams.RtKinv[1]),
        f32(cams.RtKinv[3][None]), f32(cams.C[1]), f32(cams.C[3][None]))
    cfg, scene, fcams, nbrs = facade_inputs(dev)
    ctx = engine.ViewContext(scene, fcams, cfg)
    for key, nb in (("facade view 0 N=10", nbrs[0]),
                    ("facade view 0 N=1", nbrs[0][:1])):
        segs_nb, mask_nb, F_nb, RtKinv_nb, C_nb, _ = ctx.neighbor_arrays(
            0, np.asarray(nb, np.int64))
        out[key] = (scene.segments_t[0], scene.seg_mask_t[0], segs_nb,
                    mask_nb, F_nb, ctx.RtKinv32[0], RtKinv_nb, ctx.C32[0],
                    C_nb)
    nb = np.array([2, 3, 5, 0])
    F = cams.fundamentals_for_pairs(np.stack([np.full(4, 1), nb], 1))
    src, msrc = np.zeros((200, 4), np.float32), np.zeros(200, bool)
    tgt, mtgt = np.zeros((4, 328, 4), np.float32), np.zeros((4, 328), bool)
    n1 = sc.segments.shape[1]
    src[:n1], msrc[:n1] = sc.segments[1], sc.seg_mask[1]
    tgt[:, :n1], mtgt[:, :n1] = sc.segments[nb], sc.seg_mask[nb]
    for key in ("house ragged 200x328", "house ragged, far segments"):
        if key.endswith("far segments"):
            far = np.repeat([1e19, 1e21], 4)[:, None]
            src[:8] *= far
            tgt[:, :8] *= far
        out[key] = (f32(src), b(msrc), f32(tgt), b(mtgt), f32(F),
                    f32(cams.RtKinv[1]), f32(cams.RtKinv[nb]),
                    f32(cams.C[1]), f32(cams.C[nb]))
    return out


def phase_device():
    import torch
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    log(f"[device] {name}; torch {torch.__version__} cuda "
        f"{torch.version.cuda}; nvidia-smi: {smi}")
    return name, smi


def phase_build():
    from line3d_tpu_torch.native import cuda, load
    t_cuda = cuda.build(force=True)
    t_host = load.build(force=True)
    with open(cuda.LOG_PATH) as f:
        ptxas = [ln.strip() for ln in f if "registers" in ln
                 or "Compiling entry" in ln or "spill" in ln]
    log(f"[build] nvcc {t_cuda:.2f} s (sm_90a, -fmad=false), "
        f"g++ host library {t_host:.2f} s")
    for ln in ptxas:
        log(f"[build]   {ln}")


def phase_kernels():
    import torch
    from line3d_tpu_torch.match import engine, pairwise, \
        pairwise_cuda as k1, scoring as sc, scoring_cuda as k23
    dev = torch.device("cuda")
    cfg, scene, cams, nbrs = facade_inputs(dev)
    ctx = engine.ViewContext(scene, cams, cfg)
    v, nb = 0, np.asarray(nbrs[0], np.int64)
    segs_nb, mask_nb, F_nb, RtKinv_nb, C_nb, P_nb = ctx.neighbor_arrays(v, nb)
    segs0, mask0 = scene.segments_t[v], scene.seg_mask_t[v]
    S, N = scene.max_segments, len(nb)
    out = {}

    # K1: one neighbor pair, and the main path's N-neighbor launch
    def k1_args(n):
        return (segs0, mask0, segs_nb[:n].contiguous(),
                mask_nb[:n].contiguous(), F_nb[:n].contiguous(),
                ctx.RtKinv32[v], RtKinv_nb[:n].contiguous(), ctx.C32[v],
                C_nb[:n].contiguous(), cfg.min_overlap_lower,
                cfg.min_overlap_upper)
    for n in (1, N):
        a = k1_args(n)
        stats = torch.zeros(2, dtype=torch.int64, device=dev)
        got = k1.pair_valid_cuda(*a, stats=stats)
        want = k1.pair_valid_plain(*a)
        torch.cuda.synchronize()
        bad, n_valid = int((got != want).sum()), int(want.sum())
        n_surv, n_warps = int(stats[0]), int(stats[1])
        log(f"[kernels] K1 pair_valid S={S} St={S} N={n}: {n_valid} valid "
            f"pairs of {got.numel()}, {bad} disagree with the twin (bound "
            f"{PAIR_DISAGREE_MAX:g} of the valid pairs; before the redesign "
            f"{K1_TWIN_DISAGREE[n]}); cheap-gate survivors {n_surv} "
            f"({n_surv / got.numel():.4f} of the pairs), warps holding any "
            f"{n_warps} of {got.numel() // 32}")
        require(bad <= PAIR_DISAGREE_MAX * n_valid,
                "K1 disagrees with its plain twin")
        require(bad == K1_TWIN_DISAGREE[n],
                "K1's disagreements with its twin moved")
        require(n_valid <= n_surv, "K1 has fewer survivors than valid pairs")
    ms = cuda_ms(lambda: k1.pair_valid_cuda(*a), 20)
    plain_ms = cuda_ms(lambda: k1.pair_valid_plain(*a), 3)
    ops = pair_ops(got.shape[1], got.shape[2], got.shape[0],
                   survivors=n_surv)
    nbytes = sum(x.numel() * x.element_size() for x in a[:9]) + got.numel()
    b_ms, b_by = bound_ms(ops, nbytes)
    log(f"[kernels] K1 N={N}: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms; "
        f"bound {b_ms:.4f} ms by {b_by} ({ops:.3e} ops, {nbytes} bytes)")
    out["pair_valid"] = dict(max_abs_err=float(bad > 0), disagree=bad,
                             ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                             bound_by=b_by, survivors=n_surv,
                             warps_with_survivor=n_warps)

    # K4: every facade view's pair lists in one call, then the edge cases
    out["collin_pairs"] = phase_k4(scene)

    # scoring: view 0's exact match table, cut or padded to M slots
    o = engine.match_view(ctx, v, nb)
    log(f"[kernels] view 0 exact capacity: need {o['need']}, m_total "
        f"{o['m_total']}")
    spk = float(np.float32(ctx.spatial_ks[v]))
    out["score"] = {}
    for M in (256, 1024):
        def cut(x, fill):
            if x.shape[1] >= M:
                return x[:, :M].contiguous()
            pad = torch.full((S, M - x.shape[1]) + x.shape[2:], fill,
                             dtype=x.dtype, device=dev)
            return torch.cat([x, pad], dim=1)
        cam, tgt = cut(o["cam"], -1), cut(o["tgt"], -1)
        depths, valid = cut(o["depths"], 0), cut(o["valid"], False)
        tcoords = pairwise.gather_target_coords(segs_nb, cam, tgt)
        a = (segs0, ctx.RtKinv32[v], ctx.C32[v], cam, tgt, depths, valid,
             P_nb, segs_nb, float(np.float32(cfg.sigma_p)),
             float(np.float32(cfg.sigma_a)), spk, cfg.support_threshold)
        got = k23.score_cuda(*a, tcoords=tcoords)
        want = k23.score_plain(*a, tcoords=tcoords)
        err = (got - want).abs()
        outside = err > SCORE_ATOL + SCORE_RTOL * want.abs()
        n_bad, n_scored = int(outside.sum()), int((want > 0).sum())
        need = sc.row_need(valid)
        dense, n_pass = score_gate_counts(cam, depths, valid, N, spk)
        n_valid = int(valid.sum())
        log(f"[kernels] score M={M}: {n_valid} valid slots, need max "
            f"{int(need.max())} (rows with need % 256 != 0: "
            f"{int(((need % 256) != 0).sum())}), {n_scored} scored, max "
            f"abs err {float(err.max()):.3e}, {n_bad} outside rtol "
            f"{SCORE_RTOL} / atol {SCORE_ATOL}; sum need^2 {dense} pair "
            f"tests, {n_pass} pass the spatial gate "
            f"({n_pass / max(dense, 1):.5f})")
        for s_, m_ in outside.nonzero().tolist()[:10]:
            log(f"[kernels]   slot ({s_}, {m_}): kernel "
                f"{float(got[s_, m_]):.6f}, plain {float(want[s_, m_]):.6f}")
        # a support whose confidence sits at support_t can flip between
        # the kernel's affine-in-depth projection and the plain twin's
        # projection of 3D points, which round differently; such a flip
        # moves one slot by about support_t and, like K1's borderline
        # gates, must stay rare
        require(n_bad <= SCORE_FLIP_MAX * max(n_scored, 1),
                f"scoring kernel disagrees at M={M}")
        # the kernel's time includes all of its staging: it reads the
        # table as the engine holds it (the engine gathers tcoords once
        # for the depth recompute and the scoring)
        ms = cuda_ms(lambda: k23.score_cuda(*a, tcoords=tcoords), 10)
        plain_ms = cuda_ms(lambda: k23.score_plain(*a, tcoords=tcoords), 2)
        # history: the host-side staging of the Pallas layout (the [S, 16,
        # M] planes and the per-row tables) that the kernel took before it
        # read the table itself
        old_prep_ms = cuda_ms(lambda: (
            sc.slot_terms(segs0, ctx.RtKinv32[v], cam, depths, valid,
                          tcoords),
            sc.kernel_inputs(segs0, ctx.RtKinv32[v], ctx.C32[v], valid,
                             P_nb, *a[9:])), 10)
        nbytes = S * M * (1 + 4) + n_valid * (4 + 8 + 16)
        ops = (n_valid * SCORE_SLOT_OPS + n_pass * SCORE_PAIR_OPS
               + n_pass * SCORE_GATE_OPS)
        b_ms, b_by = bound_ms(ops, nbytes)
        log(f"[kernels] score M={M}: kernel {ms:.3f} ms with its staging, "
            f"plain {plain_ms:.3f} ms; bound {b_ms:.4f} ms by {b_by}; "
            f"history: the Pallas-layout host prep {old_prep_ms:.3f} ms")
        out["score"][M] = dict(max_abs_err=float(err.max()), outside=n_bad,
                               ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                               bound_by=b_by, old_prep_ms=old_prep_ms,
                               pair_tests_dense=dense, gate_pass=n_pass)

    out["affinity_enum"], out["affinity_filter"] = _kernel_affinity()
    return out


# the configuration file of the benchmark's P25 facade, whose capture
# phase `kernels` holds the affinity enumeration and filter on (19.6 M
# candidates a model)
P25_FACADE = "benchmark/configs/facade_p25.json"


def _kernel_affinity(reps: int = 3):
    """The affinity enumeration (csrc/affinity_enum.cu) on the inputs of
    one counted exact model of the benchmark's P25 facade capture
    (P25_FACADE: 25 views of 3072 x 2048, 3,000 segments a view) on the
    card: its stream
    held to the native walk's and its filter's kept candidates to the
    twin and the native sweep (_hold_enum), the card call (the inputs'
    upload, four launches, the two readbacks, the stream's whole) timed
    by host clock over `reps` calls, and its bound: the larger of its
    least device bytes (the inputs read once, the stream written once)
    over the memory rate and its bytes over the host link (the inputs up,
    the stream down) over the link's rate.  No floating-point operation is
    counted: a weight is copied, and every other step is an integer
    lookup.  Then the filter on that stream (_kernel_affinity_filter).
    Returns the two records."""
    from benchmark.scenes import make_capture
    from line3d_tpu_torch import Line3D, L3DConfig
    from line3d_tpu_torch.cluster import affinity, affinity_cuda as ka
    here = os.path.dirname(os.path.abspath(__file__))
    with open(os.path.join(here, P25_FACADE)) as f:
        spec = json.load(f)
    cap = make_capture(spec["scene"])

    def model():
        l3d = Line3D(config=L3DConfig(**spec["l3d"]), device="cuda")
        for v in range(cap.num_views):
            l3d.add_view_segments(v, cap.segments[v], cap.K[v], cap.R[v],
                                  cap.t[v], worldpoint_ids=cap.wp_lists[v],
                                  width=int(cap.width[v]),
                                  height=int(cap.height[v]))
        l3d.compute_3d_model()
    _counted(model, "kernels")
    call = _ENUM_CALLS.pop("kernels")
    held = _hold_enum(call, "kernels")
    a = call["enum"][0]
    t0 = time.perf_counter()
    for _ in range(reps):
        ka.read_stream(affinity.enumerate_candidates(*a))
    ms = (time.perf_counter() - t0) / reps * 1e3
    n = held["candidates"]
    inputs = sum(np.asarray(x).nbytes for x in a[:7])
    stream = ka.CANDIDATE_BYTES * n
    t_mem = (inputs + stream) / PEAK_BYTES * 1e3
    t_link = (inputs + stream + 8) / PEAK_LINK * 1e3
    b_ms, b_by = (t_link, "host link") if t_link >= t_mem else \
        (t_mem, "bytes")
    log(f"[kernels] affinity enumeration on the facade's inputs: {n} "
        f"candidates; card call {ms:.3f} ms (host clock, mean of {reps}, "
        f"upload and readbacks included), native walk "
        f"{held['native_s'] * 1e3:.3f} ms; bound {b_ms:.4f} ms by {b_by} "
        f"({inputs} input bytes, {stream} stream bytes; device "
        f"{t_mem:.4f} ms, host link {t_link:.4f} ms)")
    enum = dict(max_abs_err=0.0, ms=ms, plain_ms=held["native_s"] * 1e3,
                bound_ms=b_ms, bound_by=b_by, bound_device_ms=t_mem,
                candidates=n, input_bytes=inputs, stream_bytes=stream)
    return enum, _kernel_affinity_filter(call, held)


def _kernel_affinity_filter(call, held, reps: int = 20):
    """The weight filter (csrc/affinity_filter.cu) on the stream the
    counted facade model left on the card: its launch timed by CUDA events
    over `reps`, its whole call (the rows' upload, the filter, the prefix
    sum, the compaction, the two readbacks) and its numpy twin by host
    clock, and its bound: the larger of its least device bytes (the stream
    and the rows read once, one flag a candidate written) over the memory
    rate and FILTER_F64_OPS a candidate over the float64 rate."""
    from line3d_tpu_torch.cluster import affinity_cuda as ka
    stream = call["enum"][2]
    _, best, cams, cfg = call["kept"][0]
    n = stream.n
    rows = ka.upload_rows(best, cams, stream.buf.device)
    ms = cuda_ms(lambda: ka.filter_flags(stream, rows, cfg), reps)
    t0 = time.perf_counter()
    kept = ka.kept_candidates(stream, best, cams, cfg)
    call_ms = (time.perf_counter() - t0) * 1e3
    host = ka.read_stream(stream)
    t0 = time.perf_counter()
    ka.filter_plain(*host, best, cams, cfg)
    plain_ms = (time.perf_counter() - t0) * 1e3
    rows_bytes = sum(t.numel() * t.element_size() for t in rows)
    nbytes = ka.CANDIDATE_BYTES * n + rows_bytes + n
    t_bytes = nbytes / PEAK_BYTES * 1e3
    t_ops = FILTER_F64_OPS * n / PEAK_F64 * 1e3
    b_ms, b_by = (t_bytes, "bytes") if t_bytes >= t_ops else \
        (t_ops, "float64 operations")
    m = len(kept[0])
    require(m == held["kept"], "kernels: the filter kept "
            f"{m} candidates on a second call, {held['kept']} in the model")
    log(f"[kernels] affinity filter on the facade's stream: {n} "
        f"candidates, {m} kept ({m / n:.4f}); kernel {ms:.4f} ms (CUDA "
        f"events, mean of {reps}), the whole call {call_ms:.3f} ms (host "
        f"clock), numpy twin {plain_ms:.1f} ms; bound {b_ms:.4f} ms by "
        f"{b_by} ({nbytes} bytes, {rows_bytes} of them rows: "
        f"{t_bytes:.4f} ms; {FILTER_F64_OPS * n} float64 operations: "
        f"{t_ops:.4f} ms)")
    return dict(max_abs_err=0.0, ms=ms, call_ms=call_ms, plain_ms=plain_ms,
                bound_ms=b_ms, bound_by=b_by, candidates=n, kept=m,
                kept_share=m / n, passed=held["passed"], bytes=nbytes,
                f64_ops=FILTER_F64_OPS * n)


def collin_chain(n=512):
    """One chain of n collinear, non-overlapping segments (integer
    endpoints, every other one 1 px higher): each row fills its quota in
    every 128-partner block, n * 32 survivors against a cap of 8,192."""
    t = np.arange(n) * 6 + 10
    up = np.arange(n) % 2
    return (np.stack([t, t + up, t + 4, t + 4 + up], 1)[None]
            .astype(np.float32), np.ones((1, n), bool))


def collin_random(seed, V, S, n_chains):
    """V views of S random segments in 1920 x 1440, the first 8 * n_chains
    in chains of 8 nearly collinear pieces (tests/test_torch_kernels_cuda.py
    makes the same kind of input)."""
    rng = np.random.default_rng(seed)
    ext = np.array([1920.0, 1440.0])
    segs = np.empty((V, S, 4), np.float32)
    for v in range(V):
        segs[v] = rng.uniform(0, 1, (S, 4)) * np.tile(ext, 2)
        for c in range(n_chains):
            o = rng.uniform(0, 1, 2) * ext
            th = rng.uniform(0, np.pi)
            d = np.array([np.cos(th), np.sin(th)])
            t = np.cumsum(rng.uniform(15, 40, 16))
            for k in range(8):
                segs[v, c * 8 + k] = np.concatenate(
                    [o + t[2 * k] * d, o + t[2 * k + 1] * d]) + \
                    rng.normal(0, 0.3, 4)
    return segs, np.ones((V, S), bool)


def phase_k4(scene):
    """K4 against its plain twin on the card: all 25 facade views at the
    main path's quota (8), at quota 1 (drops, then the exact re-run of
    `collinearity_maps_fast`, whose maps must equal the quota-8 maps bit
    for bit) and with no quota at a capacity of the largest count (the
    re-run's call), the 512-segment chain (the cap bites), S = 100 with a
    fully masked view, and two views at the P25 stress scene's S = 2,990.
    Keys, counts and dropped_per_view must be identical; weights are
    compared bit for bit, and any that differ must be within K4_W_ATOL.
    Then the times and the bound at the main path's call."""
    import torch
    from line3d_tpu_torch.match import collinearity as col, \
        collinearity_cuda as k4
    dev = torch.device("cuda")
    sig2 = np.float32(2.0 ** 2)
    t = lambda x: torch.as_tensor(x, device=dev)  # noqa: E731
    chain = collin_chain()
    s100, m100 = collin_random(100, 3, 100, 6)
    m100[1] = False
    m100[0, ::7] = False
    blk = k4.block_quota(scene.max_segments, 8)[0]
    cap = int(col.collinearity_compact_all(scene.segments_t,
                                           scene.seg_mask_t, sig2)[2].max())
    cases = [("facade", scene.segments_t, scene.seg_mask_t, 8, None),
             ("facade quota 1", scene.segments_t, scene.seg_mask_t, 1, None),
             ("facade exact capacity", scene.segments_t, scene.seg_mask_t,
              blk, cap),
             ("chain 512", t(chain[0]), t(chain[1]), 8, None),
             ("S=100, view 1 masked", t(s100), t(m100), 8, None),
             ("S=2990", *map(t, collin_random(2990, 2, 2990, 40)), 8, None)]
    res, n_differ, max_diff = {}, 0, 0.0
    for name, segs, masks, quota, capacity in cases:
        got = col.collinearity_compact_all(segs, masks, sig2, quota=quota,
                                           capacity=capacity)
        want = col.collinearity_compact_all_plain(segs, masks, sig2,
                                                  quota=quota,
                                                  capacity=capacity)
        g = [x.cpu().numpy() for x in got]
        w = [x.cpu().numpy() for x in want]
        S = segs.shape[1]
        mg = col.collinearity_finalize(*g, max_segments=S)
        mw = col.collinearity_finalize(*w, max_segments=S)
        differ = g[1] != w[1]
        diff = float(np.abs(g[1] - w[1]).max()) if g[1].size else 0.0
        n_differ += int(differ.sum())
        max_diff = max(max_diff, diff)
        log(f"[kernels] K4 {name}: {segs.shape[0]} views x S={S}, C="
            f"{g[0].shape[1]}, {int((g[0] >= 0).sum())} pairs, candidates "
            f"{int(g[2].sum())}, dropped {mg.dropped_total}; keys equal "
            f"{np.array_equal(g[0], w[0])}, counts equal "
            f"{np.array_equal(g[2], w[2])}, {int(differ.sum())} weights "
            f"differ (max {diff:.3e})")
        require(np.array_equal(g[0], w[0]) and np.array_equal(g[2], w[2]),
                f"K4 {name}: pairs or counts differ from the twin")
        require(np.array_equal(mg.dropped_per_view, mw.dropped_per_view),
                f"K4 {name}: dropped_per_view differs from the twin")
        require(diff <= K4_W_ATOL, f"K4 {name}: weights differ")
        if name == "facade quota 1":
            require(mg.dropped_total > 0, "K4 quota 1 dropped nothing")
            exact = col.collinearity_maps_fast(segs, masks, 2.0, quota=1)
            main = col.collinearity_maps_fast(segs, masks, 2.0)
            same = all(np.array_equal(getattr(exact, f), getattr(main, f))
                       for f in ("flat_view", "flat_i", "flat_j", "flat_w"))
            log(f"[kernels] K4 quota 1: {len(exact.views_exact)} views "
                f"re-run at exact capacity ({len(main.views_exact)} at "
                f"quota 8); the maps equal quota 8's bit for bit {same}")
            require(np.array_equal(exact.views_exact,
                                   np.flatnonzero(mg.dropped_per_view))
                    and same, "K4 quota 1: the exact re-run's maps differ "
                    "from quota 8's")
        if name == "facade exact capacity":
            require(bool((g[2] <= cap).all()),
                    "K4: a view's candidates outnumber the capacity")
        if name == "chain 512":
            require(bool((g[0] >= 0).all()) and g[0].shape[1] == 8192,
                    "K4: the cap did not bite on the chain")
        if name.startswith("S=100"):
            require(g[2][1] == 0 and bool((g[0][1] == -1).all()),
                    "K4: the masked view has pairs")
        res[name] = dict(pairs=int((g[0] >= 0).sum()), count=int(g[2].sum()),
                         weights_differ=int(differ.sum()), max_abs_err=diff)

    res["sigma 3"] = _k4_sigma3(scene)
    n_differ += res["sigma 3"]["weights_differ"]
    max_diff = max(max_diff, res["sigma 3"]["max_abs_err"])

    segs, masks = scene.segments_t, scene.seg_mask_t
    V, S = masks.shape
    run = lambda: col.collinearity_compact_all(segs, masks, sig2)  # noqa
    ms = cuda_ms(run, 20)
    plain_ms = cuda_ms(lambda: col.collinearity_compact_all_plain(
        segs, masks, sig2), 5)
    # history: the replaced path as the host paid for it, the per-view
    # loop (here with its keep plane in PyTorch: the old per-view K4
    # kernel is gone) through the readback, by host clock
    reps, t0 = 5, time.perf_counter()
    for _ in range(reps):
        [x.cpu() for x in col.collinearity_compact_all_plain(segs, masks,
                                                             sig2)]
    history_ms = (time.perf_counter() - t0) / reps * 1e3
    # the work this input needs: the gate for every ordered pair of valid
    # segments, the regate for each block's first 8 candidates
    n = masks.sum(dim=1).double()
    gate_pairs = int((n * (n - 1)).sum())
    thr = k4.keep_threshold_sq(sig2)
    blk, q = k4.block_quota(S, 8)
    regated = sum(int(k4.collin_keep_plain(segs[v], masks[v], thr)
                      .view(S, S // blk, blk).sum(dim=2).clamp(max=q).sum())
                  for v in range(V))
    C = run()[0].shape[1]
    ops = gate_pairs * K4_OPS + regated * K4_REGATE_OPS
    nbytes = V * S * 17 + V * C * 8 + V * 8
    b_ms, b_by = bound_ms(ops, nbytes)
    log(f"[kernels] K4 facade: kernel {ms:.4f} ms for all {V} views, plain "
        f"{plain_ms:.3f} ms, history {history_ms:.3f} ms (host clock); "
        f"bound {b_ms:.4f} ms by {b_by} ({gate_pairs} gate pairs, "
        f"{regated} regated, {ops:.3e} ops, {nbytes} bytes), "
        f"{b_ms / ms:.3f} of it")
    return dict(max_abs_err=max_diff, weights_differ=n_differ, ms=ms,
                plain_ms=plain_ms, history_ms=history_ms, bound_ms=b_ms,
                bound_by=b_by, share_of_bound=b_ms / ms, cases=res)


def _k4_sigma3(scene):
    """K4 against its twin at collinearity_sigma = 3 (2 sigma^2 = 18, no
    power of two) on facade views 0 and 12.  The kernel divides -d^2 by
    2 sigma^2, and so does the twin, by a tensor.  As history, the twin is
    also run dividing by a Python number, which PyTorch's CUDA backend
    turns into a multiply by the reciprocal: the weights that form parts
    from the kernel by are counted and logged, not required."""
    import torch
    from line3d_tpu_torch.match import collinearity as col
    idx = torch.tensor([0, 12], device=scene.segments_t.device)
    segs, masks = scene.segments_t[idx], scene.seg_mask_t[idx]
    sig2 = np.float32(3.0 ** 2)
    got = [x.cpu().numpy() for x in
           col.collinearity_compact_all(segs, masks, sig2)]
    want = [x.cpu().numpy() for x in
            col.collinearity_compact_all_plain(segs, masks, sig2)]
    tensor_form = col._two_sigma_sq
    try:
        col._two_sigma_sq = lambda s2, like: 2.0 * float(s2)
        old = [x.cpu().numpy() for x in
               col.collinearity_compact_all_plain(segs, masks, sig2)]
    finally:
        col._two_sigma_sq = tensor_form
    n_pairs = int((got[0] >= 0).sum())
    differ = int((got[1] != want[1]).sum())
    diff = float(np.abs(got[1] - want[1]).max())
    same_keys = np.array_equal(got[0], old[0])
    differ_old = int((got[1] != old[1]).sum()) if same_keys else -1
    log(f"[kernels] K4 sigma 3, views 0 and 12: {n_pairs} pairs, keys equal "
        f"{np.array_equal(got[0], want[0])}, counts equal "
        f"{np.array_equal(got[2], want[2])}, {differ} weights differ from "
        f"the twin (max {diff:.3e}); history: from the twin dividing by a "
        f"Python number {differ_old} differ (keys equal {same_keys})")
    require(np.array_equal(got[0], want[0]) and
            np.array_equal(got[2], want[2]),
            "K4 sigma 3: pairs or counts differ from the twin")
    require(n_pairs > 1000, "K4 sigma 3: too few pairs")
    require(diff <= K4_W_ATOL, "K4 sigma 3: weights differ")
    return dict(pairs=n_pairs, count=int(got[2].sum()),
                weights_differ=differ, max_abs_err=diff,
                weights_differ_scalar_divide=differ_old)


def phase_validate():
    """K5 through `pair_dense` (the validation path), then against its
    plain twin on the same inputs.

    Gates: at most PAIR_DISAGREE_MAX of the twin's valid pairs disagree,
    as for K1.  Depths: K5 and the twin are two float32 evaluations of the
    same triangulation (K5 multiplies by reciprocals as the Pallas kernel
    does, the twin divides as the XLA formulation does).  On near-parallel
    rays a·c − b² cancels and either can land far from the float64 value,
    so the two are held to the float64 evaluation of the twin: K5's count
    of shared valid pairs beyond rtol 1e-3 / atol 1e-4 of it may exceed the
    twin's own count by at most 10% + 10.  On the house pair (S=384,
    scripts/tpu_validate.py's case) the twin's check holds outright: every
    shared valid pair within rtol 1e-3 / atol 1e-4 of the twin.
    """
    import torch
    from line3d_tpu_torch.match import pairwise_cuda as k5
    from line3d_tpu_torch.native import cuda
    dev = torch.device("cuda")
    cases = pair_cases(dev)
    house, facade = cases["house S=384"], cases["facade view 0 N=10"]

    k5.LAUNCHES_DENSE = 0
    outs = [k5.pair_dense(*a) for a in (house, facade)]
    torch.cuda.synchronize()
    launches = k5.LAUNCHES_DENSE
    res = {}
    for name, a, (dg, vg), strict in (
            ("house S=384", house, outs[0], True),
            ("facade view 0 N=10", facade, outs[1], False)):
        dw, vw = k5.pair_dense_plain(*a)
        d64, _ = k5.pair_dense_plain(*[x.double() if x.is_floating_point()
                                       else x for x in a])
        n_valid = int(vw.sum())
        bad_gate = int((vg != vw).sum())
        both = vg & vw
        n_both = int(both.sum())
        g, w, r = dg[:, both], dw[:, both], d64[:, both].float()

        def beyond(x, ref):
            return ((x - ref).abs() > DEPTH_ATOL + DEPTH_RTOL * ref.abs()) \
                .any(dim=0)
        n_out = int(beyond(g, w).sum())
        k_off, t_off = int(beyond(g, r).sum()), int(beyond(w, r).sum())
        err = float((g - w).abs().max()) if n_both else 0.0
        far = w[:, beyond(g, w)].abs().amax(dim=0)
        log(f"[validate] K5 {name}: {n_valid} valid pairs of {vw.numel()}, "
            f"{bad_gate} gates disagree (bound {PAIR_DISAGREE_MAX:g} of the "
            f"valid pairs); {n_both} shared valid pairs, {n_out} with depths"
            f" beyond rtol {DEPTH_RTOL} / atol {DEPTH_ATOL} of the twin (max"
            f" diff {err:.3e}; their depths {_quantiles(far)}, all shared "
            f"{_quantiles(w.abs().amax(dim=0))}); beyond it of float64: K5 "
            f"{k_off}, twin {t_off}")
        require(bad_gate <= PAIR_DISAGREE_MAX * n_valid,
                f"K5 gates disagree with the twin ({name})")
        require(n_both > 20, f"K5: too few shared valid pairs ({name})")
        require(k_off <= 1.1 * t_off + 10,
                f"K5 depths less accurate than the twin's ({name})")
        require(n_out == 0 or not strict,
                f"K5 depths disagree with the twin ({name})")
        res[name] = dict(max_abs_err=err, gate_disagree=bad_gate,
                         depth_outside=n_out, k5_off_f64=k_off,
                         twin_off_f64=t_off)
    # K1 (cheap gates, then the survivors' triangulation, sign carrier
    # num * denom) against K5's valid plane (every pair triangulated, sign
    # from num * (1 / denom)) on the same facade inputs
    k1_plane = k5.pair_valid_cuda(*facade)
    vg = outs[1][1]
    differ = (k1_plane != vg).nonzero().tolist()
    log(f"[validate] K1 vs K5's valid plane, facade view 0 N=10: "
        f"{len(differ)} of {vg.numel()} pairs differ")
    for n_, s_, t_ in differ[:20]:
        log(f"[validate]   pair ({n_}, {s_}, {t_}): K1 "
            f"{bool(k1_plane[n_, s_, t_])}, K5 {bool(vg[n_, s_, t_])}, K5 "
            f"depths {outs[1][0][:, n_, s_, t_].tolist()}")
    require(not differ, "K1's plane differs from K5's valid plane")
    # K5's fast reciprocals and roots (csrc/pair_math.cuh FastRnOps)
    # against the IEEE operations on every float of their range
    counts = torch.zeros(4, dtype=torch.int64, device=dev)
    cuda.check(cuda.lib().l3d_rn_ops_check(counts.data_ptr(),
                                           cuda.stream_of(counts)),
               "l3d_rn_ops_check")
    n_rcp, bad_rcp, n_isq, bad_isq = counts.tolist()
    log(f"[validate] K5's fast 1/x on {n_rcp} floats: {bad_rcp} differ from "
        f"the IEEE operation; fast 1/sqrt(x) on {n_isq}: {bad_isq} differ")
    require(n_rcp == 2 * 252 * 2 ** 23 and n_isq == 226 * 2 ** 23 and
            bad_rcp == 0 and bad_isq == 0,
            "K5's fast reciprocals differ from the IEEE operations")
    ms = cuda_ms(lambda: k5.pair_dense_cuda(*facade), 10)
    plain_ms = cuda_ms(lambda: k5.pair_dense_plain(*facade), 2)
    N, Ss, St = vg.shape
    b_ms, b_by = bound_ms(pair_ops(Ss, St, N),
                          sum(x.numel() * x.element_size() for x in facade)
                          + vg.numel() * 17)
    log(f"[validate] K5 facade N=10: kernel {ms:.3f} ms, plain "
        f"{plain_ms:.3f} ms; bound {b_ms:.4f} ms by {b_by}; launches in "
        f"the validation path: {launches}")
    require(launches == 2, "K5 was not launched on the validation path")
    return dict(launches=launches,
                max_abs_err=max(r["max_abs_err"] for r in res.values()),
                ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                cases=res)


def _quantiles(x) -> str:
    """min / median / max of a tensor, for the log."""
    if x.numel() == 0:
        return "-"
    q = np.quantile(x.float().cpu().numpy(), [0.0, 0.5, 1.0])
    return "/".join(f"{v:.3g}" for v in q)


def phase_peak(smi):
    """K6: the marginal FMA rate, then the chain against its twin."""
    import torch
    from line3d_tpu_torch.utils import peak as k6
    k6.LAUNCHES = 0
    r = k6.measure_fp32_peak("cuda")
    launches = k6.LAUNCHES
    log(f"[peak] K6 float32 FMA rate {r['tflops']:.3f} TFLOP/s "
        f"({r['threads']} threads on {r['sms']} SMs; {r['ms_short']:.3f} ms"
        f" short, {r['ms_long']:.3f} ms long) on {smi}; published H100 "
        f"SXM5 peak {k6.H100_FP32_PEAK / 1e12:.0f}; launches {launches}")
    require(launches > 0, "K6 was not launched on the peak path")
    x = k6.chain_starts(r["threads"], device="cuda")
    trips = 4
    got, want = k6.fma_chain_cuda(x, trips), k6.fma_chain_plain(x, trips)
    rel = float(((got - want).abs() / want.abs()).max())
    err = float((got - want).abs().max())
    log(f"[peak] K6 vs twin, {k6.UNROLL * trips} steps x {k6.CHAINS} "
        f"chains x {r['threads']} threads: max rel diff {rel:.3e} (bound "
        f"{k6.CHAIN_RTOL:g})")
    require(rel <= k6.CHAIN_RTOL, "K6 disagrees with its twin")
    ms = cuda_ms(lambda: k6.fma_chain_cuda(x, trips), 20)
    plain_ms = cuda_ms(lambda: k6.fma_chain_plain(x, trips), 3)
    # one fused multiply-add is two operations
    b_ms, b_by = bound_ms(2 * x.numel() * k6.UNROLL * trips,
                          x.numel() * 4 + x.shape[0] * 4)
    log(f"[peak] K6 at {k6.UNROLL * trips} steps: kernel {ms:.3f} ms, "
        f"plain {plain_ms:.3f} ms; bound {b_ms:.4f} ms by {b_by}")
    torch.cuda.synchronize()
    return dict(launches=launches, max_abs_err=err, ms=ms,
                plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                tflops=r["tflops"])


def _hold_diffusion(calls, mode, where, host=True):
    """The recorded device diffusion run once more on the card, bit-equal;
    and, with `host`, against the float64 host on the same edge list:
    identical (i, j), weights within DIFF_RTOL / DIFF_ATOL."""
    from line3d_tpu_torch.cluster import diffusion as dh, \
        diffusion_device as dd
    host_fn, dev_fn = (dh.diffuse_reference, dd.diffuse_reference_device) \
        if mode == "reference" else (dh.diffuse_true, dd.diffuse_true_device)
    require(len(calls) == 1, f"{where}: device diffusion ran "
            f"{len(calls)} times")
    (ei, ej, ew, n, it, eps), kw, got = calls[0]
    require(kw["device"].type == "cuda", f"{where}: diffusion not on the "
            "card")
    again = dev_fn(ei, ej, ew, n, it, eps, **kw)
    require(np.array_equal(again[2], got[2]),
            f"{where}: device diffusion is not reproducible")
    if not host:
        log(f"[{where}] {mode} diffusion on the card: {len(ew)} entries, "
            f"{n} nodes; a second run on the card bit-equal")
        return
    t0 = time.perf_counter()
    want = host_fn(ei, ej, ew, n, it, eps)
    t_host = time.perf_counter() - t0
    err = np.abs(got[2] - want[2])
    rel = float((err / np.maximum(np.abs(want[2]), 1e-30)).max())
    deg = np.bincount(ei, minlength=n)
    log(f"[{where}] {mode} diffusion on the card vs float64 host "
        f"({t_host:.2f} s): {len(ew)} entries, {n} nodes, max degree "
        f"{int(deg.max())}, max abs diff {float(err.max()):.3e}, max rel "
        f"{rel:.3e}; a second run on the card bit-equal")
    require(np.array_equal(got[0], want[0]) and
            np.array_equal(got[1], want[1]), f"{where}: edge order differs")
    require(bool((err <= DIFF_ATOL + DIFF_RTOL * np.abs(want[2])).all()),
            f"{where}: device diffusion differs from the host")


def phase_house10d():
    import torch
    from line3d_tpu_torch import Line3D, L3DConfig
    from line3d_tpu_torch.cluster import diffusion_device as dd
    from line3d_tpu_torch.io.writers import compare_txt
    from line3d_tpu_torch.utils.synthetic import make_scene
    syn = make_scene(num_views=10, noise_px=0.8, seed=3)
    cfg = L3DConfig(use_collinearity=True, diffusion_backend="host")
    l3d = feed(Line3D(config=cfg, device="cuda"), syn.scene, syn.cameras)
    l3d.compute_3d_model(perform_diffusion=True)
    torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "house10_diffusion.txt")
        _txt_model(l3d, path)
        rep = compare_txt(path, os.path.join(GOLDEN_DIR,
                                             "house10_diffusion.txt"))
    log(f"[house10d] host diffusion: {l3d.stats['num_lines']} lines, vs "
        f"golden (rtol 1e-5, atol 1e-6): {rep['n_tokens']} tokens, "
        f"{rep['int_bad']} int mismatches, {len(rep['outside'])} floats "
        f"outside {rep['outside']}")
    require(rep["int_bad"] == 0, "house10 diffusion model differs from the "
            "golden")
    require(rep["outside"] == HOUSE10_DIFFUSION_OUTSIDE,
            "house10 diffusion floats differ from the golden beyond the "
            "known tokens")
    cfg = L3DConfig(use_collinearity=True, diffusion_backend="device")
    with spy(dd, "diffuse_reference_device", []) as calls:
        l3d = feed(Line3D(config=cfg, device="cuda"), syn.scene,
                   syn.cameras)
        l3d.compute_3d_model(perform_diffusion=True)
    _hold_diffusion(calls, "reference", "house10d")
    log(f"[house10d] device diffusion: {l3d.stats['num_lines']} lines")


def _launch_counts(zero=False):
    """Each kernel wrapper's launch count, after setting them all to 0
    when `zero`."""
    from line3d_tpu_torch.cluster import affinity_cuda as ka
    from line3d_tpu_torch.match import pairwise_cuda as k1, \
        collinearity_cuda as k4, scoring_cuda as k23
    from line3d_tpu_torch.utils import peak as k6
    if zero:
        k1.LAUNCHES = k1.LAUNCHES_DENSE = k4.LAUNCHES = k6.LAUNCHES = 0
        k23.LAUNCHES = k23.LAUNCHES_WIDE = ka.LAUNCHES = 0
    return dict(pair_valid=k1.LAUNCHES, collin_pairs=k4.LAUNCHES,
                score=k23.LAUNCHES, score_wide=k23.LAUNCHES_WIDE,
                pair_dense=k1.LAUNCHES_DENSE, fma_peak=k6.LAUNCHES,
                affinity_enum=ka.LAUNCHES)


# the last counted run's affinity enumeration and filter, by its tag:
# {"enum": (args, kwargs, the card's stream, host seconds of the call),
# "kept": the same of the filter, its kept candidates on the host}, held
# by _check_path_kernels
_ENUM_CALLS = {}


def _counted(run, tag, wide=True):
    """run() with the model path's kernel launch counts set to 0 just
    before; fails unless each kernel was launched (the scoring kernel at
    M > 256 when `wide`, at any M otherwise), K4 once for the first pass
    and once more if the collinearity re-ran views at exact capacity, and
    the affinity enumeration and its filter once, on the card, with their
    four launches and two.  Keeps their calls under `tag` for
    _check_path_kernels.  Returns (run's result, the counts just after)."""
    import torch
    from line3d_tpu_torch.cluster import affinity, affinity_cuda as ka
    from line3d_tpu_torch.match import collinearity
    enum, kept_fn = affinity.enumerate_candidates, ka.kept_candidates
    calls, kcalls = [], []

    def timer(fn, into):
        def timed(*a, **k):
            t0 = time.perf_counter()
            out = fn(*a, **k)
            into.append((a, k, out, time.perf_counter() - t0))
            return out
        return timed
    _ENUM_CALLS.clear()
    _launch_counts(zero=True)
    affinity.enumerate_candidates = timer(enum, calls)
    ka.kept_candidates = timer(kept_fn, kcalls)
    try:
        with spy(collinearity, "_rerun_exact", []) as reruns:
            out = run()
    finally:
        affinity.enumerate_candidates = enum
        ka.kept_candidates = kept_fn
    counts = _launch_counts()
    require(counts["pair_valid"] > 0 and counts["collin_pairs"] > 0
            and counts["score_wide" if wide else "score"] > 0,
            f"{tag}: a kernel of the path was not launched")
    require(len(reruns) <= 1 and counts["collin_pairs"] == 1 + len(reruns),
            f"{tag}: K4 ran {counts['collin_pairs']} times in one model "
            f"with {len(reruns)} exact re-runs")
    require(len(calls) == 1 and torch.device(calls[0][0][-1]).type == "cuda"
            and len(kcalls) == 1 and counts["affinity_enum"] ==
            AFFINITY_ENUM_LAUNCHES + AFFINITY_FILTER_LAUNCHES,
            f"{tag}: the affinity enumeration ran {len(calls)} times and "
            f"its filter {len(kcalls)}, {counts['affinity_enum']} launches, "
            "not once each on the card")
    _ENUM_CALLS[tag] = dict(enum=calls[0], kept=kcalls[0])
    n, m = calls[0][2].n, len(kcalls[0][2][0])
    log(f"[{tag}] launches in the run: {counts}; the affinity enumeration "
        f"on the card: {n} candidates in {calls[0][3]:.4f} s, the filter "
        f"kept {m} ({ka.CANDIDATE_BYTES * m} B read back) in "
        f"{kcalls[0][3]:.4f} s (host clock)")
    return out, counts


def _hold_enum(call, tag):
    """A recorded card enumeration (_ENUM_CALLS' entry) against the native
    walk (`device="cpu"`) on the same inputs, bit for bit, the walk timed
    by host clock; then its filter's kept candidates against the twin's
    on the walk's stream, bit for bit in order, and every candidate the
    native sweep passes among them.  Returns their figures."""
    from line3d_tpu_torch.cluster import affinity, affinity_cuda as ka
    a, _, stream, t_card = call["enum"]
    got = ka.read_stream(stream)
    t0 = time.perf_counter()
    want = affinity.enumerate_candidates(*a[:-1], device="cpu")
    t_native = time.perf_counter() - t0
    differ = [name for g, w, name in zip(got, want, ("src", "tgt", "kind",
                                                     "cw"))
              if g.dtype != w.dtype or g.shape != w.shape or
              not np.array_equal(g.view(np.uint8), w.view(np.uint8))]
    n = len(want[0])
    P, B = np.asarray(a[2]).size, np.asarray(a[0]).size
    log(f"[{tag}] affinity enumeration: the card's stream of {n} "
        f"candidates ({P} packed pairs, {B} sources) "
        f"against the native walk's: differs in {differ or 'nothing'}; "
        f"card call {t_card:.4f} s, walk {t_native:.4f} s (host clock)")
    require(not differ, f"{tag}: the card's candidate stream differs from "
            f"the native walk's in {differ}")
    (_, best, cams, cfg), _, kept, t_filter = call["kept"]
    keep = ka.filter_plain(*want, best, cams, cfg)
    t0 = time.perf_counter()
    passed = affinity._candidate_weights_range(
        best, *want, cams, cfg, 0, n,
        n_stream=max(n, affinity.NATIVE_SIM_THRESHOLD + 1)) >= 0.0
    t_sweep = time.perf_counter() - t0
    differ = [name for g, w, name in zip(kept, (x[keep] for x in want),
                                         ("src", "tgt", "kind", "cw"))
              if g.shape != w.shape or
              not np.array_equal(g.view(np.uint8), w.view(np.uint8))]
    missed = int((passed & ~keep).sum())
    m, n_pass = len(kept[0]), int(passed.sum())
    log(f"[{tag}] affinity filter: kept {m} of {n} candidates (share "
        f"{m / max(n, 1):.4f}; {ka.CANDIDATE_BYTES * m} B read back), the "
        f"native sweep passes {n_pass} (slack {m - n_pass}); the kept "
        f"candidates against the twin's differ in {differ or 'nothing'}, "
        f"{missed} passing candidates dropped; filter call {t_filter:.4f} s,"
        f" the native sweep over the whole stream {t_sweep:.4f} s (host "
        "clock)")
    require(not differ and missed == 0, f"{tag}: the card's filter kept "
            f"other candidates than its twin ({differ}) or dropped {missed} "
            "that the native sweep passes")
    return dict(candidates=n, readback_bytes=ka.CANDIDATE_BYTES * m,
                kept=m, passed=n_pass, kept_share=m / max(n, 1),
                pairs=int(P), sources=int(B), card_s=t_card,
                native_s=t_native, filter_s=t_filter, sweep_s=t_sweep)


def _profile(run, tag):
    """One more run under torch.profiler with the recorder on: the device
    ops that took the most time (the program's `l3d.*` annotations left
    out), the run's readbacks by site from the recorder's counters, and
    the device-to-host copies the profiler saw beside the recorder's.
    Returns {"DtoH": {count, bytes}} (the recorder's readbacks) with the
    profiler's copies under "profiler"."""
    from collections import defaultdict
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from line3d_tpu_torch import trace
    from line3d_tpu_torch.utils.time_match_view import memcpy_totals
    with trace.recording(), profile(activities=[ProfilerActivity.CPU,
                                                ProfilerActivity.CUDA]) \
            as prof:
        (l3d, t) = run()
        counters = trace.collect()["counters"]
    per_op = defaultdict(float)
    for e in prof.events():
        if e.device_type == DeviceType.CUDA and \
                not e.name.startswith("l3d."):
            per_op[e.name] += e.time_range.elapsed_us() / 1e3
    if not per_op:
        log(f"[{tag}] profiled run {t:.3f} s: the profiler saw no device "
            "events")
    top = sorted(per_op.items(), key=lambda kv: -kv[1])[:8]
    log(f"[{tag}] profiled run {t:.3f} s (host clock, profiler and recorder "
        f"on); most device time: " + "; ".join(f"{n[:60]} {ms:.1f} ms"
                                             for n, ms in top))
    sites = {k[len("syncs."):]: (v, counters[f"dtoh_bytes.{k[6:]}"])
             for k, v in counters.items() if k.startswith("syncs.")}
    d2h = dict(count=l3d.stats["readback_syncs"],
               bytes=l3d.stats["readback_bytes"])
    copies = memcpy_totals(prof)
    seen = copies.get("DtoH", dict(count=0, bytes=0, ms=0.0))
    log(f"[{tag}] profiled run: device-to-host readbacks {d2h['count']}, "
        f"{d2h['bytes']} bytes (t_match {l3d.stats['t_match']:.3f} s); by "
        f"site (count, bytes) {sites}; the profiler's device-to-host "
        f"copies {seen['count']}, {seen['bytes']} bytes, "
        f"{seen['ms']:.3f} ms; all copies {copies}")
    return {"DtoH": d2h, "profiler": copies}


def _facade_runs(cfg, scene, cams, n_warm, tag, profile=False):
    """One cold and n_warm warm runs of the facade through Line3D on the
    card; the kernels' launch counts of warm run 1; with profile, one more
    run under torch.profiler.  Returns (l3d of the last warm run, warm
    seconds, counts, the profiled run's copies or None)."""
    import torch
    from line3d_tpu_torch import Line3D

    def run():
        l3d = feed(Line3D(config=cfg), scene, cams)   # the card by default
        t0 = time.perf_counter()
        l3d.compute_3d_model()
        torch.cuda.synchronize()
        return l3d, time.perf_counter() - t0

    def stages(st):
        keys = ("t_collin", "t_match", "t_affinity", "t_diffusion", "t_fh",
                "t_fit", "t_cluster", "t_total")
        return ", ".join(f"{k} {st[k]:.3f}" for k in keys)

    l3d, t_cold = run()
    log(f"[{tag}] cold run {t_cold:.3f} s, {l3d.stats['num_lines']} lines "
        f"({stages(l3d.stats)})")
    warm, counts = [], None
    for i in range(n_warm):
        if i == 0:
            (l3d, t), counts = _counted(run, tag)
        else:
            l3d, t = run()
        warm.append(t)
        log(f"[{tag}] warm run {i + 1}: {t:.3f} s ({stages(l3d.stats)})")
    st = l3d.stats
    require(st["match_overflow"] == 0, f"{tag}: overflow is not 0")
    require(st["collinearity_overflow"] == 0,
            f"{tag}: collinearity overflow is not 0")
    require(st["num_lines"] > 0, f"{tag}: no lines")
    copies = _profile(run, tag) if profile else None
    return l3d, warm, counts, copies


def _hold_refine(call, where):
    """A recorded device refinement (args, kwargs, result) against the
    float64 host refinement on the same clusters, by tests/test_refine.py's
    criteria, the rms-before tolerance widened to the float32 residual
    floor."""
    import torch
    from line3d_tpu_torch.fit import refine as rf
    a, kw, got = call
    require(kw["device"].type == "cuda", f"{where}: refine not on the card")
    P0, d0, Pm, p1, p2, mask = a
    t0 = time.perf_counter()
    want = rf.refine_lines(P0, d0, Pm, p1, p2, mask,
                           iterations=kw["iterations"])
    t_host = time.perf_counter() - t0
    Pd, dd_, rb_d, ra_d = got
    Ph, dh, rb_h, ra_h = want
    align = float(np.abs(np.sum(dd_ * dh, axis=1)).min())
    perp = float(np.linalg.norm(np.cross(Pd - Ph, dh), axis=1).max())
    # the facade's lines are exact projections (rms ~1e-4 px), below what
    # a float32 residual can resolve at 1920 x 1440 with K ~ 1800: the
    # float32 and float64 residuals of the same initial lines part by up
    # to `floor` px, which bounds the two rms-before values' difference
    # in place of test_refine.py's atol 1e-4
    d_unit = d0 / np.linalg.norm(d0, axis=1, keepdims=True)
    r64, _ = rf._residuals(P0, d_unit, Pm, p1, p2, mask)
    f32 = lambda x: torch.as_tensor(np.asarray(x, np.float32),  # noqa
                                    device=kw["device"])
    r32, _ = rf.residuals_t(f32(P0), f32(d_unit), f32(Pm), f32(p1),
                             f32(p2), torch.as_tensor(mask,
                                                      device=kw["device"]))
    floor = float(np.abs(r32.cpu().numpy() - r64).max())
    rb_err = float(np.abs(rb_d - rb_h).max())
    log(f"[{where}] device refine vs float64 host ({t_host:.2f} s): "
        f"{len(P0)} lines, up to {Pm.shape[1]} members; median rms "
        f"{np.median(rb_h):.6f} -> {np.median(ra_d):.6f} (host "
        f"{np.median(ra_h):.6f}) px, rms-before diff {rb_err:.3e} (float32 "
        f"residual floor {floor:.3e}) px, worst excess "
        f"{float((ra_d - ra_h).max()):.3e} px, min alignment {align:.7f},"
        f" max perpendicular offset {perp:.3e}")
    require(bool((np.abs(rb_d - rb_h) <= 1e-4 * rb_h + max(1e-4, floor))
                 .all()) and
            np.median(ra_d) <= np.median(ra_h) * 1.1 + 1e-3 and
            bool((ra_d <= ra_h + 0.05).all()) and align > 0.9999 and
            perp < 5e-3, f"{where}: device refine differs from the host "
            "(tests/test_refine.py criteria)")
    return dict(clusters=len(P0), members=int(Pm.shape[1]), host_s=t_host,
                rms_before_diff=rb_err, floor=floor)


def phase_facade_diffusion_refine(card):
    """The facade with device diffusion and device refinement."""
    import torch
    from line3d_tpu_torch import L3DConfig
    from line3d_tpu_torch.cluster import diffusion_device as dd
    from line3d_tpu_torch.fit import refine as rf
    from line3d_tpu_torch.utils.demo import make_facade_scene
    cfg = L3DConfig(perform_diffusion=True, refine_lines=True)
    scene, cams = make_facade_scene(num_views=25, config=cfg)
    with spy(dd, "diffuse_reference_device", []) as dcalls, \
            spy(rf, "refine_lines_device", []) as rcalls:
        l3d, warm, counts, _ = _facade_runs(cfg, scene, cams, 3,
                                            "facaded")
    V, best_s = scene.num_views, min(warm)
    log(f"[facaded] warm seconds {warm}; best {best_s:.3f} s = "
        f"{V / best_s:.2f} images/s on {card}; {l3d.stats['num_lines']} "
        f"lines, {l3d.stats['num_edges']} edges")
    _hold_diffusion(dcalls[-1:], "reference", "facaded")
    _hold_refine(rcalls[-1], "facaded")
    txt = _txt_text(l3d)
    log(f"[facaded] model TXT sha256 {_sha256(txt)} ({len(txt)} bytes)")
    return dict(warm=warm, best=best_s, counts=counts, stats=l3d.stats,
                txt=txt)


def phase_facade_ba(card):
    """One facade run with joint BA, true-mode device diffusion and the
    round-parallel F-H."""
    import torch
    from line3d_tpu_torch import Line3D, L3DConfig
    from line3d_tpu_torch.cluster import diffusion_device as dd
    from line3d_tpu_torch.utils.demo import make_facade_scene
    cfg = L3DConfig(perform_diffusion=True, diffusion_mode="true",
                    fh_backend="parallel", bundle_adjust_cameras=True)
    scene, cams = make_facade_scene(num_views=25, config=cfg)
    def run():
        l3d = feed(Line3D(config=cfg, device="cuda"), scene, cams)
        t0 = time.perf_counter()
        l3d.compute_3d_model()
        torch.cuda.synchronize()
        return l3d, time.perf_counter() - t0
    with spy(dd, "diffuse_true_device", []) as calls:
        (l3d, t), _ = _counted(run, "facadeba")
    st = l3d.stats
    log(f"[facadeba] one run {t:.3f} s on {card}: {st['num_lines']} lines, "
        f"t_diffusion {st['t_diffusion']:.3f}, t_fh {st['t_fh']:.3f}, t_fit "
        f"{st['t_fit']:.3f} s; BA rms {st['ba_rms_before']:.4f} -> "
        f"{st['ba_rms_after']:.4f} px")
    require(st["num_lines"] > 0, "facadeba: no lines")
    require(st["ba_rms_after"] <= st["ba_rms_before"] + 1e-6,
            "facadeba: BA made the rms worse")
    R, tv = l3d.refined_poses
    orth = float(np.abs(np.einsum("vij,vkj->vik", R, R) - np.eye(3)).max())
    moved = float(np.abs(R - cams.R).max())
    log(f"[facadeba] refined poses: {R.shape[0]} cameras, max |R R^T - I| "
        f"{orth:.2e}, max rotation change {moved:.2e}")
    require(R.shape == (25, 3, 3) and tv.shape == (25, 3) and orth < 1e-5,
            "facadeba: refined poses are not orthonormal")
    _hold_diffusion(calls, "true", "facadeba")
    txt = _txt_text(l3d)
    log(f"[facadeba] model TXT sha256 {_sha256(txt)} ({len(txt)} bytes)")
    return dict(seconds=t, stats=st, txt=txt, poses=l3d.refined_poses)


def phase_capped(card, facade_txt):
    """The facade's three matching modes on the card (phase 11 of the
    module docstring)."""
    import contextlib as ctxlib
    import io
    import torch
    from line3d_tpu_torch import Line3D, L3DConfig
    from line3d_tpu_torch.match import engine, scoring_cuda as k23
    from line3d_tpu_torch.utils.demo import make_facade_scene
    base = L3DConfig()
    scene, cams = make_facade_scene(num_views=25, config=base)

    def runner(cfg, sink=None):
        def run():
            l3d = feed(Line3D(config=cfg), scene, cams)
            t0 = time.perf_counter()
            with ctxlib.redirect_stdout(sink) if sink else \
                    ctxlib.nullcontext():
                l3d.compute_3d_model()
            torch.cuda.synchronize()
            return l3d, time.perf_counter() - t0
        return run

    def describe(tag, l3d, times, counts):
        st = l3d.stats
        log(f"[capped] {tag}: seconds {[round(t, 3) for t in times]} on "
            f"{card} (the first after this configuration's first pass); "
            f"{st['num_lines']} lines, t_match {st['t_match']:.3f} s, "
            f"match_overflow {st['match_overflow']}, views_rematched_uncapped"
            f" {st['views_rematched_uncapped']}, probe m_total/quota/k_export"
            f" {st['probe_m_total']}/{st['probe_quota']}/"
            f"{st['probe_k_export']}, m_total per view "
            f"{sorted(set(st['m_total']))}; launches {counts}")

    out = {}
    # (a) the default: the probe's one pass
    (l3d, t), counts = _counted(runner(base), "capped")
    st = l3d.stats
    describe("(a) default", l3d, [t], counts)
    require(st["views_rematched_uncapped"] == 0 and
            st["match_overflow"] == 0, "capped (a): not exact in one pass")
    require(st["probe_m_total"] >= 512, "capped (a): probe_m_total < 512")
    require(_txt_text(l3d) == facade_txt,
            "capped (a): the model differs from phase facade's")
    out["a"] = dict(seconds=[t], counts=counts, lines=st["num_lines"])

    # (b) no probe: the capped pass, then the fallback
    cfg_b = L3DConfig(capacity_probe=False)
    runner(cfg_b)()
    (l3d, t1), counts = _counted(runner(cfg_b), "capped")
    _, t2 = runner(cfg_b)()
    st = l3d.stats
    describe("(b) capacity_probe=False", l3d, [t1, t2], counts)
    require(st["match_overflow"] > 0 and
            st["views_rematched_uncapped"] > 0,
            "capped (b): the capped pass did not overflow")
    require(counts["pair_valid"] == 25 + st["views_rematched_uncapped"],
            "capped (b): K1 launches are not one per view and re-match")
    require(_txt_text(l3d) == facade_txt,
            "capped (b): the fallback's model differs from the exact one")
    out["b"] = dict(seconds=[t1, t2], counts=counts, lines=st["num_lines"],
                    rematched=st["views_rematched_uncapped"],
                    overflow=st["match_overflow"])

    # (c) no guard: the capped pass as it is, and the warning
    cfg_c = L3DConfig(uncapped_fallback=False)
    runner(cfg_c, io.StringIO())()
    sink = io.StringIO()
    (l3d, t1), counts = _counted(runner(cfg_c, sink), "capped", wide=False)
    _, t2 = runner(cfg_c, io.StringIO())()
    st = l3d.stats
    warning = [ln for ln in sink.getvalue().splitlines() if "WARNING" in ln]
    describe("(c) uncapped_fallback=False", l3d, [t1, t2], counts)
    log(f"[capped] (c) printed: {warning}")
    require(len(warning) == 1 and "gate-passing matches" in warning[0]
            and str(st["match_overflow"]) in warning[0],
            "capped (c): the overflow warning is missing")
    require(st["match_overflow"] > 0 and
            st["views_rematched_uncapped"] == 0 and st["num_lines"] > 0 and
            set(st["m_total"]) == {256} and counts["score_wide"] == 0,
            "capped (c): not a capped pass at m_total 256")
    out["c"] = dict(seconds=[t1, t2], counts=counts, lines=st["num_lines"],
                    overflow=st["match_overflow"])

    # the scoring kernel on view 0's capped table (M = 256, quota 8)
    # against its twin: the facade's data in K3's shape
    ctx = engine.ViewContext(l3d.scene, l3d.cameras, cfg_c)
    nb = np.asarray(l3d.neighbors[0], np.int64)
    o = engine.match_view(ctx, 0, nb, caps=(cfg_c.match_block_quota, 256))
    segs_nb, _, _, _, _, P_nb = ctx.neighbor_arrays(0, nb)
    want = k23.score_plain(
        l3d.scene.segments_t[0], ctx.RtKinv32[0], ctx.C32[0], o["cam"],
        o["tgt"], o["depths"], o["valid"], P_nb, segs_nb,
        float(np.float32(cfg_c.sigma_p)), float(np.float32(cfg_c.sigma_a)),
        float(np.float32(ctx.spatial_ks[0])), cfg_c.support_threshold)
    err = (o["conf"] - want).abs()
    n_bad = int((err > SCORE_ATOL + SCORE_RTOL * want.abs()).sum())
    n_scored = int((want > 0).sum())
    log(f"[capped] view 0 capped table [{o['cam'].shape[0]}, "
        f"{o['cam'].shape[1]}]: overflow {int(o['overflow'])}, "
        f"{int(o['valid'].sum())} valid slots, {n_scored} scored, max abs "
        f"err vs the twin {float(err.max()):.3e}, {n_bad} outside rtol "
        f"{SCORE_RTOL} / atol {SCORE_ATOL}")
    require(o["cam"].shape[1] == 256 and int(o["overflow"]) > 0 and
            n_bad <= max(1, SCORE_FLIP_MAX * n_scored),
            "capped: the scoring kernel disagrees with its twin at M=256")
    return out


def phase_stress(card):
    """The P25 stress scene (phase 12 of the module docstring):
    `make_demo_scene`'s 25 views of a jittered wireframe with 2,990 uniform
    random clutter segments each (S = 3,072), exact on the card, one cold
    and one warm run.  Every view is matched at its exact capacity, so no
    overflow may remain."""
    import torch
    from line3d_tpu_torch import Line3D, L3DConfig
    from line3d_tpu_torch.utils.demo import make_demo_scene
    cfg = L3DConfig()
    t0 = time.perf_counter()
    scene, cams = make_demo_scene(25, num_random_segments=2990, config=cfg,
                                  device="cpu")
    t_build = time.perf_counter() - t0

    def run():
        l3d = feed(Line3D(config=cfg), scene, cams)
        t0 = time.perf_counter()
        l3d.compute_3d_model()
        torch.cuda.synchronize()
        return l3d, time.perf_counter() - t0

    l3d, t_cold = run()
    (l3d, t_warm), counts = _counted(run, "stress", wide=False)
    st = l3d.stats
    mt = sorted(set(st["m_total"]))
    log(f"[stress] make_demo_scene(25, num_random_segments=2990) built in "
        f"{t_build:.2f} s: S {scene.max_segments}, segments per view "
        f"{int(scene.seg_count.min())}-{int(scene.seg_count.max())}; cold "
        f"{t_cold:.3f} s, warm {t_warm:.3f} s = {25 / t_warm:.2f} images/s "
        f"on {card}; t_collin {st['t_collin']:.3f}, t_match "
        f"{st['t_match']:.3f}, t_cluster {st['t_cluster']:.3f} s; "
        f"probe_m_total {st['probe_m_total']}, m_total per view {mt}, "
        f"match_overflow {st['match_overflow']}, views_rematched_uncapped "
        f"{st['views_rematched_uncapped']}, collinearity overflow "
        f"{st['collinearity_overflow']} (views re-run exact "
        f"{st['views_recollin_exact']}), {st['num_best']} best matches, "
        f"{st['num_lines']} lines")
    require(st["match_overflow"] == 0 and
            st["views_rematched_uncapped"] == 0,
            "stress: match overflow remains")
    require(st["collinearity_overflow"] == 0 or
            st["views_recollin_exact"] > 0,
            "stress: collinear pairs dropped and no view re-run")
    require(scene.max_segments == 3072 and st["num_lines"] > 0,
            "stress: not the P25 stress shape, or no model")
    return dict(cold=t_cold, warm=t_warm, counts=counts,
                probe_m_total=st["probe_m_total"], m_total=mt,
                match_overflow=st["match_overflow"],
                views_rematched_uncapped=st["views_rematched_uncapped"],
                lines=st["num_lines"], t_match=st["t_match"])


# phase stressstages: repeats of each stage prefix and quota pair (after
# one warm-up each)
STRESS_STAGE_REPEATS = 5


def phase_stressstages(card):
    """The per-view step of the P25 stress scene split into stages, and the
    quota buckets (phase 13 of the module docstring): view 0's step in
    cumulative stages A-E at the JAX script's capacities (quota 8, m_total
    2048) and at its exact capacity (`utils/stress_stage_bench.py`), then
    the whole step at the ten (m_total, quota) pairs
    (`utils/quota_bucket_bench.py`), whose lossless pairs must select what
    the reference pair selects.  Each stage's and pair's timed calls must
    have launched K1 once a call and the scoring kernel once a call from
    stage D on (at M > 256 unless m_total is 256); the counts of the whole
    phase are set to 0 before it and read after.  The timed step's
    selection must then equal `engine.match_views`' for the view at both
    capacities (the ViewMatches, best row and median depth), so the timed
    copy of the step is held to the entry point at the shape it times.
    Then K1 and the scoring kernel against their twins at the view
    (_check_path_kernels)."""
    from types import SimpleNamespace
    from line3d_tpu_torch.match import engine
    from line3d_tpu_torch.utils import quota_bucket_bench as qbb, \
        stress_stage_bench as ssb
    t0 = time.perf_counter()
    fx = ssb.fixture("cuda")
    t_build = time.perf_counter() - t0
    require(fx.S == 3072 and len(fx.nb) == 10,
            "stressstages: not the P25 stress shape")
    _launch_counts(zero=True)
    stages = ssb.run(fx, STRESS_STAGE_REPEATS)
    quota = qbb.run(fx, STRESS_STAGE_REPEATS)
    counts = _launch_counts()
    n = STRESS_STAGE_REPEATS
    for cap in ("script", "exact"):
        wide = n if stages[cap]["occupancy"]["M"] > 256 else 0
        for st, r in stages[cap]["stages"].items():
            scored = st in ("D", "E")
            require(r["launches"] == dict(
                pair_valid=n, score=n if scored else 0,
                score_wide=wide if scored else 0),
                f"stressstages: {cap} stage {st} launched {r['launches']}")
    for r in quota["pairs"]:
        require(r["launches"] == dict(pair_valid=n, score=n,
                                      score_wide=n if r["m_total"] > 256
                                      else 0),
                f"stressstages: m_total {r['m_total']} quota {r['quota']} "
                f"launched {r['launches']}")
    lossless = [r for r in quota["pairs"] if r["overflow"] == 0]
    require(all(r["selection_equal"] for r in lossless),
            "stressstages: a lossless quota pair selected other matches")
    script = stages["script"]["stages"]
    score_ms = script["D"]["event_ms_median"] - \
        script["C"]["event_ms_median"]
    log(f"[stressstages] fixture built in {t_build:.2f} s; "
        f"{len(lossless)} of {len(quota['pairs'])} quota pairs drop "
        f"nothing and select what the ({qbb.COMBOS[0][0]}, "
        f"{qbb.COMBOS[0][1]}) pair selects; the scoring kernel's stage at "
        f"M = {stages['script']['occupancy']['M']} {score_ms:.3f} ms "
        f"(CUDA events); launches in the phase {counts}; on {card}")
    ctx = engine.ViewContext(fx.scene, fx.cams, fx.config)
    for caps in ((ssb.QUOTA, ssb.M_TOTAL), None):
        matched = engine.match_views(ctx, {fx.view: fx.nb}, [fx.view],
                                     caps=caps)
        bad = ssb.engine_mismatch(fx, ssb.step(fx, fx.segs_src, caps),
                                  matched[fx.view])
        require(not bad, f"stressstages: the timed step at caps {caps} "
                f"differs from engine.match_views in {bad}")
    log(f"[stressstages] the timed step's selection equals "
        f"engine.match_views' ({len(matched[fx.view][0].src_seg)} verified "
        "matches at exact capacity), at both capacities")
    run = SimpleNamespace(config=fx.config, scene=fx.scene, cameras=fx.cams,
                          neighbors={fx.view: fx.nb},
                          matches=[vm for vm, _, _ in matched.values()])
    held = _check_path_kernels(run, "stressstages", views=[fx.view])
    return dict(stages=stages, quota=quota, counts=counts, held=held,
                score_ms_m2048=score_ms)


# Phase cli holds the scoring kernel to its twins on detected segments
# (both edges of every drawn line, sub-pixel noise), whose supports lie
# 1-3 px off their lines, where exp(-dist^2 / 2 sigma_p^2) carries float32
# rounding of the projections into the confidence; the synthetic facade's
# supports lie on their lines and carry none.  Measured on an NVIDIA H100
# 80GB HBM3 at S = 3072 (views 0, 2 and 24): against the float32 twin
# 1.7e-4 to 8.9e-4 of the scored slots are outside the scoring tolerance;
# against the twin in float64, with the support threshold moved by the
# tolerance either way, 4.9e-5 to 4.5e-4 (the float32 twin itself: up to
# 3.5e-6, its worst slot at 2.25 times the tolerance), and at most one slot
# a view beyond three times the tolerance (a support-threshold flip).  The
# kernel keeps the Pallas kernel's projection, affine in the depth and
# undivided, which rounds more coarsely than the twin's projection of 3D
# points.  The reference parts from itself the same way: on facade rows
# whose endpoints carry 1-3 px of noise, line3d_tpu's Pallas scoring kernel
# leaves the same tolerance of its own XLA formulation on 0 to 2.9e-4 of
# the scored slots a view, support-threshold flips among them
# (tests/test_torch_scoring.py, PALLAS_XLA_OUTSIDE_MAX, which is this
# bound).
CLI_SCORE_OUTSIDE_MAX = 2e-3      # fraction of scored slots
CLI_SCORE_FAR_MAX = 1e-5          # fraction beyond 3x the tolerance


def _check_path_kernels(l3d, tag, views=None, capped=False):
    """The kernels of a finished Line3D run against their plain twins on
    the card, at the shapes that run gave them: for `views`, by default
    the first view of each match-slot width the run used and the last
    view, K1's planes on the view's N neighbors (and the probe counters
    the run reduced from them) and the scoring kernel on the view's exact
    match table; then K4 on all the scene's views.  K1 and K4 are held to
    phase `kernels`' tolerances.
    On the first of those views the device selection is held against the
    host selection on the same card tables (_hold_selection).
    The scoring kernel is held to its float32 twin and, as the arbiter of
    the two, to the twin run in float64 on the same table with the support
    threshold moved down and up by the scoring tolerance (a lower threshold
    only adds supports, so the two runs bracket every value that supports
    at the threshold can give a slot), with the bounds above.  With
    `capped` (a run with uncapped_fallback=False) each view is re-matched
    at the run's caps and must overflow as the run's view did.  For a
    Line3D run, the affinity enumeration that _counted kept under `tag`
    is held to the native walk (_hold_enum).  The launches made here come
    after the run's counts were read."""
    import torch
    from line3d_tpu_torch.match import collinearity as col, engine, \
        pairwise, pairwise_cuda as k1, scoring as sc
    cfg, scene = l3d.config, l3d.scene
    ctx = engine.ViewContext(scene, l3d.cameras, cfg)
    S = scene.max_segments
    if views is None:
        picked = {}
        for vm in l3d.matches:
            picked.setdefault(vm.m_total, vm)
        views = {vm.view: vm for vm in picked.values()}
        views[l3d.matches[-1].view] = l3d.matches[-1]
    else:
        want = set(views)
        views = {vm.view: vm for vm in l3d.matches if vm.view in want}
        require(set(views) == want, f"{tag}: views {sorted(want)} were "
                "not all matched")
    out = {}
    for v, vm in sorted(views.items()):
        M = vm.m_total
        nb = np.asarray(l3d.neighbors[v], np.int64)
        segs_nb, mask_nb, F_nb, RtKinv_nb, C_nb, P_nb = \
            ctx.neighbor_arrays(v, nb)
        a = (scene.segments_t[v], scene.seg_mask_t[v], segs_nb, mask_nb,
             F_nb, ctx.RtKinv32[v], RtKinv_nb, ctx.C32[v], C_nb,
             cfg.min_overlap_lower, cfg.min_overlap_upper)
        got, twin = k1.pair_valid_cuda(*a), k1.pair_valid_plain(*a)
        k1_bad, n_valid = int((got != twin).sum()), int(twin.sum())
        N = len(nb)
        blk = pairwise.block_size(S)
        cnt = twin.sum(dim=2)
        want = (int(cnt.sum(dim=0).max()), int(cnt.sum()),
                int(twin.reshape(N, S, S // blk, blk).sum(dim=3).max()),
                int(cnt.max()))
        mine = (vm.need_capacity, vm.total_candidates, vm.block_max,
                vm.nb_max)
        log(f"[{tag}] view {v}: K1 at [{N}, {S}, {S}]: {k1_bad} of {n_valid} "
            f"valid pairs disagree with the twin; probe counters (need, "
            f"total, blockmax, nbmax) of the run {mine}, from the twin's "
            f"planes {want}")
        require(k1_bad <= PAIR_DISAGREE_MAX * n_valid,
                f"{tag}: K1 disagrees with its plain twin at view {v}")
        require(all(abs(g - w) <= k1_bad for g, w in zip(mine, want)),
                f"{tag}: view {v}'s probe counters differ from the twin's")

        caps = (cfg.match_block_quota, min(
            cfg.max_matches_per_segment,
            max(len(n) for n in l3d.neighbors) * S)) if capped else None
        vm_d, row_d, med_d, o = _match_one(ctx, l3d.neighbors, v, caps)
        require(vm_d.m_total == M and
                vm_d.overflow == (vm.overflow if capped else 0),
                f"{tag}: view {v} was not re-matched at its run's width")
        if v == min(views):
            selection_syncs = _hold_selection(ctx, v, nb, o,
                                              (vm_d, row_d, med_d), tag)
        tcoords = pairwise.gather_target_coords(segs_nb, o["cam"], o["tgt"])

        def plain(support_t, dtype):
            f = lambda x: x.to(dtype)                       # noqa: E731
            return sc.score_matches(
                f(scene.segments_t[v]), None, f(ctx.RtKinv32[v]),
                f(ctx.C32[v]), o["cam"], o["tgt"], f(o["depths"]),
                o["valid"], f(P_nb), f(segs_nb),
                float(np.float32(cfg.sigma_p)),
                float(np.float32(cfg.sigma_a)),
                float(np.float32(ctx.spatial_ks[v])),
                support_threshold=support_t, tcoords=f(tcoords)).double()

        def tol(x):
            return SCORE_ATOL + SCORE_RTOL * x.abs()
        thr = cfg.support_threshold
        d = SCORE_ATOL + SCORE_RTOL * thr
        conf = o["conf"].double()
        t32 = plain(thr, torch.float32)
        lo, hi = plain(thr + d, torch.float64), plain(thr - d, torch.float64)

        def excess(x):
            """How far x lies outside [lo, hi], in tolerances."""
            return torch.maximum((lo - x) / tol(lo),
                                 (x - hi) / tol(hi)).clamp_min(0)
        err = (conf - t32).abs()
        n_bad = int((err > tol(t32)).sum())
        n_scored = int((t32 > 0).sum())
        ex_k, ex_t = excess(conf), excess(t32)
        n1, n3 = int((ex_k > 1).sum()), int((ex_k > 3).sum())
        log(f"[{tag}] view {v}: scoring at [{S}, {M}]: "
            f"{int(o['valid'].sum())} valid slots, {n_scored} scored; "
            f"against the float32 twin max abs err {float(err.max()):.3e}, "
            f"{n_bad} outside rtol {SCORE_RTOL} / atol {SCORE_ATOL} "
            f"({n_bad / max(n_scored, 1):.2e} of the scored); against the "
            f"float64 twin at support thresholds {thr} -+ {d:.1e} "
            f"({int((hi != lo).sum())} slots move between them): {n1} "
            f"beyond the tolerance ({n1 / max(n_scored, 1):.2e}), {n3} "
            f"beyond 3x, worst {float(ex_k.max()):.2f}x; the float32 twin "
            f"itself {int((ex_t > 1).sum())} beyond the tolerance, worst "
            f"{float(ex_t.max()):.2f}x")
        require(n_scored > 0 and
                max(n_bad, n1) <= CLI_SCORE_OUTSIDE_MAX * n_scored and
                n3 <= max(1, CLI_SCORE_FAR_MAX * n_scored),
                f"{tag}: the scoring kernel disagrees at view {v}, M={M}")
        out[f"view {v}"] = dict(
            S=S, M=M, k1_disagree=k1_bad, score_scored=n_scored,
            score_max_abs_err=float(err.max()), score_outside=n_bad,
            score_outside_f64=n1, score_far_f64=n3,
            score_worst_f64=float(ex_k.max()))

    sig2 = np.float32(cfg.collinearity_sigma * cfg.collinearity_sigma)
    kw = dict(quota=cfg.collinearity_block_quota,
              pairs_per_seg=cfg.collinearity_pairs_per_seg,
              aff_threshold=cfg.collinearity_aff_threshold)
    g = [x.cpu().numpy() for x in col.collinearity_compact_all(
        scene.segments_t, scene.seg_mask_t, sig2, **kw)]
    w = [x.cpu().numpy() for x in col.collinearity_compact_all_plain(
        scene.segments_t, scene.seg_mask_t, sig2, **kw)]
    differ = int((g[1] != w[1]).sum())
    log(f"[{tag}] K4 on the run's {scene.num_views} views x S={S}: "
        f"{int((g[0] >= 0).sum())} pairs, candidates {int(g[2].sum())}; "
        f"keys equal {np.array_equal(g[0], w[0])}, counts equal "
        f"{np.array_equal(g[2], w[2])}, {differ} weights differ")
    require(np.array_equal(g[0], w[0]) and np.array_equal(g[2], w[2]),
            f"{tag}: K4's pairs or counts differ from the twin")
    require(differ == 0, f"{tag}: K4's weights differ from the twin")
    out["collin_pairs"] = dict(S=S, views=scene.num_views,
                               pairs=int((g[0] >= 0).sum()),
                               weights_differ=differ)
    out["selection_syncs"] = selection_syncs
    call = _ENUM_CALLS.pop(tag, None)
    if hasattr(l3d, "stats"):        # a Line3D run, not a step's tables
        require(call is not None, f"{tag}: no counted run's affinity "
                "enumeration to hold")
    out["affinity_enum"] = _hold_enum(call, tag) if call else None
    return out


def write_facade_dataset(root, scene, cams):
    """A VisualSfM dataset of the facade scene in `root`: each view's
    projected segments rendered to a binary PGM, and `scene.nvm`
    (`cli_bench.nvm_text` at 12 decimals).  Returns the NVM file's
    path."""
    from line3d_tpu_torch.utils.cli_bench import nvm_text, render_images

    def name(v):
        return f"view_{v:03d}.pgm"
    render_images(scene, root, name, int(cams.width[0]),
                  int(cams.height[0]))
    path = os.path.join(root, "scene.nvm")
    with open(path, "w") as f:
        f.write(nvm_text(scene, cams, name, prec=12))
    return path


def model_error(result, gt_lines):
    """Median over the model's 3D segments of the mean distance of its two
    endpoints to the nearest ground-truth segment ([L, 2, 3])."""
    A, B = gt_lines[:, 0], gt_lines[:, 1]
    AB = B - A
    den = np.maximum((AB * AB).sum(axis=1), 1e-30)
    errs = []
    for line in result:
        for seg in np.asarray(line.segments3d):
            d = []
            for P in seg:
                t = np.clip(((P - A) * AB).sum(axis=1) / den, 0.0, 1.0)
                d.append(np.linalg.norm(A + t[:, None] * AB - P, axis=1))
            errs.append(float((0.5 * (d[0] + d[1])).min()))
    return float(np.median(errs)), len(errs)


def run_cli_dataset(root, scene, cams, gt_lines, tag, extra=()):
    """The dataset-to-model flow of phase `cli` on one scene: write the
    dataset, run `cli.main(["vsfm", ...])` with `extra` flags twice
    (detecting; from the caches), then `python -m line3d_tpu_torch.cli`
    with --profile_dir in a process of its own, and check the outputs.
    `extra` is appended to every command line (a rehearsal at a small size
    on the CPU passes `--device cpu`).  Returns a dict of what was
    measured."""
    import glob
    from line3d_tpu_torch import cli
    t0 = time.perf_counter()
    nvm = write_facade_dataset(root, scene, cams)
    t_write = time.perf_counter() - t0
    out_dir = os.path.join(root, "Line3D")
    argv = ["vsfm", "-i", nvm] + list(extra)

    def run(more=(), host_selection=False):
        make = cli._line3d

        def line3d(args, folder):
            l3d = make(args, folder)
            l3d.use_sharded_engine = not host_selection
            return l3d
        cli._line3d = line3d
        try:
            with spy(cli, "_finish", []) as calls:
                t0 = time.perf_counter()
                cli.main(argv + list(more))
                t = time.perf_counter() - t0
        finally:
            cli._line3d = make
        return calls[0][0][0], t           # the Line3D, seconds

    (l3d, t_first), counts = _counted(run, tag)
    st = l3d.stats
    n_segs = np.array([len(s) for s in l3d._segments])
    drawn = np.asarray(scene.seg_count)
    txts = glob.glob(os.path.join(out_dir, "line3D_result_*.txt"))
    stls = glob.glob(os.path.join(out_dir, "line3D_result_*.stl"))
    caches = glob.glob(os.path.join(out_dir, "L3D_data", "segments_*.npz"))
    V = scene.num_views
    log(f"[{tag}] dataset written in {t_write:.2f} s; first run "
        f"{t_first:.2f} s: t_detect {st['t_detect']:.3f} s for {V} images "
        f"of {int(cams.width[0])} x {int(cams.height[0])} "
        f"({st['t_detect'] / V * 1e3:.1f} ms per image by wall clock, "
        f"{min(os.cpu_count() or 1, 8)} workers x "
        f"{max(1, (os.cpu_count() or 1) // min(os.cpu_count() or 1, 8))} "
        f"native threads on {os.cpu_count()} cores), segments per view "
        f"min/median/max {n_segs.min()}/{int(np.median(n_segs))}/"
        f"{n_segs.max()} (drawn {drawn.min()}-{drawn.max()}), S "
        f"{l3d.scene.max_segments}, t_match {st['t_match']:.3f} s, "
        f"t_cluster {st['t_cluster']:.3f} s, {st['num_lines']} lines, "
        f"m_total {sorted(set(st['m_total']))}, probe m_total "
        f"{st['probe_m_total']}, overflow {st['match_overflow']}")
    require(len(txts) == 1 and len(stls) == 1 and len(caches) == V,
            f"{tag}: expected one TXT, one STL and {V} caches")
    require(os.path.basename(txts[0]).startswith("line3D_result__W_")
            and "__COLLIN__NO_DIFFUSION" in txts[0],
            f"{tag}: the result name is not stamped")
    require(l3d.device.type == "cuda", f"{tag}: the CLI did not take the card")
    require(st["num_lines"] > 0 and st["match_overflow"] == 0 and
            st["t_detect"] > 0, f"{tag}: no model")
    err, n3d = model_error(l3d.get_result(), gt_lines)
    log(f"[{tag}] {n3d} 3D segments, median distance to the ground-truth "
        f"lines {err:.5f}")
    with open(txts[0], "rb") as f:
        first = f.read()
    t0 = time.perf_counter()
    held = _check_path_kernels(l3d, tag)
    log(f"[{tag}] kernels held against their twins at this run's shapes in "
        f"{time.perf_counter() - t0:.1f} s")

    # the second run selects on the host (use_sharded_engine=False): the
    # same model from the other selection
    l3d2, t_second = run(host_selection=True)
    with open(txts[0], "rb") as f:
        second = f.read()
    log(f"[{tag}] second run {t_second:.2f} s from the {V} caches, with "
        f"host selection: t_detect {l3d2.stats['t_detect']:.3f} s, t_match "
        f"{l3d2.stats['t_match']:.3f} s (device selection "
        f"{st['t_match']:.3f} s), TXT equal byte for byte "
        f"{first == second} ({len(first)} bytes)")
    require(first == second, f"{tag}: the cached run with host selection "
            "wrote another model")
    require(l3d2.matches[0].depths is not None and
            l3d.matches[0].depths is None,
            f"{tag}: the two runs did not take the two selections")
    require(l3d2.stats["t_detect"] < 0.5 * st["t_detect"],
            f"{tag}: the cached run detected again")

    # The profiled run is a process of its own, as a user starts the CLI:
    # the first torch.profiler trace a process takes records every device
    # event, but later traces of one process were seen to drop their first
    # device events, K4's two passes among them (NVIDIA H100 80GB HBM3,
    # torch 2.11: kept in the first trace of 8 of 8 processes, lost in most
    # traces after a process's sixth).
    prof = os.path.join(root, "profile")
    here = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    r = subprocess.run(
        [sys.executable, "-m", "line3d_tpu_torch.cli"] + argv
        + ["--profile_dir", prof], cwd=here, capture_output=True, text=True)
    t_third = time.perf_counter() - t0
    for ln in r.stdout.splitlines():
        log(f"[{tag}]   {ln}")
    require(r.returncode == 0, f"{tag}: python -m line3d_tpu_torch.cli "
            f"failed:\n{r.stderr[-2000:]}")
    with open(txts[0], "rb") as f:
        require(f.read() == first, f"{tag}: the profiled run in its own "
                "process wrote another model")
    with open(os.path.join(prof, "line3d_trace.json")) as f:
        trace = f.read()
    seen = {k: trace.count(k) for k in ("pair_kernel", "score_kernel",
                                        "collin_pairs_kernel",
                                        "l3d.match.depths")}
    log(f"[{tag}] python -m line3d_tpu_torch.cli ... --profile_dir in "
        f"{t_third:.1f} s: the same TXT, trace {len(trace)} bytes, kernel "
        f"names in it: {seen}")
    return dict(t_detect=st["t_detect"], t_match=st["t_match"],
                t_match_host_selection=l3d2.stats["t_match"],
                t_first=t_first, t_second=t_second, lines=st["num_lines"],
                err=err, counts=counts, trace_names=seen, held=held,
                txt=first,
                segs=(int(n_segs.min()), int(np.median(n_segs)),
                      int(n_segs.max())))


def png_writer():
    """(library, write(path, gray uint8 image)) of the first image library
    that imports, cv2 then PIL; (None, None) when neither does (the port
    itself reads .jpg / .png, which the bundler layout names, only
    through one of them)."""
    try:
        import cv2
        return "cv2", lambda path, img: cv2.imwrite(path, img)
    except ImportError:
        pass
    try:
        from PIL import Image
        return "PIL", lambda path, img: Image.fromarray(img).save(path)
    except ImportError:
        return None, None


def write_bundler_dataset(root, vsfm_root, scene, cams, write):
    """A bundler dataset of the facade in `root`: `vsfm_root`'s rendered
    PGM views (write_facade_dataset) as visualize/%08d.png, and
    bundle.rd.out (`cli_bench.bundle_text` at 12 decimals)."""
    from line3d_tpu_torch.utils.cli_bench import bundle_text
    os.makedirs(os.path.join(root, "visualize"))
    for v in range(scene.num_views):
        w, h = int(cams.width[v]), int(cams.height[v])
        head = f"P5\n{w} {h}\n255\n".encode()
        img = np.fromfile(os.path.join(vsfm_root, f"view_{v:03d}.pgm"),
                          np.uint8, offset=len(head)).reshape(h, w)
        write(os.path.join(root, "visualize", f"{v:08d}.png"), img)
    with open(os.path.join(root, "bundle.rd.out"), "w") as f:
        f.write(bundle_text(scene, cams, prec=12))


def run_bundler_dataset(root, vsfm_root, scene, cams, gt_lines, vsfm_txt,
                        tag, extra=()):
    """`cli.main(["bundler", ...])` once on the facade images of phase cli
    written as PNG, held as the vsfm run is (one stamped TXT and STL, on
    the card, no overflow, the median distance to the ground truth);
    whether its TXT equals the vsfm run's is logged.  Returns a dict, or
    None (logged) when no image library imports."""
    import glob
    from line3d_tpu_torch import cli
    lib, write = png_writer()
    if write is None:
        log(f"[{tag}] bundler: neither cv2 nor PIL imports here, so no "
            f".png can be written or read; the bundler CLI was not run")
        return None
    t0 = time.perf_counter()
    write_bundler_dataset(root, vsfm_root, scene, cams, write)
    t_write = time.perf_counter() - t0
    with spy(cli, "_finish", []) as calls:
        def run():
            t0 = time.perf_counter()
            cli.main(["bundler", "-i", root] + list(extra))
            return calls[-1][0][0], time.perf_counter() - t0
        (l3d, t), counts = _counted(run, tag)
    st = l3d.stats
    out_dir = os.path.join(root, "Line3D")
    txts = glob.glob(os.path.join(out_dir, "line3D_result_*.txt"))
    stls = glob.glob(os.path.join(out_dir, "line3D_result_*.stl"))
    require(len(txts) == 1 and len(stls) == 1 and
            os.path.basename(txts[0]).startswith("line3D_result__W_"),
            f"{tag}: bundler: expected one stamped TXT and STL")
    require(l3d.device.type == "cuda", f"{tag}: bundler: not on the card")
    require(st["num_lines"] > 0 and st["match_overflow"] == 0,
            f"{tag}: bundler: no model")
    err, n3d = model_error(l3d.get_result(), gt_lines)
    with open(txts[0], "rb") as f:
        same = f.read() == vsfm_txt
    log(f"[{tag}] bundler ({lib} wrote {scene.num_views} PNG in "
        f"{t_write:.2f} s): {t:.2f} s, t_detect {st['t_detect']:.3f} s, "
        f"t_match {st['t_match']:.3f} s, {st['num_lines']} lines, {n3d} 3D "
        f"segments, median distance to the ground truth {err:.5f}; TXT "
        f"equal to the vsfm run's byte for byte {same}; launches {counts}")
    require(err < CLI_MEDIAN_ERR_MAX,
            f"{tag}: bundler: median distance to the ground truth {err}")
    return dict(library=lib, seconds=t, err=err, lines=st["num_lines"],
                same_txt_as_vsfm=same, counts=counts)


# the bound on phase cli's median distance of the model's 3D segments to
# the ground-truth facade lines (the facade spans 12 x 10 units, windows of
# ~0.6); measured 0.018 on an NVIDIA H100 80GB HBM3
CLI_MEDIAN_ERR_MAX = 0.05


def phase_cli(card):
    """Images on disk to a 3D line model through the port's `vsfm` entry
    point on the card (phase 14 of the module docstring)."""
    from line3d_tpu_torch.utils.demo import facade_lines, make_facade_scene
    scene, cams = make_facade_scene(num_views=25, device="cpu")
    gt = facade_lines(n_cols=12, n_rows=10, seed=11)
    with tempfile.TemporaryDirectory() as root:
        r = run_cli_dataset(root, scene, cams, gt, "cli")
        r["bundler"] = run_bundler_dataset(
            os.path.join(root, "bundler"), root, scene, cams, gt, r["txt"],
            "cli")
    require(r["err"] < CLI_MEDIAN_ERR_MAX,
            f"cli: median distance to the ground truth {r['err']}")
    require(all(n > 0 for n in r["trace_names"].values()),
            "cli: the profiler trace does not name the kernels")
    log(f"[cli] on {card}")
    return r


def _txt_model(l3d, path):
    l3d.save_3d_lines_as_txt(l3d.get_result(), path)


def _sha256(text: str) -> str:
    import hashlib
    return hashlib.sha256(text.encode()).hexdigest()


def _txt_text(l3d) -> str:
    """The model as its TXT file's text."""
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "model.txt")
        _txt_model(l3d, path)
        with open(path) as f:
            return f.read()


def phase_house10():
    import torch
    from line3d_tpu_torch import Line3D, L3DConfig
    from line3d_tpu_torch.io.writers import compare_txt
    from line3d_tpu_torch.match import scoring_cuda as k23
    from line3d_tpu_torch.utils.synthetic import make_scene
    syn = make_scene(num_views=10)
    l3d = feed(Line3D(config=L3DConfig(use_collinearity=True),
                      device="cuda"), syn.scene, syn.cameras)
    n0, w0 = k23.LAUNCHES, k23.LAUNCHES_WIDE
    l3d.compute_3d_model()
    torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "house10.txt")
        _txt_model(l3d, path)
        rep = compare_txt(path, os.path.join(GOLDEN_DIR, "house10.txt"))
    log(f"[house10] {l3d.stats['num_lines']} lines, m_total "
        f"{sorted(set(l3d.stats['m_total']))}, scoring launches at "
        f"M <= 256: {k23.LAUNCHES - n0 - (k23.LAUNCHES_WIDE - w0)}")
    log(f"[house10] vs golden (rtol 1e-5, atol 1e-6): {rep['n_tokens']} "
        f"tokens, {rep['int_bad']} int mismatches, "
        f"{len(rep['outside'])} floats outside {rep['outside']}, worst "
        f"{rep['worst_ratio']:.4f} of its tolerance")
    require(rep["int_bad"] == 0, "house10 model differs from the golden")
    require(rep["outside"] == HOUSE10_OUTSIDE and rep["worst_ratio"] < 1.05,
            "house10 floats differ from the golden beyond the known token")


def phase_facade(card):
    import torch
    from line3d_tpu_torch import Line3D, L3DConfig
    from line3d_tpu_torch.match import engine
    from line3d_tpu_torch.utils.demo import make_facade_scene
    cfg = L3DConfig()
    scene, cams = make_facade_scene(num_views=25, config=cfg)
    V = scene.num_views
    l3d, warm, counts, copies = _facade_runs(cfg, scene, cams, 3, "facade",
                                             profile=True)
    st = l3d.stats
    mt, mc = np.unique(st["m_total"], return_counts=True)
    log(f"[facade] {st['num_lines']} lines, {st['num_best']} best matches, "
        f"overflow {st['match_overflow']}, m_total per view "
        f"{dict(zip(mt.tolist(), mc.tolist()))}, collinearity overflow "
        f"{st['collinearity_overflow']}")
    best_s = min(warm)
    log(f"[facade] warm seconds {warm}; best {best_s:.3f} s = "
        f"{V / best_s:.2f} images/s on {card}")
    txt = _txt_text(l3d)

    # the host selection (use_sharded_engine=False): the same model
    host_s, host_match = [], []
    for _ in range(2):
        h = feed(Line3D(config=cfg, use_sharded_engine=False), scene, cams)
        t0 = time.perf_counter()
        h.compute_3d_model()
        torch.cuda.synchronize()
        host_s.append(time.perf_counter() - t0)
        host_match.append(h.stats["t_match"])
    same = _txt_text(h) == txt
    log(f"[facade] use_sharded_engine=False (host selection): seconds "
        f"{[round(t, 3) for t in host_s]}, t_match "
        f"{[round(t, 3) for t in host_match]} s; TXT equal to the "
        f"default's byte for byte {same} ({st['num_lines']} lines)")
    require(same and h.matches[0].depths is not None and
            l3d.matches[0].depths is None,
            "facade: host selection wrote another model")

    # views 0 and 12 again, on the card and on the CPU
    torch.set_num_threads(os.cpu_count() or 1)
    ctx_g = engine.ViewContext(l3d.scene, l3d.cameras, cfg)
    ctx_c = engine.ViewContext(l3d.scene.to("cpu"), l3d.cameras, cfg)
    syncs = {}
    for v in (0, 12):
        t0 = time.perf_counter()
        syncs[v] = _check_view_on_cpu(l3d, ctx_g, ctx_c, v)
        log(f"[facade] view {v}: CPU check {time.perf_counter() - t0:.1f} s")
    reduced = _reduced_facade_card_vs_cpu(card)
    return dict(warm=warm, best=best_s, counts=counts, stats=st, txt=txt,
                copies=copies, host_selection_seconds=host_s,
                host_selection_t_match=host_match, syncs=syncs,
                reduced=reduced)


# the reduced facade of tests/test_torch_host.py's tier-1 tests, facade6
# (6 views of a 10 x 6-cell facade at 960 x 720, focal 900), where the
# port's CPU model is held to line3d_tpu's stage by stage in every tier-1
# run (264 / 263 lines, 259 member sets shared, every difference entering
# at matching); that file's slow facade8 (8 views, 12 x 10 cells) takes
# ~55 s more on the CPU here
REDUCED_FACADE = dict(num_views=6, width=960, height=720, focal=900.0,
                      n_cols=10, n_rows=6, distance=13.0 * 10 / 12)
# bounds of stage (f) there: verified-match sets may differ on less than
# this share of a view's matches; a differing best-match pick must be a
# near-tie (within this relative gap of the CPU's confidences), lie in a
# row whose verified matches differ, or be a tie of the float64
# confidences that float32 rounding orders (utils/compare.float64_tie)
VERIFIED_DIFF_MAX = 1e-3
NEAR_TIE_REL = 1e-5


def _reduced_facade_card_vs_cpu(card):
    """The reduced facade through Line3D on the card (K1, K4, the scoring
    kernel; launches counted) and on the CPU (the plain twins, host
    selection) in this process, held to stage (f)'s bounds of
    tests/test_torch_host.py; the models compared by member sets.  The CPU
    run is the port that test holds to line3d_tpu, so this closes the chain
    card -> port on the CPU -> line3d_tpu."""
    import torch
    from line3d_tpu_torch import Line3D, L3DConfig
    from line3d_tpu_torch.match import engine
    from line3d_tpu_torch.utils import compare
    from line3d_tpu_torch.utils.demo import make_facade_scene
    cfg = L3DConfig()
    scene, cams = make_facade_scene(config=cfg, device="cpu",
                                    **REDUCED_FACADE)

    def card_run():
        l3d = feed(Line3D(config=cfg), scene, cams)
        l3d.compute_3d_model()
        torch.cuda.synchronize()
        return l3d
    g, counts = _counted(card_run, "facade6")
    t0 = time.perf_counter()
    c = feed(Line3D(config=cfg, use_sharded_engine=False, device="cpu"),
             scene, cams)
    c.compute_3d_model()
    t_cpu = time.perf_counter() - t0
    for l3d, where in ((g, "card"), (c, "CPU")):
        require(l3d.stats["match_overflow"] == 0 and
                l3d.stats["views_recollin_exact"] == 1,
                f"facade6: the {where} run overflowed or did not re-run "
                "view 5's collinearity")

    diffs = compare.verified_differences(c.matches, g.matches)
    per_view = {v: (n, len(oc), len(og))
                for v, (n, _, oc, og) in diffs.items()}
    for v, (n, oc, og) in per_view.items():
        require(oc + og < VERIFIED_DIFF_MAX * n,
                f"facade6: view {v}: verified matches differ on {oc} + {og} "
                f"of {n}")
    picks = compare.best_pick_differences(c.best, g.best, c.matches,
                                          g.matches, rel=NEAR_TIE_REL)
    ties = {}
    ctx_c = engine.ViewContext(c.scene, c.cameras, cfg)
    ctx_g = engine.ViewContext(g.scene, g.cameras, cfg)
    for v in sorted({u[0] for u in picks["untraced"]}):
        tc, tg = {}, {}
        engine.match_views(ctx_c, c.neighbors, [v], device_selection=False,
                           tables=tc)
        engine.match_views(ctx_g, g.neighbors, [v], tables=tg)
        tc = {k: x.numpy() for k, x in tc[v].items()}
        tg = {k: x.cpu().numpy() for k, x in tg[v].items()}
        for _, s, pick_c, pick_g, _gap in [u for u in picks["untraced"]
                                           if u[0] == v]:
            slots = (tc["cam"][s], tc["tgt"][s], tc["valid"][s])
            confs = [tc["conf"][s]]
            if all(np.array_equal(tg[k][s], tc[k][s])
                   for k in ("cam", "tgt", "valid")):
                confs.append(tg["conf"][s])
            gap64, err32 = compare.float64_tie(
                c.scene, c.cameras, c.neighbors, cfg, v, s, slots, confs,
                pick_c, pick_g)
            ties[(v, s)] = (float(gap64), float(err32))
            require(gap64 < err32,
                    f"facade6: view {v} segment {s}: the card picks "
                    f"{pick_g[:2]}, the CPU {pick_c[:2]}: not a near-tie, "
                    f"not traced, float64 gap {gap64:.3e} >= float32 error "
                    f"{err32:.3e}")
    with tempfile.TemporaryDirectory() as d:
        paths = [os.path.join(d, f"{k}.txt") for k in ("card", "cpu")]
        _txt_model(g, paths[0])
        _txt_model(c, paths[1])
        models = compare.compare_models(*paths)
    out = dict(lines_card=models["lines_a"], lines_cpu=models["lines_b"],
               shared_member_sets=models["shared"],
               only_card=models["only_a"], only_cpu=models["only_b"],
               verified_per_view={v: dict(n_cpu=n, only_cpu=oc,
                                          only_card=og)
                                  for v, (n, oc, og) in per_view.items()},
               best_matches=dict(card=picks["n_b"], cpu=picks["n_a"],
                                 differ=picks["differ"],
                                 near_ties=picks["near_tie"],
                                 traced=picks["traced"],
                                 float64_ties=len(ties)),
               largest_confidence_gap=picks["max_gap"],
               float64_ties={f"{v}:{s}": t for (v, s), t in ties.items()},
               cpu_seconds=round(t_cpu, 1))
    log(f"[facade6] card vs CPU: {json.dumps(out)}")
    return dict(out, counts=counts)


# host synchronisations of one exact view's match step with device
# selection: the probe counters, the export's masked_select, the selection
# buffer's copy
VIEW_SYNCS_MAX = 3


def _match_one(ctx, neighbors, v, caps=None):
    """View v's match step as the pipeline runs it (`engine.match_views`
    of the one view, at `caps` or exact): (ViewMatches, best row, median,
    the card tables)."""
    from line3d_tpu_torch.match import engine
    tables = {}
    (vm, row, med), = engine.match_views(ctx, neighbors, [v], caps=caps,
                                         tables=tables).values()
    return vm, row, med, tables[v]


def _hold_selection(ctx, v, nb, table, got, tag):
    """Device selection against the host selection on the same card
    tables: `got` = (ViewMatches, best row, median) of a device-selected
    match step (_match_one), `table` its card tables, copied here to the
    host for `_select_view_outputs`.  Identities (in order), best rows and
    median must be equal; the device-selected ViewMatches holds no depths
    or confidences.  Then one more call, counting its host
    synchronisations (at most VIEW_SYNCS_MAX)."""
    from line3d_tpu_torch.match import engine
    from line3d_tpu_torch.utils.time_match_view import count_syncs
    vm_d, row_d, med_d = got
    raw = {k: x.cpu().numpy() for k, x in table.items()}
    vm_h, row_h, med_h = engine._select_view_outputs(
        ctx, v, nb, raw["cam"], raw["tgt"], raw["depths"], raw["valid"],
        raw["conf"], 0)
    same_ids = all(np.array_equal(getattr(vm_d, f), getattr(vm_h, f))
                   for f in ("src_seg", "tgt_view", "tgt_seg"))
    same_best = (row_d is None) == (row_h is None) and (
        row_h is None or all(np.array_equal(row_d[k], row_h[k])
                             for k in row_h))
    n_syncs, _ = count_syncs(lambda: engine.match_views(ctx, {v: nb}, [v]))
    log(f"[{tag}] view {v}: device selection vs host selection on the same "
        f"card tables: {len(vm_d.src_seg)} verified identities equal "
        f"{same_ids}, {0 if row_h is None else len(row_h['seg'])} best rows "
        f"equal {same_best}, median {med_d!r} / {med_h!r}; one more call "
        f"synchronised {n_syncs} times")
    require(same_ids and same_best and med_d == med_h,
            f"{tag}: view {v}: device selection differs from the host's")
    require(vm_d.depths is None and vm_d.confidence is None,
            f"{tag}: view {v}: device selection carried per-match data")
    require(n_syncs <= VIEW_SYNCS_MAX,
            f"{tag}: view {v}: {n_syncs} synchronisations")
    return n_syncs


def _check_view_on_cpu(l3d, ctx_g, ctx_c, v):
    """One view's per-view step on the card against the CPU's plain twins.

    K1 is held against its twin on the view's planes.  The CPU step then
    matches on the card's K1 planes, so both sides score the same tables
    and a best-match key may differ only as a near-tie (the two best
    confidences within the scoring tolerance) or in a row holding a slot
    where the scoring kernel and its twin part by more than the tolerance
    (a support at the threshold), of which at most SCORE_FLIP_MAX of the
    scored slots are allowed.  The card's device selection is held against
    the host selection on its own tables (_hold_selection).  Returns the
    synchronisations of one more call on the card."""
    from line3d_tpu_torch.match import engine, pairwise, pairwise_cuda as k1
    nb = np.asarray(l3d.neighbors[v], np.int64)
    planes = {}

    def card_planes(*a):
        planes["g"] = k1.pair_valid(*a)
        return planes["g"]
    try:
        engine.pair_valid = card_planes
        vm_g, bg, med_g, tg = _match_one(ctx_g, l3d.neighbors, v)
        engine.pair_valid = lambda *a: planes["g"].cpu()
        _, bc, _, tc = _match_one(ctx_c, l3d.neighbors, v)
    finally:
        engine.pair_valid = k1.pair_valid
    mine = l3d.best.view == v
    require(np.array_equal(bg["seg"], l3d.best.seg[mine]) and
            np.array_equal(bg["tgt_seg"], l3d.best.tgt_seg[mine]),
            f"view {v}: per-view step differs from the pipeline run")
    n_syncs = _hold_selection(ctx_g, v, nb, tg, (vm_g, bg, med_g), "facade")
    rg = {k: x.cpu().numpy() for k, x in tg.items()}
    rc = {k: x.numpy() for k, x in tc.items()}

    segs_nb, mask_nb, F_nb, RtKinv_nb, C_nb, _ = ctx_c.neighbor_arrays(v, nb)
    twin = k1.pair_valid_plain(
        ctx_c.scene.segments_t[v], ctx_c.scene.seg_mask_t[v], segs_nb,
        mask_nb, F_nb, ctx_c.RtKinv32[v], RtKinv_nb, ctx_c.C32[v], C_nb,
        ctx_c.config.min_overlap_lower, ctx_c.config.min_overlap_upper)
    k1_bad, n_valid = int((planes["g"].cpu() != twin).sum()), int(twin.sum())
    log(f"[facade] view {v}: K1 {k1_bad} of {n_valid} valid pairs disagree "
        f"with the twin")
    require(k1_bad <= PAIR_DISAGREE_MAX * n_valid,
            f"view {v}: K1 disagrees with its plain twin")
    # the capacity-probe counters the pipeline run reduced on the card from
    # K1's planes, against the same reductions of the twin's planes on the
    # CPU: each may differ by at most the pairs K1 and the twin part on
    N, S = twin.shape[0], twin.shape[1]
    blk = pairwise.block_size(S)
    cnt = twin.sum(dim=2)
    want = (int(cnt.sum(dim=0).max()), int(cnt.sum()),
            int(twin.reshape(N, S, S // blk, blk).sum(dim=3).max()),
            int(cnt.max()))
    vm = next(m for m in l3d.matches if m.view == v)
    got = (vm.need_capacity, vm.total_candidates, vm.block_max, vm.nb_max)
    log(f"[facade] view {v}: probe counters (need, total, blockmax, nbmax) "
        f"on the card {got}, from the twin's planes on the CPU {want}")
    require(all(abs(g - w) <= k1_bad for g, w in zip(got, want)),
            f"view {v}: probe counters differ from the twin's")

    for k in ("cam", "tgt", "valid"):
        require(np.array_equal(rg[k], rc[k]), f"view {v}: {k} tables differ")
    d_err = float(np.abs(rg["depths"] - rc["depths"]).max())
    log(f"[facade] view {v}: same tables; depths max abs diff card vs CPU "
        f"{d_err:.3e}")
    require(np.array_equal(rg["depths"], rc["depths"]),
            f"view {v}: depths differ between the card and the CPU")
    want = rc["conf"]
    flip = np.abs(rg["conf"] - want) > SCORE_ATOL + SCORE_RTOL * np.abs(want)
    n_scored = int((want > 0).sum())
    flip_rows = set(np.nonzero(flip.any(axis=1))[0].tolist())
    n_same, ties, flipped, bad = _compare_best(bg, bc, rg, rc, flip_rows)
    log(f"[facade] view {v}: {int(flip.sum())} of {n_scored} scored slots "
        f"outside the scoring tolerance; best matches {n_same} identical, "
        f"{len(ties)} near-ties {ties[:3]}, {len(flipped)} in a row with "
        f"such a slot {flipped[:5]}, {len(bad)} differ {bad[:5]}")
    require(int(flip.sum()) <= SCORE_FLIP_MAX * max(n_scored, 1),
            f"view {v}: scoring kernel disagrees with its twin")
    require(not bad, f"view {v}: best matches differ on equal tables")
    return n_syncs


def _compare_best(bg, bc, rg, rc, flip_rows):
    """Best-match keys of one view on the card (g) and on the CPU (c).

    A key is the same target, a near-tie (the two best confidences within
    the scoring tolerance of each other), or in one of `flip_rows`, whose
    tables hold a slot where kernel and twin part beyond the tolerance.
    Anything else is a disagreement.  Returns (n_same, ties, flipped,
    bad)."""
    def table(b, r):
        out = {}
        for s, tv, ts in zip(b["seg"], b["tgt_view"], b["tgt_seg"]):
            keep = r["valid"][s] & (r["conf"][s] > 1.0)
            out[int(s)] = ((int(tv), int(ts)), float(r["conf"][s][keep].max()))
        return out
    g, c = table(bg, rg), table(bc, rc)
    n_same, ties, flipped, bad = 0, [], [], []
    for s in sorted(set(g) | set(c)):
        if s in g and s in c and g[s][0] == c[s][0]:
            n_same += 1
            continue
        cg = g[s][1] if s in g else 1.0      # absent: at most the threshold
        cc = c[s][1] if s in c else 1.0
        row = (s, g.get(s, (None,))[0], c.get(s, (None,))[0], round(cg, 6),
               round(cc, 6))
        if abs(cg - cc) <= SCORE_ATOL + SCORE_RTOL * abs(cc):
            ties.append(row)
        elif s in flip_rows:
            flipped.append(row)
        else:
            bad.append(row)
    return n_same, ties, flipped, bad


# phase multiproc: the facade over max(2, cards) ranks over gloo on
# 127.0.0.1, rank r on cuda:{r % cards} (two ranks share the card of a
# one-card machine).  The script starts itself once per rank with this
# variable set to "kind,port,rank,ranks,outdir" (kind: the phase,
# multiproc, scale or scalefit); a rank that fails, hangs past
# MULTIPROC_TIMEOUT_S or writes another model fails the phase.
MULTIPROC_ENV = "L3D_CHIP_SMOKE_RANK"
MULTIPROC_MIN_RANKS = 2
MULTIPROC_TIMEOUT_S = 300


@contextlib.contextmanager
def _shares(sizes):
    """Record in sizes[name] this rank's share at each split device form of
    the cluster stage: the rows of every diffusion dot (`_edge_dot`), the
    clusters of every refinement block (`_refine_lines_t`) and of every
    BA solve (`_bundle`)."""
    from line3d_tpu_torch.cluster import diffusion_device
    from line3d_tpu_torch.fit import bundle, refine
    sites = ((diffusion_device, "_edge_dot", lambda a, out: out.K),
             (refine, "_refine_lines_t", lambda a, out: int(a[0].shape[0])),
             (bundle, "_bundle", lambda a, out: int(a[0].shape[0])))
    calls = {name: [] for _, name, _ in sites}
    with contextlib.ExitStack() as stack:
        for module, name, _ in sites:
            stack.enter_context(spy(module, name, calls[name]))
        yield
    for _, name, size in sites:
        sizes[name] = [size(a, out) for a, _, out in calls[name]]


def multiproc_rank(spec: str) -> int:
    """One rank of phase multiproc: the facade exact run (one cold, one
    counted warm run) and the capped run (capacity_probe=False, whose
    overflowing views their owners re-match), on this rank's card.  Writes
    each model's TXT, the rank's K4 pair lists and its figures to the
    output directory."""
    import torch
    import torch.distributed as dist
    from line3d_tpu_torch import Line3D, L3DConfig
    from line3d_tpu_torch.cluster import affinity
    from line3d_tpu_torch.match import collinearity, engine
    from line3d_tpu_torch.parallel import multihost
    from line3d_tpu_torch.utils.demo import make_facade_scene
    port, rank, nproc, outdir = spec.split(",")
    rank, nproc = int(rank), int(nproc)
    require(multihost.initialize(f"127.0.0.1:{port}", nproc, rank,
                                 timeout_s=MULTIPROC_TIMEOUT_S),
            "multiproc: no process group")
    tag = f"multiproc rank {rank}"
    cfg = L3DConfig()
    scene, cams = make_facade_scene(num_views=25, config=cfg)
    dev = scene.device
    V = scene.num_views
    lo, hi = multihost.my_view_range(V, rank, nproc)
    log(f"[{tag}] {torch.cuda.get_device_name(dev)} as {dev} "
        f"({torch.cuda.device_count()} card(s)); views [{lo}, {hi}) of {V}")
    require(dev == torch.device("cuda", rank % torch.cuda.device_count()),
            f"{tag}: Line3D's card is {dev}")

    def runner(c, sc=scene):
        def run():
            l3d = feed(Line3D(config=c), sc, cams)
            t0 = time.perf_counter()
            l3d.compute_3d_model()
            torch.cuda.synchronize(dev)
            return l3d, time.perf_counter() - t0
        return run

    out = dict(rank=rank, lo=lo, hi=hi, device=str(dev))
    l3d, out["cold"] = runner(cfg)()
    sweeps = []
    torch.cuda.reset_peak_memory_stats(dev)
    with spy(collinearity, "collinearity_compact_all", []) as k4calls, \
            spy(affinity, "_finalize_candidates", sweeps):
        (l3d, out["warm"]), out["counts"] = _counted(runner(cfg), tag)
    out["peak"] = torch.cuda.max_memory_allocated(dev)
    st = l3d.stats
    stage_bytes = {k: st["gathered_by_stage"][k]
                   for k in ("collinearity", "matching", "affinity")}
    # the affinity stage gathers the other ranks' float64 weights of the
    # kept candidates; the whole stream's sweep would gather these bytes
    n_all = st["affinity_candidates"]
    a_lo, a_hi = multihost.local_range(n_all)
    out.update(t_match=st["t_match"], t_collin=st["t_collin"],
               gathered_bytes=st["gathered_bytes"], stage_bytes=stage_bytes,
               sweep_candidates=len(sweeps[-1][0][1]) if sweeps else 0,
               views_local=st["views_local"], lines=st["num_lines"],
               affinity_candidates=n_all,
               affinity_kept=st["affinity_kept"],
               affinity_whole_stream_bytes=8 * (n_all - (a_hi - a_lo)),
               t_affinity_enum=st["t_affinity_enum"])
    log(f"[{tag}] exact: cold {out['cold']:.3f} s, warm {out['warm']:.3f} s"
        f" (t_collin {st['t_collin']:.3f}, t_match {st['t_match']:.3f}, "
        f"t_cluster {st['t_cluster']:.3f}, t_affinity_enum "
        f"{st['t_affinity_enum']:.3f} s for {st['affinity_candidates']} "
        f"candidates), {st['num_lines']} lines; peak device memory of this "
        f"process {out['peak']} B; "
        f"received {st['gathered_bytes']} bytes from the other ranks, by "
        f"stage {stage_bytes} (the weight sweep split over "
        f"{out['sweep_candidates']} kept candidates of {n_all}: the "
        f"affinity stage gathered {stage_bytes['affinity']} B where the "
        f"whole stream's sweep would gather "
        f"{out['affinity_whole_stream_bytes']} B); launches {out['counts']}")
    require(st["num_processes"] == nproc and st["views_local"] == hi - lo,
            f"{tag}: stats do not show the rank's share")
    require(out["counts"]["pair_valid"] == hi - lo and
            out["counts"]["score"] == hi - lo,
            f"{tag}: K1 or the scoring kernel ran for other views than "
            f"its own {hi - lo}")
    pairs, w, count = (x.cpu().numpy() for x in k4calls[0][2])
    np.savez(os.path.join(outdir, f"k4_{rank}.npz"), pairs=pairs, w=w,
             count=count)
    with open(os.path.join(outdir, f"exact_{rank}.txt"), "w") as f:
        f.write(_txt_text(l3d))

    cfg_b = L3DConfig(capacity_probe=False)
    with spy(engine, "rematch_views_exact", []) as rcalls:
        (l3d, out["capped_s"]), out["counts_capped"] = _counted(
            runner(cfg_b), tag)
    mine = [v for v in rcalls[-1][0][4] if lo <= v < hi] if rcalls else []
    st = l3d.stats
    out.update(capped_rematched=st["views_rematched_uncapped"],
               capped_rematched_local=len(mine),
               capped_gathered_bytes=st["gathered_bytes"])
    log(f"[{tag}] capped (capacity_probe=False): {out['capped_s']:.3f} s, "
        f"overflow {st['match_overflow']}, {st['views_rematched_uncapped']} "
        f"views re-matched, {len(mine)} of them here {mine}; received "
        f"{st['gathered_bytes']} bytes; launches {out['counts_capped']}")
    require(st["views_rematched_uncapped"] > 0 and
            out["counts_capped"]["pair_valid"] == hi - lo + len(mine),
            f"{tag}: the owners did not re-match the overflowing views")
    with open(os.path.join(outdir, f"capped_{rank}.txt"), "w") as f:
        f.write(_txt_text(l3d))

    # the cluster stage split across the ranks: phase facaded's and phase
    # facadeba's configurations
    for run_tag, kw, n_runs in (
            ("c", dict(perform_diffusion=True, refine_lines=True), 2),
            ("d", dict(perform_diffusion=True, diffusion_mode="true",
                       fh_backend="parallel", bundle_adjust_cameras=True),
             1)):
        c = L3DConfig(**kw)
        sc, _ = make_facade_scene(num_views=25, config=c)
        for i in range(n_runs):
            shares = {}
            with _shares(shares):
                (l3d, secs), counts = _counted(runner(c, sc), tag)
        st = l3d.stats
        rec = dict(seconds=secs, counts=counts, shares=shares,
                   edges=st["num_edges"], lines=st["num_lines"],
                   gathered_by_stage=st["gathered_by_stage"],
                   **{k: st[k] for k in ("t_diffusion", "t_fh", "t_fit",
                                         "t_cluster", "t_match")})
        out[run_tag] = rec
        log(f"[{tag}] ({run_tag}) {kw}: {'warm' if n_runs > 1 else 'one'} "
            f"run {secs:.3f} s (t_diffusion {st['t_diffusion']:.3f}, t_fh "
            f"{st['t_fh']:.3f}, t_fit {st['t_fit']:.3f}, t_cluster "
            f"{st['t_cluster']:.3f} s), {st['num_lines']} lines; this "
            f"rank's dot rows {shares['_edge_dot']} of {st['num_edges']} "
            f"edges, refinement blocks {shares['_refine_lines_t']}, BA "
            f"clusters {shares['_bundle']}; received by stage "
            f"{st['gathered_by_stage']}")
        elo, ehi = multihost.local_range(st["num_edges"])
        require(shares["_edge_dot"] == [ehi - elo],
                f"{tag} ({run_tag}): the diffusion dot is not this rank's "
                f"edge range [{elo}, {ehi})")
        with open(os.path.join(outdir, f"{run_tag}_{rank}.txt"), "w") as f:
            f.write(_txt_text(l3d))
        if l3d.refined_poses is not None:
            np.savez(os.path.join(outdir, f"poses_{rank}.npz"),
                     R=l3d.refined_poses[0], t=l3d.refined_poses[1])
    with open(os.path.join(outdir, f"rank_{rank}.json"), "w") as f:
        json.dump(out, f)
    dist.destroy_process_group()
    return 0


def _run_ranks(kind: str, n_ranks: int, outdir: str) -> float:
    """Start this script once per rank of phase `kind` (MULTIPROC_ENV set to
    "kind,port,rank,ranks,outdir", each rank's output in outdir/log_r.txt),
    wait for all (MULTIPROC_TIMEOUT_S in all), kill what is left and print
    the ranks' `[kind` lines (every line of a rank that failed); fails
    unless every rank exited 0.  Returns the wall seconds."""
    import socket
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    here = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    procs, logs = [], []
    for r in range(n_ranks):
        env = dict(os.environ)
        env[MULTIPROC_ENV] = f"{kind},{port},{r},{n_ranks},{outdir}"
        logs.append(os.path.join(outdir, f"log_{r}.txt"))
        with open(logs[-1], "w") as f:
            procs.append(subprocess.Popen(
                [sys.executable, os.path.abspath(__file__)], cwd=here,
                env=env, stdout=f, stderr=subprocess.STDOUT))
    hung = False
    try:
        for p in procs:
            p.wait(timeout=max(1.0, t0 + MULTIPROC_TIMEOUT_S
                               - time.perf_counter()))
    except subprocess.TimeoutExpired:
        hung = True
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    wall = time.perf_counter() - t0
    for r, (p, path) in enumerate(zip(procs, logs)):
        with open(path) as f:
            for ln in f.read().splitlines():
                if ln.startswith(f"[{kind}") or p.returncode:
                    log(f"[{kind}]   rank {r}: {ln}")
    require(not hung, f"{kind}: a rank hung past {MULTIPROC_TIMEOUT_S} s")
    for r, p in enumerate(procs):
        require(p.returncode == 0, f"{kind}: rank {r} failed "
                f"({p.returncode})")
    return wall


def phase_multiproc(card, fa, fd, fb):
    """The facade over max(MULTIPROC_MIN_RANKS, cards) processes (phase 15
    of the module docstring): each rank's model must be phase facade's TXT
    byte for byte, exact and capped, and its K4 lists the single launch's
    rows; with the cluster stage split, phase facaded's (c) and phase
    facadeba's (d) TXT, (d)'s poses phase facadeba's, and each rank's
    shares its own."""
    import torch
    from line3d_tpu_torch import L3DConfig
    from line3d_tpu_torch.match import collinearity
    from line3d_tpu_torch.parallel import multihost
    from line3d_tpu_torch.utils.demo import make_facade_scene
    n_ranks = max(MULTIPROC_MIN_RANKS, torch.cuda.device_count())
    with tempfile.TemporaryDirectory() as outdir:
        wall = _run_ranks("multiproc", n_ranks, outdir)
        ranks = []
        for r in range(n_ranks):
            with open(os.path.join(outdir, f"rank_{r}.json")) as f:
                ranks.append(json.load(f))
            for kind, want, phase in (("exact", fa, "facade"),
                                      ("capped", fa, "facade"),
                                      ("c", fd, "facaded"),
                                      ("d", fb, "facadeba")):
                with open(os.path.join(outdir, f"{kind}_{r}.txt")) as f:
                    require(f.read() == want["txt"], f"multiproc: rank {r}'s "
                            f"{kind} model differs from phase {phase}'s")
            poses = np.load(os.path.join(outdir, f"poses_{r}.npz"))
            require(np.array_equal(poses["R"], fb["poses"][0]) and
                    np.array_equal(poses["t"], fb["poses"][1]),
                    f"multiproc: rank {r}'s refined poses differ from phase "
                    f"facadeba's")
            ranks[r]["k4"] = dict(np.load(os.path.join(outdir,
                                                       f"k4_{r}.npz")))
    # each rank's refinement blocks and BA clusters: its own whole blocks
    # of the clusters all ranks solved together
    from line3d_tpu_torch.fit import refine
    for run_tag, site in (("c", "_refine_lines_t"), ("d", "_bundle")):
        sizes = [r[run_tag]["shares"][site] for r in ranks]
        C = sum(map(sum, sizes))
        blk = refine.block_size(C)
        for r, got in zip(ranks, sizes):
            b0, b1 = multihost.my_view_range(-(-C // blk), r["rank"],
                                             n_ranks)
            mine = [min(blk, C - b * blk) for b in range(b0, b1)]
            want = mine if site == "_refine_lines_t" else \
                [sum(mine)]
            require(got == want, f"multiproc: rank {r['rank']}'s ({run_tag}) "
                    f"{site} shares {got}, not its blocks {want} of {C}")
    # each rank's K4 lists against one launch over all 25 views
    cfg = L3DConfig()
    scene, _ = make_facade_scene(num_views=25, config=cfg)
    one = [x.cpu().numpy() for x in collinearity.collinearity_compact_all(
        scene.segments_t, scene.seg_mask_t,
        np.float32(cfg.collinearity_sigma * cfg.collinearity_sigma),
        quota=cfg.collinearity_block_quota,
        pairs_per_seg=cfg.collinearity_pairs_per_seg,
        aff_threshold=cfg.collinearity_aff_threshold)]
    torch.cuda.synchronize()
    n_pairs = 0
    for r in ranks:
        sl = slice(r["lo"], r["hi"])
        same = all(np.array_equal(r["k4"][k], x[sl])
                   for k, x in zip(("pairs", "w", "count"), one))
        n_pairs += int((r["k4"]["pairs"] >= 0).sum())
        require(same, f"multiproc: rank {r['rank']}'s K4 lists differ from "
                f"the single launch's rows [{r['lo']}, {r['hi']})")
    log(f"[multiproc] {n_ranks} ranks in {wall:.1f} s wall (each "
        f"process from its start: CUDA, the scene, a cold, a warm and a "
        f"capped run): every rank's TXT equal phase facade's byte for byte, "
        f"exact and capped; the ranks' K4 lists ({n_pairs} pairs) equal "
        f"the single launch's rows; per rank (views, warm s, t_match s, "
        f"bytes received): "
        + "; ".join(f"{r['device']} [{r['lo']}, {r['hi']}) {r['warm']:.3f}"
                    f" {r['t_match']:.3f} {r['gathered_bytes']} "
                    f"{r['stage_bytes']}" for r in ranks)
        + f"; phase facade's warm seconds {fa['warm']} on {card}")
    log("[multiproc] the affinity stage's gathered bytes per rank, the "
        "kept candidates' weights against the whole stream's (the kept "
        "and all candidates): "
        + "; ".join(f"{r['stage_bytes']['affinity']} / "
                    f"{r['affinity_whole_stream_bytes']} B "
                    f"({r['affinity_kept']} / {r['affinity_candidates']})"
                    for r in ranks))
    log(f"[multiproc] cluster stage split over {n_ranks} ranks: (c) "
        f"facaded's and (d) facadeba's TXT byte for byte on every rank, "
        f"(d)'s poses bit for bit; per rank ((c) warm s, t_diffusion, t_fit;"
        f" (d) s, t_diffusion, t_fit; dot rows, refinement blocks, BA "
        f"clusters; bytes received (c) diffusion + fit, (d) diffusion + "
        f"fit): "
        + "; ".join(
            f"{r['device']} {r['c']['seconds']:.3f} "
            f"{r['c']['t_diffusion']:.3f} {r['c']['t_fit']:.3f}, "
            f"{r['d']['seconds']:.3f} {r['d']['t_diffusion']:.3f} "
            f"{r['d']['t_fit']:.3f}, {r['c']['shares']['_edge_dot']} "
            f"{r['c']['shares']['_refine_lines_t']} "
            f"{r['d']['shares']['_bundle']}, "
            f"{r['c']['gathered_by_stage']['diffusion']} + "
            f"{r['c']['gathered_by_stage']['fit']}, "
            f"{r['d']['gathered_by_stage']['diffusion']} + "
            f"{r['d']['gathered_by_stage']['fit']}" for r in ranks)
        + f"; one process (phases facaded / facadeba): t_diffusion "
        f"{fd['stats']['t_diffusion']:.3f} / {fb['stats']['t_diffusion']:.3f}"
        f", t_fit {fd['stats']['t_fit']:.3f} / {fb['stats']['t_fit']:.3f} s"
        f" on {card}")
    for r in ranks:
        del r["k4"]
    return dict(wall=wall, ranks=ranks)


# phase scale: the facade at SCALE_VIEWS views (S = SCALE_S), exact; the
# kernels held at SCALE_HELD_VIEWS' shapes; the same model over
# max(MULTIPROC_MIN_RANKS, cards) ranks
SCALE_VIEWS, SCALE_S = 256, 1408
SCALE_HELD_VIEWS = (0, 128, 255)


def _scale_run(cfg, scene, cams, dev=None):
    """(Line3D, seconds) of one exact model of the scale scene on the card,
    the run ending in a synchronize."""
    import torch
    from line3d_tpu_torch import Line3D
    l3d = feed(Line3D(config=cfg), scene, cams)
    t0 = time.perf_counter()
    l3d.compute_3d_model()
    torch.cuda.synchronize(dev)
    return l3d, time.perf_counter() - t0


def _scale_exact(st, tag):
    """The exactness fields of a scale run; fails unless the model is
    exact (no match overflow left, every view the collinearity's first
    pass dropped pairs of re-run at exact capacity) and has lines."""
    ex = {k: st[k] for k in ("match_overflow", "views_rematched_uncapped",
                             "probe_m_total", "collinearity_overflow",
                             "views_recollin_exact")}
    require(st["match_overflow"] == 0 or st["views_rematched_uncapped"] > 0,
            f"{tag}: match overflow left")
    require((st["collinearity_overflow"] == 0) ==
            (st["views_recollin_exact"] == 0),
            f"{tag}: collinear pairs dropped and not re-run")
    require(st["num_lines"] > 0, f"{tag}: no lines")
    return ex


def scale_rank(spec: str) -> int:
    """One rank of phase scale: one exact model of the scale scene on this
    rank's card; writes its TXT and its figures to the output directory."""
    import torch
    import torch.distributed as dist
    from line3d_tpu_torch import L3DConfig
    from line3d_tpu_torch.parallel import multihost
    from line3d_tpu_torch.utils.demo import make_facade_scene
    port, rank, nproc, outdir = spec.split(",")
    rank, nproc = int(rank), int(nproc)
    require(multihost.initialize(f"127.0.0.1:{port}", nproc, rank,
                                 timeout_s=MULTIPROC_TIMEOUT_S),
            "scale: no process group")
    tag = f"scale rank {rank}"
    cfg = L3DConfig()
    scene, cams = make_facade_scene(num_views=SCALE_VIEWS, config=cfg)
    lo, hi = multihost.my_view_range(SCALE_VIEWS, rank, nproc)
    torch.cuda.reset_peak_memory_stats(scene.device)
    (l3d, secs), counts = _counted(
        lambda: _scale_run(cfg, scene, cams, scene.device), tag)
    peak = torch.cuda.max_memory_allocated(scene.device)
    st = l3d.stats
    ex = _scale_exact(st, tag)
    require(counts["pair_valid"] == counts["score"] == hi - lo ==
            st["views_local"], f"{tag}: K1 or the scoring kernel ran for "
            f"other views than its own {hi - lo}")
    out = dict(rank=rank, lo=lo, hi=hi, device=str(scene.device),
               seconds=secs, counts=counts, lines=st["num_lines"],
               gathered_by_stage=st["gathered_by_stage"], peak=peak, **ex,
               **{k: st[k] for k in ("t_collin", "t_match", "t_affinity",
                                     "t_affinity_enum", "affinity_candidates",
                                     "t_fh", "t_fit", "t_cluster")})
    log(f"[{tag}] views [{lo}, {hi}) on {scene.device}: one run (cold) "
        f"{secs:.3f} s (t_collin {st['t_collin']:.3f}, t_match "
        f"{st['t_match']:.3f}, t_cluster {st['t_cluster']:.3f}, "
        f"t_affinity_enum {st['t_affinity_enum']:.3f} s for "
        f"{st['affinity_candidates']} candidates), {st['num_lines']} lines; "
        f"peak device memory of this process {peak} B; received by stage "
        f"{st['gathered_by_stage']}")
    with open(os.path.join(outdir, f"scale_{rank}.txt"), "w") as f:
        f.write(_txt_text(l3d))
    with open(os.path.join(outdir, f"rank_{rank}.json"), "w") as f:
        json.dump(out, f)
    dist.destroy_process_group()
    return 0


def phase_scale(card):
    """The facade at SCALE_VIEWS views (phase 16 of the module docstring):
    (a) one cold and one counted warm exact run in this process, (b) K1,
    the scoring kernel and K4 against their twins at that run's shapes,
    (c) the same model over max(MULTIPROC_MIN_RANKS, cards) ranks, every
    rank's TXT (a)'s byte for byte."""
    import torch
    from line3d_tpu_torch import L3DConfig
    from line3d_tpu_torch.utils.demo import make_facade_scene
    cfg = L3DConfig()
    t0 = time.perf_counter()
    scene, cams = make_facade_scene(num_views=SCALE_VIEWS, config=cfg)
    V, S = scene.num_views, scene.max_segments
    require(S == SCALE_S, f"scale: S = {S}, not {SCALE_S}")
    log(f"[scale] the facade at {V} views, S = {S}, built in "
        f"{time.perf_counter() - t0:.2f} s")
    torch.cuda.reset_peak_memory_stats()
    l3d, cold = _scale_run(cfg, scene, cams)
    (l3d, warm), counts = _counted(lambda: _scale_run(cfg, scene, cams),
                                   "scale")
    st = l3d.stats
    ex = _scale_exact(st, "scale")
    require(counts["pair_valid"] == counts["score"] == V,
            f"scale: K1 or the scoring kernel did not run once a view")
    mt, mc = np.unique(st["m_total"], return_counts=True)
    peak = torch.cuda.max_memory_allocated()
    log(f"[scale] cold {cold:.3f} s, warm {warm:.3f} s = {V / warm:.2f} "
        f"images/s on {card} (t_collin {st['t_collin']:.3f}, t_match "
        f"{st['t_match']:.3f}, t_affinity {st['t_affinity']:.3f} of which "
        f"t_affinity_enum {st['t_affinity_enum']:.3f} for "
        f"{st['affinity_candidates']} candidates, t_fh {st['t_fh']:.3f}, "
        f"t_fit {st['t_fit']:.3f} s); {st['num_lines']} "
        f"lines, {st['num_edges']} edges; m_total per view "
        f"{dict(zip(mt.tolist(), mc.tolist()))}; exactness {ex}; peak "
        f"device memory {peak} B")
    txt = _txt_text(l3d)
    t1 = time.perf_counter()
    held = _check_path_kernels(l3d, "scale", views=SCALE_HELD_VIEWS)
    t_held = time.perf_counter() - t1
    n_ranks = max(MULTIPROC_MIN_RANKS, torch.cuda.device_count())
    with tempfile.TemporaryDirectory() as outdir:
        wall = _run_ranks("scale", n_ranks, outdir)
        ranks = []
        for r in range(n_ranks):
            with open(os.path.join(outdir, f"rank_{r}.json")) as f:
                ranks.append(json.load(f))
            with open(os.path.join(outdir, f"scale_{r}.txt")) as f:
                require(f.read() == txt, f"scale: rank {r}'s model differs "
                        f"from the one-process model")
    log(f"[scale] kernels held at the run's shapes in {t_held:.1f} s; "
        f"{n_ranks} ranks in {wall:.1f} s wall: every rank's TXT equal the "
        f"one-process TXT byte for byte; per rank (views, s, t_match, "
        f"t_cluster, launches): "
        + "; ".join(f"{r['device']} [{r['lo']}, {r['hi']}) "
                    f"{r['seconds']:.3f} {r['t_match']:.3f} "
                    f"{r['t_cluster']:.3f} {r['counts']}" for r in ranks))
    return dict(cold=cold, warm=warm, counts=counts, exact=ex, held=held,
                peak=peak, lines=st["num_lines"], ranks=ranks, wall=wall)


# phase cudatests: the `cuda`-marked tests run on the card, in a process of
# their own (tests/conftest.py imports JAX, which that machine lacks; hence
# --noconftest).  On one card 48 pass and one skips,
# test_pair_valid_kernel_on_second_card, which needs two cards.
CUDA_TESTS = ["tests/test_torch_kernels_cuda.py", "-q", "-m", "cuda",
              "--noconftest", "-p", "no:cacheprovider"]
CUDA_TESTS_PASSED = 48            # on one card; one more on two or more
CUDA_TESTS_TIMEOUT_S = 600


def phase_cudatests():
    """The `cuda` tests on the card (phase 19 of the module docstring):
    fails unless pytest exits 0 and at least CUDA_TESTS_PASSED pass (one
    more where a second card lets the two-card test run)."""
    import re
    import torch
    here = os.path.dirname(os.path.abspath(__file__))
    proc = subprocess.run([sys.executable, "-m", "pytest", *CUDA_TESTS],
                          cwd=here, capture_output=True, text=True,
                          timeout=CUDA_TESTS_TIMEOUT_S)
    lines = proc.stdout.strip().splitlines()
    counts = {k: int(n) for n, k in re.findall(
        r"(\d+) (passed|skipped|failed|errors?|deselected)",
        lines[-1] if lines else "")}
    want = CUDA_TESTS_PASSED + (torch.cuda.device_count() >= 2)
    log(f"[cudatests] python -m pytest {' '.join(CUDA_TESTS)}: rc "
        f"{proc.returncode}, passed {counts.get('passed', 0)}, skipped "
        f"{counts.get('skipped', 0)}, failed {counts.get('failed', 0)}, "
        f"errors {counts.get('errors', counts.get('error', 0))} (at least "
        f"{want} must pass)")
    if proc.returncode:
        for ln in lines[-80:] + proc.stderr.strip().splitlines()[-20:]:
            log(f"[cudatests]   {ln}")
    require(proc.returncode == 0, f"cudatests: pytest exited "
            f"{proc.returncode}")
    require(counts.get("passed", 0) >= want,
            f"cudatests: {counts.get('passed', 0)} passed, not {want}")
    return counts


# phase scalefit: phases facaded's and facadeba's configurations at
# SCALE_VIEWS views, then the refinement alone at the JAX script's
# 1000-view cluster count, the float64 host on its first
# REFINE_BENCH_HOST clusters
SCALEFIT_CONFIGS = ("facaded", "facadeba")
REFINE_BENCH_CLUSTERS, REFINE_BENCH_HOST = 173_000, 20_000


def _scalefit_models(tag, dev=None):
    """For each configuration of SCALEFIT_CONFIGS: (the facade at
    SCALE_VIEWS views in it, its config)."""
    from line3d_tpu_torch.utils import scale_exact_profile as sep
    out = {}
    for name in SCALEFIT_CONFIGS:
        cfg = sep.make_config(name)
        scene, cams = sep.make_scene(SCALE_VIEWS, "facade", cfg,
                                     dev or "cuda")
        require(scene.max_segments == SCALE_S,
                f"{tag}: S = {scene.max_segments}, not {SCALE_S}")
        out[name] = (cfg, scene, cams)
    return out


def scalefit_rank(spec: str) -> int:
    """One rank of phase scalefit: one model of the scale facade in each
    configuration of SCALEFIT_CONFIGS on this rank's card; writes the TXTs,
    the poses and its figures to the output directory."""
    import torch.distributed as dist
    from line3d_tpu_torch.parallel import multihost
    from line3d_tpu_torch.utils import scale_exact_profile as sep
    port, rank, nproc, outdir = spec.split(",")
    rank, nproc = int(rank), int(nproc)
    require(multihost.initialize(f"127.0.0.1:{port}", nproc, rank,
                                 timeout_s=MULTIPROC_TIMEOUT_S),
            "scalefit: no process group")
    tag = f"scalefit rank {rank}"
    out = dict(rank=rank)
    for name, (cfg, scene, cams) in _scalefit_models(tag).items():
        (secs, l3d, _, members), counts = _counted(
            lambda: sep.run_once(cfg, scene, cams, 0.0, scene.device), tag)
        st = l3d.stats
        out[name] = dict(seconds=secs, counts=counts, device=str(scene.device),
                         gathered_by_stage=st["gathered_by_stage"],
                         **{k: st[k] for k in ("t_match", "t_diffusion",
                                               "t_fh", "t_fit")})
        log(f"[{tag}] {name} on {scene.device}: one run {secs:.3f} s "
            f"(t_diffusion {st['t_diffusion']:.3f}, t_fit {st['t_fit']:.3f}"
            f" s), {st['num_lines']} lines; received by stage "
            f"{st['gathered_by_stage']}")
        with open(os.path.join(outdir, f"{name}_{rank}.txt"), "w") as f:
            f.write(_txt_text(l3d))
        if l3d.refined_poses is not None:
            with open(os.path.join(outdir, f"{name}_{rank}.poses"),
                      "wb") as f:
                f.write(sep.poses_bytes(l3d))
    with open(os.path.join(outdir, f"rank_{rank}.json"), "w") as f:
        json.dump(out, f)
    dist.destroy_process_group()
    return 0


def phase_scalefit(card):
    """The noisy-capture configurations at scale (phase 17 of the module
    docstring)."""
    import torch
    from line3d_tpu_torch.cluster import diffusion_device as dd
    from line3d_tpu_torch.fit import refine as rf
    from line3d_tpu_torch.utils import refine_bench, \
        scale_exact_profile as sep
    out = {}
    for name, (cfg, scene, cams) in _scalefit_models("scalefit").items():
        tag = f"scalefit {name}"
        torch.cuda.reset_peak_memory_stats()
        mode = cfg.diffusion_mode
        with spy(dd, f"diffuse_{mode}_device", []) as dcalls, \
                spy(rf, "refine_lines_device", []) as rcalls:
            cold, l3d, _, members = sep.run_once(cfg, scene, cams, 0.0,
                                                 "cuda")
            txt = _txt_text(l3d)
            poses = sep.poses_bytes(l3d)
            (warm, l3d_w, _, _), counts = _counted(
                lambda: sep.run_once(cfg, scene, cams, 1e-3, "cuda"), tag)
        st = l3d_w.stats
        require(st["match_overflow"] == 0 and st["num_lines"] > 0,
                f"{tag}: overflow left or no lines")
        require(counts["pair_valid"] == counts["score"] == SCALE_VIEWS,
                f"{tag}: K1 or the scoring kernel did not run once a view")
        ms = sep.member_stats(members)
        peak = torch.cuda.max_memory_allocated()
        log(f"[{tag}] cold {cold:.3f} s, warm {warm:.3f} s on {card} "
            f"(t_match {st['t_match']:.3f}, t_diffusion "
            f"{st['t_diffusion']:.3f}, t_fh {st['t_fh']:.3f}, t_fit "
            f"{st['t_fit']:.3f} s); {st['num_lines']} lines, "
            f"{st['num_edges']} edges; clusters fitted and members {ms}; "
            f"peak device memory {peak} B")
        # the float64 host's reference mode takes ~300 s at 9.1 M edges on
        # the card's machine: phase facaded holds that mode at 25 views
        _hold_diffusion(dcalls[-1:], mode, tag, host=mode == "true")
        rec = dict(cold=cold, warm=warm, counts=counts, members=ms,
                   peak=peak, txt=txt, poses=poses, lines=st["num_lines"],
                   **{k: st[k] for k in ("t_match", "t_diffusion", "t_fh",
                                         "t_fit")})
        if rcalls:
            rec["refine"] = _hold_refine(rcalls[-1], tag)
        else:
            R, _ = l3d_w.refined_poses
            orth = float(np.abs(np.einsum("vij,vkj->vik", R, R)
                                - np.eye(3)).max())
            log(f"[{tag}] BA rms {st['ba_rms_before']:.4f} -> "
                f"{st['ba_rms_after']:.4f} px; max |R R^T - I| {orth:.2e}")
            require(st["ba_rms_after"] <= st["ba_rms_before"] + 1e-6 and
                    R.shape == (SCALE_VIEWS, 3, 3) and orth < 1e-5,
                    f"{tag}: BA made the rms worse or its poses are not "
                    f"orthonormal")
            rec["ba_rms"] = [st["ba_rms_before"], st["ba_rms_after"]]
        out[name] = rec
    n_ranks = max(MULTIPROC_MIN_RANKS, torch.cuda.device_count())
    with tempfile.TemporaryDirectory() as outdir:
        wall = _run_ranks("scalefit", n_ranks, outdir)
        ranks = []
        for r in range(n_ranks):
            with open(os.path.join(outdir, f"rank_{r}.json")) as f:
                ranks.append(json.load(f))
            for name in SCALEFIT_CONFIGS:
                with open(os.path.join(outdir, f"{name}_{r}.txt")) as f:
                    require(f.read() == out[name]["txt"], f"scalefit: rank "
                            f"{r}'s {name} model differs from one process's")
                if out[name]["poses"] is not None:
                    with open(os.path.join(outdir, f"{name}_{r}.poses"),
                              "rb") as f:
                        require(f.read() == out[name]["poses"],
                                f"scalefit: rank {r}'s refined poses differ "
                                f"from one process's")
    log(f"[scalefit] {n_ranks} ranks in {wall:.1f} s wall: every rank's "
        f"TXT of both configurations and its refined poses equal one "
        f"process's byte for byte; per rank (config: s, t_diffusion, "
        f"t_fit, bytes received by the fit): "
        + "; ".join(f"rank {r['rank']} " + ", ".join(
            f"{n}: {r[n]['seconds']:.3f} {r[n]['t_diffusion']:.3f} "
            f"{r[n]['t_fit']:.3f} {r[n]['gathered_by_stage']['fit']}"
            for n in SCALEFIT_CONFIGS) for r in ranks))
    rb = refine_bench.run(REFINE_BENCH_CLUSTERS, "cuda", REFINE_BENCH_HOST)
    ag = rb["agreement"]
    log(f"[scalefit] refine_bench C = {rb['C']} x M = {rb['M']} on {card} "
        f"(blocks of {rb['block']}): device cold {rb['device_cold_s']:.3f} "
        f"s, warm {rb['device_warm_s']:.3f} s, median rms "
        f"{rb['device_rms_before']:.4f} -> {rb['device_rms_after']:.4f} px;"
        f" float64 host on the first {rb['host_clusters']} clusters "
        f"{rb['host_s']:.2f} s, {rb['host_rms_before']:.4f} -> "
        f"{rb['host_rms_after']:.4f} px; agreement {ag}; peak device "
        f"memory {rb['max_memory_allocated']} B")
    require(ag["ok"], "scalefit: refine_bench's device optimum differs from "
            "the float64 host (tests/test_refine.py criteria)")
    for rec in out.values():
        del rec["txt"], rec["poses"]
    return dict(runs=out, ranks=ranks, wall=wall, refine_bench=rb)


# phase clutter: the P25 stress shape (make_demo_scene with 2,990 random
# segments a view, S = 3,072) at CLUTTER_VIEWS views, exact and capped;
# the kernels held at CLUTTER_HELD_VIEWS' shapes
CLUTTER_VIEWS = 100
CLUTTER_HELD_VIEWS = (0, 50, 99)


def phase_clutter(card):
    """The clutter shape past 25 views (phase 18 of the module docstring):
    one exact and one capped (uncapped_fallback=False) model of
    make_demo_scene(CLUTTER_VIEWS, 2990), each counted, and K1, the
    scoring kernel and K4 against their twins at each run's shapes."""
    import torch
    from line3d_tpu_torch.utils import scale_exact_profile as sep
    out = {}
    for capped in (False, True):
        tag = f"clutter {'capped' if capped else 'exact'}"
        cfg = sep.make_config("exact", capped)
        t0 = time.perf_counter()
        scene, cams = sep.make_scene(CLUTTER_VIEWS, "clutter", cfg, "cuda")
        t_build = time.perf_counter() - t0
        torch.cuda.reset_peak_memory_stats()
        (secs, l3d, _, _), counts = _counted(
            lambda: sep.run_once(cfg, scene, cams, 0.0, "cuda"), tag,
            wide=not capped)
        st = l3d.stats
        mt, mc = np.unique(st["m_total"], return_counts=True)
        peak = torch.cuda.max_memory_allocated()
        log(f"[{tag}] make_demo_scene({CLUTTER_VIEWS}, 2990) built in "
            f"{t_build:.2f} s (S {scene.max_segments}); one run {secs:.3f} "
            f"s on {card} (t_collin {st['t_collin']:.3f}, t_match "
            f"{st['t_match']:.3f}, t_cluster {st['t_cluster']:.3f}, "
            f"t_affinity_enum {st['t_affinity_enum']:.3f} s for "
            f"{st['affinity_candidates']} candidates); "
            f"{st['num_lines']} lines; match_overflow "
            f"{st['match_overflow']}, views re-matched "
            f"{st['views_rematched_uncapped']}, m_total per view "
            f"{dict(zip(mt.tolist(), mc.tolist()))}; launches {counts}; "
            f"peak device memory {peak} B")
        require(scene.max_segments == 3072 and st["num_lines"] > 0,
                f"{tag}: not the S = 3,072 shape, or no model")
        if capped:
            require(st["match_overflow"] > 0 and
                    st["views_rematched_uncapped"] == 0 and
                    set(st["m_total"]) == {256} and
                    counts["score_wide"] == 0,
                    f"{tag}: not a capped pass at m_total 256")
        else:
            _scale_exact(st, tag)
        require(counts["pair_valid"] == CLUTTER_VIEWS,
                f"{tag}: K1 did not run once a view")
        held = _check_path_kernels(l3d, tag, views=CLUTTER_HELD_VIEWS,
                                   capped=capped)
        out["capped" if capped else "exact"] = dict(
            seconds=secs, counts=counts, held=held, peak=peak,
            lines=st["num_lines"], overflow=st["match_overflow"],
            m_total={int(m): int(c) for m, c in zip(mt, mc)})
    return out


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False — this "
              "script needs an NVIDIA GPU", file=sys.stderr)
        return 2
    import line3d_tpu_torch  # noqa: F401  (fails outside a checkout)
    require("jax" not in sys.modules, "JAX was imported")
    if os.environ.get(MULTIPROC_ENV):
        kind, spec = os.environ[MULTIPROC_ENV].split(",", 1)
        return dict(multiproc=multiproc_rank, scale=scale_rank,
                    scalefit=scalefit_rank)[kind](spec)

    seconds = {}

    def timed(name, fn, *a):
        t0 = time.perf_counter()
        out = fn(*a)
        seconds[name] = round(time.perf_counter() - t0, 1)
        log(f"[{name}] phase done in {seconds[name]} s")
        return out

    card, smi = timed("device", phase_device)
    timed("build", phase_build)
    k = timed("kernels", phase_kernels)
    k5 = timed("validate", phase_validate)
    k6 = timed("peak", phase_peak, smi)
    timed("house10", phase_house10)
    timed("house10d", phase_house10d)
    fa = timed("facade", phase_facade, card)
    fd = timed("facaded", phase_facade_diffusion_refine, card)
    fb = timed("facadeba", phase_facade_ba, card)
    cp = timed("capped", phase_capped, card, fa["txt"])
    sp = timed("stress", phase_stress, card)
    ss = timed("stressstages", phase_stressstages, card)
    cl = timed("cli", phase_cli, card)
    mp = timed("multiproc", phase_multiproc, card, fa, fd, fb)
    sc = timed("scale", phase_scale, card)
    sf = timed("scalefit", phase_scalefit, card)
    cu = timed("clutter", phase_clutter, card)
    ct = timed("cudatests", phase_cudatests)
    require("jax" not in sys.modules and "line3d_tpu" not in sys.modules,
            "JAX or line3d_tpu was imported")
    d2h = (fa["copies"] or {}).get("DtoH", {})
    log(f"[summary] phase seconds {seconds}; facade exact best "
        f"{fa['best']:.3f} s, with diffusion + refine best {fd['best']:.3f} "
        f"s; facade profiled run device-to-host {d2h.get('bytes')} bytes in "
        f"{d2h.get('count')} readbacks (the profiler's "
        f"{(fa['copies'] or {}).get('profiler', {}).get('DtoH')}); host "
        f"synchronisations of one exact view's step: facade "
        f"{fa['syncs']}, cli {cl['held']['selection_syncs']}; stress warm "
        f"{sp['warm']:.3f} s")

    # `launches` counts the path each kernel serves (the facade's warm run
    # for K1, K4 and the scoring kernel, the validation and peak phases
    # for K5 and K6); `launches_per_facade_run` is the warm facade run's
    # count for every kernel, `launches_capped` the counts of the capped
    # phase's runs (b) and (c), `launches_cli` those of the CLI's first
    # run, `held_at_cli_shapes` that run's comparison with the twins,
    # `launches_scale` the counts of phase scale's warm run (and of each of
    # its ranks' run), `held_at_scale_shapes` its comparison,
    # `launches_scalefit` the counts of phase scalefit's warm run of each
    # configuration (and of each of its ranks' run), `launches_clutter`
    # those of phase clutter's exact and capped runs,
    # `held_at_clutter_shapes` their comparisons, `launches_stressstages`
    # the counts of phase stressstages (its stage and quota benches) and
    # `held_at_stressstages_shapes` its comparison; the scoring kernel's
    # `stressstages_ms_m2048` is that phase's stage D less stage C at
    # m_total 2048 (CUDA events).  The affinity enumeration replaces no TPU
    # kernel (line3d_tpu enumerates on the host); its `ms` is the whole
    # call by host clock, its `plain_ms` the native walk's.  No
    # single PyTorch call computes any of these functions, so `library_ms`
    # is null throughout.
    cnt = fa["counts"]

    def held_by_kernel(held):
        views = {k: d for k, d in held.items() if k.startswith("view")}
        return dict(
            pair_valid={k: dict(S=d["S"], disagree=d["k1_disagree"])
                        for k, d in views.items()},
            score={k: {key: d[key] for key in d
                       if key in ("S", "M") or key.startswith("score_")}
                   for k, d in views.items()},
            collin_pairs=held["collin_pairs"],
            affinity_enum=held["affinity_enum"])
    held_cli, held_scale = held_by_kernel(cl["held"]), \
        held_by_kernel(sc["held"])
    held_clutter = {k: held_by_kernel(cu[k]["held"])
                    for k in ("exact", "capped")}
    held_stress = held_by_kernel(ss["held"])

    def also(key):
        return dict(launches_capped=[cp["b"]["counts"][key],
                                     cp["c"]["counts"][key]],
                    launches_stress=sp["counts"][key],
                    launches_cli=cl["counts"][key],
                    launches_reduced_facade=fa["reduced"]["counts"][key],
                    held_at_cli_shapes=held_cli[key],
                    held_at_scale_shapes=held_scale[key],
                    held_at_stressstages_shapes=held_stress[key],
                    held_at_clutter_shapes={k: h[key] for k, h in
                                            held_clutter.items()},
                    **multiproc_launches(key))

    def multiproc_launches(key):
        return dict(launches_multiproc=[r["counts"][key]
                                        for r in mp["ranks"]],
                    launches_multiproc_capped=[r["counts_capped"][key]
                                               for r in mp["ranks"]],
                    launches_scale=sc["counts"][key],
                    launches_scale_ranks=[r["counts"][key]
                                          for r in sc["ranks"]],
                    launches_scalefit={
                        n: r["counts"][key] for n, r in sf["runs"].items()},
                    launches_scalefit_ranks=[
                        {n: r[n]["counts"][key] for n in SCALEFIT_CONFIGS}
                        for r in sf["ranks"]],
                    launches_clutter={k: cu[k]["counts"][key]
                                      for k in ("exact", "capped")},
                    launches_stressstages=ss["counts"][key])
    kernels = [
        dict(name="pair_valid (K1)", route="cuda",
             source="line3d_tpu_torch/csrc/pair_valid.cu",
             replaces="line3d_tpu/match/pairwise_pallas.py:216",
             launches=cnt["pair_valid"], library_ms=None,
             launches_per_facade_run=cnt["pair_valid"], **also("pair_valid"),
             **k["pair_valid"]),
        dict(name="collin_pairs (K4)", route="cuda",
             source="line3d_tpu_torch/csrc/collin_pairs.cu",
             replaces="line3d_tpu/match/collinearity_pallas.py:35",
             launches=cnt["collin_pairs"], library_ms=None,
             launches_per_facade_run=cnt["collin_pairs"],
             **also("collin_pairs"), **k["collin_pairs"]),
        dict(name="score (K2/K3)", route="cuda",
             source="line3d_tpu_torch/csrc/scoring.cu",
             replaces="line3d_tpu/match/scoring_pallas.py:239",
             also_replaces="line3d_tpu/match/scoring_pallas.py:212",
             launches=cnt["score"], launches_m_gt_256=cnt["score_wide"],
             launches_per_facade_run=cnt["score"], library_ms=None,
             **also("score"),
             max_abs_err=max(r["max_abs_err"]
                             for r in k["score"].values()),
             **{key: k["score"][1024][key] for key in
                ("ms", "plain_ms", "bound_ms", "bound_by", "old_prep_ms")},
             at_m256=k["score"][256],
             stressstages_ms_m2048=ss["score_ms_m2048"]),
        dict(name="pair_dense (K5)", route="cuda",
             source="line3d_tpu_torch/csrc/pair_dense.cu",
             replaces="line3d_tpu/match/pairwise_pallas.py:203",
             path="validate", launches=k5["launches"],
             launches_per_facade_run=cnt["pair_dense"], library_ms=None,
             held_at_scale_shapes=None, held_at_clutter_shapes=None,
             held_at_stressstages_shapes=None,
             **multiproc_launches("pair_dense"),
             **{key: k5[key] for key in ("max_abs_err", "ms", "plain_ms",
                                         "bound_ms", "bound_by")}),
        dict(name="fma_peak (K6)", route="cuda",
             source="line3d_tpu_torch/csrc/fma_peak.cu",
             replaces="bench.py:398", path="peak",
             launches=k6["launches"],
             launches_per_facade_run=cnt["fma_peak"], library_ms=None,
             held_at_scale_shapes=None, held_at_clutter_shapes=None,
             held_at_stressstages_shapes=None,
             **multiproc_launches("fma_peak"),
             **{key: k6[key] for key in ("max_abs_err", "ms", "plain_ms",
                                         "bound_ms", "bound_by",
                                         "tflops")}),
        dict(name="affinity_enum", route="cuda",
             source="line3d_tpu_torch/csrc/affinity_enum.cu",
             replaces=None,
             plain_twin="line3d_tpu_torch/native/affinity_enum.cpp:98",
             launches=cnt["affinity_enum"], library_ms=None,
             launches_per_facade_run=cnt["affinity_enum"],
             **also("affinity_enum"), **k["affinity_enum"]),
        dict(name="affinity_filter", route="cuda",
             source="line3d_tpu_torch/csrc/affinity_filter.cu",
             replaces=None,
             plain_twin="line3d_tpu_torch/cluster/affinity_cuda.py:"
                        "filter_plain",
             launches="counted with affinity_enum", library_ms=None,
             **k["affinity_filter"]),
    ]
    log(json.dumps({"kernels": kernels}))
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": card,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
