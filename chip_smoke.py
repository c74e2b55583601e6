#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (`line3d_tpu_torch`) end to end on one GPU.

    python3 chip_smoke.py            # all phases, one card

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
               gate's survivors); errors,
               CUDA-event times and each kernel's bound.
  4. validate  K5 (dense depth planes) through `pair_dense`, the port's
               counterpart of scripts/tpu_validate.py's phase 2: the house
               pair at S=384 and facade view 0 x 10 neighbors, held against
               the plain twin, and K1's plane held to K5's valid plane;
               CUDA-event times.
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
               warm run, and one run under torch.profiler (the card's busy
               time and idle share, the device-to-host copies' bytes and
               milliseconds); two runs with use_sharded_engine=False (host
               selection), whose TXT must equal the default's byte for
               byte; then views 0 and 12: K1's planes against its twin,
               the per-view step re-run on the CPU with the plain twins
               on the card's K1 planes, its tables, scores and best matches
               compared with the card's, the capacity-probe counters
               held to those counted from the twin's planes, the device
               selection held to the host selection on the same card
               tables, and the host synchronisations of one view's step
               counted (at most three).
  9. facaded   the facade with device diffusion (reference mode) and device
               line refinement: one cold and three warm runs; the diffused
               weights held to the float64 host on the same graph, the
               refined lines to the host refinement on the same clusters.
 10. facadeba  one facade run with joint camera + line bundle adjustment,
               "true"-mode device diffusion and the round-parallel F-H.
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
 13. cli       the 25 facade views rendered at 1920 x 1440 (numpy
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
               name the three kernels.

Each path's kernel launch counts are set to 0 just before it is driven and
read just after.  The line before last is the card as `nvidia-smi` reports
it, the last line the result object.  The script imports no JAX and nothing
of `line3d_tpu`.
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
# f32 operations per pair, counted from the kernel sources (each add,
# multiply, compare, divide, square root, exp or acos counts one): K1's
# cheap gates (4 intersections, 2 overlap ratios, the gate, the masks) and
# its triangulation gates (4 ray normalizations, 4 two-ray depths); K5 does
# both for every pair; K4's gate per pair and its regate per candidate
# within the quota; the scoring kernel per staged slot, per spatial-gate
# test and per pair that passes the spatial gate
K1_CHEAP_OPS, K1_TRI_OPS, K4_OPS, K4_REGATE_OPS = 254, 235, 63, 21
SCORE_SLOT_OPS, SCORE_GATE_OPS, SCORE_PAIR_OPS = 48, 8, 73
# the card's float32 rate outside the tensor cores and its memory rate
# (NVIDIA H100 SXM data sheet), the denominators of every bound.  67e12
# counts a fused multiply-add as two operations; the kernels are built with
# -fmad=false and issue one add or multiply per instruction (a divide, root,
# exp or acos many), so an operations bound is a floor about 2x below what
# they can reach.
PEAK_F32, PEAK_BYTES = 67e12, 3.35e12
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
    ops = got.numel() * K1_CHEAP_OPS + n_surv * K1_TRI_OPS
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
    return out


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
    main path's quota (8) and at quota 1 (drops, then the exact fallback),
    the 512-segment chain (the cap bites), S = 100 with a fully masked
    view, and two views at the P25 stress scene's S = 2,990.  Keys, counts
    and dropped_per_view must be identical; weights are compared bit for
    bit, and any that differ must be within K4_W_ATOL.  Then the times and
    the bound at the main path's call."""
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
    cases = [("facade", scene.segments_t, scene.seg_mask_t, 8),
             ("facade quota 1", scene.segments_t, scene.seg_mask_t, 1),
             ("chain 512", t(chain[0]), t(chain[1]), 8),
             ("S=100, view 1 masked", t(s100), t(m100), 8),
             ("S=2990", *map(t, collin_random(2990, 2, 2990, 40)), 8)]
    res, n_differ, max_diff = {}, 0, 0.0
    for name, segs, masks, quota in cases:
        got = col.collinearity_compact_all(segs, masks, sig2, quota=quota)
        want = col.collinearity_compact_all_plain(segs, masks, sig2,
                                                  quota=quota)
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
            fixed, n_views = col.apply_collinearity_exact_fallback(
                mg, segs, masks, 2.0)
            log(f"[kernels] K4 quota 1: the exact fallback re-derived "
                f"{n_views} views")
            require(fixed.dropped_total == 0, "K4 fallback left drops")
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
    from line3d_tpu_torch.match import engine, pairwise_cuda as k5
    from line3d_tpu_torch.utils.synthetic import make_scene
    dev = torch.device("cuda")
    f32 = lambda x: torch.as_tensor(np.asarray(x, np.float32),  # noqa: E731
                                    device=dev)

    # scripts/tpu_validate.py's case: house views 1 and 3 padded to S=384
    syn = make_scene(num_views=6)
    cams, sc = syn.cameras, syn.scene
    S = 384
    segs = np.zeros((2, S, 4), np.float32)
    mask = np.zeros((2, S), bool)
    ns = min(S, sc.segments.shape[1])
    segs[0, :ns], segs[1, :ns] = sc.segments[1][:ns], sc.segments[3][:ns]
    mask[0, :ns], mask[1, :ns] = sc.seg_mask[1][:ns], sc.seg_mask[3][:ns]
    house = (f32(segs[0]), torch.as_tensor(mask[0], device=dev),
             f32(segs[1:2]), torch.as_tensor(mask[1:2], device=dev),
             f32(cams.fundamental(1, 3)[None]), f32(cams.RtKinv[1]),
             f32(cams.RtKinv[3][None]), f32(cams.C[1]), f32(cams.C[3][None]))
    # facade view 0 against its 10 neighbors, 1280 x 1280 each
    cfg, scene, fcams, nbrs = facade_inputs(dev)
    ctx = engine.ViewContext(scene, fcams, cfg)
    nb = np.asarray(nbrs[0], np.int64)
    segs_nb, mask_nb, F_nb, RtKinv_nb, C_nb, _ = ctx.neighbor_arrays(0, nb)
    facade = (scene.segments_t[0], scene.seg_mask_t[0], segs_nb, mask_nb,
              F_nb, ctx.RtKinv32[0], RtKinv_nb, ctx.C32[0], C_nb)

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
    ms = cuda_ms(lambda: k5.pair_dense_cuda(*facade), 10)
    plain_ms = cuda_ms(lambda: k5.pair_dense_plain(*facade), 2)
    pairs = vg.numel()
    b_ms, b_by = bound_ms(pairs * (K1_CHEAP_OPS + K1_TRI_OPS),
                          sum(x.numel() * x.element_size() for x in facade)
                          + pairs * 17)
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


def _hold_diffusion(calls, mode, where):
    """The recorded device diffusion against the float64 host on the same
    edge list: identical (i, j), weights within DIFF_RTOL / DIFF_ATOL; and
    run once more on the card, bit-equal."""
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


def _counted(run, tag, wide=True):
    """run() with the model path's kernel launch counts set to 0 just
    before; fails unless each kernel was launched (the scoring kernel at
    M > 256 when `wide`, at any M otherwise).  Returns (run's result, the
    counts just after)."""
    from line3d_tpu_torch.match import pairwise_cuda as k1, \
        collinearity_cuda as k4, scoring_cuda as k23
    from line3d_tpu_torch.utils import peak as k6
    k1.LAUNCHES = k1.LAUNCHES_DENSE = k4.LAUNCHES = k6.LAUNCHES = 0
    k23.LAUNCHES = k23.LAUNCHES_WIDE = 0
    out = run()
    counts = dict(pair_valid=k1.LAUNCHES, collin_pairs=k4.LAUNCHES,
                  score=k23.LAUNCHES, score_wide=k23.LAUNCHES_WIDE,
                  pair_dense=k1.LAUNCHES_DENSE, fma_peak=k6.LAUNCHES)
    require(counts["pair_valid"] > 0 and counts["collin_pairs"] > 0
            and counts["score_wide" if wide else "score"] > 0,
            f"{tag}: a kernel of the path was not launched")
    require(counts["collin_pairs"] == 1,
            f"{tag}: K4 ran {counts['collin_pairs']} times in one model")
    log(f"[{tag}] launches in the run: {counts}")
    return out, counts


def _profile(run, tag):
    """One more run under torch.profiler: the card's busy time (the summed
    durations of its kernels, copies and fills), the run's host seconds,
    the card's idle share, the device ops that took the most time, and the
    device-to-host copies (count, bytes, milliseconds).  Returns the
    copies' totals by kind."""
    from collections import defaultdict
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from line3d_tpu_torch.utils.time_match_view import memcpy_totals
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        (l3d, t) = run()
    per_op = defaultdict(float)
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            per_op[e.name] += e.time_range.elapsed_us() / 1e3
    busy = sum(per_op.values())
    if not per_op:
        log(f"[{tag}] profiled run {t:.3f} s: the profiler saw no device "
            "events")
        return {}
    top = sorted(per_op.items(), key=lambda kv: -kv[1])[:8]
    log(f"[{tag}] profiled run {t:.3f} s (host clock, profiler on): card "
        f"busy {busy:.1f} ms, idle share {1 - busy / (t * 1e3):.3f}; most "
        f"device time: " + "; ".join(f"{n[:60]} {ms:.1f} ms"
                                     for n, ms in top))
    copies = memcpy_totals(prof)
    d2h = copies.get("DtoH", dict(count=0, bytes=0, ms=0.0))
    log(f"[{tag}] profiled run: device-to-host copies {d2h['count']}, "
        f"{d2h['bytes']} bytes, {d2h['ms']:.3f} ms (t_match "
        f"{l3d.stats['t_match']:.3f} s); all copies {copies}")
    return copies


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
    a, kw, got = rcalls[-1]
    require(kw["device"].type == "cuda", "facaded: refine not on the card")
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
                                    device="cuda")
    r32, _ = rf.residuals_t(f32(P0), f32(d_unit), f32(Pm), f32(p1),
                             f32(p2), torch.as_tensor(mask, device="cuda"))
    floor = float(np.abs(r32.cpu().numpy() - r64).max())
    rb_err = float(np.abs(rb_d - rb_h).max())
    log(f"[facaded] device refine vs float64 host ({t_host:.2f} s): "
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
            perp < 5e-3, "facaded: device refine differs from the host "
            "(tests/test_refine.py criteria)")
    return dict(warm=warm, best=best_s, counts=counts, stats=l3d.stats)


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
    return dict(seconds=t, stats=st)


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
        f"{st['collinearity_overflow']} (views re-derived "
        f"{st['views_recollin_exact']}), {st['num_best']} best matches, "
        f"{st['num_lines']} lines")
    require(st["match_overflow"] == 0 and
            st["views_rematched_uncapped"] == 0,
            "stress: match overflow remains")
    require(st["collinearity_overflow"] == 0 or
            st["views_recollin_exact"] > 0,
            "stress: collinearity overflow remains")
    require(scene.max_segments == 3072 and st["num_lines"] > 0,
            "stress: not the P25 stress shape, or no model")
    return dict(cold=t_cold, warm=t_warm, counts=counts,
                probe_m_total=st["probe_m_total"], m_total=mt,
                match_overflow=st["match_overflow"],
                views_rematched_uncapped=st["views_rematched_uncapped"],
                lines=st["num_lines"], t_match=st["t_match"])


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


def _check_path_kernels(l3d, tag):
    """The kernels of a finished Line3D run against their plain twins on
    the card, at the shapes that run gave them: for the first view of each
    match-slot width the run used and for the last view, K1's planes on the
    view's N neighbors (and the probe counters the run reduced from them)
    and the scoring kernel on the view's exact match table; then K4 on all
    the scene's views.  K1 and K4 are held to phase `kernels`' tolerances.
    On the first of those views the device selection is held against the
    host selection on the same card tables (_hold_selection).
    The scoring kernel is held to its float32 twin and, as the arbiter of
    the two, to the twin run in float64 on the same table with the support
    threshold moved down and up by the scoring tolerance (a lower threshold
    only adds supports, so the two runs bracket every value that supports
    at the threshold can give a slot), with the bounds above.  The launches
    made here come after the run's counts were read."""
    import torch
    from line3d_tpu_torch.match import collinearity as col, engine, \
        pairwise, pairwise_cuda as k1, scoring as sc
    cfg, scene = l3d.config, l3d.scene
    ctx = engine.ViewContext(scene, l3d.cameras, cfg)
    S = scene.max_segments
    picked = {}
    for vm in l3d.matches:
        picked.setdefault(vm.m_total, vm)
    views = {vm.view: vm for vm in picked.values()}
    views[l3d.matches[-1].view] = l3d.matches[-1]
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

        vm_d, row_d, med_d, o = engine.match_and_select_view(ctx, v, nb)
        require(vm_d.m_total == M and vm_d.overflow == 0,
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
    return out


def rot_to_quat(R):
    """(w, x, y, z) of a rotation matrix, the inverse of the NVM loader's
    quat_to_R."""
    tr = np.trace(R)
    if tr > 0:
        s = np.sqrt(tr + 1.0) * 2
        return np.array([0.25 * s, (R[2, 1] - R[1, 2]) / s,
                         (R[0, 2] - R[2, 0]) / s, (R[1, 0] - R[0, 1]) / s])
    i = int(np.argmax(np.diag(R)))
    j, k = (i + 1) % 3, (i + 2) % 3
    s = np.sqrt(R[i, i] - R[j, j] - R[k, k] + 1.0) * 2
    q = np.empty(4)
    q[0] = (R[k, j] - R[j, k]) / s
    q[1 + i] = 0.25 * s
    q[1 + j] = (R[j, i] + R[i, j]) / s
    q[1 + k] = (R[k, i] + R[i, k]) / s
    return q


def render_view(segs, width, height):
    """One view's segments as dark 3 px lines on a light background with a
    soft edge (a 1-2-1 blur in x and y): uint8 [height, width]."""
    from line3d_tpu_torch.utils.visualize import _draw_segment
    img = np.full((height, width), 235, np.uint8)
    for x1, y1, x2, y2 in np.asarray(segs, np.float64):
        _draw_segment(img, x1, y1, x2, y2, 40, 3)
    f = np.pad(img.astype(np.float32), 1, mode="edge")
    f = 0.25 * f[:-2] + 0.5 * f[1:-1] + 0.25 * f[2:]
    f = 0.25 * f[:, :-2] + 0.5 * f[:, 1:-1] + 0.25 * f[:, 2:]
    return np.rint(f).astype(np.uint8)


def write_facade_dataset(root, scene, cams):
    """A VisualSfM dataset of the facade scene in `root`: each view's
    projected segments rendered to a binary PGM, and `scene.nvm` (NVM_V3 as
    main_vsfm.cpp:121-223 parses it: name, focal, quaternion, center, no
    distortion; one worldpoint per 3D line with its views).  Returns the
    NVM file's path."""
    V = scene.num_views
    for v in range(V):
        w, h = int(cams.width[v]), int(cams.height[v])
        img = render_view(scene.segments[v][scene.seg_mask[v]], w, h)
        with open(os.path.join(root, f"view_{v:03d}.pgm"), "wb") as f:
            f.write(f"P5\n{w} {h}\n255\n".encode())
            f.write(img.tobytes())
    wp_views = {}
    for v in range(V):
        for wp in scene.wp_lists[v]:
            wp_views.setdefault(wp, []).append(v)
    lines = ["NVM_V3", "", f"{V}"]
    for v in range(V):
        lines.append(
            f"view_{v:03d}.pgm {cams.K[v][0, 0]:.6f} "
            + " ".join(f"{x:.12f}" for x in rot_to_quat(cams.R[v])) + " "
            + " ".join(f"{x:.12f}" for x in cams.C[v]) + " 0.0 0")
    lines += ["", f"{len(wp_views)}"]
    for wp in sorted(wp_views):
        lines.append(f"0 0 0 128 128 128 {len(wp_views[wp])}"
                     + "".join(f" {v} 0 0.0 0.0" for v in wp_views[wp]))
    path = os.path.join(root, "scene.nvm")
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
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
                                        "collin_pairs_kernel")}
    log(f"[{tag}] python -m line3d_tpu_torch.cli ... --profile_dir in "
        f"{t_third:.1f} s: the same TXT, trace {len(trace)} bytes, kernel "
        f"names in it: {seen}")
    return dict(t_detect=st["t_detect"], t_match=st["t_match"],
                t_match_host_selection=l3d2.stats["t_match"],
                t_first=t_first, t_second=t_second, lines=st["num_lines"],
                err=err, counts=counts, trace_names=seen, held=held,
                segs=(int(n_segs.min()), int(np.median(n_segs)),
                      int(n_segs.max())))


# the bound on phase cli's median distance of the model's 3D segments to
# the ground-truth facade lines (the facade spans 12 x 10 units, windows of
# ~0.6); measured 0.018 on an NVIDIA H100 80GB HBM3
CLI_MEDIAN_ERR_MAX = 0.05


def phase_cli(card):
    """Images on disk to a 3D line model through the port's `vsfm` entry
    point on the card (phase 13 of the module docstring)."""
    from line3d_tpu_torch.utils.demo import facade_lines, make_facade_scene
    scene, cams = make_facade_scene(num_views=25, device="cpu")
    gt = facade_lines(n_cols=12, n_rows=10, seed=11)
    with tempfile.TemporaryDirectory() as root:
        r = run_cli_dataset(root, scene, cams, gt, "cli")
    require(r["err"] < CLI_MEDIAN_ERR_MAX,
            f"cli: median distance to the ground truth {r['err']}")
    require(all(n > 0 for n in r["trace_names"].values()),
            "cli: the profiler trace does not name the kernels")
    log(f"[cli] on {card}")
    return r


def _txt_model(l3d, path):
    l3d.save_3d_lines_as_txt(l3d.get_result(), path)


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
    return dict(warm=warm, best=best_s, counts=counts, stats=st, txt=txt,
                copies=copies, host_selection_seconds=host_s,
                host_selection_t_match=host_match, syncs=syncs)


# host synchronisations of one exact view's match_and_select_view with
# device selection: the probe counters, the export's masked_select, the
# selection buffer's copy
VIEW_SYNCS_MAX = 3


def _hold_selection(ctx, v, nb, table, got, tag):
    """Device selection against the host selection on the same card
    tables: `got` = (ViewMatches, best row, median) of a device-selected
    match_and_select_view, `table` its card tables, copied here to the
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
    n_syncs, _ = count_syncs(
        lambda: engine.match_and_select_view(ctx, v, nb))
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
        vm_g, bg, med_g, tg = engine.match_and_select_view(ctx_g, v, nb)
        engine.pair_valid = lambda *a: planes["g"].cpu()
        _, bc, _, tc = engine.match_and_select_view(ctx_c, v, nb)
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


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False — this "
              "script needs an NVIDIA GPU", file=sys.stderr)
        return 2
    import line3d_tpu_torch  # noqa: F401  (fails outside a checkout)
    require("jax" not in sys.modules, "JAX was imported")

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
    timed("facadeba", phase_facade_ba, card)
    cp = timed("capped", phase_capped, card, fa["txt"])
    sp = timed("stress", phase_stress, card)
    cl = timed("cli", phase_cli, card)
    require("jax" not in sys.modules and "line3d_tpu" not in sys.modules,
            "JAX or line3d_tpu was imported")
    d2h = (fa["copies"] or {}).get("DtoH", {})
    log(f"[summary] phase seconds {seconds}; facade exact best "
        f"{fa['best']:.3f} s, with diffusion + refine best {fd['best']:.3f} "
        f"s; facade profiled run device-to-host {d2h.get('bytes')} bytes in "
        f"{d2h.get('count')} copies, {d2h.get('ms')} ms; host "
        f"synchronisations of one exact view's step: facade "
        f"{fa['syncs']}, cli {cl['held']['selection_syncs']}; stress warm "
        f"{sp['warm']:.3f} s")

    # `launches` counts the path each kernel serves (the facade's warm run
    # for K1, K4 and the scoring kernel, the validation and peak phases
    # for K5 and K6); `launches_per_facade_run` is the warm facade run's
    # count for every kernel, `launches_capped` the counts of the capped
    # phase's runs (b) and (c), `launches_cli` those of the CLI's first
    # run, `held_at_cli_shapes` that run's comparison with the twins.  No
    # single PyTorch call computes any of these functions, so `library_ms`
    # is null throughout.
    cnt = fa["counts"]

    views_cli = {k: d for k, d in cl["held"].items() if k.startswith("view")}
    held_cli = dict(
        pair_valid={k: dict(S=d["S"], disagree=d["k1_disagree"])
                    for k, d in views_cli.items()},
        score={k: {key: d[key] for key in d
                   if key in ("S", "M") or key.startswith("score_")}
               for k, d in views_cli.items()},
        collin_pairs=cl["held"]["collin_pairs"])

    def also(key):
        return dict(launches_capped=[cp["b"]["counts"][key],
                                     cp["c"]["counts"][key]],
                    launches_stress=sp["counts"][key],
                    launches_cli=cl["counts"][key],
                    held_at_cli_shapes=held_cli[key])
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
             at_m256=k["score"][256]),
        dict(name="pair_dense (K5)", route="cuda",
             source="line3d_tpu_torch/csrc/pair_valid.cu",
             replaces="line3d_tpu/match/pairwise_pallas.py:203",
             path="validate", launches=k5["launches"],
             launches_per_facade_run=cnt["pair_dense"], library_ms=None,
             **{key: k5[key] for key in ("max_abs_err", "ms", "plain_ms",
                                         "bound_ms", "bound_by")}),
        dict(name="fma_peak (K6)", route="cuda",
             source="line3d_tpu_torch/csrc/fma_peak.cu",
             replaces="bench.py:398", path="peak",
             launches=k6["launches"],
             launches_per_facade_run=cnt["fma_peak"], library_ms=None,
             **{key: k6[key] for key in ("max_abs_err", "ms", "plain_ms",
                                         "bound_ms", "bound_by",
                                         "tflops")}),
    ]
    log(json.dumps({"kernels": kernels}))
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": card,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
