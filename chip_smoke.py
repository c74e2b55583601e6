#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (`line3d_tpu_torch`) end to end on one GPU.

    python3 chip_smoke.py            # all phases, one card

Phases (each prints its own lines and its seconds; any failure raises and
exits non-zero):
  1. device    require CUDA; print the card's name and power limit.
  2. build     compile the CUDA kernels (csrc/*.cu, one nvcc per source in
               parallel, sm_90a) and the native host library from the
               checkout; print the seconds.
  3. kernels   each kernel against its plain PyTorch twin on the card, on
               inputs cut from view 0 of the 25-view facade scene: K1 (pair
               valid plane), K4 (collinearity keep plane), and the scoring
               kernel at M=256 and M=1024; errors and CUDA-event times.
  4. validate  K5 (dense depth planes) through `pair_dense`, the port's
               counterpart of scripts/tpu_validate.py's phase 2: the house
               pair at S=384 and facade view 0 x 10 neighbors, held against
               the plain twin; CUDA-event times.
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
               warm run; then views 0 and 12: K1's planes against its twin,
               and the per-view step re-run on the CPU with the plain twins
               on the card's K1 planes, its tables, scores and best matches
               compared with the card's.
  9. facaded   the facade with device diffusion (reference mode) and device
               line refinement: one cold and three warm runs; the diffused
               weights held to the float64 host on the same graph, the
               refined lines to the host refinement on the same clusters.
 10. facadeba  one facade run with joint camera + line bundle adjustment,
               "true"-mode device diffusion and the round-parallel F-H.

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
                 or "Compiling entry" in ln]
    log(f"[build] nvcc {t_cuda:.2f} s (sm_90a, -fmad=false), "
        f"g++ host library {t_host:.2f} s")
    for ln in ptxas:
        log(f"[build]   {ln}")


def phase_kernels():
    import torch
    from line3d_tpu_torch.match import collinearity as col, engine, \
        collinearity_cuda as k4, pairwise_cuda as k1, scoring as sc, \
        scoring_cuda as k23
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
        got, want = k1.pair_valid_cuda(*a), k1.pair_valid_plain(*a)
        torch.cuda.synchronize()
        bad, n_valid = int((got != want).sum()), int(want.sum())
        log(f"[kernels] K1 pair_valid S={S} St={S} N={n}: {n_valid} valid "
            f"pairs of {got.numel()}, {bad} disagree (bound "
            f"{PAIR_DISAGREE_MAX:g} of the valid pairs)")
        require(bad <= PAIR_DISAGREE_MAX * n_valid,
                "K1 disagrees with its plain twin")
    ms = cuda_ms(lambda: k1.pair_valid_cuda(*a), 20)
    plain_ms = cuda_ms(lambda: k1.pair_valid_plain(*a), 3)
    log(f"[kernels] K1 N={N}: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms")
    out["pair_valid"] = dict(max_abs_err=float(bad > 0), disagree=bad,
                             ms=ms, plain_ms=plain_ms)

    # K4: one view's keep plane
    sig2 = float(np.float32(cfg.collinearity_sigma ** 2))
    thr = k4.keep_threshold_sq(sig2, cfg.collinearity_aff_threshold)
    got = k4.collin_keep_cuda(segs0, mask0, thr)
    want = k4.collin_keep_plain(segs0, mask0, thr)
    dense = col.collinearity_matrix(segs0, mask0, sig2) > 0
    bad = int((got != want).sum())
    missing = int((dense & ~got).sum())
    extra = int((got & ~dense).sum())
    log(f"[kernels] K4 collin_keep S={S}: {int(got.sum())} kept, {bad} "
        f"disagree with plain, {missing} of {int(dense.sum())} dense pairs "
        f"missing, {extra} margin extras")
    require(missing == 0, "K4 plane is not a superset of the dense plane")
    require(bad <= max(2, int(1e-3 * int(dense.sum()))),
            "K4 disagrees with its plain twin")
    ms = cuda_ms(lambda: k4.collin_keep_cuda(segs0, mask0, thr), 20)
    plain_ms = cuda_ms(lambda: k4.collin_keep_plain(segs0, mask0, thr), 5)
    log(f"[kernels] K4: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms")
    out["collin_keep"] = dict(max_abs_err=float(bad > 0), disagree=bad,
                              ms=ms, plain_ms=plain_ms)

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
        a = (segs0, ctx.RtKinv32[v], ctx.C32[v], cam, tgt, depths, valid,
             P_nb, segs_nb, float(np.float32(cfg.sigma_p)),
             float(np.float32(cfg.sigma_a)), spk, cfg.support_threshold)
        prep = sc.kernel_inputs(*a)
        got = k23.score_prepared(*prep)
        want = k23.score_plain(*a)
        err = (got - want).abs()
        outside = err > SCORE_ATOL + SCORE_RTOL * want.abs()
        n_bad, n_scored = int(outside.sum()), int((want > 0).sum())
        need = prep[4]
        log(f"[kernels] score M={M}: {int(valid.sum())} valid slots, need "
            f"max {int(need.max())} (rows with need % 128 != 0: "
            f"{int(((need % 128) != 0).sum())}), {n_scored} scored, max "
            f"abs err {float(err.max()):.3e}, {n_bad} outside rtol "
            f"{SCORE_RTOL} / atol {SCORE_ATOL}")
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
        ms = cuda_ms(lambda: k23.score_prepared(*prep), 10)
        prep_ms = cuda_ms(lambda: sc.kernel_inputs(*a), 10)
        plain_ms = cuda_ms(lambda: k23.score_plain(*a), 2)
        log(f"[kernels] score M={M}: kernel {ms:.3f} ms (+ prep "
            f"{prep_ms:.3f} ms), plain {plain_ms:.3f} ms")
        out["score"][M] = dict(max_abs_err=float(err.max()), outside=n_bad,
                               ms=ms, prep_ms=prep_ms, plain_ms=plain_ms)
    return out


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
    ms = cuda_ms(lambda: k5.pair_dense_cuda(*facade), 10)
    plain_ms = cuda_ms(lambda: k5.pair_dense_plain(*facade), 2)
    log(f"[validate] K5 facade N=10: kernel {ms:.3f} ms, plain "
        f"{plain_ms:.3f} ms; launches in the validation path: {launches}")
    require(launches == 2, "K5 was not launched on the validation path")
    return dict(launches=launches,
                max_abs_err=max(r["max_abs_err"] for r in res.values()),
                ms=ms, plain_ms=plain_ms, cases=res)


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
    log(f"[peak] K6 at {k6.UNROLL * trips} steps: kernel {ms:.3f} ms, "
        f"plain {plain_ms:.3f} ms")
    torch.cuda.synchronize()
    return dict(launches=launches, max_abs_err=err, ms=ms,
                plain_ms=plain_ms, tflops=r["tflops"])


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


def _counted(run, tag):
    """run() with the model path's kernel launch counts set to 0 just
    before; fails unless each kernel was launched.  Returns (run's result,
    the counts just after)."""
    from line3d_tpu_torch.match import pairwise_cuda as k1, \
        collinearity_cuda as k4, scoring_cuda as k23
    k1.LAUNCHES = k4.LAUNCHES = 0
    k23.LAUNCHES = k23.LAUNCHES_WIDE = 0
    out = run()
    counts = dict(pair_valid=k1.LAUNCHES, collin_keep=k4.LAUNCHES,
                  score=k23.LAUNCHES, score_wide=k23.LAUNCHES_WIDE)
    require(counts["pair_valid"] > 0 and counts["collin_keep"] > 0
            and counts["score_wide"] > 0,
            f"{tag}: a kernel of the path was not launched")
    log(f"[{tag}] launches in the run: {counts}")
    return out, counts


def _facade_runs(cfg, scene, cams, n_warm, tag):
    """One cold and n_warm warm runs of the facade through Line3D on the
    card; the kernels' launch counts of warm run 1.  Returns (l3d of the
    last run, warm seconds, counts)."""
    import torch
    from line3d_tpu_torch import Line3D

    def run():
        l3d = feed(Line3D(config=cfg, device="cuda"), scene, cams)
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
    require(st["num_lines"] > 0, f"{tag}: no lines")
    return l3d, warm, counts


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
        l3d, warm, counts = _facade_runs(cfg, scene, cams, 3, "facaded")
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


def _txt_model(l3d, path):
    l3d.save_3d_lines_as_txt(l3d.get_result(), path)


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
    from line3d_tpu_torch import L3DConfig
    from line3d_tpu_torch.match import engine
    from line3d_tpu_torch.utils.demo import make_facade_scene
    cfg = L3DConfig()
    scene, cams = make_facade_scene(num_views=25, config=cfg)
    V = scene.num_views
    l3d, warm, counts = _facade_runs(cfg, scene, cams, 3, "facade")
    st = l3d.stats
    mt, mc = np.unique(st["m_total"], return_counts=True)
    log(f"[facade] {st['num_lines']} lines, {st['num_best']} best matches, "
        f"overflow {st['match_overflow']}, m_total per view "
        f"{dict(zip(mt.tolist(), mc.tolist()))}, collinearity overflow "
        f"{st['collinearity_overflow']}")
    best_s = min(warm)
    log(f"[facade] warm seconds {warm}; best {best_s:.3f} s = "
        f"{V / best_s:.2f} images/s on {card}")

    # views 0 and 12 again, on the card and on the CPU
    torch.set_num_threads(os.cpu_count() or 1)
    ctx_g = engine.ViewContext(l3d.scene, l3d.cameras, cfg)
    ctx_c = engine.ViewContext(l3d.scene.to("cpu"), l3d.cameras, cfg)
    for v in (0, 12):
        t0 = time.perf_counter()
        _check_view_on_cpu(l3d, ctx_g, ctx_c, v)
        log(f"[facade] view {v}: CPU check {time.perf_counter() - t0:.1f} s")
    return dict(warm=warm, best=best_s, counts=counts, stats=st)


def _check_view_on_cpu(l3d, ctx_g, ctx_c, v):
    """One view's per-view step on the card against the CPU's plain twins.

    K1 is held against its twin on the view's planes.  The CPU step then
    matches on the card's K1 planes, so both sides score the same tables
    and a best-match key may differ only as a near-tie (the two best
    confidences within the scoring tolerance) or in a row holding a slot
    where the scoring kernel and its twin part by more than the tolerance
    (a support at the threshold), of which at most SCORE_FLIP_MAX of the
    scored slots are allowed."""
    from line3d_tpu_torch.match import engine, pairwise_cuda as k1
    nb = np.asarray(l3d.neighbors[v], np.int64)
    planes = {}

    def card_planes(*a):
        planes["g"] = k1.pair_valid(*a)
        return planes["g"]
    try:
        engine.pair_valid = card_planes
        _, bg, _, rg = engine.match_and_select_view(ctx_g, v, nb)
        engine.pair_valid = lambda *a: planes["g"].cpu()
        _, bc, _, rc = engine.match_and_select_view(ctx_c, v, nb)
    finally:
        engine.pair_valid = k1.pair_valid
    mine = l3d.best.view == v
    require(np.array_equal(bg["seg"], l3d.best.seg[mine]) and
            np.array_equal(bg["tgt_seg"], l3d.best.tgt_seg[mine]),
            f"view {v}: per-view step differs from the pipeline run")

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
    require("jax" not in sys.modules and "line3d_tpu" not in sys.modules,
            "JAX or line3d_tpu was imported")
    log(f"[summary] phase seconds {seconds}; facade exact best "
        f"{fa['best']:.3f} s, with diffusion + refine best {fd['best']:.3f} s")

    cnt = fa["counts"]
    kernels = [
        dict(name="pair_valid (K1)", route="cuda",
             source="line3d_tpu_torch/csrc/pair_valid.cu",
             replaces="line3d_tpu/match/pairwise_pallas.py:216",
             launches=cnt["pair_valid"], **k["pair_valid"]),
        dict(name="collin_keep (K4)", route="cuda",
             source="line3d_tpu_torch/csrc/collin_keep.cu",
             replaces="line3d_tpu/match/collinearity_pallas.py:35",
             launches=cnt["collin_keep"], **k["collin_keep"]),
        dict(name="score (K2/K3)", route="cuda",
             source="line3d_tpu_torch/csrc/scoring.cu",
             replaces="line3d_tpu/match/scoring_pallas.py:239",
             also_replaces="line3d_tpu/match/scoring_pallas.py:212",
             launches=cnt["score"], launches_m_gt_256=cnt["score_wide"],
             max_abs_err=max(r["max_abs_err"]
                             for r in k["score"].values()),
             ms=k["score"][1024]["ms"],
             plain_ms=k["score"][1024]["plain_ms"],
             at_m256=k["score"][256]),
        dict(name="pair_dense (K5)", route="cuda",
             source="line3d_tpu_torch/csrc/pair_valid.cu",
             replaces="line3d_tpu/match/pairwise_pallas.py:203",
             path="validate", launches=k5["launches"],
             max_abs_err=k5["max_abs_err"], ms=k5["ms"],
             plain_ms=k5["plain_ms"]),
        dict(name="fma_peak (K6)", route="cuda",
             source="line3d_tpu_torch/csrc/fma_peak.cu",
             replaces="bench.py:398", path="peak",
             launches=k6["launches"], max_abs_err=k6["max_abs_err"],
             ms=k6["ms"], plain_ms=k6["plain_ms"], tflops=k6["tflops"]),
    ]
    log(json.dumps({"kernels": kernels}))
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": card,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
