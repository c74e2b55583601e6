"""Per-stage budget of the per-view matching step at the stress shape.

    python3 -m line3d_tpu_torch.utils.stress_stage_bench [--views 25]
        [--segments 2990] [--repeats 10] [--device cpu]

The port's counterpart of `line3d_tpu`'s scripts/stress_stage_bench.py (no
JAX).  On view 0 of the P25 stress scene (`make_demo_scene(25,
num_random_segments=2990)`: S = 3,072, N = 10, 1920 x 1440), with its real
neighbours, the step `match/engine.py:match_view` runs is timed in
cumulative prefixes, each stage called as `match_view` calls it:

  A  K1 (`pairwise_cuda.pair_valid`), the probe counters and the block
     compaction (`match_view_against_neighbors`)
  B  + the merge into [S, M] (`merge_neighbor_tables`)
  C  + the depth recompute (`gather_target_coords`, `depths_for_matches`)
  D  + the scoring kernel (`scoring_cuda.score`)
  E  + the device selection (`sharded.device_select`) and the copy of its
       buffer to the host, as `engine.match_views` makes it

at two capacities: the script's (quota, m_total) = (8, 2048), and the
view's own exact capacity as `match_view(caps=None)` picks it from the
probe counters (quota 128 and the per-neighbour cut; what the model pays).
Each prefix is called once to warm up, then `--repeats` times with the
source segments shifted by i * 1e-4 px (the script's perturbation); each
call ends in `torch.cuda.synchronize()` and is timed by the host clock and
by a pair of CUDA events.  Per stage it prints the cumulative and the
incremental milliseconds (medians) and the host synchronisations of one
call (PyTorch's sync debug mode, as `utils/time_match_view.count_syncs`
counts them); then, per capacity, the occupancy of the merged table (mean,
p50, p90 and max of `valid.sum(1)`, with M and S), as the script does,
and on the card one whole step under `torch.profiler` (the card's busy
milliseconds and the device ops that took the most time,
`utils/time_match_view.profiled`).
The last line is one JSON object with all of it, the kernels' launches in
each stage's calls and the card as `nvidia-smi` names it.

The device is the card unless `--device cpu` is given (the kernels' plain
twins; no CUDA events, no sync counts); without CUDA it raises.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time

import numpy as np
import torch

from ..config import L3DConfig
from ..core.cameras import CameraSet
from ..core.conditioning import compute_conditioning
from ..match import engine, pairwise, pairwise_cuda, scoring_cuda
from ..parallel import sharded
from ..scene import Scene, find_visual_neighbors, \
    view_similarities_from_worldpoints
from .demo import make_demo_scene
from .host_stage_scaling import card_line, require_device

E2E_VIEWS, E2E_SEGMENTS = 25, 2990
# the script's capacities: the probe's decision at the stress shape
QUOTA, M_TOTAL = 8, 2048
NUM_NEIGHBORS = 10
STAGES = ("A", "B", "C", "D", "E")


@dataclasses.dataclass
class Fixture:
    """One view of a demo scene with its neighbours' stacks, as the
    script's fixture() builds them, as tensors on `device`."""
    scene: Scene
    cams: CameraSet              # conditioned, float64
    config: L3DConfig
    view: int
    nb: np.ndarray               # [N] the view's neighbours
    segs_src: torch.Tensor       # [S, 4]
    mask_src: torch.Tensor       # [S]
    RtKinv_src: torch.Tensor     # [3, 3] f32
    C_src: torch.Tensor          # [3] f32
    segs_nb: torch.Tensor        # [N, S, 4]
    mask_nb: torch.Tensor        # [N, S]
    F_nb: torch.Tensor           # [N, 3, 3] f32
    RtKinv_nb: torch.Tensor      # [N, 3, 3] f32
    C_nb: torch.Tensor           # [N, 3] f32
    P_nb: torch.Tensor           # [N, 3, 4] f32
    spatial_k: np.float32

    @property
    def S(self) -> int:
        return self.scene.max_segments


def fixture(device, num_views: int = E2E_VIEWS,
            segments: int = E2E_SEGMENTS, view: int = 0) -> Fixture:
    """The script's fixture() (scripts/stress_stage_bench.py:40-63): the
    demo scene with `segments` clutter segments a view, its conditioning,
    the worldpoint similarities and N = 10 visual neighbours, and view
    `view`'s stacks: the fundamentals of its pairs, the f32 RtKinv, C and
    P, and its spatial-uncertainty factor at 2 sigma_p."""
    cfg = L3DConfig()
    scene, cams = make_demo_scene(num_views=num_views,
                                  num_random_segments=segments, config=cfg,
                                  device=device)
    tr = compute_conditioning(cams.C)
    cams.transform(tr.Qinv, tr.scale)
    sim, _ = view_similarities_from_worldpoints(scene.wp_lists,
                                                scene.num_views)
    neighbors = find_visual_neighbors(sim, cams.baselines(),
                                      cfg.min_baseline, NUM_NEIGHBORS)
    nb = np.asarray(neighbors[view])
    F = cams.fundamentals_for_pairs(
        np.stack([np.full(len(nb), view), nb], axis=1)).astype(np.float32)
    dev = scene.device

    def t(x):
        return torch.as_tensor(np.ascontiguousarray(x), device=dev)
    return Fixture(
        scene=scene, cams=cams, config=cfg, view=view, nb=nb,
        segs_src=t(scene.segments[view]), mask_src=t(scene.seg_mask[view]),
        RtKinv_src=t(cams.f32("RtKinv")[view]), C_src=t(cams.f32("C")[view]),
        segs_nb=t(scene.segments[nb]), mask_nb=t(scene.seg_mask[nb]),
        F_nb=t(F), RtKinv_nb=t(cams.f32("RtKinv")[nb]),
        C_nb=t(cams.f32("C")[nb]), P_nb=t(cams.f32("P")[nb]),
        spatial_k=np.float32(cams.spatial_uncertainty_k(
            2.0 * cfg.sigma_p)[view]))


def _planes(fx: Fixture, segs_src, caps: tuple | None):
    """K1's planes of the view on `segs_src` and the (quota, m_total,
    per_nb_cap) `match_view` derives from their probe counters."""
    cfg = fx.config
    valid_planes = pairwise_cuda.pair_valid(
        segs_src, fx.mask_src, fx.segs_nb, fx.mask_nb, fx.F_nb,
        fx.RtKinv_src, fx.RtKinv_nb, fx.C_src, fx.C_nb,
        cfg.min_overlap_lower, cfg.min_overlap_upper)
    need, _, _, nbmax = engine.plane_counters(valid_planes)
    return valid_planes, engine.capacities(need, nbmax, len(fx.nb), fx.S,
                                           caps)


def step(fx: Fixture, segs_src, caps: tuple | None, upto: str = "E"):
    """The view's step on source segments `segs_src`, through stage `upto`,
    each stage called as `engine.match_view` and `engine.match_views` call
    it; at `caps` = (quota, m_total), or at the view's exact capacity when
    None.  Returns what the last stage gave: A the compaction's dict, B
    (cam, tgt, valid), C the depths, D the confidences, E the selection
    buffer on the host (int32, `sharded.unpack_selection` reads it)."""
    cfg = fx.config
    N, S = len(fx.nb), fx.S
    valid_planes, (quota, m_total, per_nb_cap) = _planes(fx, segs_src, caps)
    res = pairwise.match_view_against_neighbors(
        segs_src, fx.mask_src, fx.RtKinv_src, fx.C_src, fx.segs_nb,
        fx.mask_nb, fx.F_nb, fx.RtKinv_nb, fx.C_nb, quota=quota,
        min_capacity=m_total, valid=valid_planes, per_nb_cap=per_nb_cap)
    if upto == "A":
        return res
    cam, tgt, valid = pairwise.merge_neighbor_tables(res, m_total, S)
    if upto == "B":
        return cam, tgt, valid
    tcoords = pairwise.gather_target_coords(fx.segs_nb, cam, tgt)
    depths = pairwise.depths_for_matches(
        segs_src, fx.segs_nb, cam, tgt, valid, fx.F_nb, fx.RtKinv_src,
        fx.RtKinv_nb, fx.C_src, fx.C_nb, tcoords=tcoords)
    if upto == "C":
        return depths
    conf = scoring_cuda.score(
        segs_src, fx.RtKinv_src, fx.C_src, cam, tgt, depths, valid, fx.P_nb,
        fx.segs_nb, float(np.float32(cfg.sigma_p)),
        float(np.float32(cfg.sigma_a)), float(fx.spatial_k),
        support_threshold=float(cfg.support_threshold), tcoords=tcoords)
    if upto == "D":
        return conf
    return sharded.device_select(
        cam, tgt, depths, valid, conf, cfg.confidence_threshold, N,
        engine.table_overflow(res, cam)).cpu().numpy()


def assembled(fx: Fixture, buf: np.ndarray) -> tuple:
    """(ViewMatches, best row, median depth) of the view from a stage-E
    buffer, as `engine.match_views` assembles them."""
    ctx = engine.ViewContext(fx.scene, fx.cams, fx.config)
    return engine._assemble_view_outputs(
        ctx, fx.view, fx.nb, sharded.unpack_selection(buf, fx.S))


def engine_mismatch(fx: Fixture, buf: np.ndarray, want: tuple) -> list:
    """The outputs in which the stage-E buffer `buf` differs from `want`,
    the view's (ViewMatches, best row, median depth) from
    `engine.match_views` at the same capacity: [] when the timed step is
    the entry point's."""
    vm, row, med = assembled(fx, buf)
    wvm, wrow, wmed = want
    bad = [f for f in ("src_seg", "tgt_view", "tgt_seg", "overflow")
           if not np.array_equal(getattr(vm, f), getattr(wvm, f))]
    if med != wmed:
        bad.append("median_depth")
    if (row is None) != (wrow is None) or row is not None and (
            row.keys() != wrow.keys()
            or not all(np.array_equal(row[k], wrow[k]) for k in wrow)):
        bad.append("best_row")
    return bad


def _launches() -> tuple:
    return (pairwise_cuda.LAUNCHES, scoring_cuda.LAUNCHES,
            scoring_cuda.LAUNCHES_WIDE)


def time_step(fx: Fixture, caps: tuple | None, upto: str,
              repeats: int) -> dict:
    """One warm-up call of the prefix through `upto`, then `repeats` calls
    with the source segments shifted by i * 1e-4 px, each ended by a
    synchronize: host-clock and (on the card) CUDA-event milliseconds of
    each call, their medians, the kernels' launches in the timed calls and
    (on the card) the host synchronisations of one call."""
    dev = fx.segs_src.device
    cuda = dev.type == "cuda"

    def call(i):
        return step(fx, fx.segs_src + i * 1e-4, caps, upto)
    call(0)
    if cuda:
        torch.cuda.synchronize(dev)
    host, event = [], []
    l0 = _launches()
    for i in range(1, repeats + 1):
        if cuda:
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        if cuda:
            e0.record()
        call(i)
        if cuda:
            e1.record()
            torch.cuda.synchronize(dev)
        host.append((time.perf_counter() - t0) * 1e3)
        if cuda:
            event.append(e0.elapsed_time(e1))
    l1 = _launches()
    syncs = None
    if cuda:
        from .time_match_view import count_syncs
        syncs = count_syncs(lambda: call(repeats + 1))[0]
    return dict(host_ms=host, event_ms=event or None,
                host_ms_median=float(np.median(host)),
                event_ms_median=float(np.median(event)) if event else None,
                syncs=syncs,
                launches=dict(zip(("pair_valid", "score", "score_wide"),
                                  (b - a for a, b in zip(l0, l1)))))


def occupancy(fx: Fixture, caps: tuple | None) -> dict:
    """Mean, p50, p90 and max over the view's rows of `valid.sum(1)` of the
    merged table at `caps`, with its M and S (the script's occupancy line:
    the distribution the scoring kernel sees)."""
    _, _, valid = step(fx, fx.segs_src, caps, "B")
    need = valid.sum(dim=1).cpu().numpy()
    return dict(mean=float(need.mean()), p50=float(np.median(need)),
                p90=float(np.percentile(need, 90)), max=int(need.max()),
                M=int(valid.shape[1]), S=fx.S)


def occupancy_line(occ: dict) -> str:
    return (f"occupancy: mean {occ['mean']:.0f} p50 {occ['p50']:.0f} p90 "
            f"{occ['p90']:.0f} max {occ['max']} (M={occ['M']}, "
            f"S={occ['S']})")


def stage_split(fx: Fixture, caps: tuple | None, repeats: int,
                label: str) -> dict:
    """Stages A-E at one capacity, printed as they are timed (the host
    clock, and the CUDA events where there are), then the occupancy
    line."""
    out, prev = {}, None
    for st in STAGES:
        r = time_step(fx, caps, st, repeats)
        r["host_ms_increment"] = r["host_ms_median"] - \
            (prev["host_ms_median"] if prev else 0.0)
        r["event_ms_increment"] = None if r["event_ms_median"] is None \
            else r["event_ms_median"] - (prev["event_ms_median"]
                                         if prev else 0.0)
        ev = "" if r["event_ms_median"] is None else \
            (f"; events {r['event_ms_median']:8.3f} ms "
             f"(+{r['event_ms_increment']:8.3f} ms)")
        print(f"[{label}] stage {st}: {r['host_ms_median']:8.3f} ms/view "
              f"cumulative (+{r['host_ms_increment']:8.3f} ms){ev}; host "
              f"synchronisations {r['syncs']}", flush=True)
        out[st], prev = r, r
    occ = occupancy(fx, caps)
    print(f"[{label}] {occupancy_line(occ)}", flush=True)
    busy = None
    if fx.segs_src.device.type == "cuda":
        from .time_match_view import profiled
        busy = profiled(lambda: step(fx, fx.segs_src, caps))["device"]
        print(f"[{label}] one step under torch.profiler: card busy "
              f"{busy['busy_ms']:.3f} ms ({busy['events']} device events) "
              f"against stage E's {out['E']['host_ms_median']:.3f} ms by "
              "the host clock; most device time: " + "; ".join(
                  f"{n} {ms:.3f} ms" for n, ms in busy["top"]), flush=True)
    return dict(stages=out, occupancy=occ, profiled_step=busy)


def exact_caps(fx: Fixture) -> tuple:
    """(quota, m_total, per_nb_cap) `match_view(caps=None)` picks for the
    fixture's unshifted segments."""
    return _planes(fx, fx.segs_src, None)[1]


def add_fixture_args(ap: argparse.ArgumentParser):
    ap.add_argument("--views", type=int, default=E2E_VIEWS)
    ap.add_argument("--segments", type=int, default=E2E_SEGMENTS,
                    help="clutter segments a view")
    ap.add_argument("--repeats", type=int, default=10)
    ap.add_argument("--device", default="cuda",
                    help="the step's device (default: the card; raises "
                    "without CUDA)")


def run(fx: Fixture, repeats: int) -> dict:
    """Stages A-E at the script's capacities and at the view's exact
    capacity; the record `main` prints."""
    dev = fx.segs_src.device
    quota, m_total, per_nb_cap = exact_caps(fx)
    rec = dict(views=fx.scene.num_views, view=fx.view, S=fx.S,
               N=len(fx.nb), device=str(dev), card=card_line(dev),
               repeats=repeats)
    rec["script"] = dict(quota=QUOTA, m_total=M_TOTAL, **stage_split(
        fx, (QUOTA, M_TOTAL), repeats, f"quota {QUOTA}, m_total {M_TOTAL}"))
    rec["exact"] = dict(quota=quota, m_total=m_total, per_nb_cap=per_nb_cap,
                        **stage_split(fx, None, repeats,
                                      f"exact: quota {quota}, m_total "
                                      f"{m_total}, per-neighbour cut "
                                      f"{per_nb_cap}"))
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    add_fixture_args(ap)
    args = ap.parse_args(argv)
    require_device(args.device, "stress_stage_bench")
    fx = fixture(args.device, args.views, args.segments)
    rec = run(fx, args.repeats)
    print(f"card: {rec['card']}", flush=True)
    print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
