"""The pipeline at scale: `Line3D` on `make_facade_scene(V)` (or the
clutter scene) for each V given, with its stage times, exactness, kernel
launches and memory.

    python3 -m line3d_tpu_torch.utils.scale_exact_profile [V ...]
        [--device cpu] [--warm 3] [--out DIR] [--expect DIR]
        [--host-selection] [--config exact|facaded|facadeba]
        [--scene facade|clutter] [--capped]
    torchrun --nproc_per_node N -m line3d_tpu_torch.utils.scale_exact_profile
        V ... --expect DIR

The port's counterpart of `line3d_tpu`'s scripts/scale_exact_profile.py
(no JAX).  By default the default configuration (exact matching with the
capacity probe and the uncapped fallback, collinearity on, exact F-H; no
diffusion, refinement or bundle adjustment) on the 1920 x 1440 facade.
`--config` takes the `L3DConfig` of `utils/time_match_view.py
--facade-config`: facaded (reference-mode device diffusion and device line
refinement) or facadeba (true-mode device diffusion, the round-parallel
F-H and the joint camera + line bundle adjustment).  `--scene clutter` is
`make_demo_scene(V, num_random_segments=2990)` (S = 3,072, the segment cap
dense imagery fills), `--capped` the capped pass alone
(`uncapped_fallback=False`, bench.py's capped row: what overflows is
dropped and counted in `match_overflow`).  For each V:
one cold run, then `--warm` runs with the segments shifted by
1e-3 * (trial + 1) px.  Each run is timed by the host clock from
`compute_3d_model` to a `torch.cuda.synchronize()`.  One JSON line per V
(per rank) gives the cold and every warm trial's seconds, images/s of the
best, the lines, every trial's `t_*`, the exactness fields
(`match_overflow`, `views_rematched_uncapped`, `probe_m_total`,
`collinearity_overflow`, `views_recollin_exact`), each warm trial's
`warm_stats` (the fields `line3d_tpu`'s scripts/stress_exact_profile.py
prints a trial: every `t_*`, `probe_*`, overflow, re-match and re-run
count; so
`25 --scene clutter` is that script's counterpart), the kernels' launches
in each warm run
(the wrappers' `LAUNCHES`), the affinity enumeration's stream length, `torch.cuda.max_memory_allocated` over the V's
runs, the process's peak RSS, `gathered_by_stage`, and the sha256 of the
cold run's TXT; the cold run's stage times; with refinement or BA the
clusters fitted and their member counts (median, p99, largest), and
under BA `ba_rms_before` / `ba_rms_after` and the sha256 of the refined
poses.  `--host-selection` runs the models with
`use_sharded_engine=False` (each view's [S, M] tables copied to the host
and selected there; the same model), which a multi-process run refuses.

Under N ranks (torchrun, or `multihost.initialize` before `main`) every
rank runs its share of each model.  Each rank writes its cold run's TXT
(`--out DIR`: `V{V}.txt` in one process, `V{V}_rank{r}.txt` under N; other
than the default facade exact, the name starts with the scene and config,
as `facade_facadeba_V256.txt` or `clutter_exact_capped_V100.txt`) and,
under BA, its refined poses (`..._poses.npz`); the TXTs and poses are
gathered, and rank 0 checks that every rank's equal those a one-process
run saved before (`--expect DIR`) and, without it, that the ranks agree;
it raises when they differ.  The device is the
card ("cuda", under N ranks the rank's card) unless `--device cpu` is
given; without CUDA it raises.
"""
from __future__ import annotations

import argparse
import contextlib
import hashlib
import json
import os
import resource
import sys
import tempfile
import time

import numpy as np
import torch

from .. import L3DConfig, Line3D
from ..cluster import affinity_cuda
from ..fit import bundle, refine
from ..match import collinearity_cuda, pairwise_cuda, scoring_cuda
from ..parallel import multihost
from .demo import make_demo_scene, make_facade_scene
from .host_stage_scaling import card_line, require_device
from .time_match_view import FACADE_CONFIGS

# the wrappers' launch counters: (module, counter, name in the record)
_COUNTERS = ((pairwise_cuda, "LAUNCHES", "pair_valid"),
             (collinearity_cuda, "LAUNCHES", "collin_pairs"),
             (scoring_cuda, "LAUNCHES", "score"),
             (scoring_cuda, "LAUNCHES_WIDE", "score_wide"),
             (affinity_cuda, "LAUNCHES", "affinity_enum"))
STAGES = ("t_setup", "t_graph", "t_collin", "t_match", "t_affinity",
          "t_diffusion", "t_fh", "t_fit", "t_cluster", "t_total")
EXACTNESS = ("match_overflow", "views_rematched_uncapped", "probe_m_total",
             "collinearity_overflow", "views_recollin_exact")
# --scene clutter: the wireframe with this many uniform random segments a
# view (bench.py's P25 stress shape, S = 3,072)
CLUTTER_SEGMENTS = 2990
# the functions that pad each fit's member data, whose cluster lists a
# run's record sizes
_MEMBER_DATA_FNS = ((refine, "build_cluster_member_data"),
                    (bundle, "build_bundle_member_data"))


def stress_fields(stats: dict) -> dict:
    """The fields of a run's stats that `line3d_tpu`'s
    scripts/stress_exact_profile.py prints for each warm trial: every
    `t_*`, `*probe*`, `*overflow*`, `*rematched*` and `*recollin*`."""
    return {k: v for k, v in stats.items()
            if k.startswith("t_") or any(w in k for w in (
                "probe", "overflow", "rematched", "recollin"))}


def _sync(dev: torch.device):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def make_config(config: str = "exact", capped: bool = False) -> L3DConfig:
    """The L3DConfig of a --config name, with --capped's
    uncapped_fallback=False."""
    kw = dict(FACADE_CONFIGS[config])
    if capped:
        kw["uncapped_fallback"] = False
    return L3DConfig(**kw)


def make_scene(V: int, scene: str, cfg: L3DConfig, device):
    """(Scene, CameraSet) of --scene at V views."""
    if scene == "clutter":
        return make_demo_scene(V, num_random_segments=CLUTTER_SEGMENTS,
                               config=cfg, device=device)
    return make_facade_scene(num_views=V, config=cfg, device=device)


def stem(V: int, scene: str = "facade", config: str = "exact",
         capped: bool = False) -> str:
    """The name of a V's files: V{V} for the default facade exact."""
    if (scene, config, capped) == ("facade", "exact", False):
        return f"V{V}"
    return f"{scene}_{config}{'_capped' if capped else ''}_V{V}"


@contextlib.contextmanager
def _member_counts(counts: list):
    """Record in `counts` the member count of every cluster the fits
    build member data for (the last fit's clusters)."""
    origs = [(mod, name, getattr(mod, name)) for mod, name in
             _MEMBER_DATA_FNS]

    def wrap(orig):
        def built(member_views, *a, **k):
            counts[:] = [len(v) for v in member_views]
            return orig(member_views, *a, **k)
        return built
    try:
        for mod, name, orig in origs:
            setattr(mod, name, wrap(orig))
        yield counts
    finally:
        for mod, name, orig in origs:
            setattr(mod, name, orig)


def run_once(cfg: L3DConfig, scene, cams, jitter: float, device,
             device_selection: bool = True):
    """One model of the scene with its segments shifted by `jitter` px,
    selecting on the device or, without `device_selection`, on the host
    (`Line3D`'s `use_sharded_engine`): (seconds from compute_3d_model to a
    synchronize, Line3D, the kernels' launches in the run, the member
    count of every cluster the fit refined)."""
    l3d = Line3D(config=cfg, use_sharded_engine=device_selection,
                 device=device)
    for v in range(scene.num_views):
        l3d.add_view_segments(
            v, scene.segments[v][scene.seg_mask[v]] + np.float32(jitter),
            cams.K[v], cams.R[v], cams.t[v],
            worldpoint_ids=scene.wp_lists[v], width=int(cams.width[v]),
            height=int(cams.height[v]))
    for mod, attr, _ in _COUNTERS:
        setattr(mod, attr, 0)
    _sync(l3d.device)
    members = []
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(sys.stderr), _member_counts(members):
        l3d.compute_3d_model()       # the pipeline's prints to stderr
    _sync(l3d.device)
    secs = time.perf_counter() - t0
    return secs, l3d, {name: getattr(mod, attr)
                       for mod, attr, name in _COUNTERS}, members


def _txt(l3d) -> bytes:
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "model.txt")
        l3d.save_3d_lines_as_txt(l3d.get_result(), path)
        with open(path, "rb") as f:
            return f.read()


def poses_bytes(l3d) -> bytes | None:
    """The refined poses' bytes (R then t, float64), None without BA."""
    if l3d.refined_poses is None:
        return None
    R, t = l3d.refined_poses
    return np.ascontiguousarray(R).tobytes() + \
        np.ascontiguousarray(t).tobytes()


def _expected(expect: str, name: str, kind: str) -> bytes:
    """The bytes a one-process --out saved: the TXT, or the poses as
    `poses_bytes` lays them out."""
    if kind == "txt":
        with open(os.path.join(expect, f"{name}.txt"), "rb") as f:
            return f.read()
    with np.load(os.path.join(expect, f"{name}_poses.npz")) as z:
        return z["R"].tobytes() + z["t"].tobytes()


def _check_ranks(data: bytes, V: int, expect: str | None,
                 name: str | None = None, kind: str = "txt") -> list | None:
    """Every rank's TXT (or, kind "poses", refined poses) gathered: on rank
    0, whether each equals the expected file's bytes (`expect`'s
    `{name}.txt`, name V{V} by default; or, without `expect`, rank 0's);
    raises when any differs.  None on the other ranks, and in one process
    without `expect`."""
    if multihost.process_count() == 1 and not expect:
        return None
    got = [bytes(x) for x in multihost.allgather_array(
        np.frombuffer(data, np.uint8).copy())]
    if multihost.process_index() != 0:
        return None
    want = _expected(expect, name or f"V{V}", kind) if expect else got[0]
    same = [g == want for g in got]
    if not all(same):
        raise RuntimeError(f"scale_exact_profile: V={V}: the {kind} of "
                           f"ranks {[r for r, s in enumerate(same) if not s]}"
                           f" differs from "
                           f"{'the expected' if expect else 'rank 0'}'s")
    return same


def member_stats(counts) -> dict | None:
    """Clusters fitted and their member counts (median, p99, largest)."""
    if not counts:
        return None
    c = np.asarray(counts)
    return dict(clusters=int(c.size), median=float(np.median(c)),
                p99=float(np.percentile(c, 99)), max=int(c.max()))


def profile_views(V: int, device, n_warm: int = 3, out: str | None = None,
                  expect: str | None = None,
                  device_selection: bool = True, config: str = "exact",
                  scene_name: str = "facade", capped: bool = False) -> dict:
    """The cold and n_warm warm runs of the V-view scene in one
    configuration; the record `main` prints."""
    cfg = make_config(config, capped)
    scene, cams = make_scene(V, scene_name, cfg, device)
    dev = scene.device
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    t_cold, l3d, cold_counts, members = run_once(cfg, scene, cams, 0.0,
                                                 device, device_selection)
    txt, poses = _txt(l3d), poses_bytes(l3d)
    rank, nproc = multihost.process_index(), multihost.process_count()
    name = stem(V, scene_name, config, capped)
    if out:
        os.makedirs(out, exist_ok=True)
        base = name if nproc == 1 else f"{name}_rank{rank}"
        with open(os.path.join(out, f"{base}.txt"), "wb") as f:
            f.write(txt)
        if poses is not None:
            R, t = l3d.refined_poses
            np.savez(os.path.join(out, f"{base}_poses.npz"), R=R, t=t)
    st = l3d.stats
    rec = dict(V=V, S=scene.max_segments, ranks=nproc, rank=rank,
               scene=scene_name, config=config, capped=capped,
               device_selection=device_selection,
               device=str(dev), card=card_line(dev), cold_s=t_cold,
               cold_lines=st["num_lines"],
               cold_stages={k: st[k] for k in STAGES},
               cold_launches=cold_counts,
               cold_match_overflow=st["match_overflow"],
               members=member_stats(members),
               ba_rms=[st.get("ba_rms_before"), st.get("ba_rms_after")],
               warm_s=[],
               txt_sha256=hashlib.sha256(txt).hexdigest(),
               poses_sha256=hashlib.sha256(poses).hexdigest()
               if poses is not None else None,
               **{k: [] for k in STAGES}, launches=[], warm_ba_rms=[],
               warm_stats=[])
    best = None
    for trial in range(n_warm):
        secs, l3d, counts, _ = run_once(cfg, scene, cams,
                                        1e-3 * (trial + 1), device,
                                        device_selection)
        rec["warm_s"].append(secs)
        rec["launches"].append(counts)
        rec["warm_ba_rms"].append([l3d.stats.get("ba_rms_before"),
                                   l3d.stats.get("ba_rms_after")])
        rec["warm_stats"].append(stress_fields(l3d.stats))
        for k in STAGES:
            rec[k].append(l3d.stats[k])
        if best is None or secs < best[0]:
            best = (secs, l3d)
    secs, l3d = best if best else (t_cold, l3d)
    st = l3d.stats
    m_totals = np.unique(st["m_total"], return_counts=True)
    rec.update(
        best_s=secs, images_per_s=V / secs, lines=st["num_lines"],
        edges=st["num_edges"], best_rows=st["num_best"],
        affinity_candidates=st["affinity_candidates"],
        affinity_kept=st["affinity_kept"],
        views_local=st["views_local"],
        m_total={str(m): int(c) for m, c in zip(*m_totals)},
        **{k: st[k] for k in EXACTNESS},
        gathered_bytes=st["gathered_bytes"],
        gathered_by_stage=st["gathered_by_stage"],
        max_memory_allocated=torch.cuda.max_memory_allocated(dev)
        if dev.type == "cuda" else None,
        scene_tensor_bytes=int(sum(t.numel() * t.element_size() for t in
                                   (scene.segments_t, scene.seg_mask_t))),
        peak_rss=resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024)
    rec["txt_equal"] = _check_ranks(txt, V, expect, name)
    rec["poses_equal"] = None if poses is None else \
        _check_ranks(poses, V, expect, name, "poses")
    if out:
        base = name if nproc == 1 else f"{name}_rank{rank}"
        with open(os.path.join(out, f"{base}.json"), "w") as f:
            json.dump(rec, f)
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("views", type=int, nargs="*", default=[100])
    ap.add_argument("--device", default="cuda",
                    help="the models' device (default: the card, the "
                    "rank's card under N ranks; raises without CUDA)")
    ap.add_argument("--warm", type=int, default=3,
                    help="warm runs after the cold one")
    ap.add_argument("--out", default="",
                    help="write each rank's cold TXT (and poses) and "
                    "record here")
    ap.add_argument("--host-selection", action="store_true",
                    help="select on the host (use_sharded_engine=False: "
                    "each view's match tables cross to the host; one "
                    "process only)")
    ap.add_argument("--expect", default="",
                    help="a one-process run's --out: every rank's TXT "
                    "(and poses) must equal its files")
    ap.add_argument("--config", default="exact",
                    choices=sorted(FACADE_CONFIGS),
                    help="the L3DConfig of time_match_view.py's "
                    "--facade-config")
    ap.add_argument("--scene", default="facade",
                    choices=("facade", "clutter"),
                    help="clutter: make_demo_scene(V, "
                    "num_random_segments=2990), S = 3,072")
    ap.add_argument("--capped", action="store_true",
                    help="the capped pass alone (uncapped_fallback=False)")
    args = ap.parse_args(argv)
    require_device(args.device, "scale_exact_profile")
    multihost.initialize()
    for V in args.views:
        rec = profile_views(V, args.device, args.warm, args.out or None,
                            args.expect or None, not args.host_selection,
                            args.config, args.scene, args.capped)
        print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
