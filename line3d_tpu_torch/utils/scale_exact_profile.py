"""The exact facade path at scale: `Line3D` on `make_facade_scene(V)` for
each V given, with its stage times, exactness, kernel launches and memory.

    python3 -m line3d_tpu_torch.utils.scale_exact_profile [V ...]
        [--device cpu] [--warm 3] [--out DIR] [--expect DIR]
        [--host-selection]
    torchrun --nproc_per_node N -m line3d_tpu_torch.utils.scale_exact_profile
        V ... --expect DIR

The port's counterpart of `line3d_tpu`'s scripts/scale_exact_profile.py
(no JAX): the default configuration (exact matching with the capacity
probe and the uncapped fallback, collinearity on, exact F-H; no diffusion,
refinement or bundle adjustment) on the 1920 x 1440 facade.  For each V:
one cold run, then `--warm` runs with the segments shifted by
1e-3 * (trial + 1) px.  Each run is timed by the host clock from
`compute_3d_model` to a `torch.cuda.synchronize()`.  One JSON line per V
(per rank) gives the cold and every warm trial's seconds, images/s of the
best, the lines, every trial's `t_*`, the exactness fields
(`match_overflow`, `views_rematched_uncapped`, `probe_m_total`,
`collinearity_overflow`, `views_recollin_exact`, the collinear pairs
still dropped after the fallback), the kernels' launches in each warm run
(the wrappers' `LAUNCHES`), `torch.cuda.max_memory_allocated` over the V's
runs, the process's peak RSS, `gathered_by_stage`, and the sha256 of the
cold run's TXT.  `--host-selection` runs the models with
`use_sharded_engine=False` (each view's [S, M] tables copied to the host
and selected there; the same model), which a multi-process run refuses.

Under N ranks (torchrun, or `multihost.initialize` before `main`) every
rank runs its share of each model.  Each rank writes its cold run's TXT
(`--out DIR`: `V{V}.txt` in one process, `V{V}_rank{r}.txt` under N); the
TXTs are gathered, and rank 0 checks that every rank's equals the TXT a
one-process run saved before (`--expect DIR`, its `V{V}.txt`) and, without
it, that the ranks agree; it raises when they differ.  The device is the
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
from ..match import collinearity_cuda, pairwise_cuda, scoring_cuda
from ..parallel import multihost
from .demo import make_facade_scene
from .host_stage_scaling import card_line

# the wrappers' launch counters: (module, counter, name in the record)
_COUNTERS = ((pairwise_cuda, "LAUNCHES", "pair_valid"),
             (collinearity_cuda, "LAUNCHES", "collin_pairs"),
             (scoring_cuda, "LAUNCHES", "score"),
             (scoring_cuda, "LAUNCHES_WIDE", "score_wide"))
STAGES = ("t_setup", "t_graph", "t_collin", "t_match", "t_affinity",
          "t_diffusion", "t_fh", "t_fit", "t_cluster", "t_total")
EXACTNESS = ("match_overflow", "views_rematched_uncapped", "probe_m_total",
             "collinearity_overflow", "views_recollin_exact")


def _sync(dev: torch.device):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def run_once(cfg: L3DConfig, scene, cams, jitter: float, device,
             device_selection: bool = True):
    """One model of the scene with its segments shifted by `jitter` px,
    selecting on the device or, without `device_selection`, on the host
    (`Line3D`'s `use_sharded_engine`): (seconds from compute_3d_model to a
    synchronize, Line3D, the kernels' launches in the run)."""
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
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(sys.stderr):     # the pipeline's prints
        l3d.compute_3d_model()
    _sync(l3d.device)
    secs = time.perf_counter() - t0
    return secs, l3d, {name: getattr(mod, attr)
                       for mod, attr, name in _COUNTERS}


def _txt(l3d) -> bytes:
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "model.txt")
        l3d.save_3d_lines_as_txt(l3d.get_result(), path)
        with open(path, "rb") as f:
            return f.read()


def _check_ranks(txt: bytes, V: int, expect: str | None) -> list | None:
    """Every rank's TXT gathered: on rank 0, whether each equals the
    expected file's bytes (or, without one, rank 0's); raises when any
    differs.  None on the other ranks, and in one process without
    `expect`."""
    if multihost.process_count() == 1 and not expect:
        return None
    got = [bytes(x) for x in multihost.allgather_array(
        np.frombuffer(txt, np.uint8).copy())]
    if multihost.process_index() != 0:
        return None
    if expect:
        with open(os.path.join(expect, f"V{V}.txt"), "rb") as f:
            want = f.read()
    else:
        want = got[0]
    same = [g == want for g in got]
    if not all(same):
        raise RuntimeError(f"scale_exact_profile: V={V}: the TXT of ranks "
                           f"{[r for r, s in enumerate(same) if not s]} "
                           f"differs from "
                           f"{'the expected' if expect else 'rank 0'}'s")
    return same


def profile_views(V: int, device, n_warm: int = 3, out: str | None = None,
                  expect: str | None = None,
                  device_selection: bool = True) -> dict:
    """The cold and n_warm warm runs of the V-view facade; the record
    `main` prints."""
    cfg = L3DConfig()
    scene, cams = make_facade_scene(num_views=V, config=cfg, device=device)
    dev = scene.device
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    t_cold, l3d, _ = run_once(cfg, scene, cams, 0.0, device,
                              device_selection)
    txt = _txt(l3d)
    rank, nproc = multihost.process_index(), multihost.process_count()
    if out:
        os.makedirs(out, exist_ok=True)
        name = f"V{V}.txt" if nproc == 1 else f"V{V}_rank{rank}.txt"
        with open(os.path.join(out, name), "wb") as f:
            f.write(txt)
    rec = dict(V=V, S=scene.max_segments, ranks=nproc, rank=rank,
               device_selection=device_selection,
               device=str(dev), card=card_line(dev), cold_s=t_cold,
               cold_lines=l3d.stats["num_lines"], warm_s=[],
               txt_sha256=hashlib.sha256(txt).hexdigest(),
               **{k: [] for k in STAGES}, launches=[])
    best = None
    for trial in range(n_warm):
        secs, l3d, counts = run_once(cfg, scene, cams, 1e-3 * (trial + 1),
                                     device, device_selection)
        rec["warm_s"].append(secs)
        rec["launches"].append(counts)
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
        views_local=st["views_local"],
        m_total={str(m): int(c) for m, c in zip(*m_totals)},
        collin_dropped_left=int(l3d.scene.collin.dropped_total),
        **{k: st[k] for k in EXACTNESS},
        gathered_bytes=st["gathered_bytes"],
        gathered_by_stage=st["gathered_by_stage"],
        max_memory_allocated=torch.cuda.max_memory_allocated(dev)
        if dev.type == "cuda" else None,
        scene_tensor_bytes=int(sum(t.numel() * t.element_size() for t in
                                   (scene.segments_t, scene.seg_mask_t))),
        peak_rss=resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024)
    rec["txt_equal"] = _check_ranks(txt, V, expect)
    if out:
        name = f"V{V}.json" if nproc == 1 else f"V{V}_rank{rank}.json"
        with open(os.path.join(out, name), "w") as f:
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
                    help="write each rank's cold TXT and record here")
    ap.add_argument("--host-selection", action="store_true",
                    help="select on the host (use_sharded_engine=False: "
                    "each view's match tables cross to the host; one "
                    "process only)")
    ap.add_argument("--expect", default="",
                    help="a one-process run's --out: every rank's TXT "
                    "must equal its V{V}.txt")
    args = ap.parse_args(argv)
    if torch.device(args.device).type == "cuda" and \
            not torch.cuda.is_available():
        raise RuntimeError("scale_exact_profile: device 'cuda' requested "
                           "but torch.cuda.is_available() is False (pass "
                           "--device cpu)")
    multihost.initialize()
    for V in args.views:
        rec = profile_views(V, args.device, args.warm, args.out or None,
                            args.expect or None, not args.host_selection)
        print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
