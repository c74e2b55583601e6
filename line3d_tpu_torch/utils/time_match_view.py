#!/usr/bin/env python3
"""Time the per-view matching step on one GPU, at views of the 25-view
facade scene (1920 x 1440, S = 1280, N = 10), and optionally whole facade
runs.

    python3 line3d_tpu_torch/utils/time_match_view.py [--root DIR]
        [--views 0 12] [--repeats 50] [--facade N] [--label NAME]

`--root` names the checkout whose `line3d_tpu_torch` is timed (by default
the one this file lies in), so one copy of the script times two commits in
turns on the same card: unpack the other commit with `git archive` and
pass its directory.  Per view, two steps are timed: `match_view` (the
match table) and `view_step`, the view's step as the timed tree's
pipeline runs it (the table, the selection and what crosses to the host:
`match_views` of the one view, or `match_and_select_view` in a tree that
predates `match_views`).  Each repeat is one call followed by
`torch.cuda.synchronize()`, timed by the host clock (what the pipeline pays
per view, launch issue and readbacks included) and by a pair of CUDA
events around it (the same span on the card's clock).  One more call of
each runs with PyTorch's sync debug mode on, which warns at every host
synchronisation the call makes (copies to the host, copies from pageable
host memory, masked_select's count), and one under `torch.profiler`, whose
trace gives the call's device-to-host copies (count, bytes, milliseconds)
and the card's busy time in it.

With `--facade N` the whole facade goes through `Line3D` (exact, the
default config): one cold run, N warm runs (host seconds ending in a
synchronize, `t_match`), and one warm run under the profiler (its
device-to-host copies).

The script prints the card as `nvidia-smi` names it and one JSON line.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
import warnings


def memcpy_totals(prof) -> dict:
    """{copy kind: {"count", "bytes", "ms"}} of a finished torch.profiler
    trace's memcpy events ("DtoH", "HtoD", "DtoD"), read from its Chrome
    trace export (the bytes ride in the events' args)."""
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f).get("traceEvents", [])
    out = {}
    for e in events:
        name = e.get("name", "")
        if e.get("cat") != "gpu_memcpy" and not name.startswith("Memcpy"):
            continue
        kind = next((k for k in ("DtoH", "HtoD", "DtoD") if k in name),
                    "other")
        t = out.setdefault(kind, dict(count=0, bytes=0, ms=0.0))
        t["count"] += 1
        t["bytes"] += int(e.get("args", {}).get("bytes", 0))
        t["ms"] += float(e.get("dur", 0.0)) / 1e3
    return out


# the warning the sync debug mode gives at each synchronising operation
# (the mode also warns, once, that it is a prototype)
SYNC_WARNING = "called a synchronizing CUDA operation"


def count_syncs(fn) -> tuple:
    """(number of host synchronisations fn() makes, the first line of each
    warning) by PyTorch's CUDA sync debug mode."""
    import torch
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    msgs = [str(w.message).splitlines()[0] for w in seen
            if SYNC_WARNING in str(w.message)]
    return len(msgs), msgs


def profiled(fn) -> dict:
    """fn() once under torch.profiler: its memcpy totals by kind, and under
    "device" the card's busy milliseconds, its launches and the device ops
    that took the most time."""
    from collections import defaultdict
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    per_op, n = defaultdict(float), 0
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            per_op[e.name[:60]] += e.time_range.elapsed_us() / 1e3
            n += 1
    out = memcpy_totals(prof)
    out["device"] = dict(
        busy_ms=sum(per_op.values()), events=n,
        top=sorted(per_op.items(), key=lambda kv: -kv[1])[:8])
    return out


def _summary(x):
    import numpy as np
    return dict(median=float(np.median(x)), mean=float(np.mean(x)),
                min=float(np.min(x)))


def time_calls(fn, repeats: int) -> dict:
    """Host-clock and CUDA-event milliseconds of `repeats` calls of fn,
    each ended by a synchronize, after three warm-up calls."""
    import torch
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    host, card = [], []
    for _ in range(repeats):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        e0.record()
        fn()
        e1.record()
        torch.cuda.synchronize()
        host.append((time.perf_counter() - t0) * 1e3)
        card.append(e0.elapsed_time(e1))
    return dict(host_ms=_summary(host), event_ms=_summary(card))


def facade_runs(n_warm: int) -> dict:
    """One cold, n_warm warm and one profiled warm exact facade run
    through Line3D on the card."""
    import torch
    from line3d_tpu_torch import Line3D, L3DConfig
    from line3d_tpu_torch.utils.demo import make_facade_scene
    cfg = L3DConfig()
    scene, cams = make_facade_scene(num_views=25, config=cfg, device="cuda")

    def run():
        l3d = Line3D(config=cfg, device="cuda")
        for v in range(scene.num_views):
            l3d.add_view_segments(
                v, scene.segments[v][scene.seg_mask[v]], cams.K[v],
                cams.R[v], cams.t[v], worldpoint_ids=scene.wp_lists[v],
                width=int(cams.width[v]), height=int(cams.height[v]))
        t0 = time.perf_counter()
        l3d.compute_3d_model()
        torch.cuda.synchronize()
        return l3d, time.perf_counter() - t0

    _, cold = run()
    warm, t_match = [], []
    for _ in range(n_warm):
        l3d, t = run()
        warm.append(t)
        t_match.append(l3d.stats["t_match"])
    out = {}
    copies = profiled(lambda: out.setdefault("l3d", run()[0]))
    return dict(cold=cold, warm=warm, t_match=t_match,
                lines=out["l3d"].stats["num_lines"],
                profiled_t_match=out["l3d"].stats["t_match"],
                profiled_copies=copies)


def main(argv=None) -> int:
    here = os.path.dirname(os.path.abspath(__file__))
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(here)))
    ap.add_argument("--views", type=int, nargs="+", default=[0, 12])
    ap.add_argument("--repeats", type=int, default=50)
    ap.add_argument("--facade", type=int, default=0,
                    help="warm facade runs through Line3D (0: none)")
    ap.add_argument("--label", default="")
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.abspath(args.root))

    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("time_match_view: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 2
    from line3d_tpu_torch import L3DConfig
    from line3d_tpu_torch.core.conditioning import compute_conditioning
    from line3d_tpu_torch.match import engine
    from line3d_tpu_torch.scene import find_visual_neighbors, \
        view_similarities_from_worldpoints
    from line3d_tpu_torch.utils.demo import make_facade_scene

    cfg = L3DConfig()
    scene, cams = make_facade_scene(num_views=25, config=cfg, device="cuda")
    sim, _ = view_similarities_from_worldpoints(scene.wp_lists,
                                                scene.num_views)
    nbrs = find_visual_neighbors(sim, cams.baselines(), cfg.min_baseline,
                                 cfg.matching_neighbors, cfg.eps)
    tr = compute_conditioning(cams.C)
    cams.transform(tr.Qinv, tr.scale)
    ctx = engine.ViewContext(scene, cams, cfg)

    out = dict(label=args.label, root=os.path.abspath(args.root),
               repeats=args.repeats, views={})
    for v in args.views:
        nb = np.asarray(nbrs[v], np.int64)
        o = engine.match_view(ctx, v, nb)
        rec = dict(m_total=int(o["m_total"]), need=int(o["need"]),
                   verified=int((o["valid"] & (o["conf"] > 1.0)).sum()))
        for name, fn in (
                ("match_view", lambda: engine.match_view(ctx, v, nb)),
                ("view_step",
                 (lambda: engine.match_views(ctx, nbrs, [v]))
                 if hasattr(engine, "match_views")
                 else lambda: engine.match_and_select_view(ctx, v, nb))):
            rec[name] = time_calls(fn, args.repeats)
            rec[name]["syncs"], rec[name]["sync_warnings"] = count_syncs(fn)
            rec[name]["copies"] = profiled(fn)
        out["views"][str(v)] = rec
    if args.facade:
        out["facade"] = facade_runs(args.facade)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
