#!/usr/bin/env python3
"""Time the per-view matching step (`match.engine.match_view`) alone on one
GPU, at views of the 25-view facade scene (1920 x 1440, S = 1280, N = 10).

    python3 line3d_tpu_torch/utils/time_match_view.py [--root DIR]
        [--views 0 12] [--repeats 50] [--label NAME]

`--root` names the checkout whose `line3d_tpu_torch` is timed (by default
the one this file lies in), so one copy of the script times two commits in
turns on the same card: unpack the other commit with `git archive` and
pass its directory.  Each repeat is one `match_view` call
followed by `torch.cuda.synchronize()`; it is timed by the host clock (what
the pipeline pays per view, launch issue and readbacks included) and by a
pair of CUDA events around it (the same span on the card's clock).  The
script prints the card as `nvidia-smi` names it and one JSON line with, per
view, the median, mean and minimum of both in milliseconds.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time


def main(argv=None) -> int:
    here = os.path.dirname(os.path.abspath(__file__))
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(here)))
    ap.add_argument("--views", type=int, nargs="+", default=[0, 12])
    ap.add_argument("--repeats", type=int, default=50)
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
        for _ in range(3):
            o = engine.match_view(ctx, v, nb)
        torch.cuda.synchronize()
        host, card = [], []
        for _ in range(args.repeats):
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            t0 = time.perf_counter()
            e0.record()
            engine.match_view(ctx, v, nb)
            e1.record()
            torch.cuda.synchronize()
            host.append((time.perf_counter() - t0) * 1e3)
            card.append(e0.elapsed_time(e1))

        def summary(x):
            return dict(median=float(np.median(x)), mean=float(np.mean(x)),
                        min=float(np.min(x)))
        out["views"][str(v)] = dict(
            m_total=int(o["m_total"]), need=int(o["need"]),
            host_ms=summary(host), event_ms=summary(card))
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
