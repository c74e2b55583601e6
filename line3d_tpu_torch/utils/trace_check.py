#!/usr/bin/env python3
"""Hold the recorder's counts (`line3d_tpu_torch/trace.py`) to PyTorch's
own on the card: every host synchronisation and every device-to-host copy
of a model must pass through `trace.readback`.

    python3 -m line3d_tpu_torch.utils.trace_check facade|clutter
        [--views 25]

The scene is `scale_exact_profile`'s at `--views` views (the 1920 x 1440
facade, or the clutter scene at S = 3,072), the default configuration.
After one cold model, one model runs under PyTorch's sync debug mode and
one under torch.profiler: the recorder's synchronisations and bytes
(`stats["readback_syncs"]`, `["readback_bytes"]`) against the debug mode's
count and the profiler's device-to-host copy bytes.  They are equal when
no other synchronisation or copy exists.  Run it in a process of its own:
the first profiler trace a process takes keeps every device event.  Prints
one JSON line, the card in it; raises without CUDA.
"""
from __future__ import annotations

import argparse
import json


def check(run) -> dict:
    """run() computes one model and returns its Line3D: the recorder's
    synchronisations and bytes of one such model against the sync debug
    mode's count, and of another against the profiler's device-to-host
    copies."""
    from torch.profiler import ProfilerActivity, profile
    from .time_match_view import count_syncs, memcpy_totals
    seen = {}
    n_debug, where = count_syncs(lambda: seen.update(l3d=run()))
    out = dict(syncs_recorder=seen["l3d"].stats["readback_syncs"],
               syncs_debug=n_debug, sync_warnings=sorted(set(where)))
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        st = run().stats
    d2h = memcpy_totals(prof).get("DtoH", dict(count=0, bytes=0, ms=0.0))
    out.update(dtoh_bytes_recorder=st["readback_bytes"],
               dtoh_bytes_profiler=d2h["bytes"], dtoh_copies=d2h["count"],
               dtoh_ms=d2h["ms"],
               views_recollin_exact=st["views_recollin_exact"],
               views_rematched_uncapped=st["views_rematched_uncapped"])
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("scene", choices=["facade", "clutter"])
    ap.add_argument("--views", type=int, default=25)
    args = ap.parse_args(argv)
    import torch
    from . import scale_exact_profile as sep
    from .host_stage_scaling import card_line, require_device
    require_device("cuda", "trace_check")
    dev = torch.device("cuda")
    cfg = sep.make_config()
    scene, cams = sep.make_scene(args.views, args.scene, cfg, dev)
    jitter = iter(1e-3 * (k + 1) for k in range(3))

    def run():
        return sep.run_once(cfg, scene, cams, next(jitter), dev)[1]
    run()                                                    # cold
    out = dict(scene=args.scene, views=args.views,
               S=scene.max_segments, card=card_line(dev), **check(run))
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
