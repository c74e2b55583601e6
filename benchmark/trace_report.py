#!/usr/bin/env python3
"""The program's recorder (`line3d_tpu_torch/trace.py`) on a cell's capture.

    python3 benchmark/trace_report.py <cell> [--check] [--profile]
        [--seed 7] [--device cpu] [--views V --segments S] [--out FILE]

The capture and the L3DConfig are the cell's; each model is `run.py`'s
(`run_model`: a fresh Line3D, every view shifted by a sub-pixel offset
drawn from the seed, `compute_3d_model()`, a synchronize).  After one cold
model:
  * `--check`: `line3d_tpu_torch/utils/trace_check.check` on the cell's
    models: the recorder's synchronisations and device-to-host bytes
    against PyTorch's sync debug mode and the profiler's device-to-host
    copies (equal when every synchronisation passes through
    `trace.readback`).  Run it first in its process: a process's first
    profiler trace keeps every device event.
  * `--profile`: one model with the recorder on under torch.profiler: the
    card's busy seconds, the idle seconds by the innermost program span
    (`l3d.*`) the host was in, named as `tracing.summarize` names them
    (`idle_gaps_program`; "outside spans" where no span holds a gap's
    middle) and that share of the idle seconds, the device ops, and the
    per-layer quantities of the model (`summary`).
`--views` / `--segments` cut the capture for a CPU rehearsal (`--device
cpu`, without `--check`).  Prints one JSON line.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from benchmark import run as bench, scenes, tracing      # noqa: E402


def cell(name: str, views: int | None = None, segments: int | None = None):
    """(capture, L3DConfig keywords, offset bound in px) of a cell."""
    spec = bench.cell_spec(name)
    scene = dict(spec["config"]["scene"])
    if views:
        scene["num_views"] = views
    if segments:
        scene["max_segments"] = segments
    return (scenes.make_capture(scene), bench.l3d_config(spec),
            float(spec["workload"]["offset_px"]))


def summary(l3d, collected: dict) -> dict:
    """One recorded model's per-layer quantities: the device ms a view of
    each per-view match span (read from the spans), and from `stats` the
    match step's readback wait a view, the affinity stage's parts and the
    model's readbacks, with the readbacks by site (the counters)."""
    st, V = l3d.stats, l3d.stats["num_views"]
    out = {f"{n}_device_ms_per_view": 1e3 * sum(
        s["device_s"] or 0.0 for s in collected["spans"]
        if s["name"] == n) / V
        for n in ("match.k1", "match.compact", "match.depths",
                  "match.score", "match.select")}
    out.update(match_wait_ms_per_view=1e3 * st["t_match_wait"] / V,
               t_match=st["t_match"], t_affinity=st["t_affinity"],
               t_affinity_pairs=st["t_affinity_pairs"],
               t_affinity_enum=st["t_affinity_enum"],
               t_affinity_weights=st["t_affinity_weights"],
               dtoh_mb=st["readback_bytes"] / 1e6,
               syncs=st["readback_syncs"])
    c = collected["counters"]
    out["by_site"] = {k[len("syncs."):]: [v, c["dtoh_bytes." + k[6:]]]
                      for k, v in c.items() if k.startswith("syncs.")}
    return out


def profiled(model) -> dict:
    """model() computes one model and returns its Line3D; it runs with the
    recorder on under torch.profiler.  Busy and idle seconds, the idle
    seconds by program span, the share outside every span, the device ops
    and the model's summary."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function
    from line3d_tpu_torch import trace
    acts = [ProfilerActivity.CPU] + \
        ([ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
    with trace.recording(), profile(activities=acts) as prof:
        with record_function("report.window"):
            l3d = model()
        got = summary(l3d, trace.collect())
    dev, spans, window = [], [], (0, 0)
    for e in prof.events():
        tr = e.time_range
        if e.name == "report.window":
            if e.device_type != DeviceType.CUDA:
                window = (tr.start, tr.end)
        elif e.name.startswith("l3d."):
            if e.device_type != DeviceType.CUDA:
                spans.append((e.name[len("l3d."):], tr.start, tr.end))
        elif e.device_type == DeviceType.CUDA:
            dev.append((e.name, tr.start, tr.end))
    busy, _, bd = tracing.summarize(dev, spans, *window, top=1000)
    idle = sum(v for _, v in bd["idle_gaps"])
    outside = dict(bd["idle_gaps"]).get("outside spans", 0.0)
    return dict(busy_s=busy, window_s=(window[1] - window[0]) / 1e6,
                idle_s=idle, outside_share=outside / idle if idle else None,
                idle_gaps_program=bd["idle_gaps"][:20],
                device_ops=bd["device_ops"][:12], summary=got)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("cell")
    ap.add_argument("--check", action="store_true")
    ap.add_argument("--profile", action="store_true")
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--views", type=int)
    ap.add_argument("--segments", type=int)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    import numpy as np
    import torch
    if args.device != "cpu" and not torch.cuda.is_available():
        raise SystemExit("trace_report: no CUDA device (use --device cpu "
                         "for a rehearsal)")
    if args.check and args.device == "cpu":
        raise SystemExit("trace_report: --check needs the card")
    capture, cfg_kw, a = cell(args.cell, args.views, args.segments)
    rng = np.random.default_rng([args.seed, 5])

    def model():
        return bench.run_model(capture, bench.shifted(
            capture, rng.uniform(-a, a, 2)), cfg_kw, args.device,
            bench.Recorder())
    model()                                                   # cold
    out = dict(cell=args.cell, seed=args.seed,
               device=args.device if args.device == "cpu"
               else torch.cuda.get_device_name(0),
               power_limit_w=None if args.device == "cpu"
               else bench.power_limit())
    if args.check:
        from line3d_tpu_torch.utils.trace_check import check
        out["check"] = check(model)
    if args.profile:
        out["profile"] = profiled(model)
    line = json.dumps(out)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(line)


if __name__ == "__main__":
    main()
