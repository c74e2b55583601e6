#!/usr/bin/env python3
"""Time the per-view matching step on one GPU, at views of the 25-view
facade scene (1920 x 1440, S = 1280, N = 10), and optionally whole facade
runs and their cluster stage.

    python3 line3d_tpu_torch/utils/time_match_view.py [--root DIR]
        [--views [0 12]] [--repeats 50] [--facade N] [--label NAME]
        [--facade-config exact|facaded|facadeba ...] [--fit-tiles K ...]
        [--save FILE]
    python3 line3d_tpu_torch/utils/time_match_view.py --compare A B

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

With `--facade N` the whole facade goes through `Line3D`, once for each
`--facade-config`: exact (the default config); facaded, `chip_smoke.py`'s
phase of that name (reference-mode device diffusion and device
refinement); facadeba, its phase of that name (true-mode device diffusion,
the round-parallel F-H and the bundle adjustment).  Each has one cold
run, N warm runs (host seconds ending in a synchronize, and the stage
times `t_match`, `t_diffusion`, `t_fh`, `t_fit`, `t_cluster`), one warm
run under the profiler (its device-to-host copies) and the sha256 of the
model's TXT.  `--fit-tiles K ...` then times the configuration's device
fit alone (`refine_lines_device` or `bundle_adjust`) on the inputs the
last run gave it, with the clusters repeated K times (one warm-up and
three timed calls at each K: at K = 5 the facade's clusters fill 12
blocks of 256), and records the sha256 of those inputs.  `--save FILE`
keeps the last run's device diffusion weights, refined lines, poses and
TXT of each configuration in an .npz.  `--compare A B` reads two such
files (no card needed) and prints, per output, how many values differ and
by how much, and whether the TXT models are equal byte for byte (else
A's tokens against B's as `compare_txt` reads them).

The timing mode prints the card as `nvidia-smi` names it and one JSON
line.
"""
from __future__ import annotations

import argparse
import hashlib
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


# the L3DConfig keywords of each --facade-config
FACADE_CONFIGS = dict(
    exact=dict(),
    facaded=dict(perform_diffusion=True, refine_lines=True),
    facadeba=dict(perform_diffusion=True, diffusion_mode="true",
                  fh_backend="parallel", bundle_adjust_cameras=True))

# the functions whose calls facade_runs records: the device diffusion and
# the device fits, with the positional arguments of a fit that hold one
# row per cluster
RECORDED = dict(diffuse_reference_device=(), diffuse_true_device=(),
                refine_lines_device=(0, 1, 2, 3, 4, 5),
                bundle_adjust=(0, 1, 5, 6, 7, 8))


# the last call of each function of RECORDED: name -> (args, kwargs, result)
SEEN: dict = {}


def record_calls() -> dict:
    """SEEN, emptied; the functions of RECORDED are wrapped (on the first
    call) so that each call lands there."""
    from line3d_tpu_torch.cluster import diffusion_device
    from line3d_tpu_torch.fit import bundle, refine
    seen = SEEN
    seen.clear()
    if getattr(refine.refine_lines_device, "recorded", False):
        return seen
    for module in (diffusion_device, refine, bundle):
        for name in RECORDED:
            if not hasattr(module, name):
                continue
            orig = getattr(module, name)

            def wrapped(*a, _orig=orig, _name=name, **k):
                out = _orig(*a, **k)
                seen[_name] = (a, k, out)
                return out
            wrapped.recorded = True
            setattr(module, name, wrapped)
    return seen


def _outputs(seen: dict, txt: bytes) -> dict:
    """The arrays --save keeps of one run, from its recorded calls."""
    import numpy as np
    out = dict(txt=np.frombuffer(txt, np.uint8))
    for name, (_, _, res) in seen.items():
        if name.startswith("diffuse"):
            out["diffusion_w"] = np.asarray(res[2])
        elif name == "refine_lines_device":
            out["refine_P0"], out["refine_d"] = res[0], res[1]
        else:
            out["ba_P0"], out["ba_d"], out["ba_R"], out["ba_t"] = res[:4]
    return out


def time_fit(seen: dict, tiles) -> dict:
    """Seconds of the recorded device fit called alone on its inputs with
    the clusters repeated K times, for each K of tiles; and the sha256 of
    the inputs."""
    import numpy as np
    from line3d_tpu_torch.fit import bundle, refine
    name = next(n for n in ("bundle_adjust", "refine_lines_device")
                if n in seen)
    fn = getattr(bundle if name == "bundle_adjust" else refine, name)
    args, kwargs, _ = seen[name]
    h = hashlib.sha256()
    for a in args:
        h.update(np.ascontiguousarray(a).tobytes())
    out = dict(fit=name, clusters=len(args[0]),
               inputs_sha256=h.hexdigest(), tiles={})
    for k in tiles:
        tiled = [np.concatenate([a] * k) if i in RECORDED[name] else a
                 for i, a in enumerate(args)]
        fn(*tiled, **kwargs)
        secs = []
        for _ in range(3):
            t0 = time.perf_counter()
            fn(*tiled, **kwargs)
            secs.append(time.perf_counter() - t0)
        out["tiles"][str(k)] = secs
    return out


def facade_runs(n_warm: int, config: str = "exact", fit_tiles=(),
                saved: dict | None = None) -> dict:
    """One cold, n_warm warm and one profiled warm facade run of one
    configuration through Line3D on the card; then its device fit alone at
    fit_tiles, and the last run's outputs into saved."""
    import torch
    from line3d_tpu_torch import Line3D, L3DConfig
    from line3d_tpu_torch.utils.demo import make_facade_scene
    cfg = L3DConfig(**FACADE_CONFIGS[config])
    scene, cams = make_facade_scene(num_views=25, config=cfg, device="cuda")
    seen = record_calls()

    def run():
        l3d = Line3D(config=cfg, device="cuda")
        for v in range(scene.num_views):
            l3d.add_view_segments(
                v, scene.segments[v][scene.seg_mask[v]], cams.K[v],
                cams.R[v], cams.t[v], worldpoint_ids=scene.wp_lists[v],
                width=int(cams.width[v]), height=int(cams.height[v]))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        l3d.compute_3d_model()
        torch.cuda.synchronize()
        return l3d, time.perf_counter() - t0

    _, cold = run()
    rec = dict(cold=cold, warm=[])
    stages = ("t_match", "t_diffusion", "t_fh", "t_fit", "t_cluster")
    for k in stages:
        rec[k] = []
    for _ in range(n_warm):
        l3d, t = run()
        rec["warm"].append(t)
        for k in stages:
            rec[k].append(l3d.stats[k])
    out = {}
    copies = profiled(lambda: out.setdefault("l3d", run()[0]))
    l3d = out["l3d"]
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "model.txt")
        l3d.save_3d_lines_as_txt(l3d.get_result(), path)
        with open(path, "rb") as f:
            txt = f.read()
    rec.update(lines=l3d.stats["num_lines"], edges=l3d.stats["num_edges"],
               txt_sha256=hashlib.sha256(txt).hexdigest(),
               profiled_t_match=l3d.stats["t_match"],
               profiled_copies=copies)
    if saved is not None:
        saved.update({f"{config}_{k}": v
                      for k, v in _outputs(seen, txt).items()})
    if fit_tiles and config != "exact":
        rec["fit_alone"] = time_fit(seen, fit_tiles)
    return rec


def _compare_txt_bytes(got: bytes, want: bytes) -> dict:
    """`io.writers.compare_txt` of two TXT models held as bytes: integer
    tokens that differ, float tokens outside rtol 1e-5 / atol 1e-6, the
    worst ratio of error to tolerance."""
    from line3d_tpu_torch.io.writers import compare_txt
    with tempfile.TemporaryDirectory() as d:
        paths = [os.path.join(d, n) for n in ("got.txt", "want.txt")]
        for path, text in zip(paths, (got, want)):
            with open(path, "wb") as f:
                f.write(text)
        r = compare_txt(*paths)
    return dict(tokens=r["n_tokens"], int_bad=r["int_bad"],
                floats_outside=len(r["outside"]),
                worst_ratio=r["worst_ratio"], worst=r["worst"])


def compare(path_a, path_b) -> dict:
    """Per output of two saved runs: values that differ, the largest
    absolute and relative differences; and whether the TXT are equal."""
    import numpy as np
    a, b = np.load(path_a), np.load(path_b)
    rep = {}
    for k in sorted(set(a.files) & set(b.files)):
        x, y = a[k], b[k]
        if k.endswith("txt"):
            rep[k] = dict(equal=x.tobytes() == y.tobytes(), bytes=x.size,
                          **_compare_txt_bytes(x.tobytes(), y.tobytes()))
            continue
        if x.shape != y.shape:
            rep[k] = dict(shape_a=x.shape, shape_b=y.shape)
            continue
        d = np.abs(x - y)
        rep[k] = dict(n=int(x.size), differ=int((d > 0).sum()),
                      max_abs=float(d.max(initial=0.0)),
                      max_rel=float((d / np.maximum(np.abs(y), 1e-30))
                                    .max(initial=0.0)))
    return rep


def main(argv=None) -> int:
    here = os.path.dirname(os.path.abspath(__file__))
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(here)))
    ap.add_argument("--views", type=int, nargs="*", default=[0, 12])
    ap.add_argument("--repeats", type=int, default=50)
    ap.add_argument("--facade", type=int, default=0,
                    help="warm facade runs through Line3D (0: none)")
    ap.add_argument("--facade-config", nargs="+", default=["exact"],
                    choices=sorted(FACADE_CONFIGS))
    ap.add_argument("--fit-tiles", type=int, nargs="*", default=[])
    ap.add_argument("--save", default="")
    ap.add_argument("--compare", nargs=2, metavar=("A", "B"))
    ap.add_argument("--label", default="")
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.abspath(args.root))
    if args.compare:
        print(json.dumps(compare(*args.compare)))
        return 0

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
    saved = {} if args.save else None
    if args.facade:
        for config in args.facade_config:
            key = "facade" if config == "exact" else f"facade_{config}"
            out[key] = facade_runs(args.facade, config, args.fit_tiles,
                                   saved)
    if args.save:
        np.savez(args.save, **saved)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
