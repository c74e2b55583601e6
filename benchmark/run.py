"""The benchmark of line3d_tpu_torch: one cell, one run, one JSON line.

    python3 benchmark/run.py --workload facade_p25.exact --seed 7 \\
        --seconds 45 --trace 0

Set-up (`setup_s`, from process start): import the port, draw the cell's
capture, and run one cold model of the cell's shapes.  The window is a
closed loop of whole models: each builds a fresh `Line3D` on the card,
adds every view's segments shifted by a sub-pixel offset drawn from the
seed, runs `compute_3d_model()` and ends in `torch.cuda.synchronize()`;
models run back to back until `--seconds` have passed and the last one
finishes.  Then one model, drawn from the seed, is held to the plain
reference (check.py).  `--trace 1` also profiles one more model as the
window closes and reports the cell's per-layer metrics instead of its
end-to-end ones.

Everything a cell is made of is found by name: its workload
(workloads/<cell>.json), its configuration (configs/<config>.json) and
its metrics (metrics/<metric>.py), as BENCHMARK.json lists them.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import dataclasses  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import traceback  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
# modules whose presence after the window means JAX or the JAX package
# ran in this process (compared by whole top-level name)
FORBIDDEN = ("jax", "jaxlib", "flax", "line3d_tpu")
# the check draws its model from the window's first CHECK_WITHIN models
# (fewer than any cell's window holds) and checks the match step of as
# many views as the workload's "check" asks ("views"), CHECK_VIEWS where
# it does not say
CHECK_WITHIN, CHECK_VIEWS = 8, 4


def check_views(rng, wl, V):
    """The views whose match step the check holds to the reference, drawn
    from the seed."""
    n = min(int(wl["check"].get("views", CHECK_VIEWS)), V)
    return sorted(rng.choice(V, size=n, replace=False).tolist())


def load_json(path):
    with open(path) as f:
        return json.load(f)


def cell_spec(name: str, root: str = ROOT) -> dict:
    """The cell `name`: its BENCHMARK.json entry, workload file,
    configuration file, and the metrics it reports (end-to-end and
    per-layer) with their BENCHMARK.json entries."""
    bench = load_json(os.path.join(root, "BENCHMARK.json"))
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    wl = load_json(os.path.join(root, "benchmark", "workloads",
                                f"{name}.json"))
    conf = next(c for c in bench["configs"] if c["name"] == entry["config"])
    cfg = load_json(os.path.join(root, conf["file"]))

    def applies(m):
        return name in m.get("workloads", [name])
    e2e = [m for m in bench["end_to_end"] if applies(m)]
    # a per-layer metric without a list goes with the metric it moves
    reported = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"] if applies(m) and
                 ("workloads" in m or m["moves"] in reported)]
    return dict(name=name, chips=entry["chips"], workload=wl, config=cfg,
                end_to_end=e2e, per_layer=per_layer, root=root)


def metric_reader(name: str, root: str = ROOT):
    """The module metrics/<name>.py: its `read(record)` gives the value or
    None where the record holds nothing to read.  A quantity split by the
    cells' end-to-end metric (<base>.<part>, as images_per_s.device_bound)
    is read by metrics/<base>.py where it has no file of its own."""
    path = os.path.join(root, "benchmark", "metrics", f"{name}.py")
    if not os.path.exists(path):
        path = os.path.join(root, "benchmark", "metrics",
                            f"{name.split('.')[0]}.py")
    spec = importlib.util.spec_from_file_location(f"_bench_metric_{name}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def l3d_config(spec: dict) -> dict:
    """The L3DConfig keyword arguments of a cell: the configuration's
    overrides, then those its traffic asks for."""
    return {**spec["config"].get("l3d", {}),
            **spec["workload"].get("pipeline", {})}


class Recorder:
    """Patches the pipeline's calls into its layers: records what the
    affinity graph, the diffusion and F-H returned to the current model
    (references only, no copies), and, while tracing, wraps each layer in
    a profiler span named bench.<layer>."""

    def __init__(self):
        self.current = {}
        self.spans = False
        self._undo = []

    def _wrap(self, module, attr, layer, keep=None):
        from torch.profiler import record_function
        orig = getattr(module, attr)

        def wrapped(*a, **k):
            cm = record_function(f"bench.{layer}") if self.spans \
                else contextlib.nullcontext()
            with cm:
                out = orig(*a, **k)
            if keep is not None:
                keep(self.current, a, out)
            return out
        setattr(module, attr, wrapped)
        self._undo.append((module, attr, orig))

    def install(self):
        from line3d_tpu_torch import pipeline
        from line3d_tpu_torch.cluster import affinity, diffusion, fh
        from line3d_tpu_torch.fit import lines
        from line3d_tpu_torch.match import engine

        def graph(cur, a, g):
            cur["graph"] = dict(i=g.edges_i, j=g.edges_j, w=g.edges_w,
                                n=g.num_nodes, view=g.node_view,
                                seg=g.node_seg)
            cur["clustered"] = cur["graph"]

        def diffused(cur, a, g):
            cur["clustered"] = dict(i=g.edges_i, j=g.edges_j, w=g.edges_w,
                                    n=g.num_nodes, view=g.node_view,
                                    seg=g.node_seg)

        def labels(cur, a, lab):
            cur["labels"] = lab
        self._wrap(pipeline, "collinearity_maps_fast", "collinearity")
        self._wrap(engine, "run_matching", "matching")
        self._wrap(affinity, "build_affinity_graph", "affinity", graph)
        self._wrap(diffusion, "run_diffusion", "diffusion", diffused)
        self._wrap(fh, "fh_cluster", "fh", labels)
        self._wrap(lines, "process_clusters", "fit")

    def uninstall(self):
        for module, attr, orig in reversed(self._undo):
            setattr(module, attr, orig)
        self._undo = []


def shifted(capture, offset):
    """Every view's segments moved by (dx, dy) pixels, in float32."""
    import numpy as np
    d = np.asarray([offset[0], offset[1]] * 2, np.float32)
    return [s + d for s in capture.segments]


def run_model(capture, segs, cfg_kw, device, recorder):
    """One model: a fresh Line3D, every view added, compute_3d_model, a
    synchronize.  Returns the Line3D."""
    import torch
    from line3d_tpu_torch import Line3D, L3DConfig
    recorder.current = {}
    l3d = Line3D(config=L3DConfig(**cfg_kw), device=device)
    for v in range(capture.num_views):
        l3d.add_view_segments(v, segs[v], capture.K[v], capture.R[v],
                              capture.t[v],
                              worldpoint_ids=capture.wp_lists[v],
                              width=int(capture.width[v]),
                              height=int(capture.height[v]))
    with contextlib.redirect_stdout(sys.stderr):
        l3d.compute_3d_model()
    if l3d.device.type == "cuda":
        torch.cuda.synchronize(l3d.device)
    return l3d


def kept_outputs(l3d, current) -> dict:
    """What the check reads of a finished model: host arrays the program
    already holds, by reference."""
    b = l3d.best
    c = l3d.scene.collin
    return dict(
        S=l3d.scene.max_segments, neighbors=l3d.neighbors,
        matches={vm.view: (vm.src_seg, vm.tgt_view, vm.tgt_seg)
                 for vm in l3d.matches},
        match_list=[(vm.view, vm.src_seg, vm.tgt_view, vm.tgt_seg)
                    for vm in l3d.matches],
        best={f.name: getattr(b, f.name) for f in dataclasses.fields(b)},
        median=l3d.cameras.median_depth,
        collin=dict(view=c.flat_view, i=c.flat_i, j=c.flat_j, w=c.flat_w)
        if c is not None else dict(view=[], i=[], j=[], w=[]),
        collin_maps=c,
        result=[(ln.views2d, ln.segs2d, ln.segments3d) for ln in l3d.result],
        **current)


def traced_work(l3d, capture) -> list:
    """Per view of a model: the counts its kernels' work is taken from."""
    counts = [len(s) for s in capture.segments]
    out = []
    for vm in l3d.matches:
        nb = [int(u) for u in l3d.neighbors[vm.view]]
        out.append(dict(src=counts[vm.view], tgts=[counts[u] for u in nb],
                        S=l3d.scene.max_segments, M=int(vm.m_total),
                        valid=int(vm.total_candidates)))
    return out


def power_limit():
    """The card's power limit as nvidia-smi reports it, or None."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits"], capture_output=True,
            text=True, timeout=20).stdout.split()
        return float(out[0]) if out else None
    except (OSError, ValueError, subprocess.SubprocessError):
        return None


def run_cell(spec: dict, seed: int, seconds: float, trace: bool,
             device: str = "cuda", log=sys.stderr) -> dict:
    """One run of a cell in this process.  Returns the result object
    (without the JAX check, which main makes)."""
    import numpy as np
    import torch
    from benchmark import check, scenes
    from line3d_tpu_torch import L3DConfig
    from line3d_tpu_torch.parallel import multihost

    wl = spec["workload"]
    cfg_kw = l3d_config(spec)
    capture = scenes.make_capture(spec["config"]["scene"])
    V = capture.num_views
    a = float(wl["offset_px"])
    draws = np.random.default_rng([seed, 0])
    recorder = Recorder()
    recorder.install()
    try:
        # set-up: one cold model of the cell's shapes
        cold = np.random.default_rng([seed, 2]).uniform(-a, a, 2)
        run_model(capture, shifted(capture, cold), cfg_kw, device, recorder)
        dev = multihost.resolve_device(device)
        is_cuda = dev.type == "cuda"
        if is_cuda:
            torch.cuda.reset_peak_memory_stats(dev)
        # the model the check holds to the reference, drawn from the seed
        # among the first few of the window; only it (and, in case the
        # window closes before it, the latest model) is kept
        pick = np.random.default_rng([seed, 1])
        check_at = int(pick.integers(CHECK_WITHIN))
        models, stats, chosen, latest = [], [], None, None
        gc.collect()
        gc.freeze()     # the set-up's objects stay out of the window's GC
        t_open = time.perf_counter()
        setup_s = t_open - T_START
        closed = False
        while True:
            i = len(models)
            off = draws.uniform(-a, a, 2)
            segs = shifted(capture, off)
            prof = None
            if closed:
                from torch.profiler import ProfilerActivity, profile
                acts = [ProfilerActivity.CPU] + \
                    ([ProfilerActivity.CUDA] if is_cuda else [])
                prof = profile(activities=acts)
                prof.__enter__()
                recorder.spans = True
            t0 = time.perf_counter()
            try:
                if prof is not None:
                    from torch.profiler import record_function
                    with record_function("bench.model"):
                        l3d = run_model(capture, segs, cfg_kw, device,
                                        recorder)
                else:
                    l3d = run_model(capture, segs, cfg_kw, device, recorder)
                ok = True
            except Exception:            # a failed model is counted
                traceback.print_exc(file=log)
                ok = False
            t1 = time.perf_counter()
            if prof is not None:
                recorder.spans = False
                prof.__exit__(None, None, None)
            m = dict(seconds=t1 - t0, ok=ok, traced=prof is not None)
            if ok:
                latest = (i, segs, kept_outputs(l3d, recorder.current))
                if i == check_at:
                    chosen = latest
                if prof is None:
                    stats.append(l3d.stats)
                else:
                    m["work"] = traced_work(l3d, capture)
                    m["profile"] = prof
                del l3d
            models.append(m)
            if closed:
                break
            if t1 - t_open >= seconds:
                t_close = t1
                # a traced run profiles one more model as the window
                # closes: the profiler leaves the process slower, so no
                # untraced model may follow it
                closed = True
                if not trace:
                    break
        peak = torch.cuda.max_memory_allocated(dev) if is_cuda else 0
    finally:
        recorder.uninstall()
        gc.unfreeze()

    window = [m for m in models if not m["traced"]]
    record = dict(setup_s=setup_s, window_s=t_close - t_open,
                  model_s=[m["seconds"] for m in window],
                  views=V, completed=sum(m["ok"] for m in window),
                  peak_bytes=peak, stats=stats)
    breakdown = None
    traced = next((m for m in models if m.get("profile") is not None), None)
    if traced is not None:
        from benchmark import tracing
        dev_ops, spans = tracing.profiler_events(traced["profile"])
        whole = [s for s in spans if s[0] == "model"]
        start, end = (whole[0][1], whole[0][2]) if whole else (0, 0)
        busy, by_op, breakdown = tracing.summarize(
            dev_ops, [s for s in spans if s[0] != "model"], start, end)
        record["trace"] = dict(busy_s=busy, window_s=(end - start) / 1e6,
                               by_op=by_op, work=traced["work"])
        del traced["profile"]

    # the check: the model drawn from the seed, after the window
    attempted, failed = len(models), sum(not m["ok"] for m in models)
    values, limits = {}, wl["check"]["limits"]
    if chosen is None:
        chosen = latest
    latest = None
    if chosen is not None:
        idx, segs, prog = chosen
        views = check_views(pick, wl, V)
        cfg = dataclasses.asdict(L3DConfig(**cfg_kw))
        if is_cuda:
            torch.cuda.empty_cache()
        t_chk = time.perf_counter()
        values = check.numbers(wl["check"]["kinds"], prog, capture, segs,
                               cfg, views, dev)
        print(f"[bench] check of model {idx} (views {views}) took "
              f"{time.perf_counter() - t_chk:.1f} s", file=log)
    correct, rows = check.judge(values, limits)
    correct = correct and failed == 0 and attempted > 0

    metrics = {}
    for m in (spec["per_layer"] if trace else spec["end_to_end"]):
        v = metric_reader(m["name"], spec["root"]).read(record)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    result = dict(correct=bool(correct), attempted=attempted, failed=failed,
                  metrics=metrics,
                  device=dict(platform="gpu" if is_cuda else "cpu",
                              kind=torch.cuda.get_device_name(dev)
                              if is_cuda else "cpu",
                              count=spec["chips"], memory_peak_bytes=peak,
                              power_limit_w=power_limit()
                              if is_cuda else None))
    if "trace" in record:
        result["device"]["busy_s"] = record["trace"]["busy_s"]
        result["device"]["window_s"] = record["trace"]["window_s"]
        result["breakdown"] = breakdown
    stage = {k: float(np.mean([st[k] for st in stats])) for k in
             ("t_collin", "t_match", "t_affinity", "t_diffusion", "t_fh",
              "t_fit")} if stats else {}
    print(f"[bench] {attempted} models ({failed} failed) in "
          f"{record['window_s']:.3f} s; model seconds min / p50 / max "
          f"{min(record['model_s']):.4f} / "
          f"{np.median(record['model_s']):.4f} / "
          f"{max(record['model_s']):.4f}; stage means "
          + " ".join(f"{k} {v:.4f}" for k, v in stage.items()), file=log)
    for k, v, lim in rows:
        print(f"[check] {k} {v!r} limit {lim!r}", file=log)
    result["checks"] = {k: {"value": v, "limit": lim} for k, v, lim in rows}
    return result


def forbidden_modules():
    """Top-level names of loaded modules that are JAX or the JAX package."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    spec = cell_spec(args.workload)
    cache = os.path.join(HERE, "_cache")
    os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(cache, "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                          os.path.join(cache, "torch_extensions"))
    import torch
    if not torch.cuda.is_available():
        print("benchmark: no CUDA device; it runs only on the card",
              file=sys.stderr)
        return 2
    if torch.cuda.device_count() < spec["chips"]:
        print(f"benchmark: the cell needs {spec['chips']} cards, "
              f"{torch.cuda.device_count()} found", file=sys.stderr)
        return 2
    result = run_cell(spec, args.seed, args.seconds, bool(args.trace))
    bad = forbidden_modules()
    if bad:
        print(f"benchmark: {bad} loaded in the measuring process",
              file=sys.stderr)
        return 3
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.path[0] = ROOT
    sys.exit(main())
