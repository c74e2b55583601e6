"""The readings that a cell's limits are set from, in one process: for
each seed, one model of the cell as a run makes it (the seed's offsets,
the seed's pick of views), held to the reference ("program"), and the
control, the reference in a lower precision put in the program's place
(check.control_program), held to the same reference ("control").

    python3 benchmark/control.py --workload facade_p25.exact \\
        --seeds 1 2 3 [--out chiprun_out/control.jsonl]

One JSON line per seed on standard output.  It runs on the card (or, for
the CPU tests, with --device cpu).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys

import numpy as np


def readings(spec, seed, device, with_control=True):
    """({name: program's number}, {name: control's number} or None) of one
    seed."""
    import torch
    from line3d_tpu_torch import L3DConfig
    from benchmark import check, run, scenes
    wl = spec["workload"]
    cfg_kw = run.l3d_config(spec)
    capture = scenes.make_capture(spec["config"]["scene"])
    a = float(wl["offset_px"])
    off = np.random.default_rng([seed, 0]).uniform(-a, a, 2)
    segs = run.shifted(capture, off)
    rec = run.Recorder()
    rec.install()
    try:
        l3d = run.run_model(capture, segs, cfg_kw, device, rec)
        prog = run.kept_outputs(l3d, rec.current)
        del l3d
    finally:
        rec.uninstall()
    pick = np.random.default_rng([seed, 1])
    pick.integers(1)
    V = capture.num_views
    views = run.check_views(pick, wl, V)
    cfg = dataclasses.asdict(L3DConfig(**cfg_kw))
    kinds = wl["check"]["kinds"]
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    sound = check.numbers(kinds, prog, capture, segs, cfg, views, device)
    if not with_control:
        return sound, None
    ctrl = check.control_program(kinds, prog, capture, segs, cfg, views,
                                 device)
    control = check.numbers(kinds, ctrl, capture, segs, cfg, views, device)
    return sound, control


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--control-seeds", type=int, default=None,
                    help="read the control on the first this many seeds "
                    "only (all by default)")
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    from benchmark import run
    import torch
    if args.device == "cuda" and not torch.cuda.is_available():
        print("control: no CUDA device", file=sys.stderr)
        return 2
    spec = run.cell_spec(args.workload)
    n_ctrl = len(args.seeds) if args.control_seeds is None \
        else args.control_seeds
    for k, seed in enumerate(args.seeds):
        sound, control = readings(spec, seed, args.device, k < n_ctrl)
        row = dict(workload=args.workload, seed=seed, program=sound,
                   control=control)
        print(json.dumps(row), flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(json.dumps(row) + "\n")
    return 0


if __name__ == "__main__":
    sys.path[0] = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.exit(main())
