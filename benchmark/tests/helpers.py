"""Tiny cells for the CPU tests: a cell's files with its capture cut to a
few small views, so that a whole run, reference and control included,
takes seconds on the CPU."""
from __future__ import annotations

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

SMALL = {
    "facade": dict(family="facade", num_views=6, width=960, height=720,
                   focal=900.0, focal_y=901.5, principal=[476.0, 355.0],
                   seed=0, n_cols=5, n_rows=4, distance=6.5,
                   min_len_factor=0.005, max_segments=224),
    "clutter": dict(family="clutter", num_views=6, width=640, height=480,
                    focal=600.0, num_random_segments=40, seed=0,
                    min_len_factor=0.005, max_segments=50),
}


# cells whose files are in but whose BENCHMARK.json entry is not yet,
# with the listed cell of the same configuration
DEFERRED = {"facade_p25.noisy": "facade_p25.exact"}


def small_cell(name: str) -> dict:
    """The cell `name` as BENCHMARK.json defines it (a DEFERRED cell: its
    workload file on its configuration's listed cell), its capture cut to
    SMALL's size of its family."""
    import json
    from benchmark import run
    spec = run.cell_spec(DEFERRED.get(name, name))
    if name in DEFERRED:
        with open(os.path.join(ROOT, "benchmark", "workloads",
                               f"{name}.json")) as f:
            spec.update(name=name, workload=json.load(f))
    spec["config"] = dict(spec["config"])
    family = spec["config"]["scene"]["family"]
    spec["config"]["scene"] = dict(SMALL[family])
    return spec
