"""Run one cell several times, each run its own process, and report the
spread of each metric.

    python3 benchmark/sets.py --workload facade_p25.exact \\
        --seeds 11 12 13 14 15 16 --seconds 45 [--trace 1] \\
        [--out chiprun_out/facade.jsonl]

Each run is `benchmark/run.py` with the given arguments; its result line,
exit code and the end of its standard error go to --out as one JSON line.
The summary gives, per metric, the median and the spread: the distance
between the first and third quartiles (statistics.quantiles, n=4) over
the median.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))


def spread(values):
    """(median, (q3 - q1) / median) of a list of numbers."""
    med = statistics.median(values)
    if len(values) < 2 or med == 0:
        return med, 0.0
    q1, _, q3 = statistics.quantiles(values, n=4)
    return med, (q3 - q1) / abs(med)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, default=0)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    runs = []
    for seed in args.seeds:
        t0 = time.perf_counter()
        p = subprocess.run(
            [sys.executable, os.path.join(HERE, "run.py"),
             "--workload", args.workload, "--seed", str(seed),
             "--seconds", str(args.seconds), "--trace", str(args.trace)],
            capture_output=True, text=True)
        wall = time.perf_counter() - t0
        lines = p.stdout.strip().splitlines()
        try:
            res = json.loads(lines[-1]) if lines else None
        except json.JSONDecodeError:
            res = None
        row = dict(workload=args.workload, seed=seed, rc=p.returncode,
                   wall_s=wall, result=res, stderr=p.stderr[-6000:])
        runs.append(row)
        if args.out:
            with open(args.out, "a") as f:
                f.write(json.dumps(row) + "\n")
        got = {k: v["value"] for k, v in (res or {}).get(
            "metrics", {}).items()}
        print(f"[sets] {args.workload} seed {seed} rc {p.returncode} "
              f"wall {wall:.1f} s correct "
              f"{(res or {}).get('correct')} attempted "
              f"{(res or {}).get('attempted')} {json.dumps(got)}",
              flush=True)
        if res is None or p.returncode:
            print(p.stderr[-3000:], flush=True)
        else:
            checks = res.get("checks", {})
            print("[sets]   checks " + json.dumps(
                {k: v["value"] for k, v in checks.items()}), flush=True)
    names = sorted({k for r in runs if r["result"]
                    for k in r["result"]["metrics"]})
    for k in names:
        vals = [r["result"]["metrics"][k]["value"] for r in runs
                if r["result"] and k in r["result"]["metrics"]]
        med, sp = spread(vals)
        print(f"[sets] {args.workload} {k}: n {len(vals)} median {med!r} "
              f"spread {sp!r} values {vals}", flush=True)
    return 0 if all(r["rc"] == 0 for r in runs) else 1


if __name__ == "__main__":
    sys.exit(main())
