"""What a coarser quota bucket costs the per-view step, and that it costs
no result.

    python3 -m line3d_tpu_torch.utils.quota_bucket_bench [--views 25]
        [--segments 2990] [--repeats 10] [--device cpu]

The port's counterpart of `line3d_tpu`'s scripts/quota_bucket_bench.py (no
JAX).  The block compaction keeps max(quota, ceil(m_total / B)) matches of
each (segment, 128-target block), capped at the block width, so a quota
bucket costs something only where it exceeds that floor.  On the fixture
of `utils/stress_stage_bench.py` (view 0 of the P25 stress scene) the
whole step A-E (`stress_stage_bench.step`) is timed at the script's ten
(m_total, quota) pairs, with its protocol (one warm-up, then `--repeats`
calls on segments shifted by i * 1e-4 px, each ended by a synchronize,
host clock and CUDA events).  Per pair it prints the effective quota, the
milliseconds a view and the overflow (the matches the caps dropped); the
m_total = 256 pairs run the scoring kernel at M <= 256 (K3's width), the
others at M > 256 (K2's).  Every pair whose overflow is 0 must give the
(2048, 8) pair's selection buffer value for value (the bucket costs time,
not results); the tool raises otherwise.  The last line is one JSON
object.  The device is the card unless `--device cpu` is given; without
CUDA it raises.
"""
from __future__ import annotations

import argparse
import json
import sys

import numpy as np

from ..match import pairwise
from ..parallel import sharded
from . import stress_stage_bench as ssb
from .host_stage_scaling import require_device

# the script's (m_total, quota) pairs (scripts/quota_bucket_bench.py:69-72);
# the first is the reference the lossless pairs are held to
COMBOS = ((2048, 8), (2048, 32), (2048, 128),
          (1024, 8), (1024, 128),
          (512, 32), (512, 128),
          (256, 8), (256, 32), (256, 128))


def effective_quota(m_total: int, quota: int, S: int) -> int:
    """The quota `pairwise.compact_rows_blockq` keeps a block."""
    blk = pairwise.block_size(S)
    return min(max(quota, -(-m_total // (S // blk))), blk)


def run(fx: ssb.Fixture, repeats: int) -> dict:
    """Each pair of COMBOS timed, with its overflow and whether its
    selection equals the first pair's; the record `main` prints."""
    dev = fx.segs_src.device
    ref = None
    rows = []
    for m_total, quota in COMBOS:
        caps = (quota, m_total)
        buf = ssb.step(fx, fx.segs_src, caps)
        sel = sharded.unpack_selection(buf, fx.S)
        if ref is None:
            if sel["overflow"]:
                raise RuntimeError(
                    f"quota_bucket_bench: the reference pair {caps[::-1]} "
                    f"dropped {sel['overflow']} matches")
            ref = buf
        same = bool(np.array_equal(buf, ref))
        if sel["overflow"] == 0 and not same:
            raise RuntimeError(
                f"quota_bucket_bench: m_total {m_total} quota {quota} drops "
                "nothing but selects other matches than "
                f"m_total {COMBOS[0][0]} quota {COMBOS[0][1]}")
        t = ssb.time_step(fx, caps, "E", repeats)
        eff = effective_quota(m_total, quota, fx.S)
        ev = "" if t["event_ms_median"] is None else \
            f" (events {t['event_ms_median']:7.3f} ms)"
        print(f"m_total {m_total:5d} quota {quota:3d} (eff {eff:3d}): "
              f"{t['host_ms_median']:7.3f} ms/view{ev}, overflow "
              f"{sel['overflow']}, {sel['n_verified']} verified, selection "
              f"{'equal to' if same else 'differs from'} the "
              f"({COMBOS[0][0]}, {COMBOS[0][1]}) pair's", flush=True)
        rows.append(dict(m_total=m_total, quota=quota, eff_quota=eff,
                         overflow=sel["overflow"],
                         n_verified=sel["n_verified"], selection_equal=same,
                         **t))
    return dict(views=fx.scene.num_views, view=fx.view, S=fx.S,
                N=len(fx.nb), device=str(dev), card=ssb.card_line(dev),
                repeats=repeats, pairs=rows)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ssb.add_fixture_args(ap)
    args = ap.parse_args(argv)
    require_device(args.device, "quota_bucket_bench")
    fx = ssb.fixture(args.device, args.views, args.segments)
    rec = run(fx, args.repeats)
    print(f"card: {rec['card']}", flush=True)
    print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
