"""The line refinement at scale: the device form (float64 torch) against the
float64 host form on C synthesized clusters of M members.

    python3 -m line3d_tpu_torch.utils.refine_bench [C] [--device cpu]
        [--host-subset K] [--out FILE] [--expect FILE]
    torchrun --nproc_per_node N -m line3d_tpu_torch.utils.refine_bench C
        --expect FILE

The port's counterpart of `line3d_tpu`'s scripts/refine_bench.py (no JAX):
`synthesize` draws the script's inputs from the same
`np.random.default_rng(seed)` stream: C random 3D lines, each seen by M
cameras drawn from a ring of `n_cams`, its projected endpoints with 1 px of
noise, its initial line 0.02 off.  The default C = 173,000 is the cluster
count of the script's 1000-view shape.

`main` runs `fit.refine.refine_lines_device` cold and warm (the initial
points moved by 1e-4) and the float64 `refine_lines` (on the first
`--host-subset` clusters only, when given), and prints one JSON line: the
seconds of each, the median rms before and after of each, the optimum's
agreement (the fraction of the host's clusters whose device rms after lies
within 1e-3 px of the host's, and the largest excess), the device's
`max_memory_allocated` and the process's peak RSS.  `--out FILE` writes the
cold device result (an .npz).  Under N ranks (torchrun, or
`multihost.initialize` before `main`) every rank solves its own blocks of
clusters (`multihost.local_block_range`) and the results are gathered;
rank 0 then checks that the gathered result equals `--expect FILE` (a
one-process `--out`) bit for bit and raises when it does not.  The device
is the card ("cuda", under N ranks the rank's card) unless `--device cpu`
is given; without CUDA it raises.
"""
from __future__ import annotations

import argparse
import json
import resource
import sys
import time

import numpy as np
import torch

from ..fit import refine
from ..parallel import multihost
from .host_stage_scaling import card_line, require_device

# the cluster count of the JAX script's 1000-view shape
DEFAULT_CLUSTERS = 173_000
# a device optimum agrees with the host's within this many px of rms
AGREE_PX = 1e-3
OUTPUTS = ("P0", "d", "rms_before", "rms_after")


def synthesize(C, M=12, n_cams=40, seed=0):
    """(P0 [C, 3], d0 [C, 3], Pm [C, M, 3, 4], p1, p2 [C, M, 2],
    mask [C, M]): scripts/refine_bench.py's `synthesize`, draw for draw."""
    rng = np.random.default_rng(seed)
    # cameras on a ring (no draws: the script's per-camera products, so
    # the matrices keep its bits)
    Pms = []
    for k in range(n_cams):
        ang = 2 * np.pi * k / n_cams
        Cc = np.array([6 * np.cos(ang), 6 * np.sin(ang), 2.0])
        fwd = -Cc / np.linalg.norm(Cc)
        right = np.cross(fwd, [0, 0, 1.0])
        right /= np.linalg.norm(right)
        down = np.cross(fwd, right)
        R = np.stack([right, down, fwd])
        t = -R @ Cc
        K = np.array([[1500.0, 0, 960], [0, 1500.0, 540], [0, 0, 1.0]])
        Pms.append(K @ np.concatenate([R, t[:, None]], axis=1))
    Pms = np.stack(Pms)

    A = rng.uniform(-1, 1, (C, 3))
    d = rng.normal(size=(C, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    B = A + 0.5 * d

    cam_ids = rng.integers(0, n_cams, (C, M))
    Pm = Pms[cam_ids]                                   # [C, M, 3, 4]

    def proj(X):
        Xh = np.concatenate([X, np.ones((C, 1))], axis=1)
        x = np.einsum("cmij,cj->cmi", Pm, Xh)
        return x[..., :2] / x[..., 2:3]

    p1 = proj(A) + rng.normal(0, 1.0, (C, M, 2))
    p2 = proj(B) + rng.normal(0, 1.0, (C, M, 2))
    mask = np.ones((C, M), bool)

    P0 = (A + B) / 2 + rng.normal(0, 0.02, (C, 3))
    d0 = d + rng.normal(0, 0.02, (C, 3))
    d0 /= np.linalg.norm(d0, axis=1, keepdims=True)
    return P0, d0, Pm, p1, p2, mask


def _sync(dev: torch.device):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def residual_floor(P0, d0, Pm, p1, p2, mask) -> float:
    """The largest difference between the float32 and the float64
    residuals of the same initial lines (px): what a float32 residual
    cannot resolve, which bounds two rms-before values' difference beyond
    tests/test_refine.py's atol 1e-4 (chip_smoke.py's phase facaded holds
    its refinement so)."""
    d_unit = d0 / np.linalg.norm(d0, axis=1, keepdims=True)
    r64, _ = refine._residuals(P0, d_unit, Pm, p1, p2, mask)
    f32 = lambda x: torch.as_tensor(np.asarray(x, np.float32))  # noqa
    r32, _ = refine.residuals_t(f32(P0), f32(d_unit), f32(Pm), f32(p1),
                                f32(p2), torch.as_tensor(mask))
    return float(np.abs(r32.numpy() - r64).max(initial=0.0))


def agreement(dev, host, floor: float = 0.0) -> dict:
    """The device result (P0, d, rms before, rms after) against the host's
    on the same clusters: the fraction whose device rms after lies within
    AGREE_PX of the host's (or below it), the largest excess, and
    tests/test_refine.py's criteria (rms before within rtol 1e-4 and atol
    max(1e-4, floor), the median rms after within 1.1x + 1e-3 px, every
    rms after within 0.05 px, directions aligned past 0.9999, base points
    within 5e-3 of the host's line), with `ok` when all hold."""
    Pd, dd, rb_d, ra_d = dev
    Ph, dh, rb_h, ra_h = host
    excess = ra_d - ra_h
    align = float(np.abs(np.sum(dd * dh, axis=1)).min(initial=1.0))
    perp = float(np.linalg.norm(np.cross(Pd - Ph, dh), axis=1)
                 .max(initial=0.0))
    crit = dict(rms_before=bool(np.all(np.abs(rb_d - rb_h) <= max(
                    1e-4, floor) + 1e-4 * np.abs(rb_h))),
                median_after=bool(np.median(ra_d)
                                  <= np.median(ra_h) * 1.1 + 1e-3),
                each_after=bool(np.all(ra_d <= ra_h + 0.05)),
                alignment=align > 0.9999, offset=perp < 5e-3)
    return dict(clusters=int(excess.size),
                within=float(np.mean(excess <= AGREE_PX)),
                worst_excess_px=float(excess.max(initial=0.0)),
                rms_before_diff=float(np.abs(rb_d - rb_h).max(initial=0.0)),
                residual_floor=floor, min_alignment=align, max_offset=perp,
                criteria=crit,
                ok=all(crit.values()))


def _check_expect(out: dict, expect: str) -> bool:
    """Whether the gathered device result equals a one-process `--out`
    file bit for bit; raises when it does not."""
    with np.load(expect) as want:
        same = all(np.array_equal(out[k], want[k]) for k in OUTPUTS)
    if not same:
        raise RuntimeError(f"refine_bench: the result of "
                           f"{multihost.process_count()} ranks differs from "
                           f"{expect}")
    return same


def run(C: int, device, host_subset: int | None = None,
        out: str | None = None, expect: str | None = None) -> dict:
    """The device refinement cold and warm and the host refinement on C
    synthesized clusters; returns the record `main` prints."""
    dev = multihost.resolve_device(device)
    t0 = time.perf_counter()
    P0, d0, Pm, p1, p2, mask = synthesize(C)
    t_synth = time.perf_counter() - t0
    if dev.type == "cuda":
        torch.cuda.init()   # an explicit index is refused before CUDA starts
        torch.cuda.reset_peak_memory_stats(dev)

    def device_run(P):
        _sync(dev)
        t0 = time.perf_counter()
        res = refine.refine_lines_device(P, d0, Pm, p1, p2, mask,
                                         device=dev)
        _sync(dev)
        return time.perf_counter() - t0, res

    t_cold, cold = device_run(P0)
    t_warm, warm = device_run(P0 + 1e-4)
    K = C if host_subset is None else min(int(host_subset), C)
    sub = slice(0, K)
    t0 = time.perf_counter()
    host = refine.refine_lines(P0[sub], d0[sub], Pm[sub], p1[sub], p2[sub],
                               mask[sub])
    t_host = time.perf_counter() - t0
    rank, nproc = multihost.process_index(), multihost.process_count()
    result = dict(zip(OUTPUTS, cold))
    if out and rank == 0:
        np.savez(out, **result)
    rec = dict(
        C=C, M=int(mask.shape[1]), ranks=nproc, rank=rank, device=str(dev),
        card=card_line(dev), block=refine.block_size(C),
        blocks_local=list(multihost.local_block_range(
            C, refine.block_size(C))),
        synthesize_s=t_synth, device_cold_s=t_cold, device_warm_s=t_warm,
        host_s=t_host, host_clusters=K,
        device_rms_before=float(np.median(cold[2])),
        device_rms_after=float(np.median(cold[3])),
        device_warm_rms_after=float(np.median(warm[3])),
        host_rms_before=float(np.median(host[2])),
        host_rms_after=float(np.median(host[3])),
        agreement=agreement([x[sub] for x in cold], host, residual_floor(
            P0[sub], d0[sub], Pm[sub], p1[sub], p2[sub], mask[sub])),
        gathered_bytes=multihost.GATHERED_BYTES,
        max_memory_allocated=torch.cuda.max_memory_allocated(dev)
        if dev.type == "cuda" else None,
        peak_rss=resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024,
        equal_to_expect=_check_expect(result, expect)
        if expect and rank == 0 else None)
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("clusters", type=int, nargs="?",
                    default=DEFAULT_CLUSTERS)
    ap.add_argument("--device", default="cuda",
                    help="the device refinement's device (default: the "
                    "card, the rank's card under N ranks; raises without "
                    "CUDA)")
    ap.add_argument("--host-subset", type=int, default=None,
                    help="run the float64 host refinement on the first K "
                    "clusters only")
    ap.add_argument("--out", default="",
                    help="write the cold device result (.npz)")
    ap.add_argument("--expect", default="",
                    help="a one-process --out: rank 0 checks the gathered "
                    "result against it bit for bit")
    args = ap.parse_args(argv)
    require_device(args.device, "refine_bench")
    multihost.initialize()
    rec = run(args.clusters, args.device, args.host_subset,
              args.out or None, args.expect or None)
    print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
