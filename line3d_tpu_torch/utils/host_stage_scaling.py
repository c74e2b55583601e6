"""The cluster stage alone at scale: affinity, diffusion, F-H and the line
fit on production-density matching outputs synthesized for V views.

    python3 -m line3d_tpu_torch.utils.host_stage_scaling [V] [--device cpu]

The port's counterpart of `line3d_tpu`'s scripts/host_stage_scaling.py
(numpy, torch and the port's native library; no JAX).  `synthesize` builds
the same inputs from the same `np.random.default_rng(seed)` stream, as the
port's types: G ground-truth 3D lines each seen in `span` consecutive views
of a V-camera ring, ~`segs_per_view` best-match rows per view, up to
`cand_per_seg` verified correspondences per segment and one collinear
partner per segment.  The stages' cost depends on the data's shape, not its
values, so this sizes the cluster stage at V = 1000 without matching 1000
views.

`main` times `affinity.build_affinity_graph`, the float64 host diffusion
(V <= 200, as the JAX script), the device diffusion on `--device` (every
V), `fh.fh_cluster`, `fh.fh_cluster_parallel` and
`fit.lines.process_clusters`, and prints one JSON line: each stage's
seconds, the edges, nodes, clusters and lines.  Both diffusions run on
copies of the graph, so F-H and the fit see the undiffused graph at every
V (the JAX script diffuses in place at V <= 200).  The device is the card
("cuda") unless `--device cpu` is given; without CUDA it raises.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
import time

import numpy as np
import torch

from ..cluster import affinity, diffusion, fh
from ..config import L3DConfig
from ..core.cameras import CameraSet
from ..core.conditioning import compute_conditioning
from ..fit import lines as fit_lines
from ..match.collinearity import CollinMaps
from ..match.engine import BestMatches, ViewMatches

# the padded segment axis of the production shape the inputs stand for
SEGMENT_SLOTS = 3072
# the host diffusion is the float64 parity reference; the JAX script
# measures it up to this many views
HOST_DIFFUSION_MAX_VIEWS = 200


def _ring_cameras(V: int):
    """V cameras on a ring looking at its centre, conditioned as the
    pipeline conditions them: (CameraSet, SceneTransform)."""
    ang = 2 * np.pi * np.arange(V) / V
    C = np.stack([4 * np.cos(ang), 4 * np.sin(ang), np.full(V, 1.4)], 1)
    look = -C / np.linalg.norm(C, axis=1, keepdims=True)
    up = np.array([0.0, 0.0, 1.0])
    z = look
    x = np.cross(look, up)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    y = np.cross(z, x)
    R = np.stack([x, y, z], axis=1)
    t = -np.einsum("vij,vj->vi", R, C)
    K = np.tile(np.array([[1000.0, 0, 960], [0, 1000.0, 540], [0, 0, 1.0]]),
                (V, 1, 1))
    cams = CameraSet(K=K, R=R, t=t, width=np.full(V, 1920),
                     height=np.full(V, 1080))
    tr = compute_conditioning(cams.C)
    cams.transform(tr.Qinv, tr.scale)
    cams.median_depth[:] = np.linalg.norm(cams.C, axis=1).mean()
    return cams, tr


def synthesize(V: int = 1000, segs_per_view: int = 2500, span: int = 20,
               cand_per_seg: int = 8, seed: int = 0):
    """Best matches, verified correspondence lists and collinearity of a
    V-view flythrough over G = V * segs_per_view // span 3D lines.

    Returns (cameras, config, transform, BestMatches, [ViewMatches],
    CollinMaps, S): the arrays of the JAX script's `synthesize` with the
    same arguments, equal value for value, built without its per-segment
    Python loops."""
    if span > V:
        raise ValueError(f"span {span} > V {V}: a view would see a line "
                         "twice")
    rng = np.random.default_rng(seed)
    cfg = L3DConfig()
    cams, tr = _ring_cameras(V)

    # G lines, line g visible in views first[g] + k (mod V), k < span
    G = V * segs_per_view // span
    A = rng.uniform(-1, 1, (G, 3))
    d = rng.normal(size=(G, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    B = A + d * rng.uniform(0.2, 1.0, (G, 1))
    first = (np.arange(G) * V // G - span // 2) % V

    # each view's lines in line order, cut to segs_per_view; a segment's
    # index is its rank there.  seg_k[g, k]: line g's segment in view
    # first[g] + k, -1 where that view's list was cut before it
    views_gk = (first[:, None] + np.arange(span)) % V
    order = np.argsort(views_gk.ravel(), kind="stable")
    v_all = views_gk.ravel()[order]
    g_all, k_all = np.divmod(order, span)
    s_all = np.arange(len(order)) - np.searchsorted(v_all, v_all)
    kept = s_all < segs_per_view
    v_r, s_r, g_r, k_r = v_all[kept], s_all[kept], g_all[kept], k_all[kept]
    seg_k = np.full((G, span), -1, np.int32)
    seg_k[g_r, k_r] = s_r

    # the other views of each (view, segment) row that hold the line, in
    # k order
    others = seg_k[g_r] >= 0
    others[np.arange(len(g_r)), k_r] = False

    # best-match rows: every (v, s) with another view of its line pairs
    # with one of them at random
    cnt = others.sum(axis=1)
    has = cnt > 0
    pick = rng.integers(cnt[has])
    rows = np.nonzero(has)[0]
    k_pick = (others[rows].cumsum(axis=1) > pick[:, None]).argmax(axis=1)
    gg = g_r[rows]
    n = len(rows)
    t1 = rng.uniform(0, 0.4, n)
    t2 = rng.uniform(0.6, 1.0, n)
    P1 = A[gg] + t1[:, None] * (B[gg] - A[gg]) + rng.normal(0, 5e-4, (n, 3))
    P2 = A[gg] + t2[:, None] * (B[gg] - A[gg]) + rng.normal(0, 5e-4, (n, 3))
    dirv = P2 - P1
    dirv /= np.linalg.norm(dirv, axis=1, keepdims=True)
    vv = v_r[rows]
    best = BestMatches(
        view=vv.astype(np.int32), seg=s_r[rows].astype(np.int32),
        tgt_view=((first[gg] + k_pick) % V).astype(np.int32),
        tgt_seg=seg_k[gg, k_pick].astype(np.int32),
        score=rng.uniform(0.5, 1.0, n).astype(np.float32),
        P1=P1, P2=P2, dir=dirv,
        d1=np.linalg.norm(P1 - cams.C[vv], axis=1).astype(np.float32),
        d2=np.linalg.norm(P2 - cams.C[vv], axis=1).astype(np.float32))

    # verified correspondence lists: per (v, s), the first cand_per_seg
    # other views of its line
    r, k = np.nonzero(others & (others.cumsum(axis=1) <= cand_per_seg))
    g = g_r[r]
    bounds = np.searchsorted(v_r[r], np.arange(V + 1))
    src = s_r[r].astype(np.int32)
    tvs = ((first[g] + k) % V).astype(np.int32)
    tss = seg_k[g, k]
    matches = [ViewMatches(view=v, src_seg=src[a:b], tgt_view=tvs[a:b],
                           tgt_seg=tss[a:b])
               for v, (a, b) in enumerate(zip(bounds[:-1], bounds[1:]))]

    # collinearity: segments (2m, 2m + 1) of each view are partners
    # (~1 partner a segment, the density measured on real scenes)
    nseg = np.bincount(v_r, minlength=V)
    fv, fi, fj = [], [], []
    for v in range(V):
        i = np.arange(0, nseg[v] - 1, 2)
        fv.append(np.full(2 * len(i), v))
        fi.append(np.ravel([i, i + 1]))
        fj.append(np.ravel([i + 1, i]))
    flat_view = np.concatenate(fv).astype(np.int32)
    flat_i = np.concatenate(fi).astype(np.int32)
    flat_j = np.concatenate(fj).astype(np.int32)
    order = np.lexsort((flat_j, flat_i, flat_view))
    cm = CollinMaps(V, flat_view[order], flat_i[order], flat_j[order],
                    np.full(len(order), 0.7, np.float32))
    return cams, cfg, tr, best, matches, cm, SEGMENT_SLOTS


def _copy(graph):
    return dataclasses.replace(graph, edges_i=graph.edges_i.copy(),
                               edges_j=graph.edges_j.copy(),
                               edges_w=graph.edges_w.copy())


def card_line(device: torch.device) -> str | None:
    """The card as `nvidia-smi --query-gpu=name,power.limit` reports it
    (None on the CPU)."""
    if device.type != "cuda":
        return None
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()
    return out[device.index or 0]


def require_device(device, tool: str):
    """Raise when the card is asked for and there is none."""
    if torch.device(device).type == "cuda" and \
            not torch.cuda.is_available():
        raise RuntimeError(f"{tool}: device 'cuda' requested but "
                           "torch.cuda.is_available() is False (pass "
                           "--device cpu)")


def run(V: int, device) -> dict:
    """Synthesize the inputs of V views and time each cluster stage on
    them; returns the record `main` prints."""
    dev = torch.device(device)

    def timed(fn, *a, **k):
        t0 = time.perf_counter()
        out = fn(*a, **k)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        return out, time.perf_counter() - t0

    (cams, cfg, tr, best, matches, cm, S), t_synth = timed(synthesize, V)
    graph, t_aff = timed(affinity.build_affinity_graph, best, matches, cm,
                         cams, cfg, S)
    t_host = None
    if V <= HOST_DIFFUSION_MAX_VIEWS:
        _, t_host = timed(diffusion.run_diffusion, _copy(graph),
                          dataclasses.replace(cfg, diffusion_backend="host"),
                          device=dev)
    _, t_dev = timed(diffusion.run_diffusion, _copy(graph),
                     dataclasses.replace(cfg, diffusion_backend="device"),
                     device=dev)
    args = (graph.edges_i, graph.edges_j, graph.edges_w, graph.num_nodes,
            cfg.fh_c)
    labels, t_fh = timed(fh.fh_cluster, *args)
    labels_p, t_fhp = timed(fh.fh_cluster_parallel, *args, device=dev)
    result, t_fit = timed(fit_lines.process_clusters, graph, labels, best,
                          tr, cfg, S,
                          scene_segments=np.zeros((V, 1, 4), np.float32),
                          P_cond=cams.P, device=dev)
    return dict(
        V=V, device=str(dev), card=card_line(dev),
        best_rows=int(best.view.size),
        correspondences=int(sum(m.src_seg.size for m in matches)),
        collinear_pairs=int(cm.flat_w.size), edges=int(len(graph.edges_w)),
        nodes=int(graph.num_nodes), clusters=int(len(np.unique(labels))),
        clusters_parallel=int(len(np.unique(labels_p))),
        lines=len(result),
        seconds=dict(synthesize=t_synth, affinity=t_aff,
                     diffusion_host=t_host, diffusion_device=t_dev,
                     fh=t_fh, fh_parallel=t_fhp, fit=t_fit),
        t_cluster=t_aff + t_fh + t_fit)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("views", type=int, nargs="?", default=1000)
    ap.add_argument("--device", default="cuda",
                    help="the device of the device diffusion and the fit "
                    "(default: the card; raises without CUDA)")
    args = ap.parse_args(argv)
    require_device(args.device, "host_stage_scaling")
    print(json.dumps(run(args.views, torch.device(args.device))), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
