"""The comparison that decides `correct`: one model of the window, drawn
from the seed, against the plain reference under `reference/`.

`numbers` returns every number a cell compares, by name; `judge` holds
each to the limit the cell's workload file gives it.  The start of the
chain is computed from the benchmark's own inputs alone: the conditioned
cameras and neighbours, each view's collinear pairs, and the match step of
a sample of views drawn from the seed.  The cluster stage is followed step
by step from the program's own stage inputs (see reference/cluster.py).
`control_program` puts the reference in the program's place in a lower
precision, the control that each limit was read against (control.py).
"""
from __future__ import annotations

import numpy as np
import torch

from .reference import cameras as rc, cluster as rk, collin as rcl, \
    match as rm, noisy as rn


def reference_cameras(capture, cfg):
    """The reference's conditioned cameras and its neighbours."""
    cams = rc.Cams(capture.K.astype(np.float64), capture.R, capture.t,
                   capture.width, capture.height,
                   cfg["uncertainty_lower_px"], cfg["uncertainty_upper_px"])
    sim = rc.view_similarity(capture.wp_lists, capture.num_views)
    nbrs = rc.neighbors(sim, cams.C, cfg["min_baseline"],
                        cfg["matching_neighbors"], cfg["eps"])
    tr = rc.conditioning(cams.C)
    cams.condition(tr.Qinv, tr.scale)
    return cams, nbrs, tr


def _share(a, b):
    """Entries in one sorted key array and not the other, as a share of
    the second's size."""
    return len(np.setxor1d(a, b, assume_unique=True)), max(len(b), 1)


# two picks of one segment whose reference scores lie closer than this
# are a near tie (float32 rounding of the scores), not a different answer
TIE = 1e-3
# a pick's confidence outside this of the reference's confidence for the
# same match is another confidence, not the scoring kernel's rounding (the
# port's own tolerance of the kernel against its float32 plain form,
# ROADMAP Queue 3: rtol 2e-3, atol 2e-4)
CONF_RTOL, CONF_ATOL = 2e-3, 2e-4


def match_numbers(prog, segs, cams, nbrs, views, cfg, device):
    """verified_diff, best_diff, conf_diff, depth_gap over `views`.

    prog holds the program's verified identities per view and its best
    matches; the reference answers each view from the inputs.
    verified_diff: identities verified on one side only, over the
    reference's count.  best_diff: segments whose best match differs from
    the reference's by more than a near tie (the program's pick scored by
    the reference more than TIE below the reference's best, or a best on
    one side only), over the reference's segments with a best; the
    confidences decide both.  depth_gap: over the program's picks that
    the reference's table holds too, the largest relative difference of
    the pick's depths from the reference's for that same match.
    conf_diff: the share of the program's picks whose confidence (the
    scoring kernel's, as the program selected by it) lies outside
    CONF_RTOL / CONF_ATOL of the reference's confidence for the same
    match; a pick the reference's table does not hold counts as
    differing, and where the program picks nothing in those views while
    the reference does, the share is 1 (no confidence came)."""
    diff = total = bad = n_best = n_conf = off_conf = 0
    depth_gap = 0.0
    for v in views:
        ref = rm.match_view(segs, v, nbrs[v], cams, cfg, device)
        pv = prog["matches"].get(v)
        pk = np.sort(rm.key(*pv)) if pv is not None else np.zeros(0, np.int64)
        d, n = _share(pk, ref["verified"])
        diff, total = diff + d, total + n
        b = prog.get("match_best", prog["best"])
        m = b["view"] == v
        p_seg, p_tv, p_ts = b["seg"][m], b["tgt_view"][m], b["tgt_seg"][m]
        p_d = np.stack([b["d1"][m], b["d2"][m]], 1).astype(np.float64)
        # the reference's entry for each pick the program made
        tk, pkeys = ref["table_keys"], rm.key(p_seg, p_tv, p_ts)
        hit = np.zeros(len(pkeys), bool)
        pos = np.zeros(len(pkeys), np.int64)
        if len(tk):
            pos = np.minimum(np.searchsorted(tk, pkeys), len(tk) - 1)
            hit = tk[pos] == pkeys
        conf = np.where(hit, ref["table_conf"][pos] if len(tk) else 0, 0.0)
        p_ref = np.where(conf > cfg["confidence_threshold"],
                         np.minimum(conf / cfg["confidence_norm"], 1.0), 0.0)
        p_s = np.asarray(b["score"][m], np.float64)
        n_conf += len(p_s)
        off_conf += int(np.sum(~hit | (np.abs(p_s - p_ref) >
                                        CONF_ATOL + CONF_RTOL * p_ref)))
        if hit.any():
            r_d = np.stack([ref["table_d1"][pos[hit]],
                            ref["table_d2"][pos[hit]]], 1).astype(np.float64)
            rel = np.abs(p_d[hit] - r_d) / np.maximum(np.abs(r_d), 1e-12)
            depth_gap = max(depth_gap, float(rel.max()))
        r_of = dict(zip(ref["best_seg"].tolist(),
                        ref["best_score"].tolist()))
        n_best += len(r_of)
        bad += len(set(r_of) - set(p_seg.tolist()))
        for k, s in enumerate(p_seg.tolist()):
            if s not in r_of or r_of[s] - p_ref[k] > TIE:
                bad += 1
    return dict(verified_diff=diff / max(total, 1),
                best_diff=bad / max(n_best, 1),
                conf_diff=off_conf / n_conf if n_conf else float(n_best > 0),
                depth_gap=depth_gap)


def collin_numbers(prog_collin, segs, cfg, device):
    """collin_diff: collinear pairs in one side and not the other, over
    all views, as a share of the reference's count; collin_gap: the
    largest difference of a common pair's weight (K4's collinearity
    weight, which the affinity graph reads)."""
    diff = total = 0
    gap = 0.0
    fv, fi, fj = (np.asarray(prog_collin[k], np.int64)
                  for k in ("view", "i", "j"))
    fw = np.asarray(prog_collin["w"], np.float64)
    for v, s in enumerate(segs):
        i, j, w = rcl.pairs(s, cfg["collinearity_sigma"],
                            cfg["collinearity_aff_threshold"], device)
        m = fv == v
        pk = fi[m] * 65536 + fj[m]
        po = np.argsort(pk)
        rk_ = i.astype(np.int64) * 65536 + j
        ro = np.argsort(rk_)
        d, n = _share(pk[po], rk_[ro])
        diff, total = diff + d, total + n
        _, a, b = np.intersect1d(pk[po], rk_[ro], assume_unique=True,
                                 return_indices=True)
        if len(a):
            gap = max(gap, float(np.abs(fw[m][po][a] -
                                        w[ro][b].astype(np.float64)).max()))
    return dict(collin_diff=diff / max(total, 1), collin_gap=gap)


def _edge_map(ei, ej, ew, node_view, node_seg, S):
    keys = node_view.astype(np.int64) * S + node_seg.astype(np.int64)
    k = keys[ei] * (1 << 32) + keys[ej]
    o = np.argsort(k, kind="stable")
    return k[o], np.asarray(ew, np.float64)[o]


def graph_numbers(prog, cams, S, cfg):
    """graph_diff: directed edges of the program's affinity graph that the
    reference, given the program's best matches, verified identities,
    collinear pairs and median depths, does not emit, and the reverse;
    weight_gap: the largest weight difference of the common edges."""
    g = prog["graph"]
    ri, rj, rw, rv, rs = rk.affinity_graph(
        prog["best"], prog["match_list"], prog["collin_maps"], S,
        (cams.k_lower, cams.k_upper), prog["median"], cfg)
    pk, pw = _edge_map(g["i"], g["j"], g["w"], g["view"], g["seg"], S)
    qk, qw = _edge_map(ri, rj, rw, rv, rs, S)
    common, a, b = np.intersect1d(pk, qk, return_indices=True)
    gap = float(np.abs(pw[a] - qw[b]).max()) if len(common) else 0.0
    return dict(graph_diff=float(len(pk) + len(qk) - 2 * len(common)),
                weight_gap=gap)


def _canonical(labels):
    """Each node's cluster named by its least member."""
    lab = np.asarray(labels)
    first = {}
    for k, l in enumerate(lab.tolist()):
        first.setdefault(l, k)
    return np.asarray([first[l] for l in lab.tolist()])


def cluster_numbers(prog, cfg):
    """cluster_diff: nodes whose F-H cluster differs, given the graph the
    program clustered."""
    g = prog["clustered"]
    ref = rk.fh_labels(np.asarray(g["i"]), np.asarray(g["j"]),
                       np.asarray(g["w"]), g["n"], cfg["fh_c"])
    return dict(cluster_diff=float(np.sum(_canonical(ref)
                                          != _canonical(prog["labels"]))))


def diffusion_numbers(prog, cfg):
    """diffusion_gap: the largest difference of a diffused weight, given
    the graph the program diffused, over the largest weight."""
    g, d = prog["graph"], prog["clustered"]
    i, j, w = rn.diffuse(np.asarray(g["i"]), np.asarray(g["j"]),
                         np.asarray(g["w"]), g["n"],
                         cfg["diffusion_iterations"], cfg["eps"])
    if len(i) != len(d["i"]) or np.any(i != d["i"]) or np.any(j != d["j"]):
        return dict(diffusion_gap=float("inf"))
    w32 = w.astype(np.float32).astype(np.float64)
    gap = np.abs(np.asarray(d["w"], np.float64) - w32).max() if len(w) else 0
    return dict(diffusion_gap=float(gap / max(np.abs(w32).max(), 1e-30)))


def line_numbers(prog, segs, cams, tr, S, cfg, extent):
    """line_diff: clusters with a line on one side only, by member set;
    line_gap: over the clusters of both, the largest distance between the
    program's sub-segment endpoints and the reference's, over the
    capture's extent (a differing count of sub-segments counts as the
    whole extent).  Where the lines are refined, the program's endpoints
    lie on its refined line, and line_gap is instead their largest
    distance from the reference's refined line, which does not hang on
    the sweep's order of nearly coincident endpoints."""
    d = prog["clustered"]
    nv, ns = np.asarray(d["view"]), np.asarray(d["seg"])
    members = rk.clusters(prog["labels"], nv, ns,
                          cfg["min_cameras_per_cluster"])
    lines = None
    if cfg["refine_lines"] and members:
        lines = rn.refined_lines(members, nv, ns, prog["best"], S, segs,
                                 cams.P, tr, cfg["refine_iterations"])
    ref = rk.fit_lines(members, nv, ns, prog["best"], S, tr.inverse,
                       cfg["min_cameras_open"], lines)
    line_of = {}
    if lines is not None:
        line_of = {(tuple(v.tolist()), tuple(s.tolist())): (lines[0][c],
                                                            lines[1][c])
                   for c, (v, s, _) in enumerate(ref)}
    ref = {(tuple(v.tolist()), tuple(s.tolist())): g
           for v, s, g in ref if len(g)}
    got = {(tuple(v.tolist()), tuple(s.tolist())): g
           for v, s, g in prog["result"]}
    common = set(ref) & set(got)
    gap = 0.0
    for k in common:
        a, b = ref[k], got[k]
        if line_of:
            P, dv = line_of[k]
            X = b.reshape(-1, 3) - P
            dist = np.linalg.norm(X - (X @ dv)[:, None] * dv, axis=1)
            gap = max(gap, float(dist.max()) / extent)
        else:
            gap = max(gap, 1.0 if a.shape != b.shape else
                      float(np.abs(a - b).max()) / extent)
    return dict(line_diff=float(len(ref) + len(got) - 2 * len(common)),
                line_gap=gap)


def numbers(kinds, prog, capture, segs, cfg, views, device):
    """Every number of `kinds` ("neighbors", "match", "collin", "graph",
    "diffusion", "cluster", "lines") for one model; segs are the model's
    inputs."""
    # a float32 product on the card may otherwise run in TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    cams, nbrs, tr = reference_cameras(capture, cfg)
    S = prog["S"]
    out = {}
    if "neighbors" in kinds:
        out["neighbor_diff"] = float(sum(
            len(np.setxor1d(a, b)) for a, b in zip(nbrs, prog["neighbors"])))
    if "match" in kinds:
        out.update(match_numbers(prog, segs, cams, nbrs, views, cfg, device))
    if "collin" in kinds:
        out.update(collin_numbers(prog["collin"], segs, cfg, device))
    if "graph" in kinds:
        out.update(graph_numbers(prog, cams, S, cfg))
    if "diffusion" in kinds:
        out.update(diffusion_numbers(prog, cfg))
    if "cluster" in kinds:
        out.update(cluster_numbers(prog, cfg))
    if "lines" in kinds:
        C = cams.C
        extent = float(np.linalg.norm(C.max(0) - C.min(0))) / tr.scale
        out.update(line_numbers(prog, segs, cams, tr, S, cfg, extent))
    return out


def judge(values: dict, limits: dict):
    """(correct, [(name, value, limit)]): each number at or under its
    limit; a number that is missing or not finite fails."""
    rows = [(k, float(values.get(k, float("nan"))), float(lim))
            for k, lim in limits.items()]
    ok = all(np.isfinite(v) and v <= lim for _, v, lim in rows)
    return ok, rows


def _bf16(x):
    return torch.as_tensor(np.asarray(x, np.float64)).to(torch.bfloat16) \
        .double().numpy()


def _graph_dict(i, j, w, n, view, seg):
    return dict(i=i, j=j, w=w, n=n, view=view, seg=seg)


def control_program(kinds, prog, capture, segs, cfg, views, device):
    """The control: the reference put in the program's place, each stage
    computed from the control's own previous stage, in the precision
    below the one the configuration states: bfloat16 for the match step,
    the collinearity and the diffusion (float32 on the card), float32 for
    the float64 host stages (affinity, F-H, the fits; the refinement reads
    its inputs rounded to bfloat16).  Returns a program-shaped dict that
    `numbers` judges as it judges the program."""
    cams, nbrs, tr = reference_cameras(capture, cfg)
    S = prog["S"]
    c = dict(prog)
    c["neighbors"] = nbrs
    if "match" in kinds:
        c["matches"], best = {}, {k: [] for k in (
            "view", "seg", "tgt_view", "tgt_seg", "score", "d1", "d2")}
        for v in views:
            r = rm.match_view(segs, v, nbrs[v], cams, cfg, device,
                              torch.bfloat16)
            k = r["verified"]
            c["matches"][v] = (k // 65536 // 65536, k // 65536 % 65536,
                               k % 65536)
            for name, x in (("view", np.full(len(r["best_seg"]), v)),
                            ("seg", r["best_seg"]),
                            ("tgt_view", r["best_view"]),
                            ("tgt_seg", r["best_tgt"]),
                            ("score", r["best_score"]), ("d1", r["best_d1"]),
                            ("d2", r["best_d2"])):
                best[name].append(np.asarray(x))
        # the control's best matches of the sampled views, which only the
        # match step's numbers read
        c["match_best"] = {k: np.concatenate(x) for k, x in best.items()}
    if "collin" in kinds:
        fv, fi, fj, fw = [], [], [], []
        for v, s in enumerate(segs):
            i, j, w = rcl.pairs(s, cfg["collinearity_sigma"],
                                cfg["collinearity_aff_threshold"], device,
                                torch.bfloat16)
            fv.append(np.full(len(i), v))
            fi.append(i)
            fj.append(j)
            fw.append(w)
        c["collin"] = dict(view=np.concatenate(fv), i=np.concatenate(fi),
                           j=np.concatenate(fj), w=np.concatenate(fw))
    if "graph" in kinds:
        g = rk.affinity_graph(prog["best"], prog["match_list"],
                              prog["collin_maps"], S,
                              (cams.k_lower, cams.k_upper), prog["median"],
                              cfg, np.float32)
        c["graph"] = _graph_dict(g[0], g[1], g[2], len(g[3]), g[3], g[4])
        c["clustered"] = c["graph"]
    if "diffusion" in kinds:
        g = c["graph"]
        i, j, w = rn.diffuse(np.asarray(g["i"]), np.asarray(g["j"]),
                             np.asarray(g["w"]), g["n"],
                             cfg["diffusion_iterations"], cfg["eps"],
                             torch.bfloat16)
        c["clustered"] = _graph_dict(i, j, w.astype(np.float32), g["n"],
                                     g["view"], g["seg"])
    if "cluster" in kinds or "lines" in kinds:
        d = c["clustered"]
        c["labels"] = rk.fh_labels(np.asarray(d["i"]), np.asarray(d["j"]),
                                   np.asarray(d["w"]), d["n"], cfg["fh_c"],
                                   np.float32)
    if "lines" in kinds:
        d = c["clustered"]
        nv, ns = np.asarray(d["view"]), np.asarray(d["seg"])
        members = rk.clusters(c["labels"], nv, ns,
                              cfg["min_cameras_per_cluster"])
        best32 = dict(prog["best"])
        for k in ("P1", "P2"):
            best32[k] = np.asarray(best32[k], np.float32).astype(np.float64)
        lines = None
        if cfg["refine_lines"] and members:
            lines = rn.refined_lines(members, nv, ns, best32, S, segs,
                                     cams.P, tr, cfg["refine_iterations"],
                                     rounding=_bf16)
        c["result"] = [x for x in rk.fit_lines(
            members, nv, ns, best32, S, tr.inverse,
            cfg["min_cameras_open"], lines) if len(x[2])]
    return c
