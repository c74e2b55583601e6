"""Where two runs of the pipeline part: their matching outputs and their
TXT models, compared by identity.

Two runs of the same scene (the card against the CPU, or the port against
line3d_tpu) can part at matching, where float32 rounding moves a pair gate,
a support past its threshold or a confidence among near-equal ones.  These
functions count such differences and classify each best-match pick that
differs: a *near-tie* when run A scores run B's target within `rel` of its
own pick, *traced* when the row (view, segment) holds a verified match that
only one run has, else *untraced*.  An untraced pick can still be a tie
of the float64 confidences that float32 rounding orders either way:
`float64_tie` scores the row again with the port's plain twins in float32
and float64 and compares the gap with the rounding error.
"""
from __future__ import annotations

import numpy as np

from ..io.writers import load_txt


def verified_keys(vm) -> set:
    """{(src_seg, tgt_view, tgt_seg)} of one view's ViewMatches."""
    return set(zip(np.asarray(vm.src_seg).tolist(),
                   np.asarray(vm.tgt_view).tolist(),
                   np.asarray(vm.tgt_seg).tolist()))


def verified_differences(matches_a, matches_b) -> dict:
    """{view: (n_a, n_b, only_a, only_b)}: each view's verified-match
    counts and the matches only one run has (sorted lists of
    (src_seg, tgt_view, tgt_seg)).  Both lists hold the same views."""
    if [vm.view for vm in matches_a] != [vm.view for vm in matches_b]:
        raise ValueError("the runs matched different views")
    out = {}
    for a, b in zip(matches_a, matches_b):
        ka, kb = verified_keys(a), verified_keys(b)
        out[int(a.view)] = (len(ka), len(kb), sorted(ka - kb),
                            sorted(kb - ka))
    return out


def _best_table(best) -> dict:
    return {(int(v), int(s)): (int(tv), int(ts), float(sc))
            for v, s, tv, ts, sc in zip(best.view, best.seg, best.tgt_view,
                                        best.tgt_seg, best.score)}


def best_pick_differences(best_a, best_b, matches_a, matches_b,
                          rel: float = 1e-5) -> dict:
    """The best-match picks (BestMatches) of run B that differ from run
    A's, classified.  `matches_a` must carry confidences (the host
    selection's ViewMatches, line3d_tpu's per-view engine); `matches_b`
    only identities.

    Returns dict(n_a, n_b, differ, near_tie, traced, untraced, max_gap):
    `differ` counts the keys of either run whose pick is missing from the
    other or has another target; `untraced` lists (view, seg, pick_a,
    pick_b, gap) of those neither a near-tie nor traced; `max_gap` is the
    largest relative confidence gap |c_A(A's pick) - c_A(B's pick)| /
    c_A(A's pick) over the differing picks whose target A verified
    too."""
    conf, rows_a = {}, {}
    for vm in matches_a:
        if vm.confidence is None:
            raise ValueError("matches_a carries no confidences")
        for s, tv, ts, c in zip(vm.src_seg.tolist(), vm.tgt_view.tolist(),
                                vm.tgt_seg.tolist(),
                                vm.confidence.tolist()):
            conf[(vm.view, s, tv, ts)] = c
            rows_a.setdefault((vm.view, s), set()).add((tv, ts))
    rows_b = {}
    for vm in matches_b:
        for s, tv, ts in zip(vm.src_seg.tolist(), vm.tgt_view.tolist(),
                             vm.tgt_seg.tolist()):
            rows_b.setdefault((vm.view, s), set()).add((tv, ts))
    ta, tb = _best_table(best_a), _best_table(best_b)
    out = dict(n_a=len(ta), n_b=len(tb), differ=0, near_tie=0, traced=0,
               untraced=[], max_gap=0.0)
    for key in sorted(ta.keys() | tb.keys()):
        pa, pb = ta.get(key), tb.get(key)
        if pa is not None and pb is not None and pa[:2] == pb[:2]:
            continue
        out["differ"] += 1
        gap = None
        if pa is not None and pb is not None and key + pb[:2] in conf:
            c_own = conf[key + pa[:2]]
            gap = abs(c_own - conf[key + pb[:2]]) / c_own
            out["max_gap"] = max(out["max_gap"], gap)
            if gap <= rel:
                out["near_tie"] += 1
                continue
        if rows_a.get(key, set()) != rows_b.get(key, set()):
            out["traced"] += 1
        else:
            out["untraced"].append(key + (pa, pb, gap))
    return out


def row_confidences(scene, cameras, neighbors, config, v: int, s: int,
                    cam, tgt, valid, dtype):
    """Confidences [M] of row s of view v's match table (its slots: cam,
    tgt [M] int32, valid [M] bool) from the port's depth recompute and
    scoring twin on the CPU in `dtype`, with the camera constants rounded
    as the match step rounds them for float32 (`engine.ViewContext`).
    `scene` and `cameras` are the port's (conditioned), `neighbors` the
    run's visual neighbours."""
    import torch
    from ..match import pairwise, scoring_cuda
    f32 = dtype == torch.float32
    nb = np.asarray(neighbors[v], np.int64)
    F = cameras.fundamentals_for_pairs(np.stack([np.full(len(nb), v), nb],
                                                axis=1))

    def t(x):
        return torch.as_tensor(np.asarray(x, np.float32 if f32 else
                                          np.float64))
    RtKinv, C, P = (t(cameras.f32(n) if f32 else getattr(cameras, n))
                    for n in ("RtKinv", "C", "P"))
    segs = scene.segments_t.cpu().to(dtype)
    row = slice(s, s + 1)
    cam, tgt, valid = (torch.as_tensor(np.array(x)[None])
                       for x in (cam, tgt, valid))
    idx = torch.as_tensor(nb)
    depths = pairwise.depths_for_matches(segs[v][row], segs[idx], cam, tgt,
                                         valid, t(F), RtKinv[v],
                                         RtKinv[idx], C[v], C[idx])
    k = cameras.spatial_uncertainty_k(2.0 * config.sigma_p)[v]
    conf = scoring_cuda.score(
        segs[v][row], RtKinv[v], C[v], cam, tgt, depths, valid, P[idx],
        segs[idx], float(np.float32(config.sigma_p)),
        float(np.float32(config.sigma_a)), float(np.float32(k)),
        support_threshold=float(config.support_threshold))
    return conf[0].double().numpy()


def float64_tie(scene, cameras, neighbors, config, v: int, s: int, slots,
                confs, pick_a, pick_b):
    """(gap64, err32) of two runs' picks (tgt_view, tgt_seg) of row s of
    view v: their relative confidence gap in float64, and the largest
    relative float32 error, against float64, of the port's float32 twin
    and of each row of `confs` on those two slots.  `slots` = (cam, tgt,
    valid) [M] of the row, `confs` a list of float32 confidence rows [M] on
    those slots (the runs' own scores).  gap64 < err32: float32 rounding
    decides which of the two wins."""
    import torch
    cam, tgt, valid = (np.asarray(x) for x in slots)
    nb = np.asarray(neighbors[v])
    slot = {(int(nb[c]), int(j)): m for m, (c, j, ok) in enumerate(
        zip(cam, tgt, valid)) if ok}
    a, b = slot[tuple(pick_a[:2])], slot[tuple(pick_b[:2])]
    args = (scene, cameras, neighbors, config, v, s, cam, tgt, valid)
    c32 = row_confidences(*args, torch.float32)
    c64 = row_confidences(*args, torch.float64)
    err = max(abs(float(c[m]) - c64[m]) / c64[m]
              for c in [c32] + list(confs) for m in (a, b))
    return abs(c64[a] - c64[b]) / c64[a], err


def member_sets(txt_path: str) -> list:
    """Each 3D line of a TXT model as the frozenset of its (camID, segID)
    members, in file order."""
    return [frozenset((c, s) for c, s, _ in res)
            for _, res in load_txt(txt_path)]


def compare_models(txt_a: str, txt_b: str) -> dict:
    """Two TXT models by their lines' member sets: dict(lines_a, lines_b,
    shared, only_a, only_b), where only_a / only_b list the member counts
    of the lines (member sets) one model has and the other not, largest
    first."""
    a, b = member_sets(txt_a), member_sets(txt_b)
    left = {}
    for m in b:
        left[m] = left.get(m, 0) + 1
    shared, only_a = 0, []
    for m in a:
        if left.get(m, 0):
            left[m] -= 1
            shared += 1
        else:
            only_a.append(len(m))
    only_b = [len(m) for m, k in left.items() for _ in range(k)]
    return dict(lines_a=len(a), lines_b=len(b), shared=shared,
                only_a=sorted(only_a, reverse=True),
                only_b=sorted(only_b, reverse=True))
