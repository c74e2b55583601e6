"""The per-view match step in plain PyTorch: pair gates and depths,
multi-view support scores, and the selection.

A restatement of Line3D++'s matching (cudawrapper.cu:306-335, 538-714,
1025-1110; line3D.cc:899-965), patterned on the port's plain twins but
dense and written anew here: every (source, neighbour, target) pair is
tested, each source segment's matches are listed in (neighbour, target)
order, and every match is scored against all the others of its segment.
`dtype` is float32 for the reference; the control runs it in bfloat16.
It imports nothing of the program.
"""
from __future__ import annotations

import numpy as np
import torch

EPS = 1e-12


def sqrt(x):
    """A correctly rounded square root (through float64)."""
    return torch.sqrt(x.double()).to(x.dtype)


def _fline(M, x, y):
    return (M[0, 0] * x + M[0, 1] * y + M[0, 2],
            M[1, 0] * x + M[1, 1] * y + M[1, 2],
            M[2, 0] * x + M[2, 1] * y + M[2, 2])


def _ray(M, x, y):
    rx, ry, rz = _fline(M, x, y)
    inv = 1.0 / sqrt((rx * rx + ry * ry + rz * rz).clamp_min(EPS))
    return rx * inv, ry * inv, rz * inv


def _tri(r1, r2, w0):
    """Depths along two rays at their closest approach."""
    a = r1[0] * r1[0] + r1[1] * r1[1] + r1[2] * r1[2]
    b = r1[0] * r2[0] + r1[1] * r2[1] + r1[2] * r2[2]
    c = r2[0] * r2[0] + r2[1] * r2[1] + r2[2] * r2[2]
    d = r1[0] * w0[0] + r1[1] * w0[1] + r1[2] * w0[2]
    e = r2[0] * w0[0] + r2[1] * w0[1] + r2[2] * w0[2]
    den = a * c - b * b
    ok = den.abs() > EPS
    zs = torch.where(ok, den, torch.ones_like(den))
    m1 = torch.full_like(den, -1.0)
    return (torch.where(ok, (b * e - c * d) / zs, m1),
            torch.where(ok, (a * e - b * d) / zs, m1), ok)


def _intersect(la, lb, lc, ma, mb, mc):
    ix = lb * mc - lc * mb
    iy = lc * ma - la * mc
    iz = la * mb - lb * ma
    ok = iz.abs() > EPS
    zs = torch.where(ok, iz, torch.ones_like(iz))
    z = torch.zeros_like(iz)
    return torch.where(ok, ix / zs, z), torch.where(ok, iy / zs, z), ok


def _overlap(ax, ay, bx, by, cx, cy, dx, dy):
    """Share of segment (a, b) that the collinear segment (c, d) covers."""
    def dist(ux, uy, vx, vy):
        return sqrt((ux - vx) ** 2 + (uy - vy) ** 2)

    def on(px, py, qx, qy, rx, ry):
        return (px - rx) * (qx - rx) + (py - ry) * (qy - ry) < EPS

    len_ab, len_cd = dist(ax, ay, bx, by), dist(cx, cy, dx, dy)
    zero = torch.zeros((), dtype=len_ab.dtype, device=len_ab.device)
    c_in, d_in = on(ax, ay, bx, by, cx, cy), on(ax, ay, bx, by, dx, dy)
    a_in, b_in = on(cx, cy, dx, dy, ax, ay), on(cx, cy, dx, dy, bx, by)
    c1 = len_cd / len_ab.clamp_min(EPS)
    c2 = len_ab / len_cd.clamp_min(EPS)
    l31, l32 = dist(bx, by, dx, dy), dist(ax, ay, dx, dy)
    c3 = torch.where(a_in & (l31 > EPS),
                     dist(cx, cy, ax, ay) / l31.clamp_min(EPS),
                     torch.where(l32 > EPS,
                                 dist(cx, cy, bx, by) / l32.clamp_min(EPS),
                                 zero))
    l41, l42 = dist(ax, ay, cx, cy), dist(bx, by, cx, cy)
    c4 = torch.where(b_in & (l41 > EPS),
                     dist(dx, dy, bx, by) / l41.clamp_min(EPS),
                     torch.where(l42 > EPS,
                                 dist(dx, dy, ax, ay) / l42.clamp_min(EPS),
                                 zero))
    ov = torch.where(c_in & d_in, c1, torch.where(
        a_in & b_in, c2, torch.where(c_in, c3, torch.where(d_in, c4, zero))))
    return torch.where((len_ab < 1.0) | (len_cd < 1.0), zero, ov)


def pair_planes(src, tgt, F, M_src, M_tgt, C_src, C_tgt, lo, hi):
    """Every (source, target) pair of one view pair: the four depths and
    the gate (epipolar transfer, overlap lo/hi, four positive depths)."""
    p1x, p1y, p2x, p2y = (src[:, k:k + 1] for k in range(4))
    q1x, q1y, q2x, q2y = (tgt[None, :, k] for k in range(4))
    l1 = (p1y - p2y, p2x - p1x, p1x * p2y - p1y * p2x)
    l2 = (q1y - q2y, q2x - q1x, q1x * q2y - q1y * q2x)
    Ft = F.T
    a1x, a1y, ok1 = _intersect(*l2, *_fline(F, p1x, p1y))
    a2x, a2y, ok2 = _intersect(*l2, *_fline(F, p2x, p2y))
    b1x, b1y, ok3 = _intersect(*l1, *_fline(Ft, q1x, q1y))
    b2x, b2y, ok4 = _intersect(*l1, *_fline(Ft, q2x, q2y))
    ov1 = _overlap(p1x, p1y, p2x, p2y, b1x, b1y, b2x, b2y)
    ov2 = _overlap(q1x, q1y, q2x, q2y, a1x, a1y, a2x, a2y)
    ov_ok = (torch.minimum(ov1, ov2) > lo) & (torch.maximum(ov1, ov2) > hi)
    w0 = tuple(C_src[k] - C_tgt[k] for k in range(3))
    d_p1, _, t1 = _tri(_ray(M_src, p1x, p1y), _ray(M_tgt, a1x, a1y), w0)
    d_p2, _, t2 = _tri(_ray(M_src, p2x, p2y), _ray(M_tgt, a2x, a2y), w0)
    _, d_q1, t3 = _tri(_ray(M_src, b1x, b1y), _ray(M_tgt, q1x, q1y), w0)
    _, d_q2, t4 = _tri(_ray(M_src, b2x, b2y), _ray(M_tgt, q2x, q2y), w0)
    ok = (ok1 & ok2 & ok3 & ok4 & ov_ok & t1 & t2 & t3 & t4 & (d_p1 > 0)
          & (d_p2 > 0) & (d_q1 > 0) & (d_q2 > 0))
    return (d_p1, d_p2, d_q1, d_q2), ok


def view_table(segs, v, nb, cams32, Fs, lo, hi):
    """One view's match table in (neighbour, target) order per source row:
    cam, tgt [S, M] (-1 pads), valid [S, M], depths [S, M, 4]."""
    src = segs[v]
    S = src.shape[0]
    dev, dt = src.device, src.dtype
    rows, cams_, tgts, deps = [], [], [], []
    for n, u in enumerate(nb):
        (dp1, dp2, dq1, dq2), ok = pair_planes(
            src, segs[u], Fs[n], cams32["RtKinv"][v], cams32["RtKinv"][u],
            cams32["C"][v], cams32["C"][u], lo, hi)
        s, t = torch.nonzero(ok, as_tuple=True)
        rows.append(s)
        cams_.append(torch.full_like(s, n))
        tgts.append(t)
        deps.append(torch.stack([dp1.expand(ok.shape)[s, t],
                                 dp2.expand(ok.shape)[s, t],
                                 dq1.expand(ok.shape)[s, t],
                                 dq2.expand(ok.shape)[s, t]], dim=1))
    s = torch.cat(rows)
    key = s * (len(nb) * 65536) + torch.cat(cams_) * 65536 + torch.cat(tgts)
    order = torch.argsort(key)
    s = s[order]
    cam = torch.cat(cams_)[order]
    tgt = torch.cat(tgts)[order]
    dep = torch.cat(deps)[order]
    count = torch.bincount(s, minlength=S)
    start = torch.cumsum(count, 0) - count
    slot = torch.arange(len(s), device=dev) - start[s]
    M = max(int(count.max()) if len(s) else 0, 1)
    T_cam = torch.full((S, M), -1, dtype=torch.int64, device=dev)
    T_tgt = torch.full((S, M), -1, dtype=torch.int64, device=dev)
    T_dep = torch.zeros((S, M, 4), dtype=dt, device=dev)
    T_cam[s, slot] = cam
    T_tgt[s, slot] = tgt
    T_dep[s, slot] = dep
    return T_cam, T_tgt, T_cam >= 0, T_dep


def _unit_dirs(d1, d2, ray1, ray2):
    dirc = [d2 * ray2[:, None, i] - d1 * ray1[:, None, i] for i in range(3)]
    dn = sqrt(dirc[0] ** 2 + dirc[1] ** 2 + dirc[2] ** 2).clamp_min(EPS)
    return torch.stack([c / dn for c in dirc], dim=-1)


def score(src, M_src, C_src, cam, tgt, depths, valid, P_nb, segs_nb,
          sigma_p, sigma_a, spatial_k, support_t, chunk_elems=1 << 24):
    """conf [S, M]: for each match, the sum over the other neighbours of
    the best support among that neighbour's matches of the same segment;
    support = min(position Gaussian, angle Gaussian), kept above
    support_t, within the spatial gate (cudawrapper.cu:614-714)."""
    S, Mx = cam.shape
    N = P_nb.shape[0]
    dev, dt = cam.device, depths.dtype
    ones = torch.ones((S, 1), dtype=dt, device=dev)
    p1 = torch.cat([src[:, 0:2], ones], 1)
    p2 = torch.cat([src[:, 2:4], ones], 1)

    def rays(p):
        r = torch.stack([M_src[i, 0] * p[:, 0] + M_src[i, 1] * p[:, 1]
                         + M_src[i, 2] * p[:, 2] for i in range(3)], 1)
        n = sqrt(r[:, 0] * r[:, 0] + r[:, 1] * r[:, 1] + r[:, 2] * r[:, 2])
        return r / n[:, None].clamp_min(EPS)
    ray1, ray2 = rays(p1), rays(p2)
    flat = cam.clamp_min(0) * segs_nb.shape[1] + tgt.clamp_min(0)
    tc = segs_nb.reshape(-1, 4)[flat.reshape(-1)].reshape(S, Mx, 4)
    tq1 = torch.cat([tc[..., 0:2], torch.ones_like(tc[..., :1])], -1)
    tq2 = torch.cat([tc[..., 2:4], torch.ones_like(tc[..., :1])], -1)
    tl = torch.stack([tq1[..., 1] * tq2[..., 2] - tq1[..., 2] * tq2[..., 1],
                      tq1[..., 2] * tq2[..., 0] - tq1[..., 0] * tq2[..., 2],
                      tq1[..., 0] * tq2[..., 1] - tq1[..., 1] * tq2[..., 0]],
                     -1)
    tden = sqrt(tl[..., 0] ** 2 + tl[..., 1] ** 2).clamp_min(EPS)
    sp2, sa2 = 2.0 * sigma_p * sigma_p, 2.0 * sigma_a * sigma_a
    need = valid.sum(1)
    conf = torch.zeros((S, Mx), dtype=dt, device=dev)
    order = torch.argsort(need).tolist()
    need_l = need.tolist()
    i = 0
    while i < S:
        Mc = need_l[order[i]]
        j = i + 1
        while j < S and j - i < 1 << 16:
            Mn = need_l[order[j]]
            if (j - i + 1) * Mn * Mn > chunk_elems and j > i:
                break
            Mc = Mn
            j += 1
        rows = torch.as_tensor(order[i:j], device=dev)
        i = j
        if Mc == 0:
            continue
        cc, vc = cam[rows, :Mc], valid[rows, :Mc]
        d1, d2 = depths[rows, :Mc, 0], depths[rows, :Mc, 1]
        r1, r2 = ray1[rows], ray2[rows]
        Sc = len(rows)
        P1 = C_src + d1[..., None] * r1[:, None, :]
        P2 = C_src + d2[..., None] * r2[:, None, :]
        dirn = _unit_dirs(d1, d2, r1, r2)

        def proj(P):
            q = [P[..., 0:1] * P_nb[None, None, :, k, 0]
                 + P[..., 1:2] * P_nb[None, None, :, k, 1]
                 + P[..., 2:3] * P_nb[None, None, :, k, 2]
                 + P_nb[None, None, :, k, 3] for k in range(3)]
            ok = q[2].abs() > EPS
            z = torch.where(ok, q[2], torch.ones_like(q[2]))
            return q[0] / z, q[1] / z, ok
        x1, y1, ok1 = proj(P1)
        x2, y2, ok2 = proj(P2)
        plx, ply, plz = y1 - y2, x2 - x1, x1 * y2 - y1 * x2
        pld = sqrt(plx ** 2 + ply ** 2).clamp_min(EPS)
        idx = cc.clamp_min(0)[:, None, :].expand(Sc, Mc, Mc)

        def at_m2(T):
            return torch.gather(T, 2, idx)
        px1, py1, px2, py2 = at_m2(x1), at_m2(y1), at_m2(x2), at_m2(y2)
        lx, ly, lz = at_m2(plx), at_m2(ply), at_m2(plz)
        ld = at_m2(pld).clamp_min(EPS)
        pok = at_m2((ok1 & ok2).to(dt)) > 0.5
        t = tl[rows, :Mc]
        tx, ty, tz = t[:, None, :, 0], t[:, None, :, 1], t[:, None, :, 2]
        td = tden[rows, None, :Mc]
        q1, q2 = tq1[rows, :Mc], tq2[rows, :Mc]
        dist = torch.maximum(
            torch.maximum((tx * px1 + ty * py1 + tz).abs() / td,
                          (tx * px2 + ty * py2 + tz).abs() / td),
            torch.maximum(
                (lx * q1[:, None, :, 0] + ly * q1[:, None, :, 1] + lz).abs()
                / ld,
                (lx * q2[:, None, :, 0] + ly * q2[:, None, :, 1] + lz).abs()
                / ld))
        c_pos = torch.exp(-dist * dist / sp2)
        dots = (dirn[:, :, None, 0] * dirn[:, None, :, 0]
                + dirn[:, :, None, 1] * dirn[:, None, :, 1]
                + dirn[:, :, None, 2] * dirn[:, None, :, 2])
        ang = torch.rad2deg(torch.arccos(dots.clamp(-1.0, 1.0)))
        ang = torch.where(ang > 90.0, 180.0 - ang, ang)
        c_ang = torch.exp(-ang * ang / sa2)
        gate = ((d1[:, :, None] - d1[:, None, :]).abs()
                <= spatial_k * d1[:, :, None]) & \
            ((d2[:, :, None] - d2[:, None, :]).abs()
             <= spatial_k * d2[:, :, None])
        c = torch.minimum(c_pos, c_ang)
        eye = torch.eye(Mc, dtype=torch.bool, device=dev)[None]
        ok = vc[:, :, None] & vc[:, None, :] & gate & pok & ~eye & \
            (c > support_t)
        c = torch.where(ok, c, torch.zeros_like(c))
        total = torch.zeros((Sc, Mc), dtype=dt, device=dev)
        for n in range(N):
            best = torch.where((cc == n)[:, None, :], c,
                               torch.zeros_like(c)).amax(2)
            total = total + torch.where(cc == n, torch.zeros_like(best), best)
        conf[rows, :Mc] = torch.where(vc, total, torch.zeros_like(total))
    return conf


def match_view(segs, v, nb, cams, cfg, device, dtype=torch.float32):
    """The reference's answer for view v against its neighbours `nb`:
    verified identities, every table entry's confidence, the best match
    per segment and the median depth.

    segs: list of [S_v, 4] float32 arrays; cams: conditioned `Cams`."""
    t = {k: torch.as_tensor(np.asarray(getattr(cams, k), np.float32),
                            device=device).to(dtype)
         for k in ("RtKinv", "C", "P")}
    seg_t = [torch.as_tensor(s, device=device).to(dtype) for s in segs]
    Fs = torch.as_tensor(cams.fundamentals(v, nb).astype(np.float32),
                         device=device).to(dtype)
    lo, hi = cfg["min_overlap_lower"], cfg["min_overlap_upper"]
    cam, tgt, valid, depths = view_table(seg_t, v, nb, t, Fs, lo, hi)
    Smax = max(len(s) for s in segs)
    segs_nb = torch.zeros((len(nb), Smax, 4), dtype=dtype, device=device)
    for n, u in enumerate(nb):
        segs_nb[n, :len(segs[u])] = seg_t[u]
    k = float(np.float32(cams.spatial_k(2.0 * cfg["sigma_p"])[v]))
    conf = score(seg_t[v], t["RtKinv"][v], t["C"][v], cam, tgt, depths,
                 valid, t["P"][nb], segs_nb,
                 float(np.float32(cfg["sigma_p"])),
                 float(np.float32(cfg["sigma_a"])), k,
                 float(cfg["support_threshold"]))
    cam, tgt, valid = cam.cpu().numpy(), tgt.cpu().numpy(), \
        valid.cpu().numpy()
    depths = depths.float().cpu().numpy()
    conf = conf.float().cpu().numpy()
    return select(cam, tgt, valid, depths, conf, np.asarray(nb), cfg)


def key(s, tv, ts):
    """One int64 per match identity (source segment, target view, target
    segment)."""
    return (np.asarray(s, np.int64) * 65536 + np.asarray(tv, np.int64)) \
        * 65536 + np.asarray(ts, np.int64)


def select(cam, tgt, valid, depths, conf, nb, cfg):
    """Verified matches (conf above the threshold) as sorted keys, every
    table entry's key, confidence and depths d1, d2, each segment's best
    (the first maximum) with score min(conf / norm, 1), and the median of
    the best raw matches' depths (cudawrapper.cu:1025-1110)."""
    thr, norm = cfg["confidence_threshold"], cfg["confidence_norm"]
    cm = np.where(valid, conf, -np.inf)
    arg = cm.argmax(1)
    has = cm.max(1) > thr / 2.0
    med = 1.0
    if has.any():
        r = np.nonzero(has)[0]
        dall = np.sort(depths[r, arg[r]][:, :2].reshape(-1), kind="stable")
        med = float(dall[len(dall) // 2])
    vs, vm = np.nonzero(valid)
    tkeys = key(vs, nb[cam[vs, vm]], tgt[vs, vm])
    order = np.argsort(tkeys)
    keep = valid & (conf > thr)
    si, mi = np.nonzero(keep)
    cf = np.where(keep, conf, -np.inf)
    bs = np.nonzero(cf.max(1) > -np.inf)[0]
    bm = cf.argmax(1)[bs]
    return dict(
        verified=np.sort(key(si, nb[cam[si, mi]], tgt[si, mi])),
        table_keys=tkeys[order], table_conf=conf[vs, vm][order],
        table_d1=depths[vs, vm, 0][order], table_d2=depths[vs, vm, 1][order],
        best_seg=bs, best_view=nb[cam[bs, bm]], best_tgt=tgt[bs, bm],
        best_score=np.minimum(conf[bs, bm] / norm, 1.0),
        best_d1=depths[bs, bm, 0], best_d2=depths[bs, bm, 1], median=med)
