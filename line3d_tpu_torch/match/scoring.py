"""Match verification: multi-view support scoring of raw matches.

Torch port of `line3d_tpu/match/scoring.py`, the equivalent of
K_verify_matches (reference: cudawrapper.cu:614-714).  For every raw match
m = (src segment s, neighbor cam c, tgt segment j) with triangulated depths
(d1, d2):
  * unproject s's endpoints at (d1, d2) -> 3D hypothesis (P1, P2),
  * for every OTHER raw match m2 of the same source segment in a DIFFERENT
    camera c2: reproject (P1, P2) into c2, compare against m2's target
    segment's 2D line (mutual max point-line distance), and compare the 3D
    direction of m with m2's hypothesis (both lie on s's viewing rays, so the
    3D spatial gate reduces to a depth-delta test),
  * support(m, m2) = min(exp(-dist^2 / 2 sigma_p^2),
                          exp(-angle^2 / 2 sigma_a^2)), kept if > 0.5,
  * confidence(m) = sum over cameras c2 != c of max_{m2 in c2} support(m, m2).

`score_matches` is the plain twin of kernels K2/K3: the [M x M] support
planes per source segment evaluated densely, over chunks of rows.
`slot_terms` and `kernel_inputs` are the plain form of what the CUDA kernel
derives from the match table while it stages a row (the Pallas kernel's
prep, `scoring_pallas.py:390-448`); the kernel itself takes the table as
the engine holds it.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core import geometry as g
from .pairwise import gather_target_coords

EPS = g.EPS


def row_need(valid):
    """need[s] = 1 + the last valid slot of row s (0 for an empty row)."""
    idx = torch.arange(1, valid.shape[1] + 1, dtype=torch.int32,
                       device=valid.device)
    return torch.where(valid, idx, torch.zeros_like(idx)).amax(dim=1) \
        if valid.shape[1] else torch.zeros(valid.shape[0], dtype=torch.int32,
                                           device=valid.device)


def _unit_dirs(d1, d2, ray1, ray2):
    """Normalized hypothesis directions [S, M, 3] from depths [S, M] on the
    source rays [S, 3]: (C + d2 ray2) - (C + d1 ray1), per component."""
    dirc = [d2 * ray2[:, i:i + 1] - d1 * ray1[:, i:i + 1] for i in range(3)]
    dnorm = g.sqrt(dirc[0] ** 2 + dirc[1] ** 2 + dirc[2] ** 2) \
        .clamp_min(EPS)
    return torch.stack([c / dnorm for c in dirc], dim=-1)


def score_matches(segs_src, mask_src, RtKinv_src, C_src,
                  cam, tgt, depths, valid,
                  P_nb, segs_nb,
                  sigma_p, sigma_a, spatial_k,
                  support_threshold=0.5, tcoords=None,
                  chunk_elems: int = 1 << 22):
    """Score all matches of one source view (see module docstring).

    Rows are processed in chunks of about `chunk_elems` [m, m2] pairs, and
    each chunk's match axis is cut to its largest `need` (slots at or past
    it are empty, so they neither score nor support).

    Returns confidence [S, M] float32 (0 for invalid slots).
    """
    S, M = cam.shape
    N = P_nb.shape[0]
    dev = cam.device
    f32 = torch.float32

    p1, p2 = g.seg_endpoints(segs_src)              # [S, 3]
    ray1 = g.ray_dir(RtKinv_src, p1)
    ray2 = g.ray_dir(RtKinv_src, p2)

    if tcoords is None:
        tcoords = gather_target_coords(segs_nb, cam, tgt)
    tq1 = g.hom(tcoords[..., 0:2])                  # [S, M, 3]
    tq2 = g.hom(tcoords[..., 2:4])
    tline = g.cross3(tq1, tq2)
    tline_den = g.sqrt(tline[..., 0] ** 2 + tline[..., 1] ** 2) \
        .clamp_min(EPS)

    sig_p2 = 2.0 * sigma_p * sigma_p
    sig_a2 = 2.0 * sigma_a * sigma_a
    need = row_need(valid)
    conf = torch.zeros((S, M), dtype=f32, device=dev)
    mmax = int(need.max()) if S else 0
    if mmax == 0:
        return conf
    rows = max(1, chunk_elems // (mmax * mmax))

    def proj_all(P):
        """Project [Sc, Mc, 3] points into all N neighbors: [Sc, Mc, N]."""
        Pn = P_nb
        q = [P[..., 0:1] * Pn[None, None, :, i, 0]
             + P[..., 1:2] * Pn[None, None, :, i, 1]
             + P[..., 2:3] * Pn[None, None, :, i, 2]
             + Pn[None, None, :, i, 3] for i in range(3)]
        ok = q[2].abs() > EPS
        zs = torch.where(ok, q[2], torch.ones_like(q[2]))
        return q[0] / zs, q[1] / zs, ok

    for r0 in range(0, S, rows):
        r1 = min(S, r0 + rows)
        Mc = int(need[r0:r1].max())
        if Mc == 0:
            continue
        camc = cam[r0:r1, :Mc]
        validc = valid[r0:r1, :Mc]
        d1c = depths[r0:r1, :Mc, 0]
        d2c = depths[r0:r1, :Mc, 1]
        ray1c, ray2c = ray1[r0:r1], ray2[r0:r1]
        Sc = r1 - r0

        # absolute 3D endpoints [Sc, Mc, 3]
        P1 = C_src + d1c[..., None] * ray1c[:, None, :]
        P2 = C_src + d2c[..., None] * ray2c[:, None, :]
        # hypothesis direction (C + d2 ray2) - (C + d1 ray1), formed as in
        # the kernel's prep so both round alike
        dirn = _unit_dirs(d1c, d2c, ray1c, ray2c)

        px1, py1, ok1 = proj_all(P1)
        px2, py2, ok2 = proj_all(P2)
        pok = ok1 & ok2                              # [Sc, Mc, N]

        # projected 2D line in each neighbor
        plx = py1 - py2
        ply = px2 - px1
        plz = px1 * py2 - py1 * px2
        pl_den = g.sqrt(plx ** 2 + ply ** 2).clamp_min(EPS)

        # value of match m in the camera of m2: [Sc, Mc(m), Mc(m2)]
        has_cam = camc >= 0
        idx = camc.clamp_min(0).long()[:, None, :].expand(Sc, Mc, Mc)

        def gather_m2(T):
            out = torch.gather(T, 2, idx)
            return torch.where(has_cam[:, None, :], out, torch.zeros_like(out))

        px1g, py1g = gather_m2(px1), gather_m2(py1)
        px2g, py2g = gather_m2(px2), gather_m2(py2)
        plxg, plyg, plzg = gather_m2(plx), gather_m2(ply), gather_m2(plz)
        pldg = gather_m2(pl_den).clamp_min(EPS)
        pokg = gather_m2(pok.to(f32)) > 0.5

        # projected endpoints of m vs m2's target line
        tl = tline[r0:r1, :Mc]
        tlx, tly, tlz = tl[:, None, :, 0], tl[:, None, :, 1], tl[:, None, :, 2]
        tden = tline_den[r0:r1, None, :Mc]
        da1 = (tlx * px1g + tly * py1g + tlz).abs() / tden
        da2 = (tlx * px2g + tly * py2g + tlz).abs() / tden

        # m2's target endpoints vs m's projected line
        q1 = tq1[r0:r1, :Mc]
        q2 = tq2[r0:r1, :Mc]
        db1 = (plxg * q1[:, None, :, 0] + plyg * q1[:, None, :, 1]
               + plzg).abs() / pldg
        db2 = (plxg * q2[:, None, :, 0] + plyg * q2[:, None, :, 1]
               + plzg).abs() / pldg

        dist = torch.maximum(torch.maximum(da1, da2), torch.maximum(db1, db2))
        conf_pos = torch.exp(-dist * dist / sig_p2)

        # 3D angle between hypotheses
        dots = (dirn[:, :, None, 0] * dirn[:, None, :, 0]
                + dirn[:, :, None, 1] * dirn[:, None, :, 1]
                + dirn[:, :, None, 2] * dirn[:, None, :, 2])
        ang = torch.rad2deg(torch.arccos(dots.clamp(-1.0, 1.0)))
        ang = torch.where(ang > 90.0, 180.0 - ang, ang)
        conf_ang = torch.exp(-ang * ang / sig_a2)

        # spatial gate: hypotheses share the src rays => depth-delta test
        # (cudawrapper.cu:387-401)
        dd1 = (d1c[:, :, None] - d1c[:, None, :]).abs()
        dd2 = (d2c[:, :, None] - d2c[:, None, :]).abs()
        gate = (dd1 <= spatial_k * d1c[:, :, None]) & \
               (dd2 <= spatial_k * d2c[:, :, None])

        c = torch.minimum(conf_pos, conf_ang)
        eye = torch.eye(Mc, dtype=torch.bool, device=dev)[None]
        pair_ok = (validc[:, :, None] & validc[:, None, :] & gate & pokg
                   & ~eye)
        c = torch.where(pair_ok & (c > support_threshold), c,
                        torch.zeros_like(c))

        # per-camera max, summed over cameras != own camera
        total = torch.zeros((Sc, Mc), dtype=f32, device=dev)
        zero = torch.zeros((), dtype=f32, device=dev)
        for n in range(N):
            in_cam = (camc == n)[:, None, :]
            cmax = torch.where(in_cam, c, zero).amax(dim=2)
            total = total + torch.where(camc == n, zero, cmax)
        conf[r0:r1, :Mc] = torch.where(validc, total, zero)
    return conf


def kernel_params(sigma_p, sigma_a, spatial_k, support_threshold=0.5):
    """The kernel's four float32 scalars (1/2sp^2, 1/2sa^2, spatial_k,
    support_threshold), rounded as float32 arithmetic rounds them."""
    f32 = np.float32
    sp, sa = f32(sigma_p), f32(sigma_a)
    return (f32(1.0) / (f32(2.0) * sp * sp), f32(1.0) / (f32(2.0) * sa * sa),
            f32(spatial_k), f32(support_threshold))


def slot_terms(segs_src, RtKinv_src, cam, depths, valid, tcoords):
    """Per-slot terms the scoring kernel derives while it stages a slot, as
    the Pallas kernel's [S, 16, M] input planes (scoring_pallas.py:60-64,
    prep :390-448), in that kernel's plane order: d1, d2, cam, valid, the
    target line (tlx, tly, tlz) and its inverse norm, the target endpoints
    (q1x, q1y, q2x, q2y), the unit hypothesis direction, and a zero
    plane."""
    S, M = cam.shape
    f32 = torch.float32
    p1, p2 = g.seg_endpoints(segs_src)
    ray1 = g.ray_dir(RtKinv_src, p1)
    ray2 = g.ray_dir(RtKinv_src, p2)
    q1x, q1y = tcoords[..., 0], tcoords[..., 1]
    q2x, q2y = tcoords[..., 2], tcoords[..., 3]
    tlx = q1y - q2y
    tly = q2x - q1x
    tlz = q1x * q2y - q1y * q2x
    itden = 1.0 / g.sqrt(tlx * tlx + tly * tly).clamp_min(EPS)
    d1 = depths[..., 0]
    d2 = depths[..., 1]
    dirn = _unit_dirs(d1, d2, ray1, ray2).unbind(-1)
    planes = [d1, d2, cam.to(f32), valid.to(f32), tlx, tly, tlz, itden,
              q1x, q1y, q2x, q2y, dirn[0], dirn[1], dirn[2],
              torch.zeros((S, M), dtype=f32, device=cam.device)]
    return torch.stack(planes, dim=1).contiguous()


def kernel_inputs(segs_src, RtKinv_src, C_src, valid, P_nb, sigma_p,
                  sigma_a, spatial_k, support_threshold=0.5):
    """The per-row tables the scoring kernel derives from the source view
    (scoring_pallas.py:390-448), in plain PyTorch.

    Returns (btab [S, 6N] f32 (P_n[:, :3] @ ray for both endpoint rays,
    layout n*6 + k), atab [3N] f32 (P_n @ [C_src; 1]), params [4] f32
    (kernel_params), need [S] int32 (row_need)).
    """
    S = segs_src.shape[0]
    p1, p2 = g.seg_endpoints(segs_src)
    ray1 = g.ray_dir(RtKinv_src, p1)
    ray2 = g.ray_dir(RtKinv_src, p2)

    # projection of C_src + d*ray into camera n = a_n + d * (P_n[:,:3] ray)
    Pr = P_nb.to(torch.float32)                      # [N, 3, 4]
    N = Pr.shape[0]
    btabs = []
    for ray in (ray1, ray2):
        for r in range(3):
            btabs.append(Pr[None, :, r, 0] * ray[:, None, 0]
                         + Pr[None, :, r, 1] * ray[:, None, 1]
                         + Pr[None, :, r, 2] * ray[:, None, 2])  # [S, N]
    btab = torch.stack(btabs, dim=2).reshape(S, N * 6).contiguous()
    atab = (Pr[:, :, 0] * C_src[0] + Pr[:, :, 1] * C_src[1]
            + Pr[:, :, 2] * C_src[2] + Pr[:, :, 3]).reshape(N * 3) \
        .contiguous()
    params = torch.tensor(kernel_params(sigma_p, sigma_a, spatial_k,
                                        support_threshold),
                          dtype=torch.float32, device=valid.device)
    return btab, atab, params, row_need(valid).contiguous()
