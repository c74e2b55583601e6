"""Pairwise line-segment matching between a source view and its neighbors.

Torch port of `line3d_tpu/match/pairwise.py`, the equivalent of
K_pairwise_matches (reference: cudawrapper.cu:538-611) and its host driver
loop (cudawrapper.cu:897-944).  The [N, S_src, S_tgt] valid planes come
from kernel K1 (`pairwise_cuda.pair_valid`); the tables are compacted
key-only per 128-target block, merged across neighbors in (neighbor,
target) order, and the depths are recomputed at the compacted shape.

Semantics per (src segment p, tgt segment q):
  1. epipolar lines of p's endpoints in the target view (l = F p) and of q's
     endpoints in the source view (l = F^T q),
  2. intersect with the opposite segment's supporting line,
  3. 2D overlap gate: min(overlap) > 0.10 and max(overlap) > 0.30
     (cudawrapper.h:45-46),
  4. two-ray triangulation of all four endpoint correspondences; a match is
     kept iff all four depths are positive (cudawrapper.cu:931).

`torch.sort` replaces `lax.sort`: every sort here runs on int32 keys that
are unique within their row, so any sort yields the reference's order.

All arithmetic is float32, as in the reference.  Ray normalizations use
1 / geometry.sqrt, both steps correctly rounded on the CPU and on the card
alike (torch.sqrt and torch.rsqrt are approximations on CUDA), and eager
PyTorch contracts no multiply-add, so the depth recompute gives the same
bits on both devices.  They are not the reference's bits on XLA:CPU, which
contracts a*b + c into fused multiply-adds and approximates rsqrt to about
1 ulp.
"""
from __future__ import annotations

import torch

from ..core.geometry import sqrt

EPS = 1e-12

# epipolar-overlap gate defaults (cudawrapper.cu:512-520: at least 10% on
# both segments, 30% on one)
MIN_OVERLAP_LOWER = 0.10
MIN_OVERLAP_UPPER = 0.30


def _overlap_soa(ax, ay, bx, by, cx, cy, dx, dy):
    """segment_overlap_2d on component planes: overlap of segment (c,d) with
    segment (a,b), all collinear.  Every operand broadcasts to [Ss, St]."""
    len_ab = sqrt((ax - bx) ** 2 + (ay - by) ** 2)
    len_cd = sqrt((cx - dx) ** 2 + (cy - dy) ** 2)
    zero = torch.zeros((), dtype=len_ab.dtype, device=len_ab.device)

    def on(px, py, qx, qy, rx, ry):
        return (px - rx) * (qx - rx) + (py - ry) * (qy - ry) < EPS

    c_in = on(ax, ay, bx, by, cx, cy)
    d_in = on(ax, ay, bx, by, dx, dy)
    a_in = on(cx, cy, dx, dy, ax, ay)
    b_in = on(cx, cy, dx, dy, bx, by)

    def dist(ux, uy, vx, vy):
        return sqrt((ux - vx) ** 2 + (uy - vy) ** 2)

    def safe(x):
        return x.clamp_min(EPS)

    c1 = len_cd / safe(len_ab)
    c2 = len_ab / safe(len_cd)
    l31 = dist(bx, by, dx, dy)
    l32 = dist(ax, ay, dx, dy)
    c3 = torch.where(a_in & (l31 > EPS), dist(cx, cy, ax, ay) / safe(l31),
                     torch.where(l32 > EPS, dist(cx, cy, bx, by) / safe(l32),
                                 zero))
    l41 = dist(ax, ay, cx, cy)
    l42 = dist(bx, by, cx, cy)
    c4 = torch.where(b_in & (l41 > EPS), dist(dx, dy, bx, by) / safe(l41),
                     torch.where(l42 > EPS, dist(dx, dy, ax, ay) / safe(l42),
                                 zero))

    ov = torch.where(c_in & d_in, c1,
                     torch.where(a_in & b_in, c2,
                                 torch.where(c_in, c3,
                                             torch.where(d_in, c4, zero))))
    return torch.where((len_ab < 1.0) | (len_cd < 1.0), zero, ov)


def _fline(M, x, y):
    """M @ (x, y, 1) as three component planes."""
    return (M[0, 0] * x + M[0, 1] * y + M[0, 2],
            M[1, 0] * x + M[1, 1] * y + M[1, 2],
            M[2, 0] * x + M[2, 1] * y + M[2, 2])


def _ray_fixed(M, x, y):
    """Normalized viewing ray M @ (x, y, 1), component planes."""
    rx, ry, rz = _fline(M, x, y)
    inv = 1.0 / sqrt((rx * rx + ry * ry + rz * rz).clamp_min(EPS))
    return rx * inv, ry * inv, rz * inv


def _tri(r1, r2, w0):
    """Two-ray depths (cudawrapper.cu:306-335); rays normalized."""
    a = r1[0] * r1[0] + r1[1] * r1[1] + r1[2] * r1[2]
    b = r1[0] * r2[0] + r1[1] * r2[1] + r1[2] * r2[2]
    c = r2[0] * r2[0] + r2[1] * r2[1] + r2[2] * r2[2]
    d = r1[0] * w0[0] + r1[1] * w0[1] + r1[2] * w0[2]
    e = r2[0] * w0[0] + r2[1] * w0[1] + r2[2] * w0[2]
    denom = a * c - b * b
    ok = denom.abs() > EPS
    zs = torch.where(ok, denom, torch.ones_like(denom))
    minus1 = torch.full_like(denom, -1.0)
    d1 = torch.where(ok, (b * e - c * d) / zs, minus1)
    d2 = torch.where(ok, (a * e - b * d) / zs, minus1)
    return d1, d2, ok


def _intersect(la, lb, lc, ma, mb, mc):
    """cross(line l, line m) -> homogeneous point, normalized to z=1."""
    ix = lb * mc - lc * mb
    iy = lc * ma - la * mc
    iz = la * mb - lb * ma
    ok = iz.abs() > EPS
    zs = torch.where(ok, iz, torch.ones_like(iz))
    zero = torch.zeros_like(iz)
    return torch.where(ok, ix / zs, zero), torch.where(ok, iy / zs, zero), ok


def match_pair_dense(segs_src, segs_tgt, mask_src, mask_tgt,
                     F, RtKinv_src, RtKinv_tgt, C_src, C_tgt,
                     min_overlap_lower=MIN_OVERLAP_LOWER,
                     min_overlap_upper=MIN_OVERLAP_UPPER):
    """Dense pair matching for one (src, tgt) view pair, component planes.

    Args:
      segs_src: [Ss, 4], segs_tgt: [St, 4] float32 segment endpoints.
      mask_src: [Ss], mask_tgt: [St] bool validity.
      F: [3, 3] fundamental (src -> tgt epipolar lines).
      RtKinv_src / RtKinv_tgt: [3, 3]; C_src / C_tgt: [3].

    Returns:
      depths: tuple of 4 planes [Ss, St] float32
              (d_src_p1, d_src_p2, d_tgt_q1, d_tgt_q2)
      valid:  [Ss, St] bool (the plain twin of kernel K1)
    """
    p1x = segs_src[:, 0:1]; p1y = segs_src[:, 1:2]
    p2x = segs_src[:, 2:3]; p2y = segs_src[:, 3:4]
    q1x = segs_tgt[None, :, 0]; q1y = segs_tgt[None, :, 1]
    q2x = segs_tgt[None, :, 2]; q2y = segs_tgt[None, :, 3]

    # 2D supporting lines: cross((x1,y1,1),(x2,y2,1))
    l1a = p1y - p2y; l1b = p2x - p1x; l1c = p1x * p2y - p1y * p2x  # [Ss,1]
    l2a = q1y - q2y; l2b = q2x - q1x; l2c = q1x * q2y - q1y * q2x  # [1,St]

    e1a, e1b, e1c = _fline(F, p1x, p1y)       # epi of p1 in tgt view
    e2a, e2b, e2c = _fline(F, p2x, p2y)
    Ft = F.T
    f1a, f1b, f1c = _fline(Ft, q1x, q1y)      # epi of q1 in src view
    f2a, f2b, f2c = _fline(Ft, q2x, q2y)

    # epipolar transfer points (cudawrapper.cu:570-573): [Ss, St] planes
    a1x, a1y, ok1 = _intersect(l2a, l2b, l2c, e1a, e1b, e1c)
    a2x, a2y, ok2 = _intersect(l2a, l2b, l2c, e2a, e2b, e2c)
    b1x, b1y, ok3 = _intersect(l1a, l1b, l1c, f1a, f1b, f1c)
    b2x, b2y, ok4 = _intersect(l1a, l1b, l1c, f2a, f2b, f2c)
    inter_ok = ok1 & ok2 & ok3 & ok4

    # overlap gate (cudawrapper.cu:584-588)
    ov1 = _overlap_soa(p1x, p1y, p2x, p2y, b1x, b1y, b2x, b2y)
    ov2 = _overlap_soa(q1x, q1y, q2x, q2y, a1x, a1y, a2x, a2y)
    ov_ok = (torch.minimum(ov1, ov2) > min_overlap_lower) & \
            (torch.maximum(ov1, ov2) > min_overlap_upper)

    w0 = (C_src[0] - C_tgt[0], C_src[1] - C_tgt[1], C_src[2] - C_tgt[2])
    ray_p1 = _ray_fixed(RtKinv_src, p1x, p1y)
    ray_p2 = _ray_fixed(RtKinv_src, p2x, p2y)
    ray_q1 = _ray_fixed(RtKinv_tgt, q1x, q1y)
    ray_q2 = _ray_fixed(RtKinv_tgt, q2x, q2y)
    ray_a1 = _ray_fixed(RtKinv_tgt, a1x, a1y)
    ray_a2 = _ray_fixed(RtKinv_tgt, a2x, a2y)
    ray_b1 = _ray_fixed(RtKinv_src, b1x, b1y)
    ray_b2 = _ray_fixed(RtKinv_src, b2x, b2y)

    d_p1, _, t1 = _tri(ray_p1, ray_a1, w0)
    d_p2, _, t2 = _tri(ray_p2, ray_a2, w0)
    _, d_q1, t3 = _tri(ray_b1, ray_q1, w0)
    _, d_q2, t4 = _tri(ray_b2, ray_q2, w0)

    pos = (d_p1 > 0.0) & (d_p2 > 0.0) & (d_q1 > 0.0) & (d_q2 > 0.0)
    valid = (inter_ok & ov_ok & pos & t1 & t2 & t3 & t4 &
             mask_src[:, None] & mask_tgt[None, :])
    return (d_p1, d_p2, d_q1, d_q2), valid


def block_size(n: int) -> int:
    """The compaction's target block: 128, halved until it divides n."""
    blk = 128
    while n % blk:
        blk //= 2
    return blk


def compact_rows_blockq(valid, quota: int, min_capacity: int = 0):
    """Key-only per-128-block compaction (ascending target index).

    Keeps at most `quota` matches per contiguous 128-target block (fewer
    for tiny shapes whose segment axis is not a multiple of 128), raised to
    cover `min_capacity` slots per row and capped at the block width, where
    the compaction drops nothing.

    Returns (tgt_idx [Ss, (St/blk)*quota] int32 (-1 pads),
             kept [Ss, (St/blk)*quota] bool, n_valid [Ss] int32).
    """
    Ss, St = valid.shape
    blk = block_size(St)
    B = St // blk
    quota = max(quota, -(-min_capacity // B))
    quota = min(quota, blk)
    dev = valid.device
    j = torch.arange(blk, dtype=torch.int32, device=dev).expand(Ss * B, blk)
    key = torch.where(valid.reshape(Ss * B, blk), j, blk + j)
    skey = torch.sort(key, dim=1).values[:, :quota].reshape(Ss, B, quota)
    kept = skey < blk
    base = torch.arange(B, dtype=torch.int32, device=dev)[None, :, None] * blk
    tgt_idx = torch.where(kept, base + skey,
                          torch.full_like(skey, -1)).reshape(Ss, B * quota)
    n_valid = valid.sum(dim=1, dtype=torch.int32)
    return tgt_idx, kept.reshape(Ss, B * quota), n_valid


def merge_neighbor_tables(res: dict, m_total: int, num_targets: int):
    """Merge per-neighbor compacted index tables [N, S, K1] into one
    per-source table [S, M] ordered by (neighbor, target) ascending — the
    reference's sortMatchingPairs order (sparsematrix.h:68-79).  Each kept
    slot is the key cam*St + tgt; one sort merges all neighbors.

    Returns (cam [S, M] int32, tgt [S, M] int32, valid [S, M] bool).
    """
    N, S, K1 = res["tgt_idx"].shape
    K = N * K1
    St = num_targets
    dev = res["tgt_idx"].device
    cam_full = torch.arange(N, dtype=torch.int32, device=dev)[:, None, None] \
        .expand(N, S, K1).permute(1, 0, 2).reshape(S, K)
    tgt_full = res["tgt_idx"].permute(1, 0, 2).reshape(S, K)
    valid_full = res["valid"].permute(1, 0, 2).reshape(S, K)

    m_total = min(m_total, K)
    big = N * St
    pos = torch.arange(K, dtype=torch.int32, device=dev).expand(S, K)
    key = torch.where(valid_full, cam_full * St + tgt_full, big + pos)
    skey = torch.sort(key, dim=1).values[:, :m_total]
    valid = skey < big
    minus1 = torch.full_like(skey, -1)
    cam = torch.where(valid, torch.div(skey, St, rounding_mode="floor"),
                      minus1)
    tgt = torch.where(valid, torch.remainder(skey, St), minus1)
    return cam, tgt, valid


def gather_target_coords(segs_nb, cam, tgt):
    """[S, M, 4] target-segment coordinates per match slot (one flat row
    gather, shared by the depth recompute and the scoring prep)."""
    N, St, _ = segs_nb.shape
    S, M = cam.shape
    flat = cam.clamp_min(0).long() * St + tgt.clamp_min(0).long()
    return segs_nb.reshape(N * St, 4)[flat.reshape(-1)].reshape(S, M, 4)


def depths_for_matches(segs_src, segs_nb, cam, tgt, valid,
                       F_nb, RtKinv_src, RtKinv_nb, C_src, C_nb,
                       tcoords=None):
    """Recompute the 4 triangulated depths for a merged match table.

    Same math as match_pair_dense (two-ray triangulation of the epipolar
    transfer points, cudawrapper.cu:306-335, 594-601), evaluated only at
    the kept [S, M] pairs, in float32.  Per-match camera constants are
    gathered by the slot's neighbor index (exact).

    Returns depths [S, M, 4] float32 (0 in invalid slots).
    """
    S, M = cam.shape
    cam_s = cam.clamp_min(0).long()
    if tcoords is None:
        tcoords = gather_target_coords(segs_nb, cam, tgt)
    Fp = F_nb.reshape(-1, 9)[cam_s]                  # [S, M, 9]
    Mp = RtKinv_nb.reshape(-1, 9)[cam_s]
    Ct = C_nb[cam_s]                                 # [S, M, 3]

    def Fc(r, c):
        return Fp[..., 3 * r + c]

    def Mc(r, c):
        return Mp[..., 3 * r + c]

    p1x = segs_src[:, 0:1]; p1y = segs_src[:, 1:2]
    p2x = segs_src[:, 2:3]; p2y = segs_src[:, 3:4]
    q1x = tcoords[..., 0]; q1y = tcoords[..., 1]
    q2x = tcoords[..., 2]; q2y = tcoords[..., 3]

    l1a = p1y - p2y; l1b = p2x - p1x; l1c = p1x * p2y - p1y * p2x  # [S,1]
    l2a = q1y - q2y; l2b = q2x - q1x; l2c = q1x * q2y - q1y * q2x  # [S,M]

    e1a = Fc(0, 0) * p1x + Fc(0, 1) * p1y + Fc(0, 2)
    e1b = Fc(1, 0) * p1x + Fc(1, 1) * p1y + Fc(1, 2)
    e1c = Fc(2, 0) * p1x + Fc(2, 1) * p1y + Fc(2, 2)
    e2a = Fc(0, 0) * p2x + Fc(0, 1) * p2y + Fc(0, 2)
    e2b = Fc(1, 0) * p2x + Fc(1, 1) * p2y + Fc(1, 2)
    e2c = Fc(2, 0) * p2x + Fc(2, 1) * p2y + Fc(2, 2)
    f1a = Fc(0, 0) * q1x + Fc(1, 0) * q1y + Fc(2, 0)
    f1b = Fc(0, 1) * q1x + Fc(1, 1) * q1y + Fc(2, 1)
    f1c = Fc(0, 2) * q1x + Fc(1, 2) * q1y + Fc(2, 2)
    f2a = Fc(0, 0) * q2x + Fc(1, 0) * q2y + Fc(2, 0)
    f2b = Fc(0, 1) * q2x + Fc(1, 1) * q2y + Fc(2, 1)
    f2c = Fc(0, 2) * q2x + Fc(1, 2) * q2y + Fc(2, 2)

    a1x, a1y, _ = _intersect(l2a, l2b, l2c, e1a, e1b, e1c)
    a2x, a2y, _ = _intersect(l2a, l2b, l2c, e2a, e2b, e2c)
    b1x, b1y, _ = _intersect(l1a, l1b, l1c, f1a, f1b, f1c)
    b2x, b2y, _ = _intersect(l1a, l1b, l1c, f2a, f2b, f2c)

    def ray_pm(x, y):
        rx = Mc(0, 0) * x + Mc(0, 1) * y + Mc(0, 2)
        ry = Mc(1, 0) * x + Mc(1, 1) * y + Mc(1, 2)
        rz = Mc(2, 0) * x + Mc(2, 1) * y + Mc(2, 2)
        inv = 1.0 / sqrt((rx * rx + ry * ry + rz * rz).clamp_min(EPS))
        return rx * inv, ry * inv, rz * inv

    w0 = tuple(C_src[k] - Ct[..., k] for k in range(3))

    ray_p1 = _ray_fixed(RtKinv_src, p1x, p1y)
    ray_p2 = _ray_fixed(RtKinv_src, p2x, p2y)
    ray_q1 = ray_pm(q1x, q1y)
    ray_q2 = ray_pm(q2x, q2y)
    ray_a1 = ray_pm(a1x, a1y)
    ray_a2 = ray_pm(a2x, a2y)
    ray_b1 = _ray_fixed(RtKinv_src, b1x, b1y)
    ray_b2 = _ray_fixed(RtKinv_src, b2x, b2y)

    d_p1 = _tri(ray_p1, ray_a1, w0)[0]
    d_p2 = _tri(ray_p2, ray_a2, w0)[0]
    d_q1 = _tri(ray_b1, ray_q1, w0)[1]
    d_q2 = _tri(ray_b2, ray_q2, w0)[1]

    depths = torch.stack([d.expand(S, M) for d in (d_p1, d_p2, d_q1, d_q2)],
                         dim=-1)
    return torch.where(valid[..., None], depths, torch.zeros_like(depths))


def match_view_against_neighbors(segs_src, mask_src, RtKinv_src, C_src,
                                 segs_nb, mask_nb, F_nb, RtKinv_nb, C_nb,
                                 quota: int,
                                 min_overlap_lower=MIN_OVERLAP_LOWER,
                                 min_overlap_upper=MIN_OVERLAP_UPPER,
                                 min_capacity: int = 0, valid=None):
    """Match one source view against a stack of N neighbor views.

    The [N, Ss, St] valid planes come from kernel K1 in one launch (or are
    passed in as `valid` when the caller already computed them to count the
    capacity); each neighbor's plane is then compacted key-only per 128-
    target block, in a loop over neighbors.

    Args:
      segs_nb: [N, St, 4]; mask_nb: [N, St]; F_nb: [N, 3, 3];
      RtKinv_nb: [N, 3, 3]; C_nb: [N, 3].
      quota: per-(source segment, 128-target-block) match quota.

    Returns dict with
      tgt_idx [N, Ss, K1], valid [N, Ss, K1], n_valid [N, Ss],
      overflow [N] (int32 count of matches dropped by the quota — the
      reference keeps all, cudawrapper.cu:926).
    """
    if valid is None:
        from .pairwise_cuda import pair_valid
        valid = pair_valid(segs_src, mask_src, segs_nb, mask_nb, F_nb,
                           RtKinv_src, RtKinv_nb, C_src, C_nb,
                           min_overlap_lower, min_overlap_upper)
    outs = [compact_rows_blockq(valid[n], quota, min_capacity)
            for n in range(valid.shape[0])]
    tgt_idx = torch.stack([o[0] for o in outs])
    kept = torch.stack([o[1] for o in outs])
    n_valid = torch.stack([o[2] for o in outs])
    overflow = n_valid.sum(dim=1) - kept.sum(dim=(1, 2))
    return dict(tgt_idx=tgt_idx, valid=kept, n_valid=n_valid,
                overflow=overflow.to(torch.int32))
