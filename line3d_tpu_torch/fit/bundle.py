"""Joint camera + line bundle adjustment with Schur-complement reduction.

Port of `line3d_tpu/fit/bundle.py` to float32 torch on one device.  The
reference never touches camera poses — its closest analogue is the
per-cluster line fit of processClusteredSegments, line3D.cc:1306-1368.
`fit/refine.py` refines 4-DoF lines with cameras frozen; this module
refines the SAME residuals jointly over

  * per-cluster line parameters (4 tangent DoF, same parameterization as
    refine.py: base-point offsets in the direction's normal plane +
    direction tangent updates), and
  * per-view camera poses (6 DoF: axis-angle rotation increment applied on
    the left of R, translation increment on t; intrinsics K stay fixed —
    they come from the upstream SfM, as in the reference).

Each residual couples exactly ONE line and ONE camera, so the Gauss-Newton
normal system is arrow-shaped: the line-line block is block-diagonal
([C, 4, 4]), and eliminating it via the Schur complement leaves a reduced
camera system S = H_θθ − Σ_c H_θl,c H_ll,c⁻¹ H_lθ,c of size [6V, 6V]
(150 × 150 at 25 views), solved on the device.  The reduction line3d_tpu
sums over its mesh (psum) is a sum over blocks of `refine.block_size(C)`
clusters in block order: across N processes each rank linearises,
eliminates and back-substitutes its own whole blocks, and the block
partials are gathered and added in that same order on every rank
(`multihost.ordered_sum`), so every rank solves the single process's
[6V, 6V] system bit for bit.

Gauge handling: the first camera's 6 DoF are pinned (update masked to
zero) and Levenberg damping on both blocks absorbs the remaining global
scale freedom.  Steps are accepted per iteration only if the global
reprojection rms improves (same accept-gate style as refine.py).

Float32 with exact forward-mode Jacobians (torch.func.jvp); matrix products
stay in full float32 (no TF32), the rule line3d_tpu states as
Precision.HIGHEST (TF32 or bf16 truncation is whole pixels of reprojection
error at K ≈ 1500).
"""
from __future__ import annotations

import numpy as np
import torch

from ..parallel import multihost
from .. import trace
from . import refine
from .refine import residuals_t, huber_weights, orthobasis_t


def _rodrigues(w):
    """[V, 3] axis-angle -> [V, 3, 3] rotations, series-safe at ||w|| -> 0."""
    th2 = (w * w).sum(dim=-1)
    th = torch.sqrt(th2.clamp_min(1e-24))
    small = th2 < 1e-12
    # sin(th)/th and (1-cos(th))/th^2 with series fallbacks
    a = torch.where(small, 1.0 - th2 / 6.0, torch.sin(th) / th)
    b = torch.where(small, 0.5 - th2 / 24.0, (1.0 - torch.cos(th)) / th2)
    wx, wy, wz = w[:, 0], w[:, 1], w[:, 2]
    zero = torch.zeros_like(wx)
    Wx = torch.stack([
        torch.stack([zero, -wz, wy], dim=-1),
        torch.stack([wz, zero, -wx], dim=-1),
        torch.stack([-wy, wx, zero], dim=-1)], dim=-2)     # [V, 3, 3]
    I = torch.eye(3, dtype=w.dtype, device=w.device)[None]
    return I + a[:, None, None] * Wx + b[:, None, None] * (Wx @ Wx)


def _member_residuals(P0, d, K, R0, t0, theta, mc, mv, q1, q2):
    """Perpendicular reprojection residuals of each member with camera
    increments.

    P0, d: [C, 3]; K/R0/t0: [V, 3, 3]/[V, 3, 3]/[V, 3]; theta: [V, 6]
    (axis-angle, translation); mc, mv: [N] each member's cluster and view;
    q1, q2: [N, 2] its endpoints.  Returns ([N, 2] residuals, [N] ok):
    refine.residuals_t of each member's line in its own view, with
    P_v = K_v [exp([ω]×) R0_v | t0_v + τ_v].
    """
    R = _rodrigues(theta[:, :3]) @ R0
    t = t0 + theta[:, 3:]
    P = K @ torch.cat([R, t[..., None]], dim=-1)           # [V, 3, 4]
    ones = torch.ones((mc.shape[0], 1), dtype=torch.bool, device=mc.device)
    r, ok = residuals_t(P0[mc], d[mc], P[mv][:, None], q1[:, None],
                        q2[:, None], ones)
    return r[:, 0], ok[:, 0]


def _seg_sum(x, lengths):
    """[n, k] sums of the consecutive runs of rows of x [N, k] whose
    lengths [n] are given (0 for an empty run): torch.segment_reduce, which
    adds each run's rows in order with no atomics, so the bits depend on
    the inputs and their shapes alone."""
    return torch.segment_reduce(x, "sum", lengths=lengths, axis=0,
                                unsafe=True, initial=0.0)


def _cat(parts, empty):
    """torch.cat of `parts`, or `empty` when this rank owns no block."""
    return torch.cat(parts) if parts else empty


def _plan(counts, mv, V: int, block: int, dev) -> list:
    """Per block of `block` clusters: its clusters and member rows, and
    the runs of its member-residual rows (two per member) by cluster, by
    (cluster, camera) and by camera, with the stable permutations that
    group them.  A member's view is fixed, so these hold for the whole
    solve."""
    def t(x):
        return torch.as_tensor(np.asarray(x, np.int64), device=dev)
    cstart = np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)
    C = len(counts)
    plan = []
    for c0 in range(0, C, block):
        c1 = min(c0 + block, C)
        m0, m1 = int(cstart[c0]), int(cstart[c1])
        rows_v = np.repeat(mv[m0:m1], 2)
        rows_c = np.repeat(np.arange(c1 - c0), 2 * counts[c0:c1])
        key = rows_c * V + rows_v
        perm_cv = np.argsort(key, kind="stable")
        keys, lens_cv = np.unique(key[perm_cv], return_counts=True)
        plan.append(dict(
            c=slice(c0, c1), m=slice(m0, m1), vix=t(rows_v),
            mc=t(np.repeat(np.arange(c1 - c0), counts[c0:c1])),
            lens_c=t(2 * counts[c0:c1]), perm_cv=t(perm_cv),
            lens_cv=t(lens_cv), key_c=t(keys // V), key_v=t(keys % V),
            perm_v=t(np.argsort(rows_v, kind="stable")),
            lens_v=t(np.bincount(rows_v, minlength=V))))
    return plan


def _bundle(P0, d, K, R0, t0, mc, mv, q1, q2, counts, n_res: float,
            block: int, iterations: int, huber_delta: float,
            damping: float):
    """The joint Gauss-Newton solve of line3d_tpu's _bundle_jit, on this
    rank's clusters: P0, d [C, 3] hold its whole blocks of `block`
    clusters (all clusters in one process), mc, mv, q1, q2 their members,
    one row each, grouped by cluster (`counts` [C] members a cluster, a
    host array); n_res is the member residual count of all clusters.
    Each block is linearised, its line blocks eliminated and
    back-substituted here; the block partials of the reduced camera system
    are summed over all ranks in global block order
    (`multihost.ordered_sum`, the single process's loop), and the
    residuals behind the rms are gathered and summed on every rank as one
    process sums them, so every rank solves the same [6V, 6V] system and
    takes the same accept decisions.

    Each residual couples one line and one camera, so the camera-camera
    block of the normal equations is block-diagonal ([V, 6, 6]) and a
    cluster's line-camera block [4, 6V] has columns only at its members'
    cameras: both are sums of member rows by camera (by cluster and camera
    for the line-camera block), formed here as segmented sums of the rows
    in a fixed order, and the members are held unpadded.  line3d_tpu pads
    every cluster to the largest member count M and forms those sums with
    a one-hot-placed Jacobian [256, 2M, 6V] per sub-block of 256 clusters
    contracted densely (the TPU's matrix unit): O(M·V²) operations a
    cluster, with M ~ 10·V on a dense arc of views."""
    C = P0.shape[0]
    V = K.shape[0]
    Q = 6 * V
    f32, dev = P0.dtype, P0.device
    plan = _plan(counts, trace.readback(mv, "bundle.plan"), V, block, dev)
    n_res = torch.tensor(n_res, dtype=f32, device=dev)
    eyeQ = torch.eye(Q, dtype=f32, device=dev)
    # the first camera's 6 DoF are pinned (gauge); rows/cols of the pinned
    # coordinates are identity in S and zero in g
    pin = torch.zeros(Q, dtype=torch.bool, device=dev)
    pin[:6] = True
    zt = torch.zeros((V, 6), dtype=f32, device=dev)
    eye4, eye6 = torch.eye(4, dtype=f32, device=dev), \
        torch.eye(6, dtype=f32, device=dev)
    diag = torch.arange(V, device=dev)

    def rms_at(P0_, d_, R_, t_):
        r = _member_residuals(P0_, d_, K, R_, t_, zt, mc, mv, q1, q2)[0]
        r = multihost.allgather_tensor(r)
        return torch.sqrt((r ** 2).sum() / n_res)

    def linearize(P0c, dc, R_cur, t_cur, b):
        """Block b at the current linearization point: its line-block
        terms for the back-substitution and its partial of the reduced
        camera system (the fill S_fill = Σ Zᵀ Hinv Z, the camera blocks
        with g_t beside each, g_corr = Σ Zᵀ Hinv g_l)."""
        sl, m, mcb = b["c"], b["m"], b["mc"]
        P0b, db = P0c[sl], dc[sl]
        mvb, q1b, q2b = mv[m], q1[m], q2[m]
        Cb = P0b.shape[0]
        u1, u2 = orthobasis_t(db)
        zx = torch.zeros((Cb, 4), dtype=f32, device=dev)

        def res_at(xi, th):
            P0p = P0b + xi[:, 0:1] * u1 + xi[:, 1:2] * u2
            dp = db + xi[:, 2:3] * u1 + xi[:, 3:4] * u2
            dp = dp / torch.linalg.norm(dp, dim=1, keepdim=True)
            return _member_residuals(P0p, dp, K, R_cur, t_cur, th, mcb,
                                     mvb, q1b, q2b)[0]

        r0, ok = _member_residuals(P0b, db, K, R_cur, t_cur, zt, mcb, mvb,
                                   q1b, q2b)
        # exact forward-mode Jacobians: one jvp pass, vmapped over the 4
        # line-tangent and 6 camera-tangent directions.  The camera tangent
        # sets coordinate k of EVERY view at once — each residual touches
        # exactly one camera, so the pass yields ∂r/∂θ_{v(m),k} for all
        # members together.
        tx = torch.cat([eye4[:, None, :].expand(4, Cb, 4),
                        zx.expand(6, Cb, 4)])
        tt = torch.cat([zt.expand(4, V, 6), eye6[:, None, :].expand(6, V, 6)])
        J = torch.func.vmap(
            lambda a, b_: torch.func.jvp(res_at, (zx, zt), (a, b_))[1])(
            tx, tt)                                         # [10, Nb, 2]
        w = huber_weights(r0, ok, huber_delta)
        # member-residual rows: i = (member, endpoint)
        A = (J[:4].movedim(0, -1) * w[..., None]).reshape(-1, 4)
        B = (J[4:].movedim(0, -1) * w[..., None]).reshape(-1, 6)
        rf = (r0 * w).reshape(-1)

        H_ll = _seg_sum((A[:, :, None] * A[:, None, :]).reshape(-1, 16),
                        b["lens_c"]).reshape(Cb, 4, 4)
        tr_l = H_ll.diagonal(dim1=1, dim2=2).sum(dim=1)
        H_ll = H_ll + damping * eye4[None] * tr_l.clamp_min(1.0)[:, None, None]
        Hinv = torch.linalg.inv_ex(H_ll)[0]                # [Cb, 4, 4]
        g_l = _seg_sum(A * rf[:, None], b["lens_c"])       # [Cb, 4]

        # each cluster's line-camera block Z [Cb, 4, 6V], its rows summed
        # by camera; the camera blocks and g_t, all rows by camera
        ZZ = _seg_sum((A[:, :, None] * B[:, None, :]).reshape(-1, 24)
                      [b["perm_cv"]], b["lens_cv"])
        Z = torch.zeros((Cb, V, 4, 6), dtype=f32, device=dev)
        Z[b["key_c"], b["key_v"]] = ZZ.reshape(-1, 4, 6)
        Z = Z.permute(0, 2, 1, 3).reshape(Cb, 4, Q)
        cam = _seg_sum(torch.cat([(B[:, :, None] * B[:, None, :])
                                  .reshape(-1, 36), B * rf[:, None]],
                                 dim=1)[b["perm_v"]], b["lens_v"])
        HZ = torch.einsum("cab,cbq->caq", Hinv, Z)
        part = torch.cat([
            (Z.reshape(-1, Q).T @ HZ.reshape(-1, Q)).reshape(-1),
            cam.reshape(-1),
            torch.einsum("caq,ca->q", Z,
                         torch.einsum("cab,cb->ca", Hinv, g_l))])
        return (u1, u2, A, B, Hinv, g_l), part

    def one_iteration(P0c, dc, R_cur, t_cur, rms_cur):
        """One damped GN step at the current linearization point; theta
        re-linearizes at zero each iteration and the accepted increments
        are folded into (R_cur, t_cur).  rms_cur is the incumbent state's
        rms, carried through the loop for the accept gate."""
        lin, parts = [], []
        for b in plan:
            terms, part = linearize(P0c, dc, R_cur, t_cur, b)
            lin.append(terms)
            parts.append(part)
        QQ = Q * Q
        tot = multihost.ordered_sum(
            _cat([x[None] for x in parts],
                 torch.zeros((0, QQ + 42 * V + Q), dtype=f32, device=dev)))
        cam = tot[QQ:QQ + 42 * V].reshape(V, 42)
        # S = Htt - S_fill, Htt the camera blocks on the diagonal
        S_part = (-tot[:QQ]).reshape(V, 6, V, 6)
        S_part[diag, :, diag, :] = S_part[diag, :, diag, :] + \
            cam[:, :36].reshape(V, 6, 6)
        S_part = S_part.reshape(Q, Q)
        g_part = cam[:, 36:].reshape(Q) - tot[QQ + 42 * V:]

        trS = S_part.diagonal().sum()
        S = S_part + damping * trS.clamp_min(1.0) * eyeQ
        # pin the gauge camera: identity rows/cols, zero gradient
        S = torch.where(pin[:, None] | pin[None, :], eyeQ, S)
        g = torch.where(pin, torch.zeros_like(g_part), g_part)

        dtheta = torch.linalg.solve_ex(S, -g[:, None])[0][:, 0]   # [Q]
        dtheta = torch.where(torch.isfinite(dtheta), dtheta,
                             torch.zeros_like(dtheta))

        # back-substitute the line steps: δx_c = -Hinv (g_l + Z δθ), with
        # Z δθ = Aᵀ (B δθ_v) summed over the cluster's rows
        dth_v = dtheta.reshape(V, 6)
        P0n, dn = [], []
        for b, (u1, u2, A, B, Hinv, g_l) in zip(plan, lin):
            Bdth = (B * dth_v[b["vix"]]).sum(dim=-1)            # [2Nb]
            Zdth = _seg_sum(A * Bdth[:, None], b["lens_c"])
            dx = -torch.einsum("cab,cb->ca", Hinv, g_l + Zdth)
            dx = torch.where(torch.isfinite(dx), dx, torch.zeros_like(dx))
            sl = b["c"]
            P0n.append(P0c[sl] + dx[:, 0:1] * u1 + dx[:, 1:2] * u2)
            dnb = dc[sl] + dx[:, 2:3] * u1 + dx[:, 3:4] * u2
            dn.append(dnb / torch.linalg.norm(dnb, dim=1, keepdim=True))
        P0n, dn = _cat(P0n, P0c), _cat(dn, dc)
        Rn = _rodrigues(dth_v[:, :3]) @ R_cur
        tn = t_cur + dth_v[:, 3:]

        # global accept gate: the coupled step stands or falls as a whole
        rms_new = rms_at(P0n, dn, Rn, tn)
        better = rms_new < rms_cur
        return tuple(torch.where(better, n, c) for n, c in
                     ((P0n, P0c), (dn, dc), (Rn, R_cur), (tn, t_cur),
                      (rms_new, rms_cur)))

    rms_before = rms_at(P0, d, R0, t0)
    state = (P0, d, R0, t0, rms_before)
    for _ in range(iterations):
        state = one_iteration(*state)
    P0f, df, Rf, tf, rms_after = state
    return P0f, df, Rf, tf, rms_before, rms_after


def bundle_adjust(P0, d, K, R, t, vidx, p1, p2, mask, iterations: int = 5,
                  huber_delta: float = 2.0, damping: float = 1e-4,
                  *, device):
    """Jointly refine [C] lines and [V] camera poses (see module docs), in
    float32 on `device`.

    Args:
      P0, d: [C, 3] initial lines (conditioned space, any float dtype).
      K, R, t: [V, 3, 3] / [V, 3, 3] / [V, 3] conditioned cameras.
      vidx: [C, M] int member view ids (-1 padding); p1/p2: [C, M, 2]
        member 2D endpoints; mask: [C, M] member validity.

    Returns (P0', d', R', t', rms_before, rms_after) as float64 numpy and
    floats — rms are scalars over all member residuals.  Across N
    processes each rank moves only its own blocks of clusters
    (`refine.block_size`, `multihost.local_block_range`) to the device;
    the refined lines of all ranks are gathered, the poses and rms are the
    same on every rank.
    """
    dev = torch.device(device)
    d_unit = np.asarray(d, np.float64)
    d_unit = d_unit / np.linalg.norm(d_unit, axis=1, keepdims=True)
    blk = refine.block_size(len(d_unit))
    lo, hi = multihost.local_block_range(len(d_unit), blk)

    def f(x, sl=slice(None)):
        return torch.as_tensor(np.asarray(x, np.float32)[sl], device=dev)
    mine = slice(lo, hi)
    # this rank's members, one row each, grouped by cluster in order
    mask = np.asarray(mask, bool)
    mc, mm = np.nonzero(mask[mine])
    out = _bundle(f(P0, mine), f(d_unit, mine), f(K), f(R), f(t),
                  torch.as_tensor(mc, device=dev),
                  torch.as_tensor(np.asarray(vidx, np.int64)[mine][mc, mm],
                                  device=dev),
                  f(np.asarray(p1)[mine][mc, mm]),
                  f(np.asarray(p2)[mine][mc, mm]),
                  mask[mine].sum(axis=1),
                  n_res=float(max(2 * int(mask.sum()), 1)),
                  block=blk,
                  iterations=int(iterations), huber_delta=float(huber_delta),
                  damping=float(damping))
    P0f, df, Rf, tf, rms_b, rms_a = out
    lines = multihost.allgather_tensor(torch.cat([P0f, df], dim=1))
    lines = trace.readback(lines, "bundle.lines").astype(np.float64)
    Rf, tf, rms_b, rms_a = (
        trace.readback(x, "bundle.poses").astype(np.float64)
        for x in (Rf, tf, rms_b, rms_a))
    return lines[:, 0:3], lines[:, 3:6], Rf, tf, float(rms_b), float(rms_a)


def build_bundle_member_data(member_views, member_segs, scene_segments):
    """Pad per-cluster member lists into the bundle_adjust inputs.

    Returns (vidx [C, M] int32 (-1 pads), p1 [C, M, 2], p2 [C, M, 2],
    mask [C, M])."""
    C = len(member_views)
    M = max((len(v) for v in member_views), default=1)
    vidx = np.full((C, M), -1, np.int32)
    p1 = np.zeros((C, M, 2))
    p2 = np.zeros((C, M, 2))
    mask = np.zeros((C, M), bool)
    for c, (vs, ss) in enumerate(zip(member_views, member_segs)):
        k = len(vs)
        vidx[c, :k] = vs
        coords = scene_segments[vs, ss]
        p1[c, :k] = coords[:, 0:2]
        p2[c, :k] = coords[:, 2:4]
        mask[c, :k] = True
    return vidx, p1, p2, mask
