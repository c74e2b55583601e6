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
(150 × 150 at 25 views), solved on the device.  On one GPU the reduction
line3d_tpu sums over its mesh (psum) is a plain sum over cluster blocks.

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

from .refine import residuals_t, huber_weights, orthobasis_t

# clusters per block of the reduced-camera-system accumulation
_BLOCK = 256


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


def _bundle_residuals(P0, d, K, R0, t0, theta, vidx, p1, p2, mask):
    """Perpendicular reprojection residuals with camera increments.

    P0, d: [C, 3]; K/R0/t0: [V, 3, 3]/[V, 3, 3]/[V, 3];
    theta: [V, 6] (axis-angle, translation); vidx: [C, M] member view ids;
    p1, p2: [C, M, 2]; mask: [C, M].  Returns ([C, M, 2] residuals, ok).
    refine.residuals_t with Pm built from the incremented poses:
    P_v = K_v [exp([ω]×) R0_v | t0_v + τ_v].
    """
    R = _rodrigues(theta[:, :3]) @ R0
    t = t0 + theta[:, 3:]
    P = K @ torch.cat([R, t[..., None]], dim=-1)           # [V, 3, 4]
    return residuals_t(P0, d, P[vidx.clamp_min(0)], p1, p2, mask)


def _bundle(P0, d, K, R0, t0, vidx, p1, p2, mask, iterations: int,
            huber_delta: float, damping: float):
    """The joint Gauss-Newton solve of line3d_tpu's _bundle_jit."""
    C, M = vidx.shape
    V = K.shape[0]
    Q = 6 * V
    f32, dev = P0.dtype, P0.device
    n_res = (mask.sum() * 2).to(f32).clamp_min(1)
    eyeQ = torch.eye(Q, dtype=f32, device=dev)
    # the first camera's 6 DoF are pinned (gauge); rows/cols of the pinned
    # coordinates are identity in S and zero in g
    pin = torch.zeros(Q, dtype=torch.bool, device=dev)
    pin[:6] = True
    zx = torch.zeros((C, 4), dtype=f32, device=dev)
    zt = torch.zeros((V, 6), dtype=f32, device=dev)
    eye4, eye6 = torch.eye(4, dtype=f32, device=dev), \
        torch.eye(6, dtype=f32, device=dev)

    def rms_at(P0_, d_, R_, t_):
        r, _ = _bundle_residuals(P0_, d_, K, R_, t_, zt, vidx, p1, p2, mask)
        return torch.sqrt((r ** 2).sum() / n_res)

    def one_iteration(P0c, dc, R_cur, t_cur, rms_cur):
        """One damped GN step at the current linearization point; theta
        re-linearizes at zero each iteration and the accepted increments
        are folded into (R_cur, t_cur).  rms_cur is the incumbent state's
        rms, carried through the loop for the accept gate."""
        u1, u2 = orthobasis_t(dc)

        def res_at(xi, th):
            P0p = P0c + xi[:, 0:1] * u1 + xi[:, 1:2] * u2
            dp = dc + xi[:, 2:3] * u1 + xi[:, 3:4] * u2
            dp = dp / torch.linalg.norm(dp, dim=1, keepdim=True)
            return _bundle_residuals(P0p, dp, K, R_cur, t_cur, th,
                                     vidx, p1, p2, mask)[0]

        r0, ok = _bundle_residuals(P0c, dc, K, R_cur, t_cur, zt,
                                   vidx, p1, p2, mask)
        # exact forward-mode Jacobians: 4 line-tangent + 6 camera-tangent
        # jvp passes.  The camera tangent sets coordinate k of EVERY view
        # at once — each residual touches exactly one camera, so the pass
        # yields ∂r/∂θ_{v(m),k} for all members together.
        Jx = torch.stack([
            torch.func.jvp(lambda x: res_at(x, zt), (zx,), (zx + eye4[k],))[1]
            for k in range(4)], dim=-1)                 # [C, M, 2, 4]
        Jt = torch.stack([
            torch.func.jvp(lambda th: res_at(zx, th), (zt,),
                           (zt + eye6[k],))[1]
            for k in range(6)], dim=-1)                 # [C, M, 2, 6]
        w = huber_weights(r0, ok, huber_delta)

        # flatten member-residual rows: i = (m, endpoint)
        A = (Jx * w[..., None]).reshape(C, 2 * M, 4)
        B = (Jt * w[..., None]).reshape(C, 2 * M, 6)
        rf = (r0 * w).reshape(C, 2 * M)
        vix = vidx.clamp_min(0).repeat_interleave(2, dim=1)   # [C, 2M]

        H_ll = torch.einsum("cia,cib->cab", A, A)
        tr_l = H_ll.diagonal(dim1=1, dim2=2).sum(dim=1)
        H_ll = H_ll + damping * eye4[None] * tr_l.clamp_min(1.0)[:, None, None]
        Hinv = torch.linalg.inv_ex(H_ll)[0]                # [C, 4, 4]
        g_l = torch.einsum("cia,ci->ca", A, rf)

        # the reduced camera system, accumulated per block of clusters: the
        # [C, 2M, 6V] placed Jacobian G (G[c, i, :] = B[c, i, :] at the
        # member's own camera's 6 columns, a one-hot outer product) is the
        # only O(C·V) tensor of the solve, so it lives one block at a time
        Htt = torch.zeros((Q, Q), dtype=f32, device=dev)
        S_fill = torch.zeros((Q, Q), dtype=f32, device=dev)
        g_t = torch.zeros(Q, dtype=f32, device=dev)
        g_corr = torch.zeros(Q, dtype=f32, device=dev)
        for c0 in range(0, C, _BLOCK):
            sl = slice(c0, min(c0 + _BLOCK, C))
            onehot = torch.nn.functional.one_hot(vix[sl], V).to(f32)
            G = (onehot[..., None] * B[sl][..., None, :]).reshape(
                -1, 2 * M, Q)
            Zc = torch.einsum("cia,ciq->caq", A[sl], G)
            Htt = Htt + torch.einsum("ciq,cir->qr", G, G)
            S_fill = S_fill + torch.einsum("caq,cab,cbr->qr", Zc, Hinv[sl],
                                           Zc)
            g_t = g_t + torch.einsum("ciq,ci->q", G, rf[sl])
            g_corr = g_corr + torch.einsum("caq,cab,cb->q", Zc, Hinv[sl],
                                           g_l[sl])
        S_part = Htt - S_fill
        g_part = g_t - g_corr

        trS = S_part.diagonal().sum()
        S = S_part + damping * trS.clamp_min(1.0) * eyeQ
        # pin the gauge camera: identity rows/cols, zero gradient
        S = torch.where(pin[:, None] | pin[None, :], eyeQ, S)
        g = torch.where(pin, torch.zeros_like(g_part), g_part)

        dtheta = torch.linalg.solve_ex(S, -g[:, None])[0][:, 0]   # [Q]
        dtheta = torch.where(torch.isfinite(dtheta), dtheta,
                             torch.zeros_like(dtheta))

        # back-substitute the line steps: δx_c = -Hinv (g_l + Z δθ), with
        # Z δθ = Aᵀ (G δθ) and G δθ the member's own camera's increments
        dth_v = dtheta.reshape(V, 6)
        Bdth = (B * dth_v[vix]).sum(dim=-1)                 # [C, 2M]
        Zdth = torch.einsum("cia,ci->ca", A, Bdth)
        dx = -torch.einsum("cab,cb->ca", Hinv, g_l + Zdth)
        dx = torch.where(torch.isfinite(dx), dx, torch.zeros_like(dx))

        P0n = P0c + dx[:, 0:1] * u1 + dx[:, 1:2] * u2
        dn = dc + dx[:, 2:3] * u1 + dx[:, 3:4] * u2
        dn = dn / torch.linalg.norm(dn, dim=1, keepdim=True)
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
                  device="cpu"):
    """Jointly refine [C] lines and [V] camera poses (see module docs), in
    float32 on `device`.

    Args:
      P0, d: [C, 3] initial lines (conditioned space, any float dtype).
      K, R, t: [V, 3, 3] / [V, 3, 3] / [V, 3] conditioned cameras.
      vidx: [C, M] int member view ids (-1 padding); p1/p2: [C, M, 2]
        member 2D endpoints; mask: [C, M] member validity.

    Returns (P0', d', R', t', rms_before, rms_after) as float64 numpy and
    floats — rms are scalars over all member residuals.
    """
    dev = torch.device(device)
    d_unit = np.asarray(d, np.float64)
    d_unit = d_unit / np.linalg.norm(d_unit, axis=1, keepdims=True)

    def f(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=dev)
    out = _bundle(f(P0), f(d_unit), f(K), f(R), f(t),
                  torch.as_tensor(np.asarray(vidx, np.int64), device=dev),
                  f(p1), f(p2),
                  torch.as_tensor(np.asarray(mask, bool), device=dev),
                  iterations=int(iterations), huber_delta=float(huber_delta),
                  damping=float(damping))
    P0f, df, Rf, tf, rms_b, rms_a = (x.cpu().numpy().astype(np.float64)
                                     for x in out)
    return P0f, df, Rf, tf, float(rms_b), float(rms_a)


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
