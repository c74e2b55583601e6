"""Batched 3D line refinement (line-bundle-adjustment).

Port of `line3d_tpu/fit/refine.py`.  An additive capability beyond the
reference: each clustered 3D line is refined by minimizing the reprojection
error of its member 2D segments — the perpendicular distances of the member
segment endpoints to the projected 3D line in their own views — with a
damped Gauss-Newton loop, batched over all clusters at once.

Parameterization (4 DoF per line): base point offsets in the plane normal
to the direction (2) + direction tangent updates (2); the line is
(P0 + a u1 + b u2,  normalize(d + c u1 + e u2)) with (u1, u2) an
orthonormal basis of d's normal plane.

Two equivalent backends (held against line3d_tpu's in
tests/test_torch_refine.py):
  * host: float64 numpy with a numeric Jacobian (`refine_lines`, a copy) —
    the semantic reference; double precision is comfortable for the normal
    equations.
  * device: float32 torch on a device (`refine_lines_device`) with EXACT
    forward-mode Jacobians (torch.func.jvp; finite differences are
    unusable in f32 — (r(x+eps)-r(x))/eps at pixel scale loses ~half the
    mantissa).  Matrix products stay in full float32: TF32 (or bf16)
    truncation costs whole pixels of reprojection error at K ≈ 1500, which
    is why line3d_tpu asks XLA for Precision.HIGHEST here.

The device form runs in blocks of `block_size(C)` clusters.  Across N
processes (`parallel/multihost.py`) each rank solves its own whole blocks
and the results are all-gathered, as line3d_tpu shards the cluster axis
over its mesh with no collective inside the solve.  One process runs the
same blocks, so every cluster's batched products and solves have the same
shapes, and give the same bits, at any process count (a batched library
call may pick its algorithm by the batch size).
"""
from __future__ import annotations

import numpy as np
import torch

from ..parallel import multihost

# clusters per block of the device refinement and of the bundle
# adjustment's line blocks (the unit of work a rank owns) are a multiple of
# BLOCK, at most MAX_BLOCKS blocks: each block is one Gauss-Newton launch
# sequence, whose launch cost on the host, not the card, sets its time
BLOCK = 256
MAX_BLOCKS = 4


def block_size(n: int) -> int:
    """Clusters per block for n clusters: the least multiple of BLOCK that
    cuts them into at most MAX_BLOCKS blocks.  It depends on n alone, never
    on the process count, so every rank runs the single process's
    blocks."""
    return BLOCK * max(1, -(-n // (BLOCK * MAX_BLOCKS)))


def _orthobasis(d: np.ndarray):
    """[C, 3] unit dirs -> two [C, 3] orthonormal normal-plane vectors."""
    ref = np.where(np.abs(d[:, 0:1]) < 0.9,
                   np.tile([1.0, 0, 0], (len(d), 1)),
                   np.tile([0, 1.0, 0], (len(d), 1)))
    u1 = np.cross(d, ref)
    u1 /= np.linalg.norm(u1, axis=1, keepdims=True)
    u2 = np.cross(d, u1)
    return u1, u2


def _residuals(P0, d, Pm, p1, p2, mask):
    """Perpendicular reprojection residuals.

    P0, d: [C, 3]; Pm: [C, M, 3, 4] member projection matrices;
    p1, p2: [C, M, 2] member 2D endpoints; mask: [C, M].
    Returns [C, M, 2] residuals (distance of each endpoint to the projected
    line) with masked entries zeroed, plus a validity mask.
    """
    Xa = np.concatenate([P0, np.ones((len(P0), 1))], axis=1)       # [C, 4]
    Xb = np.concatenate([P0 + d, np.ones((len(P0), 1))], axis=1)
    xa = np.einsum("cmij,cj->cmi", Pm, Xa)                         # [C, M, 3]
    xb = np.einsum("cmij,cj->cmi", Pm, Xb)
    # projected 2D line through the two image points
    l = np.cross(xa, xb)                                           # [C, M, 3]
    den = np.sqrt(l[..., 0] ** 2 + l[..., 1] ** 2)
    ok = (np.abs(xa[..., 2]) > 1e-12) & (np.abs(xb[..., 2]) > 1e-12) & \
         (den > 1e-12) & mask
    den = np.maximum(den, 1e-12)
    r1 = (l[..., 0] * p1[..., 0] + l[..., 1] * p1[..., 1] + l[..., 2]) / den
    r2 = (l[..., 0] * p2[..., 0] + l[..., 1] * p2[..., 1] + l[..., 2]) / den
    r = np.stack([r1, r2], axis=-1)
    return np.where(ok[..., None], r, 0.0), ok


def refine_lines(P0, d, Pm, p1, p2, mask, iterations: int = 5,
                 huber_delta: float = 2.0, damping: float = 1e-6):
    """Refine [C] lines given padded member data.  Returns (P0', d', rms
    before, rms after)."""
    P0 = np.asarray(P0, np.float64).copy()
    d = np.asarray(d, np.float64).copy()
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    C = len(P0)
    n_res = np.maximum(mask.sum(axis=1) * 2, 1)

    def rms(P0_, d_):
        r, ok = _residuals(P0_, d_, Pm, p1, p2, mask)
        return np.sqrt((r ** 2).sum(axis=(1, 2)) / n_res)

    rms_before = rms(P0, d)

    eps = 1e-6
    for _ in range(iterations):
        u1, u2 = _orthobasis(d)
        r0, ok = _residuals(P0, d, Pm, p1, p2, mask)

        # numeric Jacobian over the 4 tangent parameters
        J = np.zeros(r0.shape + (4,))
        deltas = [(u1, None), (u2, None), (None, u1), (None, u2)]
        for k, (dp, dd) in enumerate(deltas):
            P0p = P0 + eps * dp if dp is not None else P0
            dpn = d + eps * dd if dd is not None else d
            if dd is not None:
                dpn = dpn / np.linalg.norm(dpn, axis=1, keepdims=True)
            rp, _ = _residuals(P0p, dpn, Pm, p1, p2, mask)
            J[..., k] = (rp - r0) / eps

        # Huber weights
        absr = np.abs(r0)
        w = np.where(absr <= huber_delta, 1.0,
                     np.sqrt(huber_delta / np.maximum(absr, 1e-12)))
        w = np.where(ok[..., None], w, 0.0)

        Jw = J * w[..., None]
        rw = r0 * w
        # normal equations per cluster: [C, 4, 4] and [C, 4]
        Jf = Jw.reshape(C, -1, 4)
        rf = rw.reshape(C, -1)
        H = np.einsum("cik,cil->ckl", Jf, Jf)
        g = np.einsum("cik,ci->ck", Jf, rf)
        H += damping * np.eye(4)[None] * \
            np.maximum(np.trace(H, axis1=1, axis2=2), 1.0)[:, None, None]
        try:
            step = np.linalg.solve(H, -g[..., None])[..., 0]
        except np.linalg.LinAlgError:
            break

        P0_new = P0 + step[:, 0:1] * u1 + step[:, 1:2] * u2
        d_new = d + step[:, 2:3] * u1 + step[:, 3:4] * u2
        d_new /= np.linalg.norm(d_new, axis=1, keepdims=True)

        # accept per cluster only if rms improves (r0 was computed at the
        # current (P0, d), so rms_old comes for free)
        rms_old = np.sqrt((r0 ** 2).sum(axis=(1, 2)) / n_res)
        rms_new = rms(P0_new, d_new)
        better = (rms_new < rms_old)[:, None]
        P0 = np.where(better, P0_new, P0)
        d = np.where(better, d_new, d)

    return P0, d, rms_before, rms(P0, d)


def residuals_t(P0, d, Pm, p1, p2, mask):
    """torch twin of _residuals (same math, float32 tensors)."""
    ones = torch.ones((P0.shape[0], 1), dtype=P0.dtype, device=P0.device)
    Xa = torch.cat([P0, ones], dim=1)
    Xb = torch.cat([P0 + d, ones], dim=1)
    xa = torch.einsum("cmij,cj->cmi", Pm, Xa)
    xb = torch.einsum("cmij,cj->cmi", Pm, Xb)
    l = torch.linalg.cross(xa, xb)
    den = torch.sqrt(l[..., 0] ** 2 + l[..., 1] ** 2)
    ok = (xa[..., 2].abs() > 1e-12) & (xb[..., 2].abs() > 1e-12) & \
         (den > 1e-12) & mask
    den = den.clamp_min(1e-12)
    r1 = (l[..., 0] * p1[..., 0] + l[..., 1] * p1[..., 1] + l[..., 2]) / den
    r2 = (l[..., 0] * p2[..., 0] + l[..., 1] * p2[..., 1] + l[..., 2]) / den
    r = torch.stack([r1, r2], dim=-1)
    return torch.where(ok[..., None], r, torch.zeros_like(r)), ok


def orthobasis_t(dv):
    """torch _orthobasis: [C, 3] unit dirs -> (u1, u2)."""
    ex = dv.new_tensor([1.0, 0.0, 0.0]).expand_as(dv)
    ey = dv.new_tensor([0.0, 1.0, 0.0]).expand_as(dv)
    ref = torch.where(dv[:, 0:1].abs() < 0.9, ex, ey)
    u1 = torch.linalg.cross(dv, ref)
    u1 = u1 / torch.linalg.norm(u1, dim=1, keepdim=True)
    return u1, torch.linalg.cross(dv, u1)


def huber_weights(r0, ok, huber_delta):
    """Square roots of the Huber IRLS weights, zero for invalid members."""
    absr = r0.abs()
    w = torch.where(absr <= huber_delta, torch.ones_like(r0),
                    torch.sqrt(huber_delta / absr.clamp_min(1e-12)))
    return torch.where(ok[..., None], w, torch.zeros_like(w))


def _refine_lines_t(P0, d, Pm, p1, p2, mask, iterations: int,
                    huber_delta: float, damping: float):
    """The Gauss-Newton loop of line3d_tpu's _refine_lines_jit on tensors."""
    C = P0.shape[0]
    n_res = (mask.sum(dim=1) * 2).clamp_min(1).to(P0.dtype)

    def rms_of(P0_, d_):
        r, _ = residuals_t(P0_, d_, Pm, p1, p2, mask)
        return torch.sqrt((r ** 2).sum(dim=(1, 2)) / n_res)

    rms_before = rms_of(P0, d)
    eye4 = torch.eye(4, dtype=P0.dtype, device=P0.device)
    for _ in range(iterations):
        u1, u2 = orthobasis_t(d)

        def res_at(params):
            a, b, c, e = (params[:, k:k + 1] for k in range(4))
            dp = d + c * u1 + e * u2
            dp = dp / torch.linalg.norm(dp, dim=1, keepdim=True)
            return residuals_t(P0 + a * u1 + b * u2, dp, Pm, p1, p2,
                                mask)[0]

        zero = torch.zeros((C, 4), dtype=P0.dtype, device=P0.device)
        r0, ok = residuals_t(P0, d, Pm, p1, p2, mask)
        # exact forward-mode Jacobian: one jvp pass, vmapped over the 4
        # tangent directions
        J = torch.func.vmap(
            lambda v: torch.func.jvp(res_at, (zero,), (v,))[1])(
            eye4[:, None, :].expand(4, C, 4)).movedim(0, -1)  # [C, M, 2, 4]
        w = huber_weights(r0, ok, huber_delta)
        Jf = (J * w[..., None]).reshape(C, -1, 4)
        rf = (r0 * w).reshape(C, -1)
        H = torch.einsum("cik,cil->ckl", Jf, Jf)
        g = torch.einsum("cik,ci->ck", Jf, rf)
        tr = H.diagonal(dim1=1, dim2=2).sum(dim=1)
        H = H + damping * eye4[None] * tr.clamp_min(1.0)[:, None, None]
        stepv = torch.linalg.solve_ex(H, -g[..., None])[0][..., 0]
        stepv = torch.where(torch.isfinite(stepv), stepv,
                            torch.zeros_like(stepv))

        P0n = P0 + stepv[:, 0:1] * u1 + stepv[:, 1:2] * u2
        dn = d + stepv[:, 2:3] * u1 + stepv[:, 3:4] * u2
        dn = dn / torch.linalg.norm(dn, dim=1, keepdim=True)

        rms_old = torch.sqrt((r0 ** 2).sum(dim=(1, 2)) / n_res)
        better = (rms_of(P0n, dn) < rms_old)[:, None]
        P0 = torch.where(better, P0n, P0)
        d = torch.where(better, dn, d)
    return P0, d, rms_before, rms_of(P0, d)


def refine_lines_device(P0, d, Pm, p1, p2, mask, iterations: int = 5,
                        huber_delta: float = 2.0, damping: float = 1e-6,
                        *, device):
    """refine_lines in float32 torch on `device`, with exact JVP Jacobians.

    Same signature and semantics as refine_lines (numpy in, float64 numpy
    out); ~equal optima (both are rms-gated Gauss-Newton on the same
    residuals).  Every cluster's solve is independent: this rank solves
    its blocks of `block_size(C)` clusters (`multihost.local_block_range`;
    all of them in one process), each block as one set of tensor
    operations with no padding, and the float32 results of all ranks are
    gathered."""
    dev = torch.device(device)
    d_unit = np.asarray(d, np.float64)
    d_unit = d_unit / np.linalg.norm(d_unit, axis=1, keepdims=True)
    blk = block_size(len(d_unit))
    lo, hi = multihost.local_block_range(len(d_unit), blk)

    def t(x, sl, dtype=torch.float32):
        return torch.as_tensor(np.asarray(x)[sl], device=dev).to(dtype)
    outs = [torch.zeros((0, 8), dtype=torch.float32, device=dev)]
    for c0 in range(lo, hi, blk):
        sl = slice(c0, min(c0 + blk, hi))
        P0b, db, rbb, rab = _refine_lines_t(
            t(P0, sl), t(d_unit, sl), t(Pm, sl), t(p1, sl), t(p2, sl),
            t(mask, sl, torch.bool), iterations=int(iterations),
            huber_delta=float(huber_delta), damping=float(damping))
        outs.append(torch.cat([P0b, db, rbb[:, None], rab[:, None]], dim=1))
    out = multihost.allgather_tensor(torch.cat(outs)).cpu().numpy()
    out = out.astype(np.float64)
    return out[:, 0:3], out[:, 3:6], out[:, 6], out[:, 7]


def build_cluster_member_data(member_views, member_segs, scene_segments,
                              P_f64):
    """Pad per-cluster member (view, seg) lists into [C, M] arrays.

    member_views/member_segs: list of per-cluster int arrays.
    scene_segments: [V, S, 4]; P_f64: [V, 3, 4] projection matrices
    (conditioned space, float64).
    Returns (Pm [C, M, 3, 4], p1 [C, M, 2], p2 [C, M, 2], mask [C, M]).
    """
    C = len(member_views)
    M = max((len(v) for v in member_views), default=1)
    Pm = np.zeros((C, M, 3, 4))
    p1 = np.zeros((C, M, 2))
    p2 = np.zeros((C, M, 2))
    mask = np.zeros((C, M), bool)
    for c, (vs, ss) in enumerate(zip(member_views, member_segs)):
        k = len(vs)
        Pm[c, :k] = P_f64[vs]
        coords = scene_segments[vs, ss]
        p1[c, :k] = coords[:, 0:2]
        p2[c, :k] = coords[:, 2:4]
        mask[c, :k] = True
    return Pm, p1, p2, mask
