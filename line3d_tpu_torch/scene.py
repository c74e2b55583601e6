"""Scene container: fixed-shape, padded segment storage for all views.

Host-side copy of `line3d_tpu/scene.py` (f64/f32 numpy), plus the scene's
device-resident segment tensors: the reference keeps per-view std::maps and
per-view DataArrays (line3D.h:104-154, segments.h:48-132); here one padded
array per quantity plus validity masks, uploaded once to `device`.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .config import L3DConfig, DEFAULT_CONFIG
from .core.cameras import CameraSet
from .parallel import multihost


def pad_to(n: int, multiple: int) -> int:
    return max(multiple, ((n + multiple - 1) // multiple) * multiple)


@dataclasses.dataclass
class Scene:
    """All per-view data in dense padded arrays.

    segments:  [V, S, 4] float32 (x1,y1,x2,y2) in original pixel coords.
    seg_mask:  [V, S] bool — valid segment slots.
    seg_count: [V] int32.
    cameras:   CameraSet (float64 host).
    wp_lists:  list of per-view worldpoint-id arrays (ragged, host only).
    collin:    per-view sparse collinearity maps (CollinMaps), or None.
    device:    where `segments_t` / `seg_mask_t`, the tensor copies the
               matching and collinearity stages read, live ("cuda" is
               this rank's card under N ranks, multihost.resolve_device).
    """
    segments: np.ndarray
    seg_mask: np.ndarray
    seg_count: np.ndarray
    cameras: CameraSet
    wp_lists: list | None = None
    collin: list | None = None
    config: L3DConfig = dataclasses.field(default_factory=lambda: DEFAULT_CONFIG)
    device: torch.device | str = "cuda"

    def __post_init__(self):
        # under N ranks a bare "cuda" is this rank's card
        self.device = multihost.resolve_device(self.device)
        self.segments_t = torch.as_tensor(
            np.asarray(self.segments, np.float32), device=self.device)
        self.seg_mask_t = torch.as_tensor(
            np.asarray(self.seg_mask, bool), device=self.device)

    @property
    def num_views(self) -> int:
        return self.segments.shape[0]

    @property
    def max_segments(self) -> int:
        return self.segments.shape[1]

    def to(self, device) -> "Scene":
        """The same scene with its tensors on `device`."""
        return dataclasses.replace(self, device=device)

    @staticmethod
    def from_ragged(segment_lists: list, cameras: CameraSet,
                    wp_lists=None, collin=None,
                    config: L3DConfig = DEFAULT_CONFIG,
                    device="cuda") -> "Scene":
        """Build a padded Scene from per-view [S_v, 4] segment arrays; the
        segment axis pads to a multiple of `config.pad_multiple`."""
        V = len(segment_lists)
        counts = np.array([len(s) for s in segment_lists], np.int32)
        S = int(counts.max()) if V else 1
        S = pad_to(S, config.pad_multiple)
        segs = np.zeros((V, S, 4), np.float32)
        mask = np.zeros((V, S), bool)
        for v, s in enumerate(segment_lists):
            s = np.asarray(s, np.float32).reshape(-1, 4)
            segs[v, :len(s)] = s
            mask[v, :len(s)] = True
        return Scene(segments=segs, seg_mask=mask, seg_count=counts,
                     cameras=cameras, wp_lists=wp_lists, collin=collin,
                     config=config, device=device)


# ----------------------------------------------------------------------
def view_similarities_from_worldpoints(wp_lists: list, num_views: int):
    """Pairwise view similarity from shared worldpoints.

    sim(v, n) = 2 |wps_v ∩ wps_n| / (|wps_v'| + |wps_n'|) where |wps'| counts
    only worldpoints seen by >= 2 other views that share a point with it —
    mirroring processWorldpointList + findVisualNeighbors
    (line3D.cc:1874-1935, 476-501): num_wps_[v] is incremented once per
    worldpoint that already had >= 2 views when v observed it, plus once for
    each of v's points when a third view arrives.

    Returns ([V, V] float64 similarity matrix, [V] effective wp counts).
    The reference's incremental bookkeeping is equivalent to: for each
    worldpoint seen by k >= 3 views (in insertion order v1, v2, ... vk), every
    view in the list gets +1 except... — in fact tracing the code: when the
    3rd view arrives, v1 and v2 each get +1 (the "new 3-view worldpoint"
    branch) and the 3rd gets +1 (the ">=2 existing" branch); every later view
    also gets +1.  So num_wps_[v] = #worldpoints of v seen by >= 3 views
    total.  common_wps_[v][n] counts worldpoints seen by both v and n,
    counted once per (unordered pair, worldpoint) when the *later* of the two
    observes it with >= 2 existing views — i.e. every shared worldpoint that
    is seen by >= 3 views in total, plus shared points where one of the two
    was among the first two observers... Careful: the pair (v1, v2) for a
    2-view point is only counted when a 3rd view arrives.  For a point with
    views v1..vk (k >= 3), every unordered pair among v1..vk is counted
    exactly once.  For k == 2, nothing is counted.  Hence:

        common(v, n) = #worldpoints seen by both v and n and by >= 3 views
        num_wps(v)   = #worldpoints seen by v and by >= 3 views in total

    which is what this function computes directly.
    """
    # common = A A^T over the [V, W] view-worldpoint incidence matrix of
    # worldpoints seen by >= 3 views, as one (W-chunked) BLAS matmul —
    # the earlier per-worldpoint k x k scatter was O(sum k^2) and took
    # 52 s at V=1000 on the facade scene, where a worldpoint is seen by
    # hundreds of views (vs ~2 s here).  f32 accumulation is exact for
    # counts < 2^24.
    pairs = []
    for v in range(num_views):
        if wp_lists[v] is None or len(wp_lists[v]) == 0:
            continue
        # reference uses map<viewID,bool>: duplicates collapse
        u = np.unique(np.asarray(wp_lists[v], np.int64))
        u = u[u >= 0]
        pairs.append(np.stack([np.full(len(u), v, np.int64), u], axis=1))
    num_wps = np.zeros(num_views, np.int64)
    common = np.zeros((num_views, num_views), np.float32)
    if pairs:
        P = np.concatenate(pairs)
        _, w_idx = np.unique(P[:, 1], return_inverse=True)
        counts = np.bincount(w_idx)
        keep = counts[w_idx] >= 3
        v_k = P[keep, 0]
        _, w_dense = np.unique(w_idx[keep], return_inverse=True)
        W = int(w_dense.max()) + 1 if len(w_dense) else 0
        num_wps = np.bincount(v_k, minlength=num_views).astype(np.int64)
        CH = 1 << 15                  # bound A-chunk memory at V * 128 KB
        for lo in range(0, W, CH):
            in_ch = (w_dense >= lo) & (w_dense < min(lo + CH, W))
            A = np.zeros((num_views, min(CH, W - lo)), np.float32)
            A[v_k[in_ch], w_dense[in_ch] - lo] = 1.0
            common += A @ A.T
    common = common.astype(np.int64)
    np.fill_diagonal(common, 0)

    denom = num_wps[:, None] + num_wps[None, :]
    with np.errstate(divide="ignore", invalid="ignore"):
        sim = np.where(denom > 0, 2.0 * common / denom, 0.0)
    return sim, num_wps


def find_visual_neighbors(sim: np.ndarray, baselines: np.ndarray,
                          min_baseline: float, max_neighbors: int,
                          eps: float = 1e-12, ext_ids=None) -> list:
    """Greedy visual-neighbor selection per view.

    Mirrors findVisualNeighbors (line3D.cc:503-548): iterate candidates in
    ascending view-id order (std::map), accept a candidate iff its baseline to
    the source AND to every previously-accepted neighbor exceeds min_baseline;
    then keep the top `max_neighbors` by similarity (stable sort, list order =
    id order for ties).

    The accept loop and similarity tie-breaks are order-dependent;
    `ext_ids` supplies the external image ids so candidates iterate in
    ascending EXTERNAL id (the reference's std::map order) even when views
    were registered out of id order.  Default: internal order (dense ids).

    Returns per-view sorted (ascending internal id) numpy arrays of
    neighbor ids.
    """
    V = sim.shape[0]
    cand_order = np.arange(V) if ext_ids is None else \
        np.argsort(np.asarray(ext_ids), kind="stable")
    # the greedy accept is sequential BY CONSTRUCTION (each accept
    # constrains later candidates), but the per-candidate check against
    # all previously-accepted neighbors folds into one running boolean
    # mask: compatible[n] = candidate gates AND baseline > min to every
    # accepted so far.  The earlier all(...)-per-candidate python loop
    # was O(V^2 * accepted) and took ~38 s at V=1000 on the facade arc
    # (every view similar to every view); this form is ~0.5 s.
    base_ok = baselines > min_baseline
    out = []
    for v in range(V):
        mask = (sim[v] > eps) & base_ok[v]
        mask[v] = False
        cand = cand_order[mask[cand_order]]
        compatible = mask
        accepted = []
        for n in cand:
            if compatible[n]:
                accepted.append(n)
                compatible = compatible & base_ok[n]
        if accepted:
            accepted = np.array(accepted)
            order = np.argsort(-sim[v, accepted], kind="stable")
            accepted = accepted[order]
            if max_neighbors > 0 and len(accepted) > max_neighbors:
                accepted = accepted[:max_neighbors]
            out.append(np.sort(accepted))
        else:
            out.append(np.zeros(0, np.int64))
    return out
