"""Configuration for the PyTorch/CUDA port (`line3d_tpu_torch`).

`L3DConfig` has the same fields and defaults as `line3d_tpu.config.L3DConfig`,
so a configuration means the same thing in both packages.  It mirrors the
reference's compile-time defaults (reference: commons.h:42-66 and
cudawrapper.h:35-46).
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class L3DConfig:
    """All tunables of the pipeline.

    Every field cites the reference symbol it corresponds to.

    Fields the port does not read (they steer TPU-only machinery of
    `line3d_tpu`): `view_pad_multiple`, `stable_shapes`.

    Matching modes, as in `line3d_tpu`: with `uncapped_fallback` and
    `capacity_probe` (the defaults) every view is matched once at its exact
    gate-passing capacity (the reference's unbounded match list) and the
    probe counters only report the scene-wide capacities; with
    `capacity_probe=False` a pass at `max_matches_per_segment` /
    `match_block_quota` is followed by an exact re-match of the views that
    overflowed; with `uncapped_fallback=False` the capped pass stands and
    the overflow is warned about.
    """

    # --- feature detection (commons.h:42-45) ---
    max_image_width: int = 1920          # L3D_DEF_MAX_IMG_WIDTH
    min_line_length_factor: float = 0.005  # L3D_DEF_MIN_LINE_LENGTH_F (x image diagonal)
    max_num_segments: int = 3000         # L3D_DEF_MAX_NUM_SEGMENTS
    load_and_store_segments: bool = True  # L3D_DEF_LOAD_AND_STORE_SEGMENTS

    # --- collinearity (commons.h:48-49) ---
    collinearity_sigma: float = 2.0      # L3D_DEF_COLLINEARITY_S
    use_collinearity: bool = True        # L3D_DEF_COLLINEARITY_FOR_CLUSTERING
    collinearity_aff_threshold: float = 0.50  # L3D_COLLIN_AFF_T_G (cudawrapper.h:44)
    # exported collinear pairs per view are capped at
    # max(8192, collinearity_pairs_per_seg * S); drops are counted
    collinearity_pairs_per_seg: int = 4
    # per-(segment, 128-partner-block) quota of the keep-plane compaction
    collinearity_block_quota: int = 8
    # re-derive views whose export dropped pairs from the dense [S, S]
    # matrix, so the maps equal the reference's unbounded sparse map
    # (segments.h:76-100)
    collinearity_exact_fallback: bool = True

    # --- matching (commons.h:52-58, cudawrapper.h:45-46) ---
    matching_neighbors: int = 10         # L3D_DEF_MATCHING_NEIGHBORS
    uncertainty_upper_px: float = 5.0    # L3D_DEF_UNCERTAINTY_UPPER_T
    uncertainty_lower_px: float = 1.0    # L3D_DEF_UNCERTAINTY_LOWER_T
    min_baseline: float = 0.25           # L3D_DEF_MIN_BASELINE_T
    sigma_p: float = 3.5                 # L3D_DEF_SIGMA_P (px)
    sigma_a: float = 10.0                # L3D_DEF_SIGMA_A (deg)
    min_overlap_lower: float = 0.10      # L3D_MIN_OVERLAP_LOWER_T_G
    min_overlap_upper: float = 0.30      # L3D_MIN_OVERLAP_UPPER_T_G

    # --- verification / selection (cudawrapper.cu:1026-1110) ---
    confidence_threshold: float = 1.0    # conf_t
    confidence_norm: float = 2.0         # confidence_norm
    support_threshold: float = 0.5       # per-support gate (cudawrapper.cu:699)

    # --- replicator dynamics diffusion (commons.h:61, cudawrapper.h:35) ---
    perform_diffusion: bool = False      # L3D_DEF_PERFORM_RDD
    diffusion_iterations: int = 10       # L3D_RDD_MAX_ITER
    diffusion_mode: str = "reference"    # "reference" lockstep or "true" RDD
    # "host" (float64 numpy/scipy), "device" (float32 torch on the
    # Line3D's device) or "auto": "device" on CUDA, "host" on the CPU
    diffusion_backend: str = "auto"

    # --- line refinement (additive, no reference equivalent) ---
    refine_lines: bool = False
    refine_iterations: int = 5
    refine_backend: str = "auto"         # as diffusion_backend

    # --- joint camera + line bundle adjustment (additive) ---
    bundle_adjust_cameras: bool = False
    bundle_iterations: int = 5

    # --- clustering (commons.h:64, line3D.cc:1245,1334) ---
    min_affinity: float = 0.25           # L3D_MIN_AFFINITY (direct edges)
    collinear_affinity: float = 0.01     # collinear edge threshold (line3D.cc:1087,1165)
    fh_c: float = 1.0                    # F-H constant c (line3D.cc:1245)
    fh_backend: str = "exact"            # "exact" serial merge order
    min_cameras_per_cluster: int = 4     # line3D.cc:1334
    min_cameras_open: int = 3            # sweep threshold (line3D.cc:1585-1591)

    # --- numerics ---
    eps: float = 1e-12                   # L3D_EPS / L3D_EPS_G

    # --- match caps, exactness guard and shape knobs of line3d_tpu ---
    max_matches_per_segment: int = 256
    match_block_quota: int = 8
    uncapped_fallback: bool = True
    capacity_probe: bool = True
    # segment-axis padding granularity (the port keeps it so that padded
    # shapes, and with them the compaction blocks, equal line3d_tpu's)
    pad_multiple: int = 128
    view_pad_multiple: int = 8           # TPU-only
    stable_shapes: bool = False          # TPU-only

    def __post_init__(self):
        # Reference clamps (line3D.cc:24-28)
        lower = max(abs(self.uncertainty_lower_px), 1.0)
        upper = abs(self.uncertainty_upper_px)
        if upper <= lower:
            upper = lower + 1.0
        object.__setattr__(self, "uncertainty_lower_px", lower)
        object.__setattr__(self, "uncertainty_upper_px", upper)


DEFAULT_CONFIG = L3DConfig()
