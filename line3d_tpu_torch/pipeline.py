"""Public pipeline API: the Line3D class of the PyTorch/CUDA port.

Mirrors `line3d_tpu.pipeline.Line3D` and the reference's L3D::Line3D surface
(line3D.h:58-102): add_view_segments() per view, compute_3d_model(),
get_result(), save_3d_lines_as_stl/txt().  The five stages
(compute3Dmodel, line3D.cc:345-374) run with the device stages —
collinearity, matching, and when enabled the device forms of diffusion,
line refinement and bundle adjustment — on `device`, and the host stages in
numpy and the native C++ library.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from .config import L3DConfig, DEFAULT_CONFIG
from .core.cameras import CameraSet
from .core.conditioning import compute_conditioning, SceneTransform
from .scene import Scene, view_similarities_from_worldpoints, \
    find_visual_neighbors
from .match import engine
from .match.collinearity import collinearity_maps_fast, \
    apply_collinearity_exact_fallback
from .cluster import affinity, fh, diffusion as diffusion_mod
from .fit import lines as fit_lines
from .io import writers


def _check_config(cfg: L3DConfig):
    """The option of line3d_tpu the port does not run yet (ROADMAP.md)."""
    if not cfg.uncapped_fallback:
        raise NotImplementedError(
            "line3d_tpu_torch: uncapped_fallback=False is not ported yet "
            "(the capped matching mode)")


class Line3D:
    """Line-based multi-view stereo on PyTorch, with hand-written CUDA
    kernels on an NVIDIA GPU.

        l3d = Line3D(config)                  # on the card
        for v, segs in enumerate(segment_lists):
            l3d.add_view_segments(v, segs, K, R, t, worldpoint_ids, w, h)
        result = l3d.compute_3d_model()
        l3d.save_3d_lines_as_txt(result, "out.txt")

    The device is "cuda" unless the caller asks for the CPU, and the
    constructor raises when CUDA is missing: there is no quiet CPU run.
    On a CUDA device every kernel runs on the card (there is no fallback);
    on `device="cpu"` every kernel runs as its plain PyTorch twin.
    """

    def __init__(self, config: L3DConfig = DEFAULT_CONFIG, device="cuda",
                 verbose: bool = False):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("Line3D: device 'cuda' requested but "
                               "torch.cuda.is_available() is False")
        if self.device.type not in ("cpu", "cuda"):
            raise ValueError(f"Line3D: unsupported device {self.device}")
        self.config = config
        self.verbose = verbose
        self.reset()

    def reset(self):
        self._images = []       # external ids, in add order
        self._K, self._R, self._t = [], [], []
        self._wh = []
        self._segments = []     # per-view [S_v, 4] arrays
        self._wp_lists = []
        self.scene: Scene | None = None
        self.cameras: CameraSet | None = None
        self.transform: SceneTransform | None = None
        self.result: list = []
        self.neighbors = None
        self.matches = None
        self.best = None
        self.refined_poses = None
        self.stats = {}

    def add_view_segments(self, image_id: int, segments, K, R, t,
                          worldpoint_ids=None, width: int = 0,
                          height: int = 0):
        """Register a view with precomputed 2D segments (the reference's
        `-l` cache plays the same role, line3D.cc:160-168).  Views with ZERO
        segments are not registered (line3D.cc:188-198)."""
        if image_id in self._images:
            raise ValueError(f"image id {image_id} already in use")
        if worldpoint_ids is None:
            raise ValueError("unlinked images cannot be added (no worldpoints)")
        if np.asarray(segments).size == 0:
            if self.verbose:
                print(f"[L3D] image {image_id}: no segments — view skipped")
            return
        self._images.append(image_id)
        self._K.append(np.asarray(K, np.float64))
        self._R.append(np.asarray(R, np.float64))
        self._t.append(np.asarray(t, np.float64).reshape(3))
        self._wh.append((width, height))
        self._segments.append(np.asarray(segments, np.float32).reshape(-1, 4))
        self._wp_lists.append(list(worldpoint_ids))

    def _build_scene(self):
        cams = CameraSet(
            K=np.stack(self._K), R=np.stack(self._R), t=np.stack(self._t),
            width=np.array([wh[0] for wh in self._wh]),
            height=np.array([wh[1] for wh in self._wh]),
            uncertainty_lower_px=self.config.uncertainty_lower_px,
            uncertainty_upper_px=self.config.uncertainty_upper_px)
        self.scene = Scene.from_ragged(self._segments, cams,
                                       wp_lists=self._wp_lists,
                                       config=self.config, device=self.device)
        self.cameras = cams

    def compute_3d_model(self, perform_diffusion: bool | None = None):
        """Run the five-stage pipeline (compute3Dmodel, line3D.cc:345-374)."""
        cfg = self.config
        diffu = cfg.perform_diffusion if perform_diffusion is None \
            else perform_diffusion
        _check_config(cfg)
        if len(self._images) < 4:
            raise ValueError("not enough images (need >= 4)")
        self.refined_poses = None     # never leak a previous run's BA poses

        t0 = time.perf_counter()
        self._build_scene()
        scene, cams = self.scene, self.cameras
        t_setup = time.perf_counter() - t0

        # stage 1: visual neighbors (line3D.cc:361)
        sim, _ = view_similarities_from_worldpoints(self._wp_lists,
                                                    scene.num_views)
        self.neighbors = find_visual_neighbors(
            sim, cams.baselines(), cfg.min_baseline, cfg.matching_neighbors,
            cfg.eps, ext_ids=self._images)
        # stage 2: scene conditioning (line3D.cc:364)
        self.transform = compute_conditioning(cams.C)
        cams.transform(self.transform.Qinv, self.transform.scale)
        t_graph = time.perf_counter() - t0 - t_setup

        # collinearity (L3DSegments ctor, segments.h:73-101)
        tc0 = time.perf_counter()
        if cfg.use_collinearity:
            scene.collin = collinearity_maps_fast(
                scene.segments_t, scene.seg_mask_t, cfg.collinearity_sigma,
                quota=cfg.collinearity_block_quota,
                pairs_per_seg=cfg.collinearity_pairs_per_seg,
                aff_threshold=cfg.collinearity_aff_threshold)
        t1 = time.perf_counter()

        # stage 3+4: matching + verification + greedy selection at exact
        # capacity (line3D.cc:367-370; cudawrapper.cu:923-1007)
        matches, best, _ = engine.run_matching(
            scene, cams, self.neighbors, cfg, verbose=self.verbose)
        self.matches, self.best = matches, best

        # exactness guard for collinearity (the reference keeps every
        # pair, segments.h:76-100)
        coll_overflow, n_recollin = 0, 0
        if cfg.use_collinearity:
            coll_overflow = int(scene.collin.dropped_total)
            if coll_overflow and cfg.collinearity_exact_fallback:
                scene.collin, n_recollin = apply_collinearity_exact_fallback(
                    scene.collin, scene.segments_t, scene.seg_mask_t,
                    cfg.collinearity_sigma,
                    aff_threshold=cfg.collinearity_aff_threshold,
                    verbose=self.verbose)
        t2 = time.perf_counter()

        # stage 5: clustering (line3D.cc:373)
        graph = affinity.build_affinity_graph(
            best, matches, scene.collin, cams, cfg, scene.max_segments,
            verbose=self.verbose)
        t2a = time.perf_counter()
        if diffu and graph.num_nodes:
            # performDiffusion (line3D.cc:1255-1303): the device backend
            # runs on the Line3D's device
            graph = diffusion_mod.run_diffusion(graph, cfg, self.verbose,
                                                device=self.device)
        t2b = time.perf_counter()
        ba_info = {}
        if graph.num_nodes:
            fh_fn = fh.fh_cluster_parallel \
                if cfg.fh_backend == "parallel" else fh.fh_cluster
            labels = fh_fn(graph.edges_i, graph.edges_j, graph.edges_w,
                           graph.num_nodes, cfg.fh_c)
            t2c = time.perf_counter()
            self.result = fit_lines.process_clusters(
                graph, labels, best, self.transform, cfg,
                scene.max_segments, verbose=self.verbose,
                refine=cfg.refine_lines or cfg.bundle_adjust_cameras,
                scene_segments=scene.segments, P_cond=cams.P, cameras=cams,
                device=self.device, out_info=ba_info)
            if "R_cond" in ba_info:
                # un-condition the refined poses: X' = s (R_c X + t_c), so
                # the equivalent original-frame pose of a conditioned
                # camera (R', t') is R_u = R' R_c, t_u = R' t_c + t' / s
                tr = self.transform
                Rp, tp = ba_info["R_cond"], ba_info["t_cond"]
                self.refined_poses = (
                    np.einsum("vij,jk->vik", Rp, tr.R),
                    np.einsum("vij,j->vi", Rp, tr.t) + tp * tr.scale_inv)
        else:
            t2c = t2b
            self.result = []
        t3 = time.perf_counter()

        self.stats = dict(
            num_views=scene.num_views,
            num_best=int(best.view.size),
            num_edges=int(len(graph.edges_w)),
            num_lines=len(self.result),
            t_setup=t_setup, t_graph=t_graph, t_collin=t1 - tc0,
            t_match=t2 - t1, t_cluster=t3 - t2, t_total=t3 - t0,
            t_affinity=t2a - t2, t_diffusion=t2b - t2a, t_fh=t2c - t2b,
            t_fit=t3 - t2c,
            match_overflow=int(sum(vm.overflow for vm in matches)),
            m_total=[int(vm.m_total) for vm in matches],
            collinearity_overflow=coll_overflow,
            views_recollin_exact=int(n_recollin))
        if ba_info:
            self.stats["ba_rms_before"] = ba_info["ba_rms_before"]
            self.stats["ba_rms_after"] = ba_info["ba_rms_after"]
        if self.verbose:
            print(f"[L3D] {len(self.result)} 3D lines found! "
                  f"(match {t2 - t1:.2f}s, cluster {t3 - t2:.2f}s)")
        return self.result

    def get_result(self):
        return self.result

    def get_segment_2d(self, view: int, seg: int):
        """Coordinates of a 2D segment (getSegment2D, line3D.cc:2004-2013);
        `view` is the internal dense index."""
        return self.scene.segments[view, seg]

    def save_3d_lines_as_stl(self, result, filename: str):
        writers.save_stl(result, filename)

    def save_3d_lines_as_txt(self, result, filename: str):
        writers.save_txt(result, filename, get_segment_2d=self.get_segment_2d,
                         view_id_map=self._images)
