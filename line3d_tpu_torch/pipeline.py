"""Public pipeline API: the Line3D class of the PyTorch/CUDA port.

Mirrors `line3d_tpu.pipeline.Line3D` and the reference's L3D::Line3D surface
(line3D.h:58-102): add_image() / add_view_segments() per view,
compute_3d_model(), get_result(), save_3d_lines_as_stl/txt().  Images are
reduced to segment arrays on the host (detection is a host stage, as in
`line3d_tpu`); the five stages (compute3Dmodel, line3D.cc:345-374) run with
the device stages — collinearity, matching, and when enabled the device
forms of diffusion, line refinement and bundle adjustment — on `device`,
and the host stages in numpy and the native C++ library.
"""
from __future__ import annotations

import os
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from .config import L3DConfig, DEFAULT_CONFIG
from .core.cameras import CameraSet
from .core.conditioning import compute_conditioning, SceneTransform
from .scene import Scene, view_similarities_from_worldpoints, \
    find_visual_neighbors
from .match import engine
from .match.collinearity import collinearity_maps_fast
from .cluster import affinity, fh, diffusion as diffusion_mod
from .detect import detector
from .fit import lines as fit_lines
from .io import cache as seg_cache, writers
from .native import load as native_load
from .parallel import multihost
from . import trace


def _match_wait_ns() -> int:
    """The host's nanoseconds waiting in the match step's readbacks so far
    (the `match.*` sites of trace.readback)."""
    return sum(v for k, v in trace.WAIT_NS.items() if k.startswith("match."))


class Line3D:
    """Line-based multi-view stereo on PyTorch, with hand-written CUDA
    kernels on an NVIDIA GPU.

        l3d = Line3D(folder, config)                     # on the card
        for i, img in enumerate(images):
            l3d.add_image(i, img, K, R, t, worldpoint_ids)
        result = l3d.compute_3d_model()
        l3d.save_3d_lines_as_txt(result, "out.txt")

    (the flow of the reference CLIs, main_bundler.cpp:104-332);
    `add_view_segments` registers a view whose segments were detected
    elsewhere.  With a `data_directory` (created when given) detected
    segments are cached there per image.

    The positional arguments are `line3d_tpu.Line3D`'s: (data_directory,
    config, verbose, use_sharded_engine).  `use_sharded_engine` (default
    True) keeps its meaning there: each view's best matches, median depth
    and verified identities are selected on the device and only those
    cross to the host; False copies each view's match tables to the host
    and selects there.  The models are the same.

    The device, a keyword, is "cuda" unless the caller asks for the CPU,
    and the constructor raises when CUDA is missing: there is no quiet CPU
    run.  On a CUDA device every kernel runs on the card (there is no
    fallback); on `device="cpu"` every kernel runs as its plain PyTorch
    twin.

    Across N processes (`parallel.multihost.initialize` first, or
    torchrun) every rank builds the same Line3D; "cuda" is then the
    rank's card, cuda:{local rank % cards}.  Each rank runs collinearity
    and matching for its own view range only and the host arrays those
    stages read back are all-gathered over gloo; the cluster stage runs
    on every rank (its weight sweep split across them), so every rank
    ends with the single-process model.  That needs the device selection:
    `use_sharded_engine=False` raises under N > 1.
    """

    def __init__(self, data_directory: str | None = None,
                 config: L3DConfig = DEFAULT_CONFIG, verbose: bool = False,
                 use_sharded_engine: bool = True, *, device="cuda"):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("Line3D: device 'cuda' requested but "
                               "torch.cuda.is_available() is False")
        # under N ranks a bare "cuda" is this rank's card
        self.device = multihost.resolve_device(self.device)
        if self.device.type not in ("cpu", "cuda"):
            raise ValueError(f"Line3D: unsupported device {self.device}")
        self.config = config
        self.verbose = verbose
        self.data_directory = data_directory
        self.use_sharded_engine = use_sharded_engine
        if data_directory:
            os.makedirs(data_directory, exist_ok=True)
        self.reset()

    def reset(self):
        self._images = []       # external ids, in add order
        self._K, self._R, self._t = [], [], []
        self._wh = []
        self._segments = []     # per-view [S_v, 4] arrays
        self._wp_lists = []
        self._fixed_sim = None  # optional {ext_id: {ext_id: sim}}
        self.scene: Scene | None = None
        self.cameras: CameraSet | None = None
        self.transform: SceneTransform | None = None
        self.result: list = []
        self.neighbors = None
        self.matches = None
        self.best = None
        self.refined_poses = None
        self.stats = {}

    def num_cameras(self) -> int:
        return len(self._images)

    def _check_new_view(self, image_id: int, worldpoint_ids):
        if image_id in self._images:
            raise ValueError(f"image id {image_id} already in use")
        if worldpoint_ids is None and self._fixed_sim is None:
            raise ValueError("unlinked images cannot be added (no worldpoints)")

    def add_image(self, image_id: int, image, K, R, t,
                  worldpoint_ids=None, max_img_width: int | None = None,
                  load_and_store_segments: bool | None = None):
        """Detect (or load cached) segments for one image and register the
        view (addImage, line3D.cc:95-217).

        `image` is an HxW(x3) array or a zero-argument callable returning
        one.  Returns the number of segments registered for the view.
        """
        self._check_new_view(image_id, worldpoint_ids)
        cfg = self.config
        max_w = cfg.max_image_width if max_img_width is None else max_img_width
        store = cfg.load_and_store_segments if load_and_store_segments is None \
            else load_and_store_segments

        segs, (w, h), dt = self._segments_for_image(image_id, image,
                                                    max_w, store)
        self.stats["t_detect"] = self.stats.get("t_detect", 0.0) + dt
        self.add_view_segments(image_id, segs, K, R, t, worldpoint_ids,
                               width=w, height=h)
        return int(np.asarray(segs).reshape(-1, 4).shape[0])

    def _segments_for_image(self, image_id: int, image, max_w: int,
                            store: bool):
        """Detect (or load cached) segments for one image.

        Thread-safe (numpy and native host work + the segment cache, no
        shared pipeline state) — add_images_parallel maps it over a thread
        pool.  Returns (segments [N, 4], (width, height), detect_seconds).
        """
        cfg = self.config
        img = np.asarray(image() if callable(image) else image)
        h, w = img.shape[:2]

        new_w, new_h = w, h
        if max_w > 0 and max(w, h) > max_w:
            s = max_w / float(max(w, h))
            new_w, new_h = round(w * s), round(h * s)

        segs = None
        cache_file = None
        if self.data_directory:
            path = seg_cache.segment_cache_path(
                self.data_directory, image_id, new_w, new_h,
                cfg.use_collinearity, max_segments=cfg.max_num_segments,
                min_len_factor=cfg.min_line_length_factor)
            if store:
                cache_file = path
                segs = seg_cache.load_segments(cache_file)
            elif os.path.exists(path):
                # mirror the reference: -l off removes a stale cache file
                # so a later cached run cannot resurrect it
                # (line3D.cc:154-158)
                os.remove(path)
        dt = 0.0
        if segs is None:
            t0 = time.perf_counter()
            min_len = cfg.min_line_length_factor * np.hypot(h, w)
            segs = detector.detect_line_segments(
                img, new_w, new_h, min_len, cfg.max_num_segments)
            dt = time.perf_counter() - t0
            if cache_file:
                seg_cache.save_segments(cache_file, segs)
        return segs, (w, h), dt

    def add_images_parallel(self, items, max_img_width: int | None = None,
                            load_and_store_segments: bool | None = None,
                            workers: int | None = None):
        """Add many images with detection running in a thread pool.

        The reference detects strictly sequentially inside addImage
        (line3D.cc:95-217); detection here is host-side work that releases
        the GIL (numpy and the native library), so images run in parallel
        and image I/O overlaps detection.

        Args:
          items: iterable of (image_id, image_or_loader, K, R, t,
            worldpoint_ids); `image_or_loader` may be a zero-arg callable
            returning the image so file loading/undistortion also runs in
            the worker thread.
          workers: thread count (default: os.cpu_count(), capped at 8).

        Views are registered in the given item order regardless of thread
        completion order, so results are deterministic.
        """
        items = list(items)
        cfg = self.config
        max_w = cfg.max_image_width if max_img_width is None \
            else max_img_width
        store = cfg.load_and_store_segments if load_and_store_segments \
            is None else load_and_store_segments
        for image_id, _img, _K, _R, _t, wp_ids in items:
            self._check_new_view(image_id, wp_ids)
        if workers is None:
            workers = min(os.cpu_count() or 1, 8)
        workers = max(1, workers)

        # split the cores between image-level threads and the native
        # library's OpenMP regions (omp_set_num_threads is per-thread), so
        # that workers x OpenMP threads does not exceed the cores
        lib = native_load.get_lib()
        per = max(1, (os.cpu_count() or 1) // workers)

        t0 = time.perf_counter()
        with ThreadPoolExecutor(
                max_workers=workers,
                initializer=lambda: lib.native_set_num_threads(per)) as ex:
            results = list(ex.map(
                lambda it: self._segments_for_image(it[0], it[1], max_w,
                                                    store), items))
        # the pool's wall time when it detected any image; loading images
        # whose segments all came from the cache is no detection
        if any(dt > 0 for _, _, dt in results):
            self.stats["t_detect"] = self.stats.get("t_detect", 0.0) + \
                (time.perf_counter() - t0)
        for (image_id, _, K, R, t, wp_ids), (segs, (w, h), _dt) in zip(
                items, results):
            self.add_view_segments(image_id, segs, K, R, t, wp_ids,
                                   width=w, height=h)

    def set_view_similarity(self, image_id: int, sims: dict):
        """Fixed view similarity instead of worldpoints (addImage_fixed_sim /
        setViewSimilarity, line3D.cc:220-342, 1938-1946)."""
        if self._fixed_sim is None:
            self._fixed_sim = {}
        self._fixed_sim[image_id] = {k: v for k, v in sims.items()
                                     if v > 0.01}

    def _view_similarities(self):
        V = len(self._images)
        if self._fixed_sim is not None:
            ext2int = {e: i for i, e in enumerate(self._images)}
            sim = np.zeros((V, V))
            for e, d in self._fixed_sim.items():
                for e2, s in d.items():
                    if e in ext2int and e2 in ext2int:
                        sim[ext2int[e], ext2int[e2]] = s
            return sim
        sim, _ = view_similarities_from_worldpoints(self._wp_lists, V)
        return sim

    def add_view_segments(self, image_id: int, segments, K, R, t,
                          worldpoint_ids=None, width: int = 0,
                          height: int = 0):
        """Register a view with precomputed 2D segments (the reference's
        `-l` cache plays the same role, line3D.cc:160-168).  Views with ZERO
        segments are not registered (line3D.cc:188-198).  `worldpoint_ids`
        may be None once fixed view similarities are set
        (set_view_similarity)."""
        self._check_new_view(image_id, worldpoint_ids)
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
        self._wp_lists.append(list(worldpoint_ids)
                              if worldpoint_ids is not None else [])

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
        if len(self._images) < 4:
            raise ValueError("not enough images (need >= 4)")
        self.refined_poses = None     # never leak a previous run's BA poses

        nproc = multihost.process_count()
        # bytes received from the other ranks, in all and by stage (each
        # stage's count taken from b, the total at its start); the
        # readbacks' synchronisations, bytes and waits likewise
        gathered0 = multihost.GATHERED_BYTES
        syncs0, dtoh0 = trace.SYNCS, trace.DTOH_BYTES
        by_stage = {}
        with trace.model():
            with trace.stage("scene"):
                self._build_scene()
            scene, cams = self.scene, self.cameras

            with trace.stage("neighbors"):
                # stage 1: visual neighbors (line3D.cc:361)
                self.neighbors = find_visual_neighbors(
                    self._view_similarities(), cams.baselines(),
                    cfg.min_baseline, cfg.matching_neighbors, cfg.eps,
                    ext_ids=self._images)
                # stage 2: scene conditioning (line3D.cc:364)
                self.transform = compute_conditioning(cams.C)
                cams.transform(self.transform.Qinv, self.transform.scale)

            # collinearity (L3DSegments ctor, segments.h:73-101), every
            # view's pairs exact
            b = multihost.GATHERED_BYTES
            with trace.stage("collinearity"):
                if cfg.use_collinearity:
                    scene.collin = collinearity_maps_fast(
                        scene.segments_t, scene.seg_mask_t,
                        cfg.collinearity_sigma,
                        quota=cfg.collinearity_block_quota,
                        pairs_per_seg=cfg.collinearity_pairs_per_seg,
                        aff_threshold=cfg.collinearity_aff_threshold)
            by_stage["collinearity"] = multihost.GATHERED_BYTES - b

            b = multihost.GATHERED_BYTES
            wait0 = _match_wait_ns()
            with trace.stage("matching"):
                (matches, best, decision, overflow_total,
                 n_rematched) = self._matching(scene, cams)
            t_match_wait = (_match_wait_ns() - wait0) / 1e9
            by_stage["matching"] = multihost.GATHERED_BYTES - b

            # stage 5: clustering (line3D.cc:373)
            b = multihost.GATHERED_BYTES
            with trace.stage("affinity"):
                # the exact-order enumeration runs on the Line3D's device
                graph = affinity.build_affinity_graph(
                    best, matches, scene.collin, cams, cfg,
                    scene.max_segments, verbose=self.verbose,
                    device=self.device)
            n_candidates, n_kept = graph.num_candidates, graph.num_kept
            by_stage["affinity"] = multihost.GATHERED_BYTES - b
            b = multihost.GATHERED_BYTES
            diff_info = {}
            with trace.stage("diffusion"):
                if diffu and graph.num_nodes:
                    # performDiffusion (line3D.cc:1255-1303): the device
                    # backend runs on the Line3D's device, split by edge
                    # over the ranks
                    graph = diffusion_mod.run_diffusion(
                        graph, cfg, self.verbose, device=self.device,
                        out_info=diff_info)
            by_stage["diffusion"] = multihost.GATHERED_BYTES - b
            # F-H and the line fits: the device refinement or the BA
            b = multihost.GATHERED_BYTES
            fit_info = {}
            with trace.stage("fh"):
                if graph.num_nodes:
                    args = (graph.edges_i, graph.edges_j, graph.edges_w,
                            graph.num_nodes, cfg.fh_c)
                    # the round-parallel F-H runs its rounds on the
                    # Line3D's device
                    labels = fh.fh_cluster_parallel(
                        *args, device=self.device) \
                        if cfg.fh_backend == "parallel" \
                        else fh.fh_cluster(*args)
            with trace.stage("fit"):
                self.result = self._fit(graph, labels, best, scene, cams,
                                        fit_info) if graph.num_nodes else []
            by_stage["fit"] = multihost.GATHERED_BYTES - b
        lo, hi = multihost.local_range(scene.num_views)
        # the collinearity's first pass: the pairs its quota and cap
        # dropped, and the views re-run at exact capacity
        coll = scene.collin
        coll_overflow, n_recollin = (0, 0) if coll is None else \
            (coll.dropped_total, len(coll.views_exact))

        t = trace.SECONDS
        self.stats = dict(
            num_views=scene.num_views,
            num_best=int(best.view.size),
            num_edges=int(len(graph.edges_w)),
            num_lines=len(self.result),
            t_detect=self.stats.get("t_detect", 0.0),
            t_setup=t["scene"], t_graph=t["neighbors"],
            t_collin=t["collinearity"], t_match=t["matching"],
            t_cluster=t["affinity"] + t["diffusion"] + t["fh"] + t["fit"],
            t_total=t["model"], t_affinity=t["affinity"],
            t_diffusion=t["diffusion"], t_fh=t["fh"], t_fit=t["fit"],
            # the affinity stage's parts (0 where the graph was built
            # without collinearity), and the host's seconds blocked in
            # the match step's readbacks (sites match.*)
            t_affinity_pairs=t.get("affinity.pairs", 0.0),
            t_affinity_enum=t.get("affinity.enumerate", 0.0),
            t_affinity_weights=t.get("affinity.weights", 0.0),
            # the device diffusion's parts (plan: the uploads, the sorts
            # and the length classes on the device; iterate: the
            # iterations and the readback of the weights and edge ids)
            # and the line refinement (either backend, or the
            # BA), 0 where they did not run
            t_diffusion_plan=t.get("diffusion.plan", 0.0),
            t_diffusion_iterate=t.get("diffusion.iterate", 0.0),
            t_refine=t.get("fit.refine", 0.0),
            # their sizes: the edges the device diffusion took and its
            # dot's products an iteration on this rank; the clusters and
            # members refined
            diffusion_edges=diff_info.get("edges", 0),
            diffusion_terms=diff_info.get("terms", 0),
            refine_clusters=fit_info.get("refine_clusters", 0),
            refine_members=fit_info.get("refine_members", 0),
            # the length of the affinity stage's candidate stream, and
            # the candidates of it the host weighed (on CUDA those the
            # card's filter kept, otherwise all)
            affinity_candidates=n_candidates,
            affinity_kept=n_kept,
            t_match_wait=t_match_wait,
            # the model's host synchronisations and device-to-host bytes,
            # every readback counted (trace.readback)
            readback_syncs=int(trace.SYNCS - syncs0),
            readback_bytes=int(trace.DTOH_BYTES - dtoh0),
            match_overflow=int(overflow_total),
            views_rematched_uncapped=int(n_rematched),
            # the scene-wide one-pass capacities the probe counters decide
            # (0 = the default caps were already exact, or no probe)
            probe_m_total=int(decision["m_total"]) if decision else 0,
            probe_quota=int(decision["quota"]) if decision else 0,
            probe_k_export=int(decision["k_export"]) if decision else 0,
            m_total=[int(vm.m_total) for vm in matches],
            collinearity_overflow=coll_overflow,
            views_recollin_exact=n_recollin,
            # the ranks of the run, the views of this rank's range, and
            # the bytes it received from the other ranks, in all and by
            # stage
            num_processes=nproc, views_local=hi - lo,
            gathered_bytes=int(multihost.GATHERED_BYTES - gathered0),
            gathered_by_stage={k: int(v) for k, v in by_stage.items()})
        if "ba_rms_before" in fit_info:
            self.stats["ba_rms_before"] = fit_info["ba_rms_before"]
            self.stats["ba_rms_after"] = fit_info["ba_rms_after"]
        if self.verbose:
            print(f"[L3D] {len(self.result)} 3D lines found! "
                  f"(match {self.stats['t_match']:.2f}s, cluster "
                  f"{self.stats['t_cluster']:.2f}s)")
        return self.result

    def _matching(self, scene, cams):
        """Stages 3 and 4: matching, verification and greedy selection
        (line3D.cc:367-370), with the exactness guard of the matches.
        Returns (matches, best, the capacity decision, the capped pass's
        overflow, views re-matched)."""
        cfg = self.config
        # As in line3d_tpu: with the exactness guard and the capacity probe
        # (the default) one pass, every view at its exact capacity
        # (cudawrapper.cu:923-1007) — lossless, so it equals a pass at the
        # scene-wide capacities the probe counters decide, which are only
        # reported; without the probe a pass at the config's caps, then
        # the overflowing views re-matched; without the guard the capped
        # pass as it is, and a warning.  Every pass selects on the device
        # unless use_sharded_engine is off
        one_pass = cfg.uncapped_fallback and cfg.capacity_probe
        on_device = self.use_sharded_engine
        matches, best, med = engine.run_matching(
            scene, cams, self.neighbors, cfg, verbose=self.verbose,
            capped=not one_pass, device_selection=on_device)
        decision = None
        if one_pass and matches:
            decision = engine.decide_exact_capacities(
                *engine.probe_counters(matches, scene.num_views), cfg,
                max(len(n) for n in self.neighbors), scene.max_segments)
            if decision is not None and self.verbose:
                print(f"[L3D] capacity probe: need "
                      f"{decision['need']} -> m_total "
                      f"{decision['m_total']}, block quota "
                      f"{decision['blockmax']} -> "
                      f"{decision['quota']}, per-neighbor "
                      f"{decision['nbmax']} -> "
                      f"{decision['per_nb_cap']}, export "
                      f"{decision['total']} -> "
                      f"{decision['k_export']}")
        # reference-exactness guard: the match caps can only drop
        # gate-passing matches, so overflow == 0 proves the capped result
        # equals an uncapped run; overflowing views are either re-matched
        # at exact capacity (uncapped_fallback, the default — reference
        # semantics, cudawrapper.cu:923-1007) or warned about
        n_rematched = 0
        overflow_total = sum(vm.overflow for vm in matches)
        if overflow_total:
            if cfg.uncapped_fallback:
                with trace.span("match.fallback"):
                    matches, best, med, n_rematched = \
                        engine.apply_uncapped_fallback(
                            matches, best, med, scene, cams,
                            self.neighbors, cfg, verbose=self.verbose,
                            device_selection=on_device)
            else:
                print(f"[L3D] WARNING: match caps dropped "
                      f"{overflow_total} gate-passing matches across "
                      f"{sum(vm.overflow > 0 for vm in matches)} view(s) "
                      f"(uncapped_fallback off — results may differ from "
                      f"the reference; raise max_matches_per_segment / "
                      f"match_block_quota)")
        self.matches, self.best = matches, best
        return matches, best, decision, overflow_total, n_rematched

    def _fit(self, graph, labels, best, scene, cams, fit_info):
        """The line fits of F-H's clusters (the device refinement or the BA
        when configured, their sizes and the BA's result in fit_info); the
        refined poses un-conditioned into self.refined_poses."""
        cfg = self.config
        with trace.span("fit.lines"):
            result = fit_lines.process_clusters(
                graph, labels, best, self.transform, cfg,
                scene.max_segments, verbose=self.verbose,
                refine=cfg.refine_lines or cfg.bundle_adjust_cameras,
                scene_segments=scene.segments, P_cond=cams.P, cameras=cams,
                device=self.device, out_info=fit_info)
        if "R_cond" in fit_info:
            # un-condition the refined poses: X' = s (R_c X + t_c), so the
            # equivalent original-frame pose of a conditioned camera
            # (R', t') is R_u = R' R_c, t_u = R' t_c + t' / s
            tr = self.transform
            Rp, tp = fit_info["R_cond"], fit_info["t_cond"]
            self.refined_poses = (
                np.einsum("vij,jk->vik", Rp, tr.R),
                np.einsum("vij,j->vi", Rp, tr.t) + tp * tr.scale_inv)
        return result

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
