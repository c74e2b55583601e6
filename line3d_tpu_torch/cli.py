"""Command-line entry points: the bundler and VisualSfM front-ends.

Flag-compatible with the reference executables (main_bundler.cpp:36-78,
main_vsfm.cpp flags) including the parameter-stamped output filename
(main_bundler.cpp:302-327), and with `line3d_tpu.cli`: the same flags,
defaults, `[SYS]` lines and file names, so one command line runs in both
packages.

    python -m line3d_tpu_torch.cli bundler -i <folder> [-o out] [-w W] ...
    python -m line3d_tpu_torch.cli vsfm   -i <nvm file> -m <image folder> ...

Where this module differs from `line3d_tpu.cli`:
  * `--device` (default `cuda`): the device of the matching, collinearity
    and, when enabled, diffusion / refinement / bundle-adjustment stages.
    Without CUDA the run raises unless `--device cpu` is given.  Detection
    is a host stage either way.
  * `--stable_shapes` is accepted and ignored: it steers the TPU package's
    shape buckets and pre-compiles, which the port does not have.  For the
    same reason all images are added through `add_images_parallel` at once
    (no first image detected inline to size a warm-up), and there is no
    persistent compilation cache.
  * `--profile_dir` writes a `torch.profiler` Chrome trace
    (`line3d_trace.json`) of `compute_3d_model` into the directory, with
    the recorder (`trace.py`) on, so that the program's spans (`l3d.*`:
    the stages, the match step's parts, every readback's wait) lie on the
    trace's timeline beside the device activity.
"""
from __future__ import annotations

import argparse
import contextlib
import os
import sys

from .config import L3DConfig
from .pipeline import Line3D
from .io import bundler as bundler_io, nvm as nvm_io, images as img_io


def _parse_bool(s: str) -> bool:
    """Reference-compatible bool flags: TCLAP parses '-d 0' as false and
    '-d 1' as true (istream >> bool); accept the common spellings both
    ways instead of treating everything but 'false' as true."""
    v = s.strip().lower()
    if v in ("1", "true", "yes", "on"):
        return True
    if v in ("0", "false", "no", "off"):
        return False
    raise argparse.ArgumentTypeError(f"expected a boolean, got {s!r}")


def _add_common_flags(ap: argparse.ArgumentParser):
    d = L3DConfig()
    ap.add_argument("-o", "--output_folder", default="")
    ap.add_argument("-w", "--max_image_width", type=int,
                    default=d.max_image_width)
    ap.add_argument("-n", "--num_matching_neighbors", type=int,
                    default=d.matching_neighbors)
    ap.add_argument("-a", "--reprojection_error_lower_bound", type=float,
                    default=d.uncertainty_lower_px)
    ap.add_argument("-b", "--reprojection_error_upper_bound", type=float,
                    default=d.uncertainty_upper_px)
    ap.add_argument("-g", "--sigma_a", type=float, default=d.sigma_a)
    ap.add_argument("-p", "--sigma_p", type=float, default=d.sigma_p)
    ap.add_argument("-d", "--diffusion", type=_parse_bool,
                    default=d.perform_diffusion)
    ap.add_argument("-v", "--verbose", type=_parse_bool,
                    default=False)
    ap.add_argument("-l", "--load_and_store_flag",
                    type=_parse_bool,
                    default=d.load_and_store_segments)
    ap.add_argument("-e", "--collinearity_flag",
                    type=_parse_bool,
                    default=d.use_collinearity)
    ap.add_argument("-x", "--min_image_baseline", type=float,
                    default=d.min_baseline)
    ap.add_argument("-r", "--refine", type=_parse_bool,
                    default=d.refine_lines,
                    help="bundle-adjust 3D lines against member segments "
                         "(extension; no reference equivalent)")
    ap.add_argument("--ba", type=_parse_bool,
                    default=d.bundle_adjust_cameras,
                    help="joint camera+line bundle adjustment: refine "
                         "6-DoF poses and lines together (Schur-eliminated "
                         "line blocks, fit/bundle.py; extension — implies "
                         "-r; refined poses are reported in the run "
                         "summary)")
    ap.add_argument("--detect_workers", type=int, default=0,
                    help="threads for parallel image load/undistort/detect "
                         "(0 = auto; the reference detects sequentially)")
    ap.add_argument("--stable_shapes", type=_parse_bool,
                    default=True,
                    help="accepted for command lines shared with "
                         "line3d_tpu.cli and ignored (TPU shape buckets)")
    ap.add_argument("--device", default="cuda",
                    help="device of the matching and collinearity stages: "
                         "cuda (default; raises without a GPU) or cpu")
    ap.add_argument("--profile_dir", default="",
                    help="capture a torch.profiler Chrome trace of the "
                         "model computation into this directory, with "
                         "the program's l3d.* spans (line3d_trace.json; "
                         "open in a trace viewer)")
    ap.add_argument("--debug_ply", type=_parse_bool, default=False,
                    help="additionally dump the 3D line model as an ASCII "
                         "PLY line set (the reference ships this only as "
                         "commented debug code, line3D.cc:650-694)")


def _config_from_args(args) -> L3DConfig:
    return L3DConfig(
        max_image_width=args.max_image_width,
        matching_neighbors=args.num_matching_neighbors,
        uncertainty_lower_px=abs(args.reprojection_error_lower_bound),
        uncertainty_upper_px=abs(args.reprojection_error_upper_bound),
        sigma_a=abs(args.sigma_a), sigma_p=abs(args.sigma_p),
        perform_diffusion=args.diffusion,
        load_and_store_segments=args.load_and_store_flag,
        use_collinearity=args.collinearity_flag,
        min_baseline=abs(args.min_image_baseline),
        refine_lines=args.refine,
        bundle_adjust_cameras=args.ba)


def _result_stem(args) -> str:
    """Parameter-stamped result name (main_bundler.cpp:302-327)."""
    n = args.num_matching_neighbors
    # the reference stamps the fabs()'d values (main_bundler.cpp:86-94)
    parts = [
        "line3D_result_",
        f"W_{args.max_image_width}_",
        "N_ALL_" if n < 0 else f"N_{n}_",
        f"tL_{abs(args.reprojection_error_lower_bound):g}_",
        f"tU_{abs(args.reprojection_error_upper_bound):g}_",
        f"sigmaP_{abs(args.sigma_p):g}_",
        f"sigmaA_{abs(args.sigma_a):g}_",
        "COLLIN_" if args.collinearity_flag else "NO_COLLIN_",
        "DIFFUSION" if args.diffusion else "NO_DIFFUSION",
    ]
    return "_".join(parts)


@contextlib.contextmanager
def _trace(profile_dir: str, device):
    """torch.profiler around the block, exported as a Chrome trace into
    `profile_dir`, with the recorder on (`trace.recording`: the program's
    spans appear as `l3d.<name>`); no profiler without a directory.  The
    hand-written kernels appear under their own names
    (`collin_pairs_kernel`, `pair_kernel`, `score_kernel`) although they
    are launched through ctypes.  The first trace a process takes, which
    is what one run of the CLI is, records every device event; later
    traces of one process were seen to lose their first device events."""
    if not profile_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile
    from . import trace
    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(profile_dir, exist_ok=True)
    with trace.recording(), profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(profile_dir, "line3d_trace.json"))


def _finish(l3d: Line3D, args, output_folder: str):
    with _trace(args.profile_dir, l3d.device):
        result = l3d.compute_3d_model(perform_diffusion=args.diffusion)
    stem = os.path.join(output_folder, _result_stem(args))
    l3d.save_3d_lines_as_stl(result, stem + ".stl")
    l3d.save_3d_lines_as_txt(result, stem + ".txt")
    if args.debug_ply:
        from .utils import visualize
        visualize.save_ply(result, stem + ".ply")
    num_segs = sum(len(r.segments3d) for r in result)
    print(f"[SYS] 3D lines:        {len(result)}")
    print(f"[SYS] 3D segments:     {num_segs}")
    print(f"[SYS] #images:         {l3d.num_cameras()}")
    st = l3d.stats
    print("[SYS] stage seconds:   "
          + " ".join(f"{k[2:]}={st[k]:.2f}" for k in
                     ("t_detect", "t_setup", "t_graph", "t_match",
                      "t_cluster", "t_total") if k in st))
    if st.get("t_cluster", 0.0) >= 1.0:
        print("[SYS] cluster breakdown: "
              + " ".join(f"{k[2:]}={st[k]:.2f}" for k in
                         ("t_affinity", "t_diffusion", "t_fh", "t_fit")
                         if k in st))
    extras = {k: st[k] for k in ("match_overflow",
                                 "views_rematched_uncapped",
                                 "collinearity_overflow",
                                 "views_recollin_exact") if st.get(k)}
    if extras:
        print(f"[SYS] exactness:       {extras}")
    if st.get("probe_m_total"):
        print(f"[SYS] capacity probe:  m_total={st['probe_m_total']} "
              f"quota={st['probe_quota']} k_export={st['probe_k_export']}")
    if st.get("ba_rms_before") is not None:
        print(f"[SYS] camera BA:       reprojection rms "
              f"{st['ba_rms_before']:.3f} -> {st['ba_rms_after']:.3f} px "
              f"(poses on Line3D.refined_poses)")
    return stem


def _add_all(l3d: Line3D, args, prepared):
    """Register all images; detection runs on the host thread pool (the
    reference detects strictly sequentially, line3D.cc:95-217)."""
    if prepared:
        l3d.add_images_parallel(
            prepared, max_img_width=args.max_image_width,
            load_and_store_segments=args.load_and_store_flag,
            workers=args.detect_workers or None)


def _line3d(args, output_folder: str) -> Line3D:
    os.makedirs(output_folder, exist_ok=True)
    return Line3D(config=_config_from_args(args), device=args.device,
                  verbose=args.verbose,
                  data_directory=os.path.join(output_folder, "L3D_data"))


def main_bundler(argv=None):
    ap = argparse.ArgumentParser("line3d-torch-bundler")
    ap.add_argument("-i", "--input_folder", required=True,
                    help="folder that contains the bundle.rd.out file")
    _add_common_flags(ap)
    args = ap.parse_args(argv)

    output_folder = args.output_folder or os.path.join(args.input_folder,
                                                       "Line3D")
    l3d = _line3d(args, output_folder)

    ds = bundler_io.load_bundler_scene(args.input_folder)
    print(f"[SYS] num_cameras: {len(ds.focal)}")

    def loader(i):
        def _load():
            img = img_io.load_image(ds.image_paths[i])
            K = img_io.make_K(ds.focal[i], img.shape[1], img.shape[0])
            d1, d2 = ds.distortion[i]
            return img_io.undistort(img, K, d1, d2)
        return _load

    prepared = []
    for i in range(len(ds.focal)):
        if ds.image_paths[i] is None:
            print(f"[SYS] warning: no image found for cam {i}")
            continue
        if len(ds.wp_lists[i]) == 0:
            print(f"[SYS] skipping unlinked image {i}")
            continue
        w, h = img_io.image_size(ds.image_paths[i])
        K = img_io.make_K(ds.focal[i], w, h)
        prepared.append((i, loader(i), K, ds.R[i], ds.t[i], ds.wp_lists[i]))
    _add_all(l3d, args, prepared)
    _finish(l3d, args, output_folder)


def main_vsfm(argv=None):
    ap = argparse.ArgumentParser("line3d-torch-vsfm")
    ap.add_argument("-i", "--nvm_file", required=True)
    ap.add_argument("-m", "--image_folder", default="",
                    help="folder with the images (default: NVM file folder)")
    _add_common_flags(ap)
    args = ap.parse_args(argv)

    image_folder = args.image_folder or os.path.dirname(args.nvm_file)
    output_folder = args.output_folder or os.path.join(image_folder, "Line3D")
    l3d = _line3d(args, output_folder)

    ds = nvm_io.load_nvm_scene(args.nvm_file)
    print(f"[SYS] num_cameras: {len(ds.focal)}")

    def loader(i, path):
        def _load():
            img = img_io.load_image(path)
            K = img_io.make_K(ds.focal[i], img.shape[1], img.shape[0])
            # single-coefficient model, negated (main_vsfm.cpp:259)
            return img_io.undistort(img, K, -ds.distortion[i])
        return _load

    prepared = []
    for i in range(len(ds.focal)):
        if len(ds.wp_lists[i]) == 0:
            print(f"[SYS] skipping unlinked image {i}")
            continue
        path = os.path.join(image_folder, ds.image_names[i])
        w, h = img_io.image_size(path)
        K = img_io.make_K(ds.focal[i], w, h)
        prepared.append((i, loader(i, path), K, ds.R[i], ds.t[i],
                         ds.wp_lists[i]))
    _add_all(l3d, args, prepared)
    _finish(l3d, args, output_folder)


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] not in ("bundler", "vsfm"):
        print("usage: python -m line3d_tpu_torch.cli {bundler|vsfm} ...",
              file=sys.stderr)
        return 2
    if argv[0] == "bundler":
        return main_bundler(argv[1:])
    return main_vsfm(argv[1:])


if __name__ == "__main__":
    sys.exit(main())
