"""The port's CLI end to end on a rendered dataset: wall seconds and
images/s from image files to a 3D line model.

    python3 -m line3d_tpu_torch.utils.cli_bench [--views 25] [--width 1920]
        [--height 1440] [--runs 2] [--keep DIR] [--load_segments]
        [--format bundler|nvm] [--scene facade|house] [--device cpu]

The port's counterpart of `line3d_tpu`'s scripts/cli_bench.py (no JAX).
It renders a synthetic dataset (`render_dataset`: bundler,
`render_nvm_dataset`: VisualSfM NVM_V3) of the facade (realistic match
density) or the house (`make_demo_scene`'s sparse wireframe, detection
bound), then runs `line3d_tpu_torch.cli.main` on it `--runs` times with
`-w <width>` and `--device` (the card by default; without CUDA it raises
unless `--device cpu` is given), each run from fresh caches unless
`--load_segments` keeps them (the cached mode, `-l`).  It prints each run's
seconds and images/s; the last run is the warm one.  The last line is one
JSON object with the runs and the card as `nvidia-smi` names it.

The dataset's `bundle.rd.out` and `scene.nvm` are the JAX script's text
byte for byte for the same scene, image names included.  The images come
from a numpy rasteriser (`render_view`; the script draws with cv2, which
the card's machine lacks), written as binary PGM under the script's file
names (`visualize/%08d.jpg`, `img_%04d.jpg`): the port's image loader, cv2
and PIL all recognise a PGM by its content.
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile
import time

import numpy as np
import torch

from ..config import L3DConfig
from .demo import make_demo_scene, make_facade_scene
from .host_stage_scaling import card_line, require_device
from .visualize import _draw_segment


def render_view(segs, width, height):
    """One view's segments as dark 3 px lines on a light background with a
    soft edge (a 1-2-1 blur in x and y): uint8 [height, width]."""
    img = np.full((height, width), 235, np.uint8)
    for x1, y1, x2, y2 in np.asarray(segs, np.float64):
        _draw_segment(img, x1, y1, x2, y2, 40, 3)
    f = np.pad(img.astype(np.float32), 1, mode="edge")
    f = 0.25 * f[:-2] + 0.5 * f[1:-1] + 0.25 * f[2:]
    f = 0.25 * f[:, :-2] + 0.5 * f[:, 1:-1] + 0.25 * f[:, 2:]
    return np.rint(f).astype(np.uint8)


def write_pgm(path: str, img: np.ndarray):
    """A gray uint8 image as binary PGM (P5)."""
    h, w = img.shape
    with open(path, "wb") as f:
        f.write(f"P5\n{w} {h}\n255\n".encode())
        f.write(np.ascontiguousarray(img, np.uint8).tobytes())


def rot_to_quat(R):
    """(w, x, y, z) of a rotation matrix, the inverse of the NVM loader's
    quat_to_R."""
    tr = np.trace(R)
    if tr > 0:
        s = np.sqrt(tr + 1.0) * 2
        return np.array([0.25 * s, (R[2, 1] - R[1, 2]) / s,
                         (R[0, 2] - R[2, 0]) / s, (R[1, 0] - R[0, 1]) / s])
    i = int(np.argmax(np.diag(R)))
    j, k = (i + 1) % 3, (i + 2) % 3
    s = np.sqrt(R[i, i] - R[j, j] - R[k, k] + 1.0) * 2
    q = np.empty(4)
    q[0] = (R[k, j] - R[j, k]) / s
    q[1 + i] = 0.25 * s
    q[1 + j] = (R[j, i] + R[i, j]) / s
    q[1 + k] = (R[k, i] + R[i, k]) / s
    return q


def wp_views(scene) -> dict:
    """{worldpoint: the views that see it, ascending}."""
    out = {}
    for v in range(scene.num_views):
        for w in scene.wp_lists[v]:
            out.setdefault(w, []).append(v)
    return out


def make_scene(kind: str, num_views: int, width: int, height: int):
    """(Scene, CameraSet) of the script's `_make_scene`, on the CPU (the
    dataset is written from host arrays)."""
    fn = make_facade_scene if kind == "facade" else make_demo_scene
    return fn(num_views=num_views, width=width, height=height,
              focal=0.9 * width, config=L3DConfig(), device="cpu")


def render_images(scene, img_dir: str, name_fn, width: int, height: int):
    """Each view's segments rendered (`render_view`) into img_dir as PGM."""
    os.makedirs(img_dir, exist_ok=True)
    for v in range(scene.num_views):
        write_pgm(os.path.join(img_dir, name_fn(v)),
                  render_view(scene.segments[v][scene.seg_mask[v]], width,
                              height))


def bundle_text(scene, cams, prec: int = 9) -> str:
    """bundle.rd.out (v0.3) of the scene: each view's focal with no
    distortion, R and t with the loader's sign flips undone
    (main_bundler.cpp:159-176) at `prec` decimals, then each worldpoint
    with the views that see it."""
    wpv = wp_views(scene)
    lines = ["# Bundle file v0.3", f"{scene.num_views} {len(wpv)}"]
    for v in range(scene.num_views):
        R, t = cams.R[v].copy(), cams.t[v].copy()
        R[1:3] *= -1.0
        t[1:3] *= -1.0
        lines.append(f"{cams.K[v][0, 0]:.6f} 0 0")
        lines += [" ".join(f"{x:.{prec}f}" for x in R[r]) for r in range(3)]
        lines.append(" ".join(f"{x:.{prec}f}" for x in t))
    for w in sorted(wpv):
        lines += ["0 0 0", "128 128 128",
                  f"{len(wpv[w])}" + "".join(f" {v} 0 0.0 0.0"
                                             for v in wpv[w])]
    return "\n".join(lines) + "\n"


def nvm_text(scene, cams, name_fn, prec: int = 9) -> str:
    """scene.nvm (NVM_V3 as main_vsfm.cpp:121-223 parses it): each view's
    image name `name_fn(v)`, focal, quaternion and center at `prec`
    decimals, no distortion; then each worldpoint with its views."""
    wpv = wp_views(scene)
    lines = ["NVM_V3", "", f"{scene.num_views}"]
    for v in range(scene.num_views):
        lines.append(
            f"{name_fn(v)} {cams.K[v][0, 0]:.6f} "
            + " ".join(f"{x:.{prec}f}" for x in rot_to_quat(cams.R[v])) + " "
            + " ".join(f"{x:.{prec}f}" for x in cams.C[v]) + " 0.0 0")
    lines += ["", f"{len(wpv)}"]
    for w in sorted(wpv):
        lines.append(f"0 0 0 128 128 128 {len(wpv[w])}"
                     + "".join(f" {v} 0 0.0 0.0" for v in wpv[w]))
    return "\n".join(lines) + "\n"


def render_dataset(root: str, num_views: int, width: int, height: int,
                   kind: str = "facade"):
    """A bundler dataset in `root`: visualize/%08d.jpg and bundle.rd.out
    (the script's `render_dataset`).  Returns the scene."""
    scene, cams = make_scene(kind, num_views, width, height)
    render_images(scene, os.path.join(root, "visualize"),
                  lambda v: f"{v:08d}.jpg", width, height)
    with open(os.path.join(root, "bundle.rd.out"), "w") as f:
        f.write(bundle_text(scene, cams))
    return scene


def render_nvm_dataset(root: str, num_views: int, width: int, height: int,
                       kind: str = "facade"):
    """An NVM_V3 dataset in `root`: img_%04d.jpg and scene.nvm (the
    script's `render_nvm_dataset`).  Returns the scene."""
    scene, cams = make_scene(kind, num_views, width, height)

    def name(v):
        return f"img_{v:04d}.jpg"
    render_images(scene, root, name, width, height)
    with open(os.path.join(root, "scene.nvm"), "w") as f:
        f.write(nvm_text(scene, cams, name))
    return scene


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--views", type=int, default=25)
    ap.add_argument("--width", type=int, default=1920)
    ap.add_argument("--height", type=int, default=1440)
    ap.add_argument("--runs", type=int, default=2)
    ap.add_argument("--keep", default=None,
                    help="reuse/keep the dataset directory")
    ap.add_argument("--load_segments", action="store_true",
                    help="benchmark the cached re-run mode (-l)")
    ap.add_argument("--format", choices=("bundler", "nvm"),
                    default="bundler")
    ap.add_argument("--scene", choices=("facade", "house"),
                    default="facade",
                    help="facade = realistic density (exact-path bound); "
                         "house = sparse wireframe (detection bound)")
    ap.add_argument("--device", default="cuda",
                    help="the CLI's --device (default: the card; raises "
                    "without CUDA)")
    args = ap.parse_args(argv)
    require_device(args.device, "cli_bench")
    from .. import cli

    root = args.keep or tempfile.mkdtemp(prefix="cli_bench_")
    marker = os.path.join(root, "bundle.rd.out" if args.format == "bundler"
                          else "scene.nvm")
    if not os.path.exists(marker):
        print(f"[cli_bench] rendering {args.views} views "
              f"{args.width}x{args.height} ({args.format}) into {root}",
              flush=True)
        render_fn = render_dataset if args.format == "bundler" \
            else render_nvm_dataset
        render_fn(root, args.views, args.width, args.height,
                  kind=args.scene)

    cli_args = (["bundler", "-i", root] if args.format == "bundler"
                else ["vsfm", "-i", os.path.join(root, "scene.nvm")])
    runs = []
    try:
        for run in range(args.runs):
            # fresh caches unless benchmarking the cached mode
            l3d_dir = os.path.join(root, "Line3D")
            if not args.load_segments and os.path.exists(l3d_dir):
                shutil.rmtree(l3d_dir)
            t0 = time.perf_counter()
            cli.main(cli_args + ["-w", str(args.width), "--device",
                                 args.device])
            if torch.device(args.device).type == "cuda":
                torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            runs.append(dt)
            print(f"[cli_bench] run {run}: {dt:.2f} s "
                  f"({args.views / dt:.1f} images/s)", flush=True)
    finally:
        if not args.keep:
            shutil.rmtree(root, ignore_errors=True)
    dev = torch.device(args.device)
    print(json.dumps(dict(
        views=args.views, width=args.width, height=args.height,
        format=args.format, scene=args.scene,
        load_segments=args.load_segments, device=str(dev),
        card=card_line(dev), run_s=runs,
        images_per_s=[args.views / t for t in runs])), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
