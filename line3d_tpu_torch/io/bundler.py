"""Bundler `bundle.rd.out` dataset loader (numpy copy of
`line3d_tpu/io/bundler.py`).

Mirrors the reference CLI's parsing (main_bundler.cpp:109-237): camera blocks
(focal + 2 radial distortion coefficients, 3x3 rotation with rows 2-3
sign-flipped, translation with y/z sign-flipped), worldpoint view lists, and
`visualize/%08d.{jpg,png,...}` image discovery.
"""
from __future__ import annotations

import dataclasses
import os

import numpy as np


@dataclasses.dataclass
class BundlerScene:
    focal: np.ndarray            # [V]
    distortion: np.ndarray       # [V, 2]
    R: np.ndarray                # [V, 3, 3]
    t: np.ndarray                # [V, 3]
    wp_lists: list               # per view: list of worldpoint ids
    image_paths: list            # per view: path or None


def parse_bundle_file(path: str):
    """Parse bundle.rd.out; returns (focal, distortion, R, t, wp_lists)."""
    with open(path) as f:
        tokens = f.read().split()
    p = 0
    if tokens and tokens[0].startswith("#"):
        # header line "# Bundle file v0.3" — token split already removed
        # newlines; the reference skips the first LINE.  Re-read properly:
        with open(path) as f:
            lines = f.readlines()
        body = []
        for ln in lines:
            if ln.lstrip().startswith("#"):
                continue
            body.append(ln)
        tokens = " ".join(body).split()

    num_cams = int(tokens[p]); num_points = int(tokens[p + 1]); p += 2
    focal = np.zeros(num_cams)
    dist = np.zeros((num_cams, 2))
    R = np.zeros((num_cams, 3, 3))
    t = np.zeros((num_cams, 3))
    for i in range(num_cams):
        focal[i] = float(tokens[p]); dist[i, 0] = float(tokens[p + 1])
        dist[i, 1] = float(tokens[p + 2]); p += 3
        R[i] = np.array([float(x) for x in tokens[p:p + 9]]).reshape(3, 3)
        p += 9
        t[i] = [float(x) for x in tokens[p:p + 3]]
        p += 3
    # sign flips (main_bundler.cpp:159-176)
    R[:, 1:3, :] *= -1.0
    t[:, 1:3] *= -1.0

    wp_lists = [[] for _ in range(num_cams)]
    for wp in range(num_points):
        p += 3           # position
        p += 3           # color
        num_views = int(tokens[p]); p += 1
        for _ in range(num_views):
            cam = int(tokens[p])  # cam, sift, x, y
            p += 4
            if 0 <= cam < num_cams:
                wp_lists[cam].append(wp)
    return focal, dist, R, t, wp_lists


def discover_images(input_folder: str, num_cams: int) -> list:
    """visualize/%08d.{jpg,JPG,png,PNG,jpeg,JPEG} (main_bundler.cpp:217-237)."""
    exts = [".jpg", ".JPG", ".png", ".PNG", ".jpeg", ".JPEG"]
    out = []
    for i in range(num_cams):
        stem = os.path.join(input_folder, "visualize", f"{i:08d}")
        found = None
        for e in exts:
            if os.path.exists(stem + e):
                found = stem + e
                break
        out.append(found)
    return out


def load_bundler_scene(input_folder: str) -> BundlerScene:
    focal, dist, R, t, wp_lists = parse_bundle_file(
        os.path.join(input_folder, "bundle.rd.out"))
    paths = discover_images(input_folder, len(focal))
    return BundlerScene(focal=focal, distortion=dist, R=R, t=t,
                        wp_lists=wp_lists, image_paths=paths)
