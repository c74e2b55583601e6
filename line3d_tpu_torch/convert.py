"""Carry the reference's scene state into the port.

The system has no weights: a scene's padded segments and its cameras are
its whole state.  `scene_from_reference` takes `line3d_tpu`'s `Scene` and
`CameraSet` by duck typing (their numpy fields) and returns the port's, and
`affinity_graph_from_reference` does the same for a clustering-stage
`AffinityGraph`, so both packages can be fed bit-identical inputs.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from .cluster.affinity import AffinityGraph
from .config import L3DConfig
from .core.cameras import CameraSet
from .scene import Scene


def cameras_from_reference(cameras) -> CameraSet:
    """The port's CameraSet with the same K, R, t, image sizes, uncertainty
    settings and median depths (derived matrices are recomputed with the
    same float64 numpy code, so they are bit-identical)."""
    return CameraSet(
        K=np.array(cameras.K, np.float64), R=np.array(cameras.R, np.float64),
        t=np.array(cameras.t, np.float64),
        width=np.array(cameras.width), height=np.array(cameras.height),
        median_depth=np.array(cameras.median_depth, np.float64),
        uncertainty_lower_px=cameras.uncertainty_lower_px,
        uncertainty_upper_px=cameras.uncertainty_upper_px)


def _config_from_reference(cfg) -> L3DConfig:
    """The port's L3DConfig with the reference's values.  A reference field
    the port has no counterpart of must hold its default, the behaviour the
    port implements (its collinearity maps, for one, are always exact);
    any other value raises."""
    own = {f.name for f in dataclasses.fields(L3DConfig)}
    for f in dataclasses.fields(cfg):
        if f.name not in own and getattr(cfg, f.name) != f.default:
            raise ValueError(f"{f.name}={getattr(cfg, f.name)!r} has no "
                             "counterpart in the port, which implements "
                             f"only its default {f.default!r}")
    return L3DConfig(**{k: v for k, v in dataclasses.asdict(cfg).items()
                        if k in own})


def scene_from_reference(scene, cameras, device="cuda"):
    """(Scene, CameraSet) of the port from the reference's, with the scene's
    tensors on `device`."""
    cams = cameras_from_reference(cameras)
    cfg = getattr(scene, "config", None)
    config = L3DConfig() if cfg is None else _config_from_reference(cfg)
    out = Scene(segments=np.array(scene.segments, np.float32),
                seg_mask=np.array(scene.seg_mask, bool),
                seg_count=np.array(scene.seg_count, np.int32),
                cameras=cams,
                wp_lists=None if scene.wp_lists is None
                else [list(w) for w in scene.wp_lists],
                config=config, device=device)
    return out, cams


def affinity_graph_from_reference(graph) -> AffinityGraph:
    """The port's AffinityGraph with copies of the reference graph's edge
    list and node tables (same dtypes, same order)."""
    return AffinityGraph(
        edges_i=np.array(graph.edges_i, np.int32),
        edges_j=np.array(graph.edges_j, np.int32),
        edges_w=np.array(graph.edges_w, np.float32),
        node_view=np.array(graph.node_view, np.int32),
        node_seg=np.array(graph.node_seg, np.int32),
        num_nodes=int(graph.num_nodes))
