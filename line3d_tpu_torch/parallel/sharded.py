"""Device-side selection over one view's scored match table.

Torch port of the per-view parts of `line3d_tpu/parallel/sharded.py`: the
packed export word (`export_bits`, `unpack_export`, :35-58) and
`device_select` (:114-183), the selection that `line3d_tpu`'s default
engine runs on the device.  The views mesh, `shard_map`, the chunked
dispatch and the packed float32 row buffer of that module are TPU-only and
left out: the port matches one view at a time on one GPU.

`device_select` reduces a view's [S, M] tables where they live, so only
O(S + verified) values cross to the host, in one int32 buffer
(`unpack_selection` reads it).  The functions run on whatever device the
tensors are on: on a CUDA tensor the selection runs on the card, on a CPU
tensor on the CPU, the same ops either way.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import trace


def export_bits(max_segments: int, n_slots: int):
    """Bit layout of the packed verified-match export word.

    Each exported match is one int32: src_seg | cam_slot | tgt_seg
    (high→low).  Raises ValueError when the three fields need more than 31
    bits.
    """
    sbits = max((max_segments - 1).bit_length(), 1)
    cbits = max((n_slots - 1).bit_length(), 1)
    if 2 * sbits + cbits > 31:
        raise ValueError(
            f"packed export needs {2 * sbits + cbits} bits "
            f"(S={max_segments}, neighbor slots={n_slots}) — exceeds int32")
    return sbits, cbits


def unpack_export(packed: np.ndarray, max_segments: int, n_slots: int):
    """Host-side unpack: packed [K] int32 (≥0) → (src, cam_slot, tgt)."""
    sbits, cbits = export_bits(max_segments, n_slots)
    src = (packed >> (cbits + sbits)).astype(np.int32)
    cam = ((packed >> sbits) & ((1 << cbits) - 1)).astype(np.int32)
    tgt = (packed & ((1 << sbits) - 1)).astype(np.int32)
    return src, cam, tgt


def device_select(cam, tgt, depths, valid, conf, conf_t: float,
                  n_slots: int, overflow=0):
    """Selection over one view's scored match table, on the tables' device:
    the best match per segment, the median depth and the packed identities
    of the verified matches (the device twin of the host selection in
    `match.engine._select_view_outputs`).

    Args:
      cam, tgt: [S, M] int32; depths: [S, M, 4] f32; valid: [S, M] bool;
      conf: [S, M] f32 (the merged table of `match.engine.match_view`,
        ascending in cam * St + tgt within each row).
      conf_t: the confidence threshold; n_slots: the view's neighbor count
        (the width of the export's camera field).
      overflow: the view's overflow count (a device scalar or an int),
        carried in the buffer so that it crosses with the rest.

    Best match: keep = valid & (conf > conf_t), argmax with the FIRST
    maximum.  Median depth (cudawrapper.cu:1025-1076): the raw argmax over
    `valid`; the (d1, d2) pairs of the rows whose raw maximum clears
    conf_t / 2, sorted with +inf for the other rows, and element nh (nh =
    such rows), as the host's np.sort(dall)[len // 2] with len = 2 nh.
    Export: every kept slot's packed word in row-major order.  The rows are
    ascending in cam * St + tgt, so row-major order is ascending packed
    order, the order of `line3d_tpu`'s sorted export.

    The export is the reference's unbounded list (cudawrapper.cu:923-1007),
    as in the port's engine: there is no `k_export` cap, so nothing is
    dropped and no `export_drop` is counted.  `line3d_tpu`'s sharded engine
    caps its export at k_export and adds what the cap drops to `overflow`
    (sharded.py:103-104); its exact mode sizes k_export from the
    gate-passing total, a strict bound on the verified count, so it drops
    nothing either and no result differs.

    Returns one int32 buffer [6 S + 4 + n_verified]: best_cam, best_tgt,
    best_has, the bits of best_conf, best d1, best d2 ([S] each); the bits
    of the median, median_has, n_verified, overflow; the packed export
    (`unpack_selection` reads it).  The one host synchronisation is the
    kept count's readback (`trace.readback`), which sizes the export.
    """
    S = cam.shape[0]
    dev = cam.device
    i32 = torch.int32
    keep = valid & (conf > conf_t)
    ninf = -float("inf")
    best_m = torch.where(keep, conf, ninf).argmax(dim=1, keepdim=True)
    best_conf = conf.gather(1, best_m)[:, 0]
    best_cam = cam.gather(1, best_m)[:, 0]
    best_tgt = tgt.gather(1, best_m)[:, 0]
    best_has = keep.gather(1, best_m)[:, 0]
    best_d = depths[:, :, :2].gather(
        1, best_m[:, :, None].expand(S, 1, 2))[:, 0]            # [S, 2]

    raw_keyed = torch.where(valid, conf, ninf)
    raw_m = raw_keyed.argmax(dim=1, keepdim=True)
    raw_max = raw_keyed.gather(1, raw_m)[:, 0]
    raw_d = depths[:, :, :2].gather(
        1, raw_m[:, :, None].expand(S, 1, 2))[:, 0]             # [S, 2]
    has_raw = raw_max > conf_t * 0.5
    nh = has_raw.sum()
    dsorted = torch.where(has_raw[:, None], raw_d, float("inf")) \
        .reshape(-1).sort().values
    median = dsorted.gather(0, nh.clamp(max=dsorted.numel() - 1).view(1))

    sbits, cbits = export_bits(S, n_slots)
    src_plane = torch.arange(S, dtype=i32, device=dev)[:, None]
    packed_plane = (src_plane << (cbits + sbits)) | (cam << sbits) | tgt
    n_keep = keep.sum(dtype=i32)
    n = int(trace.readback(n_keep, "match.count"))
    at = torch.nonzero_static(keep.reshape(-1), size=n)[:, 0]
    exp_packed = packed_plane.reshape(-1)[at]

    floats = torch.stack([best_conf, best_d[:, 0], best_d[:, 1]])
    scalars = torch.stack([
        median.view(i32)[0], (nh > 0).to(i32), n_keep,
        torch.as_tensor(overflow, device=dev).to(i32)])
    return torch.cat([best_cam.to(i32), best_tgt.to(i32), best_has.to(i32),
                      floats.view(i32).reshape(-1), scalars,
                      exp_packed.to(i32)])


def unpack_selection(buf: np.ndarray, S: int) -> dict:
    """Host-side inverse of `device_select`'s buffer: a dict of best_cam,
    best_tgt [S] int32, best_has [S] bool, best_conf [S] f32, best_depths
    [S, 2] f32, median_depth (float32), median_has (bool), n_verified,
    overflow (int) and exp_packed [n_verified] int32."""
    buf = np.asarray(buf, np.int32)
    f = buf[3 * S:6 * S].view(np.float32)
    n_verified = int(buf[6 * S + 2])
    exp_packed = buf[6 * S + 4:]
    if len(exp_packed) != n_verified:
        raise ValueError(f"selection buffer holds {len(exp_packed)} "
                         f"exported matches, n_verified is {n_verified}")
    return dict(best_cam=buf[:S], best_tgt=buf[S:2 * S],
                best_has=buf[2 * S:3 * S].astype(bool),
                best_conf=f[:S], best_depths=np.stack([f[S:2 * S],
                                                       f[2 * S:]], axis=1),
                median_depth=buf[6 * S:6 * S + 1].view(np.float32)[0],
                median_has=bool(buf[6 * S + 1]), n_verified=n_verified,
                overflow=int(buf[6 * S + 3]), exp_packed=exp_packed)
