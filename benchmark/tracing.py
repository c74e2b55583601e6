"""Reading a torch.profiler trace of one model: the card's busy time as
the union of its device intervals, device time by op name, and the idle
gaps named by the benchmark's span (around each call into a pipeline
layer) that the host was inside."""
from __future__ import annotations

from collections import defaultdict


def union_seconds(intervals) -> float:
    """Length of the union of [start, end) intervals (any unit in, the
    same unit out): overlapping intervals, as on two streams, count once."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def gaps(intervals, start, end):
    """The idle stretches of [start, end) that no interval covers."""
    out, t = [], start
    for s, e in sorted(intervals):
        if s > t:
            out.append((t, s))
        t = max(t, e)
    if end > t:
        out.append((t, end))
    return out


def summarize(device, spans, start_us, end_us, top=10):
    """device: [(name, start_us, end_us)] of device ops; spans: [(name,
    start_us, end_us)] of the host spans.  Returns busy seconds, device
    seconds by op name, and the breakdown's two lists (at most `top` each):
    the ops with most device time, and the idle seconds by the innermost
    host span each idle stretch falls in."""
    iv = [(s, e) for _, s, e in device]
    busy = union_seconds(iv) / 1e6
    by_op = defaultdict(float)
    for n, s, e in device:
        by_op[n] += (e - s) / 1e6
    idle = defaultdict(float)
    inner = sorted(spans, key=lambda x: x[2] - x[1])
    for s, e in gaps(iv, start_us, end_us):
        mid = (s + e) / 2
        name = next((n for n, a, b in inner if a <= mid < b), "outside spans")
        idle[name] += (e - s) / 1e6
    ops = sorted(by_op.items(), key=lambda kv: -kv[1])[:top]
    idl = sorted(idle.items(), key=lambda kv: -kv[1])[:top]
    return busy, dict(by_op), {"device_ops": [[n[:120], v] for n, v in ops],
                               "idle_gaps": [[n, v] for n, v in idl]}


def profiler_events(prof):
    """(device ops, host spans named bench.*) of a finished profiler, as
    (name, start_us, end_us).  The profiler copies each host span onto the
    device's timeline as an annotation; those are not device work."""
    from torch.autograd import DeviceType
    device, spans = [], []
    for e in prof.events():
        tr = e.time_range
        if e.name.startswith("bench."):
            if e.device_type != DeviceType.CUDA:
                spans.append((e.name[len("bench."):], tr.start, tr.end))
        elif e.device_type == DeviceType.CUDA:
            device.append((e.name, tr.start, tr.end))
    return device, spans
