"""The port's recorder: spans, counters and host readbacks.

    from line3d_tpu_torch import trace
    with trace.recording():
        l3d.compute_3d_model()
        torch.cuda.synchronize()
        summary = trace.collect()

Off is the default.  Then `span` returns one shared null context (no
profiler annotation, no event, no allocation) and `count` returns at
once.  Two things run whether it is on or off:
  * `stage` spans (the pipeline's stages, the affinity stage's parts)
    time themselves on the host clock into `SECONDS`, from which
    `Line3D.stats["t_*"]` are taken;
  * `readback`, the one route by which the main path turns a device tensor
    into host data, adds its synchronisation and bytes to `SYNCS` and
    `DTOH_BYTES` and the nanoseconds the host waited in it to its site's
    entry of `WAIT_NS`.
On, every span also records its parent, the model it belongs to and its
host start and end, and opens `torch.profiler.record_function("l3d." +
name)`, so that under a profiler the program's spans share the device
activity's clock; a span given a CUDA device records a pair of timing
events on that device's current stream, read only in `collect()` after
the caller's own synchronize.  `readback` then also counts its site
(`syncs.<site>`, `dtoh_bytes.<site>`) and times its wait as a span
`wait.<site>`.  `collect()`, inside the `recording()` block, gives the
spans and counters recorded since the block began or the last collect;
leaving the block drops what was not collected.
"""
from __future__ import annotations

import contextlib
import threading
import time

import torch

_ON = False
_NULL = contextlib.nullcontext()

# always counted: host synchronisations and device-to-host bytes of every
# readback, and the host's nanoseconds waiting in them by site
SYNCS = 0
DTOH_BYTES = 0
WAIT_NS: dict = {}
# host seconds of the latest run of each stage span (cleared per model)
SECONDS: dict = {}

_spans: list = []          # span records, in the order they opened
_counts: dict = {}
_model = 0                 # id of the latest model
_local = threading.local() # each thread's stack of open spans


class _Span:
    """A span; a stage span (`stage` true) times itself even when off."""
    __slots__ = ("name", "dev", "stage", "rec", "fn", "t0")

    def __init__(self, name, device=None, stage=False):
        self.name, self.dev, self.stage, self.rec = name, device, stage, None

    def __enter__(self):
        if _ON:
            stack = _local.__dict__.setdefault("stack", [])
            self.rec = rec = dict(name=self.name, model=_model,
                                  parent=stack[-1]["id"] if stack else None,
                                  id=len(_spans), ev=None)
            _spans.append(rec)
            stack.append(rec)
            self.fn = torch.profiler.record_function("l3d." + self.name)
            self.fn.__enter__()
            if self.dev is not None and self.dev.type == "cuda":
                rec["ev"] = [torch.cuda.Event(enable_timing=True)
                             for _ in range(2)]
                rec["ev"][0].record(torch.cuda.current_stream(self.dev))
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter_ns()
        rec = self.rec
        if rec is not None:
            if rec["ev"] is not None:
                rec["ev"][1].record(torch.cuda.current_stream(self.dev))
            self.fn.__exit__(*exc)
            rec["t0"], rec["t1"] = self.t0, t1
            _local.stack.pop()
            self.rec = None
        if self.stage:
            SECONDS[self.name] = (t1 - self.t0) / 1e9
        return False


def span(name: str, device=None):
    """A span named `name`; with a CUDA `device` (a torch.device) also timed
    on that device.  Off: the shared null context."""
    if not _ON:
        return _NULL
    return _Span(name, device)


def stage(name: str):
    """A stage span: timed on the host clock into SECONDS[name] whether the
    recorder is on or off, and a span when it is on."""
    return _Span(name, stage=True)


class _Model(_Span):
    """The `model` stage: a new model id and SECONDS cleared."""
    __slots__ = ()

    def __init__(self):
        super().__init__("model", stage=True)

    def __enter__(self):
        global _model
        _model += 1
        SECONDS.clear()
        return super().__enter__()


def model():
    """The stage span around one compute_3d_model."""
    return _Model()


def count(name: str, n: int = 1):
    """Add n to the integer counter `name` (when on)."""
    if _ON:
        _counts[name] = _counts.get(name, 0) + int(n)


def readback(x: torch.Tensor, site: str, out: torch.Tensor | None = None):
    """x on the host as a numpy array (x.cpu().numpy(): a copy from a device,
    x's own memory on the CPU), counted as one synchronisation and
    x.nbytes bytes under `site`, on any device.  `out`, a host tensor of
    x's shape and dtype (pinned, for a copy at the link's full rate),
    receives the copy; the array is then out's memory."""
    global SYNCS, DTOH_BYTES
    nbytes = x.numel() * x.element_size()
    SYNCS += 1
    DTOH_BYTES += nbytes
    t0 = time.perf_counter_ns()
    if _ON:
        count("syncs." + site)
        count("dtoh_bytes." + site, nbytes)
    with _Span("wait." + site) if _ON else _NULL:
        arr = x.cpu().numpy() if out is None else out.copy_(x).numpy()
    WAIT_NS[site] = WAIT_NS.get(site, 0) + time.perf_counter_ns() - t0
    return arr


def enabled() -> bool:
    return _ON


@contextlib.contextmanager
def recording():
    """The recorder on inside the block, with nothing kept from before it
    or after it: `collect()` inside the block."""
    global _ON
    prev = _ON
    collect()
    _ON = True
    try:
        yield
    finally:
        _ON = prev
        _spans.clear()
        _counts.clear()


def collect() -> dict:
    """The spans recorded since the last collect and the counters, all
    cleared.  A span is {id, name, parent (the parent's id or None), model,
    start_s, end_s (time.perf_counter_ns over 1e9), host_s, device_s (None
    without events)}; a span still open has no times.  Call after
    synchronizing the devices the spans timed: their events are read
    here."""
    spans = []
    for r in _spans:
        ev, done = r["ev"], "t1" in r
        if ev is not None and done:
            ev[1].synchronize()
        spans.append(dict(
            id=r["id"], name=r["name"], parent=r["parent"], model=r["model"],
            start_s=r["t0"] / 1e9 if done else None,
            end_s=r["t1"] / 1e9 if done else None,
            host_s=(r["t1"] - r["t0"]) / 1e9 if done else None,
            device_s=ev[0].elapsed_time(ev[1]) / 1e3
            if ev is not None and done else None))
    counters = dict(_counts)
    _spans.clear()
    _counts.clear()
    return dict(spans=spans, counters=counters)
