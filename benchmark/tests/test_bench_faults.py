"""A whole run on the CPU at a tiny size, the look for a card skipped:
sound, it comes out correct; with the timed path broken underneath in
each way a cell can break, it does not."""
import contextlib

import numpy as np
import pytest

from helpers import small_cell
from benchmark import run


@contextlib.contextmanager
def patched(module, name, make):
    orig = getattr(module, name)
    setattr(module, name, make(orig))
    try:
        yield
    finally:
        setattr(module, name, orig)


def answer_altered():
    """Each best match's first depth 1% off where the selection makes it."""
    from line3d_tpu_torch.match import engine

    def make(orig):
        def f(scene, cams, v, bs, d1, d2, *a):
            return orig(scene, cams, v, bs, np.asarray(d1) * 1.01, d2, *a)
        return f
    return patched(engine, "_best_rows_f64", make)


def half_the_views():
    """The match step leaves out every other view."""
    from line3d_tpu_torch.match import engine

    def make(orig):
        def f(ctx, neighbors, views, *a, **k):
            return orig(ctx, neighbors, [v for v in views if v % 2 == 0],
                        *a, **k)
        return f
    return patched(engine, "match_views", make)


def clusters_unchanged():
    """F-H returns its starting state: every node its own cluster."""
    from line3d_tpu_torch.cluster import fh

    def make(orig):
        def f(ei, ej, ew, n, *a, **k):
            return np.arange(n, dtype=np.int64)
        return f
    return patched(fh, "fh_cluster", make)


def diffusion_unchanged():
    """The diffusion returns the graph it was given."""
    from line3d_tpu_torch.cluster import diffusion

    def make(orig):
        def f(graph, *a, **k):
            return graph
        return f
    return patched(diffusion, "run_diffusion", make)


def sound():
    return contextlib.nullcontext()


CELLS = ["facade_p25.exact", "clutter_p25.exact", "facade_p25.noisy"]
CASES = [(c, sound, True) for c in CELLS] + \
    [(c, f, False) for c in CELLS
     for f in (answer_altered, half_the_views, clusters_unchanged)] + \
    [("facade_p25.noisy", diffusion_unchanged, False)]


@pytest.mark.parametrize("cell,fault,want", CASES,
                         ids=[f"{c}-{f.__name__}" for c, f, _ in CASES])
def test_a_broken_path_comes_out_incorrect(cell, fault, want):
    spec = small_cell(cell)
    with fault():
        res = run.run_cell(spec, seed=2 ** 31 + 77, seconds=0.0,
                           trace=False, device="cpu")
    assert res["attempted"] == 1 and res["failed"] == 0
    assert res["correct"] is want, res["checks"]
    assert list(res)[-1] == "checks"
