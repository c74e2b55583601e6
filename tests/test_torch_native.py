"""The port's native host library stands on the port's own sources.

`line3d_tpu_torch/native/` holds byte-for-byte copies of the JAX package's
`fh_cluster.cpp` and `affinity_enum.cpp`; `native/load.py` builds only
those, and a copy of `line3d_tpu_torch/` alone (no `line3d_tpu/` beside
it, no `_build/`) builds the library into itself and runs F-H and the line
fit."""
import os
import shutil
import subprocess
import sys
import textwrap

import pytest

from line3d_tpu_torch.native import load

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "line3d_tpu_torch")


@pytest.mark.parametrize("name", ["fh_cluster.cpp", "affinity_enum.cpp"])
def test_native_sources_are_copies_of_the_reference(name):
    with open(os.path.join(PKG, "native", name), "rb") as f:
        mine = f.read()
    with open(os.path.join(REPO, "line3d_tpu", "native", name), "rb") as f:
        assert mine == f.read()


def test_native_build_reads_only_the_port():
    assert [os.path.basename(s) for s in load.SOURCES] == \
        ["fh_cluster.cpp", "affinity_enum.cpp"]
    for src in load.SOURCES:
        assert os.path.commonpath([os.path.realpath(src), PKG]) == PKG, src
        assert os.path.exists(src)


def test_port_alone_builds_and_runs_the_host_library(tmp_path):
    """One g++ build in a copy of the package that nothing else sees."""
    shutil.copytree(PKG, tmp_path / "line3d_tpu_torch",
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    code = textwrap.dedent("""
        import importlib.util, os, sys
        import numpy as np
        assert importlib.util.find_spec("line3d_tpu") is None
        from line3d_tpu_torch import Line3D, L3DConfig
        from line3d_tpu_torch.cluster.fh import fh_cluster
        from line3d_tpu_torch.native import load
        from line3d_tpu_torch.utils.synthetic import make_scene
        here = os.path.realpath(os.getcwd())
        assert os.path.realpath(load._LIB_PATH).startswith(here)
        assert not os.path.exists(load._LIB_PATH)
        labels = fh_cluster(np.array([0, 1, 3]), np.array([1, 2, 4]),
                            np.array([0.9, 0.8, 0.7]), 5, c=10.0)
        assert labels[0] == labels[1] == labels[2] != labels[3]
        assert labels[3] == labels[4]
        syn = make_scene(num_views=4, device="cpu")
        l3d = Line3D(config=L3DConfig(use_collinearity=False),
                     device="cpu")
        for v in range(syn.scene.num_views):
            l3d.add_view_segments(
                v, syn.scene.segments[v][syn.scene.seg_mask[v]],
                syn.cameras.K[v], syn.cameras.R[v], syn.cameras.t[v],
                worldpoint_ids=syn.wp_lists[v], width=640, height=480)
        lines = l3d.compute_3d_model()
        assert len(lines) > 0 and os.path.exists(load._LIB_PATH)
        print("ok", len(lines))
        """)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(tmp_path)
    r = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, env=env,
                       capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stdout + r.stderr
    assert r.stdout.startswith("ok")
