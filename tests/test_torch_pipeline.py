"""The house10 models through line3d_tpu_torch.Line3D(device="cpu"), held
against tests/golden/house10.txt and house10_diffusion.txt; the pipeline
with line refinement and with bundle adjustment against line3d_tpu's; and
the port's import hygiene.

The goldens are read as test_golden.py reads them: integer tokens equal,
float tokens within rtol 1e-5 / atol 1e-6.  The tokens outside are pinned
exactly (torch_port_helpers.HOUSE10_OUTSIDE, HOUSE10_DIFFUSION_OUTSIDE), so
any other difference, or a change of those, fails.

Refine and BA against line3d_tpu: the same lines (count and members),
3D endpoints within 1e-4 (float32 refinement; the scene spans ~1.5), BA
poses within tests/test_bundle.py's atol 5e-4 and rms within 1e-3."""
import ast
import os
import subprocess
import sys

import pytest

import numpy as np

from line3d_tpu_torch import Line3D, L3DConfig
from line3d_tpu_torch.io.writers import compare_txt
from line3d_tpu_torch.utils.synthetic import make_scene
from torch_port_helpers import HOUSE10_DIFFUSION_OUTSIDE, HOUSE10_OUTSIDE

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
PKG = os.path.join(REPO, "line3d_tpu_torch")


def _house10(config=L3DConfig(use_collinearity=True), **scene):
    return _feed(Line3D(config=config, device="cpu"), **scene)


def _feed(l3d, **scene):
    """Every view of the 10-view synthetic house (make_scene(**scene))
    added to a Line3D of either package."""
    syn = make_scene(num_views=10, device="cpu", **scene)
    for v in range(syn.scene.num_views):
        l3d.add_view_segments(
            v, syn.scene.segments[v][syn.scene.seg_mask[v]],
            syn.cameras.K[v], syn.cameras.R[v], syn.cameras.t[v],
            worldpoint_ids=syn.wp_lists[v],
            width=int(syn.cameras.width[v]),
            height=int(syn.cameras.height[v]))
    return l3d


def test_house10_matches_golden(tmp_path):
    l3d = _house10()
    result = l3d.compute_3d_model()
    out = str(tmp_path / "model.txt")
    l3d.save_3d_lines_as_txt(result, out)
    rep = compare_txt(out, os.path.join(HERE, "golden", "house10.txt"))
    assert rep["int_bad"] == 0, rep
    assert rep["outside"] == HOUSE10_OUTSIDE, rep
    assert rep["worst_ratio"] < 1.05, rep
    assert l3d.stats["match_overflow"] == 0
    assert l3d.stats["num_lines"] == len(result) == 16
    stl = str(tmp_path / "model.stl")
    l3d.save_3d_lines_as_stl(result, stl)
    text = open(stl).read()
    assert text.startswith("solid lineModel") and \
        text.count("facet normal") == sum(len(r.segments3d) for r in result)


@pytest.mark.parametrize("backend", ["host", "device"])
def test_house10_diffusion_matches_golden(tmp_path, backend):
    """The noisy house of test_golden.py's diffusion case (0.8 px, seed 3),
    reference-mode diffusion on the float64 host or the float32 device
    form (here on CPU tensors)."""
    cfg = L3DConfig(use_collinearity=True, diffusion_backend=backend)
    l3d = _house10(cfg, noise_px=0.8, seed=3)
    result = l3d.compute_3d_model(perform_diffusion=True)
    out = str(tmp_path / "model.txt")
    l3d.save_3d_lines_as_txt(result, out)
    rep = compare_txt(out, os.path.join(HERE, "golden",
                                        "house10_diffusion.txt"))
    assert rep["int_bad"] == 0, rep
    assert rep["outside"] == HOUSE10_DIFFUSION_OUTSIDE, rep
    assert len(result) == 16 and l3d.stats["t_diffusion"] > 0


def _same_lines(got, want):
    assert len(got) == len(want) > 10
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.views2d, b.views2d)
        np.testing.assert_array_equal(a.segs2d, b.segs2d)
        np.testing.assert_allclose(a.segments3d, b.segments3d, rtol=0,
                                   atol=1e-4)


@pytest.mark.parametrize("refine_backend,fh_backend", [
    ("auto", "exact"), ("device", "parallel")])
def test_pipeline_refine_matches_reference(refine_backend, fh_backend):
    """test_refine.py's noisy house (0.7 px, seed 2) with refine_lines;
    "auto" is the host float64 form in both packages on the CPU."""
    from line3d_tpu import Line3D as JLine3D, L3DConfig as JConfig
    kw = dict(use_collinearity=True, refine_lines=True,
              refine_backend=refine_backend, fh_backend=fh_backend)
    scene = dict(noise_px=0.7, seed=2)
    got = _house10(L3DConfig(**kw), **scene).compute_3d_model()
    want = _feed(JLine3D(config=JConfig(**kw)), **scene).compute_3d_model()
    _same_lines(got, want)


def test_pipeline_bundle_adjust_matches_reference():
    """test_bundle.py's end-to-end case (0.4 px, seed 7, 3 iterations)."""
    from line3d_tpu import Line3D as JLine3D, L3DConfig as JConfig
    kw = dict(use_collinearity=False, bundle_adjust_cameras=True,
              bundle_iterations=3)
    scene = dict(noise_px=0.4, seed=7)
    t = _house10(L3DConfig(**kw), **scene)
    j = _feed(JLine3D(config=JConfig(**kw)), **scene)
    _same_lines(t.compute_3d_model(), j.compute_3d_model())
    for a, b in zip(t.refined_poses, j.refined_poses):
        assert a.shape == b.shape
        np.testing.assert_allclose(a, b, rtol=0, atol=5e-4)
    for R in t.refined_poses[0]:
        np.testing.assert_allclose(R @ R.T, np.eye(3), atol=1e-5)
    st = t.stats
    assert st["ba_rms_after"] <= st["ba_rms_before"] + 1e-6
    assert abs(st["ba_rms_after"] - j.stats["ba_rms_after"]) < 1e-3
    t.compute_3d_model()
    assert t.refined_poses is not None
    t.config = L3DConfig(use_collinearity=False)
    t.compute_3d_model()
    assert t.refined_poses is None and "ba_rms_after" not in t.stats


def _imports(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_port_sources_import_no_jax():
    """Every .py file of the package, and chip_smoke.py."""
    seen = [os.path.join(REPO, "chip_smoke.py")]
    for root, dirs, files in os.walk(PKG):
        dirs[:] = [d for d in dirs if d != "_build"]   # build outputs
        seen += [os.path.join(root, f) for f in files if f.endswith(".py")]
    for path in seen:
        for mod in _imports(path):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "line3d_tpu"), (path, mod)
    assert len(seen) > 40
    for new in ("cli.py", "io/images.py", "io/bundler.py", "io/nvm.py",
                "io/cache.py", "detect/vectorized_lsd.py",
                "detect/detector.py", "utils/visualize.py",
                "parallel/sharded.py"):
        assert os.path.join(PKG, new) in seen


def test_importing_the_port_loads_no_jax():
    """Every module of the package (the CLI included) imports on a machine
    without JAX, without cv2 and without PIL, and loads none of them."""
    code = ("import sys, importlib, pkgutil\n"
            "for m in ('cv2', 'PIL', 'jax', 'jaxlib'):\n"
            "    sys.modules[m] = None\n"       # importing them now raises
            "import line3d_tpu_torch\n"
            "names = [i.name for i in pkgutil.walk_packages("
            "line3d_tpu_torch.__path__, 'line3d_tpu_torch.')]\n"
            "for n in names:\n"
            "    importlib.import_module(n)\n"
            "assert 'line3d_tpu_torch.cli' in names and len(names) > 40\n"
            "assert 'line3d_tpu_torch.parallel.sharded' in names\n"
            "from line3d_tpu_torch.io import images\n"
            "assert images._HAS_CV2 is False\n"
            "bad = [m for m, v in sys.modules.items() if v is not None and "
            "m.split('.')[0] in ('jax', 'jaxlib', 'line3d_tpu', 'cv2', "
            "'PIL')]\n"
            "assert not bad, bad\n"
            "import torch\n"
            "assert not torch.backends.cuda.matmul.allow_tf32\n"
            "assert not torch.backends.cudnn.allow_tf32\n")
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True,
                   env={**os.environ, "PYTHONPATH": REPO})
