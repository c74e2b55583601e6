"""The house10 model through line3d_tpu_torch.Line3D(device="cpu"), held
against tests/golden/house10.txt, and the port's import hygiene.

The golden is read as test_golden.py reads it: integer tokens equal, float
tokens within rtol 1e-5 / atol 1e-6.  All 1088 tokens but one meet that;
the one outside is pinned exactly (torch_port_helpers.HOUSE10_OUTSIDE), so
any other difference, or a change of that one, fails."""
import ast
import os
import subprocess
import sys

import pytest

from line3d_tpu_torch import Line3D, L3DConfig
from line3d_tpu_torch.io.writers import compare_txt
from line3d_tpu_torch.utils.synthetic import make_scene
from torch_port_helpers import HOUSE10_OUTSIDE

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
PKG = os.path.join(REPO, "line3d_tpu_torch")


def _house10(config=L3DConfig(use_collinearity=True)):
    syn = make_scene(num_views=10)
    l3d = Line3D(config=config, device="cpu")
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


@pytest.mark.parametrize("field", ["perform_diffusion", "refine_lines",
                                   "bundle_adjust_cameras",
                                   "fh_backend", "uncapped_fallback"])
def test_unported_options_raise(field):
    value = {"fh_backend": "parallel", "uncapped_fallback": False}.get(
        field, True)
    l3d = _house10(L3DConfig(**{field: value}))
    with pytest.raises(NotImplementedError, match="not ported"):
        l3d.compute_3d_model()


def _imports(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_port_sources_import_no_jax():
    seen = []
    for root, dirs, files in os.walk(PKG):
        dirs[:] = [d for d in dirs if d != "_build"]   # build outputs
        for f in files:
            if f.endswith(".py"):
                path = os.path.join(root, f)
                seen.append(path)
                for mod in _imports(path):
                    top = mod.split(".")[0]
                    assert top not in ("jax", "jaxlib", "line3d_tpu"), \
                        (path, mod)
    assert len(seen) > 15


def test_importing_the_port_loads_no_jax():
    code = ("import sys, line3d_tpu_torch, line3d_tpu_torch.pipeline, "
            "line3d_tpu_torch.utils.demo, line3d_tpu_torch.convert\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'line3d_tpu')]\n"
            "assert not bad, bad\n"
            "import torch\n"
            "assert not torch.backends.cuda.matmul.allow_tf32\n"
            "assert not torch.backends.cudnn.allow_tf32\n")
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True,
                   env={**os.environ, "PYTHONPATH": REPO})
