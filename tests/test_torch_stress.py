"""The port's counterparts of `line3d_tpu`'s stress scripts, on the CPU.

(1) `utils/stress_stage_bench.fixture` against scripts/stress_stage_bench.py
    `fixture()` (loaded by path; nothing in scripts/ changes), at the P25
    stress shape (25 views x 2,990 clutter segments, S = 3,072): segments,
    masks, neighbours, fundamentals and the f32 camera stacks equal, the
    conditioned float64 cameras within rtol 1e-12.
(2) `stress_stage_bench.main(["--device", "cpu", ...])` on a reduced
    fixture prints stages A-E and the occupancy line at both capacities
    and one JSON line; its step is the engine's: the selection of stage E
    assembles to what `engine.match_views` gives the view, at the script's
    caps and at exact capacity.
(3) `quota_bucket_bench` on that fixture: the effective quota is the
    script's formula, and every pair that drops nothing selects what the
    (2048, 8) pair selects; a pair that drops nothing but selects other
    matches raises.
(4) `utils/cli_bench`'s bundle.rd.out and scene.nvm are the JAX script's
    text byte for byte (the script's cv2 rendering patched out), and the
    port's `io/bundler.py` and `io/nvm.py` read them back to the scene's
    cameras.
"""
import importlib.util
import json
import os
import sys

import numpy as np
import pytest
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
if REPO not in sys.path:
    sys.path.insert(0, REPO)

from line3d_tpu_torch.io import bundler as bundler_io, nvm as nvm_io  # noqa
from line3d_tpu_torch.match import engine  # noqa: E402
from line3d_tpu_torch.utils import cli_bench  # noqa: E402
from line3d_tpu_torch.utils import quota_bucket_bench as qbb  # noqa: E402
from line3d_tpu_torch.utils import stress_stage_bench as ssb  # noqa: E402

# (2)-(3): a fixture the CPU steps through in a fraction of a second
SMALL = dict(num_views=4, segments=200)


def _load_script(name, monkeypatch, tmp_path):
    """scripts/<name>.py as a module, its persistent XLA cache pointed at
    tmp_path and the process's JAX cache settings and sys.path restored."""
    import jax
    from line3d_tpu.utils import xla_cache
    orig = xla_cache.enable_persistent_cache
    monkeypatch.setattr(
        xla_cache, "enable_persistent_cache",
        lambda path=None, **k: orig(str(tmp_path / "xla"), **k))
    keys = ("jax_compilation_cache_dir",
            "jax_persistent_cache_min_compile_time_secs")
    saved = {k: getattr(jax.config, k) for k in keys}
    path = list(sys.path)
    spec = importlib.util.spec_from_file_location(
        f"jax_{name}", os.path.join(REPO, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    try:
        spec.loader.exec_module(mod)
    finally:
        sys.path[:] = path
        for k, v in saved.items():
            jax.config.update(k, v)
    assert jax.config.jax_platforms == "cpu"
    return mod


@pytest.fixture(scope="module")
def small():
    return ssb.fixture("cpu", SMALL["num_views"], SMALL["segments"])


def test_fixture_equals_the_jax_script(monkeypatch, tmp_path):
    """(1) the port's fixture() is the script's at the stress shape."""
    mod = _load_script("stress_stage_bench", monkeypatch, tmp_path)
    seen = {}
    make = mod.make_demo_scene

    def spy(*a, **k):
        seen["scene"], seen["cams"] = out = make(*a, **k)
        return out
    monkeypatch.setattr(mod, "make_demo_scene", spy)
    scene, src, nbd, sk = mod.fixture()
    fx = ssb.fixture("cpu")
    assert fx.S == scene.max_segments == 3072 and fx.view == 0
    jnb = mod.find_visual_neighbors(
        mod.view_similarities_from_worldpoints(scene.wp_lists,
                                               scene.num_views)[0],
        seen["cams"].baselines(), mod.L3DConfig().min_baseline, 10)[0]
    np.testing.assert_array_equal(fx.nb, np.asarray(jnb))
    assert len(fx.nb) == 10
    np.testing.assert_array_equal(fx.scene.segments, scene.segments)
    np.testing.assert_array_equal(fx.scene.seg_mask, scene.seg_mask)
    mine = (fx.segs_src, fx.mask_src, fx.RtKinv_src, fx.C_src)
    for a, b in zip(mine, src):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    mine = (fx.segs_nb, fx.mask_nb, fx.F_nb, fx.RtKinv_nb, fx.C_nb, fx.P_nb)
    for a, b in zip(mine, nbd[:6]):
        assert a.numpy().dtype == np.asarray(b).dtype
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert np.asarray(nbd[6]).all()          # the script's nb_mask
    assert fx.spatial_k == sk and isinstance(fx.spatial_k, np.float32)
    for name in ("K", "R", "t", "C", "RtKinv", "P"):
        np.testing.assert_allclose(getattr(fx.cams, name),
                                   getattr(seen["cams"], name), rtol=1e-12,
                                   atol=0, err_msg=name)


@pytest.mark.parametrize("caps", [None, (ssb.QUOTA, ssb.M_TOTAL)])
def test_stage_e_is_the_engine_step(small, caps):
    """(2) the bench's whole step gives the selection the pipeline's
    per-view step gives (engine.match_views), at both capacities."""
    fx = small
    buf = ssb.step(fx, fx.segs_src, caps)
    vm, _, _ = ssb.assembled(fx, buf)
    ctx = engine.ViewContext(fx.scene, fx.cams, fx.config)
    want, = engine.match_views(ctx, {fx.view: fx.nb}, [fx.view],
                               caps=caps).values()
    assert len(vm.src_seg) > 0 and vm.overflow == want[0].overflow == 0
    assert want[1] is not None
    assert ssb.engine_mismatch(fx, buf, want) == []
    assert ssb.engine_mismatch(fx, buf, (*want[:2], want[2] + 1.0)) == \
        ["median_depth"]


def test_stress_stage_bench_main_on_cpu(capsys):
    """(2) main prints the five cumulative stages and the occupancy line at
    both capacities, then one JSON line."""
    assert ssb.main(["--device", "cpu", "--views",
                     str(SMALL["num_views"]), "--segments",
                     str(SMALL["segments"]), "--repeats", "1"]) == 0
    out = capsys.readouterr().out.splitlines()
    rec = json.loads(out[-1])
    for cap, tag in (("script", "[quota 8, m_total 2048]"),
                     ("exact", "[exact: quota 128")):
        lines = [ln for ln in out if ln.startswith(tag)]
        assert [ln.split("stage ")[1][0] for ln in lines[:5]] == \
            list(ssb.STAGES)
        assert "occupancy: mean" in lines[5] and "S=256)" in lines[5]
        r = rec[cap]
        assert list(r["stages"]) == list(ssb.STAGES)
        assert all(len(s["host_ms"]) == 1 and s["event_ms"] is None and
                   s["syncs"] is None for s in r["stages"].values())
        assert r["profiled_step"] is None         # the profile is the card's
        occ = r["occupancy"]
        assert occ["S"] == 256 and 0 < occ["mean"] <= occ["p90"] <= \
            occ["max"] <= occ["M"]
    assert rec["exact"]["quota"] == 128 and rec["S"] == 256
    assert rec["script"]["occupancy"]["max"] == \
        rec["exact"]["occupancy"]["max"]       # both lossless here
    assert rec["device"] == "cpu" and rec["card"] is None


def test_quota_bucket_bench_lossless_pairs_select_alike(small, capsys):
    """(3) the ten pairs: the script's effective quota, and every lossless
    pair's selection the (2048, 8) pair's."""
    rec = qbb.run(small, 1)
    assert [(r["m_total"], r["quota"]) for r in rec["pairs"]] == \
        list(qbb.COMBOS)
    for m, q in qbb.COMBOS:            # the script's formula at S = 3,072
        assert qbb.effective_quota(m, q, 3072) == \
            min(max(q, -(-m // (3072 // 128))), 128)
    lossless = [r for r in rec["pairs"] if r["overflow"] == 0]
    assert lossless and all(r["selection_equal"] for r in lossless)
    assert all(r["n_verified"] == rec["pairs"][0]["n_verified"]
               for r in lossless)
    assert len([ln for ln in capsys.readouterr().out.splitlines()
                if ln.startswith("m_total")]) == len(qbb.COMBOS)


def test_quota_bucket_bench_raises_on_a_lossless_difference(small,
                                                            monkeypatch):
    """(3) a pair that drops nothing but selects otherwise raises."""
    step = ssb.step

    def off(fx, segs, caps, upto="E"):
        buf = step(fx, segs, caps, upto)
        if caps == (8, 1024):
            buf = buf.copy()
            buf[0] += 1                       # another best camera slot
        return buf
    monkeypatch.setattr(ssb, "step", off)
    with pytest.raises(RuntimeError, match="m_total 1024 quota 8 drops"):
        qbb.run(small, 1)


@pytest.mark.parametrize("fmt", ["bundler", "nvm"])
@pytest.mark.parametrize("kind", ["facade", "house"])
def test_cli_bench_dataset_text_equals_the_jax_script(fmt, kind, tmp_path,
                                                      monkeypatch):
    """(4) the dataset text byte for byte, read back to the cameras."""
    mod = _load_script("cli_bench", monkeypatch, tmp_path)
    monkeypatch.setattr(mod, "_render_images", lambda *a, **k: None)
    V, W, H = 6, 640, 480
    name = "bundle.rd.out" if fmt == "bundler" else "scene.nvm"
    render = dict(bundler="render_dataset", nvm="render_nvm_dataset")[fmt]
    (tmp_path / "jax").mkdir()
    (tmp_path / "port").mkdir()
    getattr(mod, render)(str(tmp_path / "jax"), V, W, H, kind=kind)
    scene = getattr(cli_bench, render)(str(tmp_path / "port"), V, W, H,
                                       kind=kind)
    want = (tmp_path / "jax" / name).read_bytes()
    assert (tmp_path / "port" / name).read_bytes() == want
    _, cams = cli_bench.make_scene(kind, V, W, H)
    if fmt == "bundler":
        ds = bundler_io.load_bundler_scene(str(tmp_path / "port"))
        assert all(p is not None and p.endswith(f"{v:08d}.jpg")
                   for v, p in enumerate(ds.image_paths))
        paths = ds.image_paths
    else:
        ds = nvm_io.load_nvm_scene(str(tmp_path / "port" / name))
        assert ds.image_names == [f"img_{v:04d}.jpg" for v in range(V)]
        paths = [str(tmp_path / "port" / n) for n in ds.image_names]
    np.testing.assert_allclose(ds.focal, cams.K[:, 0, 0], atol=1e-6)
    np.testing.assert_allclose(ds.R, cams.R, atol=1e-8)
    np.testing.assert_allclose(ds.t, cams.t, atol=1e-7)
    # the file numbers the worldpoints in ascending order of their ids
    rank = {w: i for i, w in enumerate(sorted(cli_bench.wp_views(scene)))}
    assert [sorted(w) for w in ds.wp_lists] == \
        [sorted(rank[w] for w in set(ws)) for ws in scene.wp_lists]
    from line3d_tpu_torch.io import images
    img = images.load_image(paths[0])
    assert img.shape == (H, W, 3) and img.min() < 100 and img.max() == 235


def test_scale_exact_profile_keeps_the_stress_profile_fields():
    """`scale_exact_profile 25 --scene clutter` stands for
    scripts/stress_exact_profile.py: each warm trial keeps the fields that
    script prints (its filter over the stats keys)."""
    from line3d_tpu_torch.utils import scale_exact_profile as sep
    stats = dict(num_lines=3, t_match=1.0, t_fh=0.5, probe_m_total=2048,
                 probe_quota=8, match_overflow=0, collinearity_overflow=2,
                 views_rematched_uncapped=0, views_recollin_exact=1,
                 m_total=[2048], gathered_bytes=0)
    keys = [k for k in stats if k.startswith("t_") or "probe" in k
            or "overflow" in k or "rematched" in k or "recollin" in k]
    assert sep.stress_fields(stats) == {k: stats[k] for k in keys}
    assert "m_total" not in keys and "num_lines" not in keys
