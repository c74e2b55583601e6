"""`python -m line3d_tpu_torch.cli bundler|vsfm` end to end on the rendered
8-view house (images -> detector -> pipeline -> STL/TXT), held against
`line3d_tpu.cli` on the same dataset, and the Line3D entry points the CLI
drives (`add_image`, `add_images_parallel`, the segment cache,
`set_view_similarity`).  Everything runs with `--device cpu` /
`device="cpu"`.

Against the JAX CLI: the same stamped file names and `[SYS]` lines; the TXT
model within `compare_txt`'s tolerance (integer tokens equal, floats rtol
1e-5 / atol 1e-6; segments are detected by the same native code, depths
are float32 in both packages and XLA:CPU contracts FMAs), or, where a
near-tie parts the two clusterings, the same line count +-1; and in every
case a median distance to the
ground-truth wireframe below 0.05 (scene scale 1.5), tests/test_cli.py's
bound.
"""
import glob
import os

import numpy as np
import pytest

cv2 = pytest.importorskip("cv2")

from line3d_tpu import cli as jcli
from line3d_tpu.scene import view_similarities_from_worldpoints
from line3d_tpu_torch import Line3D, L3DConfig, cli as tcli
from line3d_tpu_torch.io import images as timg, writers
from line3d_tpu_torch.native import load as tload
from synthetic import make_scene

FLAGS = ["-w", "640", "-n", "6", "--stable_shapes", "false"]
STEM = "line3D_result__W_640__N_6__tL_1__tU_5__sigmaP_3.5__sigmaA_10__" \
    "COLLIN__NO_DIFFUSION"


def _rot_to_quat(R):
    """Inverse of nvm.quat_to_R (w, x, y, z)."""
    tr = np.trace(R)
    if tr > 0:
        s = np.sqrt(tr + 1.0) * 2
        return np.array([0.25 * s, (R[2, 1] - R[1, 2]) / s,
                         (R[0, 2] - R[2, 0]) / s, (R[1, 0] - R[0, 1]) / s])
    i = int(np.argmax(np.diag(R)))
    j, k = (i + 1) % 3, (i + 2) % 3
    s = np.sqrt(R[i, i] - R[j, j] - R[k, k] + 1.0) * 2
    q = np.empty(4)
    q[0] = (R[k, j] - R[j, k]) / s
    q[1 + i] = 0.25 * s
    q[1 + j] = (R[j, i] + R[i, j]) / s
    q[1 + k] = (R[k, i] + R[i, k]) / s
    return q


def _render(syn, v, width=640, height=480):
    """View v's projected wireframe as a gray image (tests/test_cli.py)."""
    img = np.full((height, width), 235, np.uint8)
    for s in syn.scene.segments[v][syn.scene.seg_mask[v]]:
        cv2.line(img, (int(s[0]), int(s[1])), (int(s[2]), int(s[3])),
                 40, 2, lineType=cv2.LINE_AA)
    return cv2.GaussianBlur(img, (3, 3), 0.7)


def _wp_views(syn):
    out = {}
    for v in range(syn.scene.num_views):
        for w in syn.wp_lists[v]:
            out.setdefault(w, []).append(v)
    return out


def write_bundler_dataset(root, syn):
    """bundle.rd.out + visualize/%08d.png (the loader's sign flips undone,
    main_bundler.cpp:159-176)."""
    cams, V = syn.cameras, syn.scene.num_views
    os.makedirs(os.path.join(root, "visualize"))
    for v in range(V):
        cv2.imwrite(os.path.join(root, "visualize", f"{v:08d}.png"),
                    cv2.cvtColor(_render(syn, v), cv2.COLOR_GRAY2BGR))
    wp_views = _wp_views(syn)
    lines = ["# Bundle file v0.3", f"{V} {len(wp_views)}"]
    for v in range(V):
        lines.append(f"{cams.K[v][0, 0]:.6f} 0 0")
        R = cams.R[v].copy()
        R[1:3] *= -1.0
        lines += [" ".join(f"{x:.9f}" for x in R[r]) for r in range(3)]
        t = cams.t[v].copy()
        t[1:3] *= -1.0
        lines.append(" ".join(f"{x:.9f}" for x in t))
    for w in sorted(wp_views):
        lines += ["0 0 0", "128 128 128",
                  f"{len(wp_views[w])}" + "".join(f" {v} 0 0.0 0.0"
                                                  for v in wp_views[w])]
    with open(os.path.join(root, "bundle.rd.out"), "w") as f:
        f.write("\n".join(lines) + "\n")


def write_nvm_dataset(root, syn, ext=".png"):
    """scene.nvm + images (NVM_V3 as main_vsfm.cpp:121-223 parses it);
    `.pgm` images are written as binary netpbm."""
    cams, V = syn.cameras, syn.scene.num_views
    os.makedirs(root)
    for v in range(V):
        cv2.imwrite(os.path.join(root, f"img_{v:03d}{ext}"), _render(syn, v))
    wp_views = _wp_views(syn)
    lines = ["NVM_V3", "", f"{V}"]
    for v in range(V):
        lines.append(
            f"img_{v:03d}{ext} {cams.K[v][0, 0]:.6f} "
            + " ".join(f"{x:.9f}" for x in _rot_to_quat(cams.R[v])) + " "
            + " ".join(f"{x:.9f}" for x in cams.C[v]) + " 0.0 0")
    lines += ["", f"{len(wp_views)}"]
    for w in sorted(wp_views):
        lines.append(f"0 0 0 128 128 128 {len(wp_views[w])}"
                     + "".join(f" {v} 0 0.0 0.0" for v in wp_views[w]))
    with open(os.path.join(root, "scene.nvm"), "w") as f:
        f.write("\n".join(lines) + "\n")


def _gt_median_error(txt, syn):
    errs = []
    for segs3d, _res in writers.load_txt(txt):
        pts = segs3d.reshape(-1, 3)
        errs.append(min(
            np.linalg.norm(np.cross(pts - A, (B - A) / np.linalg.norm(B - A)),
                           axis=1).mean() for A, B in syn.lines3d))
    return float(np.median(errs)), len(errs)


def _hold_to_reference(txt_t, txt_j, syn):
    """The port's TXT against the JAX CLI's (module docstring)."""
    err, n_t = _gt_median_error(txt_t, syn)
    assert err < 0.05 and n_t >= 6, (err, n_t)
    rep = writers.compare_txt(txt_t, txt_j)
    if not rep["ok"]:
        n_j = len(writers.load_txt(txt_j))
        assert abs(n_t - n_j) <= 1, (n_t, n_j, rep)
    return rep


@pytest.fixture(scope="module")
def datasets(tmp_path_factory):
    """One house, written as a bundler folder twice (one per package, so
    neither reads the other's segment caches) and as NVM datasets."""
    syn = make_scene(num_views=8, width=640, height=480, focal=600.0)
    root = tmp_path_factory.mktemp("cli")
    out = dict(syn=syn)
    for name in ("bundler_t", "bundler_j"):
        out[name] = str(root / name)
        os.makedirs(out[name])
        write_bundler_dataset(out[name], syn)
    for name, ext in (("nvm_t", ".png"), ("nvm_j", ".png"),
                      ("nvm_pgm", ".pgm")):
        out[name] = str(root / name)
        write_nvm_dataset(out[name], syn, ext)
    return out


def _outputs(root):
    out_dir = os.path.join(root, "Line3D")
    return (sorted(glob.glob(os.path.join(out_dir, "line3D_result_*.txt"))),
            sorted(glob.glob(os.path.join(out_dir, "line3D_result_*.stl"))),
            sorted(glob.glob(os.path.join(out_dir, "L3D_data",
                                          "segments_*.npz"))))


def test_cli_bundler_end_to_end(datasets, capsys, tmp_path):
    root_t, root_j = datasets["bundler_t"], datasets["bundler_j"]
    tcli.main(["bundler", "-i", root_t, "--device", "cpu"] + FLAGS)
    out = capsys.readouterr().out
    jcli.main(["bundler", "-i", root_j] + FLAGS)
    sys_lines = lambda o: [ln for ln in o.splitlines()          # noqa: E731
                           if ln.startswith("[SYS]") and "seconds" not in ln]
    assert sys_lines(out) == sys_lines(capsys.readouterr().out)
    assert any("capacity probe" in ln for ln in sys_lines(out))
    txt_t, stl_t, caches_t = _outputs(root_t)
    txt_j, stl_j, caches_j = _outputs(root_j)
    assert [os.path.basename(p) for p in txt_t] == \
        [os.path.basename(p) for p in txt_j] == [STEM + ".txt"]
    assert [os.path.basename(p) for p in stl_t] == [STEM + ".stl"]
    assert [os.path.basename(p) for p in caches_t] == \
        [os.path.basename(p) for p in caches_j] and len(caches_t) == 8
    _hold_to_reference(txt_t[0], txt_j[0], datasets["syn"])
    for tag in ("[SYS] num_cameras: 8", "[SYS] 3D lines:", "[SYS] #images:"
                "         8", "[SYS] stage seconds:   detect="):
        assert tag in out, tag

    # a second run reuses the 8 caches (no detection), writes the same
    # model, and leaves a torch.profiler trace when asked to
    first = open(txt_t[0]).read()
    prof = str(tmp_path / "profile")
    tcli.main(["bundler", "-i", root_t, "--device", "cpu", "--profile_dir",
               prof, "--debug_ply", "1"] + FLAGS)
    assert open(txt_t[0]).read() == first
    assert "detect=0.0" in capsys.readouterr().out
    assert os.path.getsize(os.path.join(prof, "line3d_trace.json")) > 1000
    assert os.path.exists(os.path.join(root_t, "Line3D", STEM + ".ply"))


def test_cli_vsfm_end_to_end(datasets):
    tcli.main(["vsfm", "-i", os.path.join(datasets["nvm_t"], "scene.nvm"),
               "--device", "cpu"] + FLAGS)
    jcli.main(["vsfm", "-i", os.path.join(datasets["nvm_j"], "scene.nvm")]
              + FLAGS)
    txt_t, stl_t, caches_t = _outputs(datasets["nvm_t"])
    txt_j, _, _ = _outputs(datasets["nvm_j"])
    assert [os.path.basename(p) for p in txt_t] == \
        [os.path.basename(p) for p in txt_j] == [STEM + ".txt"]
    assert len(stl_t) == 1 and len(caches_t) == 8
    _hold_to_reference(txt_t[0], txt_j[0], datasets["syn"])


def test_cli_vsfm_netpbm_without_cv2(datasets, monkeypatch):
    """Binary PGM images through the numpy reader (cv2 switched off, as on
    a machine without it) give the model the PNG dataset gives with cv2:
    the rasters are the same, so the TXT is the same text."""
    monkeypatch.setattr(timg, "_HAS_CV2", False)
    out = os.path.join(datasets["nvm_pgm"], "out")
    tcli.main(["vsfm", "-i", os.path.join(datasets["nvm_pgm"], "scene.nvm"),
               "-o", out, "--device", "cpu", "-l", "0"] + FLAGS)
    assert not glob.glob(os.path.join(out, "L3D_data", "*.npz"))
    monkeypatch.setattr(timg, "_HAS_CV2", True)
    ref = os.path.join(datasets["nvm_pgm"], "ref")
    tcli.main(["vsfm", "-i", os.path.join(datasets["nvm_t"], "scene.nvm"),
               "-o", ref, "--device", "cpu", "-l", "0"] + FLAGS)
    assert open(os.path.join(out, STEM + ".txt")).read() == \
        open(os.path.join(ref, STEM + ".txt")).read()


def test_cli_runs_on_the_card_unless_asked(datasets, monkeypatch):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        tcli.main(["bundler", "-i", datasets["bundler_t"]] + FLAGS)
    assert tcli.main([]) == 2 and tcli.main(["nope"]) == 2


@pytest.mark.parametrize("flags,stem", [
    ([], "line3D_result__W_1920__N_10__tL_1__tU_5__sigmaP_3.5__sigmaA_10__"
         "COLLIN__NO_DIFFUSION"),
    (["-n", "-1", "-a", "-2.5", "-b", "7", "-p", "-2", "-g", "12.5", "-e",
      "0", "-d", "1", "-w", "800"],
     "line3D_result__W_800__N_ALL__tL_2.5__tU_7__sigmaP_2__sigmaA_12.5__"
     "NO_COLLIN__DIFFUSION")])
def test_result_stem_and_config_equal_reference(flags, stem):
    """The stamped name and the config built from the flags, through both
    packages' parsers."""
    import argparse
    import dataclasses
    ap_t, ap_j = argparse.ArgumentParser(), argparse.ArgumentParser()
    tcli._add_common_flags(ap_t)
    jcli._add_common_flags(ap_j)
    a_t, a_j = ap_t.parse_args(flags), ap_j.parse_args(flags)
    assert tcli._result_stem(a_t) == jcli._result_stem(a_j) == stem
    c_t = dataclasses.asdict(tcli._config_from_args(a_t))
    c_j = dataclasses.asdict(jcli._config_from_args(a_j))
    c_j["stable_shapes"] = c_t["stable_shapes"]    # TPU-only, not carried
    assert c_t == c_j
    assert a_t.device == "cuda"
    assert {k for k in vars(a_j)} | {"device"} == {k for k in vars(a_t)}


def test_parse_bool_reference_semantics():
    """'-e 0' must disable (TCLAP istream>>bool semantics), not enable."""
    for s in ("0", "false", "no", "off", " Off "):
        assert tcli._parse_bool(s) is jcli._parse_bool(s) is False
    for s in ("1", "true", "yes", "on", "TRUE"):
        assert tcli._parse_bool(s) is jcli._parse_bool(s) is True
    with pytest.raises(Exception):
        tcli._parse_bool("maybe")


def _house_items(syn):
    return [(10 + v, _render(syn, v), syn.cameras.K[v], syn.cameras.R[v],
             syn.cameras.t[v], syn.wp_lists[v])
            for v in range(syn.scene.num_views)]


def test_add_image_cache_and_parallel_order(tmp_path):
    """add_image detects, caches and registers; `-l off` removes a stale
    cache file; add_images_parallel registers in item order whatever the
    thread completion order, with the same segments and the same model as
    sequential add_image; image ids in use and unlinked images raise."""
    syn = make_scene(num_views=6, width=640, height=480, focal=600.0)
    items = _house_items(syn)
    cfg = L3DConfig()
    data = str(tmp_path / "data" / "L3D_data")
    seq = Line3D(data, cfg, device="cpu")
    assert os.path.isdir(data)
    n = [seq.add_image(*it) for it in items]
    assert n == [len(s) for s in seq._segments] and min(n) > 10
    assert seq.stats["t_detect"] > 0 and seq.num_cameras() == 6
    caches = sorted(os.listdir(data))
    assert len(caches) == 6 and caches[0].startswith("segments_10_640x480")
    with pytest.raises(ValueError, match="already in use"):
        seq.add_image(*items[0])
    with pytest.raises(ValueError, match="unlinked"):
        seq.add_image(99, items[0][1], *items[0][2:5], None)

    par = Line3D(str(tmp_path / "par"), cfg, device="cpu")
    par.add_images_parallel(
        [(it[0], (lambda im=it[1]: im)) + it[2:] for it in items], workers=3)
    assert par._images == seq._images == [10 + v for v in range(6)]
    for a, b in zip(par._segments, seq._segments):
        np.testing.assert_array_equal(a, b)
    assert par.stats["t_detect"] > 0
    with pytest.raises(ValueError, match="already in use"):
        par.add_images_parallel(items[:1])

    # cached: no detection, the same segments; then -l off removes the file
    again = Line3D(data, cfg, device="cpu")
    again.add_image(*items[0])
    assert again.stats["t_detect"] == 0.0
    np.testing.assert_array_equal(again._segments[0], seq._segments[0])
    again.add_image(*items[1], load_and_store_segments=False)
    assert again.stats["t_detect"] > 0
    assert sorted(os.listdir(data)) == caches[:1] + caches[2:]

    res_s, res_p = seq.compute_3d_model(), par.compute_3d_model()
    assert len(res_s) == len(res_p) >= 6
    for a, b in zip(res_s, res_p):
        np.testing.assert_array_equal(a.segments3d, b.segments3d)
    assert seq.stats["t_detect"] > 0      # kept through compute_3d_model
    # the native library's thread count is per calling thread: put this
    # one's back to all cores
    tload.get_lib().native_set_num_threads(os.cpu_count() or 1)


def test_fixed_view_similarity_path():
    """tests/test_pipeline_extras.py's case: the pipeline runs from
    externally supplied view similarities instead of worldpoints, and gives
    the model the worldpoint path gives (the similarities are the same)."""
    syn = make_scene(num_views=8)
    sim, _ = view_similarities_from_worldpoints(syn.wp_lists,
                                                syn.scene.num_views)
    cfg = L3DConfig(use_collinearity=False)
    fixed = Line3D(config=cfg, device="cpu")
    linked = Line3D(config=cfg, device="cpu")
    with pytest.raises(ValueError, match="unlinked"):
        fixed.add_view_segments(0, syn.scene.segments[0], syn.cameras.K[0],
                                syn.cameras.R[0], syn.cameras.t[0])
    for v in range(syn.scene.num_views):
        segs = syn.scene.segments[v][syn.scene.seg_mask[v]]
        cam = (syn.cameras.K[v].copy(), syn.cameras.R[v].copy(),
               syn.cameras.t[v].copy())
        fixed.set_view_similarity(
            v, {n: float(sim[v, n]) for n in range(syn.scene.num_views)
                if n != v})
        fixed.add_view_segments(v, segs, *cam, worldpoint_ids=None,
                                width=640, height=480)
        linked.add_view_segments(v, segs, *cam,
                                 worldpoint_ids=syn.wp_lists[v],
                                 width=640, height=480)
    res = fixed.compute_3d_model(perform_diffusion=False)
    want = linked.compute_3d_model(perform_diffusion=False)
    assert len(res) == len(want) >= 8
    assert [list(n) for n in fixed.neighbors] == \
        [list(n) for n in linked.neighbors]
    for a, b in zip(res, want):
        np.testing.assert_array_equal(a.segments3d, b.segments3d)
    errs = [min(np.linalg.norm(np.cross(
        line.segments3d.reshape(-1, 3) - A, (B - A) / np.linalg.norm(B - A)),
        axis=1).mean() for A, B in syn.lines3d) for line in res]
    assert np.median(errs) < 0.01
    assert all(s > 0.01 for d in fixed._fixed_sim.values()
               for s in d.values())
