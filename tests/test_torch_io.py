"""line3d_tpu_torch.io against line3d_tpu.io on the same files and arrays:
the bundler and NVM parsers, the segment cache (each package reads what the
other wrote), the image helpers, and the numpy paths the port takes on a
machine without cv2 (forced here with `_HAS_CV2 = False`).

Tolerances: parsed values, cache contents, gray weights and the netpbm
reader are compared exactly; the numpy undistort and the numpy resize of
uint8 images within 1 grey level of cv2 (cv2 blends in fixed point), the
numpy resize of float images within 1e-3 of cv2's.
"""
import os

import numpy as np
import pytest

cv2 = pytest.importorskip("cv2")

from line3d_tpu.io import bundler as jb, cache as jc, images as ji, nvm as jn
from line3d_tpu_torch.io import bundler as tb, cache as tc, images as ti, \
    nvm as tn
from line3d_tpu_torch.utils import visualize as tv
from line3d_tpu.utils import visualize as jv

BUNDLE = """# Bundle file v0.3
2 2
800 0.01 -0.002
1 0 0
0 1 0
0 0 1
0.5 1.0 2.0
900 0 0
0.5 0 0.5
0 1 0
-0.5 0 0.5
-1 2 -3
1.5 2.5 3.5
255 0 0
2 0 11 1.0 2.0 1 22 3.0 4.0
-1 -2 -3
0 255 0
1 1 33 5.0 6.0
"""

NVM = """NVM_V3

2
img0.jpg 800 1 0 0 0 1.0 2.0 3.0 0.05 0
img1.jpg 820 0.9238795 0 0.3826834 0 -1 0 1 0 0

2
0.1 0.2 0.3 255 255 255 2 0 5 1.1 2.2 1 7 3.3 4.4
0 0 0 128 128 128 2 0 0
0.0 0.0 1 1
1.0 1.0
"""


@pytest.fixture
def no_cv2(monkeypatch):
    """The port's image module as it runs where cv2 does not import."""
    monkeypatch.setattr(ti, "_HAS_CV2", False)


def test_parse_bundle_file_equals_reference(tmp_path):
    p = tmp_path / "bundle.rd.out"
    p.write_text(BUNDLE)
    got, want = tb.parse_bundle_file(str(p)), jb.parse_bundle_file(str(p))
    for g, w in zip(got[:4], want[:4]):
        np.testing.assert_array_equal(g, w)
    assert got[4] == want[4] == [[0], [0, 1]]
    np.testing.assert_allclose(got[2][0], np.diag([1.0, -1.0, -1.0]))
    (tmp_path / "visualize").mkdir()
    (tmp_path / "visualize" / "00000001.png").write_bytes(b"")
    ds = tb.load_bundler_scene(str(tmp_path))
    assert ds.image_paths == jb.load_bundler_scene(str(tmp_path)).image_paths
    assert ds.image_paths[0] is None and ds.image_paths[1].endswith("1.png")


def test_parse_nvm_equals_reference(tmp_path):
    """Including a measurement list wrapped across lines."""
    p = tmp_path / "scene.nvm"
    p.write_text(NVM)
    got, want = tn.load_nvm_scene(str(p)), jn.load_nvm_scene(str(p))
    assert got.image_names == want.image_names == ["img0.jpg", "img1.jpg"]
    for name in ("focal", "distortion", "R", "t"):
        np.testing.assert_array_equal(getattr(got, name),
                                      getattr(want, name))
    assert got.wp_lists == want.wp_lists == [[0, 1], [0, 1]]
    np.testing.assert_allclose(got.t[0], [-1.0, -2.0, -3.0])
    p.write_text(NVM[:NVM.index("1.0 1.0")])
    with pytest.raises(ValueError, match="truncated"):
        tn.load_nvm_scene(str(p))


@pytest.mark.parametrize("writer,reader", [(tc, jc), (jc, tc), (tc, tc)])
def test_segment_cache_cross_package(tmp_path, writer, reader):
    """The same file name for the same key, and a cache written by one
    package read by the other."""
    key = (str(tmp_path), 3, 640, 480, True)
    kw = dict(max_segments=3000, min_len_factor=0.005)
    path = writer.segment_cache_path(*key, **kw)
    assert path == reader.segment_cache_path(*key, **kw)
    assert os.path.basename(path) == \
        "segments_3_640x480_coll1_cap3000_ml0.005.npz"
    segs = np.random.default_rng(0).normal(size=(17, 4)).astype(np.float32)
    writer.save_segments(path, segs)
    np.testing.assert_array_equal(reader.load_segments(path), segs)
    assert reader.load_segments(str(tmp_path / "missing.npz")) is None
    (tmp_path / "bad.npz").write_bytes(b"not a zip")
    assert reader.load_segments(str(tmp_path / "bad.npz")) is None


def test_gray_weights_and_make_k_equal_reference():
    rng = np.random.default_rng(1)
    img = rng.integers(0, 256, (7, 9, 3), dtype=np.uint8)
    np.testing.assert_array_equal(ti.to_gray(img), ji.to_gray(img))
    np.testing.assert_array_equal(ti.to_gray(img[..., 0]),
                                  ji.to_gray(img[..., 0]))
    one = np.zeros((1, 1, 3), np.uint8)
    one[0, 0, 0] = 100      # channel 0 (B of a BGR image) gets R's 0.299
    np.testing.assert_allclose(ti.to_gray(one)[0, 0], 29.9, atol=0.1)
    np.testing.assert_array_equal(ti.make_K(600.0, 640, 480),
                                  ji.make_K(600.0, 640, 480))


@pytest.mark.parametrize("k1,k2", [(0.08, -0.01), (-0.1, 0.0), (0.0, 0.0)])
def test_undistort_with_cv2_equals_reference_and_numpy_path(k1, k2,
                                                            monkeypatch):
    rng = np.random.RandomState(0)
    img = rng.randint(0, 255, (60, 80), np.uint8)
    K = ti.make_K(70.0, 80, 60)
    want = ji.undistort(img, K, k1, k2)
    np.testing.assert_array_equal(ti.undistort(img, K, k1, k2), want)
    monkeypatch.setattr(ti, "_HAS_CV2", False)
    got = ti.undistort(img, K, k1, k2)
    assert np.abs(want.astype(int) - got.astype(int)).max() <= 1
    color = np.stack([img, img[::-1], img[:, ::-1]], axis=-1)
    got3 = ti.undistort(color, K, k1, k2)
    assert got3.shape == color.shape
    np.testing.assert_array_equal(got3[..., 0], got)


@pytest.mark.parametrize("shape,new_wh", [
    ((60, 80), (64, 48)), ((60, 80), (40, 30)), ((90, 120, 3), (96, 72)),
    ((37, 53), (71, 29)), ((48, 64), (64, 48))])
def test_resize_numpy_path_against_cv2(shape, new_wh, monkeypatch):
    """Bilinear at half-pixel centres without antialiasing:
    cv2.INTER_LINEAR on up- and downscale (2x down included, which cv2
    computes as a box average)."""
    rng = np.random.default_rng(5)
    img8 = rng.integers(0, 256, shape, dtype=np.uint8)
    imgf = rng.uniform(-5.0, 300.0, shape).astype(np.float32)
    want8 = ji.resize(img8, *new_wh)
    wantf = ji.resize(imgf, *new_wh)
    np.testing.assert_array_equal(ti.resize(img8, *new_wh), want8)
    monkeypatch.setattr(ti, "_HAS_CV2", False)
    got8, gotf = ti.resize(img8, *new_wh), ti.resize(imgf, *new_wh)
    assert got8.dtype == np.uint8 and gotf.dtype == np.float32
    assert got8.shape == want8.shape
    assert np.abs(got8.astype(int) - want8.astype(int)).max() <= 1
    np.testing.assert_allclose(gotf, wantf, rtol=0, atol=1e-3)
    assert gotf.max() > 250.0 and gotf.min() >= -5.0   # no uint8 wrap
    assert ti.resize(img8, shape[1], shape[0]) is img8


@pytest.mark.parametrize("magic", ["P5", "P6"])
def test_netpbm_reader_against_cv2(tmp_path, magic, no_cv2):
    """The numpy reader returns what cv2.imread returns for a binary PGM
    or PPM (a comment in the header included), and image_size reads the
    header alone."""
    rng = np.random.default_rng(2)
    h, w = 13, 21
    ext = ".pgm" if magic == "P5" else ".ppm"
    path = str(tmp_path / ("img" + ext))
    raster = rng.integers(0, 256, (h, w) if magic == "P5" else (h, w, 3),
                          dtype=np.uint8)
    with open(path, "wb") as f:
        f.write(f"{magic}\n# a comment\n{w} {h}\n255\n".encode())
        f.write(raster.tobytes())
    got = ti.load_image(path)
    np.testing.assert_array_equal(got, cv2.imread(path))
    assert got.shape == (h, w, 3) and got.dtype == np.uint8
    assert tuple(ti.image_size(path)) == tuple(ji.image_size(path)) == (w, h)
    if magic == "P6":
        tv.save_ppm(raster, path)              # the port's own writer
        np.testing.assert_array_equal(ti.load_image(path), cv2.imread(path))
    with open(path, "wb") as f:
        f.write(f"{magic}\n{w} {h}\n255\n".encode() + b"\0" * 5)
    with pytest.raises(ValueError, match="truncated"):
        ti.load_image(path)


@pytest.mark.parametrize("comment_bytes", [600, 5000])
def test_netpbm_header_longer_than_one_read(tmp_path, comment_bytes, no_cv2):
    """Comments may push the header past the reader's first 512 bytes: the
    raster is still found where cv2.imread finds it; a file that ends
    inside its header, or holds no number where one belongs, raises and
    names the file."""
    rng = np.random.default_rng(4)
    h, w = 7, 9
    raster = rng.integers(0, 256, (h, w), dtype=np.uint8)
    path = str(tmp_path / "long.pgm")
    head = b"P5\n" + (b"# " + b"c" * 98 + b"\n") * (comment_bytes // 101) \
        + f"{w} {h}\n".encode()
    with open(path, "wb") as f:
        f.write(head + b"255\n" + raster.tobytes())
    np.testing.assert_array_equal(ti.load_image(path), cv2.imread(path))
    assert tuple(ti.image_size(path)) == (w, h)
    with open(path, "wb") as f:
        f.write(head)
    with pytest.raises(ValueError, match="long.pgm.*ends inside"):
        ti.image_size(path)
    with open(path, "wb") as f:
        f.write(b"P5\n9 x7\n255\n" + raster.tobytes())
    with pytest.raises(ValueError, match="long.pgm.*number"):
        ti.image_size(path)


def test_other_formats(tmp_path, monkeypatch):
    """A PNG goes through cv2 as in line3d_tpu; without cv2 through PIL;
    without both the error names the file."""
    rng = np.random.default_rng(3)
    img = rng.integers(0, 256, (10, 12, 3), dtype=np.uint8)
    path = str(tmp_path / "img.png")
    cv2.imwrite(path, img)
    np.testing.assert_array_equal(ti.load_image(path), ji.load_image(path))
    assert tuple(ti.image_size(path)) == (12, 10)
    with pytest.raises(FileNotFoundError):
        ti.load_image(str(tmp_path / "missing.png"))
    monkeypatch.setattr(ti, "_HAS_CV2", False)
    np.testing.assert_array_equal(ti.load_image(path), img)
    monkeypatch.setattr(ti, "_pil_image", lambda: None)
    for fn in (ti.load_image, ti.image_size):
        with pytest.raises(RuntimeError, match="img.png"):
            fn(path)


def test_visualize_equals_reference(tmp_path):
    segs = np.array([[5, 5, 60, 40], [-10, 20, 30, 90], [0, 0, 0, 0]], float)
    np.testing.assert_array_equal(
        tv.draw_lines(segs, 80, 64, highlight=[1]),
        jv.draw_lines(segs, 80, 64, highlight=[1]))

    class Line:
        confidence = 1.5
        segments3d = np.array([[[0, 0, 0], [1, 2, 3]]], float)
    for kw in ({}, dict(color_by_confidence=True)):
        tv.save_ply([Line()], str(tmp_path / "t.ply"), **kw)
        jv.save_ply([Line()], str(tmp_path / "j.ply"), **kw)
        assert (tmp_path / "t.ply").read_text() == \
            (tmp_path / "j.ply").read_text()
