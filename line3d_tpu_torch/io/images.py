"""Image loading, grayscale conversion, resizing, undistortion.

Host-side IO of the port, after `line3d_tpu/io/images.py`.  It matches the
reference CLIs' preprocessing: cv::imread + K from focal/center +
2-coefficient (bundler, main_bundler.cpp:244-284) or negated 1-coefficient
(VisualSfM, main_vsfm.cpp:243-270) radial undistortion via remap.

`cv2` is used when it imports, and then every function gives what the JAX
package's module gives.  Without it every function has a numpy path, so the
port runs on a machine with numpy alone:
  * `load_image` and `image_size` read binary netpbm (`P5` gray, `P6`
    colour, maxval <= 255), which `cv2.imread` and PIL read as well, so
    one dataset goes through both packages; any other format needs PIL
    (or cv2) and raises, naming the file, when neither imports;
  * `resize` is bilinear with half-pixel centres and no antialiasing,
    `cv2.INTER_LINEAR`'s rule (PIL's BILINEAR averages on downscale and
    is not used);
  * `undistort` is the numpy remap with BORDER_CONSTANT semantics.
"""
from __future__ import annotations

import numpy as np

try:
    import cv2
    _HAS_CV2 = True
except ImportError:                                   # pragma: no cover
    cv2 = None
    _HAS_CV2 = False

_NETPBM_CHANNELS = {b"P5": 1, b"P6": 3}


def _netpbm_header(path: str):
    """(channels, width, height, maxval, data offset) of a binary netpbm
    file, or None when the file does not start with `P5`/`P6`.  The header
    is read in growing pieces, so comments of any length are skipped."""
    with open(path, "rb") as f:
        head = f.read(512)
        if head[:2] not in _NETPBM_CHANNELS:
            return None
        while True:
            parsed = _parse_netpbm_header(head, path)
            if parsed is not None:
                break
            more = f.read(len(head))
            if not more:
                raise ValueError(f"{path}: malformed netpbm header (the "
                                 "file ends inside it)")
            head += more
    fields, offset = parsed
    width, height, maxval = fields
    return _NETPBM_CHANNELS[head[:2]], width, height, maxval, offset


def _parse_netpbm_header(head: bytes, path: str):
    """([width, height, maxval], data offset) from the first bytes of a
    binary netpbm file; None when `head` ends before the header does."""
    fields, pos = [], 2
    while len(fields) < 3:
        while pos < len(head) and head[pos:pos + 1].isspace():
            pos += 1
        if head[pos:pos + 1] == b"#":               # comment to end of line
            while pos < len(head) and head[pos:pos + 1] != b"\n":
                pos += 1
            continue
        start = pos
        while pos < len(head) and head[pos:pos + 1].isdigit():
            pos += 1
        if pos >= len(head):
            return None
        if pos == start:
            raise ValueError(f"{path}: malformed netpbm header (a number "
                             f"was expected at byte {pos})")
        fields.append(int(head[start:pos]))
    # exactly one whitespace byte separates the header from the raster
    return fields, pos + 1


def _read_netpbm(path: str, header) -> np.ndarray:
    """BGR uint8 HxWx3 from a binary PGM/PPM, as `cv2.imread` returns it
    (a gray file replicated over the three channels)."""
    ch, w, h, maxval, offset = header
    if not 0 < maxval <= 255:
        raise ValueError(f"{path}: netpbm maxval {maxval} is not supported "
                         "without cv2 (8-bit rasters only)")
    with open(path, "rb") as f:
        f.seek(offset)
        raw = np.frombuffer(f.read(w * h * ch), np.uint8)
    if raw.size != w * h * ch:
        raise ValueError(f"{path}: truncated netpbm raster")
    if maxval != 255:
        raw = ((raw.astype(np.uint32) * 255 + maxval // 2) // maxval) \
            .astype(np.uint8)
    img = raw.reshape(h, w, ch)
    if ch == 1:
        return np.repeat(img, 3, axis=2)
    return img[:, :, ::-1].copy()                     # RGB -> BGR


def _pil_image():
    try:
        from PIL import Image
    except ImportError:
        return None
    return Image


def load_image(path: str) -> np.ndarray:
    """BGR uint8 HxWx3 (cv::imread convention)."""
    if _HAS_CV2:
        img = cv2.imread(path)
        if img is None:
            raise FileNotFoundError(path)
        return img
    header = _netpbm_header(path)
    if header is not None:
        return _read_netpbm(path, header)
    Image = _pil_image()
    if Image is None:
        raise RuntimeError(
            f"cannot read {path}: not a binary netpbm (P5/P6) file, and "
            "neither cv2 nor PIL is installed")
    img = np.asarray(Image.open(path).convert("RGB"))
    return img[:, :, ::-1].copy()                     # RGB -> BGR


def to_gray(img: np.ndarray) -> np.ndarray:
    """Grayscale like the reference detector input (line3D.cc:1811-1816,
    cvtColor CV_RGB2GRAY on a BGR image — note the reference passes a BGR
    cv::imread image through CV_RGB2GRAY, so R and B weights are swapped;
    we reproduce that)."""
    if img.ndim == 2:
        return img.astype(np.float32)
    b, g, r = img[..., 0], img[..., 1], img[..., 2]
    # CV_RGB2GRAY applied to BGR data: treats channel 0 as 'R'
    return (0.299 * b + 0.587 * g + 0.114 * r).astype(np.float32)


def _linear_taps(in_size: int, out_size: int):
    """(i0, i1, frac) of cv2.INTER_LINEAR along one axis: sample positions
    (o + 0.5) * in/out - 0.5, clamped to the raster."""
    src = (np.arange(out_size) + 0.5) * (in_size / out_size) - 0.5
    src = np.clip(src, 0.0, in_size - 1.0)
    i0 = np.minimum(np.floor(src).astype(np.int64), in_size - 1)
    i1 = np.minimum(i0 + 1, in_size - 1)
    return i0, i1, src - i0


def resize(img: np.ndarray, new_w: int, new_h: int) -> np.ndarray:
    """Bilinear resize to (new_w, new_h), cv2.INTER_LINEAR's sampling."""
    if img.shape[1] == new_w and img.shape[0] == new_h:
        return img
    if _HAS_CV2:
        return cv2.resize(img, (new_w, new_h), interpolation=cv2.INTER_LINEAR)
    y0, y1, fy = _linear_taps(img.shape[0], new_h)
    x0, x1, fx = _linear_taps(img.shape[1], new_w)
    src = img.astype(np.float64)
    tail = (1,) * (img.ndim - 2)
    fy = fy.reshape((-1, 1) + tail)
    fx = fx.reshape((1, -1) + tail)
    rows = src[y0] * (1.0 - fy) + src[y1] * fy
    out = rows[:, x0] * (1.0 - fx) + rows[:, x1] * fx
    if np.issubdtype(img.dtype, np.integer):
        info = np.iinfo(img.dtype)
        out = np.clip(np.rint(out), info.min, info.max)
    return out.astype(img.dtype)


def make_K(focal: float, width: int, height: int) -> np.ndarray:
    """K with principal point at the image center (main_bundler.cpp:244-254)."""
    return np.array([[focal, 0.0, width / 2.0],
                     [0.0, focal, height / 2.0],
                     [0.0, 0.0, 1.0]])


def undistort(img: np.ndarray, K: np.ndarray, k1: float,
              k2: float = 0.0) -> np.ndarray:
    """Radial undistortion with coefficients (k1, k2), matching
    cv::initUndistortRectifyMap + remap (main_bundler.cpp:260-284)."""
    if abs(k1) < 1e-12 and abs(k2) < 1e-12:
        return img
    h, w = img.shape[:2]
    if _HAS_CV2:
        coeffs = np.array([k1, k2, 0.0, 0.0], np.float64)
        mx, my = cv2.initUndistortRectifyMap(
            K, coeffs, np.eye(3), K, (w, h), cv2.CV_32FC1)
        return cv2.remap(img, mx, my, cv2.INTER_LINEAR,
                         borderMode=cv2.BORDER_CONSTANT)
    # numpy path: same model, bilinear sampling with BORDER_CONSTANT
    # semantics — taps outside the image contribute 0 to the blend (as
    # cv2.remap does), implemented by sampling a zero-padded copy, so the
    # border band matches the cv2 path instead of edge-clamping
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float64)
    x = (xs - K[0, 2]) / K[0, 0]
    y = (ys - K[1, 2]) / K[1, 1]
    r2 = x * x + y * y
    scale = 1.0 + k1 * r2 + k2 * r2 * r2
    xd = x * scale * K[0, 0] + K[0, 2]
    yd = y * scale * K[1, 1] + K[1, 2]
    x0 = np.floor(xd).astype(int)
    y0 = np.floor(yd).astype(int)
    fx = (xd - x0)[..., None] if img.ndim == 3 else (xd - x0)
    fy = (yd - y0)[..., None] if img.ndim == 3 else (yd - y0)
    pad = np.zeros((h + 2, w + 2) + img.shape[2:], np.float64)
    pad[1:h + 1, 1:w + 1] = img
    xp0 = np.clip(x0 + 1, 0, w + 1)
    xp1 = np.clip(x0 + 2, 0, w + 1)
    yp0 = np.clip(y0 + 1, 0, h + 1)
    yp1 = np.clip(y0 + 2, 0, h + 1)
    out = (pad[yp0, xp0] * (1 - fx) * (1 - fy) + pad[yp0, xp1] * fx * (1 - fy) +
           pad[yp1, xp0] * (1 - fx) * fy + pad[yp1, xp1] * fx * fy)
    if np.issubdtype(img.dtype, np.integer):
        out = np.rint(out)
    return out.astype(img.dtype)


def image_size(path: str) -> tuple:
    """(width, height) without decoding pixel data where the format allows:
    from the header of a binary netpbm file, else PIL's lazy open, else
    one full `cv2.imread`.  PIL comes before cv2 here, unlike in
    `load_image`, because `Image.open` reads only the file's header while
    cv2 has no way to a size short of decoding the whole image (the order
    of `line3d_tpu/io/images.py:image_size`)."""
    header = _netpbm_header(path)
    if header is not None:
        return header[1], header[2]
    Image = _pil_image()
    if Image is not None:
        with Image.open(path) as im:
            return im.size
    if _HAS_CV2:
        return load_image(path).shape[1::-1]
    raise RuntimeError(
        f"cannot read the size of {path}: not a binary netpbm (P5/P6) "
        "file, and neither PIL nor cv2 is installed")
