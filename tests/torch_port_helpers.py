"""Shared helpers of the tests that hold `line3d_tpu_torch` against
`line3d_tpu`: inputs are made with numpy from a seed and handed to both
packages as numpy arrays."""
import numpy as np
import torch

# tier-1 runs several pytest workers at once; keep each one's intra-op
# thread pool small
torch.set_num_threads(2)

# The one float token of the port's house10 model outside test_golden.py's
# rtol 1e-5 / atol 1e-6, as (line, port, golden), at 1.04 of its tolerance.
# The golden holds XLA:CPU's float32 triangulation, which contracts a*b + c
# into fused multiply-adds and approximates rsqrt; the depths' a*c - b*b
# cancels, so those roundings reach 1.2e-5 of this coordinate.  The port's
# float32 recompute and a float64 one both print -0.57194.
HOUSE10_OUTSIDE = [(0, "-0.57194", "-0.571947")]


def T(x):
    """numpy (or JAX) array -> CPU torch tensor with the same dtype."""
    return torch.as_tensor(np.array(x))


def N(x):
    """torch tensor or JAX array -> numpy."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def facade_pair(v: int = 0, n: int = 1, S: int = 128, St: int = 256):
    """The first S / St segments of two facade views (demo scene of
    line3d_tpu, numpy) with the pair's matching constants, as f32 numpy, in
    `match_pair_dense`'s argument order: (segs_src, segs_tgt, mask_src,
    mask_tgt, F, RtKinv_src, RtKinv_tgt, C_src, C_tgt)."""
    from line3d_tpu.utils.demo import make_facade_scene
    scene, cams = make_facade_scene(num_views=4)
    f32 = lambda x: np.asarray(x, np.float32)  # noqa: E731

    def cut(w, k):
        segs = np.zeros((k, 4), np.float32)
        mask = np.zeros(k, bool)
        m = min(k, int(scene.seg_count[w]))
        segs[:m] = scene.segments[w, :m]
        mask[:m] = True
        return segs, mask
    ss, ms = cut(v, S)
    st, mt = cut(n, St)
    return (ss, st, ms, mt, f32(cams.fundamental(v, n)), f32(cams.RtKinv[v]),
            f32(cams.RtKinv[n]), f32(cams.C[v]), f32(cams.C[n]))
