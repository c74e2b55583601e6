"""line3d_tpu_torch — the PyTorch/CUDA port of line3d_tpu.

Line-based multi-view stereo (manhofer/Line3D, GCPR 2015) on PyTorch, with
the TPU package's Pallas kernels rewritten as hand-written CUDA kernels for
NVIDIA Hopper (`csrc/`).  The JAX package `line3d_tpu` beside it is the
reference this port is held against; the port imports neither JAX nor it.
"""
import torch

# The geometry needs full f32: TF32 keeps 10 mantissa bits, which moves
# reprojections by pixels at image scale and flips the epipolar and support
# gates (the CUDA counterpart of the TPU's bf16 matmul default).  The port's
# own small products are written out elementwise; these flags keep any
# library matmul or convolution in full f32 as well.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

from .config import L3DConfig, DEFAULT_CONFIG  # noqa: E402
from .pipeline import Line3D  # noqa: E402

__version__ = "0.1.0"
__all__ = ["Line3D", "L3DConfig", "DEFAULT_CONFIG"]
