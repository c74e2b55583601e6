"""Builder and ctypes loader for the port's hand-written CUDA kernels.

`csrc/*.cu` are compiled by `nvcc` for Hopper (`sm_90a`), one process per
source in parallel, and linked into one shared library with a plain C
interface, `_build/libl3d_kernels.so`, at first use.
Each C entry point launches its kernel on the stream it is given and returns
`cudaGetLastError()`; `check` turns a nonzero code into an exception.

Every kernel is built with `-fmad=false`: nvcc would otherwise contract
`a*b + c` into fused multiply-adds, which round differently from the
reference's separate multiply and add and so move the borderline overlap,
sign and distance gates.  No fast-math flag is used anywhere.

Nothing here runs at import time; this module imports on machines without
CUDA, and the tests on the CPU never build or load the library.
"""
from __future__ import annotations

import ctypes
import glob
import os
import shutil
import subprocess
import threading
import time

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
LIB_PATH = os.path.join(BUILD_DIR, "libl3d_kernels.so")
LOG_PATH = os.path.join(BUILD_DIR, "nvcc.log")

_ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = _ARCH + ["-std=c++17", "-O3", "-Xcompiler", "-fPIC",
                      "-fmad=false", "-Xptxas", "-v"]

_lock = threading.Lock()
_lib = None

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_L = ctypes.c_longlong
_D = ctypes.c_double
# C signatures: every pointer and the stream as c_void_p (a plain int would
# be cut to 32 bits), every count as c_int or, where it may pass 2**31,
# c_longlong, a float64 scalar as c_double
_SIGNATURES = {
    "l3d_pair_valid": [_P, _P, _P, _P, _P, _I, _I, _I, _P, _P, _P],
    "l3d_pair_dense": [_P, _P, _P, _P, _P, _I, _I, _I, _P, _P, _P],
    "l3d_rn_ops_check": [_P, _P],
    "l3d_collin_pairs": [_P, _P] + [_I] * 4 + [_F] * 3 + [_I] + [_P] * 5,
    "l3d_score": [_P] * 8 + [_F] * 4 + [_I] * 3 + [_P, _P, _I, _P],
    "l3d_score_scratch_bytes": [_I, _I, _I, _I],
    "l3d_fma_peak": [_P, _F, _F, _I, _I, _P, _P],
    "l3d_affinity_count": [_P, _P, _L, _P, _L] + [_P] * 6 + [_L, _L] +
                          [_P] * 5,
    "l3d_affinity_write": [_P, _P, _L, _P, _L] + [_P] * 6 + [_L, _L] +
                          [_P] * 5 + [_L, _P, _P],
    "l3d_affinity_filter": [_P, _L] + [_P] * 10 + [_D] * 4 + [_P, _P],
    "l3d_affinity_compact": [_P, _L, _P, _L, _P, _P],
    "l3d_error_string": [_I],
}

# return types other than a CUDA error code (c_int)
_RESTYPES = {"l3d_score_scratch_bytes": ctypes.c_longlong,
             "l3d_error_string": ctypes.c_char_p}


def sources() -> list:
    return sorted(glob.glob(os.path.join(CSRC, "*.cu")))


def nvcc() -> str:
    path = shutil.which("nvcc")
    if path:
        return path
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found (PATH, CUDA_HOME, /usr/local/cuda)")
    return path


def _up_to_date() -> bool:
    if not os.path.exists(LIB_PATH):
        return False
    deps = sources() + glob.glob(os.path.join(CSRC, "*.cuh"))
    return os.path.getmtime(LIB_PATH) >= max(os.path.getmtime(s)
                                             for s in deps)


def build(force: bool = False) -> float:
    """Compile the kernels unless an up-to-date library exists: one nvcc
    per source, all started together, then one link.  Returns the seconds
    spent (0.0 when nothing was built); the compiler's register and
    shared-memory report goes to `LOG_PATH`."""
    if not force and _up_to_date():
        return 0.0
    os.makedirs(BUILD_DIR, exist_ok=True)
    tag = f"{os.getpid()}.tmp"
    t0 = time.perf_counter()
    jobs = []
    for src in sources():
        obj = os.path.join(BUILD_DIR, f"{os.path.basename(src)}.{tag}.o")
        cmd = [nvcc()] + NVCC_FLAGS + ["-I", CSRC, "-c", "-o", obj, src]
        jobs.append((cmd, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True)))
    log, failed = [], []
    for cmd, obj, proc in jobs:
        out, err = proc.communicate()
        log.append(" ".join(cmd) + "\n" + out + err)
        if proc.returncode != 0:
            failed.append(f"{cmd[-1]} ({proc.returncode}):\n{err[-4000:]}")
    objs = [obj for _, obj, _ in jobs]
    try:
        if not failed:
            tmp = f"{LIB_PATH}.{tag}"
            cmd = [nvcc()] + _ARCH + ["-shared", "-o", tmp] + objs
            proc = subprocess.run(cmd, capture_output=True, text=True)
            log.append(" ".join(cmd) + "\n" + proc.stdout + proc.stderr)
            if proc.returncode != 0:
                failed.append(f"link ({proc.returncode}):\n"
                              f"{proc.stderr[-4000:]}")
            else:
                os.replace(tmp, LIB_PATH)
    finally:
        for obj in objs:
            if os.path.exists(obj):
                os.remove(obj)
    with open(LOG_PATH, "w") as f:
        f.write("\n".join(log))
    if failed:
        raise RuntimeError("nvcc failed: " + "\n".join(failed))
    return time.perf_counter() - t0


def lib():
    """The loaded kernel library (built on first use)."""
    global _lib
    with _lock:
        if _lib is None:
            build()
            handle = ctypes.CDLL(LIB_PATH)
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(handle, name)
                fn.argtypes = argtypes
                fn.restype = _RESTYPES.get(name, ctypes.c_int)
            _lib = handle
        return _lib


def check(rc: int, name: str):
    """Raise if a launch reported a CUDA error."""
    if rc != 0:
        msg = lib().l3d_error_string(rc).decode()
        raise RuntimeError(f"{name}: CUDA error {rc} ({msg})")


def stream_of(t) -> int:
    """The handle of PyTorch's current stream on tensor `t`'s device."""
    import torch
    return torch.cuda.current_stream(t.device).cuda_stream


def on_device(t):
    """A context making tensor `t`'s card the current device.  The CUDA
    runtime launches on the current device, whatever stream it is handed:
    every C entry point is called inside it, so that a tensor on cuda:1
    is not launched in cuda:0's context."""
    import torch
    return torch.cuda.device(t.device)


def require_cuda(name: str, *tensors, dtypes=None):
    """Wrapper-side checks: every tensor on one CUDA device and
    contiguous (and of the given dtypes, when listed)."""
    dev = tensors[0].device
    if dev.type != "cuda":
        raise ValueError(f"{name}: expected CUDA tensors, got {dev}")
    for i, t in enumerate(tensors):
        if t.device != dev:
            raise ValueError(f"{name}: argument {i} on {t.device}, "
                             f"expected {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: argument {i} is not contiguous")
        if dtypes is not None and t.dtype != dtypes[i]:
            raise TypeError(f"{name}: argument {i} has dtype {t.dtype}, "
                            f"expected {dtypes[i]}")
