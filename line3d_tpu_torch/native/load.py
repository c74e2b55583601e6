"""ctypes loader + on-demand builder for the native host library.

The sequential host stages (the native affinity enumeration and finalize,
F-H union-find, the line-fit event sweep, and the line-segment detector's
front, connected components, moments, extents and carve) run in C++.  The sources are the
port's own copies, `fh_cluster.cpp` and `affinity_enum.cpp` beside this
module (byte for byte those of the JAX package, which the port never
reads), built with one g++ call into the port's `_build/` directory on
first use.  There is no fallback: a failed build or load raises, so the
host stages always run this code.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import threading
import time

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_PKG = os.path.dirname(_HERE)
SOURCES = [os.path.join(_HERE, "fh_cluster.cpp"),
           os.path.join(_HERE, "affinity_enum.cpp")]
_LIB_PATH = os.path.join(_PKG, "_build", "libline3d_native.so")

_lock = threading.Lock()
_lib = None


def build(force: bool = False) -> float:
    """Compile the native library unless a binary at least as new as its
    sources exists (or `force`).  Returns the seconds spent compiling;
    raises when g++ is missing or fails."""
    missing = [s for s in SOURCES if not os.path.exists(s)]
    if missing:
        raise RuntimeError(f"native sources not found: {missing}")
    if os.path.exists(_LIB_PATH) and not force and \
            os.path.getmtime(_LIB_PATH) >= max(os.path.getmtime(s)
                                               for s in SOURCES):
        return 0.0
    os.makedirs(os.path.dirname(_LIB_PATH), exist_ok=True)
    tmp = f"{_LIB_PATH}.{os.getpid()}.tmp"
    t0 = time.perf_counter()
    r = subprocess.run(
        ["g++", "-O3", "-march=native", "-shared", "-fPIC", "-fopenmp",
         "-o", tmp] + SOURCES, capture_output=True, text=True)
    if r.returncode:
        raise RuntimeError(f"g++ failed building the native library:\n"
                           f"{r.stderr}")
    os.replace(tmp, _LIB_PATH)
    return time.perf_counter() - t0


def get_lib():
    """The native library, built on first use; raises if it cannot be
    built or loaded."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        build()
        lib = ctypes.CDLL(_LIB_PATH)
        i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
        f64p = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
        f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
        i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
        i8p = np.ctypeslib.ndpointer(np.int8, flags="C_CONTIGUOUS")
        u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
        one_i64 = np.ctypeslib.ndpointer(np.int64, shape=(1,),
                                         flags="C_CONTIGUOUS")
        sigs = {
            "fh_cluster": ([i64p, i64p, f64p, ctypes.c_int64,
                            ctypes.c_int64, ctypes.c_double, i64p], None),
            "sweep_events_batched": (
                [i64p, i64p, i64p, ctypes.c_int64, ctypes.c_int64,
                 ctypes.c_int64, i64p, i64p, i64p], ctypes.c_int64),
            "affinity_enumerate_packed": (
                [i64p, i64p, ctypes.c_int64,          # key_sorted, rows, B
                 i64p, ctypes.c_int64,                # allp_packed, P
                 i64p,                                # row_lookup
                 i64p, i64p, f64p,                    # coll csr
                 ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
                 i64p, i64p, i8p, f64p], ctypes.c_int64),
            "affinity_similarity": (
                [i64p, i64p, ctypes.c_int64, f64p, f64p, f64p, f32p, f32p,
                 i32p, f64p, f64p, f64p, ctypes.c_double, f64p], None),
            "affinity_capacity": ([i64p, ctypes.c_int64, i64p,
                                   ctypes.c_int64], ctypes.c_int64),
            "affinity_weights_range": (
                [i64p, i64p, i8p, f64p,                   # candidates
                 ctypes.c_int64, ctypes.c_int64,          # lo, hi
                 f32p,                                    # score
                 f64p, f64p, f64p, f32p, f32p, i32p,      # best arrays
                 f64p, f64p, f64p,                        # camera arrays
                 ctypes.c_double, ctypes.c_double, ctypes.c_double,
                 f64p], None),                            # w [hi - lo]
            "affinity_emit": (
                [f64p, i64p, i64p, ctypes.c_int64, ctypes.c_int64,
                 i32p, i32p, f32p, i64p, one_i64], ctypes.c_int64),
            "sort_unique_i64": ([i64p, ctypes.c_int64], ctypes.c_int64),
            # the detector (detect/vectorized_lsd.py)
            "grid_cc_compact": ([f32p, u8p, f32p, ctypes.c_int64,
                                 ctypes.c_int64, i32p], ctypes.c_int64),
            "region_moments": ([i32p, f32p, f32p, ctypes.c_int64,
                                ctypes.c_int64, f64p], None),
            "region_extents": ([i32p, ctypes.c_int64, ctypes.c_int64,
                                f64p, f64p, f64p, f64p, f64p], None),
            "lsd_carve": (
                [f32p, f32p, i32p, u8p, ctypes.c_int64,   # norm, angle,
                 ctypes.c_int64, ctypes.c_int64,          # labels, fail
                 ctypes.c_double, ctypes.c_double,        # prec, dens_th
                 ctypes.c_int64, f64p, ctypes.c_int64],   # min_sz, out
                ctypes.c_int64),
            "native_set_num_threads": ([ctypes.c_int64], None),
            "lsd_front": (
                [f32p, ctypes.c_int64, ctypes.c_int64,        # img, H, W
                 f32p, ctypes.c_int64,                        # kern, nk
                 i32p, f32p, ctypes.c_int64, ctypes.c_int64,  # iy, wy, oh, ty
                 i32p, f32p, ctypes.c_int64, ctypes.c_int64,  # ix, wx, ow, tx
                 ctypes.c_double, ctypes.c_float,             # rho, notdef
                 f32p, f32p, u8p], ctypes.c_int64),           # norm/angle/def
        }
        for name, (argtypes, restype) in sigs.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = restype
        _lib = lib
        return _lib
