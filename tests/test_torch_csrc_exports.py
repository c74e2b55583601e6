"""The C interface of the port's CUDA library, read from its sources.

`native/cuda.py` binds every entry point of `csrc/*.cu` with ctypes from
its table `_SIGNATURES` (argument types) and `_RESTYPES` (return types
other than int).  ctypes trusts the table: a missing entry is found only
at load time on the card, and a wrong count or type passes a cut pointer
or a shifted argument without any error.  These tests parse every
`L3D_EXPORT` definition in `csrc/*.cu` and hold the table to it, on the
CPU, without nvcc."""
import ctypes
import glob
import os
import re

import pytest

from line3d_tpu_torch.native import cuda

_EXPORT = re.compile(r"L3D_EXPORT\s+([\w\s\*]+?)\s*\b(l3d_\w+)\s*\(([^)]*)\)",
                     re.S)
_CTYPE = {"int": ctypes.c_int, "float": ctypes.c_float,
          "double": ctypes.c_double, "long long": ctypes.c_longlong,
          "const char*": ctypes.c_char_p}


def _param_ctype(decl: str):
    """The ctypes type a parameter declaration ("const void* segs",
    "int N") is bound with: every pointer as c_void_p."""
    decl = " ".join(decl.split())
    if "*" in decl:
        return ctypes.c_void_p
    return _CTYPE[decl.rsplit(" ", 1)[0]]


def exports() -> dict:
    """{symbol: (return ctype, [argument ctypes], source file)} of every
    L3D_EXPORT function defined in csrc/*.cu."""
    out = {}
    for path in sorted(glob.glob(os.path.join(cuda.CSRC, "*.cu"))):
        with open(path) as f:
            for ret, name, params in _EXPORT.findall(f.read()):
                assert name not in out, f"{name} exported twice"
                args = [_param_ctype(p) for p in params.split(",")
                        if p.strip()]
                out[name] = (_CTYPE[" ".join(ret.split())], args,
                             os.path.basename(path))
    return out


def test_parser_reads_the_known_forms():
    assert _param_ctype("const void* segs") is ctypes.c_void_p
    assert _param_ctype("void*  stream") is ctypes.c_void_p
    assert _param_ctype("int N") is ctypes.c_int
    assert _param_ctype("float thr_sq") is ctypes.c_float
    found = exports()
    assert found["l3d_error_string"][0] is ctypes.c_char_p
    assert found["l3d_score_scratch_bytes"][0] is ctypes.c_longlong


@pytest.mark.parametrize("name", sorted(cuda._SIGNATURES))
def test_signature_matches_its_export(name):
    found = exports()
    assert name in found, f"{name} is bound but no csrc/*.cu exports it"
    ret, args, src = found[name]
    assert len(cuda._SIGNATURES[name]) == len(args), (name, src)
    assert cuda._SIGNATURES[name] == args, (name, src)
    assert cuda._RESTYPES.get(name, ctypes.c_int) is ret, (name, src)


def test_every_export_is_bound():
    assert sorted(exports()) == sorted(cuda._SIGNATURES)


def test_pair_kernels_share_their_arithmetic():
    """K1 (pair_valid.cu) and K5 (pair_dense.cu) each export one kernel
    and take every per-pair function from pair_math.cuh, which defines
    each once."""
    found = exports()
    assert [n for n, v in found.items() if v[2] == "pair_valid.cu"] == \
        ["l3d_pair_valid"]
    assert [n for n, v in found.items() if v[2] == "pair_dense.cu"] == \
        ["l3d_pair_dense"]
    shared = ("ray_n", "intersect", "d2", "on_seg", "overlap_sq_nd",
              "two_ray", "stage", "cheap_gates", "two_ray_terms",
              "rcp_fast", "sqrt_fast")
    with open(os.path.join(cuda.CSRC, "pair_math.cuh")) as f:
        header = f.read()
    for fn in shared:
        assert len(re.findall(rf"\b(?:void|bool|float) {fn}\(", header)) \
            == 1, fn
    for src in ("pair_valid.cu", "pair_dense.cu", "rn_ops_check.cu"):
        with open(os.path.join(cuda.CSRC, src)) as f:
            text = f.read()
        assert '#include "pair_math.cuh"' in text, src
        assert "kDepths" not in text, src
        for fn in shared:
            assert not re.search(rf"\b(?:void|bool|float) {fn}\(", text), \
                (src, fn)
