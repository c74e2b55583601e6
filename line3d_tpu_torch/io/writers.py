"""Result writers: STL and TXT, format-compatible with the reference
(save3DLinesAsSTL line3D.cc:384-430, save3DLinesAsTXT line3D.cc:433-473,
format documented README.txt:177-186).
"""
from __future__ import annotations


def save_stl(result: list, filename: str):
    """Degenerate-facet STL: each 3D sub-segment becomes one facet with the
    first vertex repeated (line3D.cc:418-424)."""
    with open(filename, "w") as f:
        f.write("solid lineModel\n")
        for line in result:
            for seg in line.segments3d:
                P1, P2 = seg[0], seg[1]
                v1 = " ".join("%e" % x for x in P1)
                v2 = " ".join("%e" % x for x in P2)
                f.write(" facet normal 1.0e+000 0.0e+000 0.0e+000\n")
                f.write("  outer loop\n")
                f.write(f"   vertex {v1}\n")
                f.write(f"   vertex {v2}\n")
                f.write(f"   vertex {v1}\n")
                f.write("  endloop\n")
                f.write(" endfacet\n")
        f.write("endsolid lineModel\n")


def _fmt(x: float) -> str:
    """Default C++ ostream float formatting (6 significant digits)."""
    return f"{x:.6g}"


def save_txt(result: list, filename: str, get_segment_2d=None,
             view_id_map=None):
    """One line per 3D line:  n  P1 Q1 ... Pn Qn  m  camID segID p q ...

    get_segment_2d(view, seg) must return the (x1, y1, x2, y2) coords of a 2D
    residual segment.  view_id_map maps internal dense view indices back to
    the caller's external image ids (the reference uses external ids).
    """
    with open(filename, "w") as f:
        for line in result:
            if len(line.segments3d) == 0:
                continue
            parts = [str(len(line.segments3d))]
            for seg in line.segments3d:
                parts += [_fmt(v) for v in seg[0]] + [_fmt(v) for v in seg[1]]
            parts.append(str(len(line.views2d)))
            for v, s in zip(line.views2d, line.segs2d):
                ext = int(v) if view_id_map is None else int(view_id_map[int(v)])
                parts += [str(ext), str(int(s))]
                if get_segment_2d is not None:
                    coords = get_segment_2d(int(v), int(s))
                    parts += [_fmt(float(c)) for c in coords]
                else:
                    parts += ["0", "0", "0", "0"]
            f.write(" ".join(parts) + " \n")


def compare_txt(got_path: str, want_path: str, rtol: float = 1e-5,
                atol: float = 1e-6) -> dict:
    """Token-by-token comparison of two TXT models, read the way
    tests/test_golden.py reads them: integer tokens (counts, camera and
    segment ids) must be equal, float tokens within rtol / atol.

    Returns dict(ok, n_tokens, int_bad, worst_ratio, worst, outside) where
    worst_ratio is the largest |error| / tolerance over float tokens and
    outside lists the (line, got, want) float tokens beyond tolerance.
    """
    def parse(path):
        toks = []
        for ln, line in enumerate(open(path)):
            t = line.split()
            if not t:
                continue
            n = int(t[0])
            kinds = ["i"] + ["f"] * (6 * n) + ["i"]
            m = int(t[1 + 6 * n])
            kinds += ["i", "i", "f", "f", "f", "f"] * m
            if len(kinds) != len(t):
                raise ValueError(f"{path}:{ln}: malformed line")
            toks += [(ln, k, v) for k, v in zip(kinds, t)]
        return toks

    got, want = parse(got_path), parse(want_path)
    out = dict(ok=False, n_tokens=len(want), int_bad=0, worst_ratio=0.0,
               worst=None, outside=[])
    if [k for _, k, _ in got] != [k for _, k, _ in want]:
        out["int_bad"] = -1          # different structure
        return out
    for (ln, kind, g), (_, _, w) in zip(got, want):
        if kind == "i":
            out["int_bad"] += int(g) != int(w)
            continue
        ratio = abs(float(g) - float(w)) / (rtol * abs(float(w)) + atol)
        if ratio > 1.0:
            out["outside"].append((ln, g, w))
        if ratio > out["worst_ratio"]:
            out["worst_ratio"], out["worst"] = ratio, (ln, g, w)
    out["ok"] = out["int_bad"] == 0 and not out["outside"]
    return out
