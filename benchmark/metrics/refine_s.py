"""refine_s: stats["t_refine"], the line refinement (stage span fit.refine:
the members' data, the solve and its readback), mean per model of the
window (the traced one left out), in s.  None where the program does not
record it."""


def read(record):
    stats = record["stats"]
    if not stats or any("t_refine" not in s for s in stats):
        return None
    return sum(s["t_refine"] for s in stats) / len(stats)
