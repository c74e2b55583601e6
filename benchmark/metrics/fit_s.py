"""fit_s: stats["t_fit"] (the line fits and the refinement), mean per model
of the window (the traced one left out)."""


def read(record):
    stats = record["stats"]
    if not stats:
        return None
    return sum(s["t_fit"] for s in stats) / len(stats)
