"""affinity_weights_s: stats["t_affinity_weights"], the weight sweep, its
gather and the emission (span affinity.weights), mean per model of the
window (the traced one left out), in s. None where the program does not
record it."""


def read(record):
    stats = record["stats"]
    if not stats or any("t_affinity_weights" not in s for s in stats):
        return None
    return sum(s["t_affinity_weights"] for s in stats) / len(stats)
