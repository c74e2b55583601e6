"""affinity_pairs_s: stats["t_affinity_pairs"], the correspondence pairs, the
row lookup and the collinearity CSR (span affinity.pairs), mean per model
of the window (the traced one left out), in s. None where the program does
not record it."""


def read(record):
    stats = record["stats"]
    if not stats or any("t_affinity_pairs" not in s for s in stats):
        return None
    return sum(s["t_affinity_pairs"] for s in stats) / len(stats)
