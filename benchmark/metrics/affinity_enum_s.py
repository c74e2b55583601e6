"""affinity_enum_s: stats["t_affinity_enum"], the native candidate enumeration
(span affinity.enumerate), mean per model of the window (the traced one
left out), in s. None where the program does not record it."""


def read(record):
    stats = record["stats"]
    if not stats or any("t_affinity_enum" not in s for s in stats):
        return None
    return sum(s["t_affinity_enum"] for s in stats) / len(stats)
