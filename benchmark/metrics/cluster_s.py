"""cluster_s: stats["t_cluster"] (affinity, diffusion, F-H, fits), mean per
model of the window (the traced one left out)."""


def read(record):
    stats = record["stats"]
    if not stats:
        return None
    return sum(s["t_cluster"] for s in stats) / len(stats)
