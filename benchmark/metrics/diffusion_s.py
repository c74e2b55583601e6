"""diffusion_s: stats["t_diffusion"], mean per model of the window (the
traced one left out)."""


def read(record):
    stats = record["stats"]
    if not stats:
        return None
    return sum(s["t_diffusion"] for s in stats) / len(stats)
