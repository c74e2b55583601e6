"""diffusion_plan_s: stats["t_diffusion_plan"], the device diffusion's host
plan, uploads and length classes (stage span diffusion.plan), mean per
model of the window (the traced one left out), in s.  None where the
program does not record it."""


def read(record):
    stats = record["stats"]
    if not stats or any("t_diffusion_plan" not in s for s in stats):
        return None
    return sum(s["t_diffusion_plan"] for s in stats) / len(stats)
