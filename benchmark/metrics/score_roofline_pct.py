"""score_roofline_pct: The scoring kernel (csrc/scoring.cu) in the traced
model: the least time its work needs (roofline.score_work per view) over
its summed device time in the trace, in percent."""
from benchmark import roofline

# the kernel's name in the trace
KERNEL = "score_kernel"


def read(record):
    tr = record.get("trace")
    if not tr:
        return None
    t = sum(s for n, s in tr["by_op"].items() if KERNEL in n)
    if t <= 0:
        return None
    least = sum(roofline.least_seconds(*roofline.score_work(
        w["S"], w["M"], w["valid"])) for w in tr["work"])
    return 100.0 * least / t
