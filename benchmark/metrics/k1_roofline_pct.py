"""k1_roofline_pct: K1 (csrc/pair_valid.cu) in the traced model: the least
time its work needs (roofline.k1_work per view, at the published peaks)
over its summed device time in the trace, in percent."""
from benchmark import roofline

# the kernel's name in the trace
KERNEL = "pair_kernel"


def read(record):
    tr = record.get("trace")
    if not tr:
        return None
    t = sum(s for n, s in tr["by_op"].items() if KERNEL in n)
    if t <= 0:
        return None
    least = sum(roofline.least_seconds(*roofline.k1_work(
        w["src"], w["tgts"], w["valid"])) for w in tr["work"])
    return 100.0 * least / t
