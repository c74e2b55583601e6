"""match_wait_ms_per_view: stats["t_match_wait"] (the host's seconds blocked
in the per-view match step's readbacks, `trace.readback`'s `match.*` sites)
summed over the window's models (the traced one left out) over models x
views, in ms.  None where the program does not record it."""


def read(record):
    stats = record["stats"]
    if not stats or any("t_match_wait" not in s for s in stats):
        return None
    return 1e3 * sum(s["t_match_wait"] for s in stats) / \
        (len(stats) * record["views"])
