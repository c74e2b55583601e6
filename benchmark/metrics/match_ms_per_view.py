"""match_ms_per_view: stats["t_match"] summed over the window's models (the
traced one left out) over models x views, in ms: host clock around the
match stage, which ends in a readback."""


def read(record):
    stats = record["stats"]
    if not stats:
        return None
    return 1e3 * sum(s["t_match"] for s in stats) / \
        (len(stats) * record["views"])
