"""dtoh_mb_per_model: stats["readback_bytes"] (every byte the model read
back from the device, `trace.readback`), mean per model of the window (the
traced one left out), in MB (1e6 bytes).  None where the program does not
count it."""


def read(record):
    stats = record["stats"]
    if not stats or any("readback_bytes" not in s for s in stats):
        return None
    return sum(s["readback_bytes"] for s in stats) / len(stats) / 1e6
