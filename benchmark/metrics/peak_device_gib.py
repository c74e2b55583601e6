"""peak_device_gib: torch.cuda.max_memory_allocated() over the window (its
peak statistics reset at the window's start) on the fullest card, in
GiB."""


def read(record):
    if not record["peak_bytes"]:
        return None
    return record["peak_bytes"] / 2 ** 30
