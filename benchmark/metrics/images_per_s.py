"""images_per_s: Views of every model completed in the window over the
window's wall seconds, from its start to the end of its last model."""


def read(record):
    if not record["window_s"]:
        return None
    return record["completed"] * record["views"] / record["window_s"]
