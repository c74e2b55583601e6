"""setup_s: Seconds from the process's start to the window's start:
imports, the kernels' build on a checkout's first run, the capture, one
cold model."""


def read(record):
    return record["setup_s"]
