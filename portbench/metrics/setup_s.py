"""Process start to the first timed epoch or call, compilation, loading
and warm-up inside (host clock)."""


def read(record):
    return record["setup_s"]
