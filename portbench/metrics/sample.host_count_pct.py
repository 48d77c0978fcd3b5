"""The share of the window the host spends in the per-chunk counts of
sample mode (genes present, essential genes present), timed by the
benchmark's span around each ``on_chunk`` call, in percent."""


def read(record):
    if record["driver"] != "sample":
        return None
    return 100.0 * record["host_count_s"] / record["window_s"]
