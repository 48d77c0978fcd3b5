"""Genomes decoded, thresholded, packed, copied to the host and counted,
over the window (host clock)."""


def read(record):
    if record["driver"] != "sample":
        return None
    return record["genomes"] / record["window_s"]
