"""Genomes decoded, thresholded, packed, copied to the host, converted,
minimized and written as FASTA records, over the window (host clock)."""


def read(record):
    if record["driver"] != "pipeline":
        return None
    return record["genomes"] / record["window_s"]
