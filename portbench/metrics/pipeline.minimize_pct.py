"""The share of the window in which the pipeline's minimize worker runs the
native convert, minimize and write of a chunk (the program's
``PipelineStats.minimize_s``, summed over the window's calls), in
percent."""


def read(record):
    if record["driver"] != "pipeline":
        return None
    return 100.0 * record["minimize_s"] / record["window_s"]
